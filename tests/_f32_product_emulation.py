"""The 3xTF32 arithmetic and the partitions of ``csrc/f32_product.cu``,
emulated in PyTorch on the CPU (no card runs here).

Each operand value x is split as the kernels split it (``split`` of
``csrc/edge_block_tile.cuh``): hi = x's bits plus 0x1000 with the low 13
bits cleared (x rounded to TF32), lo = x - hi (exact in f32), and the
tensor cores read only lo's top 19 bits. A tensor-core product of one
8-deep step adds its eight terms to an f32 sum; it is modelled as the exact
sum in f64 rounded once to f32. The sums follow the kernels' order:

  * the wgmma rows kernel (K <= 128 and N > 8) adds each 32-deep chunk into
    a fresh partial, the chunk's eight small terms (lo*hi, hi*lo) first,
    then its four hi*hi, and adds the partials in chunk order with rounded
    f32 adds;
  * the mma.sync rows kernel adds each 8-deep step's three terms (lo*hi,
    hi*lo, hi*hi) into a fresh partial and that into the sum; the
    weight-gradient kernel adds the three terms of each step into one
    running sum a split.

The weight gradient follows the kernel's partition: the split of the rows
from ``wgrad_partition``, 32-row chunks in order inside a split, the
splits' partials added in the reduce kernel's order; the bias gradient's
column sums as the kernel's threads take them.

``through_emulation`` patches ``ops/f32_product``'s launchers and ``takes``
so that ``linear`` runs ``F32Product`` on CPU tensors over these versions,
counting ``LAUNCHES`` as the launchers do.
"""

from contextlib import contextmanager
from unittest import mock

import torch

from sgnn_tpu_torch.ops import f32_product as fp

STEP = 8  # the depth of one tensor-core step
CHUNK = 32  # the depth of a staged chunk
THREADS = 256
REDUCE_WARPS = 8  # the reduce kernel's warps, each a strided share of the splits


def tf32_split(x: torch.Tensor):
    """(hi, lo as the tensor cores read it) of f32 values."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = x - hi
    lo_read = (lo.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo_read


def _mma_sum(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc (f32) + a @ b over one 8-deep step, exact in f64, rounded once."""
    return (acc.double() + a.double() @ b.double()).float()


def rows_on_wgmma(k: int, n: int) -> bool:
    return k <= 128 and n > 8


def product(a: torch.Tensor, b: torch.Tensor, chunked: bool = True) -> torch.Tensor:
    """a [M, D] @ b [D, N] summed over D as the kernels sum it (f32): by
    32-deep chunk partials (``chunked``, the wgmma kernels) or by 8-deep
    step partials (the mma.sync rows kernel)."""
    m, d = a.shape
    n = b.shape[1]
    total = torch.zeros((m, n), dtype=torch.float32)
    depth = CHUNK if chunked else STEP
    for c0 in range(0, d, depth):
        steps = []
        for k0 in range(c0, min(c0 + depth, d), STEP):
            ahi, alo = tf32_split(a[:, k0:k0 + STEP].float())
            bhi, blo = tf32_split(b[k0:k0 + STEP].float())
            steps.append((ahi, alo, bhi, blo))
        part = torch.zeros((m, n), dtype=torch.float32)
        for ahi, alo, bhi, blo in steps:
            part = _mma_sum(part, alo, bhi)
            part = _mma_sum(part, ahi, blo)
            if not chunked:
                part = _mma_sum(part, ahi, bhi)
        if chunked:
            for ahi, _, bhi, _ in steps:
                part = _mma_sum(part, ahi, bhi)
        total = total + part
    return total


def gated(g: torch.Tensor, gate):
    return g if gate is None else torch.where(gate > 0, g, torch.zeros((), dtype=g.dtype))


def column_tile(n: int) -> int:
    """The mma.sync weight-gradient kernel's column tile for a cotangent width n."""
    return 128 if n > 64 else 64 if n > 8 else 8


def in_reduce_order(partials):
    """The splits' partials added as the reduce kernel adds them: warp w sums
    splits w, w + 8, ... in order, then the eight warps' sums in warp order."""
    warps = []
    for w in range(min(REDUCE_WARPS, len(partials))):
        v = partials[w]
        for p in partials[w + REDUCE_WARPS::REDUCE_WARPS]:
            v = v + p
        warps.append(v)
    total = warps[0]
    for v in warps[1:]:
        total = total + v
    return total


def bias_sums(g: torch.Tensor, rows: int) -> torch.Tensor:
    """The weight-gradient kernel's column sums of g [M, N]: per split, thread
    c + TN q keeps column c of rows q, q + 256 / TN, ... of each 32-row chunk
    in order, the threads of a column added in thread order, the splits'
    sums in split order."""
    m, n = g.shape
    tn = column_tile(n)
    per_col = THREADS // tn
    g = torch.nn.functional.pad(g, (0, -n % tn))
    sums = []
    for r0 in range(0, m, rows):
        block = g[r0:r0 + rows]
        threads = torch.zeros((per_col, g.shape[1]), dtype=torch.float32)
        for c0 in range(0, block.shape[0], CHUNK):
            chunk = block[c0:c0 + CHUNK]
            for r in range(chunk.shape[0]):
                threads[r % per_col] = threads[r % per_col] + chunk[r]
        split_sum = threads[0]
        for q in range(1, per_col):
            split_sum = split_sum + threads[q]
        sums.append(split_sum)
    return in_reduce_order(sums)[:n]


def wgrad(x: torch.Tensor, g: torch.Tensor):
    """(x^T g, the per-split partials) as the weight-gradient kernel sums it."""
    splits, rows = fp.wgrad_partition(x.shape[0])
    partials = []
    for s in range(splits):
        xs, gs = x[s * rows:(s + 1) * rows], g[s * rows:(s + 1) * rows]
        acc = torch.zeros((x.shape[1], g.shape[1]), dtype=torch.float32)
        for r0 in range(0, xs.shape[0], STEP):  # one running sum, three terms a step
            ahi, alo = tf32_split(xs[r0:r0 + STEP].t().contiguous())
            bhi, blo = tf32_split(gs[r0:r0 + STEP].contiguous())
            acc = _mma_sum(acc, alo, bhi)
            acc = _mma_sum(acc, ahi, blo)
            acc = _mma_sum(acc, ahi, bhi)
        partials.append(acc)
    return in_reduce_order(partials), partials


def emulated_fwd(x, w, b, relu):
    y = product(x, w, rows_on_wgmma(*w.shape))
    if b is not None:
        y = y + b
    y = torch.relu(y) if relu else y
    if x.shape[0]:
        fp.LAUNCHES["fwd"] += 1
    return y


def emulated_dgrad(g, gate, w):
    dx = product(gated(g, gate), w.t(), rows_on_wgmma(w.shape[1], w.shape[0]))
    if g.shape[0]:
        fp.LAUNCHES["dgrad"] += 1
    return dx


def emulated_wgrad(x, g, gate, w, with_bias):
    dw = fp._grad_like(w)
    if x.shape[0] == 0:
        return dw.zero_(), torch.zeros(g.shape[1]) if with_bias else None
    gg = gated(g, gate)
    total, _ = wgrad(x, gg)
    dw.copy_(total)
    db = bias_sums(gg, fp.wgrad_partition(x.shape[0])[1]) if with_bias else None
    fp.LAUNCHES["wgrad"] += 1
    return dw, db


@contextmanager
def through_emulation():
    """``ops/f32_product`` with CPU f32 tensors taking ``F32Product`` over the emulated kernels."""
    with mock.patch.object(fp, "takes", lambda x: x.dtype == torch.float32), \
            mock.patch.object(fp, "_launch_fwd", emulated_fwd), \
            mock.patch.object(fp, "_launch_dgrad", emulated_dgrad), \
            mock.patch.object(fp, "_launch_wgrad", emulated_wgrad):
        yield
