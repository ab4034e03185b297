"""Row-gather probe: the three row-gather kernels against ``index_select``.

Port of ``scripts/gather_kernel_probe.py``: the same shapes (a
``[M_PAD, H]`` table, ``E`` int32 indices drawn from its first 38,376
rows), the same data (numpy ``default_rng(0)``: the indices, then the
table) in bf16, or in f32 with ``--dtype float32``. It times the library
gather (``index_select``, the TPU script's ``xla`` line) and each kernel
of ``ops/row_gather.py`` over ``ITERS`` launches, and checks each kernel
with ``torch.equal`` against ``tbl[idx]``. A variant that fails raises::

  python -m sgnn_tpu_torch.scripts.gather_kernel_probe [--dtype bfloat16|float32] [--device cuda|cpu]

On the card, the ``ITERS`` calls are captured in one CUDA graph and its
replay is timed with CUDA events: the counterpart of the TPU probe's
``lax.scan``, which runs its ``ITERS`` gathers in one compiled program,
so neither figure holds the host's launch time. A replay re-runs the
captured launches without counting them in ``row_gather.LAUNCHES``. On
the CPU (``--device cpu``, the plain versions) times come from the host
clock.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sgnn_tpu_torch.ops import row_gather as rg
from sgnn_tpu_torch.utils.device import Device, resolve_device

M_PAD = 38384  # 38376 rounded up to 8 sublanes
E = 307008
H = 64
ITERS = 300
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KERNELS = {"loop": rg.row_gather_loop, "unroll8": rg.row_gather_unroll8, "take": rg.row_gather_take}


def probe_inputs(dtype: torch.dtype, device: torch.device):
    """(tbl [M_PAD, H] in ``dtype``, idx [E] int32), drawn as the TPU probe draws them."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 38376, (E, 1)).astype(np.int32)[:, 0]
    tbl = torch.from_numpy(rng.normal(size=(M_PAD, H)).astype(np.float32)).to(dtype)
    return tbl.to(device), torch.from_numpy(idx).to(device)


def time_ms(fn: Callable[[], torch.Tensor], iters: int, device: torch.device) -> float:
    """Mean ms per call of ``iters`` calls: on the card, the replay of one
    CUDA graph holding them, between two CUDA events (after warm-up calls
    on a side stream and one replay); on the CPU, by the host clock after
    one warm-up call."""
    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def run_probe(dtype: torch.dtype = torch.bfloat16, device: Device = None, iters: int = ITERS) -> Dict[str, float]:
    """Times (ms per call) of ``index_select`` and of each kernel; raises
    if a kernel's output is not ``tbl[idx]`` bit for bit."""
    dev = resolve_device(device)
    tbl, idx = probe_inputs(dtype, dev)
    ref = tbl[idx.long()]
    name = str(dtype).removeprefix("torch.")
    times = {"index_select": time_ms(lambda: torch.index_select(tbl, 0, idx), iters, dev)}
    print(f"index_select    : {times['index_select']:7.4f} ms   ({name}, tbl {tuple(tbl.shape)}, {E} indices, {dev})")
    failed = []
    for variant, fn in KERNELS.items():
        ok = torch.equal(fn(tbl, idx), ref)
        times[variant] = time_ms(lambda fn=fn: fn(tbl, idx), iters, dev)
        print(f"row_gather {variant:8}: {times[variant]:7.4f} ms   correct={ok}")
        if not ok:
            failed.append(variant)
    if failed:
        raise AssertionError(f"row_gather {failed} differ from tbl[idx] ({name})")
    return times


def main(argv: Optional[list] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="Row-gather kernels against index_select")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    parser.add_argument("--device", type=str, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run_probe(DTYPES[args.dtype], args.device)


if __name__ == "__main__":
    main()
