"""The port's row gather (ops/row_gather.py) against the TPU probe's three
Pallas kernels run in interpret mode on the CPU, and the ported probe.

The kernels are loaded by path from scripts/gather_kernel_probe.py and
wrapped in ``pl.pallas_call(..., interpret=True)`` over E = 2 * TILE
indices; a gather is exact, so every comparison is ``torch.equal``.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sgnn_tpu_torch.ops import row_gather as rg
from sgnn_tpu_torch.scripts import gather_kernel_probe as tprobe

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ROWS, W = 96, 16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
WRAPPERS = {"loop": rg.row_gather_loop, "unroll8": rg.row_gather_unroll8, "take": rg.row_gather_take}


def _probe_module():
    """The TPU probe's constants and kernel functions, executed from its
    source. Its other top-level statements (which point JAX's persistent
    compilation cache at a directory) are left out, so that loading it
    changes no setting of this test process."""
    path = REPO / "scripts" / "gather_kernel_probe.py"
    keep = [
        node for node in ast.parse(path.read_text()).body
        if (isinstance(node, ast.FunctionDef) and node.name.startswith("_gather_"))
        or (isinstance(node, ast.Assign) and all(isinstance(t, ast.Name) and t.id.isupper() for t in node.targets))
    ]
    namespace = {"jax": jax, "jnp": jnp, "pl": pl}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), namespace)
    return SimpleNamespace(**namespace)


PROBE = _probe_module()
E = 2 * PROBE.TILE
PALLAS = {"loop": PROBE._gather_loop_kernel, "unroll8": PROBE._gather_unroll8_kernel,
          "take": PROBE._gather_take_kernel}


def pallas_gather(kernel, tbl: np.ndarray, idx: np.ndarray, jdtype) -> torch.Tensor:
    """The TPU kernel over tbl [ROWS, W] and idx [E] (as [E, 1] int32, the
    probe's layout), in interpret mode; returned as a torch tensor."""
    rows, w = tbl.shape
    out = pl.pallas_call(
        kernel,
        grid=(len(idx) // PROBE.TILE,),
        in_specs=[pl.BlockSpec((PROBE.TILE, 1), lambda i: (i, 0)), pl.BlockSpec((rows, w), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((PROBE.TILE, w), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((len(idx), w), jdtype),
        interpret=True,
    )(jnp.asarray(idx.astype(np.int32)[:, None]), jnp.asarray(tbl, jdtype))
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _inputs(rng, dtype):
    tbl = torch.from_numpy(rng.normal(size=(ROWS, W)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, ROWS, E)
    return tbl, idx


@pytest.mark.parametrize("variant", list(WRAPPERS))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wrappers_equal_the_pallas_kernels(rng, variant, dt):
    jdtype, tdtype = DTYPES[dt]
    tbl, idx = _inputs(rng, tdtype)
    want = pallas_gather(PALLAS[variant], tbl.float().numpy(), idx, jdtype).to(tdtype)
    for itype in (torch.int32, torch.int64):
        t_idx = torch.from_numpy(idx).to(itype)
        assert torch.equal(rg.row_gather_reference(tbl, t_idx), want)
        got = WRAPPERS[variant](tbl, t_idx)
        assert got.dtype == tdtype and got.shape == (E, W)
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", list(WRAPPERS))
def test_wrappers_take_any_index_shape(rng, variant):
    tbl, idx = _inputs(rng, torch.float32)
    idx2 = torch.from_numpy(idx[: 64 * 24].reshape(64, 24)).int()
    got = WRAPPERS[variant](tbl, idx2)
    assert got.shape == (64, 24, W)
    assert torch.equal(got, tbl[idx2.long()])
    assert torch.equal(rg.row_gather(tbl, idx2), got)


@pytest.mark.parametrize("variant", ["loop", "unroll8"])
def test_out_of_range_indices_are_clamped(rng, variant):
    """Past the end reads the last row, as the TPU kernels' dynamic row
    reads clamp; below 0 reads row 0 (XLA's gather clamps; JAX's indexing
    would first wrap a negative index, which no graph of the repo holds)."""
    tbl, idx = _inputs(rng, torch.float32)
    idx[[3, 700, 1500]] = [ROWS, ROWS + 7, 10**6]
    want = pallas_gather(PALLAS[variant], tbl.numpy(), idx, jnp.float32)
    assert torch.equal(want[[3, 700, 1500]], tbl[[ROWS - 1] * 3])
    idx_neg = idx.copy()
    idx_neg[[5, 9]] = [-1, -(2**40)]
    for t_idx in (torch.from_numpy(idx).int(), torch.from_numpy(idx_neg)):
        got = WRAPPERS[variant](tbl, t_idx)
        assert torch.equal(got, rg.row_gather_reference(tbl, t_idx))
    assert torch.equal(WRAPPERS[variant](tbl, torch.from_numpy(idx).int()), want)
    assert torch.equal(got[[5, 9]], tbl[[0, 0]])


@pytest.mark.parametrize("variant", list(WRAPPERS))
def test_wrappers_refuse_what_the_kernel_does_not_take(variant):
    fn = WRAPPERS[variant]
    tbl = torch.zeros(8, 16)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(tbl.double(), idx)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(tbl.half(), idx)
    with pytest.raises(TypeError, match="int32 or int64"):
        fn(tbl, idx.short())
    with pytest.raises(TypeError, match="int32 or int64"):
        fn(tbl, idx.float())
    with pytest.raises(ValueError, match="16 bytes"):
        fn(torch.zeros(8, 6), idx)  # 24-byte f32 rows
    with pytest.raises(ValueError, match="16 bytes"):
        fn(torch.zeros(8, 4, dtype=torch.bfloat16), idx)  # 8-byte bf16 rows
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(16, 8).t(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        fn(tbl, torch.zeros(4, 2, dtype=torch.int32)[:, 0])
    with pytest.raises(ValueError, match=r"\[rows >= 1, W\] table"):
        fn(torch.zeros(16), idx)
    with pytest.raises(ValueError, match=r"\[rows >= 1, W\] table"):
        fn(torch.zeros(0, 16), idx)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fn(torch.zeros(8 * 16 + 1)[1:].view(8, 16), idx)
    with pytest.raises(ValueError, match="one cpu or cuda device"):
        fn(torch.zeros(8, 16, device="meta"), idx)
    with pytest.raises(NotImplementedError, match="sorted_gather, planned_gather or ordered_gather"):
        fn(tbl.requires_grad_(True), idx)  # a bare gather has no backward; the model's Functions do
    with torch.no_grad():  # no graph is built, so no backward is needed
        assert torch.equal(fn(tbl, idx), torch.zeros(4, 16))


def test_widths_the_kernels_take():
    idx = torch.tensor([2, 0, 1], dtype=torch.int64)
    for tbl in (torch.arange(12.0).view(3, 4), torch.arange(24.0).view(3, 8).bfloat16()):
        for fn in WRAPPERS.values():
            assert torch.equal(fn(tbl, idx), tbl[idx])
            assert fn(tbl, idx[:0]).shape == (0, tbl.shape[1])


def test_probe_inputs_are_the_tpu_probes():
    tbl, idx = tprobe.probe_inputs(torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(0)  # the TPU probe's draws, in its order
    want_idx = rng.integers(0, 38376, (PROBE.E, 1))[:, 0]
    want_tbl = rng.normal(size=(PROBE.M_PAD, PROBE.H))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(tbl.numpy(), want_tbl.astype(np.float32))
    assert (tprobe.M_PAD, tprobe.E, tprobe.H, tprobe.ITERS) == (PROBE.M_PAD, PROBE.E, PROBE.H, PROBE.ITERS)
    assert idx.dtype == torch.int32


def test_probe_runs_and_checks_every_variant_on_cpu(capsys):
    times = tprobe.run_probe(torch.bfloat16, "cpu", iters=1)
    assert set(times) == {"index_select", "loop", "unroll8", "take"}
    out = capsys.readouterr().out
    assert out.count("correct=True") == 3 and "correct=False" not in out


def test_probe_raises_on_a_wrong_variant(monkeypatch):
    monkeypatch.setitem(tprobe.KERNELS, "take", lambda t, i: rg.row_gather_reference(t, i + 1))
    with pytest.raises(AssertionError, match="take"):
        tprobe.run_probe(torch.float32, "cpu", iters=1)
