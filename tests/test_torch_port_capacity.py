"""The port's capacity knobs against JAX on the CPU: the packed gather, the
banded gathers, band_violations, the remat modes, deeper edge MLPs in the
flat forward, forward_batched's routes and guard count, and one training
step with remat and a band (the counterparts of
``tests/test_epd_flat.py:196-500``).

The same seeded numpy inputs go through ``sgnn_tpu`` and ``sgnn_tpu_torch``;
JAX's weights are carried across by ``utils/jax_params``. Where the port
runs one route against another (packed against unfused, banded against
unbanded, every remat mode against none) the results are held equal with
``torch.equal``; against JAX, within the stated tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.models import EPDConfig, encode_process_decode_init
from sgnn_tpu.models import epd_flat as jflat
from sgnn_tpu.ops import radius_neighbors_bruteforce
from sgnn_tpu.ops import sym_gather as jsg
from sgnn_tpu.physics import noise as jnoise
from sgnn_tpu.physics import simulator as jsim
from sgnn_tpu_torch.models import encode_process_decode as tepd
from sgnn_tpu_torch.models import epd_flat as tflat
from sgnn_tpu_torch.ops import edge_block as teb
from sgnn_tpu_torch.ops import sym_gather as tsg
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.utils.jax_params import state_dict_from_jax

torch.set_num_threads(1)

EPD = "_encode_process_decode."
REMATS = (True, "xj", "xj_msg", "full", "group")
# gradients against JAX: the limit the port's step tests hold
# (tests/test_torch_port_train.py): 1e-4 relative + 1e-5 of the tensor's scale
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
FWD_TOL = dict(rtol=5e-5, atol=5e-5)  # tests/test_torch_port_model.py


def port_epd(params, jcfg):
    epd = tepd.EncodeProcessDecode(tepd.EPDConfig(
        jcfg.node_in, jcfg.edge_in, jcfg.node_out, jcfg.latent_dim,
        jcfg.num_message_passing_steps, jcfg.num_mlp_layers,
    ))
    sd = state_dict_from_jax({"epd": jax.tree.map(np.asarray, params)})
    epd.load_state_dict({k[len(EPD):]: v for k, v in sd.items()}, strict=True)
    return epd


def jax_grads_as_port(grads) -> dict:
    return {k[len(EPD):]: v for k, v in state_dict_from_jax({"epd": jax.tree.map(np.asarray, grads)}).items()}


def assert_grads_close(epd, want: dict):
    for name, p in epd.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(w.abs().max()), err_msg=name)


def make_batch(rng, b=2, n=40, k=8):
    pos = rng.uniform(-1, 1, size=(b, n, 2)).astype(np.float32)
    nls = [radius_neighbors_bruteforce(jnp.asarray(p), 0.5, max_neighbors=k) for p in pos]
    return np.stack([np.asarray(nl.senders) for nl in nls]), np.stack([np.asarray(nl.mask) for nl in nls])


def sym_fixture(rng, n=64, k=16, radius=0.45):
    """One symmetric graph (its cap never binds) and JAX's model on it."""
    cfg = EPDConfig(node_in=7, edge_in=3, node_out=3, latent_dim=16,
                    num_message_passing_steps=2, num_mlp_layers=1)
    params = encode_process_decode_init(jax.random.key(0), cfg)
    pos = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    nl = radius_neighbors_bruteforce(jnp.asarray(pos), radius, max_neighbors=k)
    assert int(np.asarray(nl.mask).sum(1).max()) < k
    nf = rng.normal(size=(n, cfg.node_in)).astype(np.float32)
    return cfg, params, pos, np.asarray(nl.senders), np.asarray(nl.mask), nf


# --- the packed gather ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_packed_gather_path_exact(rng, dtype):
    """encode_process_decode_apply_flat_fused == apply_flat with the edge
    features and reverse index built apart, bit for bit: outputs and every
    gradient; and in f32 within tolerance of JAX's fused entry."""
    cfg, params, pos, senders, mask, nf = sym_fixture(rng)
    n, k = senders.shape
    radius = 0.45
    epd = port_epd(params, cfg)
    tpos, ts, tm, tnf = (torch.from_numpy(a) for a in (pos, senders, mask, nf))
    w = torch.from_numpy(rng.normal(size=(n, cfg.node_out)).astype(np.float32))

    def unfused():
        ef = tflat.edge_features_from(tpos[ts.long()], tpos, tm, radius)
        rev = tsg.reverse_edge_positions(ts, tm)
        return tflat.encode_process_decode_apply_flat(
            epd, tnf, ef.reshape(n * k, -1), ts.reshape(-1).long(), tm.sum(-1, keepdim=True).float(), k,
            compute_dtype=dtype, rev=rev)

    def fused():
        return tflat.encode_process_decode_apply_flat_fused(epd, tnf, tpos, ts, tm, radius, compute_dtype=dtype)

    results = []
    for fn in (unfused, fused):
        epd.zero_grad()
        out = fn()
        (out * w).sum().backward()
        results.append([out.detach()] + [p.grad.clone() for p in epd.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)

    if dtype is None:
        want = jflat.encode_process_decode_apply_flat_fused(
            params, jnp.asarray(nf), jnp.asarray(pos), jnp.asarray(senders), jnp.asarray(mask), radius,
            use_pallas=False)
        np.testing.assert_allclose(results[1][0].numpy(), np.asarray(want), **FWD_TOL)


def test_packed_sym_gather_equals_jax(rng):
    """The packed gather's four outputs equal JAX's (bit for bit: a gather
    is a copy), -1 sender columns included, and its proj gradient equals
    jax.vjp's within f32 summation order."""
    _, _, pos, senders, mask, _ = sym_fixture(rng)
    n, k = senders.shape
    proj = rng.normal(size=(n, 16)).astype(np.float32)
    cot = rng.normal(size=(n * k, 16)).astype(np.float32)
    out, vjp = jax.vjp(lambda p: jsg.packed_sym_gather(jnp.asarray(pos), p, jnp.asarray(senders),
                                                        jnp.asarray(mask))[1], jnp.asarray(proj))
    (want_g,) = vjp(jnp.asarray(cot))
    want = jsg.packed_sym_gather(jnp.asarray(pos), jnp.asarray(proj), jnp.asarray(senders), jnp.asarray(mask))
    tp = torch.from_numpy(proj).requires_grad_(True)
    got = tsg.packed_sym_gather(torch.from_numpy(pos), tp, torch.from_numpy(senders), torch.from_numpy(mask))
    assert not mask.all()  # some slots carry -1 through the f32 table
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    got[1].backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-5)


def test_gather_rows_packed_equals_plain(rng):
    """gather_rows on a table in JAX's P = 4 packing window returns exactly
    table[idx], as JAX's does."""
    rows, h = 512 * 1024, 8
    assert jsg._PACK_GATHER_MIN_ROWS <= rows <= 1_200_000
    tbl = rng.normal(size=(rows, h)).astype(np.float32)
    idx = rng.integers(0, rows, (1000, 3)).astype(np.int32)
    got = tsg.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), tbl[idx])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsg.gather_rows(jnp.asarray(tbl), jnp.asarray(idx))))


# --- the banded gathers ---------------------------------------------------------------


def _break_band(rng, idx, e, count=25):
    """Some indices moved far outside any band."""
    out = idx.copy()
    where = rng.choice(out.size, count, replace=False)
    out.reshape(-1)[where] = rng.integers(0, e, count)
    return out


def test_banded_gather_rows_exact_and_equal_to_jax_on_broken_bands(rng):
    """Single-level banded gathers (reverse-gather shape E == R, sender
    shape R == K * E with a ragged tile) equal table[idx] under the band,
    and equal JAX's banded_gather_rows where indices break it (JAX clamps
    into the window)."""
    n, k, w = 3000, 8, 40
    e = n * k
    send = np.clip(np.arange(n)[:, None] + rng.integers(-w, w + 1, (n, k)), 0, n - 1)
    idx = (send * k + rng.integers(0, k, (n, k))).astype(np.int32)
    tbl = rng.normal(size=(e, 16)).astype(np.float32)
    band = (w + 1) * k
    for ids, table, b, tile in ((idx, tbl, band, 2048), (send.astype(np.int32), tbl[:n], w, 2048 + 512)):
        got = tsg.banded_gather_rows(torch.from_numpy(table), torch.from_numpy(ids), b, tile)
        np.testing.assert_array_equal(got.numpy(), table[ids])
        bad = _break_band(rng, ids, table.shape[0])
        got = tsg.banded_gather_rows(torch.from_numpy(table), torch.from_numpy(bad), b, tile)
        want = np.asarray(jsg.banded_gather_rows(jnp.asarray(table), jnp.asarray(bad), b, tile))
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.array_equal(want, table[bad])  # the band broke: JAX read other rows


def test_banded_gather_rows_chunked_equals_jax(rng, monkeypatch):
    """The two-level (chunked) form with JAX's ceilings forced down: equal
    to table[idx] under the band and to JAX's also on broken bands, in the
    three caller geometries (E == R, R == K * E, E == q * R)."""
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "_BANDED_MAX_ROWS", 600)
        monkeypatch.setattr(mod, "_BANDED_TILE_ROWS", 64)
    band, h, e, k = 7, 5, 2000, 4
    tbl = rng.normal(size=(e, h)).astype(np.float32)
    base = [np.arange(e), np.repeat(np.arange(e), k), np.arange(500) * (e // 500)]
    for b0 in base:
        ids = np.clip(b0 + rng.integers(-band, band + 1, b0.size), 0, e - 1).astype(np.int32)
        got = tsg.banded_gather_rows(torch.from_numpy(tbl), torch.from_numpy(ids), band)
        np.testing.assert_array_equal(got.numpy(), tbl[ids])
        bad = _break_band(rng, ids, e, count=10)
        got = tsg.banded_gather_rows(torch.from_numpy(tbl), torch.from_numpy(bad), band)
        want = np.asarray(jsg.banded_gather_rows(jnp.asarray(tbl), jnp.asarray(bad), band))
        np.testing.assert_array_equal(got.numpy(), want)


def test_band_violations_equal_jax(rng):
    n, k, w = 300, 8, 10
    send = np.clip(np.arange(n)[:, None] + rng.integers(-w, w + 1, (n, k)), 0, n - 1).astype(np.int32)
    mask = rng.uniform(size=(n, k)) < 0.9
    bad = _break_band(rng, send, n, count=12)
    for s in (send, bad):
        for band, halo in ((w, 0), (w - 3, 0), (w, 2)):
            want = int(jsg.band_violations(jnp.asarray(s), jnp.asarray(mask), band, halo))
            got = tsg.band_violations(torch.from_numpy(s), torch.from_numpy(mask), band, halo)
            assert int(got) == want
    assert int(tsg.band_violations(torch.from_numpy(send), torch.ones(n, k, dtype=torch.bool), w)) == 0


@pytest.mark.parametrize("n", [512, 2048])
def test_sym_gather_band_matches_unbanded(rng, monkeypatch, n):
    """sym_gather, packed_sym_gather and the ordered (non-symmetric) sender
    gather with band_nodes: outputs and gradients bit-equal to the unbanded
    ones (thresholds forced down to test size), and the banded routes ran
    (the sender gathers only where the table outgrows one window: n = 2048)."""
    k, h, w = 8, 16, 20
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "_BANDED_TILE_ROWS", 512)
    pos = np.stack([np.arange(n) * 0.01, np.zeros(n)], -1).astype(np.float32)  # x-sorted line
    nl = radius_neighbors_bruteforce(jnp.asarray(pos), 0.035, max_neighbors=k)
    senders, mask = torch.from_numpy(np.array(nl.senders)), torch.from_numpy(np.array(nl.mask))
    rev_pos, rev_ok = tsg.reverse_edge_positions(senders, mask)
    idx = senders.reshape(-1).long()
    table = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(n * k, h)).astype(np.float32)) * mask.reshape(-1, 1)

    def run(band):
        t = table.clone().requires_grad_(True)
        out = tsg.sym_gather(t, idx, rev_pos, rev_ok, band)
        out.backward(cot)
        p = table.clone().requires_grad_(True)
        packed = tsg.packed_sym_gather(torch.from_numpy(pos), p, senders, mask, None, band)
        packed[1].backward(cot)
        o = table.clone().requires_grad_(True)
        ordered = tflat.sender_gather(idx, n, None, band)(o)
        ordered.backward(cot)
        return [out.detach(), t.grad] + [a.detach() for a in packed] + [p.grad, ordered.detach(), o.grad]

    ref = run(None)
    monkeypatch.setattr(tsg, "_BANDED_MIN_ROWS", 64)
    before = dict(tsg.BANDED)
    got = run(w)
    assert tsg.BANDED["reverse"] == before["reverse"] + 2
    assert tsg.BANDED["forward"] == before["forward"] + (3 if n > 512 else 0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# --- the remat modes and deeper edge MLPs ---------------------------------------------


@pytest.mark.parametrize("num_mlp_layers", [1, 2])
def test_remat_matches_plain(rng, num_mlp_layers):
    """Every remat mode changes memory, not math: outputs and gradients
    torch.equal to remat=False (for one hidden layer the fused edge block's
    plain version, for two the plain edge stage), and each mode's gradients
    within the step tests' limit of JAX's for the same mode."""
    b, n, k = 2, 40, 8
    cfg = EPDConfig(node_in=7, edge_in=3, node_out=3, latent_dim=16,
                    num_message_passing_steps=3, num_mlp_layers=num_mlp_layers)
    params = encode_process_decode_init(jax.random.key(0), cfg)
    senders, mask = make_batch(rng, b, n, k)
    nf = rng.normal(size=(b * n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(b * n * k, cfg.edge_in)).astype(np.float32)
    js, jd = jflat.flatten_batch_graph(jnp.asarray(senders), jnp.asarray(mask), n)
    ts, td = tflat.flatten_batch_graph(torch.from_numpy(senders).long(), torch.from_numpy(mask), n)
    epd = port_epd(params, cfg)

    def port(remat):
        epd.zero_grad()
        out = tflat.encode_process_decode_apply_flat(epd, torch.from_numpy(nf), torch.from_numpy(ef), ts, td, k,
                                                     remat=remat)
        out.square().sum().backward()
        return [out.detach()] + [p.grad.clone() for p in epd.parameters()]

    def jax_grads(remat):
        return jax.grad(lambda p: jnp.sum(jflat.encode_process_decode_apply_flat(
            p, jnp.asarray(nf), jnp.asarray(ef), js, jd, k, use_pallas=False, remat=remat) ** 2))(params)

    ref = port(False)
    for mode in REMATS:
        got = port(mode)
        for a, b_ in zip(got, ref):
            assert torch.equal(a, b_), mode
        assert_grads_close(epd, jax_grads_as_port(jax_grads(mode)))


def test_remat_launch_counts_follow_the_design(rng, monkeypatch):
    """The edge block's forward and backward calls per training step in
    each mode (the plain versions stand in for the kernels on the CPU; the
    card counts the same launches): chip_smoke.py's phase 12 asserts these
    counts, with the take kernel's from the same design."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = teb.edge_block_fwd, teb.edge_block_bwd

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(teb, "edge_block_fwd", count_fwd)
    monkeypatch.setattr(teb, "edge_block_bwd", count_bwd)
    b, n, k, layers = 2, 40, 8, 5
    cfg = EPDConfig(node_in=7, edge_in=3, node_out=3, latent_dim=16, num_message_passing_steps=layers)
    epd = port_epd(encode_process_decode_init(jax.random.key(0), cfg), cfg)
    senders, mask = make_batch(rng, b, n, k)
    ts, td = tflat.flatten_batch_graph(torch.from_numpy(senders).long(), torch.from_numpy(mask), n)
    nf = torch.from_numpy(rng.normal(size=(b * n, 7)).astype(np.float32))
    ef = torch.from_numpy(rng.normal(size=(b * n * k, 3)).astype(np.float32))
    # "group": each of the two groups is recomputed once, then each of its
    # nested "full" layers again, so each layer's forward runs three times
    # (as JAX's nested jax.checkpoint)
    want = {False: (5, 5), "xj": (10, 5), "xj_msg": (5, 5), "full": (10, 5), "group": (15, 5)}
    for mode, (f, bw) in want.items():
        calls.update(fwd=0, bwd=0)
        tflat.encode_process_decode_apply_flat(epd, nf, ef, ts, td, k, remat=mode).sum().backward()
        assert (calls["fwd"], calls["bwd"]) == (f, bw), mode


def test_remat_holds_what_the_design_says(rng, monkeypatch):
    """Which layers' edge latents the forward leaves alive for the backward
    in each mode (5 layers): every layer's without remat and under
    "full" (its layer inputs), only the two groups' inputs (layers 0 and
    3) under "group", whose nested layers' inputs are recomputed."""
    import gc
    import weakref

    held = []
    edge_stage = tflat._edge_stage

    def record(block, x, e, *rest):
        held.append(weakref.ref(e))
        return edge_stage(block, x, e, *rest)

    monkeypatch.setattr(tflat, "_edge_stage", record)
    b, n, k, layers = 2, 40, 8, 5
    cfg = EPDConfig(node_in=7, edge_in=3, node_out=3, latent_dim=16, num_message_passing_steps=layers)
    epd = port_epd(encode_process_decode_init(jax.random.key(0), cfg), cfg)
    senders, mask = make_batch(rng, b, n, k)
    ts, td = tflat.flatten_batch_graph(torch.from_numpy(senders).long(), torch.from_numpy(mask), n)
    nf = torch.from_numpy(rng.normal(size=(b * n, 7)).astype(np.float32))
    ef = torch.from_numpy(rng.normal(size=(b * n * k, 3)).astype(np.float32))
    want = {False: [0, 1, 2, 3, 4], "full": [0, 1, 2, 3, 4], "group": [0, 3]}
    for mode, alive in want.items():
        held.clear()
        out = tflat.encode_process_decode_apply_flat(epd, nf, ef, ts, td, k, remat=mode)
        gc.collect()
        assert [i for i, ref in enumerate(held) if ref() is not None] == alive, mode
        out.sum().backward()
        del out


def test_flat_forward_two_layer_edge_mlp_matches_jax(rng):
    """num_mlp_layers = 2 in the flat forward (the plain edge stage) against
    JAX's encode_process_decode_apply_flat(use_pallas=False): outputs and
    gradients, f32; and in bf16 no weight gradient is rounded through bf16."""
    b, n, k = 2, 40, 8
    cfg = EPDConfig(node_in=7, edge_in=3, node_out=3, latent_dim=16,
                    num_message_passing_steps=2, num_mlp_layers=2)
    params = encode_process_decode_init(jax.random.key(4), cfg)
    senders, mask = make_batch(rng, b, n, k)
    nf = rng.normal(size=(b * n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(b * n * k, cfg.edge_in)).astype(np.float32)
    wout = rng.normal(size=(b * n, cfg.node_out)).astype(np.float32)
    js, jd = jflat.flatten_batch_graph(jnp.asarray(senders), jnp.asarray(mask), n)

    def jloss(p):
        out = jflat.encode_process_decode_apply_flat(p, jnp.asarray(nf), jnp.asarray(ef), js, jd, k,
                                                     use_pallas=False)
        return jnp.sum(out * wout), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    epd = port_epd(params, cfg)
    ts, td = tflat.flatten_batch_graph(torch.from_numpy(senders).long(), torch.from_numpy(mask), n)
    out = tflat.encode_process_decode_apply_flat(epd, torch.from_numpy(nf), torch.from_numpy(ef), ts, td, k)
    (out * torch.from_numpy(wout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    assert_grads_close(epd, jax_grads_as_port(jg))

    epd.zero_grad()
    out = tflat.encode_process_decode_apply_flat(epd, torch.from_numpy(nf), torch.from_numpy(ef), ts, td, k,
                                                 compute_dtype=torch.bfloat16)
    out.sum().backward()
    for name, p in epd.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name


def test_dot_wf32_weight_gradient_is_f32(rng):
    """_DotWf32's weight gradient is the f32 product of the bf16 operands
    (any rank), where autograd's would round through bf16; in f32 it equals
    autograd's."""
    w = torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32))
    for shape in [(9, 16), (5, 4, 16)]:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        cot = torch.from_numpy(rng.normal(size=shape[:-1] + (12,)).astype(np.float32))
        wa = w.clone().requires_grad_(True)
        (tflat._DotWf32.apply(x, wa) * cot).sum().backward()
        wb = w.clone().requires_grad_(True)
        ((x @ wb) * cot).sum().backward()
        torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-6, atol=1e-5)
        wc = w.clone().requires_grad_(True)
        xb, cb = x.bfloat16(), cot.bfloat16()
        (tflat._DotWf32.apply(xb, wc) * cb).sum().backward()
        want = xb.float().reshape(-1, 16).t() @ cb.float().reshape(-1, 12)
        assert torch.equal(wc.grad, want)


# --- forward_batched's routes and the training step -----------------------------------


def sim_pair(rng, **kw):
    base = dict(dim=2, latent_dim=16, num_message_passing_steps=2, input_sequence_length=4,
                connectivity_radius=0.6, max_neighbors=12, domain=((-2.5, -2.5), (2.5, 2.5)))
    base.update(kw)
    jcfg, tcfg = jsim.SimulatorConfig(**base), tsim.SimulatorConfig(**base)
    params = jsim.simulator_init(jax.random.key(0), jcfg)
    sim = tsim.simulator_init(tcfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    jstats = jsim.NormStats(jnp.zeros(2), jnp.ones(2), jnp.zeros(2), jnp.ones(2))
    tstats = tsim.NormStats(torch.zeros(2), torch.ones(2), torch.zeros(2), torch.ones(2))
    return jcfg, tcfg, params, sim, jstats, tstats


def drifting(rng, b, n, s, lo=-1.5, hi=1.5):
    pos = rng.uniform(lo, hi, size=(b, n, 2)).astype(np.float32)
    return (pos[:, :, None, :] + rng.normal(scale=0.01, size=(b, n, s, 2)).cumsum(2)).astype(np.float32)


def test_forward_batched_unpacked_sym_over_threshold(rng):
    """Past packed_gather_max_nodes the symmetric route builds its reverse
    index apart: outputs and gradients torch.equal to the packed route's;
    outputs within tolerance of JAX's forward_batched, gradients of JAX's
    plain route."""
    b, n, s = 2, 48, 4
    jcfg, tcfg, params, sim, jstats, tstats = sim_pair(rng, symmetric_gather=True)
    seq = drifting(rng, b, n, s)
    types = np.zeros((b, n), np.int32)
    unpacked = dataclasses.replace(tcfg, packed_gather_max_nodes=1)
    assert b * n > unpacked.packed_gather_max_nodes

    def run(cfg):
        sim.zero_grad()
        acc, strain = tsim.forward_batched(sim, cfg, tstats, torch.from_numpy(seq), torch.from_numpy(types).long())
        (acc.square().sum() + strain.square().sum()).backward()
        return [acc.detach(), strain.detach()] + [p.grad.clone() for p in sim.parameters()]

    ref, got = run(tcfg), run(unpacked)
    for a, b_ in zip(got, ref):
        assert torch.equal(a, b_)
    want = jsim.forward_batched(params, jcfg, jstats, jnp.asarray(seq), jnp.asarray(types), use_pallas=False)
    for a, w in zip(got[:2], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **FWD_TOL)

    def jloss(p):
        acc, strain = jsim.forward_batched(p, dataclasses.replace(jcfg, symmetric_gather=False), jstats,
                                           jnp.asarray(seq), jnp.asarray(types), use_pallas=False)
        return jnp.sum(acc**2) + jnp.sum(strain**2)

    want_g = state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    for (name, _), g in zip(sim.named_parameters(), got[2:]):
        w = want_g[name]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4, atol=1e-5 * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize("symmetric", [False, True], ids=["plain", "symmetric"])
def test_forward_batched_band_violations_equal_jax(rng, symmetric):
    """return_aux=True: the guard's count equals JAX's for a band that holds
    (0), a band that breaks, and no band (0); a device tensor."""
    b, n, s = 2, 48, 4
    jcfg, tcfg, params, sim, jstats, tstats = sim_pair(rng, symmetric_gather=symmetric)
    seq = drifting(rng, b, n, s)
    types = np.zeros((b, n), np.int32)
    for band in (None, 200, 20):
        jc, tc = dataclasses.replace(jcfg, band_nodes=band), dataclasses.replace(tcfg, band_nodes=band)
        *_, jaux = jsim.forward_batched(params, jc, jstats, jnp.asarray(seq), jnp.asarray(types),
                                        use_pallas=False, return_aux=True)
        with torch.no_grad():
            *_, taux = tsim.forward_batched(sim, tc, tstats, torch.from_numpy(seq), torch.from_numpy(types).long(),
                                            return_aux=True)
        assert isinstance(taux["band_violations"], torch.Tensor)
        assert int(taux["band_violations"]) == int(jaux["band_violations"])
        if band == 20:
            assert int(jaux["band_violations"]) > 0


@pytest.mark.parametrize("remat", ["full", True], ids=["full", "xj"])
def test_training_step_with_remat_and_band_matches_jax(rng, monkeypatch, remat):
    """One step of train's loss (make_train_step) with remat and band_nodes
    set, the banded thresholds forced down on both sides, against JAX's
    _make_step_body: the metrics (train/band_violations included) and the
    gradients within the step tests' limits; the parameters after the step
    equal those of the port's step with neither knob."""
    from test_torch_port_train import B, LOSS_TOL, jax_step, make_batch as train_batch, port_step, stats_pair
    from test_torch_port_train import train_cfg

    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "_BANDED_MIN_ROWS", 64)
        monkeypatch.setattr(mod, "_BANDED_MIN_FANOUT_ROWS", 64)
        monkeypatch.setattr(mod, "_BANDED_TILE_ROWS", 128)
    kw = dict(dim=2, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=1, connectivity_radius=0.6,
              input_sequence_length=6, max_neighbors=12, wall_x=-2.0, domain=((-3.0, -3.0), (6.0, 6.0)),
              symmetric_gather=True, band_nodes=8, remat=remat)
    jcfg, tcfg = jsim.SimulatorConfig(**kw), tsim.SimulatorConfig(**kw)
    jstats, tstats = stats_pair(rng)
    cfg = train_cfg()
    params = jsim.simulator_init(jax.random.key(0), jcfg)
    batch = train_batch(rng)
    key = jax.random.key(5)
    noise = jnoise.random_walk_position_noise(key, batch["positions"].shape, cfg.noise_std)
    jm, jgrads, _ = jax_step(jcfg, jstats, cfg, params, batch, key)
    before = dict(tsg.BANDED)
    tm, tgrads, _, after = port_step(tcfg, tstats, cfg, params, batch, noise)
    assert tsg.BANDED["reverse"] > before["reverse"]  # the banded route ran
    assert set(tm) == set(jm) and tm["train/band_violations"] == jm["train/band_violations"] == 0
    for name in jm:
        np.testing.assert_allclose(tm[name], jm[name], err_msg=name, **LOSS_TOL)
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, w in want_g.items():
        np.testing.assert_allclose(tgrads[name].numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(w.abs().max()), err_msg=name)
    plain = dataclasses.replace(tcfg, band_nodes=None, remat=False)
    _, _, _, after_plain = port_step(plain, tstats, cfg, params, batch, noise)
    for name, p in after.items():
        assert torch.equal(p, after_plain[name]), name
    # a band the batch breaks is counted, as JAX counts it
    tight = dict(kw, band_nodes=3)
    jm2, _, _ = jax_step(jsim.SimulatorConfig(**tight), jstats, cfg, params, batch, key)
    tm2, _, _, _ = port_step(tsim.SimulatorConfig(**tight), tstats, cfg, params, batch, noise)
    assert tm2["train/band_violations"] == jm2["train/band_violations"] > 0
    assert B == batch["positions"].shape[0]


# --- the knobs through the trainer ----------------------------------------------------


@pytest.fixture(scope="module")
def knob_env(tmp_path_factory):
    from sgnn_tpu_torch.data.builder import DatasetBuilder
    from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

    root = tmp_path_factory.mktemp("port_knobs")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root, root / "data"


def _knob_config(root, data, **kw):
    from sgnn_tpu_torch.train.config import TrainConfig

    base = dict(mode="train", data_path=str(data), model_path=str(root / "models"), output_path=str(root / "out"),
                layers=2, hidden_dim=16, dim=2, input_sequence_length=6, connection_radius=0.6, batch_size=2,
                noise_std=0.001, ntraining_steps=4, nsave_steps=4, log_every=2, lr_init=1e-3, run_name="knobs",
                pad_multiple=32, seed=0)
    base.update(kw)
    return TrainConfig(**base)


def test_train_with_remat_band_and_debug_graph(knob_env, capsys):
    """train(cfg, device="cpu") with debug_graph, remat "full" and a band:
    the audit line (no spot-check failure), train/band_violations logged at
    0, predict from its checkpoint; a band the data breaks is counted and
    warned about at the log point."""
    import json

    from sgnn_tpu_torch.train import train as ttrain

    root, data = knob_env
    cfg = _knob_config(root, data, debug_graph=True, remat="full", band_nodes=64, symmetric_gather=True)
    assert ttrain.train(cfg, device="cpu")["step"] == 4
    out = capsys.readouterr().out
    assert "graph audit" in out and "spot checks OK" in out and "WARNING" not in out
    lines = [json.loads(x) for x in (root / "models" / "knobs" / "metrics.jsonl").read_text().splitlines()]
    logged = [x for x in lines if "train/band_violations" in x]
    assert logged and all(x["train/band_violations"] == 0 for x in logged)
    meta = json.load(open(root / "models" / "knobs" / "checkpoint_meta.json"))
    summary = ttrain.predict(_knob_config(root, data, mode="rollout", model_file=meta["path"], remat="full",
                                          band_nodes=64), device="cpu")
    assert np.isfinite(summary["total"])

    ttrain.train(_knob_config(root, data, band_nodes=0, run_name="broken"), device="cpu")
    assert "banded-gather contract violations" in capsys.readouterr().out
