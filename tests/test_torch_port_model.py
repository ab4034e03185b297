"""Port EPD forwards (readable and flat) against the JAX package on CPU,
and pinned to the committed golden fixtures."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sgnn_tpu.experimental.edge_block as jeb
import sgnn_tpu.models.epd_flat as jflat
from sgnn_tpu.models import encode_process_decode as jepd
from sgnn_tpu.ops import radius_neighbors_bruteforce
from sgnn_tpu.ops.neighbors import NeighborList as JNeighborList
from sgnn_tpu_torch.models import encode_process_decode as tepd
from sgnn_tpu_torch.models import epd_flat as tflat
from sgnn_tpu_torch.ops.neighbors import NeighborList
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.utils.jax_params import state_dict_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol=5e-5)  # f32 sums in another order through 2-3 layers
GOLDEN_TOL = dict(rtol=2e-5, atol=2e-5)  # as tests/test_golden_parity.py
FIX = Path(__file__).parent / "fixtures"
EPD = "_encode_process_decode."


def port_epd(params, jcfg):
    """Port EncodeProcessDecode holding the JAX params (via the state_dict map)."""
    epd = tepd.EncodeProcessDecode(tepd.EPDConfig(
        jcfg.node_in, jcfg.edge_in, jcfg.node_out, jcfg.latent_dim,
        jcfg.num_message_passing_steps, jcfg.num_mlp_layers,
    ))
    sd = state_dict_from_jax({"epd": params})
    epd.load_state_dict({k[len(EPD):]: v for k, v in sd.items()}, strict=True)
    return epd


def graph_batch(rng, b, n, k):
    pos = rng.uniform(-1, 1, size=(b, n, 2)).astype(np.float32)
    nls = [radius_neighbors_bruteforce(jnp.asarray(p), 0.5, max_neighbors=k) for p in pos]
    return np.stack([np.asarray(nl.senders) for nl in nls]), np.stack([np.asarray(nl.mask) for nl in nls])


@pytest.mark.parametrize("num_mlp_layers", [1, 2])
def test_readable_forward_matches_jax(rng, num_mlp_layers):
    n, k = 40, 8
    cfg = jepd.EPDConfig(node_in=7, edge_in=3, node_out=3, latent_dim=32,
                         num_message_passing_steps=2, num_mlp_layers=num_mlp_layers)
    params = jepd.encode_process_decode_init(jax.random.key(0), cfg)
    senders, mask = graph_batch(rng, 1, n, k)
    nf = rng.normal(size=(n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(n, k, cfg.edge_in)).astype(np.float32)
    want = jepd.encode_process_decode_apply(
        params, jnp.asarray(nf), jnp.asarray(ef), JNeighborList(jnp.asarray(senders[0]), jnp.asarray(mask[0]))
    )
    epd = port_epd(params, cfg)
    nl = NeighborList(torch.from_numpy(senders[0]).long(), torch.from_numpy(mask[0]))
    with torch.no_grad():
        got = tepd.encode_process_decode_apply(epd, torch.from_numpy(nf), torch.from_numpy(ef), nl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _flat_inputs(rng, b, n, k, cfg):
    senders, mask = graph_batch(rng, b, n, k)
    nf = rng.normal(size=(b * n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(b * n * k, cfg.edge_in)).astype(np.float32)
    return senders, mask, nf, ef


def _jax_flat(params, senders, mask, nf, ef, n, k, use_pallas, compute_dtype=None):
    s_flat, deg = jflat.flatten_batch_graph(jnp.asarray(senders), jnp.asarray(mask), n)
    return np.asarray(
        jflat.encode_process_decode_apply_flat(
            params, jnp.asarray(nf), jnp.asarray(ef), s_flat, deg, k,
            use_pallas=use_pallas, compute_dtype=compute_dtype,
        )
    )


def _port_flat(epd, senders, mask, nf, ef, n, k, compute_dtype=None):
    s_flat, deg = tflat.flatten_batch_graph(torch.from_numpy(senders).long(), torch.from_numpy(mask), n)
    with torch.no_grad():
        return tflat.encode_process_decode_apply_flat(
            epd, torch.from_numpy(nf), torch.from_numpy(ef), s_flat, deg, k, compute_dtype
        ).numpy()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX flat path's fused kernel through interpret mode (the
    monkeypatch of tests/test_epd_flat.py)."""
    orig = jeb.fused_edge_block
    monkeypatch.setattr(
        jflat, "fused_edge_block",
        lambda *args: orig(*args[:-1], args[-1], True) if not isinstance(args[-1], bool) else orig(*args),
    )


@pytest.mark.parametrize("use_pallas", [False, True])
def test_flat_forward_matches_jax_flat(rng, use_pallas, pallas_interpret):
    b, n, k = 2, 32, 8
    cfg = jepd.EPDConfig(node_in=5, edge_in=3, node_out=3, latent_dim=16,
                         num_message_passing_steps=2, num_mlp_layers=1)
    params = jepd.encode_process_decode_init(jax.random.key(1), cfg)
    senders, mask, nf, ef = _flat_inputs(rng, b, n, k, cfg)
    want = _jax_flat(params, senders, mask, nf, ef, n, k, use_pallas)
    got = _port_flat(port_epd(params, cfg), senders, mask, nf, ef, n, k)
    np.testing.assert_allclose(got, want, **TOL)


def test_flat_forward_bf16_matches_jax_kernel(rng, pallas_interpret):
    b, n, k = 2, 32, 8
    cfg = jepd.EPDConfig(node_in=5, edge_in=3, node_out=3, latent_dim=32,
                         num_message_passing_steps=2, num_mlp_layers=1)
    params = jepd.encode_process_decode_init(jax.random.key(2), cfg)
    senders, mask, nf, ef = _flat_inputs(rng, b, n, k, cfg)
    want = _jax_flat(params, senders, mask, nf, ef, n, k, True, jnp.bfloat16)
    got = _port_flat(port_epd(params, cfg), senders, mask, nf, ef, n, k, torch.bfloat16)
    # bf16 edge latents round at the same points on both sides; where an f32
    # sum in another order flips a rounding, that latent moves by 2^-8
    # relative and reaches the f32 output damped through two layers. The
    # bound stays below the bf16-vs-f32 gap of these outputs (~2e-3), so a
    # port that rounded elsewhere would fail.
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# chip_smoke.BF16_GAP_FACTOR: two bf16 forwards that round at different points
# each lie about their bf16-vs-f32 gap from the f32 result, so within twice it
# of each other
BF16_GAP_FACTOR = 2.0


@pytest.mark.parametrize("latent", [32, 64])
def test_flat_forward_bf16_matches_jax_default_route(rng, latent):
    """The port's bf16 flat forward against JAX's default route
    (use_pallas=False, what JAX's train and predict run), which keeps h
    and msg in bf16 and folds agg into a bf16 product, where the port's
    kernel keeps h in f32 and rounds agg once. Held within BF16_GAP_FACTOR
    times that route's own bf16-vs-f32 gap (measured 1.63 and 1.38 of it)."""
    b, n, k = 2, 32, 8
    cfg = jepd.EPDConfig(node_in=5, edge_in=3, node_out=3, latent_dim=latent,
                         num_message_passing_steps=2, num_mlp_layers=1)
    params = jepd.encode_process_decode_init(jax.random.key(2), cfg)
    senders, mask, nf, ef = _flat_inputs(rng, b, n, k, cfg)
    default_bf16 = _jax_flat(params, senders, mask, nf, ef, n, k, False, jnp.bfloat16)
    default_f32 = _jax_flat(params, senders, mask, nf, ef, n, k, False)
    got = _port_flat(port_epd(params, cfg), senders, mask, nf, ef, n, k, torch.bfloat16)
    gap = float(np.abs(default_bf16 - default_f32).max())
    err = float(np.abs(got - default_bf16).max())
    assert 0.0 < gap and err <= BF16_GAP_FACTOR * gap, (err, gap)


def test_flat_forward_refuses_deeper_edge_mlps(rng):
    """Deeper edge MLPs (num_mlp_layers = 2) no longer raise: they take the
    plain edge stage, held to JAX's XLA route (use_pallas=False), and a
    remat value JAX does not know is refused."""
    b, n, k = 2, 32, 8
    cfg = jepd.EPDConfig(node_in=5, edge_in=3, node_out=3, latent_dim=16,
                         num_message_passing_steps=2, num_mlp_layers=2)
    params = jepd.encode_process_decode_init(jax.random.key(3), cfg)
    senders, mask, nf, ef = _flat_inputs(rng, b, n, k, cfg)
    want = _jax_flat(params, senders, mask, nf, ef, n, k, False)
    epd = port_epd(params, cfg)
    np.testing.assert_allclose(_port_flat(epd, senders, mask, nf, ef, n, k), want, **TOL)
    with pytest.raises(ValueError, match="remat"):
        tflat.encode_process_decode_apply_flat(
            epd, torch.zeros(4, 5), torch.zeros(8, 3), torch.zeros(8, dtype=torch.long),
            torch.full((4, 1), 2.0), 2, remat="sometimes",
        )


def test_split_first_layer_is_a_view():
    epd = tepd.EncodeProcessDecode(tepd.EPDConfig(5, 3, 3, 16, 1))
    mlp = epd._processor.gnn_stacks[0].edge_fn[0]
    (w_i, w_j, w_e), b = tepd.split_first_layer(mlp, (16, 16, 16))
    w = mlp.linears[0].weight
    assert w_j.data_ptr() == w.data_ptr() + 16 * w.element_size()  # column block of [out, in]
    assert b is mlp.linears[0].bias
    assert len(list(epd.parameters())) == len(epd.state_dict())  # no extra parameters


# --- golden fixtures --------------------------------------------------------


def _unflatten(flat):
    """'a/b/0/w' -> nested dicts, digit keys -> lists (numpy leaves)."""
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


@pytest.fixture(scope="module")
def golden_epd():
    with np.load(FIX / "golden_epd.npz") as z:
        return {k: z[k] for k in z.files}


def test_readable_forward_matches_golden(golden_epd):
    fix = golden_epd
    node_in, edge_in, node_out, d, steps, nlayers = (int(v) for v in fix["meta"])
    cfg = jepd.EPDConfig(node_in, edge_in, node_out, d, steps, nlayers)
    params = _unflatten({k[len("param/"):]: v for k, v in fix.items() if k.startswith("param/")})
    epd = port_epd(params, cfg)
    nl = NeighborList(torch.from_numpy(fix["nl_senders"]).long(), torch.from_numpy(fix["nl_mask"]))
    mask = nl.mask[..., None].float()
    with torch.no_grad():
        x = tepd.mlp_ln_apply(epd._encoder.node_fn, torch.from_numpy(fix["node_feat"]))
        e = tepd.mlp_ln_apply(epd._encoder.edge_fn, torch.from_numpy(fix["edge_feat_dense"])) * mask
        acts = {"node_enc": x, "edge_enc": e}
        for i, block in enumerate(epd._processor.gnn_stacks):
            x, e = tepd.interaction_network_apply(block, x, e, nl)
            acts[f"block{i}/x"], acts[f"block{i}/e"] = x, e
        out = epd._decoder.node_fn(x)
    np.testing.assert_allclose(out.numpy(), fix["golden_output"], **GOLDEN_TOL)
    valid = fix["nl_mask"].reshape(-1)
    for name, a in acts.items():
        a = a.numpy()
        if a.ndim == 3:  # dense [N, K, D] -> the recorded COO rows
            a = a.reshape(-1, a.shape[-1])[valid]
        np.testing.assert_allclose(a, fix[f"act/{name}"], err_msg=name, **GOLDEN_TOL)


def test_flat_forward_matches_golden(golden_epd):
    fix = golden_epd
    node_in, edge_in, node_out, d, steps, nlayers = (int(v) for v in fix["meta"])
    params = _unflatten({k[len("param/"):]: v for k, v in fix.items() if k.startswith("param/")})
    epd = port_epd(params, jepd.EPDConfig(node_in, edge_in, node_out, d, steps, nlayers))
    senders, mask = fix["nl_senders"], fix["nl_mask"]
    n, k = senders.shape
    assert (mask == (np.arange(k)[None] < mask.sum(1)[:, None])).all()  # prefix-compacted
    got = _port_flat(epd, senders[None], mask[None], fix["node_feat"],
                     fix["edge_feat_dense"].reshape(n * k, -1), n, k)
    np.testing.assert_allclose(got, fix["golden_output"], **GOLDEN_TOL)


@pytest.fixture(scope="module")
def golden_sim():
    with np.load(FIX / "golden_sim.npz") as z:
        fix = {k: z[k] for k in z.files}
    n, s, dim, k, d, steps, nlayers, ntypes = (int(v) for v in fix["ss/meta"])
    r, wall_x = (float(v) for v in fix["ss/radius"])
    cfg = tsim.SimulatorConfig(
        dim=dim, latent_dim=d, num_message_passing_steps=steps, num_mlp_layers=nlayers,
        connectivity_radius=r, input_sequence_length=s, num_particle_types=ntypes,
        max_neighbors=k, wall_x=wall_x,
    )
    stats = tsim.NormStats(*(torch.from_numpy(fix[f"ss/{key}"]) for key in
                             ("vel_mean", "vel_std", "acc_mean", "acc_std")))
    params = {
        "epd": _unflatten({k[len("ss/param/"):]: v for k, v in fix.items() if k.startswith("ss/param/")}),
        "type_embedding": {"table": fix["ss/emb_table"]},
    }
    sim = tsim.simulator_init(cfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(params), strict=True)
    return fix, cfg, stats, sim


def test_simulator_chain_matches_golden(golden_sim):
    fix, cfg, stats, sim = golden_sim
    seq, types = torch.from_numpy(fix["ss/seq"]), torch.from_numpy(fix["ss/types"]).long()
    with torch.no_grad():
        nf, _, _ = tsim.encoder_preprocess(sim, cfg, stats, seq, types)
        next_pos, strain = tsim.predict_positions(sim, cfg, stats, seq, types)
    np.testing.assert_allclose(nf.numpy(), fix["ss/node_feat"], **GOLDEN_TOL)
    np.testing.assert_allclose(next_pos.numpy(), fix["ss/golden_next_pos"], **GOLDEN_TOL)
    np.testing.assert_allclose(strain.numpy(), fix["ss/golden_strain"], rtol=2e-4, atol=2e-5)
    target = tsim.inverse_decoder_postprocess(stats, torch.from_numpy(fix["ss/next_gt"]), seq)
    np.testing.assert_allclose(target.numpy(), fix["ss/golden_target_acc"], **GOLDEN_TOL)


@pytest.mark.parametrize("domain", [None, ((-4.0, -3.0), (2.0, 3.0))])
def test_flat_simulator_matches_golden(golden_sim, domain):
    fix, cfg, stats, sim = golden_sim
    cfg = dataclasses.replace(cfg, domain=domain)
    seq = torch.from_numpy(fix["ss/seq"])[None]
    types = torch.from_numpy(fix["ss/types"]).long()[None]
    with torch.no_grad():
        acc, strain = tsim.forward_batched(sim, cfg, stats, seq, types)
    np.testing.assert_allclose(acc[0].numpy(), fix["ss/golden_norm_acc"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(strain[0].numpy(), fix["ss/golden_strain"], rtol=2e-4, atol=2e-5)
