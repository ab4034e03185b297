"""Port training slice against the JAX package on CPU: noise, batches, one
full training step (loss, gradients, parameters after Adam), bf16
gradients through the fused edge block, and the trainer's checks (train,
predict and resume are in ``test_torch_port_families.py``).

JAX params are carried across by ``state_dict_from_jax``; JAX's noise is
injected into the port's step, so both sides see the same inputs.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sgnn_tpu.data.loader import SampleBatcher as JSampleBatcher
from sgnn_tpu.models import EPDConfig, encode_process_decode_init
from sgnn_tpu.models import epd_flat as jflat
from sgnn_tpu.ops import radius_neighbors_bruteforce
from sgnn_tpu.physics import noise as jnoise
from sgnn_tpu.physics import simulator as jsim
from sgnn_tpu.train import config as jconfig
from sgnn_tpu.train import train as jtrain
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.loader import SampleBatcher
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.models import encode_process_decode as tepd
from sgnn_tpu_torch.models import epd_flat as tflat
from sgnn_tpu_torch.ops import sym_gather as tsg
from sgnn_tpu_torch.physics import noise as tnoise
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.checkpoint import CheckpointManager
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.jax_params import state_dict_from_jax

torch.set_num_threads(1)

S, N, B, DIM = 6, 40, 2, 2
LR = 1e-3
# loss and aux metrics: f32 sums in another order through 2 layers (the
# JAX step runs the XLA edge path, the port the fused block's plain version)
LOSS_TOL = dict(rtol=2e-5, atol=1e-7)
# gradients, per tensor: the same sums in another order, then the edge
# block's backward; atol relative to the tensor's largest entry
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
# parameters after the first Adam step: p - lr * g / (|g| + eps) moves
# each entry by ~lr, so the updates agree to ~1e-6 * lr and the new
# parameters to the f32 rounding of p (2^-22 |p|: two ulps); where |g| lies
# within the gradient tolerance of 0 its sign may differ, and so may the
# step (by at most 2 * lr)
PARAM_ATOL, PARAM_RTOL = 1e-7, 2.0**-22


def configs(symmetric=False):
    kw = dict(dim=DIM, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=1,
              connectivity_radius=0.6, input_sequence_length=S, max_neighbors=12,
              wall_x=-2.0, domain=((-3.0, -3.0), (6.0, 6.0)), symmetric_gather=symmetric)
    return jsim.SimulatorConfig(**kw), tsim.SimulatorConfig(**kw)


def stats_pair(rng):
    v = {k: rng.uniform(0.5, 1.5, size=DIM).astype(np.float32) * s
         for k, s in (("vel_mean", 0.01), ("vel_std", 0.05), ("acc_mean", 0.001), ("acc_std", 0.01))}
    return (jsim.NormStats(**{k: jnp.asarray(a) for k, a in v.items()}),
            tsim.NormStats(**{k: torch.from_numpy(a) for k, a in v.items()}))


def make_batch(rng):
    """A lattice of N particles per graph (symmetric radius graph: the cap
    of 12 never binds at spacing 0.5, r = 0.6), drifting over S frames."""
    side = int(np.ceil(np.sqrt(N)))
    base = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1).reshape(-1, 2)[:N]
    base = base * 0.5 - 1.0
    walk = np.cumsum(rng.normal(scale=0.005, size=(B, N, S + 1, DIM)), axis=2)
    seq = (base[None, :, None, :] + walk).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -4:] = False
    return {
        "positions": seq[:, :, :S],
        "next_position": seq[:, :, S],
        "next_strain": rng.normal(size=(B, N)).astype(np.float32),
        "particle_type": np.zeros((B, N), np.int32),
        "node_mask": mask,
    }


def train_cfg():
    return TrainConfig(batch_size=B, noise_std=0.01, input_sequence_length=S, hidden_dim=16,
                       layers=2, lr_init=LR, lr_decay=0.1, lr_decay_steps=1000)


def _capture_grads():
    """An optax transformation that keeps the gradients in its state."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}),
    )


def jax_step(jcfg, jstats, cfg, params, batch, key):
    """(metrics, grads, params after one Adam step) of _make_step_body."""
    jcfg_train = jconfig.TrainConfig(**{f: getattr(cfg, f) for f in (
        "batch_size", "noise_std", "input_sequence_length", "hidden_dim", "layers",
        "lr_init", "lr_decay", "lr_decay_steps")})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for name, tx in (("grads", _capture_grads()), ("adam", optax.adam(jtrain.lr_schedule(jcfg_train)))):
        state = {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}
        out[name] = jax.jit(jtrain._make_step_body(jcfg, jstats, jcfg_train, tx))(state, jbatch, key)
    metrics = {k: float(v) for k, v in out["adam"][1].items()}
    return metrics, out["grads"][0]["opt_state"]["g"], out["adam"][0]["params"]


def port_step(tcfg, tstats, cfg, params, batch, noise):
    sim = tsim.simulator_init(tcfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    before = {k: v.detach().clone() for k, v in sim.state_dict().items()}
    opt = ttrain.make_optimizer(sim, cfg)
    step = ttrain.make_train_step(sim, tcfg, tstats, cfg, opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = step(tbatch, 0, noise=torch.from_numpy(np.array(noise)))
    grads = {k: p.grad for k, p in sim.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, before, sim.state_dict()


@pytest.mark.parametrize("symmetric", [False, True], ids=["plain_gather", "symmetric_gather"])
def test_training_step_matches_jax(rng, symmetric):
    jcfg, tcfg = configs(symmetric)
    jstats, tstats = stats_pair(rng)
    cfg = train_cfg()
    params = jsim.simulator_init(jax.random.key(0), jcfg)
    batch = make_batch(rng)
    key = jax.random.key(5)
    noise = jnoise.random_walk_position_noise(key, batch["positions"].shape, cfg.noise_std)

    jm, jgrads, jparams = jax_step(jcfg, jstats, cfg, params, batch, key)
    calls = tsg.BWD_CALLS
    tm, tgrads, before, after = port_step(tcfg, tstats, cfg, params, batch, noise)
    assert tsg.BWD_CALLS == calls + (2 if symmetric else 0)  # one per layer

    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(tm[name], jm[name], err_msg=name, **LOSS_TOL)
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    want_p = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(tgrads) == set(want_g) == set(want_p)
    for name, wg in want_g.items():
        g = tgrads[name]
        assert g.dtype == torch.float32
        atol = GRAD_ATOL_REL * float(wg.abs().max())
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=GRAD_RTOL, atol=atol, err_msg=name)
        # Adam's first step, entry by entry
        either_way = (wg.abs() <= atol + GRAD_RTOL * wg.abs()).numpy()
        err = ((after[name] - want_p[name]).abs() - PARAM_RTOL * want_p[name].abs()).numpy()
        assert (err[~either_way] <= PARAM_ATOL).all(), f"{name}: max |err| {err[~either_way].max():.3e}"
        assert (err <= 2 * LR + PARAM_ATOL).all(), name
        assert (after[name] != before[name]).any(), f"{name} did not move"


def test_predict_accelerations_matches_jax(rng):
    """The readable per-graph training forward, one graph."""
    jcfg, tcfg = configs()
    jstats, tstats = stats_pair(rng)
    params = jsim.simulator_init(jax.random.key(1), jcfg)
    sim = tsim.simulator_init(tcfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    batch = make_batch(rng)
    noise = rng.normal(scale=0.01, size=batch["positions"].shape[1:]).astype(np.float32)
    args = (batch["next_position"][1], noise, batch["positions"][1], batch["particle_type"][1],
            batch["node_mask"][1])
    want = jsim.predict_accelerations(params, jcfg, jstats, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tsim.predict_accelerations(sim, tcfg, tstats, *(torch.from_numpy(a) for a in args))
    for name, a, b in zip(("pred_acc", "target_acc", "strain"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5, atol=5e-5, err_msg=name)


def test_noise_matches_jax_given_the_same_draws():
    key = jax.random.key(11)
    shape = (3, 7, S, DIM)
    want = jnoise.random_walk_position_noise(key, shape, 0.02)
    z = jax.random.normal(key, shape[:-2] + ((S - 1) * DIM,), jnp.float32)
    got = tnoise.random_walk_position_noise(shape, 0.02, z=torch.from_numpy(np.asarray(z)))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    assert torch.equal(got[..., 0, :], torch.zeros(3, 7, DIM))  # no noise on the first frame


def test_noise_draw_has_the_configured_last_step_std():
    g = torch.Generator().manual_seed(0)
    noise = tnoise.random_walk_position_noise((20000, S, DIM), 0.02, generator=g)
    vel = noise[:, -1] - noise[:, -2]  # velocity noise at the last step
    assert abs(float(vel.std()) - 0.02) < 0.02 * 0.02
    with pytest.raises(ValueError, match="z has shape"):
        tnoise.random_walk_position_noise((4, S, DIM), 0.02, z=torch.zeros(4, 3))


def test_sample_batcher_matches_jax(tiny_env):
    _, data = tiny_env
    kw = dict(pad_multiple=32, seed=3)
    ours = SampleBatcher(data / "train.npz", S, 4, **kw)
    ref = JSampleBatcher(data / "train.npz", S, 4, **kw)
    assert len(ours) == len(ref) and ours.num_nodes == ref.num_nodes
    assert ours.steps_per_epoch() == ref.steps_per_epoch()
    a, b = ours.epochs(), ref.epochs()
    for _ in range(ours.steps_per_epoch() + 2):  # into the second epoch
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for k in y:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_bf16_flat_gradients_match_jax_pallas_path(rng, monkeypatch):
    """Gradients of the bf16 flat model through the fused block against the
    JAX flat path with use_pallas=True (kernel in interpret mode)."""
    import sgnn_tpu.experimental.edge_block as jeb

    orig = jeb.fused_edge_block
    monkeypatch.setattr(jflat, "fused_edge_block", lambda *a: orig(*a, True))

    b, n, k = 2, 32, 8  # M = 64 receivers: _tile_receivers tiles them
    cfg = EPDConfig(node_in=5, edge_in=3, node_out=3, latent_dim=16,
                    num_message_passing_steps=2, num_mlp_layers=1)
    params = encode_process_decode_init(jax.random.key(2), cfg)
    pos = rng.uniform(-1, 1, size=(b, n, 2)).astype(np.float32)
    nls = [radius_neighbors_bruteforce(jnp.asarray(p), 0.5, max_neighbors=k) for p in pos]
    senders, degrees = jflat.flatten_batch_graph(jnp.stack([nl.senders for nl in nls]),
                                                 jnp.stack([nl.mask for nl in nls]), n)
    nf = rng.normal(size=(b * n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(b * n * k, cfg.edge_in)).astype(np.float32)
    w = rng.normal(size=(b * n, cfg.node_out)).astype(np.float32)

    def jloss(p):
        out = jflat.encode_process_decode_apply_flat(
            p, jnp.asarray(nf), jnp.asarray(ef), senders, degrees, k, use_pallas=True,
            compute_dtype=jnp.bfloat16)
        return jnp.sum(out * w)

    jl, jg = jax.value_and_grad(jloss)(params)

    epd = tepd.EncodeProcessDecode(tepd.EPDConfig(
        node_in=5, edge_in=3, node_out=3, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=1))
    sd = state_dict_from_jax({"epd": jax.tree.map(np.asarray, params)})
    epd.load_state_dict({k_[len("_encode_process_decode."):]: v for k_, v in sd.items()}, strict=True)
    out = tflat.encode_process_decode_apply_flat(
        epd, torch.from_numpy(nf), torch.from_numpy(ef), torch.from_numpy(np.asarray(senders)).long(),
        torch.from_numpy(np.asarray(degrees)), k, compute_dtype=torch.bfloat16)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    # bf16 edge latents: a flipped bf16 rounding moves an edge value by
    # 2^-8 relative, and the scatter-add of the sender gather sums bf16
    # in another order; gradients agree to ~1e-2 of each tensor's scale
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-2)
    want = {k_[len("_encode_process_decode."):]: v for k_, v in
            state_dict_from_jax({"epd": jax.tree.map(np.asarray, jg)}).items()}
    for name, p in epd.named_parameters():
        assert p.grad.dtype == torch.float32, name  # no weight grad rounded through bf16
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-2, atol=1e-2 * scale, err_msg=name)


# --- train / predict / resume on the CPU -------------------------------------------


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root, root / "data"


def tiny_config(root, data, **kw):
    base = dict(mode="train", data_path=str(data), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, dim=2,
                input_sequence_length=6, connection_radius=0.6, batch_size=4, noise_std=0.001,
                ntraining_steps=120, nsave_steps=60, lr_init=1e-3, run_name="t", pad_multiple=32,
                seed=0, log_every=20)
    base.update(kw)
    return TrainConfig(**base)


def test_final_checkpoint_when_no_validation_ran(tiny_env):
    root, data = tiny_env
    cfg = tiny_config(root, data, ntraining_steps=4, nsave_steps=100, log_every=2, run_name="final",
                      symmetric_gather=True)
    assert ttrain.train(cfg, device="cpu") == {"step": 4, "lowest_eval_loss": float("inf")}
    meta = json.load(open(root / "models" / "final" / "checkpoint_meta.json"))
    assert meta["path"] == "model-final-000004" and meta["lowest_eval_loss"] is None


def test_train_refuses_unported_options(tiny_env):
    """Every option of the JAX trainer is ported now: what is still refused
    is what JAX refuses, a step count that is no multiple of inner_steps,
    and a remat value that names no mode."""
    root, data = tiny_env
    with pytest.raises(ValueError, match="inner_steps"):
        ttrain.train(tiny_config(root, data, ntraining_steps=9, inner_steps=2), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        ttrain.train(tiny_config(root, data, ntraining_steps=2, remat="sometimes", run_name="refused"), device="cpu")


def test_inner_steps_run_as_single_steps(tiny_env):
    root, data = tiny_env
    cfg = tiny_config(root, data, ntraining_steps=8, nsave_steps=8, log_every=4, inner_steps=2, run_name="inner")
    assert ttrain.train(cfg, device="cpu")["step"] == 8


def test_checkpoint_refuses_a_bare_state_dict(tmp_path):
    sim = tsim.simulator_init(tsim.SimulatorConfig(latent_dim=8, num_message_passing_steps=1), device="cpu")
    torch.save(sim.state_dict(), tmp_path / "model-best-000000")
    with pytest.raises(ValueError, match="not a train-state checkpoint"):
        CheckpointManager(tmp_path).restore("model-best-000000")


def test_simulator_config_symmetric_auto_rule(tiny_env):
    root, data = tiny_env
    md = ttrain.load_metadata(data)
    assert not ttrain.simulator_config_from(tiny_config(root, data), md).symmetric_gather
    bf16 = ttrain.simulator_config_from(tiny_config(root, data, compute_dtype="bfloat16"), md)
    assert bf16.symmetric_gather == (int(md["max_degree"]) + 2 <= bf16.slots)
    for value in (True, False):
        cfg = tiny_config(root, data, compute_dtype="bfloat16", symmetric_gather=value)
        assert ttrain.simulator_config_from(cfg, md).symmetric_gather is value
    jcfg = jconfig.TrainConfig(compute_dtype="bfloat16", hidden_dim=16, layers=2, input_sequence_length=6)
    assert jtrain.simulator_config_from(jcfg, md).symmetric_gather == bf16.symmetric_gather


def test_lr_schedule_matches_jax():
    cfg = train_cfg()
    jcfg = jconfig.TrainConfig(lr_init=cfg.lr_init, lr_decay=cfg.lr_decay, lr_decay_steps=cfg.lr_decay_steps)
    for step in (0, 1, 500, 1000, 5000):
        assert ttrain.lr_schedule(cfg)(step) == pytest.approx(float(jtrain.lr_schedule(jcfg)(step)), rel=1e-12)
