"""Bit-reproducible, captured training on the CPU: deterministic sums (the
sorted sum and the ordered gather, the COO and config A routes on them),
the ported ``DevicePrefetcher``, the captured training step's body over
its static buffers, and checkpoints of either form of Adam's state.

On CPU tensors ``TrainStep`` runs its body eagerly over the same buffers
the card's graph reads, with ``z`` drawn into its buffer, so these tests
drive the card's code less the graph; tests/test_torch_port_cuda.py holds
the captured route against the eager one on the card.
"""

import copy
import itertools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.models import multi_scale as jmodel
from sgnn_tpu.physics import multi_scale_graph as jg
from sgnn_tpu_torch.data import prefetch
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.models import epd_flat as tflat
from sgnn_tpu_torch.models import multi_scale as tmodel
from sgnn_tpu_torch.ops import row_gather as rg
from sgnn_tpu_torch.physics import multi_scale_graph as tg
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics.noise import random_walk_position_noise
from sgnn_tpu_torch.train import captured_train_step as cts
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train import train_multi_scale as ttms
from sgnn_tpu_torch.train.checkpoint import CheckpointManager, load_optimizer_state, train_state
from sgnn_tpu_torch.train.config import TrainConfig
from test_torch_port_multi_scale import GRIDS, configs, sim_pair

torch.set_num_threads(1)

# the sorted sum and the ordered gather in f32 against index_add_ /
# index_select in f64: each output entry is a sum of at most a few dozen
# f32 terms, so it lies within a few f32 ulps of the f64 sum of |terms|
SUM_RTOL = {torch.float32: 2.0**-20, torch.bfloat16: 2.0**-7}
# the COO forward against JAX's on a flattened batch: the JAX tests' f32
# tolerance (sums in another order)
TOL = dict(rtol=2e-5, atol=2e-5)


# --- (a) the deterministic sums -------------------------------------------------------


def _ids(rng, m, n):
    return np.sort(rng.integers(0, n, m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sorted_sum_matches_index_add_in_f64(rng, dtype):
    """sorted_sum (forward: sorted_segment_sum) against index_add_ in f64;
    its gradient is the cotangent's rows gathered, as index_add_'s is."""
    n, w = 23, 8
    ids = torch.from_numpy(_ids(rng, 300, n))
    data = torch.from_numpy(rng.normal(size=(300, w))).to(dtype).requires_grad_(True)
    got = rg.sorted_sum(data, ids, n)
    want = torch.zeros(n, w, dtype=torch.float64).index_add_(0, ids, data.detach().double())
    scale = torch.zeros(n, w, dtype=torch.float64).index_add_(0, ids, data.detach().double().abs())
    assert got.dtype == dtype
    assert ((got.double() - want).abs() <= SUM_RTOL[dtype] * scale + 1e-30).all()
    cot = torch.from_numpy(rng.normal(size=(n, w))).to(dtype)
    (grad,) = torch.autograd.grad(got, data, cot)
    assert torch.equal(grad, cot[ids])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ordered_gather_matches_index_select_in_f64(rng, dtype):
    """ordered_gather: the forward is table[idx] exactly; the backward, the
    sorted sum of the cotangent's rows in the sender order, against
    index_select's (index_add_) in f64, for [R, K] indices."""
    n, w = 31, 16
    idx = torch.from_numpy(rng.integers(0, n, (40, 6)))
    sorted_idx, order = torch.sort(idx.reshape(-1), stable=True)
    table = torch.from_numpy(rng.normal(size=(n, w))).to(dtype).requires_grad_(True)
    got = rg.ordered_gather(table, idx, order, sorted_idx, n)
    assert torch.equal(got, table.detach()[idx])
    cot = torch.from_numpy(rng.normal(size=(40, 6, w))).to(dtype)
    (grad,) = torch.autograd.grad(got, table, cot)
    flat = cot.reshape(-1, w).double()
    want = torch.zeros(n, w, dtype=torch.float64).index_add_(0, idx.reshape(-1), flat)
    scale = torch.zeros(n, w, dtype=torch.float64).index_add_(0, idx.reshape(-1), flat.abs())
    assert grad.dtype == dtype
    assert ((grad.double() - want).abs() <= SUM_RTOL[dtype] * scale + 1e-30).all()
    # the same bits as the sorted sum over the reordered rows: index order inside each node
    assert torch.equal(grad, rg.sorted_segment_sum(cot.reshape(-1, w)[order].contiguous(), sorted_idx, n))
    with pytest.raises(ValueError, match="ordered_gather"):
        rg.ordered_gather(table, idx, order[:-1], sorted_idx, n)


def test_flat_forward_sorts_the_senders_once_when_gradients_are_taken(rng, monkeypatch):
    """Config A's route (no reverse-edge index): under grad the senders are
    sorted once per forward and every layer gathers through
    ordered_gather; with no gradients (serving) the layers gather with
    index_select. The
    gradients equal index_select's route to f32 rounding (each node's
    cotangent rows in another order)."""
    from sgnn_tpu_torch.models import encode_process_decode as tepd

    torch.manual_seed(0)
    layers, b, n, k = 3, 2, 24, 6
    epd = tepd.EncodeProcessDecode(tepd.EPDConfig(node_in=5, edge_in=3, node_out=3, latent_dim=16,
                                                  num_message_passing_steps=layers, num_mlp_layers=1))
    senders = torch.from_numpy(rng.integers(0, n, (b, n, k)))
    mask = torch.from_numpy(rng.random((b, n, k)) < 0.7)
    mask = torch.sort(mask.int(), dim=-1, descending=True).values.bool()  # prefix-compacted slots
    flat, degrees = tflat.flatten_batch_graph(senders, mask, n)
    nf = torch.from_numpy(rng.normal(size=(b * n, 5)).astype(np.float32))
    ef = torch.from_numpy(rng.normal(size=(b * n * k, 3)).astype(np.float32))
    calls = {"sort": 0, "ordered": 0}
    sort, ordered = torch.sort, tflat.ordered_gather
    monkeypatch.setattr(torch, "sort", lambda *a, **kw: calls.__setitem__("sort", calls["sort"] + 1) or sort(*a, **kw))
    monkeypatch.setattr(tflat, "ordered_gather",
                        lambda *a: calls.__setitem__("ordered", calls["ordered"] + 1) or ordered(*a))
    out = tflat.encode_process_decode_apply_flat(epd, nf, ef, flat, degrees, k)
    assert calls == {"sort": 1, "ordered": layers}
    grads = torch.autograd.grad(out.sum(), list(epd.parameters()))
    with torch.no_grad():
        served = tflat.encode_process_decode_apply_flat(epd, nf, ef, flat, degrees, k)
    assert calls == {"sort": 1, "ordered": layers} and torch.equal(served, out.detach())
    # the reference: the same forward with index_select (index_add_ backward)
    monkeypatch.setattr(tflat, "ordered_gather", lambda table, idx, *_: table.index_select(0, idx))
    want = torch.autograd.grad(tflat.encode_process_decode_apply_flat(epd, nf, ef, flat, degrees, k).sum(),
                               list(epd.parameters()))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))


# --- (b) the COO route on the sender order, against JAX ---------------------------------


def _coo_batch(n=64, samples=2):
    """Per-sample COO graphs of both packages over jittered bars, stacked:
    (JAX's, the port's)."""
    grids = [GRIDS["jittered12x5"] + 0.01 * s for s in range(samples)]
    out = []
    for mod in (jg, tg):
        cfg = mod.MultiScaleConfig(num_scales=2, window_size=2)
        gs = [mod.build_static_graph(cfg, g, g2m_pad=512, m2m_pad=256, m2g_pad=512) for g in grids]
        out.append(type(gs[0])(*(type(gs[0][0])(*(np.stack(f) for f in zip(*es))) for es in zip(*gs))))
    return out


def test_coo_forward_on_a_flattened_batch_matches_jax(rng):
    """multi_scale_gnn_apply over a flattened batch of two graphs (sorted
    receivers, the sender order, every sum on the sorted sum) against JAX's
    with sorted_receivers=True: outputs, and the gradients of the node and
    edge features."""
    jcfg, tcfg = configs()
    params, sim = sim_pair(jcfg, tcfg)
    jgraph, tgraph = _coo_batch()
    n = 60
    jflat = jmodel.flatten_ms_graph(jax.tree.map(jnp.asarray, jgraph), n)
    tflat_graph = tmodel.flatten_ms_graph(tms.graph_to(tgraph, torch.device("cpu")), n)
    nf = rng.normal(size=(2 * n, tcfg.node_in)).astype(np.float32)
    ef = {t: rng.normal(size=(2 * getattr(tgraph, t).senders.shape[1], tcfg.edge_in)).astype(np.float32)
          for t in ("g2m", "m2m", "m2g")}
    cot = rng.normal(size=(2 * n, tcfg.node_out)).astype(np.float32)

    def jloss(nf, ef):
        out = jmodel.multi_scale_gnn_apply(params["gnn"], nf, ef, jflat, sorted_receivers=True)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(nf), {k: jnp.asarray(v) for k, v in ef.items()})
    tnf = torch.from_numpy(nf).requires_grad_(True)
    tef = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ef.items()}
    tout = tmodel.multi_scale_gnn_apply(sim._multi_scale_gnn, tnf, tef, tflat_graph)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    (tout * torch.from_numpy(cot)).sum().backward()
    scale = float(np.abs(np.asarray(jgrads[0])).max())
    np.testing.assert_allclose(tnf.grad.numpy(), np.asarray(jgrads[0]), rtol=1e-4, atol=1e-5 * scale)
    for k in ef:
        want = np.asarray(jgrads[1][k])
        np.testing.assert_allclose(tef[k].grad.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_pad_edges_keeps_the_sender_order_and_graph_to_fills_a_missing_one():
    """pad_edges's order is the stable sort of the valid senders, padding
    last; a graph built without one (three fields, as JAX's) gets the same
    from graph_to."""
    cfg = tg.MultiScaleConfig(num_scales=2, window_size=2)
    graph = tg.build_static_graph(cfg, GRIDS["square8"], g2m_pad=512, m2m_pad=256, m2g_pad=512)
    for pe in graph:
        e = int(pe.mask.sum())
        assert sorted(pe.order) == list(range(len(pe.mask))) and (pe.order[e:] == np.arange(e, len(pe.mask))).all()
        assert (np.diff(pe.senders[pe.order[:e]]) >= 0).all()
        same = pe.senders[pe.order[:e]]
        ties = np.flatnonzero(np.diff(same) == 0)
        assert (pe.order[ties] < pe.order[ties + 1]).all()  # stable
    bare = tg.StaticGraph(*(tg.PaddedEdges(pe.senders, pe.receivers, pe.mask) for pe in graph))
    moved = tms.graph_to(bare, torch.device("cpu"))
    for pe, got in zip(graph, moved):
        assert torch.equal(got.order, torch.from_numpy(pe.order))


# --- (c) the ported DevicePrefetcher (tests/test_aux.py's, on the port) --------------------


def test_device_prefetcher(rng):
    batches = [{"x": rng.normal(size=(4, 8)).astype(np.float32), "i": i} for i in range(5)]
    with prefetch.DevicePrefetcher(iter(batches), depth=2) as pf:
        out = list(pf)
    assert [b["i"] for b in out] == list(range(5))
    for a, b in zip(out, batches):
        assert isinstance(a["x"], torch.Tensor)
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])


def test_device_prefetcher_propagates_errors():
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("loader exploded")

    with prefetch.DevicePrefetcher(bad(), depth=2) as pf:
        next(pf)
        with pytest.raises(RuntimeError, match="loader exploded"):
            next(pf)


def test_device_prefetcher_close_unblocks_infinite_stream():
    pf = prefetch.DevicePrefetcher(({"i": i} for i in itertools.count()), depth=1)
    assert next(pf)["i"] == 0
    pf.close()
    assert not pf._thread.is_alive()


def test_device_prefetcher_stages_a_multi_scale_batch(data):
    """A multi-scale batch (its stacked COO graph a tree of NamedTuples)
    arrives as the same tree of tensors that batch_to_device makes; a
    custom ``put`` runs on the worker."""
    root, path = data
    cfg = _config(root, path, "prefetch", ms_dense=False)
    built = ttms.build_training(cfg, torch.device("cpu"))
    host = list(itertools.islice(built.batcher.epochs(), 3))
    with prefetch.DevicePrefetcher(iter(host), depth=2, device="cpu") as pf:
        staged = list(pf)
    for got, batch in zip(staged, host):
        want = ttms.batch_to_device(batch, torch.device("cpu"))
        assert isinstance(got["graph"], tg.StaticGraph) and isinstance(got["graph"].m2m, tg.PaddedEdges)
        for a, b in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor), jax.tree.leaves(want, is_leaf=torch.is_tensor)):
            assert torch.equal(a, b)
    with prefetch.DevicePrefetcher(iter(host), put=lambda b: b["node_mask"].sum()) as pf:
        assert [int(v) for v in pf] == [int(b["node_mask"].sum()) for b in host]


# --- (d) the captured step's body over its static buffers --------------------------------


def _dataset(root):
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40, val_patterns=["-110"],
                   test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root / "data"


def _config(root, data, run_name, **kw):
    base = dict(mode="train", data_path=str(data), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, dim=2, input_sequence_length=6,
                connection_radius=0.6, batch_size=2, noise_std=0.001, ntraining_steps=4, nsave_steps=4,
                lr_init=1e-3, run_name=run_name, pad_multiple=32, seed=0, log_every=2, num_scales=2,
                window_size=2, edge_pad_multiple=256)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train_step")
    return root, _dataset(root)


def _today(built, cfg, batches):
    """The step as the trainers ran it before the capture: the noise drawn
    with its own tensor from the generator, the lr a float, the update."""
    gen = torch.Generator().manual_seed(cfg.seed)
    out = []
    for i, b in enumerate(batches):
        noise = random_walk_position_noise(tuple(b["positions"].shape), cfg.noise_std, generator=gen)
        cts.set_lr(built.optimizer, ttrain.lr_schedule(cfg)(i))
        out.append({k: v.clone() for k, v in built.step_fn.update(b, noise).items()})
    return out


@pytest.mark.parametrize("family,kw", [("single_scale", {}), ("multi_scale", dict(ms_dense=False)),
                                       ("multi_scale", dict(ms_dense=True))], ids=["A", "coo", "dense"])
def test_captured_body_on_the_cpu_equals_the_step_of_today(data, family, kw):
    """Three steps of TrainStep on the CPU (batch copied into its buffers,
    z drawn into its buffer, the body over them), of its eager route, and
    of the step as it was: equal bit for bit, parameters, Adam's state and
    metrics; the buffers are made once and kept."""
    root, path = data
    cfg = _config(root, path, family, **kw)
    trainer = ttms if family == "multi_scale" else ttrain
    cpu = torch.device("cpu")
    source = trainer.build_training(cfg, cpu).batcher.epochs()
    batches = [trainer.batch_to_device(next(source), cpu) for _ in range(3)]
    runs = []
    for route in ("buffers", "eager", "today"):
        built = trainer.build_training(cfg, cpu)
        if route == "today":
            metrics = _today(built, cfg, batches)
        else:
            built.step_fn.capture = route == "buffers"
            metrics, kept = [], set()
            for i, b in enumerate(batches):
                metrics.append({k: v.clone() for k, v in built.step_fn(b, i).items()})
                kept.add(id(built.step_fn.batch))
            assert len(kept) == 1 and (built.step_fn.batch is None) == (route == "eager")
        runs.append((metrics, built.sim.state_dict(), built.optimizer.state_dict()["state"]))
    for metrics, params, state in runs[1:]:
        for a, b in zip(runs[0][0], metrics):
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(v, params[k]) for k, v in runs[0][1].items())
        for i, st in runs[0][2].items():
            assert all(torch.equal(st[k], state[i][k]) for k in st)


def test_train_step_takes_new_buffers_when_the_optimizer_state_is_replaced(data):
    root, path = data
    cfg = _config(root, path, "rekey")
    cpu = torch.device("cpu")
    built = ttrain.build_training(cfg, cpu)
    source = built.batcher.epochs()
    built.step_fn(ttrain.batch_to_device(next(source), cpu), 0)
    first = built.step_fn.batch
    built.step_fn(ttrain.batch_to_device(next(source), cpu), 1)
    assert built.step_fn.batch is first
    built.optimizer.load_state_dict(copy.deepcopy(built.optimizer.state_dict()))  # new state tensors
    built.step_fn(ttrain.batch_to_device(next(source), cpu), 2)
    assert built.step_fn.batch is not first
    built.step_fn.close()
    assert built.step_fn.batch is None and built.step_fn.graph is None


@pytest.mark.parametrize("family", ["single_scale", "multi_scale"])
def test_inner_steps_two_equal_one(data, family):
    """train with inner_steps 2 (two steps, each on its own batch, between
    logs) gives the bits of inner_steps 1: the parameters and Adam's state
    of the checkpoint and the logged metrics."""
    root, path = data
    trainer = ttms if family == "multi_scale" else ttrain
    states, logs = [], []
    for inner in (1, 2):
        cfg = _config(root, path, f"inner_{family}_{inner}", inner_steps=inner, ms_dense=False)
        assert trainer.train(cfg, device="cpu")["step"] == 4
        ckpt = CheckpointManager(root / "models" / cfg.run_name)
        states.append(ckpt.restore()[0])
        lines = [json.loads(x) for x in open(root / "models" / cfg.run_name / "metrics.jsonl")]
        logs.append([{k: v for k, v in x.items() if k.startswith("train/loss")} for x in lines if "train/loss" in x])
    assert logs[0] == logs[1] and len(logs[0]) == 2
    assert all(torch.equal(v, states[1]["params"][k]) for k, v in states[0]["params"].items())
    for i, st in states[0]["opt_state"]["state"].items():
        assert all(torch.equal(st[k], states[1]["opt_state"]["state"][i][k]) for k in st)


# --- (e) checkpoints of either form of Adam's state ---------------------------------------


def _stepped(cfg, cpu, steps=2):
    built = ttrain.build_training(cfg, cpu)
    source = built.batcher.epochs()
    for i in range(steps):
        built.step_fn(ttrain.batch_to_device(next(source), cpu), i)
    return built, source


def _card_form(opt_state, lr):
    """What the card's capturable Adam writes (the tensors brought to the
    CPU, as CheckpointManager stores them): capturable groups, the lr a
    tensor, f32 step counts."""
    out = {"state": {i: {**st, "step": torch.as_tensor(float(st["step"]), dtype=torch.float32)}
                     for i, st in opt_state["state"].items()},
           "param_groups": [{**g, "capturable": True, "lr": torch.tensor(lr)} for g in opt_state["param_groups"]]}
    return out


def _old_form(opt_state):
    """An older form: float step counts, a float lr, not capturable."""
    return {"state": {i: {**st, "step": float(st["step"])} for i, st in opt_state["state"].items()},
            "param_groups": [{**g, "capturable": False} for g in opt_state["param_groups"]]}


@pytest.mark.parametrize("form", ["card", "old"])
def test_optimizer_state_of_either_form_restores_and_steps_the_same(data, form, tmp_path):
    """A checkpoint whose Adam state the card wrote (capturable, lr tensor)
    or an older one (float steps) restores into the CPU's Adam and steps
    to the bits of the run that never stopped; into a capturable Adam it
    keeps that optimizer's lr tensor and flags and puts the step counts
    on the parameters' device as f32."""
    root, path = data
    cpu = torch.device("cpu")
    cfg = _config(root, path, f"form_{form}")
    built, source = _stepped(cfg, cpu)
    saved = train_state(built.sim, built.optimizer, 2)
    path_ = CheckpointManager(tmp_path).save_best(saved, 2, 1.0)
    state, _ = CheckpointManager(tmp_path).restore(path_.name)
    lr = ttrain.lr_schedule(cfg)(2)
    opt_state = _card_form(state["opt_state"], lr) if form == "card" else _old_form(state["opt_state"])
    resumed = ttrain.build_training(cfg, cpu)
    resumed.sim.load_state_dict(state["params"])
    load_optimizer_state(resumed.optimizer, opt_state)
    for g in resumed.optimizer.param_groups:
        assert g["capturable"] is False and isinstance(g["lr"], float)
    for st in resumed.optimizer.state.values():
        assert st["step"].dtype == torch.float32 and st["step"].device == cpu and float(st["step"]) == 2.0
    batch = ttrain.batch_to_device(next(source), cpu)
    resumed.step_fn.generator.set_state(built.step_fn.generator.get_state())
    a, b = built.step_fn(batch, 2), resumed.step_fn(batch, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(v, resumed.sim.state_dict()[k]) for k, v in built.sim.state_dict().items())

    capturable = torch.optim.Adam(resumed.sim.parameters(), lr=torch.tensor(0.5), capturable=True)
    own_lr = capturable.param_groups[0]["lr"]
    load_optimizer_state(capturable, opt_state)
    assert capturable.param_groups[0]["lr"] is own_lr and capturable.param_groups[0]["capturable"] is True
    for p, st in capturable.state.items():
        assert st["step"].dtype == torch.float32 and st["step"].device == p.device and float(st["step"]) == 2.0


def test_resume_from_a_checkpoint_the_card_wrote(data):
    """train resumes on the CPU from a best checkpoint rewritten in the
    card's form of Adam's state."""
    root, path = data
    cfg = _config(root, path, "card_resume")
    assert ttrain.train(cfg, device="cpu")["step"] == 4
    ckpt = CheckpointManager(root / "models" / "card_resume")
    state, meta = ckpt.restore()
    state["opt_state"] = _card_form(state["opt_state"], ttrain.lr_schedule(cfg)(4))
    name = ckpt.save_best(state, 4, meta["lowest_eval_loss"]).name
    out = ttrain.train(_config(root, path, "card_resume", model_file=name, ntraining_steps=6, nsave_steps=2),
                       device="cpu")
    assert out["step"] == 6
