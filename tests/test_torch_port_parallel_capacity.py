"""The capacity knobs on the port's graph-partitioned forward against JAX's
on the CPU (the cases of ``tests/test_edge_partition.py:598-751``): banded
gathers with the halo offset, exact and counted by the guard; remat through
the sharded forward; the packed gather over the extended rows, composed
with banded gathers.

JAX runs ``sgnn_tpu.parallel.edge_partition`` on 4 devices of the host mesh;
the port runs 4 shards on a mesh of CPU devices. Routes of the port are
held to each other with ``torch.equal``; to JAX, at the JAX tests'
tolerances.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.ops import sym_gather as jsg
from sgnn_tpu.parallel import edge_partition as jep
from sgnn_tpu_torch.ops import sym_gather as tsg
from sgnn_tpu_torch.parallel import edge_partition as tep
from test_torch_port_parallel import R, as_port, cpu_mesh, jax_mesh, port_sim, setup, t

torch.set_num_threads(1)

SHARDS = 4
BAR_DOMAIN = ((-2.0, -2.0), (40.0, 6.0))
# tests/test_edge_partition.py:746-749 (the symmetric route against the plain one)
SYM_TOL = dict(rtol=2e-4, atol=1e-6)
# gradients against JAX's: tests/test_edge_partition.py:134-136
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _inputs(seq, n):
    spec, order = tep.partition_plan(seq[:, -1], SHARDS, R)
    seq_sorted = tep.scatter_to_shards(seq, order, spec)
    mask = np.zeros(spec.total_nodes, bool)
    mask[:n] = True
    return spec, seq_sorted, np.zeros(spec.total_nodes, np.int32), mask


def port_run(tcfg, tstats, spec, sim, seq_sorted, types, mask):
    """(acc, strain, violations, gradients) of the port's sharded forward."""
    fwd = tep._build_forward(cpu_mesh(SHARDS), tcfg, tstats, spec)
    replicas = tep.Replicas(sim, cpu_mesh(SHARDS).graph_devices)
    replicas.sync()
    replicas.zero_grad()
    acc, strain, viol = fwd(replicas.modules, t(seq_sorted), t(types), t(mask))
    (acc.square().sum() + strain.square().sum()).backward()
    for module in replicas.copies:
        replicas.fold(module)
    grads = {k: p.grad.clone() for k, p in sim.named_parameters()}
    sim.zero_grad()
    return acc.detach(), strain.detach(), int(viol), grads


def jax_run(jcfg, jstats, spec, params, seq_sorted, types, mask):
    jspec = jep.PartitionSpec1D(*dataclasses.astuple(spec))
    fwd = jax.jit(jep._build_forward(jax_mesh(SHARDS), jcfg, jstats, jspec, "graph"))
    args = (jnp.asarray(seq_sorted), jnp.asarray(types), jnp.asarray(mask))

    def loss(p):
        acc, strain, _ = fwd(p, *args)
        return jnp.sum(acc**2) + jnp.sum(strain**2)

    acc, strain, viol = fwd(params, *args)
    return np.asarray(acc), np.asarray(strain), int(viol), as_port(jax.grad(loss)(params))


def _force_banded(monkeypatch):
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "_BANDED_MIN_ROWS", 64)
        monkeypatch.setattr(mod, "_BANDED_MIN_FANOUT_ROWS", 64)
        monkeypatch.setattr(mod, "_BANDED_TILE_ROWS", 128)


def _assert_equal(got, ref):
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for name, g in got[3].items():
        assert torch.equal(g, ref[3][name]), name


def _assert_close_to_jax(got, want, mask):
    np.testing.assert_allclose(got[0].numpy()[mask], want[0][mask], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[1].numpy()[mask], want[1][mask], rtol=2e-4, atol=2e-5)
    for name, w in want[3].items():
        np.testing.assert_allclose(got[3][name].numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


def test_partitioned_banded_gathers_exact(monkeypatch):
    """With band_nodes and the thresholds forced down, the shards' banded
    sender gathers and banded reverse gathers give outputs and gradients
    bit-equal to the unbanded sharded forward, the guard counts 0 (the halo
    offset centres the band in ext coordinates), the values are JAX's, and
    a too-small band is counted (as JAX counts it), not silently wrong."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    kw = dict(symmetric_gather=True, max_neighbors=20, domain=BAR_DOMAIN)
    jbase, tbase = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    spec, seq_sorted, types, mask = _inputs(seq, n)
    sim = port_sim(tcfg, params)
    # the symmetric route at test size, its reverse index built apart (the
    # unfused route): the reverse gathers band with the halo offset
    for mod in (jep, tep):
        monkeypatch.setattr(mod, "_SYM_MIN_LOCAL_ROWS", 0)
    jbase, tbase = (dataclasses.replace(c, packed_gather_max_nodes=1) for c in (jbase, tbase))
    ref = port_run(tbase, tstats, spec, sim, seq_sorted, types, mask)
    assert ref[2] == 0
    _force_banded(monkeypatch)
    before = dict(tsg.BANDED)
    # a band that holds on the x-sorted bar (a column's 8 rows, jittered,
    # and the next column's) and leaves the reverse gathers' window smaller
    # than their table, so that they take the banded index (the ext tables
    # fit one window: their sender gathers stay plain, as JAX's)
    band = 20
    got = port_run(dataclasses.replace(tbase, band_nodes=band), tstats, spec, sim, seq_sorted, types, mask)
    assert got[2] == 0 and tsg.BANDED["reverse"] > before["reverse"]
    _assert_equal(got, ref)
    want = jax_run(dataclasses.replace(jbase, band_nodes=band), jstats, spec, params, seq_sorted, types, mask)
    assert want[2] == 0
    _assert_close_to_jax(got, want, mask)
    tight = port_run(dataclasses.replace(tbase, band_nodes=2), tstats, spec, sim, seq_sorted, types, mask)
    jtight = jax_run(dataclasses.replace(jbase, band_nodes=2), jstats, spec, params, seq_sorted, types, mask)
    assert tight[2] == jtight[2] > 0


def test_partitioned_remat_matches_plain():
    """cfg.remat flows through the sharded forward: loss and gradients of
    every mode torch.equal to remat=False, and JAX's remat=True within the
    partitioned gradient tolerance."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    spec, seq_sorted, types, mask = _inputs(seq, n)
    sim = port_sim(tcfg, params)
    ref = port_run(tcfg, tstats, spec, sim, seq_sorted, types, mask)
    for mode in (True, "xj_msg", "full", "group"):
        _assert_equal(port_run(dataclasses.replace(tcfg, remat=mode), tstats, spec, sim, seq_sorted, types, mask),
                      ref)
    want = jax_run(dataclasses.replace(jcfg, remat=True), jstats, spec, params, seq_sorted, types, mask)
    _assert_close_to_jax(ref, want, mask)


def test_partitioned_packed_banded_grads_match(monkeypatch):
    """The packed gather over the ext rows (symmetric route engaged at test
    size): outputs and gradients within the symmetric tolerance of the
    plain sharded route, and of JAX's packed route; with banded gathers on
    top, bit-equal to the unbanded packed route."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    kw = dict(max_neighbors=20, domain=BAR_DOMAIN)
    jbase, tbase = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    spec, seq_sorted, types, mask = _inputs(seq, n)
    sim = port_sim(tcfg, params)
    plain = port_run(tbase, tstats, spec, sim, seq_sorted, types, mask)
    for mod in (jep, tep):
        monkeypatch.setattr(mod, "_SYM_MIN_LOCAL_ROWS", 0)
    tsym, jsym = dataclasses.replace(tbase, symmetric_gather=True), dataclasses.replace(jbase, symmetric_gather=True)
    calls = tsg.BWD_CALLS
    packed = port_run(tsym, tstats, spec, sim, seq_sorted, types, mask)
    assert packed[2] == 0 and tsg.BWD_CALLS > calls
    np.testing.assert_allclose(packed[0].numpy(), plain[0].numpy(), rtol=1e-6, atol=1e-7)
    for name, g in packed[3].items():
        np.testing.assert_allclose(g.numpy(), plain[3][name].numpy(), err_msg=name, **SYM_TOL)
    _assert_close_to_jax(packed, jax_run(jsym, jstats, spec, params, seq_sorted, types, mask), mask)
    _force_banded(monkeypatch)
    before = dict(tsg.BANDED)
    banded = port_run(dataclasses.replace(tsym, band_nodes=20), tstats, spec, sim, seq_sorted, types, mask)
    assert banded[2] == 0 and tsg.BANDED["reverse"] > before["reverse"]
    _assert_equal(banded, packed)
