"""Port radius search against sgnn_tpu.ops.neighbors: exact edge sets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgnn_tpu.ops import neighbors as jnb
from sgnn_tpu_torch.ops import neighbors as tnb

torch.set_num_threads(1)

R = 0.6


def _cloud(rng, n, extent, b=None):
    shape = (n, 2) if b is None else (b, n, 2)
    return rng.uniform(0.0, extent, size=shape).astype(np.float32)


def _equal(t_nl, j_nl):
    """Same senders in every slot and the same mask (padded slots = own index)."""
    np.testing.assert_array_equal(t_nl.mask.numpy(), np.asarray(j_nl.mask))
    np.testing.assert_array_equal(t_nl.senders.numpy(), np.asarray(j_nl.senders))


def _lattice(n_side, spacing):
    # f32 lattice on the radius: many pairs sit at d2 ~ r2, so the strict
    # test must round exactly as the JAX search does
    xs = np.arange(n_side, dtype=np.float32) * np.float32(spacing)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


@pytest.mark.parametrize("k", [24, 5])  # cap free / cap binding
@pytest.mark.parametrize("masked", [False, True])
def test_bruteforce_matches_jax(rng, k, masked):
    pos = _cloud(rng, 150, 4.0)
    mask = rng.random(150) > 0.2 if masked else None
    got = tnb.radius_neighbors_bruteforce(
        torch.from_numpy(pos), R, max_neighbors=k,
        node_mask=None if mask is None else torch.from_numpy(mask), tile=64,
    )
    want = jnb.radius_neighbors_bruteforce(
        jnp.asarray(pos), R, max_neighbors=k, node_mask=None if mask is None else jnp.asarray(mask)
    )
    _equal(got, want)
    if masked:
        assert not got.mask.numpy()[~mask].any()  # masked nodes have degree 0
    if k == 5:
        assert int(got.mask.sum(1).max()) == 5  # the cap binds


def test_bruteforce_lattice_on_the_radius():
    pos = _lattice(12, R)
    got = tnb.radius_neighbors_bruteforce(torch.from_numpy(pos), R, max_neighbors=9)
    _equal(got, jnb.radius_neighbors_bruteforce(jnp.asarray(pos), R, max_neighbors=9))


@pytest.mark.parametrize(
    "k,cap,extent", [(20, 8, 6.0), (4, 8, 6.0), (20, 2, 3.0)]
)  # free / cap binding / cell-capacity overflow
def test_grid_batched_matches_celltable(rng, k, cap, extent):
    b, n = 2, 160
    pos = _cloud(rng, n, extent, b=b)
    mask = rng.random((b, n)) > 0.15
    dom = ((-1.0, -1.0), (extent + 1.0, extent + 1.0))
    kw = dict(domain_min=dom[0], domain_max=dom[1], max_neighbors=k, cell_capacity=cap)
    got = tnb.radius_neighbors_grid_batched(
        torch.from_numpy(pos), R, node_mask=torch.from_numpy(mask), **kw
    )
    want = jnb.radius_neighbors_celltable(jnp.asarray(pos), R, node_mask=jnp.asarray(mask), **kw)
    _equal(got, want)
    np.testing.assert_array_equal(
        got.senders.numpy(),
        np.asarray(jnb.radius_neighbors_grid_batched(jnp.asarray(pos), R, node_mask=jnp.asarray(mask), **kw).senders),
    )
    flat = got.senders.numpy()
    graph_of = np.arange(b * n) // n
    assert (graph_of[flat] == graph_of[:, None]).all()  # no edge crosses graphs
    if cap == 2:
        brute = tnb.radius_neighbors_bruteforce(
            torch.from_numpy(pos[0]), R, max_neighbors=k, node_mask=torch.from_numpy(mask[0])
        )
        # overflow dropped real neighbors, so the cell list sees fewer edges
        assert int(got.mask[:n].sum()) < int(brute.mask.sum())


def test_grid_lattice_on_the_radius_matches_bruteforce():
    pos = _lattice(12, R)
    dom = ((-1.0, -1.0), (8.0, 8.0))
    got = tnb.radius_neighbors(
        torch.from_numpy(pos), R, max_neighbors=9, domain=dom, method="grid"
    )
    _equal(got, jnb.radius_neighbors_bruteforce(jnp.asarray(pos), R, max_neighbors=9))
    _equal(got, jnb.radius_neighbors_grid(jnp.asarray(pos), R, domain_min=dom[0], domain_max=dom[1], max_neighbors=9))


def test_dispatcher_picks_by_domain(rng):
    pos = torch.from_numpy(_cloud(rng, 60, 3.0))
    auto = tnb.radius_neighbors(pos, R, max_neighbors=12)
    grid = tnb.radius_neighbors(pos, R, max_neighbors=12, domain=((-1, -1), (4, 4)))
    assert torch.equal(auto.senders, grid.senders) and torch.equal(auto.mask, grid.mask)
    with pytest.raises(ValueError):
        tnb.radius_neighbors(pos, R, method="grid")
    with pytest.raises(ValueError):
        tnb.radius_neighbors(pos, R, method="kdtree")


@pytest.mark.parametrize("method", ["auto", "grid", "bruteforce"])
def test_simulator_neighbor_method_matches_jax(rng, method, monkeypatch):
    """SimulatorConfig.neighbor_method chooses compute_neighbors' search as
    JAX's does: with a domain, 'auto' and 'grid' take the cell list and
    'bruteforce' the brute force; the edges equal JAX's; without a domain
    'grid' raises, as does a method neither package knows."""
    import dataclasses

    from sgnn_tpu.physics import simulator as jsim
    from sgnn_tpu_torch.physics import simulator as tsim

    used = []
    brute = tnb.radius_neighbors_bruteforce

    def counted(*a, **kw):
        used.append("bruteforce")
        return brute(*a, **kw)

    monkeypatch.setattr(tnb, "radius_neighbors_bruteforce", counted)
    pos = _cloud(rng, 60, 3.0)
    domain = ((-1.0, -1.0), (4.0, 4.0))
    tcfg = tsim.SimulatorConfig(connectivity_radius=R, max_neighbors=12, domain=domain, neighbor_method=method)
    jcfg = jsim.SimulatorConfig(connectivity_radius=R, max_neighbors=12, domain=domain, neighbor_method=method)
    _equal(tsim.compute_neighbors(tcfg, torch.from_numpy(pos)), jsim.compute_neighbors(jcfg, jnp.asarray(pos)))
    assert used == (["bruteforce"] if method == "bruteforce" else [])
    with pytest.raises(ValueError):
        tsim.compute_neighbors(dataclasses.replace(tcfg, domain=None, neighbor_method="grid"), torch.from_numpy(pos))
    with pytest.raises(ValueError):
        tsim.compute_neighbors(dataclasses.replace(tcfg, neighbor_method="kdtree"), torch.from_numpy(pos))


def test_rows_are_prefix_compacted_with_self_padding(rng):
    nl = tnb.radius_neighbors_bruteforce(torch.from_numpy(_cloud(rng, 80, 3.0)), R, max_neighbors=10)
    mask = nl.mask.numpy()
    deg = mask.sum(1)
    assert (mask == (np.arange(10)[None] < deg[:, None])).all()
    rows = np.broadcast_to(np.arange(80)[:, None], mask.shape)
    assert (nl.senders.numpy()[~mask] == rows[~mask]).all()
    assert (nl.senders.numpy()[:, 0] <= rows[:, 0]).all()  # self loop kept, lowest first
