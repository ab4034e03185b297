"""Multi-scale data loading: one static graph per trajectory.

The port's own copy of ``_build_graphs``, ``_stack_graphs``,
``MultiScaleSampleBatcher`` and ``MultiScaleTrajectoryLoader`` of
``sgnn_tpu/data/static_graph_loader.py``. Each trajectory's hierarchy is
built once from its frame-0 positions; all graphs of a split pad to the
split-wide maximum per edge type, so they share one shape, and a training
batch stacks each sample's own graph on a leading axis. Plain numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from sgnn_tpu_torch.data.loader import SampleBatcher, TrajectoryLoader, _round_up
from sgnn_tpu_torch.physics.multi_scale_graph import (
    DenseStaticGraph,
    MultiScaleConfig,
    StaticGraph,
    create_all_edges,
    dense_edges,
    pad_edges,
)
from sgnn_tpu_torch.utils.profiling import trace_region

KEYS = ("grid2mesh_edges", "mesh2mesh_edges", "mesh2grid_edges")


def _auto_dense(raw, edge_pad_multiple: int, m2m_traversals: int, dense_row_advantage: float) -> bool:
    """The layout rule of ``dense="auto"``: dense unless slot padding
    inflates traversal-weighted edge rows more than ``dense_row_advantage``
    times over the COO edge count (m2m is traversed ``m2m_traversals``
    times per forward, g2m and m2g once). Prints its choice."""
    w = {KEYS[0]: 1, KEYS[1]: max(1, m2m_traversals), KEYS[2]: 1}
    dense_rows, coo_rows = 0, 0
    for k in KEYS:
        e_max = max([1] + [len(r[k].senders) for r in raw])
        coo_rows += w[k] * _round_up(e_max, edge_pad_multiple)
        # dense m2m rows count per scale (tight per-scale K)
        views = range(len(raw[0]["mesh2mesh_edges_per_scale"])) if k == KEYS[1] else [None]
        for v in views:
            r_max, k_max = 1, 1
            for r in raw:
                e = r["mesh2mesh_edges_per_scale"][v] if v is not None else r[k]
                _, counts = np.unique(e.receivers, return_counts=True)
                r_max = max(r_max, len(counts))
                k_max = max(k_max, int(counts.max()) if len(counts) else 1)
            dense_rows += w[k] * _round_up(r_max, 8) * _round_up(k_max, 4)
    dense = dense_rows <= dense_row_advantage * coo_rows
    print(f"ms layout auto: {'dense' if dense else 'coo'} (dense rows {dense_rows} vs coo rows {coo_rows})")
    return dense


def _dense_sizes(edge_sets):
    """Split-wide dense pad sizes over a list of COO edge sets: (receiver
    rows, slots, plan rows, plan slots), rounded to 8 and 4."""
    r_max, k_max, sr_max, sk_max = 1, 1, 1, 1
    for e in edge_sets:
        recv, counts = np.unique(e.receivers, return_counts=True)
        r_max = max(r_max, len(recv))
        k_max = max(k_max, int(counts.max()) if len(counts) else 1)
        snd, scounts = np.unique(e.senders, return_counts=True)
        sr_max = max(sr_max, len(snd))
        sk_max = max(sk_max, int(scounts.max()) if len(scounts) else 1)
    return _round_up(r_max, 8), _round_up(k_max, 4), _round_up(sr_max, 8), _round_up(sk_max, 4)


def _build_graphs(
    trajectories,
    ms_cfg: MultiScaleConfig,
    edge_pad_multiple: int,
    *,
    dense: bool | str = False,
    num_nodes: int = 0,
    m2m_traversals: int = 6,
    dense_row_advantage: float = 2.0,
) -> List[StaticGraph] | List[DenseStaticGraph]:
    """One static graph per trajectory from frame-0 positions, common
    padding. ``dense=True`` emits DenseStaticGraphs (receiver rows and
    slot widths padded to the split-wide maximum per edge type, per scale
    for m2m), ``False`` StaticGraphs (COO edges padded to a multiple of
    ``edge_pad_multiple``), ``"auto"`` picks by ``_auto_dense``. Spans:
    ``graph.search`` per ``create_all_edges`` call, ``graph.layout`` over
    the layout's choice and padding."""
    raw = []
    for pos, _, _ in trajectories:
        with trace_region("graph.search"):
            raw.append(create_all_edges(ms_cfg, pos[0]))
    with trace_region("graph.layout"):
        if dense == "auto":
            dense = _auto_dense(raw, edge_pad_multiple, m2m_traversals, dense_row_advantage)
        if not dense:
            sizes = {k: _round_up(max(max(len(r[k].senders) for r in raw), 1), edge_pad_multiple) for k in KEYS}
            return [StaticGraph(*(pad_edges(r[k], sizes[k]) for k in KEYS)) for r in raw]

        sz = {k: _dense_sizes([r[k] for r in raw]) for k in (KEYS[0], KEYS[2])}
        num_m2m_scales = len(raw[0]["mesh2mesh_edges_per_scale"])
        sz_m2m = [_dense_sizes([r["mesh2mesh_edges_per_scale"][s] for r in raw]) for s in range(num_m2m_scales)]

        def de(e, s):
            return dense_edges(e, num_nodes, s[0], s[1], tsp_rows_pad=s[2], tsp_slots=s[3])

        return [
            DenseStaticGraph(
                g2m=de(r[KEYS[0]], sz[KEYS[0]]),
                m2m=tuple(de(e, s) for e, s in zip(r["mesh2mesh_edges_per_scale"], sz_m2m)),
                m2g=de(r[KEYS[2]], sz[KEYS[2]]),
            )
            for r in raw
        ]


def _stack_graphs(graphs):
    """Stack a list of StaticGraphs (or DenseStaticGraphs) along a new
    leading batch axis, field by field."""
    head = graphs[0]
    if isinstance(head, np.ndarray):
        return np.stack(graphs)
    parts = [_stack_graphs(list(items)) for items in zip(*graphs)]
    return type(head)(*parts) if hasattr(head, "_fields") else tuple(parts)


def check_sorted_ids(graph, num_nodes: int) -> None:
    """Raise unless a batched graph ([B, ...] leaves) keeps every id the
    sorted backward kernels take ascending once the batch is flattened:
    per sample, in ``[0, num_nodes)`` and non-decreasing (dense ``recv`` and
    ``tsp_node``; COO receivers, and COO senders taken in the graph's sender
    order, with padding at the last node, as ``flatten_ms_graph`` re-points
    it)."""
    if isinstance(graph, DenseStaticGraph):
        named = [(f"{t}.{f}", getattr(de, f)) for t, de in (("g2m", graph.g2m), ("m2g", graph.m2g),
                                                          *((f"m2m[{i}]", de) for i, de in enumerate(graph.m2m)))
                 for f in ("recv", "tsp_node")]
    else:
        named = []
        for t, pe in (("g2m", graph.g2m), ("m2m", graph.m2m), ("m2g", graph.m2g)):
            named.append((f"{t}.receivers", np.where(pe.mask, pe.receivers, num_nodes - 1)))
            senders = np.where(pe.mask, pe.senders, num_nodes - 1)
            named.append((f"{t}.order", np.take_along_axis(senders, pe.order.astype(np.int64), axis=-1)))
    for name, ids in named:
        if ids.size and (ids.min() < 0 or ids.max() >= num_nodes or (np.diff(ids, axis=-1) < 0).any()):
            raise ValueError(f"{name}: ids must lie in [0, {num_nodes}) and be non-decreasing per sample")


class MultiScaleSampleBatcher(SampleBatcher):
    """SampleBatcher that attaches each sample's trajectory static graph,
    stacked over the batch (``batch["graph"]``), and checks on the host
    that its ids stay ascending once flattened (``check_sorted_ids``)."""

    def __init__(
        self,
        path: str | Path,
        input_sequence_length: int,
        batch_size: int,
        *,
        ms_cfg: MultiScaleConfig,
        pad_multiple: int = 128,
        edge_pad_multiple: int = 1024,
        seed: int = 0,
        drop_remainder: bool = True,
        dense: bool | str = False,
        m2m_traversals: int = 6,
        dense_row_advantage: float = 2.0,
    ):
        super().__init__(path, input_sequence_length, batch_size, pad_multiple=pad_multiple, seed=seed,
                         drop_remainder=drop_remainder)
        self.graphs = _build_graphs(
            self.trajectories, ms_cfg, edge_pad_multiple,
            dense=dense, num_nodes=self.num_nodes,
            m2m_traversals=m2m_traversals, dense_row_advantage=dense_row_advantage,
        )

    def _gather(self, idxs: np.ndarray):
        batch = super()._gather(idxs)
        batch["graph"] = _stack_graphs([self.graphs[self.samples[i][0]] for i in idxs])
        check_sorted_ids(batch["graph"], self.num_nodes)
        return batch


class MultiScaleTrajectoryLoader(TrajectoryLoader):
    """TrajectoryLoader that attaches each trajectory's static graph
    (``item["graph"]``, numpy arrays)."""

    def __init__(
        self,
        path: str | Path,
        *,
        ms_cfg: MultiScaleConfig,
        pad_multiple: int = 128,
        edge_pad_multiple: int = 1024,
        dense: bool | str = False,
        m2m_traversals: int = 6,
        dense_row_advantage: float = 2.0,
    ):
        super().__init__(path, pad_multiple=pad_multiple)
        self.graphs = _build_graphs(
            self.trajectories, ms_cfg, edge_pad_multiple,
            dense=dense, num_nodes=self.num_nodes,
            m2m_traversals=m2m_traversals, dense_row_advantage=dense_row_advantage,
        )

    def __iter__(self):
        for item, graph in zip(super().__iter__(), self.graphs):
            item["graph"] = graph
            yield item
