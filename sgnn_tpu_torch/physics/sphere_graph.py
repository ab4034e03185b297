"""GraphCast's static graphs on the sphere, built once on the host.

Lam et al., "Learning skillful medium-range global weather forecasting"
(Science 2023, arXiv:2212.12794), and ``graphcast/icosahedral_mesh.py``,
``grid_mesh_connectivity.py`` and ``model_utils.py`` of
github.com/google-deepmind/graphcast:

  * the grid: ``lat x lon`` points at the resolution's spacing, poles
    included, node ``i_lat * lon + i_lon`` (``grid``);
  * the icosahedron, rotated about y as GraphCast's ``get_icosahedron``
    rotates it (no vertex at a pole), refined ``refinement`` times by
    splitting every triangle into four at its edges' midpoints (projected
    onto the sphere); each level's vertices are the first of the next
    level's, so the levels share indices (``icosphere``);
  * the multi-mesh: the union of every level's edges (M0 to M_r, the
    paper's rule: 60 * (4^(r+1) - 1) / 3 directed edges, 81,900 at r = 5)
    over the finest level's vertices (``multi_mesh``);
  * grid2mesh: every grid point within ``radius_fraction`` times the
    finest level's longest edge (chord length on the unit sphere) of a
    mesh node sends to it (``grid2mesh``);
  * mesh2grid: the three vertices of the finest triangle that holds a grid
    point send to it; of the triangles that hold it (barycentric
    coordinates of the ray through it all >= -1e-9: two on an edge, five
    or six at a vertex), the one whose centre is the largest by (z, y, x)
    (``mesh2grid``);
  * features (``node_features``, ``edge_features``): a node's cos(lat),
    sin(lon), cos(lon); an edge's length and the sender minus the receiver
    in the receiver's local frame (the receiver rotated to lat 0, lon 0:
    x along it, y east, z north), both divided by the edge set's longest
    edge.

``build_graph`` makes all of it as the model takes it: ``PaddedEdges`` in
``models/multi_scale.flatten_ms_graph``'s contract (receivers ascending,
each set padded to a multiple of ``edge_pad_multiple``, padded slots at the
receiver table's and the sender table's last rows, the sender order), with
each stage's span (``graph.grid``, ``graph.multimesh``, ``graph.g2m``,
``graph.m2g``, attributes ``nodes``, ``edges`` and ``max_in_degree``) and
the counter ``edge_counts``: per stage (valid edges, padded edge rows).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np

from sgnn_tpu_torch.physics.multi_scale_graph import PaddedEdges, sender_order
from sgnn_tpu_torch.utils.profiling import trace_region

BARY_TOL = 1e-9  # barycentric coordinates above -this hold a point
M2G_CANDIDATES = 8  # nearest triangle centres tried per grid point before all of them


class Grid(NamedTuple):
    lat: np.ndarray  # f64[N] degrees
    lon: np.ndarray  # f64[N] degrees
    xyz: np.ndarray  # f64[N, 3] unit vectors


class Mesh(NamedTuple):
    xyz: np.ndarray  # f64[V, 3] unit vectors of the finest level
    faces: np.ndarray  # i64[F, 3] the finest level's triangles
    level_faces: Tuple[np.ndarray, ...]  # every level's triangles, coarsest first


class SphereGraph(NamedTuple):
    """Everything the model reads of the graphs (numpy on the host)."""

    grid_nodes: int
    mesh_nodes: int
    grid_features: np.ndarray  # f32[N_grid, 3]
    mesh_features: np.ndarray  # f32[N_mesh, 3]
    g2m: PaddedEdges  # senders: grid rows, receivers: mesh rows
    m2m: PaddedEdges
    m2g: PaddedEdges  # senders: mesh rows, receivers: grid rows
    g2m_features: np.ndarray  # f32[E_pad, 4], padded rows zero
    m2m_features: np.ndarray
    m2g_features: np.ndarray
    edge_counts: Dict[str, Tuple[int, int]]  # stage -> (valid edges, padded edge rows)


def grid(resolution_deg: float) -> Grid:
    """The lat-lon grid at ``resolution_deg``, poles included: lat from -90
    to 90, lon from 0, node ``i_lat * n_lon + i_lon``."""
    n_lat = int(round(180.0 / resolution_deg)) + 1
    n_lon = int(round(360.0 / resolution_deg))
    lat = np.linspace(-90.0, 90.0, n_lat)
    lon = np.arange(n_lon) * resolution_deg
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    la, lo = la.ravel(), lo.ravel()
    return Grid(la, lo, lat_lon_to_xyz(la, lo))


def lat_lon_to_xyz(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    phi, lam = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.stack([np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam), np.sin(phi)], axis=-1)


def xyz_to_lat_lon(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lat = np.rad2deg(np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0)))
    lon = np.rad2deg(np.arctan2(xyz[:, 1], xyz[:, 0])) % 360.0
    return lat, lon


def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    """The 12 vertices and 20 faces, rotated about y by (pi - the dihedral
    angle) / 2, as GraphCast's ``get_icosahedron``."""
    p = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p), (0, 1, p),
                  (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)], np.float64)
    v /= np.linalg.norm([1.0, p])
    f = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4), (11, 10, 2),
                  (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
                  (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)
    angle = (math.pi - 2.0 * math.asin(p / math.sqrt(3.0))) / 2.0
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])  # about y
    return v @ rot, f


def icosphere(refinement: int) -> Mesh:
    """The icosahedron refined ``refinement`` times (see the module
    docstring): V = 10 * 4^r + 2 vertices, 20 * 4^r faces at level r."""
    xyz, faces = icosahedron()
    verts = [xyz]
    count = len(xyz)
    levels = [faces]
    for _ in range(refinement):
        mid: Dict[Tuple[int, int], int] = {}
        new_pts = []

        def midpoint(a: int, b: int) -> int:
            nonlocal count
            key = (a, b) if a < b else (b, a)
            if key not in mid:
                m = all_xyz[a] + all_xyz[b]
                new_pts.append(m / np.linalg.norm(m))
                mid[key] = count
                count += 1
            return mid[key]

        all_xyz = np.concatenate(verts)
        out = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        verts.append(np.asarray(new_pts))
        faces = np.asarray(out, np.int64)
        levels.append(faces)
    return Mesh(np.concatenate(verts), faces, tuple(levels))


def face_edges(faces: np.ndarray) -> np.ndarray:
    """i64[E, 2] (sender, receiver): both directions of every side, once."""
    sides = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    both = np.concatenate([sides, sides[:, ::-1]])
    return np.unique(both, axis=0)


def multi_mesh(mesh: Mesh) -> np.ndarray:
    """i64[E, 2] (sender, receiver): the union of every level's edges."""
    return np.unique(np.concatenate([face_edges(f) for f in mesh.level_faces]), axis=0)


def longest_edge(mesh: Mesh) -> float:
    e = face_edges(mesh.faces)
    return float(np.linalg.norm(mesh.xyz[e[:, 0]] - mesh.xyz[e[:, 1]], axis=-1).max())


def grid2mesh(g: Grid, mesh: Mesh, radius_fraction: float) -> np.ndarray:
    """i64[E, 2] (grid sender, mesh receiver): grid points within
    ``radius_fraction`` times the finest level's longest edge of a mesh node."""
    from scipy.spatial import cKDTree

    radius = radius_fraction * longest_edge(mesh)
    near = cKDTree(g.xyz).query_ball_point(mesh.xyz, r=radius)
    recv = np.repeat(np.arange(len(near)), [len(n) for n in near])
    send = np.concatenate([np.asarray(n, np.int64) for n in near]) if len(recv) else np.zeros(0, np.int64)
    return np.stack([send, recv], axis=1)


def barycentric(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """f64[..., 3]: p = sum_k w_k tri[k] for ``points [..., 3]`` and
    triangles ``tri [..., 3, 3]`` (rows the vertices)."""
    return np.linalg.solve(np.swapaxes(tri, -1, -2), points[..., None])[..., 0]


def face_rank(mesh: Mesh) -> np.ndarray:
    """i64[F]: each finest face's rank by its centre, (z, y, x) rounded to
    1e-9, ascending (a rule of positions alone, not of face numbers)."""
    c = np.round(mesh.xyz[mesh.faces].mean(axis=1) * 1e9).astype(np.int64)
    rank = np.empty(len(c), np.int64)
    rank[np.lexsort((c[:, 0], c[:, 1], c[:, 2]))] = np.arange(len(c))
    return rank


def mesh2grid(g: Grid, mesh: Mesh) -> np.ndarray:
    """i64[E, 2] (mesh sender, grid receiver): the three vertices of the
    finest triangle holding each grid point (see the module docstring)."""
    from scipy.spatial import cKDTree

    tri = mesh.xyz[mesh.faces]  # [F, 3, 3]
    rank = face_rank(mesh)
    k = min(M2G_CANDIDATES, len(mesh.faces))
    _, cand = cKDTree(tri.mean(axis=1)).query(g.xyz, k=k)
    cand = cand.reshape(len(g.xyz), k)
    holds = barycentric(np.repeat(g.xyz[:, None], k, axis=1), tri[cand]).min(axis=-1) >= -BARY_TOL  # [N, k]
    face = cand[np.arange(len(g.xyz)), np.where(holds, rank[cand], -1).argmax(axis=1)]
    for i in np.nonzero(~holds.any(axis=1))[0]:  # none of the nearest centres' triangles holds it: every one
        held = barycentric(np.repeat(g.xyz[i][None], len(tri), axis=0), tri).min(axis=-1) >= -BARY_TOL
        face[i] = int(np.where(held, rank, -1).argmax())
    send = mesh.faces[face].reshape(-1)
    recv = np.repeat(np.arange(len(g.xyz)), 3)
    return np.stack([send, recv], axis=1)


def node_features(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    """f32[N, 3]: cos(lat), sin(lon), cos(lon)."""
    phi, lam = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.stack([np.cos(phi), np.sin(lam), np.cos(lam)], axis=-1).astype(np.float32)


def local_rotation(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    """f64[N, 3, 3]: the rotation Ry(lat) Rz(-lon) that takes the point at
    (lat, lon) to (1, 0, 0), its east to y and its north to z."""
    phi, lam = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    z = np.zeros_like(phi)
    o = np.ones_like(phi)
    rz = np.stack([np.stack([np.cos(lam), np.sin(lam), z], -1), np.stack([-np.sin(lam), np.cos(lam), z], -1),
                   np.stack([z, z, o], -1)], -2)
    ry = np.stack([np.stack([np.cos(phi), z, np.sin(phi)], -1), np.stack([z, o, z], -1),
                   np.stack([-np.sin(phi), z, np.cos(phi)], -1)], -2)
    return ry @ rz


def edge_features(edges: np.ndarray, send_xyz: np.ndarray, recv_xyz: np.ndarray, recv_lat: np.ndarray,
                  recv_lon: np.ndarray) -> np.ndarray:
    """f32[E, 4]: length and (sender - receiver) in the receiver's local
    frame, over the set's longest edge."""
    s, r = edges[:, 0], edges[:, 1]
    rot = local_rotation(recv_lat[r], recv_lon[r])
    rel = np.einsum("eij,ej->ei", rot, send_xyz[s] - recv_xyz[r])
    length = np.linalg.norm(rel, axis=-1, keepdims=True)
    scale = float(length.max()) if len(length) else 1.0
    return (np.concatenate([length, rel], axis=-1) / scale).astype(np.float32)


def pad_sorted(edges: np.ndarray, feats: np.ndarray, pad_multiple: int, n_send: int,
               n_recv: int) -> Tuple[PaddedEdges, np.ndarray]:
    """Receiver-sorted COO edges padded to a multiple of ``pad_multiple``:
    padded slots point at the last sender and the last receiver row (so
    the receivers stay non-decreasing and the senders, taken in the sender
    order, ascend), masked, with zero features."""
    order = np.lexsort((edges[:, 0], edges[:, 1]))
    e = len(edges)
    e_pad = max(pad_multiple, -(-e // pad_multiple) * pad_multiple)
    s = np.full(e_pad, n_send - 1, np.int32)
    r = np.full(e_pad, n_recv - 1, np.int32)
    m = np.zeros(e_pad, bool)
    f = np.zeros((e_pad, feats.shape[1]), np.float32)
    s[:e], r[:e], m[:e], f[:e] = edges[order, 0], edges[order, 1], True, feats[order]
    return PaddedEdges(s, r, m, sender_order(s, m)), f


def _max_in_degree(edges: np.ndarray, n_recv: int) -> int:
    return int(np.bincount(edges[:, 1], minlength=n_recv).max()) if len(edges) else 0


def _stamp(span, **attrs) -> None:
    if span is not None:
        span.attrs = attrs


def build_graph(resolution_deg: float, refinement: int, radius_fraction: float,
                edge_pad_multiple: int) -> SphereGraph:
    """The grid, the multi-mesh and the two bipartite sets, with their
    features, padded (see the module docstring)."""
    with trace_region("graph.grid") as span:
        g = grid(resolution_deg)
        _stamp(span, nodes=len(g.xyz), edges=0, max_in_degree=0)
    with trace_region("graph.multimesh") as span:
        mesh = icosphere(refinement)
        m2m = multi_mesh(mesh)
        m_lat, m_lon = xyz_to_lat_lon(mesh.xyz)
        _stamp(span, nodes=len(mesh.xyz), edges=len(m2m), max_in_degree=_max_in_degree(m2m, len(mesh.xyz)))
    ng, nm = len(g.xyz), len(mesh.xyz)
    with trace_region("graph.g2m") as span:
        g2m = grid2mesh(g, mesh, radius_fraction)
        _stamp(span, nodes=nm, edges=len(g2m), max_in_degree=_max_in_degree(g2m, nm))
    with trace_region("graph.m2g") as span:
        m2g = mesh2grid(g, mesh)
        _stamp(span, nodes=ng, edges=len(m2g), max_in_degree=_max_in_degree(m2g, ng))
    g2m_pe, g2m_f = pad_sorted(g2m, edge_features(g2m, g.xyz, mesh.xyz, m_lat, m_lon), edge_pad_multiple, ng, nm)
    m2m_pe, m2m_f = pad_sorted(m2m, edge_features(m2m, mesh.xyz, mesh.xyz, m_lat, m_lon), edge_pad_multiple, nm, nm)
    m2g_pe, m2g_f = pad_sorted(m2g, edge_features(m2g, mesh.xyz, g.xyz, g.lat, g.lon), edge_pad_multiple, nm, ng)
    counts = {name: (int(pe.mask.sum()), len(pe.mask)) for name, pe in (("g2m", g2m_pe), ("m2m", m2m_pe),
                                                                         ("m2g", m2g_pe))}
    return SphereGraph(ng, nm, node_features(g.lat, g.lon), node_features(m_lat, m_lon), g2m_pe, m2m_pe, m2g_pe,
                       g2m_f, m2m_f, m2g_f, counts)
