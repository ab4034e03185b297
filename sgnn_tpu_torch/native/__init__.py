"""Native (C++) host-side radius search, loaded through ctypes.

The port's own copy of ``sgnn_tpu/native``: ``radius_search.cc`` (a cell
list; strict < r, optional self loops, a per-receiver cap keeping the
lowest sender indices, receiver-sorted output) is built at first use with
the host compiler, ``g++ -O3 -shared -fPIC``, into ``build/native/`` at the
repo root (``.gitignore``'s ``build/``), under a name that hashes the
source, so an edit rebuilds it; JAX's committed
``sgnn_tpu/native/libradius_search.so`` is never loaded.
``radius_search_host`` and ``max_degree_host`` return None where the library
cannot be built (no ``g++``); the multi-scale graph builder then takes
scipy's cKDTree, which gives the same edges. ``LAST_SEARCH`` names the
search that built the last radius graph (``"native"`` or ``"ckdtree"``).

Build by hand: ``python -m sgnn_tpu_torch.native.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).parent / "radius_search.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_lib = None
_build_failed = False
LAST_SEARCH: Optional[str] = None


def library_path() -> Path:
    """``build/native/libradius_search-<hash of the source>.so``."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libradius_search-{digest}.so"


def build(verbose: bool = False) -> bool:
    """Compile radius_search.cc into ``library_path()``. Returns success."""
    global _build_failed
    cxx = shutil.which("g++")
    if cxx is None:
        if verbose:
            print("g++ not found", file=sys.stderr)
        _build_failed = True
        return False
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        if verbose:
            print(f"g++ failed: {exc}", file=sys.stderr)
        _build_failed = True
        return False
    if res.returncode != 0:
        if verbose:
            print(res.stderr, file=sys.stderr)
        tmp.unlink(missing_ok=True)
        _build_failed = True
        return False
    os.replace(tmp, out)  # atomic: concurrent builders never load a half-written file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists() and (_build_failed or not build()):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.radius_search.restype = ctypes.c_int64
    lib.radius_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.max_degree.restype = ctypes.c_int32
    lib.max_degree.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def radius_search_host(
    positions: np.ndarray,
    radius: float,
    max_neighbors: int,
    include_self: bool = True,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(senders, receivers) int64 arrays, or None if the library is
    unavailable. Strict < r, per-receiver cap keeping the lowest sender
    indices, receiver-sorted output."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    n, dims = pos.shape
    cap = n * max_neighbors
    senders = np.empty(cap, np.int32)
    receivers = np.empty(cap, np.int32)
    e = lib.radius_search(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dims, ctypes.c_float(radius), max_neighbors, int(include_self),
        senders.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        receivers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return senders[:e].astype(np.int64), receivers[:e].astype(np.int64)


def max_degree_host(positions: np.ndarray, radius: float, include_self: bool = True) -> Optional[int]:
    """The largest in-radius count over the points, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    n, dims = pos.shape
    return int(lib.max_degree(pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, dims,
                              ctypes.c_float(radius), int(include_self)))
