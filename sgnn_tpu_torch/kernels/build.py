"""Build the CUDA sources in ``sgnn_tpu_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
at first use, with::

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
       -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` under the repository root (the ``build/`` entry of
``.gitignore`` keeps it out of git). A source may include the headers of
``csrc`` (``*.cuh``); they are no sources of their own. The library name
carries a hash of the source, every header and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
``build_all`` starts one nvcc per source, all at once.

The ``sm_90a`` target (Hopper) is the only one built. Nothing is compiled
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel, kept in the log
]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of sgnn_tpu_torch are built from source at first use"
        )
    return found


def headers() -> List[Path]:
    """The headers a source may include (``csrc/*.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in headers():
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile every (or the named) source not yet built, one nvcc each,
    all started together. Returns ``{name: {"seconds", "log", "path"}}``;
    raises if any compile fails."""
    names = sources() if names is None else names
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {name: _start(name, nvcc) for name in names}
    report, failed = {}, []
    for name, proc in procs.items():
        out = library_path(name)
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log, "path": str(out)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
