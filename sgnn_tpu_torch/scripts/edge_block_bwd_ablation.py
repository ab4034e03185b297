"""Where an edge-block kernel's time goes, on the card.

    python -m sgnn_tpu_torch.scripts.edge_block_bwd_ablation [--kernel bwd|fwd]

Builds ``csrc/edge_block_bwd.cu`` (or, with ``--kernel fwd``,
``csrc/edge_block_fwd.cu``) as it is and in variants with one part of each
tile's work removed or changed, one nvcc each, all started together, into
``build/ablation/``. Each variant is one self-contained source: the
headers it includes (``csrc/*.cuh``) are inlined first, so a pattern cuts
the shared tile code too. Backward variants: without the tile loads, the
four row products, the two weight-gradient products, the g_e / g_xj /
g_proj_i stores, the column-sum shuffles. Forward variants: without the
tile loads, the two row products, the new_e / agg stores; and with each
dtype's tile buffering swapped (f32 one buffer; bf16 two buffers and one
block per SM in place of one buffer and two blocks). Then times every build at the training shapes of configs A (f32,
R = 155,648) and B (bf16, R = 77,824), K = 8, D = H = 64: CUDA events
around launches that cycle two input sets (together beyond the 50 MB L2),
the kernel and each variant in turn, twice over. A cut variant's outputs
are wrong and only its time is read: what a part costs is the kernel's
time less the variant's, and the parts overlap, so those costs need not
add up to the whole. Prints the card's name and power limit, each build's
registers and spills from ``ptxas``, and one ``ablation {...}`` JSON line
per dtype. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from sgnn_tpu_torch.kernels import build
from sgnn_tpu_torch.ops import edge_block as eb

SOURCE = build.CSRC / f"{eb.BWD_KERNEL}.cu"
FWD_SOURCE = build.CSRC / f"{eb.KERNEL}.cu"
OUT_DIR = build.BUILD_DIR.parent / "ablation"
SHAPES = {"float32": 155_648, "bfloat16": 77_824}  # R of configs A and B at their batch
K, WIDTH = 8, 64
ITERS, WARMUP = 10, 2

# name: (pattern of the source text, times it must match[, replacement]);
# the replacement is an empty statement where none is given
VARIANTS = {
    "no_tile_loads": (r"stage_rows<T>\([^;]*;", 3),
    "no_row_products": (r"warp_gemm_(?:tf32<[^>]*>|bf16)\(acc,.*?g, t\);", 6),
    "no_weight_grad_products": (r"tile_gemm_tn<[^>]*>\(acc_w\w,.*?wm0, wn0, g, t\);", 3),
    "no_row_stores": (r"store_pair\((?:g_|dst)[^;]*;", 3),
    "no_column_sums": (r"add_column_sums\(acc_\w+, v, g\);", 4),
}
FWD_VARIANTS = {
    "no_tile_loads": (r"stage_rows<T>\([^;]*;", 2),
    "no_row_products": (r"warp_gemm_(?:tf32<[^>]*>|bf16)\(acc,.*?g, t\);", 4),
    "no_row_stores": (r"(?:residual_piece|slot_sum_piece)\((?:new_e|agg)[^;]*;", 2),
    "swapped_buffers": (r"sizeof\(T\) == 2 \? 1 : 2;", 1, "sizeof(T) == 2 ? 2 : 1;"),
}
KERNELS = {"bwd": (SOURCE, VARIANTS), "fwd": (FWD_SOURCE, FWD_VARIANTS)}


def kernel_source(path: Path = SOURCE) -> str:
    """The source at ``path`` with each ``#include "<header>.cuh"`` of
    ``csrc`` replaced by the header's text."""
    def inline(m):
        return (build.CSRC / m.group(1)).read_text()

    return re.sub(r'^#include "(\w+\.cuh)"$', inline, path.read_text(), flags=re.M)


def variant_sources(src: str, variants=VARIANTS) -> Dict[str, str]:
    """The kernel's source and each variant's, by name; raises if a
    pattern no longer matches the source as often as it should."""
    out = {"kernel": src}
    for name, (pattern, count, *replacement) in variants.items():
        found = len(re.findall(pattern, src, flags=re.S))
        if found != count:
            raise ValueError(f"variant {name}: pattern matches {found} times, expected {count}")
        out[name] = re.sub(pattern, replacement[0] if replacement else ";", src, flags=re.S)
    return out


def build_all(sources: Dict[str, str], kernel: str = "bwd") -> Dict[str, ctypes.CDLL]:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name, src in sources.items():
        cu = OUT_DIR / f"{kernel}_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{kernel}_{name}.so"))
    return libs


def inputs(r: int, dtype, seed: int):
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale  # noqa: E731
    rows = r * K
    degrees = torch.randint(0, K + 1, (r, 1), generator=g).float()
    args = [n(rows, WIDTH).to(dtype), n(rows, WIDTH).to(dtype), n(r, WIDTH), degrees,
            n(WIDTH, WIDTH, scale=0.2), n(WIDTH, scale=0.1), n(WIDTH, WIDTH, scale=0.2), n(WIDTH, scale=0.1),
            1.0 + n(WIDTH, scale=0.1), n(WIDTH, scale=0.1), n(rows, WIDTH).to(dtype), n(r, WIDTH).to(dtype)]
    return [a.cuda() for a in args]


def time_ms(lib, sets, kernel: str = "bwd") -> float:
    if kernel == "fwd":
        run = lambda i: eb._launch_fwd(lib, sets[i % 2][:10], K)  # noqa: E731
    else:
        run = lambda i: eb._launch_bwd(lib, sets[i % 2][:10], *sets[i % 2][10:], K)  # noqa: E731
    for i in range(WARMUP):
        run(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(ITERS):
        run(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="bwd")
    kernel = parser.parse_args(argv).kernel
    if not torch.cuda.is_available():
        print("edge_block_bwd_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    path, variants = KERNELS[kernel]
    libs = build_all(variant_sources(kernel_source(path), variants), kernel)
    for dtype_name, r in SHAPES.items():
        dtype = getattr(torch, dtype_name)
        sets = [inputs(r, dtype, seed) for seed in (0, 1)]
        runs = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                runs[name].append(time_ms(lib, sets, kernel))
        ms = {name: sum(t) / len(t) for name, t in runs.items()}
        cost = {name: ms["kernel"] - t for name, t in ms.items() if name != "kernel"}
        print("ablation " + json.dumps({"kernel": kernel, "dtype": dtype_name, "shape": [r, K, WIDTH], "ms": ms,
                                        "ms_runs": runs, "cost_ms": cost, "smi": smi}), flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
