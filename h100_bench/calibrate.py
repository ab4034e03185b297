"""Readings that the limits of a cell's check are set from, many seeds in
one process (the benchmark's own runs never run this):

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--seconds S]

Per seed, one JSON line: the numbers the check compares for the program
(``program``), for the control (``control``: the reference at TF32 in the
program's place) and, for a training cell, for the fault of half the batch
left out (``half_batch``). A training cell drives only its checked first
steps; a serving cell a window of ``--seconds`` at the cell's own load.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402
from h100_bench.run import Context  # noqa: E402


def readings(cell_name: str, seed: int, seconds: float, device=None) -> dict:
    import torch

    cell = harness.find_cell(cell_name)
    dev = torch.device(device or "cuda")
    ctx = Context(cell, seed, dev, harness.scratch_dir(cell_name))
    runner = harness.load_module(harness.BENCH_DIR / "runners" / f"{cell.traffic['runner']}.py",
                                 f"calib_{cell.traffic['runner']}").Runner(ctx)
    t0 = time.perf_counter()
    runner.setup()
    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    if cell.traffic["runner"] == "train":
        runner.free()
        want = runner.reference_steps("f32")
        out["program"] = runner.gaps(runner.program_readings(), want)
        out["control"] = runner.gaps(runner.reference_steps("tf32"), want)
        out["half_batch"] = runner.gaps(runner.reference_steps("f32", drop_half=True), want)
        out["losses"] = {"program": runner.losses, "reference": want["losses"]}
    else:
        runner.window(seconds, None)
        out["requests"] = len(runner.latencies)
        runner.free()
        out["program"] = runner.check()
        out["control"] = runner.control()
    del runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
