"""Run one cell of the benchmark and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files are found by name (see
``harness.find_cell``). Set-up (dataset, the port's model and step,
weights from the seed, warm-up and the checked first steps) is timed as
``setup_s``; the window then runs for ``--seconds``; after it the peak
memory is read, the port's state is freed, and the plain reference decides
``correct``. With ``--trace 1`` the per-layer metrics are reported: host
spans and counts from the window, and a ``torch.profiler`` trace of a few
more steps or requests run after the window closes. The last line
of standard output is the result (JSON); the numbers compared, each with
its limit, are the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; so it does if JAX or the JAX package has been
imported by the time the window closes.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the port's caches stay in the checkout, at fixed paths (set before torch loads)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

from h100_bench import harness  # noqa: E402


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden import)."""


class Tracer:
    """``torch.profiler`` over the traced steps or requests (run after the
    window), its Chrome trace written to the scratch directory, read back
    once and deleted."""

    def __init__(self, path: Path):
        self.path, self.prof, self.span = path, None, None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function("bench.window")
        self.span.__enter__()

    def stop(self) -> None:
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self):
        """The traced window's breakdown, read once the window has closed."""
        from h100_bench import trace

        if self.prof is None:
            return None
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            return trace.breakdown(trace.load(str(self.path)))
        finally:
            self.path.unlink()


class Context:
    """What a runner is given: the cell, the seed, the device and helpers."""

    def __init__(self, cell: harness.Cell, seed: int, device, scratch: Path):
        self.cell, self.seed, self.device, self.scratch = cell, seed, device, scratch

    def dataset(self, cases: bool):
        from h100_bench import data

        spec = dict(self.cell.config["dataset"])
        spec.update(self.cell.traffic.get("dataset", {}))
        directory = harness.data_cache_dir({**spec, "cases": cases})
        trajs, metadata = data.prepare(spec, directory, cases)
        return trajs, metadata, directory

    def weights(self, shapes, output_layer: str, output_scale: float):
        from h100_bench.weights import make_weights

        return make_weights(shapes, self.seed, self.device, output_layer, output_scale)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def quiet(self):
        """The port's own printing goes to standard error."""
        with contextlib.redirect_stdout(sys.stderr):
            yield


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, device=None, benchmark=None,
        require_cuda: bool = True, on_runner=None, adjust=None) -> dict:
    """One run of a cell; the result as a dict (``numbers``: the compared
    numbers, each {value, limit}). ``require_cuda=False`` and ``device``
    let a test drive a run on the CPU; ``adjust(cell)`` lets it shrink the
    cell's files; ``on_runner(runner)`` lets it break the timed path before
    the set-up."""
    import torch

    cell = harness.find_cell(cell_name, benchmark)
    if adjust is not None:
        adjust(cell)
    if require_cuda:
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} found")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    scratch = harness.scratch_dir(cell_name)
    ctx = Context(cell, seed, dev, scratch)
    runner = harness.load_module(harness.BENCH_DIR / "runners" / f"{cell.traffic['runner']}.py",
                                 f"h100_bench.runners.{cell.traffic['runner']}").Runner(ctx)
    if on_runner is not None:
        on_runner(runner)
    runner.setup()
    setup_s = time.perf_counter() - _T_START
    tracer = Tracer(scratch / f"trace-{os.getpid()}.json") if trace else None
    e2e = runner.window(seconds, tracer)
    found = harness.forbidden_loaded()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e["peak_mem_gib"] = peak / 2 ** 30
    e2e["setup_s"] = setup_s
    for k in sorted(set(e2e) - {m["name"] for m in cell.end_to_end}):  # measured, not a metric of the cell
        print(f"not reported: {k} = {e2e[k]!r}", file=sys.stderr)
    breakdown = tracer.read() if tracer else None
    per_layer = {}
    if trace:
        for m in cell.per_layer:
            reader = harness.load_module(harness.BENCH_DIR / "metrics" / f"{m['name']}.py",
                                         f"h100_bench.metrics.{m['name']}")
            value = reader.read(runner, breakdown)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    runner.free()
    from h100_bench import compare

    limits = cell.workload["limits"]
    try:
        numbers = runner.check()
        correct = compare.judge(numbers, limits)
    except compare.CheckFailed as exc:
        print(f"check failed: {exc}", file=sys.stderr)
        numbers, correct = {}, False
    metrics = per_layer if trace else {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                                       for m in cell.end_to_end}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    if trace and breakdown is not None:
        device_info["busy_s"] = breakdown["busy_s"]
        device_info["window_s"] = breakdown["window_s"]
    attempted = len(getattr(runner, "latencies", [])) or getattr(runner, "window_steps", 0)
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace and breakdown is not None:
        result["breakdown"] = {"device_ops": breakdown["device_ops"], "idle_gaps": breakdown["idle_gaps"]}
    result["numbers"] = {k: {"value": numbers.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    result["_runner"] = runner
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        res = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 2
    res.pop("_runner")
    numbers = res.pop("numbers")
    for v in numbers.values():  # a number that is not finite prints as null (and fails its limit)
        if not math.isfinite(v["value"]):
            v["value"] = None
    res["checked"] = numbers  # the compared numbers beside their limits, last in the line
    for k, v in numbers.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
