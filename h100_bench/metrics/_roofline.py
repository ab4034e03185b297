"""Shared by the ``<kernel>_roofline.*`` readers: a kernel group's share
of its roofline over the traced steps, in percent: the least seconds of
its launches (``yardstick``) over their device seconds in the trace. The
group's launches per step must agree between the port's counters and the
trace, and every launch must pass the L2 rule (``yardstick.qualifies``);
otherwise nothing is returned."""

from __future__ import annotations

from typing import Optional

from h100_bench import trace, yardstick


def share(runner, breakdown, group: str) -> Optional[float]:
    if breakdown is None:
        return None
    info = runner.kernel_bounds().get(group)
    if not info:
        return None
    steps = runner.traced_steps
    seconds, launches = trace.kernel_seconds(breakdown["per_name"], info["kernels"])
    if seconds <= 0 or info["launches"] != info["per_step"] * steps:
        return None
    if not all(yardstick.qualifies(b["bytes"]) for b in info["bounds"]):
        return None
    return 100.0 * sum(b["seconds"] for b in info["bounds"]) / seconds
