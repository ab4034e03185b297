"""``sorted_sum_ms.train``: device milliseconds per traced step in the
sorted segment sums (``sorted_segment_sum_kernel`` and the
``sorted_segment_combine_kernel`` that joins runs crossing its chunks):
the aggregations at receivers and the sender gathers' backward, the part
of the step that a receiver's skew (hundreds of grid points at a pole's
mesh node) slows. None unless the trace's launches of the sum kernel equal
the port's count of sorted sums over the traced steps
(``row_gather.BWD_LAUNCHES["sorted"]``, ``counters.read_counters``)."""

from h100_bench import trace


def read(runner, breakdown):
    if breakdown is None or not runner.traced_steps:
        return None
    sec, launches = trace.kernel_seconds(breakdown["per_name"], r"sorted_segment_sum_kernel")
    combine, _ = trace.kernel_seconds(breakdown["per_name"], r"sorted_segment_combine_kernel")
    if launches == 0 or launches != runner.counters.get("sorted"):
        return None
    return 1e3 * (sec + combine) / runner.traced_steps
