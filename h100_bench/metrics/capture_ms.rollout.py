"""``capture_ms.rollout``: mean host milliseconds per traced request (per
``rollout`` root span of the port) in the eager warm-up step and the CUDA
graph capture of the rollout step, the port's spans ``step.warmup`` and
``step.capture`` under that root; 0 where no request captured."""

from h100_bench.metrics._spans import per_request_ms


def read(runner, breakdown):
    return per_request_ms(("step.warmup", "step.capture"), within_request=True)
