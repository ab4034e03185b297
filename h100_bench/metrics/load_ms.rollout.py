"""``load_ms.rollout``: mean host milliseconds per traced request (per
``rollout`` root span of the port) in the port's loader spans: the
trajectory file's read (``load.read``), its padding (``load.pad``) and,
multi-scale, the hierarchy's search (``graph.search``) and layout
(``graph.layout``)."""

from h100_bench.metrics._spans import per_request_ms


def read(runner, breakdown):
    return per_request_ms(("load.read", "load.pad", "graph.search", "graph.layout"), within_request=False)
