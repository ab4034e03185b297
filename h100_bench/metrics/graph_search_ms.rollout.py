"""``graph_search_ms.rollout``: mean host milliseconds per traced request
(per ``rollout`` root span of the port) in the multi-scale hierarchy's
search, the port's ``graph.search`` spans (one per ``create_all_edges``
call of the loader)."""

from h100_bench.metrics._spans import per_request_ms


def read(runner, breakdown):
    return per_request_ms(("graph.search",), within_request=False)
