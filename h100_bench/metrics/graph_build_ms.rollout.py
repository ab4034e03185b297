"""``graph_build_ms.rollout``: mean host milliseconds per request spent in
the port's loader of the request's trajectory (reading the one-trajectory
split file and, for the multi-scale model, building its static hierarchy)."""


def read(runner, breakdown):
    builds = runner.build_s
    return 1e3 * sum(builds) / len(builds) if builds else None
