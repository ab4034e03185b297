"""``coo_edge_fill.train``: the share of the padded COO edge rows that hold
a valid edge over a training step's three stages, in percent, each stage
weighted by its traversals a forward (the multi-mesh once per processor
layer): what a dense or compacted layout would save. Read from the port's
counter on the built graph (``models/graphcast.GraphCast.edge_counts``:
per stage, valid edges and padded edge rows). None where the port keeps
no such counter."""

TRAVERSALS = {"g2m": 1, "m2g": 1}  # the multi-mesh: the configuration's processor layers


def read(runner, breakdown):
    counts = getattr(getattr(getattr(runner, "built", None), "sim", None), "edge_counts", None)
    if not counts:
        return None
    weight = {k: TRAVERSALS.get(k, runner.mc["layers"]) for k in counts}
    padded = sum(weight[k] * rows for k, (_, rows) in counts.items())
    return 100.0 * sum(weight[k] * valid for k, (valid, _) in counts.items()) / padded if padded else None
