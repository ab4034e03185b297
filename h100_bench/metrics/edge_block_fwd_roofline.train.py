"""``edge_block_fwd_roofline.train``: the share of its roofline that the
training step's ``edge_block_fwd`` launches reach (see ``_roofline.py``)."""

from h100_bench.metrics._roofline import share


def read(runner, breakdown):
    return share(runner, breakdown, "edge_block_fwd")
