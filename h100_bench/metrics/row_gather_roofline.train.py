"""``row_gather_roofline.train``: the share of its roofline that the
training step's ``row_gather`` launches reach (see ``_roofline.py``)."""

from h100_bench.metrics._roofline import share


def read(runner, breakdown):
    return share(runner, breakdown, "row_gather")
