"""``mfu.rollout``: the model's matrix-product operations over the window
(``runner.model_flops``, counted by the benchmark on the inputs' real
nodes and valid edges) per second of the window, as a share of the card's
peak for the configuration's dtype (``yardstick.PEAK_FLOPS``), in percent."""

from h100_bench import yardstick


def read(runner, breakdown):
    flops = runner.model_flops()
    if not flops or runner.window_s <= 0:
        return None
    return 100.0 * flops / runner.window_s / yardstick.PEAK_FLOPS[runner.mc["dtype"]]
