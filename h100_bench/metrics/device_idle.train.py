"""``device_idle.train``: the share of the traced window in which no
kernel, copy or set ran on the card (the union of the trace's device
intervals), in percent."""


def read(runner, breakdown):
    if breakdown is None or breakdown["window_s"] <= 0 or breakdown["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - breakdown["busy_s"] / breakdown["window_s"])
