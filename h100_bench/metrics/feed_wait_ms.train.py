"""``feed_wait_ms.train``: mean host milliseconds per window step spent in
``next()`` on the port's ``DevicePrefetcher`` (the benchmark's span)."""


def read(runner, breakdown):
    waits = runner.feed_waits
    return 1e3 * sum(waits) / len(waits) if waits else None
