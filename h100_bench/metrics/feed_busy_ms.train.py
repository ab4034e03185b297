"""``feed_busy_ms.train``: mean host milliseconds per batch that the port's
``DevicePrefetcher`` thread spends on it, ``feed.build`` (the batcher
producing it) plus ``feed.stage`` (pinning and enqueuing its copies), the
port's own spans over the traced steps, paired by the batch's sequence
number: the feed's busy time, beside ``feed_wait_ms.train``'s wait."""

from h100_bench.metrics._spans import per_batch_ms


def read(runner, breakdown):
    return per_batch_ms(("feed.build", "feed.stage"))
