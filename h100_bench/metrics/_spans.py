"""Shared by the readers of the port's own spans (``sgnn_tpu_torch.utils.
profiling.trace_region``): the finished records of the traced stretch,
which the port keeps while the benchmark's profile is active, and sums of
their host milliseconds per batch and per request. A port that keeps no
spans (no ``profiling.spans``) gives no records, and the readers return
None."""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional

REQUEST = "rollout"  # the root span of one rollout call: a request


def records() -> Optional[list]:
    """The port's finished span records, or None where it keeps none."""
    from sgnn_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    done = [s for s in spans() if s.end_ns is not None]
    return done or None


def ms(span) -> float:
    return (span.end_ns - span.start_ns) * 1e-6


def outermost(recs: List, names: Iterable[str]) -> List:
    """The records named in ``names`` that no record named in ``names``
    encloses (so that nested spans count once)."""
    names = set(names)
    by_index = {s.index: s for s in recs}
    out = []
    for s in recs:
        if s.name not in names:
            continue
        up = by_index.get(s.parent)
        while up is not None and up.name not in names:
            up = by_index.get(up.parent)
        if up is None:
            out.append(s)
    return out


def per_request_ms(names: Iterable[str], within_request: bool) -> Optional[float]:
    """Host ms per request (per ``rollout`` root span) in the spans named:
    those under a request's root (``within_request``), or every one (the
    loader's spans, which run before the request's rollout call)."""
    recs = records()
    if recs is None:
        return None
    roots = {s.index for s in recs if s.name == REQUEST and s.parent == -1}
    if not roots:
        return None
    spans = outermost(recs, names)
    if within_request:
        spans = [s for s in spans if s.root in roots]
    return sum(ms(s) for s in spans) / len(roots)


def per_batch_ms(names: Iterable[str]) -> Optional[float]:
    """Host ms per batch in the spans named, paired by their thread and
    ``seq`` attribute; only batches that have a record of every name."""
    recs = records()
    if recs is None:
        return None
    names = set(names)
    batches = defaultdict(dict)
    for s in recs:
        if s.name in names and s.attrs and "seq" in s.attrs:
            batches[(s.tid, s.attrs["seq"])][s.name] = ms(s)
    whole = [sum(b.values()) for b in batches.values() if set(b) == names]
    return sum(whole) / len(whole) if whole else None
