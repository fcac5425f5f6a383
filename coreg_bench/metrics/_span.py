"""Shared by the span and counter readers: what the program's
``collect_stages()`` scope keeps beside its ``{span name: host seconds}``
dict (``card``, the card extents of its card spans; ``spans``; and
``counters``), per traced file.  Each returns None where the run holds
nothing to read: a program whose scope keeps none of these, or a span or
counter that did not run."""
from coreg_bench import trace


def _per_file(rec, total, scale):
    if total is None or not rec["files"]:
        return None
    return scale * total / rec["files"]


def card_ms(rec, name):
    """The card extent of span ``name`` in ms, summed over its runs."""
    card = getattr(rec["stages"], "card", None) or {}
    return _per_file(rec, card.get(name), 1e3)


def counter_mb(rec, name):
    """The counter ``name`` (bytes) in MB."""
    counters = getattr(rec["stages"], "counters", None) or {}
    return _per_file(rec, counters.get(name), 1e-6)


def self_ms(rec, name):
    """The self time of span ``name`` in ms: each run's duration less the
    part of it that its child spans cover."""
    spans = getattr(rec["stages"], "spans", None) or []
    children = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    total, found = 0, False
    for i, s in enumerate(spans):
        if s.name != name or s.end_ns is None:
            continue
        found = True
        covered = sum(e - b for b, e in trace.merge(children.get(i, [])))
        total += s.end_ns - s.start_ns - covered
    return _per_file(rec, total if found else None, 1e-6)
