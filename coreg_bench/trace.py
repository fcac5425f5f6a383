"""Reduction of a ``torch.profiler`` trace of the window's traced stretch:
the device's busy time, the kernel table and the breakdown.

Device events are the profiler's CUDA-side events (kernels, copies, sets);
the device-side mirrors of host annotations (``record_function`` ranges,
which the profiler also draws on the card's timeline) are left out.  Busy
time is the union of their intervals inside the stretch, which runs
from the start of the first file span (``coreg_bench.file``) to the end of
the last.  An idle gap is named by what the host was doing at each of its
moments: each stretch of the gap between two host event boundaries goes
to the innermost host event that covers it, an operator of the program or
one of the benchmark's spans around the calls into it.
"""
from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

FILE_SPAN = "coreg_bench.file"
OUTSIDE = "host outside any traced event"


def _is_device(evt):
    kind = getattr(evt, "device_type", None)
    return kind is not None and getattr(kind, "name", str(kind)).upper() \
        .endswith("CUDA")


def split_events(events):
    """(host, device) lists of (start_us, end_us, name); a device event that
    is a user annotation, or bears a host event's name, is left out."""
    host, dev = [], []
    for e in events:
        tr = e.time_range
        (dev if _is_device(e) else host).append(
            (float(tr.start), float(tr.end), e.name,
             bool(getattr(e, "is_user_annotation", False))))
    names = {n for _, _, n, _ in host}
    return ([(s, e, n) for s, e, n, _ in host],
            [(s, e, n) for s, e, n, ann in dev if not ann and n not in names])


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(host, dev, top=10):
    """Everything the metrics and the result line need from the trace:
    ``window_s``, ``busy_s``, ``kernels`` ({name: {count, seconds}}) and
    ``breakdown`` ({device_ops, idle_gaps}, each at most ``top`` long).
    None when the trace holds no file span."""
    spans = [(s, e) for s, e, n in host if n == FILE_SPAN]
    if not spans:
        return None
    w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    kernels = defaultdict(lambda: {"count": 0, "seconds": 0.0})
    inside = []
    for s, e, n in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        kernels[n]["count"] += 1
        kernels[n]["seconds"] += (e - s) * 1e-6
    busy = merge(inside)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    cuts = sorted({t for s, e, _ in host for t in (s, e) if w0 < t < w1})
    pieces = []
    for s, e in gaps:
        lo, hi = bisect.bisect_right(cuts, s), bisect.bisect_left(cuts, e)
        edges = [s] + cuts[lo:hi] + [e]
        pieces.extend(zip(edges, edges[1:]))
    idle = _attribute(sorted(host), pieces)
    ops = sorted(((n, v["seconds"]) for n, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": dict(kernels),
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in gap_list]}}


def _attribute(host, pieces):
    """Seconds of each piece of idle time, ``pieces`` in time order, by the
    innermost host event covering it (the latest-started one still
    running), in one sweep over ``host`` sorted by start."""
    idle = defaultdict(float)
    active, k = [], 0
    for a, b in pieces:
        t = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= t:
            heapq.heappush(active, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        idle[active[0][2] if active else OUTSIDE] += (b - a) * 1e-6
    return idle
