"""Arithmetic from the window's records to metrics: rates over the whole
window, percentiles over every frame, the union of device intervals, the
idle gaps labelled by what the host was doing, the device time by name.

Times are int64 nanoseconds of the wall clock, which is also the clock of
the profiler's trace, shared by every process of a run.
"""

from __future__ import annotations

import numpy as np


def rate(n: int, window_s: float) -> float:
    """Work per second over the whole window."""
    return n / window_s


def percentile(values, q: float) -> float:
    """The q-th percentile (numpy's linear rule) over every value given."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union(starts: np.ndarray, ends: np.ndarray):
    """Disjoint blocks covering the union of [start, end) intervals:
    (block starts, block ends), in order."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def busy_ns(starts, ends, t0: int, t1: int) -> int:
    """Time in [t0, t1] in which at least one interval runs."""
    bs, be = union(np.clip(starts, t0, t1), np.clip(ends, t0, t1))
    return int(np.sum(be - bs))


def gaps(starts, ends, t0: int, t1: int):
    """The idle stretches of [t0, t1]: (gap starts, gap ends)."""
    bs, be = union(np.clip(starts, t0, t1), np.clip(ends, t0, t1))
    gs = np.concatenate([[t0], be])
    ge = np.concatenate([bs, [t1]])
    keep = ge > gs
    return gs[keep], ge[keep]


def open_span(spans, t: int):
    """The kind of the host span of one session open at time t, or None.
    spans: (starts, ends, kinds) with starts sorted."""
    s, e, kinds = spans
    j = int(np.searchsorted(s, t, side="right")) - 1
    return kinds[j] if j >= 0 and e[j] > t else None


def label_gaps(gs, ge, sessions_spans, top: int = 10):
    """The `top` longest gaps, each named by the host spans open at its
    middle across the sessions ("track_call+resolve", or "between_calls"
    where none is), as [name, seconds]."""
    order = np.argsort(-(ge - gs), kind="stable")[:top]
    out = []
    for j in order:
        mid = int((gs[j] + ge[j]) // 2)
        kinds = sorted({k for sp in sessions_spans if (k := open_span(sp, mid)) is not None})
        out.append(["+".join(kinds) if kinds else "between_calls", float(ge[j] - gs[j]) / 1e9])
    return out


def by_name(traces):
    """Device seconds and counts by operation name over the sessions'
    traces: {name: [seconds, count]}."""
    out = {}
    for tr in traces:
        dur = (tr["end"] - tr["start"]).astype(np.float64) / 1e9
        secs = np.bincount(tr["name"], weights=dur, minlength=len(tr["names"]))
        cnt = np.bincount(tr["name"], minlength=len(tr["names"]))
        for nm, s, c in zip(tr["names"], secs, cnt):
            acc = out.setdefault(nm, [0.0, 0])
            acc[0] += float(s)
            acc[1] += int(c)
    return out

