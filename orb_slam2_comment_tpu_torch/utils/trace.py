"""The port's one tracer: spans at the stage boundaries of the frame path,
and counters of kernel launches, transfer waits, loop decisions and the
path each frame took.

Spans are off unless `enable()` has been called (no environment variable
or config key turns them on). Off, `span()` returns one shared no-op
context: no allocation and no clock read. On, each span records its name,
its start and end (`time.time_ns()`, the wall clock that torch.profiler's
trace is aligned to), the span open around it on the same thread (its
parent), that thread, and the frame id whose work it does (given, or the
parent's). Spans are kept in memory up to `CAPACITY`; a span past it is
not kept and counts in `dropped`. `take()` returns what was recorded since
the tracer was switched on, as numpy arrays and the name table; nothing is
written out.

    from orb_slam2_comment_tpu_torch.utils import trace
    with trace.span("track", frame_id):
        ...

`enable()` and `disable()` nest: spans stay on until every `enable()` is
matched (sessions run as threads of one process share the tracer).

Counters are always on: `count(name, n)` adds to a plain dict and
`counters()` returns a copy. Launches count as `launch.K1` ... `launch.K4`
(`launch.K3b`: the batched pose solve), waits on a transfer that had not
landed as `transfer_wait.<site>`, the loop closer's decisions as
`loop.<reason>`, and frames by the path they took as `frames.<path>`.
"""

from __future__ import annotations

import array
import itertools
import threading
import time

import numpy as np

CAPACITY = 1 << 17   # spans kept between enable() and take()

dropped = 0          # spans past CAPACITY since the tracer was switched on

_lock = threading.Lock()
_on = 0              # enable() calls not yet matched by disable()
_gen = 0             # bumps at every switch-on: spans of an earlier recording are not kept
_cap = 0
_seq = itertools.count()
# one int64 array per field, indexed by span (plain arrays, not lists: the
# garbage collector does not walk them); a span is kept once its start is set
_start = _end = _name = _parent = _frame = _thread = array.array("q")
_name_ids: dict = {}
_names: list = []
_local = threading.local()
_counts: dict = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _stack() -> list:
    """This thread's open spans (their indices)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _name_id(name: str) -> int:
    with _lock:
        i = _name_ids.get(name)
        if i is None:
            i = _name_ids[name] = len(_names)
            _names.append(name)
        return i


class _Span:
    __slots__ = ("_name_s", "_frame_v", "_i", "_gen")

    def __init__(self, name: str, frame):
        self._name_s, self._frame_v = name, frame

    def __enter__(self):
        global dropped
        stack = _stack()
        parent = stack[-1] if stack else -1
        i = next(_seq)
        self._i, self._gen = i, _gen
        if i < _cap:
            frame = self._frame_v
            if frame is None:
                frame = _frame[parent] if parent >= 0 else -1
            nid = _name_ids.get(self._name_s)
            if nid is None:
                nid = _name_id(self._name_s)
            _name[i], _parent[i], _frame[i] = nid, parent, frame
            _thread[i] = threading.get_ident()
            _start[i] = time.time_ns()
        else:
            with _lock:
                dropped += 1
        stack.append(i)
        return self

    def __exit__(self, *exc):
        t = time.time_ns()
        _stack().pop()
        if self._i < _cap and self._gen == _gen:
            _end[self._i] = t
        return False


def span(name: str, frame=None):
    """A context that records one span while the tracer is on. `frame`:
    the id of the frame whose work it does (None: the parent span's, or
    -1 at the root)."""
    return _Span(name, frame) if _on else NO_SPAN


def enable():
    """Switch spans on. The first switch-on starts a new recording."""
    global _on, _gen, _cap, _seq, dropped
    global _start, _end, _name, _parent, _frame, _thread
    with _lock:
        if not _on:
            _gen += 1
            _cap = int(CAPACITY)
            _seq = itertools.count()
            zeros = bytes(8 * _cap)
            _start, _end, _name, _parent, _frame, _thread = (
                array.array("q", zeros) for _ in range(6))
            dropped = 0
        _on += 1


def disable():
    """Undo one enable(); spans stay on while any other is unmatched."""
    global _on
    with _lock:
        _on = max(_on - 1, 0)


def take() -> dict:
    """The spans recorded since the tracer was switched on, in the order
    they started: int64 `start`, `end` (0: still open), `frame`, `thread`;
    int32 `name` (into `names`) and `parent` (an index into these arrays,
    -1 at the root); and `dropped`."""
    with _lock:
        cols = [np.frombuffer(a, np.int64).copy() for a in (
            _start, _end, _name, _parent, _frame, _thread)]
        names, n_drop = list(_names), dropped
    start, end, name, parent, frame, thread = cols
    keep = np.nonzero(start > 0)[0]
    new = np.full(len(start) + 1, -1, np.int64)   # [-1] reads -1
    new[keep] = np.arange(len(keep))
    return dict(start=start[keep], end=end[keep], name=name[keep].astype(np.int32),
                parent=new[parent[keep]].astype(np.int32), frame=frame[keep],
                thread=thread[keep], names=names, dropped=n_drop)


def count(name: str, n: int = 1):
    """Add n to the counter `name` (always on)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)
