#!/usr/bin/env python3
"""Run one cell as `run.py --trace 1` does, with the port's own tracer
(`orb_slam2_comment_tpu_torch/utils/trace.py`) on in every session, and
print a `# stages {...}` line before run.py's result line:

    python3 slam_bench/stage_trace.py --workload <name> --seed <n> --seconds <s>

The line holds what `spans.stages` reads from the port's spans: the
per-stage figures (`extract.host_ms`, `track.host_ms`, `mapper.host_ms`,
`detect.host_ms_per_kf`, `pipeline.transfer_wait_ms`, and with a device
trace `extract.device_ms`, `stereo.match_device_ms`, `track.device_ms`,
`mapper.device_ms`), host self time and device time by span, counters per
frame, the clock check, syncs by site and by span, garbage-collection time
by generation, and the idle gaps named `<benchmark kind>/<port span>`.

run.py, session.py and their metrics run unchanged; each session process
runs `session.main` with four additions. Its pipe switches the tracer
on when the session reports ready and, when the session reports its
window, adds the session thread's spans, the counters' deltas, the
runtime calls that launched the device's operations, the sync-debug
warnings' sites and the process's garbage collections (`stages`). The profiler's device events keep their
correlation ids (`corr`); their other fields are as run.py reads them.
The sync-debug warnings keep their time and `file:line`; their count is
run.py's. A program without the tracer gives no `stages` and no line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from slam_bench import session  # noqa: E402

_session_main = session.main
_device_events = session._device_events
SYNC = "called a synchronizing CUDA operation"


class _Stash:
    """What the patched pieces of one session hand to its pipe."""

    def __init__(self):
        self.sync_log = None
        self.launch_corr, self.launch_t = [], []
        self.gc, self.gc_t0 = [], 0   # (start, end, generation) of each collection

    def on_gc(self, phase, info):
        """gc.callbacks: when each of the process's collections ran."""
        if phase == "start":
            self.gc_t0 = time.time_ns()
        else:
            self.gc.append((self.gc_t0, time.time_ns(), info["generation"]))


def _device_events_with_corr(stash):
    def device_events(prof, t0_ns: int, t1_ns: int):
        """run.py's device events, and their correlation ids; the runtime
        calls with a correlation id go to the stash."""
        from torch.autograd import DeviceType

        out = _device_events(prof, t0_ns, t1_ns)
        corr = []
        for e in prof.profiler.kineto_results.events():
            c = e.correlation_id()
            if e.device_type() != DeviceType.CUDA:
                if c:
                    stash.launch_corr.append(c)
                    stash.launch_t.append(e.start_ns())
                continue
            s, d = e.start_ns(), e.duration_ns()
            if s + d < t0_ns or s > t1_ns:
                continue
            corr.append(c)
        out["corr"] = np.asarray(corr, np.int64)
        if len(out["corr"]) != len(out["start"]):
            raise RuntimeError("device events and their correlation ids differ in number")
        return out
    return device_events


class _TimedLog(list):
    """warnings' record list; each warning also keeps when it came."""

    def append(self, w):
        w.t_ns = time.time_ns()
        super().append(w)


def _catch_warnings(stash):
    class catch_warnings(warnings.catch_warnings):
        def __enter__(self):
            log = super().__enter__()
            if log is None or sys._getframe(1).f_globals.get("__name__") != session.__name__:
                return log
            log = stash.sync_log = _TimedLog()
            self._module._showwarnmsg_impl = log.append
            return log
    return catch_warnings


class _Pipe:
    """The session's pipe: the tracer goes on at `ready`; `window` gets
    the session's `stages`."""

    def __init__(self, conn, stash, root: str):
        self._conn, self._stash, self._root = conn, stash, root
        self._trace, self._c0 = None, None

    def recv(self):
        return self._conn.recv()

    def close(self):
        self._conn.close()

    def send(self, msg):
        kind, body = msg
        if kind == "ready":
            try:
                from orb_slam2_comment_tpu_torch.utils import trace
            except ImportError:   # a program without the tracer
                trace = None
            if trace is not None:
                trace.enable()
                self._trace, self._c0 = trace, trace.counters()
        elif kind == "window" and self._trace is not None:
            body = dict(body, stages=self._take())
            self._trace.disable()
        self._conn.send((kind, body))

    def _take(self):
        from slam_bench import spans

        tr, st = self._trace, self._stash
        rec = tr.take()
        c1 = tr.counters()
        sync_t, sync_site = [], []
        for w in st.sync_log or []:
            if SYNC in str(w.message):
                f = os.path.abspath(w.filename)
                if f.startswith(self._root + os.sep):
                    f = os.path.relpath(f, self._root)
                sync_t.append(getattr(w, "t_ns", 0))
                sync_site.append(f"{f}:{w.lineno}")
        return dict(spans=spans.thread_spans(rec, threading.get_ident()),
                    dropped=int(rec["dropped"]),
                    counters={k: v - self._c0.get(k, 0) for k, v in c1.items()
                              if v != self._c0.get(k, 0)},
                    launch_corr=np.asarray(st.launch_corr, np.int64),
                    launch_t=np.asarray(st.launch_t, np.int64),
                    sync_t=np.asarray(sync_t, np.int64), sync_site=sync_site,
                    gc=np.asarray(st.gc, np.int64).reshape(-1, 3))


def session_main(conn, spec):
    """session.main with the additions above (a process's entry, or a
    thread's with run_cell's `inprocess`)."""
    if spec["root"] not in sys.path:
        sys.path.insert(0, spec["root"])
    stash = _Stash()
    old = session._device_events, warnings.catch_warnings
    session._device_events = _device_events_with_corr(stash)
    warnings.catch_warnings = _catch_warnings(stash)
    gc.callbacks.append(stash.on_gc)
    try:
        _session_main(_Pipe(conn, stash, os.path.abspath(spec["root"])), spec)
    finally:
        session._device_events, warnings.catch_warnings = old
        gc.callbacks.remove(stash.on_gc)


def run_cell(args, root: Path, device: str = "cuda", inprocess: bool = False):
    """run.run_cell with traced sessions: (result, extra, stages)."""
    from slam_bench import run, spans

    seen = {}

    class Bench(run.Bench):
        def metrics(self, workload, kind):
            out = super().metrics(workload, kind)
            if kind == "per_layer":
                out.append(("(stages)", "", lambda r: seen.setdefault("run", r) and None))
            return out

    old = run.Bench, session.main
    run.Bench, session.main = Bench, session_main
    try:
        result, extra = run.run_cell(args, Path(root), device, inprocess)
    finally:
        run.Bench, session.main = old
    return result, extra, spans.stages(seen["run"])


def main(argv=None, device: str = "cuda", root: Path = HERE.parent, inprocess: bool = False):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    args.trace, args.control = 1, 0
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("stage_trace: needs a CUDA device", file=sys.stderr)
            return 2
    result, extra, stages = run_cell(args, Path(root), device, inprocess)
    extra.pop("modules", None)
    print("# " + json.dumps(extra, default=lambda o: o.tolist() if hasattr(o, "tolist")
                            else str(o)), flush=True)
    if stages is not None:
        print("# stages " + json.dumps(stages), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
