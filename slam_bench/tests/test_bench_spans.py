"""The arithmetic on the port's own spans (`slam_bench/spans.py`) on
synthetic arrays, and a tiny traced CPU run through `stage_trace.py`."""

import contextlib
import io
import json
import threading

import numpy as np
import pytest

from slam_bench import spans
from slam_bench.tests import tiny

NAMES = ["call", "extract", "track", "mapper.ba1", "kf_callbacks", "detect.harvest",
         "transfer_wait.stats", "kf_create"]


def sp(rows):
    """Spans from (name, start, end, parent) rows in start order."""
    return dict(start=np.array([r[1] for r in rows], np.int64),
                end=np.array([r[2] for r in rows], np.int64),
                name=np.array([NAMES.index(r[0]) for r in rows], np.int32),
                parent=np.array([r[3] for r in rows], np.int32),
                frame=np.zeros(len(rows), np.int64), names=list(NAMES))


# call [0, 100] > extract [10, 40], track [50, 70] > transfer_wait [55, 60];
# call [200, 300] > kf_callbacks [210, 260] > detect.harvest [220, 240];
# detect.harvest [270, 290] on its own under the call
TREE = sp([("call", 0, 100, -1), ("extract", 10, 40, 0), ("track", 50, 70, 0),
           ("transfer_wait.stats", 55, 60, 2), ("call", 200, 300, -1),
           ("kf_callbacks", 210, 260, 4), ("detect.harvest", 220, 240, 5),
           ("detect.harvest", 270, 290, 4)])


def test_self_time():
    assert spans.self_ns(TREE).tolist() == [50, 30, 15, 5, 30, 30, 20, 20]
    assert spans.sums_by_name(TREE, spans.self_ns(TREE)) == {
        "call": 80.0, "extract": 30.0, "track": 15.0, "transfer_wait.stats": 5.0,
        "kf_callbacks": 30.0, "detect.harvest": 40.0}
    # nested detection spans count once
    assert spans.outermost_of(TREE, spans.DETECT).tolist() == [
        False, False, False, False, False, True, False, True]


def test_thread_spans_from_the_tracer():
    """The tracer's records of one thread, re-indexed, give the same self
    times as their own nesting."""
    from orb_slam2_comment_tpu_torch.utils import trace

    def other():
        with trace.span("extract"):
            pass

    trace.enable()
    try:
        with trace.span("call", 1):
            with trace.span("extract"):
                th = threading.Thread(target=other)
                th.start()
                th.join(timeout=30)
            with trace.span("track"):
                pass
        rec = trace.take()
    finally:
        trace.disable()
    mine = spans.thread_spans(rec, threading.get_ident())
    names = [mine["names"][i] for i in mine["name"]]
    assert names == ["call", "extract", "track"] and mine["parent"].tolist() == [-1, 0, 0]
    s = spans.self_ns(mine)
    dur = mine["end"] - mine["start"]
    assert s[0] == dur[0] - dur[1] - dur[2] and (s >= 0).all()
    assert mine["frame"].tolist() == [1, 1, 1]


def test_attribution_by_correlation():
    """Each operation goes to the innermost span open when the runtime
    call with its correlation id was made; none open: -1; no record: -2."""
    t = spans.launch_times([7, 3, 9, 4, 5, 11], [3, 4, 5, 7, 9], [20, 57, 150, 5, 45])
    assert t.tolist() == [5, 20, 45, 57, 150, -1]
    who = spans.attribute(TREE, t)
    assert who.tolist() == [0, 1, 0, 3, -1, -2]
    assert spans.innermost(TREE, [230, 265, 280, 300, 1000]).tolist() == [6, 4, 7, -1, -1]


def test_gap_labels_name_the_port_span():
    """The benchmark's kind stays first; the innermost port span open at
    the gap's middle follows it; a session with no spans keeps the kind."""
    bench_a = (np.array([0, 200]), np.array([100, 300]), ["track_call", "track_call"])
    bench_b = (np.array([50]), np.array([260]), ["resolve_wait"])
    gs, ge = np.array([54, 212, 500]), np.array([60, 216, 510])
    got = spans.gap_labels(gs, ge, [(bench_a, TREE), (bench_b, None)])
    assert got == [["between_calls", 10e-9],
                   ["resolve_wait+track_call/transfer_wait.stats", 6e-9],
                   ["resolve_wait+track_call/kf_callbacks", 4e-9]]


def _run(with_stages=True):
    corr = np.array([1, 2, 3, 4], np.int64)
    trace = dict(start=np.array([12, 56, 60, 230], np.int64),
                 end=np.array([22, 58, 70, 250], np.int64), name=np.array([0, 1, 1, 2], np.int32),
                 names=["fast_nms_levels_kernel(Levels)", "pose_lm_kernel(float const*)",
                        "sgemm"], corr=corr)
    stages = dict(spans=TREE, dropped=0, counters={"launch.K1": 1, "launch.K3": 2},
                  launch_corr=np.array([1, 2, 3, 4]), launch_t=np.array([11, 56, 65, 221]),
                  sync_t=np.array([56, 225]), sync_site=["tracking.py:10", "system.py:5"],
                  gc=np.array([[30, 34, 0], [250, 290, 2], [400, 500, 2]]))
    win = dict(t0=np.array([0, 200], np.int64), t1=np.array([100, 300], np.int64), t2=None,
               drain=(300, 310), kf_created=2, trace=trace)
    if with_stages:
        win["stages"] = stages
    return dict(sessions=[win], frames=2, t_go=0, t_end=310, device=None)


def test_stages_on_a_synthetic_run():
    out = spans.stages(_run())
    m = out["metrics"]
    assert m["extract.host_ms"] == pytest.approx(30e-6 / 2)
    assert m["track.host_ms"] == pytest.approx(15e-6 / 2)
    assert m["mapper.host_ms"] == 0.0
    assert m["detect.host_ms_per_kf"] == pytest.approx(70e-6 / 2)
    assert m["pipeline.transfer_wait_ms"] == pytest.approx(5e-6 / 2)
    # device: K1 (10 ns) under extract, K3 (2 + 10 ns) under track and its
    # transfer wait, the GEMM (20 ns) under the harvest
    assert m["extract.device_ms"] == pytest.approx(10e-6 / 2)
    assert m["track.device_ms"] == pytest.approx(10e-6 / 2)
    assert "stereo.match_device_ms" not in m and "mapper.device_ms" not in m
    assert out["device_ms_per_frame"]["transfer_wait.stats"] == pytest.approx(2e-6 / 2)
    assert out["top_ops_by_span"]["pose_lm_kernel(float const*)"] == {
        "track": pytest.approx(10e-6 / 2), "transfer_wait.stats": pytest.approx(2e-6 / 2)}
    assert out["host_total_ms_per_frame"]["call"] == pytest.approx(200e-6 / 2)
    assert out["clock_check"] == {"K1": 1.0, "K3": 0.5, "K4": None}
    assert out["counters_per_frame"] == {"launch.K1": 0.5, "launch.K3": 1.0}
    assert out["syncs_by_site"] == {"tracking.py:10": 1, "system.py:5": 1}
    assert out["syncs_by_span"] == {"transfer_wait.stats": 1, "detect.harvest": 1}
    assert out["call_self_pct"] == pytest.approx(100.0 * 80 / 200)
    # collections that start in the window, by generation
    assert out["gc_collections"] == {"gen0": 1, "gen2": 1}
    assert out["gc_ms_per_frame"] == {"gen0": pytest.approx(4e-6 / 2),
                                      "gen2": pytest.approx(40e-6 / 2)}
    assert spans.stages(_run(with_stages=False)) is None


def test_traced_tiny_run():
    """The tiny cell through stage_trace.py on the CPU: run.py's result
    line as before, and a stages line with the host figures."""
    from pathlib import Path
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tmp = tiny.make_checkout(Path(d))
        from slam_bench import stage_trace

        argv = ["--workload", tiny.CELL, "--seed", str(2 ** 31 + 13), "--seconds", "2"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = stage_trace.main(argv, device="cpu", root=tmp, inprocess=True)
    lines = out.getvalue().splitlines()
    assert rc == 0
    r = json.loads(lines[-1])
    assert r["correct"] is True and "host.call_ms" in r["metrics"]
    st = json.loads(lines[-2][len("# stages "):])
    assert {"extract.host_ms", "track.host_ms", "mapper.host_ms",
            "pipeline.transfer_wait_ms"} <= set(st["metrics"])
    assert st["metrics"]["extract.host_ms"] > 0 and st["dropped"] == 0
    assert st["counters_per_frame"]["frames.fused"] > 0
    assert 0 <= st["call_self_pct"] < 5
