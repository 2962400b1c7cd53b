"""The port's tracer (`utils/trace.py`): off by default and then free of
records; spans nest per thread, carry their parent and frame, and past
the capacity are counted as dropped; counters hold under threads; each
transfer wait counts at its site. Then a tiny pipelined RGB-D run on the
CPU (320 x 240, 520 features, 4 levels, `pipeline_lag` 1, four frames
0.25 m apart, loop closing on): every child span lies inside its parent,
each fused frame has one `track` span carrying its id, each mapper pass
not cut short has a span per phase, and the run's trajectory and map are
bit-identical with the tracer on and off. The first frame (the host
path's initialization) runs traced once; the System is then copied, and
the three fused frames and the drain run traced in one copy and
untraced in the other. Port only: no JAX."""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from orb_slam2_comment_tpu_torch.utils import trace

torch.set_num_threads(2)

N_FRAMES = 4


def _spans(rec):
    """[(name, start, end, parent, frame, thread)] of take()'s arrays."""
    return [(rec["names"][n], s, e, p, f, t) for n, s, e, p, f, t in zip(
        rec["name"].tolist(), rec["start"].tolist(), rec["end"].tolist(),
        rec["parent"].tolist(), rec["frame"].tolist(), rec["thread"].tolist())]


def test_off_records_nothing():
    """Off, span() is the one shared no-op and nothing is recorded."""
    trace.enable()
    trace.disable()
    s = trace.span("call", 3)
    assert s is trace.NO_SPAN and trace.span("x") is s
    with s:
        with trace.span("track", 3):
            pass
    rec = trace.take()
    assert len(rec["start"]) == 0 and rec["dropped"] == 0


def test_nesting_threads_and_capacity(monkeypatch):
    """Parents and frames (given, or the parent's) per thread; a span past
    the capacity is not kept and counts in `dropped`."""
    seen = {}

    def worker():
        with trace.span("w.outer", 7):
            with trace.span("w.inner"):
                seen["thread"] = threading.get_ident()

    trace.enable()
    try:
        with trace.span("outer", 2):
            with trace.span("inner"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
            with trace.span("other", 5):
                pass
        rec = trace.take()
    finally:
        trace.disable()
    assert not th.is_alive()
    sp = {s[0]: s for s in _spans(rec)}
    names = [rec["names"][i] for i in rec["name"]]
    assert sorted(names) == ["inner", "other", "outer", "w.inner", "w.outer"]
    idx = {n: i for i, n in enumerate(names)}
    me = threading.get_ident()
    assert sp["outer"][3] == -1 and sp["outer"][4] == 2 and sp["outer"][5] == me
    assert sp["inner"][3] == idx["outer"] and sp["inner"][4] == 2
    assert sp["other"][3] == idx["outer"] and sp["other"][4] == 5
    # the worker's spans nest on its own stack, not under the open "inner"
    assert sp["w.outer"][3] == -1 and sp["w.outer"][5] == seen["thread"] != me
    assert sp["w.inner"][3] == idx["w.outer"] and sp["w.inner"][4] == 7
    for name, s, e, p, _, _ in sp.values():
        assert 0 < s <= e
        if p >= 0:
            assert rec["start"][p] <= s and e <= rec["end"][p], name

    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.enable()
    try:
        for _ in range(5):
            with trace.span("a"):
                pass
        rec = trace.take()
        assert len(rec["start"]) == 3 and rec["dropped"] == 2 == trace.dropped
    finally:
        trace.disable()
    trace.enable()   # a new recording starts from none dropped
    trace.disable()
    assert trace.dropped == 0


def test_counters_hold_under_threads():
    """Concurrent counts lose no update (more threads than cores, a short
    switch interval)."""
    name = "test.concurrent"
    base = trace.counters().get(name, 0)
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count(name) for _ in range(n_each)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert trace.counters()[name] - base == n_threads * n_each


def test_transfer_wait_sites_sum_to_the_total():
    """A wait on an event that had not landed counts at its site and in
    tracking.transfer_waits; a landed event counts nowhere."""
    from orb_slam2_comment_tpu_torch.models import tracking

    class Event:
        def __init__(self, landed):
            self.landed, self.waited = landed, False

        def query(self):
            return self.landed

        def synchronize(self):
            self.waited = True

    sites = ("stats", "side", "staging")
    c0, w0 = trace.counters(), tracking.transfer_waits
    events = []
    for i, site in enumerate(sites * 3):
        events.append(Event(landed=i % 3 == 2))
        tracking._wait(events[-1], site)
    c1 = trace.counters()
    by_site = {s: c1.get("transfer_wait." + s, 0) - c0.get("transfer_wait." + s, 0)
               for s in sites}
    assert by_site == {"stats": 3, "side": 3, "staging": 0}
    assert sum(by_site.values()) == tracking.transfer_waits - w0 == 6
    assert [e.waited for e in events] == [not e.landed for e in events]


def _cfg():
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    K = tuple(k * 0.5 for k in syn.DEFAULT_K)
    return SlamConfig(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                      bf=K[0] * syn.DEFAULT_BASELINE, n_features=520, n_levels=4,
                      width=320, height=240, max_keyframes=32, max_points=8192,
                      grow_capacity=False, match_th_scale=1.5, pipeline_lag=1), K


@pytest.fixture(scope="module")
def traced_run():
    """(cfg, spans of the traced copy, traced System, untraced System)."""
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    cfg, K = _cfg()
    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    frames = list(syn.render_sequence(
        scene, syn.make_trajectory("forward", n_frames=N_FRAMES, step=0.25), K=K,
        hw=(cfg.height, cfg.width), depth=True))
    on = System(cfg, device="cpu")
    trace.enable()
    try:
        f = frames[0]
        on.track_rgbd(f["image"], f["depth"], f["timestamp"])
        off = copy.deepcopy(on)
        for f in frames[1:]:
            on.track_rgbd(f["image"], f["depth"], f["timestamp"])
        on.shutdown()
        rec = trace.take()
    finally:
        trace.disable()
    for f in frames[1:]:
        off.track_rgbd(f["image"], f["depth"], f["timestamp"])
    off.shutdown()
    return cfg, rec, on, off


def test_children_lie_inside_their_parents(traced_run):
    _, rec, on, _ = traced_run
    sp = _spans(rec)
    names = {s[0] for s in sp}
    assert {"call", "upload", "extract", "frame_step", "track", "kf_create", "ship",
            "resolve", "kf_callbacks", "db.add", "flush", "host_path"} <= names
    assert any(n.startswith("mapper.") for n in names)
    assert rec["dropped"] == 0 and all(0 < s <= e for _, s, e, *_ in sp)
    for name, s, e, p, f, th in sp:
        if p >= 0:
            pn, ps, pe, *_ , pth = sp[p]
            assert ps <= s and e <= pe and th == pth, (name, pn)
    calls = sorted(f for n, *_, f, _ in sp if n == "call")
    assert calls == list(range(N_FRAMES))


def test_one_track_span_per_fused_frame(traced_run):
    """Frame 0 initializes on the host path; frames 1.. are fused, each
    tracked once, in a span that carries its own id (stage B of frame f
    runs in call f + 1, or in the drain)."""
    _, rec, on, _ = traced_run
    sp = _spans(rec)
    tracks = sorted(f for n, *_, f, _ in sp if n == "track")
    assert tracks == list(range(1, N_FRAMES))
    assert [f for n, *_, f, _ in sp if n == "host_path"] == [0]
    # the keyframe the run creates in a frame step, inside that frame's step
    kfc = [(f, sp[p][0], sp[p][4]) for n, _, _, p, f, _ in sp if n == "kf_create"]
    assert kfc and all(pn == "frame_step" and pf == f for f, pn, pf in kfc)
    assert on.tracker.n_kfs >= 2


def test_complete_mapper_passes_have_every_phase(traced_run):
    """The mapper spans, in order, split at each `mapper.start`: a pass
    cut short by a new keyframe has fewer; every other pass, the last one
    (drained at shutdown) and the initialization's among them, has one
    span per phase of the machine's table, in its order."""
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm

    cfg, rec, _, _ = traced_run
    table = ["mapper." + p[0] for p in lm._phase_list(cfg)]
    assert len(table) == lm.machine_phase_count(cfg)
    seq = [s[0] for s in _spans(rec) if s[0].startswith("mapper.")]
    passes, cur = [], None
    for name in seq:
        if name == "mapper.start":
            cur = []
            passes.append(cur)
        cur.append(name)
    assert len(passes) >= 2
    for i, p in enumerate(passes):
        assert p == table[:len(p)]
        assert len(p) == len(table) or i < len(passes) - 1


def test_outputs_identical_with_tracing_on_and_off(traced_run):
    from orb_slam2_comment_tpu_torch.models import map_state as ms

    _, _, on, off = traced_run
    a, b = on.trajectory, off.trajectory
    assert len(a) == len(b) == N_FRAMES
    for (ta, Ta, ra, sa), (tb, Tb, rb, sb) in zip(a, b):
        assert (ta, ra, sa) == (tb, rb, sb) and np.array_equal(Ta, Tb)
    for f in ms.MapState.field_names():
        assert torch.equal(getattr(on.tracker.map, f), getattr(off.tracker.map, f)), f
    assert on.tracker.n_kfs == off.tracker.n_kfs and on.tracker.n_pts == off.tracker.n_pts
