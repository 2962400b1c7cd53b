"""The port's asynchronous frame pipeline against the JAX package's on the
CPU: `track_rgbd` returns a lazy output, an RGB-D frame's extraction runs
`pipeline_lag` frames before its tracking, images are dispatched a call
late, per-frame results come back in batches and the host state (the
keyframe callbacks, loop harvests) moves when a batch resolves. Each test
drives both packages over the same seeded frames at the widths of
tests/test_torch_system.py, either resolving every frame `pipeline_lag`
frames late (`_flush_upto(i - lag)` after each call, as bench.py's warm-up
does) or reading nothing until `shutdown`. Also a leftover ported beside
it: `build_frame_mono(double_features=True)`. The loop closer's packs
over the loop orbit are checked on tests/test_torch_system.py's orbit
run."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_FORWARD = 22
N_DETERMINISM = 14


def _cfg_kw(**kw):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    K = syn.DEFAULT_K
    return dict(dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                     bf=K[0] * syn.DEFAULT_BASELINE, n_features=500, n_levels=4,
                     max_keyframes=32, max_points=8192, grow_capacity=False,
                     match_th_scale=1.5), **kw)


def _systems(**kw):
    """(JAX System, port System on the CPU) for _cfg_kw(**kw)."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    return JSystem(JConfig(**_cfg_kw(**kw))), TSystem(TConfig(**_cfg_kw(**kw)), device="cpu")


def _forward(n, step=0.03):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    return list(syn.render_sequence(scene, syn.make_trajectory("forward", n_frames=n, step=step),
                                    K=syn.DEFAULT_K, depth=True))


def _orbit(n):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=1800, seed=0, extent=(14.0, 8.0, 20.0))
    return list(syn.render_sequence(scene, syn.make_trajectory("orbit", n_frames=44)[:n],
                                    K=syn.DEFAULT_K, depth=True))


def _fields(out):
    return (out.state, out.created_kf, out.ref_kf, out.n_inliers,
            None if out.Tcw is None else np.asarray(out.Tcw, np.float64),
            None if out.relative_to_kf is None else np.asarray(out.relative_to_kf, np.float64))


def _lagged(system, frames, ts_shift=0.0, before=None):
    """System.track_rgbd over the frames, resolving each frame
    `pipeline_lag` calls after it arrives. Returns per-frame outputs'
    fields (read as soon as each frame resolves), the (call, keyframe)
    of every keyframe callback, n_kfs after each call, and the outputs."""
    fired, n_kfs, outs, fields = [], [], [], {}
    system.tracker.new_kf_callbacks.append(lambda k: fired.append((system.frame_id, k)))
    lag = system.cfg.pipeline_lag
    for i, f in enumerate(frames):
        if before is not None:
            before(i, system)
        outs.append(system.track_rgbd(f["image"], f["depth"], f["timestamp"] + ts_shift))
        system.tracker._flush_upto(i - lag)
        if i >= lag:
            fields[i - lag] = _fields(outs[i - lag])
        n_kfs.append(system.tracker.n_kfs)
    system.shutdown()
    for i in range(len(frames)):
        if i not in fields:
            fields[i] = _fields(outs[i])
    return [fields[i] for i in range(len(frames))], fired, n_kfs, outs


def _assert_like_jax(jrec, trec, tol=1e-3):
    """States, keyframe flags and reference keyframes equal; inliers
    within 5; Tcw and Tcr translations within tol."""
    assert [r[:3] for r in trec] == [r[:3] for r in jrec]
    assert max(abs(a[3] - b[3]) for a, b in zip(trec, jrec)) <= 5
    for a, b in zip(trec, jrec):
        for x, y in ((a[4], b[4]), (a[5], b[5])):
            assert (x is None) == (y is None)
            if x is not None:
                assert np.abs(x[:3, 3] - y[:3, 3]).max() <= tol


@pytest.fixture(scope="module")
def forward():
    """Both packages (loop closing on) over the forward sequence of
    tests/test_torch_system.py, each frame resolved pipeline_lag calls
    late."""
    frames = _forward(N_FORWARD)
    return frames, [(s, _lagged(s, frames)) for s in _systems()]


def test_lagged_resolution_like_jax(forward):
    """Every output field, the call at which each keyframe callback fires
    and n_kfs after each call equal JAX's (translations within 1 mm, the
    tolerance of test_slice_tracks_like_jax); the port's fused frames
    return lazy outputs, and its host state runs pipeline_lag frames
    behind the calls as JAX's does."""
    from orb_slam2_comment_tpu_torch.models.tracking import LazyTrackOutput

    frames, ((js, (jrec, jfired, jn, _)), (ts, (trec, tfired, tn, touts))) = forward
    _assert_like_jax(jrec, trec)
    assert all(r[0] == 1 for r in trec)
    assert tfired == jfired and len(tfired) >= 3
    # a keyframe's callback fires pipeline_lag calls after its frame
    lag = ts.cfg.pipeline_lag
    kf_frames = [i for i, r in enumerate(trec) if r[1]]
    assert [c for c, _ in tfired[1:]] == [min(i + lag + 1, len(frames)) for i in kf_frames[1:]]
    assert tn == jn
    assert not isinstance(touts[0], LazyTrackOutput)   # initialization: the host path
    assert all(isinstance(o, LazyTrackOutput) for o in touts[1:])
    assert ts.tracker.n_kfs == js.tracker.n_kfs and len(ts.trajectory) == len(frames)


def test_unread_run_like_jax_and_deterministic(monkeypatch):
    """tests/test_determinism.py's run (fewer frames, batches of 4 so that
    batches ship and resolve while frames arrive) with no output read until
    shutdown: the same keyframe count and live points as JAX, the
    trajectories within 1 mm, and two port runs bit-identical."""
    from orb_slam2_comment_tpu.models import tracking as jtr
    from orb_slam2_comment_tpu_torch.models import tracking as ttr

    monkeypatch.setattr(jtr.Tracker, "STATS_BATCH", 4)
    monkeypatch.setattr(ttr.Tracker, "STATS_BATCH", 4)
    frames = _forward(N_DETERMINISM)

    def run(system):
        for f in frames:
            system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        system.shutdown()
        t = system.tracker
        return dict(n_kfs=t.n_kfs, live=int(np.asarray(t.map.pt_valid).sum()),
                    kf_valid=np.asarray(t.map.kf_valid).copy(),
                    kf_pose=np.asarray(t.map.kf_pose).copy(),
                    traj=[(ts_, np.asarray(T), ref, st) for ts_, T, ref, st in t.trajectory],
                    poses=[np.asarray(T, np.float64) for _, T in system._frame_poses()])

    js, ts = _systems()
    j, a = run(js), run(ts)
    b = run(_systems()[1])
    assert a["n_kfs"] == j["n_kfs"] >= 2 and a["live"] == j["live"]
    assert len(a["poses"]) == len(j["poses"]) == len(frames)
    assert max(np.abs(x[:3, 3] - y[:3, 3]).max() for x, y in zip(a["poses"], j["poses"])) <= 1e-3
    assert (a["n_kfs"], a["live"]) == (b["n_kfs"], b["live"])
    np.testing.assert_array_equal(a["kf_valid"], b["kf_valid"])
    np.testing.assert_array_equal(a["kf_pose"], b["kf_pose"])
    assert len(a["traj"]) == len(b["traj"])
    for (ta, Ta, ra, sa), (tb, Tb, rb, sb) in zip(a["traj"], b["traj"]):
        assert (ta, ra, sa) == (tb, rb, sb)
        np.testing.assert_array_equal(Ta, Tb)


def test_fewer_frames_than_the_lag():
    """Three frames (the initializing one and two fused frames, both still
    queued: one upload, one in stage A) and shutdown: the same outputs,
    keyframes and trajectory as JAX."""
    frames = _forward(3)
    res = []
    for system in _systems():
        outs = [system.track_rgbd(f["image"], f["depth"], f["timestamp"]) for f in frames]
        t = system.tracker
        queued = (len(t._upQ), len(t._stageA), len(t._pending), t.n_kfs, len(t.trajectory))
        system.shutdown()
        res.append((queued, [_fields(o) for o in outs], t.n_kfs, len(t.trajectory)))
    (jq, jrec, jk, jn), (tq, trec, tk, tn) = res
    assert tq == jq == (1, 1, 0, 1, 1)
    _assert_like_jax(jrec, trec)
    assert all(r[0] == 1 for r in trec) and (tk, tn) == (jk, jn) == (1, 3)


def test_lost_frame_inside_the_queue_like_jax():
    """Twelve orbit frames (8 keyframes), two textureless frames, then
    frames 8-11 again, each frame resolved pipeline_lag calls late: the
    textureless frames are LOST while later frames are already in the
    stage-A queue, those go on through the device step, and the per-frame
    states, the frame that relocalizes and its pose equal JAX's."""
    base = _orbit(12)
    blank = dict(image=np.full_like(base[0]["image"], 128), depth=np.zeros_like(base[0]["depth"]))
    frames = base + [dict(blank, timestamp=base[-1]["timestamp"] + (k + 1) / 30)
                     for k in range(2)]
    frames += [dict(f, timestamp=base[-1]["timestamp"] + (k + 3) / 30)
               for k, f in enumerate(base[8:])]
    queued_at_loss = []

    def watch(i, system):
        t = system.tracker
        if t.state == 2 and not queued_at_loss:
            queued_at_loss.append(len(t._upQ) + len(t._stageA))

    recs = []
    for system in _systems():
        queued_at_loss.clear()
        rec, _, _, _ = _lagged(system, frames, before=watch)
        recs.append((rec, list(queued_at_loss), system.n_resets))
    (jrec, jq, jr), (trec, tq, tr) = recs
    states = [r[0] for r in trec]
    assert states == [r[0] for r in jrec] and (tq, tr) == (jq, jr) == ([4], 0)
    assert states[12:14] == [2, 2]
    back = states.index(1, 12)
    assert back >= 14 and all(s == 1 for s in states[back:])
    _assert_like_jax(jrec, trec)


@pytest.mark.parametrize("event", ["grow", "compact"])
def test_capacity_event_with_frames_queued_like_jax(event):
    """A capacity event with frames 4-7 still queued after call 7, in both
    packages. grow (growth on, default caps): the point-cursor mirror is
    set past 85% of the arena, so the next call drains the pipeline and
    grows the point tier. compact: the device cursor is set there instead,
    so the next stage B with the mapper idle compacts the arena on the
    device while later frames' extraction waits in the queue, and the
    compaction resolves (epoch, compact callbacks) when its batch does.
    The tier, epoch, cursor and mirror, the keyframe callbacks and the
    frames before and after equal JAX's."""
    kw = dict(grow_capacity=True) if event == "grow" else {}
    frames = _forward(12, step=0.04)
    events = []

    def before(i, system):
        t = system.tracker
        if i != 8:
            return
        events.append((len(t._upQ) + len(t._stageA), t.compaction_epoch))
        full = int(0.85 * t.cfg.max_points) + 1
        if event == "grow":
            t.n_pts_host = full
        elif isinstance(t.ds.n_pts, torch.Tensor):
            t.ds = t.ds.replace(n_pts=torch.tensor(full, dtype=torch.int32))
            t.n_pts_dev = t.ds.n_pts
        else:
            import jax.numpy as jnp

            t.ds = t.ds._replace(n_pts=jnp.asarray(full, jnp.int32))
            t.n_pts_dev = t.ds.n_pts

    res = []
    for system in _systems(**kw):
        events.clear()
        compactions = []
        system.tracker.compact_callbacks.append(lambda: compactions.append(system.frame_id))
        rec, fired, _, _ = _lagged(system, frames, before=before)
        t = system.tracker
        res.append((rec, fired, list(events), compactions, t.cfg.max_points,
                    t.compaction_epoch, t.n_pts_host, int(t.n_pts)))
    (jrec, jf, je, jc, jp, jep, jh, jn), (trec, tf, te, tc, tp, tep, th, tn) = res
    assert te == je == [(4, 0)]
    assert (tp, tep) == (jp, jep) == ((32768, 0) if event == "grow" else (8192, 1))
    assert tc == jc and len(tc) == tep
    assert (th, tn) == (jh, jn) and tf == jf
    assert all(r[0] == 1 for r in trec)
    _assert_like_jax(jrec, trec)


def test_reset_with_batches_in_flight_like_jax(monkeypatch):
    """Batches of 4: after 10 calls one batch is in flight, one pending and
    four frames queued when reset() is called; reset resolves them into the
    old tracker (their keyframe callbacks fire) before the new map starts,
    and the next frames re-initialize and track as in JAX."""
    from orb_slam2_comment_tpu.models import tracking as jtr
    from orb_slam2_comment_tpu_torch.models import tracking as ttr

    monkeypatch.setattr(jtr.Tracker, "STATS_BATCH", 4)
    monkeypatch.setattr(ttr.Tracker, "STATS_BATCH", 4)
    frames = _forward(14, step=0.06)
    res = []
    for system in _systems():
        fired = []
        system.tracker.new_kf_callbacks.append(lambda k: fired.append((system.frame_id, k)))
        for f in frames[:10]:
            system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        t = system.tracker
        in_flight = (len(t._batchQ), len(t._pending), len(t._upQ) + len(t._stageA))
        n0 = len(t.trajectory)
        system.reset()
        old = (len(t.trajectory), t.n_kfs, list(fired))
        outs = [system.track_rgbd(f["image"], f["depth"], f["timestamp"] + 5.0)
                for f in frames[10:]]
        recs = [_fields(o) for o in outs]
        system.shutdown()
        res.append((in_flight, n0, old, recs, system.n_resets, system.tracker.n_kfs))
    (ji, jn0, jold, jrec, jr, jk), (ti, tn0, told, trec, tr, tk) = res
    assert ti == ji and ti[0] >= 1 and ti[2] == 5
    assert (tn0, told, tr, tk) == (jn0, jold, jr, jk)
    assert told[0] == 10 > tn0 and tr == 1
    _assert_like_jax(jrec, trec)
    assert all(r[0] == 1 for r in trec)


def test_device_step_does_not_pull_per_frame(monkeypatch):
    """Ten unread calls: the fused frames' device steps ran, but no frame
    was resolved (no batch shipped: no pull); shutdown resolves every
    fused frame once, from one batch, and ships no out vector twice."""
    from orb_slam2_comment_tpu_torch.models import tracking as ttr

    _, system = _systems()
    t = system.tracker
    counts = dict(resolve=0, ship=0, step=0)
    for name, fn in (("resolve", "_resolve_entry"), ("ship", "_ship_batch"),
                     ("step", "_finish_stageA_front")):
        orig = getattr(t, fn)

        def counted(*a, orig=orig, name=name):
            counts[name] += 1
            return orig(*a)

        monkeypatch.setattr(t, fn, counted)
    frames = _forward(10)
    for f in frames:
        system.track_rgbd(f["image"], f["depth"], f["timestamp"])
    assert counts == dict(resolve=0, ship=0, step=4) and len(t._pending) == 4
    assert t.n_kfs == 1 and len(t.trajectory) == 1 and t.STATS_BATCH == 16
    system.shutdown()
    assert counts == dict(resolve=9, ship=1, step=9)
    assert len(t.trajectory) == 10 and ttr.Tracker.MAX_BATCHES == 6


def test_mono_frame_with_double_features_like_jax():
    """build_frame_mono(double_features=True): twice the keypoint budget
    (the reference's initializer extractor), the same keypoints and
    descriptors as JAX's."""
    import jax.numpy as jnp
    from orb_slam2_comment_tpu.models import frame as jfr
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models import frame as tfr
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    kw = _cfg_kw(sensor="monocular")
    image = np.clip(_forward(1)[0]["image"], 0, 255).astype(np.uint8)
    single = tfr.build_frame_mono(0, 0.0, image, TConfig(**kw))
    t = tfr.build_frame_mono(0, 0.0, image, TConfig(**kw), double_features=True)
    j = jfr.build_frame_mono(0, 0.0, jnp.asarray(image), JConfig(**kw), double_features=True)
    assert t.n_feat == j.feats.xy.shape[0] > single.n_feat
    assert int(t.feats.valid.sum()) > int(single.feats.valid.sum())
    np.testing.assert_array_equal(t.feats.valid.numpy(), np.asarray(j.feats.valid))
    v = t.feats.valid.numpy()
    np.testing.assert_allclose(t.feats.xy.numpy()[v], np.asarray(j.feats.xy)[v], atol=1e-3)
    same = (t.feats.desc.numpy()[v] == np.asarray(j.feats.desc).view(np.int32)[v]).all(1)
    assert same.mean() > 0.99
    assert (t.uright.numpy() == -1).all() and (t.depth.numpy() == -1).all()


def test_pipeline_lag_below_one_refused_where_jax_fails():
    """pipeline_lag=0: JAX pops its empty stage-A queue on the first fused
    RGB-D frame (IndexError); the port refuses the configuration up front
    with a ValueError naming pipeline_lag. Where JAX runs without stage A
    (a stereo or staged RGB-D System) the port builds and tracks."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.models.tracking import Tracker
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    frames = _forward(3)
    js = JSystem(JConfig(**_cfg_kw(pipeline_lag=0)))
    with pytest.raises(IndexError):
        for f in frames:
            js.track_rgbd(f["image"], f["depth"], f["timestamp"])
        js.shutdown()
    for build in (lambda c: TSystem(c, device="cpu"), lambda c: Tracker(c, device="cpu")):
        for lag in (0, -1):
            with pytest.raises(ValueError, match="pipeline_lag"):
                build(TConfig(**_cfg_kw(pipeline_lag=lag)))
    for kw in (dict(sensor="stereo"), dict(fused_tracking=False)):
        TSystem(TConfig(**_cfg_kw(pipeline_lag=0, **kw)), device="cpu").shutdown()
    staged = TSystem(TConfig(**_cfg_kw(pipeline_lag=0, fused_tracking=False)), device="cpu")
    outs = [staged.track_rgbd(f["image"], f["depth"], f["timestamp"]) for f in frames]
    assert [o.state for o in outs] == [1, 1, 1]
    staged.shutdown()
