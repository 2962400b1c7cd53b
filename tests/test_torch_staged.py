"""The port's staged tracking ladder (`fused_tracking=False`) and its
monolithic local mapper (`chunked_mapper=False`) against the JAX package
on the CPU: System.track_rgbd over the forward sequence of
tests/test_torch_system.py in each mode, one `_mapper_kernel` pass from
the same map, the whole-map descriptor refresh, a staged monocular and a
monolithic stereo run and the host compaction branch of `_maybe_grow`."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_FRAMES = 22
# the SlamConfig flag each mode sets to False
MODES = ["fused_tracking", "chunked_mapper"]


def _rgbd_kw(**kw):
    from orb_slam2_comment_tpu.utils import synthetic as syn

    K = syn.DEFAULT_K
    return dict(dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                     bf=K[0] * syn.DEFAULT_BASELINE, n_features=500, n_levels=4,
                     max_keyframes=32, max_points=8192, grow_capacity=False,
                     match_th_scale=1.5), **kw)


def _np(tree) -> dict:
    return {k: np.array(v) for k, v in tree._asdict().items()}


def _jmap(arrays):
    import jax.numpy as jnp
    from orb_slam2_comment_tpu.models import map_state as jms

    return jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _records(track, frames):
    """track(frame) per frame, each output read before the next frame: that
    resolves the JAX package's lagged output at once, so its pipeline runs
    frames in the port's synchronous order."""
    recs = []
    for f in frames:
        o = track(f)
        recs.append((o.state, o.n_inliers, o.created_kf,
                     None if o.Tcw is None else np.asarray(o.Tcw, np.float64)))
    return recs


@pytest.fixture(scope="module", params=MODES)
def rgbd_runs(request):
    """Both packages over the forward sequence with request.param False,
    loop closing off; JAX's monolithic mapper passes are recorded (map,
    keyframe, cursor) as they start."""
    from orb_slam2_comment_tpu.models import local_mapping as jlm
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    kw = _rgbd_kw(**{request.param: False})
    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=N_FRAMES, step=0.03)
    frames = list(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, depth=True))
    passes = []
    kernel = jlm._mapper_kernel

    def recording(m, kf_id, pt_base, cfg):
        passes.append((_np(m), int(kf_id), int(pt_base)))
        return kernel(m, kf_id, pt_base, cfg)

    jlm._mapper_kernel = recording
    try:
        js = JSystem(JConfig(**kw), enable_loop_closing=False)
        jrec = _records(lambda f: js.track_rgbd(f["image"], f["depth"], f["timestamp"]), frames)
        js.shutdown()
    finally:
        jlm._mapper_kernel = kernel
    ts = TSystem(TConfig(**kw), enable_loop_closing=False, device="cpu")
    trec = _records(lambda f: ts.track_rgbd(f["image"], f["depth"], f["timestamp"]), frames)
    ts.shutdown()
    return request.param, kw, frames, (js, jrec), (ts, trec), passes


def test_system_tracks_like_jax(rgbd_runs):
    """Every frame tracked in both, keyframes on the same frames, per-frame
    translations within 1 mm, inliers within 5 and ATE within 0.5 mm of
    JAX's (test_slice_tracks_like_jax's bar). Observed: equal inlier
    counts, translations within 3e-5 m."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    _, _, frames, (js, jrec), (ts, trec), _ = rgbd_runs
    assert all(r[0] == 1 for r in jrec) and all(r[0] == 1 for r in trec)
    assert [r[2] for r in trec] == [r[2] for r in jrec]
    assert ts.tracker.n_kfs == js.tracker.n_kfs >= 3
    dt = max(np.abs(a[3][:3, 3] - b[3][:3, 3]).max() for a, b in zip(trec, jrec))
    assert dt <= 1e-3, dt
    assert max(abs(a[1] - b[1]) for a, b in zip(trec, jrec)) <= 5
    gt = [f["Tcw_gt"] for f in frames]
    ate_t, ate_j = ate_rmse([r[3] for r in trec], gt), ate_rmse([r[3] for r in jrec], gt)
    assert ate_t <= ate_j + 5e-4 and ate_t < 0.02, (ate_t, ate_j)


def test_point_cursor_like_jax(rgbd_runs):
    """The same point-slot cursor, cursor mirror and live points after
    shutdown, and the monolithic mapper ran once per keyframe in both
    packages: the staged mode keeps no device state (and its mirror stays
    0); the fused step with the monolithic mapper keeps the cursor in its
    device state too."""
    mode, _, _, (js, _), (ts, _), passes = rgbd_runs
    assert len(passes) == js.tracker.n_kfs == ts.tracker.n_kfs
    # later passes start from a cursor their predecessors advanced
    assert passes[-1][2] > passes[1][2]
    assert ts.tracker.n_pts == int(js.tracker.n_pts) > 0
    assert ts.tracker.n_pts_host == js.tracker.n_pts_host
    assert (int(ts.tracker.map.pt_valid.sum())
            == int(np.asarray(js.tracker.map.pt_valid).sum()) > 0)
    if mode == "fused_tracking":
        assert ts.tracker.ds is None and js.tracker.ds is None
        assert ts.tracker.n_pts_host == 0
    else:
        assert int(ts.tracker.ds.n_pts) == ts.tracker.n_pts
        assert ts.tracker.ds.mp.phase == 0


_INT_FIELDS = ("kf_obs", "kf_valid", "kf_parent", "pt_valid", "pt_desc", "pt_ref_kf",
               "pt_first_kf", "pt_visible", "pt_found")


def test_mapper_kernel_like_jax(rgbd_runs):
    """One `_mapper_kernel` pass from the same map (JAX's last recorded
    pass of the run): the integer tables and the cursor equal, keyframe
    poses and point positions within 1e-3 (the local BA's bar: LAPACK and
    XLA round the f32 Cholesky of the reduced camera system apart)."""
    from orb_slam2_comment_tpu.models import local_mapping as jlm
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models import local_mapping as tlm
    from orb_slam2_comment_tpu_torch.models import map_state as tms
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    import jax.numpy as jnp

    _, kw, _, _, _, passes = rgbd_runs
    arrays, kf_id, base = passes[-1]
    assert kf_id >= 2
    jm, jbase = jlm._mapper_kernel(_jmap(arrays), jnp.asarray(kf_id, jnp.int32),
                                   jnp.asarray(base, jnp.int32), JConfig(**kw))
    tm, tbase = tlm._mapper_kernel(tms.from_numpy(arrays), kf_id,
                                   torch.tensor(base, dtype=torch.int32), TConfig(**kw))
    jm, tm = _np(jm), tms.to_numpy(tm)
    assert int(tbase) == int(jbase) >= base
    for f in _INT_FIELDS:
        np.testing.assert_array_equal(tm[f], jm[f], err_msg=f)
    np.testing.assert_allclose(tm["kf_pose"], jm["kf_pose"], atol=1e-3)
    live = jm["pt_valid"]
    np.testing.assert_allclose(tm["pt_pos"][live], jm["pt_pos"][live], atol=1e-3)
    # the pass changed the map: culling, new points and the BA all acted
    assert not np.array_equal(jm["kf_pose"], arrays["kf_pose"])
    assert not np.array_equal(jm["kf_obs"], arrays["kf_obs"])


def test_update_point_descriptors_like_jax():
    """The whole-map min-median descriptor refresh on a random map whose
    descriptors repeat (median ties) and whose busiest points have more
    than MAX_DESC_OBS observations: `torch.equal` with JAX."""
    from orb_slam2_comment_tpu.models import local_mapping as jlm
    from orb_slam2_comment_tpu_torch.models import local_mapping as tlm
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    r = np.random.default_rng(11)
    kmax, n, pmax = 24, 64, 300
    arrays = tms.to_numpy(tms.empty_map(kmax, pmax, n))
    # a skewed point draw: the first points are seen from most keyframes
    obs = np.minimum(r.geometric(0.02, (kmax, n)) - 1, pmax - 1).astype(np.int32)
    obs[r.random((kmax, n)) < 0.2] = -1
    arrays["kf_obs"] = obs
    arrays["kf_valid"] = r.random(kmax) < 0.9
    arrays["kf_feat_valid"] = r.random((kmax, n)) < 0.95
    pool = r.integers(0, 2 ** 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    arrays["kf_desc"] = pool[r.integers(0, 5, (kmax, n))]
    arrays["pt_valid"] = r.random(pmax) < 0.9
    arrays["pt_desc"] = r.integers(0, 2 ** 32, (pmax, 8), dtype=np.uint64).astype(np.uint32)
    counts = np.bincount(obs[obs >= 0], minlength=pmax)
    assert (counts > 2 * tlm.MAX_DESC_OBS).sum() >= 5
    want = np.array(jlm.update_point_descriptors(_jmap(arrays)).pt_desc)
    got = tlm.update_point_descriptors(tms.from_numpy(arrays)).pt_desc
    assert torch.equal(got, torch.from_numpy(want.view(np.int32)))
    assert not np.array_equal(want, arrays["pt_desc"])


def _mono_frames():
    from orb_slam2_comment_tpu.utils import synthetic as syn

    K = (520.0, 520.0, 320.0, 240.0)
    scene = syn.make_scene(n_points=1600, seed=0, extent=(8.0, 6.0, 8.0), z_near=1.5)
    poses = np.tile(np.eye(4, dtype=np.float32), (14, 1, 1))
    poses[:, 0, 3] = -0.12 * np.arange(14)
    poses[:, 2, 3] = -0.02 * np.arange(14)
    return K, list(syn.render_sequence(scene, poses, K=K))


def test_staged_mono_like_jax():
    """The monocular sequence of tests/test_loop_closing.py:53-77 (600 x 4)
    with the staged ladder: initialization at the same frame, the same
    keyframes and tracked frames, translations within 1e-3 map units, the
    same cursor and live points."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    K, frames = _mono_frames()
    kw = dict(sensor="monocular", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
              bf=K[0] * syn.DEFAULT_BASELINE, n_features=600, n_levels=4, max_keyframes=48,
              max_points=12288, match_th_scale=1.5, grow_capacity=False, fused_tracking=False)
    res = []
    for system in (JSystem(JConfig(**kw), enable_loop_closing=False),
                   TSystem(TConfig(**kw), enable_loop_closing=False, device="cpu")):
        recs = _records(lambda f: system.track_monocular(f["image"], f["timestamp"]), frames)
        system.shutdown()
        tr = system.tracker
        res.append((recs, tr.n_kfs, int(tr.n_pts), int(np.asarray(tr.map.pt_valid).sum())))
    (jrec, jk, jp, jl), (trec, tk, tp, tl) = res
    tracked = [i for i, r in enumerate(trec) if r[3] is not None]
    assert tracked == [i for i, r in enumerate(jrec) if r[3] is not None]
    assert len(tracked) >= 8 and tk == jk >= 2
    assert [r[2] for r in trec] == [r[2] for r in jrec]
    assert max(np.abs(trec[i][3][:3, 3] - jrec[i][3][:3, 3]).max() for i in tracked) <= 1e-3
    assert (tp, tl) == (jp, jl) and tl > 0


def test_monolithic_stereo_like_jax():
    """System.track_stereo with the monolithic mapper behind the fused
    step over 6 frames of tests/test_torch_stereo.py's sequence: every
    frame tracked, the same keyframes and cursor, translations within
    1 mm."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    kw = _rgbd_kw(sensor="stereo", n_features=600, chunked_mapper=False)
    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=6, step=0.3)
    frames = list(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, stereo=True))
    res = []
    for system in (JSystem(JConfig(**kw), enable_loop_closing=False),
                   TSystem(TConfig(**kw), enable_loop_closing=False, device="cpu")):
        recs = _records(lambda f: system.track_stereo(f["image"], f["image_right"],
                                                      f["timestamp"]), frames)
        system.shutdown()
        tr = system.tracker
        res.append((recs, tr.n_kfs, int(tr.n_pts)))
    (jrec, jk, jp), (trec, tk, tp) = res
    assert all(r[0] == 1 for r in jrec) and all(r[0] == 1 for r in trec)
    assert [r[2] for r in trec] == [r[2] for r in jrec] and tk == jk >= 2
    assert tp == jp > 0
    assert max(np.abs(a[3][:3, 3] - b[3][:3, 3]).max() for a, b in zip(trec, jrec)) <= 1e-3


@pytest.mark.parametrize("flags", [
    dict(fused_tracking=False), dict(chunked_mapper=False), dict()],
    ids=["staged", "monolithic", "no-device-state"])
def test_host_compaction_like_jax(flags):
    """`_maybe_grow` with the cursor past 85% of the arena and under half
    of it live, where the device step does not compact (either flag off,
    or no device state yet): both packages compact at the same tier instead
    of growing, with the same remap of the map and of the last frame's
    associations."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    from orb_slam2_comment_tpu.models.tracking import Tracker as JTracker
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models import map_state as tms
    from orb_slam2_comment_tpu_torch.models.tracking import Tracker as TTracker
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    kw = _rgbd_kw(max_keyframes=16, max_points=1024, grow_capacity=True,
                  max_keyframes_cap=64, max_points_cap=4096, **flags)
    r = np.random.default_rng(5)
    t = TTracker(TConfig(**kw), device="cpu")
    arrays = tms.to_numpy(t.map)
    n_feat = arrays["kf_obs"].shape[1]
    cursor = 900
    valid = np.zeros(1024, bool)
    valid[r.choice(cursor, 400, replace=False)] = True
    arrays["pt_valid"] = valid
    arrays["pt_pos"] = r.normal(size=(1024, 3)).astype(np.float32)
    arrays["kf_valid"][:4] = True
    arrays["kf_obs"][:4] = np.where(r.random((4, n_feat)) < 0.5,
                                    r.integers(0, cursor, (4, n_feat)), -1)
    last = np.where(r.random(n_feat) < 0.5, r.integers(0, cursor, n_feat), -1).astype(np.int32)

    j = JTracker(JConfig(**kw))
    j.map = _jmap(arrays)
    j.n_kfs, j.n_pts_host, j.n_pts = 4, cursor, cursor
    j.last_frame = SimpleNamespace(assoc=jnp.asarray(last))
    t.map = tms.from_numpy(arrays)
    t.n_kfs, t.n_pts_host, t.n_pts = 4, cursor, cursor
    t.last_frame = SimpleNamespace(assoc=torch.from_numpy(last))
    j._maybe_grow()
    t._maybe_grow()
    assert t.cfg.max_points == j.cfg.max_points == 1024
    assert t.compaction_epoch == j.compaction_epoch == 1
    assert t.n_pts_host == j.n_pts_host == int(j.n_pts) == t.n_pts == 400
    jm, tm = _np(j.map), tms.to_numpy(t.map)
    for f in jm:
        np.testing.assert_array_equal(tm[f], jm[f], err_msg=f)
    np.testing.assert_array_equal(t.last_frame.assoc.numpy(), np.asarray(j.last_frame.assoc))
    assert tm["pt_valid"][:400].all() and not tm["pt_valid"][400:].any()


@pytest.mark.parametrize("flags,mapped_per_kf", [
    (dict(), False), (dict(fused_tracking=False), True), (dict(chunked_mapper=False), True)],
    ids=["default", "staged", "monolithic"])
def test_mapper_callback_follows_the_mode(flags, mapped_per_kf):
    """System registers LocalMapper.process ahead of its own keyframe hook
    exactly when either flag is off, again after reset() and load_map(),
    and passes grown capacities on to the mapper."""
    import dataclasses
    import os
    import tempfile

    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    s = System(SlamConfig(**_rgbd_kw(max_keyframes=8, max_points=1024, **flags)),
               device="cpu")

    def check():
        cbs = s.tracker.new_kf_callbacks
        assert (s.mapper.process in cbs) == mapped_per_kf
        assert s.mapper.tracker is s.tracker
        if mapped_per_kf:
            assert cbs.index(s.mapper.process) < cbs.index(s._on_new_kf)

    check()
    s.reset()
    check()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        s.save_map(path)
        s.load_map(path)
    check()
    grown = dataclasses.replace(s.cfg, max_points=4096)
    s._on_grow(grown)
    assert s.mapper.cfg is grown
