"""The port's capacity tiers against the JAX package on the CPU: grow_map,
KeyFrameDatabase.grow, the host point compaction and the top-tier branch
of Tracker._maybe_grow, then one orbit at narrow width (600 x 4) in both
packages from the smallest tiers (16 keyframes, 8192 points; caps 64 and
32768) with a background global BA in flight across the growth, the
grown map saved and JAX's loaded into a System of each package at the
starting tier, and the default configuration constructed."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_ORBIT = 30     # growth fires at frame 14; the forced GBA lands at frame 21
N_AFTER_LOAD = 4


def _random_map(kmax=8, pmax=64, n_feat=16, n_valid_kf=6, seed=0):
    """tests/test_capacity.py's fixture map, as numpy arrays of the
    reference's MapState fields."""
    from orb_slam2_comment_tpu.models import map_state as jms

    rng = np.random.RandomState(seed)
    m = {k: np.asarray(v) for k, v in jms.empty_map(kmax, pmax, n_feat)._asdict().items()}
    obs = np.full((kmax, n_feat), -1, np.int32)
    for k in range(kmax):
        obs[k, :12] = rng.choice(pmax, size=12, replace=False)
    parent = np.full(kmax, -1, np.int32)
    parent[1:n_valid_kf] = np.arange(n_valid_kf - 1)
    poses = np.tile(np.eye(4, dtype=np.float32), (kmax, 1, 1))
    poses[:, :3, 3] = rng.randn(kmax, 3).astype(np.float32)
    Tcp = poses.copy()
    Tcp[:, :3, :3] = np.float32(0.5)
    m.update(kf_obs=obs, kf_valid=np.arange(kmax) < n_valid_kf, kf_feat_valid=obs >= 0,
             kf_parent=parent, kf_pose=poses, kf_Tcp=Tcp,
             pt_valid=rng.rand(pmax) > 0.2,
             pt_pos=rng.randn(pmax, 3).astype(np.float32),
             pt_max_dist=rng.rand(pmax).astype(np.float32) + 1.0,
             pt_ref_kf=rng.randint(0, n_valid_kf, pmax).astype(np.int32),
             kf_desc=rng.randint(0, 2 ** 32, (kmax, n_feat, 8), dtype=np.uint64).astype(np.uint32),
             kf_uright=rng.rand(kmax, n_feat).astype(np.float32))
    return m


def _jax_map(arrays):
    import jax.numpy as jnp
    from orb_slam2_comment_tpu.models import map_state as jms

    return jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _assert_maps_equal(tmap, jmap):
    from orb_slam2_comment_tpu_torch.models import map_state as ms

    t = ms.to_numpy(tmap)
    for f, a in jmap._asdict().items():
        a = np.asarray(a)
        assert t[f].shape == a.shape and t[f].dtype == a.dtype, f
        np.testing.assert_array_equal(t[f], a, err_msg=f)


@pytest.mark.parametrize("tiers", [(32, 64), (8, 256), (32, 256)],
                         ids=["keyframes", "points", "both"])
def test_grow_map_matches_jax(tiers):
    """Every field of the grown map equals JAX's grow_map, bit for bit:
    the old rows kept, the new ones filled as the reference fills them."""
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu_torch.models import map_state as ms

    arrays = _random_map()
    g = ms.grow_map(ms.from_numpy(arrays), *tiers)
    _assert_maps_equal(g, jms.grow_map(_jax_map(arrays), *tiers))
    assert g.kf_obs.shape[0] == tiers[0] and g.pt_pos.shape[0] == tiers[1]


def test_grow_map_refuses_shrink_and_keeps_identity():
    from orb_slam2_comment_tpu_torch.models import map_state as ms

    m = ms.from_numpy(_random_map())
    for tiers in ((4, 256), (32, 32)):
        with pytest.raises(ValueError):
            ms.grow_map(m, *tiers)
    assert ms.grow_map(m, 8, 64) is m


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_database_grow_matches_jax(layout, monkeypatch):
    """KeyFrameDatabase.grow on the dense BoW matrix and on the inverted
    file (a threshold below the vocabulary's word count): every array
    equals JAX's after the same adds and the same growth, the sparse
    layout drops its postings cache, and the grown database scores the
    same as JAX's."""
    from orb_slam2_comment_tpu.models import keyframe_database as jkd
    from orb_slam2_comment_tpu.ops import bow as jbow
    from orb_slam2_comment_tpu_torch.models import keyframe_database as tkd
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET
    from orb_slam2_comment_tpu_torch.ops import bow as tbow

    if layout == "sparse":
        monkeypatch.setattr(jkd, "SPARSE_W_THRESHOLD", 8)
        monkeypatch.setattr(tkd, "SPARSE_W_THRESHOLD", 8)
    jvoc, tvoc = jbow.load_vocabulary(VOC_ASSET), tbow.load_vocabulary(VOC_ASSET, "cpu")
    jdb, tdb = jkd.KeyFrameDatabase(jvoc, 4, 32), tkd.KeyFrameDatabase(tvoc, 4, 32, "cpu")
    assert jdb.sparse == tdb.sparse == (layout == "sparse")
    r = np.random.default_rng(1)
    desc = r.integers(0, 2 ** 32, (4, 32, 8), dtype=np.uint64).astype(np.uint32)
    valid = r.random((4, 32)) < 0.9
    for k in range(3):
        jdb.add(k, desc[k], valid[k])
        tdb.add(k, torch.from_numpy(desc[k].view(np.int32)), torch.from_numpy(valid[k]))
    if tdb.sparse:
        tdb.postings()
        assert tdb._postings is not None
    jdb.grow(16)
    tdb.grow(16)
    tdb.grow(8)   # no shrink
    if tdb.sparse:
        assert tdb._postings is None
    # ids and flags exactly; the BoW weights to f32 rounding (the two
    # packages normalize in other orders)
    for f in ("sp_word", "groups", "words", "valid") if tdb.sparse else ("groups", "words",
                                                                          "valid"):
        np.testing.assert_array_equal(getattr(tdb, f).numpy(), np.asarray(getattr(jdb, f)), f)
    f = "sp_w" if tdb.sparse else "bow"
    np.testing.assert_allclose(getattr(tdb, f).numpy(), np.asarray(getattr(jdb, f)),
                               rtol=1e-6, atol=1e-7)
    tdb.add(12, torch.from_numpy(desc[3].view(np.int32)), torch.from_numpy(valid[3]))
    jdb.add(12, desc[3], valid[3])
    js, jc = jdb.scores_device(kf_id=12)
    ts, tc = tdb.scores_device(kf_id=12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("live_share", [0.7, 0.9], ids=["compacts", "warns"])
def test_top_tier_branch_matches_jax(live_share, capsys):
    """At the top tier a full point cursor compacts the arena when >= 15%
    of it is reclaimable, else warns once; either way the next attempt
    waits 4 keyframes. Both packages' _maybe_grow on the same map and
    cursors reach the same map, cursor, epoch and hysteresis. At least half
    the slots are live, so JAX does not take its branch for a tracker that
    does not compact on the device, which the port leaves out."""
    from orb_slam2_comment_tpu.models.tracking import Tracker as JTracker
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models import map_state as ms
    from orb_slam2_comment_tpu_torch.models.tracking import Tracker as TTracker
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    kw = dict(max_keyframes=8, max_points=64, max_keyframes_cap=8, max_points_cap=64,
              n_features=16, n_levels=1)
    arrays = _random_map()
    r = np.random.default_rng(2)
    arrays["pt_valid"] = r.random(64) < live_share
    assert 32 <= arrays["pt_valid"].sum() and (arrays["pt_valid"].sum() < 54) == (live_share < 0.85)
    jt, tt = JTracker(JConfig(**kw)), TTracker(TConfig(**kw), device="cpu")
    jt.map, tt.map = _jax_map(arrays), ms.from_numpy(arrays)
    for t in (jt, tt):
        t.n_kfs, t.n_pts_host = 6, 60
        t._maybe_grow()
        t._maybe_grow()   # within the hysteresis: no second attempt
    assert (tt.compaction_epoch, tt.n_pts_host, tt._next_compact_kfs, tt._top_tier_warned) == (
        jt.compaction_epoch, jt.n_pts_host, jt._next_compact_kfs, jt._top_tier_warned)
    assert tt.compaction_epoch == (1 if live_share < 0.85 else 0)
    assert tt.cfg.max_points == 64
    _assert_maps_equal(tt.map, jt.map)
    assert capsys.readouterr().out.count("WARNING") == (0 if live_share < 0.85 else 2)


def _cfg_kw():
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    K = syn.DEFAULT_K
    # the smallest tiers the BA-window constants and LOCAL_POINTS_CAP allow
    return dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                bf=K[0] * syn.DEFAULT_BASELINE, n_features=600, n_levels=4,
                max_keyframes=16, max_points=8192, max_keyframes_cap=64,
                max_points_cap=32768, match_th_scale=1.5)


def _drive(system, frames):
    """The orbit through System.track_rgbd; a background GBA is started by
    hand when the 12th keyframe exists (before growth at 13). Returns
    per-frame records and the growth events (frame, tiers, n_kfs, GBA in
    flight)."""
    recs, events, started = [], [], [None]
    system.tracker.grow_callbacks.append(lambda c: events.append(
        (len(recs), c.max_keyframes, c.max_points, system.tracker.n_kfs,
         system.loop_closer._bg is not None)))
    for i, f in enumerate(frames):
        if started[0] is None and system.tracker.n_kfs >= 12:
            system.loop_closer._start_background_gba(system.tracker.map)
            started[0] = i
        out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        recs.append((out.state, out.created_kf,
                     None if out.Tcw is None else np.asarray(out.Tcw, np.float64),
                     system.loop_closer._bg is None))
    system.shutdown()
    return recs, events, started[0]


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    K, B = syn.DEFAULT_K, syn.DEFAULT_BASELINE
    scene = syn.make_scene(n_points=1400, seed=0)
    poses = syn.make_trajectory("orbit", n_frames=60, step=0.1)[:N_ORBIT + N_AFTER_LOAD]
    frames = list(syn.render_sequence(scene, poses, K=K, depth=True, baseline=B))
    d = tmp_path_factory.mktemp("grown")
    out = {}
    for name, make in (("jax", lambda: JSystem(JConfig(**_cfg_kw()))),
                       ("torch", lambda: TSystem(TConfig(**_cfg_kw()), device="cpu"))):
        system = make()
        recs, events, started = _drive(system, frames[:N_ORBIT])
        system.save_map(str(d / f"{name}.npz"))
        loaded = make()
        loaded.load_map(str(d / "jax.npz"))   # the same file in both packages
        after_load = dict(cfg=(loaded.cfg.max_keyframes, loaded.cfg.max_points),
                          map=tuple(loaded.tracker.map.kf_pose.shape[:1])
                          + tuple(loaded.tracker.map.pt_pos.shape[:1]),
                          db=int(np.asarray(loaded.db.valid).shape[0]),
                          db_indexed=int(np.asarray(loaded.db.valid).sum()),
                          n_kfs=loaded.tracker.n_kfs)
        states = []
        for f in frames[N_ORBIT:]:
            state = loaded.track_rgbd(f["image"], f["depth"], f["timestamp"] + 10.0).state
            db_valid = np.asarray(loaded.db.valid)
            states.append((state, loaded.tracker.n_kfs, loaded.cfg.max_keyframes,
                           loaded.tracker.cfg.max_keyframes, db_valid.shape[0],
                           np.flatnonzero(db_valid).tolist()))
        loaded.shutdown()
        out[name] = dict(system=system, recs=recs, events=events, started=started,
                         after_load=after_load, states_after_load=states, loaded=loaded)
    out["jax_file"] = dict(np.load(d / "jax.npz"))
    return frames, out


def test_growth_like_jax(orbit):
    """Both packages grow at the same frame, from 16/8192 to the same
    tiers, keep every frame tracked and the same keyframes, and agree on
    the poses as tests/test_torch_system.py's orbit does (ATE within 5 mm;
    observed: every frame's translation within 1.6 mm); the grown map,
    database and components agree on the tier."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    frames, out = orbit
    j, t = out["jax"], out["torch"]
    assert [e[:4] for e in t["events"]] == [e[:4] for e in j["events"]]
    assert len(t["events"]) == 1 and t["events"][0][1:3] == (64, 8192)
    assert all(r[0] == 1 for r in t["recs"]) and all(r[0] == 1 for r in j["recs"])
    assert [r[1] for r in t["recs"]] == [r[1] for r in j["recs"]]
    ts, js = t["system"], j["system"]
    assert ts.tracker.n_kfs == js.tracker.n_kfs >= 13
    tp, jp = [r[2] for r in t["recs"]], [r[2] for r in j["recs"]]
    gt = [f["Tcw_gt"] for f in frames[:N_ORBIT]]
    assert abs(ate_rmse(tp, gt) - ate_rmse(jp, gt)) < 5e-3
    assert max(np.abs(a[:3, 3] - b[:3, 3]).max() for a, b in zip(tp, jp)) < 5e-3
    k = ts.cfg.max_keyframes
    assert (ts.tracker.cfg.max_keyframes == ts.loop_closer.cfg.max_keyframes == k
            == ts.tracker.map.kf_obs.shape[0] == ts.db.valid.shape[0]
            == ts.db.groups.shape[0] == len(ts.tracker.kf_ts_host) == 64)
    assert ts.tracker.map.pt_pos.shape[0] == ts.cfg.max_points == 8192
    # the mapper machine was rebuilt at the new tier's window capacities
    assert ts.tracker.ds.mp.ba_cam_ids.shape[0] == js.tracker.ds.mp.ba_cam_ids.shape[0]


def test_gba_in_flight_across_growth_like_jax(orbit):
    """A background GBA started at the old tier is still in flight when
    growth fires; both packages keep it (growth keeps every id) and apply
    it, padded to the grown map, on the same frame, with the same
    keyframes afterwards and poses within 1 mm of JAX's (observed 0.4 mm)."""
    _, out = orbit
    j, t = out["jax"], out["torch"]
    assert t["started"] == j["started"] is not None
    assert t["events"][0][4] and j["events"][0][4], "no GBA in flight at growth"
    applied_t = [r[3] for r in t["recs"]]
    assert applied_t == [r[3] for r in j["recs"]]
    first = applied_t.index(True, t["started"] + 1)
    assert first > t["events"][0][0]
    ts = t["system"]
    assert ts.loop_closer.n_gba_applied >= 1 and ts.loop_closer._bg is None
    for a, b in zip(t["recs"][first:], j["recs"][first:]):
        assert np.abs(a[2][:3, 3] - b[2][:3, 3]).max() < 1e-3


def test_grown_map_loads_into_a_system_at_the_starting_tier(orbit, tmp_path):
    """JAX's map saved at the 64-keyframe tier (the port's own file has the
    same tier and cursors), loaded by a System of each package built at 16:
    both adopt the 64-row map beside their 16-keyframe cfg and database,
    index keyframes 0-15 only (the database drops the rows at or above its
    tier) and then agree frame by frame on the state, n_kfs, the tiers of
    the System and the tracker and the database's rows."""
    _, out = orbit
    j, t = out["jax"], out["torch"]
    n = j["after_load"]["n_kfs"]
    assert n > 16
    assert t["after_load"] == j["after_load"] == dict(cfg=(16, 8192), map=(64, 8192), db=16,
                                                       db_indexed=16, n_kfs=n)
    assert t["states_after_load"] == j["states_after_load"]
    assert len(t["states_after_load"]) == N_AFTER_LOAD
    t["system"].save_map(str(tmp_path / "port.npz"))
    zt, zj = np.load(tmp_path / "port.npz"), out["jax_file"]
    assert (zt["kf_pose"].shape, int(zt["n_kfs"])) == (zj["kf_pose"].shape, int(zj["n_kfs"]))


def test_host_compaction_remaps_like_jax(orbit):
    """Tracker._compact_points on the same map, device assoc and host-frame
    assoc in both packages (the JAX orbit tracker's, copied into the
    port's):
    the same compacted map, cursor, epoch and remapped associations."""
    from orb_slam2_comment_tpu_torch.models import map_state as ms

    _, out = orbit
    jt, tt = out["jax"]["system"].tracker, out["torch"]["system"].tracker
    tt.map = ms.from_numpy({k: np.asarray(v) for k, v in jt.map._asdict().items()})
    tt.n_pts_host = jt.n_pts_host = int(np.asarray(jt.ds.n_pts))
    tt.ds = tt.ds.replace(last_assoc=torch.from_numpy(np.array(jt.ds.last_assoc)))
    tt.last_frame.assoc = torch.from_numpy(np.array(jt.last_frame.assoc))
    e0 = (tt.compaction_epoch, jt.compaction_epoch)
    for t in (jt, tt):
        t._compact_points()
    assert (tt.compaction_epoch - e0[0], jt.compaction_epoch - e0[1]) == (1, 1)
    _assert_maps_equal(tt.map, jt.map)
    assert tt.n_pts_host == jt.n_pts_host == int(tt.ds.n_pts) == int(np.asarray(jt.ds.n_pts))
    np.testing.assert_array_equal(tt.ds.last_assoc.numpy(), np.asarray(jt.ds.last_assoc))
    np.testing.assert_array_equal(tt.ds.obs_counts.numpy(), np.asarray(jt.ds.obs_counts))
    np.testing.assert_array_equal(tt.last_frame.assoc.numpy(), np.asarray(jt.last_frame.assoc))
    assert int((tt.ds.last_assoc >= 0).sum()) > 0


@pytest.mark.parametrize("sensor", ["rgbd", "stereo", "monocular"])
def test_default_config_constructs(sensor):
    """System(SlamConfig()) — growth on, 256/32768 tiers, loop closing on —
    constructs for each sensor, as the reference's drivers build it."""
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    s = System(SlamConfig(sensor=sensor), device="cpu")
    assert s.cfg.grow_capacity and s.cfg.max_keyframes == 256
    assert s.loop_closer is not None and s.tracker.grow_callbacks == [s._on_grow]
