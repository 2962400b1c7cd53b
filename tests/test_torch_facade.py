"""The rest of the port's System façade against the JAX package on the CPU:
quaternions and the TUM/KITTI writers, the vocabulary tools (text format,
first-keyframe bootstrap), localization mode with its visual-odometry
fallback, the auto-reset gate, the state queries, the trajectory savers,
map save/load across the two packages and the synchronous global BA —
the scenarios of tests/test_system.py at the widths of
tests/test_torch_system.py."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_TXT = os.path.join(ROOT, "orb_slam2_comment_tpu", "assets", "voc_synth_100k.txt")


def _cfg_kw():
    from orb_slam2_comment_tpu.utils import synthetic as syn

    K = syn.DEFAULT_K
    return dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                bf=K[0] * syn.DEFAULT_BASELINE, n_features=500, n_levels=4,
                max_keyframes=32, max_points=8192, grow_capacity=False, match_th_scale=1.5)


def _systems(**kw):
    """(JAX System, port System on the CPU) at the test widths."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    return JSystem(JConfig(**_cfg_kw()), **kw), TSystem(TConfig(**_cfg_kw()), device="cpu", **kw)


def _drive(system, frames):
    """(state, n_inliers, created_kf, Tcw or None, vo flag) per frame;
    reading the state resolves each JAX frame before the next one."""
    recs = []
    for f in frames:
        out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        recs.append((out.state, out.n_inliers, out.created_kf,
                     None if out.Tcw is None else np.asarray(out.Tcw, np.float64),
                     bool(system.tracker.vo)))
    return recs


def _max_dt(a, b):
    return max(np.abs(x[3][:3, 3] - y[3][:3, 3]).max() for x, y in zip(a, b)
               if x[3] is not None and y[3] is not None)


def _map_arrays(system):
    """A System's map as numpy arrays in the reference's dtypes."""
    m = system.tracker.map
    if isinstance(m.kf_pose, torch.Tensor):
        from orb_slam2_comment_tpu_torch.models import map_state as ms

        return {f: a.copy() for f, a in ms.to_numpy(m).items()}   # no views of live tensors
    return {f: np.asarray(getattr(m, f)) for f in m._fields}


@pytest.fixture(scope="module")
def jitter(tmp_path_factory):
    """tests/test_system.py's scenarios in both packages: 6 jitter frames
    (1400 points, seed 0), the savers and state queries, localization mode
    over 4 jitter frames (seed 5), then every map point made unmatchable
    and 6 forward frames at 0.08 m in visual odometry."""
    from orb_slam2_comment_tpu.utils import synthetic as syn

    scene = syn.make_scene(n_points=1400, seed=0)
    render = lambda poses: list(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, depth=True,
                                                    baseline=syn.DEFAULT_BASELINE))
    first = render(syn.make_trajectory("jitter", n_frames=6, step=0.05))
    loc = render(syn.make_trajectory("jitter", n_frames=4, step=0.05, seed=5))
    vo = render(syn.make_trajectory("forward", n_frames=6, step=0.08))
    out = {}
    for name, system in zip(("jax", "port"), _systems()):
        d = tmp_path_factory.mktemp(name)
        r = dict(system=system, first=_drive(system, first))
        r["n_kfs"] = system.tracker.n_kfs
        r["points"] = np.sort(np.asarray(system.get_tracked_map_points()))
        r["keypoints"] = np.asarray(system.get_tracked_keypoints())
        for saver in ("tum", "kitti", "keyframe_tum"):
            p = str(d / f"{saver}.txt")
            getattr(system, "save_keyframe_trajectory_tum" if saver == "keyframe_tum" else
                    f"save_trajectory_{saver}")(p)
            r[saver] = np.loadtxt(p, ndmin=2)
        r["kf_valid"] = int(np.asarray(system.tracker.map.kf_valid).sum())
        r["map"] = str(d / "map.npz")
        system.save_map(r["map"])
        system.activate_localization_mode()
        r["loc"] = _drive(system, loc)
        r["n_kfs_loc"] = system.tracker.n_kfs
        t = system.tracker
        if name == "jax":
            import jax.numpy as jnp

            t.map = t.map._replace(pt_valid=jnp.zeros_like(t.map.pt_valid))
        else:
            t.map = t.map.replace(pt_valid=torch.zeros_like(t.map.pt_valid))
        r["vo"] = _drive(system, vo)
        out[name] = r
    out["loc_frames"] = loc
    out["gt_first"] = [f["Tcw_gt"] for f in first]
    out["gt_vo"] = [f["Tcw_gt"] for f in vo]
    return out


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    """12 frames of the orbit of tests/test_loop_closing.py (8 keyframes)
    mapped by each package and saved; the JAX map loaded into a new System
    of each package and tracked over frames 10-13 (the first relocalizes),
    and the port's map loaded into JAX."""
    from orb_slam2_comment_tpu.utils import synthetic as syn

    scene = syn.make_scene(n_points=1800, seed=0, extent=(14.0, 8.0, 20.0))
    frames = list(syn.render_sequence(scene, syn.make_trajectory("orbit", n_frames=44)[:14],
                                      K=syn.DEFAULT_K, depth=True))
    d = tmp_path_factory.mktemp("maps")
    files, counts = {}, {}
    for name, system in zip(("jax", "port"), _systems()):
        _drive(system, frames[:12])
        files[name] = str(d / f"{name}.npz")
        system.save_map(files[name])
        counts[name] = (system.tracker.n_kfs, int(system.tracker.n_pts))
    jl, tl = _systems()
    jl.load_map(files["jax"])
    tl.load_map(files["jax"])
    loaded = dict(jax=(_map_arrays(jl), jl.tracker.n_kfs, jl.tracker.n_pts,
                       np.asarray(jl.db.valid)),
                  port=(_map_arrays(tl), tl.tracker.n_kfs, tl.tracker.n_pts,
                        tl.db.valid.numpy().copy()))
    after = dict(jax=_drive(jl, frames[10:]), port=_drive(tl, frames[10:]))
    jp, _ = _systems()
    jp.load_map(files["port"])
    return dict(files=files, counts=counts, loaded=loaded, after=after, port_loaded=tl,
                jax_loaded=jl,
                jax_from_port=(_map_arrays(jp), jp.tracker.n_kfs, jp.tracker.n_pts),
                # the map's world is camera 0's frame
                gt=[f["Tcw_gt"] @ np.linalg.inv(frames[0]["Tcw_gt"]) for f in frames[10:]])


def _rotations():
    """Random rotations plus half-turns about x, y and z, so that every
    branch of Shepperd's method is taken."""
    def exp(w):   # Rodrigues
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx

    r = np.random.default_rng(13)
    Rs = [exp(r.normal(size=3) * 2) for _ in range(30)]
    for axis in np.eye(3):
        for ang in (np.pi, 0.97 * np.pi):
            Rs.append(exp(axis * ang + r.normal(size=3) * 0.05))
    return np.stack(Rs).astype(np.float32)


def test_rot_to_quat_like_jax():
    """The port's rot_to_quat equals JAX's within 1e-6 on rotations that
    take all four branches, and round-trips through quat_to_rot within
    1e-5 (tests/test_geometry.py:153)."""
    import jax.numpy as jnp
    from orb_slam2_comment_tpu.ops import geometry as jgeo
    from orb_slam2_comment_tpu_torch.ops import geometry as tgeo

    R = _rotations()
    q_t = tgeo.rot_to_quat(torch.from_numpy(R))
    q_j = np.asarray(jgeo.rot_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(q_t.numpy(), q_j, atol=1e-6)
    np.testing.assert_allclose(tgeo.quat_to_rot(q_t).numpy(), R, atol=1e-5)
    d = np.diagonal(R, axis1=1, axis2=2)
    tr = d.sum(1)
    branch = np.where(tr > 0, 0, np.where((d[:, 0] >= d[:, 1]) & (d[:, 0] >= d[:, 2]), 1,
                                          np.where(d[:, 1] >= d[:, 2], 2, 3)))
    assert set(branch.tolist()) == {0, 1, 2, 3}


def test_trajectory_writers_like_jax(tmp_path):
    """save_tum and save_kitti of both packages on the same 36 poses. The
    KITTI files are byte-equal (float64 numpy in both). The TUM files are
    not: their timestamp and position columns are equal character for
    character, but the f32 quaternions of the two frameworks can differ by
    one in the 7th decimal (observed on these poses), so the parsed values
    agree within 1e-6."""
    from orb_slam2_comment_tpu.utils import trajectory as J
    from orb_slam2_comment_tpu_torch.utils import trajectory as T

    r = np.random.default_rng(4)
    R = _rotations().astype(np.float64)
    poses = np.tile(np.eye(4), (len(R), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = r.normal(size=(len(R), 3)) * 3
    ts = np.cumsum(r.uniform(0.01, 0.05, len(R))) + 1.3e9
    out = {}
    for writer, args in (("save_tum", (ts, poses)), ("save_kitti", (poses,))):
        pj, pt = tmp_path / f"j_{writer}.txt", tmp_path / f"t_{writer}.txt"
        getattr(J, writer)(str(pj), *args)
        getattr(T, writer)(str(pt), *args)
        np.testing.assert_allclose(np.loadtxt(pt), np.loadtxt(pj), atol=1e-6, rtol=0)
        out[writer] = pt.read_text().splitlines(), pj.read_text().splitlines()
    assert out["save_kitti"][0] == out["save_kitti"][1]
    tl, jl = out["save_tum"]
    assert [ln.split()[:4] for ln in tl] == [ln.split()[:4] for ln in jl]


def test_vocabulary_text_like_jax(tmp_path):
    """save_orb_vocab_text of the packaged vocabulary is byte-equal to
    JAX's, and load_orb_vocab of the 100k-word ORBvoc.txt (read by the port's
    vectorized tokenizer) gives JAX's arrays."""
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    jv, tv = jb.load_vocabulary(VOC_ASSET), tb.load_vocabulary(VOC_ASSET)
    jb.save_orb_vocab_text(str(tmp_path / "j.txt"), jv)
    tb.save_orb_vocab_text(str(tmp_path / "t.txt"), tv)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    a, b = jb.load_orb_vocab(VOC_TXT), tb.load_orb_vocab(VOC_TXT)
    for f in ("children", "node_word", "word_weight"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), f)
    np.testing.assert_array_equal(b.node_desc.numpy().view(np.uint32), np.asarray(a.node_desc))
    assert (b.group_depth, b.depth, b.k) == (a.group_depth, a.depth, a.k)


def test_bootstrap_vocabulary_like_jax(monkeypatch):
    """With the packaged vocabulary hidden, both packages train one from the
    first keyframe's descriptors: equal arrays, the node gate active in
    both, equal database groups for keyframe 0."""
    from orb_slam2_comment_tpu.utils import synthetic as syn

    exists = os.path.exists
    monkeypatch.setattr(os.path, "exists",
                        lambda p: False if str(p).endswith("voc_synth.npz") else exists(p))
    js, ts = _systems()
    assert js.voc is None and ts.voc is None and ts.db is None
    f = next(iter(syn.render_sequence(syn.make_scene(n_points=1400, seed=0),
                                      syn.make_trajectory("jitter", n_frames=1),
                                      K=syn.DEFAULT_K, depth=True)))
    for s in (js, ts):
        assert s.track_rgbd(f["image"], f["depth"], f["timestamp"]).state == 1
    for fld in ("children", "node_word", "word_weight"):
        np.testing.assert_array_equal(getattr(ts.voc, fld).numpy(),
                                      np.asarray(getattr(js.voc, fld)), fld)
    np.testing.assert_array_equal(ts.voc.node_desc.numpy().view(np.uint32),
                                  np.asarray(js.voc.node_desc))
    assert (ts.voc.group_depth, ts.voc.depth, ts.voc.k) == (js.voc.group_depth, 3, 8)
    assert ts._gate_active and js._gate_active
    assert ts.loop_closer is not None and js.loop_closer is not None
    np.testing.assert_array_equal(ts.db.groups[0].numpy(), np.asarray(js.db.groups[0]))
    np.testing.assert_array_equal(ts.tracker.map.kf_group[0].numpy(),
                                  np.asarray(js.tracker.map.kf_group[0]))


def test_full_stack_and_savers_like_jax(jitter):
    """tests/test_system.py:test_full_stack: every frame tracked, the same
    keyframes, translations within 1e-3 m of JAX's and ATE < 3 cm; the TUM,
    KITTI and keyframe files have the same lines, positions within 1e-3 m,
    one keyframe line per valid keyframe."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    j, t = jitter["jax"], jitter["port"]
    assert [r[:1] + r[2:3] for r in t["first"]] == [r[:1] + r[2:3] for r in j["first"]]
    assert all(r[0] == 1 for r in t["first"])
    assert _max_dt(t["first"], j["first"]) <= 1e-3
    assert ate_rmse([r[3] for r in t["first"]], jitter["gt_first"]) < 0.03
    for saver in ("tum", "kitti", "keyframe_tum"):
        assert t[saver].shape == j[saver].shape, saver
        np.testing.assert_allclose(t[saver], j[saver], atol=1e-3, rtol=0, err_msg=saver)
    assert t["keyframe_tum"].shape[0] == t["kf_valid"] == t["n_kfs"]


def test_state_queries_like_jax(jitter):
    """get_tracked_map_points gives the same point ids, and
    get_tracked_keypoints the same keypoints within 1e-4 px — those of the
    last host-path frame, the initializing one, in both."""
    j, t = jitter["jax"], jitter["port"]
    np.testing.assert_array_equal(t["points"], j["points"])
    assert len(t["points"]) > 50
    assert t["keypoints"].shape == j["keypoints"].shape
    np.testing.assert_allclose(t["keypoints"], j["keypoints"], atol=1e-4, rtol=0)


def test_localization_mode_like_jax(jitter):
    """tests/test_system.py:test_localization_only_mode: the same states,
    no keyframe created, translations within 1e-3 m of JAX's."""
    j, t = jitter["jax"], jitter["port"]
    assert [r[0] for r in t["loc"]] == [r[0] for r in j["loc"]]
    assert all(r[0] == 1 and not r[2] for r in t["loc"])
    assert t["n_kfs_loc"] == t["n_kfs"] and j["n_kfs_loc"] == j["n_kfs"]
    assert _max_dt(t["loc"], j["loc"]) <= 1e-3


def test_localization_vo_like_jax(jitter):
    """tests/test_system.py:test_localization_only_vo_mode: with no map
    point matchable both packages track by visual odometry — the same
    states and VO flags, translations within 1e-3 m of JAX's, within 8 cm
    of the truth after the first frame."""
    j, t = jitter["jax"], jitter["port"]
    assert [(r[0], r[4]) for r in t["vo"]] == [(r[0], r[4]) for r in j["vo"]]
    assert j["system"].tracker.vo and t["system"].tracker.vo
    assert all(r[0] == 1 for r in t["vo"][1:])
    assert _max_dt(t["vo"], j["vo"]) <= 1e-3
    errs = [np.linalg.norm(r[3][:3, 3] - g[:3, 3]) for r, g in zip(t["vo"][1:],
                                                                    jitter["gt_vo"][1:])]
    assert max(errs) < 0.08, errs


def test_auto_reset_gate_and_map_changed_like_jax():
    """A map lost with <= 5 keyframes is kept in localization mode and
    reset outside it (tests/test_system.py:test_auto_reset_after_early_loss);
    map_changed reads False, True, False across that reset in both."""
    from orb_slam2_comment_tpu_torch.models.tracking import LOST

    seqs = []
    for s in _systems():
        s.tracker.n_kfs, s.tracker.state = 2, LOST
        seq = [s.map_changed()]
        s.activate_localization_mode()
        s._maybe_auto_reset()
        kept = (s.n_resets, s.tracker.n_kfs)
        s.deactivate_localization_mode()
        s._maybe_auto_reset()
        seq += [s.map_changed(), s.map_changed()]
        seqs.append((kept, s.n_resets, s.tracker.n_kfs, seq))
    assert seqs[1] == seqs[0] == ((0, 2), 1, 0, [False, True, False])


def test_map_save_load_across_packages(orbit):
    """A map saved by either package loads in both, field for field equal
    to the file; the JAX map loaded into each package relocalizes on the
    first frame (a view near the last keyframes; the orbit's next, unmapped
    view is lost in both after a relocalization, which drops the motion
    model) and tracks 4 frames with the same states and keyframes,
    translations within 1e-3 m of JAX's and 2 cm of the truth."""
    # saved by one package, loaded by the other
    for saved, loaded in (("jax", orbit["loaded"]["port"][:3]),
                          ("port", orbit["jax_from_port"])):
        z = np.load(orbit["files"][saved])
        arrays, n_kfs, n_pts = loaded
        assert (n_kfs, n_pts) == orbit["counts"][saved] == (int(z["n_kfs"]), int(z["n_pts"]))
        assert n_kfs > 5
        for f, a in arrays.items():
            assert a.dtype == z[f].dtype, f
            np.testing.assert_array_equal(a, z[f], f)
    assert sorted(np.load(orbit["files"]["jax"]).files) == sorted(
        np.load(orbit["files"]["port"]).files)
    # the JAX map in both: the same database entries, then the same frames
    np.testing.assert_array_equal(orbit["loaded"]["port"][3], orbit["loaded"]["jax"][3])
    j, t = orbit["after"]["jax"], orbit["after"]["port"]
    assert [(r[0], r[2]) for r in t] == [(r[0], r[2]) for r in j]
    assert all(r[0] == 1 for r in t)
    assert _max_dt(t, j) <= 1e-3
    assert max(np.abs(r[3][:3, 3] - g[:3, 3]).max() for r, g in zip(t, orbit["gt"])) < 0.02


def test_load_map_keeps_what_was_tracked_like_jax(jitter, orbit):
    """load_map into a System that has tracked more keyframes than the file
    holds, in both packages (each System loaded the JAX orbit map and
    tracked 4 frames): the map, keyframe count and point cursor come from
    the file and the tracker starts LOST, and both keep the rest alike:
    database rows above the file's keyframes, the trajectory, the device
    state, velocity, `last_frame`, the cursor mirror, the loop closer's
    state and n_resets. Then the same frames give the same states and
    keyframes in both, translations within 1e-3 m."""
    from orb_slam2_comment_tpu_torch.models.tracking import LOST

    path = jitter["jax"]["map"]
    z = np.load(path)
    n_kfs_file = int(z["n_kfs"])
    kept = {}
    for name in ("jax", "port"):
        s = orbit[f"{name}_loaded"]
        t, lc = s.tracker, s.loop_closer
        assert t.n_kfs > n_kfs_file and len(t.trajectory) > 0 and t.ds is not None
        before = (s.n_resets, len(t.trajectory), id(t.ds), id(t.last_frame), t.n_pts_host,
                  np.asarray(s.db.valid).copy(), lc._bg is not None, len(lc._detect_q),
                  len(lc.loop_edges))
        velocity = None if t.velocity is None else np.asarray(t.velocity).copy()
        s.load_map(path)
        assert (t.state, t.n_kfs, t.ref_kf, int(t.n_pts)) == (
            LOST, n_kfs_file, n_kfs_file - 1, int(z["n_pts"]))
        after = (s.n_resets, len(t.trajectory), id(t.ds), id(t.last_frame), t.n_pts_host,
                 np.asarray(s.db.valid).copy(), lc._bg is not None, len(lc._detect_q),
                 len(lc.loop_edges))
        assert after[:5] == before[:5] and after[6:] == before[6:]
        assert after[5][:n_kfs_file].all()
        np.testing.assert_array_equal(after[5][n_kfs_file:], before[5][n_kfs_file:])
        assert after[5][n_kfs_file:].any()   # stale rows kept
        assert (t.velocity is None) == (velocity is None)
        if velocity is not None:
            np.testing.assert_array_equal(np.asarray(t.velocity), velocity)
        kept[name] = (after[1], after[4], after[5], after[6:], velocity,
                      _map_arrays(s))
    (jt, jh, jv, jl, jvel, jm), (tt, th, tv, tl, tvel, tm) = kept["jax"], kept["port"]
    assert (tt, th, tl) == (jt, jh, jl)   # trajectory rows, mirror, loop closer
    np.testing.assert_array_equal(tv, jv)
    assert (tvel is None) == (jvel is None)
    if tvel is not None:
        np.testing.assert_allclose(tvel, jvel, atol=1e-3)
    for f in jm:
        np.testing.assert_array_equal(tm[f], jm[f], f)
        np.testing.assert_array_equal(tm[f], z[f], f)
    rj = _drive(orbit["jax_loaded"], jitter["loc_frames"])
    rt = _drive(orbit["port_loaded"], jitter["loc_frames"])
    assert [(r[0], r[2]) for r in rt] == [(r[0], r[2]) for r in rj]
    assert any(r[0] == 1 for r in rt)
    assert _max_dt(rt, rj) <= 1e-3


def test_global_ba_kernel_like_jax(orbit):
    """The synchronous global BA (loop_closing._global_ba_kernel) of both
    packages on the JAX-saved 8-keyframe map: keyframe 0 and invalid slots
    untouched; poses within 1e-3 and points within 1e-4 relative to the
    scene's 20 m extent (2 mm) of JAX's. Observed: 1.3e-4 and 3.4e-4 m
    (f32 sums over 10 LM iterations of 40 PCG steps; the points move up
    to 1.3 m)."""
    import jax.numpy as jnp
    from orb_slam2_comment_tpu.models import loop_closing as jlc
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models import loop_closing as tlc
    from orb_slam2_comment_tpu_torch.models import map_state as tms
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    z = np.load(orbit["files"]["jax"])
    arrays = {f: z[f] for f in tms.MapState.field_names()}
    jm = jlc._global_ba_kernel(jms.MapState(**{f: jnp.asarray(a) for f, a in arrays.items()}),
                               JConfig(**_cfg_kw()))
    tm = tlc._global_ba_kernel(tms.from_numpy(arrays), TConfig(**_cfg_kw()))
    jp, tp = np.asarray(jm.kf_pose), tm.kf_pose.numpy()
    jx, tx = np.asarray(jm.pt_pos), tm.pt_pos.numpy()
    valid = arrays["kf_valid"].copy()
    np.testing.assert_array_equal(tp[0], arrays["kf_pose"][0])
    np.testing.assert_array_equal(tp[~valid], arrays["kf_pose"][~valid])
    moved = np.abs(jp[valid] - arrays["kf_pose"][valid]).max()
    assert moved > 1e-5   # the BA did move the poses
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
    pv = arrays["pt_valid"]
    np.testing.assert_array_equal(tx[~pv], arrays["pt_pos"][~pv])
    rel = np.abs(tx[pv] - jx[pv]).max() / 20.0
    assert rel < 1e-4, rel
