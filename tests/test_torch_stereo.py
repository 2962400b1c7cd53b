"""The port's stereo path against the JAX package on the CPU:
`stereo_match` on a rendered pair, its median helper against numpy, and
System.track_stereo over a forward synthetic sequence in both packages,
plus the port's determinism on it."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_FRAMES = 10
N_RERUN = 6


def _cfg_kw():
    from orb_slam2_comment_tpu.utils import synthetic as syn

    K = syn.DEFAULT_K
    return dict(sensor="stereo", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                bf=K[0] * syn.DEFAULT_BASELINE, n_features=600, n_levels=4,
                max_keyframes=32, max_points=8192, grow_capacity=False, match_th_scale=1.5)


def test_stereo_match_like_jax():
    """The rendered pair of tests/test_matching.py:138-149 (600 x 4): the
    matched sets differ in <= 1% of matches; where both matched, u_right
    within 1e-3 px and depth within 1e-4 relative (the resized levels
    round differently in the two frameworks)."""
    import jax.numpy as jnp
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu.ops import stereo as jst
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.ops import orb as torb
    from orb_slam2_comment_tpu_torch.ops import stereo as tst
    from orb_slam2_comment_tpu_torch.utils.config import ORBConfig

    K, HW, b = syn.DEFAULT_K, syn.DEFAULT_HW, syn.DEFAULT_BASELINE
    scene = syn.make_scene(n_points=350, seed=9)
    T = np.eye(4, dtype=np.float32)
    img_l = syn.render(scene, T, K, HW, noise=1.0, seed=1)
    img_r = syn.render(scene, T, K, HW, baseline=b, noise=1.0, seed=2)
    jcfg = jorb.ORBConfig(n_features=600, n_levels=4)
    fl, pl = jorb.extract(jnp.asarray(img_l), jcfg)
    fr, pr = jorb.extract(jnp.asarray(img_r), jcfg)
    ju, jz = jst.stereo_match(fl, fr, pl, pr, tuple(jcfg.scales), K[0] * b, min_z=2 * b,
                              n_levels=4)
    tcfg = ORBConfig(n_features=600, n_levels=4)
    gl, _, ql = torb._extract_impl(torch.from_numpy(img_l).float(), tcfg, HW)
    gr, _, qr = torb._extract_impl(torch.from_numpy(img_r).float(), tcfg, HW)
    tu, tz = tst.stereo_match(gl, gr, ql, qr, tcfg.level_sizes(*HW), tuple(tcfg.scales),
                              K[0] * b, min_z=2 * b, n_levels=4)
    ju, jz, tu, tz = np.asarray(ju), np.asarray(jz), tu.numpy(), tz.numpy()
    jm, tm = ju >= 0, tu >= 0
    assert jm.sum() > 80
    assert (jm != tm).sum() <= 0.01 * jm.sum(), ((jm != tm).sum(), jm.sum())
    both = jm & tm
    assert np.abs(tu[both] - ju[both]).max() <= 1e-3
    assert (np.abs(tz[both] - jz[both]) / jz[both]).max() <= 1e-4


@pytest.mark.parametrize("n", [7, 8, 0])
def test_nanmedian_like_numpy(n):
    """Odd and even counts of finite values among NaNs, and all NaN."""
    from orb_slam2_comment_tpu_torch.ops.stereo import nanmedian

    r = np.random.default_rng(n)
    x = np.full(20, np.nan, np.float32)
    x[r.choice(20, n, replace=False)] = r.uniform(0, 500, n).astype(np.float32)
    got = nanmedian(torch.from_numpy(x)).item()
    if n == 0:
        assert np.isnan(got)
    else:
        assert got == np.nanmedian(x)


def _run(system, frames):
    recs = []
    for f in frames:
        out = system.track_stereo(f["image"], f["image_right"], f["timestamp"])
        recs.append((out.state, out.n_inliers, out.created_kf,
                     None if out.Tcw is None else np.asarray(out.Tcw, np.float64)))
    system.shutdown()
    return recs


@pytest.fixture(scope="module")
def runs():
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=N_FRAMES, step=0.3)
    frames = list(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, stereo=True))
    jrec = _run(JSystem(JConfig(**_cfg_kw()), enable_loop_closing=False), frames)
    ts = TSystem(TConfig(**_cfg_kw()), enable_loop_closing=False, device="cpu")
    trec = _run(ts, frames)
    trec2 = _run(TSystem(TConfig(**_cfg_kw()), enable_loop_closing=False, device="cpu"),
                 frames[:N_RERUN])
    return frames, jrec, trec, trec2


@pytest.fixture(scope="module")
def forced(runs):
    """The port over the same frames with its pyramid resize replaced by
    the JAX package's of the same input level (tests/lockstep_run.py);
    JAX's records are the `runs` fixture's."""
    from lockstep_run import jax_resize_level
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.ops import orb as torb
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    frames = runs[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torb, "_resize_level", jax_resize_level)
        return _run(TSystem(TConfig(**_cfg_kw()), enable_loop_closing=False, device="cpu"),
                    frames)


def test_stereo_lockstep_on_the_jax_pyramid(runs, forced):
    """On JAX's pyramid the port extracts JAX's features, so every frame
    has JAX's state and keyframe decision; inliers within 2 and
    translations within 2e-4 m of JAX's (measured over these 10 frames: 1
    inlier and 9.9e-5 m, at frame 2, where the port on its own pyramid
    also parts by 1.0e-4 m: the pose LM's f32 rounding)."""
    _, jrec, _, _ = runs
    assert [r[0] for r in forced] == [r[0] for r in jrec]
    assert [r[2] for r in forced] == [r[2] for r in jrec]
    d_inl = max(abs(a[1] - b[1]) for a, b in zip(forced, jrec))
    d_t = max(np.abs(a[3][:3, 3] - b[3][:3, 3]).max() for a, b in zip(forced, jrec))
    assert d_inl <= 2, d_inl
    assert d_t <= 2e-4, d_t


def test_stereo_system_tracks_like_jax(runs):
    """Every frame tracked in both, keyframes at the same frames,
    translations within 1 mm, inliers within 5, ATE within 0.5 mm of
    JAX's (on the CPU JAX makes keyframes at frames 0, 4 and 8, ATE 7.5
    mm)."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    frames, jrec, trec, _ = runs
    assert all(r[0] == 1 for r in jrec) and all(r[0] == 1 for r in trec)
    assert [r[2] for r in trec] == [r[2] for r in jrec]
    assert sum(r[2] for r in trec) >= 3
    dt = max(np.abs(a[3][:3, 3] - b[3][:3, 3]).max() for a, b in zip(trec, jrec))
    assert dt <= 1e-3, dt
    assert max(abs(a[1] - b[1]) for a, b in zip(trec, jrec)) <= 5
    gt = [f["Tcw_gt"] for f in frames]
    ate_t = ate_rmse([r[3] for r in trec], gt)
    ate_j = ate_rmse([r[3] for r in jrec], gt)
    assert ate_t <= ate_j + 5e-4, (ate_t, ate_j)


def test_stereo_system_is_deterministic(runs):
    _, _, trec, trec2 = runs
    for a, b in zip(trec[:N_RERUN], trec2):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("sensor", ["stereo", "monocular"])
def test_sensor_systems_need_cuda_unless_told_cpu(sensor):
    """A stereo or monocular System defaults to the card and raises without
    one, as RGB-D does; on the CPU it builds, and its track_* entries
    refuse frames of another sensor."""
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    cfg = SlamConfig(**dict(_cfg_kw(), sensor=sensor, max_keyframes=8, max_points=1024))
    if torch.cuda.is_available():
        assert System(cfg).tracker.map.kf_pose.is_cuda
    else:
        with pytest.raises(RuntimeError):
            System(cfg)
    s = System(cfg, device="cpu")
    img = np.zeros((cfg.height, cfg.width), np.uint8)
    with pytest.raises(ValueError):
        s.track_rgbd(img, img, 0.0)
    with pytest.raises(ValueError):
        (s.track_monocular(img, 0.0) if sensor == "stereo" else s.track_stereo(img, img, 0.0))
