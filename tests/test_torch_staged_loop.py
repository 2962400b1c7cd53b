"""The JAX package's own staged configuration against the port on the CPU:
the orbit of tests/test_loop_closing.py:16-50 (600 x 4, 80 keyframes,
24576 points, `fused_tracking=False`, loop closing on) through
System.track_rgbd in both packages. Loop detection, the loop correction
without a device state and the background GBA run in the staged mode."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def orbit_runs():
    """Per-frame records (keyframe flag, pose or None) and the final
    system of each package over the orbit with its 12-frame overshoot."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    K = syn.DEFAULT_K
    kw = dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
              bf=K[0] * syn.DEFAULT_BASELINE, n_features=600, n_levels=4,
              max_keyframes=80, max_points=24576, match_th_scale=1.5,
              fused_tracking=False)
    scene = syn.make_scene(n_points=1800, seed=0, extent=(14.0, 8.0, 20.0))
    base = syn.make_trajectory("orbit", n_frames=44)
    frames = list(syn.render_sequence(scene, np.concatenate([base, base[:12]]),
                                      K=syn.DEFAULT_K, depth=True))
    res = []
    for system in (JSystem(JConfig(**kw)), TSystem(TConfig(**kw), device="cpu")):
        recs = []
        for f in frames:
            out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
            recs.append((bool(out.created_kf),
                         None if out.Tcw is None else np.asarray(out.Tcw, np.float64)))
        system.shutdown()
        res.append((system, recs))
    return frames, res


def test_staged_orbit_closes_the_same_loop_as_jax(orbit_runs):
    """Every frame tracked in both, keyframes on the same frames, the
    same first loop pair; the port's background GBA was applied and its
    tracker kept no device state."""
    _, ((js, jrec), (ts, trec)) = orbit_runs
    assert all(r[1] is not None for r in jrec) and all(r[1] is not None for r in trec)
    assert [r[0] for r in trec] == [r[0] for r in jrec]
    assert ts.tracker.n_kfs == js.tracker.n_kfs
    assert ts.n_loops >= 1 and js.n_loops >= 1
    tpair = tuple(int(x) for x in ts.loop_closer.loop_edges[0][:2])
    jpair = tuple(int(x) for x in js.loop_closer.loop_edges[0][:2])
    assert tpair == jpair, (tpair, jpair)
    assert ts.loop_closer.n_gba_applied >= 1
    assert ts.tracker.ds is None


def test_staged_orbit_poses_like_jax(orbit_runs):
    """Per-frame translations within 5 mm of JAX's and ATEs within 5 mm of
    each other (tests/test_torch_system.py's orbit bar; the loop
    correction and the GBA spread LAPACK's and XLA's f32 rounding over
    the map: observed at most 2.5 mm), ATE < 10 cm as
    tests/test_loop_closing.py:50 holds JAX."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    frames, ((_, jrec), (_, trec)) = orbit_runs
    dt = max(np.abs(a[1][:3, 3] - b[1][:3, 3]).max() for a, b in zip(trec, jrec))
    assert dt < 5e-3, dt
    gt = [f["Tcw_gt"] for f in frames]
    tate, jate = ate_rmse([r[1] for r in trec], gt), ate_rmse([r[1] for r in jrec], gt)
    assert abs(tate - jate) < 5e-3, (tate, jate)
    assert tate < 0.10
