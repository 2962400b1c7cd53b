"""The port's head-to-head harness (orb_slam2_comment_tpu_torch.examples.
head_to_head) on the CPU: its trajectory readers and evaluators against
tools/head_to_head.py's on the same files, and run_ours on a 10-frame head
of the desk sequence with `--device cpu`."""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import head_to_head as J  # noqa: E402

from orb_slam2_comment_tpu_torch.examples import head_to_head as T  # noqa: E402


def _poses(n, seed):
    """n camera-to-world poses along a wobbling path."""
    from orb_slam2_comment_tpu_torch.ops import geometry as geo

    r = np.random.default_rng(seed)
    xi = np.cumsum(r.normal(0, 0.05, (n, 6)), axis=0).astype(np.float32)
    return geo.se3_exp(torch.from_numpy(xi)).double().numpy()


def _write_tum(path, ts, Twc, skip_every=0):
    from orb_slam2_comment_tpu_torch.ops.geometry import rot_to_quat

    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, (t, T_) in enumerate(zip(ts, Twc)):
            if skip_every and i % skip_every == 0:
                continue
            q = np.asarray(rot_to_quat(torch.from_numpy(T_[:3, :3])))
            f.write(f"{t:.6f} " + " ".join(f"{v:.7f}" for v in (*T_[:3, 3], *q)) + "\n")


def _write_kitti(path, Twc):
    with open(path, "w") as f:
        for T_ in Twc:
            f.write(" ".join(f"{v:.9e}" for v in T_[:3, :4].reshape(-1)) + "\n")


@pytest.fixture(scope="module")
def traj_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("h2h")
    gt, est = _poses(40, 0), _poses(40, 0)
    est[:, :3, 3] = est[:, :3, 3] * 1.3 + np.random.default_rng(1).normal(0, 0.01, (40, 3))
    ts = 1000.0 + np.arange(40) / 30.0
    _write_tum(d / "gt.txt", ts, gt)
    _write_tum(d / "est.txt", ts + 0.004, est, skip_every=7)
    _write_kitti(d / "gt_kitti.txt", gt)
    _write_kitti(d / "est_kitti.txt", est[:35])
    return d


@pytest.mark.parametrize("fn", ["load_tum_traj", "load_kitti_traj"])
def test_readers_like_reference(traj_files, fn):
    name = "est.txt" if fn == "load_tum_traj" else "est_kitti.txt"
    a, b = getattr(T, fn)(str(traj_files / name)), getattr(J, fn)(str(traj_files / name))
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        np.testing.assert_array_equal(x, y)


def test_associate_like_reference(traj_files):
    ts_e, _ = T.load_tum_traj(str(traj_files / "est.txt"))
    ts_g, _ = T.load_tum_traj(str(traj_files / "gt.txt"))
    for dt in (0.002, 0.02):
        a, b = T.associate(ts_e, ts_g, dt), J.associate(ts_e, ts_g, dt)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("with_scale", [False, True])
def test_evaluators_like_reference(traj_files, with_scale):
    d = traj_files
    a = T.eval_tum(str(d / "est.txt"), str(d / "gt.txt"), with_scale)
    b = J.eval_tum(str(d / "est.txt"), str(d / "gt.txt"), with_scale)
    assert a == b and a["n_poses"] == 34
    a = T.eval_kitti(str(d / "est_kitti.txt"), str(d / "gt_kitti.txt"), 40, with_scale)
    b = J.eval_kitti(str(d / "est_kitti.txt"), str(d / "gt_kitti.txt"), 40, with_scale)
    assert a == b and a["coverage"] == 35 / 40
    c = np.random.default_rng(2).normal(size=(20, 3))
    assert T.evaluate_ate(c, c + 0.1, with_scale) == J.evaluate_ate(c, c + 0.1, with_scale)


def test_sequences_like_reference():
    """Every sequence reads a folder that examples/make_datasets.py renders."""
    from orb_slam2_comment_tpu_torch.examples import make_datasets as md

    assert T.SEQS == J.SEQS
    assert {v.get("dir", k) for k, v in T.SEQS.items()} <= set(md.ALL)


@pytest.fixture(scope="module")
def desk_head(tmp_path_factory):
    """The first 10 frames of the desk sequence (tools/make_datasets.py's
    scene, trajectory and settings), rendered by the port."""
    from orb_slam2_comment_tpu_torch.examples import make_datasets as md
    from orb_slam2_comment_tpu_torch.utils import render as rr

    data = tmp_path_factory.mktemp("synth")
    out = data / "desk"
    scene = rr.make_room(seed=13, size=(7.0, 3.0, 7.0), n_boxes=6)
    poses = rr.desk_trajectory(400, seed=3)[:10]
    # in this process: a worker pool would fork a process that JAX's threads run in
    rr.write_tum_rgbd(str(out), scene, poses, md.K_TUM, md.HW_TUM, fps=30.0, workers=1)
    rr.write_settings_yaml(str(out / "settings.yaml"), md.K_TUM, md.HW_TUM, fps=30.0, bf=40.0,
                           depth_factor=rr.DEPTH_FACTOR_TUM, n_features=1000)
    return data


def test_run_ours_on_the_desk_head(desk_head, tmp_path, monkeypatch):
    """run_ours drives the port's rgbd_tum twin in a new process (2 runs,
    prestaged, --device cpu): every frame tracked in the timed run, every
    frame in the trajectory, ATE under 15 mm (the desk-head bound of
    chip_smoke.py), and the timing lines read."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # the rgbd_tum process shares the CPU
    r = T.run_ours("desk", str(tmp_path / "ours"), repeat=2, data=str(desk_head), device="cpu")
    assert r["rc"] == 0, r["log_tail"]
    assert r["tracked_frames"] == r["frames"] == 10
    assert r["n_poses"] == 10 and r["coverage"] == 1.0
    assert r["ate_rmse_m"] < 0.015
    assert r["runs_in_process"] == 2 and r["loops"] == 0
    for k in ("median_track_s", "mean_track_s", "p99_track_s", "fps", "warm_wall_s",
              "dispatch_fps"):
        assert r[k] > 0, k
    # the headline fps is the warm run's frames over its wall, drain included
    assert abs(r["fps"] - 10 / r["warm_wall_s"]) < 0.1
