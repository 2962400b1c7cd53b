"""Trajectory export and evaluation — the port of the JAX package's
`utils/trajectory.py`.

Byte-format-compatible writers for the reference's savers:
- save_tum  <- System::SaveTrajectoryTUM (src/System.cc:322-377):
  'timestamp tx ty tz qx qy qz qw' of the camera-to-world transform.
- save_kitti <- System::SaveTrajectoryKITTI (src/System.cc:419-472):
  3x4 row-major camera-to-world matrix per line.

The quaternion comes from the port's own `geometry.rot_to_quat` in f32, as
the JAX package computes it; the evaluation part (camera centres, ATE,
Umeyama) is a copy that tests/test_torch_system.py holds equal.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.ops.geometry import rot_to_quat


def _twc(Tcw: np.ndarray):
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    return R.T, -R.T @ t


def _rot_to_quat(R):
    # (x, y, z, w), matching the TUM convention used by the reference's
    # Converter::toQuaternion output ordering (System.cc:371-374)
    return rot_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def save_tum(path: str, timestamps, poses_cw):
    with open(path, "w") as f:
        for ts, Tcw in zip(timestamps, poses_cw):
            Rwc, twc = _twc(np.asarray(Tcw))
            q = _rot_to_quat(Rwc)
            f.write(
                f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_kitti(path: str, poses_cw):
    with open(path, "w") as f:
        for Tcw in poses_cw:
            Rwc, twc = _twc(np.asarray(Tcw))
            M = np.concatenate([Rwc, twc[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def camera_centers(poses_cw, align_first=True):
    """[N,3] camera centers; optionally expressed relative to frame 0."""
    Ts = [np.asarray(T) for T in poses_cw]
    if align_first:
        T0inv = np.linalg.inv(Ts[0])
        Ts = [T @ T0inv for T in Ts]
    return np.stack([_twc(T)[1] for T in Ts])


def ate_rmse(poses_est, poses_gt, align="first"):
    """Absolute trajectory error (RMSE of camera-center differences).

    align='first' anchors both at their first pose; align='umeyama' solves
    the best rigid alignment (needed for monocular, which also gets scale).
    """
    c_est = camera_centers(poses_est, align_first=(align == "first"))
    c_gt = camera_centers(poses_gt, align_first=(align == "first"))
    if align == "umeyama":
        c_est, _ = umeyama_align(c_est, c_gt, with_scale=True)
    d = c_est - c_gt
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def umeyama_align(src, dst, with_scale=False):
    """Least-squares similarity alignment src -> dst (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs * xs).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    aligned = (s * (R @ src.T)).T + t
    return aligned, (s, R, t)
