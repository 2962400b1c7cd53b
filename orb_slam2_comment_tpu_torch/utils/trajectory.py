"""Trajectory evaluation: camera centres, ATE RMSE and Umeyama alignment.

The port's own copy of the evaluation part of the JAX package's
`utils/trajectory.py` (its TUM/KITTI writers are not ported yet);
tests/test_torch_system.py holds the two equal.
"""

from __future__ import annotations

import numpy as np


def _twc(Tcw: np.ndarray):
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    return R.T, -R.T @ t


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
