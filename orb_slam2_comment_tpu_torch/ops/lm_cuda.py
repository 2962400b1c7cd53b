"""Kernel K3: pose-only LM as one CUDA kernel (csrc/pose_lm.cu).

Replaces `orb_slam2_comment_tpu/ops/lm_pallas.py::pose_optimize_pallas`.
`pose_optimize_lm` takes the plain version (`optim.pose_optimize_plain`,
the reference's XLA branch) for CPU tensors and launches the kernel for
CUDA tensors. Like the Pallas kernel, the pose is SO(3)-projected before
the kernel and after it, and inliers are the kernel's final mask & valid.
"""

from __future__ import annotations

import torch

from orb_slam2_comment_tpu_torch import _build
from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops.optim import PoseOptResult, pose_optimize_plain

__all__ = ["pose_optimize_lm", "pose_optimize_plain"]


def pose_optimize_lm(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels, K, bf,
                     rounds: int = C.POSE_OPT_ROUNDS,
                     iters: int = C.POSE_OPT_ITS_PER_ROUND) -> PoseOptResult:
    """K3 wrapper (motion-only BA, Optimizer::PoseOptimization)."""
    if not Xw.is_cuda:
        return pose_optimize_plain(Tcw0, Xw, obs, octave, is_stereo, valid,
                                   inv_sigma2_levels, K, bf, rounds=rounds, iters=iters)
    n = Xw.shape[0]
    f32 = torch.float32
    T = geo.orthonormalize_T(Tcw0.to(f32))
    pose0 = torch.cat([T[:3, :3].reshape(9), T[:3, 3]]).contiguous()
    lvl = torch.clamp(octave, 0, inv_sigma2_levels.shape[0] - 1).long()
    invs2 = inv_sigma2_levels.to(f32)[lvl].contiguous()
    comp = is_stereo.to(f32).contiguous()
    validf = valid.to(f32).contiguous()
    delta = torch.where(is_stereo, C.HUBER_STEREO, C.HUBER_MONO).to(f32).contiguous()
    chi2th = torch.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO).to(f32).contiguous()
    X = Xw.to(f32).contiguous()
    O = obs.to(f32).contiguous()
    for name, t, shape in (("Xw", X, (n, 3)), ("obs", O, (n, 3)), ("pose0", pose0, (12,))):
        _build.require(t, name, f32, shape)
    pose_out = torch.empty(12, dtype=f32, device=X.device)
    mask = torch.empty(n, dtype=f32, device=X.device)
    fx, fy, cx, cy = (float(v) for v in K)
    lib = _build.library()
    err = lib.slam_pose_lm(
        _build.ptr(X), _build.ptr(O), _build.ptr(invs2), _build.ptr(comp),
        _build.ptr(validf), _build.ptr(delta), _build.ptr(chi2th), _build.ptr(pose0),
        _build.ptr(pose_out), _build.ptr(mask), n, fx, fy, cx, cy, float(bf),
        int(rounds), int(iters), int(C.POSE_OPT_ROBUST_ROUNDS), _build.stream_of(X))
    _build.check(err, "slam_pose_lm")
    pose_optimize_lm.launches += 1
    Tcw = geo.orthonormalize_T(geo.make_T(pose_out[:9].reshape(3, 3), pose_out[9:12]))
    inliers = (mask > 0) & valid
    return PoseOptResult(Tcw=Tcw, inliers=inliers, n_inliers=torch.sum(inliers).to(torch.int32))


pose_optimize_lm.launches = 0
