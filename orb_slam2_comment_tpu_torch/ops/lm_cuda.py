"""Kernel K3: pose-only LM as one CUDA kernel (csrc/pose_lm.cu).

Replaces `orb_slam2_comment_tpu/ops/lm_pallas.py::pose_optimize_pallas`.
`pose_optimize_lm` takes the plain version (`optim.pose_optimize_plain`,
the reference's XLA branch) for CPU tensors and launches the kernel for
CUDA tensors. Like the Pallas kernel, the pose is SO(3)-projected before
the kernel and after it, and inliers are the kernel's final mask & valid.

With a leading batch axis (Tcw0 [B,4,4], per-edge inputs [B,N,...]) one
launch solves B independent poses, one block each (relocalization's
candidates); the plain version then loops over B. Single launches count in
`pose_optimize_lm.launches`, batched ones in `.batched_launches`.
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
    """K3 wrapper (motion-only BA, Optimizer::PoseOptimization), for one
    pose (Tcw0 [4,4], Xw [N,3]) or a batch (Tcw0 [B,4,4], Xw [B,N,3])."""
    batched = Tcw0.dim() == 3
    if not Xw.is_cuda:
        if not batched:
            return pose_optimize_plain(Tcw0, Xw, obs, octave, is_stereo, valid,
                                       inv_sigma2_levels, K, bf, rounds=rounds, iters=iters)
        res = [pose_optimize_plain(Tcw0[b], Xw[b], obs[b], octave[b], is_stereo[b], valid[b],
                                   inv_sigma2_levels, K, bf, rounds=rounds, iters=iters)
               for b in range(Tcw0.shape[0])]
        return PoseOptResult(*(torch.stack(f) for f in zip(*res)))
    if not batched:
        Tcw0, Xw, obs, octave, is_stereo, valid = (
            t[None] for t in (Tcw0, Xw, obs, octave, is_stereo, valid))
    B, n = Xw.shape[0], Xw.shape[1]
    f32 = torch.float32
    T = geo.orthonormalize_T(Tcw0.to(f32))
    pose0 = torch.cat([T[:, :3, :3].reshape(B, 9), T[:, :3, 3]], dim=1).contiguous()
    lvl = torch.clamp(octave, 0, inv_sigma2_levels.shape[0] - 1).long()
    invs2 = inv_sigma2_levels.to(f32)[lvl].contiguous()
    comp = is_stereo.to(f32).contiguous()
    validf = valid.to(f32).contiguous()
    delta = torch.where(is_stereo, C.HUBER_STEREO, C.HUBER_MONO).to(f32).contiguous()
    chi2th = torch.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO).to(f32).contiguous()
    X = Xw.to(f32).contiguous()
    O = obs.to(f32).contiguous()
    for name, t, shape in (("Xw", X, (B, n, 3)), ("obs", O, (B, n, 3)), ("pose0", pose0, (B, 12)),
                           ("invs2", invs2, (B, n)), ("comp", comp, (B, n)),
                           ("valid", validf, (B, n)), ("delta", delta, (B, n)),
                           ("chi2th", chi2th, (B, n))):
        _build.require(t, name, f32, shape)
    pose_out = torch.empty((B, 12), dtype=f32, device=X.device)
    mask = torch.empty((B, n), dtype=f32, device=X.device)
    fx, fy, cx, cy = (float(v) for v in K)
    lib = _build.library()
    err = lib.slam_pose_lm(
        _build.ptr(X), _build.ptr(O), _build.ptr(invs2), _build.ptr(comp),
        _build.ptr(validf), _build.ptr(delta), _build.ptr(chi2th), _build.ptr(pose0),
        _build.ptr(pose_out), _build.ptr(mask), B, n, fx, fy, cx, cy, float(bf),
        int(rounds), int(iters), int(C.POSE_OPT_ROBUST_ROUNDS), _build.stream_of(X))
    _build.check(err, "slam_pose_lm")
    if batched:
        pose_optimize_lm.batched_launches += 1
    else:
        pose_optimize_lm.launches += 1
    Tcw = geo.orthonormalize_T(geo.make_T(pose_out[:, :9].reshape(B, 3, 3), pose_out[:, 9:12]))
    inliers = (mask > 0) & valid
    res = PoseOptResult(Tcw=Tcw, inliers=inliers,
                        n_inliers=torch.sum(inliers, dim=-1).to(torch.int32))
    return res if batched else PoseOptResult(*(f[0] for f in res))


pose_optimize_lm.launches = 0
pose_optimize_lm.batched_launches = 0
