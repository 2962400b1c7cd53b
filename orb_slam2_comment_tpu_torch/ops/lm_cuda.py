"""Kernel K3: pose-only LM as one CUDA kernel (csrc/pose_lm.cu).

Replaces `orb_slam2_comment_tpu/ops/lm_pallas.py::pose_optimize_pallas`.
`pose_optimize_lm` takes the plain version (`optim.pose_optimize_plain`,
the reference's XLA branch) for CPU tensors and launches the kernel for
CUDA tensors. The kernel does all of the call's work: the SO(3)
projection of the start and final poses, the level lookup, the 4 x 10 LM
iterations and the inlier count, so the wrapper only checks its arguments,
allocates the three outputs and launches once.

With a leading batch axis (Tcw0 [B,4,4], per-edge inputs [B,N,...]) one
launch solves B independent poses, one block each (relocalization's
candidates); a per-edge input shared by every pose may be broadcast
(`expand`, batch stride 0). The plain version then loops over B. Single
launches count in `pose_optimize_lm.launches`, batched ones in
`.batched_launches`.
"""

from __future__ import annotations

import torch

from orb_slam2_comment_tpu_torch import _build
from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops.optim import PoseOptResult, pose_optimize_plain

__all__ = ["pose_optimize_lm", "pose_optimize_plain"]


def pose_optimize_lm(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels, K, bf,
                     rounds: int = C.POSE_OPT_ROUNDS,
                     iters: int = C.POSE_OPT_ITS_PER_ROUND) -> PoseOptResult:
    """K3 wrapper (motion-only BA, Optimizer::PoseOptimization), for one
    pose (Tcw0 [4,4], Xw [N,3]) or a batch (Tcw0 [B,4,4], Xw [B,N,3]).
    On the card: Tcw0, Xw, obs and inv_sigma2_levels float32, octave int32,
    is_stereo and valid bool."""
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
    B, n, strides = launch_layout(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels)
    for name, t in (("Tcw0", Tcw0), ("obs", obs), ("octave", octave), ("is_stereo", is_stereo),
                    ("valid", valid), ("inv_sigma2_levels", inv_sigma2_levels)):
        if t.device != Xw.device:
            raise ValueError(f"{name}: on {t.device}, Xw on {Xw.device}")
    Tcw = torch.empty((B, 4, 4), dtype=torch.float32, device=Xw.device)
    inliers = torch.empty((B, n), dtype=torch.uint8, device=Xw.device)
    n_inliers = torch.empty((B,), dtype=torch.int32, device=Xw.device)
    fx, fy, cx, cy = (float(v) for v in K)
    lib = _build.library()
    # the bool masks reach the kernel as bytes: a bool tensor holds 0 or 1 per byte
    err = lib.slam_pose_lm(
        _build.ptr(Tcw0), _build.ptr(Xw), _build.ptr(obs), _build.ptr(octave),
        _build.ptr(is_stereo), _build.ptr(valid), _build.ptr(inv_sigma2_levels),
        _build.ptr(Tcw), _build.ptr(inliers), _build.ptr(n_inliers), B, n,
        inv_sigma2_levels.shape[0], *strides, fx, fy, cx, cy, float(bf), int(rounds),
        int(iters), int(C.POSE_OPT_ROBUST_ROUNDS), _build.stream_of(Xw))
    _build.check(err, "slam_pose_lm")
    if batched:
        pose_optimize_lm.batched_launches += 1
        return PoseOptResult(Tcw=Tcw, inliers=inliers.view(torch.bool), n_inliers=n_inliers)
    pose_optimize_lm.launches += 1
    return PoseOptResult(Tcw=Tcw[0], inliers=inliers[0].view(torch.bool),
                         n_inliers=n_inliers[0])


def launch_layout(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels):
    """(B, n, batch strides of Xw, obs, octave, is_stereo, valid) of a
    batched call, after checking what the kernel reads: float32 poses,
    points, observations and level weights, int32 octaves, bool flags,
    packed trailing axes. A per-edge input may be broadcast over the batch
    (stride 0)."""
    B, n = Xw.shape[0], Xw.shape[1]
    f32 = torch.float32
    if not (Tcw0.dtype == f32 and tuple(Tcw0.shape) == (B, 4, 4) and Tcw0.is_contiguous()):
        raise ValueError(f"Tcw0: expected contiguous float32 [{B}, 4, 4], got "
                         f"{Tcw0.dtype} {tuple(Tcw0.shape)} strides {Tcw0.stride()}")
    if not (inv_sigma2_levels.dtype == f32 and inv_sigma2_levels.dim() == 1
            and inv_sigma2_levels.is_contiguous()):
        raise ValueError("inv_sigma2_levels: expected a contiguous float32 vector")
    strides = [_build.batch_stride(t, name, dt, shape) for t, name, dt, shape in (
        (Xw, "Xw", f32, (B, n, 3)), (obs, "obs", f32, (B, n, 3)),
        (octave, "octave", torch.int32, (B, n)), (is_stereo, "is_stereo", torch.bool, (B, n)),
        (valid, "valid", torch.bool, (B, n)))]
    return B, n, strides


pose_optimize_lm.launches = 0
pose_optimize_lm.batched_launches = 0
