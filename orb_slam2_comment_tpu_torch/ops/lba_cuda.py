"""Kernel K4: one local-BA linearization as CUDA kernels (csrc/lba_build.cu).

Replaces `orb_slam2_comment_tpu/ops/lba_pallas.py::build_system` (and its
`prep_problem`). `prep_problem` runs once per BA window: besides the
per-observation weights it sorts the observations by point, stably, so the
kernel's per-point sums walk a fixed order (no float atomics; reruns are
bit-identical). `build_system` takes the plain version
(`optim.build_system_plain`) for CPU tensors and launches the kernels for
CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from orb_slam2_comment_tpu_torch import _build
from orb_slam2_comment_tpu_torch.ops.optim import BAProblem, LBASystem, build_system_plain

__all__ = ["LBAPrep", "prep_problem", "build_system", "build_system_plain"]

_NCAM = 44  # per-camera sums: 36 Hcc + 6 bc + cost + n_in


@dataclass
class LBAPrep:
    """Per-window static tensors of one BA problem."""

    prob: BAProblem
    inv_sigma2_levels: torch.Tensor
    F: int
    N_per: int
    inv_s2: torch.Tensor    # [O] f32 information scale per observation
    urmask: torch.Tensor    # [O] f32 1 for stereo observations
    obs_pt: torch.Tensor    # [O] int32, clipped to [0, Np)
    cam_free: torch.Tensor  # [Nc] int32
    perm: torch.Tensor      # [O] int32 valid observations sorted by point, then the rest
    seg: torch.Tensor       # [Np + 1] int32 segment starts in perm


def prep_problem(prob: BAProblem, inv_sigma2_levels, F: int) -> LBAPrep:
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    O = prob.obs_cam.shape[0]
    lvl = torch.clamp(prob.obs_oct, 0, inv_sigma2_levels.shape[0] - 1).long()
    obs_pt = torch.clamp(prob.obs_pt, 0, Np - 1).to(torch.int32).contiguous()
    # observations outside the window's valid set (padding, which the
    # window clips onto point 0) sort past the last point and are never
    # walked: they contribute exactly zero
    key = torch.where(prob.obs_valid, obs_pt, Np)
    perm = torch.sort(key, stable=True).indices.to(torch.int32).contiguous()
    counts = torch.zeros(Np + 1, dtype=torch.int32, device=obs_pt.device)
    counts = counts.index_add_(0, key.long(), torch.ones_like(obs_pt))[:Np]
    seg = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(torch.int32)])
    return LBAPrep(
        prob=prob,
        inv_sigma2_levels=inv_sigma2_levels,
        F=F,
        N_per=O // Nc,
        inv_s2=inv_sigma2_levels.to(torch.float32)[lvl].contiguous(),
        urmask=prob.obs_stereo.to(torch.float32).contiguous(),
        obs_pt=obs_pt,
        cam_free=((~prob.cam_fixed) & prob.cam_valid).to(torch.int32).contiguous(),
        perm=perm,
        seg=seg.contiguous(),
    )


def build_system(prep: LBAPrep, cam_T, pts, obs_ok, robust: bool, K, bf) -> LBASystem:
    """K4 wrapper: the normal-equation blocks at (cam_T, pts)."""
    prob = prep.prob
    if not cam_T.is_cuda:
        return build_system_plain(prob, prep.inv_sigma2_levels, prep.F, cam_T, pts,
                                  obs_ok, robust, K, bf)
    f32 = torch.float32
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    O = prob.obs_cam.shape[0]
    F = prep.F
    cam = cam_T.to(f32).reshape(Nc, 16).contiguous()
    P = pts.to(f32).contiguous()
    uvr = prob.obs_uvr.to(f32).contiguous()
    wbase = (prep.inv_s2 * obs_ok.to(f32)).contiguous()
    _build.require(cam, "cam_T", f32, (Nc, 16))
    _build.require(P, "pts", f32, (Np, 3))
    _build.require(uvr, "obs_uvr", f32, (O, 3))
    _build.require(prep.perm, "perm", torch.int32, (O,))
    _build.require(prep.seg, "seg", torch.int32, (Np + 1,))
    if prep.N_per * Nc != O:
        raise ValueError("observations must be camera-major: O = Nc * N_per")
    cam_out = torch.empty(Nc, _NCAM, dtype=f32, device=cam.device)
    pp = torch.empty(12, Np, dtype=f32, device=cam.device)
    E = torch.empty(F, 18, Np, dtype=f32, device=cam.device)
    fx, fy, cx, cy = (float(v) for v in K)
    lib = _build.library()
    err = lib.slam_lba_build(
        _build.ptr(cam), _build.ptr(P), _build.ptr(uvr), _build.ptr(wbase),
        _build.ptr(prep.urmask), _build.ptr(prep.obs_pt), _build.ptr(prep.cam_free),
        _build.ptr(prep.perm), _build.ptr(prep.seg), _build.ptr(cam_out), _build.ptr(pp),
        _build.ptr(E), Nc, Np, prep.N_per, F, int(bool(robust)), fx, fy, cx, cy,
        float(bf), _build.stream_of(cam))
    _build.check(err, "slam_lba_build")
    build_system.launches += 1
    return LBASystem(
        Hcc=cam_out[:F, :36].reshape(F, 6, 6),
        bc=cam_out[:F, 36:42],
        Hpp9=pp[:9],
        bp3=pp[9:12],
        E=E.reshape(F, 6, 3, Np),
        cost=torch.sum(cam_out[:, 42]),
        n_in=torch.sum(cam_out[:, 43]).to(torch.int32),
    )


build_system.launches = 0
