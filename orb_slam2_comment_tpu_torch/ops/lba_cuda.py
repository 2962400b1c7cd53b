"""Kernel K4: one local-BA linearization as one CUDA kernel (csrc/lba_build.cu).

Replaces `orb_slam2_comment_tpu/ops/lba_pallas.py::build_system` (and its
`prep_problem`). `prep_problem` runs once per BA window: besides the
per-observation level weights it sorts the observations by point, stably,
so the kernel's per-point sums walk a fixed order (no float atomics;
reruns are bit-identical), and it allocates the launch's scratch and
completion counters. `build_system` takes the plain version
(`optim.build_system_plain`) for CPU tensors and launches the kernel for
CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from orb_slam2_comment_tpu_torch import _build
from orb_slam2_comment_tpu_torch.ops.optim import BAProblem, LBASystem, build_system_plain
from orb_slam2_comment_tpu_torch.utils import trace

__all__ = ["LBAPrep", "prep_problem", "build_system", "build_system_plain"]

CHUNKS = 8  # camera blocks per camera in a launch (csrc/lba_build.cu)


@dataclass
class LBAPrep:
    """Per-window static tensors of one BA problem."""

    prob: BAProblem
    inv_sigma2_levels: torch.Tensor
    F: int
    N_per: int
    uvr: torch.Tensor       # [O, 3] f32 observations
    inv_s2: torch.Tensor    # [O] f32 information scale per observation
    stereo: torch.Tensor    # [O] bool
    obs_pt: torch.Tensor    # [O] int32, clipped to [0, Np)
    cam_free: torch.Tensor  # [Nc] bool
    perm: torch.Tensor      # [O] int32 valid observations sorted by point, then the rest
    seg: torch.Tensor       # [Np + 1] int32 segment starts in perm
    scratch: torch.Tensor   # [Nc * CHUNKS * 32 + 2 * Nc] f32 per-chunk and per-camera sums
    tickets: torch.Tensor   # [Nc + 1] int32 completion counters, 0 between calls


def prep_problem(prob: BAProblem, inv_sigma2_levels, F: int) -> LBAPrep:
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    O = prob.obs_cam.shape[0]
    if O % Nc:
        raise ValueError("observations must be camera-major: O = Nc * N_per")
    dev = prob.cam_T.device
    lvl = torch.clamp(prob.obs_oct, 0, inv_sigma2_levels.shape[0] - 1).long()
    obs_pt = torch.clamp(prob.obs_pt, 0, Np - 1).to(torch.int32).contiguous()
    # observations outside the window's valid set (padding, which the
    # window clips onto point 0) sort past the last point and are never
    # walked: they contribute exactly zero
    key = torch.where(prob.obs_valid, obs_pt, Np)
    perm = torch.sort(key, stable=True).indices.to(torch.int32).contiguous()
    counts = torch.zeros(Np + 1, dtype=torch.int32, device=dev)
    counts = counts.index_add_(0, key.long(), torch.ones_like(obs_pt))[:Np]
    seg = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(torch.int32)])
    return LBAPrep(
        prob=prob,
        inv_sigma2_levels=inv_sigma2_levels,
        F=F,
        N_per=O // Nc,
        uvr=prob.obs_uvr.to(torch.float32).contiguous(),
        inv_s2=inv_sigma2_levels.to(torch.float32)[lvl].contiguous(),
        stereo=prob.obs_stereo.contiguous(),
        obs_pt=obs_pt,
        cam_free=((~prob.cam_fixed) & prob.cam_valid).contiguous(),
        perm=perm,
        seg=seg.contiguous(),
        scratch=torch.empty(Nc * CHUNKS * 32 + 2 * Nc, dtype=torch.float32, device=dev),
        tickets=torch.zeros(Nc + 1, dtype=torch.int32, device=dev),
    )


def build_system(prep: LBAPrep, cam_T, pts, obs_ok, robust: bool, K, bf) -> LBASystem:
    """K4 wrapper: the normal-equation blocks at (cam_T, pts), one launch."""
    prob = prep.prob
    if not cam_T.is_cuda:
        return build_system_plain(prob, prep.inv_sigma2_levels, prep.F, cam_T, pts,
                                  obs_ok, robust, K, bf)
    f32 = torch.float32
    Nc, Np, F = prob.cam_T.shape[0], prob.pts.shape[0], prep.F
    O = prep.perm.shape[0]
    cam_T, pts, obs_ok = cam_T.contiguous(), pts.contiguous(), obs_ok.contiguous()
    _build.require(cam_T, "cam_T", f32, (Nc, 4, 4))
    _build.require(pts, "pts", f32, (Np, 3))
    _build.require(obs_ok, "obs_ok", torch.bool, (O,))
    # [E | Hpp9, bp3 | Hcc | bc | cost], E first so its rows stay aligned
    n_e, n_pp = F * 18 * Np, 12 * Np
    sys_ = torch.empty(n_e + n_pp + F * 42 + 1, dtype=f32, device=cam_T.device)
    n_in = torch.empty((), dtype=torch.int32, device=cam_T.device)
    fx, fy, cx, cy = (float(v) for v in K)
    lib = _build.library()
    # bool tensors reach the kernel as bytes (0 or 1 each)
    err = lib.slam_lba_build(
        _build.ptr(cam_T), _build.ptr(pts), _build.ptr(prep.uvr), _build.ptr(prep.inv_s2),
        _build.ptr(prep.stereo), _build.ptr(obs_ok), _build.ptr(prep.obs_pt),
        _build.ptr(prep.cam_free), _build.ptr(prep.perm), _build.ptr(prep.seg),
        _build.ptr(sys_), _build.ptr(n_in), _build.ptr(prep.scratch), _build.ptr(prep.tickets),
        Nc, Np, prep.N_per, F, CHUNKS, int(bool(robust)), fx, fy, cx, cy, float(bf),
        _build.stream_of(cam_T))
    _build.check(err, "slam_lba_build")
    trace.count("launch.K4")
    o_hcc = n_e + n_pp
    out = LBASystem(
        Hcc=sys_[o_hcc:o_hcc + F * 36].view(F, 6, 6),
        bc=sys_[o_hcc + F * 36:o_hcc + F * 42].view(F, 6),
        Hpp9=sys_[n_e:n_e + 9 * Np].view(9, Np),
        bp3=sys_[n_e + 9 * Np:n_e + n_pp].view(3, Np),
        E=sys_[:n_e].view(F, 6, 3, Np),
        cost=sys_[-1],
        n_in=n_in,
    )
    if build_system.record is not None:
        build_system.record.append((cam_T, pts, obs_ok, robust, out))
    return out


# None, or a list to which each launch appends (cam_T, pts, obs_ok, robust,
# system), so that a solve's every linearization can be held to the plain
# version afterwards (chip_smoke.py)
build_system.record = None
