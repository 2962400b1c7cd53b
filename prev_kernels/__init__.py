"""The earlier designs of kernels K1 (FAST + NMS, one launch per pyramid
level), K3 (pose-only LM) and K4 (local-BA build), with their wrappers,
kept only so that chip_smoke.py can time each redesigned kernel against
its predecessor in one run, in turns. The port never imports this
package. Beside it, two tools for a GPU: `k1_variants.py` times build
variants of K1, and `trace_mono.py` runs the monocular path on the CPU and
the card in lockstep and prints where the two part.

`library()` builds `prev_kernels/*.cu` with
`orb_slam2_comment_tpu_torch._build.compile_library` into the port's build
directory.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from orb_slam2_comment_tpu_torch import _build
from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops.optim import LBASystem, PoseOptResult

_SRC = Path(__file__).resolve().parent
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # img, out, h, w, margin, stream
    "slam_prev_fast_nms": [_P, _P, _I, _I, _I, _P],
    # X, obs, invs2, comp, valid, delta, chi2th, pose0, pose_out, inl, B, n,
    # fx, fy, cx, cy, bf, rounds, iters, robust_rounds, stream
    "slam_prev_pose_lm": [_P] * 10 + [_I] * 2 + [_F] * 5 + [_I] * 3 + [_P],
    # cam_T, pts, uvr, wbase, urmask, obs_pt, cam_free, perm, seg,
    # cam_out, pp_out, e_out, Nc, Np, N_per, F, robust, fx, fy, cx, cy, bf, stream
    "slam_prev_lba_build": [_P] * 12 + [_I] * 5 + [_F] * 5 + [_P],
}


def build():
    """Compile the earlier kernels (if needed); returns the library path."""
    so = _build.library_path(_SRC, "libprev_kernels")
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        _build.compile_library(sorted(_SRC.glob("*.cu")), so, so.parent / "nvcc_prev.log")
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def fast_nms_prev(img: torch.Tensor) -> torch.Tensor:
    """The earlier K1 wrapper and kernel (CUDA tensors only): one launch
    for one [H, W] f32 level."""
    h, w = img.shape
    _build.require(img, "img", torch.float32, (h, w))
    out = torch.empty_like(img)
    _build.check(library().slam_prev_fast_nms(_build.ptr(img), _build.ptr(out), h, w,
                                              C.EDGE_THRESHOLD, _build.stream_of(img)),
                 "slam_prev_fast_nms")
    return out


def pose_optimize_prev(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels, K, bf,
                       rounds: int = C.POSE_OPT_ROUNDS,
                       iters: int = C.POSE_OPT_ITS_PER_ROUND) -> PoseOptResult:
    """The earlier K3 wrapper and kernel (CUDA tensors only)."""
    batched = Tcw0.dim() == 3
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
    pose_out = torch.empty((B, 12), dtype=f32, device=X.device)
    mask = torch.empty((B, n), dtype=f32, device=X.device)
    fx, fy, cx, cy = (float(v) for v in K)
    _build.check(library().slam_prev_pose_lm(
        _build.ptr(X), _build.ptr(O), _build.ptr(invs2), _build.ptr(comp),
        _build.ptr(validf), _build.ptr(delta), _build.ptr(chi2th), _build.ptr(pose0),
        _build.ptr(pose_out), _build.ptr(mask), B, n, fx, fy, cx, cy, float(bf),
        int(rounds), int(iters), int(C.POSE_OPT_ROBUST_ROUNDS), _build.stream_of(X)),
        "slam_prev_pose_lm")
    Tcw = geo.orthonormalize_T(geo.make_T(pose_out[:, :9].reshape(B, 3, 3), pose_out[:, 9:12]))
    inliers = (mask > 0) & valid
    res = PoseOptResult(Tcw=Tcw, inliers=inliers,
                        n_inliers=torch.sum(inliers, dim=-1).to(torch.int32))
    return res if batched else PoseOptResult(*(f[0] for f in res))


def prep_prev(prob, inv_sigma2_levels, F: int) -> dict:
    """The earlier per-window tables of K4."""
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    lvl = torch.clamp(prob.obs_oct, 0, inv_sigma2_levels.shape[0] - 1).long()
    obs_pt = torch.clamp(prob.obs_pt, 0, Np - 1).to(torch.int32).contiguous()
    key = torch.where(prob.obs_valid, obs_pt, Np)
    perm = torch.sort(key, stable=True).indices.to(torch.int32).contiguous()
    counts = torch.zeros(Np + 1, dtype=torch.int32, device=obs_pt.device)
    counts = counts.index_add_(0, key.long(), torch.ones_like(obs_pt))[:Np]
    seg = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(torch.int32)])
    return dict(prob=prob, F=F, N_per=prob.obs_cam.shape[0] // Nc,
                inv_s2=inv_sigma2_levels.to(torch.float32)[lvl].contiguous(),
                urmask=prob.obs_stereo.to(torch.float32).contiguous(), obs_pt=obs_pt,
                cam_free=((~prob.cam_fixed) & prob.cam_valid).to(torch.int32).contiguous(),
                perm=perm, seg=seg.contiguous())


def build_system_prev(prep: dict, cam_T, pts, obs_ok, robust: bool, K, bf) -> LBASystem:
    """The earlier K4 wrapper and kernels (CUDA tensors only)."""
    prob, F = prep["prob"], prep["F"]
    f32 = torch.float32
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    cam = cam_T.to(f32).reshape(Nc, 16).contiguous()
    P = pts.to(f32).contiguous()
    uvr = prob.obs_uvr.to(f32).contiguous()
    wbase = (prep["inv_s2"] * obs_ok.to(f32)).contiguous()
    cam_out = torch.empty(Nc, 44, dtype=f32, device=cam.device)
    pp = torch.empty(12, Np, dtype=f32, device=cam.device)
    E = torch.empty(F, 18, Np, dtype=f32, device=cam.device)
    fx, fy, cx, cy = (float(v) for v in K)
    _build.check(library().slam_prev_lba_build(
        _build.ptr(cam), _build.ptr(P), _build.ptr(uvr), _build.ptr(wbase),
        _build.ptr(prep["urmask"]), _build.ptr(prep["obs_pt"]), _build.ptr(prep["cam_free"]),
        _build.ptr(prep["perm"]), _build.ptr(prep["seg"]), _build.ptr(cam_out), _build.ptr(pp),
        _build.ptr(E), Nc, Np, prep["N_per"], F, int(bool(robust)), fx, fy, cx, cy,
        float(bf), _build.stream_of(cam)), "slam_prev_lba_build")
    return LBASystem(Hcc=cam_out[:F, :36].reshape(F, 6, 6), bc=cam_out[:F, 36:42],
                     Hpp9=pp[:9], bp3=pp[9:12], E=E.reshape(F, 6, 3, Np),
                     cost=torch.sum(cam_out[:, 42]),
                     n_in=torch.sum(cam_out[:, 43]).to(torch.int32))
