"""Struct-of-arrays map state — the port of
`orb_slam2_comment_tpu/models/map_state.py`.

`MapState` is a dataclass of tensors with the reference's field names and
shapes. Descriptors are int32 bit patterns of the reference's uint32 words;
`from_numpy` / `to_numpy` convert to and from the reference's arrays, so a
map can be carried across packages bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.ops.scatter import scatter_set

_DESC_FIELDS = ("kf_desc", "pt_desc")


@dataclass
class MapState:
    # keyframes (capacity Kmax, feature slots N)
    kf_pose: torch.Tensor       # [Kmax, 4, 4] Tcw
    kf_valid: torch.Tensor      # [Kmax] bool
    kf_frame_id: torch.Tensor   # [Kmax] int32
    kf_timestamp: torch.Tensor  # [Kmax] f32
    kf_xy: torch.Tensor         # [Kmax, N, 2]
    kf_octave: torch.Tensor     # [Kmax, N] int32
    kf_angle: torch.Tensor      # [Kmax, N] f32
    kf_uright: torch.Tensor     # [Kmax, N] f32 (-1 = mono)
    kf_depth: torch.Tensor      # [Kmax, N] f32 (-1 = none)
    kf_desc: torch.Tensor       # [Kmax, N, 8] int32
    kf_feat_valid: torch.Tensor  # [Kmax, N] bool
    kf_obs: torch.Tensor        # [Kmax, N] int32 point id or -1
    kf_group: torch.Tensor      # [Kmax, N] int32 BoW group id (-1 none)
    kf_no_erase: torch.Tensor   # [Kmax] bool
    kf_parent: torch.Tensor     # [Kmax] int32 (-1 = root)
    kf_Tcp: torch.Tensor        # [Kmax, 4, 4]
    # map points (capacity Pmax)
    pt_pos: torch.Tensor        # [Pmax, 3]
    pt_valid: torch.Tensor      # [Pmax] bool
    pt_desc: torch.Tensor       # [Pmax, 8] int32
    pt_normal: torch.Tensor     # [Pmax, 3]
    pt_min_dist: torch.Tensor   # [Pmax]
    pt_max_dist: torch.Tensor   # [Pmax]
    pt_ref_kf: torch.Tensor     # [Pmax] int32
    pt_first_kf: torch.Tensor   # [Pmax] int32
    pt_visible: torch.Tensor    # [Pmax] int32
    pt_found: torch.Tensor      # [Pmax] int32

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy (reference dtypes, no x64) -> tensor; uint32 becomes int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    # a read-only source (a JAX buffer) is copied: the port writes rows in place
    a = np.ascontiguousarray(a) if a.flags.writeable else np.array(a, copy=True)
    return torch.from_numpy(a).to(device)


def from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> MapState:
    """Build a MapState from the reference MapState's arrays (a mapping of
    field name -> numpy array, e.g. `{k: np.asarray(v) for k, v in
    jax_map._asdict().items()}`)."""
    return MapState(**{f: tensor_from_numpy(arrays[f], device)
                       for f in MapState.field_names()})


def to_numpy(m: MapState) -> dict:
    """MapState -> field name -> numpy array in the reference's dtypes."""
    out = {}
    for f in MapState.field_names():
        a = getattr(m, f).detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f in _DESC_FIELDS else a
    return out


def empty_map(max_kfs: int, max_pts: int, n_feat: int, device="cpu") -> MapState:
    kw = dict(device=device)
    i32, f32 = torch.int32, torch.float32
    eye = torch.eye(4, dtype=f32, **kw)
    return MapState(
        kf_pose=eye.repeat(max_kfs, 1, 1),
        kf_valid=torch.zeros(max_kfs, dtype=torch.bool, **kw),
        kf_frame_id=torch.full((max_kfs,), -1, dtype=i32, **kw),
        kf_timestamp=torch.zeros(max_kfs, dtype=f32, **kw),
        kf_xy=torch.zeros((max_kfs, n_feat, 2), dtype=f32, **kw),
        kf_octave=torch.zeros((max_kfs, n_feat), dtype=i32, **kw),
        kf_angle=torch.zeros((max_kfs, n_feat), dtype=f32, **kw),
        kf_uright=torch.full((max_kfs, n_feat), -1.0, dtype=f32, **kw),
        kf_depth=torch.full((max_kfs, n_feat), -1.0, dtype=f32, **kw),
        kf_desc=torch.zeros((max_kfs, n_feat, 8), dtype=i32, **kw),
        kf_feat_valid=torch.zeros((max_kfs, n_feat), dtype=torch.bool, **kw),
        kf_obs=torch.full((max_kfs, n_feat), -1, dtype=i32, **kw),
        kf_group=torch.full((max_kfs, n_feat), -1, dtype=i32, **kw),
        kf_no_erase=torch.zeros(max_kfs, dtype=torch.bool, **kw),
        kf_parent=torch.full((max_kfs,), -1, dtype=i32, **kw),
        kf_Tcp=eye.repeat(max_kfs, 1, 1),
        pt_pos=torch.zeros((max_pts, 3), dtype=f32, **kw),
        pt_valid=torch.zeros(max_pts, dtype=torch.bool, **kw),
        pt_desc=torch.zeros((max_pts, 8), dtype=i32, **kw),
        pt_normal=torch.zeros((max_pts, 3), dtype=f32, **kw),
        pt_min_dist=torch.zeros(max_pts, dtype=f32, **kw),
        pt_max_dist=torch.full((max_pts,), 1e9, dtype=f32, **kw),
        pt_ref_kf=torch.full((max_pts,), -1, dtype=i32, **kw),
        pt_first_kf=torch.full((max_pts,), -1, dtype=i32, **kw),
        pt_visible=torch.zeros(max_pts, dtype=i32, **kw),
        pt_found=torch.zeros(max_pts, dtype=i32, **kw),
    )


def _clip(ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(ids, 0, n - 1).long()


def grow_map(m: MapState, new_kmax: int, new_pmax: int) -> MapState:
    """Pad a MapState to a larger capacity tier (the reference's
    `grow_map`): keyframe rows to new_kmax, point rows to new_pmax, ids
    unchanged, the new rows filled as empty_map fills them. Raises
    ValueError on a shrink; returns `m` itself when the sizes do not
    change."""
    (kmax, n_feat), pmax = m.kf_obs.shape, m.pt_pos.shape[0]
    if new_kmax < kmax or new_pmax < pmax:
        raise ValueError("capacity tiers only grow")
    if new_kmax == kmax and new_pmax == pmax:
        return m
    tail = empty_map(new_kmax - kmax, new_pmax - pmax, n_feat, m.kf_obs.device)
    return MapState(**{f: torch.cat([getattr(m, f), getattr(tail, f)])
                       for f in MapState.field_names()})


def compact_points(m: MapState):
    """Stream-compact live points to the low slots. Returns
    (m', n_live, remap) with remap[old id] = new id or -1."""
    pmax = m.pt_pos.shape[0]
    valid = m.pt_valid
    rank = torch.cumsum(valid.to(torch.int32), 0).to(torch.int32) - 1
    remap = torch.where(valid, rank, torch.full_like(rank, -1))
    dst = torch.where(valid, rank, torch.full_like(rank, pmax)).long()

    def mv(arr, fill):
        out = torch.full((pmax + 1,) + arr.shape[1:], fill, dtype=arr.dtype,
                         device=arr.device)
        out[dst] = arr   # live rows land on distinct slots; dead rows on pmax
        return out[:pmax]

    obs = m.kf_obs
    oc = _clip(obs, pmax)
    obs_new = torch.where((obs >= 0) & valid[oc], remap[oc], torch.full_like(obs, -1))
    return m.replace(
        pt_pos=mv(m.pt_pos, 0),
        pt_valid=mv(m.pt_valid, False),
        pt_desc=mv(m.pt_desc, 0),
        pt_normal=mv(m.pt_normal, 0),
        pt_min_dist=mv(m.pt_min_dist, 0),
        pt_max_dist=mv(m.pt_max_dist, 1e9),
        pt_ref_kf=mv(m.pt_ref_kf, -1),
        pt_first_kf=mv(m.pt_first_kf, -1),
        pt_visible=mv(m.pt_visible, 0),
        pt_found=mv(m.pt_found, 0),
        kf_obs=obs_new,
    ), torch.sum(valid.to(torch.int32)), remap


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """[Kmax, Kmax] int32 all-pairs shared-observation counts (A @ A^T of
    the 0/1 observation indicator; exact in f32)."""
    kmax = m.kf_obs.shape[0]
    pmax = m.pt_pos.shape[0]
    obs_ok = m.kf_feat_valid & m.kf_valid[:, None] & m.pt_valid[_clip(m.kf_obs, pmax)]
    obs_ok = obs_ok & (m.kf_obs >= 0)
    A = torch.zeros((kmax, pmax + 1), dtype=torch.float32, device=m.kf_obs.device)
    rows = torch.arange(kmax, device=A.device)[:, None].expand_as(m.kf_obs)
    cols = torch.where(obs_ok, m.kf_obs.long(), pmax)
    A[rows, cols] = 1.0
    A = A[:, :pmax]
    W = (A @ A.T).to(torch.int32)
    W = torch.where(m.kf_valid[:, None] & m.kf_valid[None, :], W, torch.zeros_like(W))
    return W * (1 - torch.eye(kmax, dtype=torch.int32, device=W.device))


def covisibility_weights(m: MapState, k) -> torch.Tensor:
    """Shared-observation counts between keyframe k and every other KF."""
    obs_k = m.kf_obs[k]
    pmax = m.pt_pos.shape[0]
    in_k = scatter_set(torch.zeros(pmax, dtype=torch.bool, device=obs_k.device),
                       _clip(obs_k, pmax), obs_k >= 0)
    in_k = in_k & m.pt_valid
    shared = in_k[_clip(m.kf_obs, pmax)] & (m.kf_obs >= 0)
    w = torch.sum(shared, dim=1).to(torch.int32)
    w = torch.where(m.kf_valid, w, torch.zeros_like(w))
    w = w.clone()
    w[k] = 0
    return w


def point_observation_counts(m: MapState) -> torch.Tensor:
    """[Pmax] observation count per point; a stereo observation counts 2."""
    pmax = m.pt_pos.shape[0]
    N = m.kf_obs.shape[1]
    flat = m.kf_obs.reshape(-1)
    ok = (flat >= 0) & m.kf_valid.repeat_interleave(N)
    wgt = torch.where(m.kf_uright.reshape(-1) >= 0, 2, 1).to(torch.int32)
    upd = torch.where(ok, wgt, torch.zeros_like(wgt))
    return torch.zeros(pmax, dtype=torch.int32, device=flat.device).index_add_(
        0, _clip(flat, pmax), upd)


def update_point_stats(m: MapState, scale_factor: float = 1.2, n_levels: int = 8) -> MapState:
    """Refresh normals and scale bands of all valid points from their
    observations (batched MapPoint::UpdateNormalAndDepth)."""
    from orb_slam2_comment_tpu_torch.ops.scatter import segment_sum

    Kmax, N = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    flat_pt = m.kf_obs.reshape(-1)
    valid_obs = (flat_pt >= 0) & m.kf_valid.repeat_interleave(N) & m.kf_feat_valid.reshape(-1)
    pt_idx = _clip(flat_pt, pmax)
    Rt = m.kf_pose[:, :3, :3].transpose(1, 2)
    cam_centers = -(Rt @ m.kf_pose[:, :3, 3:])[..., 0]
    vec = m.pt_pos[pt_idx] - cam_centers.repeat_interleave(N, 0)
    unit = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-9)
    seg = torch.where(valid_obs, pt_idx, pmax)
    nsum = segment_sum(unit, seg, pmax)
    cnt = segment_sum(valid_obs.to(torch.float32), seg, pmax)
    normal = nsum / torch.clamp(cnt[:, None], min=1.0)
    ref = _clip(m.pt_ref_kf, Kmax)
    ref_dist = torch.linalg.norm(m.pt_pos - cam_centers[ref], dim=-1)
    pids = torch.arange(pmax, device=flat_pt.device)
    slot_match = m.kf_obs[ref] == pids[:, None]
    slot = torch.argmax(slot_match.to(torch.int8), dim=1)
    has_slot = torch.any(slot_match, dim=1)
    octv = torch.where(has_slot, m.kf_octave[ref, slot], torch.zeros_like(slot, dtype=torch.int32))
    sf = float(scale_factor)
    max_dist = ref_dist * torch.pow(torch.full((), sf, device=ref_dist.device), octv.to(torch.float32))
    min_dist = max_dist / (sf ** (float(n_levels) - 1.0))
    wb = m.pt_valid & has_slot
    return m.replace(
        pt_normal=torch.where(m.pt_valid[:, None], normal, m.pt_normal),
        pt_max_dist=torch.where(wb, max_dist, m.pt_max_dist),
        pt_min_dist=torch.where(wb, min_dist, m.pt_min_dist),
    )


def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """Scale level from distance (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    # the reference takes log(scale_factor) in f32, not f64
    log_sf = torch.log(torch.full((), scale_factor, dtype=torch.float32, device=dist.device))
    lvl = torch.ceil(torch.log(ratio) / log_sf).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)
