"""Frame-rate tracking — the port of the device step and the host tracker
of `orb_slam2_comment_tpu/models/tracking.py` (the reference's Tracking
state machine, src/Tracking.cc:267-506), for RGB-D, stereo and monocular
frames.

Per frame after initialization, the device step extracts features,
samples depth (stereo: matches the right image; mono: none), tracks
(motion model, reference-KF fallback, local map), applies the keyframe
policy, creates a keyframe when needed and runs one chunk of the mapper
machine. The reference's `lax.cond`s become Python `if`s taken on the same
conditions. Host reads per steady-state frame: the narrow-match count, the
motion-branch verdict, the local-map cap check, the stats vector and the
point-arena compaction check (mapper idle only); mapper phases add their
own (see PERF.md). With `cfg.chunked_mapper` False the step runs no
machine chunk and compacts nothing: the monolithic mapper
(`local_mapping.LocalMapper.process`, a keyframe callback) maps each new
keyframe when the frame resolves.

The fused frames run through the reference's asynchronous pipeline:
`track_*_arrays` returns a `LazyTrackOutput` without waiting for the frame.
A host image is copied to the card on a copy stream and its frame is
dispatched one call later (`_upQ`). An RGB-D frame's extraction (stage A)
runs on an extraction stream when it is dispatched, and its tracking,
keyframe and mapper step (stage B) `cfg.pipeline_lag` frames later, on the
caller's stream; stereo and monocular frames run whole. Each frame's packed
out vector joins a batch of `STATS_BATCH` that is copied to pinned host
memory in one transfer, and the host state (state, `n_kfs`, trajectory,
keyframe callbacks) moves when a landed batch resolves (`_resolve_entry`).
Reading a field of a `LazyTrackOutput`, `_flush_upto`, `_flush_all` or
more than `MAX_BATCHES` batches in flight wait for the device; the loop
closer's detection packs ride the same transfers (`enqueue_side`).

The first frames take the host path: stereo and RGB-D initialize from
one frame, monocular through `MonocularInitializer` (a reference frame,
then a two-view reconstruction). A frame after LOST, every frame in
localization-only mode and, with `cfg.fused_tracking` False, every frame
drains the pipeline and takes the reference's host path
(`Tracker._track_host`, tracking.py:1795-1967): extraction, `_track_core`
called from the host (OK state; the staged ladder `_staged_retry` instead
when not fused), the staged retry on a weak frame, relocalization through
`reloc_fn`, in localization mode the visual-odometry fallback against the
previous host-path frame (`_track_vo_frame`), the host keyframe policy;
then, in the fused mode, the device state is rebuilt from the host
(`_sync_ds_from_host`) and a new keyframe's chunked mapper pass is drained
at once. The staged mode keeps no device state.

Before each frame, with `cfg.grow_capacity`, `_maybe_grow` moves the map
to the next capacity tier when the host mirrors say it is ~85% full (the
reference's `Tracker._maybe_grow`).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.models import local_mapping as lm
from orb_slam2_comment_tpu_torch.models import map_state as ms
from orb_slam2_comment_tpu_torch.models.frame import (
    Frame, build_frame_mono, build_frame_rgbd, build_frame_stereo, mono_features, rgbd_depth,
    stereo_features)
from orb_slam2_comment_tpu_torch.models.initializer import MonocularInitializer
from orb_slam2_comment_tpu_torch.models.map_state import MapState
from orb_slam2_comment_tpu_torch.ops import bow, matching, optim, orb
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops.scatter import const, scalar, scatter_set, top_k
from orb_slam2_comment_tpu_torch.utils import trace
from orb_slam2_comment_tpu_torch.utils.config import (
    MONOCULAR, RGBD, STEREO, SlamConfig, resolve_device)

NO_IMAGES_YET = -1
NOT_INITIALIZED = 0
OK = 1
LOST = 2

LOCAL_POINTS_CAP = 8192
_INT_MAX = 0x7FFFFFFF


def _inv_sigma2(cfg: SlamConfig, device) -> torch.Tensor:
    return const(tuple(1.0 / (cfg.scale_factor ** (2 * l)) for l in range(cfg.n_levels)),
                 device)


def _clip(ids, n: int) -> torch.Tensor:
    return torch.clamp(ids, 0, n - 1).long()


def check_slice(cfg: SlamConfig):
    """Raise for a sensor the port does not run, and for a fused RGB-D
    pipeline with no stage-A lag (the reference pops its empty stage-A
    queue on the first fused frame and fails there)."""
    if cfg.sensor not in (RGBD, STEREO, MONOCULAR):
        raise NotImplementedError(f"sensor {cfg.sensor!r}")
    if cfg.sensor == RGBD and cfg.fused_tracking and cfg.pipeline_lag < 1:
        raise ValueError(f"pipeline_lag={cfg.pipeline_lag}: a fused RGB-D pipeline needs "
                         "pipeline_lag >= 1")


# ---------------------------------------------------------------------------
# device-side pieces
# ---------------------------------------------------------------------------

def _invert_matches(res, row_ids, n_cols: int):
    """Row->col matches inverted to a per-column assignment; collisions go
    to the best Hamming distance, then the lower row id (one int key,
    scatter-min)."""
    key = (torch.clamp(res.dist, 0, 511).to(torch.int64) * (1 << 20)
           + torch.clamp(row_ids, 0, (1 << 20) - 1).to(torch.int64))
    key = torch.where(res.ok & (row_ids >= 0), key, _INT_MAX)
    best = torch.full((n_cols,), _INT_MAX, dtype=torch.int64, device=key.device)
    best = best.scatter_reduce(0, res.idx.long(), key, reduce="amin")
    return torch.where(best < _INT_MAX, best % (1 << 20), -1).to(torch.int32)


def _match_against_points(m: MapState, pt_ids, Tcw, feats, uright, radius: float,
                          cfg: SlamConfig, use_frustum_band: bool = True):
    """Project candidate map points into the frame and associate features
    (SearchByProjection + Frame::isInFrustum). Returns
    (assoc [N] point id or -1, n_matches, visible [P])."""
    pmax = m.pt_pos.shape[0]
    pid = _clip(pt_ids, pmax)
    ok = (pt_ids >= 0) & m.pt_valid[pid]
    X = m.pt_pos[pid]
    Xc = geo.transform_points(Tcw, X)
    uv = geo.project(cfg.K, Xc)
    h, w = cfg.height, cfg.width
    in_img = ((Xc[:, 2] > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    cam_center = -(Tcw[:3, :3].T @ Tcw[:3, 3])
    vec = X - cam_center
    dist = torch.linalg.norm(vec, dim=-1)
    band = (dist >= 0.8 * m.pt_min_dist[pid]) & (dist <= 1.2 * m.pt_max_dist[pid])
    if use_frustum_band:
        view_cos = torch.sum(vec * m.pt_normal[pid], dim=-1) / torch.clamp(dist, min=1e-9)
        frustum = band & (view_cos > 0.5)
    else:
        frustum = torch.ones_like(band)
    visible = ok & in_img & frustum
    pred_oct = ms.predict_scale(dist, m.pt_max_dist[pid], cfg.scale_factor, cfg.n_levels)
    scales = const(tuple(cfg.orb.scales), X.device)
    res = matching.match_projection(uv, visible, m.pt_desc[pid], pred_oct, feats, radius,
                                    scales, max_dist=cfg.th_high, nn_ratio=0.8)
    assoc = _invert_matches(res, pt_ids, feats.xy.shape[0])
    assoc = torch.where(feats.valid, assoc, -1)
    return assoc, torch.sum(assoc >= 0), visible


def _pose_opt_from_assoc(m: MapState, Tcw0, feats, uright, assoc, cfg: SlamConfig):
    """Motion-only BA on the current associations."""
    pmax = m.pt_pos.shape[0]
    pid = _clip(assoc, pmax)
    valid = (assoc >= 0) & m.pt_valid[pid] & feats.valid
    obs = torch.cat([feats.xy, uright[:, None]], dim=-1)
    res = optim.pose_optimize(Tcw0, m.pt_pos[pid], obs, feats.octave, uright >= 0, valid,
                              _inv_sigma2(cfg, obs.device), cfg.K, cfg.bf)
    return res.Tcw, torch.where(res.inliers, assoc, -1), res.n_inliers


def _select_local_map(m: MapState, assoc):
    """Local keyframes (sharing observations with the frame, capped at
    LOCAL_MAP_MAX_KFS) and local points (their observations, capped at
    LOCAL_POINTS_CAP by strongest-observer covisibility). One host read:
    whether the candidates fit the cap."""
    pmax = m.pt_pos.shape[0]
    kmax = m.kf_pose.shape[0]
    dev = assoc.device
    in_cur = scatter_set(torch.zeros(pmax, dtype=torch.bool, device=dev),
                         _clip(assoc, pmax), assoc >= 0)
    shared = in_cur[_clip(m.kf_obs, pmax)] & (m.kf_obs >= 0)
    counts = torch.where(m.kf_valid, torch.sum(shared, dim=1), 0)
    k = min(C.LOCAL_MAP_MAX_KFS, kmax)
    top_counts, top_kfs = top_k(counts, k)
    kf_ids = torch.where(top_counts > 0, top_kfs, -1).to(torch.int32)
    obs_sel = m.kf_obs[_clip(kf_ids, kmax)]
    wgt = torch.where(kf_ids >= 0, top_counts, 0)
    score = torch.zeros(pmax, dtype=torch.int64, device=dev).scatter_reduce(
        0, _clip(obs_sel.reshape(-1), pmax),
        (wgt[:, None] * (obs_sel >= 0)).reshape(-1).to(torch.int64), reduce="amax")
    score = torch.where(m.pt_valid, score, 0)
    mask = score > 0
    if int(torch.sum(mask)) <= LOCAL_POINTS_CAP:
        pos = torch.cumsum(mask.to(torch.int64), 0) - 1
        dst = torch.where(mask, torch.clamp(pos, max=LOCAL_POINTS_CAP), LOCAL_POINTS_CAP)
        out = scatter_set(torch.full((LOCAL_POINTS_CAP + 1,), -1, dtype=torch.int32, device=dev),
                          dst, torch.arange(pmax, dtype=torch.int32, device=dev))
        pt_ids = out[:LOCAL_POINTS_CAP]
    else:
        vals, ids = top_k(score, LOCAL_POINTS_CAP)
        pt_ids = torch.where(vals > 0, ids, -1).to(torch.int32)
    return kf_ids, pt_ids


def _update_point_counters(m: MapState, pt_ids, visible, assoc) -> MapState:
    """IncreaseVisible for frustum-visible local points, IncreaseFound for
    inlier-associated points."""
    pmax = m.pt_pos.shape[0]
    vis = (visible & (pt_ids >= 0)).to(torch.int32)
    fnd = (assoc >= 0).to(torch.int32)
    return m.replace(
        pt_visible=m.pt_visible.index_add(0, _clip(pt_ids, pmax), vis),
        pt_found=m.pt_found.index_add(0, _clip(assoc, pmax), fnd),
    )


def _create_kf_core(m: MapState, slot: int, pt_base: torch.Tensor, frame_id: int,
                    timestamp: float, Tcw, feats, uright, depth, assoc, parent: int,
                    cfg: SlamConfig, max_new: int = 256, create_all_depth: bool = False,
                    groups=None):
    """Insert a keyframe and spawn close RGB-D points
    (Tracking::CreateNewKeyFrame; all positive-depth features at
    initialization). Returns (map, n_created, kf_obs_row)."""
    n = feats.xy.shape[0]
    pmax = m.pt_pos.shape[0]
    dev = Tcw.device
    max_new = min(max_new, pmax)
    cand = feats.valid & (depth > 0) & (assoc < 0)
    order = torch.sort(torch.where(cand, depth, 1e9), stable=True).indices
    sel_rank = torch.arange(n, device=dev)
    take = cand[order] & (sel_rank < max_new)
    if not create_all_depth:
        close = depth[order] <= cfg.depth_threshold
        take = take & ((sel_rank < C.MAX_CLOSE_STEREO_POINTS) | close)
    feat_idx = order[:max_new]
    take = take[:max_new]
    take = take & (pt_base <= pmax - max_new)
    b0 = torch.clamp(pt_base, 0, pmax - max_new)
    new_ids = (b0 + torch.arange(max_new, device=dev)).long()

    z = depth[feat_idx]
    uv = feats.xy[feat_idx]
    Xc = geo.backproject(cfg.K, uv, z)
    Twc = geo.inv_T(Tcw)
    Xw = geo.transform_points(Twc, Xc)
    vec = Xw - Twc[:3, 3]
    dist = torch.linalg.norm(vec, dim=-1)
    normal = vec / torch.clamp(dist[:, None], min=1e-9)
    lvl = feats.octave[feat_idx].to(torch.float32)
    sf = torch.full((), float(cfg.scale_factor), dtype=torch.float32, device=dev)
    max_dist = dist * torch.pow(sf, lvl)
    min_dist = max_dist / (cfg.scale_factor ** (cfg.n_levels - 1))
    put = lm._put_block
    m = m.replace(
        pt_pos=put(m.pt_pos, new_ids, take, Xw),
        pt_valid=put(m.pt_valid, new_ids, take, True),
        pt_desc=put(m.pt_desc, new_ids, take, feats.desc[feat_idx]),
        pt_normal=put(m.pt_normal, new_ids, take, normal),
        pt_min_dist=put(m.pt_min_dist, new_ids, take, min_dist),
        pt_max_dist=put(m.pt_max_dist, new_ids, take, max_dist),
        pt_ref_kf=put(m.pt_ref_kf, new_ids, take, slot),
        pt_first_kf=put(m.pt_first_kf, new_ids, take, slot),
        pt_visible=put(m.pt_visible, new_ids, take, 1),
        pt_found=put(m.pt_found, new_ids, take, 1),
    )
    kf_obs_row = assoc.clone()
    kf_obs_row[feat_idx] = torch.where(take, new_ids.to(torch.int32), assoc[feat_idx])

    def row(arr, value):
        return lm._set_row(arr, slot, value)

    rows = dict(
        kf_pose=row(m.kf_pose, Tcw),
        kf_valid=row(m.kf_valid, True),
        kf_no_erase=row(m.kf_no_erase, True),
        kf_frame_id=row(m.kf_frame_id, int(frame_id)),
        kf_timestamp=row(m.kf_timestamp, float(timestamp)),
        kf_xy=row(m.kf_xy, feats.xy),
        kf_octave=row(m.kf_octave, feats.octave),
        kf_angle=row(m.kf_angle, feats.angle),
        kf_uright=row(m.kf_uright, uright),
        kf_depth=row(m.kf_depth, depth),
        kf_desc=row(m.kf_desc, feats.desc),
        kf_feat_valid=row(m.kf_feat_valid, feats.valid),
        kf_obs=row(m.kf_obs, kf_obs_row),
        kf_parent=row(m.kf_parent, int(parent)),
    )
    if groups is not None:
        rows["kf_group"] = row(m.kf_group, groups)
    return m.replace(**rows), torch.sum(take).to(torch.int32), kf_obs_row


def _match_ref_kf(m: MapState, ref_kf: int, feats, cfg: SlamConfig, frame_groups=None):
    """BoW-node-gated matching against the reference KF's points
    (TrackReferenceKeyFrame / SearchByBoW); a KF whose group row is all -1
    is matched ungated."""
    kf_obs = m.kf_obs[ref_kf]
    kf_ok = m.kf_feat_valid[ref_kf] & (kf_obs >= 0)
    dist = matching.hamming_from_packed(m.kf_desc[ref_kf], feats.desc)
    mask = kf_ok[:, None] & feats.valid[None, :]
    if frame_groups is not None:
        ga = m.kf_group[ref_kf]
        row_ungated = ~torch.any(ga >= 0)
        node_ok = (ga[:, None] == frame_groups[None, :]) & (ga >= 0)[:, None]
        mask = mask & (node_ok | row_ungated)
    res = matching.match_generic(dist, mask, cfg.th_low, nn_ratio=0.7, mutual=True,
                                 angles_a=m.kf_angle[ref_kf], angles_b=feats.angle)
    assoc = _invert_matches(res, kf_obs, feats.xy.shape[0])
    assoc = torch.where(feats.valid, assoc, -1)
    return assoc, torch.sum(assoc >= 0)


# stats vector layout
S_TRACKED = 0
S_N_INL = 1
S_USED_MOTION = 2
S_NEED_KF = 3
S_BEST_LOCAL = 4
S_N_MOTION = 5
S_N_REF = 6
S_TRACKED_CLOSE = 7
S_NONTRACKED_CLOSE = 8
S_N_REF_MATCHES = 9
S_COARSE_OK = 10
S_INL_M = 11
S_INL_R = 12
N_STATS = 13


def _track_core(m: MapState, feats, uright, depth, T_pred, T_last, have_velocity: bool,
                last_assoc, ref_kf: int, frame_id: int, last_kf_frame_id: int, n_kfs: int,
                cfg: SlamConfig, obs_counts=None, voc_gate=None, mapper_idle=None):
    """Motion model (TrackWithMotionModel), reference-KF fallback
    (TrackReferenceKeyFrame), local map (TrackLocalMap) and the keyframe
    policy (NeedNewKeyFrame). Returns (m', Tcw, assoc, stats[N_STATS])."""
    dev = feats.xy.device
    th = 7.0 if cfg.sensor != MONOCULAR else 15.0
    n_feat = feats.xy.shape[0]
    i32 = torch.int32

    assoc_m, n_m, _ = _match_against_points(m, last_assoc, T_pred, feats, uright, th, cfg,
                                            use_frustum_band=False)
    if int(n_m) < C.TRACK_MOTION_MIN_MATCHES:
        assoc_m, n_m, _ = _match_against_points(m, last_assoc, T_pred, feats, uright,
                                                2.0 * th, cfg, use_frustum_band=False)
    T_m, assoc_m, inl_m = _pose_opt_from_assoc(m, T_pred, feats, uright, assoc_m, cfg)
    motion_ok = bool(have_velocity and (n_m >= C.TRACK_MOTION_MIN_MATCHES)
                     & (inl_m >= 10))

    if motion_ok:
        T_r = T_last
        assoc_r = torch.full((n_feat,), -1, dtype=i32, device=dev)
        inl_r = torch.zeros((), dtype=i32, device=dev)
        n_r = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        fg = None
        if voc_gate is not None:
            fg = bow.group_ids(voc_gate[0], voc_gate[1], feats.desc, feats.valid,
                               cfg.voc_levels)
        assoc_r, n_r = _match_ref_kf(m, ref_kf, feats, cfg, frame_groups=fg)
        T_r, assoc_r, inl_r = _pose_opt_from_assoc(m, T_last, feats, uright, assoc_r, cfg)
    ref_ok = (n_r >= C.TRACK_REF_KF_MIN_MATCHES) & (inl_r >= 10)

    T1 = T_m if motion_ok else T_r
    assoc1 = assoc_m if motion_ok else assoc_r
    coarse_ok = ref_ok | motion_ok

    kf_ids, pt_ids = _select_local_map(m, assoc1)
    th_local = 3.0 if cfg.sensor == "rgbd" else 1.0
    assoc2, _, visible = _match_against_points(m, pt_ids, T1, feats, uright, th_local, cfg)
    assoc_merged = torch.where(assoc1 >= 0, assoc1, assoc2)
    T_f, assoc_f, inl_f = _pose_opt_from_assoc(m, T1, feats, uright, assoc_merged, cfg)
    tracked = coarse_ok & (inl_f >= C.TRACK_LOCAL_MAP_MIN_INLIERS)

    Tcw = torch.where(tracked, T_f, T_last)
    assoc_out = torch.where(tracked, assoc_f, -1)
    assoc_seen = torch.where(coarse_ok, assoc_f, -1)
    m = _update_point_counters(m, pt_ids, visible & coarse_ok, assoc_seen)

    kmax, pmax = cfg.max_keyframes, cfg.max_points
    best_local = kf_ids[0]
    ref_for_policy = torch.where(best_local >= 0, best_local, ref_kf)
    min_obs = 2 if n_kfs <= 2 else 3
    if obs_counts is None:
        obs_counts = ms.point_observation_counts(m)
    ref_obs = m.kf_obs[_clip(ref_for_policy, kmax)]
    ref_pid = _clip(ref_obs, pmax)
    ref_ok_pts = (ref_obs >= 0) & m.pt_valid[ref_pid]
    n_ref_matches = torch.sum(ref_ok_pts & (obs_counts[ref_pid] >= min_obs))
    if cfg.sensor != MONOCULAR:
        close = (depth > 0) & (depth < cfg.depth_threshold)
        tracked_close = torch.sum((assoc_out >= 0) & close)
        nontracked_close = torch.sum((assoc_out < 0) & close & feats.valid)
        need_close = (tracked_close < 100) & (nontracked_close > 70)
    else:
        tracked_close = nontracked_close = 0
        need_close = False
    th_ref = 0.9 if cfg.sensor == MONOCULAR else 0.75
    th_ref_j = 0.4 if n_kfs < 2 else th_ref
    frames_since = frame_id - last_kf_frame_id
    c1a = frames_since >= cfg.fps
    if mapper_idle is not None:
        c1b = bool(mapper_idle) and frames_since >= 1
    else:
        # the reference's host-path heuristic: the mapper is busy for
        # pipeline_lag frames after a keyframe (tracking.py:660-662)
        c1b = frames_since > max(int(cfg.pipeline_lag) + 1, 2)
    c1c = (cfg.sensor != MONOCULAR) & ((inl_f < n_ref_matches * 0.25) | need_close)
    c2 = ((inl_f < n_ref_matches * th_ref_j) | need_close) & (inl_f > 15)
    need_kf = (tracked & (c1c | (c1a or c1b)) & c2
               & (n_kfs < cfg.max_keyframes - 1) & (not cfg.localization_only))

    def f(v):
        return scalar(float(v) if not isinstance(v, torch.Tensor) else v, Tcw, torch.float32)

    stats = torch.stack([
        f(tracked), f(inl_f), f(motion_ok), f(need_kf), f(best_local), f(n_m), f(n_r),
        f(tracked_close), f(nontracked_close), f(n_ref_matches), f(coarse_ok), f(inl_m),
        f(inl_r)])
    return m, Tcw, assoc_out, stats


def _apply_velocity(velocity, T_last):
    return geo.orthonormalize_T(velocity @ T_last)


def _compose_velocity(Tcw, T_last):
    """velocity = Tcw @ T_last^-1 (Tracking.cc:423-434), re-orthonormalized."""
    return geo.orthonormalize_T(Tcw @ geo.inv_T(T_last))


def _track_vo_frame(last_feats, last_depth, T_last, T_pred, feats, uright, cfg: SlamConfig):
    """Visual odometry against the previous frame (the temporal points of
    Tracking::UpdateLastFrame, src/Tracking.cc:801-865, used by the mbVO
    branch of Track(), :333-391): the previous frame's depth-bearing
    features, lifted through its pose T_last, are matched into this frame
    by projection from T_pred and a motion-only LM gives the pose.
    Returns (Tcw, n_inliers)."""
    ok3d = last_feats.valid & (last_depth > 0)
    Xc = geo.backproject(cfg.K, last_feats.xy, last_depth)
    Xw = geo.transform_points(geo.inv_T(T_last), Xc)
    Xp = geo.transform_points(T_pred, Xw)
    uv = geo.project(cfg.K, Xp)
    h, w = cfg.height, cfg.width
    visible = (ok3d & (Xp[:, 2] > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
               & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    res = matching.match_projection(uv, visible, last_feats.desc, last_feats.octave, feats,
                                    15.0, const(tuple(cfg.orb.scales), uv.device),
                                    max_dist=cfg.th_high, nn_ratio=0.9,
                                    angles_p=last_feats.angle)
    n = feats.xy.shape[0]
    rows = torch.where(visible, torch.arange(n, dtype=torch.int32, device=uv.device), -1)
    assoc = _invert_matches(res, rows, n)
    valid = (assoc >= 0) & feats.valid
    obs = torch.cat([feats.xy, uright[:, None]], dim=-1)
    out = optim.pose_optimize(T_pred, Xw[_clip(assoc, n)], obs, feats.octave, uright >= 0,
                              valid, _inv_sigma2(cfg, obs.device), cfg.K, cfg.bf)
    return out.Tcw, out.n_inliers


@dataclass
class DeviceTrackState:
    """Tracker state carried from frame to frame. Scalars the host decides
    on are Python values; the rest lives on the device."""

    T_last: torch.Tensor        # [4,4]
    velocity: torch.Tensor      # [4,4]
    have_vel: bool
    last_assoc: torch.Tensor    # [N] int32
    ref_kf: int
    n_kfs: int
    n_pts: torch.Tensor         # 0-d int32 point-slot cursor
    last_kf_frame_id: int
    obs_counts: torch.Tensor    # [Pmax] int32
    voc_children: torch.Tensor  # [Nn, k] int32
    voc_signed: torch.Tensor    # [Nn, 256] f32 +-1
    mp: lm.MapperMachine

    def replace(self, **kw) -> "DeviceTrackState":
        return dataclasses.replace(self, **kw)


_DS_SCALARS = {"have_vel": bool, "ref_kf": int, "n_kfs": int, "last_kf_frame_id": int}


def track_state_from_numpy(arrays, device="cpu") -> DeviceTrackState:
    """From the reference DeviceTrackState's arrays (field -> numpy; `mp`
    a mapping of the MapperMachine's fields). The reference's bf16 signed
    centroids arrive as any float array."""
    kw = {}
    for f in dataclasses.fields(DeviceTrackState):
        a = arrays[f.name]
        if f.name == "mp":
            kw["mp"] = lm.machine_from_numpy(a, device)
        elif f.name in _DS_SCALARS:
            kw[f.name] = _DS_SCALARS[f.name](np.asarray(a))
        elif f.name == "voc_signed":
            kw[f.name] = torch.from_numpy(np.asarray(a, np.float32)).to(device)
        else:
            kw[f.name] = ms.tensor_from_numpy(np.asarray(a), device)
    return DeviceTrackState(**kw)


def track_state_to_numpy(ds: DeviceTrackState) -> dict:
    out = {}
    for f in dataclasses.fields(DeviceTrackState):
        v = getattr(ds, f.name)
        if f.name == "mp":
            out["mp"] = lm.machine_to_numpy(v)
        elif f.name in _DS_SCALARS:
            out[f.name] = np.asarray(v, np.bool_ if f.name == "have_vel" else np.int32)
        else:
            out[f.name] = v.detach().cpu().numpy()
    return out


# packed per-frame output vector layout (after stats[N_STATS])
X_KF_SLOT = N_STATS + 0
X_REF_KF = N_STATS + 1
X_N_KFS = N_STATS + 2
X_N_PTS = N_STATS + 3
X_TRACKED = N_STATS + 4
X_TCW = N_STATS + 5
X_TCR = N_STATS + 21
X_COMPACTED = N_STATS + 37
OUT_LEN = N_STATS + 38


def _frame_step_core(m: MapState, ds: DeviceTrackState, feats, uright, depth,
                     frame_id: int, timestamp: float, since_reloc: int, cfg: SlamConfig,
                     depth_map=None):
    """Track + keyframe policy + keyframe creation, then, with the chunked
    mapper, one mapper chunk and on-device point compaction (without it the
    keyframe callbacks map a new keyframe once the frame resolves). With
    `depth_map` (RGB-D stage B) the depth per keypoint, right u and
    undistortion come first, from the extracted `feats`.
    Returns (m', ds', out[OUT_LEN])."""
    chunked = cfg.chunked_mapper
    with trace.span("track", frame_id):
        if depth_map is not None:
            feats, uright, depth = rgbd_depth(feats, depth_map, cfg)
        T_pred = _apply_velocity(ds.velocity, ds.T_last) if ds.have_vel else ds.T_last
        m, Tcw, assoc, stats = _track_core(
            m, feats, uright, depth, T_pred, ds.T_last, ds.have_vel, ds.last_assoc, ds.ref_kf,
            frame_id, ds.last_kf_frame_id, ds.n_kfs, cfg, obs_counts=ds.obs_counts,
            voc_gate=(ds.voc_children, ds.voc_signed),
            mapper_idle=ds.mp.phase == 0 if chunked else None)
        s = stats.tolist()   # the per-frame policy read
    tracked = s[S_TRACKED] > 0
    # recently-relocalized frames need the stricter inlier floor
    if since_reloc < int(cfg.fps) and s[S_N_INL] < C.TRACK_LOCAL_MAP_MIN_INLIERS_RECENT_RELOC:
        tracked = False
    kf_reloc_block = since_reloc < int(cfg.fps) and ds.n_kfs > int(cfg.fps)
    best_local = int(s[S_BEST_LOCAL])
    ref1 = best_local if (s[S_COARSE_OK] > 0 and best_local >= 0) else ds.ref_kf
    need_kf = s[S_NEED_KF] > 0 and tracked and not kf_reloc_block
    slot = ds.n_kfs

    if need_kf:
        with trace.span("kf_create", frame_id):
            # the chunked mapper's keyframes carry their node ids from
            # creation; the monolithic path's get them from the database
            # callback
            groups = bow.group_ids(ds.voc_children, ds.voc_signed, feats.desc, feats.valid,
                                   cfg.voc_levels) if chunked else None
            m, n_created, kf_obs_row = _create_kf_core(
                m, slot, ds.n_pts, frame_id, timestamp, Tcw, feats, uright, depth, assoc,
                ref1, cfg, groups=groups)
            obs_counts2 = ms.point_observation_counts(m)
        assoc_after = kf_obs_row
        ref2 = slot
        n_pts2 = ds.n_pts + n_created
    else:
        obs_counts2 = ds.obs_counts
        assoc_after = assoc
        ref2 = ref1
        n_pts2 = ds.n_pts

    la_next = assoc_after if tracked else ds.last_assoc
    mp = ds.mp
    if chunked:
        if need_kf:
            # a new keyframe preempts the machine (mbAbortBA)
            mp = mp.replace(phase=1, kf=slot)
        m, n_pts2, obs_counts2, mp = lm.mapper_machine_step(m, n_pts2, obs_counts2, mp, cfg)

    compacted = False
    if chunked and mp.phase == 0:
        pmax = cfg.max_points
        n_live = torch.sum(m.pt_valid.to(torch.int32))
        if bool((n_pts2 >= int(pmax * 0.85)) & (n_live * 2 < n_pts2)):
            with trace.span("compact", frame_id):
                m, n_live2, remap = ms.compact_points(m)
                la_next = torch.where(la_next >= 0, remap[_clip(la_next, pmax)], -1)
                n_pts2 = n_live2.to(torch.int32)
                obs_counts2 = ms.point_observation_counts(m)
            compacted = True

    ds2 = DeviceTrackState(
        T_last=Tcw if tracked else ds.T_last,
        velocity=_compose_velocity(Tcw, ds.T_last) if tracked else ds.velocity,
        have_vel=tracked,
        last_assoc=la_next,
        ref_kf=ref2,
        n_kfs=ds.n_kfs + int(need_kf),
        n_pts=n_pts2,
        last_kf_frame_id=frame_id if need_kf else ds.last_kf_frame_id,
        obs_counts=obs_counts2,
        voc_children=ds.voc_children,
        voc_signed=ds.voc_signed,
        mp=mp,
    )
    kmax = m.kf_pose.shape[0]
    Tcr = Tcw @ geo.inv_T(m.kf_pose[min(max(ref2, 0), kmax - 1)])
    host = [float(slot if need_kf else -1), float(ref2), float(ds2.n_kfs), n_pts2,
            float(tracked)]
    head = torch.stack([scalar(v, Tcw, torch.float32) for v in host])
    out = torch.cat([stats, head, Tcw.reshape(-1), Tcr.reshape(-1),
                     scalar(float(compacted), Tcw, torch.float32)[None]])
    return m, ds2, out


def _frame_step_stereo(m: MapState, ds: DeviceTrackState, image_l, image_r, frame_id: int,
                       timestamp: float, since_reloc: int, cfg: SlamConfig):
    """One stereo frame: both extractions, stereo matching, undistortion,
    then _frame_step_core. image_l, image_r: [H, W] f32."""
    feats, uright, depth, _ = stereo_features(image_l, image_r, cfg)
    return _frame_step_core(m, ds, feats, uright, depth, frame_id, timestamp, since_reloc, cfg)


def _frame_step_mono(m: MapState, ds: DeviceTrackState, image, frame_id: int,
                     timestamp: float, since_reloc: int, cfg: SlamConfig):
    """One monocular frame: extraction, undistortion, then
    _frame_step_core with no right u and no depth. image: [H, W] f32."""
    feats, uright, depth, _ = mono_features(image, cfg)
    return _frame_step_core(m, ds, feats, uright, depth, frame_id, timestamp, since_reloc, cfg)


def _extract_stage(image, cfg: SlamConfig):
    """Stage A of the RGB-D pipeline: extraction only. image: [H, W] f32."""
    return orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))[0]


def _track_stage_rgbd_core(m: MapState, ds: DeviceTrackState, feats, depth_map, frame_id: int,
                           timestamp: float, since_reloc: int, cfg: SlamConfig):
    """Stage B of the RGB-D pipeline: depth per keypoint sampled on the
    device from the full depth map (the map rides to the device with the
    image), right u, undistortion, then _frame_step_core."""
    return _frame_step_core(m, ds, feats, None, None, frame_id, timestamp, since_reloc, cfg,
                            depth_map=depth_map)


# ---------------------------------------------------------------------------
# the asynchronous pipeline's transfers
# ---------------------------------------------------------------------------

# waits on a transfer that had not landed, all sites together (each site
# counts in trace's `transfer_wait.<site>`); torch's sync debug mode does
# not see event waits
transfer_waits = 0


def _wait(event, site: str):
    """Wait for a transfer's event. site: `stats` (a stats batch), `side`
    (a batch carrying detection packs, or a pack of its own) or `staging`
    (a pinned upload buffer)."""
    global transfer_waits
    if not event.query():
        transfer_waits += 1
        trace.count("transfer_wait." + site)
        with trace.span("transfer_wait." + site):
            event.synchronize()


class _Pull:
    """A device-to-host copy in flight, future-like (the reference's pull
    pool future): on the card a non-blocking copy into pinned host memory
    with an event after it, the buffer kept until the copy is read; a CPU
    tensor is ready at once. `site` names its waits (`_wait`)."""

    __slots__ = ("_host", "_event", "_site")

    def __init__(self, t: torch.Tensor, site: str):
        self._host, self._event, self._site = t, None, site
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            _wait(self._event, self._site)
        return self._host.numpy()


class _SideSlot:
    """Future-like handle of a side-channel buffer riding the next stats
    batch."""

    __slots__ = ("_value", "_force")

    def __init__(self, force):
        self._value = None
        self._force = force

    def done(self) -> bool:
        return self._value is not None

    def result(self) -> np.ndarray:
        if self._value is None:
            self._force()
        return self._value


@dataclass
class _Upload:
    """A frame's image or depth map on its way to the device: the device
    tensor, the event after its copy (None: nothing to wait for) and its
    kind ("image" -> f32; "depth": a uint16 map travels as its int16 bit
    pattern and is widened on the device)."""

    t: torch.Tensor
    event: Optional[object]
    kind: str

    def take(self) -> torch.Tensor:
        """The input for work on the current stream."""
        t = self.t
        if self.event is not None:
            s = torch.cuda.current_stream(t.device)
            s.wait_event(self.event)
            t.record_stream(s)   # allocated on the copy stream
        if self.kind == "image":
            return t.to(torch.float32)
        return t.to(torch.int32) & 0xFFFF if t.dtype == torch.int16 else t


# ---------------------------------------------------------------------------
# host-side tracker
# ---------------------------------------------------------------------------

@dataclass
class TrackOutput:
    state: int
    Tcw: Optional[np.ndarray]
    n_inliers: int
    created_kf: bool
    relative_to_kf: Optional[np.ndarray] = None
    ref_kf: int = -1


class LazyTrackOutput:
    """Handle returned for a frame of the asynchronous pipeline. Reading a
    field resolves the frame (`_flush_upto`, a host wait); a frame already
    trimmed from the resolved records reads the tracker's current state,
    as the reference's does."""

    __slots__ = ("_trk", "_fid")

    def __init__(self, trk, fid: int):
        self._trk = trk
        self._fid = fid

    def _get(self) -> TrackOutput:
        t = self._trk
        t._flush_upto(self._fid)
        out = t._resolved.get(self._fid)
        if out is None:
            return TrackOutput(t.state, t.last_Tcw, t.n_last_inliers, False, ref_kf=t.ref_kf)
        return out

    @property
    def state(self):
        return self._get().state

    @property
    def Tcw(self):
        return self._get().Tcw

    @property
    def n_inliers(self):
        return self._get().n_inliers

    @property
    def created_kf(self):
        return self._get().created_kf

    @property
    def relative_to_kf(self):
        return self._get().relative_to_kf

    @property
    def ref_kf(self):
        return self._get().ref_kf


class Tracker:
    """Host tracker: initialization and lost frames on the host path, then
    the fused frames through the asynchronous pipeline (`_frame_step_*`,
    stage A/B for RGB-D), or with `cfg.fused_tracking` False the staged
    ladder on the host path."""

    # out vectors per pinned transfer (the reference reads the same
    # environment variable); more batches in flight than MAX_BATCHES are
    # waited for
    STATS_BATCH = int(os.environ.get("STATS_BATCH", "16"))
    MAX_BATCHES = 6
    SIDE_SLOTS = 2     # detection packs per stats transfer
    UPLOAD_RING = 4    # pinned staging buffers per image shape and dtype

    def __init__(self, cfg: SlamConfig, device=None):
        check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device, "Tracker")
        self.map = ms.empty_map(cfg.max_keyframes, cfg.max_points, self._n_slots(),
                                self.device)
        self.n_kfs = 0
        # the point-slot cursor lives on the device; n_pts_host mirrors it
        # from the resolved out vectors and compactions only, as the
        # reference's does (tracking.py:1397,1675)
        self.n_pts_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self.n_pts_host = 0
        self.state = NO_IMAGES_YET
        self.last_Tcw: Optional[np.ndarray] = None
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -(1 << 30)
        self.n_last_inliers = 0
        self.new_kf_callbacks = []
        self.compact_callbacks = []   # point-arena compaction hook
        self.grow_callbacks = []      # capacity-tier hook (set by System)
        self._next_compact_kfs = 0    # top-tier compaction rate limit
        self._top_tier_warned = False
        self.reloc_fn = None          # relocalization hook (set by System)
        self.compaction_epoch = 0     # bumps on every point-arena compaction
        self.velocity: Optional[torch.Tensor] = None   # host-path motion model
        # the last host-path frame (set on host-path frames only, as the
        # reference keeps it: tracking.py:1943, 2002)
        self.last_frame: Optional[Frame] = None
        self.vo = False               # mbVO: the last frame was tracked by odometry
        self.trajectory = []          # (timestamp, Tcr, ref_kf, state)
        self.kf_ts_host = np.zeros(cfg.max_keyframes, np.float64)
        self._voc_gate = bow.gate_arrays(None, self.device)
        self._gate_active = False
        self.ds: Optional[DeviceTrackState] = None
        self.mono_init: Optional[MonocularInitializer] = None
        # the asynchronous pipeline
        self._upQ = collections.deque()      # (dispatch fn, args): uploads not dispatched
        self._stageA = collections.deque()   # (fid, ts, feats, event, depth upload)
        self._pending = collections.deque()  # (fid, ts, out vector) not shipped
        self._batchQ = collections.deque()   # (entries, pull, side slots, meta)
        self._sideQ = collections.deque()    # (flat device buffer, shape, slot)
        self._resolved = {}                  # fid -> TrackOutput
        self._side_streams = None            # (extraction, copy) on the card
        self._staging = {}                   # (shape, dtype) -> ring of (pinned, event)

    @property
    def STAGE_A_LAG(self):
        """Frames between an RGB-D frame's extraction and its tracking."""
        return self.cfg.pipeline_lag

    @property
    def n_pts(self) -> int:
        """The point-slot cursor (a host read)."""
        return int(self.n_pts_dev)

    @n_pts.setter
    def n_pts(self, v):
        self.n_pts_dev = torch.tensor(int(v), dtype=torch.int32, device=self.device)

    def _n_slots(self):
        return sum(self.cfg.orb.level_budgets())

    # -- vocabulary gate / keyframe flags ------------------------------------
    def set_vocabulary_gate(self, voc):
        self._voc_gate = bow.gate_arrays(voc, self.device)
        self._gate_active = voc is not None
        if self.ds is not None:
            self.ds = self.ds.replace(voc_children=self._voc_gate[0],
                                      voc_signed=self._voc_gate[1])

    def set_kf_erasable(self, kf_id: int):
        """Release a keyframe to KeyFrameCulling (KeyFrame::SetErase)."""
        self.map = self.map.replace(kf_no_erase=lm._set_row(self.map.kf_no_erase, kf_id, False))

    def set_kf_groups(self, kf_id: int, groups):
        """Backfill a keyframe's FeatureVector node ids (after
        KeyFrameDatabase.add)."""
        self.map = self.map.replace(kf_group=lm._set_row(self.map.kf_group, kf_id, groups))

    def frame_groups(self, feats):
        return bow.group_ids(self._voc_gate[0], self._voc_gate[1], feats.desc, feats.valid,
                             self.cfg.voc_levels)

    # -- the asynchronous pipeline -------------------------------------------
    def _streams(self):
        """(extraction stream, copy stream), made on first use. Pool
        streams: work on them never waits for the legacy default stream,
        nor it for them."""
        if self._side_streams is None:
            self._side_streams = (torch.cuda.Stream(self.device),
                                  torch.cuda.Stream(self.device))
        return self._side_streams

    def _upload(self, a, kind: str, frame_id: int) -> _Upload:
        """Start a frame input's way to the device. A tensor goes straight
        in; a host array is copied into a ring of pinned staging buffers
        and from there on the copy stream (on the CPU: copied at once)."""
        with trace.span("upload", frame_id):
            if isinstance(a, torch.Tensor):
                return _Upload(a.to(self.device), None, kind)
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint16:
                a = a.view(np.int16)   # torch's uint16 support is thin
            elif a.dtype == np.float64 and kind == "depth":
                a = a.astype(np.float32)
            if self.device.type != "cuda":
                return _Upload(torch.from_numpy(a.copy()), None, kind)
            ring = self._staging.setdefault((a.shape, a.dtype.str), collections.deque())
            if len(ring) < self.UPLOAD_RING:
                host = torch.from_numpy(a).pin_memory()
            else:
                host, ev = ring.popleft()
                _wait(ev, "staging")   # its copy left frames ago
                host.numpy()[...] = a
            cs = self._streams()[1]
            with torch.cuda.stream(cs):
                t = host.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(cs)
            ring.append((host, ev))
            return _Upload(t, ev, kind)

    def _extract_async(self, image: _Upload, frame_id: int):
        """Stage A of one frame: on the card on the extraction stream, with
        an event after it. Returns (feats, event or None)."""
        with trace.span("extract", frame_id):
            if self.device.type != "cuda":
                return _extract_stage(image.take(), self.cfg), None
            xs = self._streams()[0]
            with torch.cuda.stream(xs):
                feats = _extract_stage(image.take(), self.cfg)
                ev = torch.cuda.Event()
                ev.record(xs)
            return feats, ev

    def _finish_stageA_front(self):
        """Stage B of the oldest stage-A frame, on the current stream
        after its extraction."""
        fid, ts, feats, ev, depth = self._stageA.popleft()
        with trace.span("frame_step", fid):
            if ev is not None:
                s = torch.cuda.current_stream(self.device)
                s.wait_event(ev)
                for f in dataclasses.fields(feats):
                    getattr(feats, f.name).record_stream(s)   # made on the extraction stream
            self.map, self.ds, out = _track_stage_rgbd_core(
                self.map, self.ds, feats, depth.take(), fid, ts, fid - self.last_reloc_frame_id,
                self.cfg)
            self.n_pts_dev = self.ds.n_pts
            self._enqueue_out(fid, ts, out)

    def _dispatch_rgbd_upload(self, fid: int, ts: float, image: _Upload, depth: _Upload):
        """Dispatch one RGB-D frame whose upload started a call earlier:
        its extraction, then the tracking stage of the stage-A head
        (fid - STAGE_A_LAG). B stages run strictly in frame order, so the
        tracking is the one-frame chain's."""
        feats, ev = self._extract_async(image, fid)
        if self._stageA and len(self._stageA) >= self.STAGE_A_LAG:
            self._finish_stageA_front()
        self._stageA.append((fid, ts, feats, ev, depth))

    def _dispatch_fused(self, step_fn, frame_id: int, ts: float, *uploads):
        self._upQ.append((self._dispatch_fused_now, (step_fn, frame_id, ts) + uploads))
        self._drain_upload(n_keep=1)
        return LazyTrackOutput(self, frame_id)

    def _dispatch_fused_now(self, step_fn, frame_id: int, ts: float, *uploads):
        with trace.span("frame_step", frame_id):
            self.map, self.ds, out = step_fn(self.map, self.ds, *(u.take() for u in uploads),
                                             frame_id, ts, frame_id - self.last_reloc_frame_id,
                                             self.cfg)
            self.n_pts_dev = self.ds.n_pts
            self._enqueue_out(frame_id, ts, out)

    def _enqueue_out(self, fid: int, ts: float, out: torch.Tensor):
        self._pending.append((fid, ts, out))
        if len(self._pending) >= self.STATS_BATCH:
            self._ship_batch()

    def enqueue_side(self, flat_dev: torch.Tensor, shape):
        """Attach a device buffer to the next stats transfer; the returned
        slot is done once that transfer is resolved (the loop closer's
        detection packs)."""
        slot = _SideSlot(self._force_side)
        self._sideQ.append((flat_dev, shape, slot))
        return slot

    def _force_side(self):
        self._flush_upto(1 << 60)
        # a side buffer enqueued with no pending frame ships with empty stats
        while self._sideQ:
            a, shp, slot = self._sideQ.popleft()
            slot._value = _Pull(a, "side").result().reshape(shp)

    def _ship_batch(self):
        """The pending out vectors, padded to STATS_BATCH rows as the
        reference pads them, and up to SIDE_SLOTS equal-sized side buffers,
        flattened into one f32 buffer and copied to the host in one
        transfer."""
        if not self._pending:
            return
        entries = list(self._pending)
        self._pending.clear()
        with trace.span("ship", entries[-1][0]):
            outs = [e[2] for e in entries]
            outs += [outs[-1]] * (self.STATS_BATCH - len(outs))
            side_slots, sides = [], []
            while self._sideQ and len(sides) < self.SIDE_SLOTS:
                a, shp, slot = self._sideQ.popleft()
                if sides and a.numel() != sides[0].numel():
                    self._sideQ.appendleft((a, shp, slot))
                    break
                sides.append(a)
                side_slots.append((shp, slot))
            flat, meta = torch.stack(outs), None
            if sides:
                n_real = len(sides)
                sides += [sides[-1]] * (self.SIDE_SLOTS - n_real)
                meta = (len(outs), int(outs[0].shape[0]), int(sides[0].numel()), n_real)
                flat = torch.cat([flat.reshape(-1)] + [x.to(torch.float32) for x in sides])
            self._batchQ.append((entries, _Pull(flat, "side" if sides else "stats"),
                                 side_slots, meta))

    def _resolve_batch(self, entries, pull, side_slots=(), meta=None):
        with trace.span("resolve", entries[-1][0]):
            arr = pull.result()
            if meta is not None:
                B, out_len, S, n_real = meta
                stats = arr[:B * out_len].reshape(B, out_len)
                for i, (shp, slot) in enumerate(side_slots[:n_real]):
                    off = B * out_len + i * S
                    slot._value = arr[off:off + S].reshape(shp)
            else:
                stats = arr
            for (fid, ts, _), row in zip(entries, stats):
                self._resolve_entry(fid, ts, row)

    def _flush_ready(self, max_batches: Optional[int] = None):
        """Resolve the shipped batches whose transfers have landed; wait
        for the oldest while more than max_batches are in flight."""
        if max_batches is None:
            max_batches = self.MAX_BATCHES
        while self._batchQ:
            entries, pull, side_slots, meta = self._batchQ[0]
            if not pull.done() and len(self._batchQ) <= max_batches:
                break
            self._batchQ.popleft()
            self._resolve_batch(entries, pull, side_slots, meta)

    def _drain_upload(self, n_keep: int = 0):
        """Dispatch queued-upload frames until at most n_keep remain."""
        while len(self._upQ) > n_keep:
            fn, args = self._upQ.popleft()
            fn(*args)

    def _flush_upto(self, fid: int):
        """Dispatch, track, ship and resolve every frame up to fid."""
        with trace.span("flush", fid if 0 <= fid < 1 << 60 else -1):
            self._drain_upload(0)
            while self._stageA and self._stageA[0][0] <= fid:
                self._finish_stageA_front()
            if self._pending and self._pending[0][0] <= fid:
                self._ship_batch()
            while self._batchQ and self._batchQ[0][0] and self._batchQ[0][0][0][0] <= fid:
                entries, pull, side_slots, meta = self._batchQ.popleft()
                self._resolve_batch(entries, pull, side_slots, meta)

    def _flush_all(self):
        """Resolve every frame in the pipeline and pump the mapper to idle."""
        self._flush_upto(1 << 60)
        self._drain_mapper()

    # -- per-frame entry -----------------------------------------------------
    def _fused_ok(self) -> bool:
        # the staged ladder and localization-only frames take the host path
        # (the VO fallback needs the previous frame's features and depth;
        # the reference's _fused_ok, tracking.py:1516-1525). The state is the
        # lagged one: frames already dispatched go on through the device
        # step after a frame that turns out LOST
        return (self.cfg.fused_tracking and self.state == OK and self.ds is not None
                and not self.cfg.localization_only)

    def track_rgbd_arrays(self, frame_id: int, ts: float, image, depth_map):
        self._maybe_grow(frame_id)
        self._flush_ready()
        if self._fused_ok():
            trace.count("frames.fused")
            # one call late: the upload overlaps the previous frame's work
            self._upQ.append((self._dispatch_rgbd_upload,
                              (frame_id, ts, self._upload(image, "image", frame_id),
                               self._upload(depth_map, "depth", frame_id))))
            self._drain_upload(n_keep=1)
            return LazyTrackOutput(self, frame_id)
        self._flush_all()
        return self.track(build_frame_rgbd(frame_id, ts, image, depth_map, self.cfg,
                                           self.device))

    def track_stereo_arrays(self, frame_id: int, ts: float, image_l, image_r):
        self._maybe_grow(frame_id)
        self._flush_ready()
        if self._fused_ok():
            trace.count("frames.fused")
            return self._dispatch_fused(_frame_step_stereo, frame_id, ts,
                                        self._upload(image_l, "image", frame_id),
                                        self._upload(image_r, "image", frame_id))
        self._flush_all()
        return self.track(build_frame_stereo(frame_id, ts, image_l, image_r, self.cfg,
                                             self.device))

    def track_mono_arrays(self, frame_id: int, ts: float, image):
        self._maybe_grow(frame_id)
        self._flush_ready()
        if self._fused_ok():
            trace.count("frames.fused")
            return self._dispatch_fused(_frame_step_mono, frame_id, ts,
                                        self._upload(image, "image", frame_id))
        self._flush_all()
        return self.track(build_frame_mono(frame_id, ts, image, self.cfg, self.device))

    def track(self, frame: Frame) -> TrackOutput:
        """The host path: initialization, a frame after LOST, every frame in
        localization-only mode, and every frame of the staged ladder
        (`cfg.fused_tracking` False)."""
        self._flush_all()
        trace.count("frames.host_path")
        with trace.span("host_path", frame.frame_id):
            out = self._track_host(frame)
        if out.Tcw is not None:
            Tcr = np.eye(4) if out.relative_to_kf is None else out.relative_to_kf
            self.trajectory.append((frame.timestamp, Tcr, out.ref_kf, out.state))
        if self.state == OK and self.cfg.fused_tracking:
            self._sync_ds_from_host(frame)
            if out.created_kf and self.cfg.chunked_mapper:
                # host-path keyframes run the machine to completion at once
                # (the monolithic mapper already ran in the keyframe callbacks)
                self.ds = self.ds.replace(mp=self.ds.mp.replace(phase=1, kf=self.ref_kf))
                self._drain_mapper()
        return out

    def _track_host(self, frame: Frame) -> TrackOutput:
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            if self.cfg.sensor == MONOCULAR:
                # MonocularInitialization (Tracking.cc:563-737)
                if self.mono_init is None:
                    self.mono_init = MonocularInitializer(self.cfg)
                ok = self.mono_init.try_initialize(self, frame)
            else:
                ok = self._stereo_initialization(frame)
            self.state = OK if ok else NOT_INITIALIZED
            return TrackOutput(state=self.state, Tcw=frame.Tcw.cpu().numpy() if ok else None,
                               n_inliers=0, created_kf=ok, ref_kf=self.ref_kf)
        cfg = self.cfg
        tracked, n_inliers, stats = False, 0, None
        if self.state == OK and not cfg.fused_tracking:
            # the staged ladder: the reference's fallback ladder with host
            # branch decisions (tracking.py:1822-1827)
            tracked, n_inliers = self._staged_retry(frame)
        elif self.state == OK:
            # an OK frame off the device step (localization-only mode):
            # the fused tracking chain, called from the host
            T_last = self._last_Tcw_tensor()
            have_vel = self.velocity is not None
            T_pred = _apply_velocity(self.velocity, T_last) if have_vel else T_last
            self.map, Tcw, assoc, st = _track_core(
                self.map, frame.feats, frame.uright, frame.depth, T_pred, T_last, have_vel,
                self.last_frame.assoc, self.ref_kf, frame.frame_id, self.last_kf_frame_id,
                self.n_kfs, cfg, voc_gate=self._voc_gate)
            stats = st.cpu().numpy()
            tracked = stats[S_TRACKED] > 0
            n_inliers = int(stats[S_N_INL])
            # the reloc window's stricter inlier floor (Tracking.cc:967-971)
            if (tracked and frame.frame_id - self.last_reloc_frame_id < cfg.fps
                    and n_inliers < C.TRACK_LOCAL_MAP_MIN_INLIERS_RECENT_RELOC):
                tracked = False
            if tracked:
                frame.Tcw, frame.assoc = Tcw, assoc
            if stats[S_COARSE_OK] > 0 and int(stats[S_BEST_LOCAL]) >= 0:
                # TrackLocalMap updates the reference KF before the final gate
                self.ref_kf = int(stats[S_BEST_LOCAL])
            if not tracked:
                # a weak frame: the stage-by-stage ladder with host decisions
                tracked, n_inliers = self._staged_retry(frame)
                if tracked:
                    stats = None
        vo_frame = False
        if not tracked and self.reloc_fn is not None:
            # Relocalization (Tracking.cc:436-448 -> Relocalization); in
            # localization mode it is tried on every untracked frame and
            # preferred over odometry (Tracking.cc:352-390)
            with trace.span("reloc"):
                ok, Tcw_r, assoc_r = self.reloc_fn(frame)
            if ok:
                frame.Tcw, frame.assoc = Tcw_r, assoc_r
                self.velocity = None
                self.last_reloc_frame_id = frame.frame_id
                self.last_Tcw = Tcw_r.cpu().numpy()
                n_inliers = self._track_local_map(frame)
                tracked = n_inliers >= C.TRACK_LOCAL_MAP_MIN_INLIERS
                stats = None
        if (not tracked and cfg.localization_only and self.state == OK
                and cfg.sensor != MONOCULAR and self.last_frame is not None
                and self.last_Tcw is not None and self.last_frame.Tcw is not None):
            # mbVO: off the map, odometry against the last host-path
            # frame's depth points, lifted through that frame's own pose
            # (it can be older than last_Tcw right after a mode switch)
            T_prev = self._last_Tcw_tensor()
            T_pred = (_apply_velocity(self.velocity, T_prev) if self.velocity is not None
                      else T_prev)
            lf = self.last_frame
            Tcw_vo, ninl_vo = _track_vo_frame(lf.feats, lf.depth, lf.Tcw, T_pred, frame.feats,
                                              frame.uright, cfg)
            if int(ninl_vo) >= 10:
                frame.Tcw = Tcw_vo
                frame.assoc = torch.full((frame.n_feat,), -1, dtype=torch.int32,
                                         device=self.device)
                n_inliers = int(ninl_vo)
                tracked = vo_frame = True
                stats = None
        if not tracked:
            self.state = LOST
            return TrackOutput(LOST, None, 0, False, ref_kf=self.ref_kf)
        self.vo = vo_frame
        self.state = OK
        if self.last_Tcw is not None:
            self.velocity = _compose_velocity(frame.Tcw, self._last_Tcw_tensor())
        self.last_Tcw = frame.Tcw.cpu().numpy()
        self.last_frame = frame
        self.n_last_inliers = n_inliers
        created_kf = (stats is not None and stats[S_NEED_KF] > 0
                      and self.n_kfs < cfg.max_keyframes - 1)
        if stats is None and not cfg.localization_only:
            # after a retry or relocalization: the host keyframe policy
            created_kf = self._need_new_keyframe(frame, n_inliers)
        if created_kf:
            self._create_keyframe(frame)
        Tcr = frame.Tcw @ geo.inv_T(self.map.kf_pose[self.ref_kf])
        return TrackOutput(state=OK, Tcw=self.last_Tcw, n_inliers=n_inliers,
                           created_kf=created_kf, relative_to_kf=Tcr.cpu().numpy(),
                           ref_kf=self.ref_kf)

    def _last_Tcw_tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.last_Tcw, np.float32)).to(self.device)

    def _staged_retry(self, frame: Frame):
        """Per-stage tracking with host branch decisions (the reference's
        fallback ladder, Tracking.cc:300-345): every OK frame of the staged
        mode, and a frame the fused chain reported weak. Host reads: the
        match count and the inlier count at each rung taken. Returns
        (tracked, n_inliers)."""
        trace.count("frames.staged_retry")
        cfg = self.cfg
        ok = False
        T_last = self._last_Tcw_tensor()
        if self.velocity is not None:
            T_pred = _apply_velocity(self.velocity, T_last)
            th = 7.0 if cfg.sensor != MONOCULAR else 15.0
            assoc, nm, _ = _match_against_points(self.map, self.last_frame.assoc, T_pred,
                                                 frame.feats, frame.uright, th, cfg,
                                                 use_frustum_band=False)
            if int(nm) < C.TRACK_MOTION_MIN_MATCHES:
                assoc, nm, _ = _match_against_points(self.map, self.last_frame.assoc, T_pred,
                                                     frame.feats, frame.uright, 2 * th, cfg,
                                                     use_frustum_band=False)
            if int(nm) >= C.TRACK_MOTION_MIN_MATCHES:
                Tcw, assoc, ninl = _pose_opt_from_assoc(self.map, T_pred, frame.feats,
                                                        frame.uright, assoc, cfg)
                if int(ninl) >= 10:
                    frame.Tcw, frame.assoc = Tcw, assoc
                    ok = True
        if not ok and self.ref_kf >= 0:
            assoc, nm = _match_ref_kf(self.map, self.ref_kf, frame.feats, cfg,
                                      frame_groups=self.frame_groups(frame.feats))
            if int(nm) >= C.TRACK_REF_KF_MIN_MATCHES:
                Tcw, assoc, ninl = _pose_opt_from_assoc(self.map, T_last, frame.feats,
                                                        frame.uright, assoc, cfg)
                if int(ninl) >= 10:
                    frame.Tcw, frame.assoc = Tcw, assoc
                    ok = True
        if not ok:
            return False, 0
        n_inl = self._track_local_map(frame)
        return n_inl >= C.TRACK_LOCAL_MAP_MIN_INLIERS, n_inl

    def _track_local_map(self, frame: Frame) -> int:
        """Tracking::TrackLocalMap: expand to the covisible neighbourhood,
        re-search and re-optimize."""
        cfg = self.cfg
        kf_ids, pt_ids = _select_local_map(self.map, frame.assoc)
        th = 3.0 if cfg.sensor == RGBD else 1.0
        assoc2, _, visible = _match_against_points(self.map, pt_ids, frame.Tcw, frame.feats,
                                                   frame.uright, th, cfg)
        assoc = torch.where(frame.assoc >= 0, frame.assoc, assoc2)
        frame.Tcw, frame.assoc, n_inl = _pose_opt_from_assoc(
            self.map, frame.Tcw, frame.feats, frame.uright, assoc, cfg)
        self.map = _update_point_counters(self.map, pt_ids, visible, frame.assoc)
        best = int(kf_ids[0])
        if best >= 0:
            self.ref_kf = best
        return int(n_inl)

    def _need_new_keyframe(self, frame: Frame, n_inliers: int) -> bool:
        """Tracking::NeedNewKeyFrame on the host (post-relocalization
        frames): conditions c1a/c1b/c1c/c2; monocular has no close-point
        rule and no c1c, and a stricter reference ratio. Never in
        localization-only mode."""
        cfg = self.cfg
        if cfg.localization_only:
            return False
        if self.n_kfs >= cfg.max_keyframes - 1:
            return False
        if frame.frame_id - self.last_reloc_frame_id < cfg.fps and self.n_kfs > cfg.fps:
            return False
        frames_since_kf = frame.frame_id - self.last_kf_frame_id
        min_obs = 2 if self.n_kfs <= 2 else 3
        pmax = cfg.max_points
        obs_counts = ms.point_observation_counts(self.map)
        ref_obs = self.map.kf_obs[self.ref_kf]
        ref_pid = _clip(ref_obs, pmax)
        n_ref_matches = int(torch.sum((ref_obs >= 0) & self.map.pt_valid[ref_pid]
                                      & (obs_counts[ref_pid] >= min_obs)))
        need_close = False
        if cfg.sensor != MONOCULAR:   # close points (Tracking.cc:1005-1022)
            close = (frame.depth > 0) & (frame.depth < cfg.depth_threshold)
            tracked_close = int(torch.sum((frame.assoc >= 0) & close))
            nontracked_close = int(torch.sum((frame.assoc < 0) & close))
            need_close = tracked_close < 100 and nontracked_close > 70
        th_ref = 0.9 if cfg.sensor == MONOCULAR else 0.75
        if self.n_kfs < 2:
            th_ref = 0.4
        c1a = frames_since_kf >= cfg.fps
        c1b = frames_since_kf >= 1
        c1c = cfg.sensor != MONOCULAR and (n_inliers < n_ref_matches * 0.25 or need_close)
        c2 = (n_inliers < n_ref_matches * th_ref or need_close) and n_inliers > 15
        return bool((c1a or c1b or c1c) and c2)

    def _create_keyframe(self, frame: Frame):
        """Tracking::CreateNewKeyFrame on the host path."""
        slot = self.n_kfs
        with trace.span("kf_create"):
            self.map, n_created, kf_obs_row = _create_kf_core(
                self.map, slot, self.n_pts_dev, frame.frame_id, frame.timestamp, frame.Tcw,
                frame.feats, frame.uright, frame.depth, frame.assoc, self.ref_kf, self.cfg)
        self.n_kfs += 1
        self.n_pts_dev = self.n_pts_dev + n_created
        frame.assoc = kf_obs_row
        self.ref_kf = slot
        self.last_kf_frame_id = frame.frame_id
        self.kf_ts_host[slot] = frame.timestamp
        with trace.span("kf_callbacks"):
            for cb in self.new_kf_callbacks:
                cb(slot)

    def _resolve_entry(self, fid: int, ts: float, s: np.ndarray):
        """Host state update from one frame's packed out vector, when its
        batch resolves: the lagged counterpart of the reference's per-frame
        bookkeeping (Tracking.cc:423-504). Keeps the last 16 of 32 outputs
        for LazyTrackOutput."""
        tracked = s[X_TRACKED] > 0
        Tcw = s[X_TCW:X_TCW + 16].reshape(4, 4).copy()
        Tcr = s[X_TCR:X_TCR + 16].reshape(4, 4).copy()
        self.n_kfs = int(s[X_N_KFS])
        ref = int(s[X_REF_KF])
        self.ref_kf = ref
        self.n_last_inliers = int(s[S_N_INL])
        kf_slot = int(s[X_KF_SLOT])
        self.n_pts_host = int(s[X_N_PTS])
        if s[X_COMPACTED] > 0:
            self.compaction_epoch += 1
            for cb in self.compact_callbacks:
                cb()
        if tracked:
            self.state = OK
            self.last_Tcw = Tcw
            self.trajectory.append((ts, Tcr, ref, OK))
        else:
            self.state = LOST
            self.velocity = None
        if kf_slot >= 0:
            self.kf_ts_host[kf_slot] = ts
            self.last_kf_frame_id = fid
            self.n_pts_dev = self.ds.n_pts   # the newest dispatched frame's cursor
            with trace.span("kf_callbacks", fid):
                for cb in self.new_kf_callbacks:
                    cb(kf_slot)
            if not self.cfg.chunked_mapper:
                # the monolithic mapper moved the point cursor and the
                # observations (tracking.py:1431-1440)
                self.ds = self.ds.replace(n_pts=self.n_pts_dev,
                                          obs_counts=ms.point_observation_counts(self.map))
        self._resolved[fid] = TrackOutput(
            state=self.state, Tcw=Tcw if tracked else None, n_inliers=self.n_last_inliers,
            created_kf=kf_slot >= 0, relative_to_kf=Tcr if tracked else None, ref_kf=ref)
        if len(self._resolved) > 32:
            for k in sorted(self._resolved)[:-16]:
                del self._resolved[k]

    def _sync_ds_from_host(self, frame: Frame):
        """Device tracker state after a host-path frame (initialization or
        relocalization), with a fresh idle mapper machine."""
        vel = self.velocity
        self.ds = DeviceTrackState(
            T_last=frame.Tcw.to(torch.float32).reshape(4, 4),
            velocity=torch.eye(4, dtype=torch.float32, device=self.device) if vel is None
            else vel.to(torch.float32),
            have_vel=vel is not None,
            last_assoc=frame.assoc.to(torch.int32),
            ref_kf=self.ref_kf,
            n_kfs=self.n_kfs,
            n_pts=self.n_pts_dev,
            last_kf_frame_id=self.last_kf_frame_id,
            obs_counts=ms.point_observation_counts(self.map),
            voc_children=self._voc_gate[0],
            voc_signed=self._voc_gate[1],
            mp=lm.empty_machine(self.cfg, self._n_slots(), self.device),
        )

    def _drain_mapper(self):
        """Pump the mapper machine to idle (System::Shutdown's LocalMapping
        drain); nothing to drain without the chunked mapper."""
        if self.ds is None or not self.cfg.chunked_mapper:
            return
        m, n_pts, oc, mp = self.map, self.ds.n_pts, self.ds.obs_counts, self.ds.mp
        if mp.phase == 0:
            return
        while mp.phase != 0:
            m, n_pts, oc, mp = lm.mapper_machine_step(m, n_pts, oc, mp, self.cfg)
        self.map = m
        self.ds = self.ds.replace(n_pts=n_pts, obs_counts=oc, mp=mp)
        self.n_pts_dev = n_pts

    # -- capacity tiers ------------------------------------------------------
    def _maybe_grow(self, frame_id: int = -1):
        """Grow the map to the next capacity tier when ~85% full, read from
        the host mirrors (no device read in the frame loop): the keyframe
        count at 85% of max_keyframes, or the point-cursor mirror at 85% of
        max_points, each up to its `_cap`. Growth drains the pipeline and
        the mapper, pads every map array (ms.grow_map), swaps cfg
        (capacities ride in it) and rebuilds the tier-shaped device state;
        System passes the new cfg on through grow_callbacks. At the top
        tier a full point cursor compacts the arena instead, with
        hysteresis.

        Where the device step does not compact the arena (the monolithic
        mapper, the staged ladder, before the first device state), a full
        cursor over a half-empty arena compacts it on the host instead of
        growing."""
        cfg = self.cfg
        if not cfg.grow_capacity:
            return
        kmax, pmax = cfg.max_keyframes, cfg.max_points
        need_k = self.n_kfs >= int(kmax * 0.85) and kmax < cfg.max_keyframes_cap
        cursor_full = self.n_pts_host >= int(pmax * 0.85)
        if not (need_k or cursor_full):
            return
        with trace.span("grow", frame_id):
            dev_compacts = cfg.chunked_mapper and cfg.fused_tracking and self.ds is not None
            if cursor_full and not need_k and not dev_compacts:
                # the cursor filled with dead slots (triangulation burns ~8 per
                # survivor): with the live points under half the arena, compact
                # at the same tier (tracking.py:1605-1619)
                self._flush_all()
                if int(torch.sum(self.map.pt_valid)) < int(pmax * 0.5):
                    self._compact_points()
                    return
            need_p = cursor_full and pmax < cfg.max_points_cap
            if not (need_k or need_p):
                # the point cursor is full at the top tier. Compaction helps
                # only with dead slots to reclaim, and each attempt drains the
                # mapper: >= 15% reclaimable, >= 4 keyframes since the last try
                if self.n_kfs < self._next_compact_kfs:
                    return
                self._next_compact_kfs = self.n_kfs + 4
                self._flush_all()
                n_live = int(torch.sum(self.map.pt_valid))
                if n_live >= int(pmax * 0.85):
                    if not self._top_tier_warned:
                        print(f"[tracker] WARNING: point arena at top tier with {n_live}/{pmax} "
                              f"live; point creation degrades until culling frees slots")
                        self._top_tier_warned = True
                    return
                print(f"[tracker] point arena at top tier (cursor {self.n_pts_host}/{pmax}); "
                      f"compacting")
                self._compact_points()
                return
            self._grow_to(min(kmax * 4, cfg.max_keyframes_cap) if need_k else kmax,
                          min(pmax * 4, cfg.max_points_cap) if need_p else pmax)

    def _grow_to(self, new_k: int, new_p: int):
        """Move the map and cfg to the tier (new_k keyframes, new_p points)
        and tell the grow_callbacks."""
        self._flush_all()
        self.map = ms.grow_map(self.map, new_k, new_p)
        self.kf_ts_host = np.concatenate([self.kf_ts_host,
                                          np.zeros(new_k - len(self.kf_ts_host), np.float64)])
        self.cfg = dataclasses.replace(self.cfg, max_keyframes=new_k, max_points=new_p)
        if self.ds is not None:
            # the machine is idle; its window capacities follow the tier
            self.ds = self.ds.replace(
                obs_counts=ms.point_observation_counts(self.map),
                mp=lm.empty_machine(self.cfg, self._n_slots(), self.device))
        for cb in self.grow_callbacks:
            cb(self.cfg)

    def _compact_points(self):
        """Compact the point arena (ms.compact_points) and remap every
        point id held outside the map. Call only with the mapper drained."""
        for cb in self.compact_callbacks:
            cb()   # e.g. abort a background GBA whose snapshot holds old ids
        with trace.span("compact"):
            m2, n_live, remap = ms.compact_points(self.map)
        self.map = m2
        self.compaction_epoch += 1
        n_live = int(n_live)
        print(f"[tracker] compacted point arena: cursor {self.n_pts_host} -> {n_live} "
              f"live slots")
        self.n_pts = self.n_pts_host = n_live
        pmax = self.map.pt_pos.shape[0]
        if self.ds is not None:
            la = self.ds.last_assoc
            self.ds = self.ds.replace(
                last_assoc=torch.where(la >= 0, remap[_clip(la, pmax)], -1).to(torch.int32),
                n_pts=self.n_pts_dev, obs_counts=ms.point_observation_counts(self.map))
        lf = self.last_frame
        if lf is not None and lf.assoc is not None:
            lf.assoc = torch.where(lf.assoc >= 0, remap[_clip(lf.assoc, pmax)],
                                   -1).to(torch.int32)

    def _stereo_initialization(self, frame: Frame) -> bool:
        """Tracking::StereoInitialization: >= 500 features; identity pose;
        every positive-depth feature becomes a map point."""
        if int(torch.sum(frame.feats.valid)) < 500:
            return False
        frame.Tcw = torch.eye(4, dtype=torch.float32, device=self.device)
        assoc = torch.full((frame.n_feat,), -1, dtype=torch.int32, device=self.device)
        groups = self.frame_groups(frame.feats) if self._gate_active else None
        self.map, n_created, kf_obs_row = _create_kf_core(
            self.map, 0, torch.zeros((), dtype=torch.int32, device=self.device),
            frame.frame_id, frame.timestamp, frame.Tcw, frame.feats, frame.uright,
            frame.depth, assoc, -1, self.cfg, max_new=self._n_slots(), create_all_depth=True,
            groups=groups)
        self.n_kfs = 1
        self.n_pts_dev = n_created
        frame.assoc = kf_obs_row
        self.ref_kf = 0
        self.last_kf_frame_id = frame.frame_id
        self.kf_ts_host[0] = frame.timestamp
        self.last_Tcw = np.eye(4, dtype=np.float32)
        self.last_frame = frame
        with trace.span("kf_callbacks"):
            for cb in self.new_kf_callbacks:
                cb(0)
        return self.n_pts > 0
