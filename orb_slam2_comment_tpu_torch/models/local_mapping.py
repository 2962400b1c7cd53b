"""The local mapper — the port of
`orb_slam2_comment_tpu/models/local_mapping.py` (the reference's
LocalMapping thread, src/LocalMapping.cc:47-112), in its two forms.

Chunked (`cfg.chunked_mapper` and `cfg.fused_tracking`, the default): one
keyframe's pass is the phase table start -> tri -> fuse -> refresh -> ba1
-> ba2 -> ba3 -> kfcull; `mapper_machine_step` runs one phase per call,
at the end of each frame step. The machine's phase and keyframe are host
integers here (the port's tracker is synchronous), so choosing a phase
costs no device read.

Monolithic (either flag off): `LocalMapper.process`, a keyframe callback,
runs the whole pass at once (`_mapper_kernel`), with the whole-map
descriptor and statistics refresh and one `local_bundle_adjustment`.

Every `.at[idx].set` of the reference whose index can repeat goes through
`scatter_set` (last update wins, as XLA:CPU applies them); float
scatter-adds go through `segment_sum` so CUDA runs stay deterministic.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.models import map_state as ms
from orb_slam2_comment_tpu_torch.models.map_state import MapState
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import matching, optim
from orb_slam2_comment_tpu_torch.ops.orb import FrameFeatures
from orb_slam2_comment_tpu_torch.ops.scatter import const, scalar, scatter_set, segment_sum, top_k
from orb_slam2_comment_tpu_torch.utils import trace
from orb_slam2_comment_tpu_torch.utils.config import MONOCULAR, SlamConfig

# the reference's former fixed window and neighbour capacities, public
# beside the per-run SlamConfig fields (ba_free_kfs, ba_fixed_kfs,
# ba_points, tri_neighbors, fuse_neighbors)
NC_FREE = 12
NC_FIXED = 12
NP_BA = 2048
TRI_MAX_NEW = 128
N_TRI_NEIGHBORS = 5
N_FUSE_NEIGHBORS = 5
MAX_DESC_OBS = 12
N_CULL_CANDIDATES = 6
MAX_REPARENT_CHILDREN = 8


def _inv_sigma2(cfg: SlamConfig, device) -> torch.Tensor:
    return const(tuple(1.0 / (cfg.scale_factor ** (2 * l)) for l in range(cfg.n_levels)),
                 device)


def _clip(ids, n: int) -> torch.Tensor:
    return torch.clamp(ids, 0, n - 1).long()


def _kf_feats(m: MapState, k) -> FrameFeatures:
    return FrameFeatures(
        xy=m.kf_xy[k],
        response=torch.zeros_like(m.kf_angle[k]),
        angle=m.kf_angle[k],
        octave=m.kf_octave[k],
        desc=m.kf_desc[k],
        valid=m.kf_feat_valid[k],
    )


def _hamming_words(x: torch.Tensor) -> torch.Tensor:
    """Bit count of [..., 8] int32 words (a 256-bit descriptor XOR) summed
    over the last axis, in int32: SWAR byte counts (the arithmetic shifts'
    sign bits fall outside each mask), summed over the words while every
    byte holds at most 64, then the four bytes added."""
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = ((v + (v >> 4)) & 0x0F0F0F0F).sum(-1, dtype=torch.int32)
    v = (v & 0x00FF00FF) + ((v >> 8) & 0x00FF00FF)
    return (v & 0xFFFF) + (v >> 16)


def _set_row(arr: torch.Tensor, k, row) -> torch.Tensor:
    out = arr.clone()
    out[k] = row
    return out


# ---------------------------------------------------------------------------
# point statistics refresh
# ---------------------------------------------------------------------------

def _distinctive_descriptors(key: torch.Tensor, n_rows: int, desc: torch.Tensor):
    """MapPoint::ComputeDistinctiveDescriptors (src/MapPoint.cc:242-307)
    for n_rows groups at once. key [M] in [0, n_rows] gives each
    observation's group (n_rows: none); desc [M, 8] its descriptor. One
    stable sort by key ranks the observations of each group in table
    order; the first MAX_DESC_OBS fill [n_rows, O, 8] slots, and the slot
    whose median Hamming distance to the group's others (itself included)
    is least wins, the first such slot on a tie. Returns (descriptor
    [n_rows, 8], observations per group [n_rows]; 0 = no descriptor)."""
    O = MAX_DESC_OBS
    dev = key.device
    order = torch.sort(key, stable=True).indices
    k_sorted = key[order]
    idx = torch.arange(k_sorted.shape[0], device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          k_sorted[1:] != k_sorted[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start
    keep = (k_sorted < n_rows) & (rank < O)
    slots = torch.zeros((n_rows + 1, O, 8), dtype=torch.int32, device=dev)
    # kept (group, rank) pairs are distinct; everything else lands on row n_rows
    slots[torch.where(keep, k_sorted, n_rows), torch.clamp(rank, 0, O - 1)] = desc[order]
    slots = slots[:n_rows]
    cnt = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev).index_add_(
        0, k_sorted, (k_sorted < n_rows).to(torch.int64))[:n_rows]
    n_obs = torch.clamp(cnt, max=O)

    dist = _hamming_words(slots[:, :, None, :] ^ slots[:, None, :, :])
    slot_ok = torch.arange(O, device=dev)[None, :] < n_obs[:, None]
    big = 1 << 20
    dist = torch.where(slot_ok[:, None, :], dist, big)
    dsort = torch.sort(dist, dim=-1).values
    med_idx = torch.clamp((n_obs - 1) // 2, 0, O - 1)
    median = torch.gather(dsort, -1, med_idx[:, None, None].expand(n_rows, O, 1))[..., 0]
    best = torch.argmin(torch.where(slot_ok, median, big), dim=-1)
    return slots[torch.arange(n_rows, device=dev), best], cnt


def update_point_descriptors(m: MapState) -> MapState:
    """Every valid point's representative descriptor from its first
    MAX_DESC_OBS observations in (keyframe, feature) order (the monolithic
    mapper's whole-map refresh)."""
    pmax = m.pt_pos.shape[0]
    ok = (m.kf_obs >= 0) & m.kf_valid[:, None] & m.kf_feat_valid
    key = torch.where(ok, m.kf_obs, pmax).reshape(-1).long()
    best_desc, cnt = _distinctive_descriptors(key, pmax, m.kf_desc.reshape(-1, 8))
    has = (cnt > 0) & m.pt_valid
    return m.replace(pt_desc=torch.where(has[:, None], best_desc, m.pt_desc))


def refresh_point_stats_for_kf(m: MapState, kf_id: int, cfg: SlamConfig) -> MapState:
    """Distinctive descriptor (min-median Hamming over up to 12
    observations, MapPoint::ComputeDistinctiveDescriptors), mean viewing
    normal and scale band (UpdateNormalAndDepth) for the points keyframe
    kf_id observes."""
    Kmax, N = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    dev = m.kf_obs.device
    arN = torch.arange(N, device=dev)
    row = m.kf_obs[kf_id]
    pid = _clip(row, pmax)
    tgt = (row >= 0) & m.pt_valid[pid] & m.kf_feat_valid[kf_id]
    first_slot = torch.full((pmax,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, pid, torch.where(tgt, arN, N), reduce="amin")
    is_first = tgt & (first_slot[pid] == arN)

    flat_pt = m.kf_obs.reshape(-1)
    fp = _clip(flat_pt, pmax)
    okobs = ((flat_pt >= 0) & m.kf_valid.repeat_interleave(N)
             & m.kf_feat_valid.reshape(-1))
    fs = first_slot[fp]
    r_t = torch.where(okobs & (fs < N), fs, N)
    best_desc, cnt = _distinctive_descriptors(r_t, N, m.kf_desc.reshape(-1, 8))
    has_desc = cnt > 0

    Rt = m.kf_pose[:, :3, :3].transpose(1, 2)
    centers = -(Rt @ m.kf_pose[:, :3, 3:])[..., 0]
    vec = m.pt_pos[fp] - centers.repeat_interleave(N, 0)
    unit = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-9)
    nsum = segment_sum(unit, r_t, N)
    normal = nsum / torch.clamp(cnt.to(torch.float32), min=1.0)[:, None]

    refk = _clip(m.pt_ref_kf[pid], Kmax)
    ref_dist = torch.linalg.norm(m.pt_pos[pid] - centers[refk], dim=-1)
    match = m.kf_obs[refk] == pid[:, None].to(torch.int32)
    slot_in_ref = torch.argmax(match.to(torch.int8), dim=1)
    has_slot = torch.any(match, dim=1)
    octv = torch.where(has_slot, m.kf_octave[refk, slot_in_ref], 0)
    sf = torch.full((), float(cfg.scale_factor), dtype=torch.float32, device=dev)
    max_dist = ref_dist * torch.pow(sf, octv.to(torch.float32))
    min_dist = max_dist / (float(cfg.scale_factor) ** (float(cfg.n_levels) - 1.0))

    wd = is_first & has_desc
    wn = is_first & (cnt > 0)
    wb = is_first & has_slot
    return m.replace(
        pt_desc=scatter_set(m.pt_desc, pid,
                            torch.where(wd[:, None], best_desc, m.pt_desc[pid])),
        pt_normal=scatter_set(m.pt_normal, pid,
                              torch.where(wn[:, None], normal, m.pt_normal[pid])),
        pt_max_dist=scatter_set(m.pt_max_dist, pid,
                                torch.where(wb, max_dist, m.pt_max_dist[pid])),
        pt_min_dist=scatter_set(m.pt_min_dist, pid,
                                torch.where(wb, min_dist, m.pt_min_dist[pid])),
    )


# ---------------------------------------------------------------------------
# point and keyframe culling
# ---------------------------------------------------------------------------

def cull_points(m: MapState, current_kf: int) -> MapState:
    """MapPointCulling (src/LocalMapping.cc:170-205) plus the orphan rule."""
    obs = ms.point_observation_counts(m)
    age = current_kf - m.pt_first_kf
    found_ratio = m.pt_found.to(torch.float32) / torch.clamp(
        m.pt_visible.to(torch.float32), min=1.0)
    recent = (m.pt_first_kf >= 0) & (age <= 3)
    bad = recent & ((found_ratio < C.MIN_FOUND_RATIO)
                    | ((age >= 2) & (obs < C.MIN_OBS_FOR_POINT)))
    bad = bad | (obs == 0)
    new_valid = m.pt_valid & ~bad
    pmax = m.pt_pos.shape[0]
    obs_ok = (m.kf_obs >= 0) & new_valid[_clip(m.kf_obs, pmax)]
    return m.replace(pt_valid=new_valid,
                     kf_obs=torch.where(obs_ok, m.kf_obs, torch.full_like(m.kf_obs, -1)))


def cull_orphans(m: MapState) -> MapState:
    obs = ms.point_observation_counts(m)
    return m.replace(pt_valid=m.pt_valid & (obs > 0))


def cull_keyframes(m: MapState, kf_id: int, cfg: SlamConfig) -> MapState:
    """KeyFrameCulling (src/LocalMapping.cc:632-758): a covisible neighbour
    is retired if >=90% of its close points are seen by >=3 other KFs at the
    same or finer scale; its children are re-parented by best covisibility
    (KeyFrame::SetBadFlag). Candidates run in order; a culled KF stops
    counting toward later candidates' support. One host read per candidate
    (whether it is culled)."""
    kmax, N = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    dev = m.kf_obs.device
    w = ms.covisibility_weights(m, kf_id)
    _, cand = top_k(w, N_CULL_CANDIDATES)
    ncand = N_CULL_CANDIDATES
    total_obs = ms.point_observation_counts(m)
    cand_obs = m.kf_obs[cand]
    cand_pid = _clip(cand_obs, pmax)
    cand_ok = (cand_obs >= 0) & m.pt_valid[cand_pid] & m.kf_feat_valid[cand]
    cand_seen = cand_ok
    if cfg.sensor != MONOCULAR:
        d = m.kf_depth[cand]
        cand_seen = cand_seen & (d > 0) & (d < cfg.depth_threshold)
    cflat = torch.arange(ncand, device=dev)[:, None] * pmax + cand_pid   # [C, N]
    oct_in = torch.full((ncand * pmax,), 127, dtype=torch.int64, device=dev).scatter_reduce(
        0, cflat.reshape(-1),
        torch.where(cand_seen, m.kf_octave[cand], 127).reshape(-1).long(), reduce="amin")
    oct_in = oct_in.reshape(ncand, pmax)
    flat_pt = m.kf_obs.reshape(-1)
    fpa = _clip(flat_pt, pmax)
    okflat = (flat_pt >= 0) & m.kf_valid.repeat_interleave(N) & m.kf_feat_valid.reshape(-1)
    oct_flat = torch.clamp(m.kf_octave.reshape(-1), 0, 7).long()
    H = torch.zeros(pmax * 8, dtype=torch.int32, device=dev).index_add_(
        0, fpa * 8 + oct_flat, okflat.to(torch.int32)).reshape(pmax, 8)
    cum = torch.cumsum(H, dim=1).to(torch.int32)
    thr = torch.clamp(oct_in.reshape(-1)[cflat] + 1, 0, 7)           # [C, N]
    own_ok = (cand_obs >= 0) & m.kf_feat_valid[cand] & m.kf_valid[cand][:, None]
    own_upd = own_ok & (torch.clamp(m.kf_octave[cand], 0, 7) <= thr)
    own_cnt = torch.zeros(ncand * pmax, dtype=torch.int32, device=dev).index_add_(
        0, cflat.reshape(-1), own_upd.reshape(-1).to(torch.int32)).reshape(ncand, pmax)
    ar_k = torch.arange(kmax, device=dev)

    for ci in range(ncand):
        k = cand[ci]
        pid = cand_pid[ci]
        obs_k_ok = cand_ok[ci]
        seen = cand_seen[ci]
        considered = seen & (total_obs[pid] > C.KF_REDUNDANT_OBS)
        support = cum[pid, thr[ci]] - own_cnt[ci, pid]
        redundant = considered & (support >= C.KF_REDUNDANT_OBS)
        n_mp = torch.sum(seen)
        n_red = torch.sum(redundant)
        cull = ((k > 0) & (k != kf_id) & m.kf_valid[k] & ~m.kf_no_erase[k]
                & (n_mp > 0) & (n_red > C.KF_REDUNDANT_RATIO * n_mp))
        if not bool(cull):
            continue   # every update below is the identity for a kept KF
        parent = m.kf_parent[k]
        pk = torch.clamp(parent, 0, kmax - 1).long()
        Tcp = m.kf_pose[k] @ geo.inv_T(m.kf_pose[pk])
        new_valid = m.kf_valid.clone()
        new_valid[k] = False
        children = (m.kf_parent == k) & m.kf_valid & (ar_k != k)
        new_parent = _reparent(m, new_valid, pk, parent, children)
        wgt = torch.where(m.kf_uright[k] >= 0, 2, 1).to(torch.int32)
        sub = torch.zeros(pmax, dtype=torch.int32, device=dev).index_add_(
            0, pid, torch.where(obs_k_ok, wgt, 0).to(torch.int32))
        okh = obs_k_ok & (cand_obs[ci] >= 0)
        dec_h = okh[:, None] & (torch.arange(8, device=dev)[None, :]
                                >= torch.clamp(m.kf_octave[k], 0, 7)[:, None])
        cum = cum - torch.zeros(pmax, 8, dtype=torch.int32, device=dev).index_add_(
            0, pid, dec_h.to(torch.int32))
        m = m.replace(kf_valid=new_valid, kf_parent=new_parent,
                      kf_Tcp=_set_row(m.kf_Tcp, k, Tcp))
        total_obs = total_obs - sub
    return m


def _reparent(m: MapState, new_valid, pk, parent, children):
    """Iterative best-covisible re-parenting of a culled KF's children
    (src/KeyFrame.cc:480-540); leftovers go to the culled KF's parent."""
    kmax, N = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    dev = m.kf_obs.device
    fp = _clip(m.kf_obs.reshape(-1), pmax)
    ok_obs = ((m.kf_obs.reshape(-1) >= 0) & m.kf_valid.repeat_interleave(N)
              & m.kf_feat_valid.reshape(-1) & m.pt_valid[fp])
    rows = torch.arange(kmax, device=dev).repeat_interleave(N)
    inc = torch.zeros(kmax, pmax + 1, dtype=torch.float32, device=dev)
    inc[rows, torch.where(ok_obs, fp, pmax)] = 1.0
    inc = inc[:, :pmax]
    W_full = inc @ inc.T
    cand_mask = (torch.arange(kmax, device=dev) == pk) & new_valid
    new_parent = m.kf_parent.clone()
    ch_left = children.clone()
    for _ in range(MAX_REPARENT_CHILDREN):
        Wm = torch.where(ch_left[:, None] & cand_mask[None, :], W_full,
                         torch.full_like(W_full, -1.0))
        flat = torch.argmax(Wm.reshape(-1))
        ci = flat // kmax
        qi = (flat % kmax).to(torch.int32)
        do = Wm.reshape(-1)[flat] >= C.COVIS_MIN_WEIGHT
        new_parent[ci] = torch.where(do, qi, new_parent[ci])
        cand_mask[ci] = cand_mask[ci] | do
        ch_left[ci] = ch_left[ci] & ~do
    return torch.where(ch_left, parent, new_parent)


# ---------------------------------------------------------------------------
# triangulation of new points
# ---------------------------------------------------------------------------

def _put_block(arr, new_ids, take, vals):
    """Write vals into the contiguous slots new_ids where take."""
    cur = arr[new_ids]
    sel = take.reshape(take.shape + (1,) * (arr.dim() - 1))
    out = arr.clone()
    out[new_ids] = torch.where(sel, scalar(vals, arr, arr.dtype), cur)
    return out


def triangulate_with_neighbor(m: MapState, kf1: int, kf2: int, pt_base: torch.Tensor,
                              cfg: SlamConfig, max_new: int = TRI_MAX_NEW):
    """CreateNewMapPoints vs one neighbour (src/LocalMapping.cc:207-451):
    epipolar matching of unmatched features, DLT or stereo unprojection,
    cheirality, reprojection chi2 and scale-consistency gates, insertion
    into contiguous point slots. Returns (map, n_created)."""
    dev = m.kf_obs.device
    T1 = m.kf_pose[kf1]
    T2 = m.kf_pose[kf2]
    f1 = _kf_feats(m, kf1)
    f2 = _kf_feats(m, kf2)
    sigma2 = const(tuple(cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)), dev)
    F12 = geo.fundamental_from_poses(cfg.K, T1, cfg.K, T2)
    c1 = -T1[:3, :3].T @ T1[:3, 3]
    c2 = -T2[:3, :3].T @ T2[:3, 3]
    baseline = torch.linalg.norm(c1 - c2)
    enough_baseline = baseline > (0.08 if cfg.sensor != MONOCULAR else 0.02)

    un1 = m.kf_obs[kf1] < 0
    un2 = m.kf_obs[kf2] < 0
    res = matching.match_epipolar(f1, f2, F12, sigma2, un1, un2,
                                  max_dist=cfg.th_low, check_rotation=False)
    idx2 = res.idx
    ok = res.ok & enough_baseline

    fx, fy, cx, cy = cfg.K
    Km = const(((fx, 0.0, cx), (0.0, fy, cy), (0.0, 0.0, 1.0)), dev)
    P1 = Km @ T1[:3]
    P2 = Km @ T2[:3]
    uv1 = f1.xy
    uv2 = f2.xy[idx2]
    Xdlt = geo.triangulate_linear(P1, P2, uv1, uv2)

    ones = torch.ones_like(uv1[:, 0])
    ray1 = (T1[:3, :3].T @ torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy, ones])).T
    ray2 = (T2[:3, :3].T @ torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy, ones])).T
    cos_rays = torch.sum(ray1 * ray2, -1) / torch.clamp(
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1), min=1e-9)

    b = cfg.baseline
    z1 = m.kf_depth[kf1]
    z2 = m.kf_depth[kf2][idx2]
    st1 = (m.kf_uright[kf1] >= 0) & (z1 > 0)
    st2 = (m.kf_uright[kf2][idx2] >= 0) & (z2 > 0)
    two = torch.full_like(z1, 2.0)
    cos_st1 = torch.where(st1, torch.cos(2.0 * torch.atan2(
        torch.full_like(z1, b / 2.0), torch.clamp(z1, min=1e-6))), two)
    cos_st2 = torch.where(st2, torch.cos(2.0 * torch.atan2(
        torch.full_like(z2, b / 2.0), torch.clamp(z2, min=1e-6))), two)
    cos_stereo = torch.minimum(cos_st1, cos_st2)
    use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (st1 | st2 | (cos_rays < 0.9998))
    X1s = geo.transform_points(geo.inv_T(T1), geo.backproject(cfg.K, uv1, z1))
    X2s = geo.transform_points(geo.inv_T(T2), geo.backproject(cfg.K, uv2, z2))
    use_s1 = (~use_dlt) & st1 & (cos_st1 < cos_st2)
    use_s2 = (~use_dlt) & st2 & ~use_s1
    Xw = torch.where(use_dlt[:, None], Xdlt, torch.where(use_s1[:, None], X1s, X2s))
    ok = ok & (use_dlt | use_s1 | use_s2)

    Xc1 = geo.transform_points(T1, Xw)
    Xc2 = geo.transform_points(T2, Xw)
    ok = ok & (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0)
    r1 = Xw - c1
    r2 = Xw - c2
    s1 = sigma2[torch.clamp(f1.octave, 0, cfg.n_levels - 1).long()]
    s2 = sigma2[torch.clamp(f2.octave[idx2], 0, cfg.n_levels - 1).long()]
    p1 = geo.project(cfg.K, Xc1)
    p2 = geo.project(cfg.K, Xc2)
    e1 = uv1 - p1
    e2 = uv2 - p2
    ur1 = m.kf_uright[kf1]
    ur2 = m.kf_uright[kf2][idx2]
    eur1 = ur1 - (p1[:, 0] - cfg.bf / torch.clamp(Xc1[:, 2], min=1e-6))
    eur2 = ur2 - (p2[:, 0] - cfg.bf / torch.clamp(Xc2[:, 2], min=1e-6))
    zero = torch.zeros_like(eur1)
    chi1 = torch.sum(e1 * e1, -1) + torch.where(st1, eur1 * eur1, zero)
    chi2_ = torch.sum(e2 * e2, -1) + torch.where(st2, eur2 * eur2, zero)
    th1 = torch.where(st1, 7.8, 5.991)
    th2 = torch.where(st2, 7.8, 5.991)
    ok = ok & (chi1 < th1 * s1) & (chi2_ < th2 * s2)
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    sf = torch.full((), float(cfg.scale_factor), dtype=torch.float32, device=dev)
    ratio_octave = torch.pow(sf, (f1.octave - f2.octave[idx2]).to(torch.float32))
    rf = 1.5 * cfg.scale_factor
    ok = ok & (ratio_dist * rf > ratio_octave) & (ratio_dist < ratio_octave * rf)

    order = torch.sort((~ok).to(torch.int8), stable=True).indices   # winners first
    take = ok[order][:max_new]
    feat1 = order[:max_new]
    feat2 = idx2[order][:max_new]
    pmax = m.pt_pos.shape[0]
    base_ok = pt_base <= pmax - max_new
    take = take & base_ok
    b0 = torch.clamp(pt_base, 0, pmax - max_new)
    new_ids = (b0 + torch.arange(max_new, device=dev)).long()
    nid = new_ids.to(torch.int32)

    Xn = Xw[feat1]
    vec = Xn - c1
    dist = torch.linalg.norm(vec, dim=-1)
    normal = vec / torch.clamp(dist[:, None], min=1e-9)
    lvl = f1.octave[feat1].to(torch.float32)
    max_dist = dist * torch.pow(sf, lvl)
    min_dist = max_dist / (cfg.scale_factor ** (cfg.n_levels - 1))
    m = m.replace(
        pt_pos=_put_block(m.pt_pos, new_ids, take, Xn),
        pt_valid=_put_block(m.pt_valid, new_ids, take, True),
        pt_desc=_put_block(m.pt_desc, new_ids, take, f1.desc[feat1]),
        pt_normal=_put_block(m.pt_normal, new_ids, take, normal),
        pt_min_dist=_put_block(m.pt_min_dist, new_ids, take, min_dist),
        pt_max_dist=_put_block(m.pt_max_dist, new_ids, take, max_dist),
        pt_ref_kf=_put_block(m.pt_ref_kf, new_ids, take, kf1),
        pt_first_kf=_put_block(m.pt_first_kf, new_ids, take, kf1),
        pt_visible=_put_block(m.pt_visible, new_ids, take, 1),
        pt_found=_put_block(m.pt_found, new_ids, take, 1),
    )
    row1 = m.kf_obs[kf1]
    obs1 = scatter_set(row1, feat1, torch.where(take, nid, row1[feat1]))
    m = m.replace(kf_obs=_set_row(m.kf_obs, kf1, obs1))
    row2 = m.kf_obs[kf2]
    obs2 = scatter_set(row2, feat2, torch.where(take, nid, row2[feat2]))
    m = m.replace(kf_obs=_set_row(m.kf_obs, kf2, obs2))
    return m, torch.sum(take).to(torch.int32)


# ---------------------------------------------------------------------------
# fusion with neighbours (SearchInNeighbors, deferred merges)
# ---------------------------------------------------------------------------

def _project_into_kf(m: MapState, pt_ids, dst_kf: int, cfg: SlamConfig, radius: float):
    """ORBmatcher::Fuse's search: project the points pt_ids (-1 padding)
    into dst_kf and match each visible one within `radius` at its predicted
    scale. Returns (clipped ids, point valid, MatchResult)."""
    pmax = m.pt_pos.shape[0]
    pid = _clip(pt_ids, pmax)
    okp = (pt_ids >= 0) & m.pt_valid[pid]
    X = m.pt_pos[pid]
    Tcw = m.kf_pose[dst_kf]
    Xc = geo.transform_points(Tcw, X)
    uv = geo.project(cfg.K, Xc)
    in_img = ((Xc[:, 2] > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height))
    cam_center = -Tcw[:3, :3].T @ Tcw[:3, 3]
    dist = torch.linalg.norm(X - cam_center, dim=-1)
    band = (dist >= 0.8 * m.pt_min_dist[pid]) & (dist <= 1.2 * m.pt_max_dist[pid])
    visible = okp & in_img & band
    pred_oct = ms.predict_scale(dist, m.pt_max_dist[pid], cfg.scale_factor, cfg.n_levels)
    scales = const(tuple(cfg.orb.scales), X.device)
    res = matching.match_projection(uv, visible, m.pt_desc[pid], pred_oct, _kf_feats(m, dst_kf),
                                    radius, scales, max_dist=cfg.th_low)
    return pid, okp, res


def _fuse_deferred_step(m: MapState, rep, acc2, src_kf: int, dst_kf: int, cfg: SlamConfig,
                        obs_counts, chase_n: int):
    """One directional Fuse (ORBmatcher::Fuse) whose point replacements
    accumulate in `rep` (chased chase_n deep on read) and are applied once
    per chunk by fuse_targets_scan."""
    pmax = m.pt_pos.shape[0]

    def chase(ids):
        idc = _clip(ids, pmax)
        for _ in range(chase_n):
            idc = rep[idc].long()
        return torch.where(ids >= 0, idc.to(torch.int32), torch.full_like(ids, -1))

    src_pt = chase(m.kf_obs[src_kf])
    pid, okp, res = _project_into_kf(m, src_pt, dst_kf, cfg, 3.0)
    dst_obs = chase(m.kf_obs[dst_kf])
    tgt_feat = res.idx
    existing = dst_obs[tgt_feat]
    exist_c = _clip(existing, pmax)
    has_existing = (existing >= 0) & m.pt_valid[exist_c]
    do = res.ok & okp & (src_pt != existing)

    addA = do & ~has_existing
    new_row = scatter_set(dst_obs, tgt_feat, torch.where(addA, src_pt, dst_obs[tgt_feat]))
    m = m.replace(kf_obs=_set_row(m.kf_obs, dst_kf, new_row))

    dup = do & has_existing
    keep_existing = obs_counts[exist_c] >= obs_counts[pid]
    winner = torch.where(keep_existing, existing, src_pt)
    loser = torch.where(keep_existing, src_pt, existing)
    lose_c = _clip(loser, pmax)
    win_c = _clip(winner, pmax)
    rep = scatter_set(rep, lose_c, torch.where(dup, winner, rep[lose_c]))
    pt_valid = scatter_set(m.pt_valid, lose_c,
                           torch.where(dup, torch.zeros_like(dup), m.pt_valid[lose_c]))
    zero = torch.zeros_like(m.pt_visible[lose_c])
    upd = torch.stack([torch.where(dup, m.pt_visible[lose_c] + acc2[lose_c, 0], zero),
                       torch.where(dup, m.pt_found[lose_c] + acc2[lose_c, 1], zero)], dim=-1)
    acc2 = acc2 + torch.zeros_like(acc2).index_add_(0, win_c, upd)
    return m.replace(pt_valid=pt_valid), rep, acc2


def _fuse_points_core(m: MapState, pt_ids, dst_kf: int, cfg: SlamConfig, enabled=True,
                      radius: float = 3.0, prefer_src: bool = False, obs_counts=None):
    """Eager Fuse of a point set into dst_kf: a free feature gains the
    observation; a duplicate merges into one point (the projected one if
    prefer_src, else the more-observed one), its observations rewritten
    across the map and its counters moved (MapPoint::Replace,
    src/MapPoint.cc:177-222). Returns (m', number of merges)."""
    pmax = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    pid, okp, res = _project_into_kf(m, pt_ids, dst_kf, cfg, radius)
    if not prefer_src and obs_counts is None:
        # counted on the map as it stands, before the free features gain
        obs_counts = ms.point_observation_counts(m)
    dst_obs = m.kf_obs[dst_kf]
    tgt_feat = res.idx
    existing = dst_obs[tgt_feat]
    exist_c = _clip(existing, pmax)
    has_existing = (existing >= 0) & m.pt_valid[exist_c]
    do = res.ok & okp & (pt_ids != existing)
    if enabled is not True:
        do = do & scalar(enabled, do, torch.bool)
    addA = do & ~has_existing
    new_row = scatter_set(dst_obs, tgt_feat, torch.where(addA, pt_ids, dst_obs[tgt_feat]))
    m = m.replace(kf_obs=_set_row(m.kf_obs, dst_kf, new_row))
    dup = do & has_existing
    if prefer_src:
        # loop fusion: the loop point wins unconditionally (LoopClosing.cc:634-641)
        winner, loser = pt_ids, existing
    else:
        keep_existing = obs_counts[exist_c] >= obs_counts[pid]
        winner = torch.where(keep_existing, existing, pt_ids)
        loser = torch.where(keep_existing, pt_ids, existing)
    lose_c = _clip(loser, pmax)
    rep = torch.arange(pmax, dtype=torch.int32, device=dev)
    rep = scatter_set(rep, lose_c, torch.where(dup, winner, rep[lose_c]))
    kf_obs = torch.where(m.kf_obs >= 0, rep[_clip(m.kf_obs, pmax)], torch.full_like(m.kf_obs, -1))
    pt_valid = scatter_set(m.pt_valid, lose_c,
                           torch.where(dup, torch.zeros_like(dup), m.pt_valid[lose_c]))
    zero = torch.zeros_like(m.pt_visible[lose_c])
    upd = torch.stack([torch.where(dup, m.pt_visible[lose_c], zero),
                       torch.where(dup, m.pt_found[lose_c], zero)], dim=-1)
    acc = torch.zeros((pmax, 2), dtype=torch.int32, device=dev).index_add_(
        0, _clip(winner, pmax), upd)
    return m.replace(kf_obs=kf_obs, pt_valid=pt_valid, pt_visible=m.pt_visible + acc[:, 0],
                     pt_found=m.pt_found + acc[:, 1]), torch.sum(dup)


def fuse_into_keyframe(m: MapState, src_kf: int, dst_kf: int, cfg: SlamConfig, enabled=True,
                       obs_counts=None):
    """Project src_kf's points into dst_kf at radius 3; a matched feature
    gains the observation, or a duplicate merges into the more-observed
    point (ORBmatcher::Fuse, src/ORBmatcher.cc:825-975, as
    SearchInNeighbors drives it, src/LocalMapping.cc:454-533). obs_counts:
    per-point observation counts computed beforehand, else from m.
    Returns (m', number of merges)."""
    return _fuse_points_core(m, m.kf_obs[src_kf], dst_kf, cfg, enabled=enabled, radius=3.0,
                             prefer_src=False, obs_counts=obs_counts)


def fuse_point_set_into_keyframe(m: MapState, pt_ids, dst_kf: int, cfg: SlamConfig,
                                 radius: float = 4.0):
    """Loop closing's SearchAndFuse body (src/LoopClosing.cc:587-643,
    ORBmatcher::Fuse(KF, Scw, ...)): project a point set into one corrected
    keyframe; a free feature gains the observation, and on a duplicate the
    projected loop point replaces the keyframe's (MapPoint::Replace).
    Returns (m', number of merges)."""
    return _fuse_points_core(m, pt_ids, dst_kf, cfg, enabled=True, radius=radius,
                             prefer_src=True)


def fuse_targets_scan(m: MapState, center_kf: int, targets, cfg: SlamConfig, obs_counts):
    """SearchInNeighbors over a target slice (both directions per target)
    with one deferred merge application at the end. targets: host list of
    kf ids, -1 = disabled slot."""
    pmax = m.pt_pos.shape[0]
    kmax = m.kf_pose.shape[0]
    dev = m.kf_obs.device
    T = len(targets)
    chase_n = 2 * T
    rep = torch.arange(pmax, dtype=torch.int32, device=dev)
    acc2 = torch.zeros((pmax, 2), dtype=torch.int32, device=dev)
    for t in targets:
        if not (t >= 0 and center_kf > 0):
            continue
        tgt = min(max(int(t), 0), kmax - 1)
        m, rep, acc2 = _fuse_deferred_step(m, rep, acc2, center_kf, tgt, cfg, obs_counts, chase_n)
        m, rep, acc2 = _fuse_deferred_step(m, rep, acc2, tgt, center_kf, cfg, obs_counts, chase_n)
    for _ in range(max(1, math.ceil(math.log2(max(2 * T, 2))))):
        rep = rep[rep.long()]
    kf_obs = torch.where(m.kf_obs >= 0, rep[_clip(m.kf_obs, pmax)],
                         torch.full_like(m.kf_obs, -1))
    return m.replace(kf_obs=kf_obs, pt_visible=m.pt_visible + acc2[:, 0],
                     pt_found=m.pt_found + acc2[:, 1])


def _fuse_targets(m: MapState, kf_id: int, n_fuse: int, n_ext: int) -> torch.Tensor:
    """SearchInNeighbors target set: the top n_fuse first-degree covisible
    neighbours, plus up to n_ext second-degree ones (-1 = empty)."""
    if n_fuse > 31:
        raise ValueError("bit-packed neighbour mask supports <= 31 rows")
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    dev = m.kf_obs.device
    w = ms.covisibility_weights(m, kf_id)
    w1v, w1i = top_k(w, n_fuse)
    ok1 = w1v >= C.COVIS_MIN_WEIGHT
    first = torch.where(ok1, w1i, -1).to(torch.int32)
    if n_ext == 0:
        return first
    in_first = scatter_set(torch.zeros(kmax, dtype=torch.bool, device=dev),
                           _clip(first, kmax), ok1)
    fobs = m.kf_obs[_clip(first, kmax)]
    fpid = _clip(fobs, pmax)
    fok = ok1[:, None] & (fobs >= 0) & m.pt_valid[fpid]
    bits = torch.zeros(n_fuse * pmax, dtype=torch.int64, device=dev).scatter_reduce(
        0, (torch.arange(n_fuse, device=dev)[:, None] * pmax + fpid).reshape(-1),
        fok.reshape(-1).to(torch.int64), reduce="amax").reshape(n_fuse, pmax)
    mask_pt = torch.sum(bits << torch.arange(n_fuse, device=dev)[:, None], dim=0)
    gm = mask_pt[_clip(m.kf_obs, pmax)]
    gok = (m.kf_obs >= 0) & m.kf_valid[:, None]
    W2 = torch.stack([torch.sum(torch.where(gok, (gm >> r) & 1, 0), dim=1)
                      for r in range(n_fuse)])
    W2[torch.arange(n_fuse, device=dev), _clip(first, kmax)] = 0
    rows = []
    for i in range(n_fuse):
        v2, i2 = top_k(W2[i], C.SECOND_DEGREE_NEIGHBORS)
        ok2 = ok1[i] & (v2 >= C.COVIS_MIN_WEIGHT)
        rows.append(torch.where(ok2, i2, -1))
    second = torch.cat(rows)
    cand2 = scatter_set(torch.zeros(kmax, dtype=torch.bool, device=dev),
                        torch.where(second >= 0, second, kmax), second >= 0)
    ar = torch.arange(kmax, device=dev)
    cand2 = cand2 & ~in_first & (ar != kf_id) & m.kf_valid
    e_v, e_i = top_k(torch.where(cand2, w + 1, 0), n_ext)
    ext = torch.where(e_v > 0, e_i, -1).to(torch.int32)
    return torch.cat([first, ext])


# ---------------------------------------------------------------------------
# local BA window
# ---------------------------------------------------------------------------

def build_ba_window(m: MapState, kf_id: int, cfg: SlamConfig):
    """Local window = current KF + covisible KFs (free), their points, and
    the other observers of those points as fixed cameras
    (src/Optimizer.cc:456-546). Returns (BAProblem, cam_ids, pt_ids).
    One host read: whether the candidate points fit the cap."""
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    N = m.kf_obs.shape[1]
    dev = m.kf_obs.device
    i32 = torch.int32
    NC_FREE = min(cfg.ba_free_kfs, kmax)
    NC_FIXED = min(cfg.ba_fixed_kfs, kmax)
    NP_BA = min(cfg.ba_points, pmax)
    ar_k = torch.arange(kmax, device=dev)
    w = ms.covisibility_weights(m, kf_id)
    wv, wi = top_k(w, NC_FREE - 1)
    free_ids = torch.cat([torch.full((1,), kf_id, device=dev),
                          torch.where(wv > 0, wi, -1)]).to(i32)
    is_free = scatter_set(torch.zeros(kmax, dtype=torch.bool, device=dev),
                          _clip(free_ids, kmax), free_ids >= 0)
    is_free = is_free & m.kf_valid & (ar_k != 0)

    obs_masked = torch.where(is_free[:, None], m.kf_obs, -1).reshape(-1)
    in_local = scatter_set(torch.zeros(pmax, dtype=torch.bool, device=dev),
                           _clip(obs_masked, pmax), obs_masked >= 0)
    in_local = in_local & m.pt_valid
    n_cand = int(torch.sum(in_local))

    QUOTA = min(C.BA_CAM_ANCHOR_QUOTA, NP_BA // max(NC_FREE, 1))
    free_rows = m.kf_obs[_clip(free_ids, kmax)]
    row_pt = _clip(free_rows, pmax)
    row_ok = (free_ids >= 0)[:, None] & (free_rows >= 0) & m.pt_valid[row_pt]
    anchor_score = torch.where(row_ok, pmax - row_pt, 0)
    av, ai = top_k(anchor_score, min(QUOTA, free_rows.shape[1]))
    anchor_ids = torch.where(av > 0, torch.gather(row_pt, 1, ai), 0)
    guaranteed = scatter_set(torch.zeros(pmax, dtype=torch.bool, device=dev),
                             anchor_ids.reshape(-1), (av > 0).reshape(-1))
    guaranteed = guaranteed & in_local

    ar_p = torch.arange(pmax, device=dev)
    if n_cand <= NP_BA:
        pos = torch.cumsum(in_local.to(torch.int64), 0) - 1
        dst = torch.where(in_local, torch.clamp(pos, max=NP_BA), NP_BA)
        pt_ids = scatter_set(torch.full((NP_BA + 1,), -1, dtype=i32, device=dev),
                             dst, ar_p.to(i32))[:NP_BA]
    else:
        pt_score = torch.where(in_local, ar_p + 1, 0)
        pt_score = torch.where(guaranteed, pt_score + 2 * pmax, pt_score)
        pv, ids = top_k(pt_score, NP_BA)
        pt_ids = torch.where(pv > 0, ids, -1).to(i32)
    ptc = _clip(pt_ids, pmax)
    sel = scatter_set(torch.zeros(pmax, dtype=torch.bool, device=dev), ptc, pt_ids >= 0)
    remap = scatter_set(torch.full((pmax,), -1, dtype=i32, device=dev), ptc,
                        torch.where(pt_ids >= 0, torch.arange(NP_BA, device=dev, dtype=i32),
                                    -1))

    observes_sel = torch.any(sel[_clip(m.kf_obs, pmax)] & (m.kf_obs >= 0), dim=1)
    fixed_cand = observes_sel & m.kf_valid & ~is_free
    no_anchor = ~torch.any(fixed_cand)
    oldest_free = torch.argmin(torch.where(is_free, ar_k, kmax))
    pin = no_anchor & (torch.sum(is_free) >= 2)
    is_free = is_free & ~(pin & (ar_k == oldest_free))
    fixed_cand = observes_sel & m.kf_valid & ~is_free
    fv, fixed_ids = top_k(fixed_cand.to(i32), NC_FIXED)
    fixed_ids = torch.where(fv > 0, fixed_ids, -1).to(i32)

    cam_ids = torch.cat([free_ids, fixed_ids])
    NC = NC_FREE + NC_FIXED
    cam_ok = cam_ids >= 0
    cid = _clip(cam_ids, kmax)
    cam_fixed = torch.cat([torch.zeros(NC_FREE, dtype=torch.bool, device=dev),
                           torch.ones(NC_FIXED, dtype=torch.bool, device=dev)]) | ~is_free[cid]
    prob = _window_problem(m, cam_ids, pt_ids, remap, m.kf_pose[cid], cam_fixed,
                           m.pt_pos[ptc], NP_BA)
    obs_per_cam = torch.sum(prob.obs_valid.reshape(NC, N), dim=1)
    weak = (obs_per_cam < C.BA_MIN_OBS_PER_FREE_CAM) & (torch.arange(NC, device=dev) != 0)
    return prob._replace(cam_fixed=cam_fixed | weak), cam_ids, pt_ids


def _window_problem(m: MapState, cam_ids, pt_ids, remap, cam_T, cam_fixed, pts, NP):
    """The window's camera-major observation arrays from the current map."""
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    NC = cam_ids.shape[0]
    N = m.kf_obs.shape[1]
    cid = _clip(cam_ids, kmax)
    cam_ok = cam_ids >= 0
    kf_obs_w = m.kf_obs[cid]
    feat_ok = m.kf_feat_valid[cid]
    pt_local = remap[_clip(kf_obs_w, pmax)]
    obs_valid = cam_ok[:, None] & feat_ok & (kf_obs_w >= 0) & (pt_local >= 0)
    uvr = torch.cat([m.kf_xy[cid], m.kf_uright[cid][..., None]], dim=-1)
    return optim.BAProblem(
        cam_T=cam_T,
        cam_fixed=cam_fixed,
        cam_valid=cam_ok,
        pts=pts,
        pt_valid=pt_ids >= 0,
        obs_cam=torch.arange(NC, dtype=torch.int32, device=cid.device).repeat_interleave(N),
        obs_pt=torch.clamp(pt_local.reshape(-1), 0, NP - 1),
        obs_uvr=uvr.reshape(NC * N, 3),
        obs_oct=m.kf_octave[cid].reshape(-1),
        obs_stereo=(m.kf_uright[cid] >= 0).reshape(-1),
        obs_valid=obs_valid.reshape(-1),
    )


def scatter_ba_result(m: MapState, res: optim.BAResult, prob: optim.BAProblem,
                      cam_ids, pt_ids) -> MapState:
    """Write optimized poses/points back and erase outlier observations
    (src/Optimizer.cc:711-757)."""
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    cid = _clip(cam_ids, kmax)
    write_cam = (cam_ids >= 0) & ~prob.cam_fixed
    new_pose = torch.where(write_cam[:, None, None], res.cam_T, m.kf_pose[cid])
    m = m.replace(kf_pose=scatter_set(m.kf_pose, cid, new_pose))
    pidc = _clip(pt_ids, pmax)
    new_pos = torch.where((pt_ids >= 0)[:, None], res.pts, m.pt_pos[pidc])
    m = m.replace(pt_pos=scatter_set(m.pt_pos, pidc, new_pos))
    NC = prob.cam_T.shape[0]
    N = m.kf_obs.shape[1]
    erase = (prob.obs_valid & ~res.obs_inlier).reshape(NC, N)
    rows = torch.where(erase, -1, m.kf_obs[cid])
    return m.replace(kf_obs=scatter_set(m.kf_obs, cid, rows))


# ---------------------------------------------------------------------------
# the monolithic mapper
# ---------------------------------------------------------------------------

def _mapper_kernel(m: MapState, kf_id: int, pt_base: torch.Tensor, cfg: SlamConfig):
    """The whole LocalMapping pass for keyframe kf_id (the Run-loop body,
    src/LocalMapping.cc:47-112): point culling, triangulation against the
    top covisible neighbours, fusion with the first- and second-degree
    neighbours, the whole-map descriptor and statistics refresh, one
    camera-major local BA (K4 on the card), the orphan sweep and keyframe
    culling. Returns (map, advanced point-slot cursor)."""
    kmax = m.kf_pose.shape[0]
    m = cull_points(m, kf_id)
    n_tri = min(cfg.tri_neighbors, kmax)
    n_fuse = min(cfg.fuse_neighbors, kmax)
    nbw, nbi = top_k(ms.covisibility_weights(m, kf_id), max(n_tri, n_fuse))
    nbw, nbi = nbw.tolist(), nbi.tolist()
    base = pt_base
    for i in range(n_tri):
        if nbw[i] >= C.COVIS_MIN_WEIGHT and kf_id > 0:
            m, n_new = triangulate_with_neighbor(m, kf_id, nbi[i], base, cfg)
            base = base + n_new
    fbi = _fuse_targets(m, kf_id, n_fuse, C.FUSE_EXT_SLOTS)
    m = fuse_targets_scan(m, kf_id, fbi.tolist(), cfg, ms.point_observation_counts(m))
    m = update_point_descriptors(m)
    m = ms.update_point_stats(m, cfg.scale_factor, cfg.n_levels)
    if cfg.enable_local_ba:
        prob, cam_ids, pt_ids = build_ba_window(m, kf_id, cfg)
        res = optim.local_bundle_adjustment(
            prob, _inv_sigma2(cfg, m.kf_obs.device), cfg.K, cfg.bf, cam_major=True,
            n_free=min(cfg.ba_free_kfs, cfg.max_keyframes))
        m = cull_orphans(scatter_ba_result(m, res, prob, cam_ids, pt_ids))
    if cfg.enable_kf_culling:
        m = cull_keyframes(m, kf_id, cfg)
    return m, base


@dataclass
class LocalMapper:
    """The monolithic mapper as a keyframe callback: `process(kf_id)` runs
    `_mapper_kernel` on the tracker's map and writes the map and the
    point-slot cursor `n_pts_dev` back; the tracker rebuilds its device
    state, where it has one, after the keyframe callbacks."""

    cfg: SlamConfig
    tracker: "object"   # tracking.Tracker (a circular import otherwise)

    def process(self, kf_id: int):
        trk = self.tracker
        trk.map, trk.n_pts_dev = _mapper_kernel(trk.map, kf_id, trk.n_pts_dev, self.cfg)


# ---------------------------------------------------------------------------
# the chunked mapper machine
# ---------------------------------------------------------------------------

@dataclass
class MapperMachine:
    """Chunked-mapper state. phase/kf are host ints (0 = idle, else the
    1-based phase index); the rest stays on the device."""

    phase: int
    kf: int
    nbw: torch.Tensor          # [n_nb] int32 covisibility weights
    nbi: torch.Tensor          # [n_nb] int32 neighbour kf ids
    fbi: torch.Tensor          # [n_fb] int32 fuse targets (-1 pad)
    ba_cam_ids: torch.Tensor   # [NC] int32
    ba_pt_ids: torch.Tensor    # [NP] int32
    ba_cam_fixed: torch.Tensor  # [NC] bool
    ba_cam_T: torch.Tensor     # [NC, 4, 4]
    ba_pts: torch.Tensor       # [NP, 3]
    ba_obs_ok: torch.Tensor    # [NC*N] bool
    ba_lam: torch.Tensor       # 0-d f32
    ba_cost: torch.Tensor      # 0-d f32
    ba_n_in: torch.Tensor      # 0-d int32

    def replace(self, **kw) -> "MapperMachine":
        return dataclasses.replace(self, **kw)


_MACHINE_SCALARS = ("phase", "kf")


def _machine_dims(cfg: SlamConfig, n_slots: int):
    kmax = cfg.max_keyframes
    n_nb = max(min(cfg.tri_neighbors, kmax), min(cfg.fuse_neighbors, kmax), 1)
    NC = min(cfg.ba_free_kfs, kmax) + min(cfg.ba_fixed_kfs, kmax)
    NP = min(cfg.ba_points, cfg.max_points)
    return n_nb, NC, NP, n_slots


def _machine_n_fb(cfg: SlamConfig) -> int:
    return min(cfg.fuse_neighbors, cfg.max_keyframes) + C.FUSE_EXT_SLOTS


def empty_machine(cfg: SlamConfig, n_slots: int, device="cpu") -> MapperMachine:
    n_nb, NC, NP, N = _machine_dims(cfg, n_slots)
    kw = dict(device=device)
    i32, f32 = torch.int32, torch.float32
    return MapperMachine(
        phase=0,
        kf=-1,
        nbw=torch.zeros(n_nb, dtype=i32, **kw),
        nbi=torch.full((n_nb,), -1, dtype=i32, **kw),
        fbi=torch.full((_machine_n_fb(cfg),), -1, dtype=i32, **kw),
        ba_cam_ids=torch.full((NC,), -1, dtype=i32, **kw),
        ba_pt_ids=torch.full((NP,), -1, dtype=i32, **kw),
        ba_cam_fixed=torch.ones(NC, dtype=torch.bool, **kw),
        ba_cam_T=torch.eye(4, dtype=f32, **kw).repeat(NC, 1, 1),
        ba_pts=torch.zeros((NP, 3), dtype=f32, **kw),
        ba_obs_ok=torch.zeros(NC * N, dtype=torch.bool, **kw),
        ba_lam=torch.tensor(1e-4, dtype=f32, **kw),
        ba_cost=torch.tensor(0.0, dtype=f32, **kw),
        ba_n_in=torch.tensor(0, dtype=i32, **kw),
    )


def machine_from_numpy(arrays, device="cpu") -> MapperMachine:
    """From the reference MapperMachine's arrays (field -> numpy)."""
    kw = {}
    for f in dataclasses.fields(MapperMachine):
        a = np.asarray(arrays[f.name])
        kw[f.name] = int(a) if f.name in _MACHINE_SCALARS else ms.tensor_from_numpy(a, device)
    return MapperMachine(**kw)


def machine_to_numpy(mp: MapperMachine) -> dict:
    out = {}
    for f in dataclasses.fields(MapperMachine):
        v = getattr(mp, f.name)
        out[f.name] = np.asarray(v, np.int32) if f.name in _MACHINE_SCALARS \
            else v.detach().cpu().numpy()
    return out


def _phase_list(cfg: SlamConfig):
    """Static phase table of one keyframe's mapping pass."""
    phases = [("start",)]
    n_tri = min(cfg.tri_neighbors, cfg.max_keyframes)
    if n_tri > 0:
        h = (n_tri + 1) // 2
        phases.append(("tri", 0, h))
        if h < n_tri:
            phases.append(("tri", h, n_tri))
    n_fuse = min(cfg.fuse_neighbors, cfg.max_keyframes)
    if n_fuse > 0:
        n_fb = _machine_n_fb(cfg)
        for lo in range(0, n_fb, C.FUSE_CHUNK):
            phases.append(("fuse", lo, min(lo + C.FUSE_CHUNK, n_fb)))
    phases.append(("refresh",))
    if cfg.enable_local_ba:
        phases += [("ba1",), ("ba2",), ("ba3",)]
    if cfg.enable_kf_culling:
        phases.append(("kfcull",))
    return phases


def machine_phase_count(cfg: SlamConfig) -> int:
    return len(_phase_list(cfg))


# the tracer's span of each phase kind
_PHASE_SPANS = {k: "mapper." + k for k in (
    "start", "tri", "fuse", "refresh", "ba1", "ba2", "ba3", "kfcull")}


def _ba_prob_from_machine(m: MapState, mp: MapperMachine, cfg: SlamConfig):
    """Rebuild the window's observation arrays from the frozen
    (cam_ids, pt_ids) selection and the current map; poses and points come
    from the LM carry."""
    pmax = cfg.max_points
    NP = mp.ba_pt_ids.shape[0]
    dev = mp.ba_pt_ids.device
    remap = scatter_set(
        torch.full((pmax,), -1, dtype=torch.int32, device=dev), _clip(mp.ba_pt_ids, pmax),
        torch.where(mp.ba_pt_ids >= 0, torch.arange(NP, dtype=torch.int32, device=dev), -1))
    return _window_problem(m, mp.ba_cam_ids, mp.ba_pt_ids, remap, mp.ba_cam_T,
                           mp.ba_cam_fixed, mp.ba_pts, NP)


def _store_carry(mp: MapperMachine, carry) -> MapperMachine:
    cam_T, pts, lam, cost, n_in, obs_ok = carry
    return mp.replace(ba_cam_T=cam_T, ba_pts=pts, ba_lam=lam, ba_cost=cost,
                      ba_n_in=n_in, ba_obs_ok=obs_ok)


def _load_carry(mp: MapperMachine):
    return (mp.ba_cam_T, mp.ba_pts, mp.ba_lam, mp.ba_cost, mp.ba_n_in, mp.ba_obs_ok)


def mapper_machine_step(m: MapState, n_pts: torch.Tensor, obs_counts: torch.Tensor,
                        mp: MapperMachine, cfg: SlamConfig):
    """Run ONE phase of the chunked mapper and advance the phase counter
    (idle stays idle), in a `mapper.<phase>` span. Returns (m, n_pts,
    obs_counts, mp)."""
    phases = _phase_list(cfg)
    if mp.phase <= 0:
        return m, n_pts, obs_counts, mp
    spec = phases[min(mp.phase, len(phases)) - 1]
    with trace.span(_PHASE_SPANS[spec[0]]):
        kind = spec[0]
        dev = m.kf_obs.device
        inv_s2 = _inv_sigma2(cfg, dev)
        n_free = min(cfg.ba_free_kfs, cfg.max_keyframes)
        its1 = C.LOCAL_BA_ITS_PHASE1
        its2 = C.LOCAL_BA_ITS_PHASE2
        its2a = (its2 + 1) // 2
        kf = mp.kf
        if kind == "start":
            m = cull_points(m, kf)
            w = ms.covisibility_weights(m, kf)
            nbw, nbi = top_k(w, mp.nbw.shape[0])
            fbi = _fuse_targets(m, kf, min(cfg.fuse_neighbors, cfg.max_keyframes),
                                C.FUSE_EXT_SLOTS)
            mp = mp.replace(nbw=nbw.to(torch.int32), nbi=nbi.to(torch.int32), fbi=fbi)
        elif kind == "tri":
            lo, hi = spec[1], spec[2]
            nbw = mp.nbw.tolist()
            nbi = mp.nbi.tolist()
            for i in range(lo, hi):
                if nbw[i] >= C.COVIS_MIN_WEIGHT and kf > 0:
                    m, n_new = triangulate_with_neighbor(m, kf, nbi[i], n_pts, cfg)
                    n_pts = n_pts + n_new
        elif kind == "fuse":
            lo, hi = spec[1], spec[2]
            obs_counts = ms.point_observation_counts(m)
            m = fuse_targets_scan(m, kf, mp.fbi[lo:hi].tolist(), cfg, obs_counts)
        elif kind == "refresh":
            m = refresh_point_stats_for_kf(m, kf, cfg)
        elif kind == "ba1":
            prob, cam_ids, pt_ids = build_ba_window(m, kf, cfg)
            carry = optim.lba_init(prob, inv_s2, cfg.K, cfg.bf)
            carry = optim.lba_iterate(prob, inv_s2, carry, cfg.K, cfg.bf, its1, robust=True,
                                      n_free=n_free)
            mp = _store_carry(mp, carry).replace(ba_cam_ids=cam_ids, ba_pt_ids=pt_ids,
                                                 ba_cam_fixed=prob.cam_fixed)
        elif kind == "ba2":
            prob = _ba_prob_from_machine(m, mp, cfg)
            carry = optim.lba_prune(prob, inv_s2, _load_carry(mp), cfg.K, cfg.bf)
            carry = optim.lba_iterate(prob, inv_s2, carry, cfg.K, cfg.bf, its2a, robust=False,
                                      n_free=n_free)
            mp = _store_carry(mp, carry)
        elif kind == "ba3":
            prob = _ba_prob_from_machine(m, mp, cfg)
            carry = optim.lba_iterate(prob, inv_s2, _load_carry(mp), cfg.K, cfg.bf,
                                      its2 - its2a, robust=False, n_free=n_free)
            res = optim.lba_finalize(prob, inv_s2, carry, cfg.K, cfg.bf)
            m = scatter_ba_result(m, res, prob, mp.ba_cam_ids, mp.ba_pt_ids)
            m = cull_orphans(m)
        elif kind == "kfcull":
            m = cull_keyframes(m, kf, cfg)
        if mp.phase >= len(phases):
            # the pass is complete: refresh the cached observation counts
            obs_counts = ms.point_observation_counts(m)
            nxt = 0
        else:
            nxt = mp.phase + 1
        return m, n_pts, obs_counts, mp.replace(phase=nxt)
