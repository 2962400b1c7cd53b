"""Loop detection and correction — the port of
`orb_slam2_comment_tpu/models/loop_closing.py` (the reference's LoopClosing
thread, src/LoopClosing.cc) as a per-keyframe pass plus a per-frame pump.

  DetectLoop  (:103-229): BoW candidates above the covisible neighbours'
              minimum score, kept after 3 consistent detections.
  ComputeSim3 (:231-400): node-gated matches -> batched Horn Sim3 RANSAC ->
              guided SearchBySim3 -> sim3_optimize -> projection count.
  CorrectLoop (:402-643): propagate the Sim3 through the current
              neighbourhood, fuse loop duplicates, optimize the essential
              graph, then start the chunked background global BA.

Detection is queued: a keyframe's covisibility matrix and BoW scores are
packed on the device when its frame resolves, and the pack comes to the
host without stalling a frame: with fused tracking it rides the tracker's
next stats transfer (`Tracker.enqueue_side`), otherwise it is one
non-blocking copy into pinned memory with an event after it. A pack is
harvested on a pump at least 4 pumps after it was queued and once its
transfer has landed (at once, waiting, when forced). The keyframe stays
unerasable (SetNotErase) until its detection is harvested. The reference's
failure dump is left out.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.models import map_state as ms
from orb_slam2_comment_tpu_torch.models.keyframe_database import scores_dense
from orb_slam2_comment_tpu_torch.models.local_mapping import (
    _kf_feats, fuse_point_set_into_keyframe)
from orb_slam2_comment_tpu_torch.models.map_state import MapState
from orb_slam2_comment_tpu_torch.models.tracking import _Pull
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import matching, optim, ransac
from orb_slam2_comment_tpu_torch.ops.scatter import const, scatter_set, top_k
from orb_slam2_comment_tpu_torch.utils.config import MONOCULAR, SlamConfig


def _loop_dbg(msg):
    if os.environ.get("LOOP_DEBUG", "") not in ("", "0"):
        print(msg, flush=True)


def _clip(ids, n: int) -> torch.Tensor:
    return torch.clamp(ids, 0, n - 1).long()


def _sigma2(cfg: SlamConfig, device):
    return const(tuple(cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)), device)


def _detect_pack(m: MapState, scores, common):
    """One keyframe's detection inputs as one [K, K+3] f32 device buffer:
    covisibility matrix | BoW scores | shared-word counts | kf_valid."""
    W = ms.covisibility_matrix(m).to(torch.float32)
    return torch.cat([W, scores[:, None], common.to(torch.float32)[:, None],
                      m.kf_valid.to(torch.float32)[:, None]], dim=1)


def _sim3_gate(m: MapState, k1: int, k2: int, cfg: SlamConfig):
    """ComputeSim3's match + RANSAC gate: FeatureVector-node-gated
    one-directional SearchByBoW(KF, KF), then the batched Horn Sim3
    RANSAC. Without usable groups (none, or one node for all features)
    mutual-best replaces the node-scoped ratio test. Returns (scalars [4]
    = n_bow, ransac_ok, n_inl, n_raw; idx; pair_ok; S12; inliers)."""
    obs2 = m.kf_obs[k2]
    ok2 = m.kf_feat_valid[k2] & (obs2 >= 0)
    ok1 = m.kf_feat_valid[k1] & (m.kf_obs[k1] >= 0)
    ga, gb = m.kf_group[k1], m.kf_group[k2]
    row_ungated = (~torch.any(ga >= 0)) | (~torch.any(gb >= 0))

    def _uniform(g, okm):
        valid = okm & (g >= 0)
        mx = torch.max(torch.where(valid, g, -1))
        mn = torch.min(torch.where(valid, g, mx))
        return mx == mn

    gate_inactive = row_ungated | (_uniform(ga, ok1) & _uniform(gb, ok2))
    node_ok = (ga[:, None] == gb[None, :]) & (ga >= 0)[:, None]
    dist = matching.hamming_from_packed(m.kf_desc[k1], m.kf_desc[k2])
    mask = ok1[:, None] & ok2[None, :] & (node_ok | gate_inactive)
    res = matching.match_generic(dist, mask, max_dist=cfg.th_low, nn_ratio=0.75, mutual=False,
                                 angles_a=m.kf_angle[k1], angles_b=m.kf_angle[k2])
    mut_ok = matching._mutual_best(torch.where(mask, dist, matching._INF), res.idx, res.ok)
    res_ok = torch.where(gate_inactive, mut_ok, res.ok)
    pmax = cfg.max_points
    p1, p2 = m.kf_obs[k1], obs2[res.idx]
    pair_ok = (res_ok & (p1 >= 0) & (p2 >= 0) & m.pt_valid[_clip(p1, pmax)]
               & m.pt_valid[_clip(p2, pmax)])
    Xc1 = geo.transform_points(m.kf_pose[k1], m.pt_pos[_clip(p1, pmax)])
    Xc2 = geo.transform_points(m.kf_pose[k2], m.pt_pos[_clip(p2, pmax)])
    rres = ransac.sim3_ransac(Xc1, Xc2, m.kf_xy[k1], m.kf_xy[k2][res.idx], m.kf_octave[k1],
                              m.kf_octave[k2][res.idx], pair_ok, _sigma2(cfg, Xc1.device),
                              cfg.K, cfg.K, fix_scale=cfg.sensor != MONOCULAR)
    scalars = torch.stack([torch.sum(pair_ok).float(), rres.ok.float(),
                           rres.n_inliers.float(), torch.sum(res_ok).float()])
    return scalars, res.idx, pair_ok, rres.S12, rres.inliers


def _sim3_guided_pairs(m: MapState, k1: int, k2: int, S12, cfg: SlamConfig):
    """SearchBySim3 (src/ORBmatcher.cc:1102-1326): project each KF's
    landmarks into the other camera under the Sim3 and keep the pairs both
    directed searches agree on. Returns ([N] kf2 feature per kf1 feature
    or -1, [N] bool)."""
    pmax = cfg.max_points
    scales = const(tuple(cfg.orb.scales), S12.device)
    T1, T2 = m.kf_pose[k1], m.kf_pose[k2]
    p1, p2 = m.kf_obs[k1], m.kf_obs[k2]
    X1, X2 = m.pt_pos[_clip(p1, pmax)], m.pt_pos[_clip(p2, pmax)]
    ok1 = m.kf_feat_valid[k1] & (p1 >= 0) & m.pt_valid[_clip(p1, pmax)]
    ok2 = m.kf_feat_valid[k2] & (p2 >= 0) & m.pt_valid[_clip(p2, pmax)]
    Xc1_of_2 = geo.transform_points(S12, geo.transform_points(T2, X2))
    uv_in1 = geo.project(cfg.K, Xc1_of_2)
    Xc2_of_1 = geo.transform_points(geo.inv_T(S12), geo.transform_points(T1, X1))
    uv_in2 = geo.project(cfg.K, Xc2_of_1)

    def inb(uv, z):
        return ((z > 0.0) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width)
                & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height))

    r21 = matching.match_projection(uv_in1, ok2 & inb(uv_in1, Xc1_of_2[:, 2]), m.kf_desc[k2],
                                    m.kf_octave[k2], _kf_feats(m, k1), 7.5, scales,
                                    max_dist=float(C.TH_HIGH), nn_ratio=None)
    r12 = matching.match_projection(uv_in2, ok1 & inb(uv_in2, Xc2_of_1[:, 2]), m.kf_desc[k1],
                                    m.kf_octave[k1], _kf_feats(m, k2), 7.5, scales,
                                    max_dist=float(C.TH_HIGH), nn_ratio=None)
    n = p1.shape[0]
    j = torch.clamp(r12.idx, 0, n - 1)
    agree = r12.ok & r21.ok[j] & (r21.idx[j] == torch.arange(n, device=j.device))
    return torch.where(agree, j, -1), agree


def _count_loop_matches(m: MapState, k1: int, k2: int, S12, sim3_ok, cfg: SlamConfig):
    """Acceptance count (LoopClosing.cc:352-398): project the loop KF's
    covisible group's landmarks into the current KF under Scw = S12 T2w
    (th 10) and count current-KF features matched either way."""
    pmax = cfg.max_points
    group = (ms.covisibility_weights(m, k2) >= C.COVIS_MIN_WEIGHT) & m.kf_valid
    group = group.clone()
    group[k2] = True
    contributes = group[:, None] & (m.kf_obs >= 0) & m.kf_feat_valid
    loop_pt = torch.zeros(pmax, dtype=torch.int32, device=S12.device).scatter_reduce(
        0, _clip(m.kf_obs.reshape(-1), pmax), contributes.reshape(-1).to(torch.int32),
        reduce="amax") > 0
    loop_pt = loop_pt & m.pt_valid
    Xc = geo.transform_points(S12 @ m.kf_pose[k2], m.pt_pos)
    uv = geo.project(cfg.K, Xc)
    vis = (loop_pt & (Xc[:, 2] > 0.0) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height))
    res = matching.match_projection(uv, vis, m.pt_desc,
                                    torch.zeros(pmax, dtype=torch.int32, device=uv.device),
                                    _kf_feats(m, k1), 10.0,
                                    const(tuple(cfg.orb.scales), uv.device),
                                    max_dist=float(C.TH_LOW), nn_ratio=None,
                                    octave_band=(0, cfg.n_levels))
    n = m.kf_obs.shape[1]
    matched = torch.zeros(n, dtype=torch.int32, device=uv.device).scatter_reduce(
        0, torch.clamp(res.idx, 0, n - 1), res.ok.to(torch.int32), reduce="amax") > 0
    return torch.sum(matched | sim3_ok)


def _build_gba_problem(m: MapState, cfg: SlamConfig):
    """The full-map BAProblem (every valid KF, KF 0 fixed, every valid
    landmark) from copies of the map, so tracking can keep changing the
    live map while the GBA chunks run."""
    kmax, n = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    dev = m.kf_pose.device
    obs_pt_raw = m.kf_obs.reshape(-1)
    obs_pt = _clip(obs_pt_raw, pmax).to(torch.int32)
    obs_valid = ((obs_pt_raw >= 0) & m.kf_feat_valid.reshape(-1)
                 & m.kf_valid.repeat_interleave(n) & m.pt_valid[obs_pt.long()])
    prob = optim.BAProblem(
        cam_T=m.kf_pose.clone(),
        cam_fixed=torch.arange(kmax, device=dev) == 0,
        cam_valid=m.kf_valid.clone(),
        pts=m.pt_pos.clone(),
        pt_valid=m.pt_valid.clone(),
        obs_cam=torch.arange(kmax, dtype=torch.int32, device=dev).repeat_interleave(n),
        obs_pt=obs_pt,
        obs_uvr=torch.cat([m.kf_xy, m.kf_uright[..., None]], dim=-1).reshape(-1, 3),
        obs_oct=m.kf_octave.reshape(-1),
        obs_stereo=(m.kf_uright >= 0).reshape(-1),
        obs_valid=obs_valid,
    )
    return prob, 1.0 / _sigma2(cfg, dev)


def _global_ba_kernel(m: MapState, cfg: SlamConfig) -> MapState:
    """Synchronous full-map BA after a loop closure
    (RunGlobalBundleAdjustment, src/LoopClosing.cc:645-737) with the
    monolithic solver: every valid camera but keyframe 0 and every valid
    point take the result."""
    kmax = m.kf_pose.shape[0]
    prob, inv_s2 = _build_gba_problem(m, cfg)
    res = optim.global_bundle_adjustment(prob, inv_s2, cfg.K, cfg.bf, iters=C.GBA_ITERS)
    write_cam = m.kf_valid & (torch.arange(kmax, device=m.kf_valid.device) != 0)
    return m.replace(kf_pose=torch.where(write_cam[:, None, None], res.cam_T, m.kf_pose),
                     pt_pos=torch.where(m.pt_valid[:, None], res.pts, m.pt_pos))


def _apply_gba(m: MapState, cam_T, pts, snap_kf, snap_pt):
    """Write a GBA result into the CURRENT map with the reference's
    catch-up (src/LoopClosing.cc:676-737): KFs created after the snapshot
    follow their parent through the spanning tree in slot order; points
    created after it follow their reference KF's pose change."""
    kmax = m.kf_pose.shape[0]
    old_pose = m.kf_pose
    in_snap = snap_kf & m.kf_valid
    keep = (in_snap & (torch.arange(kmax, device=cam_T.device) != 0))[:, None, None]
    new_pose = torch.where(keep, cam_T, old_pose)
    is_new = m.kf_valid & ~snap_kf & (m.kf_parent >= 0)
    parents = m.kf_parent.tolist()
    for k in torch.nonzero(is_new).flatten().tolist():
        p = min(max(parents[k], 0), kmax - 1)
        corr = old_pose[k] @ geo.inv_T(old_pose[p]) @ new_pose[p]
        new_pose = new_pose.index_copy(0, torch.tensor([k], device=cam_T.device), corr[None])
    ref = _clip(m.pt_ref_kf, kmax)
    T_old = old_pose[ref]
    Xc = (T_old[:, :3, :3] @ m.pt_pos[..., None])[..., 0] + T_old[:, :3, 3]
    Tinv = geo.inv_T(new_pose)[ref]
    X_remap = (Tinv[:, :3, :3] @ Xc[..., None])[..., 0] + Tinv[:, :3, 3]
    new_pts = torch.where((snap_pt & m.pt_valid)[:, None], pts,
                          torch.where(m.pt_valid[:, None], X_remap, m.pt_pos))
    return m.replace(kf_pose=new_pose, pt_pos=new_pts)


def _sim3_to_se3(S):
    """[K,4,4] Sim3 -> SE3 by dividing R and t by the scale
    (src/Optimizer.cc:991-1010)."""
    s = geo.sim3_scale(S)
    return geo.make_T(S[..., :3, :3] / s[..., None, None], S[..., :3, 3] / s[..., None])


def _remap_through(m: MapState, mask, S_new):
    """p' = S_new[ref]^-1 T_old[ref] p for valid points whose reference KF
    is in mask."""
    kmax = m.kf_pose.shape[0]
    ref = _clip(m.pt_ref_kf, kmax)
    T_old = m.kf_pose[ref]
    Xc = (T_old[:, :3, :3] @ m.pt_pos[..., None])[..., 0] + T_old[:, :3, 3]
    Sinv = geo.inv_T(S_new[ref])
    Xw = (Sinv[:, :3, :3] @ Xc[..., None])[..., 0] + Sinv[:, :3, 3]
    return m.replace(pt_pos=torch.where((mask[ref] & m.pt_valid)[:, None], Xw, m.pt_pos))


def _correct_points(m: MapState, neigh_mask, S_corr):
    """Points of the corrected neighbourhood (src/LoopClosing.cc:476-512)."""
    return _remap_through(m, neigh_mask, S_corr)


def _remap_points_after_graph(m: MapState, S_new):
    """Every point through its reference KF's pose change
    (src/Optimizer.cc:1012-1043)."""
    return _remap_through(m, torch.ones_like(m.kf_valid), S_new)


def _essential_edges_kernel(m: MapState, meas_poses, loop_a, loop_b, loop_ok, cand: int,
                            kf_id: int, S12, topc: int = 32):
    """Edge sets of the essential graph (src/Optimizer.cc:851-983):
    spanning tree, per-KF top-`topc` covisibility edges with weight >= 100,
    past loop edges and the new loop edge with its measured Sim3. Edge
    measurements come from the poses before the correction
    (NonCorrectedSim3). Returns (ei, ej, Sji, ok, n_saturated)."""
    kmax = m.kf_pose.shape[0]
    dev = meas_poses.device
    poses = meas_poses
    inv_poses = geo.inv_T(poses)

    def rel_of(i, j):
        return poses[j.long()] @ inv_poses[i.long()]

    ar = torch.arange(kmax, device=dev)
    st_j = ar.to(torch.int32)
    st_i = torch.clamp(m.kf_parent, 0, kmax - 1)
    st_ok = (m.kf_parent >= 0) & m.kf_valid
    W = ms.covisibility_matrix(m)
    upper = ar[None, :] > ar[:, None]
    flat = torch.zeros(kmax * kmax, dtype=torch.bool, device=dev)
    flat = scatter_set(flat, st_i.long() * kmax + st_j.long(), st_ok)
    is_parent = scatter_set(flat, st_j.long() * kmax + st_i.long(), st_ok).reshape(kmax, kmax)
    Wm = torch.where(upper & ~is_parent & (W >= C.ESSENTIAL_MIN_WEIGHT), W, torch.zeros_like(W))
    Wm[min(cand, kf_id), max(cand, kf_id)] = 0
    la_, lb_ = torch.clamp(loop_a, 0, kmax - 1).long(), torch.clamp(loop_b, 0, kmax - 1).long()
    Wm = scatter_set(Wm.reshape(-1), torch.minimum(la_, lb_) * kmax + torch.maximum(la_, lb_),
                     0).reshape(kmax, kmax)
    topc = min(topc, kmax)
    vals, idxs = top_k(Wm, topc)
    cv_i = st_j.repeat_interleave(topc)
    cv_j = idxs.reshape(-1).to(torch.int32)
    cv_ok = vals.reshape(-1) >= C.ESSENTIAL_MIN_WEIGHT
    n_saturated = torch.sum(vals[:, topc - 1] >= C.ESSENTIAL_MIN_WEIGHT)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    ei = torch.cat([st_i, cv_i, la_.to(torch.int32), one * cand])
    ej = torch.cat([st_j, cv_j, lb_.to(torch.int32), one * kf_id])
    ok = torch.cat([st_ok, cv_ok, loop_ok, torch.ones(1, dtype=torch.bool, device=dev)])
    Sji = torch.cat([rel_of(st_i, st_j), rel_of(cv_i, cv_j), rel_of(la_, lb_), S12[None]])
    return ei, ej, Sji, ok, n_saturated


def _essential_edges(m: MapState, meas_poses, n_kfs: int, kf_id: int, cand: int, S12,
                     past_loop_edges=(), topc: int = 32):
    """Pack the accepted loop edges to a fixed 64-slot array and build the
    edge sets; every truncation is logged."""
    cap = 64
    edges = list(past_loop_edges)
    if len(edges) > cap:
        print(f"[loop_closing] WARNING: {len(edges)} accepted loop edges exceed the "
              f"essential-graph capacity {cap}; the oldest {len(edges) - cap} are dropped")
        edges = edges[-cap:]
    la = np.zeros(cap, np.int32)
    lb = np.zeros(cap, np.int32)
    lok = np.zeros(cap, bool)
    for i, (a, b, _) in enumerate(edges):
        if a < n_kfs and b < n_kfs:
            la[i], lb[i], lok[i] = a, b, True
    dev = meas_poses.device
    ei, ej, Sji, ok, n_sat = _essential_edges_kernel(
        m, meas_poses, torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev),
        torch.from_numpy(lok).to(dev), int(cand), int(kf_id),
        torch.as_tensor(S12, dtype=torch.float32, device=dev), topc=topc)
    n_sat = int(n_sat)
    if n_sat:
        print(f"[loop_closing] WARNING: covisibility edges truncated at top-{topc} for "
              f"{n_sat} keyframes (raise cfg.essential_topc)")
    return ei, ej, Sji, ok


@dataclass
class LoopCloser:
    cfg: SlamConfig
    tracker: object
    db: object                      # KeyFrameDatabase
    last_loop_kf: int = -(1 << 30)
    consistent_groups: list = field(default_factory=list)
    n_loops_closed: int = 0
    n_detections: int = 0           # queued detections harvested
    n_gba_started: int = 0
    n_gba_applied: int = 0
    # the full-map BA after a correction (LoopClosing.cc:575-579): chunked
    # in the background, one LM iteration per frame, or with
    # gba_background=False solved inside the closing frame
    gba_background: bool = True
    # accepted loop edges (a, b, S_ba) — KeyFrame::AddLoopEdge; they stay
    # in every later essential graph (src/Optimizer.cc:902-910)
    loop_edges: list = field(default_factory=list)
    # chunked background GBA: one LM iteration per frame via
    # pump_background(); aborted by a new correction, a compaction or reset
    _bg: object = None   # [prob, inv_s2, carry, it, snap_kf, snap_pt, epoch, plans]
    # queued detections: (kf_id, packed device buffer, its transfer (done() /
    # result()), pump count at queueing)
    _detect_q: object = field(default_factory=collections.deque)
    _pump_count: int = 0

    # -- state carried across packages ------------------------------------------
    def to_state(self) -> dict:
        """Host state: last loop KF, consistency groups, loop edges and the
        background-GBA carry (None when idle)."""
        bg = None
        if self._bg is not None:
            _, _, carry, it, _, _, epoch, _ = self._bg
            bg = dict(carry=[c.cpu().numpy() for c in carry], it=it, epoch=epoch)
        return dict(last_loop_kf=self.last_loop_kf,
                    consistent_groups=[(set(g), c) for g, c in self.consistent_groups],
                    loop_edges=[(a, b, np.asarray(S)) for a, b, S in self.loop_edges],
                    n_loops_closed=self.n_loops_closed, background=bg)

    def load_state(self, state: dict):
        """Adopt a state from `to_state` or from the reference's LoopCloser
        (its `_bg` list gives `background` as dict(carry, it, epoch)); a
        background GBA is rebuilt on the current map with that carry."""
        self.last_loop_kf = int(state["last_loop_kf"])
        self.consistent_groups = [(set(int(x) for x in g), int(c))
                                  for g, c in state["consistent_groups"]]
        self.loop_edges = [(int(a), int(b), np.asarray(S, np.float32))
                           for a, b, S in state["loop_edges"]]
        self.n_loops_closed = int(state.get("n_loops_closed", self.n_loops_closed))
        bg = state.get("background")
        self._bg = None
        if bg is not None:
            self._start_background_gba(self.tracker.map)
            dev = self.tracker.map.kf_pose.device
            self._bg[2] = tuple(ms.tensor_from_numpy(np.asarray(c), dev) for c in bg["carry"])
            self._bg[3] = int(bg["it"])
            self._bg[6] = int(bg.get("epoch", self._bg[6]))

    # -- per keyframe -------------------------------------------------------------
    def process(self, kf_id: int) -> bool:
        """Queue this keyframe's loop detection and harvest any that is due."""
        if self.tracker.n_kfs < 5 or kf_id - self.last_loop_kf < C.LOOP_MIN_KFS_GAP:
            self.tracker.set_kf_erasable(kf_id)
            return False
        if self.db.sparse:
            sc, cm = self.db.scores_device(kf_id=kf_id)
        else:
            sc, cm = scores_dense(self.db.bow, self.db.valid, self.db.bow[kf_id])
        packed = _detect_pack(self.tracker.map, sc, cm)
        if self.tracker.cfg.fused_tracking:
            # rides the next stats transfer (one transfer for both)
            fut = self.tracker.enqueue_side(packed.reshape(-1), packed.shape)
        else:
            # the staged mode ships no stats: a transfer of its own
            fut = _Pull(packed)
        self._detect_q.append((kf_id, packed, fut, self._pump_count))
        return self._drain_detect(force=False)

    def _drain_detect(self, force: bool) -> bool:
        """Harvest queued detections at least 4 pumps after queueing whose
        transfers have landed (all, waiting, when forced). Returns True if
        a loop closed."""
        closed = False
        while self._detect_q:
            kf_id, packed, fut, born = self._detect_q[0]
            if not force and (self._pump_count - born < 4 or not fut.done()):
                break
            self._detect_q.popleft()
            self.n_detections += 1
            # harvested -> the KF becomes erasable again (KeyFrame::SetErase)
            self.tracker.set_kf_erasable(kf_id)
            P = fut.result()
            kmax = P.shape[0]
            closed |= self._finish_detect(kf_id, P[:, :kmax].astype(np.int32), P[:, kmax],
                                          P[:, kmax + 1].astype(np.int32),
                                          P[:, kmax + 2] > 0.5)
        return closed

    def _finish_detect(self, kf_id, W, scores_all, common_all, kf_valid) -> bool:
        if kf_id - self.last_loop_kf < C.LOOP_MIN_KFS_GAP:
            return False
        cands = self._detect_loop(kf_id, W, scores_all, common_all, kf_valid)
        if not cands:
            return False
        # the snapshot predates this harvest: re-check liveness on the
        # current map before committing
        live = self.tracker.map.kf_valid.cpu().numpy()
        if not live[kf_id]:
            return False
        cands = [c for c in cands if live[c]]
        for cand in cands:
            ok, S_cur_cand = self._compute_sim3(kf_id, cand)
            if ok:
                break
        else:
            return False
        print(f"Loop detected! kf={kf_id} <-> {cand}", flush=True)
        self._correct_loop(kf_id, cand, S_cur_cand)
        self.last_loop_kf = kf_id
        self.n_loops_closed += 1
        # queued snapshots predate the correction: drop them, releasing holds
        for q_kf, *_ in self._detect_q:
            self.tracker.set_kf_erasable(q_kf)
        self._detect_q.clear()
        return True

    def _detect_loop(self, kf_id: int, W, scores_all, common_all, kf_valid):
        """DetectLoop (src/LoopClosing.cc:103-229) on the harvested arrays."""
        nbrs = np.where(W[kf_id] >= C.COVIS_MIN_WEIGHT)[0]
        nbrs = nbrs[nbrs != kf_id]
        if len(nbrs) == 0:
            return None
        min_score = max(float(scores_all[nbrs].min()), 0.0)
        candidates = self.db.detect_loop_candidates(
            self.tracker.map, kf_id, min_score, W=W, scores_common=(scores_all, common_all),
            kf_valid=kf_valid)
        if not candidates:
            _loop_dbg(f"[loop] kf={kf_id} minScore={min_score:.3f} candidates=0")
            self.consistent_groups = []
            return None
        # covisibility consistency across 3 detections (src/LoopClosing.cc:152-211)
        new_groups, enough = [], []
        for c in candidates:
            group = set(np.where(W[int(c)] > 0)[0].tolist()) | {int(c)}
            count = 0
            for pg, pc in self.consistent_groups:
                if group & pg:
                    count = max(count, pc + 1)
            new_groups.append((group, count))
            if count >= C.LOOP_CONSISTENCY_TH:
                enough.append(int(c))
        self.consistent_groups = new_groups
        _loop_dbg(f"[loop] kf={kf_id} minScore={min_score:.3f} cands={candidates} "
                  f"consistency={[c for _, c in new_groups]} -> {enough}")
        return enough

    def _compute_sim3(self, kf_id: int, cand: int):
        """ComputeSim3 (src/LoopClosing.cc:231-400). Returns (ok, S12) with
        S12 mapping candidate-camera coordinates into current-camera ones."""
        cfg = self.cfg
        m = self.tracker.map
        k1, k2 = int(kf_id), int(cand)
        scalars, res_idx, pair_ok, S12_r, inl_r = _sim3_gate(m, k1, k2, cfg)
        n_bow, r_ok, r_ninl, n_raw = scalars.tolist()
        if n_bow < C.LOOP_MIN_MATCHES_BOW:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: bow pairs {int(n_bow)} "
                      f"< {C.LOOP_MIN_MATCHES_BOW} (raw matches {int(n_raw)})")
            return False, None
        if not r_ok > 0:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: RANSAC failed "
                      f"({int(n_bow)} pairs, best {int(r_ninl)} inl)")
            return False, None
        pmax = cfg.max_points
        p1, obs2 = m.kf_obs[k1], m.kf_obs[k2]
        Xc1 = geo.transform_points(m.kf_pose[k1], m.pt_pos[_clip(p1, pmax)])
        # SearchBySim3 (ORBmatcher.cc:1102): widen the correspondences by
        # mutual projection agreement, then optimize on the union
        j_guided, guided_ok = _sim3_guided_pairs(m, k1, k2, S12_r, cfg)
        bow_pair_ok = pair_ok & inl_r
        j_union = torch.where(bow_pair_ok, res_idx, j_guided)
        union_ok = bow_pair_ok | (guided_ok & ~bow_pair_ok & m.kf_feat_valid[k1] & (p1 >= 0)
                                  & m.pt_valid[_clip(p1, pmax)])
        p2u = obs2[j_union]
        union_ok = union_ok & (p2u >= 0) & m.pt_valid[_clip(p2u, pmax)]
        Xc2_u = geo.transform_points(m.kf_pose[k2], m.pt_pos[_clip(p2u, pmax)])
        sigma2 = _sigma2(cfg, Xc1.device)
        nl = cfg.n_levels
        inv_s2_1 = 1.0 / sigma2[torch.clamp(m.kf_octave[k1], 0, nl - 1).long()]
        inv_s2_2 = 1.0 / sigma2[torch.clamp(m.kf_octave[k2][j_union], 0, nl - 1).long()]
        ores = optim.sim3_optimize(S12_r, Xc1, Xc2_u, m.kf_xy[k1], m.kf_xy[k2][j_union],
                                   inv_s2_1, inv_s2_2, union_ok, cfg.K, cfg.K,
                                   fix_scale=cfg.sensor != MONOCULAR)
        n_opt = int(ores.n_inliers)
        if n_opt < C.LOOP_MIN_INLIERS_SIM3:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: opt inliers {n_opt} "
                      f"< {C.LOOP_MIN_INLIERS_SIM3}")
            return False, None
        n_total = int(_count_loop_matches(m, k1, k2, ores.S12, union_ok & ores.inliers, cfg))
        if n_total < C.LOOP_MIN_TOTAL_MATCHES:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: total matches {n_total} "
                      f"< {C.LOOP_MIN_TOTAL_MATCHES}")
            return False, None
        return True, ores.S12

    def _correct_loop(self, kf_id: int, cand: int, S12):
        """CorrectLoop (src/LoopClosing.cc:402-643)."""
        cfg = self.cfg
        trk = self.tracker
        # the reference stops LocalMapping first: drain the mapper machine
        trk._drain_mapper()
        m = trk.map
        kmax = cfg.max_keyframes
        dev = m.kf_pose.device
        S_cw_corr = S12 @ m.kf_pose[cand]
        T_cur = m.kf_pose[kf_id]
        poses_before = m.kf_pose
        # propagate the correction to the current covisible neighbourhood:
        # S_i = (T_i T_cur^-1) S_cw_corr (src/LoopClosing.cc:443-474)
        w = ms.covisibility_weights(m, kf_id).cpu().numpy()
        neigh = set(np.where(w >= C.COVIS_MIN_WEIGHT)[0].tolist()) | {kf_id}
        neigh_np = np.zeros(kmax, bool)
        neigh_np[list(neigh)] = True
        neigh_mask = torch.from_numpy(neigh_np).to(dev)
        S_corr_all = m.kf_pose @ geo.inv_T(T_cur) @ S_cw_corr
        S_init = torch.where(neigh_mask[:, None, None], S_corr_all, m.kf_pose)
        m = _correct_points(m, neigh_mask, S_init)
        m = m.replace(kf_pose=torch.where(neigh_mask[:, None, None], _sim3_to_se3(S_init),
                                          m.kf_pose))
        # SearchAndFuse (src/LoopClosing.cc:587-643): the loop
        # neighbourhood's points into every corrected keyframe at radius 4
        wl = ms.covisibility_weights(m, cand).cpu().numpy()
        loop_kfs = [cand] + np.where(wl >= C.COVIS_MIN_WEIGHT)[0].tolist()
        obs = m.kf_obs[torch.tensor(loop_kfs, device=dev)].cpu().numpy().ravel()
        lp = np.unique(obs[obs >= 0])
        lp = lp[m.pt_valid.cpu().numpy()[lp]]
        cap = 4096
        if len(lp) > cap:
            print(f"[loop_closing] WARNING: loop neighborhood has {len(lp)} points; fusing "
                  f"only the first {cap} into corrected KFs")
        lp_vec = np.full(cap, -1, np.int32)
        lp_vec[: min(len(lp), cap)] = lp[:cap]
        lp_dev = torch.from_numpy(lp_vec).to(dev)
        for nb in sorted(neigh):
            m, _ = fuse_point_set_into_keyframe(m, lp_dev, int(nb), cfg)
        trk.map = m
        # essential graph: spanning tree + strong covisibility + the new
        # loop edge + every accepted loop edge
        ei, ej, Sji, valid_edges = _essential_edges(m, poses_before, trk.n_kfs, kf_id, cand,
                                                    S12, self.loop_edges,
                                                    topc=cfg.essential_topc)
        self.loop_edges.append((cand, kf_id, S12.cpu().numpy()))
        fixed = torch.arange(kmax, device=dev) == cand
        if kmax <= 320:
            res = optim.essential_graph_optimize(m.kf_pose, m.kf_valid, fixed, ei, ej, Sji,
                                                 valid_edges, fix_scale=cfg.sensor != MONOCULAR)
        else:
            res = optim.essential_graph_optimize_sparse(
                m.kf_pose, m.kf_valid, fixed, ei, ej, Sji, valid_edges,
                fix_scale=cfg.sensor != MONOCULAR, cg_iters=min(2 * kmax, 2400))
        m = _remap_points_after_graph(m, res.S)
        m = m.replace(kf_pose=torch.where(m.kf_valid[:, None, None], _sim3_to_se3(res.S),
                                          m.kf_pose))
        trk.map = m
        # a new correction replaces any GBA in flight (src/LoopClosing.cc:410-423)
        self._bg = None
        if self.gba_background:
            self._start_background_gba(m)
        else:
            trk.map = m = _global_ba_kernel(m, cfg)
            self.n_gba_applied += 1
        # the tracker's pose jumps with the map
        self._set_tracker_pose(m.kf_pose[kf_id].cpu().numpy())

    def _set_tracker_pose(self, Tcw):
        trk = self.tracker
        trk.last_Tcw = Tcw
        trk.velocity = None
        if trk.ds is not None:
            T = trk.ds.T_last if Tcw is None else torch.as_tensor(
                np.asarray(Tcw, np.float32), device=trk.ds.T_last.device)
            trk.ds = trk.ds.replace(T_last=T, have_vel=False)

    # -- chunked background GBA ----------------------------------------------------
    def _start_background_gba(self, m: MapState):
        cfg = self.cfg
        prob, inv_s2 = _build_gba_problem(m, cfg)
        carry = optim.gba_init_carry(prob, inv_s2, cfg.K, cfg.bf)
        self._bg = [prob, inv_s2, carry, 0, prob.cam_valid, prob.pt_valid,
                    self.tracker.compaction_epoch, optim._gba_plans(prob)]
        self.n_gba_started += 1

    def pump_background(self) -> bool:
        """Advance a pending background GBA by one LM iteration; called
        once per frame. Also harvests due loop detections. Returns True
        while a GBA is in flight."""
        self._pump_count += 1
        if self._detect_q:
            self._drain_detect(force=False)
        if self._bg is None:
            return False
        prob, inv_s2, carry, it, _, _, _, plans = self._bg
        cfg = self.cfg
        self._bg[2] = optim.gba_chunk(prob, inv_s2, carry, it, cfg.K, cfg.bf, n_iters=1,
                                      plans=plans)
        self._bg[3] = it + 1
        if it + 1 >= C.GBA_ITERS:
            self._apply_background()
            return False
        return True

    def finish_background(self):
        """Force queued detections through, then run the remaining chunks
        (a closure found here starts a GBA that also completes)."""
        self._drain_detect(force=True)
        while self._bg is not None:
            self.pump_background()

    def abort_background(self):
        self._bg = None
        for q_kf, *_ in self._detect_q:
            self.tracker.set_kf_erasable(q_kf)
        self._detect_q.clear()

    def _apply_background(self):
        prob, inv_s2, carry, _, snap_kf, snap_pt, snap_epoch, _ = self._bg
        self._bg = None
        trk = self.tracker
        trk._flush_all()
        if trk.compaction_epoch != snap_epoch:
            # the point arena was renumbered under the snapshot: discard
            print("[loop] background GBA discarded: point arena compacted mid-flight",
                  flush=True)
            return
        cfg = self.cfg
        res = optim.gba_result(prob, inv_s2, cfg.K, cfg.bf, carry)
        trk._flush_all()
        m = trk.map
        # the map may have grown to a larger tier while the chunks ran:
        # growth keeps every id, so the snapshot-shaped result is padded
        # (new slots are not in the snapshot and get the catch-up)
        cam_T, pts = res.cam_T, res.pts
        dk, dp = m.kf_pose.shape[0] - cam_T.shape[0], m.pt_pos.shape[0] - pts.shape[0]
        if dk > 0:
            cam_T = torch.cat([cam_T, torch.eye(4, dtype=cam_T.dtype,
                                                device=cam_T.device).repeat(dk, 1, 1)])
            snap_kf = torch.cat([snap_kf, snap_kf.new_zeros(dk)])
        if dp > 0:
            pts = torch.cat([pts, pts.new_zeros((dp, 3))])
            snap_pt = torch.cat([snap_pt, snap_pt.new_zeros(dp)])
        ref = trk.ref_kf if trk.ref_kf >= 0 else 0
        T_ref_old = m.kf_pose[ref].cpu().numpy()
        m = _apply_gba(m, cam_T, pts, snap_kf, snap_pt)
        trk.map = m
        self.n_gba_applied += 1
        # keep the tracker's pose relative to its reference KF
        Tcw = None
        if trk.last_Tcw is not None:
            Tcr = np.asarray(trk.last_Tcw) @ np.linalg.inv(T_ref_old)
            Tcw = Tcr @ m.kf_pose[ref].cpu().numpy()
        self._set_tracker_pose(Tcw)
