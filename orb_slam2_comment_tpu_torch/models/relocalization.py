"""Relocalization after tracking loss — the port of
`orb_slam2_comment_tpu/models/relocalization.py` (Tracking::Relocalization,
src/Tracking.cc:1341-1502).

Per candidate keyframe from the BoW database: descriptor matching to the
KF's map points (>= 15), EPnP RANSAC, motion-only BA; candidates short of
50 inliers after it get a widened projective re-search and a second BA.
The reference maps over a fixed axis of RELOC_MAX_CANDIDATES candidates;
here the matching and RANSAC loop over the candidates and each BA pass is
ONE batched launch of kernel K3 over all of them (disabled candidates get
an all-invalid edge mask). The reference's `lax.cond` on needs_widen
becomes a host read of the 5 flags; only flagged candidates take the
widened result.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.models.map_state import MapState
from orb_slam2_comment_tpu_torch.models.tracking import (
    _clip, _inv_sigma2, _match_against_points)
from orb_slam2_comment_tpu_torch.ops import bow as bow_mod
from orb_slam2_comment_tpu_torch.ops import matching, optim, ransac
from orb_slam2_comment_tpu_torch.ops.scatter import const, scatter_set
from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

RELOC_MAX_CANDIDATES = 5


def _pose_opt_batch(m: MapState, T0, feats, uright, assoc, cfg: SlamConfig):
    """`_pose_opt_from_assoc` for B candidate poses at once: T0 [B,4,4],
    assoc [B,N] -> (Tcw [B,4,4], assoc' [B,N], n_inliers [B])."""
    B = assoc.shape[0]
    pid = _clip(assoc, m.pt_pos.shape[0])
    valid = (assoc >= 0) & m.pt_valid[pid] & feats.valid[None]
    obs = torch.cat([feats.xy, uright[:, None]], dim=-1)
    res = optim.pose_optimize(T0, m.pt_pos[pid], obs.expand(B, -1, -1),
                              feats.octave.expand(B, -1), (uright >= 0).expand(B, -1), valid,
                              _inv_sigma2(cfg, obs.device), cfg.K, cfg.bf)
    return res.Tcw, torch.where(res.inliers, assoc, -1), res.n_inliers


def reloc_candidates(m: MapState, cand_ids, feats, uright, cfg: SlamConfig):
    """Try every candidate; return (ok_any, first ok index, Tcw [C,4,4],
    assoc [C,N], n_inl [C]) — the first success wins, as the reference's
    loop breaks on the first candidate reaching 50 inliers.
    cand_ids: host list of RELOC_MAX_CANDIDATES ints, -1 padded."""
    kmax = m.kf_pose.shape[0]
    n = feats.xy.shape[0]
    dev = feats.xy.device
    sig2 = const(tuple(cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)), dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    assoc_in, T_pnp, pnp_ok, bow_ok = [], [], [], []
    for c in cand_ids:
        if c < 0:
            assoc_in.append(torch.full((n,), -1, dtype=torch.int32, device=dev))
            T_pnp.append(eye)
            pnp_ok.append(torch.zeros((), dtype=torch.bool, device=dev))
            bow_ok.append(torch.zeros((), dtype=torch.bool, device=dev))
            continue
        kf_j = min(max(int(c), 0), kmax - 1)
        # 1. descriptor matching to the candidate KF's map points
        kf_obs = m.kf_obs[kf_j]
        kf_ok = m.kf_feat_valid[kf_j] & (kf_obs >= 0)
        dist = matching.hamming_from_packed(m.kf_desc[kf_j], feats.desc)
        res = matching.match_generic(dist, kf_ok[:, None] & feats.valid[None, :],
                                     max_dist=cfg.th_low, nn_ratio=0.75, mutual=True,
                                     angles_a=m.kf_angle[kf_j], angles_b=feats.angle)
        assoc = scatter_set(torch.full((n,), -1, dtype=torch.int32, device=dev), res.idx,
                            torch.where(res.ok, kf_obs, -1))
        assoc = torch.where(feats.valid, assoc, -1)
        valid = (assoc >= 0) & m.pt_valid[_clip(assoc, m.pt_pos.shape[0])]
        enough_bow = torch.sum(valid) >= 15
        valid = valid & enough_bow
        # 2. PnP RANSAC on the putative 2D-3D matches
        pnp = ransac.pnp_ransac(m.pt_pos[_clip(assoc, m.pt_pos.shape[0])], feats.xy,
                                feats.octave, valid, sig2, cfg.K)
        assoc_in.append(torch.where(valid & pnp.ok, assoc, -1))
        T_pnp.append(pnp.Tcw)
        pnp_ok.append(pnp.ok)
        bow_ok.append(enough_bow)
    pnp_ok = torch.stack(pnp_ok)
    # 3. motion-only BA for all candidates in one K3 launch
    Tcw, assoc2, n_inl = _pose_opt_batch(m, torch.stack(T_pnp), feats, uright,
                                         torch.stack(assoc_in), cfg)
    needs_widen = (n_inl >= 10) & (n_inl < C.RELOC_MIN_INLIERS) & pnp_ok
    widen = [i for i, f in enumerate(needs_widen.tolist()) if f]
    if widen:
        merged = []
        for i in widen:
            kf_j = min(max(int(cand_ids[i]), 0), kmax - 1)
            assoc3, _, _ = _match_against_points(m, m.kf_obs[kf_j], Tcw[i], feats, uright, 10.0,
                                                 cfg, use_frustum_band=False)
            merged.append(torch.where(assoc2[i] >= 0, assoc2[i], assoc3))
        T_w, a_w, n_w = _pose_opt_batch(m, Tcw[widen], feats, uright, torch.stack(merged), cfg)
        sel = torch.tensor(widen, device=dev)
        Tcw = Tcw.index_copy(0, sel, T_w)
        assoc2 = assoc2.index_copy(0, sel, a_w)
        n_inl = n_inl.index_copy(0, sel, n_w)
    enabled = torch.tensor([c >= 0 for c in cand_ids], device=dev)
    ok = enabled & torch.stack(bow_ok) & pnp_ok & (n_inl >= C.RELOC_MIN_INLIERS)
    return torch.any(ok), torch.argmax(ok.to(torch.int32)), Tcw, assoc2, n_inl


def relocalize(m: MapState, db, frame, cfg: SlamConfig, rank_offset: int = 0):
    """Recover the pose of a lost frame against the top BoW candidates.
    rank_offset rotates through the ranked candidate list on consecutive
    failures (see AdaptiveRelocalizer). Returns (success, Tcw, assoc,
    n_candidates)."""
    words, _, vec = bow_mod.transform(db.voc, frame.feats.desc, frame.feats.valid)
    candidates = db.detect_reloc_candidates(vec, valid_mask=m.kf_valid, m=m, query_words=words,
                                            max_out=4 * RELOC_MAX_CANDIDATES)
    if not candidates:
        return False, None, None, 0
    if rank_offset:
        candidates = candidates[rank_offset:] or candidates
    cand = np.full(RELOC_MAX_CANDIDATES, -1, np.int64)
    k = min(len(candidates), RELOC_MAX_CANDIDATES)
    cand[:k] = candidates[:k]
    ok_any, first, Tcw, assoc, _ = reloc_candidates(m, cand.tolist(), frame.feats,
                                                    frame.uright, cfg)
    if not bool(ok_any):
        return False, None, None, len(candidates) + rank_offset
    i = int(first)
    return True, Tcw[i], assoc[i], len(candidates) + rank_offset


class AdaptiveRelocalizer:
    """Retry ladder over relocalize(): each consecutive LOST frame moves
    rank_offset by RELOC_MAX_CANDIDATES, wrapping when the list runs out."""

    def __init__(self):
        self.fail_streak = 0
        self._n_cand = RELOC_MAX_CANDIDATES

    def reset(self):
        self.fail_streak = 0

    def __call__(self, m, db, frame, cfg):
        pages = max(1, -(-self._n_cand // RELOC_MAX_CANDIDATES))
        offset = (self.fail_streak % pages) * RELOC_MAX_CANDIDATES
        ok, Tcw, assoc, n_cand = relocalize(m, db, frame, cfg, rank_offset=offset)
        self._n_cand = max(n_cand, 1)
        self.fail_streak = 0 if ok else self.fail_streak + 1
        return ok, Tcw, assoc
