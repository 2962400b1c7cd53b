"""Monocular map bootstrap — the port of
`orb_slam2_comment_tpu/models/initializer.py` (Tracking::
MonocularInitialization + CreateInitialMapMonocular, src/Tracking.cc:
563-737).

Keeps a reference frame with > 100 features; each new frame is matched
with a 100 px window search around the reference features' last matched
positions; on enough matches the batched two-view solver runs; on success
the initial map is written: two keyframes, the triangulated points, a
20-iteration global BA and median-depth scale normalization. The host
bookkeeping stays in numpy with the reference's own calls.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.models import local_mapping as lm
from orb_slam2_comment_tpu_torch.models.frame import Frame
from orb_slam2_comment_tpu_torch.ops import matching, optim, twoview
from orb_slam2_comment_tpu_torch.ops.scatter import const
from orb_slam2_comment_tpu_torch.utils.config import SlamConfig


def _insert_kf(m, slot: int, f: Frame, T, obs_row):
    """One keyframe's rows, as the reference writes them (no erase
    protection, parent 0 for the second keyframe)."""
    def row(name, value):
        return lm._set_row(getattr(m, name), slot, value)

    return m.replace(
        kf_pose=row("kf_pose", T), kf_valid=row("kf_valid", True),
        kf_frame_id=row("kf_frame_id", int(f.frame_id)),
        kf_timestamp=row("kf_timestamp", float(f.timestamp)),
        kf_xy=row("kf_xy", f.feats.xy), kf_octave=row("kf_octave", f.feats.octave),
        kf_angle=row("kf_angle", f.feats.angle), kf_uright=row("kf_uright", f.uright),
        kf_depth=row("kf_depth", f.depth), kf_desc=row("kf_desc", f.feats.desc),
        kf_feat_valid=row("kf_feat_valid", f.feats.valid), kf_obs=row("kf_obs", obs_row),
        kf_parent=row("kf_parent", 0 if slot else -1))


class MonocularInitializer:
    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.ref: Optional[Frame] = None

    def reset(self):
        self.ref = None

    def try_initialize(self, tracker, frame: Frame) -> bool:
        """Returns True when the initial two-keyframe map was created."""
        cfg = self.cfg
        dev = frame.feats.xy.device
        n_valid = int(torch.sum(frame.feats.valid))
        if self.ref is None:
            if n_valid > 100:
                self.ref = frame
                # last matched position per reference feature (the
                # reference's mvbPrevMatched, Tracking.cc:597-598)
                self.prev_xy = frame.feats.xy
            return False
        if n_valid <= 100:
            self.ref = None
            return False

        # window search around each reference feature's last matched
        # position (SearchForInitialization + Tracking.cc:625-630)
        res = matching.match_window(self.ref.feats.replace(xy=self.prev_xy), frame.feats,
                                    max_dist=cfg.th_low)
        ok_np = res.ok.cpu().numpy()
        idx_np = res.idx.cpu().numpy()
        n_matches = int(ok_np.sum())
        # 100 matches at the reference's doubled init budget (Tracking.cc:
        # 117,612), scaled to the single budget
        if n_matches < max(40, cfg.n_features // 20):
            self.ref = None
            return False
        prev = self.prev_xy.cpu().numpy().copy()
        prev[ok_np] = frame.feats.xy.cpu().numpy()[idx_np[ok_np]]
        self.prev_xy = torch.from_numpy(prev).to(dev)

        tv = twoview.two_view_init(self.ref.feats.xy, frame.feats.xy[res.idx], res.ok, cfg.K)
        if not bool(tv.ok):
            return False

        # ---- the initial map (CreateInitialMapMonocular) ----
        good = tv.good.cpu().numpy()
        X = tv.X.cpu().numpy()
        # median-depth scale normalization (Tracking.cc:686-712)
        med_depth = float(np.median(X[good][:, 2]))
        if med_depth <= 0:
            return False
        inv_med = 1.0 / med_depth
        X = X * inv_med
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = tv.R21.cpu().numpy()
        T2[:3, 3] = tv.t21.cpu().numpy() * inv_med

        nf = frame.n_feat
        pmax = cfg.max_points
        # one point slot per good match
        good_idx = np.where(good)[0]
        n_new = len(good_idx)
        ids = np.arange(n_new)
        obs0 = np.full(self.ref.n_feat, -1, np.int32)
        obs1 = np.full(nf, -1, np.int32)
        obs0[good_idx] = ids
        obs1[idx_np[good_idx]] = ids

        desc0 = self.ref.feats.desc.cpu().numpy()
        oct0 = self.ref.feats.octave.cpu().numpy()
        Xn = X[good_idx]
        dist = np.linalg.norm(Xn, axis=1)
        lvl = oct0[good_idx].astype(np.float32)
        max_dist = dist * cfg.scale_factor ** lvl
        min_dist = max_dist / cfg.scale_factor ** (cfg.n_levels - 1)

        def pad(a, fill=0.0):
            out = np.full((pmax,) + a.shape[1:], fill, a.dtype)
            out[:n_new] = a
            return torch.from_numpy(out).to(dev)

        m = tracker.map.replace(
            pt_pos=pad(Xn.astype(np.float32)),
            pt_valid=pad(np.ones(n_new, bool), False),
            pt_desc=pad(desc0[good_idx]),
            pt_normal=pad((Xn / np.maximum(dist[:, None], 1e-9)).astype(np.float32)),
            pt_min_dist=pad(min_dist.astype(np.float32)),
            pt_max_dist=pad(max_dist.astype(np.float32), 1e9),
            pt_ref_kf=pad(np.zeros(n_new, np.int32), -1),
            pt_first_kf=pad(np.zeros(n_new, np.int32), -1),
            pt_visible=pad(np.ones(n_new, np.int32)),
            pt_found=pad(np.ones(n_new, np.int32)),
        )
        m = _insert_kf(m, 0, self.ref, torch.from_numpy(T1).to(dev),
                       torch.from_numpy(obs0).to(dev))
        m = _insert_kf(m, 1, frame, torch.from_numpy(T2).to(dev),
                       torch.from_numpy(obs1).to(dev))

        # 20-iteration global BA on the two-keyframe map (Tracking.cc:686)
        inv_s2 = const(tuple(1.0 / (cfg.scale_factor ** (2 * l)) for l in range(cfg.n_levels)),
                       dev)
        n_ba = max(n_new, 8)
        obs = torch.cat([m.kf_obs[0], m.kf_obs[1]])
        prob = optim.BAProblem(
            cam_T=m.kf_pose[:2],
            cam_fixed=torch.tensor([True, False], device=dev),
            cam_valid=torch.ones(2, dtype=torch.bool, device=dev),
            pts=m.pt_pos[:n_ba],
            pt_valid=m.pt_valid[:n_ba],
            obs_cam=torch.arange(2, dtype=torch.int32, device=dev).repeat_interleave(nf),
            obs_pt=torch.clamp(obs, 0, n_ba - 1),
            obs_uvr=torch.cat([torch.cat([m.kf_xy[k], m.kf_uright[k][:, None]], dim=-1)
                               for k in (0, 1)]),
            obs_oct=torch.cat([m.kf_octave[0], m.kf_octave[1]]),
            obs_stereo=torch.zeros(2 * nf, dtype=torch.bool, device=dev),
            obs_valid=obs >= 0,
        )
        res_ba = optim.global_bundle_adjustment(prob, inv_s2, cfg.K, cfg.bf,
                                                iters=C.INIT_GBA_ITERS)
        pt_pos = m.pt_pos.clone()
        pt_pos[:n_ba] = res_ba.pts
        m = m.replace(kf_pose=lm._set_row(m.kf_pose, 1, res_ba.cam_T[1]), pt_pos=pt_pos)

        tracker.map = m
        tracker.n_kfs = 2
        tracker.n_pts = n_new
        tracker.ref_kf = 1
        tracker.last_kf_frame_id = frame.frame_id
        frame.Tcw = m.kf_pose[1]
        frame.assoc = torch.from_numpy(obs1).to(dev)
        tracker.last_Tcw = m.kf_pose[1].cpu().numpy()
        tracker.last_frame = frame
        for cb in tracker.new_kf_callbacks:
            cb(0)
            cb(1)
        return n_new >= C.INIT_MIN_TRIANGULATED
