"""Per-image frame construction — the port of
`orb_slam2_comment_tpu/models/frame.py`: RGB-D, stereo and monocular
frames. The `*_features` helpers are shared by the host path's frames and
the tracker's device step."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.ops import orb, stereo
from orb_slam2_comment_tpu_torch.utils.config import SlamConfig


@dataclass
class Frame:
    """One tracked frame. `assoc` maps feature slot -> map point id (-1)."""

    frame_id: int
    timestamp: float
    feats: orb.FrameFeatures
    uright: torch.Tensor                   # [N] f32, -1 where none
    depth: torch.Tensor                    # [N] f32, -1 where unknown
    Tcw: Optional[torch.Tensor] = None     # [4,4]
    assoc: Optional[torch.Tensor] = None   # [N] int32 map point ids
    pyramid: Optional[list] = None

    @property
    def n_feat(self):
        return self.feats.xy.shape[0]


def undistort_points(xy: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    """Iterative inversion of the radial-tangential distortion model
    (Frame::UndistortKeyPoints); a no-op without distortion."""
    if not cfg.has_distortion:
        return xy
    fx, fy, cx, cy = cfg.K
    x = (xy[:, 0] - cx) / fx
    y = (xy[:, 1] - cy) / fy
    x0, y0 = x, y
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cfg.k1 + r2 * (cfg.k2 + r2 * cfg.k3))
        dx = 2 * cfg.p1 * x * y + cfg.p2 * (r2 + 2 * x * x)
        dy = cfg.p1 * (r2 + 2 * y * y) + 2 * cfg.p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def image_to_tensor(image, device) -> torch.Tensor:
    """uint8 (or float) gray image -> f32 tensor on `device`; the image
    crosses to the device in its native dtype."""
    if isinstance(image, torch.Tensor):
        return image.to(device).to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(image)).to(device).to(torch.float32)


def depth_to_tensor(depth_map, device) -> torch.Tensor:
    """Depth map (uint16 in sensor units, or float) -> tensor on `device`.
    uint16 travels as its int16 bit pattern (torch's uint16 support is
    thin) and is widened on the device."""
    if isinstance(depth_map, torch.Tensor):
        return depth_map.to(device)
    a = np.ascontiguousarray(depth_map)
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def rgbd_features(image: torch.Tensor, depth_map: torch.Tensor, cfg: SlamConfig):
    """Extraction + depth per keypoint + undistortion (a host-path RGB-D
    frame; the pipeline splits it into stage A and rgbd_depth). Returns
    (feats, uright, depth, pyramid)."""
    feats, pyr, _ = orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))
    return rgbd_depth(feats, depth_map, cfg) + (pyr,)


def rgbd_depth(feats: orb.FrameFeatures, depth_map: torch.Tensor, cfg: SlamConfig):
    """Depth per keypoint from the full depth map (nearest pixel), right u
    and undistortion: what follows extraction in an RGB-D frame (the
    pipeline's stage B starts here). Returns (feats, uright, depth)."""
    d = stereo.sample_depth_at(depth_map, feats.xy).to(torch.float32)
    if cfg.depth_map_factor != 1.0:
        d = d / cfg.depth_map_factor
    uright, depth = stereo.depth_to_uright(feats.xy, d, cfg.bf)
    return feats.replace(xy=undistort_points(feats.xy, cfg)), uright, depth


def stereo_features(image_l: torch.Tensor, image_r: torch.Tensor, cfg: SlamConfig):
    """Extraction of both images, stereo matching on the left keypoints
    and undistortion (the front half of tracking._frame_step_stereo).
    Returns (feats, uright, depth, left pyramid)."""
    shape = (cfg.height, cfg.width)
    feats_l, pyr_l, stack_l = orb._extract_impl(image_l, cfg.orb, shape)
    feats_r, _, stack_r = orb._extract_impl(image_r, cfg.orb, shape)
    uright, depth = stereo.stereo_match(
        feats_l, feats_r, stack_l, stack_r, cfg.orb.level_sizes(*shape), tuple(cfg.orb.scales),
        cfg.bf, min_z=cfg.baseline, n_levels=cfg.n_levels,
        th_stereo=min(75.0 * cfg.match_th_scale, 100.0))
    feats_l = feats_l.replace(xy=undistort_points(feats_l.xy, cfg))
    return feats_l, uright, depth, pyr_l


def mono_features(image: torch.Tensor, cfg: SlamConfig, ocfg: Optional[orb.ORBConfig] = None):
    """Extraction (with `ocfg`, cfg.orb by default) and undistortion; no
    feature has a right u or a depth. Returns (feats, uright, depth,
    pyramid)."""
    feats, pyr, _ = orb._extract_impl(image, ocfg or cfg.orb, (cfg.height, cfg.width))
    none = torch.full(feats.valid.shape, -1.0, dtype=torch.float32, device=image.device)
    return feats.replace(xy=undistort_points(feats.xy, cfg)), none, none.clone(), pyr


def build_frame_stereo(frame_id: int, timestamp: float, image_left, image_right,
                       cfg: SlamConfig, device="cpu") -> Frame:
    feats, uright, depth, pyr = stereo_features(
        image_to_tensor(image_left, device), image_to_tensor(image_right, device), cfg)
    return Frame(frame_id, timestamp, feats, uright, depth, pyramid=pyr)


def build_frame_mono(frame_id: int, timestamp: float, image, cfg: SlamConfig,
                     device="cpu", double_features: bool = False) -> Frame:
    """Monocular frame; `double_features` extracts twice cfg's budget, as
    the reference's initializer extractor does (Tracking.cc:243-247,
    mpIniORBextractor)."""
    ocfg = cfg.orb
    if double_features:
        ocfg = ocfg._replace(n_features=2 * ocfg.n_features)
    feats, uright, depth, pyr = mono_features(image_to_tensor(image, device), cfg, ocfg)
    return Frame(frame_id, timestamp, feats, uright, depth, pyramid=pyr)


def build_frame_rgbd(frame_id: int, timestamp: float, image, depth_map,
                     cfg: SlamConfig, device="cpu") -> Frame:
    feats, uright, depth, pyr = rgbd_features(
        image_to_tensor(image, device), depth_to_tensor(depth_map, device), cfg)
    return Frame(frame_id, timestamp, feats, uright, depth, pyramid=pyr)
