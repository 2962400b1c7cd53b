"""Per-image frame construction — the RGB-D part of
`orb_slam2_comment_tpu/models/frame.py`."""

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
    """Extraction + depth per keypoint + undistortion (the front half of
    tracking._frame_step_rgbd). Returns (feats, uright, depth, pyramid)."""
    feats, pyr = orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))
    d = stereo.sample_depth_at(depth_map, feats.xy).to(torch.float32)
    if cfg.depth_map_factor != 1.0:
        d = d / cfg.depth_map_factor
    uright, depth = stereo.depth_to_uright(feats.xy, d, cfg.bf)
    feats = feats.replace(xy=undistort_points(feats.xy, cfg))
    return feats, uright, depth, pyr


def build_frame_rgbd(frame_id: int, timestamp: float, image, depth_map,
                     cfg: SlamConfig, device="cpu") -> Frame:
    feats, uright, depth, pyr = rgbd_features(
        image_to_tensor(image, device), depth_to_tensor(depth_map, device), cfg)
    return Frame(frame_id, timestamp, feats, uright, depth, pyramid=pyr)
