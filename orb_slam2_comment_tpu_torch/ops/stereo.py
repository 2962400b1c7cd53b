"""RGB-D depth association — `sample_depth_at` and `depth_to_uright` of
`orb_slam2_comment_tpu/ops/stereo.py` (Frame::ComputeStereoFromRGBD,
src/Frame.cc:643-664). Stereo matching is outside this port's slice."""

from __future__ import annotations

import torch


def depth_to_uright(xy: torch.Tensor, depth: torch.Tensor, bf: float):
    """RGB-D: synthesize the right-image u from measured depth."""
    valid = depth > 0
    neg = torch.full_like(depth, -1.0)
    u_right = torch.where(valid, xy[:, 0] - bf / torch.clamp(depth, min=1e-6), neg)
    d = torch.where(valid, depth, neg)
    return u_right, d


def sample_depth_at(depth_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour depth lookup at keypoint locations (round half to
    even, as jnp.round)."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    return depth_map[y, x]
