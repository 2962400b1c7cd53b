"""System configuration: `SlamConfig` and `ORBConfig`.

Field for field the same as the JAX package's `utils/config.SlamConfig` and
`ops/orb.ORBConfig` (same names, defaults and derived properties). They are
kept here because the JAX ones cannot be imported without jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from orb_slam2_comment_tpu_torch import constants as C

MONOCULAR = "monocular"
STEREO = "stereo"
RGBD = "rgbd"


def resolve_device(device, who: str) -> torch.device:
    """The device of a public class: CUDA unless the caller names another,
    and no silent fallback to the CPU when there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


class ORBConfig(NamedTuple):
    """Static extraction config (Examples/*/ *.yaml ORBextractor.* keys)."""

    n_features: int = C.DEFAULT_N_FEATURES
    n_levels: int = C.DEFAULT_N_LEVELS
    scale_factor: float = C.DEFAULT_SCALE_FACTOR
    ini_th: float = float(C.DEFAULT_INI_TH_FAST)
    min_th: float = float(C.DEFAULT_MIN_TH_FAST)
    cell: int = 32  # spatial-distribution bucket size (px)

    @property
    def scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    @property
    def sigma2(self):
        return [s * s for s in self.scales]

    def level_sizes(self, h: int, w: int):
        return [
            (max(int(round(h / s)), 64), max(int(round(w / s)), 64))
            for s in self.scales
        ]

    def level_budgets(self):
        """Geometric per-level feature budget (src/ORBextractor.cc:200-221)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = [max(int(round(n0 * f ** l)), 8) for l in range(self.n_levels)]
        budgets[-1] = max(self.n_features - sum(budgets[:-1]), 8)
        return budgets


@dataclass(frozen=True)
class SlamConfig:
    sensor: str = RGBD
    # Camera intrinsics / model
    fx: float = 520.0
    fy: float = 520.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 156.0          # baseline(m) * fx  (Camera.bf)
    fps: float = 20.0
    rgb: bool = True
    width: int = 640
    height: int = 480
    th_depth: float = 35.0     # close/far split: depth < bf*ThDepth/fx
    depth_map_factor: float = 1.0
    # ORB extraction
    n_features: int = C.DEFAULT_N_FEATURES
    scale_factor: float = C.DEFAULT_SCALE_FACTOR
    n_levels: int = C.DEFAULT_N_LEVELS
    ini_th_fast: float = float(C.DEFAULT_INI_TH_FAST)
    min_th_fast: float = float(C.DEFAULT_MIN_TH_FAST)
    # Static map capacities
    max_keyframes: int = 256
    max_points: int = 32768
    grow_capacity: bool = field(default=True, compare=False)
    max_keyframes_cap: int = 2048
    max_points_cap: int = 262144
    # Local-mapping window capacities
    ba_free_kfs: int = 16
    ba_fixed_kfs: int = 16
    ba_points: int = 2048
    tri_neighbors: int = 10
    fuse_neighbors: int = 10
    essential_topc: int = 32
    # Pipeline toggles
    enable_local_ba: bool = True
    enable_loop_closing: bool = field(default=True, compare=False)
    enable_kf_culling: bool = True
    localization_only: bool = False
    chunked_mapper: bool = True
    fused_tracking: bool = field(default=True, compare=False)
    pipeline_lag: int = field(default=4, compare=False)
    match_th_scale: float = 1.0
    voc_levels: int = 2

    @property
    def th_low(self):
        return min(float(C.TH_LOW) * self.match_th_scale, 100.0)

    @property
    def th_high(self):
        return float(C.TH_HIGH)

    @property
    def K(self):
        return (self.fx, self.fy, self.cx, self.cy)

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def depth_threshold(self):
        """Meters below which a stereo/RGBD point counts as 'close'
        (mThDepth = mbf * ThDepth / fx, Tracking.cc:126-131)."""
        return self.bf * self.th_depth / self.fx

    @property
    def orb(self) -> ORBConfig:
        return ORBConfig(
            n_features=self.n_features,
            n_levels=self.n_levels,
            scale_factor=self.scale_factor,
            ini_th=self.ini_th_fast,
            min_th=self.min_th_fast,
        )

    @property
    def has_distortion(self):
        return any(abs(v) > 1e-12 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))
