"""System configuration: `SlamConfig` and `ORBConfig`.

Field for field the same as the JAX package's `utils/config.SlamConfig` and
`ops/orb.ORBConfig` (same names, defaults and derived properties). They are
kept here because the JAX ones cannot be imported without jax. The settings
readers `load_yaml_settings` and `load_rectification` are copies of the
JAX package's, held equal by tests/test_torch_drivers.py.
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


def load_yaml_settings(path: str, sensor: str) -> SlamConfig:
    """Parse an ORB-SLAM2-style YAML settings file (same keys as the
    reference's cv::FileStorage usage, e.g. Examples/RGB-D/TUM1.yaml).

    Supports the OpenCV '%YAML:1.0' header and flat 'Key.sub: value' lines
    without requiring a yaml library.
    """
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if not val:
                continue
            try:
                vals[key] = float(val)
            except ValueError:
                vals[key] = val

    def g(key, default):
        return vals.get(key, default)

    return SlamConfig(
        sensor=sensor,
        fx=g("Camera.fx", 520.0),
        fy=g("Camera.fy", 520.0),
        cx=g("Camera.cx", 320.0),
        cy=g("Camera.cy", 240.0),
        k1=g("Camera.k1", 0.0),
        k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0),
        p2=g("Camera.p2", 0.0),
        k3=g("Camera.k3", 0.0),
        bf=g("Camera.bf", 0.0),
        fps=g("Camera.fps", 30.0),
        rgb=bool(int(g("Camera.RGB", 1))),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        th_depth=g("ThDepth", 35.0),
        depth_map_factor=g("DepthMapFactor", 1.0),
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=g("ORBextractor.iniThFAST", 20.0),
        min_th_fast=g("ORBextractor.minThFAST", 7.0),
        # extension key (not in the reference): Hamming acceptance scaling
        # for low-texture/synthetic footage, cf. SlamConfig.match_th_scale
        match_th_scale=g("Matcher.thScale", 1.0),
    )


def load_rectification(path: str):
    """Parse the LEFT./RIGHT. {K,D,R,P,height,width} stereo-rectification
    blocks from an EuRoC-style settings YAML (Examples/Stereo/EuRoC.yaml:
    34-76, consumed by stereo_euroc.cc:63-98 and ros_stereo.cc:71-108).

    Returns (K1, D1, R1, P1, K2, D2, R2, P2, (h, w)) as numpy arrays, or
    None when the file carries no rectification blocks. Handles the
    OpenCV '!!opencv-matrix' node format without a yaml library.
    """
    import re

    import numpy as np

    text = open(path).read()
    mats = {}
    for m in re.finditer(
        r"(LEFT|RIGHT)\.(K|D|R|P)\s*:\s*!!opencv-matrix"
        r".*?data\s*:\s*\[(.*?)\]",
        text,
        re.DOTALL,
    ):
        side, name, data = m.group(1), m.group(2), m.group(3)
        vals = [float(v) for v in re.split(r"[,\s]+", data.strip()) if v]
        mats[f"{side}.{name}"] = np.asarray(vals, np.float64)
    needed = [f"{s}.{n}" for s in ("LEFT", "RIGHT") for n in "KDRP"]
    if not all(k in mats for k in needed):
        return None
    hm = re.search(r"LEFT\.height\s*:\s*(\d+)", text)
    wm = re.search(r"LEFT\.width\s*:\s*(\d+)", text)
    h = int(hm.group(1)) if hm else 480
    w = int(wm.group(1)) if wm else 752
    return (
        mats["LEFT.K"], mats["LEFT.D"], mats["LEFT.R"], mats["LEFT.P"],
        mats["RIGHT.K"], mats["RIGHT.D"], mats["RIGHT.R"], mats["RIGHT.P"],
        (h, w),
    )
