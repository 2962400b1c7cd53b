"""Dataset loaders for the reference's three benchmark formats — the
port's copy of `orb_slam2_comment_tpu/utils/datasets.py`.

Mirrors the loading logic of the reference drivers (Examples/*):
- TUM RGB-D: rgb.txt / depth.txt lists + associations file
  (Examples/RGB-D/rgbd_tum.cc LoadImages, README.md:186-200)
- TUM monocular: rgb.txt (Examples/Monocular/mono_tum.cc)
- KITTI odometry: sequences/NN/image_{0,1} + times.txt
  (Examples/Stereo/stereo_kitti.cc LoadImages)
- EuRoC ASL: mav0/cam{0,1}/data + timestamp file
  (Examples/Stereo/stereo_euroc.cc LoadImages)

The list readers, `stereo_rectify_maps` and `remap` are the JAX package's,
unchanged. Images decode through `utils/pngio` (PNG only), to the JAX
package's values where its native reader loads; `FramePrefetcher` decodes
ahead on a Python thread pool (zlib releases the GIL).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from orb_slam2_comment_tpu_torch.utils import pngio


def _png(path: str) -> str:
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG images are read")
    return path


def load_image_gray(path: str) -> np.ndarray:
    """f32 grayscale in 0..255."""
    return pngio.read_gray(_png(path))


def load_image_gray_u8(path: str) -> np.ndarray:
    """u8 grayscale — the sensor-native dtype the tracker ships to the
    device."""
    return pngio.read_gray_u8(_png(path))


def load_depth_raw(path: str) -> np.ndarray:
    """u16 raw depth samples (TUM PNGs); DepthMapFactor scaling happens
    on the device (Tracking.cc:222-231 equivalent)."""
    return pngio.read_u16(_png(path))


def load_depth(path: str, factor: float) -> np.ndarray:
    arr = load_depth_raw(path).astype(np.float32)
    return arr / factor if factor not in (0.0, 1.0) else arr


class FramePrefetcher:
    """Decode-ahead loader over a SequenceItem list: while frame i is
    handed out, up to `lookahead` later frames decode on `threads` worker
    threads. Yields dicts with native-dtype arrays (u8 gray, u16 depth)."""

    def __init__(self, items: "List[SequenceItem]", lookahead: int = 8,
                 threads: int = 4):
        self.items = items
        self.lookahead = max(int(lookahead), 0)
        self._pool = ThreadPoolExecutor(max(int(threads), 1)) if self.lookahead else None
        self._pending = {}

    def __len__(self):
        return len(self.items)

    def _decode(self, i: int):
        it = self.items[i]
        out = {"timestamp": it.timestamp, "image": load_image_gray_u8(it.image)}
        if it.image_right is not None:
            out["image_right"] = load_image_gray_u8(it.image_right)
        if it.depth is not None:
            out["depth"] = load_depth_raw(it.depth)
        return out

    def __getitem__(self, i: int):
        if self._pool is None:
            return self._decode(i)
        for j in range(i, min(i + self.lookahead + 1, len(self.items))):
            if j not in self._pending:
                self._pending[j] = self._pool.submit(self._decode, j)
        return self._pending.pop(i).result()

    def __iter__(self):
        try:
            for i in range(len(self.items)):
                yield self[i]
        finally:
            self.close()

    def close(self):
        """Drop frames decoded ahead and stop the worker threads."""
        for f in self._pending.values():
            f.cancel()
        self._pending.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


@dataclass
class SequenceItem:
    timestamp: float
    image: str
    image_right: Optional[str] = None
    depth: Optional[str] = None


def load_tum_mono(seq_dir: str) -> List[SequenceItem]:
    """TUM rgb.txt list (mono_tum.cc:LoadImages)."""
    items = []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            items.append(SequenceItem(float(ts), os.path.join(seq_dir, rel)))
    return items


def load_tum_rgbd(seq_dir: str, associations: str) -> List[SequenceItem]:
    """TUM RGB-D with an associations file: 'ts_rgb rgb ts_d depth'
    (rgbd_tum.cc:LoadImages; associations per README.md:186-200)."""
    items = []
    with open(associations) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            items.append(
                SequenceItem(
                    float(p[0]),
                    os.path.join(seq_dir, p[1]),
                    depth=os.path.join(seq_dir, p[3]),
                )
            )
    return items


def load_kitti(seq_dir: str, stereo: bool = True) -> List[SequenceItem]:
    """KITTI odometry sequence dir (stereo_kitti.cc/mono_kitti.cc
    LoadImages: times.txt + image_0/ [+ image_1/] 6-digit pngs)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(t) for t in f.read().split()]
    items = []
    for i, ts in enumerate(times):
        left = os.path.join(seq_dir, "image_0", f"{i:06d}.png")
        right = os.path.join(seq_dir, "image_1", f"{i:06d}.png") if stereo else None
        items.append(SequenceItem(ts, left, image_right=right))
    return items


def load_euroc(seq_dir: str, timestamp_file: str, stereo: bool = True
               ) -> List[SequenceItem]:
    """EuRoC ASL layout (stereo_euroc.cc/mono_euroc.cc LoadImages)."""
    items = []
    with open(timestamp_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts = line.split(",")[0].split()[0]
            name = ts + ".png"
            left = os.path.join(seq_dir, "mav0", "cam0", "data", name)
            right = (
                os.path.join(seq_dir, "mav0", "cam1", "data", name)
                if stereo else None
            )
            items.append(SequenceItem(float(ts) / 1e9, left, image_right=right))
    return items


def stereo_rectify_maps(K1, D1, R1, P1, K2, D2, R2, P2, hw):
    """Precompute undistort+rectify sampling grids for EuRoC online
    rectification (stereo_euroc.cc:63-98 initUndistortRectifyMap usage).

    Returns two (map_x, map_y) float32 grids; apply with remap()."""
    h, w = hw
    maps = []
    for K_, D_, R_, P_ in ((K1, D1, R1, P1), (K2, D2, R2, P2)):
        K_ = np.asarray(K_, np.float64).reshape(3, 3)
        D_ = np.asarray(D_, np.float64).reshape(-1)
        R_ = np.asarray(R_, np.float64).reshape(3, 3)
        P_ = np.asarray(P_, np.float64).reshape(3, 4)[:, :3]
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        ones = np.ones_like(xs)
        pix = np.stack([xs, ys, ones], axis=-1) @ np.linalg.inv(P_).T
        rays = pix @ np.linalg.inv(R_).T
        x = rays[..., 0] / rays[..., 2]
        y = rays[..., 1] / rays[..., 2]
        # apply distortion of the source camera
        k1, k2, p1, p2 = D_[0], D_[1], D_[2], D_[3]
        k3 = D_[4] if len(D_) > 4 else 0.0
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        map_x = (K_[0, 0] * xd + K_[0, 2]).astype(np.float32)
        map_y = (K_[1, 1] * yd + K_[1, 2]).astype(np.float32)
        maps.append((map_x, map_y))
    return maps


def remap(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Bilinear resampling of image at (map_x, map_y) — cv::remap."""
    h, w = image.shape
    x0 = np.clip(np.floor(map_x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(map_y).astype(np.int64), 0, h - 2)
    fx = np.clip(map_x - x0, 0.0, 1.0)
    fy = np.clip(map_y - y0, 0.0, 1.0)
    v00 = image[y0, x0]
    v01 = image[y0, x0 + 1]
    v10 = image[y0 + 1, x0]
    v11 = image[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    ).astype(np.float32)
