"""Scenes and camera trajectories that the benchmark renders its frames from.

A frozen copy of the port's synthetic generator (`utils/render.py`: the
procedural textures, the textured-quad scenes `make_room` and
`make_street`, and the trajectories `room_loop_trajectory` and
`street_trajectory`), kept here so that the yardstick does not move when
the program does, plus one scene and one trajectory of the benchmark's
own: `make_hall` and `hall_walk`, a long corridor walked forward once.

Host numpy only; `render.py` ray-casts these scenes on the card. The
ground truth of every cell is the trajectory made here, never anything
the program computes. Camera convention: x right, y down, z forward;
poses are world->camera 4x4 (`Tcw`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


# ---------------------------------------------------------------------------
# procedural textures (copied from the port's utils/render.py)
# ---------------------------------------------------------------------------

def _value_noise(rng: np.random.Generator, size: int, octaves: int = 5,
                 persistence: float = 0.55) -> np.ndarray:
    """Multi-octave bilinear value noise in [0, 1], size x size."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        n = max(2, 2 ** (o + 2))
        if n > size:
            break
        grid = rng.random((n + 1, n + 1)).astype(np.float32)
        xs = np.linspace(0, n, size, endpoint=False)
        i0 = xs.astype(np.int64)
        f = (xs - i0).astype(np.float32)
        f = f * f * (3 - 2 * f)  # smoothstep
        g = grid[i0][:, i0]
        gx = grid[i0 + 1][:, i0]
        gy = grid[i0][:, i0 + 1]
        gxy = grid[i0 + 1][:, i0 + 1]
        layer = (g * (1 - f)[:, None] + gx * f[:, None]) * (1 - f)[None, :] + (
            gy * (1 - f)[:, None] + gxy * f[:, None]) * f[None, :]
        out += amp * layer
        total += amp
        amp *= persistence
    return out / max(total, 1e-9)


def make_texture(seed: int, size: int = 768, style: str = "wall") -> np.ndarray:
    """High-contrast textured surface [size, size] f32 in 0..255: low
    frequency shading, sharp-edged rectangles and speckle, so FAST finds
    corners at every pyramid level."""
    rng = np.random.default_rng(seed)
    base = 90.0 + 110.0 * _value_noise(rng, size, octaves=5)
    img = base.copy()
    n_rect = {"wall": 160, "floor": 90, "facade": 220}.get(style, 150)
    for _ in range(n_rect):
        wv = int(rng.integers(6, size // 6))
        hv = int(rng.integers(6, size // 6))
        x0 = int(rng.integers(0, size - wv))
        y0 = int(rng.integers(0, size - hv))
        lvl = float(rng.uniform(15, 240))
        alpha = float(rng.uniform(0.55, 1.0))
        img[y0:y0 + hv, x0:x0 + wv] = (
            (1 - alpha) * img[y0:y0 + hv, x0:x0 + wv] + alpha * lvl)
        if wv > 16 and hv > 16 and rng.random() < 0.5:
            m = int(rng.integers(3, min(wv, hv) // 3))
            lvl2 = float(rng.uniform(15, 240))
            img[y0 + m:y0 + hv - m, x0 + m:x0 + wv - m] = lvl2
    n_dot = size * size // 900
    ys = rng.integers(1, size - 2, n_dot)
    xs = rng.integers(1, size - 2, n_dot)
    lv = rng.uniform(0, 255, n_dot).astype(np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[ys + dy, xs + dx] = lv
    return np.clip(img, 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# scenes: lists of finite textured quads
# ---------------------------------------------------------------------------

@dataclass
class Quad:
    """Finite textured rectangle: origin corner + two edge vectors."""
    origin: np.ndarray   # [3] world corner
    eu: np.ndarray       # [3] edge along texture u (full extent)
    ev: np.ndarray       # [3] edge along texture v (full extent)
    tex: np.ndarray      # [S, S] float32 0..255


@dataclass
class QuadScene:
    quads: List[Quad]
    background: float = 40.0


def _quad(o, eu, ev, tex) -> Quad:
    return Quad(np.asarray(o, np.float64), np.asarray(eu, np.float64),
                np.asarray(ev, np.float64), tex)


def _box(quads, bx, bz, bw, bd, bh, floor_y, tex):
    """Four sides and the top of a box standing on the floor."""
    y0 = floor_y - bh
    quads += [
        _quad([bx - bw / 2, y0, bz - bd / 2], [bw, 0, 0], [0, bh, 0], tex),
        _quad([bx - bw / 2, y0, bz + bd / 2], [bw, 0, 0], [0, bh, 0], tex),
        _quad([bx - bw / 2, y0, bz - bd / 2], [0, 0, bd], [0, bh, 0], tex),
        _quad([bx + bw / 2, y0, bz - bd / 2], [0, 0, bd], [0, bh, 0], tex),
        _quad([bx - bw / 2, y0, bz - bd / 2], [bw, 0, 0], [0, 0, bd], tex),
    ]


def make_room(seed: int = 0, size=(8.0, 3.0, 8.0), n_boxes: int = 5,
              tex_size: int = 768) -> QuadScene:
    """Closed box room: floor, ceiling, four walls and n_boxes textured
    boxes on the floor, kept clear of a 2.4 m square round the centre
    (copied from the port's utils/render.make_room)."""
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    t = lambda st: make_texture(int(rng.integers(1 << 31)), tex_size, st)
    quads = [
        _quad([-hx, hy, -hz], [sx, 0, 0], [0, 0, sz], t("floor")),
        _quad([-hx, -hy, -hz], [sx, 0, 0], [0, 0, sz], t("floor")),
        _quad([-hx, -hy, hz], [sx, 0, 0], [0, sy, 0], t("wall")),
        _quad([-hx, -hy, -hz], [sx, 0, 0], [0, sy, 0], t("wall")),
        _quad([hx, -hy, -hz], [0, 0, sz], [0, sy, 0], t("wall")),
        _quad([-hx, -hy, -hz], [0, 0, sz], [0, sy, 0], t("wall")),
    ]
    for _ in range(n_boxes):
        bw = rng.uniform(0.5, 1.2)
        bd = rng.uniform(0.5, 1.2)
        bh = rng.uniform(0.8, 2.0)
        bx = rng.uniform(-hx + 1.2, hx - 1.2)
        bz = rng.uniform(-hz + 1.2, hz - 1.2)
        clear = 2.4
        if abs(bx) < clear and abs(bz) < clear:
            s = 1.0 if bx >= 0 else -1.0
            bx = s * rng.uniform(clear, max(hx - 1.2, clear + 0.1))
        _box(quads, bx, bz, bw, bd, bh, hy, t("wall"))
    return QuadScene(quads)


def make_hall(seed: int = 0, length: float = 30.0, width: float = 4.0,
              height: float = 3.0, segment=(3.0, 6.0), box_every: float = 3.0,
              tex_size: int = 768) -> QuadScene:
    """A long corridor along +z from z = -2 to z = length: floor, ceiling
    and both walls in segments of their own texture (walls set back by up
    to 0.3 m, so segment ends make corners in depth), two end walls, and
    a box against a wall about every `box_every` metres, alternating
    sides, leaving |x| < 0.9 m clear for the camera."""
    rng = np.random.default_rng(seed)
    hx, hy = width / 2, height / 2
    t = lambda st: make_texture(int(rng.integers(1 << 31)), tex_size, st)
    z_lo = -2.0
    quads = [
        _quad([-hx - 0.3, -hy, z_lo], [width + 0.6, 0, 0], [0, height, 0], t("wall")),
        _quad([-hx - 0.3, -hy, length], [width + 0.6, 0, 0], [0, height, 0], t("wall")),
    ]
    for y, st in ((hy, "floor"), (-hy, "floor")):
        z0 = z_lo
        while z0 < length:
            seg = min(rng.uniform(*segment), length - z0)
            quads.append(_quad([-hx - 0.3, y, z0], [width + 0.6, 0, 0], [0, 0, seg], t(st)))
            z0 += seg
    for side in (-1, 1):
        z0 = z_lo
        while z0 < length:
            seg = min(rng.uniform(*segment), length - z0)
            x = side * (hx + rng.uniform(0.0, 0.3))
            quads.append(_quad([x, -hy, z0], [0, 0, seg], [0, height, 0], t("wall")))
            z0 += seg
    z, side = z_lo + 1.5, -1
    while z < length - 1.0:
        bw = rng.uniform(0.4, 1.0)
        bd = rng.uniform(0.5, 1.2)
        bh = rng.uniform(0.5, 1.8)
        bx = side * (hx - bw / 2 - 0.05)
        _box(quads, bx, z + rng.uniform(-0.5, 0.5), bw, bd, bh, hy, t("wall"))
        z += box_every * rng.uniform(0.7, 1.3)
        side = -side
    return QuadScene(quads)


def make_street(seed: int = 0, length: float = 120.0, width: float = 12.0,
                height: float = 6.0, tex_size: int = 1024) -> QuadScene:
    """Street canyon for KITTI-style forward motion: ground plane and two
    facades split into per-building segments, camera driving +z (copied
    from the port's utils/render.make_street)."""
    rng = np.random.default_rng(seed)
    hw = width / 2
    quads = [
        _quad([-hw, 1.6, -5.0], [width, 0, 0], [0, 0, length + 10],
              make_texture(int(rng.integers(1 << 31)), tex_size, "floor")),
    ]
    for side in (-1, 1):
        z0 = -5.0
        while z0 < length + 5.0:
            seg = rng.uniform(8.0, 20.0)
            tex = make_texture(int(rng.integers(1 << 31)), tex_size, "facade")
            inset = rng.uniform(0.0, 1.5)
            x = side * (hw - inset)
            quads.append(_quad([x, -height + 1.6, z0], [0, 0, seg], [0, height, 0], tex))
            z0 += seg
    return QuadScene(quads)


# ---------------------------------------------------------------------------
# trajectories: [N, 4, 4] float64 Tcw
# ---------------------------------------------------------------------------

def _look(pos: np.ndarray, fwd: np.ndarray) -> np.ndarray:
    z = fwd / np.linalg.norm(fwd)
    x = np.cross([0.0, 1.0, 0.0], z)
    nx = np.linalg.norm(x)
    x = np.array([1.0, 0.0, 0.0]) if nx < 1e-6 else x / nx
    y = np.cross(z, x)
    Rwc = np.stack([x, y, z], axis=1)
    Tcw = np.eye(4)
    Tcw[:3, :3] = Rwc.T
    Tcw[:3, 3] = -Rwc.T @ pos
    return Tcw


def room_loop_trajectory(n_frames: int, radius: float = 1.3, loops: float = 1.08,
                         seed: int = 0, bob: float = 0.02, phase: float = 0.0) -> np.ndarray:
    """Circular path inside the room looking between the direction of
    travel and outward; more than one loop, so the start is revisited
    (copied from the port's utils/render.room_loop_trajectory, with a
    start angle `phase` added)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        th = phase + 2 * np.pi * loops * i / n_frames
        pos = np.array([radius * np.sin(th), 0.2 + bob * np.sin(7 * th + 1.0),
                        -radius * np.cos(th)])
        tang = np.array([np.cos(th), 0.0, np.sin(th)])
        outw = np.array([np.sin(th), 0.0, -np.cos(th)])
        fwd = tang + 0.8 * outw + rng.normal(0, 0.002, 3)
        poses.append(_look(pos, fwd))
    return np.stack(poses)


def street_trajectory(n_frames: int, length: float = 100.0, seed: int = 0) -> np.ndarray:
    """Forward drive down the street with gentle lateral sway and yaw
    (copied from the port's utils/render.street_trajectory)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        s = length * i / max(n_frames - 1, 1)
        sway = 0.8 * np.sin(s * 0.06) + 0.2 * np.sin(s * 0.023 + 1.0)
        pos = np.array([sway, 0.0, s])
        yaw = 0.05 * np.cos(s * 0.06) + rng.normal(0, 0.001)
        fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        poses.append(_look(pos, fwd))
    return np.stack(poses)


def hall_walk(n_frames: int, step: float = 0.012, yaw_amp: float = 0.5,
              yaw_freq: float = 2.0, seed: int = 0) -> np.ndarray:
    """Walking forward down the hall at `step` metres a frame from z = 0,
    swaying up to 0.35 m sideways and sweeping the view up to `yaw_amp`
    radians to either side, `yaw_freq` radians of phase per metre walked,
    with hand-held jitter; never back."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 3)
    poses = []
    for i in range(n_frames):
        s = step * i
        pos = np.array([0.35 * np.sin(0.45 * s + ph[0]),
                        0.1 + 0.03 * np.sin(2.1 * s + ph[1]), s])
        yaw = yaw_amp * np.sin(yaw_freq * s + ph[2]) + rng.normal(0, 0.002)
        pitch = 0.08 * np.sin(0.9 * s + ph[1]) + rng.normal(0, 0.002)
        fwd = np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch), np.cos(yaw) * np.cos(pitch)])
        poses.append(_look(pos, fwd))
    return np.stack(poses)


SCENES = {"room": make_room, "hall": make_hall, "street": make_street}
TRAJECTORIES = {"room_loop": room_loop_trajectory, "street": street_trajectory,
                "hall_walk": hall_walk}
