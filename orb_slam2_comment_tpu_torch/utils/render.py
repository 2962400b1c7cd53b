"""Textured-scene rasterizer + on-disk dataset writers.

Round-1 validation ran only on the marker renderer (utils/synthetic.py);
this module provides the "photorealistic-texture" tier: closed scenes
built from finite textured quads (room walls / street canyon / furniture
boxes), ray-cast with a z-buffer so every pixel has texture detail (FAST
finds corners everywhere, like on real imagery) and an exact depth value.

Sequences are written to disk in the reference's dataset layouts so the
C++ reference binaries (Examples/RGB-D/rgbd_tum.cc, Examples/Stereo/
stereo_kitti.cc, Examples/Monocular/mono_tum.cc) and this framework's
drivers consume IDENTICAL inputs:

- TUM RGB-D: rgb/ + depth/ (16-bit PNG, factor 5000) + rgb.txt/depth.txt/
  associations.txt/groundtruth.txt  (rgbd_tum.cc:LoadImages,
  the reference's README.md:186-200)
- KITTI odometry: sequences/NN/image_{0,1}/ + times.txt
  (stereo_kitti.cc:LoadImages)

Host-side numpy only — the port's copy of
`orb_slam2_comment_tpu/utils/render.py`, the same but for the two PNG
writers, which go through `utils/pngio` (no cv2 or PIL).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from orb_slam2_comment_tpu_torch.utils import pngio


# ---------------------------------------------------------------------------
# Procedural textures
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
    """High-contrast textured surface, uint8 [size, size].

    Mixes low-frequency noise (shading) with dense high-frequency detail:
    random dark/light rectangles ("posters", "bricks") and speckle, so the
    FAST detector finds strong corners at every scale level, approximating
    a cluttered indoor wall or a building facade.
    """
    rng = np.random.default_rng(seed)
    base = 90.0 + 110.0 * _value_noise(rng, size, octaves=5)
    img = base.copy()
    # rectangles: high-contrast blocks with sharp edges (corner factories)
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
        # inner frame for double corners
        if wv > 16 and hv > 16 and rng.random() < 0.5:
            m = int(rng.integers(3, min(wv, hv) // 3))
            lvl2 = float(rng.uniform(15, 240))
            img[y0 + m:y0 + hv - m, x0 + m:x0 + wv - m] = lvl2
    # speckle: small bright/dark dots
    n_dot = size * size // 900
    ys = rng.integers(1, size - 2, n_dot)
    xs = rng.integers(1, size - 2, n_dot)
    lv = rng.uniform(0, 255, n_dot).astype(np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[ys + dy, xs + dx] = lv
    return np.clip(img, 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# Scene: a list of finite textured quads
# ---------------------------------------------------------------------------

@dataclass
class Quad:
    """Finite textured rectangle: origin corner + two edge vectors."""
    origin: np.ndarray   # [3] world corner
    eu: np.ndarray       # [3] edge vector along texture u (full extent)
    ev: np.ndarray       # [3] edge vector along texture v (full extent)
    tex: np.ndarray      # [S, S] float32 0..255


@dataclass
class QuadScene:
    quads: List[Quad]
    background: float = 40.0


def _quad(o, eu, ev, tex) -> Quad:
    return Quad(np.asarray(o, np.float64), np.asarray(eu, np.float64),
                np.asarray(ev, np.float64), tex)


def make_room(seed: int = 0, size=(8.0, 3.0, 8.0), n_boxes: int = 5,
              tex_size: int = 768) -> QuadScene:
    """Closed box room (camera convention: x right, y DOWN, z forward).

    Floor at y=+sy/2, ceiling at y=-sy/2, four walls; n_boxes textured
    boxes standing on the floor as mid-range structure (parallax).
    """
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    t = lambda st: make_texture(int(rng.integers(1 << 31)), tex_size, st)
    quads = [
        # floor (y=+hy), viewed from above
        _quad([-hx, hy, -hz], [sx, 0, 0], [0, 0, sz], t("floor")),
        # ceiling (y=-hy)
        _quad([-hx, -hy, -hz], [sx, 0, 0], [0, 0, sz], t("floor")),
        # wall z=+hz (front)
        _quad([-hx, -hy, hz], [sx, 0, 0], [0, sy, 0], t("wall")),
        # wall z=-hz (back)
        _quad([-hx, -hy, -hz], [sx, 0, 0], [0, sy, 0], t("wall")),
        # wall x=+hx (right)
        _quad([hx, -hy, -hz], [0, 0, sz], [0, sy, 0], t("wall")),
        # wall x=-hx (left)
        _quad([-hx, -hy, -hz], [0, 0, sz], [0, sy, 0], t("wall")),
    ]
    for _ in range(n_boxes):
        bw = rng.uniform(0.5, 1.2)
        bd = rng.uniform(0.5, 1.2)
        bh = rng.uniform(0.8, 2.0)
        bx = rng.uniform(-hx + 1.2, hx - 1.2)
        bz = rng.uniform(-hz + 1.2, hz - 1.2)
        # keep the camera path clear: the loop trajectory stays within
        # ~1.5m of room center, boxes reach 0.6m from their center
        clear = 2.4
        if abs(bx) < clear and abs(bz) < clear:
            s = 1.0 if bx >= 0 else -1.0
            bx = s * rng.uniform(clear, max(hx - 1.2, clear + 0.1))
        y0, y1 = hy - bh, hy  # standing on the floor
        tex = t("wall")
        quads += [
            _quad([bx - bw / 2, y0, bz - bd / 2], [bw, 0, 0], [0, bh, 0], tex),
            _quad([bx - bw / 2, y0, bz + bd / 2], [bw, 0, 0], [0, bh, 0], tex),
            _quad([bx - bw / 2, y0, bz - bd / 2], [0, 0, bd], [0, bh, 0], tex),
            _quad([bx + bw / 2, y0, bz - bd / 2], [0, 0, bd], [0, bh, 0], tex),
            _quad([bx - bw / 2, y0, bz - bd / 2], [bw, 0, 0], [0, 0, bd], tex),
        ]
    return QuadScene(quads)


def make_street(seed: int = 0, length: float = 120.0, width: float = 12.0,
                height: float = 6.0, tex_size: int = 1024) -> QuadScene:
    """Street canyon for KITTI-style forward motion: ground plane + two
    long facades split into per-building segments, camera driving +z."""
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
            quads.append(_quad([x, -height + 1.6, z0], [0, 0, seg],
                               [0, height, 0], tex))
            z0 += seg
    return QuadScene(quads)


# ---------------------------------------------------------------------------
# Ray-cast rendering with z-buffer
# ---------------------------------------------------------------------------

def render_quads(scene: QuadScene, Tcw: np.ndarray, K, hw=(480, 640),
                 baseline: float = 0.0, noise: float = 1.0, seed: int = 0,
                 supersample: int = 2,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Render gray [H,W] f32 + z-depth [H,W] f32 (0 where no surface).

    Per-quad analytic ray/plane intersection over the full pixel grid with
    a z-buffer; texture sampled bilinearly; optional supersampling for
    anti-aliased edges (real camera MTF), then sensor noise.
    """
    h, w = hw
    fx, fy, cx, cy = [float(v) for v in K]
    ss = max(1, int(supersample))
    H, W = h * ss, w * ss
    R = Tcw[:3, :3].astype(np.float64)
    t = Tcw[:3, 3].astype(np.float64)
    # camera center in world: c = -R^T t; right camera shifts +x_cam
    cam_t = t.copy()
    if baseline != 0.0:
        cam_t = cam_t - np.array([baseline, 0.0, 0.0])

    ys = (np.arange(H, dtype=np.float64)[:, None] / ss - cy + 0.5 / ss - 0.5) / fy
    xs = (np.arange(W, dtype=np.float64)[None, :] / ss - cx + 0.5 / ss - 0.5) / fx
    # ray directions in camera frame (z=1), constant per pixel
    dx = np.broadcast_to(xs, (H, W))
    dy = np.broadcast_to(ys, (H, W))

    img = np.full((H, W), scene.background, np.float32)
    zbuf = np.full((H, W), np.inf, np.float64)

    # front-to-back: nearer quads fill the z-buffer first so farther ones
    # fail the depth test before any texture math
    def _min_z(q):
        cs = np.stack([q.origin, q.origin + q.eu, q.origin + q.ev,
                       q.origin + q.eu + q.ev]) @ R.T + cam_t
        return float(np.abs(cs[:, 2]).min())

    for q in sorted(scene.quads, key=_min_z):
        # quad in camera frame
        oc = R @ q.origin + cam_t
        euc = R @ q.eu
        evc = R @ q.ev
        # projected-bbox clip: if all 4 corners are in front, only the
        # subrect covering their projection can be hit (boxes are tiny on
        # screen; this is the dominant speed win). Any corner at/behind
        # the camera -> fall back to the full grid.
        corners = np.stack([oc, oc + euc, oc + evc, oc + euc + evc])
        y0g, y1g, x0g, x1g = 0, H, 0, W
        if (corners[:, 2] > 0.05).all():
            us = (corners[:, 0] / corners[:, 2] * fx + cx + 0.5) * ss
            vs = (corners[:, 1] / corners[:, 2] * fy + cy + 0.5) * ss
            x0g = max(0, int(np.floor(us.min())) - 2)
            x1g = min(W, int(np.ceil(us.max())) + 2)
            y0g = max(0, int(np.floor(vs.min())) - 2)
            y1g = min(H, int(np.ceil(vs.max())) + 2)
            if x0g >= x1g or y0g >= y1g:
                continue
        sub = np.s_[y0g:y1g, x0g:x1g]
        dxs, dys = dx[sub], dy[sub]
        n = np.cross(euc, evc)
        # ray d = (dx, dy, 1); t_hit = dot(oc, n) / dot(d, n)
        dn = dxs * n[0] + dys * n[1] + n[2]
        on = float(oc @ n)
        with np.errstate(divide="ignore", invalid="ignore"):
            th = on / dn
        zs = th  # camera z of hit = th * d_z = th
        hit = (zs > 0.05) & (zs < zbuf[sub]) & np.isfinite(zs)
        if not hit.any():
            continue
        # gather candidate pixels once; all texture math runs 1-D
        iy, ix = np.nonzero(hit)
        thg = th[iy, ix]
        px = thg * dxs[iy, ix] - oc[0]
        py = thg * dys[iy, ix] - oc[1]
        pz = thg - oc[2]
        # solve [eu ev] coords via Gram inverse (2x2)
        a = float(euc @ euc)
        b = float(euc @ evc)
        c = float(evc @ evc)
        det = a * c - b * b
        pu = px * euc[0] + py * euc[1] + pz * euc[2]
        pv = px * evc[0] + py * evc[1] + pz * evc[2]
        uu = (c * pu - b * pv) / det
        vv = (a * pv - b * pu) / det
        inq = (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1)
        if not inq.any():
            continue
        iy, ix = iy[inq], ix[inq]
        S = q.tex.shape[0]
        tu = np.clip(uu[inq] * S - 0.5, 0, S - 1.001)
        tv = np.clip(vv[inq] * S - 0.5, 0, S - 1.001)
        i0 = tu.astype(np.int64)
        j0 = tv.astype(np.int64)
        fu = (tu - i0).astype(np.float32)
        fv = (tv - j0).astype(np.float32)
        tex = q.tex
        val = (tex[j0, i0] * (1 - fu) * (1 - fv)
               + tex[j0, i0 + 1] * fu * (1 - fv)
               + tex[j0 + 1, i0] * (1 - fu) * fv
               + tex[j0 + 1, i0 + 1] * fu * fv)
        img[y0g + iy, x0g + ix] = val
        zbuf[y0g + iy, x0g + ix] = thg[inq]

    if ss > 1:
        img = img.reshape(h, ss, w, ss).mean(axis=(1, 3))
        # depth: center sample (averaging depth across edges is wrong)
        zbuf = zbuf[ss // 2::ss, ss // 2::ss]
    dep = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32), dep


# ---------------------------------------------------------------------------
# Trajectories (world->camera 4x4; x right, y down, z forward)
# ---------------------------------------------------------------------------

def _look(pos: np.ndarray, fwd: np.ndarray) -> np.ndarray:
    z = fwd / np.linalg.norm(fwd)
    x = np.cross([0.0, 1.0, 0.0], z)
    nx = np.linalg.norm(x)
    if nx < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / nx
    y = np.cross(z, x)
    Rwc = np.stack([x, y, z], axis=1)
    Tcw = np.eye(4)
    Tcw[:3, :3] = Rwc.T
    Tcw[:3, 3] = -Rwc.T @ pos
    return Tcw


def room_loop_trajectory(n_frames: int, radius: float = 1.3,
                         loops: float = 1.08, seed: int = 0,
                         bob: float = 0.02) -> np.ndarray:
    """Circular path inside the room looking outward-tangent; >1 loop so
    the start is revisited (loop closure). Returns [N,4,4] f64 Tcw."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * loops * i / n_frames
        pos = np.array([radius * np.sin(th),
                        0.2 + bob * np.sin(7 * th + 1.0),
                        -radius * np.cos(th)])
        # look tangentially (direction of travel) blended with outward
        tang = np.array([np.cos(th), 0.0, np.sin(th)])
        outw = np.array([np.sin(th), 0.0, -np.cos(th)])
        fwd = tang + 0.8 * outw
        fwd = fwd + rng.normal(0, 0.002, 3)
        poses.append(_look(pos, fwd))
    return np.stack(poses)


def desk_trajectory(n_frames: int, seed: int = 0, step: float = 0.012
                    ) -> np.ndarray:
    """Smooth hand-held wander near the room center looking at the front
    wall (TUM fr1-like). Smoothed random-walk velocity (handheld inertia)."""
    rng = np.random.default_rng(seed)
    poses = []
    pos = np.array([0.0, 0.15, 0.0])
    vel = np.zeros(3)
    yaw, yaw_v = 0.0, 0.0
    for _ in range(n_frames):
        vel = 0.92 * vel + rng.normal(0, step, 3) * [1.0, 0.35, 1.0]
        pos = pos + vel
        pos = np.clip(pos, [-1.8, -0.3, -1.8], [1.8, 0.6, 1.8])
        yaw_v = 0.9 * yaw_v + rng.normal(0, 0.0035)
        yaw += yaw_v
        fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        poses.append(_look(pos, fwd))
    return np.stack(poses)


def street_trajectory(n_frames: int, length: float = 100.0, seed: int = 0
                      ) -> np.ndarray:
    """Forward drive down the street with gentle lateral sway and yaw."""
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


# ---------------------------------------------------------------------------
# Disk writers (reference-consumable layouts)
# ---------------------------------------------------------------------------

def _write_png_gray8(path: str, img: np.ndarray) -> None:
    pngio.write(path, np.clip(img, 0, 255).astype(np.uint8))


def _write_png_gray16(path: str, img: np.ndarray) -> None:
    pngio.write(path, np.clip(img, 0, 65535).astype(np.uint16))


def _tum_pose_line(ts: float, Tcw: np.ndarray) -> str:
    """groundtruth.txt line: ts tx ty tz qx qy qz qw of Twc (camera in
    world), TUM convention (System.cc:322-377 output format)."""
    Rcw = Tcw[:3, :3]
    tcw = Tcw[:3, 3]
    Rwc = Rcw.T
    twc = -Rwc @ tcw
    # rotation matrix -> quaternion (w last)
    m = Rwc
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        qw = (m[k, j] - m[j, k]) / s
        qx, qy, qz = q
    return (f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}")


DEPTH_FACTOR_TUM = 5000.0  # TUM PNG depth scale (README.md:186-200)


def _render_tum_frame(args):
    scene, Tcw, K, hw, noise, ss, out_dir, i, fps = args
    ts = i / fps
    img, dep = render_quads(scene, Tcw, K, hw, noise=noise,
                            seed=1000 + i, supersample=ss)
    _write_png_gray8(os.path.join(out_dir, f"rgb/{ts:.6f}.png"), img)
    _write_png_gray16(os.path.join(out_dir, f"depth/{ts:.6f}.png"),
                      dep * DEPTH_FACTOR_TUM)
    return i


def _render_kitti_frame(args):
    scene, Tcw, K, hw, noise, ss, out_dir, i, baseline = args
    imgL, _ = render_quads(scene, Tcw, K, hw, noise=noise, seed=1000 + i,
                           supersample=ss)
    imgR, _ = render_quads(scene, Tcw, K, hw, baseline=baseline,
                           noise=noise, seed=5000 + i, supersample=ss)
    _write_png_gray8(os.path.join(out_dir, "image_0", f"{i:06d}.png"), imgL)
    _write_png_gray8(os.path.join(out_dir, "image_1", f"{i:06d}.png"), imgR)
    return i


def _pmap(fn, jobs, workers: int, progress: bool, tag: str):
    workers = min(workers, os.cpu_count() or 1)
    if workers <= 1:
        for j, job in enumerate(jobs):
            fn(job)
            if progress and j % 50 == 0:
                print(f"  {tag} frame {j}/{len(jobs)}", flush=True)
        return
    import concurrent.futures as cf

    with cf.ProcessPoolExecutor(max_workers=workers) as ex:
        for k, _ in enumerate(ex.map(fn, jobs, chunksize=4)):
            if progress and k % 50 == 0:
                print(f"  {tag} frame {k}/{len(jobs)}", flush=True)


def write_tum_rgbd(out_dir: str, scene: QuadScene, poses: np.ndarray, K,
                   hw=(480, 640), fps: float = 30.0, noise: float = 1.5,
                   supersample: int = 2, progress: bool = False,
                   workers: int = 8) -> None:
    """Render + write a TUM RGB-D sequence consumable by BOTH the
    reference rgbd_tum binary and examples/rgbd_tum.py."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    jobs = [(scene, Tcw, K, hw, noise, supersample, out_dir, i, fps)
            for i, Tcw in enumerate(poses)]
    _pmap(_render_tum_frame, jobs, workers, progress, "tum")
    rgb_lines, dep_lines, asc_lines, gt_lines = [], [], [], []
    for i, Tcw in enumerate(poses):
        ts = i / fps
        rname = f"rgb/{ts:.6f}.png"
        dname = f"depth/{ts:.6f}.png"
        rgb_lines.append(f"{ts:.6f} {rname}")
        dep_lines.append(f"{ts:.6f} {dname}")
        asc_lines.append(f"{ts:.6f} {rname} {ts:.6f} {dname}")
        gt_lines.append(_tum_pose_line(ts, Tcw))
    hdr = "# synthetic textured sequence\n# ts filename\n"
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write(hdr + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write(hdr + "\n".join(dep_lines) + "\n")
    with open(os.path.join(out_dir, "associations.txt"), "w") as f:
        f.write("\n".join(asc_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")


def write_kitti_stereo(out_dir: str, scene: QuadScene, poses: np.ndarray, K,
                       baseline: float, hw=(376, 1241), fps: float = 10.0,
                       noise: float = 1.5, supersample: int = 2,
                       progress: bool = False, workers: int = 8) -> None:
    """KITTI odometry layout: image_0/, image_1/, times.txt + poses_gt.txt
    (Twc 3x4 row-major, the KITTI ground-truth format)."""
    os.makedirs(os.path.join(out_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_1"), exist_ok=True)
    jobs = [(scene, Tcw, K, hw, noise, supersample, out_dir, i, baseline)
            for i, Tcw in enumerate(poses)]
    _pmap(_render_kitti_frame, jobs, workers, progress, "kitti")
    times, gt_lines = [], []
    for i, Tcw in enumerate(poses):
        ts = i / fps
        times.append(f"{ts:.6e}")
        Rwc = Tcw[:3, :3].T
        twc = -Rwc @ Tcw[:3, 3]
        M = np.concatenate([Rwc, twc[:, None]], axis=1)
        gt_lines.append(" ".join(f"{v:.9e}" for v in M.reshape(-1)))
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(out_dir, "poses_gt.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")


def write_settings_yaml(path: str, K, hw, fps: float, bf: float = 0.0,
                        depth_factor: float = 0.0, n_features: int = 1000,
                        th_depth: float = 40.0, rgb: int = 1) -> None:
    """Reference-compatible cv::FileStorage YAML (Tracking.cc:46-148 keys)."""
    fx, fy, cx, cy = [float(v) for v in K]
    lines = [
        "%YAML:1.0", "",
        f"Camera.fx: {fx}", f"Camera.fy: {fy}",
        f"Camera.cx: {cx}", f"Camera.cy: {cy}",
        "Camera.k1: 0.0", "Camera.k2: 0.0",
        "Camera.p1: 0.0", "Camera.p2: 0.0", "Camera.k3: 0.0",
        f"Camera.width: {hw[1]}", f"Camera.height: {hw[0]}",
        f"Camera.fps: {float(fps)}",
        f"Camera.bf: {float(bf)}",
        f"Camera.RGB: {rgb}",
        f"ThDepth: {float(th_depth)}",
    ]
    if depth_factor:
        lines.append(f"DepthMapFactor: {float(depth_factor)}")
    lines += [
        "", f"ORBextractor.nFeatures: {n_features}",
        "ORBextractor.scaleFactor: 1.2",
        "ORBextractor.nLevels: 8",
        "ORBextractor.iniThFAST: 20",
        "ORBextractor.minThFAST: 7",
        # extension key, ignored by the reference's cv::FileStorage reads:
        # this framework's generated (non-learned) rBRIEF pattern needs a
        # wider Hamming gate than the reference's TH_LOW/TH_HIGH=50/100 —
        # measured on desk: ATE 29cm at 1.0 vs mm-class at 1.5
        # (BENCH_ACCURACY.md)
        "Matcher.thScale: 1.5",
        "", "Viewer.KeyFrameSize: 0.05",
        "Viewer.KeyFrameLineWidth: 1", "Viewer.GraphLineWidth: 0.9",
        "Viewer.PointSize: 2", "Viewer.CameraSize: 0.08",
        "Viewer.CameraLineWidth: 3", "Viewer.ViewpointX: 0",
        "Viewer.ViewpointY: -0.7", "Viewer.ViewpointZ: -1.8",
        "Viewer.ViewpointF: 500",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
