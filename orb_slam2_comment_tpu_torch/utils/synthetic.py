"""Synthetic scene rendering with exact ground truth.

A cloud of 3D landmarks rendered as small high-contrast squares
(FAST-detectable corners) over a textured background, with exact
ground-truth poses, depths, and stereo pairs.

Host-side numpy. The port's own copy of the JAX package's
`utils/synthetic.py`; tests/test_torch_system.py holds the two to
array-equal frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


_MAX_HALF = 7


@dataclass
class SyntheticScene:
    """A box of landmark 'markers': world-anchored textured 3D squares.

    Each marker is a true planar patch in 3D (center + orthonormal frame +
    metric half-size), rendered with perspective-correct texture warp and
    per-pixel exact depth. This matters: camera-facing billboards with
    constant patch depth make FAST corners geometrically INCONSISTENT
    landmarks across large viewpoint changes (the corner's effective 3D
    position swings around the marker center as the camera moves), which
    breaks orbit/loop trajectories no SLAM tuning can fix.

    Each marker stamps its own random texture so binary descriptors are
    discriminative across landmarks (uniform squares would collide)."""

    points: np.ndarray       # [M, 3] world centers
    e1: np.ndarray           # [M, 3] in-plane axis 1 (unit)
    e2: np.ndarray           # [M, 3] in-plane axis 2 (unit)
    normal: np.ndarray       # [M, 3] plane normal (unit)
    half_m: np.ndarray       # [M] metric half-size of the square
    texture: np.ndarray      # [M, S, S] pixel values
    background: float = 128.0


def make_scene(
    n_points: int = 1200,
    extent=(12.0, 8.0, 18.0),
    z_near: float = 2.0,
    seed: int = 0,
    planar_frac: float = 0.0,
) -> SyntheticScene:
    r = np.random.default_rng(seed)
    pts = np.stack(
        [
            r.uniform(-extent[0], extent[0], n_points),
            r.uniform(-extent[1], extent[1], n_points),
            r.uniform(z_near, z_near + extent[2], n_points),
        ],
        axis=1,
    ).astype(np.float32)
    if planar_frac > 0.0:
        # a dominant ground plane (y = +extent/2, camera looks +z with +y
        # down) for the AR demo's plane detection
        k = int(n_points * planar_frac)
        pts[:k, 1] = extent[1] * 0.5 + r.normal(0, 0.01, k).astype(np.float32)
    side = 2 * _MAX_HALF + 1
    # unique binary block textures: 5x5 random dark/light control grids
    # bilinearly upsampled. High contrast matters twice over — FAST corner
    # scores stay far above threshold (no octave flapping between frames)
    # and the intensity-centroid orientation is driven by strong asymmetric
    # mass instead of noise (smooth uniform textures measured 12-80 deg of
    # frame-to-frame angle jitter, which scrambles rotated BRIEF).
    low = np.where(
        r.uniform(size=(n_points, 5, 5)) > 0.5, 235.0, 20.0
    ).astype(np.float32)
    xs = np.linspace(0, 4, side)
    i0 = np.clip(xs.astype(int), 0, 3)
    w = (xs - i0).astype(np.float32)
    W = np.zeros((side, 5), np.float32)
    W[np.arange(side), i0] = 1 - w
    W[np.arange(side), i0 + 1] += w
    tex = np.einsum("ia,mab,jb->mij", W, low, W)
    # random plane orientation per marker (any viewpoint sees the ~half of
    # the markers whose normal faces it — uniform across trajectories)
    n = r.normal(size=(n_points, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    a = np.where(np.abs(n[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]]).astype(
        np.float32
    )
    e1 = np.cross(a, n)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(n, e1)
    # metric size chosen so each marker subtends ~10-16 px from the test
    # cameras (which live near the origin looking +z): large floating
    # squares overlap heavily in the image, and the inter-marker parallax
    # inside a 31px ORB patch scrambles orientation/descriptors between
    # viewpoints (measured 12-80 deg angle jitter at 2x overdraw)
    target_px = r.uniform(10.0, 16.0, n_points).astype(np.float32)
    half_m = np.maximum(pts[:, 2], 1.0) * target_px / (2.0 * 520.0)
    return SyntheticScene(
        points=pts, e1=e1, e2=e2, normal=n, half_m=half_m, texture=tex
    )


def render(
    scene: SyntheticScene,
    Tcw: np.ndarray,
    K,
    hw=(480, 640),
    baseline: float = 0.0,
    noise: float = 1.0,
    seed: int = 0,
    depth_map: bool = False,
):
    """Render a grayscale frame (and optional depth map) from pose Tcw.

    Each marker square is ray-cast: pixels inside its projected quad get a
    perspective-correct bilinear texture sample and the EXACT ray-plane
    depth, so stereo disparity / RGB-D unprojection are consistent with the
    true 3D geometry to machine precision.

    baseline > 0 shifts the camera right by `baseline` meters (for the right
    image of a rectified pair).
    Returns image [H,W] float32 (and depth [H,W] float32 with 0 = no depth).
    """
    h, w = hw
    fx, fy, cx, cy = K
    rng = np.random.default_rng(seed)
    R, t = Tcw[:3, :3].astype(np.float64), Tcw[:3, 3].astype(np.float64)
    tc = t.copy()
    if baseline != 0.0:
        # right camera of a rectified pair: Xc_right = Xc_left - [b, 0, 0]
        tc = tc - np.array([baseline, 0.0, 0.0])
    Xc = scene.points @ R.T + tc          # marker centers, camera frame
    n_c = scene.normal @ R.T              # plane normals, camera frame
    e1_c = scene.e1 @ R.T
    e2_c = scene.e2 @ R.T
    S = scene.texture.shape[1]

    img = np.full((h, w), scene.background, np.float32)
    dep = np.zeros((h, w), np.float32)

    z = Xc[:, 2]
    view = Xc / np.maximum(np.linalg.norm(Xc, axis=1, keepdims=True), 1e-9)
    facing = np.einsum("md,md->m", n_c, view)
    # visible: in front, tilt <= ~53 deg (|cos| > 0.60). Strongly tilted
    # planes shear noticeably per frame of camera motion, which destabilizes
    # orientation estimates and BRIEF bits; real feature pipelines also only
    # track near-frontal surface patches reliably.
    vis = (z > 0.25) & (np.abs(facing) > 0.60)
    order = np.argsort(-z)  # painter's: far first
    for i in order:
        if not vis[i]:
            continue
        hm = float(scene.half_m[i])
        corners = (
            Xc[i][None, :]
            + np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]])
            @ np.stack([e1_c[i] * hm, e2_c[i] * hm])
        )
        if np.any(corners[:, 2] < 0.05):
            continue
        uc = fx * corners[:, 0] / corners[:, 2] + cx
        vc = fy * corners[:, 1] / corners[:, 2] + cy
        u0, u1 = int(np.floor(uc.min())), int(np.ceil(uc.max()))
        v0, v1 = int(np.floor(vc.min())), int(np.ceil(vc.max()))
        u0, u1 = max(u0, 0), min(u1, w - 1)
        v0, v1 = max(v0, 0), min(v1, h - 1)
        if u0 > u1 or v0 > v1 or (u1 - u0) * (v1 - v0) > 40000:
            continue
        uu, vv = np.meshgrid(
            np.arange(u0, u1 + 1), np.arange(v0, v1 + 1)
        )
        # ray-plane intersection: d = pixel ray, t* = n.X / n.d
        d = np.stack(
            [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)],
            axis=-1,
        )
        nd = d @ n_c[i]
        ok = np.abs(nd) > 1e-9
        ts = (n_c[i] @ Xc[i]) / np.where(ok, nd, 1.0)
        P = d * ts[..., None]
        rel = P - Xc[i]
        a = (rel @ e1_c[i]) / hm
        b = (rel @ e2_c[i]) / hm
        inside = ok & (ts > 0.05) & (np.abs(a) <= 1.0) & (np.abs(b) <= 1.0)
        if not inside.any():
            continue
        # bilinear texture sample at (a,b) in [-1,1]^2
        ta = (a + 1.0) * 0.5 * (S - 1)
        tb = (b + 1.0) * 0.5 * (S - 1)
        ia = np.clip(ta.astype(int), 0, S - 2)
        ib = np.clip(tb.astype(int), 0, S - 2)
        fa = np.clip(ta - ia, 0.0, 1.0)
        fb = np.clip(tb - ib, 0.0, 1.0)
        T = scene.texture[i]
        val = (
            T[ib, ia] * (1 - fa) * (1 - fb)
            + T[ib, ia + 1] * fa * (1 - fb)
            + T[ib + 1, ia] * (1 - fa) * fb
            + T[ib + 1, ia + 1] * fa * fb
        )
        sl = (slice(v0, v1 + 1), slice(u0, u1 + 1))
        img[sl] = np.where(inside, val, img[sl]).astype(np.float32)
        dep[sl] = np.where(inside, P[..., 2], dep[sl]).astype(np.float32)
    if noise > 0:
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
        img = np.clip(img, 0, 255)
    if depth_map:
        return img, dep
    return img


def make_trajectory(kind: str = "forward", n_frames: int = 30, step: float = 0.06,
                    yaw_rate: float = 0.0, seed: int = 0):
    """Ground-truth world->camera pose sequence [N, 4, 4].

    'forward': translate along +z with optional yaw drift (KITTI-like).
    'orbit'  : circle the scene center (loop-closure-friendly).
    'jitter' : small random walk around origin (TUM-desk-like).
    """
    r = np.random.default_rng(seed)
    poses = []
    if kind == "forward":
        for i in range(n_frames):
            yaw = yaw_rate * i
            cz, sz = np.cos(yaw), np.sin(yaw)
            Rwc = np.array([[cz, 0, sz], [0, 1, 0], [-sz, 0, cz]], np.float32)
            twc = np.array([step * i * sz * 0.5, 0.0, step * i], np.float32)
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = Rwc.T
            Tcw[:3, 3] = -Rwc.T @ twc
            poses.append(Tcw)
    elif kind == "orbit":
        radius = 6.0
        center = np.array([0.0, 0.0, 10.0], np.float32)
        for i in range(n_frames):
            th = 2 * np.pi * i / n_frames
            pos = center + radius * np.array([np.sin(th), 0.0, -np.cos(th)], np.float32)
            # look at center
            z_axis = center - pos
            z_axis = z_axis / np.linalg.norm(z_axis)
            x_axis = np.cross([0.0, 1.0, 0.0], z_axis)
            x_axis = x_axis / np.linalg.norm(x_axis)
            y_axis = np.cross(z_axis, x_axis)
            Rwc = np.stack([x_axis, y_axis, z_axis], axis=1).astype(np.float32)
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = Rwc.T
            Tcw[:3, 3] = -Rwc.T @ pos
            poses.append(Tcw)
    elif kind == "circle_translate":
        # translation-only circuit (camera keeps facing +z): revisits the
        # start with identical viewing direction — a loop-closure-friendly
        # trajectory without the per-frame rotation that stresses
        # descriptor stability
        radius = 4.0
        for i in range(n_frames):
            th = 2 * np.pi * i / n_frames
            pos = radius * np.array(
                [np.sin(th), 0.0, (1 - np.cos(th)) * 0.4], np.float32
            )
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, 3] = -pos
            poses.append(Tcw)
    elif kind == "jitter":
        pos = np.zeros(3, np.float32)
        yaw = 0.0
        for i in range(n_frames):
            pos = pos + r.normal(0, step / 2, 3).astype(np.float32) * [1, 0.3, 1]
            yaw += r.normal(0, 0.004)
            cz, sz = np.cos(yaw), np.sin(yaw)
            Rwc = np.array([[cz, 0, sz], [0, 1, 0], [-sz, 0, cz]], np.float32)
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = Rwc.T
            Tcw[:3, 3] = -Rwc.T @ pos
            poses.append(Tcw)
    else:
        raise ValueError(kind)
    return np.stack(poses)


DEFAULT_K = (520.0, 520.0, 320.0, 240.0)
DEFAULT_HW = (480, 640)
DEFAULT_BASELINE = 0.3


def render_sequence(scene, poses, K=DEFAULT_K, hw=DEFAULT_HW, stereo=False,
                    baseline=DEFAULT_BASELINE, depth=False, noise=1.0):
    """Yield per-frame dicts with image(s)/depth and ground truth pose."""
    for i, Tcw in enumerate(poses):
        out = {"Tcw_gt": Tcw, "timestamp": i / 20.0}
        if stereo:
            out["image"] = render(scene, Tcw, K, hw, noise=noise, seed=100 + i)
            out["image_right"] = render(
                scene, Tcw, K, hw, baseline=baseline, noise=noise, seed=200 + i
            )
        elif depth:
            img, dep = render(scene, Tcw, K, hw, noise=noise, seed=100 + i, depth_map=True)
            out["image"], out["depth"] = img, dep
        else:
            out["image"] = render(scene, Tcw, K, hw, noise=noise, seed=100 + i)
        yield out
