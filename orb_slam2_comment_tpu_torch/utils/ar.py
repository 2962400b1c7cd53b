"""Augmented-reality helpers — the reference's monoAR demo support
(Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.{h,cc}): RANSAC plane detection
over the tracked map points and a virtual cube anchored to the plane,
drawn by software projection (no GL needed).
"""

from __future__ import annotations

import numpy as np


def detect_plane(points: np.ndarray, Tcw: np.ndarray, iterations: int = 50,
                 seed: int = 0):
    """RANSAC plane fit over tracked 3D map points
    (ViewerAR::DetectPlane, AR/ViewerAR.cc). Returns (normal [3],
    origin [3]) in world coordinates with the normal oriented toward the
    camera, or None with <20 points or no consensus.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(pts)
    if n < 20:
        return None
    rng = np.random.RandomState(seed)
    best_inliers, best_plane = 0, None
    # scale-aware threshold: median distance between points and centroid
    spread = np.median(np.linalg.norm(pts - pts.mean(0), axis=1))
    th = max(0.02 * spread, 1e-6)
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[idx]
        nrm = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(nrm)
        if norm < 1e-12:
            continue
        nrm = nrm / norm
        d = np.abs((pts - p0) @ nrm)
        inl = int((d < th).sum())
        if inl > best_inliers:
            best_inliers, best_plane = inl, (nrm, p0)
    if best_plane is None or best_inliers < max(20, 0.2 * n):
        return None
    nrm, p0 = best_plane
    mask = np.abs((pts - p0) @ nrm) < th
    sel = pts[mask]
    origin = sel.mean(0)
    # least-squares refit
    u, s, vt = np.linalg.svd(sel - origin)
    nrm = vt[2]
    # orient normal toward the camera (ViewerAR keeps the visible side)
    cam_center = -(Tcw[:3, :3].T @ Tcw[:3, 3])
    if (cam_center - origin) @ nrm < 0:
        nrm = -nrm
    return nrm, origin


def cube_vertices(origin: np.ndarray, normal: np.ndarray, size: float):
    """8 world-space corners of a cube of edge `size` sitting on the
    plane at `origin` (the AR demo's inserted virtual cube)."""
    n = normal / np.linalg.norm(normal)
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    h = size / 2.0
    base = [origin + su * h * u + sv * h * v for su in (-1, 1) for sv in (-1, 1)]
    top = [p + size * n for p in base]
    return np.stack(base + top)


CUBE_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),      # base
    (4, 5), (5, 7), (7, 6), (6, 4),      # top
    (0, 4), (1, 5), (2, 6), (3, 7),      # pillars
]


def project_points(Tcw: np.ndarray, K, pts: np.ndarray):
    """World points -> pixel coords (u, v) + in-front mask."""
    fx, fy, cx, cy = K
    Xc = pts @ np.asarray(Tcw[:3, :3]).T + np.asarray(Tcw[:3, 3])
    z = Xc[:, 2]
    ok = z > 1e-6
    u = fx * Xc[:, 0] / np.maximum(z, 1e-6) + cx
    v = fy * Xc[:, 1] / np.maximum(z, 1e-6) + cy
    return np.stack([u, v], -1), ok


def draw_line(img: np.ndarray, p0, p1, color):
    """Integer Bresenham segment on an RGB uint8 image (in place)."""
    h, w = img.shape[:2]
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    steps = max(abs(x1 - x0), abs(y1 - y0), 1)
    if steps > 4 * (h + w):  # reject absurd off-screen segments
        return
    xs = np.linspace(x0, x1, steps + 1).round().astype(int)
    ys = np.linspace(y0, y1, steps + 1).round().astype(int)
    m = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[m], xs[m]] = color


def render_cube(image: np.ndarray, Tcw: np.ndarray, K, normal, origin,
                size: float, color=(0, 255, 0)) -> np.ndarray:
    """Overlay the virtual cube wireframe on a grayscale/RGB frame."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = np.clip(img, 0, 255).astype(np.uint8).copy()
    verts = cube_vertices(np.asarray(origin), np.asarray(normal), size)
    uv, ok = project_points(np.asarray(Tcw), K, verts)
    for i, j in CUBE_EDGES:
        if ok[i] and ok[j]:
            draw_line(img, uv[i], uv[j], color)
    return img
