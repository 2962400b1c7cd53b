"""Ray-cast a textured-quad scene on the card, in plain PyTorch.

The arithmetic of the port's host renderer (`utils/render.render_quads`:
an analytic ray/plane hit per quad over a supersampled pixel grid, the
nearest hit per pixel, a bilinear texture lookup, the mean of each
supersample block, the centre sample's depth, Gaussian sensor noise),
reorganised for the card: every pixel is tested against every quad in
front of the camera at once ([quads, pixels] arrays, a few dozen kernels
a frame), the nearest hit is a minimum over quads, and only the winning
quad's texture is sampled. Textures are stacked on the device once.
With a lens distortion (OpenCV's radial-tangential model, k1 k2 p1 p2 k3)
each output pixel's ray is that of its undistorted point, worked out once
for the grid, so the frames carry the distortion that the SLAM system
undoes as it would for a real camera.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.scene import QuadScene

QUAD_CHUNK = 16   # quads tested against the whole grid at once


class Renderer:
    """One scene on one device for one camera: textures uploaded once,
    the per-pixel ray directions built once."""

    def __init__(self, scene: QuadScene, K, hw, device, supersample: int = 2,
                 noise: float = 1.5, dist=None):
        self.scene = scene
        self.K = tuple(float(v) for v in K)
        self.hw = tuple(hw)
        self.dev = torch.device(device)
        self.ss = max(1, int(supersample))
        self.noise = float(noise)
        texs, self.tex_of = [], []
        seen = {}
        for q in scene.quads:
            if id(q.tex) not in seen:
                seen[id(q.tex)] = len(texs)
                texs.append(q.tex)
            self.tex_of.append(seen[id(q.tex)])
        if len({t.shape for t in texs}) != 1:
            raise ValueError("every texture of a scene must have one size")
        self.tex = torch.from_numpy(np.stack(texs)).to(self.dev)   # [T, S, S]
        self.tex_of = np.asarray(self.tex_of, np.int64)
        self.O = np.stack([q.origin for q in scene.quads])
        self.EU = np.stack([q.eu for q in scene.quads])
        self.EV = np.stack([q.ev for q in scene.quads])
        h, w = self.hw
        fx, fy, cx, cy = self.K
        ss = self.ss
        H, W = h * ss, w * ss
        ys = (np.arange(H)[:, None] / ss - cy + 0.5 / ss - 0.5) / fy
        xs = (np.arange(W)[None, :] / ss - cx + 0.5 / ss - 0.5) / fx
        xs, ys = np.broadcast_to(xs, (H, W)).reshape(-1), np.broadcast_to(ys, (H, W)).reshape(-1)
        if dist is not None:
            xs, ys = undistort_normalized(xs, ys, dist)
        # the pinhole box that the grid's rays cover, for the quads' cull
        self.box = (fx * xs.min() + cx, fx * xs.max() + cx, fy * ys.min() + cy,
                    fy * ys.max() + cy)
        self.dx = torch.from_numpy(xs.astype(np.float32)).to(self.dev)
        self.dy = torch.from_numpy(ys.astype(np.float32)).to(self.dev)

    def _quads_in_camera(self, Tcw, baseline):
        """Per quad in front of the camera, ordered near to far as the host
        renderer visits them: [n, 17] rows (origin, edges and normal in
        the camera frame, origin . normal, the edges' Gram entries and
        their determinant) and each quad's texture index."""
        R = Tcw[:3, :3].astype(np.float64)
        t = Tcw[:3, 3].astype(np.float64) - np.array([baseline, 0.0, 0.0])
        oc = self.O @ R.T + t
        eu = self.EU @ R.T
        ev = self.EV @ R.T
        keep = self._on_screen(np.stack([oc, oc + eu, oc + eu + ev, oc + ev], 1))
        near = np.abs(np.stack([oc[:, 2], oc[:, 2] + eu[:, 2], oc[:, 2] + ev[:, 2],
                                oc[:, 2] + eu[:, 2] + ev[:, 2]], 1)).min(1)
        order = np.argsort(near[keep], kind="stable")
        idx = np.nonzero(keep)[0][order]
        oc, eu, ev = oc[idx], eu[idx], ev[idx]
        n = np.cross(eu, ev)
        a = (eu * eu).sum(1)
        b = (eu * ev).sum(1)
        c = (ev * ev).sum(1)
        rows = np.concatenate([oc, eu, ev, n, (oc * n).sum(1)[:, None], a[:, None], b[:, None],
                               c[:, None], (a * c - b * b)[:, None]], 1)
        return rows, self.tex_of[idx]

    def _on_screen(self, C):
        """Quads [n, 4 corners, 3] (camera frame, in polygon order) that
        can cover a pixel: their part in front of the near plane z = 0.05
        (corners there, and where an edge crosses it) projects to a box
        that meets the image. A quad wholly behind the plane never does."""
        zn = 0.05
        D = np.roll(C, -1, axis=1)
        z0, z1 = C[..., 2], D[..., 2]
        cross = (z0 - zn) * (z1 - zn) < 0
        a = np.where(cross, (zn - z0) / np.where(cross, z1 - z0, 1.0), 0.0)
        P = np.concatenate([C, C + a[..., None] * (D - C)], 1)          # [n, 8, 3]
        ok = np.concatenate([z0 >= zn, cross], 1)
        fx, fy, cx, cy = self.K
        z = np.where(ok, P[..., 2], 1.0)
        u = np.where(ok, fx * P[..., 0] / z + cx, np.nan)
        v = np.where(ok, fy * P[..., 1] / z + cy, np.nan)
        any_ok = ok.any(1)
        with np.errstate(invalid="ignore"):
            u0, u1 = np.nanmin(np.where(any_ok[:, None], u, 0), 1), np.nanmax(
                np.where(any_ok[:, None], u, 0), 1)
            v0, v1 = np.nanmin(np.where(any_ok[:, None], v, 0), 1), np.nanmax(
                np.where(any_ok[:, None], v, 0), 1)
        bu0, bu1, bv0, bv1 = self.box
        return any_ok & (u1 >= bu0 - 2) & (u0 <= bu1 + 2) & (v1 >= bv0 - 2) & (v0 <= bv1 + 2)

    def render(self, Tcw: np.ndarray, baseline: float = 0.0, seed: int = 0):
        """Gray [h, w] f32 in 0..255 and z-depth [h, w] f32 (0 where no
        surface) of the camera at Tcw, shifted `baseline` metres along its
        +x for the right image of a stereo pair; the noise drawn from
        `seed`."""
        h, w = self.hw
        ss = self.ss
        rows, tex_idx = self._quads_in_camera(Tcw, baseline)
        P = self.dx.shape[0]
        f32 = torch.float32
        zbest = torch.full((P,), float("inf"), dtype=f32, device=self.dev)
        ubest = torch.zeros(P, dtype=f32, device=self.dev)
        vbest = torch.zeros(P, dtype=f32, device=self.dev)
        tbest = torch.zeros(P, dtype=torch.int64, device=self.dev)
        if len(rows):
            G = torch.from_numpy(rows.astype(np.float32)).to(self.dev)    # [n, 17]
            T = torch.from_numpy(tex_idx).to(self.dev)
            dx, dy = self.dx[None], self.dy[None]
            for q0 in range(0, G.shape[0], QUAD_CHUNK):
                g = G[q0:q0 + QUAD_CHUNK, :, None]
                th = g[:, 12] / (dx * g[:, 9] + dy * g[:, 10] + g[:, 11])
                px = th * dx - g[:, 0]
                py = th * dy - g[:, 1]
                pz = th - g[:, 2]
                pu = px * g[:, 3] + py * g[:, 4] + pz * g[:, 5]
                pv = px * g[:, 6] + py * g[:, 7] + pz * g[:, 8]
                uu = (g[:, 15] * pu - g[:, 14] * pv) / g[:, 16]
                vv = (g[:, 13] * pv - g[:, 14] * pu) / g[:, 16]
                hit = ((th > 0.05) & torch.isfinite(th) & (uu >= 0) & (uu < 1)
                       & (vv >= 0) & (vv < 1))
                z = torch.where(hit, th, torch.full_like(th, float("inf")))
                zmin, k = z.min(0)                 # ties: the nearer-sorted quad
                better = zmin < zbest
                zbest = torch.where(better, zmin, zbest)
                ubest = torch.where(better, uu.gather(0, k[None])[0], ubest)
                vbest = torch.where(better, vv.gather(0, k[None])[0], vbest)
                tbest = torch.where(better, T[q0:q0 + QUAD_CHUNK][k], tbest)
        S = self.tex.shape[-1]
        tu = torch.clamp(ubest * S - 0.5, 0, S - 1.001)
        tv = torch.clamp(vbest * S - 0.5, 0, S - 1.001)
        i0 = tu.to(torch.int64)
        j0 = tv.to(torch.int64)
        fu = (tu - i0).to(torch.float32)
        fv = (tv - j0).to(torch.float32)
        flat = self.tex.reshape(-1)
        base = (tbest * S + j0) * S + i0
        val = (flat[base] * (1 - fu) * (1 - fv) + flat[base + 1] * fu * (1 - fv)
               + flat[base + S] * (1 - fu) * fv + flat[base + S + 1] * fu * fv)
        found = torch.isfinite(zbest)
        img = torch.where(found, val, torch.full_like(val, self.scene.background))
        img = img.reshape(h, ss, w, ss).mean(dim=(1, 3))
        zc = zbest.reshape(h * ss, w * ss)[ss // 2::ss, ss // 2::ss]
        dep = torch.where(torch.isfinite(zc), zc, torch.zeros_like(zc)).to(torch.float32)
        if self.noise > 0:
            g = torch.Generator(device=self.dev)
            g.manual_seed(int(seed))
            img = img + self.noise * torch.randn((h, w), generator=g, device=self.dev,
                                                 dtype=torch.float32)
        return torch.clamp(img, 0, 255), dep


def distort_normalized(x: np.ndarray, y: np.ndarray, dist):
    """OpenCV's radial-tangential model on normalized image points."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def undistort_normalized(xd: np.ndarray, yd: np.ndarray, dist, iters: int = 100):
    """The undistorted normalized points whose distortion is (xd, yd), by
    fixed-point iteration in float64 to convergence."""
    xd = np.asarray(xd, np.float64)
    yd = np.asarray(yd, np.float64)
    k1, k2, p1, p2, k3 = dist
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x, y = ((xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / radial,
                (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / radial)
    ex, ey = distort_normalized(x, y, dist)
    err = max(float(np.abs(ex - xd).max()), float(np.abs(ey - yd).max()))
    if err > 1e-9:
        raise ValueError(f"the distortion does not invert over the image ({err:.2e})")
    return x, y


def to_gray8(img: torch.Tensor) -> torch.Tensor:
    """A camera's 8-bit gray image (truncated, as a cast of the clipped
    value)."""
    return torch.clamp(img, 0, 255).to(torch.uint8)


def to_depth16(dep: torch.Tensor, factor: float) -> torch.Tensor:
    """A depth camera's uint16 map in units of 1/factor m; a surface past
    the format's range reads 0 (no measurement), as a sensor out of range
    does. Carried as int32 on the device (torch's uint16 is thin)."""
    d = dep.to(torch.float64) * factor
    return torch.where(d < 65535.0, d, torch.zeros_like(d)).to(torch.int32)
