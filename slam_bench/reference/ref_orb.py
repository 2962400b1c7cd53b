"""Plain reference of ORB extraction, RGB-D depth lookup and stereo matching.

A frozen copy, in plain PyTorch, of what the port computes for a frame
before tracking (its `ops/orb.py` plain path, `ops/stereo.py`): the
bilinear pyramid as two matrix products per level, the dense FAST-9 score
with the border mask and the tie-broken 3x3 NMS, the bucketed top-k
selection, one 48x48 patch per keypoint, and the [N, 2304] x [2304,
Q*256+2] product that gives the IC angle and the rotated BRIEF bits. It
imports nothing of the port: the benchmark holds the keyframes that the
timed path stored against this, run on the same raw image.

`ExtractConfig` carries the ORBextractor settings of a configuration.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

EDGE_THRESHOLD = 19
HALF_PATCH_SIZE = 15
PATCH_SIZE = 31

_RING = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]
_ARC = 9
_PATCH_R = 21
_PATCH_W = 2 * _PATCH_R + 1
_PATCH_WX = _PATCH_W + 5
_PATCH_HP = _PATCH_W + 5
_PATCH_PAD = _PATCH_R - EDGE_THRESHOLD + 1
_BRIEF_Q = 64
_g = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
_GAUSS7 = (_g / _g.sum()).astype(np.float32)


class ExtractConfig(NamedTuple):
    n_features: int
    n_levels: int
    scale_factor: float
    min_th: float
    cell: int = 32

    @property
    def scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    def level_sizes(self, h: int, w: int):
        return [(max(int(round(h / s)), 64), max(int(round(w / s)), 64)) for s in self.scales]

    def level_budgets(self):
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = [max(int(round(n0 * f ** l)), 8) for l in range(self.n_levels)]
        budgets[-1] = max(self.n_features - sum(budgets[:-1]), 8)
        return budgets


class Features(NamedTuple):
    xy: torch.Tensor        # [N, 2] level-0 pixel coordinates
    angle: torch.Tensor     # [N]
    octave: torch.Tensor    # [N] int32
    desc: torch.Tensor      # [N, 8] int32 bit patterns
    valid: torch.Tensor     # [N] bool


def _brief_pattern(seed: int = 42, n_bits: int = 256, clip: int = 13,
                   min_sep: float = 5.0) -> np.ndarray:
    r = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    out = np.zeros((n_bits, 4), np.int32)
    n = 0
    while n < n_bits:
        p = np.clip(np.round(r.normal(0.0, sigma, size=4)), -clip, clip)
        if np.hypot(p[0] - p[2], p[1] - p[3]) >= min_sep:
            out[n] = p
            n += 1
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = torch.sum(b << shifts, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    return (((desc[..., None] >> shifts) & 1) > 0).reshape(desc.shape[:-1] + (256,))


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    d = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for (dx, dy) in _RING])
    dcat = torch.cat([d, d[: _ARC - 1]], dim=0)
    m_bright = dcat[0:16]
    m_dark = -dcat[0:16]
    for j in range(1, _ARC):
        m_bright = torch.minimum(m_bright, dcat[j:j + 16])
        m_dark = torch.minimum(m_dark, -dcat[j:j + 16])
    return torch.maximum(torch.max(m_bright, dim=0).values, torch.max(m_dark, dim=0).values)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 NMS keeping the (score desc, index asc) maximum of each window."""
    h, w = score.shape
    dev = score.device
    idx = (torch.arange(h, device=dev, dtype=torch.int32)[:, None] * w
           + torch.arange(w, device=dev, dtype=torch.int32)[None, :])
    best_v, best_i = score, idx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            v = torch.full((h, w), -math.inf, dtype=score.dtype, device=dev)
            i2 = torch.full((h, w), 1 << 30, dtype=torch.int32, device=dev)
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            v[yd, xd] = score[ys, xs]
            i2[yd, xd] = idx[ys, xs]
            take = (v > best_v) | ((v == best_v) & (i2 < best_i))
            best_v = torch.where(take, v, best_v)
            best_i = torch.where(take, i2, best_i)
    return torch.where(best_i == idx, score, torch.zeros_like(score))


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    m = EDGE_THRESHOLD
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    return _nms3(torch.where(inb, fast_score_map(img), torch.zeros_like(img)))


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    x = (np.arange(n_out) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    lo = np.clip(x0, 0, n_in - 1)
    hi = np.clip(x0 + 1, 0, n_in - 1)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), lo] += 1.0 - frac
    M[np.arange(n_out), hi] += frac
    return M


def _resize(img: torch.Tensor, hw) -> torch.Tensor:
    h1, w1 = img.shape
    Ry = torch.from_numpy(_resize_matrix(h1, hw[0])).to(img.device)
    Rx = torch.from_numpy(_resize_matrix(w1, hw[1])).to(img.device)
    return (Ry @ img) @ Rx.T


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select(score: torch.Tensor, budget: int, cell: int, min_th: float):
    h, w = score.shape
    dev = score.device
    ch, cw = -(-h // cell), -(-w // cell)
    s = torch.nn.functional.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = s.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(ch * cw, cell * cell)
    n_cells = ch * cw
    k_cell = min(max(-(-3 * budget // n_cells), 1), cell * cell)
    vals, idx = top_k(cells, k_cell)
    ar = torch.arange(n_cells, device=dev)
    yy = ((ar // cw)[:, None] * cell + idx // cell).reshape(-1)
    xx = ((ar % cw)[:, None] * cell + idx % cell).reshape(-1)
    vals = vals.reshape(-1)
    ok = vals > min_th
    is_best = (torch.arange(n_cells * k_cell, device=dev) % k_cell) == 0
    rank_key = torch.where(ok, vals + torch.where(is_best, 1e4, 0.0),
                           torch.full_like(vals, -math.inf))
    top_vals, top_idx = top_k(rank_key, budget)
    sel_valid = torch.isfinite(top_vals)
    zero = torch.zeros((), dtype=xx.dtype, device=dev)
    sel_x = torch.where(sel_valid, xx[top_idx], zero)
    sel_y = torch.where(sel_valid, yy[top_idx], zero)
    return torch.stack([sel_x, sel_y], dim=-1).to(torch.int32), sel_valid


@functools.lru_cache(maxsize=None)
def _brief_matrix_np(qb: int = _BRIEF_Q, stride: int = _PATCH_WX) -> np.ndarray:
    """[48*48, Q*256 + 2]: +/- 7x7 Gaussian stamps at the rotated test
    offsets of each of the Q rotation buckets, then the disk moments."""
    P, R = _PATCH_R, HALF_PATCH_SIZE
    g = _GAUSS7.astype(np.float64)
    pat = _brief_pattern().astype(np.float64)
    S = np.zeros((_PATCH_HP * stride, qb * 256 + 2), np.float64)
    th = 2.0 * np.pi * np.arange(qb) / qb
    ca, sa = np.cos(th)[:, None], np.sin(th)[:, None]
    rx = np.rint(np.stack([ca * pat[:, 0] - sa * pat[:, 1],
                           ca * pat[:, 2] - sa * pat[:, 3]], axis=-1)).astype(int)
    ry = np.rint(np.stack([sa * pat[:, 0] + ca * pat[:, 1],
                           sa * pat[:, 2] + ca * pat[:, 3]], axis=-1)).astype(int)
    dyx = np.arange(-3, 4)
    gw = np.outer(g, g)
    yy = (P + ry[..., None, None] + dyx[None, None, None, :, None])
    xx = (P + rx[..., None, None] + dyx[None, None, None, None, :])
    full = (qb, 256, 2, 7, 7)
    rows = np.broadcast_to(yy * stride + xx, full).ravel()
    cols = np.broadcast_to(
        (np.arange(qb)[:, None] * 256 + np.arange(256)[None, :])[..., None, None, None],
        full).ravel()
    sign = np.broadcast_to(np.asarray([-1.0, 1.0])[None, None, :, None, None], full).ravel()
    wts = np.broadcast_to(gw[None, None, None], full).ravel() * sign
    np.add.at(S, (rows, cols), wts)
    dy, dx = np.mgrid[-R:R + 1, -R:R + 1]
    disk = (dx * dx + dy * dy) <= R * R
    ys, xs = np.nonzero(disk)
    rr = (ys - R + P) * stride + (xs - R + P)
    S[rr, -2] = dx[disk]
    S[rr, -1] = dy[disk]
    return S.astype(np.float32)


def level_stack(pyramid, shape) -> torch.Tensor:
    h, w = shape
    pd = _PATCH_PAD
    hp2 = -(-(h + 2 * pd + 16) // 8) * 8
    wp2 = -(-(w + 2 * pd + 16) // 8) * 8
    stack = torch.zeros((len(pyramid), hp2, wp2), dtype=torch.float32,
                        device=pyramid[0].device)
    for l, lv in enumerate(pyramid):
        stack[l, pd:pd + lv.shape[0], pd:pd + lv.shape[1]] = lv
    return stack


def _patches(stack: torch.Tensor, xy: torch.Tensor, octave: torch.Tensor, shape):
    h, w = shape
    L, Hp, Wp = stack.shape
    pd = _PATCH_PAD
    hi_y = h + 2 * pd - _PATCH_HP + (_PATCH_HP - _PATCH_W)
    hi_x = w + 2 * pd + (_PATCH_WX - _PATCH_W) - _PATCH_WX
    y0 = torch.clamp(xy[:, 1] - _PATCH_R + pd, 0, hi_y).long().clamp(0, Hp - _PATCH_HP)
    x0 = torch.clamp(xy[:, 0] - _PATCH_R + pd, 0, hi_x).long().clamp(0, Wp - _PATCH_WX)
    lv = torch.clamp(octave.long(), 0, L - 1)
    dy = torch.arange(_PATCH_HP, device=stack.device)
    dx = torch.arange(_PATCH_WX, device=stack.device)
    yy = (y0[:, None] + dy[None, :])[:, :, None]
    xx = (x0[:, None] + dx[None, :])[:, None, :]
    return stack[lv[:, None, None], yy, xx]


def extract(image: torch.Tensor, cfg: ExtractConfig):
    """[H, W] f32 image (0..255) -> (Features, level stack, level sizes)."""
    h, w = image.shape
    dev = image.device
    sizes = cfg.level_sizes(h, w)
    budgets = cfg.level_budgets()
    pyramid = [image]
    for lvl in range(1, cfg.n_levels):
        pyramid.append(_resize(pyramid[-1], sizes[lvl]))
    stack = level_stack(pyramid, (h, w))
    xy_l, valid_l = zip(*(_select(fast_nms(lv), b, cfg.cell, cfg.min_th)
                          for lv, b in zip(pyramid, budgets)))
    octave = torch.cat([torch.full((b,), l, dtype=torch.int32, device=dev)
                        for l, b in enumerate(budgets)])
    scale = torch.cat([torch.full((b,), cfg.scales[l], dtype=torch.float32, device=dev)
                       for l, b in enumerate(budgets)])
    xy = torch.cat(xy_l)
    n = xy.shape[0]
    S = torch.from_numpy(_brief_matrix_np()).to(torch.bfloat16).to(torch.float32).to(dev)
    pf = _patches(stack, xy, octave, (h, w)).reshape(n, _PATCH_HP * _PATCH_WX)
    out = pf.to(torch.bfloat16).to(torch.float32) @ S
    ang = torch.atan2(out[:, -1], out[:, -2])
    qb = _BRIEF_Q
    bucket = torch.remainder(torch.round(ang / (2.0 * math.pi / qb)).to(torch.int32), qb)
    sel = out[:, : qb * 256].reshape(n, qb, 256)[torch.arange(n, device=dev), bucket.long()]
    feats = Features(xy=xy.to(torch.float32) * scale[:, None], angle=ang, octave=octave,
                     desc=pack_bits(sel > 0), valid=torch.cat(valid_l))
    return feats, stack, sizes


def depth_at(depth_map: torch.Tensor, xy: torch.Tensor, factor: float) -> torch.Tensor:
    """RGB-D: the depth map's nearest pixel (round half to even) in metres,
    -1 where it reads 0 (no measurement)."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map[y, x].to(torch.float32)
    if factor != 1.0:
        d = d / factor
    return torch.where(d > 0, d, torch.full_like(d, -1.0))


def undistort(xy: torch.Tensor, K, dist, iters: int = 50) -> torch.Tensor:
    """Keypoints through the inverse of OpenCV's radial-tangential model
    (Frame::UndistortKeyPoints), iterated in float64 to convergence; the
    points unchanged without distortion."""
    if dist is None or not any(dist):
        return xy
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    fx, fy, cx, cy = (float(v) for v in K)
    xd = (xy[:, 0].to(torch.float64) - cx) / fx
    yd = (xy[:, 1].to(torch.float64) - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x, y = ((xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / radial,
                (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / radial)
    return torch.stack([x * fx + cx, y * fy + cy], -1).to(xy.dtype)


# ---------------------------------------------------------------------------
# stereo matching (Frame::ComputeStereoMatches)
# ---------------------------------------------------------------------------

_W = 5
_L = 5
_INF = 1e9


def _hamming(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    a = unpack_bits(da).to(torch.float32)
    b = unpack_bits(db).to(torch.float32)
    return a.shape[-1] - (a @ b.T + (1 - a) @ (1 - b).T)


def _patch_rows(stack, sizes, lvl, yc, xc, half: int, width: int):
    dev = yc.device
    h = sizes[lvl, 0][:, None, None]
    w = sizes[lvl, 1][:, None, None]
    dy = torch.arange(-half, half + 1, device=dev)
    dx = torch.arange(width, device=dev) - (width - 1) // 2
    yy = torch.minimum(torch.clamp(yc[:, None, None] + dy[None, :, None], min=0), h - 1)
    xx = torch.minimum(torch.clamp(xc[:, None, None] + dx[None, None, :], min=0), w - 1)
    return stack[lvl[:, None, None], yy + _PATCH_PAD, xx + _PATCH_PAD]


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    ok = ~torch.isnan(x)
    n = torch.sum(ok)
    v = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf")))).values
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), max=x.shape[0] - 1)
    med = (v[lo] + v[hi]) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def stereo_match(fl: Features, fr: Features, stack_l, stack_r, sizes, cfg: ExtractConfig,
                 bf: float, min_z: float, th_stereo: float):
    """Right u per left keypoint: the best Hamming match in the row band,
    refined by an 11 px SAD slid +-5 px at the keypoint's level, a
    parabola through the minimum and the median-SAD rejection; -1 where
    unmatched. Returns (u_right, depth)."""
    dev = fl.xy.device
    sf = torch.tensor(cfg.scales, dtype=torch.float32, device=dev)
    uL, vL = fl.xy[:, 0], fl.xy[:, 1]
    uR, vR = fr.xy[:, 0], fr.xy[:, 1]
    oct_l = torch.clamp(fl.octave, 0, cfg.n_levels - 1).long()
    oct_r = torch.clamp(fr.octave, 0, cfg.n_levels - 1).long()
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= (2.0 * sf[oct_r])[None, :]
    max_d = bf / min_z
    disp = uL[:, None] - uR[None, :]
    mask = (row_ok & (disp >= -2.0) & (disp <= max_d)
            & (torch.abs(fl.octave[:, None] - fr.octave[None, :]) <= 1)
            & fl.valid[:, None] & fr.valid[None, :])
    dist = torch.where(mask, _hamming(fl.desc, fr.desc), torch.full_like(disp, _INF))
    best = torch.argmin(dist, dim=1)
    matched = torch.gather(dist, 1, best[:, None])[:, 0] < th_stereo
    scale_l = sf[oct_l]
    u0R = uR[best]
    sc = torch.tensor([1.0 / s for s in cfg.scales], dtype=torch.float32, device=dev)[oct_l]
    szs = torch.tensor(sizes, dtype=torch.int64, device=dev)
    xl = torch.round(uL * sc).to(torch.int64)
    yl = torch.round(vL * sc).to(torch.int64)
    xr = torch.round(u0R * sc).to(torch.int64)
    pl = _patch_rows(stack_l, szs, oct_l, yl, xl, _W, 2 * _W + 1)
    pr = _patch_rows(stack_r, szs, oct_l, yl, xr, _W, 2 * _W + 1 + 2 * _L)
    pl = pl - pl[:, _W, _W][:, None, None]
    win = pr.unfold(2, 2 * _W + 1, 1)
    win = win - win[:, _W, :, _W][:, None, :, None]
    sad = torch.sum(torch.abs(pl[:, :, None, :] - win), dim=(1, 3))
    k_best = torch.argmin(sad, dim=1)
    interior = (k_best > 0) & (k_best < 2 * _L)
    k = torch.clamp(k_best, 1, 2 * _L - 1)
    s_m = torch.gather(sad, 1, (k - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, k[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (k + 1)[:, None])[:, 0]
    delta = (s_m - s_p) / torch.clamp(2.0 * (s_m + s_p - 2.0 * s_0), min=1e-6)
    u_ref = (torch.round(u0R * (1.0 / scale_l)) + (k.to(torch.float32) - _L) + delta) * scale_l
    disparity = uL - u_ref
    good = (matched & interior & (torch.abs(delta) <= 1.0) & (disparity > 0.01)
            & (disparity < max_d))
    med = _nanmedian(torch.where(good, s_0, torch.full_like(s_0, float("nan"))))
    med = torch.where(torch.isnan(med), torch.full_like(med, _INF), med)
    good = good & (s_0 <= 1.5 * 1.4 * med)
    neg = torch.full_like(u_ref, -1.0)
    depth = torch.where(good, torch.full_like(disparity, bf) / torch.clamp(disparity, min=1e-6),
                        neg)
    return torch.where(good, u_ref, neg), depth
