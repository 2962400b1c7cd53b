"""Oriented multi-scale FAST + rotated BRIEF descriptors — the port of
`orb_slam2_comment_tpu/ops/orb.py::_extract_impl` and its parts.

The pyramid: each level a bilinear resize of the one above (two matmuls),
all written once into a zero-padded level stack. One launch of kernel K1
(`fast_nms_levels`) scores and suppresses every level of the stack (dense
FAST score + border mask + 3x3 NMS), then a bucketed top-k selects each
level's keypoints. One 48x48 patch per keypoint comes from the same stack
(kernel K2, `gather_patches`), and one [N, 2304] x [2304, Q*256+2]
product with the static BRIEF/moment matrix S gives the IC angle and the
descriptor bits of all Q rotation buckets; each keypoint keeps the bucket
of its angle.

Descriptors are [N, 8] int32 bit patterns of the reference's uint32 words.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import _build
from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops.scatter import top_k
from orb_slam2_comment_tpu_torch.utils.config import ORBConfig

__all__ = ["ORBConfig", "FrameFeatures", "extract", "fast_nms_levels", "gather_patches"]

# FAST 9-16 ring offsets (dx, dy), Bresenham circle of radius 3
_RING = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]
_ARC = 9


def _brief_pattern(seed: int = 42, n_bits: int = 256, clip: int = 13,
                   min_sep: float = 5.0) -> np.ndarray:
    """[n_bits, 4] int32 (x1, y1, x2, y2): the reference's fixed-seed
    Gaussian test pattern, drawn the same way so the bits are identical."""
    r = np.random.default_rng(seed)
    sigma = C.PATCH_SIZE / 5.0
    out = np.zeros((n_bits, 4), np.int32)
    n = 0
    while n < n_bits:
        p = np.clip(np.round(r.normal(0.0, sigma, size=4)), -clip, clip)
        if np.hypot(p[0] - p[2], p[1] - p[3]) >= min_sep:
            out[n] = p
            n += 1
    return out


_PATTERN = _brief_pattern()
_R = C.HALF_PATCH_SIZE
_g = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
_GAUSS7 = (_g / _g.sum()).astype(np.float32)

_PATCH_R = 21
_PATCH_W = 2 * _PATCH_R + 1
_PATCH_WX = _PATCH_W + 5            # stored patch: 48 x 48
_PATCH_HP = _PATCH_W + 5
_PATCH_PAD = _PATCH_R - C.EDGE_THRESHOLD + 1  # = 3
_BRIEF_Q = 64


@dataclass
class FrameFeatures:
    """Fixed-shape per-image feature set."""

    xy: torch.Tensor        # [N, 2] level-0 pixel coords (x, y)
    response: torch.Tensor  # [N] FAST score
    angle: torch.Tensor     # [N] orientation, radians
    octave: torch.Tensor    # [N] int32 pyramid level
    desc: torch.Tensor      # [N, 8] int32 bit patterns of uint32 words
    valid: torch.Tensor     # [N] bool

    @property
    def n_max(self):
        return self.xy.shape[0]

    def replace(self, **kw) -> "FrameFeatures":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# descriptor bit packing
# ---------------------------------------------------------------------------

def unpack_descriptors_signed(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] float32 +-1 (bit b of word w at
    position 32*w + b, as the reference's uint32 unpack)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1   # arithmetic shift; &1 keeps bit k
    bits = bits.reshape(desc.shape[:-1] + (256,))
    return 2.0 * bits.to(torch.float32) - 1.0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 bit patterns."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = torch.sum(b << shifts, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


# ---------------------------------------------------------------------------
# K1: FAST score + border mask + 3x3 NMS
# ---------------------------------------------------------------------------

def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST 9-16 score: the max over the 16 contiguous 9-pixel arcs of
    min(ring - centre) (bright) or min(centre - ring) (dark)."""
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
    """3x3 NMS keeping the lexicographic (score desc, index asc) maximum of
    each window — an exact tie-break toward the top-left."""
    h, w = score.shape
    dev = score.device
    idx = (torch.arange(h, device=dev, dtype=torch.int32)[:, None] * w
           + torch.arange(w, device=dev, dtype=torch.int32)[None, :])
    big = 1 << 30
    best_v, best_i = score, idx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            v = torch.full((h, w), -math.inf, dtype=score.dtype, device=dev)
            i2 = torch.full((h, w), big, dtype=torch.int32, device=dev)
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


def fast_nms_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: _nms3(where(inb, fast_score_map(img), 0))."""
    h, w = img.shape
    m = C.EDGE_THRESHOLD
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    score = torch.where(inb, fast_score_map(img), torch.zeros_like(img))
    return _nms3(score)


K1_TILE = (30, 30)      # output tile (rows, columns) of csrc/fast_nms.cu
_K1_MAX_LEVELS = 16
K1_HEAD = 7             # scalars before the per-level arrays of k1_table


@functools.lru_cache(maxsize=None)
def k1_table(sizes, Hp: int, Wp: int) -> np.ndarray:
    """K1's launch table for a level stack [L, Hp, Wp] holding levels of
    `sizes` ((h, w) per level, a tuple) at offset _PATCH_PAD: n_levels,
    Hp, Wp, pad, margin, tile rows, tile columns, then per level h, w,
    tiles across, output offset, and the prefix of tile counts (L + 1).
    Tiles are numbered level by level, row-major within a level. Raises if
    a level does not fit in the stack."""
    pd, m = _PATCH_PAD, C.EDGE_THRESHOLD
    th, tw = K1_TILE
    if not 1 <= len(sizes) <= _K1_MAX_LEVELS:
        raise ValueError(f"K1 takes 1-{_K1_MAX_LEVELS} levels, got {len(sizes)}")
    for h, w in sizes:
        if h + pd > Hp or w + pd > Wp or min(h, w) <= 2 * m:
            raise ValueError(f"level {h}x{w} does not fit a {Hp}x{Wp} stack at pad {pd} "
                             f"or has no pixel inside the {m}-px border")
    hs, ws = [h for h, _ in sizes], [w for _, w in sizes]
    tiles_x = [-(-w // tw) for w in ws]
    n_tiles = [-(-h // th) * tx for h, tx in zip(hs, tiles_x)]
    out_off = np.cumsum([0] + [h * w for h, w in sizes])[:-1].tolist()
    start = np.cumsum([0] + n_tiles).tolist()
    table = np.asarray([len(sizes), Hp, Wp, pd, m, th, tw, *hs, *ws, *tiles_x, *out_off,
                        *start], np.int32)
    table.flags.writeable = False
    return table


def fast_nms_levels(stack: torch.Tensor, sizes) -> list:
    """K1 wrapper over the zero-padded level stack [L, Hp, Wp] f32 of
    `_level_stack` (level l at [l, pad:pad + h_l, pad:pad + w_l]).
    Returns the masked, NMS-ed FAST score [h_l, w_l] of each level: for a
    CUDA stack contiguous views of one flat buffer written by one launch
    of csrc/fast_nms.cu; for a CPU stack the plain version of each
    level's view."""
    sizes = tuple(map(tuple, sizes))
    L, Hp, Wp = stack.shape
    if L != len(sizes):
        raise ValueError(f"stack has {L} levels, sizes {len(sizes)}")
    table = k1_table(sizes, Hp, Wp)
    pd = _PATCH_PAD
    if not stack.is_cuda:
        return [fast_nms_plain(stack[l, pd:pd + h, pd:pd + w]) for l, (h, w) in enumerate(sizes)]
    _build.require(stack, "stack", torch.float32, (L, Hp, Wp))
    out = torch.empty(sum(h * w for h, w in sizes), dtype=torch.float32, device=stack.device)
    _build.check(_build.library().slam_fast_nms(_build.ptr(stack), _build.ptr(out),
                                                table.ctypes.data, _build.stream_of(stack)),
                 "slam_fast_nms")
    fast_nms_levels.launches += 1
    return k1_views(out, sizes, table)


def k1_views(out: torch.Tensor, sizes, table: np.ndarray) -> list:
    """Level l's [h_l, w_l] scores as a view of K1's flat output."""
    L = len(sizes)
    off = table[K1_HEAD + 3 * L:K1_HEAD + 4 * L].tolist()
    return [out.as_strided((h, w), (w, 1), o) for (h, w), o in zip(sizes, off)]


fast_nms_levels.launches = 0


# ---------------------------------------------------------------------------
# K2: patch gather
# ---------------------------------------------------------------------------

def gather_patches_plain(padded: torch.Tensor, lyx: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: [L, Hp, Wp] f32 stack, [N, 3] int32 rows
    (level, y0, x0) -> [N, 48, 48] f32 patches. Starts are clamped into the
    stack as jax.lax.dynamic_slice clamps them."""
    L, Hp, Wp = padded.shape
    lv = torch.clamp(lyx[:, 0].long(), 0, L - 1)
    y0 = torch.clamp(lyx[:, 1].long(), 0, Hp - _PATCH_HP)
    x0 = torch.clamp(lyx[:, 2].long(), 0, Wp - _PATCH_WX)
    dy = torch.arange(_PATCH_HP, device=padded.device)
    dx = torch.arange(_PATCH_WX, device=padded.device)
    yy = (y0[:, None] + dy[None, :])[:, :, None]
    xx = (x0[:, None] + dx[None, :])[:, None, :]
    return padded[lv[:, None, None], yy, xx]


def gather_patches(padded: torch.Tensor, lyx: torch.Tensor) -> torch.Tensor:
    """K2 wrapper. CPU tensors take the plain version; CUDA tensors launch
    csrc/gather_patches.cu."""
    if not padded.is_cuda:
        return gather_patches_plain(padded, lyx)
    L, Hp, Wp = padded.shape
    n = lyx.shape[0]
    _build.require(padded, "padded", torch.float32)
    _build.require(lyx, "lyx", torch.int32, (n, 3))
    if Hp < _PATCH_HP or Wp < _PATCH_WX:
        raise ValueError(f"padded stack {tuple(padded.shape)} smaller than a patch")
    out = torch.empty((n, _PATCH_HP, _PATCH_WX), dtype=torch.float32, device=padded.device)
    lib = _build.library()
    _build.check(lib.slam_gather_patches(_build.ptr(padded), _build.ptr(lyx),
                                         _build.ptr(out), n, L, Hp, Wp,
                                         _build.stream_of(padded)),
                 "slam_gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0


# ---------------------------------------------------------------------------
# pyramid, keypoint selection, BRIEF matrix
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Bilinear interpolation as a dense [n_out, n_in] matrix (half-pixel
    centres, edge-clamped), as the reference builds it."""
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


@functools.lru_cache(maxsize=None)
def _resize_matrix_dev(n_in: int, n_out: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def _resize_level(img: torch.Tensor, hw) -> torch.Tensor:
    h1, w1 = img.shape
    h2, w2 = hw
    dev = str(img.device)
    Ry = _resize_matrix_dev(h1, h2, dev)
    Rx = _resize_matrix_dev(w1, w2, dev)
    return (Ry @ img) @ Rx.T


def _select_keypoints(score: torch.Tensor, budget: int, cell: int, min_th: float):
    """Bucketed top-k spatial distribution (the quadtree equivalent).
    Returns (xy [budget,2] int32 level coords, response [budget], valid)."""
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
    bonus = torch.where(is_best, 1e4, 0.0)
    rank_key = torch.where(ok, vals + bonus, torch.full_like(vals, -math.inf))
    top_vals, top_idx = top_k(rank_key, budget)
    sel_valid = torch.isfinite(top_vals)
    zero = torch.zeros((), dtype=xx.dtype, device=dev)
    sel_x = torch.where(sel_valid, xx[top_idx], zero)
    sel_y = torch.where(sel_valid, yy[top_idx], zero)
    sel_resp = torch.where(sel_valid, vals[top_idx], torch.zeros_like(top_vals))
    return torch.stack([sel_x, sel_y], dim=-1).to(torch.int32), sel_resp, sel_valid


@functools.lru_cache(maxsize=None)
def _brief_matrix_np(qb: int = _BRIEF_Q, stride: int = _PATCH_WX) -> np.ndarray:
    """The static S matrix [48*48, Q*256 + 2] over a row-major patch: +/-
    7x7 Gaussian stamps at the rotated test offsets for each of the Q
    rotation buckets, then the IC_Angle disk moments (m10, m01). Built the
    same way as the reference, so it is array-equal to it."""
    P, W = _PATCH_R, _PATCH_W
    g = _GAUSS7.astype(np.float64)
    pat = _PATTERN.astype(np.float64)
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
        full,
    ).ravel()
    sign = np.broadcast_to(
        np.asarray([-1.0, 1.0])[None, None, :, None, None], full
    ).ravel()
    wts = np.broadcast_to(gw[None, None, None], full).ravel() * sign
    np.add.at(S, (rows, cols), wts)
    dy, dx = np.mgrid[-_R:_R + 1, -_R:_R + 1]
    disk = (dx * dx + dy * dy) <= _R * _R
    ys, xs = np.nonzero(disk)
    rr = (ys - _R + P) * stride + (xs - _R + P)
    S[rr, -2] = dx[disk]
    S[rr, -1] = dy[disk]
    del W
    return S.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brief_matrix(device: str, qb: int = _BRIEF_Q) -> torch.Tensor:
    """S rounded to bf16 (as the reference stores it) and held in f32 on
    `device`: bf16 x bf16 products are exact in f32, so an f32 product of
    bf16-rounded operands accumulates exactly as the reference's
    preferred_element_type=f32 dot does, up to summation order."""
    S = torch.from_numpy(_brief_matrix_np(qb)).to(torch.bfloat16).to(torch.float32)
    return S.to(device)


# ---------------------------------------------------------------------------
# the extraction program
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _slot_tables(cfg: ORBConfig, device: str):
    budgets = cfg.level_budgets()
    oct_np = np.concatenate([np.full(b, l, np.int32) for l, b in enumerate(budgets)])
    scale_np = np.concatenate(
        [np.full(b, cfg.scales[l], np.float32) for l, b in enumerate(budgets)])
    return torch.from_numpy(oct_np).to(device), torch.from_numpy(scale_np).to(device)


def _level_stack(pyramid, shape) -> torch.Tensor:
    """The zero-padded level stack [L, Hp, Wp] that K1 scores and K2
    gathers from: level l at [l, pad:pad + h_l, pad:pad + w_l] with
    pad = _PATCH_PAD = 3 px of zeros round it (keypoints keep
    EDGE_THRESHOLD = 19 px from their level's border and a patch reaches
    21 px), tall and wide enough that no patch start is ever clamped."""
    h, w = shape
    pd = _PATCH_PAD
    hp2 = -(-(h + 2 * pd + 16) // 8) * 8
    wp2 = -(-(w + 2 * pd + 16) // 8) * 8
    stack = torch.zeros((len(pyramid), hp2, wp2), dtype=torch.float32,
                        device=pyramid[0].device)
    for l, lv in enumerate(pyramid):
        stack[l, pd:pd + lv.shape[0], pd:pd + lv.shape[1]] = lv
    return stack


def _patch_starts(xy_all, cfg: ORBConfig, shape) -> torch.Tensor:
    """K2's start table: one (level, y0, x0) row per keypoint slot, into
    the stack of `_level_stack`."""
    h, w = shape
    oct_dev, _ = _slot_tables(cfg, str(xy_all.device))
    pd = _PATCH_PAD
    hi_y = h + 2 * pd - _PATCH_HP + (_PATCH_HP - _PATCH_W)
    hi_x = w + 2 * pd + (_PATCH_WX - _PATCH_W) - _PATCH_WX
    ys0 = torch.clamp(xy_all[:, 1] - _PATCH_R + pd, 0, hi_y)
    xs0 = torch.clamp(xy_all[:, 0] - _PATCH_R + pd, 0, hi_x)
    return torch.stack([oct_dev, ys0, xs0], dim=1).to(torch.int32).contiguous()


def _extract_impl(image: torch.Tensor, cfg: ORBConfig, shape):
    """[H, W] f32 image -> (FrameFeatures, pyramid list, level stack of
    `_level_stack`, which stereo matching reads again)."""
    h, w = shape
    dev = image.device
    sizes = cfg.level_sizes(h, w)
    budgets = cfg.level_budgets()
    pyramid = [image]
    for lvl in range(1, cfg.n_levels):
        pyramid.append(_resize_level(pyramid[-1], sizes[lvl]))
    stack = _level_stack(pyramid, shape)
    scores = fast_nms_levels(stack, sizes)
    xy_lvl, resp_all, valid_all = zip(*(
        _select_keypoints(s, b, cfg.cell, cfg.min_th) for s, b in zip(scores, budgets)))

    oct_dev, scale_per_slot = _slot_tables(cfg, str(dev))
    xy_all = torch.cat(xy_lvl)
    n_slots = xy_all.shape[0]
    patches = gather_patches(stack, _patch_starts(xy_all, cfg, shape))   # [N, 48, 48]

    S = _brief_matrix(str(dev))
    pf = patches.reshape(n_slots, _PATCH_HP * _PATCH_WX)
    pf = pf.to(torch.bfloat16).to(torch.float32)
    out = pf @ S                                            # [N, Q*256 + 2]
    ang_all = torch.atan2(out[:, -1], out[:, -2])
    qb = _BRIEF_Q
    bucket = torch.remainder(torch.round(ang_all / (2.0 * math.pi / qb)).to(torch.int32), qb)
    sel = out[:, : qb * 256].reshape(n_slots, qb, 256)[
        torch.arange(n_slots, device=dev), bucket.long()]
    desc_all = pack_bits(sel > 0)

    feats = FrameFeatures(
        xy=xy_all.to(torch.float32) * scale_per_slot[:, None],
        response=torch.cat(resp_all),
        angle=ang_all,
        octave=oct_dev,
        desc=desc_all,
        valid=torch.cat(valid_all),
    )
    return feats, pyramid, stack


def extract(image: torch.Tensor, cfg: ORBConfig):
    """Extract features from a [H, W] grayscale image (0..255). Returns
    (FrameFeatures, pyramid list)."""
    return _extract_impl(image.to(torch.float32), cfg, tuple(image.shape))[:2]
