"""Stereo correspondence and RGB-D depth association — the port of
`orb_slam2_comment_tpu/ops/stereo.py`.

`stereo_match` (Frame::ComputeStereoMatches, src/Frame.cc:466-640): for
every left keypoint, the best Hamming match among right keypoints in the
same row band (radius scaled by the right keypoint's octave), then an 11 px
SAD window slid +-5 px at the keypoint's own pyramid level, a parabola
through the SAD minimum, and a median-based SAD rejection. The reference
computes the SAD at every level and then selects each keypoint's; this
computes only the keypoint's own level, the same arithmetic on the same
pixels. `depth_to_uright` and `sample_depth_at` serve RGB-D frames
(Frame::ComputeStereoFromRGBD, src/Frame.cc:643-664).
"""

from __future__ import annotations

import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops import orb
from orb_slam2_comment_tpu_torch.ops.matching import hamming_from_packed
from orb_slam2_comment_tpu_torch.ops.scatter import const

_W = 5          # SAD half-window (src/Frame.cc:540 'const int w = 5')
_L = 5          # slide range (src/Frame.cc:555 '-L to +L')
_INF = 1e9


def _gather_patch_rows(stack, sizes, lvl, yc, xc, half: int, width: int):
    """[N] centres at per-keypoint levels -> [N, 2*half+1, width] patches
    (row strips). Rows and columns clamp to each level's own size; `stack`
    is `orb._level_stack` of the pyramid, level l at offset _PATCH_PAD."""
    pd = orb._PATCH_PAD
    dev = yc.device
    h = sizes[lvl, 0][:, None, None]
    w = sizes[lvl, 1][:, None, None]
    dy = torch.arange(-half, half + 1, device=dev)
    dx = torch.arange(width, device=dev) - (width - 1) // 2
    yy = torch.minimum(torch.clamp(yc[:, None, None] + dy[None, :, None], min=0), h - 1)
    xx = torch.minimum(torch.clamp(xc[:, None, None] + dx[None, None, :], min=0), w - 1)
    return stack[lvl[:, None, None], yy + pd, xx + pd]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor, the mean of the two
    middle values for an even count (as numpy and jnp.nanmedian; torch's
    nanmedian returns the lower one); NaN when every entry is NaN."""
    ok = ~torch.isnan(x)
    n = torch.sum(ok)
    v = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf")))).values
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), max=x.shape[0] - 1)
    med = (v[lo] + v[hi]) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def stereo_match(feats_l, feats_r, stack_l, stack_r, level_sizes, scale_factors: tuple,
                 bf: float, min_z: float, n_levels: int = C.DEFAULT_N_LEVELS,
                 th_stereo: float = float(C.TH_STEREO)):
    """Returns (u_right [N], depth [N]) for the left features; -1 where
    unmatched. `stack_l` and `stack_r` are the two images' level stacks
    as extraction built them (`orb._extract_impl`), `level_sizes` the
    (h, w) of each level. min_z sets the largest disparity, bf / min_z
    (the reference uses minD = 0, maxD = bf / b, src/Frame.cc:485-487)."""
    dev = feats_l.xy.device
    sf = const(tuple(float(s) for s in scale_factors), dev)
    uL, vL = feats_l.xy[:, 0], feats_l.xy[:, 1]
    uR, vR = feats_r.xy[:, 0], feats_r.xy[:, 1]
    oct_l = torch.clamp(feats_l.octave, 0, n_levels - 1).long()
    oct_r = torch.clamp(feats_r.octave, 0, n_levels - 1).long()

    # candidates: same row band (radius 2 x the right octave's scale,
    # src/Frame.cc:478), disparity in range, octaves within one
    r_band = 2.0 * sf[oct_r]
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= r_band[None, :]
    max_d = bf / min_z
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= -2.0) & (disp <= max_d)
    oct_ok = torch.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    mask = row_ok & disp_ok & oct_ok & feats_l.valid[:, None] & feats_r.valid[None, :]
    dist = torch.where(mask, hamming_from_packed(feats_l.desc, feats_r.desc),
                       torch.full_like(disp, _INF))
    best = torch.argmin(dist, dim=1)
    best_d = torch.gather(dist, 1, best[:, None])[:, 0]
    matched = best_d < th_stereo

    # SAD refinement at the left keypoint's level (src/Frame.cc:527-621)
    scale_l = sf[oct_l]
    inv_scale = 1.0 / scale_l
    u0R = uR[best]
    sc = const(tuple(1.0 / s for s in scale_factors), dev)[oct_l]
    sizes = const(tuple(tuple(int(v) for v in s) for s in level_sizes), dev, torch.int64)
    xl = torch.round(uL * sc).to(torch.int64)
    yl = torch.round(vL * sc).to(torch.int64)
    xr = torch.round(u0R * sc).to(torch.int64)
    pl = _gather_patch_rows(stack_l, sizes, oct_l, yl, xl, _W, 2 * _W + 1)
    pr = _gather_patch_rows(stack_r, sizes, oct_l, yl, xr, _W, 2 * _W + 1 + 2 * _L)
    # centre-subtracted windows, as the reference (src/Frame.cc:550-551,570)
    pl = pl - pl[:, _W, _W][:, None, None]
    win = pr.unfold(2, 2 * _W + 1, 1)                      # [N, 11, 2L+1, 11]
    win = win - win[:, _W, :, _W][:, None, :, None]
    sad = torch.sum(torch.abs(pl[:, :, None, :] - win), dim=(1, 3))   # [N, 2L+1]

    k_best = torch.argmin(sad, dim=1)
    interior = (k_best > 0) & (k_best < 2 * _L)
    k_safe = torch.clamp(k_best, 1, 2 * _L - 1)
    s_m = torch.gather(sad, 1, (k_safe - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, k_safe[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (k_safe + 1)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (s_m + s_p - 2.0 * s_0), min=1e-6)
    delta = (s_m - s_p) / denom              # parabola vertex in [-1, 1]
    delta_ok = torch.abs(delta) <= 1.0
    u_ref = (torch.round(u0R * inv_scale) + (k_safe.to(torch.float32) - _L) + delta) * scale_l

    disparity = uL - u_ref
    good = matched & interior & delta_ok & (disparity > 0.01) & (disparity < max_d)

    # median-SAD outlier rejection (src/Frame.cc:625-639)
    med = nanmedian(torch.where(good, s_0, torch.full_like(s_0, float("nan"))))
    med = torch.where(torch.isnan(med), torch.full_like(med, _INF), med)
    good = good & (s_0 <= 1.5 * 1.4 * med)

    neg = torch.full_like(u_ref, -1.0)
    u_right = torch.where(good, u_ref, neg)
    depth = torch.where(good, torch.full_like(disparity, bf)
                        / torch.clamp(disparity, min=1e-6), neg)
    return u_right, depth


def depth_to_uright(xy: torch.Tensor, depth: torch.Tensor, bf: float):
    """RGB-D: synthesize the right-image u from measured depth."""
    valid = depth > 0
    neg = torch.full_like(depth, -1.0)
    u_right = torch.where(valid, xy[:, 0] - bf / torch.clamp(depth, min=1e-6), neg)
    d = torch.where(valid, depth, neg)
    return u_right, d


def sample_depth_at(depth_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour depth lookup at keypoint locations (round half to
    even, as jnp.round)."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    return depth_map[y, x]
