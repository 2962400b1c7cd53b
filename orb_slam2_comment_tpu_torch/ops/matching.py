"""Data association as masked Hamming-distance matrices — the port of
`orb_slam2_comment_tpu/ops/matching.py`.

Hamming distances come from one f32 product of +-1 bit vectors: the sums
are integers below 2^9, exact in f32 with TF32 off. `argmin` returns the
first minimum in both frameworks, and top-k ties go to the lower index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops.orb import unpack_descriptors_signed
from orb_slam2_comment_tpu_torch.ops.scatter import top_k

_INF = 1e9


def hamming_matrix(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """[N,256] x [M,256] signed (+-1) bits -> [N,M] float32 Hamming."""
    return (256.0 - sa @ sb.T) * 0.5


def hamming_from_packed(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Packed [N,8]/[M,8] int32 descriptors -> [N,M] Hamming distances."""
    return hamming_matrix(unpack_descriptors_signed(da), unpack_descriptors_signed(db))


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [N] best column per row (garbage where ~ok)
    dist: torch.Tensor   # [N] best distance
    ok: torch.Tensor     # [N] bool accepted


def _best_two(dist: torch.Tensor):
    """Per-row best and second-best distances + both indices."""
    n = dist.shape[0]
    rows = torch.arange(n, device=dist.device)
    best = torch.argmin(dist, dim=1)
    d1 = dist[rows, best]
    masked = dist.clone()
    masked[rows, best] = _INF
    best2 = torch.argmin(masked, dim=1)
    d2 = masked[rows, best2]
    return best, d1, d2, best2


def _mutual_best(dist: torch.Tensor, row_best: torch.Tensor, row_ok: torch.Tensor):
    n = dist.shape[0]
    col_best = torch.argmin(dist, dim=0)
    mutual = col_best[row_best] == torch.arange(n, device=dist.device)
    return row_ok & mutual


def rotation_consistency(angles_a, angles_b_matched, ok, n_bins: int = C.HISTO_LENGTH):
    """Keep matches whose rotation offset falls in the 3 dominant bins
    (ComputeThreeMaxima, src/ORBmatcher.cc:1601-1645)."""
    rot = torch.remainder(angles_a - angles_b_matched, 2 * math.pi)
    bins = torch.clamp((rot * n_bins / (2 * math.pi)).to(torch.int32), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=ok.device)
    hist = hist.index_add(0, bins.long(), ok.to(torch.int32))
    top3, top3i = top_k(hist, 3)
    neg = torch.full_like(top3i, -1)
    keep1 = top3i[0]
    keep2 = torch.where(top3[1] > 0.1 * top3[0], top3i[1], neg[1])
    keep3 = torch.where(top3[2] > 0.1 * top3[0], top3i[2], neg[2])
    in_top = (bins == keep1) | (bins == keep2) | (bins == keep3)
    return ok & in_top


def match_generic(dist, mask, max_dist: float, nn_ratio=None, mutual: bool = False,
                  angles_a=None, angles_b=None, octaves_b=None) -> MatchResult:
    """Best match with acceptance threshold, Lowe ratio (same-octave only
    when octaves_b is given), mutual-best and rotation filters."""
    d = torch.where(mask, dist, torch.full_like(dist, _INF))
    best, d1, d2, best2 = _best_two(d)
    ok = d1 <= max_dist
    if nn_ratio is not None:
        ratio_ok = d1 < nn_ratio * d2
        if octaves_b is not None:
            same_level = octaves_b[best] == octaves_b[best2]
            ratio_ok = ratio_ok | ~same_level
        ok = ok & ratio_ok
    if mutual:
        ok = _mutual_best(d, best, ok)
    if angles_a is not None:
        ok = rotation_consistency(angles_a, angles_b[best], ok)
    return MatchResult(idx=best, dist=d1, ok=ok)


def match_window(feats_a, feats_b, radius: float = 100.0, max_dist: float = float(C.TH_LOW),
                 nn_ratio: float = 0.9, check_rotation: bool = True) -> MatchResult:
    """Windowed search for monocular initialization
    (SearchForInitialization: windowSize 100, mfNNratio 0.9, level 0
    only, mutual best, rotation check)."""
    dist = hamming_from_packed(feats_a.desc, feats_b.desc)
    dxy = feats_a.xy[:, None, :] - feats_b.xy[None, :, :]
    close = torch.sum(dxy * dxy, dim=-1) <= radius * radius
    lvl0 = (feats_a.octave[:, None] == 0) & (feats_b.octave[None, :] == 0)
    mask = close & lvl0 & feats_a.valid[:, None] & feats_b.valid[None, :]
    return match_generic(dist, mask, max_dist, nn_ratio, mutual=True,
                         angles_a=feats_a.angle if check_rotation else None,
                         angles_b=feats_b.angle)


def match_projection(proj_xy, proj_valid, proj_desc, proj_octave, feats, radius,
                     scale_factors, max_dist: float = float(C.TH_HIGH), nn_ratio=None,
                     octave_band: tuple = (-1, 1), angles_p=None) -> MatchResult:
    """Project candidate points into a frame and match within a
    scale-aware radius (SearchByProjection family)."""
    if isinstance(radius, torch.Tensor):
        radius = radius.to(torch.float32).expand(proj_xy.shape[:1])
    else:
        radius = torch.full(proj_xy.shape[:1], float(radius), dtype=torch.float32,
                            device=proj_xy.device)
    lvl = torch.clamp(proj_octave, 0, scale_factors.shape[0] - 1).long()
    r_eff = radius * scale_factors[lvl]
    dist = hamming_from_packed(proj_desc, feats.desc)
    dxy = proj_xy[:, None, :] - feats.xy[None, :, :]
    close = torch.sum(dxy * dxy, dim=-1) <= (r_eff * r_eff)[:, None]
    d_oct = feats.octave[None, :] - proj_octave[:, None]
    oct_ok = (d_oct >= octave_band[0]) & (d_oct <= octave_band[1])
    mask = close & oct_ok & proj_valid[:, None] & feats.valid[None, :]
    return match_generic(dist, mask, max_dist, nn_ratio, angles_a=angles_p,
                         angles_b=feats.angle, octaves_b=feats.octave)


def match_nodes(desc_a, nodes_a, valid_a, feats_b, nodes_b,
                max_dist: float = float(C.TH_LOW), nn_ratio: float = 0.7,
                angles_a=None) -> MatchResult:
    """BoW-node-gated matching (SearchByBoW)."""
    dist = hamming_from_packed(desc_a, feats_b.desc)
    mask = ((nodes_a[:, None] == nodes_b[None, :]) & (nodes_a[:, None] >= 0)
            & valid_a[:, None] & feats_b.valid[None, :])
    return match_generic(dist, mask, max_dist, nn_ratio,
                         angles_a=angles_a, angles_b=feats_b.angle)


def epipolar_distance2(F12, xy1, xy2):
    """[N,M] squared point-to-epiline distance of xy2 vs the lines of xy1."""
    ones = torch.ones(xy1.shape[:1] + (1,), dtype=xy1.dtype, device=xy1.device)
    h1 = torch.cat([xy1, ones], dim=-1)
    lines = h1 @ F12
    a, b, c = lines[:, 0], lines[:, 1], lines[:, 2]
    num = a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1] + c[:, None]
    den = a * a + b * b
    return (num * num) / torch.clamp(den, min=1e-12)[:, None]


def match_epipolar(feats_a, feats_b, F12, sigma2_levels, unmatched_a, unmatched_b,
                   max_dist: float = float(C.TH_LOW), check_rotation: bool = False
                   ) -> MatchResult:
    """Epipolar-constrained search for triangulation
    (SearchForTriangulation): chi2(1) band of 3.84 sigma^2, both features
    unmatched, mutual best."""
    dist = hamming_from_packed(feats_a.desc, feats_b.desc)
    ed2 = epipolar_distance2(F12, feats_a.xy, feats_b.xy)
    lvl = torch.clamp(feats_b.octave, 0, sigma2_levels.shape[0] - 1).long()
    s2 = sigma2_levels[lvl]
    epi_ok = ed2 < 3.84 * s2[None, :]
    mask = (epi_ok & (unmatched_a & feats_a.valid)[:, None]
            & (unmatched_b & feats_b.valid)[None, :])
    return match_generic(dist, mask, max_dist, nn_ratio=None, mutual=True,
                         angles_a=feats_a.angle if check_rotation else None,
                         angles_b=feats_b.angle)
