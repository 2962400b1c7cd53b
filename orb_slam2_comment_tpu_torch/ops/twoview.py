"""Monocular two-view bootstrap — the port of
`orb_slam2_comment_tpu/ops/twoview.py` (the reference's Initializer,
src/Initializer.cc): 200 RANSAC sets scored for both a homography and a
fundamental matrix, each model as one batched program; model selection by
RH = SH / (SH + SF) > 0.40; pose recovery (E = K^T F K -> 4 candidates,
or the 8-solution Faugeras decomposition of H) and a cheirality vote with
the reference's gates (a clear winner, >= 50 triangulated points, 90% of
the inliers, parallax >= 1 deg).

Minimal sets come from `rng.masked_categorical`, index for index JAX's
`categorical(PRNGKey(seed), ...)`. The small batched `eigh` and `svd`
calls are sign-ambiguous between LAPACK, cuSOLVER and XLA, and no sign
matters here:
- F and H are homogeneous, so their sign drops out of every score (the
  epipolar distances are ratios of squares of F, the transfer errors
  divide by H's third row);
- flipping one singular pair (u_i, v_i) of E or of A together permutes the
  4 or 8 pose candidates and leaves their set unchanged (for E: the third
  pair swaps +t and -t, the first or second swaps U W V^T and U W^T V^T;
  for A: det(U) det(V) is unchanged and the flip maps eps1, eps3 onto
  other sign pairs);
- the winner `argmax(n_good)` is then the same candidate whenever the
  solution is accepted, because a tie fails `distinct`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import rng
from orb_slam2_comment_tpu_torch.ops.scatter import const


def _normalize(pts, mask):
    """Hartley normalization (Initializer::Normalize): zero mean, unit mean
    absolute deviation. Returns (normalized pts, T [3,3])."""
    wsum = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(pts * mask[:, None], dim=0) / wsum
    d = torch.abs(pts - mean) * mask[:, None]
    md = torch.sum(d, dim=0) / wsum
    s = 1.0 / torch.clamp(md, min=1e-9)
    one, zero = torch.ones_like(s[0]), torch.zeros_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


class TwoViewResult(NamedTuple):
    ok: torch.Tensor          # scalar bool
    R21: torch.Tensor         # [3,3] rotation frame 1 -> frame 2
    t21: torch.Tensor         # [3]
    X: torch.Tensor           # [N,3] triangulated points (frame-1 coords)
    good: torch.Tensor        # [N] bool triangulated + inlier
    is_homography: torch.Tensor
    # diagnostics
    n_good: torch.Tensor
    n_inliers: torch.Tensor
    parallax_deg: torch.Tensor
    distinct: torch.Tensor


def _h(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _smallest_eigvec(A):
    """[H,8,9] -> [H,3,3]: the null vector of A by the smallest eigenvector
    of A^T A (eigh sorts eigenvalues ascending in both frameworks)."""
    AtA = torch.einsum("hki,hkj->hij", A, A)
    return torch.linalg.eigh(AtA)[1][..., 0].reshape(-1, 3, 3)


def _fundamentals(p1n, p2n, idx8, T1, T2):
    """Batched normalized 8-point F21 with rank 2 enforced, denormalized."""
    a1, a2 = p1n[idx8], p2n[idx8]
    A = torch.stack([
        a2[..., 0] * a1[..., 0], a2[..., 0] * a1[..., 1], a2[..., 0],
        a2[..., 1] * a1[..., 0], a2[..., 1] * a1[..., 1], a2[..., 1],
        a1[..., 0], a1[..., 1], torch.ones_like(a1[..., 0])], dim=-1)   # [H, 8, 9]
    Fn = _smallest_eigvec(A)
    U, S, Vt = torch.linalg.svd(Fn)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    Fn = U @ (S[:, :, None] * Vt)
    return torch.einsum("ij,hjk,kl->hil", T2.T, Fn, T1)


def score_fundamental(F, xy1, xy2, valid, inv_s2: float):
    """Symmetric epipolar chi2 score (CheckFundamental): (score [H],
    inliers [H, N])."""
    h1a, h2a = _h(xy1), _h(xy2)
    l2 = torch.einsum("hij,nj->hni", F, h1a)               # line in image 2
    l1 = torch.einsum("hji,nj->hni", F, h2a)               # line in image 1
    num2 = torch.sum(l2 * h2a[None], dim=-1)
    num1 = torch.sum(l1 * h1a[None], dim=-1)
    d2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    chi1, chi2 = d1 * inv_s2, d2 * inv_s2
    zero = torch.zeros_like(chi1)
    inl = (chi1 < 3.841) & (chi2 < 3.841) & valid[None]
    per = (torch.where(chi1 < 3.841, 5.991 - chi1, zero)
           + torch.where(chi2 < 3.841, 5.991 - chi2, zero))
    return torch.sum(torch.where(valid[None], per, zero), dim=1), inl


def _homographies(p1n, p2n, idx4, T1, T2):
    """Batched normalized 4-point DLT H21, denormalized."""
    b1, b2 = p1n[idx4], p2n[idx4]
    o = torch.ones_like(b1[..., 0])
    z = torch.zeros_like(o)
    r1 = torch.stack([b1[..., 0], b1[..., 1], o, z, z, z,
                      -b2[..., 0] * b1[..., 0], -b2[..., 0] * b1[..., 1], -b2[..., 0]], dim=-1)
    r2 = torch.stack([z, z, z, b1[..., 0], b1[..., 1], o,
                      -b2[..., 1] * b1[..., 0], -b2[..., 1] * b1[..., 1], -b2[..., 1]], dim=-1)
    Hn = _smallest_eigvec(torch.cat([r1, r2], dim=1))
    return torch.einsum("ij,hjk,kl->hil", torch.linalg.inv_ex(T2)[0], Hn, T1)


def _dehomogenize(p):
    z = p[..., 2]
    w = (torch.clamp(torch.abs(z), min=1e-9)
         * torch.sign(torch.where(z == 0, torch.ones_like(z), z)))
    return p[..., :2] / w[..., None]


def score_homography(Hm, xy1, xy2, valid, inv_s2: float):
    """Symmetric transfer error (CheckHomography): (score [H], inliers
    [H, N])."""
    h1a, h2a = _h(xy1), _h(xy2)
    p12 = _dehomogenize(torch.einsum("hij,nj->hni", Hm, h1a))
    p21 = _dehomogenize(torch.einsum("hij,nj->hni", torch.linalg.inv_ex(Hm)[0], h2a))
    e2 = torch.sum((p12 - xy2[None]) ** 2, dim=-1) * inv_s2
    e1 = torch.sum((p21 - xy1[None]) ** 2, dim=-1) * inv_s2
    zero = torch.zeros_like(e1)
    inl = (e1 < 5.991) & (e2 < 5.991) & valid[None]
    per = torch.where(e1 < 5.991, 5.991 - e1, zero) + torch.where(e2 < 5.991, 5.991 - e2, zero)
    return torch.sum(torch.where(valid[None], per, zero), dim=1), inl


def _Rt(R, t):
    return torch.cat([R, (t / torch.clamp(torch.linalg.norm(t), min=1e-9))[:, None]], dim=1)


def candidates_from_E(Ue, Vte):
    """The 4 (R | t) candidates [4,3,4] of E = U diag(1,1,0) V^T."""
    W = const(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), Ue.device, Ue.dtype)

    def mk_R(M):
        R = Ue @ M @ Vte
        return R * torch.sign(torch.linalg.det(R))

    R1, R2 = mk_R(W), mk_R(W.T)
    tE = Ue[:, 2]
    return torch.stack([_Rt(R1, tE), _Rt(R1, -tE), _Rt(R2, tE), _Rt(R2, -tE)])


def candidates_from_A(Ua, Sa, Vta):
    """The 8 Faugeras (R | t) candidates [8,3,4] of A = K^-1 H K = U S V^T,
    in the reference's order (eps1, eps3 in (1, -1) x (1, -1), the d' = d2
    solution before the d' = -d2 one)."""
    s_det = torch.linalg.det(Ua) * torch.linalg.det(Vta)
    d1, d2, d3 = Sa[0], Sa[1], Sa[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)
    cands = []
    for eps1 in (1.0, -1.0):
        for eps3 in (1.0, -1.0):
            # d' = d2: a rotation about y
            st = (d1 - d3) * x1 * x3 * eps1 * eps3 / d2
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2
            Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                              torch.stack([st, zero, ct])])
            tp = torch.stack([eps1 * x1, zero, -eps3 * x3]) * (d1 - d3)
            cands.append(_Rt(s_det * Ua @ Rp @ Vta, Ua @ tp))
            # d' = -d2: a rotation about y with a reflection
            sp = (d1 + d3) * x1 * x3 * eps1 * eps3 / d2
            cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2
            Rn = torch.stack([torch.stack([cp, zero, sp]), torch.stack([zero, -one, zero]),
                              torch.stack([sp, zero, -cp])])
            tn = torch.stack([eps1 * x1, zero, eps3 * x3]) * (d1 + d3)
            cands.append(_Rt(s_det * Ua @ Rn @ Vta, Ua @ tn))
    return torch.stack(cands)


def check_rt(cands, inliers, xy1, xy2, K, sigma: float):
    """The cheirality vote (CheckRT) over candidates [C,3,4]: triangulate
    every inlier pair, keep points in front of both cameras, reprojecting
    within 2 sigma, with parallax. Returns (n_good [C], X [C,N,3],
    good [C,N], parallax in degrees [C,N], 0 where not good)."""
    fx, fy, cx, cy = K
    dev, dt = cands.device, cands.dtype
    nc, n = cands.shape[0], xy1.shape[0]
    R, t = cands[:, :, :3], cands[:, :, 3]
    Km = const(((fx, 0.0, cx), (0.0, fy, cy), (0.0, 0.0, 1.0)), dev, dt)
    P1 = (Km @ torch.eye(4, dtype=dt, device=dev)[:3]).expand(nc, 1, 3, 4)
    T21 = geo.make_T(R, t)
    P2 = (Km @ T21[:, :3])[:, None]
    X = geo.triangulate_linear(P1, P2, xy1.expand(nc, n, 2), xy2.expand(nc, n, 2))
    Xc2 = geo.transform_points(T21[:, None], X)
    r2v = X - (-(R.transpose(1, 2) @ t[..., None])[..., 0])[:, None, :]
    cosp = torch.sum(X * r2v, -1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2v, dim=-1), min=1e-9)
    e1p = xy1 - geo.project(K, X)
    e2p = xy2 - geo.project(K, Xc2)
    s2 = 4.0 * sigma * sigma
    okp = (inliers & (X[..., 2] > 0) & (Xc2[..., 2] > 0)
           & (torch.sum(e1p * e1p, -1) < s2) & (torch.sum(e2p * e2p, -1) < s2)
           & (cosp < 0.99998))
    par = torch.where(okp, torch.rad2deg(torch.arccos(torch.clamp(cosp, -1, 1))),
                      torch.zeros_like(cosp))
    return torch.sum(okp, dim=-1), X, okp, par


def two_view_init(xy1, xy2, valid, K, seed: int = 0, n_hyp: int = C.INIT_RANSAC_ITERS,
                  sigma: float = C.INIT_SIGMA) -> TwoViewResult:
    """xy1, xy2 [N,2] matched pixels in frames 1 and 2, valid [N] bool."""
    fx, fy, cx, cy = K
    dev, dt = xy1.device, xy1.dtype
    idx8 = rng.masked_categorical(rng.prng_key(seed), valid, (n_hyp, 8))
    vf = valid.to(dt)
    p1n, T1 = _normalize(xy1, vf)
    p2n, T2 = _normalize(xy2, vf)
    inv_s2 = 1.0 / (sigma * sigma)

    F_all = _fundamentals(p1n, p2n, idx8, T1, T2)
    score_F, inl_F = score_fundamental(F_all, xy1, xy2, valid, inv_s2)
    bF = torch.argmax(score_F)
    H_all = _homographies(p1n, p2n, idx8[:, :4], T1, T2)
    score_H, inl_H = score_homography(H_all, xy1, xy2, valid, inv_s2)
    bH = torch.argmax(score_H)
    SF, SH = score_F[bF], score_H[bH]

    RH = SH / torch.clamp(SH + SF, min=1e-9)
    use_H = RH > C.INIT_MODEL_SELECT_RH

    Km = const(((fx, 0.0, cx), (0.0, fy, cy), (0.0, 0.0, 1.0)), dev, dt)
    Kinv = torch.linalg.inv_ex(Km)[0]
    Ue, _, Vte = torch.linalg.svd(Km.T @ F_all[bF] @ Km)
    cand_F = candidates_from_E(Ue, Vte)
    cand_H = candidates_from_A(*torch.linalg.svd(Kinv @ H_all[bH] @ Km))
    # F's 4 candidates padded to 8 so both models share one vote; the
    # duplicate half is masked out (it would defeat the uniqueness check)
    cands = torch.where(use_H, cand_H, torch.cat([cand_F, cand_F]))
    cand_valid = use_H | (torch.arange(8, device=dev) < 4)
    inliers = torch.where(use_H, inl_H[bH], inl_F[bF])

    n_good, Xs, goods, pars = check_rt(cands, inliers, xy1, xy2, K, sigma)
    n_good = torch.where(cand_valid, n_good, torch.full_like(n_good, -1))
    best_c = torch.argmax(n_good)
    n_best = n_good[best_c]
    second = torch.sort(n_good).values[-2]
    distinct = n_best > 1.33 * torch.clamp(second, min=1)
    # parallax of the ~50th best point
    par_sorted = torch.sort(torch.where(goods[best_c], pars[best_c],
                                        torch.zeros_like(pars[best_c]))).values
    med_par = par_sorted[max(par_sorted.shape[0] - 50, 0)]
    n_inl_total = torch.sum(inliers)
    ok = ((n_best >= C.INIT_MIN_TRIANGULATED)
          # 90% of the RANSAC inliers must triangulate cleanly
          # (nMinGood = max(0.9 N, minTriangulated), Initializer.cc:504,721)
          & (n_best > 0.9 * n_inl_total) & distinct
          & (med_par > C.INIT_MIN_PARALLAX_DEG))
    Rt = cands[best_c]
    return TwoViewResult(ok=ok, R21=Rt[:, :3], t21=Rt[:, 3], X=Xs[best_c], good=goods[best_c],
                         is_homography=use_H, n_good=n_best, n_inliers=n_inl_total,
                         parallax_deg=med_par, distinct=distinct)
