"""Batched RANSAC solvers — the port of `orb_slam2_comment_tpu/ops/ransac.py`:
EPnP RANSAC for relocalization (PnPsolver) and 3-point Horn Sim3 RANSAC
for loop alignment (Sim3Solver). Every hypothesis is generated, solved and
scored at once.

Minimal sets come from `ops/rng.py`, which reproduces JAX's
`categorical(PRNGKey(seed), ...)` draws index for index. The small batched
`eigh`/`svd` calls are sign-ambiguous between LAPACK, cuSOLVER and XLA;
the math makes every such sign irrelevant: EPnP's control points and
null-space basis enter through products that the cheirality flip fixes,
the DLT tries both null-vector signs, SVD factors flip in pairs, and a
Horn quaternion and its negation give the same rotation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import rng


def _sample_indices(seed: int, n_hyp: int, set_size: int, valid):
    """[n_hyp, set_size] indices drawn from the valid entries (duplicates
    within a hypothesis are tolerated; degenerate sets score poorly)."""
    return rng.masked_categorical(rng.prng_key(seed), valid, (n_hyp, set_size))


def _solve(A, b):
    return torch.linalg.solve_ex(A, b)[0]


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_EPNP_B10 = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
             (0, 3), (1, 3), (2, 3), (3, 3))


def _epnp_poses(Xs, us, K):
    """Batched EPnP: [H,S,3] world points, [H,S,2] pixels -> (R [3H,3,3],
    t [3H,3]), one Gauss-Newton-refined pose per beta-approximation case."""
    fx, fy, cx, cy = K
    H, S = Xs.shape[0], Xs.shape[1]
    dev, dt = Xs.device, Xs.dtype
    # 1. control points: centroid + principal directions
    c0 = torch.mean(Xs, dim=1)
    A = Xs - c0[:, None, :]
    cov = torch.einsum("hsi,hsj->hij", A, A)
    lam, V = torch.linalg.eigh(cov)
    sig = torch.sqrt(torch.clamp(lam, min=1e-10) / S)
    cws = torch.cat([c0[:, None, :], c0[:, None, :] + sig[..., None] * V.transpose(1, 2)], dim=1)
    # 2. barycentric coordinates: [cws^T; 1] alpha = [X; 1]
    Cm = torch.cat([cws.transpose(1, 2), torch.ones((H, 1, 4), dtype=dt, device=dev)], dim=1)
    Cm = Cm + 1e-9 * torch.eye(4, dtype=dt, device=dev)
    Xh = torch.cat([Xs, torch.ones((H, S, 1), dtype=dt, device=dev)], dim=-1)
    alpha = _solve(Cm[:, None], Xh[..., None])[..., 0]            # [H,S,4]
    # 3. M and its 4 smallest right singular vectors
    z = torch.zeros((H, S, 4), dtype=dt, device=dev)
    r1 = torch.stack([alpha * fx, z, alpha * (cx - us[..., :1])], dim=-1).reshape(H, S, 12)
    r2 = torch.stack([z, alpha * fy, alpha * (cy - us[..., 1:2])], dim=-1).reshape(H, S, 12)
    M = torch.cat([r1, r2], dim=1)
    MtM = torch.einsum("hki,hkj->hij", M, M)
    _, evec = torch.linalg.eigh(MtM)
    v = evec[..., :4].transpose(1, 2).reshape(H, 4, 4, 3)          # [H, k, ctrl, 3]
    # 4. rho and L
    dcw = torch.stack([cws[:, a] - cws[:, b] for a, b in _EPNP_PAIRS], dim=1)
    rho = torch.sum(dcw * dcw, dim=-1)                             # [H,6]
    dv = torch.stack([v[:, :, a] - v[:, :, b] for a, b in _EPNP_PAIRS], dim=1)
    cols = []
    for a, b in _EPNP_B10:
        dot = torch.sum(dv[:, :, a] * dv[:, :, b], dim=-1)
        cols.append(dot if a == b else 2.0 * dot)
    L = torch.stack(cols, dim=-1)                                  # [H,6,10]

    def lsq(cols_idx):
        Lc = L[..., list(cols_idx)]
        AtA = torch.einsum("hki,hkj->hij", Lc, Lc)
        AtA = AtA + 1e-9 * torch.eye(len(cols_idx), dtype=dt, device=dev)
        Atb = torch.einsum("hki,hk->hi", Lc, rho)
        return _solve(AtA, Atb[..., None])[..., 0]

    def sqrt_abs(x):
        return torch.sqrt(torch.abs(x))

    zH = torch.zeros(H, dtype=dt, device=dev)
    b4 = lsq((0, 1, 3, 6))
    s1 = torch.sign(b4[:, 0:1])
    beta1_1 = sqrt_abs(b4[:, 0])
    denom = torch.where(beta1_1 < 1e-8, torch.ones_like(beta1_1), beta1_1)
    beta_c1 = torch.cat([beta1_1[:, None], s1 * b4[:, 1:] / denom[:, None]], dim=1)
    b3 = lsq((0, 1, 2))
    beta1_2 = sqrt_abs(b3[:, 0]) * torch.sign(b3[:, 1])
    beta2_2 = torch.where(torch.sign(b3[:, 2]) == torch.sign(b3[:, 0]), sqrt_abs(b3[:, 2]), zH)
    beta_c2 = torch.stack([beta1_2, beta2_2, zH, zH], dim=1)
    b5 = lsq((0, 1, 2, 3, 4))
    beta1_3 = sqrt_abs(b5[:, 0]) * torch.sign(b5[:, 1])
    beta2_3 = torch.where(torch.sign(b5[:, 2]) == torch.sign(b5[:, 0]), sqrt_abs(b5[:, 2]), zH)
    d3 = torch.where(torch.abs(beta1_3) < 1e-8, torch.ones_like(beta1_3), beta1_3)
    beta_c3 = torch.stack([beta1_3, beta2_3, b5[:, 3] / d3, zH], dim=1)
    eye4 = torch.eye(4, dtype=dt, device=dev)

    def gauss_newton(b):
        """5 iterations on f(beta) = L beta10(beta) - rho."""
        for _ in range(5):
            prods = torch.stack([b[:, a] * b[:, c] for a, c in _EPNP_B10], dim=1)
            jcols = []
            for a, c in _EPNP_B10:
                row = [zH] * 4
                row[a] = row[a] + b[:, c]
                row[c] = row[c] + b[:, a]
                jcols.append(torch.stack(row, dim=1))
            J10 = torch.stack(jcols, dim=1)                        # [H,10,4]
            r = torch.einsum("hkc,hc->hk", L, prods) - rho
            Jf = torch.einsum("hkc,hcj->hkj", L, J10)
            AtA = torch.einsum("hki,hkj->hij", Jf, Jf) + 1e-8 * eye4
            Atb = torch.einsum("hki,hk->hi", Jf, r)
            b = b - _solve(AtA, Atb[..., None])[..., 0]
        return b

    Rs, ts = [], []
    for beta in (beta_c1, beta_c2, beta_c3):
        beta = gauss_newton(beta)
        cc = torch.einsum("hk,hkcj->hcj", beta, v)
        pcs = torch.einsum("hsc,hcj->hsj", alpha, cc)
        flip = torch.sum(pcs[..., 2], dim=1) < 0                   # cheirality
        pcs = torch.where(flip[:, None, None], -pcs, pcs)
        R, _, t = _horn_batch(pcs, Xs, fix_scale=True)
        Rs.append(R)
        ts.append(t)
    return torch.cat(Rs, dim=0), torch.cat(ts, dim=0)


def pnp_ransac(Xw, uv, octave, valid, sigma2_levels, K, seed: int = 0, n_hyp: int = 128,
               set_size: int = 4) -> PnPResult:
    """Batched EPnP RANSAC (PnPsolver): minimal sets of 4, three EPnP
    cases per hypothesis, chi2(2 dof) inliers, weighted-DLT refinement on
    the best hypothesis' inlier set (PnPsolver::Refine)."""
    fx, fy, cx, cy = K
    idx = _sample_indices(seed, n_hyp, set_size, valid)

    def dlt_poses(Xs, us, wgt):
        """Weighted DLT -> (R, t) per hypothesis, both null-vector signs;
        the 3-D points are Hartley-normalized per hypothesis."""
        wsum = torch.clamp(torch.sum(wgt, dim=1, keepdim=True), min=1e-9)
        mu = torch.sum(Xs * wgt[..., None], dim=1, keepdim=True) / wsum[..., None]
        Xc_ = Xs - mu
        scale = torch.sqrt(torch.sum(torch.sum(Xc_ * Xc_, -1) * wgt, dim=1) / wsum[:, 0])
        scale = torch.clamp(scale, min=1e-6)
        Xn = Xc_ / scale[:, None, None]
        xn = (us[..., 0] - cx) / fx
        yn = (us[..., 1] - cy) / fy
        Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)
        z4 = torch.zeros_like(Xh)
        r1 = torch.cat([Xh, z4, -xn[..., None] * Xh], dim=-1)
        r2 = torch.cat([z4, Xh, -yn[..., None] * Xh], dim=-1)
        A = torch.cat([r1, r2], dim=1) * torch.cat([wgt, wgt], dim=1)[..., None] ** 0.5
        AtA = torch.einsum("hki,hkj->hij", A, A)
        _, vecs = torch.linalg.eigh(AtA)
        P = vecs[..., 0].reshape(-1, 3, 4)
        P = torch.cat([P, -P], dim=0)
        M = P[:, :, :3]
        U, Sv, Vt = torch.linalg.svd(M)
        detUV = torch.linalg.det(U @ Vt)
        Vt_fix = Vt.clone()
        Vt_fix[:, 2, :] = Vt[:, 2, :] * torch.sign(detUV)[:, None]
        R = U @ Vt_fix
        s = torch.clamp(torch.mean(Sv, dim=-1), min=1e-12)
        t_n = P[:, :, 3] / s[:, None]
        mu2 = torch.cat([mu[:, 0], mu[:, 0]], dim=0)
        scale2 = torch.cat([scale, scale], dim=0)
        t = scale2[:, None] * t_n - torch.einsum("hij,hj->hi", R, mu2)
        return R, t

    lvl = torch.clamp(octave, 0, sigma2_levels.shape[0] - 1).long()
    s2 = sigma2_levels[lvl]

    def score(R, t):
        Xc = torch.einsum("hij,nj->hni", R, Xw) + t[:, None, :]
        zc = torch.clamp(Xc[..., 2], min=1e-9)
        pu = fx * Xc[..., 0] / zc + cx
        pv = fy * Xc[..., 1] / zc + cy
        du = pu - uv[None, :, 0]
        dv = pv - uv[None, :, 1]
        chi2 = (du * du + dv * dv) / s2[None, :]
        inl = (chi2 < 5.991) & (Xc[..., 2] > 0) & valid[None, :]
        return inl, torch.sum(inl, dim=1)

    R, t = _epnp_poses(Xw[idx], uv[idx], K)
    inl, scores = score(R, t)
    best = torch.argmax(scores)
    w_ref = inl[best].to(torch.float32)
    R2, t2 = dlt_poses(Xw[None], uv[None], w_ref[None])
    inl2, scores2 = score(R2, t2)
    best2 = torch.argmax(scores2)
    use_refined = scores2[best2] >= scores[best]
    R_f = torch.where(use_refined, R2[best2], R[best])
    t_f = torch.where(use_refined, t2[best2], t[best])
    inl_f = torch.where(use_refined, inl2[best2], inl[best])
    n_inl = torch.where(use_refined, scores2[best2], scores[best])
    return PnPResult(Tcw=geo.make_T(R_f, t_f), inliers=inl_f, n_inliers=n_inl, ok=n_inl >= 10)


class Sim3Result(NamedTuple):
    S12: torch.Tensor       # [4,4] Sim3 mapping cam2 coords to cam1
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _horn_batch(X1, X2, fix_scale: bool):
    """Closed-form absolute orientation per hypothesis, X1 ~ s R X2 + t
    (Horn 1987 quaternion method, Sim3Solver::ComputeSim3)."""
    c1 = torch.mean(X1, dim=1, keepdim=True)
    c2 = torch.mean(X2, dim=1, keepdim=True)
    q1 = X1 - c1
    q2 = X2 - c2
    M = torch.einsum("hsi,hsj->hij", q2, q1)
    Sxx, Sxy, Sxz = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    Syx, Syy, Syz = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    Szx, Szy, Szz = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., -1]                                   # (w, x, y, z)
    R = geo.quat_to_rot(torch.stack([q[:, 1], q[:, 2], q[:, 3], q[:, 0]], dim=-1))
    if fix_scale:
        s = torch.ones(X1.shape[0], dtype=X1.dtype, device=X1.device)
    else:
        s = torch.sqrt(torch.sum(q1 * q1, dim=(1, 2))
                       / torch.clamp(torch.sum(q2 * q2, dim=(1, 2)), min=1e-12))
    t = c1[:, 0, :] - s[:, None] * torch.einsum("hij,hj->hi", R, c2[:, 0, :])
    return R, s, t


def sim3_ransac(Xc1, Xc2, uv1, uv2, octave1, octave2, valid, sigma2_levels, K1, K2,
                fix_scale: bool = False, seed: int = 0, n_hyp: int = 512,
                min_inliers: int = 20) -> Sim3Result:
    """Batched 3-point Horn RANSAC with the mutual-reprojection inlier
    check (Sim3Solver::iterate + CheckInliers, chi2 gate 9.21)."""
    idx = _sample_indices(seed, n_hyp, 3, valid)
    R, s, t = _horn_batch(Xc1[idx], Xc2[idx], fix_scale)

    def proj(Kt, X):
        fx, fy, cx, cy = Kt
        zc = torch.clamp(X[..., 2], min=1e-9)
        return torch.stack([fx * X[..., 0] / zc + cx, fy * X[..., 1] / zc + cy], -1)

    X1_pred = s[:, None, None] * torch.einsum("hij,nj->hni", R, Xc2) + t[:, None, :]
    Rt = R.transpose(1, 2)
    X2_pred = torch.einsum("hij,hnj->hni", Rt, (Xc1[None] - t[:, None, :])) / s[:, None, None]
    e1 = proj(K1, X1_pred) - uv1[None]
    e2 = proj(K2, X2_pred) - uv2[None]
    nl = sigma2_levels.shape[0]
    s2_1 = sigma2_levels[torch.clamp(octave1, 0, nl - 1).long()]
    s2_2 = sigma2_levels[torch.clamp(octave2, 0, nl - 1).long()]
    c1 = torch.sum(e1 * e1, -1) / s2_1[None]
    c2 = torch.sum(e2 * e2, -1) / s2_2[None]
    inl = (c1 < 9.21) & (c2 < 9.21) & valid[None]
    scores = torch.sum(inl, dim=1)
    best = torch.argmax(scores)
    n_inl = scores[best]
    return Sim3Result(S12=geo.sim3_make(R[best], t[best], s[best]), inliers=inl[best],
                      n_inliers=n_inl, ok=n_inl >= min_inliers)
