"""Levenberg-Marquardt solvers — the port of `orb_slam2_comment_tpu/ops/optim.py`:
pose-only LM, the chunked local BA, and loop closing's Sim3 optimization,
essential graph and chunked global BA.

- `pose_optimize`: motion-only BA (Optimizer::PoseOptimization). The plain
  version `pose_optimize_plain` is the reference's XLA branch; CUDA
  tensors go to kernel K3 (`ops/lm_cuda.py`).
- Local BA (`lba_init`, `lba_iterate`, `lba_prune`, `lba_finalize`, and
  `local_bundle_adjustment` over all four) with a Schur complement on the
  points. On a camera-major window (`cam_major=True`) one linearization is
  `build_system_plain` (the reference's cam-major build_system_xla) or, for
  CUDA tensors, kernel K4 (`ops/lba_cuda.py`); on any other layout it is
  `build_system_ragged`, plain PyTorch on either device.
- `reduce`: the global BA and both pose-graph solvers take a hook applied
  to every sum over the observation or edge axis (`parallel/dist_ba.py`
  passes an all-reduce; None is the identity).

`lax.fori_loop` / `while_loop` / `cond` become Python loops and `if`s; the
local-BA loop reads one or two scalars per iteration on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops.scatter import SegmentPlan


def _residual_unified(Tcw, Xw, obs, K, bf):
    """(u, v, ur) residual and camera-frame depth; Tcw broadcasts."""
    Xc = geo.transform_points(Tcw, Xw)
    pred = geo.project_stereo(K, bf, Xc)
    return obs - pred, Xc[..., 2]


def _edge_jacobians(Tcw, Xw, obs, K, bf):
    """Residual + analytic Jacobians wrt the camera tangent (6, [rho, phi])
    and the point (3); Tcw [..., 4, 4] broadcasts against Xw [..., 3]."""
    fx, fy, cx, cy = K
    Xc = geo.transform_points(Tcw, Xw)
    pred = geo.project_stereo(K, bf, Xc)
    r = obs - pred
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    invz = 1.0 / torch.clamp(z, min=1e-9)
    invz2 = invz * invz
    zr = torch.zeros_like(x)
    D00 = -fx * invz
    D02 = fx * x * invz2
    D11 = -fy * invz
    D12 = fy * y * invz2
    D20 = -fx * invz
    D22 = (fx * x - bf) * invz2
    M00 = -D02 * y
    M01 = -D00 * z + D02 * x
    M02 = D00 * y
    M10 = D11 * z - D12 * y
    M11 = D12 * x
    M12 = -D11 * x
    M20 = -D22 * y
    M21 = -D20 * z + D22 * x
    M22 = D20 * y
    Jc = torch.stack([
        torch.stack([D00, zr, D02, -M00, -M01, -M02], dim=-1),
        torch.stack([zr, D11, D12, -M10, -M11, -M12], dim=-1),
        torch.stack([D20, zr, D22, -M20, -M21, -M22], dim=-1),
    ], dim=-2)
    R = Tcw[..., :3, :3]
    R0, R1, R2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
    Jp = torch.stack([
        D00[..., None] * R0 + D02[..., None] * R2,
        D11[..., None] * R1 + D12[..., None] * R2,
        D20[..., None] * R0 + D22[..., None] * R2,
    ], dim=-2)
    return r, Jc, Jp, z


def _edge_weights(octave, is_stereo, valid, inv_sigma2_levels):
    """Per-edge information scale (0 where invalid) and component mask."""
    lvl = torch.clamp(octave, 0, inv_sigma2_levels.shape[0] - 1).long()
    inv_s2 = inv_sigma2_levels[lvl]
    comp = torch.stack(
        [torch.ones_like(inv_s2), torch.ones_like(inv_s2), is_stereo.to(inv_s2.dtype)],
        dim=-1)
    return torch.where(valid, inv_s2, torch.zeros_like(inv_s2)), comp


def _edge_chi2(r, inv_s2, comp):
    return inv_s2 * torch.sum(comp * r * r, dim=-1)


def _chi2_th(is_stereo):
    return torch.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO).to(torch.float32)


def _huber_delta(is_stereo):
    return torch.where(is_stereo, C.HUBER_STEREO, C.HUBER_MONO).to(torch.float32)


def _identity(t):
    """The `reduce` hook of a single process."""
    return t


# ---------------------------------------------------------------------------
# pose-only optimization
# ---------------------------------------------------------------------------

class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # 0-d int


def pose_optimize_plain(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels,
                        K, bf, rounds: int = C.POSE_OPT_ROUNDS,
                        iters: int = C.POSE_OPT_ITS_PER_ROUND) -> PoseOptResult:
    """Plain version of K3: the reference's XLA branch of pose_optimize —
    4 rounds x 10 LM iterations, Huber in the first two, chi2
    reclassification between rounds."""
    chi2_th = _chi2_th(is_stereo)
    delta = _huber_delta(is_stereo)
    eye6 = torch.eye(6, dtype=torch.float32, device=Xw.device)

    def robust_cost(r, inv_s2, comp, robust):
        chi2 = _edge_chi2(r, inv_s2, comp)
        if not robust:
            return torch.sum(chi2)
        d2 = delta * delta
        rho = torch.where(chi2 <= d2, chi2,
                          2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d2)
        return torch.sum(rho)

    def lm_round(T, inlier_mask, robust):
        inv_s2, comp = _edge_weights(octave, is_stereo, valid & inlier_mask, inv_sigma2_levels)
        r0, _ = _residual_unified(T, Xw, obs, K, bf)
        cost = robust_cost(r0, inv_s2, comp, robust)
        lam = torch.full((), 1e-3, dtype=torch.float32, device=Xw.device)
        for _ in range(iters):
            r, Jc, _, _ = _edge_jacobians(T, Xw, obs, K, bf)
            chi2 = _edge_chi2(r, inv_s2, comp)
            hw = geo.huber_weight(chi2, delta) if robust else torch.ones_like(chi2)
            w = (inv_s2 * hw)[:, None] * comp
            JcW = Jc * w[:, :, None]                 # weighted first: no 0*inf
            H = torch.einsum("nki,nkj->ij", JcW, Jc)
            b = -torch.einsum("nki,nk->i", JcW, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = torch.linalg.solve_ex(Hd, b)[0]
            T_new = geo.se3_exp(dx) @ T
            r_new, _ = _residual_unified(T_new, Xw, obs, K, bf)
            new_cost = robust_cost(r_new, inv_s2, comp, robust)
            accept = new_cost < cost
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e6))
            cost = torch.where(accept, new_cost, cost)
        r, depth = _residual_unified(T, Xw, obs, K, bf)
        inv_s2_all, comp_all = _edge_weights(octave, is_stereo, valid, inv_sigma2_levels)
        chi2 = _edge_chi2(r, inv_s2_all, comp_all)
        return T, (chi2 <= chi2_th) & (depth > 0) & valid

    T = geo.orthonormalize_T(Tcw0)
    mask = valid
    for rd in range(rounds):
        T, mask = lm_round(T, mask, robust=rd < C.POSE_OPT_ROBUST_ROUNDS)
    return PoseOptResult(Tcw=geo.orthonormalize_T(T), inliers=mask,
                         n_inliers=torch.sum(mask).to(torch.int32))


def pose_optimize(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels, K, bf,
                  rounds: int = C.POSE_OPT_ROUNDS,
                  iters: int = C.POSE_OPT_ITS_PER_ROUND) -> PoseOptResult:
    """Motion-only BA: the plain version for CPU tensors, kernel K3 for
    CUDA tensors."""
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    return lm_cuda.pose_optimize_lm(Tcw0, Xw, obs, octave, is_stereo, valid,
                                    inv_sigma2_levels, K, bf, rounds=rounds, iters=iters)


# ---------------------------------------------------------------------------
# local bundle adjustment with a Schur complement on the points
# ---------------------------------------------------------------------------

class BAProblem(NamedTuple):
    """Fixed-shape camera-major BA window; pad with valid=False."""

    cam_T: torch.Tensor       # [Nc, 4, 4] world->cam
    cam_fixed: torch.Tensor   # [Nc] bool
    cam_valid: torch.Tensor   # [Nc] bool
    pts: torch.Tensor         # [Np, 3]
    pt_valid: torch.Tensor    # [Np] bool
    obs_cam: torch.Tensor     # [O] int32 = repeat(arange(Nc), N_per)
    obs_pt: torch.Tensor      # [O] int32 point index
    obs_uvr: torch.Tensor     # [O, 3]
    obs_oct: torch.Tensor     # [O] int32
    obs_stereo: torch.Tensor  # [O] bool
    obs_valid: torch.Tensor   # [O] bool


class BAResult(NamedTuple):
    cam_T: torch.Tensor
    pts: torch.Tensor
    obs_inlier: torch.Tensor  # [O] bool
    cost: torch.Tensor


class LBASystem(NamedTuple):
    """One linearization of the window, point axis last."""

    Hcc: torch.Tensor   # [F, 6, 6]
    bc: torch.Tensor    # [F, 6]
    Hpp9: torch.Tensor  # [9, Np]
    bp3: torch.Tensor   # [3, Np]
    E: torch.Tensor     # [F, 6, 3, Np]
    cost: torch.Tensor  # 0-d robust cost at the linearization point
    n_in: torch.Tensor  # 0-d int32 chi2-inlier count


def _inv33(M):
    """Closed-form batched 3x3 inverse with damping for empty blocks."""
    M = M + 1e-8 * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([Cc, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _cost_from_chi2(prob: BAProblem, chi2, obs_ok, robust: bool):
    delta = _huber_delta(prob.obs_stereo)
    d2 = delta * delta
    n_in = torch.sum(obs_ok & (chi2 <= _chi2_th(prob.obs_stereo))).to(torch.int32)
    if not robust:
        return torch.sum(chi2), n_in
    rho = torch.where(chi2 <= d2, chi2,
                      2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d2)
    return torch.sum(rho), n_in


def lba_cost(prob: BAProblem, inv_sigma2_levels, K, bf, cam_T, pts, obs_ok, robust: bool):
    """(robust or plain cost, chi2-inlier count) of a window state."""
    cam = prob.obs_cam.long()
    r, _ = _residual_unified(cam_T[cam], pts[prob.obs_pt.long()], prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels)
    return _cost_from_chi2(prob, _edge_chi2(r, inv_s2, comp), obs_ok, robust)


def _weighted_rows(prob: BAProblem, cam_T, pts, obs_ok, inv_sigma2_levels, K, bf,
                   robust: bool):
    """Per observation: residual r, Jacobians Jc (zero for fixed or invalid
    cameras) and Jp, their weighted rows JcW and JpW, chi2, and the
    free-camera mask."""
    cam = prob.obs_cam.long()
    r, Jc, Jp, _ = _edge_jacobians(cam_T[cam], pts[prob.obs_pt.long()], prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels)
    chi2 = _edge_chi2(r, inv_s2, comp)
    hw = geo.huber_weight(chi2, _huber_delta(prob.obs_stereo)) if robust \
        else torch.ones_like(chi2)
    cam_free = (~prob.cam_fixed) & prob.cam_valid
    Jc = Jc * cam_free[cam].to(Jc.dtype)[:, None, None]
    w = (inv_s2 * hw)[:, None] * comp
    return r, Jc, Jp, Jc * w[:, :, None], Jp * w[:, :, None], chi2, cam_free


def build_system_plain(prob: BAProblem, inv_sigma2_levels, F: int, cam_T, pts, obs_ok,
                       robust: bool, K, bf) -> LBASystem:
    """Plain version of K4: the reference's cam-major build_system_xla.
    Camera blocks are reshape-sums over the regular camera axis; the
    irregular point axis is an index_add (the reference's one-hot product),
    which the CPU sums in a fixed order."""
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    O = prob.obs_cam.shape[0]
    N_per = O // Nc
    cam = prob.obs_cam.long()
    ptl = prob.obs_pt.long()
    r, Jc, Jp, JcW, JpW, chi2, _ = _weighted_rows(prob, cam_T, pts, obs_ok, inv_sigma2_levels,
                                                  K, bf, robust)
    cost, n_in = _cost_from_chi2(prob, chi2, obs_ok, robust)
    Hcc = torch.einsum("oki,okj->oij", JcW, Jc).reshape(Nc, N_per, 6, 6).sum(1)[:F]
    bc = -torch.einsum("oki,ok->oi", JcW, r).reshape(Nc, N_per, 6).sum(1)[:F]
    hpp_o = torch.einsum("oki,okj->oij", JpW, Jp).reshape(O, 9)
    bp_o = -torch.einsum("oki,ok->oi", JpW, r)
    e_o = torch.einsum("oki,okj->oij", JcW, Jp).reshape(O, 18)
    dev, dt = cam_T.device, cam_T.dtype
    Hpp9 = torch.zeros(Np, 9, dtype=dt, device=dev).index_add_(0, ptl, hpp_o).T
    bp3 = torch.zeros(Np, 3, dtype=dt, device=dev).index_add_(0, ptl, bp_o).T
    key = torch.where(cam < F, cam * Np + ptl, F * Np)
    E = torch.zeros(F * Np + 1, 18, dtype=dt, device=dev).index_add_(0, key, e_o)[:F * Np]
    E = E.reshape(F, Np, 6, 3).permute(0, 2, 3, 1).contiguous()
    return LBASystem(Hcc=Hcc, bc=bc, Hpp9=Hpp9.contiguous(), bp3=bp3.contiguous(), E=E,
                     cost=cost, n_in=n_in)


class RaggedPlans(NamedTuple):
    """The segment sums of the general-layout build, sorted once per window."""

    cam: SegmentPlan    # observation -> camera
    pt: SegmentPlan     # observation -> point
    pair: SegmentPlan   # observation -> (camera < F, point)


def ragged_plans(prob: BAProblem, F: int) -> RaggedPlans:
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    cam, ptl = prob.obs_cam.long(), prob.obs_pt.long()
    return RaggedPlans(SegmentPlan(cam, Nc), SegmentPlan(ptl, Np),
                       SegmentPlan(torch.where(cam < F, cam * Np + ptl, -1), F * Np))


def build_system_ragged(prob: BAProblem, plans: RaggedPlans, inv_sigma2_levels, F: int, cam_T,
                        pts, obs_ok, robust: bool, K, bf) -> LBASystem:
    """One linearization over any observation layout: the reference's
    general branch of build_system_xla, whose `.at[].add` scatters become
    segment sums (Hcc and bc over the camera, Hpp and bp over the point, E
    over the (camera, point) pair, repeated pairs adding up)."""
    Np = prob.pts.shape[0]
    r, Jc, Jp, JcW, JpW, chi2, _ = _weighted_rows(prob, cam_T, pts, obs_ok, inv_sigma2_levels,
                                                  K, bf, robust)
    cost, n_in = _cost_from_chi2(prob, chi2, obs_ok, robust)
    Hcc = plans.cam.sum(torch.einsum("oki,okj->oij", JcW, Jc))[:F]
    bc = plans.cam.sum(-torch.einsum("oki,ok->oi", JcW, r))[:F]
    Hpp = plans.pt.sum(torch.einsum("oki,okj->oij", JpW, Jp))
    bp = plans.pt.sum(-torch.einsum("oki,ok->oi", JpW, r))
    E = plans.pair.sum(torch.einsum("oki,okj->oij", JcW, Jp))     # [F * Np, 6, 3]
    return LBASystem(Hcc=Hcc, bc=bc, Hpp9=Hpp.reshape(Np, 9).T.contiguous(),
                     bp3=bp.T.contiguous(),
                     E=E.reshape(F, Np, 6, 3).permute(0, 2, 3, 1).contiguous(),
                     cost=cost, n_in=n_in)


def _lba_core(prob: BAProblem, inv_sigma2_levels, K, bf, cam_major: bool = True,
              n_free=None):
    """Local-BA LM machinery over one window: returns
    (build_system, cost_of, iterate_da). n_free: count of leading camera
    slots that may be free; the reduced camera system spans only them.
    cam_major: the window is camera-major (O = Nc * N_per), so one
    linearization is K4; otherwise `build_system_ragged`."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda

    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    F = Nc if n_free is None else max(1, min(n_free, Nc))
    cam_free_mask = (~prob.cam_fixed) & prob.cam_valid
    dev = prob.cam_T.device
    if cam_major:
        prepped = lba_cuda.prep_problem(prob, inv_sigma2_levels, F)

        def build_system(cam_T, pts, obs_ok, robust) -> LBASystem:
            return lba_cuda.build_system(prepped, cam_T, pts, obs_ok, robust, K, bf)
    else:
        plans = ragged_plans(prob, F)

        def build_system(cam_T, pts, obs_ok, robust) -> LBASystem:
            return build_system_ragged(prob, plans, inv_sigma2_levels, F, cam_T, pts, obs_ok,
                                       robust, K, bf)

    def cost_of(cam_T, pts, obs_ok, robust):
        return lba_cost(prob, inv_sigma2_levels, K, bf, cam_T, pts, obs_ok, robust)

    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    ci = torch.arange(F, device=dev)
    emb_r = (ci[:, None, None] * 6 + torch.arange(6, device=dev)[None, :, None]).expand(F, 6, 6)
    emb_c = (ci[:, None, None] * 6 + torch.arange(6, device=dev)[None, None, :]).expand(F, 6, 6)

    def solve_from_system(sys_: LBASystem, lam, cam_T, pts):
        """One damped Gauss-Newton step: Schur complement on the points,
        dense Cholesky on the free-camera prefix, back-substitution."""
        tr = torch.diagonal(sys_.Hcc, dim1=-2, dim2=-1).sum(-1)
        Hcc_d = sys_.Hcc + lam * eye6 * torch.clamp(tr[:, None, None] / 6.0, min=1e-6)
        cfree = cam_free_mask[:F]
        Hcc_d = torch.where(cfree[:, None, None], Hcc_d, eye6)
        bc = torch.where(cfree[:, None], sys_.bc, torch.zeros_like(sys_.bc))
        h = sys_.Hpp9
        dmp = lam * torch.clamp((h[0] + h[4] + h[8]) / 3.0, min=1e-6) + 1e-8
        a, b_, c_ = h[0] + dmp, h[1], h[2]
        d_, e_, f_ = h[3], h[4] + dmp, h[5]
        g_, hh, i_ = h[6], h[7], h[8] + dmp
        A = e_ * i_ - f_ * hh
        B = -(d_ * i_ - f_ * g_)
        Cc = d_ * hh - e_ * g_
        det = a * A + b_ * B + c_ * Cc
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
        Hi = torch.stack([
            torch.stack([A, -(b_ * i_ - c_ * hh), (b_ * f_ - c_ * e_)]),
            torch.stack([B, (a * i_ - c_ * g_), -(a * f_ - c_ * d_)]),
            torch.stack([Cc, -(a * hh - b_ * g_), (a * e_ - b_ * d_)]),
        ]) * inv_det                                           # [3, 3, Np]
        E = sys_.E                                             # [F, 6, 3, Np]
        EH = torch.stack([
            sum(E[:, :, j, :] * Hi[j, l, :] for j in range(3)) for l in range(3)
        ], dim=2)
        A2 = EH.reshape(F * 6, 3 * Np)
        B2 = E.reshape(F * 6, 3 * Np)
        Hcc_embed = torch.zeros(F * 6, F * 6, dtype=torch.float32, device=dev)
        Hcc_embed[emb_r, emb_c] = Hcc_d
        S_mat = Hcc_embed - A2 @ B2.T
        rhs = bc.reshape(-1) - A2 @ sys_.bp3.reshape(-1)
        L, info = torch.linalg.cholesky_ex(S_mat + 1e-9 * torch.eye(F * 6, device=dev))
        # a failed factorization gives NaN, as jnp.linalg.cholesky does
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
        dc = torch.cholesky_solve(rhs[:, None], L)[:, 0].reshape(F, 6)
        t3 = (dc.reshape(-1) @ B2).reshape(3, Np)
        rp = sys_.bp3 - t3
        dp3 = torch.stack([sum(Hi[j, l, :] * rp[j] for j in range(3)) for l in range(3)])
        dcs = geo.se3_exp(dc) @ cam_T[:F]
        head = torch.where(cfree[:, None, None], dcs, cam_T[:F])
        cam_T_new = torch.cat([head, cam_T[F:]], dim=0)
        pts_new = torch.where(prob.pt_valid[:, None], pts + dp3.T, pts)
        return cam_T_new, pts_new

    def iterate_da(carry, n_iters: int, robust: bool, tol: float):
        """Delayed-acceptance LM: step k's accept test reuses step k+1's
        linearization; a rejection re-linearizes at the last accepted
        state. Stops after two consecutive non-improving steps. Host reads
        per iteration: the accept flag and the improvement flag, in one
        transfer when the step is accepted."""
        cam_T, pts, lam, cost, n_in, obs_ok = carry
        i, stall = 0, 0
        cur_T, cur_pts = cam_T, pts
        ref_T, ref_pts, ref_cost, ref_nin = cam_T, pts, cost, n_in
        while i < n_iters + 1 and stall < 2:
            first = i == 0
            sys_cur = build_system(cur_T, cur_pts, obs_ok, robust)
            ok_t = (sys_cur.cost <= ref_cost) & (
                sys_cur.n_in.to(torch.float32) >= 0.6 * ref_nin.to(torch.float32))
            imp_t = (ref_cost - sys_cur.cost) > tol * torch.clamp(torch.abs(ref_cost), min=1.0)
            ok, improved = (bool(v) for v in torch.stack([ok_t, imp_t]).tolist())
            if ok:
                lin_T, lin_pts, sys_ = cur_T, cur_pts, sys_cur
            else:
                lin_T, lin_pts = ref_T, ref_pts
                sys_ = build_system(ref_T, ref_pts, obs_ok, robust)
                improved = bool((ref_cost - sys_.cost) > tol * torch.clamp(
                    torch.abs(ref_cost), min=1.0))
            if not first:
                lam = torch.clamp(lam * 0.5, min=1e-9) if ok else torch.clamp(lam * 4.0, max=1e6)
            new_T, new_pts = solve_from_system(sys_, lam, lin_T, lin_pts)
            if not first:
                stall = 0 if improved else stall + 1
            i += 1
            cur_T, cur_pts = new_T, new_pts
            ref_T, ref_pts = lin_T, lin_pts
            ref_cost = torch.minimum(sys_.cost, ref_cost)
            ref_nin = sys_.n_in
        return (ref_T, ref_pts, lam, ref_cost, ref_nin, obs_ok)

    return build_system, cost_of, iterate_da


# local-BA LM carry: (cam_T, pts, lam, cost, n_in, obs_ok)

def lba_init(prob: BAProblem, inv_sigma2_levels, K, bf, cam_major=True):
    """Initial LM carry: SO(3)-projected poses, robust cost and inliers.
    The cost is the same for either layout; cam_major is the reference's
    signature."""
    cam_T = geo.orthonormalize_T(prob.cam_T)
    cost0, n_in0 = lba_cost(prob, inv_sigma2_levels, K, bf, cam_T, prob.pts,
                            prob.obs_valid, True)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=cam_T.device)
    return (cam_T, prob.pts, lam, cost0, n_in0, prob.obs_valid)


def lba_iterate(prob: BAProblem, inv_sigma2_levels, carry, K, bf, n_iters: int,
                robust: bool, cam_major=True, tol: float = 1e-3, n_free=None):
    """Advance the LM carry by up to n_iters steps (early stop on stall)."""
    _, _, iterate_da = _lba_core(prob, inv_sigma2_levels, K, bf, cam_major, n_free)
    return iterate_da(carry, n_iters, robust, tol)


def lba_prune(prob: BAProblem, inv_sigma2_levels, carry, K, bf, cam_major=True):
    """Mid-schedule prune: drop chi2/depth outliers, reset the damping
    (either layout)."""
    cam_T, pts = carry[0], carry[1]
    r, depth = _residual_unified(cam_T[prob.obs_cam.long()], pts[prob.obs_pt.long()],
                                 prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(prob.obs_oct, prob.obs_stereo, prob.obs_valid,
                                 inv_sigma2_levels)
    chi2 = _edge_chi2(r, inv_s2, comp)
    obs_ok = prob.obs_valid & (chi2 <= _chi2_th(prob.obs_stereo)) & (depth > 0)
    cost1, n_in1 = lba_cost(prob, inv_sigma2_levels, K, bf, cam_T, pts, obs_ok, False)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=cam_T.device)
    return (cam_T, pts, lam, cost1, n_in1, obs_ok)


def lba_finalize(prob: BAProblem, inv_sigma2_levels, carry, K, bf) -> BAResult:
    """Final chi2 classification for observation erasure."""
    cam_T, pts, _, cost, _, _ = carry
    r, depth = _residual_unified(cam_T[prob.obs_cam.long()], pts[prob.obs_pt.long()],
                                 prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(prob.obs_oct, prob.obs_stereo, prob.obs_valid,
                                 inv_sigma2_levels)
    chi2 = _edge_chi2(r, inv_s2, comp)
    inlier = prob.obs_valid & (chi2 <= _chi2_th(prob.obs_stereo)) & (depth > 0)
    return BAResult(cam_T=geo.orthonormalize_T(cam_T), pts=pts, obs_inlier=inlier, cost=cost)


def local_bundle_adjustment(prob: BAProblem, inv_sigma2_levels, K, bf,
                            iters1: int = C.LOCAL_BA_ITS_PHASE1,
                            iters2: int = C.LOCAL_BA_ITS_PHASE2,
                            cam_major: bool = False, n_free=None) -> BAResult:
    """Two-phase local BA (src/Optimizer.cc:453-778): iters1 robust LM
    steps, the chi2 prune, iters2 plain steps, the final classification.
    The reduced camera system is dense: S = Hcc - E Hpp^-1 E^T as one
    [6F, 3Np] @ [3Np, 6F] product. cam_major=True needs a camera-major
    window and reaches K4 on the card; the default takes any layout."""
    carry = lba_init(prob, inv_sigma2_levels, K, bf, cam_major)
    carry = lba_iterate(prob, inv_sigma2_levels, carry, K, bf, iters1, robust=True,
                        cam_major=cam_major, n_free=n_free)
    carry = lba_prune(prob, inv_sigma2_levels, carry, K, bf, cam_major)
    carry = lba_iterate(prob, inv_sigma2_levels, carry, K, bf, iters2, robust=False,
                        cam_major=cam_major, n_free=n_free)
    return lba_finalize(prob, inv_sigma2_levels, carry, K, bf)


# ---------------------------------------------------------------------------
# Sim3 optimization, essential graph and global BA (loop closing)
#
# Jacobians of the Sim3 residuals are forward-mode derivatives of the same
# residual functions (the reference's jax.jacfwd), taken as one batched
# torch.func.jvp per tangent direction. Every float scatter-add of the
# reference is a segment sum, so CUDA reruns are bit-identical.
# ---------------------------------------------------------------------------

def _tangent_jacobian(f, n_args: int, dim: int, like: torch.Tensor, batch=(1,)):
    """(f(0...), [J_a for each argument a]) of f(*deltas) -> [..., R] at
    zero tangents of shape batch + (dim,); J_a is [..., R, dim]. All
    n_args * dim tangent directions go through ONE jvp, along a leading
    axis that f must broadcast (one pass of host dispatch instead of one
    per direction). The batch axis is never empty: forward-mode AD of
    torch 2.x promotes a 0-d float32 tangent plus a Python float to
    float64."""
    nd = n_args * dim
    lead = (nd,) + tuple(batch) + (dim,)
    eye = torch.eye(nd, dtype=like.dtype, device=like.device).reshape(nd, n_args, dim)
    zs = tuple(torch.zeros(lead, dtype=like.dtype, device=like.device) for _ in range(n_args))
    tang = tuple(eye[:, a].reshape((nd,) + (1,) * len(batch) + (dim,)).expand(lead)
                 for a in range(n_args))
    r, cols = torch.func.jvp(f, zs, tang)
    cols = cols.movedim(0, -1)
    return r[0], [cols[..., a * dim:(a + 1) * dim] for a in range(n_args)]


def _scale_mask(fix_scale: bool, like: torch.Tensor) -> torch.Tensor:
    m = torch.ones(7, dtype=like.dtype, device=like.device)
    if fix_scale:
        m[6] = 0.0
    return m


class Sim3Result(NamedTuple):
    S12: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def sim3_optimize(S12_0, Xc1, Xc2, obs1, obs2, inv_sigma2_1, inv_sigma2_2, valid, K1, K2,
                  fix_scale: bool = False, chi2_th: float = 10.0,
                  iters: int = 10) -> Sim3Result:
    """Single-vertex Sim3 LM with paired forward/inverse projection edges
    (Optimizer::OptimizeSim3): 5 iterations, chi2 prune, `iters` more."""
    scale_mask = _scale_mask(fix_scale, S12_0)
    eye7 = torch.eye(7, dtype=S12_0.dtype, device=S12_0.device)

    def residuals(S12):
        r1 = obs1 - geo.project(K1, geo.transform_points(S12, Xc2))
        r2 = obs2 - geo.project(K2, geo.transform_points(geo.inv_T(S12), Xc1))
        return r1, r2

    def chi2_of(S12):
        r1, r2 = residuals(S12)
        return (inv_sigma2_1 * torch.sum(r1 * r1, dim=-1),
                inv_sigma2_2 * torch.sum(r2 * r2, dim=-1))

    def run(S12, cost, ok, n_it):
        lam = torch.full((), 1e-3, dtype=S12.dtype, device=S12.device)
        okf = ok.to(S12.dtype)
        w = torch.cat([inv_sigma2_1 * okf, inv_sigma2_2 * okf])[:, None]
        for _ in range(n_it):
            def r_of(dz, S12=S12):     # dz [D, 1, 7]
                r1, r2 = residuals(geo.sim3_exp(dz * scale_mask) @ S12)
                return torch.cat([r1, r2], dim=-2)

            r, (J,) = _tangent_jacobian(r_of, 1, 7, S12)          # J [2N, 2, 7]
            wb = w.expand(r.shape)
            H = torch.einsum("nki,nk,nkj->ij", J, wb, J)
            b = -torch.einsum("nki,nk->i", J * wb[:, :, None], r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            dz = torch.linalg.solve_ex(Hd, b)[0] * scale_mask
            S_new = geo.sim3_exp(dz) @ S12
            c1, c2 = chi2_of(S_new)
            new_cost = torch.sum(torch.where(ok, c1 + c2, torch.zeros_like(c1)))
            accept = new_cost < cost
            S12 = torch.where(accept, S_new, S12)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, new_cost, cost)
        return S12

    c1, c2 = chi2_of(S12_0)
    S12 = run(S12_0, torch.sum(torch.where(valid, c1 + c2, torch.zeros_like(c1))), valid, 5)
    c1, c2 = chi2_of(S12)
    ok = valid & (c1 < chi2_th) & (c2 < chi2_th)
    S12 = run(S12, torch.sum(torch.where(ok, c1 + c2, torch.zeros_like(c1))), ok, iters)
    c1, c2 = chi2_of(S12)
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    return Sim3Result(S12=S12, inliers=inl, n_inliers=torch.sum(inl))


class PoseGraphResult(NamedTuple):
    S: torch.Tensor      # [K, 4, 4] optimized Sim3 world->kf
    cost: torch.Tensor


def _graph_edges(S, edge_i, edge_j, edge_Sji, edge_valid, free, scale_mask):
    """Per-edge residual r = log(Sji Si Sj^-1) [E,7] and masked Jacobians
    wrt left perturbations of Si and Sj [E,7,7]."""
    ei, ej = edge_i.long(), edge_j.long()
    Si, Sj = S[ei], S[ej]

    def f(di, dj):
        return geo.sim3_log(edge_Sji @ (geo.sim3_exp(di * scale_mask) @ Si)
                            @ geo.inv_T(geo.sim3_exp(dj * scale_mask) @ Sj))

    r, (Ji, Jj) = _tangent_jacobian(f, 2, 7, S, batch=(ei.shape[0],))
    ew = edge_valid.to(S.dtype)
    Ji = Ji * (ew * free[ei].to(S.dtype))[:, None, None]
    Jj = Jj * (ew * free[ej].to(S.dtype))[:, None, None]
    return r, r * ew[:, None], Ji, Jj


def _graph_cost(S, edge_i, edge_j, edge_Sji, edge_valid, reduce=None):
    r = geo.sim3_log(edge_Sji @ S[edge_i.long()] @ geo.inv_T(S[edge_j.long()]))
    return (reduce or _identity)(
        torch.sum(torch.where(edge_valid[:, None], r * r, torch.zeros_like(r))))


def _graph_update(S, dx, free, cost, lam, edges, reduce=None):
    S_new = geo.sim3_exp(dx) @ S
    S_new = torch.where(free[:, None, None], S_new, S)
    new_cost = _graph_cost(S_new, *edges, reduce=reduce)
    accept = new_cost < cost
    return (torch.where(accept, S_new, S), torch.where(accept, lam * 0.5, lam * 4.0),
            torch.where(accept, new_cost, cost))


def essential_graph_optimize(S0, kf_valid, kf_fixed, edge_i, edge_j, edge_Sji, edge_valid,
                             fix_scale: bool = False,
                             iters: int = C.ESSENTIAL_GRAPH_ITERS,
                             reduce=None) -> PoseGraphResult:
    """7-DoF pose graph (Optimizer::OptimizeEssentialGraph) with identity
    information, damped Gauss-Newton on the dense [7K, 7K] normal matrix.
    `reduce` follows every sum over the edges (H, b and the cost)."""
    red = reduce or _identity
    Kn = S0.shape[0]
    dev, dt = S0.device, S0.dtype
    scale_mask = _scale_mask(fix_scale, S0)
    free = kf_valid & (~kf_fixed)
    edges = (edge_i, edge_j, edge_Sji, edge_valid)
    ei, ej = edge_i.long(), edge_j.long()
    # the four block scatters of H, and the two of b, as two segment sums
    plan_H = SegmentPlan(torch.cat([ei * Kn + ei, ej * Kn + ej, ei * Kn + ej, ej * Kn + ei]),
                         Kn * Kn)
    plan_b = SegmentPlan(torch.cat([ei, ej]), Kn)
    anchor = (~free).repeat_interleave(7)
    anchor2 = anchor[:, None] | anchor[None, :]
    eye = torch.eye(Kn * 7, dtype=dt, device=dev)
    S, lam = S0, torch.full((), 1e-4, dtype=dt, device=dev)
    cost = _graph_cost(S0, *edges, reduce=reduce)
    for _ in range(iters):
        _, rw, Ji, Jj = _graph_edges(S, *edges, free, scale_mask)
        blocks = torch.cat([torch.einsum("eki,ekj->eij", Ji, Ji),
                            torch.einsum("eki,ekj->eij", Jj, Jj),
                            torch.einsum("eki,ekj->eij", Ji, Jj),
                            torch.einsum("eki,ekj->eij", Jj, Ji)])
        H = red(plan_H.sum(blocks)).reshape(Kn, Kn, 7, 7)
        b = red(plan_b.sum(torch.cat([-torch.einsum("eki,ek->ei", Ji, rw),
                                      -torch.einsum("eki,ek->ei", Jj, rw)])))
        Hf = H.permute(0, 2, 1, 3).reshape(Kn * 7, Kn * 7)
        Hf = Hf + torch.diag(lam * torch.clamp(torch.diagonal(Hf), min=1e-6) + 1e-8)
        Hf = torch.where(anchor2, eye, Hf)
        bf_ = torch.where(anchor, torch.zeros_like(b.reshape(-1)), b.reshape(-1))
        dx = torch.linalg.solve_ex(Hf, bf_)[0].reshape(Kn, 7) * scale_mask
        S, lam, cost = _graph_update(S, dx, free, cost, lam, edges, reduce)
    return PoseGraphResult(S=S, cost=cost)


def essential_graph_optimize_sparse(S0, kf_valid, kf_fixed, edge_i, edge_j, edge_Sji,
                                    edge_valid, fix_scale: bool = False,
                                    iters: int = C.ESSENTIAL_GRAPH_ITERS,
                                    cg_iters: int = 100, reduce=None) -> PoseGraphResult:
    """The same graph solved matrix-free: per-edge [7,7] blocks, H v by
    segment sums, block-Jacobi preconditioned CG (large maps). `reduce`
    follows every sum over the edges (b, the block diagonal, each matvec's
    partial and the cost)."""
    red = reduce or _identity
    Kn = S0.shape[0]
    dev, dt = S0.device, S0.dtype
    scale_mask = _scale_mask(fix_scale, S0)
    free = kf_valid & (~kf_fixed)
    edges = (edge_i, edge_j, edge_Sji, edge_valid)
    ei, ej = edge_i.long(), edge_j.long()
    plan = SegmentPlan(torch.cat([ei, ej]), Kn)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    S, lam = S0, torch.full((), 1e-4, dtype=dt, device=dev)
    cost = _graph_cost(S0, *edges, reduce=reduce)
    for _ in range(iters):
        _, rw, Ji, Jj = _graph_edges(S, *edges, free, scale_mask)
        Bii = torch.einsum("eki,ekj->eij", Ji, Ji)
        Bjj = torch.einsum("eki,ekj->eij", Jj, Jj)
        Bij = torch.einsum("eki,ekj->eij", Ji, Jj)
        b = red(plan.sum(torch.cat([-torch.einsum("eki,ek->ei", Ji, rw),
                                    -torch.einsum("eki,ek->ei", Jj, rw)])))
        Hd = red(plan.sum(torch.cat([Bii, Bjj])))
        dvec = torch.diagonal(Hd, dim1=-2, dim2=-1)
        damp = lam * torch.clamp(dvec, min=1e-6) + 1e-8
        Hd = Hd + torch.diag_embed(damp)
        Hd = torch.where(free[:, None, None], Hd, eye7)
        Minv = torch.linalg.inv_ex(Hd)[0]

        def hv(v):
            vi, vj = v[ei], v[ej]
            ui = torch.einsum("eij,ej->ei", Bii, vi) + torch.einsum("eij,ej->ei", Bij, vj)
            uj = torch.einsum("eji,ej->ei", Bij, vi) + torch.einsum("eij,ej->ei", Bjj, vj)
            out = red(plan.sum(torch.cat([ui, uj]))) + damp * v
            return torch.where(free[:, None], out, v)

        bf_ = torch.where(free[:, None], b, torch.zeros_like(b))
        x = torch.zeros((Kn, 7), dtype=dt, device=dev)
        rr = bf_
        p = torch.einsum("kij,kj->ki", Minv, bf_)
        rz = torch.sum(bf_ * p)
        for _ in range(cg_iters):
            Ap = hv(p)
            denom = torch.sum(p * Ap)
            alpha = torch.where(denom > 1e-12, rz / torch.clamp(denom, min=1e-12),
                                torch.zeros_like(rz))
            x = x + alpha * p
            rr = rr - alpha * Ap
            zz = torch.einsum("kij,kj->ki", Minv, rr)
            rz_new = torch.sum(rr * zz)
            beta = torch.where(rz > 1e-12, rz_new / torch.clamp(rz, min=1e-12),
                               torch.zeros_like(rz))
            p = zz + beta * p
            rz = rz_new
        S, lam, cost = _graph_update(S, x * scale_mask, free, cost, lam, edges, reduce)
    return PoseGraphResult(S=S, cost=cost)


# -- global BA: matrix-free Schur complement + preconditioned CG -------------

def _gba_cost(prob: BAProblem, cam_T, pts, obs_ok, inv_sigma2_levels, K, bf, robust: bool,
              reduce=None):
    red = reduce or _identity
    r, _ = _residual_unified(cam_T[prob.obs_cam.long()], pts[prob.obs_pt.long()],
                             prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels)
    chi2 = _edge_chi2(r, inv_s2, comp)
    if not robust:
        return red(torch.sum(chi2))
    delta = _huber_delta(prob.obs_stereo)
    d2 = delta * delta
    return red(torch.sum(torch.where(chi2 <= d2, chi2,
                                     2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d2)))


class _GBAPlans(NamedTuple):
    cam: SegmentPlan   # observation -> camera
    pt: SegmentPlan    # observation -> point


def _gba_plans(prob: BAProblem) -> _GBAPlans:
    return _GBAPlans(SegmentPlan(prob.obs_cam, prob.cam_T.shape[0]),
                     SegmentPlan(prob.obs_pt, prob.pts.shape[0]))


def _assemble_blocks(prob: BAProblem, plans: _GBAPlans, cam_T, pts, obs_ok, inv_sigma2_levels,
                     K, bf, robust: bool, reduce=None):
    """Per-observation Jacobians and the block pieces of the normal
    equations (the reference's `.at[].add` scatters as segment sums, each
    followed by `reduce`; A stays per observation)."""
    red = reduce or _identity
    r, Jc, Jp, JcW, JpW, _, cam_free = _weighted_rows(prob, cam_T, pts, obs_ok,
                                                      inv_sigma2_levels, K, bf, robust)
    Hcc = red(plans.cam.sum(torch.einsum("oki,okj->oij", JcW, Jc)))
    bc = red(plans.cam.sum(-torch.einsum("oki,ok->oi", JcW, r)))
    Hpp = red(plans.pt.sum(torch.einsum("oki,okj->oij", JpW, Jp)))
    bp = red(plans.pt.sum(-torch.einsum("oki,ok->oi", JpW, r)))
    A = torch.einsum("oki,okj->oij", JcW, Jp)             # [O, 6, 3]
    return Hcc, bc, Hpp, bp, A, cam_free


def _gba_lm_step(prob: BAProblem, plans: _GBAPlans, inv_sigma2_levels, K, bf, carry, it: int,
                 cg_iters: int = 40, robust_iters: int = 5, reduce=None):
    """One damped-GN/Schur/PCG iteration of the global BA. `reduce`
    follows every sum over the observations: the block sums, the two
    partials of each Schur matvec, the right-hand side, the
    back-substitution and the cost."""
    red = reduce or _identity
    cam_T, pts, lam, cost, obs_ok = carry
    robust = it < robust_iters
    dev, dt = cam_T.device, cam_T.dtype
    Nc = cam_T.shape[0]
    cam = prob.obs_cam.long()
    ptl = prob.obs_pt.long()
    Hcc, bc, Hpp, bp, A, cam_free = _assemble_blocks(prob, plans, cam_T, pts, obs_ok,
                                                     inv_sigma2_levels, K, bf, robust, reduce)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    tr6 = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + lam * eye6 * torch.clamp(tr6[:, None, None] / 6.0, min=1e-6)
    Hcc_d = torch.where(cam_free[:, None, None], Hcc_d, eye6)
    bc = torch.where(cam_free[:, None], bc, torch.zeros_like(bc))
    tr3 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_inv = _inv33(Hpp + lam * eye3 * torch.clamp(tr3[:, None, None] / 3.0, min=1e-6))

    def schur_matvec(x):
        y = torch.einsum("cij,cj->ci", Hcc_d, x)
        sp = red(plans.pt.sum(torch.einsum("oij,oi->oj", A, x[cam])))
        v = torch.einsum("pij,pj->pi", Hpp_inv, sp)
        y = y - red(plans.cam.sum(torch.einsum("oij,oj->oi", A, v[ptl])))
        return torch.where(cam_free[:, None], y, x)

    v0 = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    rhs = bc - red(plans.cam.sum(torch.einsum("oij,oj->oi", A, v0[ptl])))
    rhs = torch.where(cam_free[:, None], rhs, torch.zeros_like(rhs))
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-8 * eye6)[0]
    tiny = torch.full((), 1e-20, dtype=dt, device=dev)
    x = torch.zeros((Nc, 6), dtype=dt, device=dev)
    r_ = rhs
    p = torch.einsum("cij,cj->ci", Minv, rhs)
    rz = torch.sum(rhs * p)
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, tiny, denom)
        x = x + alpha * p
        r_ = r_ - alpha * Ap
        z = torch.einsum("cij,cj->ci", Minv, r_)
        rz_new = torch.sum(r_ * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, tiny, rz)
        p = z + beta * p
        rz = rz_new
    sp = red(plans.pt.sum(torch.einsum("oij,oi->oj", A, x[cam])))
    dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - sp)
    cam_T_new = torch.where(cam_free[:, None, None], geo.se3_exp(x) @ cam_T, cam_T)
    pts_new = torch.where(prob.pt_valid[:, None], pts + dp, pts)
    new_cost = _gba_cost(prob, cam_T_new, pts_new, obs_ok, inv_sigma2_levels, K, bf, robust,
                         reduce)
    accept = new_cost < cost
    return (torch.where(accept, cam_T_new, cam_T), torch.where(accept, pts_new, pts),
            torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6)),
            torch.where(accept, new_cost, cost), obs_ok)


def gba_init_carry(prob: BAProblem, inv_sigma2_levels, K, bf, reduce=None):
    """Initial LM carry (cam_T, pts, lam, cost, obs_ok) of the chunked GBA."""
    cost0 = _gba_cost(prob, prob.cam_T, prob.pts, prob.obs_valid, inv_sigma2_levels, K, bf,
                      True, reduce)
    lam = torch.full((), 1e-4, dtype=prob.cam_T.dtype, device=prob.cam_T.device)
    return (prob.cam_T, prob.pts, lam, cost0, prob.obs_valid)


def gba_chunk(prob: BAProblem, inv_sigma2_levels, carry, it0: int, K, bf, n_iters: int = 1,
              cg_iters: int = 40, robust_iters: int = 5, plans: _GBAPlans = None,
              reduce=None):
    """Advance the chunked GBA by n_iters LM iterations from `carry`: one
    bounded piece of work the host interleaves with frames and can drop
    (the reference's interruptible GBA thread). `plans` caches the
    observation segment sort across chunks of one problem."""
    plans = plans or _gba_plans(prob)
    for k in range(n_iters):
        carry = _gba_lm_step(prob, plans, inv_sigma2_levels, K, bf, carry, it0 + k, cg_iters,
                             robust_iters, reduce)
    return carry


def gba_result(prob: BAProblem, inv_sigma2_levels, K, bf, carry) -> BAResult:
    """Final chi2 classification of a chunked GBA carry (per observation:
    no sum to reduce)."""
    cam_T, pts, _, cost, _ = carry
    r, depth = _residual_unified(cam_T[prob.obs_cam.long()], pts[prob.obs_pt.long()],
                                 prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(prob.obs_oct, prob.obs_stereo, prob.obs_valid,
                                 inv_sigma2_levels)
    chi2 = _edge_chi2(r, inv_s2, comp)
    inlier = prob.obs_valid & (chi2 <= _chi2_th(prob.obs_stereo)) & (depth > 0)
    return BAResult(cam_T=geo.orthonormalize_T(cam_T), pts=pts, obs_inlier=inlier, cost=cost)


def global_bundle_adjustment(prob: BAProblem, inv_sigma2_levels, K, bf,
                             iters: int = C.GBA_ITERS, cg_iters: int = 40,
                             robust_iters: int = 5, reduce=None) -> BAResult:
    """Full-map BA in one call (Optimizer::GlobalBundleAdjustemnt): the
    chunked GBA's carry, `iters` of its LM steps, its final
    classification. The monocular initializer runs it on the two-keyframe
    map; `parallel/dist_ba.py` runs it on a shard of the observations with
    an all-reduce as `reduce`."""
    carry = gba_init_carry(prob, inv_sigma2_levels, K, bf, reduce)
    carry = gba_chunk(prob, inv_sigma2_levels, carry, 0, K, bf, n_iters=iters,
                      cg_iters=cg_iters, robust_iters=robust_iters, reduce=reduce)
    return gba_result(prob, inv_sigma2_levels, K, bf, carry)
