"""Plain reference of the two solves that every frame and keyframe runs.

- `pose_optimize`: motion-only bundle adjustment (ORB-SLAM2's
  Optimizer::PoseOptimization): 4 rounds of 10 Levenberg-Marquardt steps
  on the left-multiplied SE(3) increment, Huber in the first two, each
  edge re-classified by its chi2 between rounds.
- `build_system`: one linearization of a local-BA window, the normal
  equation blocks that the Schur solve reads: Hcc [F,6,6], bc [F,6],
  Hpp [Np,3,3] (9 entries), bp [Np,3], E [F,6,3,Np] and the robust cost.

A frozen copy, in plain PyTorch, of the port's plain versions of its
kernels K3 and K4 (`ops/optim.py`: `pose_optimize_plain`,
`build_system_plain` and the helpers they call), computed in whatever
dtype the inputs are given in; the benchmark gives float64. It imports
nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5
POSE_OPT_ROUNDS = 4
POSE_OPT_ITS_PER_ROUND = 10
POSE_OPT_ROBUST_ROUNDS = 2
_EPS = 1e-8


# --- SE(3) -------------------------------------------------------------------

def _eye(n, ref):
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def so3_exp(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    return _eye(3, phi) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    big = theta2 > _EPS
    b = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye(3, phi) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def make_T(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi):
    rho, phi = xi[..., :3], xi[..., 3:6]
    return make_T(so3_exp(phi), (_so3_left_jacobian(phi) @ rho[..., None])[..., 0])


def orthonormalize_T(T):
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=_EPS)
    y = R[..., :, 1]
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
    z = torch.linalg.cross(x, y, dim=-1)
    return make_T(torch.stack([x, y, z], dim=-1), T[..., :3, 3])


# --- edges -------------------------------------------------------------------

def _transform(T, X):
    return (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]


def _project_stereo(K, bf, Xc):
    fx, fy, cx, cy = K
    invz = 1.0 / torch.clamp(Xc[..., 2], min=1e-9)
    u = fx * Xc[..., 0] * invz + cx
    v = fy * Xc[..., 1] * invz + cy
    return torch.stack([u, v, u - bf * invz], dim=-1)


def _residual(Tcw, Xw, obs, K, bf):
    Xc = _transform(Tcw, Xw)
    return obs - _project_stereo(K, bf, Xc), Xc[..., 2]


def _edge_jacobians(Tcw, Xw, obs, K, bf):
    """Residual and Jacobians wrt the camera tangent [rho, phi] and the point."""
    fx, fy, cx, cy = K
    Xc = _transform(Tcw, Xw)
    r = obs - _project_stereo(K, bf, Xc)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    invz = 1.0 / torch.clamp(z, min=1e-9)
    invz2 = invz * invz
    zr = torch.zeros_like(x)
    D00, D02 = -fx * invz, fx * x * invz2
    D11, D12 = -fy * invz, fy * y * invz2
    D20, D22 = -fx * invz, (fx * x - bf) * invz2
    M00, M01, M02 = -D02 * y, -D00 * z + D02 * x, D00 * y
    M10, M11, M12 = D11 * z - D12 * y, D12 * x, -D11 * x
    M20, M21, M22 = -D22 * y, -D20 * z + D22 * x, D20 * y
    Jc = torch.stack([
        torch.stack([D00, zr, D02, -M00, -M01, -M02], dim=-1),
        torch.stack([zr, D11, D12, -M10, -M11, -M12], dim=-1),
        torch.stack([D20, zr, D22, -M20, -M21, -M22], dim=-1),
    ], dim=-2)
    R = Tcw[..., :3, :3]
    R0, R1, R2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
    Jp = torch.stack([D00[..., None] * R0 + D02[..., None] * R2,
                      D11[..., None] * R1 + D12[..., None] * R2,
                      D20[..., None] * R0 + D22[..., None] * R2], dim=-2)
    return r, Jc, Jp


def _edge_weights(octave, is_stereo, valid, inv_sigma2_levels):
    lvl = torch.clamp(octave, 0, inv_sigma2_levels.shape[0] - 1).long()
    inv_s2 = inv_sigma2_levels[lvl]
    comp = torch.stack([torch.ones_like(inv_s2), torch.ones_like(inv_s2),
                        is_stereo.to(inv_s2.dtype)], dim=-1)
    return torch.where(valid, inv_s2, torch.zeros_like(inv_s2)), comp


def _chi2(r, inv_s2, comp):
    return inv_s2 * torch.sum(comp * r * r, dim=-1)


def _delta(is_stereo, dtype):
    return torch.where(is_stereo, HUBER_STEREO, HUBER_MONO).to(dtype)


def _huber_weight(chi2, delta):
    e = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta * delta, torch.ones_like(chi2), delta / torch.sqrt(e))


def _robust_sum(chi2, delta, robust):
    if not robust:
        return torch.sum(chi2)
    d2 = delta * delta
    return torch.sum(torch.where(chi2 <= d2, chi2,
                                 2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d2))


class PoseResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def pose_optimize(Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels, K, bf):
    """Motion-only BA of one pose; every floating input in one dtype."""
    dt = Xw.dtype
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    delta = _delta(is_stereo, dt)
    eye6 = torch.eye(6, dtype=dt, device=Xw.device)

    def lm_round(T, inlier_mask, robust):
        inv_s2, comp = _edge_weights(octave, is_stereo, valid & inlier_mask, inv_sigma2_levels)
        cost = _robust_sum(_chi2(_residual(T, Xw, obs, K, bf)[0], inv_s2, comp), delta, robust)
        lam = torch.full((), 1e-3, dtype=dt, device=Xw.device)
        for _ in range(POSE_OPT_ITS_PER_ROUND):
            r, Jc, _ = _edge_jacobians(T, Xw, obs, K, bf)
            chi2 = _chi2(r, inv_s2, comp)
            hw = _huber_weight(chi2, delta) if robust else torch.ones_like(chi2)
            w = (inv_s2 * hw)[:, None] * comp
            JcW = Jc * w[:, :, None]
            H = torch.einsum("nki,nkj->ij", JcW, Jc)
            b = -torch.einsum("nki,nk->i", JcW, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = torch.linalg.solve_ex(Hd, b)[0]
            T_new = se3_exp(dx) @ T
            new_cost = _robust_sum(_chi2(_residual(T_new, Xw, obs, K, bf)[0], inv_s2, comp),
                                   delta, robust)
            accept = new_cost < cost
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e6))
            cost = torch.where(accept, new_cost, cost)
        r, depth = _residual(T, Xw, obs, K, bf)
        inv_s2_all, comp_all = _edge_weights(octave, is_stereo, valid, inv_sigma2_levels)
        return T, (_chi2(r, inv_s2_all, comp_all) <= chi2_th) & (depth > 0) & valid

    T = orthonormalize_T(Tcw0)
    mask = valid
    for rd in range(POSE_OPT_ROUNDS):
        T, mask = lm_round(T, mask, robust=rd < POSE_OPT_ROBUST_ROUNDS)
    return PoseResult(orthonormalize_T(T), mask, torch.sum(mask))


class LBASystem(NamedTuple):
    Hcc: torch.Tensor
    bc: torch.Tensor
    Hpp9: torch.Tensor
    bp3: torch.Tensor
    E: torch.Tensor
    cost: torch.Tensor


def build_system(cam_T, cam_fixed, cam_valid, obs_cam, obs_pt, obs_uvr, obs_oct, obs_stereo,
                 obs_ok, inv_sigma2_levels, F: int, Np: int, pts, robust: bool, K, bf,
                 absolute: bool = False):
    """The normal-equation blocks of a camera-major window (O = Nc * N_per
    observations) at (cam_T, pts). With `absolute`, every block is instead
    the sum of the absolute values of its contributions: the scale that a
    block's rounding error is measured against."""
    Nc = cam_T.shape[0]
    O = obs_cam.shape[0]
    N_per = O // Nc
    cam = obs_cam.long()
    ptl = obs_pt.long()
    dt, dev = cam_T.dtype, cam_T.device
    r, Jc, Jp = _edge_jacobians(cam_T[cam], pts[ptl], obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(obs_oct, obs_stereo, obs_ok, inv_sigma2_levels)
    chi2 = _chi2(r, inv_s2, comp)
    delta = _delta(obs_stereo, dt)
    hw = _huber_weight(chi2, delta) if robust else torch.ones_like(chi2)
    cam_free = (~cam_fixed) & cam_valid
    Jc = Jc * cam_free[cam].to(dt)[:, None, None]
    w = (inv_s2 * hw)[:, None] * comp
    cost = _robust_sum(chi2, delta, robust)
    sign = -1.0
    if absolute:
        r, Jc, Jp, sign = r.abs(), Jc.abs(), Jp.abs(), 1.0
    JcW, JpW = Jc * w[:, :, None], Jp * w[:, :, None]
    Hcc = torch.einsum("oki,okj->oij", JcW, Jc).reshape(Nc, N_per, 6, 6).sum(1)[:F]
    bc = sign * torch.einsum("oki,ok->oi", JcW, r).reshape(Nc, N_per, 6).sum(1)[:F]
    hpp_o = torch.einsum("oki,okj->oij", JpW, Jp).reshape(O, 9)
    bp_o = sign * torch.einsum("oki,ok->oi", JpW, r)
    e_o = torch.einsum("oki,okj->oij", JcW, Jp).reshape(O, 18)
    Hpp9 = torch.zeros(Np, 9, dtype=dt, device=dev).index_add_(0, ptl, hpp_o).T
    bp3 = torch.zeros(Np, 3, dtype=dt, device=dev).index_add_(0, ptl, bp_o).T
    key = torch.where(cam < F, cam * Np + ptl, F * Np)
    E = torch.zeros(F * Np + 1, 18, dtype=dt, device=dev).index_add_(0, key, e_o)[:F * Np]
    E = E.reshape(F, Np, 6, 3).permute(0, 2, 3, 1)
    return LBASystem(Hcc, bc, Hpp9, bp3, E, cost)
