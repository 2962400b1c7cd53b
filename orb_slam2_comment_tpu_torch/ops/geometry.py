"""SE(3) math, the pinhole/stereo camera model and robust kernels — the
part of `orb_slam2_comment_tpu/ops/geometry.py` the RGB-D main path calls.

Conventions as in the reference: 4x4 row-major `Tcw` (world -> camera),
se3 tangent `[rho, phi]`, optimizer updates by LEFT multiplication
`T <- exp(xi) @ T`. Every function is batched over leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(n, ref):
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def hat(w):
    """Skew-symmetric matrix of a 3-vector (so(3) hat operator)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(phi):
    """Rodrigues formula, Taylor-safe at phi -> 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    return _eye(3, phi) + a[..., None, None] * W + b[..., None, None] * W2


def _so3_left_jacobian(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    big = theta2 > _EPS
    b = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    c = torch.where(
        big,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    return _eye(3, phi) + b[..., None, None] * W + c[..., None, None] * W2


def se3_exp(xi):
    """xi = [rho, phi] -> 4x4 transform [[R, J rho], [0, 1]]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    J = _so3_left_jacobian(phi)
    t = (J @ rho[..., None])[..., 0]
    return make_T(R, t)


def make_T(R, t):
    """Assemble 4x4 from R [...,3,3] and t [...,3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def orthonormalize_R(R):
    """Project a near-rotation back onto SO(3) by Gram-Schmidt (see the
    reference's note: f32 left-increment chains drift off the manifold)."""
    x = R[..., :, 0]
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=_EPS)
    y = R[..., :, 1]
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def orthonormalize_T(T):
    return make_T(orthonormalize_R(T[..., :3, :3]), T[..., :3, 3])


def inv_T(T):
    """Inverse of a rigid (or similarity) transform."""
    A = T[..., :3, :3]
    t = T[..., :3, 3]
    s2 = torch.sum(A[..., 0, :] * A[..., 0, :], dim=-1)
    Ainv = A.transpose(-1, -2) / s2[..., None, None]
    tinv = -(Ainv @ t[..., None])[..., 0]
    return make_T(Ainv, tinv)


def transform_points(T, X):
    """Apply 4x4 T [...,4,4] (broadcast against X) to points X [...,3]."""
    return (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]


def project(K, Xc):
    fx, fy, cx, cy = K
    invz = 1.0 / torch.clamp(Xc[..., 2], min=1e-9)
    u = fx * Xc[..., 0] * invz + cx
    v = fy * Xc[..., 1] * invz + cy
    return torch.stack([u, v], dim=-1)


def project_stereo(K, bf, Xc):
    """(u_left, v, u_right), u_right = u - bf/z."""
    fx, fy, cx, cy = K
    invz = 1.0 / torch.clamp(Xc[..., 2], min=1e-9)
    u = fx * Xc[..., 0] * invz + cx
    v = fy * Xc[..., 1] * invz + cy
    ur = u - bf * invz
    return torch.stack([u, v, ur], dim=-1)


def backproject(K, uv, z):
    fx, fy, cx, cy = K
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def huber_weight(chi2, delta):
    """IRLS weight of the Huber kernel at squared error chi2."""
    d2 = delta * delta
    e = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= d2, torch.ones_like(chi2), delta / torch.sqrt(e))


def triangulate_linear(P1, P2, uv1, uv2):
    """DLT triangulation; smallest eigenvector of A^T A by four shifted
    inverse iterations, as the reference does."""
    rows = torch.stack(
        [
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )
    AtA = rows.transpose(-1, -2) @ rows
    trace = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye4 = _eye(4, AtA)
    M = AtA + 1e-7 * trace * eye4 + 1e-12 * eye4
    X = torch.ones(AtA.shape[:-2] + (4,), dtype=AtA.dtype, device=AtA.device)
    for _ in range(4):
        X = torch.linalg.solve_ex(M, X[..., None])[0][..., 0]
        X = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-30)
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def fundamental_from_poses(K1, T1w, K2, T2w):
    """F12 with x1^T F12 x2 = 0, from two world->cam poses."""
    R1w, t1w = T1w[:3, :3], T1w[:3, 3]
    R2w, t2w = T2w[:3, :3], T2w[:3, 3]
    R12 = R1w @ R2w.T
    t12 = -R12 @ t2w + t1w
    fx1, fy1, cx1, cy1 = K1
    fx2, fy2, cx2, cy2 = K2
    from orb_slam2_comment_tpu_torch.ops.scatter import const

    K1m = const(((fx1, 0.0, cx1), (0.0, fy1, cy1), (0.0, 0.0, 1.0)), T1w.device, T1w.dtype)
    K2m = const(((fx2, 0.0, cx2), (0.0, fy2, cy2), (0.0, 0.0, 1.0)), T1w.device, T1w.dtype)
    # inv_ex: no error check, so no host sync on CUDA
    K1i = torch.linalg.inv_ex(K1m)[0]
    K2i = torch.linalg.inv_ex(K2m)[0]
    return K1i.T @ hat(t12) @ R12 @ K2i
