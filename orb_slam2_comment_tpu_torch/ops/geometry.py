"""SE(3) math, the pinhole/stereo camera model, robust kernels and the
quaternions of the trajectory savers — the part of
`orb_slam2_comment_tpu/ops/geometry.py` the port calls.

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


def so3_log(R):
    """Inverse of so3_exp; handles angles near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    big = torch.abs(sin_t) > 1e-5
    scale = torch.where(big, theta / torch.where(big, sin_t, torch.ones_like(sin_t)),
                        torch.ones_like(sin_t))
    w_generic = w * scale[..., None]
    # near pi: R ~ I + 2 W^2 / theta^2, the diagonal gives the axis
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_t[..., None])
                        / torch.clamp(1.0 - cos_t[..., None], min=1e-8), min=0.0)
    axis = torch.sqrt(axis2)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    ay = torch.where(sxy >= 0, axis[..., 1], -axis[..., 1])
    az = torch.where(sxz >= 0, axis[..., 2], -axis[..., 2])
    w_pi = torch.stack([axis[..., 0], ay, az], dim=-1) * theta[..., None]
    return torch.where((theta > 3.0)[..., None], w_pi, w_generic)


def _so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    half = 0.5 * theta
    big = theta2 > _EPS
    cot = torch.where(big, half / torch.tan(half + _EPS), torch.ones_like(half))
    k = torch.where(big, (1.0 - cot) / (theta2 + _EPS), 1.0 / 12.0 + theta2 / 720.0)
    return _eye(3, phi) - 0.5 * W + k[..., None, None] * W2


def se3_exp(xi):
    """xi = [rho, phi] -> 4x4 transform [[R, J rho], [0, 1]]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    J = _so3_left_jacobian(phi)
    t = (J @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T):
    phi = so3_log(T[..., :3, :3])
    rho = (_so3_left_jacobian_inv(phi) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


# --- Sim(3): 4x4 matrices with upper-left s R --------------------------------

def sim3_make(R, t, s):
    return make_T(R * s[..., None, None], t)


def sim3_scale(S):
    """Scale of a Sim3 matrix (row norm of sR)."""
    return torch.sqrt(torch.sum(S[..., 0, :3] * S[..., 0, :3], dim=-1))


def sim3_exp(zeta):
    """zeta = [rho, phi, sigma] -> 4x4 Sim3 with s = exp(sigma); the
    closed-form V of the Sim(3) exponential (t = V rho), as the reference."""
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    near_zero_sigma = torch.abs(sigma) < 1e-5
    near_zero_theta = theta2 < _EPS
    one = torch.ones_like(sigma)
    sigma_safe = torch.where(near_zero_sigma, one, sigma)
    theta_safe = torch.where(near_zero_theta, one, theta)
    A_ = torch.where(near_zero_sigma, one, (s - 1.0) / sigma_safe)
    st, ct = torch.sin(theta), torch.cos(theta)
    denom = sigma_safe ** 2 + theta_safe ** 2
    b_full = ((sigma_safe * st + theta_safe * (1.0 - s * ct)) / (theta_safe * denom)) * s / s
    b_sigma0 = (1.0 - ct) / theta_safe ** 2
    c_full = (A_ - ((s * ct - 1.0) * sigma_safe + s * st * theta_safe) / denom) / theta_safe ** 2
    c_sigma0 = (theta_safe - st) / theta_safe ** 3
    zero = torch.zeros_like(sigma)
    b = torch.where(near_zero_theta, zero, torch.where(near_zero_sigma, b_sigma0, b_full))
    c = torch.where(near_zero_theta, zero, torch.where(near_zero_sigma, c_sigma0, c_full))
    V = A_[..., None, None] * _eye(3, zeta) + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ rho[..., None])[..., 0]
    return sim3_make(R, t, s)


def sim3_log(S):
    """Inverse of sim3_exp: V from unit-rho exponentials, then V rho = t."""
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    sigma = torch.log(s)
    phi = so3_log(R)
    eye = _eye(3, S)

    def v_col(i):
        e = eye[i].expand(phi.shape)
        return sim3_exp(torch.cat([e, phi, sigma[..., None]], dim=-1))[..., :3, 3]

    V = torch.stack([v_col(i) for i in range(3)], dim=-1)
    rho = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]   # no host sync on CUDA
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def rot_to_quat(R):
    """Rotation matrix -> quaternion (x, y, z, w), Shepperd's method: the
    branch of the largest of the trace and the three diagonal entries."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2

    s = s_of(tr + 1.0)
    case0 = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], dim=-1)
    s = s_of(1.0 + m00 - m11 - m22)
    case1 = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], dim=-1)
    s = s_of(1.0 + m11 - m00 - m22)
    case2 = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], dim=-1)
    s = s_of(1.0 + m22 - m00 - m11)
    case3 = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], dim=-1)
    q = torch.where((tr > 0)[..., None], case0,
                    torch.where(((m00 >= m11) & (m00 >= m22))[..., None], case1,
                                torch.where((m11 >= m22)[..., None], case2, case3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.clamp(n, min=1e-12)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)], dim=-1),
    ], dim=-2)


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
