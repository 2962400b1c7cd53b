"""Parity of the port's RNG and RANSAC solvers with the JAX package on the
CPU: threefry bits and the categorical index tables exactly, the geometry
of Sim(3) within float tolerance, and pnp_ransac / sim3_ransac on the
fixtures of tests/test_ransac.py (pose within 1e-3, equal ok, inliers
within 2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

K = (500.0, 500.0, 320.0, 240.0)
SIGMA2 = np.asarray([1.2 ** (2 * l) for l in range(8)], np.float32)


def test_threefry_layout_is_partitionable():
    """The port reproduces the partitionable layout, JAX's default."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (0, (3, 5, 11)), (7, (128, 4, 60)),
                                        (123456789, (2, 1000))])
def test_random_bits_equal_jax(seed, shape):
    from orb_slam2_comment_tpu_torch.ops import rng

    jb = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    tb = rng.random_bits(rng.prng_key(seed), shape).numpy()
    np.testing.assert_array_equal(jb.astype(np.int64), tb)
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    np.testing.assert_array_equal(ju, rng.uniform(rng.prng_key(seed), shape).numpy())


@pytest.mark.parametrize("H,S,N,p", [(128, 4, 80, 1.0), (128, 4, 600, 0.3),
                                     (512, 3, 600, 0.05), (512, 3, 1000, 0.5),
                                     (16, 3, 40, 0.0)])
def test_sample_indices_equal_jax(H, S, N, p):
    """The minimal-set tables are equal, not close: JAX's Gumbel-max and
    the port's argmax of the same uniform bits pick the same index (the
    last row has no valid entry: both give index 0). The general
    categorical (with its float32 log) agrees too at these shapes."""
    from orb_slam2_comment_tpu.ops import ransac as jr
    from orb_slam2_comment_tpu_torch.ops import ransac as tr, rng

    valid = np.random.default_rng(N + H).random(N) < p
    ji = np.asarray(jr._sample_indices(jax.random.PRNGKey(0), H, S, N, jnp.asarray(valid)))
    ti = tr._sample_indices(0, H, S, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(ji, ti)
    logits = torch.where(torch.from_numpy(valid), 0.0, -float("inf"))[None, :]
    np.testing.assert_array_equal(ji, rng.categorical(rng.prng_key(0), logits, (H, S)).numpy())


def test_sim3_geometry_matches_jax():
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu_torch.ops import geometry as tg

    r = np.random.default_rng(0)
    z = r.normal(0, 0.3, (64, 7)).astype(np.float32)
    z[:8, 6] = 0.0          # exact unit scale
    z[8:12, 3:6] = 0.0      # no rotation
    S_j = np.asarray(jax.vmap(jg.sim3_exp)(jnp.asarray(z)))
    S_t = tg.sim3_exp(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(S_t, S_j, atol=2e-6)
    log_j = np.asarray(jax.vmap(jg.sim3_log)(jnp.asarray(S_j)))
    log_t = tg.sim3_log(torch.from_numpy(S_j)).numpy()
    np.testing.assert_allclose(log_t, log_j, atol=2e-5)
    T = S_j.copy()
    T[:, :3, :3] /= np.cbrt(np.linalg.det(T[:, :3, :3]))[:, None, None]
    np.testing.assert_allclose(tg.se3_log(torch.from_numpy(T)).numpy(),
                               np.asarray(jax.vmap(jg.se3_log)(jnp.asarray(T))), atol=2e-5)


def _pnp_problem(n, outlier_frac, noise, seed):
    from orb_slam2_comment_tpu.ops import geometry as geo

    r = np.random.default_rng(seed)
    X = r.uniform(-3, 3, (n, 3)).astype(np.float32) + [0, 0, 8]
    T_gt = np.asarray(geo.se3_exp(jnp.asarray([0.3, -0.1, 0.2, 0.1, -0.2, 0.05], jnp.float32)))
    Xc = X @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv = np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2], K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], -1)
    uv += r.normal(0, noise, uv.shape)
    n_out = int(n * outlier_frac)
    out_idx = r.choice(n, n_out, replace=False)
    uv[out_idx] = r.uniform([0, 0], [640, 480], (n_out, 2))
    return X.astype(np.float32), uv.astype(np.float32)


@pytest.mark.parametrize("n,outlier_frac,noise,seed", [(80, 0.3, 0.5, 0), (60, 0.0, 0.0, 0),
                                                       (120, 0.6, 0.4, 3)])
def test_pnp_ransac_matches_jax(n, outlier_frac, noise, seed):
    """Equal ok, inliers within 2 and pose within 1e-3 — except at 60%
    outliers: a 4-point EPnP set leaves a 4-dim null space of M^T M whose
    eigenvector basis differs between LAPACK builds, so the hypotheses, and
    the first best one, differ. There the two packages return the same
    final inlier set and poses within 2 cm of each other, both inside the
    reference test's 0.05 bound against the truth."""
    from orb_slam2_comment_tpu.ops import geometry as geo
    from orb_slam2_comment_tpu.ops import ransac as jr
    from orb_slam2_comment_tpu_torch.ops import ransac as tr

    X, uv = _pnp_problem(n, outlier_frac, noise, seed)
    octv = np.random.default_rng(seed).integers(0, 3, n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[::7] = False
    jres = jr.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(octv), jnp.asarray(valid),
                         jnp.asarray(SIGMA2), K)
    tres = tr.pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(octv),
                         torch.from_numpy(valid), torch.from_numpy(SIGMA2), K)
    assert bool(tres.ok) == bool(jres.ok)
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 2
    if outlier_frac < 0.5:
        tol = 1e-3
    else:
        np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
        T_gt = geo.se3_exp(jnp.asarray([0.3, -0.1, 0.2, 0.1, -0.2, 0.05], jnp.float32))
        for T in (np.asarray(jres.Tcw), tres.Tcw.numpy()):
            assert np.linalg.norm(np.asarray(geo.se3_log(jnp.asarray(T) @ geo.inv_T(T_gt)))) < 0.05
        tol = 2e-2
    np.testing.assert_allclose(tres.Tcw.numpy()[:3, 3], np.asarray(jres.Tcw)[:3, 3], atol=tol)
    np.testing.assert_allclose(tres.Tcw.numpy()[:3, :3], np.asarray(jres.Tcw)[:3, :3], atol=tol)


def test_pnp_ransac_garbage_fails_in_both():
    from orb_slam2_comment_tpu.ops import ransac as jr
    from orb_slam2_comment_tpu_torch.ops import ransac as tr

    r = np.random.default_rng(1)
    X = (r.uniform(-3, 3, (40, 3)) + [0, 0, 5]).astype(np.float32)
    uv = r.uniform([0, 0], [640, 480], (40, 2)).astype(np.float32)
    z = np.zeros(40, np.int32)
    v = np.ones(40, bool)
    jres = jr.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(z), jnp.asarray(v),
                         jnp.asarray(SIGMA2), K)
    tres = tr.pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(z),
                         torch.from_numpy(v), torch.from_numpy(SIGMA2), K)
    assert int(tres.n_inliers) < 20 and int(jres.n_inliers) < 20
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax(fix_scale):
    from orb_slam2_comment_tpu.ops import geometry as geo
    from orb_slam2_comment_tpu.ops import ransac as jr
    from orb_slam2_comment_tpu_torch.ops import ransac as tr

    r = np.random.default_rng(3 if fix_scale else 2)
    n = 40 if fix_scale else 60
    zeta = (np.array([0.2, 0.1, -0.3, 0.05, 0.1, -0.05, 0.0], np.float32) if fix_scale
            else np.array([0.4, -0.2, 0.3, 0.1, -0.1, 0.2, 0.3], np.float32))
    S12 = np.asarray(geo.sim3_exp(jnp.asarray(zeta)))
    Xc2 = (r.uniform(-2, 2, (n, 3)) + [0, 0, 6]).astype(np.float32)
    Xc1 = (Xc2 @ S12[:3, :3].T + S12[:3, 3]).astype(np.float32)

    def proj(X):
        return np.stack([K[0] * X[:, 0] / X[:, 2] + K[2],
                         K[1] * X[:, 1] / X[:, 2] + K[3]], -1).astype(np.float32)

    uv1, uv2 = proj(Xc1), proj(Xc2)
    if not fix_scale:
        idx = r.choice(n, n * 3 // 10, replace=False)
        Xc2 = Xc2.copy()
        Xc2[idx] += r.uniform(1, 3, (len(idx), 3)).astype(np.float32)
    z = np.zeros(n, np.int32)
    v = np.ones(n, bool)
    args = (Xc1, Xc2, uv1, uv2, z, z, v, SIGMA2)
    jres = jr.sim3_ransac(*[jnp.asarray(a) for a in args], K, K, fix_scale=fix_scale)
    tres = tr.sim3_ransac(*[torch.from_numpy(a) for a in args], K, K, fix_scale=fix_scale)
    assert bool(tres.ok) == bool(jres.ok)
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 2
    np.testing.assert_allclose(tres.S12.numpy(), np.asarray(jres.S12), atol=1e-3)
