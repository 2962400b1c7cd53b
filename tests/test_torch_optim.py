"""Parity of the port's solvers (orb_slam2_comment_tpu_torch.ops.optim) with
the JAX package on the CPU: pose-only LM (kernel K3's plain version) against
both the JAX XLA path and the Pallas kernel in interpret mode, and one
local-BA linearization (kernel K4's plain version) plus five LM iterations
against the JAX cam-major build_system_xla."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

K = (500.0, 500.0, 320.0, 240.0)
BF = 50.0


def _pose_problem(seed, N=300):
    from orb_slam2_comment_tpu.ops import geometry as geo

    r = np.random.default_rng(seed)
    Xw = (r.uniform(-3, 3, (N, 3)) + [0, 0, 8]).astype(np.float32)
    T_gt = np.asarray(geo.se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01],
                                              jnp.float32)))
    Xc = Xw @ T_gt[:3, :3].T + T_gt[:3, 3]
    u = K[0] * Xc[:, 0] / Xc[:, 2] + K[2]
    v = K[1] * Xc[:, 1] / Xc[:, 2] + K[3]
    uvr = np.stack([u, v, u - BF / Xc[:, 2]], -1) + r.normal(0, 0.4, (N, 3))
    out_idx = r.choice(N, N // 5, replace=False)
    uvr[out_idx, :2] += r.uniform(15, 40, (len(out_idx), 2))
    T0 = np.asarray(geo.se3_exp(jnp.asarray([0.08, -0.04, 0.06, 0.015, -0.02, 0.006],
                                            jnp.float32)))
    return dict(T0=T0, Xw=Xw, obs=uvr.astype(np.float32),
                octave=r.integers(0, 4, N).astype(np.int32), stereo=r.random(N) < 0.7,
                valid=r.random(N) < 0.95,
                inv_s2=np.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)], np.float32))


@pytest.mark.parametrize("seed", [3, 4])
def test_pose_lm_matches_xla_and_pallas(seed):
    """|dT| < 5e-3 and |d inliers| <= 5 (the reference's Pallas-vs-XLA
    bar): the closed-form vs solve-based steps round differently."""
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu.ops.lm_pallas import pose_optimize_pallas
    from orb_slam2_comment_tpu_torch.ops import optim as topt

    p = _pose_problem(seed)
    jargs = (jnp.asarray(p["T0"]), jnp.asarray(p["Xw"]), jnp.asarray(p["obs"]),
             jnp.asarray(p["octave"]), jnp.asarray(p["stereo"]), jnp.asarray(p["valid"]),
             jnp.asarray(p["inv_s2"]), K, BF)
    ref = jopt.pose_optimize(*jargs)
    pal = pose_optimize_pallas(*jargs, interpret=True)
    got = topt.pose_optimize(*(torch.from_numpy(np.asarray(a)) for a in
                               (p["T0"], p["Xw"], p["obs"], p["octave"], p["stereo"],
                                p["valid"], p["inv_s2"])), K, BF)
    for other in (ref, pal):
        assert np.abs(got.Tcw.numpy() - np.asarray(other.Tcw)).max() < 5e-3
        assert abs(int(got.n_inliers) - int(other.n_inliers)) <= 5
    np.testing.assert_array_equal(got.inliers.numpy() <= p["valid"], True)


def _ba_problem(NC=8, NP=256, N_PER=200, F=4, seed=0):
    r = np.random.default_rng(seed)
    O = NC * N_PER
    pts = (r.uniform(-6, 6, (NP, 3)) + [0, 0, 10]).astype(np.float32)
    cam_T = np.tile(np.eye(4, dtype=np.float32), (NC, 1, 1))
    cam_T[:, 0, 3] = -np.linspace(0, 2, NC).astype(np.float32)
    obs_pt = r.integers(0, NP, (NC, N_PER)).astype(np.int32)
    Xc = pts[obs_pt] + cam_T[:, None, :3, 3]
    u = K[0] * Xc[..., 0] / Xc[..., 2] + K[2]
    v = K[1] * Xc[..., 1] / Xc[..., 2] + K[3]
    uvr = np.stack([u, v, u - BF / Xc[..., 2]], -1).reshape(O, 3)
    uvr = (uvr + r.normal(0, 0.4, (O, 3))).astype(np.float32)
    # perturb the free cameras and the points so LM has work to do
    cam_T[1:F, :3, 3] += r.normal(0, 0.02, (F - 1, 3)).astype(np.float32)
    pts = pts + r.normal(0, 0.03, pts.shape).astype(np.float32)
    cam_fixed = np.zeros(NC, bool)
    cam_fixed[F:] = True
    cam_fixed[0] = True
    return dict(
        cam_T=cam_T, cam_fixed=cam_fixed, cam_valid=np.ones(NC, bool), pts=pts,
        pt_valid=np.ones(NP, bool),
        obs_cam=np.repeat(np.arange(NC, dtype=np.int32), N_PER),
        obs_pt=obs_pt.reshape(-1), obs_uvr=uvr,
        obs_oct=r.integers(0, 4, O).astype(np.int32), obs_stereo=r.random(O) < 0.7,
        obs_valid=r.random(O) < 0.95), F


def _both_problems(fields):
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu_torch.ops import optim as topt

    jp = jopt.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = topt.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jp, tp


@pytest.mark.parametrize("robust", [True, False])
def test_lba_build_system_matches_xla(robust):
    """Relative error < 1e-3 per LBASystem field against build_system_xla
    (different summation order on the point axis)."""
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim as topt

    fields, F = _ba_problem()
    jp, tp = _both_problems(fields)
    inv_s2 = [1.0 / (1.2 ** (2 * l)) for l in range(8)]
    bs_j, _, _ = jopt._lba_core(jp, jnp.asarray(inv_s2), K, BF, cam_major=True, n_free=F)
    sj = bs_j(jp.cam_T, jp.pts, jp.obs_valid, robust)
    prep = lba_cuda.prep_problem(tp, torch.tensor(inv_s2), F)
    st = lba_cuda.build_system(prep, tp.cam_T, tp.pts, tp.obs_valid, robust, K, BF)
    assert isinstance(st, topt.LBASystem)
    for fld in sj._fields:
        a = np.asarray(getattr(sj, fld), np.float64)
        b = getattr(st, fld).numpy().astype(np.float64)
        assert a.shape == b.shape, fld
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-6)
        assert err < 1e-3, (fld, err)


def test_lba_iterate_matches_xla():
    """Five robust LM iterations from lba_init: cost within 1e-3 relative
    and an equal inlier count."""
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu_torch.ops import optim as topt

    fields, F = _ba_problem(seed=1)
    jp, tp = _both_problems(fields)
    inv_s2 = [1.0 / (1.2 ** (2 * l)) for l in range(8)]
    cj = jopt.lba_init(jp, jnp.asarray(inv_s2), K, BF)
    cj = jopt.lba_iterate(jp, jnp.asarray(inv_s2), cj, K, BF, 5, robust=True, n_free=F)
    ct = topt.lba_init(tp, torch.tensor(inv_s2), K, BF)
    ct = topt.lba_iterate(tp, torch.tensor(inv_s2), ct, K, BF, 5, robust=True, n_free=F)
    c_j, c_t = float(cj[3]), float(ct[3])
    assert abs(c_j - c_t) / max(abs(c_j), 1.0) < 1e-3, (c_j, c_t)
    assert int(cj[4]) == int(ct[4])
    assert np.abs(np.asarray(cj[0]) - ct[0].numpy()).max() < 1e-3
    # prune + finalize agree on the inlier set
    pj = jopt.lba_prune(jp, jnp.asarray(inv_s2), cj, K, BF)
    pt_ = topt.lba_prune(tp, torch.tensor(inv_s2), ct, K, BF)
    agree = np.mean(np.asarray(pj[5]) == pt_[5].numpy())
    assert agree > 0.999, agree
    rj = jopt.lba_finalize(jp, jnp.asarray(inv_s2), pj, K, BF)
    rt = topt.lba_finalize(tp, torch.tensor(inv_s2), pt_, K, BF)
    assert np.mean(np.asarray(rj.obs_inlier) == rt.obs_inlier.numpy()) > 0.999


def test_geometry_matches_jax():
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu_torch.ops import geometry as tg

    r = np.random.default_rng(5)
    xi = (r.normal(0, 0.3, (16, 6))).astype(np.float32)
    T = np.asarray(jg.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(tg.se3_exp(torch.from_numpy(xi)).numpy(), T, atol=2e-6)
    np.testing.assert_allclose(tg.inv_T(torch.from_numpy(T)).numpy(),
                               np.asarray(jg.inv_T(jnp.asarray(T))), atol=2e-6)
    Tn = T + r.normal(0, 1e-3, T.shape).astype(np.float32)
    np.testing.assert_allclose(tg.orthonormalize_T(torch.from_numpy(Tn)).numpy(),
                               np.asarray(jg.orthonormalize_T(jnp.asarray(Tn))), atol=2e-6)
    X = (r.uniform(-2, 2, (50, 3)) + [0, 0, 6]).astype(np.float32)
    np.testing.assert_allclose(
        tg.project_stereo(K, BF, torch.from_numpy(X)).numpy(),
        np.asarray(jg.project_stereo(K, BF, jnp.asarray(X))), rtol=1e-6, atol=1e-4)
    P1 = np.asarray(jnp.asarray([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1]]) @ T[0, :3])
    P2 = np.asarray(jnp.asarray([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1]]) @ T[1, :3])
    uv1 = (X[:, :2] * 10 + 300).astype(np.float32)
    uv2 = uv1 + 3.0
    np.testing.assert_allclose(
        tg.triangulate_linear(*(torch.from_numpy(a) for a in (P1, P2, uv1, uv2))).numpy(),
        np.asarray(jg.triangulate_linear(*(jnp.asarray(a) for a in (P1, P2, uv1, uv2)))),
        rtol=1e-3, atol=1e-3)
    F12 = jg.fundamental_from_poses(K, jnp.asarray(T[0]), K, jnp.asarray(T[1]))
    np.testing.assert_allclose(
        tg.fundamental_from_poses(K, torch.from_numpy(T[0]), K, torch.from_numpy(T[1])).numpy(),
        np.asarray(F12), rtol=1e-4, atol=1e-9)


def test_inv33_matches_jax():
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu_torch.ops import optim as topt

    r = np.random.default_rng(6)
    A = r.normal(size=(64, 3, 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    M[:4] = 0.0   # empty blocks take the damping path
    np.testing.assert_allclose(topt._inv33(torch.from_numpy(M)).numpy(),
                               np.asarray(jopt._inv33(jnp.asarray(M))), rtol=1e-5, atol=1e-4)


def test_lba_prep_tables_match_numpy():
    """K4's per-window tables (the kernel reads them as they are) against a
    numpy construction: level weights, point ids clipped into the window,
    observations sorted stably by point with the invalid ones last, segment
    starts, free cameras; the completion counters start at 0."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim as topt

    fields, F = _ba_problem(NC=6, NP=40, N_PER=30, F=3, seed=2)
    fields["obs_pt"][::7] = 45   # padding slots clipped onto the last point
    fields["cam_valid"][4] = False
    tp = topt.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})
    inv = np.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)], np.float32)
    prep = lba_cuda.prep_problem(tp, torch.from_numpy(inv), F)
    NC, NP, O = 6, 40, 180
    obs_pt = np.clip(fields["obs_pt"], 0, NP - 1)
    key = np.where(fields["obs_valid"], obs_pt, NP)
    perm = np.argsort(key, kind="stable")
    seg = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=NP + 1)[:NP])])
    np.testing.assert_array_equal(prep.perm.numpy(), perm)
    np.testing.assert_array_equal(prep.seg.numpy(), seg)
    np.testing.assert_array_equal(prep.obs_pt.numpy(), obs_pt)
    np.testing.assert_array_equal(prep.inv_s2.numpy(), inv[np.clip(fields["obs_oct"], 0, 7)])
    np.testing.assert_array_equal(prep.cam_free.numpy(),
                                  ~fields["cam_fixed"] & fields["cam_valid"])
    np.testing.assert_array_equal(prep.stereo.view(torch.uint8).numpy(),
                                  fields["obs_stereo"].astype(np.uint8))
    np.testing.assert_array_equal(prep.uvr.numpy(), fields["obs_uvr"])
    assert prep.N_per == 30 and prep.F == F
    assert prep.scratch.shape == (NC * lba_cuda.CHUNKS * 32 + 2 * NC,)
    np.testing.assert_array_equal(prep.tickets.numpy(), np.zeros(NC + 1, np.int32))
    # each point's segment lists its valid observations, camera-major
    for p in (0, 17, NP - 1):
        obs = perm[seg[p]:seg[p + 1]]
        assert np.all(obs_pt[obs] == p) and np.all(fields["obs_valid"][obs])
        assert np.all(np.diff(obs // 30) >= 0)
    assert O == len(perm)


@pytest.mark.parametrize("layout", ["single", "stacked", "broadcast"])
def test_pose_lm_launch_layout(layout):
    """K3's launch arguments as the wrapper checks them on any device: the
    batch strides the kernel walks (0 for inputs broadcast over the
    batch), the bool flags read as bytes, and a wrong dtype or an unpacked
    row refused."""
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    p = _pose_problem(7, N=50)
    B, n = 3, 50
    T0 = torch.from_numpy(np.tile(p["T0"], (B, 1, 1)))
    per_edge = [torch.from_numpy(p[k]) for k in ("Xw", "obs", "octave", "stereo")]
    valid = torch.from_numpy(np.tile(p["valid"], (B, 1)))
    if layout == "single":
        args = [T0[:1]] + [t[None] for t in per_edge] + [valid[:1]]
        want = [0] * 5
    elif layout == "stacked":
        args = [T0] + [t.expand((B,) + t.shape).contiguous() for t in per_edge] + [valid]
        want = [n * 3, n * 3, n, n, n]
    else:
        args = [T0] + [t.expand((B,) + t.shape) for t in per_edge] + [valid]
        want = [0, 0, 0, 0, n]
    inv = torch.from_numpy(p["inv_s2"])
    got_B, got_n, strides = lm_cuda.launch_layout(*args, inv)
    assert (got_B, got_n, strides) == (args[0].shape[0], n, want)
    np.testing.assert_array_equal(args[4].view(torch.uint8)[0].numpy(),
                                  p["stereo"].astype(np.uint8))
    for i, bad in ((1, args[1].double()), (3, args[3].long()), (4, args[4].to(torch.uint8)),
                   (2, args[2].transpose(-1, -2).contiguous().transpose(-1, -2))):
        with pytest.raises(ValueError):
            lm_cuda.launch_layout(*args[:i], bad, *args[i + 1:], inv)
