"""Parity of the port's loop-closing pieces with the JAX package on the CPU,
on small hand-built maps carried across with map_state.from_numpy:
sim3_optimize, the essential-graph edges and both solvers (with their
forward-mode Jacobians against jax.jacfwd), the chunked global BA (also
resumed in the port from a JAX carry through LoopCloser.load_state), the
point corrections and loop fusion."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

K = (500.0, 500.0, 320.0, 240.0)


def _cfg(pkg, **kw):
    if pkg == "jax":
        from orb_slam2_comment_tpu.utils.config import SlamConfig
    else:
        from orb_slam2_comment_tpu_torch.utils.config import SlamConfig
    base = dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3], bf=40.0, n_features=64,
                n_levels=4, max_keyframes=16, max_points=1024, grow_capacity=False)
    return SlamConfig(**dict(base, **kw))


def _to_torch(jm):
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    return tms.from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})


def _scene_map(seed=0, kmax=16, pmax=1024, n=64, n_kf=6, noise=0.0):
    """n_kf keyframes stepping along x, each observing 64 of the points it
    sees (neighbours share most), with projections, octaves and stereo
    right coordinates; parents form a chain."""
    from orb_slam2_comment_tpu.models import map_state as ms

    r = np.random.default_rng(seed)
    n_pts = 400
    pts = np.zeros((pmax, 3), np.float32)
    pts[:n_pts] = r.uniform([-3, -2, 4], [3, 2, 9], (n_pts, 3))
    poses = np.tile(np.eye(4, dtype=np.float32), (kmax, 1, 1))
    obs = np.full((kmax, n), -1, np.int32)
    xy = np.zeros((kmax, n, 2), np.float32)
    ur = np.full((kmax, n), -1.0, np.float32)
    octv = np.zeros((kmax, n), np.int32)
    for k in range(n_kf):
        poses[k, 0, 3] = -0.15 * k
        poses[k, 1, 3] = 0.02 * np.sin(k)
        Xc = pts[:n_pts] + poses[k, :3, 3]
        u = K[0] * Xc[:, 0] / Xc[:, 2] + K[2]
        v = K[1] * Xc[:, 1] / Xc[:, 2] + K[3]
        vis = np.where((u > 5) & (u < 635) & (v > 5) & (v < 475))[0]
        sel = np.sort(r.choice(vis, n, replace=False))
        obs[k] = sel
        xy[k] = np.stack([u[sel], v[sel]], -1) + r.normal(0, noise, (n, 2))
        ur[k] = np.where(r.random(n) < 0.7, xy[k, :, 0] - 40.0 / Xc[sel, 2], -1.0)
        octv[k] = r.integers(0, 3, n)
    parent = np.full(kmax, -1, np.int32)
    parent[1:n_kf] = np.arange(n_kf - 1)
    m = ms.empty_map(kmax, pmax, n)
    return m._replace(
        kf_pose=jnp.asarray(poses), kf_valid=jnp.asarray(np.arange(kmax) < n_kf),
        kf_obs=jnp.asarray(obs), kf_feat_valid=jnp.asarray(obs >= 0), kf_xy=jnp.asarray(xy),
        kf_uright=jnp.asarray(ur), kf_octave=jnp.asarray(octv), kf_parent=jnp.asarray(parent),
        pt_pos=jnp.asarray(pts), pt_valid=jnp.asarray(np.arange(pmax) < n_pts),
        pt_ref_kf=jnp.asarray(np.where(np.arange(pmax) < n_pts, np.arange(pmax) % n_kf, -1)
                              .astype(np.int32)))


def test_sim3_optimize_matches_jax():
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu.ops import optim as jo
    from orb_slam2_comment_tpu_torch.ops import optim as to

    r = np.random.default_rng(4)
    n = 120
    S_gt = np.asarray(jg.sim3_exp(jnp.asarray([0.2, -0.1, 0.15, 0.05, -0.08, 0.1, 0.0],
                                              jnp.float32)))
    Xc2 = (r.uniform(-2, 2, (n, 3)) + [0, 0, 6]).astype(np.float32)
    Xc1 = (Xc2 @ S_gt[:3, :3].T + S_gt[:3, 3]).astype(np.float32)
    proj = lambda X: np.stack([K[0] * X[:, 0] / X[:, 2] + K[2],
                               K[1] * X[:, 1] / X[:, 2] + K[3]], -1)
    uv1 = (proj(Xc1) + r.normal(0, 0.7, (n, 2))).astype(np.float32)
    uv2 = (proj(Xc2) + r.normal(0, 0.7, (n, 2))).astype(np.float32)
    uv1[:15] += 30.0
    S0 = np.asarray(jg.sim3_exp(jnp.asarray([0.23, -0.12, 0.1, 0.06, -0.07, 0.12, 0.0],
                                            jnp.float32)))
    w1 = (1.0 / 1.44 ** r.integers(0, 3, n)).astype(np.float32)
    w2 = (1.0 / 1.44 ** r.integers(0, 3, n)).astype(np.float32)
    valid = r.random(n) < 0.95
    args = (S0, Xc1, Xc2, uv1, uv2, w1, w2, valid)
    for fix_scale in (True, False):
        jr = jo.sim3_optimize(*[jnp.asarray(a) for a in args], K, K, fix_scale=fix_scale)
        tr = to.sim3_optimize(*[torch.from_numpy(a) for a in args], K, K, fix_scale=fix_scale)
        np.testing.assert_allclose(tr.S12.numpy(), np.asarray(jr.S12), atol=1e-4)
        assert int(tr.n_inliers) == int(jr.n_inliers)
        np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))


def _graph_problem():
    """Essential-graph edges of a 6-KF chain whose last KF closes a loop to
    KF 0, with a past loop edge (1, 4); poses before/after a perturbation."""
    from orb_slam2_comment_tpu.models import loop_closing as jlc
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu_torch.models import loop_closing as tlc

    jm = _scene_map(seed=1)
    r = np.random.default_rng(2)
    dz = np.zeros((16, 6), np.float32)
    dz[:6] = r.normal(0, 0.01, (6, 6))
    poses_after = np.asarray(jg.se3_exp(jnp.asarray(dz))) @ np.asarray(jm.kf_pose)
    jm2 = jm._replace(kf_pose=jnp.asarray(poses_after))
    S12 = np.asarray(jg.sim3_exp(jnp.asarray([0.01, 0.0, -0.02, 0.0, 0.01, 0.0, 0.0],
                                             jnp.float32))) @ (
        np.asarray(jm.kf_pose[5]) @ np.linalg.inv(np.asarray(jm.kf_pose[0])))
    past = [(1, 4, np.eye(4, dtype=np.float32))]
    je = jlc._essential_edges(jm2, jm.kf_pose, 6, 5, 0, jnp.asarray(S12, jnp.float32), past,
                              topc=4)
    tm, tm2 = _to_torch(jm), _to_torch(jm2)
    te = tlc._essential_edges(tm2, tm.kf_pose, 6, 5, 0, torch.from_numpy(S12.astype(np.float32)),
                              past, topc=4)
    return jm2, tm2, je, te


def test_essential_edges_and_jacobians_match_jax():
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu_torch.ops import optim as to

    jm2, tm2, je, te = _graph_problem()
    for a, b in zip(te[:2] + te[3:], je[:2] + je[3:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(te[2].numpy(), np.asarray(je[2]), atol=1e-6)
    ok = np.asarray(je[3])
    pairs = {(int(a), int(b)) for a, b, v in zip(np.asarray(je[0]), np.asarray(je[1]), ok) if v}
    assert {(1, 4), (0, 5), (0, 1), (4, 5)} <= pairs
    # Jacobians of log(Sji Si Sj^-1) wrt left perturbations: port (jvp)
    # against jax.jacfwd within 1e-5 at random Sim3 states. A few scale
    # columns carry JAX's own f32 rounding above 1e-5 (its arccos and
    # solve); there the bound is 1e-5 plus JAX's distance from the same
    # derivative evaluated in float64.
    r = np.random.default_rng(7)
    S = np.asarray(jax.vmap(jg.sim3_exp)(jnp.asarray(r.normal(0, 0.3, (16, 7)), jnp.float32)))
    ei, ej, Sji = (np.asarray(x) for x in je[:3])
    z = jnp.zeros(7)

    def per_edge(Si, Sj, Sm):
        f = lambda di, dj: jg.sim3_log(Sm @ (jg.sim3_exp(di) @ Si) @ jg.inv_T(jg.sim3_exp(dj) @ Sj))
        return f(z, z), jax.jacfwd(f, 0)(z, z), jax.jacfwd(f, 1)(z, z)

    jout = jax.vmap(per_edge)(jnp.asarray(S[ei]), jnp.asarray(S[ej]), jnp.asarray(Sji))
    args = (torch.ones(len(ei), dtype=torch.bool), torch.ones(16, dtype=torch.bool))
    t32 = to._graph_edges(torch.from_numpy(S), te[0], te[1], te[2], *args, torch.ones(7))
    t64 = to._graph_edges(torch.from_numpy(S).double(), te[0], te[1], te[2].double(), *args,
                          torch.ones(7, dtype=torch.float64))
    for a, b, exact in zip((t32[0], t32[2], t32[3]), jout, (t64[0], t64[2], t64[3])):
        b = np.asarray(b)
        bound = 1e-5 + np.abs(b - exact.numpy())
        assert np.all(np.abs(a.numpy() - b) <= bound)
        assert np.abs(a.numpy() - b).max() <= 1e-4


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_essential_graph_matches_jax(solver):
    from orb_slam2_comment_tpu.ops import optim as jo
    from orb_slam2_comment_tpu_torch.ops import optim as to

    jm2, tm2, je, te = _graph_problem()
    fixed = np.arange(16) == 0
    kw = dict(fix_scale=True, iters=6)
    if solver == "dense":
        jr = jo.essential_graph_optimize(jm2.kf_pose, jm2.kf_valid, jnp.asarray(fixed), *je, **kw)
        tr = to.essential_graph_optimize(tm2.kf_pose, tm2.kf_valid, torch.from_numpy(fixed), *te,
                                         **kw)
    else:
        jr = jo.essential_graph_optimize_sparse(jm2.kf_pose, jm2.kf_valid, jnp.asarray(fixed),
                                                *je, cg_iters=30, **kw)
        tr = to.essential_graph_optimize_sparse(tm2.kf_pose, tm2.kf_valid,
                                                torch.from_numpy(fixed), *te, cg_iters=30, **kw)
    assert float(tr.cost) < float(jo.essential_graph_optimize(
        jm2.kf_pose, jm2.kf_valid, jnp.asarray(fixed), *je, fix_scale=True, iters=0).cost)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(tr.S.numpy(), np.asarray(jr.S), atol=1e-4)


def test_global_ba_chunks_match_jax_and_resume_from_jax_carry():
    """gba_init_carry / gba_chunk / gba_result agree with JAX: cost within
    1e-4 relative, poses within 1e-4 (2e-4 after all chunks), points within
    1 mm (weakly observed points absorb the f32 rounding of the 40-step
    PCG, ~0.3 mm observed). A LoopCloser loaded with JAX's carry after 2
    chunks finishes like JAX."""
    from orb_slam2_comment_tpu.models import loop_closing as jlc
    from orb_slam2_comment_tpu.ops import optim as jo
    from orb_slam2_comment_tpu_torch.models import loop_closing as tlc
    from orb_slam2_comment_tpu_torch.models.tracking import Tracker
    from orb_slam2_comment_tpu_torch.ops import optim as to

    jm = _scene_map(seed=3, noise=0.5)
    r = np.random.default_rng(3)
    pos = np.asarray(jm.pt_pos) + np.where(np.asarray(jm.pt_valid)[:, None],
                                           r.normal(0, 0.02, (1024, 3)), 0).astype(np.float32)
    jm = jm._replace(pt_pos=jnp.asarray(pos))
    tm = _to_torch(jm)
    jcfg, tcfg = _cfg("jax"), _cfg("torch")
    jprob, jinv = jlc._build_gba_problem(jm, jcfg)
    tprob, tinv = tlc._build_gba_problem(tm, tcfg)
    jc = jo.gba_init_carry(jprob, jinv, jcfg.K, jcfg.bf)
    tc = to.gba_init_carry(tprob, tinv, tcfg.K, tcfg.bf)
    np.testing.assert_allclose(float(tc[3]), float(jc[3]), rtol=1e-5)
    for it in range(2):
        jc = jo.gba_chunk(jprob, jinv, jc, jnp.asarray(it, jnp.int32), jcfg.K, jcfg.bf)
        tc = to.gba_chunk(tprob, tinv, tc, it, tcfg.K, tcfg.bf)
        np.testing.assert_allclose(float(tc[3]), float(jc[3]), rtol=1e-4)
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), atol=1e-4)
        np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]), atol=1e-3)
    # resume from JAX's carry inside the port's LoopCloser and finish
    trk = Tracker(tcfg, "cpu")
    trk.map = tm
    lc = tlc.LoopCloser(tcfg, trk, db=None)
    lc.load_state(dict(last_loop_kf=5, consistent_groups=[({0, 1}, 2)],
                       loop_edges=[(0, 5, np.eye(4))],
                       background=dict(carry=[np.asarray(c) for c in jc], it=2, epoch=0)))
    assert lc.to_state()["loop_edges"][0][:2] == (0, 5)
    from orb_slam2_comment_tpu import constants as C

    for it in range(2, C.GBA_ITERS):
        jc = jo.gba_chunk(jprob, jinv, jc, jnp.asarray(it, jnp.int32), jcfg.K, jcfg.bf)
    jres = jo.gba_result(jprob, jinv, jcfg.K, jcfg.bf, jc)
    while lc._bg is not None:
        lc.pump_background()
    assert lc.n_gba_applied == 1
    free = np.asarray(jm.kf_valid) & (np.arange(16) > 0)
    np.testing.assert_allclose(trk.map.kf_pose.numpy()[free], np.asarray(jres.cam_T)[free],
                               atol=2e-4)
    pv = np.asarray(jm.pt_valid)
    np.testing.assert_allclose(trk.map.pt_pos.numpy()[pv], np.asarray(jres.pts)[pv], atol=1e-3)


def test_point_corrections_match_jax():
    from orb_slam2_comment_tpu.models import loop_closing as jlc
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu_torch.models import loop_closing as tlc

    jm = _scene_map(seed=5)
    tm = _to_torch(jm)
    r = np.random.default_rng(5)
    S = np.asarray(jax.vmap(jg.sim3_exp)(jnp.asarray(r.normal(0, 0.05, (16, 7)), jnp.float32)))
    S = S @ np.asarray(jm.kf_pose)
    mask = np.arange(16) % 2 == 0
    a = tlc._correct_points(tm, torch.from_numpy(mask), torch.from_numpy(S)).pt_pos.numpy()
    b = np.asarray(jlc._correct_points(jm, jnp.asarray(mask), jnp.asarray(S)).pt_pos)
    np.testing.assert_allclose(a, b, atol=1e-5)
    a = tlc._remap_points_after_graph(tm, torch.from_numpy(S)).pt_pos.numpy()
    b = np.asarray(jlc._remap_points_after_graph(jm, jnp.asarray(S)).pt_pos)
    np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(tlc._sim3_to_se3(torch.from_numpy(S)).numpy(),
                               np.asarray(jlc._sim3_to_se3(jnp.asarray(S))), atol=1e-6)


def test_loop_fusion_matches_jax():
    """SearchAndFuse: KF 5's points re-created under new ids project onto
    KF 4's features; both packages add the same observations and replace
    the same duplicates."""
    from orb_slam2_comment_tpu.models.local_mapping import fuse_point_set_into_keyframe as jf
    from orb_slam2_comment_tpu_torch.models.local_mapping import (
        fuse_point_set_into_keyframe as tf)

    jm = _scene_map(seed=6)
    r = np.random.default_rng(6)
    desc = r.integers(0, 2 ** 32, (1024, 8), dtype=np.uint32)
    obs = np.asarray(jm.kf_obs).copy()
    pos = np.asarray(jm.pt_pos).copy()
    valid = np.asarray(jm.pt_valid).copy()
    kf_desc = np.zeros((16, 64, 8), np.uint32)
    for k in range(6):
        kf_desc[k] = desc[obs[k]]
    # duplicate KF 5's landmarks as new points 600..663 (the loop points)
    dup_ids = np.arange(600, 664)
    pos[dup_ids] = pos[obs[5]] + r.normal(0, 0.003, (64, 3))
    desc[dup_ids] = desc[obs[5]]
    valid[dup_ids] = True
    obs[4, ::3] = -1     # free some features of the target KF
    pts_ids = np.full(128, -1, np.int32)
    pts_ids[:64] = dup_ids
    cam_c = -np.asarray(jm.kf_pose)[4, :3, 3]
    d = np.linalg.norm(pos - cam_c, axis=1).astype(np.float32)
    jm = jm._replace(kf_obs=jnp.asarray(obs), pt_pos=jnp.asarray(pos), pt_valid=jnp.asarray(valid),
                     pt_desc=jnp.asarray(desc), kf_desc=jnp.asarray(kf_desc),
                     kf_angle=jnp.zeros((16, 64)), pt_max_dist=jnp.asarray(d * 1.2),
                     pt_min_dist=jnp.asarray(d * 0.5),
                     pt_visible=jnp.asarray(r.integers(1, 9, 1024).astype(np.int32)),
                     pt_found=jnp.asarray(r.integers(1, 9, 1024).astype(np.int32)))
    tm = _to_torch(jm)
    jm2, jn = jf(jm, jnp.asarray(pts_ids), jnp.asarray(4), _cfg("jax"))
    tm2, tn = tf(tm, torch.from_numpy(pts_ids), 4, _cfg("torch"))
    assert int(tn) == int(jn) > 0
    for f in ("kf_obs", "pt_valid", "pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(tm2, f).numpy(), np.asarray(getattr(jm2, f)), f)
    assert (np.asarray(jm2.kf_obs)[4] != obs[4]).sum() > 0
