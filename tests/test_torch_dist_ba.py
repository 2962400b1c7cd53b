"""Parity of the port's dense-Schur local BA and distributed BA
(orb_slam2_comment_tpu_torch.ops.optim.local_bundle_adjustment,
orb_slam2_comment_tpu_torch.parallel.dist_ba) with the JAX package on the
CPU. Ranks 2 and 4 run as processes of parallel.dist_worker over gloo on
127.0.0.1; world size 1 runs in this process."""

import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = (500.0, 500.0, 320.0, 240.0)
BF = 100.0
INV_S2 = [1.0 / (1.2 ** (2 * l)) for l in range(8)]
WORKER_ITERS = 4   # parallel/dist_worker.py's GBA iterations


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pose_err(Ta, Tb):
    """|se3_log(Ta Tb^-1)| per camera, in float64."""
    from orb_slam2_comment_tpu_torch.ops import geometry as geo

    Ta = torch.as_tensor(np.asarray(Ta), dtype=torch.float64)
    Tb = torch.as_tensor(np.asarray(Tb), dtype=torch.float64)
    return geo.se3_log(Ta @ geo.inv_T(Tb)).norm(dim=-1).numpy()


def _to_torch(jprob):
    from orb_slam2_comment_tpu_torch.ops import optim as topt

    return topt.BAProblem(**{k: torch.from_numpy(np.array(getattr(jprob, k)))
                             for k in jprob._fields})


def _test_optim_problem():
    """tests/test_optim.py's local-BA problem, perturbed as its
    test_recovers_perturbation does: ragged (points visible per camera)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_optim as T

    prob, _, X_gt, r = T.TestLocalBA()._problem()
    cam_T = np.asarray(prob.cam_T).copy()
    for c in range(2, len(cam_T)):
        cam_T[c] = T._make_pose(r.normal(0, 0.02, 6).astype(np.float32)) @ cam_T[c]
    pts = np.asarray(prob.pts) + r.normal(0, 0.05, X_gt.shape).astype(np.float32)
    return prob._replace(cam_T=jnp.asarray(cam_T), pts=jnp.asarray(pts)), T.BF


def _ragged_synthetic():
    """The reference's synthetic problem with a fifth of its observations
    dropped at random, so cameras hold different counts."""
    from orb_slam2_comment_tpu.parallel import dist_ba as jdist

    prob, _, _ = jdist.make_synthetic_ba_problem(n_cams=6, n_pts=96, obs_per_cam=48, seed=5,
                                                 perturb=0.02)
    keep = np.random.default_rng(1).random(prob.obs_cam.shape[0]) < 0.8
    return prob._replace(**{k: jnp.asarray(np.asarray(getattr(prob, k))[keep])
                            for k in prob._fields if k.startswith("obs_")}), BF


@pytest.mark.parametrize("kw", [dict(n_cams=8, n_pts=128, obs_per_cam=64),
                                dict(n_cams=6, n_pts=96, obs_per_cam=48, perturb=0.02, seed=3),
                                dict(n_cams=4, n_pts=32, obs_per_cam=17)],
                         ids=["default", "seed3", "small"])
def test_make_synthetic_ba_problem_matches_jax(kw):
    """Integer and boolean arrays equal, floats within 1e-6 relative (the
    port's se3_exp rounds apart from JAX's by ~4e-9, which moves a
    projection near 500 px by an ulp)."""
    from orb_slam2_comment_tpu.parallel import dist_ba as jdist
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist

    jp, jcams, jX = jdist.make_synthetic_ba_problem(**kw)
    tp, tcams, tX = tdist.make_synthetic_ba_problem(**kw, device="cpu")
    for f in jp._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(tcams, jcams, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tX, jX)


@pytest.mark.parametrize("problem", [_test_optim_problem, _ragged_synthetic],
                         ids=["test_optim", "ragged_synthetic"])
def test_local_ba_ragged_matches_jax(problem):
    """local_bundle_adjustment(cam_major=False) against JAX's: the same
    inlier flags, fixed cameras bit-equal, poses within 1e-3 (se3_log
    norm) and points within 2e-3 m. The reduced camera system's condition
    number is ~3e6 on these problems, and LAPACK's f32 Cholesky rounds
    apart from XLA's: one LM step from systems that agree to 2e-6
    relative already differs by 1e-4 in the pose."""
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu_torch.ops import optim as topt

    jp, bf = problem()
    tp = _to_torch(jp)
    rj = jopt.local_bundle_adjustment(jp, jnp.asarray(INV_S2), K, bf)
    rt = topt.local_bundle_adjustment(tp, torch.tensor(INV_S2), K, bf)
    np.testing.assert_array_equal(rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier))
    assert rt.obs_inlier.float().mean() > 0.95
    fixed = np.asarray(jp.cam_fixed)
    np.testing.assert_array_equal(rt.cam_T.numpy()[fixed], np.asarray(rj.cam_T)[fixed])
    assert _pose_err(rt.cam_T, rj.cam_T).max() < 1e-3
    assert np.abs(rt.pts.numpy() - np.asarray(rj.pts)).max() < 2e-3
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * abs(float(rj.cost))


def test_local_ba_layouts_agree():
    """On a camera-major window, cam_major=True (K4's plain version) and
    the ragged build reach the same solution: poses within 1e-3, equal
    inlier flags."""
    from orb_slam2_comment_tpu_torch.ops import optim as topt
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist

    tp, _, _ = tdist.make_synthetic_ba_problem(n_cams=6, n_pts=96, obs_per_cam=48, seed=3,
                                               device="cpu")
    inv = torch.tensor(INV_S2)
    a = topt.local_bundle_adjustment(tp, inv, K, BF, cam_major=True)
    b = topt.local_bundle_adjustment(tp, inv, K, BF, cam_major=False)
    assert torch.equal(a.obs_inlier, b.obs_inlier)
    assert _pose_err(a.cam_T, b.cam_T).max() < 1e-3
    # one linearization: the two builds agree field by field
    F = tp.cam_T.shape[0]
    from orb_slam2_comment_tpu_torch.ops import lba_cuda

    sa = lba_cuda.build_system(lba_cuda.prep_problem(tp, inv, F), tp.cam_T, tp.pts,
                               tp.obs_valid, True, K, BF)
    sb = topt.build_system_ragged(tp, topt.ragged_plans(tp, F), inv, F, tp.cam_T, tp.pts,
                                  tp.obs_valid, True, K, BF)
    for f in sa._fields:
        x, y = getattr(sa, f).double(), getattr(sb, f).double()
        assert (x - y).abs().max() <= 1e-5 * max(float(x.abs().max()), 1.0), f


def test_pcg_matches_dense_schur():
    """The twin of tests/test_dist_ba.py::test_matches_dense_schur: the
    port's PCG global BA and its dense-Schur local BA within 5e-3."""
    from orb_slam2_comment_tpu_torch.ops import optim as topt
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist

    prob, _, _ = tdist.make_synthetic_ba_problem(n_cams=6, n_pts=96, obs_per_cam=48,
                                                 perturb=0.02, seed=3, device="cpu")
    inv = torch.tensor(INV_S2)
    pcg = topt.global_bundle_adjustment(prob, inv, K, BF, iters=10)
    dense = topt.local_bundle_adjustment(prob, inv, K, BF)
    assert _pose_err(pcg.cam_T[2:], dense.cam_T[2:]).max() < 5e-3


def test_pad_and_shard_problem():
    from orb_slam2_comment_tpu.parallel import dist_ba as jdist
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist

    prob, _, _ = tdist.make_synthetic_ba_problem(n_cams=4, n_pts=32, obs_per_cam=17,
                                                 device="cpu")      # 68, not a multiple of 8
    jprob, _, _ = jdist.make_synthetic_ba_problem(n_cams=4, n_pts=32, obs_per_cam=17)
    padded, jpadded = tdist.pad_problem(prob, 8), jdist.pad_problem(jprob, 8)
    assert padded.obs_cam.shape[0] == 72
    for f in padded._fields:
        np.testing.assert_allclose(getattr(padded, f).numpy(), np.asarray(getattr(jpadded, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert int(padded.obs_valid.sum()) == int(prob.obs_valid.sum())
    assert tdist.pad_problem(prob, 4) is prob
    shards = [tdist.shard_problem(prob, r, 8) for r in range(8)]
    for f in prob._fields:
        if f.startswith("obs_"):
            assert torch.equal(torch.cat([getattr(s, f) for s in shards]), getattr(padded, f))
        else:
            assert all(getattr(s, f) is getattr(prob, f) for s in shards)


def test_make_group_needs_an_initialized_group():
    import torch.distributed as dist
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist

    if dist.is_initialized():
        pytest.fail("a process group is left over from another test")
    with pytest.raises(RuntimeError, match="not initialized"):
        tdist.make_group()


def _circle(device="cpu"):
    from orb_slam2_comment_tpu_torch.parallel.dist_worker import circle_graph

    S_est, S_gt, ei, ej, Sji = circle_graph()
    n = S_est.shape[0]
    return (torch.from_numpy(S_est), torch.ones(n, dtype=torch.bool),
            torch.tensor([True] + [False] * (n - 1)), torch.from_numpy(ei),
            torch.from_numpy(ej), torch.from_numpy(Sji), torch.ones(len(ei), dtype=torch.bool))


def _window_map():
    """A small map made from the synthetic problem (8 keyframes of 96
    observations, 256 points), its numpy arrays for either package, the
    SlamConfig fields of its window and the window's keyframe."""
    from orb_slam2_comment_tpu_torch.models import map_state as ms
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist

    prob, _, _ = tdist.make_synthetic_ba_problem(n_cams=8, n_pts=256, obs_per_cam=96, seed=2,
                                                 device="cpu")
    arrays = ms.to_numpy(ms.empty_map(8, 256, 96))
    arrays.update(
        kf_pose=prob.cam_T.numpy(), kf_valid=np.ones(8, bool),
        kf_xy=prob.obs_uvr[:, :2].numpy().reshape(8, 96, 2),
        kf_uright=prob.obs_uvr[:, 2].numpy().reshape(8, 96),
        kf_feat_valid=np.ones((8, 96), bool), kf_obs=prob.obs_pt.numpy().reshape(8, 96),
        kf_parent=np.arange(-1, 7, dtype=np.int32), pt_pos=prob.pts.numpy(),
        pt_valid=np.ones(256, bool))
    cfg = dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3], bf=BF, n_features=96,
               n_levels=8, max_keyframes=8, max_points=256, grow_capacity=False,
               ba_free_kfs=4, ba_fixed_kfs=4, ba_points=256)
    return arrays, cfg, 7


@pytest.fixture()
def world1():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_world1_bit_identical(world1):
    """At world size 1 every distributed solve equals its single-process
    call bit for bit."""
    from orb_slam2_comment_tpu_torch.models import map_state as ms
    from orb_slam2_comment_tpu_torch.models.local_mapping import build_ba_window
    from orb_slam2_comment_tpu_torch.ops import optim as topt
    from orb_slam2_comment_tpu_torch.parallel import dist_ba as tdist
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    prob, _, _ = tdist.make_synthetic_ba_problem(n_cams=6, n_pts=96, obs_per_cam=47,
                                                 device="cpu")
    inv = torch.tensor(INV_S2)
    a = tdist.distributed_global_ba(prob, inv, K, BF, iters=3)
    b = topt.global_bundle_adjustment(prob, inv, K, BF, iters=3)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    g = _circle()
    assert torch.equal(tdist.distributed_essential_graph(*g).S,
                       topt.essential_graph_optimize(*g).S)
    assert torch.equal(tdist.distributed_essential_graph_sparse(*g, iters=3).S,
                       topt.essential_graph_optimize_sparse(*g, iters=3, cg_iters=300).S)
    arrays, cfg_kw, kf = _window_map()
    m, cfg = ms.from_numpy(arrays), SlamConfig(**cfg_kw)
    res, wprob, cam_ids, pt_ids = tdist.distributed_local_ba(m, kf, cfg, iters=3)
    wprob2, cam_ids2, pt_ids2 = build_ba_window(m, kf, cfg)
    assert torch.equal(cam_ids, cam_ids2) and torch.equal(pt_ids, pt_ids2)
    one = topt.global_bundle_adjustment(wprob2, inv, K, BF, iters=3, cg_iters=20)
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(one, f)), f


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs parallel.dist_worker at world sizes 2 and 4 (all six processes
    at once, one thread each) with the window map; returns
    {world: rank 0's results} and the map."""
    d = tmp_path_factory.mktemp("dist")
    arrays, cfg, kf = _window_map()
    np.savez(d / "map.npz", **arrays, cfg=json.dumps(cfg), kf_id=kf)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        port = _free_port()
        for rank in range(world):
            cmd = [sys.executable, "-m", "orb_slam2_comment_tpu_torch.parallel.dist_worker",
                   str(rank), str(world), str(port), "--device", "cpu", "--backend", "gloo",
                   "--map", str(d / "map.npz"), "--out", str(d / f"w{world}")]
            procs.append((world, rank, subprocess.Popen(
                cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    outs = {}
    try:
        for world, rank, p in procs:
            outs[world, rank] = p.communicate(timeout=120)[0]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (world, rank), out in outs.items():
        assert f"DIST_OK {rank} " in out, f"world {world} rank {rank}:\n{out[-3000:]}"
    res = {w: dict(np.load(d / f"w{w}" / "rank0.npz")) for w in (2, 4)}
    for w in (2, 4):   # every rank holds the same distributed result
        other = np.load(d / f"w{w}" / f"rank{w - 1}.npz")
        assert set(other.files) == {k for k in res[w] if "one" not in k}
        for k in other.files:
            np.testing.assert_array_equal(other[k], res[w][k], err_msg=f"{w} {k}")
    return res, (arrays, cfg, kf)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_gba_matches_single_process(ranks, world):
    """Ranks > 1 against the same solve in one process: poses within 1e-3
    (the all-reduce adds partial sums in another order), equal inliers."""
    r = ranks[0][world]
    assert _pose_err(r["gba_cam_T"], r["one_cam_T"]).max() < 1e-3
    np.testing.assert_array_equal(r["gba_inlier"], r["one_inlier"])


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_gba_matches_jax(ranks, world):
    """Ranks > 1 against JAX's global_bundle_adjustment on the JAX
    package's own synthetic problem: poses within 1e-3."""
    from orb_slam2_comment_tpu.ops import optim as jopt
    from orb_slam2_comment_tpu.parallel import dist_ba as jdist

    prob, cams_gt, _ = jdist.make_synthetic_ba_problem(n_cams=8, n_pts=256, obs_per_cam=96,
                                                       seed=0)
    ref = jopt.global_bundle_adjustment(prob, jnp.asarray(INV_S2), K, BF, iters=WORKER_ITERS)
    r = ranks[0][world]
    assert _pose_err(r["gba_cam_T"], np.asarray(ref.cam_T)).max() < 1e-3
    assert np.mean(r["gba_inlier"] == np.asarray(ref.obs_inlier)) > 0.999


@pytest.mark.parametrize("graph", ["graph", "graph_sparse"])
@pytest.mark.parametrize("world", [2, 4])
def test_distributed_pose_graph_matches_single_process(ranks, world, graph):
    """Both edge-sharded pose graphs on the circle of tests/test_dist_ba.py
    against the single-process solve: within 1e-4, and solved."""
    from orb_slam2_comment_tpu_torch.ops import geometry as geo
    from orb_slam2_comment_tpu_torch.parallel.dist_worker import circle_graph

    r = ranks[0][world]
    np.testing.assert_allclose(r[f"{graph}_S"], r[f"{graph}_one_S"], rtol=0, atol=1e-4)
    S_gt = torch.from_numpy(circle_graph()[1])
    d = geo.sim3_log(torch.from_numpy(r[f"{graph}_S"]) @ geo.inv_T(S_gt)).norm(dim=-1)
    assert float(d.max()) < 0.02


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_local_ba(ranks, world):
    """distributed_local_ba on the map's window: poses within 1e-3 of the
    single-process solve and of JAX's distributed_local_ba over its
    8-device CPU mesh."""
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu.parallel import dist_ba as jdist
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig

    r = ranks[0][world]
    arrays, cfg, kf = ranks[1]
    assert _pose_err(r["lba_cam_T"], r["lba_one_cam_T"]).max() < 1e-3
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    mesh = jdist.make_mesh(jax.devices()[:8])
    jres, jprob, jcam, jpt = jdist.distributed_local_ba(jm, kf, JConfig(**cfg), mesh)
    np.testing.assert_array_equal(r["lba_cam_ids"], np.asarray(jcam))
    np.testing.assert_array_equal(r["lba_pt_ids"], np.asarray(jpt))
    assert _pose_err(r["lba_cam_T"], np.asarray(jres.cam_T)).max() < 1e-3
    np.testing.assert_allclose(r["lba_pts"], np.asarray(jres.pts), rtol=0, atol=2e-3)
    assert np.mean(r["lba_inlier"] == np.asarray(jres.obs_inlier)[:r["lba_inlier"].shape[0]]) \
        > 0.999
