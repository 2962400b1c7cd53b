"""Distributed bundle adjustment over `torch.distributed` — the port of
`orb_slam2_comment_tpu/parallel/dist_ba.py`.

The observations (or the pose graph's edges) are split into one
contiguous block per rank; the camera and point state stays replicated.
Each rank runs the single-process solver of `ops/optim.py` on its block
with `reduce` set to an all-reduce (SUM), so every partial sum over the
observation or edge axis (the normal-equation blocks, each CG matvec's
partials, the right-hand side, the back-substitution, the costs) is
combined across ranks, and every rank then takes the same step. JAX
leaves the same collectives to GSPMD, which inserts a psum wherever a
sharded axis is summed.

The backend is the caller's choice (`init_process_group`): NCCL for CUDA
tensors with one card per rank, gloo on the CPU, or gloo for several ranks
sharing one card. An all-reduce adds the ranks' partial sums in its own
order, so results at world size > 1 match a single process to a
tolerance, not bit for bit; at world size 1 they are bit-identical.

    python -m orb_slam2_comment_tpu_torch.parallel.dist_worker RANK WORLD PORT \\
        [--device cpu|cuda] [--backend gloo|nccl]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import optim

# all-reduce calls made by `reduce_fn`s and the bytes they carried
stats = {"calls": 0, "bytes": 0}


def make_group(group=None):
    """(group, rank, world size) of `group`, or of the default group. Raises
    when torch.distributed is not initialized: there is no silent world of
    one."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "torch.distributed.init_process_group first")
    group = group if group is not None else dist.group.WORLD
    return group, dist.get_rank(group), dist.get_world_size(group)


def reduce_fn(group):
    """The `reduce` hook of ops/optim.py: SUM over the ranks of `group`.
    The result keeps the input's strides: the solvers' next products round
    differently on a transposed and a contiguous operand, and a world of
    one must reproduce the single-process result bit for bit."""

    def all_reduce(t):
        u = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(u, op=dist.ReduceOp.SUM, group=group)
        stats["calls"] += 1
        stats["bytes"] += u.numel() * u.element_size()
        return u if t.is_contiguous() else torch.empty_like(t).copy_(u)

    return all_reduce


def _pad_rows(x, pad: int, fill):
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                    device=x.device)])


def pad_problem(prob: optim.BAProblem, multiple: int) -> optim.BAProblem:
    """Pad the observation axis to a multiple of `multiple`; padded
    observations carry obs_valid=False and weigh zero."""
    O = prob.obs_cam.shape[0]
    pad = -(-O // multiple) * multiple - O
    if pad == 0:
        return prob
    return prob._replace(
        obs_cam=_pad_rows(prob.obs_cam, pad, 0),
        obs_pt=_pad_rows(prob.obs_pt, pad, 0),
        obs_uvr=_pad_rows(prob.obs_uvr, pad, 0.0),
        obs_oct=_pad_rows(prob.obs_oct, pad, 0),
        obs_stereo=_pad_rows(prob.obs_stereo, pad, False),
        obs_valid=_pad_rows(prob.obs_valid, pad, False),
    )


def shard_problem(prob: optim.BAProblem, rank: int, world: int) -> optim.BAProblem:
    """This rank's contiguous block of the padded observations (JAX's
    P(BA_AXIS) split); cameras and points stay whole."""
    prob = pad_problem(prob, world)
    n = prob.obs_cam.shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    return prob._replace(obs_cam=prob.obs_cam[sl], obs_pt=prob.obs_pt[sl],
                         obs_uvr=prob.obs_uvr[sl], obs_oct=prob.obs_oct[sl],
                         obs_stereo=prob.obs_stereo[sl], obs_valid=prob.obs_valid[sl])


def _all_gather_rows(x, group, world: int):
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def distributed_global_ba(prob: optim.BAProblem, inv_sigma2_levels, K, bf, group=None,
                          iters: int = 10, cg_iters: int = 40) -> optim.BAResult:
    """The matrix-free Schur/PCG global BA with the observations split over
    the ranks. Every rank returns the whole result; obs_inlier is gathered
    back to the problem's observation axis (padding cut)."""
    group, rank, world = make_group(group)
    O = prob.obs_cam.shape[0]
    local = shard_problem(prob, rank, world)
    res = optim.global_bundle_adjustment(local, inv_sigma2_levels, K, bf, iters=iters,
                                         cg_iters=cg_iters, reduce=reduce_fn(group))
    inl = _all_gather_rows(res.obs_inlier.to(torch.uint8), group, world)[:O].bool()
    return res._replace(obs_inlier=inl)


def _shard_edges(edge_i, edge_j, edge_Sji, edge_valid, rank: int, world: int):
    """Pad the edges to a multiple of the world size (identity Sji,
    edge_valid=False) and keep this rank's contiguous block."""
    E = edge_i.shape[0]
    pad = -(-E // world) * world - E
    if pad:
        eye = torch.eye(4, dtype=edge_Sji.dtype, device=edge_Sji.device)
        edge_i = _pad_rows(edge_i, pad, 0)
        edge_j = _pad_rows(edge_j, pad, 0)
        edge_Sji = torch.cat([edge_Sji, eye.expand(pad, 4, 4)])
        edge_valid = _pad_rows(edge_valid, pad, False)
    n = (E + pad) // world
    sl = slice(rank * n, (rank + 1) * n)
    return edge_i[sl], edge_j[sl], edge_Sji[sl], edge_valid[sl]


def distributed_essential_graph(S0, kf_valid, kf_fixed, edge_i, edge_j, edge_Sji, edge_valid,
                                group=None, fix_scale: bool = False,
                                iters: int | None = None) -> optim.PoseGraphResult:
    """The dense essential-graph solve (Optimizer::OptimizeEssentialGraph)
    with the edges split over the ranks: one all-reduce of H and b per
    Gauss-Newton iteration (and of each cost), the [7K, 7K] solve on every
    rank."""
    group, rank, world = make_group(group)
    edges = _shard_edges(edge_i, edge_j, edge_Sji, edge_valid, rank, world)
    kw = {} if iters is None else {"iters": iters}
    return optim.essential_graph_optimize(S0, kf_valid, kf_fixed, *edges, fix_scale=fix_scale,
                                          reduce=reduce_fn(group), **kw)


def distributed_essential_graph_sparse(S0, kf_valid, kf_fixed, edge_i, edge_j, edge_Sji,
                                       edge_valid, group=None, fix_scale: bool = False,
                                       iters: int | None = None,
                                       cg_iters: int = 300) -> optim.PoseGraphResult:
    """The matrix-free essential graph with the edges split over the ranks:
    each CG matvec all-reduces its [K, 7] partial, whatever the edge count."""
    group, rank, world = make_group(group)
    edges = _shard_edges(edge_i, edge_j, edge_Sji, edge_valid, rank, world)
    kw = {} if iters is None else {"iters": iters}
    return optim.essential_graph_optimize_sparse(S0, kf_valid, kf_fixed, *edges,
                                                 fix_scale=fix_scale, cg_iters=cg_iters,
                                                 reduce=reduce_fn(group), **kw)


def distributed_local_ba(m, kf_id: int, cfg, group=None, iters: int = 15, cg_iters: int = 20):
    """The local-mapping BA window (Optimizer::LocalBundleAdjustment), built
    as the chunked mapper builds it (local_mapping.build_ba_window) and
    solved by distributed_global_ba. Returns (BAResult, window BAProblem,
    cam_ids, pt_ids); write back with local_mapping.scatter_ba_result."""
    from orb_slam2_comment_tpu_torch.models.local_mapping import build_ba_window

    prob, cam_ids, pt_ids = build_ba_window(m, kf_id, cfg)
    inv_s2 = torch.tensor([1.0 / cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)],
                          dtype=torch.float32, device=prob.cam_T.device)
    res = distributed_global_ba(prob, inv_s2, cfg.K, cfg.bf, group, iters=iters,
                                cg_iters=cg_iters)
    return res, prob, cam_ids, pt_ids


def _se3_exp_np(xi) -> np.ndarray:
    return geo.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def make_synthetic_ba_problem(n_cams=8, n_pts=128, obs_per_cam=64, seed=0,
                              K=(500.0, 500.0, 320.0, 240.0), bf=100.0, noise=0.3,
                              perturb=0.02, device=None):
    """Synthetic BA problem with known ground truth: the reference's draws
    from np.random.default_rng(seed), in the same order. Returns
    (BAProblem on `device` (None: CUDA), ground-truth Tcw [n_cams, 4, 4],
    ground-truth points [n_pts, 3])."""
    from orb_slam2_comment_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device, "make_synthetic_ba_problem")
    r = np.random.default_rng(seed)
    X_gt = r.uniform(-4, 4, (n_pts, 3)).astype(np.float32) + [0, 0, 10]
    # the trajectory spans ~2.4 m whatever n_cams, so every camera keeps the
    # point cloud (z ~ 10) in view
    step = 2.4 / max(n_cams - 1, 1)
    rot = 0.08 / max(n_cams - 1, 1)
    cams = np.stack([
        _se3_exp_np([step * i, 0.03 * step * i, 0.07 * step * i, 0.0, rot * i, 0.0])
        for i in range(n_cams)])
    obs_cam, obs_pt, obs_uvr = [], [], []
    fx, fy, cx, cy = K
    for c in range(n_cams):
        pts_sel = r.choice(n_pts, size=obs_per_cam, replace=False)
        Xc = X_gt[pts_sel] @ cams[c][:3, :3].T + cams[c][:3, 3]
        u = fx * Xc[:, 0] / Xc[:, 2] + cx
        v = fy * Xc[:, 1] / Xc[:, 2] + cy
        ur = u - bf / Xc[:, 2]
        uvr = np.stack([u, v, ur], 1) + r.normal(0, noise, (obs_per_cam, 3))
        obs_cam.extend([c] * obs_per_cam)
        obs_pt.extend(pts_sel.tolist())
        obs_uvr.append(uvr)
    O = len(obs_cam)
    cam_T0 = cams.copy()
    for c in range(2, n_cams):
        d = r.normal(0, perturb, 6).astype(np.float32)
        cam_T0[c] = _se3_exp_np(d) @ cam_T0[c]
    pts0 = X_gt + r.normal(0, perturb * 2, X_gt.shape).astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    prob = optim.BAProblem(
        cam_T=t(cam_T0, torch.float32),
        cam_fixed=t([True, True] + [False] * (n_cams - 2), torch.bool),
        cam_valid=torch.ones(n_cams, dtype=torch.bool, device=dev),
        pts=t(pts0, torch.float32),
        pt_valid=torch.ones(n_pts, dtype=torch.bool, device=dev),
        obs_cam=t(obs_cam, torch.int32),
        obs_pt=t(obs_pt, torch.int32),
        obs_uvr=t(np.concatenate(obs_uvr), torch.float32),
        obs_oct=torch.zeros(O, dtype=torch.int32, device=dev),
        obs_stereo=torch.ones(O, dtype=torch.bool, device=dev),
        obs_valid=torch.ones(O, dtype=torch.bool, device=dev),
    )
    return prob, cams, X_gt
