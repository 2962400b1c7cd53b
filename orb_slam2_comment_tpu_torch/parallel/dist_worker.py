"""One rank of a multi-process distributed BA — the port's twin of
`tools/dist_worker.py`.

Every rank builds the same synthetic problem (8 cameras, 256 points, 96
observations per camera, seed 0) and solves it with 4 LM iterations of
`distributed_global_ba`, then both distributed pose graphs on a
12-keyframe circle (the sparse one with 5 Gauss-Newton iterations of 300
CG steps: it converges in 3, and each CG step is an all-reduce); with
`--map`, also `distributed_local_ba` on a map read from an npz file. Rank 0 then solves each problem again in its
process alone and prints the largest differences.

    python -m orb_slam2_comment_tpu_torch.parallel.dist_worker RANK WORLD PORT \\
        [--device cpu|cuda] [--backend gloo|nccl] [--map FILE] [--out DIR]

The ranks meet at tcp://127.0.0.1:PORT. `--device cuda` puts every rank
on cuda:0 (NCCL needs one card per rank; ranks that share a card use
gloo). The last line is `DIST_OK <rank> <pose error after the solve>`;
`--out` saves rank RANK's results to DIR/rank<RANK>.npz (rank 0's also
hold the single-process solves, under names with `one`).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

K = (500.0, 500.0, 320.0, 240.0)
BF = 100.0
ITERS = 4
SPARSE_ITERS = 5


def _se3_exp(xi):
    from orb_slam2_comment_tpu_torch.ops import geometry as geo

    return geo.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def circle_graph(n_kf=12, seed=4):
    """The noisy loop of tests/test_dist_ba.py's essential-graph test:
    (S_est, S_gt, edge_i, edge_j, edge_Sji) as numpy arrays."""
    r = np.random.default_rng(seed)
    S_gt = []
    for i in range(n_kf):
        th = 2 * np.pi * i / n_kf
        S_gt.append(_se3_exp([np.sin(th) * 2, 0, (1 - np.cos(th)) * 2, 0, th, 0]))
    S_gt = np.stack(S_gt)
    S_est = [S_gt[0]]
    for i in range(1, n_kf):
        rel_gt = S_gt[i] @ np.linalg.inv(S_gt[i - 1])
        noise = _se3_exp(r.normal(0, 0.02, 6).astype(np.float32))
        S_est.append(noise @ rel_gt @ S_est[i - 1])
    ei, ej, Sji = [], [], []
    for i in range(n_kf - 1):
        ei.append(i)
        ej.append(i + 1)
        Sji.append(S_gt[i + 1] @ np.linalg.inv(S_gt[i]))
    ei.append(n_kf - 1)
    ej.append(0)
    Sji.append(S_gt[0] @ np.linalg.inv(S_gt[n_kf - 1]))
    return (np.stack(S_est), S_gt, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(Sji).astype(np.float32))


def _max_diff(a, b):
    return float((a - b).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--map", default=None,
                    help="npz of MapState arrays plus `kf_id` and `cfg` (JSON of SlamConfig "
                         "fields) for distributed_local_ba")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    from orb_slam2_comment_tpu_torch.ops import optim
    from orb_slam2_comment_tpu_torch.parallel import dist_ba
    from orb_slam2_comment_tpu_torch.utils.config import resolve_device

    dev = resolve_device(a.device, "dist_worker")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // max(a.world, 1)))
    dist.init_process_group(a.backend, init_method=f"tcp://127.0.0.1:{a.port}", rank=a.rank,
                            world_size=a.world, timeout=datetime.timedelta(seconds=120))
    try:
        prob, cams_gt, _ = dist_ba.make_synthetic_ba_problem(
            n_cams=8, n_pts=256, obs_per_cam=96, seed=0, device=dev)
        inv_s2 = torch.tensor([1.0 / 1.2 ** (2 * l) for l in range(8)], device=dev)
        res = dist_ba.distributed_global_ba(prob, inv_s2, K, BF, iters=ITERS)
        gt = torch.from_numpy(cams_gt).to(dev)
        e0 = float((prob.cam_T[:, :3, 3] - gt[:, :3, 3]).norm(dim=1).sum())
        e1 = float((res.cam_T[:, :3, 3] - gt[:, :3, 3]).norm(dim=1).sum())
        print(f"rank {a.rank}: pose err {e0:.4f} -> {e1:.4f}", flush=True)
        if not e1 < 0.5 * e0:
            raise AssertionError(f"the distributed GBA did not converge: {e0} -> {e1}")
        out = dict(gba_cam_T=res.cam_T, gba_pts=res.pts, gba_inlier=res.obs_inlier)
        # name -> (single-process solve, its distributed result's key, what to compare)
        single = {"one": (lambda: optim.global_bundle_adjustment(prob, inv_s2, K, BF,
                                                                 iters=ITERS), "gba")}

        S_est, _, ei, ej, Sji = circle_graph()
        n_kf = S_est.shape[0]
        g = (torch.from_numpy(S_est).to(dev), torch.ones(n_kf, dtype=torch.bool, device=dev),
             torch.tensor([True] + [False] * (n_kf - 1), device=dev),
             torch.from_numpy(ei).to(dev), torch.from_numpy(ej).to(dev),
             torch.from_numpy(Sji).to(dev), torch.ones(len(ei), dtype=torch.bool, device=dev))
        out["graph_S"] = dist_ba.distributed_essential_graph(*g).S
        out["graph_sparse_S"] = dist_ba.distributed_essential_graph_sparse(
            *g, iters=SPARSE_ITERS).S
        single["graph_one"] = (lambda: optim.essential_graph_optimize(*g), "graph")
        single["graph_sparse_one"] = (
            lambda: optim.essential_graph_optimize_sparse(*g, iters=SPARSE_ITERS, cg_iters=300),
            "graph_sparse")

        if a.map:
            from orb_slam2_comment_tpu_torch.models import map_state as ms
            from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

            z = np.load(a.map)
            m = ms.from_numpy({k: z[k] for k in ms.MapState.field_names()}, dev)
            cfg = SlamConfig(**json.loads(str(z["cfg"])))
            lres, lprob, cam_ids, pt_ids = dist_ba.distributed_local_ba(m, int(z["kf_id"]), cfg)
            inv_w = torch.tensor([1.0 / cfg.scale_factor ** (2 * l)
                                  for l in range(cfg.n_levels)], device=dev)
            out.update(lba_cam_T=lres.cam_T, lba_pts=lres.pts, lba_inlier=lres.obs_inlier,
                       lba_cam_ids=cam_ids, lba_pt_ids=pt_ids)
            single["lba_one"] = (lambda: optim.global_bundle_adjustment(
                lprob, inv_w, cfg.K, cfg.bf, iters=15, cg_iters=20), "lba")

        if a.rank == 0:
            for name, (solve, key) in single.items():
                r = solve()
                d = r.S if key.startswith("graph") else r.cam_T
                mine = out[f"{key}_S" if key.startswith("graph") else f"{key}_cam_T"]
                print(f"rank 0: {key} distributed vs one process {_max_diff(mine, d):.3e}",
                      flush=True)
                if key.startswith("graph"):
                    out[f"{name}_S"] = d
                else:
                    out.update({f"{name}_cam_T": r.cam_T, f"{name}_pts": r.pts,
                                f"{name}_inlier": r.obs_inlier})
        if a.out:
            os.makedirs(a.out, exist_ok=True)
            np.savez(os.path.join(a.out, f"rank{a.rank}.npz"),
                     **{k: v.cpu().numpy() for k, v in out.items()})
        print(f"DIST_OK {a.rank} {e1:.6f}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
