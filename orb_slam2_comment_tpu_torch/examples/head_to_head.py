"""Head-to-head accuracy and latency harness, the port's side of
`tools/head_to_head.py`: the port's dataset drivers over the on-disk
sequences of `tools/make_datasets.py` (rendered by the port's
`examples/make_datasets.py` with `--render`), scored by ATE RMSE against
ground truth with Horn/Umeyama alignment (SE3 for RGB-D and stereo, Sim3
for mono, the TUM benchmark convention), with the warm run's fps over
its wall time, the final drain included, and each call's dispatch
latency. The reference's side (the C++ binaries) is not run here.

    python -m orb_slam2_comment_tpu_torch.examples.head_to_head --seq desk \
        [--render DIR | --data DIR] [--out build/h2h_torch] [--device cpu]

Results are merged into OUT/results.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from orb_slam2_comment_tpu_torch.utils import trajectory as traj

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DATA = os.path.join(REPO, "data", "synth")

SEQS = {
    "room_loop": {"kind": "tum_rgbd", "fps": 30.0},
    "desk": {"kind": "tum_rgbd", "fps": 30.0},
    "street": {"kind": "kitti_stereo", "fps": 10.0},
    # monocular on the SAME desk sequence (both systems' mono_tum).
    # Scored on the KEYFRAME trajectory with Sim3 alignment — the
    # reference's mono driver only saves KeyFrameTrajectory.txt
    # (Examples/Monocular/mono_tum.cc) and mono scale is free.
    "desk_mono": {"kind": "tum_mono", "fps": 30.0, "dir": "desk"},
}


# ---------------------------------------------------------------------------
# Trajectory file parsing + evaluation
# ---------------------------------------------------------------------------

def load_tum_traj(path):
    """-> (ts [N], Twc [N,4,4])"""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = v[:8]
            n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
            qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
            R = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                 1 - 2 * (qx * qx + qy * qy)],
            ])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            ts.append(t)
            poses.append(T)
    return np.array(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def load_kitti_traj(path):
    """-> Twc [N,4,4] (one pose per frame, row-major 3x4)."""
    poses = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) < 12:
                continue
            T = np.eye(4)
            T[:3, :] = np.array(v[:12]).reshape(3, 4)
            poses.append(T)
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def associate(ts_a, ts_b, max_dt=0.02):
    """Nearest-timestamp matching -> (idx_a, idx_b)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.array(ia, int), np.array(ib, int)


def evaluate_ate(est_centers, gt_centers, with_scale=False):
    """Umeyama-aligned ATE RMSE (meters) + the fitted scale."""
    aligned, (s, _, _) = traj.umeyama_align(
        est_centers, gt_centers, with_scale=with_scale)
    d = aligned - gt_centers
    rmse = float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
    return rmse, s


def eval_tum(traj_path, gt_path, with_scale=False):
    ts_e, T_e = load_tum_traj(traj_path)
    ts_g, T_g = load_tum_traj(gt_path)
    ia, ib = associate(ts_e, ts_g)
    if len(ia) < 10:
        return {"error": f"only {len(ia)} associated poses"}
    ce = T_e[ia][:, :3, 3]
    cg = T_g[ib][:, :3, 3]
    rmse, s = evaluate_ate(ce, cg, with_scale)
    return {"ate_rmse_m": rmse, "scale": s, "n_poses": int(len(ia)),
            "coverage": float(len(ia)) / max(len(ts_g), 1)}


def eval_kitti(traj_path, gt_path, n_frames, with_scale=False):
    T_e = load_kitti_traj(traj_path)
    T_g = load_kitti_traj(gt_path)
    n = min(len(T_e), len(T_g))
    if n < 10:
        return {"error": f"only {n} poses"}
    rmse, s = evaluate_ate(T_e[:n, :3, 3], T_g[:n, :3, 3], with_scale)
    return {"ate_rmse_m": rmse, "scale": s, "n_poses": int(n),
            "coverage": float(len(T_e)) / max(n_frames, 1)}


# ---------------------------------------------------------------------------
# The port's runs
# ---------------------------------------------------------------------------

_DRIVERS = {"tum_rgbd": "rgbd_tum", "tum_mono": "mono_tum", "kitti_stereo": "stereo_kitti"}


def run_ours(seq: str, workdir: str, repeat: int = 2, data: str = DATA,
             device: str = "cuda") -> dict:
    """The port's argv twin of the reference's driver on `seq`, in a new
    process, with `--runs repeat` (default 2: timing from the warm run, in a
    fresh System, after the one-time CUDA context and kernel loads) and
    prestaged frames (decoded and on the device before the timed loop, as
    the reference's timer brackets Track* alone,
    Examples/RGB-D/rgbd_tum.cc:84-104). Runs are bit-identical, so the warm
    run's trajectory is the cold run's."""
    info = SEQS[seq]
    seq_dir = os.path.join(data, info.get("dir", seq))
    settings = os.path.join(seq_dir, "settings.yaml")
    os.makedirs(workdir, exist_ok=True)
    cmd = [sys.executable, "-u", "-m",
           f"orb_slam2_comment_tpu_torch.examples.{_DRIVERS[info['kind']]}",
           "-", settings, seq_dir]
    if info["kind"] == "tum_rgbd":
        cmd.append(os.path.join(seq_dir, "associations.txt"))
    cmd += ["--device", device]
    env = dict(os.environ, RUN_RUNS=str(max(repeat, 1)), RUN_PRESTAGE="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                                     if p]))
    t0 = time.time()
    p = subprocess.run(cmd, cwd=workdir, capture_output=True, text=True, timeout=5400, env=env)
    wall = time.time() - t0
    out = p.stdout + p.stderr
    res = {"wall_s": wall, "rc": p.returncode, "runs_in_process": max(repeat, 1),
           "prestaged": True, "device": device}
    # per-call times: the dispatch latency of a track_* call (a fused
    # frame resolves later, so they do not time a frame)
    for key, name in (("median_track_s", "median"), ("mean_track_s", "mean"),
                      ("p99_track_s", "p99")):
        m = re.search(rf"{name} tracking time:\s+([0-9.e-]+) ms", out)
        if m:
            res[key] = float(m.group(1)) / 1e3
    if "mean_track_s" in res:
        res["dispatch_fps"] = 1.0 / max(res["mean_track_s"], 1e-9)
    # with in-process replays, count loops from the timed (last) run only
    timed_out = out.rsplit("--- run ", 1)[-1]
    res["loops"] = len(re.findall(r"[Ll]oop (closed|detected)", timed_out))
    m = re.search(r"run wall incl\. drain: ([0-9.e-]+) s \(([0-9.]+) fps\)", timed_out)
    if m:
        # the headline: the warm run's frames over its wall, drain included
        res["warm_wall_s"] = float(m.group(1))
        res["fps"] = float(m.group(2))
    m = re.search(r"tracked frames: (\d+)/(\d+)", timed_out)
    if m:
        res["tracked_frames"], res["frames"] = int(m.group(1)), int(m.group(2))
    res["log_tail"] = "\n".join(out.strip().splitlines()[-15:])
    gt = os.path.join(seq_dir, "groundtruth.txt")
    if info["kind"] == "tum_mono":
        kf_path = os.path.join(workdir, "KeyFrameTrajectory_kf_tum.txt")
        if os.path.exists(kf_path):
            res.update(eval_tum(kf_path, gt, with_scale=True))
            full = eval_tum(os.path.join(workdir, "KeyFrameTrajectory_tum.txt"), gt,
                            with_scale=True)
            res["full_traj_ate_rmse_m"] = full.get("ate_rmse_m")
            res["full_traj_n_poses"] = full.get("n_poses")
        else:
            res["error"] = "no trajectory written"
        return res
    if not os.path.exists(os.path.join(workdir, "CameraTrajectory_tum.txt")):
        res["error"] = "no trajectory written"
    elif info["kind"] == "tum_rgbd":
        res.update(eval_tum(os.path.join(workdir, "CameraTrajectory_tum.txt"), gt))
    else:
        n_frames = sum(1 for _ in open(os.path.join(seq_dir, "times.txt")))
        res.update(eval_kitti(os.path.join(workdir, "CameraTrajectory_kitti.txt"),
                              os.path.join(seq_dir, "poses_gt.txt"), n_frames=n_frames))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", action="append", default=None, choices=sorted(SEQS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--repeat", type=int, default=2,
                    help="runs per sequence in one process; timing from the last")
    ap.add_argument("--render", default=None,
                    help="render the sequences into this folder first and read them there")
    ap.add_argument("--data", default=DATA, help="folder of already rendered sequences")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "h2h_torch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seqs = list(SEQS) if args.all or not args.seq else args.seq
    data = args.data
    if args.render:
        from orb_slam2_comment_tpu_torch.examples import make_datasets

        data = os.path.abspath(args.render)
        os.makedirs(data, exist_ok=True)
        for name in dict.fromkeys(SEQS[s].get("dir", s) for s in seqs):
            if not os.path.exists(os.path.join(data, name, "settings.yaml")):
                t0 = time.time()
                make_datasets.ALL[name](data)
                print(f"[{name}] rendered in {time.time() - t0:.0f}s", flush=True)
    results = {}
    for seq in seqs:
        print(f"[{seq}] ours ...", flush=True)
        r = run_ours(seq, os.path.join(args.out, seq, "ours"), repeat=args.repeat, data=data,
                     device=args.device)
        results[seq] = {"ours": r}
        print(f"  -> ate={r.get('ate_rmse_m')} fps={r.get('fps')} rc={r['rc']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "results.json")
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    for seq, d in results.items():
        existing.setdefault(seq, {}).update(d)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1)
    print(json.dumps(results, indent=1))
    return 0 if all(d["ours"]["rc"] == 0 for d in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
