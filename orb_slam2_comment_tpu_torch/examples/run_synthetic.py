"""End-to-end SLAM drive on a synthetic sequence with exact ground truth —
the port's twin of `examples/run_synthetic.py`.

Mirrors the shape of the reference's dataset drivers
(Examples/Stereo/stereo_kitti.cc:35-110: load -> per-frame Track -> timing
stats -> trajectory save), on a scene it renders itself. Prints per-frame
tracking state and the final ATE RMSE against ground truth. The tracker
runs on CUDA unless `--device cpu` is given.

    python -m orb_slam2_comment_tpu_torch.examples.run_synthetic --sensor rgbd --frames 30
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sensor", default="rgbd", choices=["rgbd", "stereo", "mono"])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--trajectory", default="jitter", choices=["jitter", "forward", "orbit"])
    ap.add_argument("--n-features", type=int, default=600)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--local-ba", action="store_true", help="enable local BA")
    ap.add_argument("--save", default=None, help="save TUM trajectory to file")
    args = ap.parse_args(argv)

    from orb_slam2_comment_tpu_torch.models.tracking import Tracker
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.utils.config import MONOCULAR, SlamConfig

    K = syn.DEFAULT_K
    b = syn.DEFAULT_BASELINE
    sensor = MONOCULAR if args.sensor == "mono" else args.sensor
    cfg = SlamConfig(
        sensor=sensor,
        fx=K[0], fy=K[1], cx=K[2], cy=K[3],
        bf=K[0] * b,
        n_features=args.n_features,
        n_levels=4,
        enable_local_ba=args.local_ba,
        match_th_scale=1.5,
    )

    scene = syn.make_scene(n_points=1400, seed=0)
    poses = syn.make_trajectory(args.trajectory, n_frames=args.frames, step=0.05)
    tracker = Tracker(cfg, device=args.device)

    est, gt, times = [], [], []
    frames = syn.render_sequence(
        scene, poses, K=K, stereo=args.sensor == "stereo", depth=args.sensor == "rgbd",
        baseline=b)
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        if args.sensor == "rgbd":
            out = tracker.track_rgbd_arrays(i, f["timestamp"], f["image"], f["depth"])
        elif args.sensor == "stereo":
            out = tracker.track_stereo_arrays(i, f["timestamp"], f["image"], f["image_right"])
        else:
            out = tracker.track_mono_arrays(i, f["timestamp"], f["image"])
        dt = time.perf_counter() - t0
        times.append(dt)
        state = {1: "OK", 2: "LOST", 0: "INIT", -1: "START"}.get(out.state, "?")
        print(
            f"frame {i:3d}: {state:5s} inliers={out.n_inliers:4d} "
            f"kf={'*' if out.created_kf else ' '} map_pts={tracker.n_pts:5d} "
            f"kfs={tracker.n_kfs:3d} {dt*1e3:7.1f} ms"
        )
        if out.Tcw is not None:
            est.append(np.asarray(out.Tcw))
            gt.append(f["Tcw_gt"])

    if len(est) < 2:
        print("TRACKING FAILED: no poses estimated")
        sys.exit(1)

    # ATE RMSE on camera centers, aligned at the first tracked frame
    def centers(Ts, T0):
        out = []
        T0inv = np.linalg.inv(T0)
        for T in Ts:
            Ta = T @ T0inv  # pose relative to first frame's camera
            R, t = Ta[:3, :3], Ta[:3, 3]
            out.append(-R.T @ t)
        return np.stack(out)

    c_est = centers(est, est[0])
    c_gt = centers(gt, gt[0])
    ate = np.sqrt(np.mean(np.sum((c_est - c_gt) ** 2, axis=1)))
    times = np.asarray(times[2:])  # skip the first frames' one-time costs
    print(f"\ntracked {len(est)}/{args.frames} frames")
    print(f"ATE RMSE: {ate*100:.2f} cm over "
          f"{np.linalg.norm(np.diff(c_gt, axis=0), axis=1).sum():.2f} m trajectory")
    print(f"median frame time: {np.median(times)*1e3:.1f} ms  "
          f"(={1.0/np.median(times):.1f} fps)")

    if args.save:
        from orb_slam2_comment_tpu_torch.utils.trajectory import save_tum

        save_tum(args.save, [f / 20.0 for f in range(len(est))], est)
        print(f"saved trajectory to {args.save}")
    return ate


if __name__ == "__main__":
    main()
