"""Standalone AR demo — the port's twin of `examples/ar_demo.py` (the
reference's monoAR node without ROS, Examples/ROS/ORB_SLAM2/src/AR/
ros_mono_ar.cc + ViewerAR.cc): track the synthetic RGB-D sequence, RANSAC-fit
a plane to the tracked map points, insert a virtual cube and render it into
each frame, written as PNG to --out.

    python -m orb_slam2_comment_tpu_torch.examples.ar_demo [--frames N] [--out DIR] \\
        [--device cpu]
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="ar_demo_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (default cuda)")
    args = ap.parse_args(argv)

    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils import ar, pngio
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    K = syn.DEFAULT_K
    cfg = SlamConfig(
        sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
        bf=K[0] * syn.DEFAULT_BASELINE, n_features=800, n_levels=4,
        max_keyframes=64, max_points=16384, match_th_scale=1.5,
    )
    scene = syn.make_scene(n_points=1500, seed=0, planar_frac=0.55)
    poses = syn.make_trajectory("jitter", n_frames=args.frames, step=0.03)
    system = System(cfg, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    plane = None
    n_drawn = 0
    for i, f in enumerate(syn.render_sequence(scene, poses, K=K, depth=True)):
        out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        if out.state != 1 or out.Tcw is None:
            continue
        assoc = system.get_tracked_map_points()
        if plane is None and len(assoc) >= 50:
            pts = system.tracker.map.pt_pos.cpu().numpy()[assoc]
            plane = ar.detect_plane(pts, np.asarray(out.Tcw), seed=0)
            if plane is not None:
                print(f"frame {i}: plane detected, inserting cube")
        if plane is not None:
            img = ar.render_cube(f["image"], np.asarray(out.Tcw), K, plane[0], plane[1],
                                 size=0.4)
            pngio.write(f"{args.out}/ar_{i:04d}.png", img)
            n_drawn += 1
    system.shutdown()
    print(f"rendered {n_drawn} AR frames to {args.out}")
    return 0 if n_drawn > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
