"""Render the on-disk synthetic sequences of `tools/make_datasets.py` with
the port's renderer (utils/render.py, PNG through utils/pngio.py): the
same scenes, trajectories, layouts and settings files, so the port's
drivers and the reference's read identical inputs.

  room_loop  TUM RGB-D, 600 frames @ 30fps, circular loop (loop closure)
  desk       TUM RGB-D, 400 frames @ 30fps, handheld jitter (fr1-style)
  street     KITTI stereo, 400 frames @ 10fps, forward drive

Deterministic (fixed seeds): regenerate rather than commit (~1 GB).

    python -m orb_slam2_comment_tpu_torch.examples.make_datasets OUT_ROOT [--only NAME]
"""

import argparse
import os
import time

from orb_slam2_comment_tpu_torch.utils import render as rr

K_TUM = (520.0, 520.0, 320.0, 240.0)
HW_TUM = (480, 640)
K_KITTI = (718.0, 718.0, 620.0, 188.0)
HW_KITTI = (376, 1241)
BASELINE_KITTI = 0.54  # meters, KITTI-like


def make_room_loop(root: str) -> None:
    out = os.path.join(root, "room_loop")
    scene = rr.make_room(seed=7, size=(8.0, 3.0, 8.0), n_boxes=6)
    poses = rr.room_loop_trajectory(600, radius=1.3, loops=1.15, seed=1)
    rr.write_tum_rgbd(out, scene, poses, K_TUM, HW_TUM, fps=30.0,
                      progress=True)
    rr.write_settings_yaml(
        os.path.join(out, "settings.yaml"), K_TUM, HW_TUM, fps=30.0,
        bf=40.0, depth_factor=rr.DEPTH_FACTOR_TUM, n_features=1000)


def make_desk(root: str) -> None:
    out = os.path.join(root, "desk")
    scene = rr.make_room(seed=13, size=(7.0, 3.0, 7.0), n_boxes=6)
    poses = rr.desk_trajectory(400, seed=3)
    rr.write_tum_rgbd(out, scene, poses, K_TUM, HW_TUM, fps=30.0,
                      progress=True)
    rr.write_settings_yaml(
        os.path.join(out, "settings.yaml"), K_TUM, HW_TUM, fps=30.0,
        bf=40.0, depth_factor=rr.DEPTH_FACTOR_TUM, n_features=1000)


def make_street(root: str) -> None:
    out = os.path.join(root, "street")
    scene = rr.make_street(seed=21, length=110.0)
    poses = rr.street_trajectory(400, length=100.0, seed=5)
    rr.write_kitti_stereo(out, scene, poses, K_KITTI, BASELINE_KITTI,
                          HW_KITTI, fps=10.0, progress=True)
    rr.write_settings_yaml(
        os.path.join(out, "settings.yaml"), K_KITTI, HW_KITTI, fps=10.0,
        bf=K_KITTI[0] * BASELINE_KITTI, n_features=2000, th_depth=40.0)


ALL = {"room_loop": make_room_loop, "desk": make_desk, "street": make_street}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--only", choices=sorted(ALL))
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    os.makedirs(root, exist_ok=True)
    for name, fn in ALL.items():
        if a.only and name != a.only:
            continue
        t0 = time.time()
        print(f"[{name}] generating ...", flush=True)
        fn(root)
        print(f"[{name}] done in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
