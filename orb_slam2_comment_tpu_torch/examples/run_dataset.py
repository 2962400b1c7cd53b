"""Dataset drivers with the reference's argv signatures — the port's twin
of `examples/run_dataset.py`.

One entry point covering the reference's six CLI drivers (Examples/
{Monocular,Stereo,RGB-D}); the thin modules beside this one keep each
driver's argv shape (e.g. `rgbd_tum vocabulary settings sequence
associations`).

Shape per the reference (Examples/Stereo/stereo_kitti.cc:35-110): load
image list -> System ctor -> per-frame Track* with timing -> save
trajectory -> print timing stats. The System runs on CUDA unless
`--device cpu` is given; without a card it raises.

    python -m orb_slam2_comment_tpu_torch.examples.run_dataset rgbd tum_rgbd SEQ \\
        --settings SEQ/settings.yaml --associations SEQ/associations.txt [--device cpu]
"""

import argparse
import os
import time

import numpy as np
import torch


def run(sensor, dataset, seq_dir, settings=None, vocabulary=None,
        associations=None, timestamps=None, out_prefix="trajectory",
        max_frames=None, runs=None, prestage=None, device="cuda", timings=None,
        walls=None):
    """runs>1 replays the sequence with a fresh System per run and reports
    timing from the LAST run: the first pays the one-time costs (the CUDA
    context, kernel loads, torch's first calls). Runs are bit-identical, so
    the warm run's trajectory is the cold run's.

    prestage=True decodes every frame and copies its arrays to the device
    before the timed loop, as a production input pipeline would: the
    reference's driver also keeps image IO out of its timer (chrono
    brackets TrackRGBD alone, Examples/RGB-D/rgbd_tum.cc:84-104).

    `timings`, when a list, receives the last run's per-call seconds (the
    dispatch latency of each track_* call); `walls`, when a list, receives
    the last run's wall seconds with the final drain included.
    Returns the last run's System."""
    from orb_slam2_comment_tpu_torch.models.frame import depth_to_tensor
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.models.tracking import OK
    from orb_slam2_comment_tpu_torch.utils import datasets as ds
    from orb_slam2_comment_tpu_torch.utils.config import (
        SlamConfig, load_rectification, load_yaml_settings, resolve_device)

    dev = resolve_device(device, "run_dataset")
    if runs is None:  # env defaults so the argv-parity shims inherit them
        runs = int(os.environ.get("RUN_RUNS", "1"))
    if prestage is None:
        prestage = os.environ.get("RUN_PRESTAGE", "") not in ("", "0")

    if settings:
        cfg = load_yaml_settings(settings, sensor)
    else:
        cfg = SlamConfig(sensor=sensor)

    if dataset == "tum_mono":
        items = ds.load_tum_mono(seq_dir)
    elif dataset == "tum_rgbd":
        items = ds.load_tum_rgbd(seq_dir, associations)
    elif dataset == "kitti":
        items = ds.load_kitti(seq_dir, stereo=sensor == "stereo")
    elif dataset == "euroc":
        items = ds.load_euroc(seq_dir, timestamps, stereo=sensor == "stereo")
    else:
        raise ValueError(dataset)
    if max_frames:
        items = items[:max_frames]

    # EuRoC-style online rectification (stereo_euroc.cc:63-98): applied
    # when the settings YAML carries LEFT./RIGHT. calibration blocks
    rect_maps = None
    if sensor == "stereo" and settings:
        rect = load_rectification(settings)
        if rect is not None:
            rect_maps = ds.stereo_rectify_maps(*rect[:8], rect[8])

    def rectified(f):
        if sensor == "stereo" and rect_maps is not None:
            f["image"] = ds.remap(f["image"], *rect_maps[0])
            f["image_right"] = ds.remap(f["image_right"], *rect_maps[1])
        return f

    staged = None
    if prestage:
        staged = []
        for f in ds.FramePrefetcher(items, lookahead=8, threads=4):
            f = rectified(f)
            g = {"timestamp": f["timestamp"],
                 "image": torch.from_numpy(f["image"]).to(dev)}
            if sensor == "rgbd":
                g["depth"] = depth_to_tensor(f["depth"], dev)
            elif sensor == "stereo":
                g["image_right"] = torch.from_numpy(f["image_right"]).to(dev)
            staged.append(g)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"prestaged {len(staged)} frames to {dev}")

    system = None
    times = []
    for run_idx in range(max(runs, 1)):
        if system is not None:
            system.shutdown()  # drain before discarding the cold system
        system = System(cfg, vocabulary_path=vocabulary, device=dev)
        times = []
        # frames arrive in sensor-native dtypes (u8 gray, u16 raw depth —
        # the device applies DepthMapFactor, mirroring Tracking.cc:222-231)
        loader = staged if staged is not None else ds.FramePrefetcher(
            items, lookahead=8, threads=4)
        if runs > 1:
            print(f"--- run {run_idx + 1}/{runs} "
                  f"{'(timed)' if run_idx == runs - 1 else '(warm-up)'} ---")
        t_run0 = time.perf_counter()
        for i, f in enumerate(loader):
            t0 = time.perf_counter()
            if sensor == "rgbd":
                out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
            elif sensor == "stereo":
                if staged is None:
                    f = rectified(f)
                out = system.track_stereo(f["image"], f["image_right"], f["timestamp"])
            else:
                out = system.track_monocular(f["image"], f["timestamp"])
            dt = time.perf_counter() - t0
            times.append(dt)
            # reading an output waits for its frame: only where it prints
            if i % 20 == 0:
                print(f"frame {i}/{len(items)} state={out.state} "
                      f"inl={out.n_inliers} {dt*1e3:.1f}ms")

    system.shutdown()
    # end-to-end wall of the LAST run including the final drain (the
    # reference's timer never sees its LocalMapping/LoopClosing tail)
    run_wall = time.perf_counter() - t_run0
    print(f"run wall incl. drain: {run_wall:.2f} s "
          f"({len(times)/max(run_wall, 1e-9):.1f} fps)")
    n_ok = sum(1 for r in system.trajectory if r[3] == OK)
    print(f"tracked frames: {n_ok}/{len(times)}")
    system.save_trajectory_tum(f"{out_prefix}_tum.txt")
    system.save_trajectory_kitti(f"{out_prefix}_kitti.txt")
    system.save_keyframe_trajectory_tum(f"{out_prefix}_kf_tum.txt")
    t = np.asarray(times[5:]) if len(times) > 10 else np.asarray(times)
    # a fused frame resolves after its call returns: these time dispatch
    print("per-call dispatch latency (frames resolve later; see run wall incl. drain):")
    print(f"median tracking time: {np.median(t)*1e3:.1f} ms")
    print(f"mean tracking time:   {np.mean(t)*1e3:.1f} ms")
    print(f"p99 tracking time:    {np.percentile(t, 99)*1e3:.1f} ms")
    if os.environ.get("RUN_DUMP"):
        worst = np.argsort(t)[-12:][::-1]
        for i in worst:
            print(f"# slow frame {i+5:4d}: {t[i]*1e3:8.1f} ms")
    if timings is not None:
        timings.extend(times)
    if walls is not None:
        walls.append(run_wall)
    return system


def shim(sensor, dataset, argv, names, out_prefix):
    """The reference drivers' positional argv: vocabulary ('-' or 'none'
    for the packaged one), settings, sequence, then `names` (associations
    or timestamps); `--device` may follow."""
    ap = argparse.ArgumentParser()
    for n in ("vocabulary", "settings", "sequence") + names:
        ap.add_argument(n)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    voc = None if a.vocabulary in ("-", "none") else a.vocabulary
    return run(sensor, dataset, a.sequence, settings=a.settings, vocabulary=voc,
               out_prefix=out_prefix, device=a.device,
               **{n: getattr(a, n) for n in names})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sensor", choices=["monocular", "stereo", "rgbd"])
    ap.add_argument("dataset", choices=["tum_mono", "tum_rgbd", "kitti", "euroc"])
    ap.add_argument("sequence")
    ap.add_argument("--settings")
    ap.add_argument("--vocabulary")
    ap.add_argument("--associations")
    ap.add_argument("--timestamps")
    ap.add_argument("--out-prefix", default="trajectory")
    ap.add_argument("--max-frames", type=int)
    ap.add_argument("--runs", type=int,
                    default=int(os.environ.get("RUN_RUNS", "1")),
                    help="replays per process; timing from the last run")
    ap.add_argument("--prestage", action="store_true",
                    default=os.environ.get("RUN_PRESTAGE", "") not in ("", "0"),
                    help="decode all frames and copy them to the device before tracking")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    a = ap.parse_args(argv)
    run(a.sensor, a.dataset, a.sequence, a.settings, a.vocabulary,
        a.associations, a.timestamps, a.out_prefix, a.max_frames,
        runs=a.runs, prestage=a.prestage, device=a.device)


if __name__ == "__main__":
    main()
