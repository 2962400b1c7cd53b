#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the four hand-written CUDA kernels of orb_slam2_comment_tpu_torch
(and, to time against, the earlier designs of K1, K3 and K4 in
prev_kernels/) and checks each against its plain PyTorch version on the
card at the shapes of the RGB-D main path (K1 as one launch over the 8
levels of a 480x640 and of a 376x1241 frame, K3 also as one batched
launch of 5 poses, as relocalization runs it) and at the stereo path's
(K1 and K2 on its first 376x1241 frame with 2000 keypoints, K3 over 2000
edges, K4 on the largest local-BA window of its run and on a window of
the same capacities with 2000 observations per keyframe). Each kernel is
timed three ways: the span of one call (`ms`), 100 calls back to back
(`per_launch_ms`) and calls replayed from a CUDA graph (`device_ms`, no
host dispatch), beside its plain version, its bound and, for K2, the one
PyTorch call that computes the same function. Then it drives eleven
paths of the default `System(cfg, device="cuda")` (loop closing on, as
bench.py builds it) and the distributed BA on their maps, each with the
launch counts set to 0 just before it and read just after:

  main   bench.py's config, scene and forward trajectory: every frame
         tracks, keyframes, local BA and loop detection happen, the
         keyframe database indexes every keyframe, a rerun is bit-identical
         and the trajectory error is small;
  pipeline bench.py's program over main's frames (warm-up resolved
         pipeline_lag frames late until 6 keyframes exist, then prestaged
         images), once with no output read in the timed loop and once with
         out.state read on every frame, each run twice: all four runs give
         bit-identical trajectories, keyframes and points; stage A
         (extraction) runs on its own stream, and a torch.profiler trace of
         20 frames shows K1 on another stream than K3; fps, p50/p90/p99,
         drain, host syncs and device-busy ms per frame for both ways;
  reloc  frames 0-79, 3 textureless frames (LOST), then frames 40-79 again:
         the first returning frame relocalizes through the batched K3;
  loop   the orbit of tests/test_loop_closing.py (56 frames) at the bench
         config: a loop closes, the background global BA is applied, the
         trajectory error is small and a rerun is bit-identical.
  stereo the street configuration of tools/make_datasets.py (376x1241,
         2000 features, KITTI intrinsics and baseline) over 30 frames at
         0.3 m: every frame tracks through System.track_stereo, K1 and K2
         launch twice per frame, the error is small, a rerun is
         bit-identical;
  mono   the 14 frames of tests/test_loop_closing.py:53-77 at the bench
         widths through System.track_monocular: the two-view initializer
         succeeds, later frames track, a rerun is bit-identical.
  facade the rest of the System API at the bench config: frames 0-59
         mapped, the TUM/KITTI/keyframe savers read back, save_map;
         localization mode over frames 60-89 (no keyframe, no local BA);
         visual odometry over frames 90-99 with no map point matchable
         (its K3 problem is held to the plain version afterwards); the saved
         map loaded into a new System, relocalized (in localization mode)
         and mapped again over frames 60-79; the orbit closed with the
         synchronous global BA; the packaged vocabulary read back from
         ORBvoc.txt text.
  grow   the orbit of tests/test_capacity.py's auto-grow test (60 frames)
         at the bench widths with capacity growth on, from the smallest
         tiers (16 keyframes, 8192 points; caps 64 and 32768): growth
         fires, every component agrees on the new tier, K1-K4 launch after
         it, the trajectory error is small and a rerun is bit-identical;
  desk   the 90-frame head of tools/make_datasets.py's desk sequence,
         rendered into data/ by the port's renderer (in a subprocess, while
         the kernels build), run through the port's run_dataset driver on
         its settings.yaml (the default SlamConfig: growth and loop closing
         on) with prestaged frames and 2 runs: ATE < 15 mm; fps over the
         warm run's wall, the drain included.
  staged the bench config in the two modes outside the default: the loop
         path's orbit with fused_tracking=False (the staged ladder on the
         host path, the monolithic mapper per keyframe): every frame
         tracked, a loop closed, the background GBA applied, ATE < 0.10 m,
         a bit-identical rerun; and main's frames 0-59 with
         chunked_mapper=False (the fused step, the monolithic mapper):
         every frame tracked, ATE < 2 cm, the same keyframes on a rerun.
  placerec place recognition at vocabulary scale: the 560 keyframes of
         examples/eval_vocab_pr.py (two traversals of a textured room,
         rendered by a process pool at the start of the path, so that no
         other path's timed window shares the host with it) extracted on
         the card, the second traversal queried against a database of the
         first with the 9991-word vocabulary (dense) and the 97,273-word
         one (the inverted file): recall@1 >= 0.9 each, the card's words,
         top-2 and scores equal to the port's CPU path on 20 queries, and
         on the whole database, past the inverted file's posting cap, its
         scores, shared-word counts and dropped postings equal to the CPU
         path's on the same words; then the loop path's orbit with the
         9991-word vocabulary and with the 97,273-word one, back to back:
         every frame tracked, the loop the JAX package closes on the CPU,
         ATE < 0.10 m, a bit-identical rerun; and the reloc path with it.
  dist   parallel/dist_ba.py on the maps of the main and loop paths: NCCL at
         world size 1 (distributed_global_ba on the loop map's full GBA
         problem, distributed_local_ba on the main path's last keyframe
         window, both distributed pose graphs on the loop's essential graph:
         each bit-identical to its single-process solve), two gloo ranks
         sharing the card (poses within 1e-3 of one process), and
         local_bundle_adjustment on that window in both layouts (K4 launched
         for cam_major=True, poses within 1e-3 of the ragged build); one GBA
         iteration timed at world sizes 1 and 2 and on the synthetic problem
         at the default tier's size, with its all-reduce calls and bytes.
  leftovers the last public pieces on maps already built:
         local_mapping.fuse_into_keyframe on the main path's final map,
         its newest keyframe fused into its best covisible neighbour, on
         the card and on the CPU from the same map (equal association and
         map tables, positions within 1e-5 m); and the main path's last
         local-BA window through local_bundle_adjustment(cam_major=True):
         its K4 launches, every linearization held to the plain version
         within K4_C * 2^-24 * S, poses within 1e-3 of the CPU's solve.

K4 is also held to its plain version on every local-BA window of the
stereo, grow and pipeline paths, entrywise within K4_C * 2^-24 times the
sum of absolute contributions to the entry, and its worst field error is
printed against the active observations per window camera; and on the
largest window the monolithic mapper built in the staged orbit.

    python3 chip_smoke.py [--frames N] [--profile FILE] [--kernels-only]

Run from the repository root. Exits nonzero on any failure and when no
CUDA device is present. The last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_K1 = ("orb_slam2_comment_tpu_torch/csrc/fast_nms.cu", "orb_slam2_comment_tpu/ops/orb.py:302")
_K2 = ("orb_slam2_comment_tpu_torch/csrc/gather_patches.cu",
       "orb_slam2_comment_tpu/ops/orb.py:727")
_K3 = ("orb_slam2_comment_tpu_torch/csrc/pose_lm.cu", "orb_slam2_comment_tpu/ops/lm_pallas.py:301")
_K4 = ("orb_slam2_comment_tpu_torch/csrc/lba_build.cu",
       "orb_slam2_comment_tpu/ops/lba_pallas.py:260")
# the paths at 480x640 and 1000 features, and the stereo path at 376x1241
# and 2000 features: each row reads its kernel's launch count on the paths
# at its shapes
_SMALL = ("main", "pipeline", "reloc", "loop", "mono", "facade", "grow", "desk", "staged",
          "placerec")
KERNEL_ROWS = [
    # name, (source, replaced Pallas call site), kernel counted, paths counted
    ("fast_nms", _K1, "fast_nms", _SMALL),
    ("gather_patches", _K2, "gather_patches", _SMALL),
    ("pose_lm", _K3, "pose_lm", _SMALL),
    ("lba_build", _K4, "lba_build", _SMALL),
    ("pose_lm_batched", _K3, "pose_lm_batched", _SMALL),
    ("fast_nms@376x1241", _K1, "fast_nms", ("stereo",)),
    ("gather_patches@2000", _K2, "gather_patches", ("stereo",)),
    ("pose_lm@2000", _K3, "pose_lm", ("stereo",)),
    ("lba_build@stereo", _K4, "lba_build", ("stereo",)),
    # K3 on the first visual-odometry frame's problem; counts the facade
    # path's VO frames (a subset of the pose_lm row's launches)
    ("pose_lm@vo", _K3, "pose_lm", ("vo",)),
    # K4 on the main path's last local-BA window; counts the dist path's
    # local_bundle_adjustment(cam_major=True) and the leftovers path's
    ("lba_build@lba", _K4, "lba_build", ("dist", "leftovers")),
    # K4 on the largest window the monolithic mapper built in the staged
    # orbit; counts the staged path
    ("lba_build@staged", _K4, "lba_build", ("staged",)),
]
K1_K4 = ("fast_nms", "gather_patches", "pose_lm", "lba_build")


def counters():
    """kernel -> (wrapper, attribute) of its launch count."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, lm_cuda, orb

    return {"fast_nms": (orb.fast_nms_levels, "launches"),
            "gather_patches": (orb.gather_patches, "launches"),
            "pose_lm": (lm_cuda.pose_optimize_lm, "launches"),
            "lba_build": (lba_cuda.build_system, "launches"),
            "pose_lm_batched": (lm_cuda.pose_optimize_lm, "batched_launches")}


def zero_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def cuda_ms(fn, reps=30, warm=3):
    """Median CUDA-event span of one call, in ms (host dispatch included
    where it is longer than the device work)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def per_launch_ms(fn, n=100, reps=5, warm=3):
    """CUDA-event span of n back-to-back calls divided by n, median of
    reps, in ms: the card's time per call once the queue is full."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return float(np.median(times))


def graph_ms(fn, n=20, reps=5):
    """Device time per call: n calls captured in one CUDA graph and
    replayed, so no host dispatch falls inside the timed span; median of
    reps, in ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return float(np.median(times))


# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 minimum and maximum issue at 64 results per SM per clock on compute
# capability 9.0, f32 add at 128 (CUDA C++ Programming Guide, the
# arithmetic-instruction throughput table: "compare, minimum, maximum" and
# "32-bit floating-point add, multiply, multiply-add").
MINMAX_PER_SM_CLOCK = 64


def minmax_rate():
    """f32 min/max the card can issue per second: every SM at the card's
    maximum SM clock (nvidia-smi clocks.max.sm)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * MINMAX_PER_SM_CLOCK * float(mhz) * 1e6


def bound(nbytes, nops, rate=PEAK_F32_FLOPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their rate (f32 FLOP/s unless given)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(nops))


def timed(kernel, plain, plain_reps=10):
    """ms (one call), per_launch_ms (100 back to back), device_ms (calls
    replayed from a CUDA graph) and plain_ms (one call of the plain
    version)."""
    return dict(ms=cuda_ms(kernel), per_launch_ms=per_launch_ms(kernel),
                device_ms=graph_ms(kernel), plain_ms=cuda_ms(plain, reps=plain_reps, warm=1))


def against_earlier(name, new, old, check):
    """A redesigned kernel against its earlier design (prev_kernels/) on the
    same inputs: check(earlier result) holds the earlier one to the same
    tolerance; then the span of one call of each, in turns (earlier, new,
    new, earlier), and each one's back-to-back time."""
    check(old())
    spans = [cuda_ms(old), cuda_ms(new), cuda_ms(new), cuda_ms(old)]
    back = [per_launch_ms(old), per_launch_ms(new)]
    dev = [graph_ms(old), graph_ms(new)]
    print(f"# redesign {name}: span of one call in turns (earlier, new, new, earlier) "
          + " / ".join(f"{t:.4f}" for t in spans)
          + f" ms; back to back: earlier {back[0]:.4f}, new {back[1]:.4f} ms; from a CUDA "
          f"graph: earlier {dev[0]:.4f}, new {dev[1]:.4f} ms", flush=True)
    return dict(earlier_ms=float(np.mean([spans[0], spans[3]])),
                earlier_per_launch_ms=back[0], earlier_device_ms=dev[0], turns_ms=spans)


# Operation counts behind the bounds (f32 add, mul, min, max, compare and
# select count one each).
# K1 per pixel inside the mask (the only pixels it scores), in f32 min/max
# issue slots: the doubling over 2, 4 and 8 ring elements for both
# polarities (2 x 3 x 16), min9/max9 (2 x 16), the extrema over the 16
# arcs (2 x 15) and their max, the mask select, the 8 NMS compares and the
# keep select; the 16 ring differences issue at twice that rate (8 slots).
K1_SLOTS_PER_PX = 2 * 3 * 16 + 2 * 16 + 2 * 15 + 1 + 1 + 8 + 1 + 16 // 2
# K3 per edge and LM iteration: at the current pose, transform (18),
# projection and residuals (12), chi2 (8), Huber weight (4), Jacobian rows
# (20), the 21 + 6 normal-equation sums (27 x 8); at the candidate pose
# transform, projection, residuals, chi2, robust cost and its sum (45).
K3_OPS_PER_EDGE_ITER = 18 + 12 + 8 + 4 + 20 + 27 * 8 + 45
# K4 per active observation: linearisation (residual, chi2, Huber, Jc, Jp:
# 100), weighted rows (27), Hcc lower triangle and bc (21 x 6 + 6 x 6), Hpp
# lower triangle and bp (6 x 6 + 3 x 6), E (18 x 6).
K4_OPS_PER_OBS = 100 + 27 + 21 * 6 + 6 * 6 + 6 * 6 + 3 * 6 + 18 * 6


def bench_config():
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    K = syn.DEFAULT_K
    return SlamConfig(
        sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
        bf=K[0] * syn.DEFAULT_BASELINE, n_features=1000, n_levels=8,
        max_keyframes=128, max_points=32768, grow_capacity=False,
        match_th_scale=1.5, depth_map_factor=1000.0,
    )


def render_frames(n_frames):
    """bench.py's scene and forward trajectory, in sensor dtypes (uint8
    gray, uint16 depth in mm)."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=3200, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=n_frames, step=0.025)
    frames = []
    for f in syn.render_sequence(scene, poses, K=syn.DEFAULT_K, depth=True):
        f["image"] = np.clip(f["image"], 0, 255).astype(np.uint8)
        f["depth"] = np.clip(f["depth"] * 1000.0, 0, 65535).astype(np.uint16)
        frames.append(f)
    return frames


# ---------------------------------------------------------------------------
# kernel vs plain, at the main path's shapes
# ---------------------------------------------------------------------------

def k1_inputs(img, ocfg):
    """One frame's pyramid (the extraction's resizes), its zero-padded
    level stack and the level sizes."""
    from orb_slam2_comment_tpu_torch.ops import orb

    h, w = img.shape
    sizes = ocfg.level_sizes(h, w)
    pyr = [img]
    for lvl in range(1, ocfg.n_levels):
        pyr.append(orb._resize_level(pyr[-1], sizes[lvl]).contiguous())
    return pyr, orb._level_stack(pyr, (h, w)), sizes


def check_k1_levels(pyr, scores, what):
    """K1's scores equal the plain version on every level under
    torch.equal (the sign of a zero may differ) and are 0 outside each
    level's mask. Returns the largest absolute difference."""
    from orb_slam2_comment_tpu_torch import constants as C
    from orb_slam2_comment_tpu_torch.ops import orb

    m = C.EDGE_THRESHOLD
    err = 0.0
    for lv, a in zip(pyr, scores, strict=True):
        b = orb.fast_nms_plain(lv)
        err = max(err, (a - b).abs().max().item())
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs at level {tuple(lv.shape)}: "
                                 f"{(a != b).sum().item()} pixels")
        outside = torch.ones_like(a, dtype=torch.bool)
        outside[m:-m, m:-m] = False
        if (a[outside] != 0).any():
            raise AssertionError(f"{what}: nonzero score outside the mask at level "
                                 f"{tuple(lv.shape)}")
    return err


def kitti_frame():
    """bench.py's scene seen at the KITTI image shape, 376x1241, uint8."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=3200, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    img = syn.render(scene, np.eye(4, dtype=np.float32), (718.856, 718.856, 607.19, 185.22),
                     (376, 1241))
    return np.clip(img, 0, 255).astype(np.uint8)


def k1_measure(pyr, stack, sizes, err, rate):
    """K1's times over one frame's level stack, beside its plain version
    and its bound."""
    from orb_slam2_comment_tpu_torch import constants as C
    from orb_slam2_comment_tpu_torch.ops import orb

    px = sum(lv.numel() for lv in pyr)
    m = 2 * C.EDGE_THRESHOLD
    inside = sum((lh - m) * (lw - m) for lh, lw in sizes)
    return dict(max_abs_err=err, library_ms=None, minmax_per_s=rate,
                **timed(lambda: orb.fast_nms_levels(stack, sizes),
                        lambda: [orb.fast_nms_plain(lv) for lv in pyr]),
                **bound(2 * 4 * px, K1_SLOTS_PER_PX * inside, rate))


def k2_inputs(cfg, img, dev, what):
    """One frame's K1 inputs and scores (held bit-exact to the plain
    version) and K2's start table for its keypoints."""
    from orb_slam2_comment_tpu_torch.ops import orb

    ocfg = cfg.orb
    pyr, stack, sizes = k1_inputs(torch.from_numpy(img).to(dev).float(), ocfg)
    scores = orb.fast_nms_levels(stack, sizes)
    err = check_k1_levels(pyr, scores, what)
    budgets = ocfg.level_budgets()
    xy_all = torch.cat([orb._select_keypoints(s, budgets[i], ocfg.cell, ocfg.min_th)[0]
                        for i, s in enumerate(scores)])
    return pyr, stack, sizes, err, orb._patch_starts(xy_all, ocfg, (cfg.height, cfg.width))


def k2_measure(padded, lyx, dev):
    """K2 bit-exact against its plain version and its library call, with
    its times and bound."""
    from orb_slam2_comment_tpu_torch.ops import orb

    a, b = orb.gather_patches(padded, lyx), orb.gather_patches_plain(padded, lyx)
    if not torch.equal(a, b):
        raise AssertionError(f"K2 differs from its plain version at {lyx.shape[0]} patches")
    # the library call: one advanced-indexing gather with prebuilt indices
    L, Hp, Wp = padded.shape
    P = a.shape[1]
    lv_i = torch.clamp(lyx[:, 0].long(), 0, L - 1)[:, None, None]
    yy = (torch.clamp(lyx[:, 1].long(), 0, Hp - P)[:, None]
          + torch.arange(P, device=dev)[None, :])[:, :, None]
    xx = (torch.clamp(lyx[:, 2].long(), 0, Wp - P)[:, None]
          + torch.arange(P, device=dev)[None, :])[:, None, :]
    if not torch.equal(padded[lv_i, yy, xx], a):
        raise AssertionError("K2's library call differs from the kernel")
    # bytes: each stack pixel some patch covers read once, the patches
    # written once, the start table read once
    covered = torch.zeros_like(padded, dtype=torch.bool)
    covered[lv_i, yy, xx] = True
    return dict(max_abs_err=(a - b).abs().max().item(),
                library_ms=per_launch_ms(lambda: padded[lv_i, yy, xx]),
                **timed(lambda: orb.gather_patches(padded, lyx),
                        lambda: orb.gather_patches_plain(padded, lyx), plain_reps=30),
                **bound(4 * int(covered.sum()) + 4 * a.numel() + 4 * lyx.numel(), 0))


def check_k1_k2(cfg, frame, dev):
    import prev_kernels
    from orb_slam2_comment_tpu_torch.ops import orb

    ocfg = cfg.orb
    pyr, stack, sizes, err, lyx = k2_inputs(cfg, frame["image"], dev, "K1")
    kpyr, kstack, ksizes = k1_inputs(torch.from_numpy(kitti_frame()).to(dev).float(), ocfg)
    check_k1_levels(kpyr, orb.fast_nms_levels(kstack, ksizes), "K1 at 376x1241")
    rate = minmax_rate()
    k1 = k1_measure(pyr, stack, sizes, err, rate)
    k1.update(against_earlier("K1 fast_nms", lambda: orb.fast_nms_levels(stack, sizes),
                              lambda: [prev_kernels.fast_nms_prev(lv) for lv in pyr],
                              lambda o: check_k1_levels(pyr, o, "earlier K1")))
    k2 = k2_measure(stack, lyx, dev)
    print(f"# K1 fast_nms: one launch, 8 levels bit-exact at 480x640 and 376x1241, 0 outside "
          f"the mask; {k1['ms']:.4f} ms/frame, {k1['per_launch_ms']:.4f} per frame back to "
          f"back, {k1['device_ms']:.4f} from a graph (plain {k1['plain_ms']:.4f}, "
          f"bound {k1['bound_ms']:.5f} by {k1['bound_by']}: {k1['bound_ops']} min/max slots "
          f"at {rate:.4g}/s, {k1['bound_bytes']} B); K2 gather_patches: {lyx.shape[0]} patches "
          f"bit-exact; {k2['ms']:.4f} ms, {k2['per_launch_ms']:.4f} per launch, "
          f"{k2['device_ms']:.4f} from a graph (plain "
          f"{k2['plain_ms']:.4f}, library {k2['library_ms']:.4f}, bound "
          f"{k2['bound_ms']:.5f})", flush=True)
    return k1, k2


def k3_problem(cfg, r):
    """One motion-only BA problem at the config's feature count:
    (T_gt, [T0, Xw, obs, octave, is_stereo, valid, inv_sigma2] as numpy)."""
    N = sum(cfg.orb.level_budgets())
    K, bf = cfg.K, cfg.bf
    Xw = (r.uniform([-3, -2, 2.0], [3, 2, 8.0], size=(N, 3))).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, 3] = [0.1, -0.05, 0.2]
    Xc = Xw @ T_gt[:3, :3].T + T_gt[:3, 3]
    u = K[0] * Xc[:, 0] / Xc[:, 2] + K[2]
    v = K[1] * Xc[:, 1] / Xc[:, 2] + K[3]
    obs = np.stack([u, v, u - bf / Xc[:, 2]], -1).astype(np.float32)
    obs[:, :2] += r.normal(0, 0.5, (N, 2)).astype(np.float32)
    out_idx = r.choice(N, N // 20, replace=False)
    obs[out_idx, :2] += r.normal(0, 40.0, (len(out_idx), 2)).astype(np.float32)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.05, 0.0, 0.1]
    return T_gt, [T0, Xw, obs, r.integers(0, 8, N).astype(np.int32), r.random(N) > 0.5,
                  r.random(N) < 0.9, (1.0 / 1.44 ** np.arange(8)).astype(np.float32)]


def k3_bound(args, cfg):
    """Bytes: X, obs (12 B each), octave (4), stereo and valid (1 each) per
    edge, the start pose and level table in; pose, inlier mask and count
    out. Operations: 40 LM iterations over this run's valid edges."""
    T0, Xw, valid = args[0], args[1], args[5]
    B = T0.shape[0] if T0.dim() == 3 else 1
    n = Xw.shape[-2]
    iters = 4 * 10
    nbytes = B * (30 * n + 64 + 32 + 64 + n + 4)
    return bound(nbytes, K3_OPS_PER_EDGE_ITER * iters * int(valid.sum()))


def check_k3(cfg, dev, name="K3 pose_lm", earlier=True):
    """K3 on one problem at cfg's feature count (and its camera) against
    its plain version; with `earlier`, timed against its earlier design."""
    import prev_kernels
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    r = np.random.default_rng(0)
    K, bf = cfg.K, cfg.bf
    T_gt, arrs = k3_problem(cfg, r)
    N = arrs[1].shape[0]
    args = [torch.from_numpy(a).to(dev) for a in arrs]
    ker = lm_cuda.pose_optimize_lm(*args, K, bf)
    pl = lm_cuda.pose_optimize_plain(*args, K, bf)
    dT = (ker.Tcw - pl.Tcw).abs().max().item()
    dn = abs(int(ker.n_inliers) - int(pl.n_inliers))
    if not (dT < 5e-3 and dn <= 5):
        raise AssertionError(f"K3 disagrees: |dT|={dT} |dinl|={dn}")
    gt_err = (ker.Tcw - torch.from_numpy(T_gt).to(dev)).abs().max().item()
    res = dict(max_abs_err=dT, library_ms=None,
               **timed(lambda: lm_cuda.pose_optimize_lm(*args, K, bf),
                       lambda: lm_cuda.pose_optimize_plain(*args, K, bf)),
               **k3_bound(args, cfg))
    def close_to_plain(o):
        eT, en = (o.Tcw - pl.Tcw).abs().max().item(), abs(int(o.n_inliers) - int(pl.n_inliers))
        if not (eT < 5e-3 and en <= 5):
            raise AssertionError(f"earlier K3 disagrees: |dT|={eT} |dinl|={en}")

    if earlier:
        res.update(against_earlier(name, lambda: lm_cuda.pose_optimize_lm(*args, K, bf),
                                   lambda: prev_kernels.pose_optimize_prev(*args, K, bf),
                                   close_to_plain))
    print(f"# {name}: N={N} ({2 * N * 16} B of shared memory) |dT|={dT:.2e} |dinl|={dn} (inliers {int(ker.n_inliers)}, "
          f"pose vs truth {gt_err:.2e}); {res['ms']:.4f} ms, {res['device_ms']:.4f} from a graph, "
          f"{res['per_launch_ms']:.4f} per "
          f"launch back to back (plain {res['plain_ms']:.4f}, bound {res['bound_ms']:.6f})",
          flush=True)
    return res


def check_k3_batched(cfg, dev, B=5):
    """K3 over a batch of B poses (relocalization's candidates): the K3
    check's problem with perturbed starts and edge masks, the last one all
    invalid (a disabled candidate). The batched launch must equal B single
    launches bit for bit, and each pose its plain version within K3's
    tolerances (tests/test_tpu_parity.py:63-66)."""
    import prev_kernels
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    r = np.random.default_rng(1)
    K, bf = cfg.K, cfg.bf
    _, (T0, Xw, obs, octv, stereo, _, inv_s2) = k3_problem(cfg, r)
    N = Xw.shape[0]
    T0s = np.tile(T0, (B, 1, 1))
    T0s[:, :3, 3] += r.normal(0, 0.03, (B, 3)).astype(np.float32)
    valid = r.random((B, N)) < np.linspace(0.95, 0.5, B)[:, None]
    valid[-1] = False

    def stack(a):
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (B,) + a.shape))).to(dev)

    args = [torch.from_numpy(T0s).to(dev), stack(Xw), stack(obs), stack(octv), stack(stereo),
            torch.from_numpy(valid).to(dev)]
    inv = torch.from_numpy(inv_s2).to(dev)
    bat = lm_cuda.pose_optimize_lm(*args, inv, K, bf)
    dT, dn = 0.0, 0
    for b in range(B):
        one = [a[b] for a in args]
        single = lm_cuda.pose_optimize_lm(*one, inv, K, bf)
        if not (torch.equal(single.Tcw, bat.Tcw[b]) and torch.equal(single.inliers,
                                                                    bat.inliers[b])):
            raise AssertionError(f"K3 batched pose {b} differs from its single launch")
        pl = lm_cuda.pose_optimize_plain(*one, inv, K, bf)
        dT = max(dT, (bat.Tcw[b] - pl.Tcw).abs().max().item())
        dn = max(dn, abs(int(bat.n_inliers[b]) - int(pl.n_inliers)))
    if not (dT < 5e-3 and dn <= 5):
        raise AssertionError(f"K3 batched disagrees with plain: |dT|={dT} |dinl|={dn}")
    # relocalization broadcasts the frame's observations over the batch
    shared = [torch.from_numpy(a).to(dev).expand((B,) + a.shape) for a in (obs, octv, stereo)]
    bro = lm_cuda.pose_optimize_lm(args[0], args[1], *shared, args[5], inv, K, bf)
    if not all(torch.equal(a, b) for a, b in zip(bro, bat)):
        raise AssertionError("K3 batched over broadcast inputs differs from stacked inputs")

    def singles(fn):
        for b in range(B):
            fn(*[a[b] for a in args], inv, K, bf)

    res = dict(max_abs_err=dT, library_ms=None,
               ms=cuda_ms(lambda: lm_cuda.pose_optimize_lm(*args, inv, K, bf)),
               per_launch_ms=per_launch_ms(lambda: lm_cuda.pose_optimize_lm(*args, inv, K, bf)),
               device_ms=graph_ms(lambda: lm_cuda.pose_optimize_lm(*args, inv, K, bf)),
               plain_ms=cuda_ms(lambda: singles(lm_cuda.pose_optimize_plain), reps=3, warm=1),
               **k3_bound(args, cfg))
    single_ms = cuda_ms(lambda: singles(lm_cuda.pose_optimize_lm))

    def close_to_batched(o):
        eT = (o.Tcw - bat.Tcw).abs().max().item()
        en = (o.n_inliers - bat.n_inliers).abs().max().item()
        if not (eT < 5e-3 and en <= 5):
            raise AssertionError(f"earlier batched K3 disagrees: |dT|={eT} |dinl|={en}")

    res.update(against_earlier("K3b pose_lm batched",
                               lambda: lm_cuda.pose_optimize_lm(*args, inv, K, bf),
                               lambda: prev_kernels.pose_optimize_prev(*args, inv, K, bf),
                               close_to_batched))
    print(f"# K3 batched pose_lm: B={B} x N={N}, equal to {B} single launches bit for bit; "
          f"vs plain |dT|={dT:.2e} |dinl|={dn} (inliers {bat.n_inliers.tolist()}); "
          f"{res['ms']:.4f} ms batched ({res['per_launch_ms']:.4f} back to back, "
          f"{res['device_ms']:.4f} from a graph) vs "
          f"{single_ms:.4f} ms for {B} single launches (plain {res['plain_ms']:.4f}, "
          f"bound {res['bound_ms']:.6f})", flush=True)
    return res


def k4_fields(r, NC, NP, N_PER, F, K, BF):
    """One camera-major local-BA window (numpy fields of optim.BAProblem):
    random point ids, so cameras may observe a point more than once."""
    from orb_slam2_comment_tpu_torch.ops import geometry as geo

    O = NC * N_PER
    pts = r.uniform(-6, 6, (NP, 3)).astype(np.float32) + np.float32([0, 0, 10])
    cam_T = np.tile(np.eye(4, dtype=np.float32), (NC, 1, 1))
    cam_T[:, 0, 3] = -np.linspace(0, 2, NC).astype(np.float32)
    obs_pt = r.integers(0, NP, (NC, N_PER)).astype(np.int32)
    uvr = geo.project_stereo(K, BF, geo.transform_points(
        torch.from_numpy(cam_T)[:, None], torch.from_numpy(pts[obs_pt]))).numpy()
    uvr = uvr.reshape(O, 3) + r.normal(0, 0.4, (O, 3)).astype(np.float32)
    cam_fixed = np.zeros(NC, bool)
    cam_fixed[F:] = True
    cam_fixed[3] = True
    return dict(
        cam_T=cam_T, cam_fixed=cam_fixed, cam_valid=np.ones(NC, bool), pts=pts,
        pt_valid=np.ones(NP, bool), obs_cam=np.repeat(np.arange(NC, dtype=np.int32), N_PER),
        obs_pt=obs_pt.reshape(-1), obs_uvr=uvr.astype(np.float32),
        obs_oct=r.integers(0, 4, O).astype(np.int32), obs_stereo=r.random(O) < 0.7,
        obs_valid=r.random(O) < 0.95)


def k4_bytes(NC, NP, O, n_obs, F):
    """K4's bytes: cam_T and pts in, the ok flag of each of the O slots,
    and uvr, point id, octave and stereo flag of the n_obs active ones (an
    inactive slot returns after its flag, lba_build.cu:98-99); Hcc, bc,
    Hpp, bp, E, cost and n_in out."""
    return (NC * 66 + NP * 12 + O * 1 + n_obs * (12 + 4 + 4 + 1)
            + F * 42 * 4 + NP * 12 * 4 + F * 18 * NP * 4 + 8)


def k4_field_err(sp, sk, what):
    """Largest per-field error of K4's system sk relative to the plain sp;
    each must be below 1e-3."""
    worst = 0.0
    for fld in sp._fields:
        a, b = getattr(sp, fld).double(), getattr(sk, fld).double()
        err = ((a - b).abs().max() / max(a.abs().max().item(), 1e-6)).item()
        worst = max(worst, err)
        if not err < 1e-3:
            raise AssertionError(f"{what}: field {fld} rel err {err}")
    return worst


# K4 against its plain version entrywise: |K4 - plain| <= K4_C * 2^-24 * S,
# where S sums, in float64, each observation's contribution to the entry
# with |.| taken before every sum (the residual obs - proj and the point
# transform R X + t included) and first-order magnitudes carried through
# 1/z, the Jacobians and the Huber weight (k4_abs_sums). Each build's
# error is then at most (roundings along one observation's chain +
# depth of its reduction) * 2^-24 * S: a chain of <= 19 roundings (the
# transform 3, 1/z and its square 2, a Jacobian entry 4, the weight 6,
# the product and its 3-term sum 4); K4's reductions at most 18 deep (one
# observation per thread per chunk, 5 shuffles, 4 warps, 8 chunks in
# order; a point's sums: strided lanes, 5 shuffles, its scan's carries);
# the plain version on the card at most 32 (torch's strided sum and
# shuffles over <= 2048 rows, or index_add_'s atomics over <= 32
# observations of a point). Two builds: 2 * (19 + 32) < 128.
K4_C = 128


def k4_abs_sums(prob, inv, F, cam_T, pts, obs_ok, robust, K, BF):
    """S of every entry of Hcc, bc, Hpp9, bp3 and E (float64, the plain
    version's layouts): see K4_C. A quantity q's magnitude qm bounds the
    scale of its rounding error (qm >= |q|): a leaf's is |q|, a sum's the
    sum of its terms' magnitudes, a product's am |b| + |a| bm, and 1/z's
    zm / z^2."""
    from orb_slam2_comment_tpu_torch import constants as C
    from orb_slam2_comment_tpu_torch.ops import optim

    fx, fy, cx, cy = (float(k) for k in K)
    d = torch.float64
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    cam, ptl = prob.obs_cam.long(), prob.obs_pt.long()
    T, X, uvr = cam_T.to(d)[cam], pts.to(d)[ptl], prob.obs_uvr.to(d)
    r, Jc, Jp, _ = optim._edge_jacobians(T, X, uvr, K, BF)
    R, t = T[:, :3, :3], T[:, :3, 3]
    x, y, z = ((R @ X[:, :, None])[..., 0] + t).unbind(-1)
    xm, ym, zm = ((R.abs() @ X.abs()[:, :, None])[..., 0] + t.abs()).unbind(-1)
    iz = 1.0 / torch.clamp(z, min=1e-9)
    izm = zm * iz * iz
    iz2, iz2m = iz * iz, 2.0 * iz * izm
    um = fx * (xm * iz + x.abs() * izm) + abs(cx)
    rm = uvr.abs() + torch.stack([um, fy * (ym * iz + y.abs() * izm) + abs(cy),
                                  um + BF * izm], -1)      # obs - proj
    D00, D00m = fx * iz, fx * izm
    D02, D02m = fx * x.abs() * iz2, fx * (xm * iz2 + x.abs() * iz2m)
    D11, D11m = fy * iz, fy * izm
    D12, D12m = fy * y.abs() * iz2, fy * (ym * iz2 + y.abs() * iz2m)
    D22 = (fx * x - BF).abs() * iz2
    D22m = (fx * xm + BF) * iz2 + (fx * x - BF).abs() * iz2m

    def pm(a, am, b, bm):
        return am * b.abs() + a * bm

    zr = torch.zeros_like(x)
    Jcm = torch.stack([
        torch.stack([D00m, zr, D02m, pm(D02, D02m, y, ym),
                     pm(D00, D00m, z, zm) + pm(D02, D02m, x, xm), pm(D00, D00m, y, ym)], -1),
        torch.stack([zr, D11m, D12m, pm(D11, D11m, z, zm) + pm(D12, D12m, y, ym),
                     pm(D12, D12m, x, xm), pm(D11, D11m, x, xm)], -1),
        torch.stack([D00m, zr, D22m, pm(D22, D22m, y, ym),
                     pm(D00, D00m, z, zm) + pm(D22, D22m, x, xm), pm(D00, D00m, y, ym)], -1),
    ], -2)
    Ra = R.abs()
    Jpm = torch.stack([D00m[:, None] * Ra[:, 0] + D02m[:, None] * Ra[:, 2],
                       D11m[:, None] * Ra[:, 1] + D12m[:, None] * Ra[:, 2],
                       D00m[:, None] * Ra[:, 0] + D22m[:, None] * Ra[:, 2]], -2)
    Jca, Jpa = Jc.abs(), Jp.abs()
    Jcm, Jpm = torch.maximum(Jcm, Jca), torch.maximum(Jpm, Jpa)
    lvl = torch.clamp(prob.obs_oct, 0, inv.shape[0] - 1).long()
    inv_s2 = torch.where(obs_ok, inv.to(d)[lvl], torch.zeros_like(uvr[:, 0]))
    comp = torch.stack([torch.ones_like(inv_s2), torch.ones_like(inv_s2),
                        prob.obs_stereo.to(d)], -1)
    chi2 = inv_s2 * (comp * r * r).sum(-1)
    chi2m = inv_s2 * (comp * 2.0 * r.abs() * rm).sum(-1)
    delta = torch.where(prob.obs_stereo, C.HUBER_STEREO, C.HUBER_MONO).to(d)
    active = (chi2 > delta * delta) if robust else torch.zeros_like(obs_ok)
    hw = torch.where(active, delta / torch.sqrt(torch.clamp(chi2, min=1e-12)),
                     torch.ones_like(chi2))
    # first-order magnitude of delta / sqrt(chi2): hw * chi2m / (2 chi2)
    hwm = torch.where(active, hw * (1.0 + chi2m / (2.0 * torch.clamp(chi2, min=1e-12))), hw)
    free = ((~prob.cam_fixed) & prob.cam_valid)[cam].to(d)[:, None, None]
    w, wm = (inv_s2 * hw)[:, None] * comp, (inv_s2 * hwm)[:, None] * comp
    Jca, Jcm = Jca * free, Jcm * free
    JcWa, JcWm = Jca * w[:, :, None], Jcm * wm[:, :, None]
    JpWa, JpWm = Jpa * w[:, :, None], Jpm * wm[:, :, None]

    def prod(Aa, Am, Ba, Bm):             # sum_k |A_ki B_kj| with magnitudes
        return torch.einsum("oki,okj->oij", Am, Ba) + torch.einsum("oki,okj->oij", Aa, Bm)

    hcc = prod(JcWa, JcWm, Jca, Jcm).reshape(-1, 36)
    bc = (torch.einsum("oki,ok->oi", JcWm, r.abs()) + torch.einsum("oki,ok->oi", JcWa, rm))
    hpp = prod(JpWa, JpWm, Jpa, Jpm).reshape(-1, 9)
    bp = (torch.einsum("oki,ok->oi", JpWm, r.abs()) + torch.einsum("oki,ok->oi", JpWa, rm))
    e = prod(JcWa, JcWm, Jpa, Jpm).reshape(-1, 18)
    dev = hcc.device
    key = torch.where(cam < F, cam * Np + ptl, F * Np)
    E = torch.zeros(F * Np + 1, 18, dtype=d, device=dev).index_add_(0, key, e)[:F * Np]
    return dict(
        Hcc=torch.zeros(Nc, 36, dtype=d, device=dev).index_add_(0, cam, hcc)[:F]
        .reshape(F, 6, 6),
        bc=torch.zeros(Nc, 6, dtype=d, device=dev).index_add_(0, cam, bc)[:F],
        Hpp9=torch.zeros(Np, 9, dtype=d, device=dev).index_add_(0, ptl, hpp).T,
        bp3=torch.zeros(Np, 3, dtype=d, device=dev).index_add_(0, ptl, bp).T,
        E=E.reshape(F, Np, 6, 3).permute(0, 2, 3, 1))


def k4_sum_bound(S, sp, sk, what):
    """Hold K4's system sk to the plain sp entrywise within K4_C * 2^-24 *
    S; returns the worst |sk - sp| / (2^-24 * S) over the fields."""
    worst = 0.0
    for f, s in S.items():
        diff = (getattr(sk, f).double() - getattr(sp, f).double()).abs()
        unit = s * 2.0 ** -24
        if not bool(torch.all(diff <= K4_C * unit)):
            i = int(torch.argmax(diff - K4_C * unit))
            raise AssertionError(
                f"{what}: {f} differs by {float(diff.reshape(-1)[i]):.4g} where "
                f"{K4_C} * 2^-24 * S is {float(K4_C * unit.reshape(-1)[i]):.4g}")
        ratio = torch.where(unit > 0, diff / torch.where(unit > 0, unit, 1.0),
                            torch.zeros_like(diff))
        worst = max(worst, float(ratio.max()) if ratio.numel() else 0.0)
    return worst


def check_k4_window(prep, K, BF, path="stereo"):
    """K4 on a real local-BA window of the `path` path (the one with the
    most valid observations) where the mapper linearizes it: robust over
    every valid observation at the window's start (lba_init), and not
    robust over the observations the prune keeps (lba_prune drops chi2 and
    depth outliers, whose unweighted residuals may be infinite). Then on a
    dense window at the path's camera with the real window's capacities
    (N_per observations per camera, ~95% valid, as the path could fill
    it). Each field within 1e-3 relative of the plain version, a
    rerun bit-identical; the row is timed on the real window."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    prob, inv, F = prep.prob, prep.inv_sigma2_levels, prep.F
    start = optim.lba_init(prob, inv, K, BF)
    pruned = optim.lba_prune(prob, inv, start, K, BF)
    NC, NP, O = prob.cam_T.shape[0], prob.pts.shape[0], prob.obs_cam.shape[0]
    dense = optim.BAProblem(**{k: torch.from_numpy(v).to(inv.device) for k, v in k4_fields(
        np.random.default_rng(2), NC, NP, prep.N_per, F, K, BF).items()})
    dprep = lba_cuda.prep_problem(dense, inv, F)
    worst = 0.0
    for what, pp, pr, (cam_T, pts, *_, obs_ok), robust in (
            (f"the {path} window", prep, prob, start, True),
            (f"the {path} window", prep, prob, pruned, False),
            (f"the dense {path} window", dprep, dense,
             (dense.cam_T, dense.pts, dense.obs_valid), True),
            (f"the dense {path} window", dprep, dense,
             (dense.cam_T, dense.pts, dense.obs_valid), False)):
        sk = lba_cuda.build_system(pp, cam_T, pts, obs_ok, robust, K, BF)
        sp = optim.build_system_plain(pr, inv, F, cam_T, pts, obs_ok, robust, K, BF)
        again = lba_cuda.build_system(pp, cam_T, pts, obs_ok, robust, K, BF)
        worst = max(worst, k4_field_err(sp, sk, f"K4 on {what} (robust={robust})"))
        if not all(torch.equal(getattr(sk, f), getattr(again, f)) for f in sk._fields):
            raise AssertionError(f"K4 on {what}: a rerun differs")
    n_obs, n_dense = int(prob.obs_valid.sum()), int(dense.obs_valid.sum())
    cam_T = start[0]
    res = dict(
        max_abs_err=worst, library_ms=None,
        **timed(lambda: lba_cuda.build_system(prep, cam_T, prob.pts, prob.obs_valid,
                                              True, K, BF),
                lambda: optim.build_system_plain(prob, inv, F, cam_T, prob.pts,
                                                 prob.obs_valid, True, K, BF)),
        **bound(k4_bytes(NC, NP, O, n_obs, F), K4_OPS_PER_OBS * n_obs))
    dres = dict(**timed(lambda: lba_cuda.build_system(dprep, dense.cam_T, dense.pts,
                                                      dense.obs_valid, True, K, BF),
                        lambda: optim.build_system_plain(dense, inv, F, dense.cam_T, dense.pts,
                                                         dense.obs_valid, True, K, BF)),
                **bound(k4_bytes(NC, NP, O, n_dense, F), K4_OPS_PER_OBS * n_dense))
    res.update({f"dense_{k}": v for k, v in dres.items()}, dense_valid_obs=n_dense)
    print(f"# K4 lba_build@{path}: {NC} cams ({F} free) x {NP} pts x {O} obs ({n_obs} valid, "
          f"{int(pruned[5].sum())} after the prune, {prep.N_per} per camera); worst field rel "
          f"err {worst:.2e} with the dense window; {res['ms']:.4f} ms, {res['device_ms']:.4f} "
          f"from a graph, {res['per_launch_ms']:.4f} per launch back to back (plain "
          f"{res['plain_ms']:.4f}, bound {res['bound_ms']:.6f}); dense window ({n_dense} "
          f"valid): {dres['ms']:.4f} ms, {dres['device_ms']:.4f} from a graph, "
          f"{dres['per_launch_ms']:.4f} back to back (plain {dres['plain_ms']:.4f}, bound "
          f"{dres['bound_ms']:.6f})", flush=True)
    return res


def check_k4(dev):
    """K4 at the main path's window (32 cameras, 16 free, 2048 points, 1000
    observations per camera) and on a dense window (64 points seen ~100
    times each, so a point's observations span several warp-wide chunks):
    each field within 1e-3 relative of the plain version, robust and not,
    and a rerun bit-identical."""
    import prev_kernels
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    NC, NP, N_PER, F = 32, 2048, 1000, 16
    O = NC * N_PER
    K = (500.0, 500.0, 320.0, 240.0)
    BF = 50.0
    inv_s2 = torch.tensor([1.0 / (1.2 ** (2 * l)) for l in range(8)], dtype=torch.float32)
    inv_dev = inv_s2.to(dev)
    r = np.random.default_rng(0)
    fields = k4_fields(r, NC, NP, N_PER, F, K, BF)
    dense = k4_fields(r, NC, 64, 200, F, K, BF)
    worst = 0.0
    for flds in (fields, dense):
        pr = optim.BAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in flds.items()})
        pp = lba_cuda.prep_problem(pr, inv_dev, F)
        for robust in (True, False):
            sk = lba_cuda.build_system(pp, pr.cam_T, pr.pts, pr.obs_valid, robust, K, BF)
            sp = optim.build_system_plain(pr, inv_dev, F, pr.cam_T, pr.pts, pr.obs_valid,
                                          robust, K, BF)
            again = lba_cuda.build_system(pp, pr.cam_T, pr.pts, pr.obs_valid, robust, K, BF)
            worst = max(worst, k4_field_err(sp, sk, f"K4 (robust={robust}, Np="
                                                     f"{pr.pts.shape[0]})"))
            if not all(torch.equal(getattr(sk, f), getattr(again, f)) for f in sk._fields):
                raise AssertionError("K4: a rerun differs")
    prob = optim.BAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in fields.items()})
    prob_cpu = optim.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})
    prep = lba_cuda.prep_problem(prob, inv_dev, F)
    sp = optim.build_system_plain(prob, inv_dev, F, prob.cam_T, prob.pts, prob.obs_valid,
                                  True, K, BF)
    # five LM iterations: kernel path on the card vs the plain path (CPU)
    ck = optim.lba_iterate(prob, inv_dev, optim.lba_init(prob, inv_dev, K, BF), K, BF, 5,
                           robust=True, n_free=F)
    cp = optim.lba_iterate(prob_cpu, inv_s2, optim.lba_init(prob_cpu, inv_s2, K, BF), K, BF, 5,
                           robust=True, n_free=F)
    c_k, c_p = float(ck[3]), float(cp[3])
    if not (abs(c_k - c_p) / max(abs(c_p), 1.0) < 1e-3 and int(ck[4]) == int(cp[4])):
        raise AssertionError(f"K4 lba_iterate(5): cost {c_k} vs {c_p}, "
                             f"inliers {int(ck[4])} vs {int(cp[4])}")
    res = dict(
        max_abs_err=worst, library_ms=None,
        **timed(lambda: lba_cuda.build_system(prep, prob.cam_T, prob.pts, prob.obs_valid,
                                              True, K, BF),
                lambda: optim.build_system_plain(prob, inv_dev, F, prob.cam_T, prob.pts,
                                                 prob.obs_valid, True, K, BF)),
        **bound(k4_bytes(NC, NP, O, int(prob.obs_valid.sum()), F),
                K4_OPS_PER_OBS * int(prob.obs_valid.sum())))

    pprev = prev_kernels.prep_prev(prob, inv_dev, F)
    res.update(against_earlier(
        "K4 lba_build",
        lambda: lba_cuda.build_system(prep, prob.cam_T, prob.pts, prob.obs_valid, True, K, BF),
        lambda: prev_kernels.build_system_prev(pprev, prob.cam_T, prob.pts, prob.obs_valid,
                                               True, K, BF),
        lambda o: k4_field_err(sp, o, "earlier K4")))
    print(f"# K4 lba_build: {NC} cams x {NP} pts x {O} obs; worst field rel err "
          f"{worst:.2e}; lba_iterate(5) cost {c_k:.6g} vs plain {c_p:.6g}, inliers "
          f"{int(ck[4])}; {res['ms']:.4f} ms, {res['device_ms']:.4f} from a graph, "
          f"{res['per_launch_ms']:.4f} per launch back "
          f"to back (plain {res['plain_ms']:.4f}, bound {res['bound_ms']:.6f})", flush=True)
    return res


# ---------------------------------------------------------------------------
# the paths of the default System
# ---------------------------------------------------------------------------

def make_system(cfg, dev, vocabulary_path=None):
    """The default System, as bench.py builds it (loop closing on), with
    its device named (and a vocabulary file, when given); its map and
    database must live on the card."""
    from orb_slam2_comment_tpu_torch.models.system import System

    system = System(cfg, vocabulary_path=vocabulary_path, device=dev)
    if not (system.loop_closer is not None and system.tracker.map.kf_pose.is_cuda
            and system.tracker.map.pt_pos.is_cuda and system.db.valid.is_cuda):
        raise AssertionError("the default System is not a loop-closing system on the card")
    return system


def resolved(out):
    """A track_* output with its frame resolved: reading a field of the
    pipeline's lazy output waits for the frame, so a timed call that the
    caller reads includes this."""
    out.state
    return out


def host_syncs(fn):
    """fn() under torch's sync debug mode: (its result, host syncs). The
    pipeline's waits on a transfer event (a stats batch or detection pack
    not landed yet), which the debug mode does not see, count too."""
    from orb_slam2_comment_tpu_torch.models import tracking

    w0 = tracking.transfer_waits
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, (sum("synchroniz" in str(w.message) for w in caught)
                 + tracking.transfer_waits - w0)


def run_sequence(cfg, frames, dev, count_syncs_from=None, profile=None):
    """System.track_rgbd over the frames. Returns (system, per-frame
    records, per-frame seconds, phases run, host syncs per counted frame)."""
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm

    phases = lm._phase_list(cfg)
    system = make_system(cfg, dev)
    recs, secs, ran, syncs = [], [], set(), []
    for i, f in enumerate(frames):
        ds = system.tracker.ds
        p_before = ds.mp.phase if ds is not None else 0
        counting = count_syncs_from is not None and i >= count_syncs_from
        prof_on = profile is not None and i == len(frames) - 20
        if prof_on:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        if counting:
            out, n = host_syncs(lambda: resolved(system.track_rgbd(f["image"], f["depth"],
                                                                   f["timestamp"])))
            syncs.append(n)
        else:
            out = resolved(system.track_rgbd(f["image"], f["depth"], f["timestamp"]))
        secs.append(time.perf_counter() - t0)
        if out.state != 1:
            raise AssertionError(f"frame {i}: tracking state {out.state}")
        recs.append((out.Tcw, out.n_inliers, out.created_kf))
        if out.created_kf and i > 0:
            ran.add(phases[0][0])
        elif p_before > 0:
            ran.add(phases[p_before - 1][0])
    if profile is not None:
        prof.__exit__(None, None, None)
        with open(profile, "w") as fh:
            fh.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    return system, recs, secs, ran, syncs


def check_database(system):
    """Every live keyframe is indexed in the database, and loop detection
    was harvested at least once."""
    live = system.tracker.map.kf_valid.cpu().numpy()
    indexed = system.db.valid.cpu().numpy()
    if not indexed[live].all():
        raise AssertionError(f"keyframes {np.where(live & ~indexed)[0]} not in the database")
    if system.loop_closer.n_detections < 1:
        raise AssertionError("no loop detection was harvested")
    return int(live.sum()), system.loop_closer.n_detections


def main_path(cfg, frames, dev, profile, keep=None):
    """`keep`, when a dict, receives the first run's final map."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    system, recs, secs, ran, _ = run_sequence(cfg, frames, dev, profile=profile)
    torch.cuda.synchronize()
    if keep is not None:
        keep["map"] = system.tracker.map
    n_kfs = system.tracker.n_kfs
    if n_kfs < 3:
        raise AssertionError(f"only {n_kfs} keyframes")
    if not {"ba1", "ba2", "ba3"} <= ran:
        raise AssertionError(f"mapper phases run: {sorted(ran)}")
    n_indexed, n_detect = check_database(system)
    poses = [np.asarray(r[0], np.float64) for r in recs]
    gt = [f["Tcw_gt"] for f in frames]
    ate = ate_rmse(poses, gt)
    if not np.all(np.isfinite(np.stack(poses))) or not ate < 0.02:
        raise AssertionError(f"ATE {ate} m")

    n_rerun = min(40, len(frames))
    _, recs2, _, _, syncs = run_sequence(cfg, frames[:n_rerun], dev, count_syncs_from=10)
    for i in range(n_rerun):
        if not np.array_equal(recs[i][0], recs2[i][0]):
            raise AssertionError(f"rerun differs at frame {i}")

    n_warm = 8
    dt = np.asarray(secs[n_warm:]) * 1e3
    return dict(frames=len(frames), frames_run=len(frames) + n_rerun, timed=len(dt),
                fps=len(dt) / (dt.sum() / 1e3),
                p50_ms=float(np.percentile(dt, 50)), p90_ms=float(np.percentile(dt, 90)),
                p99_ms=float(np.percentile(dt, 99)), max_ms=float(dt.max()),
                n_kfs=n_kfs, ate_m=ate, kf_frames=int(sum(r[2] for r in recs)),
                mapper_phases=sorted(ran), rerun_identical_frames=n_rerun,
                db_indexed_kfs=n_indexed, loop_detections=n_detect,
                host_syncs_per_frame_median=float(np.median(syncs)) if syncs else None,
                host_syncs_per_frame_max=int(max(syncs)) if syncs else None,
                inliers_median=float(np.median([r[1] for r in recs[1:]])))


def _stage_streams(log):
    """Wrap the pipeline's stage A (extraction) and stage B (tracking) to
    log the stream each ran on; returns the undo."""
    from orb_slam2_comment_tpu_torch.models import tracking

    a, b = tracking._extract_stage, tracking._track_stage_rgbd_core

    def stage_a(*x, **k):
        log.append(("A", torch.cuda.current_stream().stream_id))
        return a(*x, **k)

    def stage_b(*x, **k):
        log.append(("B", torch.cuda.current_stream().stream_id))
        return b(*x, **k)

    tracking._extract_stage, tracking._track_stage_rgbd_core = stage_a, stage_b

    def undo():
        tracking._extract_stage, tracking._track_stage_rgbd_core = a, b
    return undo


def trace_kernels(prof, path):
    """Device events of a torch.profiler run from its chrome trace: a list
    of (name, stream, start us, duration us) for kernels, copies and
    sets."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], e.get("args", {}).get("stream"), float(e["ts"]), float(e["dur"]))
            for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]


def busy_ms(events):
    """Device time covered by at least one event (the union over streams)."""
    spans = sorted((t, t + d) for _, _, t, d in events)
    total, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def run_pipelined(cfg, frames, dev, read_every, profile=None, syncs=None, keep=None):
    """bench.py's program through System.track_rgbd: 8 warm-up frames read
    one by one, more (resolved pipeline_lag frames late, as bench.py's
    warm-up does) until 6 keyframes exist, then the remaining frames'
    images and depth maps staged on the card and tracked in a timed loop
    with no output read (read_every: out.state read on every frame), the
    pipeline drained at the end and charged to the last frame. `profile`,
    a file name, traces 20 timed frames (from the 21st where there are
    40) with torch.profiler; `syncs`, a
    list, receives each timed call's host syncs; `keep`, a dict, receives
    the local-BA windows and the last pose_optimize calls of the final
    drain. Returns (system, per-frame ms, drain ms, n_warm, trace events)."""
    from orb_slam2_comment_tpu_torch.models.frame import depth_to_tensor
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    system = make_system(cfg, dev)
    t = system.tracker
    n_warm = 8
    for i, f in enumerate(frames[:n_warm]):
        if system.track_rgbd(f["image"], f["depth"], f["timestamp"]).state != 1:
            raise AssertionError(f"pipeline warm-up frame {i} not tracked")
    i = n_warm
    while i < len(frames) - 30 and (i < n_warm + 6 or t.n_kfs < 6):
        system.track_rgbd(frames[i]["image"], frames[i]["depth"], frames[i]["timestamp"])
        t._flush_upto(i - cfg.pipeline_lag)
        i += 1
    n_warm = i
    t._flush_all()
    staged = [(torch.from_numpy(f["image"]).to(dev), depth_to_tensor(f["depth"], dev),
               f["timestamp"]) for f in frames[n_warm:]]
    torch.cuda.synchronize()
    prep, po = lba_cuda.prep_problem, optim.pose_optimize
    if keep is not None:
        keep.setdefault("windows", [])

        def kept_window(*a, **k):
            keep["windows"].append(prep(*a, **k))
            return keep["windows"][-1]

        lba_cuda.prep_problem = kept_window
    prof, events = None, []
    p0 = min(20, len(staged) - 20)   # the 20 traced frames
    if profile is not None and p0 < 0:
        raise AssertionError(f"pipeline: {len(staged)} timed frames, fewer than 20 to trace")
    try:
        stamps = [time.perf_counter()]
        for k, (im, dm, ts) in enumerate(staged):
            if profile is not None and k == p0:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            call = ((lambda: resolved(system.track_rgbd(im, dm, ts))) if read_every
                    else (lambda: system.track_rgbd(im, dm, ts)))
            if syncs is not None:
                out, n = host_syncs(call)
                syncs.append(n)
            else:
                out = call()
            if read_every and out.state != 1:
                raise AssertionError(f"pipeline frame {n_warm + k}: state {out.state}")
            stamps.append(time.perf_counter())
            if prof is not None and k == p0 + 19:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                events = trace_kernels(prof, profile)
                prof = None
        t_drain = time.perf_counter()
        if keep is not None:
            keep["calls"] = []

            def recording(*a, **k):
                keep["calls"].append((a, k))
                return po(*a, **k)

            optim.pose_optimize = recording
        t._flush_upto(1 << 60)
        optim.pose_optimize = po
        t._drain_mapper()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    finally:
        lba_cuda.prep_problem, optim.pose_optimize = prep, po
        if prof is not None:
            prof.__exit__(None, None, None)
    dt = np.diff(np.asarray(stamps)) * 1e3
    dt[-2] += dt[-1]   # the drain charged to the last frame, as bench.py does
    system.shutdown()
    return system, dt[:-1], (stamps[-1] - t_drain) * 1e3, n_warm, events


def pipeline_state(system):
    """What the bit-identity checks compare: the trajectory records, the
    keyframe count, live points and keyframe poses."""
    t = system.tracker
    return dict(traj=[(ts, np.asarray(T), ref, st) for ts, T, ref, st in t.trajectory],
                n_kfs=t.n_kfs, live=int(t.map.pt_valid.sum()),
                kf_valid=t.map.kf_valid.cpu().numpy(), kf_pose=t.map.kf_pose.cpu().numpy())


def same_state(a, b, what):
    if (a["n_kfs"], a["live"], len(a["traj"])) != (b["n_kfs"], b["live"], len(b["traj"])):
        raise AssertionError(f"{what}: keyframes, live points or trajectory length differ "
                             f"({a['n_kfs']}, {a['live']}, {len(a['traj'])} against "
                             f"{b['n_kfs']}, {b['live']}, {len(b['traj'])})")
    for i, (x, y) in enumerate(zip(a["traj"], b["traj"])):
        if x[0] != y[0] or x[2:] != y[2:] or not np.array_equal(x[1], y[1]):
            raise AssertionError(f"{what}: trajectory record {i} differs")
    if not (np.array_equal(a["kf_valid"], b["kf_valid"])
            and np.array_equal(a["kf_pose"], b["kf_pose"])):
        raise AssertionError(f"{what}: keyframe poses differ")


def pipeline_path(cfg, frames, dev, keep):
    """bench.py's program on the card in two ways over main's frames: (i)
    no output read in the timed loop, images prestaged (bench.py's
    protocol), (ii) out.state read on every frame. Each is run twice, the
    second time with host syncs counted per call and torch.profiler over
    20 timed frames. Hard checks: (i) is bit-identical to its rerun and to
    (ii) and (ii)'s rerun (trajectory records, keyframes, live points,
    keyframe poses), every frame is tracked, ATE < 2 cm, stage A ran on
    another stream than stage B, and the trace shows K1 on another stream
    than K3. `keep` receives (i)'s local-BA windows and its last
    pose_optimize calls for the kernel checks."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs, streams = {}, []
    undo = _stage_streams(streams)
    try:
        for name, read_every in (("pipelined", False), ("per_frame", True)):
            system, dt, drain, n_warm, _ = run_pipelined(
                cfg, frames, dev, read_every, keep=keep if name == "pipelined" else None)
            syncs = []
            system2, _, _, _, events = run_pipelined(
                cfg, frames, dev, read_every, syncs=syncs,
                profile=os.path.join(ROOT, "build", f"pipeline_{name}.json"))
            runs[name] = dict(system=system, dt=dt, drain=drain, n_warm=n_warm, syncs=syncs,
                              events=events, state=pipeline_state(system),
                              rerun=pipeline_state(system2))
    finally:
        undo()
    ref = runs["pipelined"]["state"]
    same_state(ref, runs["pipelined"]["rerun"], "pipelined rerun")
    same_state(ref, runs["per_frame"]["state"], "per-frame-resolved run")
    same_state(ref, runs["per_frame"]["rerun"], "per-frame-resolved rerun")
    if len(ref["traj"]) != len(frames) or any(r[3] != 1 for r in ref["traj"]):
        raise AssertionError("pipeline: not every frame tracked")
    poses = [np.asarray(T, np.float64) for _, T in runs["pipelined"]["system"]._frame_poses()]
    ate = ate_rmse(poses, [f["Tcw_gt"] for f in frames])
    if not ate < 0.02:
        raise AssertionError(f"pipeline ATE {ate} m")
    a_streams = {s for k, s in streams if k == "A"}
    b_streams = {s for k, s in streams if k == "B"}
    if not a_streams or not b_streams or a_streams & b_streams:
        raise AssertionError(f"stage A ran on streams {a_streams}, stage B on {b_streams}")
    out = dict(frames=len(frames), frames_run=4 * len(frames), n_kfs=ref["n_kfs"],
               live_points=ref["live"], ate_m=ate, bit_identical_runs=4,
               stage_a_streams=sorted(a_streams), stage_b_streams=sorted(b_streams))
    for name, r in runs.items():
        dt, ev = r["dt"], r["events"]
        k1 = {s for n, s, _, _ in ev if "fast_nms_levels_kernel" in n}
        k3 = {s for n, s, _, _ in ev if "pose_lm_kernel" in n}
        if not k1 or not k3 or k1 & k3:
            raise AssertionError(f"{name}: the trace shows K1 on streams {k1}, K3 on {k3} "
                                 f"({len(ev)} device events)")
        out[name] = dict(
            timed=len(dt), warm=r["n_warm"], fps=len(dt) / (dt.sum() / 1e3),
            p50_ms=float(np.percentile(dt, 50)), p90_ms=float(np.percentile(dt, 90)),
            p99_ms=float(np.percentile(dt, 99)), max_ms=float(dt.max()), drain_ms=r["drain"],
            host_syncs=float(np.mean(r["syncs"])),
            host_syncs_per_frame_median=float(np.median(r["syncs"])),
            device_busy_ms_per_frame=busy_ms(ev) / 20, k1_streams=sorted(k1),
            k3_streams=sorted(k3))
    print(f"# pipeline: pipelined {out['pipelined']['fps']:.2f} fps, p50/p90/p99 "
          f"{out['pipelined']['p50_ms']:.2f}/{out['pipelined']['p90_ms']:.2f}/"
          f"{out['pipelined']['p99_ms']:.2f} ms, drain {out['pipelined']['drain_ms']:.1f} ms, "
          f"{out['pipelined']['host_syncs']:.2f} host syncs and "
          f"{out['pipelined']['device_busy_ms_per_frame']:.2f} device-busy ms per frame; "
          f"per-frame-resolved {out['per_frame']['fps']:.2f} fps, p50/p90/p99 "
          f"{out['per_frame']['p50_ms']:.2f}/{out['per_frame']['p90_ms']:.2f}/"
          f"{out['per_frame']['p99_ms']:.2f} ms, {out['per_frame']['host_syncs']:.2f} syncs, "
          f"{out['per_frame']['device_busy_ms_per_frame']:.2f} busy ms", flush=True)
    return out


def reloc_path(cfg, frames, dev, vocabulary_path=None):
    """Frames 0-79, three textureless frames (LOST), then frame 40 and
    41-79 again with later timestamps: the first returning frame must
    relocalize through the batched K3, within 5 cm of the truth, and every
    later frame must track."""
    from orb_slam2_comment_tpu_torch.models.tracking import LOST, OK
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    system = make_system(cfg, dev, vocabulary_path)
    for i, f in enumerate(frames[:80]):
        if system.track_rgbd(f["image"], f["depth"], f["timestamp"]).state != OK:
            raise AssertionError(f"reloc path: frame {i} not tracked")
    n_kfs = system.tracker.n_kfs
    ts = frames[79]["timestamp"]
    blank = np.full_like(frames[0]["image"], 128)
    no_depth = np.zeros_like(frames[0]["depth"])
    lost_ms = []
    for _ in range(3):
        ts += 1.0 / 30
        t0 = time.perf_counter()
        state = resolved(system.track_rgbd(blank, no_depth, ts)).state
        torch.cuda.synchronize()
        lost_ms.append((time.perf_counter() - t0) * 1e3)
        if state != LOST:
            raise AssertionError(f"a textureless frame came back in state {state}")
    ret_ms, inliers = [], []
    for j, f in enumerate(frames[40:80]):
        ts += 1.0 / 30
        b0 = lm_cuda.pose_optimize_lm.batched_launches
        t0 = time.perf_counter()
        out = resolved(system.track_rgbd(f["image"], f["depth"], ts))
        torch.cuda.synchronize()
        ret_ms.append((time.perf_counter() - t0) * 1e3)
        if out.state != OK:
            raise AssertionError(f"returning frame {40 + j}: state {out.state}")
        inliers.append(out.n_inliers)
        if j == 0:
            err = float(np.linalg.norm(np.asarray(out.Tcw)[:3, 3] - f["Tcw_gt"][:3, 3]))
            if not err < 0.05:
                raise AssertionError(f"relocalized frame 40 is {err} m off")
            if lm_cuda.pose_optimize_lm.batched_launches == b0:
                raise AssertionError("relocalization did not launch the batched K3")
    system.shutdown()
    if system.n_resets:
        raise AssertionError(f"{system.n_resets} auto-resets in the reloc path")
    return dict(kfs_before_loss=n_kfs, lost_frame_ms=lost_ms, reloc_frame_ms=ret_ms[0],
                reloc_translation_err_m=err, reloc_inliers=inliers[0],
                later_frames_p50_ms=float(np.median(ret_ms[1:])),
                n_kfs=system.tracker.n_kfs, inverted_file=system.db.sparse, frames_run=123)


def render_orbit():
    """The orbit of tests/test_loop_closing.py:38-40 with its 12-frame
    overshoot (56 frames), in sensor dtypes."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=1800, seed=0, extent=(14.0, 8.0, 20.0))
    base = syn.make_trajectory("orbit", n_frames=44)
    frames = []
    for f in syn.render_sequence(scene, np.concatenate([base, base[:12]]), K=syn.DEFAULT_K,
                                 depth=True):
        f["image"] = np.clip(f["image"], 0, 255).astype(np.uint8)
        f["depth"] = np.clip(f["depth"] * 1000.0, 0, 65535).astype(np.uint16)
        frames.append(f)
    return frames


def timed_detection(system, detect):
    """Wrap the loop closer's per-keyframe detection (the database query,
    the inverted file rebuilt first after an add, and the detection pack)
    so that `detect` receives (host ms of the call, its CUDA event pair)."""
    lc = system.loop_closer
    process = lc.process

    def timed(kf_id):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        out = process(kf_id)
        e.record()
        detect.append(((time.perf_counter() - t0) * 1e3, s, e))
        return out

    lc.process = timed


def detection_ms(detect):
    """Median host and device ms of the timed detections."""
    torch.cuda.synchronize()
    return dict(detections=len(detect),
                detect_host_ms_median=float(np.median([h for h, _, _ in detect])),
                detect_device_ms_median=float(np.median([s.elapsed_time(e)
                                                         for _, s, e in detect])))


def run_orbit(cfg, frames, dev, chunk_events=None, syncs=None, vocabulary_path=None,
              detect=None):
    """Returns (system, poses, per-frame seconds, loops closed after each
    frame, frames that ended with a global BA in flight). `syncs`, when a
    list, receives the host syncs of each frame from frame 10 on;
    `detect`, when a list, the timings of every loop detection."""
    system = make_system(cfg, dev, vocabulary_path)
    if detect is not None:
        timed_detection(system, detect)
    poses, secs, loops, in_flight = [], [], [], 0
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        if syncs is not None and i >= 10:
            out, n = host_syncs(lambda: resolved(system.track_rgbd(f["image"], f["depth"],
                                                                   f["timestamp"])))
            syncs.append(n)
        else:
            out = resolved(system.track_rgbd(f["image"], f["depth"], f["timestamp"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if out.state != 1:
            raise AssertionError(f"orbit frame {i}: tracking state {out.state}")
        poses.append(np.asarray(out.Tcw, np.float64))
        loops.append(system.n_loops)
        in_flight += system.loop_closer._bg is not None
    system.shutdown()
    return system, poses, secs, loops, in_flight


def loop_path(cfg, frames, dev, keep=None):
    """The orbit at the bench config: every frame tracked, >= 1 loop, the
    background GBA in flight and applied by shutdown(), ATE < 0.10 m
    (tests/test_loop_closing.py:50), and a bit-identical rerun. `keep`,
    when a dict, receives the first run's final map and the arguments of
    its last essential-graph solve (the loop's; System's warm-up solves a
    two-keyframe graph first)."""
    from orb_slam2_comment_tpu_torch.ops import optim
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    # time each GBA chunk with CUDA events (no host sync added)
    events = []
    chunk, graph = optim.gba_chunk, optim.essential_graph_optimize

    def timed_chunk(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = chunk(*a, **k)
        e.record()
        events.append((s, e))
        return out

    def kept_graph(*a, **k):
        if keep is not None:
            keep["graph"] = (tuple(x.clone() for x in a), dict(k))
        return graph(*a, **k)

    optim.gba_chunk, optim.essential_graph_optimize = timed_chunk, kept_graph
    detect = []
    try:
        system, poses, secs, loops, in_flight = run_orbit(cfg, frames, dev, detect=detect)
    finally:
        optim.gba_chunk, optim.essential_graph_optimize = chunk, graph
    torch.cuda.synchronize()
    if keep is not None:
        keep["map"] = system.tracker.map
    lc = system.loop_closer
    if system.n_loops < 1:
        raise AssertionError("the orbit closed no loop")
    if not (lc.n_gba_started >= 1 and in_flight >= 1 and lc.n_gba_applied >= 1):
        raise AssertionError(f"background GBA: started {lc.n_gba_started}, in flight after "
                             f"{in_flight} frames, applied {lc.n_gba_applied}")
    ate = ate_rmse(poses, [f["Tcw_gt"] for f in frames])
    if not (np.all(np.isfinite(np.stack(poses))) and ate < 0.10):
        raise AssertionError(f"orbit ATE {ate} m")
    _, poses2, _, _, _ = run_orbit(cfg, frames, dev)
    for i, (a, b) in enumerate(zip(poses, poses2)):
        if not np.array_equal(a, b):
            raise AssertionError(f"orbit rerun differs at frame {i}")
    close = int(np.argmax(np.asarray(loops) >= 1))
    # reference: the JAX package on the CPU over these same uint8/uint16 frames
    cand, kf = (int(x) for x in lc.loop_edges[0][:2])
    return dict(frames=len(frames), n_loops=system.n_loops, loop_pair=[kf, cand],
                closing_frame=close, closing_frame_ms=secs[close] * 1e3,
                frame_p50_ms=float(np.median(secs) * 1e3),
                gba_chunks=len(events),
                gba_chunk_ms_median=float(np.median([s.elapsed_time(e) for s, e in events])),
                gba_frames_in_flight=in_flight, gba_applied=lc.n_gba_applied,
                n_kfs=system.tracker.n_kfs, ate_m=ate, rerun_identical_frames=len(frames),
                **detection_ms(detect),
                reference_cpu=dict(loop_pair=[22, 0], n_kfs=27, ate_m=0.02025))


def staged_path(cfg, orbit, frames, dev, windows, main):
    """The staged tracking ladder and the monolithic local mapper at the
    bench config, run once and rerun. (a) The loop path's orbit with
    fused_tracking=False (the JAX package's own staged configuration,
    tests/test_loop_closing.py:34): every frame tracked on the host path
    with no device state, a loop closed and the background GBA applied,
    ATE < 0.10 m, a bit-identical rerun. (b) Main's frames 0-59 with
    chunked_mapper=False (the fused step, the mapper a keyframe callback):
    every frame tracked, ATE < 2 cm, no step of the chunked machine, and a
    rerun with the same poses bit for bit and the same keyframes. The
    local-BA windows of (a)'s first run are kept in `windows` for K4's
    check. Frame p50/p90 and host syncs per frame (counted on the reruns
    from frame 10) beside the main path's."""
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm
    from orb_slam2_comment_tpu_torch.ops import lba_cuda
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    acfg = dataclasses.replace(cfg, fused_tracking=False)
    prep = lba_cuda.prep_problem

    def keep(*a, **k):
        windows.append(prep(*a, **k))
        return windows[-1]

    lba_cuda.prep_problem = keep
    try:
        system, poses, secs, loops, in_flight = run_orbit(acfg, orbit, dev)
    finally:
        lba_cuda.prep_problem = prep
    torch.cuda.synchronize()
    lc = system.loop_closer
    if system.tracker.ds is not None or system.mapper.process not in \
            system.tracker.new_kf_callbacks:
        raise AssertionError("staged: a device state, or no monolithic mapper callback")
    if system.n_loops < 1 or lc.n_gba_applied < 1:
        raise AssertionError(f"staged orbit: {system.n_loops} loops, {lc.n_gba_applied} "
                             f"global BAs applied")
    ate = ate_rmse(poses, [f["Tcw_gt"] for f in orbit])
    if not (np.all(np.isfinite(np.stack(poses))) and ate < 0.10):
        raise AssertionError(f"staged orbit ATE {ate} m")
    if not windows:
        raise AssertionError("staged orbit: the monolithic mapper built no local-BA window")
    a_syncs = []
    _, poses2, _, _, _ = run_orbit(acfg, orbit, dev, syncs=a_syncs)
    for i, (x, y) in enumerate(zip(poses, poses2)):
        if not np.array_equal(x, y):
            raise AssertionError(f"staged orbit rerun differs at frame {i}")
    close = int(np.argmax(np.asarray(loops) >= 1))

    bcfg = dataclasses.replace(cfg, chunked_mapper=False)
    bframes = frames[:60]
    # the chunked machine must take no step in either monolithic run
    step, machine_steps = lm.mapper_machine_step, [0]

    def counted_step(*a, **k):
        machine_steps[0] += 1
        return step(*a, **k)

    lm.mapper_machine_step = counted_step
    try:
        bsys, brecs, bsecs, _, _ = run_sequence(bcfg, bframes, dev)
        bsys2, brecs2, _, _, b_syncs = run_sequence(bcfg, bframes, dev, count_syncs_from=10)
    finally:
        lm.mapper_machine_step = step
    if bsys.mapper.process not in bsys.tracker.new_kf_callbacks or machine_steps[0]:
        raise AssertionError(f"monolithic: no mapper callback, or {machine_steps[0]} "
                             f"machine steps")
    bposes = [np.asarray(r[0], np.float64) for r in brecs]
    bate = ate_rmse(bposes, [f["Tcw_gt"] for f in bframes])
    if not (np.all(np.isfinite(np.stack(bposes))) and bate < 0.02):
        raise AssertionError(f"monolithic ATE {bate} m")
    for i, (x, y) in enumerate(zip(brecs, brecs2)):
        if x[1:] != y[1:] or not np.array_equal(x[0], y[0]):
            raise AssertionError(f"monolithic rerun differs at frame {i}")
    if bsys2.tracker.n_kfs != bsys.tracker.n_kfs:
        raise AssertionError(f"monolithic rerun: {bsys2.tracker.n_kfs} keyframes, not "
                             f"{bsys.tracker.n_kfs}")

    def lat(xs, syncs):
        dt = np.asarray(xs[8:]) * 1e3
        return dict(p50_ms=float(np.percentile(dt, 50)), p90_ms=float(np.percentile(dt, 90)),
                    max_ms=float(dt.max()), host_syncs_per_frame_median=float(np.median(syncs)),
                    host_syncs_per_frame_max=int(max(syncs)))

    cand, kf = (int(x) for x in lc.loop_edges[0][:2])
    return dict(
        frames_run=2 * len(orbit) + 2 * len(bframes),
        staged_orbit=dict(frames=len(orbit), **lat(secs, a_syncs), n_kfs=system.tracker.n_kfs,
                          n_loops=system.n_loops, loop_pair=[kf, cand], closing_frame=close,
                          closing_frame_ms=secs[close] * 1e3, gba_applied=lc.n_gba_applied,
                          gba_frames_in_flight=in_flight, ate_m=ate, ba_windows=len(windows),
                          rerun_identical_frames=len(orbit)),
        monolithic=dict(frames=len(bframes), **lat(bsecs, b_syncs), n_kfs=bsys.tracker.n_kfs,
                        kf_frames=[i for i, r in enumerate(brecs) if r[2]], ate_m=bate,
                        rerun_n_kfs=bsys2.tracker.n_kfs, rerun_identical_frames=len(bframes),
                        machine_steps=machine_steps[0]),
        main=dict(p50_ms=main["p50_ms"], p90_ms=main["p90_ms"],
                  host_syncs_per_frame_median=main["host_syncs_per_frame_median"]))


# the street configuration of tools/make_datasets.py:54-62 (KITTI stereo)
KITTI_K = (718.0, 718.0, 620.0, 188.0)
KITTI_HW = (376, 1241)
KITTI_BASELINE = 0.54


def stereo_config():
    """The street config: 376x1241 stereo, bf = 718 x 0.54, 2000 features x
    8 levels, ThDepth 40, 10 fps; bench.py's capacities."""
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    K = KITTI_K
    return SlamConfig(
        sensor="stereo", fx=K[0], fy=K[1], cx=K[2], cy=K[3], bf=K[0] * KITTI_BASELINE,
        width=KITTI_HW[1], height=KITTI_HW[0], fps=10.0, th_depth=40.0, n_features=2000,
        n_levels=8, max_keyframes=128, max_points=32768, grow_capacity=False,
        match_th_scale=1.5)


def render_stereo(n_frames=30):
    """make_scene(3200 points, seed 0) driven through forward at 0.3 m per
    frame, seen by the KITTI-shaped pair, uint8."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=3200, seed=0)
    poses = syn.make_trajectory("forward", n_frames=n_frames, step=0.3)
    frames = []
    for f in syn.render_sequence(scene, poses, K=KITTI_K, hw=KITTI_HW, stereo=True,
                                 baseline=KITTI_BASELINE):
        for k in ("image", "image_right"):
            f[k] = np.clip(f[k], 0, 255).astype(np.uint8)
        frames.append(f)
    return frames


def mono_config():
    """bench.py's widths and capacities, monocular."""
    return dataclasses.replace(bench_config(), sensor="monocular", depth_map_factor=1.0)


def render_mono():
    """The scene and 14-frame sideways trajectory of
    tests/test_loop_closing.py:53-77, uint8."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=1600, seed=0, extent=(8.0, 6.0, 8.0), z_near=1.5)
    poses = np.tile(np.eye(4, dtype=np.float32), (14, 1, 1))
    poses[:, 0, 3] = -0.12 * np.arange(14)
    poses[:, 2, 3] = -0.02 * np.arange(14)
    frames = []
    for f in syn.render_sequence(scene, poses, K=syn.DEFAULT_K):
        f["image"] = np.clip(f["image"], 0, 255).astype(np.uint8)
        frames.append(f)
    return frames


def run_sensor(cfg, frames, dev, track):
    """track(system, frame) over the frames of a new default System.
    Returns (system, per-frame (Tcw or None, inliers, created_kf),
    per-frame seconds)."""
    system = make_system(cfg, dev)
    recs, secs = [], []
    for f in frames:
        t0 = time.perf_counter()
        out = resolved(track(system, f))
        secs.append(time.perf_counter() - t0)
        recs.append((None if out.Tcw is None else np.asarray(out.Tcw, np.float64),
                     out.n_inliers, out.created_kf))
    system.shutdown()
    return system, recs, secs


def same_records(a, b, what):
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        if x[1:] != y[1:] or (x[0] is None) != (y[0] is None) or (
                x[0] is not None and not np.array_equal(x[0], y[0])):
            raise AssertionError(f"{what} rerun differs at frame {i}")


def latency(secs, n_warm):
    """fps and percentiles of per-frame seconds after n_warm frames; of a
    call that reads its output, these time resolved frames."""
    dt = np.asarray(secs[n_warm:]) * 1e3
    return dict(timed=len(dt), fps=len(dt) / (dt.sum() / 1e3),
                p50_ms=float(np.percentile(dt, 50)), p90_ms=float(np.percentile(dt, 90)),
                p99_ms=float(np.percentile(dt, 99)), max_ms=float(dt.max()))


def stereo_path(cfg, frames, dev, windows):
    """System.track_stereo over the KITTI-shaped sequence: every frame
    tracked, >= 3 keyframes, ATE < 2 cm, a bit-identical rerun. The local-BA
    windows of the first run are kept in `windows` for K4's check."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    def track(system, f):
        return system.track_stereo(f["image"], f["image_right"], f["timestamp"])

    prep = lba_cuda.prep_problem

    def keep(*a, **k):
        windows.append(prep(*a, **k))
        return windows[-1]

    lba_cuda.prep_problem = keep
    try:
        system, recs, secs = run_sensor(cfg, frames, dev, track)
    finally:
        lba_cuda.prep_problem = prep
    torch.cuda.synchronize()
    lost = [i for i, r in enumerate(recs) if r[0] is None]
    if lost:
        raise AssertionError(f"stereo frames not tracked: {lost}")
    n_kfs = system.tracker.n_kfs
    if n_kfs < 3:
        raise AssertionError(f"stereo: only {n_kfs} keyframes")
    poses = [r[0] for r in recs]
    ate = ate_rmse(poses, [f["Tcw_gt"] for f in frames])
    if not (np.all(np.isfinite(np.stack(poses))) and ate < 0.02):
        raise AssertionError(f"stereo ATE {ate} m")
    _, recs2, _ = run_sensor(cfg, frames, dev, track)
    same_records(recs, recs2, "stereo")
    return dict(frames=len(frames), frames_run=2 * len(frames), **latency(secs, 3),
                n_kfs=n_kfs, kf_frames=[i for i, r in enumerate(recs) if r[2]], ate_m=ate,
                rerun_identical_frames=len(frames), ba_windows=len(windows),
                inliers_median=float(np.median([r[1] for r in recs[1:]])),
                reference_cpu=dict(tracked=30, n_kfs=4, ate_m=0.0092))


def mono_path(cfg, frames, dev):
    """System.track_monocular over the 14 frames: initialization succeeds,
    >= 2 keyframes, >= 8 frames tracked, Umeyama ATE < 5 cm, a
    bit-identical rerun."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    def track(system, f):
        return system.track_monocular(f["image"], f["timestamp"])

    system, recs, secs = run_sensor(cfg, frames, dev, track)
    torch.cuda.synchronize()
    tracked = [i for i, r in enumerate(recs) if r[0] is not None]
    if not tracked:
        raise AssertionError("monocular initialization never succeeded")
    init = tracked[0]
    n_kfs = system.tracker.n_kfs
    if n_kfs < 2 or len(tracked) < 8:
        raise AssertionError(f"mono: {n_kfs} keyframes, {len(tracked)} frames tracked")
    ate = ate_rmse([recs[i][0] for i in tracked], [frames[i]["Tcw_gt"] for i in tracked],
                   align="umeyama")
    if not ate < 0.05:
        raise AssertionError(f"mono ATE {ate}")
    _, recs2, _ = run_sensor(cfg, frames, dev, track)
    same_records(recs, recs2, "mono")
    after = np.asarray(secs[init + 1:]) * 1e3
    return dict(frames=len(frames), frames_run=2 * len(frames), init_frame=init,
                init_frame_ms=secs[init] * 1e3, before_init_ms=[t * 1e3 for t in secs[:init]],
                tracked=len(tracked), n_kfs=n_kfs, n_points=system.tracker.n_pts,
                n_live_points=int(system.tracker.map.pt_valid.sum()),
                ate_m=ate, after_init_p50_ms=float(np.median(after)),
                after_init_p99_ms=float(np.percentile(after, 99)),
                rerun_identical_frames=len(frames),
                # the JAX package on the CPU (tests/test_torch_mono.py run as a
                # script): n_points is its cursor `tracker.n_pts`
                reference_cpu=dict(tracked=12, n_kfs=4, ate_m=0.0143, n_points=681,
                                   n_live_points=404))


def centre_errors(poses, gts, gt0):
    """Camera-centre distances to the truth, in the map's world (camera 0
    of the first mapped frame, whose true pose is gt0)."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import camera_centers

    aligned = [g @ np.linalg.inv(gt0) for g in gts]
    return np.linalg.norm(camera_centers(poses, False) - camera_centers(aligned, False), axis=1)


def tum_poses(rows):
    """Tcw from 'ts tx ty tz qx qy qz qw' rows (camera-to-world in the file)."""
    from orb_slam2_comment_tpu_torch.ops import geometry as geo

    Rwc = geo.quat_to_rot(torch.from_numpy(rows[:, 4:8])).numpy().astype(np.float64)
    Twc = np.tile(np.eye(4), (len(rows), 1, 1))
    Twc[:, :3, :3] = Rwc
    Twc[:, :3, 3] = rows[:, 1:4]
    return list(np.linalg.inv(Twc))


def track_ok(system, frames, what, secs=None):
    """Track each frame through the façade; each must come back OK."""
    outs = []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        out = resolved(system.track_rgbd(f["image"], f["depth"], f["timestamp"]))
        torch.cuda.synchronize()
        if secs is not None:
            secs.append(time.perf_counter() - t0)
        if out.state != 1:
            raise AssertionError(f"{what} frame {i}: tracking state {out.state}")
        outs.append(out)
    return outs


def facade_path(cfg, frames, orbit, loop, dev, vo_problem, per_path):
    """The rest of the System API on bench-shaped frames (see the module
    docstring). Keeps the first VO frame's pose_optimize inputs in
    `vo_problem` and the VO frames' launch counts in per_path['vo']."""
    import tempfile

    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET, System
    from orb_slam2_comment_tpu_torch.ops import bow, lm_cuda, optim
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    gt0 = frames[0]["Tcw_gt"]
    res, segs = {}, {}
    system = make_system(cfg, dev)
    track_ok(system, frames[:60], "facade map")
    system.shutdown()
    n_kfs = system.tracker.n_kfs
    with tempfile.TemporaryDirectory() as d:
        system.save_trajectory_tum(f"{d}/tum.txt")
        system.save_trajectory_kitti(f"{d}/kitti.txt")
        system.save_keyframe_trajectory_tum(f"{d}/kf.txt")
        tum, kitti = np.loadtxt(f"{d}/tum.txt", ndmin=2), np.loadtxt(f"{d}/kitti.txt", ndmin=2)
        kf = np.loadtxt(f"{d}/kf.txt", ndmin=2)
        n_valid = int(system.tracker.map.kf_valid.sum())
        if not (tum.shape == (60, 8) and kitti.shape == (60, 12) and kf.shape == (n_valid, 8)):
            raise AssertionError(f"savers: tum {tum.shape}, kitti {kitti.shape}, keyframes "
                                 f"{kf.shape} for {n_valid} valid keyframes")
        if not np.allclose(kitti[:, [3, 7, 11]], tum[:, 1:4], atol=1e-6):
            raise AssertionError("the KITTI and TUM files disagree on the camera centres")
        ate_tum = float(np.sqrt(np.mean(centre_errors(tum_poses(tum),
                                                      [f["Tcw_gt"] for f in frames[:60]],
                                                      gt0) ** 2)))
        if not ate_tum < 0.02:
            raise AssertionError(f"facade: ATE of the TUM file {ate_tum} m")
        t0 = time.perf_counter()
        system.save_map(f"{d}/map.npz")
        res.update(n_kfs=n_kfs, saved_frames=60, tum_ate_m=ate_tum, keyframe_lines=len(kf),
                   save_map_s=time.perf_counter() - t0)

        # localization mode: no keyframe, so no local BA
        system.activate_localization_mode()
        c0, loc_s = read_counts(), []
        track_ok(system, frames[60:90], "localization", loc_s)
        segs["localization"] = {k: v - c0[k] for k, v in read_counts().items()}
        if system.tracker.n_kfs != n_kfs:
            raise AssertionError(f"localization mode made keyframes: {n_kfs} -> "
                                 f"{system.tracker.n_kfs}")
        c = segs["localization"]
        if not (c["fast_nms"] == c["gather_patches"] == 30 and c["pose_lm"] >= 30
                and c["lba_build"] == 0):
            raise AssertionError(f"localization frames launched {c}")

        # visual odometry: no map point matchable
        t = system.tracker
        t.map = t.map.replace(pt_valid=torch.zeros_like(t.map.pt_valid))
        calls, po = [], optim.pose_optimize

        def recording(*a, **k):
            calls.append((a, k))
            return po(*a, **k)

        optim.pose_optimize = recording
        c0, vo_s, vo_err = read_counts(), [], []
        try:
            for j, f in enumerate(frames[90:100]):
                calls.clear()
                out = track_ok(system, [f], "VO", vo_s)[0]
                if not system.tracker.vo:
                    raise AssertionError(f"VO frame {90 + j}: the VO flag is not set")
                if j == 0:   # the mbVO solve is the frame's last pose_optimize
                    vo_problem.append(calls[-1])
                vo_err.append(centre_errors([np.asarray(out.Tcw, np.float64)], [f["Tcw_gt"]],
                                            gt0)[0])
                if not vo_err[-1] < 0.08:
                    raise AssertionError(f"VO frame {90 + j} is {vo_err[-1]} m off")
        finally:
            optim.pose_optimize = po
        per_path["vo"] = {k: v - c0[k] for k, v in read_counts().items()}
        segs["vo"] = per_path["vo"]
        res.update(vo_max_err_m=float(max(vo_err)))

        # the saved map in a new System: relocalize in localization mode (a
        # LOST map of <= 5 keyframes is otherwise auto-reset, as in the
        # reference), then map again
        s2 = make_system(cfg, dev)
        t0 = time.perf_counter()
        s2.load_map(f"{d}/map.npz")
        res["load_map_s"] = time.perf_counter() - t0
        c0, b0, ld_s = read_counts(), lm_cuda.pose_optimize_lm.batched_launches, []
        s2.activate_localization_mode()
        outs = track_ok(s2, frames[60:61], "after load_map", ld_s)
        if lm_cuda.pose_optimize_lm.batched_launches == b0:
            raise AssertionError("the first frame after load_map did not relocalize")
        s2.deactivate_localization_mode()
        outs += track_ok(s2, frames[61:80], "after load_map", ld_s)
        if s2.n_resets:
            raise AssertionError("the loaded map was reset")
        segs["load"] = {k: v - c0[k] for k, v in read_counts().items()}
        missing = [k for k in K1_K4 if segs["load"][k] <= 0]
        if missing:
            raise AssertionError(f"after load_map, kernels never launched: {missing}")
        ate_load = float(np.sqrt(np.mean(centre_errors(
            [np.asarray(o.Tcw, np.float64) for o in outs],
            [f["Tcw_gt"] for f in frames[60:80]], gt0) ** 2)))
        if not ate_load < 0.02:
            raise AssertionError(f"after load_map: ATE {ate_load} m")
        res.update(load_n_kfs=s2.tracker.n_kfs, load_ate_m=ate_load,
                   reloc_after_load_ms=ld_s[0] * 1e3,
                   after_load_p50_ms=float(np.median(ld_s[1:]) * 1e3))

        # the packaged vocabulary as ORBvoc.txt text
        voc = bow.load_vocabulary(VOC_ASSET, dev)
        bow.save_orb_vocab_text(f"{d}/voc.txt", voc)
        tv = bow.load_orb_vocab(f"{d}/voc.txt", levels_up=voc.depth - voc.group_depth,
                                device=dev)
        m = system.tracker.map
        a, b = bow.transform(voc, m.kf_desc[0], m.kf_feat_valid[0]), bow.transform(
            tv, m.kf_desc[0], m.kf_feat_valid[0])
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError("the text vocabulary gives other words or groups")
        st = System(cfg, vocabulary_path=f"{d}/voc.txt", device=dev)
        if not (st.voc.node_word.device == voc.node_word.device
                and st.voc.n_words == voc.n_words):
            raise AssertionError("System did not read the text vocabulary onto its device")
        res.update(text_vocab_words=int((a[0] >= 0).sum()),
                   text_vocab_bow_max_diff=(a[2] - b[2]).abs().max().item())

    # the orbit with the global BA solved inside the closing frame
    close = loop["closing_frame"]
    s3 = make_system(cfg, dev)
    s3.loop_closer.gba_background = False
    sec, poses = [], []
    for i, f in enumerate(orbit[:close + 5]):
        poses.append(np.asarray(track_ok(s3, [f], "sync-GBA orbit", sec)[0].Tcw, np.float64))
        if i == close:
            lc = s3.loop_closer
            if not (s3.n_loops == 1 and lc.n_gba_applied == 1 and lc.n_gba_started == 0
                    and lc._bg is None):
                raise AssertionError(f"closing frame {i}: loops {s3.n_loops}, GBA applied "
                                     f"{lc.n_gba_applied}, started {lc.n_gba_started}")
    pair = [int(x) for x in s3.loop_closer.loop_edges[0][:2]][::-1]
    if pair != loop["loop_pair"]:
        raise AssertionError(f"synchronous GBA closed {pair}, the background run {loop['loop_pair']}")
    ate_sync = ate_rmse(poses, [f["Tcw_gt"] for f in orbit[:close + 5]])
    if not ate_sync < 0.10:
        raise AssertionError(f"synchronous-GBA orbit ATE {ate_sync} m")
    n_frames = 60 + 30 + 10 + 20 + close + 5

    def p(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q))

    res.update(frames_run=n_frames, loc_p50_ms=p(loc_s, 50), loc_p90_ms=p(loc_s, 90),
               vo_p50_ms=p(vo_s, 50), vo_p90_ms=p(vo_s, 90), sync_gba_loop_pair=pair,
               sync_gba_closing_frame=close, sync_gba_closing_frame_ms=sec[close] * 1e3,
               sync_gba_ate_m=ate_sync, segment_launches=segs)
    return res


def check_k3_vo(cfg, call):
    """K3 on the first VO frame's pose_optimize inputs against its plain
    version: pose within check_k3's 5e-3, <= 5 inliers apart."""
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    args, kw = call
    ker, dT, dmask = k3_agrees(call, "K3@vo")
    res = dict(max_abs_err=dT, inlier_flags_differing=dmask, library_ms=None,
               edges=int(args[5].sum()),
               **timed(lambda: lm_cuda.pose_optimize_lm(*args, **kw),
                       lambda: lm_cuda.pose_optimize_plain(*args, **kw)),
               **k3_bound(args, cfg))
    print(f"# K3 pose_lm@vo: {res['edges']} valid edges of {args[1].shape[0]}, |dT|={dT:.2e}, "
          f"{dmask} inlier flags differ (inliers {int(ker.n_inliers)}); {res['ms']:.4f} ms, "
          f"{res['device_ms']:.4f} from a graph (plain {res['plain_ms']:.4f}, bound "
          f"{res['bound_ms']:.6f})", flush=True)
    return res


def k3_agrees(call, what):
    """K3 on one recorded pose_optimize call against its plain version:
    pose within check_k3's 5e-3, <= 5 inlier flags apart. Returns (kernel
    result, |dT|, flags differing)."""
    from orb_slam2_comment_tpu_torch.ops import lm_cuda

    args, kw = call
    ker = lm_cuda.pose_optimize_lm(*args, **kw)
    pl = lm_cuda.pose_optimize_plain(*args, **kw)
    dT = (ker.Tcw - pl.Tcw).abs().max().item()
    dmask = int((ker.inliers != pl.inliers).sum())
    if not (dT < 5e-3 and dmask <= 5):
        raise AssertionError(f"{what} disagrees: |dT|={dT}, {dmask} inlier flags differ")
    return ker, dT, dmask


def k4_density(windows, K, BF, what):
    """K4 against its plain version on every captured local-BA window, at
    the window's start (lba_init, robust), each field within 1e-3 relative.
    Returns [(active observations per valid window camera, worst field rel
    err)] in window order, and prints the curve with the slope of log(err)
    over log(observations per camera)."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    curve, ratios = [], []
    for prep in windows:
        prob, inv = prep.prob, prep.inv_sigma2_levels
        cam_T, pts, *_, obs_ok = optim.lba_init(prob, inv, K, BF)
        sk = lba_cuda.build_system(prep, cam_T, pts, obs_ok, True, K, BF)
        sp = optim.build_system_plain(prob, inv, prep.F, cam_T, pts, obs_ok, True, K, BF)
        n_cam = max(int(prob.cam_valid.sum()), 1)
        curve.append((int(obs_ok.sum()) / n_cam, k4_field_err(sp, sk, f"K4 on a {what} window")))
        ratios.append(k4_sum_bound(k4_abs_sums(prob, inv, prep.F, cam_T, pts, obs_ok, True, K,
                                               BF), sp, sk, f"K4 on a {what} window"))
    x = np.asarray([c[0] for c in curve])
    y = np.asarray([c[1] for c in curve])
    keep = (y > 0) & (x > 0)
    slope = (float(np.polyfit(np.log(x[keep]), np.log(y[keep]), 1)[0])
             if keep.sum() >= 3 and np.ptp(x[keep]) > 0 else None)
    order = np.argsort(x)
    print(f"# K4 density on the {what} path: {len(curve)} windows, obs/camera "
          f"{x.min():.1f}-{x.max():.1f}, worst field rel err {y.max():.3e}; log-log slope "
          f"{slope}; worst |K4 - plain| / (2^-24 S) {max(ratios):.3f} (bound {K4_C}); "
          "(obs/camera, err) sorted: "
          + " ".join(f"({x[i]:.1f},{y[i]:.2e})" for i in order), flush=True)
    return dict(windows=len(curve), obs_per_cam_min=float(x.min()), obs_per_cam_max=float(x.max()),
                worst_err=float(y.max()), loglog_slope=slope, worst_sum_ratio=max(ratios),
                curve=[[float(a), float(b)] for a, b in curve])


def k4_window_errors(windows, K, BF, what):
    """Hold K4 to its plain version on every captured local-BA window at
    its start (lba_init, robust) within K4_C * 2^-24 * S entrywise, and
    print each field's largest magnitude in the plain version, the largest
    difference and the worst ratio to 2^-24 * S. A window linearized where
    its BA has converged has a near-zero camera gradient bc, so
    k4_field_err's per-field relative error says little there; S scales
    with the rounding both builds actually do."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    rows = []
    for i, prep in enumerate(windows):
        prob, inv = prep.prob, prep.inv_sigma2_levels
        cam_T, pts, *_, obs_ok = optim.lba_init(prob, inv, K, BF)
        sk = lba_cuda.build_system(prep, cam_T, pts, obs_ok, True, K, BF)
        sp = optim.build_system_plain(prob, inv, prep.F, cam_T, pts, obs_ok, True, K, BF)
        ratio = k4_sum_bound(k4_abs_sums(prob, inv, prep.F, cam_T, pts, obs_ok, True, K, BF),
                             sp, sk, f"K4 on {what} window {i}")
        rows.append({f: (float(getattr(sp, f).double().abs().max()),
                         float((getattr(sp, f).double() - getattr(sk, f).double()).abs().max()))
                     for f in ("Hcc", "bc", "Hpp9", "bp3", "E")}
                    | dict(active=int(obs_ok.sum()), sum_ratio=ratio))
    print(f"# K4 on all {len(rows)} {what} windows within {K4_C} * 2^-24 * S (active obs, "
          "ratio, then field: max |plain|, max |diff|): " + json.dumps(rows), flush=True)
    return rows


def grow_config():
    """bench.py's widths (640x480, 1000 x 8) from the smallest tiers the
    BA-window constants and LOCAL_POINTS_CAP allow (16 keyframes, 8192
    points), growth on with caps 64 and 32768, loop closing on."""
    return dataclasses.replace(bench_config(), grow_capacity=True, max_keyframes=16,
                               max_points=8192, max_keyframes_cap=64, max_points_cap=32768)


def render_grow_orbit():
    """The orbit of tests/test_capacity.py:218-254: make_scene(1400, seed
    0), 60 frames at step 0.1, in sensor dtypes."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=1400, seed=0)
    frames = []
    for f in syn.render_sequence(scene, syn.make_trajectory("orbit", n_frames=60, step=0.1),
                                 K=syn.DEFAULT_K, depth=True):
        f["image"] = np.clip(f["image"], 0, 255).astype(np.uint8)
        f["depth"] = np.clip(f["depth"] * 1000.0, 0, 65535).astype(np.uint16)
        frames.append(f)
    return frames


def run_grow(cfg, frames, dev, calls=None):
    """System.track_rgbd over the orbit. Returns (system, per-frame Tcw or
    None, per-frame seconds, growth events: frame, tiers, n_kfs and the
    launch counts at that moment). With `calls`, the last frame's
    pose_optimize calls are kept there."""
    from orb_slam2_comment_tpu_torch.ops import optim

    system = make_system(cfg, dev)
    poses, secs, events = [], [], []
    system.tracker.grow_callbacks.append(lambda c: events.append(dict(
        frame=len(poses), max_keyframes=c.max_keyframes, max_points=c.max_points,
        n_kfs=system.tracker.n_kfs, counts=read_counts())))
    po = optim.pose_optimize

    def recording(*a, **k):
        calls.append((a, k))
        return po(*a, **k)

    for i, f in enumerate(frames):
        if calls is not None and i == len(frames) - 1:
            optim.pose_optimize = recording
        try:
            t0 = time.perf_counter()
            out = resolved(system.track_rgbd(f["image"], f["depth"], f["timestamp"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        finally:
            optim.pose_optimize = po
        poses.append(None if out.Tcw is None else np.asarray(out.Tcw, np.float64))
    system.shutdown()
    return system, poses, secs, events


def grow_path(cfg, frames, dev, windows, calls):
    """The orbit from the smallest tiers: growth fires; the System, the
    tracker, the loop closer, the map, the database, the keyframe
    timestamps and the mapper machine all agree on the new tier; the
    keyframes created before it survive; K1-K4 launch after it; the last
    frame is tracked, ATE < 10 cm (PERF.md §2's orbit bound) and a rerun
    is bit-identical. Local-BA windows go to `windows`, the last frame's
    pose_optimize calls to `calls`."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    prep = lba_cuda.prep_problem

    def keep(*a, **k):
        windows.append(prep(*a, **k))
        return windows[-1]

    lba_cuda.prep_problem = keep
    try:
        system, poses, secs, events = run_grow(cfg, frames, dev, calls)
    finally:
        lba_cuda.prep_problem = prep
    end = read_counts()
    if not events or system.cfg.max_keyframes <= 16:
        raise AssertionError(f"growth never reached the keyframe tier: {events}")
    t, k, p = system.tracker, system.cfg.max_keyframes, system.cfg.max_points
    lc = system.loop_closer
    tiers = dict(keyframes=[k, t.cfg.max_keyframes, lc.cfg.max_keyframes, t.map.kf_obs.shape[0],
                            system.db.valid.shape[0], len(t.kf_ts_host)],
                 points=[p, t.cfg.max_points, lc.cfg.max_points, t.map.pt_pos.shape[0]])
    if any(len(set(v)) != 1 for v in tiers.values()):
        raise AssertionError("tiers disagree after growth (System, tracker, loop closer, map, "
                             f"database, keyframe timestamps): {tiers}")
    mp = t.ds.mp
    if mp.ba_cam_ids.shape[0] != min(cfg.ba_free_kfs, k) + min(cfg.ba_fixed_kfs, k):
        raise AssertionError("the mapper machine was not rebuilt at the new tier")
    kf_growth = next(e for e in events if e["max_keyframes"] > 16)
    n_before = kf_growth["n_kfs"]
    valid_before = int(t.map.kf_valid[:n_before].sum())
    if not (n_before >= 13 and valid_before >= 10):
        raise AssertionError(f"keyframes before growth: {n_before} slots, {valid_before} valid")
    after = {kk: end[kk] - kf_growth["counts"][kk] for kk in K1_K4}
    if min(after.values()) <= 0:
        raise AssertionError(f"kernels not launched after growth: {after}")
    if poses[-1] is None:
        raise AssertionError("the last orbit frame is not tracked")
    tracked = [i for i, T in enumerate(poses) if T is not None]
    ate = ate_rmse([poses[i] for i in tracked], [frames[i]["Tcw_gt"] for i in tracked])
    if not ate < 0.10:
        raise AssertionError(f"grow orbit ATE {ate} m")
    _, poses2, _, events2 = run_grow(cfg, frames, dev)
    if [e["frame"] for e in events2] != [e["frame"] for e in events]:
        raise AssertionError("the rerun grew at other frames")
    for i, (a, b) in enumerate(zip(poses, poses2)):
        if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
            raise AssertionError(f"grow rerun differs at frame {i}")
    g = kf_growth["frame"]
    return dict(frames=len(frames), frames_run=2 * len(frames),
                growth=[{kk: e[kk] for kk in ("frame", "max_keyframes", "max_points", "n_kfs")}
                        for e in events],
                growth_frame_ms=secs[g] * 1e3,
                neighbour_frames_p50_ms=float(np.median(secs[max(g - 5, 0):g] + secs[g + 1:g + 6])
                                              * 1e3),
                frame_p50_ms=float(np.median(secs) * 1e3), tiers=[k, p],
                kfs_before_growth=n_before, valid_of_those=valid_before,
                launches_after_growth=after, n_kfs=t.n_kfs, valid_kfs=int(t.map.kf_valid.sum()),
                tracked=len(tracked), n_loops=system.n_loops, ate_m=ate,
                ba_windows=len(windows), rerun_identical_frames=len(frames))


DESK_FRAMES = 90
ROOT = os.path.dirname(os.path.abspath(__file__))


def render_desk(out):
    """The head of the desk sequence: the scene, trajectory and writers of
    tools/make_datasets.py:43-51 (tests/test_accuracy_smoke.py:46-57),
    through the port's renderer, into `out`."""
    from orb_slam2_comment_tpu_torch.utils import render as rr

    K_TUM, HW_TUM = (520.0, 520.0, 320.0, 240.0), (480, 640)
    scene = rr.make_room(seed=13, size=(7.0, 3.0, 7.0), n_boxes=6)
    poses = rr.desk_trajectory(400, seed=3)[:DESK_FRAMES]
    rr.write_tum_rgbd(out, scene, poses, K_TUM, HW_TUM, fps=30.0)
    rr.write_settings_yaml(os.path.join(out, "settings.yaml"), K_TUM, HW_TUM, fps=30.0, bf=40.0,
                           depth_factor=rr.DEPTH_FACTOR_TUM, n_features=1000)


def start_desk_render():
    """Render the desk head into data/ in a new interpreter, whose worker
    processes fork from a process that never touched CUDA. Returns (the
    sequence folder, the process)."""
    out = os.path.join(ROOT, "data", "port_desk_head")
    shutil.rmtree(out, ignore_errors=True)
    proc = subprocess.Popen([sys.executable, "-c",
                             f"import chip_smoke; chip_smoke.render_desk({out!r})"], cwd=ROOT)
    return out, proc


def desk_path(seq, dev, smi):
    """The port's run_dataset driver on the rendered desk head, as the
    reference's rgbd_tum runs it, from its settings.yaml (the default
    SlamConfig: growth and loop closing on), frames prestaged on the card,
    2 runs: every frame in the TUM file, ATE < 15 mm (ATE_LIMIT_M of
    tests/test_accuracy_smoke.py; the JAX package measured 5.7-6.8 mm),
    the warm run's fps over its wall with the final drain included, and
    its per-call dispatch latency (a fused frame resolves after its call
    returns, so per-call times do not time frames)."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset
    from orb_slam2_comment_tpu_torch.utils.trajectory import umeyama_align

    times, walls = [], []
    system = run_dataset.run("rgbd", "tum_rgbd", seq, settings=os.path.join(seq, "settings.yaml"),
                             associations=os.path.join(seq, "associations.txt"),
                             out_prefix=os.path.join(seq, "port"), runs=2, prestage=True,
                             device=dev, timings=times, walls=walls)
    cfg = system.cfg
    if not (cfg.grow_capacity and system.loop_closer is not None and cfg.n_features == 1000
            and cfg.n_levels == 8 and system.tracker.map.kf_pose.device.type == dev.type):
        raise AssertionError(f"the desk driver did not build the default System on {dev}: "
                             f"{cfg}")
    est = np.loadtxt(os.path.join(seq, "port_tum.txt"), ndmin=2)
    gt = np.loadtxt(os.path.join(seq, "groundtruth.txt"), ndmin=2)
    ia = [i for i, t_ in enumerate(est[:, 0]) if np.abs(gt[:, 0] - t_).min() <= 0.02]
    ib = [int(np.argmin(np.abs(gt[:, 0] - est[i, 0]))) for i in ia]
    if len(ia) < DESK_FRAMES - 2:
        raise AssertionError(f"desk coverage {len(ia)}/{DESK_FRAMES}")
    aligned, _ = umeyama_align(est[ia, 1:4], gt[ib, 1:4], False)
    ate = float(np.sqrt(np.mean(np.sum((aligned - gt[ib, 1:4]) ** 2, axis=1))))
    if not ate < 0.015:
        raise AssertionError(f"desk head ATE {ate * 1e3:.2f} mm")
    return dict(frames=DESK_FRAMES, frames_run=2 * DESK_FRAMES, ate_m=ate, coverage=len(ia),
                n_kfs=system.tracker.n_kfs, n_loops=system.n_loops,
                tiers=(cfg.max_keyframes, cfg.max_points), card=smi,
                warm_fps=len(times) / walls[-1], warm_wall_s=walls[-1],
                warm_dispatch=latency(times, 5),
                reference_cpu=dict(ate_m_range=[0.0057, 0.0068]))


# ---------------------------------------------------------------------------
# the placerec path: place recognition at vocabulary scale (the port's
# examples/eval_vocab_pr.py) and the loop orbit with the 97,273-word
# vocabulary, whose database is the inverted file
# ---------------------------------------------------------------------------

PLACEREC_DIR = os.path.join(ROOT, "build", "placerec")
# keyframes of eval_vocab_pr's workload, both traversals (the tool's default)
PLACEREC_KFS = 560
# the port's plain CPU path is held on a database of this many first-
# traversal keyframes, queried by the first PLACEREC_CPU_QUERIES keyframes
# of the second traversal (their true matches are in it)
PLACEREC_CPU_DB = 40
PLACEREC_CPU_QUERIES = 20
# L1 scores against the CPU path: the same f32 terms summed in other orders
# (tests/test_torch_placerec.py's SCORE_ATOL)
PLACEREC_SCORE_ATOL = 1e-6
PLACEREC_MIN_RECALL = 0.9
# the loop path's orbit with the 97,273-word vocabulary through the JAX
# package on the CPU, run by hand (tests/test_torch_placerec.py,
# test_orbit_with_the_large_vocabulary_like_jax): it closes keyframe 22 on
# keyframe 0 with 27 keyframes, as the port does on the CPU
PLACEREC_ORBIT_REF = dict(loop_pair=[22, 0], n_kfs=27)


def render_placerec(out, n_kfs, workers):
    """Render eval_vocab_pr's workload of n_kfs keyframes (f32, as
    render_quads returns them) into the .npy `out` with a process pool;
    `out`.json receives the seconds it took."""
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as E

    t0 = time.perf_counter()
    tmp = out + ".part"
    arr = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32,
                                    shape=(2 * (n_kfs // 2), 480, 640))
    E.render_all(n_kfs, workers, out=arr)
    arr.flush()
    del arr
    os.replace(tmp, out)
    with open(out + ".json", "w") as f:
        json.dump(dict(seconds=time.perf_counter() - t0, workers=workers,
                       n_kfs=2 * (n_kfs // 2)), f)


def placerec_images(n_kfs, children):
    """Run render_placerec in a new interpreter (its workers spawned from
    it, one per core) and wait for it: nothing else runs meanwhile. The
    process goes into `children`. Returns (the images as a read-only memory
    map, the render's metadata, the seconds waited)."""
    os.makedirs(PLACEREC_DIR, exist_ok=True)
    out = os.path.join(PLACEREC_DIR, f"images_{n_kfs}.npy")
    for f in (out, out + ".json"):
        if os.path.exists(f):
            os.remove(f)
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke."
                             f"render_placerec({out!r}, {n_kfs}, {workers})"], cwd=ROOT)
    children.append(proc)
    if proc.wait() != 0:
        raise AssertionError(f"rendering the place-recognition workload failed "
                             f"({proc.returncode})")
    waited = time.perf_counter() - t0
    with open(out + ".json") as f:
        meta = json.load(f)
    return np.load(out, mmap_mode="r"), meta, waited


def placerec_against_cpu(voc_path, descs, valids, poses, dev):
    """The card's evaluate() and the port's plain CPU path on the same
    descriptors: PLACEREC_CPU_DB first-traversal keyframes indexed,
    PLACEREC_CPU_QUERIES second-traversal ones queried; words, top-1 and
    top-2 equal, scores within PLACEREC_SCORE_ATOL. Returns the largest
    score difference."""
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as E
    from orb_slam2_comment_tpu_torch.ops import bow

    half, n = len(poses) // 2, PLACEREC_CPU_DB
    sel = list(range(n)) + list(range(half, half + n))
    d, v, p = descs[sel], valids[sel], poses[sel]
    q = PLACEREC_CPU_QUERIES
    card = E.evaluate(bow.load_vocabulary(voc_path, dev), d, v, p, dev, n_queries=q, keep=q)
    cpu = E.evaluate(bow.load_vocabulary(voc_path, "cpu"), d.cpu(), v.cpu(), p, "cpu",
                     n_queries=q, keep=q)
    worst = 0.0
    for a, b, ka, kb in zip(card["records"], cpu["records"], card["kept"], cpu["kept"],
                            strict=True):
        if not np.array_equal(ka["words"], kb["words"]):
            raise AssertionError(f"{voc_path}: query {a['q']}'s words differ from the CPU's")
        if (a["top1"], a["top2"]) != (b["top1"], b["top2"]):
            raise AssertionError(f"{voc_path}: query {a['q']}: top-2 {a['top2']} on the card, "
                                 f"{b['top2']} on the CPU")
        worst = max(worst, float(np.abs(ka["scores"] - kb["scores"]).max()))
    if not worst <= PLACEREC_SCORE_ATOL:
        raise AssertionError(f"{voc_path}: scores differ from the CPU's by {worst}")
    return dict(queries=len(card["records"]), db=n, max_score_diff=worst,
                mode_cpu=cpu["mode"])


def placerec_cap_against_cpu(voc_path, r, dev):
    """The card's database of evaluate() result `r` (the whole first
    traversal) carried to the port's plain CPU path, queried there with
    the card's words of r's kept queries: scores within PLACEREC_SCORE_ATOL,
    equal shared-word counts and, for the inverted file, equal dropped
    postings, which must be some (the lists past the cap of 96). Returns
    the largest score difference and the postings dropped."""
    from orb_slam2_comment_tpu_torch.models.keyframe_database import KeyFrameDatabase
    from orb_slam2_comment_tpu_torch.ops import bow

    db = r["db"]
    cpu = KeyFrameDatabase.from_numpy(bow.load_vocabulary(voc_path, "cpu"), db.to_numpy(), "cpu")
    kmax = db.valid.shape[0]
    worst, dropped = 0.0, 0
    for kept in r["kept"]:
        words = torch.from_numpy(kept["words"])
        out = []
        for d, w in ((db, words.to(dev)), (cpu, words)):
            sc, cm = d.scores_device(q_words_feat=w)
            n = 0
            if d.sparse:
                n = int(bow.inverted_file_query(*d.postings(),
                                                *bow.sparse_bow(d.voc.word_weight, w),
                                                kmax=kmax)[2])
            out.append((sc.cpu().numpy(), cm.cpu().numpy(), n))
        (sa, ca, na), (sb, cb, nb) = out
        if not (np.array_equal(ca, cb) and na == nb):
            raise AssertionError(f"{voc_path}: query {kept['q']} on the whole database: "
                                 f"shared words or dropped postings ({na}, {nb}) differ")
        worst = max(worst, float(np.abs(sa - sb).max()))
        dropped += na
    if not worst <= PLACEREC_SCORE_ATOL:
        raise AssertionError(f"{voc_path}: whole-database scores differ from the CPU's by {worst}")
    if db.sparse and not dropped > 0:
        raise AssertionError(f"{voc_path}: no posting list passed the cap in {len(r['kept'])} "
                             "queries")
    return dict(queries=len(r["kept"]), db=kmax, max_score_diff=worst, n_dropped=dropped)


def placerec_path(cfg, orbit, frames, dev, reloc, keep, children):
    """(a) eval_vocab_pr's workload of PLACEREC_KFS keyframes, rendered
    first with nothing else running (placerec_images), then extracted on
    the card (K1 and K2 once per keyframe) and evaluated with both
    packaged vocabularies (dense at 9991 words, the inverted file at
    97,273): recall@1 >= PLACEREC_MIN_RECALL each, the card against the
    port's CPU path (placerec_against_cpu, placerec_cap_against_cpu).
    (b) the loop path's orbit with the 9991-word vocabulary and then with
    the 97,273-word one, under the same load: each tracks every frame and
    closes the loop of the JAX package on the CPU, ATE < 0.10 m, and the
    97k run reruns bit-identical; then the reloc path with the 97k
    vocabulary (relocalization's candidates from the inverted file).
    `keep` receives an evaluation frame."""
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as E
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET, VOC_ASSET_100K
    from orb_slam2_comment_tpu_torch.ops import bow
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    images, rmeta, waited = placerec_images(PLACEREC_KFS, children)
    _, poses = E.workload(rmeta["n_kfs"])
    if images.shape != (len(poses), 480, 640) or images.dtype != np.float32:
        raise AssertionError(f"rendered images {images.shape} {images.dtype}")
    keep["image"] = np.array(images[0])
    descs, valids, ext_ms = E.extract_all(images, dev)
    counts = read_counts()
    n = len(poses)
    if not (counts["fast_nms"] == counts["gather_patches"] == n
            and counts["pose_lm"] == counts["lba_build"] == 0):
        raise AssertionError(f"extracting {n} keyframes launched {counts}")
    res = dict(keyframes=n, render_s=rmeta["seconds"], render_workers=rmeta["workers"],
               render_waited_s=waited, extract_ms_per_kf=ext_ms,
               valid_features_min=int(valids.sum(1).min()))
    for name, vpath in (("voc_synth", VOC_ASSET), ("voc_synth_100k", VOC_ASSET_100K)):
        voc = bow.load_vocabulary(vpath, dev)
        r = E.evaluate(voc, descs, valids, poses, dev, keep=PLACEREC_CPU_QUERIES)
        print("# placerec " + E.line(name, r) + f" n_dropped max={r['n_dropped_max']} "
              f"total={r['n_dropped_total']}", flush=True)
        if not r["recall@1"] >= PLACEREC_MIN_RECALL:
            raise AssertionError(f"{name}: recall@1 {r['recall@1']}")
        if (r["mode"] == "dense") != (voc.n_words <= 16384):
            raise AssertionError(f"{name}: {r['mode']} database at {voc.n_words} words")
        res[name] = {k: v for k, v in r.items() if k not in ("records", "kept", "db")}
        res[name]["against_cpu"] = placerec_against_cpu(vpath, descs, valids, poses, dev)
        res[name]["whole_db_against_cpu"] = placerec_cap_against_cpu(vpath, r, dev)
    # (b) the loop orbit at both vocabularies back to back, then the rerun
    ref = PLACEREC_ORBIT_REF
    for name, vpath in (("orbit_10k", None), ("orbit_97k", VOC_ASSET_100K)):
        detect = []
        system, tposes, secs, loops, _ = run_orbit(cfg, orbit, dev, vocabulary_path=vpath,
                                                   detect=detect)
        if system.db.sparse != (vpath is not None):
            raise AssertionError(f"{name}: inverted file {system.db.sparse}")
        ate = ate_rmse(tposes, [f["Tcw_gt"] for f in orbit])
        if not (np.all(np.isfinite(np.stack(tposes))) and ate < 0.10):
            raise AssertionError(f"{name} ATE {ate} m")
        lc = system.loop_closer
        pairs = [[int(x) for x in e[:2]][::-1] for e in lc.loop_edges]
        if pairs[:1] != [ref["loop_pair"]]:
            raise AssertionError(f"{name} closed {pairs}, the JAX package on the CPU {ref}")
        if not lc.n_gba_applied >= 1:
            raise AssertionError(f"{name}: a loop closed but no global BA was applied")
        close = int(np.argmax(np.asarray(loops) >= 1))
        res[name] = dict(
            frames=len(orbit), n_loops=system.n_loops, loop_pairs=pairs,
            n_kfs=system.tracker.n_kfs, closing_frame=close,
            closing_frame_ms=secs[close] * 1e3, frame_p50_ms=float(np.median(secs) * 1e3),
            ate_m=ate, gba_applied=lc.n_gba_applied, **detection_ms(detect), reference_cpu=ref)
    _, tposes2, _, _, _ = run_orbit(cfg, orbit, dev, vocabulary_path=VOC_ASSET_100K)
    for i, (a, b) in enumerate(zip(tposes, tposes2)):
        if not np.array_equal(a, b):
            raise AssertionError(f"97k orbit rerun differs at frame {i}")
    res["orbit_97k"]["rerun_identical_frames"] = len(orbit)
    res["reloc_97k"] = reloc_path(cfg, frames, dev, VOC_ASSET_100K)
    if not res["reloc_97k"]["inverted_file"]:
        raise AssertionError("the 97,273-word reloc System's database is not the inverted file")
    res["reloc_10k"] = {k: reloc[k] for k in ("reloc_frame_ms", "reloc_translation_err_m",
                                              "reloc_inliers", "n_kfs")}
    res["frames_run"] = n + 3 * len(orbit) + res["reloc_97k"]["frames_run"]
    return res


# ---------------------------------------------------------------------------
# the dist path: distributed BA (parallel/dist_ba.py) and the dense-Schur
# local BA on the maps of the main and loop paths
# ---------------------------------------------------------------------------

DIST_DIR = os.path.join(ROOT, "build", "dist")
# the single-process and distributed GBA, and the two pose-error bounds
DIST_GBA_ITERS, DIST_RANK_TOL, LBA_LAYOUT_TOL = 10, 1e-3, 1e-3


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pose_err(Ta, Tb):
    """Largest |se3_log(Ta Tb^-1)| over the cameras, in float64."""
    from orb_slam2_comment_tpu_torch.ops import geometry as geo

    return float(geo.se3_log(Ta.double() @ geo.inv_T(Tb.double())).norm(dim=-1).max())


def _same(a, b, what):
    for f in a._fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs from the single-process solve")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _iteration_ms(run, dev):
    """(ms of one LM iteration, all-reduce calls and bytes per iteration):
    run(1) and run(2) after a warm call, the difference of their spans."""
    from orb_slam2_comment_tpu_torch.parallel import dist_ba

    run(1)
    spans, counts = [], []
    for n in (1, 2):
        dist_ba.stats.update(calls=0, bytes=0)
        _sync(dev)
        t0 = time.perf_counter()
        run(n)
        _sync(dev)
        spans.append((time.perf_counter() - t0) * 1e3)
        counts.append(dict(dist_ba.stats))
    return dict(one_iteration_ms=spans[1] - spans[0], iters1_ms=spans[0], iters2_ms=spans[1],
                all_reduce_calls_per_iteration=counts[1]["calls"] - counts[0]["calls"],
                all_reduce_bytes_per_iteration=counts[1]["bytes"] - counts[0]["bytes"])


def dist_rank(rank, world, port, problem, out):
    """One gloo rank on the saved problem's device (cuda:0 for dist_path;
    run in its own process): the distributed GBA of the problem, then one
    iteration timed. Rank 0 saves the result and prints the timings as
    `DIST_RANK <json>`."""
    import torch.distributed as dist

    from orb_slam2_comment_tpu_torch.ops import optim
    from orb_slam2_comment_tpu_torch.parallel import dist_ba

    z = torch.load(problem)
    dev = torch.device(z["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        prob = optim.BAProblem(**{k: v.to(dev) for k, v in z["prob"].items()})
        inv, K, bf = z["inv"].to(dev), z["K"], z["bf"]
        res = dist_ba.distributed_global_ba(prob, inv, K, bf, iters=DIST_GBA_ITERS)
        timing = _iteration_ms(lambda n: dist_ba.distributed_global_ba(prob, inv, K, bf,
                                                                       iters=n), dev)
        if rank == 0:
            torch.save({f: getattr(res, f).cpu() for f in res._fields}, out)
            print("DIST_RANK " + json.dumps(timing), flush=True)
    finally:
        dist.destroy_process_group()


def gloo_ranks(prob, inv, K, bf, world=2):
    """The GBA problem solved by `world` gloo ranks sharing its device
    (cuda:0), each in its own process. Returns (result tensors, rank 0's
    timings), or raises with the ranks' output."""
    os.makedirs(DIST_DIR, exist_ok=True)
    problem, out = os.path.join(DIST_DIR, "gba_problem.pt"), os.path.join(DIST_DIR, "rank0.pt")
    torch.save(dict(prob={f: getattr(prob, f).cpu() for f in prob._fields}, inv=inv.cpu(),
                    K=tuple(K), bf=float(bf), device=str(prob.cam_T.device)), problem)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.dist_rank("
                               f"{r}, {world}, {port}, {problem!r}, {out!r})"], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"{world} gloo ranks on cuda:0 failed:\n"
                             + "\n".join(log[-3000:] for log in logs))
    line = [x for x in logs[0].splitlines() if x.startswith("DIST_RANK ")][-1]
    return torch.load(out), json.loads(line[len("DIST_RANK "):])


def check_k4_lba(prob, inv, F, K, BF):
    """K4 against its plain version on the main path's last local-BA
    window at the window's start (lba_init, robust): each field within
    1e-3 relative; timed as the other K4 rows."""
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    prep = lba_cuda.prep_problem(prob, inv, F)
    cam_T, pts, *_, obs_ok = optim.lba_init(prob, inv, K, BF)
    sk = lba_cuda.build_system(prep, cam_T, pts, obs_ok, True, K, BF)
    sp = optim.build_system_plain(prob, inv, F, cam_T, pts, obs_ok, True, K, BF)
    worst = k4_field_err(sp, sk, "K4 on the main path's last window")
    NC, NP, O = prob.cam_T.shape[0], prob.pts.shape[0], prob.obs_cam.shape[0]
    n_obs = int(obs_ok.sum())
    return dict(max_abs_err=worst, library_ms=None,
                **timed(lambda: lba_cuda.build_system(prep, cam_T, pts, obs_ok, True, K, BF),
                        lambda: optim.build_system_plain(prob, inv, F, cam_T, pts, obs_ok, True,
                                                         K, BF)),
                **bound(k4_bytes(NC, NP, O, n_obs, F), K4_OPS_PER_OBS * n_obs))


def dist_path(cfg, main_keep, loop_keep, dev, k4_window):
    """parallel/dist_ba.py on the card, on the maps of the main and loop
    paths:
      - NCCL at world size 1: distributed_global_ba on the loop path's
        full-map GBA problem (every keyframe slot x every feature slot,
        every point), distributed_local_ba on the main path's last
        keyframe window and both distributed pose graphs on the loop path's
        essential graph, each bit-identical to its single-process solve;
        one LM iteration timed, and its all-reduce calls and bytes counted;
      - two gloo ranks sharing cuda:0 (spawned) on the same GBA problem:
        poses within 1e-3 of the single process (an all-reduce adds the
        partial sums in its own order), one iteration timed;
      - local_bundle_adjustment on the main path's last window in both
        layouts: cam_major=True launches K4, the ragged layout builds in
        plain PyTorch, poses within 1e-3; K4 held to its plain version on
        that window;
      - one GBA iteration timed at world size 1 on the synthetic problem at
        the default tier's size (256 cameras, 32768 points, 1000
        observations per camera).
    `k4_window` receives (window, inverse sigma2, free cameras) of the
    local-BA window for K4's check after the path."""
    import torch.distributed as dist

    from orb_slam2_comment_tpu_torch.models import local_mapping as lm
    from orb_slam2_comment_tpu_torch.models.loop_closing import _build_gba_problem
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim
    from orb_slam2_comment_tpu_torch.parallel import dist_ba

    K, bf = cfg.K, cfg.bf
    out = {}
    gprob, ginv = _build_gba_problem(loop_keep["map"], cfg)
    m = main_keep["map"]
    kf = int(torch.nonzero(m.kf_valid).max())
    wprob, cam_ids, pt_ids = lm.build_ba_window(m, kf, cfg)
    winv = lm._inv_sigma2(cfg, dev)
    g_args, g_kw = loop_keep["graph"]
    if g_args[0].shape[0] != cfg.max_keyframes:
        raise AssertionError("the loop path kept no essential graph of its map")
    single = optim.global_bundle_adjustment(gprob, ginv, K, bf, iters=DIST_GBA_ITERS)

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        res = dist_ba.distributed_global_ba(gprob, ginv, K, bf, iters=DIST_GBA_ITERS)
        _sync(dev)
        out["gba_world1_s"] = time.perf_counter() - t0
        _same(res, single, "distributed_global_ba (NCCL, world 1)")
        out["gba_world1"] = _iteration_ms(
            lambda n: dist_ba.distributed_global_ba(gprob, ginv, K, bf, iters=n), dev)
        out["gba_single"] = _iteration_ms(
            lambda n: optim.global_bundle_adjustment(gprob, ginv, K, bf, iters=n), dev)
        lres, _, cam2, pt2 = dist_ba.distributed_local_ba(m, kf, cfg)
        if not (torch.equal(cam2, cam_ids) and torch.equal(pt2, pt_ids)):
            raise AssertionError("distributed_local_ba built another window")
        _same(lres, optim.global_bundle_adjustment(wprob, winv, K, bf, iters=15, cg_iters=20),
              "distributed_local_ba (NCCL, world 1)")
        _same(dist_ba.distributed_essential_graph(*g_args, **g_kw),
              optim.essential_graph_optimize(*g_args, **g_kw),
              "distributed_essential_graph (NCCL, world 1)")
        _same(dist_ba.distributed_essential_graph_sparse(*g_args, **g_kw),
              optim.essential_graph_optimize_sparse(*g_args, **g_kw, cg_iters=300),
              "distributed_essential_graph_sparse (NCCL, world 1)")
        syn, _, _ = dist_ba.make_synthetic_ba_problem(n_cams=256, n_pts=32768, obs_per_cam=1000,
                                                      device=dev)
        sinv = torch.tensor([1.0 / 1.2 ** (2 * l) for l in range(8)], device=dev)
        out["synthetic_256x32768x1000_world1"] = _iteration_ms(
            lambda n: dist_ba.distributed_global_ba(syn, sinv, (500.0, 500.0, 320.0, 240.0),
                                                    100.0, iters=n), dev)
    finally:
        dist.destroy_process_group()
    print("# dist: NCCL world 1 bit-identical to one process on the GBA problem "
          f"({gprob.cam_T.shape[0]} keyframes x {gprob.obs_cam.shape[0] // gprob.cam_T.shape[0]}"
          f" slots, {gprob.pts.shape[0]} points, {int(gprob.obs_valid.sum())} valid "
          f"observations), the local-BA window of keyframe {kf} and both pose graphs "
          f"({int(g_args[6].sum())} valid edges of {g_args[3].shape[0]}); one GBA iteration "
          f"{out['gba_world1']}", flush=True)

    two, timing = gloo_ranks(gprob, ginv, K, bf)
    err2 = _pose_err(two["cam_T"].to(dev), single.cam_T)
    if not err2 < DIST_RANK_TOL:
        raise AssertionError(f"2 gloo ranks: pose error {err2} against one process")
    out["gba_gloo_world2"] = dict(timing, pose_err=err2,
                                  pts_max_abs_diff=float((two["pts"].to(dev)
                                                          - single.pts).abs().max()),
                                  inlier_flags_differing=int((two["obs_inlier"].to(dev)
                                                              != single.obs_inlier).sum()))
    print(f"# dist: 2 gloo ranks on cuda:0 within {err2:.3e} of one process; "
          f"{out['gba_gloo_world2']}", flush=True)

    F = min(cfg.ba_free_kfs, cfg.max_keyframes)
    k0 = lba_cuda.build_system.launches
    a = optim.local_bundle_adjustment(wprob, winv, K, bf, cam_major=True, n_free=F)
    k4_launches = lba_cuda.build_system.launches - k0
    b = optim.local_bundle_adjustment(wprob, winv, K, bf, cam_major=False, n_free=F)
    if lba_cuda.build_system.launches - k0 != k4_launches or k4_launches < 2:
        raise AssertionError(f"K4 launches: {k4_launches} for cam_major=True, "
                             f"{lba_cuda.build_system.launches - k0 - k4_launches} ragged")
    lerr = _pose_err(a.cam_T, b.cam_T)
    if not lerr < LBA_LAYOUT_TOL:
        raise AssertionError(f"local_bundle_adjustment layouts differ by {lerr}")
    out["local_ba_layouts"] = dict(
        window=[wprob.cam_T.shape[0], wprob.pts.shape[0], int(wprob.obs_valid.sum())],
        k4_launches=k4_launches, pose_err=lerr,
        pts_max_abs_diff=float((a.pts - b.pts).abs().max()),
        inlier_flags_differing=int((a.obs_inlier != b.obs_inlier).sum()))
    k4_window.append((wprob, winv, F))
    print(f"# dist: local_bundle_adjustment on the main path's last window, K4 "
          f"({k4_launches} launches) vs the ragged build: {out['local_ba_layouts']}", flush=True)
    return out


FUSE_POS_TOL, LBA_CPU_POSE_TOL = 1e-5, 1e-3


def leftovers_path(cfg, main_keep, k4_window, dev):
    """The last public pieces of the port on maps already built: (1)
    fuse_into_keyframe on the main path's final map, its newest keyframe
    fused into its best covisible neighbour, on the card and on the CPU
    from the same map: merges, association and map tables equal, positions
    within FUSE_POS_TOL; (2) the main path's last local-BA window (the
    K4@lba row's) through local_bundle_adjustment(cam_major=True): its K4
    launches, each linearization (recorded by lba_cuda.build_system.record)
    held to the plain version within K4_C * 2^-24 * S, and poses within
    LBA_CPU_POSE_TOL of the CPU's solve."""
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm
    from orb_slam2_comment_tpu_torch.models import map_state as ms
    from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

    out = {}
    m = main_keep["map"]
    kf = int(torch.nonzero(m.kf_valid).max())
    w = ms.covisibility_weights(m, kf).clone()
    w[kf] = 0
    nb = int(torch.argmax(w))
    cpu = torch.device("cpu")
    mc = ms.from_numpy(ms.to_numpy(m), cpu)
    t0 = time.perf_counter()
    gm, gn = lm.fuse_into_keyframe(m, kf, nb, cfg)
    _sync(dev)
    fuse_ms = (time.perf_counter() - t0) * 1e3
    cm, cn = lm.fuse_into_keyframe(mc, kf, nb, cfg)
    differ = {}
    for f in (fl.name for fl in dataclasses.fields(gm)):
        a, b = getattr(gm, f).cpu(), getattr(cm, f)
        if a.dtype.is_floating_point:
            d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            if not d <= FUSE_POS_TOL:
                differ[f] = f"max |card - cpu| {d:.3g}"
        elif not torch.equal(a, b):
            differ[f] = f"{int((a != b).sum())} entries"
    changed = int((gm.kf_obs != m.kf_obs).sum())
    out["fuse_into_keyframe"] = dict(src_kf=kf, dst_kf=nb, covisibility=int(w[nb]),
                                     merges=int(gn), merges_cpu=int(cn),
                                     obs_entries_changed=changed, ms=fuse_ms)
    print(f"# leftovers: fuse_into_keyframe({kf} -> {nb}, covisibility {int(w[nb])}) on the "
          f"card: {int(gn)} merges (CPU {int(cn)}), {changed} association entries changed, "
          f"{fuse_ms:.2f} ms", flush=True)
    if differ or int(gn) != int(cn):
        # the cause: which features matched differently on the two devices
        src = m.kf_obs[kf]
        print(f"# leftovers: fuse_into_keyframe card vs CPU differ: {differ}; the projected "
              f"points: {int((src >= 0).sum())}; the card's row of keyframe {nb} against "
              f"the CPU's at {torch.nonzero(gm.kf_obs[nb].cpu() != cm.kf_obs[nb]).flatten()[:20].tolist()}",
              flush=True)
        raise AssertionError(f"fuse_into_keyframe: card and CPU differ ({differ}, merges "
                             f"{int(gn)} vs {int(cn)})")

    wprob, winv, F = k4_window[0]
    cprob = optim.BAProblem(*(t.cpu() for t in wprob))
    K, bf = cfg.K, cfg.bf
    calls = []
    k0 = lba_cuda.build_system.launches
    lba_cuda.build_system.record = calls
    try:
        res = optim.local_bundle_adjustment(wprob, winv, K, bf, cam_major=True, n_free=F)
    finally:
        lba_cuda.build_system.record = None
    _sync(dev)
    launches = lba_cuda.build_system.launches - k0
    if launches < 1 or launches != len(calls):
        raise AssertionError(f"local BA: {launches} K4 launches, {len(calls)} recorded")
    ratios = [k4_sum_bound(k4_abs_sums(wprob, winv, F, cT, pt, ok, rb, K, bf),
                           optim.build_system_plain(wprob, winv, F, cT, pt, ok, rb, K, bf),
                           sk, f"K4 in local_bundle_adjustment, launch {i}")
              for i, (cT, pt, ok, rb, sk) in enumerate(calls)]
    ref = optim.local_bundle_adjustment(cprob, winv.cpu(), K, bf, cam_major=True, n_free=F)
    err = _pose_err(res.cam_T.cpu(), ref.cam_T)
    if not err < LBA_CPU_POSE_TOL:
        raise AssertionError(f"local BA: card poses {err} from the CPU's")
    out["local_ba"] = dict(
        window=[wprob.cam_T.shape[0], wprob.pts.shape[0], int(wprob.obs_valid.sum())],
        k4_launches=launches, worst_sum_ratio=max(ratios), pose_err_vs_cpu=err,
        pts_max_abs_diff_vs_cpu=float((res.pts.cpu() - ref.pts).abs().max()),
        inlier_flags_differing_vs_cpu=int((res.obs_inlier.cpu() != ref.obs_inlier).sum()))
    print(f"# leftovers: local_bundle_adjustment on the main path's last window: "
          f"{json.dumps(out['local_ba'])}", flush=True)
    return out


def drive(name, fn, path_kernels, per_path):
    """Run one path with the launch counts set to 0 just before it and read
    just after; every kernel the path runs must have launched."""
    zero_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    counts = read_counts()
    per_path[name] = counts
    missing = [k for k in path_kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name} path: kernels never launched: {missing} ({counts})")
    print(f"# {name}_path " + json.dumps(res), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--profile", default=None, help="write a torch.profiler table here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port first: without the repository around it, fail before printing
    from orb_slam2_comment_tpu_torch import _build  # noqa: F401

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"# device {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    desk_seq, desk_proc = (None, None) if args.kernels_only else start_desk_render()
    children = [desk_proc]
    try:
        return run_all(args, dev, kind, smi, desk_seq, desk_proc, children)
    finally:
        for proc in children:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def run_all(args, dev, kind, smi, desk_seq, desk_proc, children):
    """Build, check and time the kernels, then drive the paths; processes
    started on the way go into `children`."""
    import prev_kernels
    from orb_slam2_comment_tpu_torch import _build
    from orb_slam2_comment_tpu_torch.ops import orb

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # both builds at once, one nvcc per source
        builds = [pool.submit(_build.library), pool.submit(prev_kernels.library)]
        for b in builds:
            b.result()
    print(f"# kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    log = (_build.library_path().parent / "nvcc.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "bytes stack frame" in line:
            print(f"# ptxas {log[i - 1].split('for')[-1].strip()}: {line.strip()} "
                  f"{log[i + 1].strip() if i + 1 < len(log) else ''}", flush=True)
            if [int(t) for t in line.split() if t.isdigit()] != [0, 0, 0]:
                raise AssertionError(f"ptxas: a stack frame or spills: {line.strip()}")

    cfg, scfg, mcfg, gcfg = bench_config(), stereo_config(), mono_config(), grow_config()
    t0 = time.perf_counter()
    frames = render_frames(max(args.frames, 100))
    sframes = render_stereo()
    orbit, mframes, gframes = ([], [], []) if args.kernels_only else (
        render_orbit(), render_mono(), render_grow_orbit())
    print(f"# rendered {len(frames)} + {len(sframes)} stereo + {len(orbit)} + {len(mframes)} "
          f"+ {len(gframes)} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    checks = list(check_k1_k2(cfg, frames[0], dev))
    checks += [check_k3(cfg, dev), check_k4(dev), check_k3_batched(cfg, dev)]
    # K1, K2 and K3 at the stereo path's shapes
    spyr, sstack, ssizes, serr, slyx = k2_inputs(scfg, sframes[0]["image"], dev,
                                                 "K1 on the first stereo frame")
    checks += [k1_measure(spyr, sstack, ssizes, serr, minmax_rate()),
               k2_measure(sstack, slyx, dev)]
    print(f"# K1@376x1241 {checks[-2]['device_ms']:.4f} ms from a graph; K2 gather_patches@"
          f"{slyx.shape[0]}: bit-exact, {checks[-1]['device_ms']:.4f} ms from a graph, "
          f"{checks[-1]['per_launch_ms']:.4f} back to back (library "
          f"{checks[-1]['library_ms']:.4f}, bound {checks[-1]['bound_ms']:.5f})", flush=True)
    checks.append(check_k3(scfg, dev, "K3 pose_lm@2000", earlier=False))
    torch.cuda.synchronize()
    if args.kernels_only:
        return 0

    per_path, frames_run, results = {}, {}, {}

    def run(name, fn, kernels):
        results[name] = drive(name, fn, kernels, per_path)
        frames_run[name] = results[name].get("frames_run")

    main_keep, loop_keep = {}, {}
    run("main", lambda: main_path(cfg, frames[:args.frames], dev, args.profile, main_keep),
        K1_K4)
    pipe_keep = {}
    run("pipeline", lambda: pipeline_path(cfg, frames[:args.frames], dev, pipe_keep), K1_K4)
    # K1-K4 at the pipeline's shapes: K1 and K2 on its last frame, K3 on the
    # last pose_optimize call of its final drain, K4 on every local-BA window
    _, pstack, _, _, plyx = k2_inputs(cfg, frames[args.frames - 1]["image"], dev,
                                      "K1 on the pipeline's last frame")
    if not torch.equal(orb.gather_patches(pstack, plyx), orb.gather_patches_plain(pstack, plyx)):
        raise AssertionError("K2 on the pipeline's last frame differs from its plain version")
    _, pdT, pdmask = k3_agrees(pipe_keep["calls"][-1], "K3 on the pipeline's last call")
    pk4 = check_k4_window(pipe_keep["windows"][-1], cfg.K, cfg.bf, "pipeline")
    prows = k4_window_errors(pipe_keep["windows"], cfg.K, cfg.bf, "pipeline")
    print(f"# pipeline shapes: K1 and K2 bit-exact on the last frame, K3 |dT|={pdT:.2e} with "
          f"{pdmask} inlier flags differing, K4 on the last window within "
          f"{pk4['max_abs_err']:.2e} relative and on all {len(prows)} windows within "
          f"{max(r['sum_ratio'] for r in prows):.3f} * 2^-24 * S (bound {K4_C})", flush=True)
    run("reloc", lambda: reloc_path(cfg, frames, dev), K1_K4 + ("pose_lm_batched",))
    run("loop", lambda: loop_path(cfg, orbit, dev, loop_keep), K1_K4)
    windows = []
    run("stereo", lambda: stereo_path(scfg, sframes, dev, windows), K1_K4)
    run("mono", lambda: mono_path(mcfg, mframes, dev), K1_K4)
    vo_problem = []
    run("facade", lambda: facade_path(cfg, frames, orbit, results["loop"], dev, vo_problem,
                                      per_path), K1_K4)
    gwindows, gcalls = [], []
    run("grow", lambda: grow_path(gcfg, gframes, dev, gwindows, gcalls), K1_K4)
    # K1-K4 after growth: K1 and K2 on the last orbit frame, K3 on its last
    # pose_optimize call, K4 on every local-BA window of the run
    _, gstack, _, _, glyx = k2_inputs(gcfg, gframes[-1]["image"], dev, "K1 after growth")
    if not torch.equal(orb.gather_patches(gstack, glyx), orb.gather_patches_plain(gstack, glyx)):
        raise AssertionError("K2 after growth differs from its plain version")
    _, dT, dmask = k3_agrees(gcalls[-1], "K3 after growth")
    density = {"stereo": k4_density(windows, scfg.K, scfg.bf, "stereo"),
               "grow": k4_density(gwindows, gcfg.K, gcfg.bf, "grow")}
    print(f"# after growth: K1 and K2 bit-exact on the last orbit frame, K3 |dT|={dT:.2e} with "
          f"{dmask} inlier flags differing, K4 within 1e-3 on all {len(gwindows)} windows",
          flush=True)
    t0 = time.perf_counter()
    if desk_proc.wait() != 0:
        raise AssertionError(f"rendering the desk head failed ({desk_proc.returncode})")
    print(f"# desk head rendered (waited {time.perf_counter() - t0:.1f} s more)", flush=True)
    run("desk", lambda: desk_path(desk_seq, dev, smi), K1_K4)
    swindows = []
    run("staged", lambda: staged_path(cfg, orbit, frames, dev, swindows, results["main"]),
        K1_K4)
    pr_keep = {}
    run("placerec", lambda: placerec_path(cfg, orbit, frames, dev, results["reloc"], pr_keep,
                                          children),
        K1_K4 + ("pose_lm_batched",))
    # K1 and K2 on an evaluation frame (480x640, f32 as rendered)
    _, estack, _, _, elyx = k2_inputs(cfg, pr_keep["image"], dev, "K1 on an evaluation frame")
    if not torch.equal(orb.gather_patches(estack, elyx), orb.gather_patches_plain(estack, elyx)):
        raise AssertionError("K2 on an evaluation frame differs from its plain version")
    print("# placerec shapes: K1 and K2 bit-exact on the first evaluation frame", flush=True)
    k4_window = []
    run("dist", lambda: dist_path(cfg, main_keep, loop_keep, dev, k4_window), ("lba_build",))
    run("leftovers", lambda: leftovers_path(cfg, main_keep, k4_window, dev), ("lba_build",))
    frames_run["vo"] = 10
    for path, k, per in (("main", "fast_nms", 1), ("pipeline", "fast_nms", 1),
                         ("pipeline", "gather_patches", 1), ("stereo", "fast_nms", 2),
                         ("stereo", "gather_patches", 2), ("mono", "fast_nms", 1),
                         ("facade", "fast_nms", 1), ("facade", "gather_patches", 1),
                         ("grow", "fast_nms", 1), ("grow", "gather_patches", 1),
                         ("desk", "fast_nms", 1), ("desk", "gather_patches", 1),
                         ("staged", "fast_nms", 1), ("staged", "gather_patches", 1),
                         ("placerec", "fast_nms", 1), ("placerec", "gather_patches", 1)):
        if per_path[path][k] != per * frames_run[path]:
            raise AssertionError(f"{k} launched {per_path[path][k]} times over "
                                 f"{frames_run[path]} {path} frames, not {per} per frame")
    print("# launches per path " + json.dumps(per_path), flush=True)
    # K4 on the stereo run's largest local-BA window
    checks.append(check_k4_window(max(windows, key=lambda w: int(w.prob.obs_valid.sum())),
                                  scfg.K, scfg.bf))
    # K3 on the first visual-odometry frame's problem
    checks.append(check_k3_vo(cfg, vo_problem[0]))
    # K4 on the main path's last local-BA window, which the dist path's
    # local_bundle_adjustment solved
    checks.append(check_k4_lba(*k4_window[0], cfg.K, cfg.bf))
    # K4 on the largest local-BA window of the monolithic mapper
    checks.append(check_k4_window(max(swindows, key=lambda w: int(w.prob.obs_valid.sum())),
                                  cfg.K, cfg.bf, "staged"))

    rows = []
    for (name, (src, rep), kern, paths), res in zip(KERNEL_ROWS, checks, strict=True):
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=sum(per_path[p][kern] for p in paths),
                         launches_per_main_frame=(per_path["main"][kern] / frames_run["main"]
                                                  if "main" in paths else None),
                         launches_per_frame={p: per_path[p][kern] / frames_run[p]
                                             for p in paths if frames_run[p]},
                         **res))
        if name in ("lba_build", "lba_build@stereo"):
            d = density["grow" if name == "lba_build" else "stereo"]
            rows[-1]["density"] = {k: v for k, v in d.items() if k != "curve"}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
