"""Trace where a sequence parts between the CPU and the card.

The 14 frames of chip_smoke.py's mono path (or, with --seq, a rendered
RGB-D or stereo sequence read through the dataset loaders, with its
settings.yaml) go through one System on the CPU and one on the card, in
lockstep. Per frame it prints keypoints, descriptors, state, inliers,
pose, each run's camera-centre error against the ground truth (--seq),
the keyframe decision, the point cursor, the live point count and the
mapper phase the frame ran, then shutdown's mapper drain one phase at a
time, and the first step where the two part (extraction, tracking,
keyframe decision or a mapper phase). For the mono path, last, the
initializing frame's two-view solve is run on both devices from the CPU
run's inputs, stage by stage (the 200 F and H hypotheses, their scores, the
winners, the result).

    python3 prev_kernels/trace_mono.py     # from the repository root, on a GPU
    python3 prev_kernels/trace_mono.py --seq DIR --sensor rgbd|stereo [--frames N]

Its stages are rebuilt from ops/twoview.py's private helpers, so they
follow that file only as long as two_view_init keeps its structure.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def map_diff(ta, tb):
    """Largest keyframe-pose and point-position differences between two
    trackers' maps (points valid in both)."""
    ma, mb = ta.map, tb.map
    kv = (ma.kf_valid.cpu() & mb.kf_valid.cpu())
    pv = (ma.pt_valid.cpu() & mb.pt_valid.cpu())
    dk = (ma.kf_pose.cpu()[kv] - mb.kf_pose.cpu()[kv]).abs().max().item() if kv.any() else 0.0
    dp = (ma.pt_pos.cpu()[pv] - mb.pt_pos.cpu()[pv]).abs().max().item() if pv.any() else 0.0
    return dk, dp


def two_view_parts(xy1, xy2, valid, K):
    """two_view_init and its RANSAC stages on one device: the 200 F and H
    hypotheses (each scaled to unit norm, sign fixed), their scores and the
    winners, and the result."""
    from orb_slam2_comment_tpu_torch import constants as C
    from orb_slam2_comment_tpu_torch.ops import rng, twoview

    idx8 = rng.masked_categorical(rng.prng_key(0), valid, (C.INIT_RANSAC_ITERS, 8))
    vf = valid.to(xy1.dtype)
    (p1n, T1), (p2n, T2) = twoview._normalize(xy1, vf), twoview._normalize(xy2, vf)
    inv_s2 = 1.0 / (C.INIT_SIGMA * C.INIT_SIGMA)

    def unit(M):
        M = M.reshape(M.shape[0], 9)
        M = M / M.norm(dim=1, keepdim=True)
        return (M * torch.sign(M[:, 8:9])).cpu()

    F = twoview._fundamentals(p1n, p2n, idx8, T1, T2)
    H = twoview._homographies(p1n, p2n, idx8[:, :4], T1, T2)
    sF = twoview.score_fundamental(F, xy1, xy2, valid, inv_s2)[0].cpu()
    sH = twoview.score_homography(H, xy1, xy2, valid, inv_s2)[0].cpu()
    return dict(F=unit(F), H=unit(H), sF=sF, sH=sH, tv=twoview.two_view_init(xy1, xy2, valid, K))


def trace_two_view(args, K):
    """The initializing frame's two-view solve on the CPU and on the card
    from the same inputs (the CPU run's): where the two part."""
    a = two_view_parts(*args, K)
    b = two_view_parts(*[x.cuda() for x in args], K)
    ta, tb = a["tv"], b["tv"]
    ga, gb = ta.good.cpu(), tb.good.cpu()
    row = dict(F_max_diff=(a["F"] - b["F"]).abs().max().item(),
               H_max_diff=(a["H"] - b["H"]).abs().max().item(),
               score_F_max_rel_diff=((a["sF"] - b["sF"]).abs() / a["sF"].abs().clamp(min=1e-9)
                                     ).max().item(),
               score_H_max_rel_diff=((a["sH"] - b["sH"]).abs() / a["sH"].abs().clamp(min=1e-9)
                                     ).max().item(),
               F_hypotheses_differing=int(((a["F"] - b["F"]).abs().max(1).values > 1e-3).sum()),
               H_hypotheses_differing=int(((a["H"] - b["H"]).abs().max(1).values > 1e-3).sum()),
               best_F=[int(a["sF"].argmax()), int(b["sF"].argmax())],
               best_F_scores_cpu=[float(a["sF"][a["sF"].argmax()]),
                                  float(a["sF"][b["sF"].argmax()])],
               best_F_scores_card=[float(b["sF"][a["sF"].argmax()]),
                                   float(b["sF"][b["sF"].argmax()])],
               best_H=[int(a["sH"].argmax()), int(b["sH"].argmax())],
               homography=[bool(ta.is_homography), bool(tb.is_homography)],
               R21_diff=(ta.R21.cpu() - tb.R21.cpu()).abs().max().item(),
               t21_diff=(ta.t21.cpu() - tb.t21.cpu()).abs().max().item(),
               n_good=[int(ta.n_good), int(tb.n_good)], good_differing=int((ga != gb).sum()),
               X_max_diff_common=(ta.X.cpu()[ga & gb] - tb.X.cpu()[ga & gb]).abs().max().item())
    print("# trace_mono_two_view " + json.dumps(row), flush=True)
    return row


_FEATURES = {"monocular": "mono_features", "rgbd": "rgbd_features",
             "stereo": "stereo_features"}


def _track(system, fr):
    if "depth" in fr:
        return system.track_rgbd(fr["image"], fr["depth"], fr["timestamp"])
    if "image_right" in fr:
        return system.track_stereo(fr["image"], fr["image_right"], fr["timestamp"])
    return system.track_monocular(fr["image"], fr["timestamp"])


def trace_mono(cfg, frames):
    """The mono path's frames through a System on the CPU and one on the
    card in lockstep; per frame: keypoints, descriptors, state, inliers,
    pose, keyframe decision, point cursor, live points, the mapper phase
    the frame ran and the largest keyframe-pose and point differences;
    then shutdown's mapper drain one phase at a time. Prints each step and
    the first one where cursor, live count, pose or features part. Frames
    carrying "depth" or "image_right" go through track_rgbd or
    track_stereo; with "Tcw_gt", each run's camera-centre error is
    printed too."""
    from orb_slam2_comment_tpu_torch.models import frame as frame_mod
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm
    from orb_slam2_comment_tpu_torch.models import tracking
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.ops import twoview

    phases = lm._phase_list(cfg)
    feats, running, tv_args, steps, at = {}, [None], {}, {"cpu": [], "cuda": []}, [None]
    fname = _FEATURES[cfg.sensor]
    orig = {"tracking": getattr(tracking, fname), "frame": getattr(frame_mod, fname),
            "two_view": twoview.two_view_init, "step": lm.mapper_machine_step}

    def step_recording(m, n_pts, oc, mp, c):
        ran = phases[mp.phase - 1][0] if mp.phase > 0 else "-"
        out = orig["step"](m, n_pts, oc, mp, c)
        steps[running[0]].append((at[0], ran, int(out[1]), int(out[0].pt_valid.sum())))
        return out

    def two_view_recording(*a, **k):
        tv_args.setdefault(running[0], [])
        tv_args[running[0]].append([x.clone() for x in a[:3]])
        return orig["two_view"](*a, **k)

    def recording(mod):
        def f(*a):
            out = orig[mod](*a)
            feats[running[0]] = out[0]
            return out
        return f

    setattr(tracking, fname, recording("tracking"))
    setattr(frame_mod, fname, recording("frame"))
    twoview.two_view_init = two_view_recording
    lm.mapper_machine_step = step_recording
    first, rows = None, []
    try:
        systems = {"cpu": System(cfg, device="cpu"), "cuda": cs.make_system(cfg, torch.device("cuda"))}
        for i, fr in enumerate(frames):
            st = {}
            at[0] = i
            for name, s in systems.items():
                running[0] = name
                ds = s.tracker.ds
                ran = phases[ds.mp.phase - 1][0] if ds is not None and ds.mp.phase > 0 else "-"
                out = _track(s, fr)
                torch.cuda.synchronize()
                t = s.tracker
                st[name] = dict(state=out.state, inliers=out.n_inliers, kf=out.created_kf,
                                Tcw=None if out.Tcw is None else np.asarray(out.Tcw, np.float64),
                                cursor=t.n_pts_host, live=int(t.map.pt_valid.sum()),
                                phase=ran, feats=feats[name])
                st[name]["centre_err"] = (
                    None if out.Tcw is None or "Tcw_gt" not in fr else float(np.linalg.norm(
                        np.linalg.inv(st[name]["Tcw"])[:3, 3]
                        - np.linalg.inv(fr["Tcw_gt"])[:3, 3])))
            a, b = st["cpu"], st["cuda"]
            fa, fb = a["feats"], b["feats"]
            kp_diff = int((fa.xy.cpu() != fb.xy.cpu()).any(1).sum()
                          + (fa.valid.cpu() != fb.valid.cpu()).sum())
            desc_diff = int((fa.desc.cpu() != fb.desc.cpu()).any(1).sum())
            dT = (None if a["Tcw"] is None or b["Tcw"] is None
                  else float(np.abs(a["Tcw"] - b["Tcw"]).max()))
            stage = None
            if kp_diff or desc_diff:
                stage = "extraction"
            elif a["state"] != b["state"] or a["inliers"] != b["inliers"] or (dT or 0) > 1e-4:
                stage = "tracking"
            elif a["kf"] != b["kf"]:
                stage = "keyframe"
            elif a["cursor"] != b["cursor"] or a["live"] != b["live"]:
                stage = f"mapper:{a['phase']}"
            dk, dp = map_diff(systems["cpu"].tracker, systems["cuda"].tracker)
            row = dict(frame=i, stage=stage, keypoints_differing=kp_diff,
                       descriptors_differing=desc_diff, dT=dT, kf_pose_diff=dk, pt_pos_diff=dp,
                       **{f"{k}_{n}": st[n][k] for n in st
                          for k in ("state", "inliers", "kf", "cursor", "live", "phase",
                                    "centre_err")})
            rows.append(row)
            print("# trace_mono " + json.dumps(row), flush=True)
            if stage and first is None:
                first = row
        # every mapper step so far (the frames' chunks and host-path
        # drains), in order: the first whose cursor or live count parts
        step_first = next(({"step": k, "frame": x[0], "phase": x[1], "cpu": x[2:], "cuda": y[2:]}
                           for k, (x, y) in enumerate(zip(steps["cpu"], steps["cuda"]))
                           if x != y), None)
        print(f"# trace_mono mapper steps {len(steps['cpu'])} / {len(steps['cuda'])}, first "
              "parting " + json.dumps(step_first), flush=True)
        # shutdown's drain, one mapper phase at a time in both
        trackers = {n: s.tracker for n, s in systems.items()}
        while any(t.ds is not None and t.ds.mp.phase != 0 for t in trackers.values()):
            ran = {}
            for n, t in trackers.items():
                if t.ds is None or t.ds.mp.phase == 0:
                    ran[n] = "-"
                    continue
                ran[n] = phases[t.ds.mp.phase - 1][0]
                m, n_pts, oc, mp = lm.mapper_machine_step(t.map, t.ds.n_pts, t.ds.obs_counts,
                                                          t.ds.mp, t.cfg)
                t.map, t.n_pts_host = m, int(n_pts)
                t.ds = t.ds.replace(n_pts=n_pts, obs_counts=oc, mp=mp)
            a, b = trackers["cpu"], trackers["cuda"]
            dk, dp = map_diff(a, b)
            live = {n: int(t.map.pt_valid.sum()) for n, t in trackers.items()}
            stage = (f"drain:{ran['cpu']}" if (a.n_pts_host != b.n_pts_host
                                              or live["cpu"] != live["cuda"]) else None)
            row = dict(frame="shutdown", stage=stage, phase_cpu=ran["cpu"],
                       phase_cuda=ran["cuda"], cursor_cpu=a.n_pts_host,
                       cursor_cuda=b.n_pts_host, live_cpu=live["cpu"], live_cuda=live["cuda"],
                       kf_pose_diff=dk, pt_pos_diff=dp)
            rows.append(row)
            print("# trace_mono " + json.dumps(row), flush=True)
            if stage and first is None:
                first = row
        for s in systems.values():
            s.shutdown()
        if cfg.sensor == "monocular":
            # the initializing (last) two-view solve, from the CPU run's inputs
            same = all(torch.equal(x, y.cpu()) for x, y in zip(tv_args["cpu"][-1],
                                                                tv_args["cuda"][-1]))
            print(f"# trace_mono two-view calls {len(tv_args['cpu'])} / "
                  f"{len(tv_args['cuda'])}, the last one's inputs equal: {same}", flush=True)
            trace_two_view(tv_args["cpu"][-1], cfg.K)
    finally:
        setattr(tracking, fname, orig["tracking"])
        setattr(frame_mod, fname, orig["frame"])
        twoview.two_view_init = orig["two_view"]
        lm.mapper_machine_step = orig["step"]
    print("# trace_mono_first " + json.dumps(first), flush=True)
    return first, rows


def load_sequence(seq, sensor, n_frames=None):
    """(SlamConfig from SEQ/settings.yaml, frames with their ground truth
    relative to the first camera) of a sequence rendered by
    examples/make_datasets.py."""
    import os

    from orb_slam2_comment_tpu_torch.utils import datasets as ds
    from orb_slam2_comment_tpu_torch.utils.config import load_yaml_settings

    cfg = load_yaml_settings(os.path.join(seq, "settings.yaml"), sensor)
    if sensor == "rgbd":
        items = ds.load_tum_rgbd(seq, os.path.join(seq, "associations.txt"))
        gt = np.loadtxt(os.path.join(seq, "groundtruth.txt"), ndmin=2)
        Twc = []
        for row in gt:
            x, y, z, w = row[4:8]
            R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                          [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                          [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, row[1:4]
            Twc.append(T)
    else:
        items = ds.load_kitti(seq, stereo=True)
        Twc = [np.vstack([r.reshape(3, 4), [0, 0, 0, 1]])
               for r in np.loadtxt(os.path.join(seq, "poses_gt.txt"), ndmin=2)]
    frames = []
    for f, T in zip(ds.FramePrefetcher(items[:n_frames]), Twc):
        # relative to the first camera, where the System starts
        f["Tcw_gt"] = np.linalg.inv(T) @ Twc[0]
        frames.append(f)
    return cfg, frames


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=None, help="a rendered sequence folder")
    ap.add_argument("--sensor", default="rgbd", choices=["rgbd", "stereo"])
    ap.add_argument("--frames", type=int, default=None, help="the first N frames only")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_mono: no CUDA device", file=sys.stderr)
        return 2
    from orb_slam2_comment_tpu_torch import _build

    _build.library()
    if a.seq:
        trace_mono(*load_sequence(a.seq, a.sensor, a.frames))
    else:
        trace_mono(cs.mono_config(), cs.render_mono())
    return 0


if __name__ == "__main__":
    sys.exit(main())
