"""What decides `correct`: the timed path's outputs held against the plain
reference, after the window, on items sampled from the seed.

Each session reads its numbers (`judge`), and the parent combines the
sessions' readings (`combine`) and holds each to its limit (`verdict`):

- `extract_diff_pct`: of the keypoint slots of keyframes created in the
  window (the map stores each keyframe's whole feature set), the share
  that differ from `ref_orb.extract` run on the same raw frame: the valid
  flag, position, level, angle or any descriptor bit, and the depth and
  right u (RGB-D: the depth map's pixel; stereo: `ref_orb.stereo_match`
  on the raw pair).
- `pose_dT`: the largest entry of |Tcw - Tcw_ref| over sampled pose
  solves of the window (K3), the reference re-solving each from the same
  inputs in float64.
- `lba_err`: the largest |block - block_ref| over sampled local-BA
  linearizations of the window (K4) and every block (Hcc, bc, Hpp, bp, E,
  cost), as a share of the largest sum of absolute contributions to that
  block, the reference in float64.
- `ate_mm`: the RMS distance in mm between the session's camera centres
  (every frame it tracked, after the map settled) and the ground truth,
  both taken relative to the first tracked frame.

The pose and linearization checks start from the program's own state (the
points, observations and start pose that it handed its solver), as a
reference can only follow the program step by step there; the extraction
check starts from the raw frame, and the trajectory from the ground truth.

With `control` a session also reads the numbers that the reference itself
gives one precision down, put in the program's place: extraction with
TF32 matrix products (the configuration computes float32 with TF32 off),
the two solves from inputs rounded to bfloat16, computed in float32.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import numpy as np
import torch

from slam_bench.reference import ref_optim
from slam_bench.reference.ref_orb import (ExtractConfig, depth_at, extract, stereo_match,
                                          undistort, unpack_bits)

NUMBERS = ("extract_diff_pct", "pose_dT", "lba_err", "ate_mm")
F64 = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --- extraction --------------------------------------------------------------

def _extract_cfg(slam: dict) -> ExtractConfig:
    return ExtractConfig(int(slam["n_features"]), int(slam["n_levels"]),
                         float(slam["scale_factor"]), float(slam["min_th_fast"]))


def ref_frame(slam: dict, seq, frame: int, dev, tf32: bool = False) -> dict:
    """The reference's keypoint slots of one raw frame: xy (undistorted),
    octave, angle, desc, valid, depth, uright (as numpy). RGB-D's depth is
    read at the raw keypoint and its right u is the undistorted x less
    bf / depth (Frame::ComputeStereoFromRGBD)."""
    ecfg = _extract_cfg(slam)
    bf = float(slam["bf"])
    K = (slam["fx"], slam["fy"], slam["cx"], slam["cy"])
    dist = tuple(float(slam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2", "k3"))
    with _tf32(tf32):
        img = torch.from_numpy(seq.images[frame]).to(dev).to(torch.float32)
        f, stack, sizes = extract(img, ecfg)
        xy = undistort(f.xy, K, dist)
        if slam["sensor"] == "rgbd":
            dmap = torch.from_numpy(seq.depth[frame].astype(np.int32)).to(dev)
            depth = depth_at(dmap, f.xy, float(slam["depth_map_factor"]))
            uright = torch.where(depth > 0, xy[:, 0] - bf / torch.clamp(depth, min=1e-6),
                                 torch.full_like(depth, -1.0))
        else:
            right = torch.from_numpy(seq.right[frame]).to(dev).to(torch.float32)
            fr, stack_r, _ = extract(right, ecfg)
            uright, depth = stereo_match(
                f, fr, stack, stack_r, sizes, ecfg, bf, min_z=bf / float(slam["fx"]),
                th_stereo=min(75.0 * float(slam.get("match_th_scale", 1.0)), 100.0))
    out = dict(xy=xy, octave=f.octave, angle=f.angle, desc=f.desc, feat_valid=f.valid,
               depth=depth, uright=uright)
    return {k: v.cpu().numpy() for k, v in out.items()}


def slot_diff(a: dict, b: dict):
    """(slots that differ, slots compared): a slot is compared where
    either side holds a keypoint."""
    va, vb = a["feat_valid"].astype(bool), b["feat_valid"].astype(bool)
    both = va & vb
    bad = va != vb
    bits = unpack_bits(torch.from_numpy(a["desc"] ^ b["desc"])).numpy().any(-1)
    dang = np.abs(np.angle(np.exp(1j * (a["angle"].astype(np.float64) - b["angle"]))))
    bad |= both & ((np.abs(a["xy"] - b["xy"]).max(-1) > 1e-3) | (a["octave"] != b["octave"])
                   | bits | (dang > 1e-4)
                   | (np.abs(a["depth"] - b["depth"]) > 1e-4 * np.maximum(1.0, np.abs(b["depth"])))
                   | (np.abs(a["uright"] - b["uright"]) > 1e-3))
    return int(bad.sum()), int((va | vb).sum())


# --- the two solves ----------------------------------------------------------

def _low(t: torch.Tensor) -> torch.Tensor:
    """A floating input rounded to bfloat16 and computed on in float32."""
    return t.to(torch.bfloat16).to(torch.float32) if t.is_floating_point() else t


def ref_pose(s: dict, dtype=F64, low: bool = False):
    args = [_low(t) if low else t for t in s["args"]]
    args = [t.to(dtype) if t.is_floating_point() else t for t in args]
    return ref_optim.pose_optimize(*args, s["K"], s["bf"])


def pose_dT(s: dict, T) -> float:
    return float((T.to(F64) - ref_pose(s).Tcw)[:3, :].abs().max())


def ref_lba(s: dict, dtype=F64, low: bool = False, absolute: bool = False):
    w = s["window"]
    fl = (lambda t: _low(t).to(dtype)) if low else (lambda t: t.to(dtype))
    Np = s["pts"].shape[0]
    return ref_optim.build_system(
        fl(s["cam_T"]), w["cam_fixed"], w["cam_valid"], w["obs_cam"], w["obs_pt"],
        fl(w["obs_uvr"]), w["obs_oct"], w["obs_stereo"], s["obs_ok"], fl(s["inv_s2"]), s["F"],
        Np, fl(s["pts"]), s["robust"], s["K"], s["bf"], absolute=absolute)


def lba_err(s: dict, out: dict) -> float:
    ref = ref_lba(s)
    scale = ref_lba(s, absolute=True)
    worst = 0.0
    for k in ("Hcc", "bc", "Hpp9", "bp3", "E", "cost"):
        d = float((out[k].to(F64) - getattr(ref, k)).abs().max())
        worst = max(worst, d / max(float(getattr(scale, k).abs().max()), 1e-30))
    return worst


# --- the trajectory ----------------------------------------------------------

def _centres(T: np.ndarray) -> np.ndarray:
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def ate_mm(poses, gt: np.ndarray) -> float:
    """RMS centre error in mm, both trajectories relative to the first
    tracked frame."""
    if not poses:
        return float("inf")
    idx = np.asarray([i for i, _ in poses])
    est = np.stack([T for _, T in poses])
    est_rel = est @ np.linalg.inv(est[0])
    gt_rel = gt[idx] @ np.linalg.inv(gt[idx[0]])
    err = np.linalg.norm(_centres(est_rel) - _centres(gt_rel), axis=-1)
    return float(np.sqrt(np.mean(err ** 2)) * 1e3)


# --- one session, then the run ----------------------------------------------

def judge(slam: dict, seq, kfs, samples, poses, dev, control: bool = False) -> dict:
    """One session's readings (and with `control`, the control's) as
    plain floats: the extraction's bad and compared slots, the worst pose
    and linearization errors and the trajectory error."""
    r = dict(extract_bad=0, extract_slots=0, pose_dT=None, lba_err=None,
             ate_mm=ate_mm(poses, seq.poses), n_kfs=len(kfs),
             n_poses=sum(s is not None for s in samples["poses"]),
             n_lba=sum(s is not None for s in samples["lba"]))
    c = dict(extract_bad=0, extract_slots=0, pose_dT=None, lba_err=None, ate_mm=None)
    for kf in kfs:
        ref = ref_frame(slam, seq, kf["frame"], dev)
        bad, n = slot_diff(kf, ref)
        r["extract_bad"] += bad
        r["extract_slots"] += n
        if control:
            bad, n = slot_diff(ref_frame(slam, seq, kf["frame"], dev, tf32=True), ref)
            c["extract_bad"] += bad
            c["extract_slots"] += n
    for s in samples["poses"]:
        if s is None:
            continue
        r["pose_dT"] = max(r["pose_dT"] or 0.0, pose_dT(s, s["Tcw"]))
        if control:
            T = ref_pose(s, torch.float32, low=True).Tcw
            c["pose_dT"] = max(c["pose_dT"] or 0.0, pose_dT(s, T))
    for s in samples["lba"]:
        if s is None:
            continue
        r["lba_err"] = max(r["lba_err"] or 0.0, lba_err(s, s["out"]))
        if control:
            low = ref_lba(s, torch.float32, low=True)
            c["lba_err"] = max(c["lba_err"] or 0.0, lba_err(s, low._asdict()))
    if control:
        r["control"] = c
    return r


def combine(readings) -> dict:
    """The run's numbers from its sessions' readings: the extraction's
    share over all compared slots, the worst pose and linearization errors
    and the worst session's trajectory error. None where no session had
    an item to compare."""
    slots = sum(x["extract_slots"] for x in readings)
    out = dict(extract_diff_pct=100.0 * sum(x["extract_bad"] for x in readings) / slots
               if slots else None)
    for k in ("pose_dT", "lba_err", "ate_mm"):
        vals = [x[k] for x in readings if x[k] is not None]
        out[k] = max(vals) if vals else None
    return out


def load_limits(root: Path, workload: str) -> dict:
    """limits/<workload>.json: each number's limit, and the readings it
    was set from."""
    p = Path(root) / "limits" / f"{workload}.json"
    return json.loads(p.read_text()) if p.exists() else {}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the numbers the cell's limits
    name (none: not correct): each present and at or under its limit. A
    number whose limit says `"optional": true` may also be absent: the
    window ran nothing that it reads (say, no local BA)."""
    rows, ok = [], bool(limits)
    for k in [n for n in NUMBERS if n in limits] or NUMBERS:
        v = numbers.get(k)
        lim = limits.get(k, {}).get("limit")
        if v is None and limits.get(k, {}).get("optional"):
            rows.append((k, v, lim))
            continue
        good = v is not None and lim is not None and np.isfinite(v) and v <= lim
        ok &= bool(good)
        rows.append((k, v, lim))
    return ok, rows
