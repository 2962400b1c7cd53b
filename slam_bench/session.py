"""One SLAM session of a cell, in a process of its own.

The parent (`run.py`) spawns one per session of the mix and talks to it
over a pipe with plain Python and numpy values (no tensor crosses). A
session:

1. renders its frames on the card, or loads them from the checkout's
   frame cache, and keeps them in host memory;
2. builds the port's `System`, warms it up until it holds the mix's
   keyframes (bench.py's protocol), and reports ready;
3. at the shared start time hands in frames in a closed loop for the
   window: each `track_*` call is given the next frame when the previous
   call has returned (`resolved`: and its pose has been read; `pipelined`:
   nothing is read, as bench.py's timed loop, and the host state moves as
   the stats transfers land); a `pipelined` session then drains its
   pipeline, which the window includes;
4. reports what it timed and counted, and with `--trace 1` the device
   trace of the window;
5. settles its map, samples timed items from the seed (keyframes, pose
   solves, local-BA linearizations), frees the program, and runs the
   plain reference over them (`reference/judge.py`).
"""

from __future__ import annotations

import gc
import os
import sys
import time
import traceback
import warnings

import numpy as np


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn
    from a seeded generator."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = int(k), rng, 0, []

    def slot(self):
        """The index the next item goes to, or None to drop it."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.n))
        return j if j < self.k else None


class Hooks:
    """Wrappers around the port's two solver entry points for the window:
    a seeded sample of pose solves (K3, single pose) and local-BA
    linearizations (K4) with their inputs and outputs copied, and in a
    traced run the valid edges of every K3 launch for its bound."""

    def __init__(self, check: dict, rng, trace: bool):
        self.poses = Reservoir(check.get("pose_calls", 4), rng)
        self.lba = Reservoir(check.get("lba_calls", 2), rng)
        self.trace = trace
        self.k3_launches = []   # (B, n, device count of valid edges)
        self._undo = []

    def install(self):
        from orb_slam2_comment_tpu_torch.ops import lba_cuda, optim

        po, bs = optim.pose_optimize, lba_cuda.build_system

        def pose_optimize(Tcw0, Xw, obs, octave, is_stereo, valid, inv_s2, K, bf, **kw):
            res = po(Tcw0, Xw, obs, octave, is_stereo, valid, inv_s2, K, bf, **kw)
            if self.trace:
                B = Tcw0.shape[0] if Tcw0.dim() == 3 else 1
                self.k3_launches.append((B, Xw.shape[-2], valid.sum()))
            if Tcw0.dim() == 2:
                j = self.poses.slot()
                if j is not None:
                    self.poses.items[j] = dict(
                        args=[t.detach().clone() for t in (Tcw0, Xw, obs, octave, is_stereo,
                                                           valid, inv_s2)],
                        K=tuple(float(v) for v in K), bf=float(bf),
                        Tcw=res.Tcw.detach().clone(), inliers=res.inliers.detach().clone())
            return res

        def build_system(prep, cam_T, pts, obs_ok, robust, K, bf):
            out = bs(prep, cam_T, pts, obs_ok, robust, K, bf)
            j = self.lba.slot()
            if j is not None:
                p = prep.prob
                self.lba.items[j] = dict(
                    window={k: getattr(p, k).detach().clone() for k in (
                        "cam_fixed", "cam_valid", "obs_cam", "obs_pt", "obs_uvr", "obs_oct",
                        "obs_stereo")},
                    inv_s2=prep.inv_sigma2_levels.detach().clone(), F=int(prep.F),
                    cam_T=cam_T.detach().clone(), pts=pts.detach().clone(),
                    obs_ok=obs_ok.detach().clone(), robust=bool(robust),
                    K=tuple(float(v) for v in K), bf=float(bf),
                    out={k: getattr(out, k).detach().clone() for k in (
                        "Hcc", "bc", "Hpp9", "bp3", "E", "cost")})
            return out

        # the kernel wrapper counts its launches on its own module-level
        # name: the stand-in shares its attributes
        build_system.__dict__ = bs.__dict__
        optim.pose_optimize, lba_cuda.build_system = pose_optimize, build_system
        self._undo.append(lambda: (setattr(optim, "pose_optimize", po),
                                   setattr(lba_cuda, "build_system", bs)))

    def remove(self):
        while self._undo:
            self._undo.pop()()


def _device_events(prof, t0_ns: int, t1_ns: int):
    """The card's operations in [t0, t1] from a torch.profiler run: start
    and end (wall-clock ns, the profiler's clock) and a name index."""
    from torch.autograd import DeviceType

    names, index = [], {}
    starts, ends, ids = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        d = e.duration_ns()
        if s + d < t0_ns or s > t1_ns:
            continue
        nm = e.name()
        if nm not in index:
            index[nm] = len(names)
            names.append(nm)
        starts.append(s)
        ends.append(s + d)
        ids.append(index[nm])
    return dict(start=np.asarray(starts, np.int64), end=np.asarray(ends, np.int64),
                name=np.asarray(ids, np.int32), names=names)


def _track_fn(system, sensor: str):
    return system.track_rgbd if sensor == "rgbd" else system.track_stereo


def warm_up(system, seq, mix, sensor):
    """Frames until the map holds the mix's keyframes (at least 8 frames,
    and 6 more after the first 8): the first 8 read one by one, then, for
    a pipelined session, resolved pipeline_lag frames late as bench.py's
    warm-up does; then everything resolved. Returns the next frame."""
    track = _track_fn(system, sensor)
    t = system.tracker
    lag = system.cfg.pipeline_lag
    want = int(mix.get("warm_keyframes", 6))
    i = 0
    while i < 8:
        if track(*seq.inputs(i)).state != 1:
            raise RuntimeError(f"warm-up frame {i} not tracked")
        i += 1
    while i < 14 or t.n_kfs < want:
        if i >= len(seq) // 2:
            raise RuntimeError(f"warm-up: {t.n_kfs} keyframes after {i} frames")
        out = track(*seq.inputs(i))
        if mix["read"] == "resolved":
            if out.state != 1:
                raise RuntimeError(f"warm-up frame {i} not tracked")
        else:
            t._flush_upto(i - lag)
        i += 1
    t._flush_all()
    return i


def run(conn, spec):
    import torch

    torch.set_num_threads(int(spec.get("threads", 1)))
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    from slam_bench import forbidden_modules, traffic
    from slam_bench.reference import judge
    from orb_slam2_comment_tpu_torch.models import tracking
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    slam, mix = spec["config"]["slam"], spec["mix"]
    sensor = slam["sensor"]
    idx, seed = spec["index"], spec["seed"]
    seeds = traffic.session_seeds(seed, idx, mix)
    t_render = time.time()
    seq = traffic.make_sequence(slam, mix, seed, idx, dev,
                                cache=traffic.cache_dir(spec["root"]))
    t_render = time.time() - t_render
    system = System(SlamConfig(**slam), device=dev)
    i = warm_up(system, seq, mix, sensor)
    n_warm = i
    track = _track_fn(system, sensor)
    tr = system.tracker
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    check = mix.get("check", {})
    hooks = Hooks(check, np.random.default_rng(seeds["sample"]), spec["trace"])
    kf_new = []
    tr.new_kf_callbacks.append(kf_new.append)
    n_ok0, resets0 = len(tr.trajectory), system.n_resets
    n_max = len(seq)
    N = n_max - i
    t0s = np.zeros(N, np.int64)
    t1s = np.zeros(N, np.int64)
    t2s = np.zeros(N, np.int64)
    prof = None
    if spec["trace"] and cuda:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    conn.send(("ready", dict(render_s=t_render, warm_frames=n_warm)))
    t_go = conn.recv()
    hooks.install()
    caught = None
    if spec["trace"] and cuda:
        caught = warnings.catch_warnings(record=True)
        sync_log = caught.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
    waits0 = tracking.transfer_waits
    resolved = mix["read"] == "resolved"
    ran_out = False
    while time.time() < t_go:
        time.sleep(0.0005)
    t_end = int((t_go + spec["seconds"]) * 1e9)
    k = 0
    try:
        while True:
            a = time.time_ns()
            if a >= t_end:
                break
            if i >= n_max:
                ran_out = True
                break
            out = track(*seq.inputs(i))
            b = time.time_ns()
            if resolved:
                out.state
                out.Tcw
            t0s[k], t1s[k], t2s[k] = a, b, time.time_ns()
            i += 1
            k += 1
        d0 = time.time_ns()
        if not resolved:
            tr._flush_upto(1 << 60)
            tr._drain_mapper()
        if cuda:
            torch.cuda.synchronize(dev)
        d1 = time.time_ns()
    finally:
        if caught is not None:
            torch.cuda.set_sync_debug_mode(0)
            caught.__exit__(None, None, None)
        hooks.remove()
    waits = tracking.transfer_waits - waits0
    syncs = (sum("called a synchronizing CUDA operation" in str(w.message) for w in sync_log)
             if caught is not None else None)
    trace = None
    k3 = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = _device_events(prof, int(t_go * 1e9), d1)
        del prof
        if hooks.k3_launches:
            vs = torch.stack([v for _, _, v in hooks.k3_launches]).cpu().numpy()
            k3 = [(B, n, int(v)) for (B, n, _), v in zip(hooks.k3_launches, vs)]
        hooks.k3_launches = []
    n_ok = len(tr.trajectory) - n_ok0 if system.n_resets == resets0 else 0
    window = dict(
        index=idx, frames=k, ran_out=ran_out, ok=n_ok, first=n_warm, last=n_warm + k - 1,
        t0=t0s[:k], t1=t1s[:k], t2=t2s[:k] if resolved else None, drain=(d0, d1),
        transfer_waits=waits, syncs=syncs, kf_created=len(kf_new), trace=trace, k3=k3,
        memory_peak=int(torch.cuda.max_memory_allocated(dev)) if cuda else 0,
        device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        sms=torch.cuda.get_device_properties(dev).multi_processor_count if cuda else 0,
        resets=system.n_resets - resets0, modules=forbidden_modules())
    conn.send(("window", window))

    # --- the check: after the window, the program's state freed first ---
    frame_poses = system._frame_poses()
    m = system.tracker.map
    kfv = m.kf_valid.cpu().numpy()
    fid = m.kf_frame_id.cpu().numpy()
    cand = np.nonzero(kfv & (fid >= n_warm) & (fid <= n_warm + k - 1))[0]
    rng = np.random.default_rng(seeds["sample"] + 1)
    take = rng.choice(cand, size=min(len(cand), int(check.get("keyframes", 2))), replace=False)
    kfs = [dict(frame=int(fid[s]), **{f: getattr(m, "kf_" + f)[s].cpu().numpy() for f in (
        "xy", "octave", "angle", "desc", "feat_valid", "uright", "depth")}) for s in sorted(take)]
    poses = [(int(round(ts * seq.fps)), np.asarray(T, np.float64)) for ts, T in frame_poses]
    samples = dict(poses=hooks.poses.items, lba=hooks.lba.items)
    del system, tr, m, track, hooks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = judge.judge(slam, seq, kfs, samples, poses, dev, spec.get("control", False))
    tracked = {f for f, _ in poses}
    readings["lost_frames"] = [f for f in range(n_warm, n_warm + k) if f not in tracked]
    conn.send(("check", readings))


def main(conn, spec):
    """Process entry: run the session; any error goes to the parent as
    its traceback, and the process exits non-zero."""
    os.environ.setdefault("USE_FLAX", "0")
    if spec["root"] not in sys.path:
        sys.path.insert(0, spec["root"])
    try:
        run(conn, spec)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        raise SystemExit(1)
    conn.close()
