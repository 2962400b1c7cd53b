"""One run of a lockstep comparison between the JAX package and the port on
the CPU: a sequence through one package's `System`, with every frame's
record written to an .npz that `tests/test_torch_lockstep.py` compares.

    python tests/lockstep_run.py {jax|port|forced} {street|room_loop|bench} OUT_DIR [--frames N]

`forced` is the port with its pyramid resize replaced by the JAX
package's `_resize_level` of the same input level (the only source that
makes the two front ends' extraction part). The substitution is made
here, on the test side; the port has no hook for it.

Sequences: `street` and `room_loop` are read from the folders that the
port's `examples/make_datasets.py` renders (env `LOCKSTEP_DATA`, default
`build/lockstep_data`) with their settings.yaml; `bench` is bench.py's
120 frames at 1000 x 8 with its warm-up schedule. Every package resolves
frames on the same schedule: `_flush_upto(i - cfg.pipeline_lag)` after
every call (bench: the first 8 calls read their output, as bench.py's
warm-up does, and the warm-up ends with `_flush_all` and the mapper
drain), so host state moves at the same frames in both.

Per frame: state, inliers, keyframe decision, Tcw, the 13 tracking stats
the keyframe policy reads (`tracking.S_*`) and the keyframe count; per
run: the loop pairs with the frame that closed them, and the ATE of the
saved trajectory against the ground truth.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def _packages(pkg):
    """(System class, tracking module, loop closing module, config module,
    System kwargs) of the package a run uses."""
    if pkg == "jax":
        _jax_cpu()
        from orb_slam2_comment_tpu.models import loop_closing, system, tracking
        from orb_slam2_comment_tpu.utils import config
        return system.System, tracking, loop_closing, config, {}
    from orb_slam2_comment_tpu_torch.models import loop_closing, system, tracking
    from orb_slam2_comment_tpu_torch.utils import config
    if pkg == "forced":
        force_jax_pyramid()
    return system.System, tracking, loop_closing, config, {"device": "cpu"}


def jax_resize_level(img, hw):
    """The JAX package's `orb._resize_level` of a port level (a CPU or CUDA
    tensor), as a tensor on the same device."""
    import jax.numpy as jnp
    import torch
    from orb_slam2_comment_tpu.ops import orb as jorb

    out = np.asarray(jorb._resize_level(jnp.asarray(img.detach().cpu().numpy()), hw))
    return torch.from_numpy(out.copy()).to(img.device)


def force_jax_pyramid():
    """Replace the port's `orb._resize_level` by `jax_resize_level`."""
    _jax_cpu()
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    torb._resize_level = jax_resize_level


def _bench_frames(n):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=3200, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=n, step=0.025)
    frames = []
    for f in syn.render_sequence(scene, poses, K=syn.DEFAULT_K, depth=True):
        f["image"] = np.clip(f["image"], 0, 255).astype(np.uint8)
        f["depth"] = np.clip(f["depth"] * 1000.0, 0, 65535).astype(np.uint16)
        frames.append(f)
    return frames


def _bench_cfg(config):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    K = syn.DEFAULT_K
    return config.SlamConfig(
        pipeline_lag=4, sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
        bf=K[0] * syn.DEFAULT_BASELINE, n_features=1000, n_levels=8, max_keyframes=128,
        max_points=32768, grow_capacity=False, match_th_scale=1.5, depth_map_factor=1000.0)


def _dataset(seq, config, n_frames):
    from orb_slam2_comment_tpu_torch.utils import datasets as ds

    root = os.environ.get("LOCKSTEP_DATA", os.path.join(REPO, "build", "lockstep_data"))
    seq_dir = os.path.join(root, seq)
    if seq == "street":
        sensor, items = "stereo", ds.load_kitti(seq_dir, stereo=True)
    else:
        sensor = "rgbd"
        items = ds.load_tum_rgbd(seq_dir, os.path.join(seq_dir, "associations.txt"))
    cfg = config.load_yaml_settings(os.path.join(seq_dir, "settings.yaml"), sensor)
    return seq_dir, cfg, items[:n_frames] if n_frames else items


def run(pkg, seq, out_dir, n_frames=None):
    System, tracking, loop_closing, config, kw = _packages(pkg)
    os.makedirs(out_dir, exist_ok=True)
    if seq == "bench":
        cfg = _bench_cfg(config)
        frames = _bench_frames(n_frames or 120)
        seq_dir = None
    else:
        seq_dir, cfg, items = _dataset(seq, config, n_frames)
        from orb_slam2_comment_tpu_torch.utils import datasets as ds
        frames = list(ds.FramePrefetcher(items, lookahead=8, threads=2))

    recs, loops = {}, []
    n_stats = tracking.N_STATS
    orig_resolve = tracking.Tracker._resolve_entry
    orig_correct = loop_closing.LoopCloser._correct_loop
    cur = {"i": -1}

    def resolve(self, fid, ts, s):
        r = orig_resolve(self, fid, ts, s)
        out = self._resolved.get(fid)
        recs[fid] = dict(stats=np.asarray(s[:n_stats], np.float64).copy(),
                         n_kfs=int(s[tracking.X_N_KFS]), state=int(out.state),
                         n_inl=int(out.n_inliers), kf=bool(out.created_kf),
                         Tcw=None if out.Tcw is None else np.asarray(out.Tcw, np.float64))
        return r

    def correct(self, kf_id, cand, *a, **k):
        loops.append((int(kf_id), int(cand), cur["i"]))
        return orig_correct(self, kf_id, cand, *a, **k)

    tracking.Tracker._resolve_entry = resolve
    loop_closing.LoopCloser._correct_loop = correct
    system = System(cfg, **kw)
    trk = system.tracker
    lag = int(cfg.pipeline_lag)
    outs = []
    t0 = time.time()
    warm_end = None
    n_frames_all = len(frames)
    for i, f in enumerate(frames):
        cur["i"] = i
        if cfg.sensor == "stereo":
            out = system.track_stereo(f["image"], f["image_right"], f["timestamp"])
        else:
            out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        outs.append(out)
        if seq == "bench" and i < 8:
            out.state
        else:
            trk._flush_upto(i - lag)
        if (seq == "bench" and warm_end is None and i >= 8 + 6 - 1
                and (trk.n_kfs >= 6 or i + 1 >= n_frames_all - 30)):
            # bench.py:96-110: the warm-up ends with a full flush and a drain
            trk._flush_all()
            trk._drain_mapper()
            warm_end = i + 1
        if i % 50 == 0:
            print(f"[{pkg} {seq}] frame {i}/{len(frames)} kfs={trk.n_kfs} "
                  f"{time.time() - t0:.0f}s", flush=True)
    trk._flush_all()
    trk._drain_mapper()
    wall = time.time() - t0
    n = len(frames)
    # frames resolved outside the stats batches (the host path: the first
    # frame, relocalization) read their handles, all resolved by now
    for i in range(n):
        if i not in recs:
            o = outs[i]
            recs[i] = dict(stats=np.full(n_stats, np.nan), n_kfs=-1, state=int(o.state),
                           n_inl=int(o.n_inliers), kf=bool(o.created_kf),
                           Tcw=None if o.Tcw is None else np.asarray(o.Tcw, np.float64))
    system.shutdown()
    Tcw = np.stack([recs[i]["Tcw"] if recs[i]["Tcw"] is not None else np.full((4, 4), np.nan)
                    for i in range(n)])
    res = dict(pkg=pkg, seq=seq, frames=n, wall_s=wall, n_kfs=int(trk.n_kfs),
               tracked=int(sum(recs[i]["state"] == tracking.OK for i in range(n))),
               loops=loops, warm_end=warm_end)
    if seq == "bench":
        from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

        ok = ~np.isnan(Tcw[:, 0, 0])
        res["ate_m"] = ate_rmse(list(Tcw[ok]), [frames[i]["Tcw_gt"] for i in np.where(ok)[0]])
    else:
        from orb_slam2_comment_tpu_torch.examples import head_to_head as h2h

        if seq == "street":
            path = os.path.join(out_dir, f"{pkg}_{seq}_kitti.txt")
            system.save_trajectory_kitti(path)
            ev = h2h.eval_kitti(path, os.path.join(seq_dir, "poses_gt.txt"), n_frames=n)
        else:
            path = os.path.join(out_dir, f"{pkg}_{seq}_tum.txt")
            system.save_trajectory_tum(path)
            ev = h2h.eval_tum(path, os.path.join(seq_dir, "groundtruth.txt"))
        res["ate_m"] = ev.get("ate_rmse_m")
    np.savez(os.path.join(out_dir, f"{pkg}_{seq}.npz"),
             state=np.asarray([recs[i]["state"] for i in range(n)]),
             n_inl=np.asarray([recs[i]["n_inl"] for i in range(n)]),
             kf=np.asarray([recs[i]["kf"] for i in range(n)]),
             n_kfs=np.asarray([recs[i]["n_kfs"] for i in range(n)]),
             stats=np.stack([recs[i]["stats"] for i in range(n)]), Tcw=Tcw)
    with open(os.path.join(out_dir, f"{pkg}_{seq}.json"), "w") as fh:
        json.dump(res, fh)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("pkg", choices=["jax", "port", "forced"])
    ap.add_argument("seq", choices=["street", "room_loop", "bench"])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=None)
    a = ap.parse_args()
    if a.pkg != "jax":
        import torch

        torch.set_num_threads(int(os.environ.get("LOCKSTEP_THREADS", "2")))
    run(a.pkg, a.seq, a.out_dir, a.frames)
