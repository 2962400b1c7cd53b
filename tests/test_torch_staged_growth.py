"""Capacity growth with the staged ladder (`fused_tracking=False`) and
with the monolithic mapper (`chunked_mapper=False`) against the JAX
package on the CPU: tests/test_torch_capacity.py's orbit (600 x 4) from
the 16-keyframe tier (caps 64 and 32768) through System.track_rgbd with
loop closing on. Both modes grow the keyframe tier at frame 13. The
staged tracker never refreshes its point-cursor mirror (`n_pts_host`
moves only with a device step's stats or a compaction), so neither
package grows a point tier or compacts the arena there, while the cursor
itself fills (ROADMAP, "Reference hazards the port mirrors"); the
packages are compared over the whole run."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# frames per mode: the keyframe tier grows at frame 13 in both modes; the
# staged cursor passes 85% of the point tier by frame 29
N_FRAMES = {"fused_tracking": 30, "chunked_mapper": 20}


@pytest.fixture(scope="module", params=sorted(N_FRAMES))
def growth_runs(request):
    """Both packages over the orbit with request.param False. Returns the
    mode, the per-frame records (state, keyframe flag, pose or None) and
    capacity events ("grow", frame, keyframes, points) or ("compact",
    frame) of each, and both Systems (JAX's, the port's)."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    K, B = syn.DEFAULT_K, syn.DEFAULT_BASELINE
    kw = dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3], bf=K[0] * B,
              n_features=600, n_levels=4, max_keyframes=16, max_points=8192,
              max_keyframes_cap=64, max_points_cap=32768, match_th_scale=1.5,
              **{request.param: False})
    scene = syn.make_scene(n_points=1400, seed=0)
    poses = syn.make_trajectory("orbit", n_frames=60, step=0.1)[:N_FRAMES[request.param]]
    frames = list(syn.render_sequence(scene, poses, K=K, depth=True, baseline=B))
    out, systems = [], (JSystem(JConfig(**kw)), TSystem(TConfig(**kw), device="cpu"))
    for system in systems:
        recs, events = [], []
        tr = system.tracker
        tr.grow_callbacks.append(lambda c, recs=recs, events=events: events.append(
            ("grow", len(recs), c.max_keyframes, c.max_points)))
        tr.compact_callbacks.append(lambda recs=recs, events=events: events.append(
            ("compact", len(recs))))
        for f in frames:
            o = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
            recs.append((o.state, bool(o.created_kf),
                         None if o.Tcw is None else np.asarray(o.Tcw, np.float64)))
        system.shutdown()
        out.append((recs, events))
    return request.param, out, systems


def test_growth_tracks_like_jax(growth_runs):
    """Every frame tracked in both; the same capacity events, the keyframe
    growth (16 -> 64 at the same frame) only; keyframes on the same frames
    and translations within 1 mm of JAX's over the whole run."""
    mode, ((jrec, jev), (trec, tev)), _ = growth_runs
    assert all(r[0] == 1 for r in jrec) and all(r[0] == 1 for r in trec)
    assert tev == jev == [("grow", 13, 64, 8192)]
    assert [r[1] for r in trec] == [r[1] for r in jrec]
    dt = max(np.abs(a[2][:3, 3] - b[2][:3, 3]).max() for a, b in zip(trec, jrec))
    assert dt < 1e-3, dt


def test_growth_reaches_every_component(growth_runs):
    """After growth the tracker, the mapper, the loop closer and the
    database agree on the 64-keyframe tier: the monolithic mapper runs
    with the grown cfg. The staged tracker keeps no device state; the
    monolithic one rebuilt its machine at the new tier and never ran it.
    The cursor and its mirror equal JAX's; the staged mirror stays 0 while
    the staged cursor is past 85% of the point tier."""
    mode, _, (js, ts) = growth_runs
    tr = ts.tracker
    assert ts.mapper.cfg is tr.cfg and ts.loop_closer.cfg is tr.cfg and ts.cfg is tr.cfg
    assert tr.cfg.max_keyframes == tr.map.kf_obs.shape[0] == ts.db.valid.shape[0] == 64
    assert tr.cfg.max_points == tr.map.pt_pos.shape[0] == 8192
    assert ts.mapper.process in tr.new_kf_callbacks
    assert (tr.n_pts, tr.n_pts_host) == (int(js.tracker.n_pts), js.tracker.n_pts_host)
    if mode == "fused_tracking":
        assert tr.ds is None and tr.compaction_epoch == js.tracker.compaction_epoch == 0
        assert tr.n_pts_host == 0 and tr.n_pts >= int(0.85 * 8192)
    else:
        assert tr.ds.mp.phase == 0 and tr.ds.mp.kf == -1
        assert int(tr.ds.n_pts) == tr.n_pts
