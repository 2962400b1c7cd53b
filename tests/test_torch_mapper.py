"""Parity of the port's chunked local mapper
(orb_slam2_comment_tpu_torch.models.local_mapping.mapper_machine_step) with
the JAX package: a JAX map is snapshotted right after it creates a
keyframe, carried across with from_numpy, and every phase of that
keyframe's pass (start, tri, tri, fuse, fuse, refresh, ba1, ba2, ba3,
kfcull) runs in both packages from the identical state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)


def _cfg_kw():
    from orb_slam2_comment_tpu.utils import synthetic as syn

    K = syn.DEFAULT_K
    return dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                bf=K[0] * syn.DEFAULT_BASELINE, n_features=500, n_levels=4,
                max_keyframes=32, max_points=8192, grow_capacity=False, match_th_scale=1.5)


def _np_state(t):
    """(map, n_pts, obs_counts, machine) of a JAX tracker as numpy."""
    ds = t.ds
    return ({k: np.array(v) for k, v in t.map._asdict().items()}, np.array(ds.n_pts),
            np.array(ds.obs_counts), {k: np.array(v) for k, v in ds.mp._asdict().items()})


def _jax_step(state, cfg):
    from orb_slam2_comment_tpu.models import local_mapping as jlm
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu.models import tracking as jt

    m, n_pts, oc, mp = state
    out = jt._mapper_pump(jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}),
                          jnp.asarray(n_pts), jnp.asarray(oc),
                          jlm.MapperMachine(**{k: jnp.asarray(v) for k, v in mp.items()}), cfg)
    m2, n2, oc2, mp2 = out
    return ({k: np.array(v) for k, v in m2._asdict().items()}, np.array(n2), np.array(oc2),
            {k: np.array(v) for k, v in mp2._asdict().items()})


@pytest.fixture(scope="module")
def phase_states():
    """states[p] = the JAX mapper state before phase p (1-based) of the
    pass of the first keyframe created after initialization, plus every
    JAX output."""
    from orb_slam2_comment_tpu.models.system import System
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig

    cfg = SlamConfig(**_cfg_kw())
    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=16, step=0.03)
    system = System(cfg, enable_loop_closing=False)
    snap = None
    for i, f in enumerate(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, depth=True)):
        out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        if i > 0 and out.created_kf:
            snap = _np_state(system.tracker)
            ds_np = {k: (v if k != "mp" else v._asdict()) for k, v in
                     system.tracker.ds._asdict().items()}
            ds_np = {k: ({f: np.array(a) for f, a in v.items()} if k == "mp" else np.array(v))
                     for k, v in ds_np.items()}
            break
    assert snap is not None and int(snap[3]["phase"]) == 2
    start = (snap[0], snap[1], snap[2], dict(snap[3], phase=np.asarray(1, np.int32)))
    states = {1: start, 2: snap}
    p = 2
    while int(states[p][3]["phase"]) != 0:
        states[p + 1] = _jax_step(states[p], cfg)
        p += 1
    states["after_start"] = _jax_step(start, cfg)
    states["track_state"] = ds_np
    return cfg, states


def _port_step(state):
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm
    from orb_slam2_comment_tpu_torch.models import map_state as tms
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    m, n_pts, oc, mp = state
    out = lm.mapper_machine_step(tms.from_numpy(m), torch.from_numpy(np.array(n_pts)),
                                 torch.from_numpy(oc), lm.machine_from_numpy(mp),
                                 SlamConfig(**_cfg_kw()))
    m2, n2, oc2, mp2 = out
    return tms.to_numpy(m2), n2.numpy(), oc2.numpy(), lm.machine_to_numpy(mp2)


# float tolerance per phase kind (the others must match exactly):
# refresh averages unit vectors in another summation order; the BA phases
# run LM whose sums (and hence steps) differ in the last bits.
_FLOAT_TOL = {"refresh": 1e-5, "ba1": 2e-3, "ba2": 2e-3, "ba3": 2e-3}


@pytest.mark.parametrize("phase", list(range(1, 11)))
def test_mapper_phase_matches_jax(phase_states, phase):
    from orb_slam2_comment_tpu_torch.models import local_mapping as lm
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    _, states = phase_states
    kinds = [s[0] for s in lm._phase_list(SlamConfig(**_cfg_kw()))]
    assert len(kinds) == 10
    kind = kinds[phase - 1]
    before = states[phase]
    after = states["after_start"] if phase == 1 else states[phase + 1]
    got = _port_step(before)
    tol = _FLOAT_TOL.get(kind, 0.0)
    m_j, n_j, oc_j, mp_j = after
    m_t, n_t, oc_t, mp_t = got
    assert int(n_t) == int(n_j), kind
    assert int(mp_t["phase"]) == int(mp_j["phase"]) and int(mp_t["kf"]) == int(mp_j["kf"])
    for name, a, b in ([("map." + k, m_j[k], m_t[k]) for k in m_j]
                       + [("mp." + k, mp_j[k], mp_t[k]) for k in mp_j]
                       + [("obs_counts", oc_j, oc_t)]):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            if name == "mp.ba_cost":
                np.testing.assert_allclose(b, a, rtol=1e-3, err_msg=f"{kind} {name}")
            else:
                np.testing.assert_allclose(b, a, atol=tol, rtol=tol, err_msg=f"{kind} {name}")
        elif kind.startswith("ba") and name in ("map.kf_obs", "mp.ba_obs_ok", "map.pt_valid",
                                                 "obs_counts", "mp.ba_n_in"):
            # chi2 gates of the BA phases may flip a borderline observation
            diff = np.sum(a != b)
            assert diff <= max(2, a.size // 2000), f"{kind} {name}: {diff} differ"
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} {name}")


def test_mapper_pass_does_work(phase_states):
    """The snapshot's pass is not trivial: triangulation creates points,
    fusion or culling edits observations, local BA moves keyframes."""
    _, states = phase_states
    assert int(states[4][1]) > int(states[2][1])                  # tri
    assert not np.array_equal(states[4][0]["kf_obs"], states[6][0]["kf_obs"])
    assert not np.array_equal(states[7][0]["kf_pose"], states[10][0]["kf_pose"])


def test_track_state_round_trip(phase_states):
    """DeviceTrackState carried across: from_numpy of the reference's
    state, then to_numpy, gives the same arrays (bf16 centroids as f32)."""
    from orb_slam2_comment_tpu_torch.models import tracking as tt

    _, states = phase_states
    ref = states["track_state"]
    back = tt.track_state_to_numpy(tt.track_state_from_numpy(ref))
    for k, v in ref.items():
        if k == "mp":
            for f, a in v.items():
                np.testing.assert_array_equal(back["mp"][f], a, err_msg=f)
        elif k == "voc_signed":
            np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
