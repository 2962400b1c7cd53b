"""The port's last public pieces against the JAX package on the CPU:
`local_mapping.fuse_into_keyframe` (the radius-3 Fuse whose duplicate
merge keeps the most-observed point) and the module's five capacity
constants, and `AdaptiveRelocalizer.reset`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

K = (500.0, 500.0, 320.0, 240.0)


def _cfg(pkg):
    if pkg == "jax":
        from orb_slam2_comment_tpu.utils.config import SlamConfig
    else:
        from orb_slam2_comment_tpu_torch.utils.config import SlamConfig
    return SlamConfig(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3], bf=40.0,
                      n_features=64, n_levels=4, max_keyframes=16, max_points=1024,
                      grow_capacity=False)


def _mapped_pair(seed=11, kmax=16, pmax=1024, n=64, n_kf=6):
    """A map of n_kf keyframes stepping along x, each observing 64 of the
    points it sees (with projections, octaves, stereo right coordinates,
    descriptors and counters), where keyframe 5 observes 24 of its
    landmarks through duplicates (new point ids, positions within 3 mm,
    the same descriptors; half of them also seen by keyframe 3) and
    keyframe 4 has a third of its features free. Fusing 5 into 4 both adds
    observations and merges duplicates, each way round."""
    from orb_slam2_comment_tpu.models import map_state as ms

    r = np.random.default_rng(seed)
    n_pts = 400
    pts = np.zeros((pmax, 3), np.float32)
    pts[:n_pts] = r.uniform([-3, -2, 4], [3, 2, 9], (n_pts, 3))
    poses = np.tile(np.eye(4, dtype=np.float32), (kmax, 1, 1))
    obs = np.full((kmax, n), -1, np.int32)
    xy = np.zeros((kmax, n, 2), np.float32)
    ur = np.full((kmax, n), -1.0, np.float32)
    octv = np.zeros((kmax, n), np.int32)
    for k in range(n_kf):
        poses[k, 0, 3] = -0.15 * k
        poses[k, 1, 3] = 0.02 * np.sin(k)
        Xc = pts[:n_pts] + poses[k, :3, 3]
        u = K[0] * Xc[:, 0] / Xc[:, 2] + K[2]
        v = K[1] * Xc[:, 1] / Xc[:, 2] + K[3]
        vis = np.where((u > 5) & (u < 635) & (v > 5) & (v < 475))[0]
        sel = np.sort(r.choice(vis, n, replace=False))
        obs[k] = sel
        xy[k] = np.stack([u[sel], v[sel]], -1)
        ur[k] = np.where(r.random(n) < 0.7, xy[k, :, 0] - 40.0 / Xc[sel, 2], -1.0)
        octv[k] = r.integers(0, 3, n)
    desc = r.integers(0, 2 ** 32, (pmax, 8), dtype=np.uint32)
    valid = np.arange(pmax) < n_pts
    # keyframe 5 sees 24 of its landmarks through duplicates 600..623
    slots = np.arange(0, 48, 2)
    dup_ids = 600 + np.arange(len(slots))
    pts[dup_ids] = pts[obs[5, slots]] + r.normal(0, 0.003, (len(slots), 3))
    desc[dup_ids] = desc[obs[5, slots]]
    valid[dup_ids] = True
    obs[5, slots] = dup_ids
    obs[3, :12] = dup_ids[::2]          # more observations for half of them
    obs[4, 1::3] = -1                   # free features on the target
    kf_desc = np.zeros((kmax, n, 8), np.uint32)
    for k in range(n_kf):
        kf_desc[k] = desc[np.clip(obs[k], 0, pmax - 1)]
    cam_c = -poses[4, :3, 3]
    d = np.linalg.norm(pts - cam_c, axis=1).astype(np.float32)
    parent = np.full(kmax, -1, np.int32)
    parent[1:n_kf] = np.arange(n_kf - 1)
    m = ms.empty_map(kmax, pmax, n)
    return m._replace(
        kf_pose=jnp.asarray(poses), kf_valid=jnp.asarray(np.arange(kmax) < n_kf),
        kf_obs=jnp.asarray(obs), kf_feat_valid=jnp.asarray(np.ones((kmax, n), bool)),
        kf_xy=jnp.asarray(xy), kf_uright=jnp.asarray(ur), kf_octave=jnp.asarray(octv),
        kf_parent=jnp.asarray(parent), kf_desc=jnp.asarray(kf_desc),
        kf_angle=jnp.zeros((kmax, n)), pt_pos=jnp.asarray(pts), pt_valid=jnp.asarray(valid),
        pt_desc=jnp.asarray(desc), pt_max_dist=jnp.asarray(d * 1.2),
        pt_min_dist=jnp.asarray(d * 0.5),
        pt_visible=jnp.asarray(r.integers(1, 9, pmax).astype(np.int32)),
        pt_found=jnp.asarray(r.integers(1, 9, pmax).astype(np.int32)),
        pt_ref_kf=jnp.asarray(np.where(valid, np.arange(pmax) % n_kf, -1).astype(np.int32)))


def _shared_point_case():
    """The pair above where a point P that keyframes 4 and 5 share, on
    feature 0 of keyframe 4, also projects onto keyframe 4's free feature
    1, while a duplicate Q of P in keyframe 5 matches feature 0: the fuse
    adds P on feature 1 and merges Q with P. Q has one observation more
    than P before the add and as many after it, so the counts taken before
    the add (JAX's) keep Q. Returns (map, P, Q)."""
    from orb_slam2_comment_tpu.models import map_state as ms

    m = {k: np.array(v) for k, v in _mapped_pair()._asdict().items()}
    obs, ur = m["kf_obs"], m["kf_uright"]
    P, Q = int(obs[4, 0]), 700
    obs[5, 60], obs[5, 61] = P, Q
    m["pt_pos"][Q] = m["pt_pos"][P] + np.float32([1e-3, 0.0, 0.0])
    m["pt_valid"][Q] = True
    m["pt_desc"][Q] = m["pt_desc"][P] ^ np.uint32([0xFFFFF, 0, 0, 0, 0, 0, 0, 0])  # 20 bits
    for f in ("pt_max_dist", "pt_min_dist", "pt_ref_kf"):
        m[f][Q] = m[f][P]
    Tcw = m["kf_pose"][4]
    for feat, pt in ((0, Q), (1, P)):
        Xc = Tcw[:3, :3] @ m["pt_pos"][pt] + Tcw[:3, 3]
        m["kf_xy"][4, feat] = [K[0] * Xc[0] / Xc[2] + K[2], K[1] * Xc[1] / Xc[2] + K[3]]
        m["kf_desc"][4, feat] = m["pt_desc"][pt]
        m["kf_octave"][4, feat] = 1
    assert obs[4, 1] == -1
    ur[4, 1] = -1.0                     # the add counts 1

    def count(pt):
        return int(np.where(ur[:6][obs[:6] == pt] >= 0, 2, 1).sum())

    for k in range(4):                  # one-count observations of Q in keyframes 0-3
        if count(Q) < count(P) + 1:
            obs[k, 63], ur[k, 63] = Q, -1.0
    assert count(Q) == count(P) + 1, (count(P), count(Q))
    return ms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), P, Q


@pytest.mark.parametrize("case", ["map_counts", "given_counts", "disabled", "enabled_tensor",
                                  "shared_point"])
def test_fuse_into_keyframe_matches_jax(case):
    """Keyframe 5 fused into keyframe 4: the number of merges, the
    association and map tables exactly equal to JAX's, positions within
    the mapper tests' 1e-3 (they are not written), both with counts taken
    from the map and with precomputed ones (a draw that makes the
    projected point win some merges), nothing changed when disabled, the
    switch given as a 0-d tensor, and a point added on a free feature
    while it loses a merge on another (`_shared_point_case`)."""
    from orb_slam2_comment_tpu.models import local_mapping as jlm
    from orb_slam2_comment_tpu_torch.models import local_mapping as tlm
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    jm = _shared_point_case()[0] if case == "shared_point" else _mapped_pair()
    tm = tms.from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    kw_j, kw_t = {}, {}
    if case == "given_counts":
        oc = np.random.default_rng(5).integers(0, 6, 1024).astype(np.int32)
        kw_j["obs_counts"], kw_t["obs_counts"] = jnp.asarray(oc), torch.from_numpy(oc)
    enabled = case != "disabled"
    en_t = torch.tensor(enabled) if case == "enabled_tensor" else enabled
    jm2, jn = jlm.fuse_into_keyframe(jm, jnp.asarray(5), jnp.asarray(4), _cfg("jax"),
                                     enabled=jnp.asarray(enabled), **kw_j)
    tm2, tn = tlm.fuse_into_keyframe(tm, 5, 4, _cfg("torch"), enabled=en_t, **kw_t)
    assert int(tn) == int(jn)
    assert (int(tn) > 0) == enabled
    for f in jm2._fields:
        a, b = np.asarray(getattr(jm2, f)), getattr(tm2, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=1e-3, err_msg=f)
        else:
            np.testing.assert_array_equal(b.astype(a.dtype), a, f)
    changed = (np.asarray(jm2.kf_obs) != np.asarray(jm.kf_obs)).sum()
    assert (changed > 0) == enabled
    if case == "shared_point":
        _, P, Q = _shared_point_case()
        # the case arises: P gained feature 1 and lost its merge to Q
        assert int(jm2.kf_obs[4, 1]) == Q and int(jm2.kf_obs[4, 0]) == Q
        assert not bool(jm2.pt_valid[P]) and bool(jm2.pt_valid[Q])


@pytest.mark.parametrize("name", ["NC_FREE", "NC_FIXED", "NP_BA", "N_TRI_NEIGHBORS",
                                  "N_FUSE_NEIGHBORS"])
def test_local_mapping_constants_equal_jax(name):
    from orb_slam2_comment_tpu.models import local_mapping as jlm
    from orb_slam2_comment_tpu_torch.models import local_mapping as tlm

    assert getattr(tlm, name) == getattr(jlm, name)


def test_adaptive_relocalizer_reset_restores_the_first_page(monkeypatch):
    """After a failure streak has moved the candidate page, reset() sends
    the next attempt back to rank offset 0, in both packages."""
    from orb_slam2_comment_tpu.models import relocalization as jrl
    from orb_slam2_comment_tpu_torch.models import relocalization as trl

    for mod in (jrl, trl):
        offsets = []

        def fake(m, db, frame, cfg, rank_offset=0, _o=offsets):
            _o.append(rank_offset)
            return False, None, None, 3 * mod.RELOC_MAX_CANDIDATES

        monkeypatch.setattr(mod, "relocalize", fake)
        r = mod.AdaptiveRelocalizer()
        for _ in range(2):
            r(None, None, None, None)
        assert r.fail_streak == 2
        r.reset()
        assert r.fail_streak == 0
        r(None, None, None, None)
        step = mod.RELOC_MAX_CANDIDATES
        assert offsets == [0, step, 0], (mod.__name__, offsets)
