"""Exact parity of the port's matching, BoW group ids, map-state ops and the
tracking association helpers with the JAX package on identical inputs (CPU).
Hamming distances are integers and every tie is broken by index in both
packages, so the integer outputs must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)


def _feats(r, n, h=480, w=640):
    return dict(
        xy=r.uniform([0, 0], [w, h], (n, 2)).astype(np.float32),
        response=r.random(n).astype(np.float32),
        angle=r.uniform(-np.pi, np.pi, n).astype(np.float32),
        octave=r.integers(0, 4, n).astype(np.int32),
        desc=r.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32),
        valid=r.random(n) < 0.9,
    )


def _both_feats(d):
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    jf = jorb.FrameFeatures(**{k: jnp.asarray(v) for k, v in d.items()})
    tf = torb.FrameFeatures(**{k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                                   else v) for k, v in d.items()})
    return jf, tf


def _desc_with_near_copies(r, base):
    """bit-flipped copies of the `base` rows (small Hamming distances,
    with ties)."""
    n = base.shape[0]
    flips = r.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    mask = (r.random((n, 8)) < 0.15).astype(np.uint32) * np.uint32(0xFFFFFFFF)
    return base ^ (flips & mask & np.uint32(0x11111111))


def _check_result(jr, tr):
    ok = np.asarray(jr.ok)
    np.testing.assert_array_equal(tr.ok.numpy(), ok)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))


@pytest.mark.parametrize("seed", [0, 1])
def test_match_projection_and_generic_exact(seed):
    from orb_slam2_comment_tpu.ops import matching as jm
    from orb_slam2_comment_tpu_torch.ops import matching as tm

    r = np.random.default_rng(seed)
    fd = _feats(r, 400)
    jf, tf = _both_feats(fd)
    P = 300
    src = r.integers(0, 400, P)
    pdesc = _desc_with_near_copies(r, fd["desc"][src])
    pxy = (fd["xy"][src] + r.normal(0, 3, (P, 2))).astype(np.float32)
    poct = r.integers(0, 4, P).astype(np.int32)
    pval = r.random(P) < 0.9
    scales = np.asarray([1.2 ** l for l in range(4)], np.float32)
    # a consistent rotation (+0.3 rad) plus some random outliers
    pang = (fd["angle"][src] + 0.3 + r.normal(0, 0.05, P)).astype(np.float32)
    pang[::7] = r.uniform(-np.pi, np.pi, len(pang[::7]))
    for nn, ang in ((0.8, None), (None, pang)):
        jr = jm.match_projection(jnp.asarray(pxy), jnp.asarray(pval), jnp.asarray(pdesc),
                                 jnp.asarray(poct), jf, 7.0, jnp.asarray(scales),
                                 max_dist=100.0, nn_ratio=nn,
                                 angles_p=None if ang is None else jnp.asarray(ang))
        tr = tm.match_projection(torch.from_numpy(pxy), torch.from_numpy(pval),
                                 torch.from_numpy(pdesc.view(np.int32)), torch.from_numpy(poct),
                                 tf, 7.0, torch.from_numpy(scales), max_dist=100.0,
                                 nn_ratio=nn,
                                 angles_p=None if ang is None else torch.from_numpy(ang))
        _check_result(jr, tr)
        assert np.asarray(jr.ok).sum() > 20
    np.testing.assert_array_equal(
        tm.hamming_from_packed(torch.from_numpy(pdesc.view(np.int32)), tf.desc).numpy(),
        np.asarray(jm.hamming_from_packed(jnp.asarray(pdesc), jf.desc)))


def test_match_epipolar_and_nodes_exact():
    from orb_slam2_comment_tpu.ops import geometry as jg
    from orb_slam2_comment_tpu.ops import matching as jm
    from orb_slam2_comment_tpu_torch.ops import matching as tm

    r = np.random.default_rng(3)
    fa = _feats(r, 300)
    fb = _feats(r, 300)
    fb["desc"][:200] = _desc_with_near_copies(r, fa["desc"][r.integers(0, 300, 200)])
    ja, ta = _both_feats(fa)
    jb, tb = _both_feats(fb)
    K = (520.0, 520.0, 320.0, 240.0)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jg.se3_exp(jnp.asarray([0.3, 0.0, 0.05, 0.0, 0.02, 0.0], jnp.float32)))
    F12 = np.asarray(jg.fundamental_from_poses(K, jnp.asarray(T1), K, jnp.asarray(T2)))
    s2 = np.asarray([1.44 ** l for l in range(4)], np.float32) * 4000.0   # wide band
    un_a, un_b = r.random(300) < 0.8, r.random(300) < 0.8
    jr = jm.match_epipolar(ja, jb, jnp.asarray(F12), jnp.asarray(s2), jnp.asarray(un_a),
                           jnp.asarray(un_b), max_dist=75.0)
    tr = tm.match_epipolar(ta, tb, torch.from_numpy(F12), torch.from_numpy(s2),
                           torch.from_numpy(un_a), torch.from_numpy(un_b), max_dist=75.0)
    _check_result(jr, tr)
    assert np.asarray(jr.ok).sum() > 20
    na = r.integers(-1, 6, 300).astype(np.int32)
    nb = r.integers(0, 6, 300).astype(np.int32)
    jr = jm.match_nodes(ja.desc, jnp.asarray(na), ja.valid, jb, jnp.asarray(nb), 75.0, 0.7,
                        angles_a=ja.angle)
    tr = tm.match_nodes(ta.desc, torch.from_numpy(na), ta.valid, tb, torch.from_numpy(nb),
                        75.0, 0.7, angles_a=ta.angle)
    _check_result(jr, tr)


def test_group_ids_exact_with_vocabulary_asset():
    import os

    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    assert os.path.exists(VOC_ASSET)
    jv = jb.load_vocabulary(VOC_ASSET)
    tv = tb.load_vocabulary(VOC_ASSET)
    r = np.random.default_rng(4)
    desc = np.asarray(jv.node_desc)[r.integers(1, jv.n_nodes, 500)]
    desc = desc ^ (r.integers(0, 2 ** 32, desc.shape, dtype=np.uint64).astype(np.uint32)
                   & np.uint32(0x01010101))
    valid = r.random(500) < 0.9
    for voc_j, voc_t in ((jv, tv), (None, None)):
        gj = jb.gate_arrays(voc_j)
        gt = tb.gate_arrays(voc_t)
        a = jb.group_ids(gj[0], gj[1], jnp.asarray(desc), jnp.asarray(valid), 2)
        b = tb.group_ids(gt[0], gt[1], torch.from_numpy(desc.view(np.int32)),
                         torch.from_numpy(valid), 2)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _random_map(r, kmax=12, n=64, pmax=400):
    """A random but consistent MapState as numpy arrays (reference dtypes)."""
    from orb_slam2_comment_tpu.models import map_state as jms

    m = {k: np.asarray(v).copy() for k, v in jms.empty_map(kmax, pmax, n)._asdict().items()}
    nk = kmax - 2
    m["kf_valid"][:nk] = r.random(nk) < 0.9
    m["kf_valid"][0] = True
    m["kf_pose"][:nk, :3, 3] = r.normal(0, 0.5, (nk, 3))
    obs = r.integers(0, pmax, (kmax, n)).astype(np.int32)
    obs[r.random((kmax, n)) < 0.3] = -1
    m["kf_obs"] = obs
    m["kf_feat_valid"] = r.random((kmax, n)) < 0.95
    m["kf_uright"] = np.where(r.random((kmax, n)) < 0.6, 300.0, -1.0).astype(np.float32)
    m["kf_octave"] = r.integers(0, 8, (kmax, n)).astype(np.int32)
    m["kf_xy"] = r.uniform(0, 400, (kmax, n, 2)).astype(np.float32)
    m["kf_desc"] = r.integers(0, 2 ** 32, (kmax, n, 8), dtype=np.uint64).astype(np.uint32)
    m["pt_valid"] = r.random(pmax) < 0.85
    m["pt_pos"] = (r.normal(0, 2, (pmax, 3)) + [0, 0, 6]).astype(np.float32)
    m["pt_ref_kf"] = r.integers(0, nk, pmax).astype(np.int32)
    m["pt_first_kf"] = r.integers(0, nk, pmax).astype(np.int32)
    m["pt_max_dist"] = r.uniform(2, 12, pmax).astype(np.float32)
    m["pt_visible"] = r.integers(1, 20, pmax).astype(np.int32)
    m["pt_found"] = r.integers(0, 10, pmax).astype(np.int32)
    return m


def _maps(m):
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    return jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), tms.from_numpy(m)


def _assert_maps_equal(jm_, tm_, float_tol=0.0):
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    tn = tms.to_numpy(tm_)
    for k, v in jm_._asdict().items():
        a = np.asarray(v)
        if a.dtype.kind == "f" and float_tol:
            np.testing.assert_allclose(tn[k], a, atol=float_tol, rtol=float_tol, err_msg=k)
        else:
            np.testing.assert_array_equal(tn[k], a, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_map_state_ops_exact(seed):
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    r = np.random.default_rng(seed)
    m = _random_map(r)
    jm_, tm_ = _maps(m)
    _assert_maps_equal(jm_, tm_)   # from_numpy/to_numpy round trip
    np.testing.assert_array_equal(tms.point_observation_counts(tm_).numpy(),
                                  np.asarray(jms.point_observation_counts(jm_)))
    for k in (0, 3, 7):
        np.testing.assert_array_equal(tms.covisibility_weights(tm_, k).numpy(),
                                      np.asarray(jms.covisibility_weights(jm_, k)))
    np.testing.assert_array_equal(tms.covisibility_matrix(tm_).numpy(),
                                  np.asarray(jms.covisibility_matrix(jm_)))
    jc, jn, jr = jms.compact_points(jm_)
    tc, tn, tr = tms.compact_points(tm_)
    assert int(jn) == int(tn)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    _assert_maps_equal(jc, tc)
    d = r.uniform(0.5, 15, 200).astype(np.float32)
    md = r.uniform(1, 20, 200).astype(np.float32)
    np.testing.assert_array_equal(
        tms.predict_scale(torch.from_numpy(d), torch.from_numpy(md), 1.2, 8).numpy(),
        np.asarray(jms.predict_scale(jnp.asarray(d), jnp.asarray(md), 1.2, 8)))
    # float sums in another order: normals/bands within f32 rounding
    _assert_maps_equal(jms.update_point_stats(jm_, 1.2, 8),
                       tms.update_point_stats(tm_, 1.2, 8), float_tol=1e-5)


def test_tracking_association_helpers_exact():
    from orb_slam2_comment_tpu.models import tracking as jt
    from orb_slam2_comment_tpu.ops import matching as jm
    from orb_slam2_comment_tpu_torch.models import tracking as tt
    from orb_slam2_comment_tpu_torch.ops import matching as tm

    r = np.random.default_rng(5)
    # the reference traces both cap branches: Pmax must exceed the 8192 cap
    m = _random_map(r, kmax=24, n=512, pmax=8200)
    jm_, tm_ = _maps(m)
    n = 512
    assoc = r.integers(-1, 8200, n).astype(np.int32)
    jk, jp = jt._select_local_map(jm_, jnp.asarray(assoc))
    tk, tp = tt._select_local_map(tm_, torch.from_numpy(assoc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    vis = r.random(tp.shape[0]) < 0.5
    _assert_maps_equal(jt._update_point_counters(jm_, jp, jnp.asarray(vis), jnp.asarray(assoc)),
                       tt._update_point_counters(tm_, tp, torch.from_numpy(vis),
                                                 torch.from_numpy(assoc)))
    res_np = dict(idx=r.integers(0, n, 300).astype(np.int32),
                  dist=r.integers(0, 120, 300).astype(np.float32), ok=r.random(300) < 0.7)
    rows = r.integers(-1, 8200, 300).astype(np.int32)
    a = jt._invert_matches(jm.MatchResult(**{k: jnp.asarray(v) for k, v in res_np.items()}),
                           jnp.asarray(rows), n)
    b = tt._invert_matches(tm.MatchResult(**{k: torch.from_numpy(v)
                                             for k, v in res_np.items()}),
                           torch.from_numpy(rows), n)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
