"""Parity of the port's place recognition with the JAX package on the CPU:
vocabulary descent (words and groups exactly), BoW vectors and L1 scores
(within 1e-6), the inverted file against the dense scores, and the
KeyFrameDatabase's loop and relocalization candidate lists (exactly) in
both the dense and the inverted-file mode."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "orb_slam2_comment_tpu", "assets", "voc_synth.npz")
ASSET_100K = os.path.join(ROOT, "orb_slam2_comment_tpu", "assets", "voc_synth_100k.npz")


@pytest.fixture(scope="module")
def vocs():
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    return jb.load_vocabulary(ASSET), tb.load_vocabulary(ASSET)


@pytest.fixture(scope="module")
def vocs100k():
    """Both packages' 97,273-word vocabulary, each from its own asset."""
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET_100K
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    return jb.load_vocabulary(ASSET_100K), tb.load_vocabulary(VOC_ASSET_100K)


def _flip_bits(desc, n_flips, r):
    """Flip n_flips random bits of every [8]-word uint32 descriptor."""
    out = desc.copy()
    for _ in range(n_flips):
        w = r.integers(0, 8, len(out))
        b = r.integers(0, 32, len(out)).astype(np.uint32)
        out[np.arange(len(out)), w] ^= np.uint32(1) << b
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_and_scores_match_jax(vocs, seed):
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    jv, tv = vocs
    r = np.random.default_rng(seed)
    desc = r.integers(0, 2 ** 32, (400, 8), dtype=np.uint32)
    valid = r.random(400) < 0.9
    jw, jg, jvec = jb.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
    tw, tg, tvec = tb.transform(tv, torch.from_numpy(desc.view(np.int32)),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), atol=1e-6)
    # the gate's group ids equal transform's groups at the group depth
    ch, signed = tb.gate_arrays(tv)
    np.testing.assert_array_equal(
        tb.group_ids(ch, signed, torch.from_numpy(desc.view(np.int32)),
                     torch.from_numpy(valid), tv.group_depth).numpy(), np.asarray(jg))
    desc2 = _flip_bits(desc, 3, r)
    jvec2 = jb.transform(jv, jnp.asarray(desc2), jnp.asarray(valid))[2]
    tvec2 = tb.transform(tv, torch.from_numpy(desc2.view(np.int32)), torch.from_numpy(valid))[2]
    js = float(jb.l1_score(jvec, jvec2))
    ts = float(tb.l1_score(tvec, tvec2))
    assert abs(js - ts) < 1e-6 and js > 0.1


def test_inverted_file_matches_dense():
    """Sparse vectors + postings reproduce the dense scores (1e-5) and
    shared-word counts (exactly), in the port and against JAX."""
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    r = np.random.default_rng(0)
    W, N, K = 3000, 120, 12
    weight = r.uniform(0.2, 1.0, W).astype(np.float32)
    tvoc = tb.Vocabulary(children=None, node_desc=None, node_word=None,
                         word_weight=torch.from_numpy(weight), group_depth=0, depth=0, k=0)
    words = [np.where(r.random(N) < 0.9, r.integers(0, W, N), -1).astype(np.int32)
             for _ in range(K + 1)]
    sp = [tb.sparse_bow(torch.from_numpy(weight), torch.from_numpy(w)) for w in words]
    for (uw, ww), w in zip(sp, words):
        juw, jww = jb.sparse_bow(jnp.asarray(weight), jnp.asarray(w))
        np.testing.assert_array_equal(uw.numpy(), np.asarray(juw))
        np.testing.assert_allclose(ww.numpy(), np.asarray(jww), atol=1e-7)
    dense = torch.stack([tb.bow_vector(tvoc, torch.from_numpy(w)) for w in words[:K]])
    valid = torch.from_numpy(r.random(K) < 0.8)
    pw, pk, pv = tb.build_postings(torch.stack([s[0] for s in sp[:K]]),
                                   torch.stack([s[1] for s in sp[:K]]), valid)
    scores, common, dropped = tb.inverted_file_query(pw, pk, pv, sp[K][0], sp[K][1], kmax=K)
    qd = tb.bow_vector(tvoc, torch.from_numpy(words[K]))
    assert int(dropped) == 0
    v = valid.numpy()
    np.testing.assert_allclose(scores.numpy()[v], tb.l1_score(dense, qd[None]).numpy()[v],
                               atol=1e-5)
    np.testing.assert_array_equal(common.numpy()[v],
                                  torch.sum((dense > 0) & (qd[None] > 0), dim=1).numpy()[v])
    jpw, jpk, jpv = jb.build_postings(jnp.asarray(np.stack([s[0].numpy() for s in sp[:K]])),
                                      jnp.asarray(np.stack([s[1].numpy() for s in sp[:K]])),
                                      jnp.asarray(v))
    js, jc, _ = jb.inverted_file_query(jpw, jpk, jpv, jnp.asarray(sp[K][0].numpy()),
                                       jnp.asarray(sp[K][1].numpy()), kmax=K)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(common.numpy(), np.asarray(jc))


def _db_map(r):
    """A 12-keyframe map: KFs 0-9 walk forward over shared points; KFs 10
    and 11 re-observe the region of KFs 0-2 through NEW point ids (a loop
    revisit: similar descriptors, no covisibility)."""
    from orb_slam2_comment_tpu.models import map_state as ms

    kmax, pmax, n = 16, 2048, 256
    pt_desc = r.integers(0, 2 ** 32, (pmax, 8), dtype=np.uint32)
    obs = np.full((kmax, n), -1, np.int32)
    for k in range(10):
        obs[k] = np.arange(n) + 100 * k
    for k in (10, 11):
        obs[k] = np.arange(n) + 1300 + 100 * (k - 10)
        src = np.arange(n) + 100 * (k - 10)
        pt_desc[obs[k]] = _flip_bits(pt_desc[src], 2, r)
    kf_desc = np.zeros((kmax, n, 8), np.uint32)
    for k in range(12):
        kf_desc[k] = _flip_bits(pt_desc[obs[k]], 1, r)
    m = ms.empty_map(kmax, pmax, n)
    m = m._replace(kf_valid=jnp.asarray(np.arange(kmax) < 12), kf_obs=jnp.asarray(obs),
                   kf_feat_valid=jnp.asarray(obs >= 0), kf_desc=jnp.asarray(kf_desc),
                   pt_valid=jnp.asarray(np.arange(pmax) < 1700), pt_desc=jnp.asarray(pt_desc))
    return m, kf_desc, pt_desc, obs


@pytest.mark.parametrize("sparse", [False, True, "voc100k"])
def test_database_candidates_match_jax(request, sparse, monkeypatch):
    """Loop and relocalization candidates, the scores of a stored keyframe
    and a database carried across packages: dense, the inverted file over
    the 9991-word vocabulary pushed past the threshold, and the inverted
    file of the 97,273-word vocabulary with no threshold moved."""
    from orb_slam2_comment_tpu.models import keyframe_database as jdb
    from orb_slam2_comment_tpu.models import map_state as jms
    from orb_slam2_comment_tpu_torch.models import keyframe_database as tdb
    from orb_slam2_comment_tpu_torch.models import map_state as tms
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    if sparse is True:   # voc_synth has 9991 words: push it over the threshold
        monkeypatch.setattr(jdb, "SPARSE_W_THRESHOLD", 1000)
        monkeypatch.setattr(tdb, "SPARSE_W_THRESHOLD", 1000)
    jv, tv = request.getfixturevalue("vocs100k" if sparse == "voc100k" else "vocs")
    sparse = bool(sparse)
    r = np.random.default_rng(5)
    jm, kf_desc, pt_desc, obs = _db_map(r)
    tm = tms.from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    jd = jdb.KeyFrameDatabase(jv, 16, 256)
    td = tdb.KeyFrameDatabase(tv, 16, 256, device="cpu")
    assert jd.sparse == td.sparse == sparse
    for k in range(12):
        jd.add(k, jm.kf_desc[k], jm.kf_feat_valid[k])
        td.add(k, tm.kf_desc[k], tm.kf_feat_valid[k])
    for f in ("groups", "words", "valid"):
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))
    W = np.asarray(jms.covisibility_matrix(jm))
    np.testing.assert_array_equal(tms.covisibility_matrix(tm).numpy(), W)
    for kf in (10, 11):
        jc = jd.detect_loop_candidates(jm, kf, 0.0)
        tc = td.detect_loop_candidates(tm, kf, 0.0)
        assert tc == jc and len(jc) > 0, (tc, jc)
        # the scores and shared-word counts of a stored keyframe (the loop
        # closer's query), within f32 rounding of JAX's sum order
        (js, jn), (ts, tn) = jd.scores_device(kf_id=kf), td.scores_device(kf_id=kf)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # relocalization queries: a noisy re-observation of KF 5's and KF 11's features
    for src in (5, 11):
        q = _flip_bits(pt_desc[obs[src]], 2, r)
        valid = np.ones(len(q), bool)
        jw, _, jvec = __import__("orb_slam2_comment_tpu.ops.bow", fromlist=["x"]).transform(
            jv, jnp.asarray(q), jnp.asarray(valid))
        tw, _, tvec = tb.transform(tv, torch.from_numpy(q.view(np.int32)),
                                   torch.from_numpy(valid))
        jc = jd.detect_reloc_candidates(jvec, valid_mask=jm.kf_valid, m=jm, query_words=jw,
                                        max_out=20)
        tc = td.detect_reloc_candidates(tvec, valid_mask=tm.kf_valid, m=tm, query_words=tw,
                                        max_out=20)
        assert tc == jc and len(jc) > 0, (tc, jc)
    # the database state carries across packages
    td2 = tdb.KeyFrameDatabase.from_numpy(
        tv, {f: np.asarray(getattr(jd, f)) for f in ("bow", "sp_word", "sp_w", "groups",
                                                    "words", "valid")
             if getattr(jd, f, None) is not None}, device="cpu")
    assert td2.detect_loop_candidates(tm, 11, 0.0) == jd.detect_loop_candidates(jm, 11, 0.0)


@pytest.mark.parametrize("sparse", [False, True])
def test_database_erase_matches_jax(vocs, sparse, monkeypatch):
    """KeyFrameDatabase.erase (KeyFrameDatabase::erase) in both layouts:
    the erased keyframes leave the index (the inverted file is rebuilt)
    and the loop candidates of the revisiting keyframe equal JAX's; an add
    at a slot past the database's tier is dropped in both packages."""
    from orb_slam2_comment_tpu.models import keyframe_database as jdb
    from orb_slam2_comment_tpu_torch.models import keyframe_database as tdb
    from orb_slam2_comment_tpu_torch.models import map_state as tms

    if sparse:
        monkeypatch.setattr(jdb, "SPARSE_W_THRESHOLD", 1000)
        monkeypatch.setattr(tdb, "SPARSE_W_THRESHOLD", 1000)
    jv, tv = vocs
    jm, _, _, _ = _db_map(np.random.default_rng(5))
    tm = tms.from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    jd = jdb.KeyFrameDatabase(jv, 16, 256)
    td = tdb.KeyFrameDatabase(tv, 16, 256, device="cpu")
    for k in range(12):
        jd.add(k, jm.kf_desc[k], jm.kf_feat_valid[k])
        td.add(k, tm.kf_desc[k], tm.kf_feat_valid[k])
    before = td.detect_loop_candidates(tm, 11, 0.0)
    if sparse:
        td.postings()
    for k in (0, 1):
        jd.erase(k)
        td.erase(k)
    assert td._postings is None
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert not td.valid[:2].any() and td.valid[2:12].all()
    tc, jc = td.detect_loop_candidates(tm, 11, 0.0), jd.detect_loop_candidates(jm, 11, 0.0)
    assert tc == jc and not {0, 1} & set(tc) and tc != before
    jd.add(16, jm.kf_desc[2], jm.kf_feat_valid[2])
    td.add(16, tm.kf_desc[2], tm.kf_feat_valid[2])
    for f in ("groups", "words", "valid"):
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))
