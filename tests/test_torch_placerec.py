"""Place recognition at vocabulary scale: the port's twin of
tools/eval_vocab_pr.py (orb_slam2_comment_tpu_torch/examples/eval_vocab_pr.py)
against the JAX package on the CPU. The workload's poses equal the tool's
at its 560 keyframes; at 3 database and 3 query keyframes of the tool's
widths (640x480, 1000 x 8) the same f32 images give equal descriptors,
word ids, top-1/top-2 candidates, hits and dropped postings in both
packages, for the 9991-word vocabulary (dense database) and the
97,273-word one (the inverted file, no threshold moved), with scores
within SCORE_ATOL; and the inverted file past its posting cap gives
JAX's scores, shared-word counts and dropped postings. Opt-in (RUN_SLOW_TESTS=1): the 56-frame orbit of
chip_smoke.py's loop path through System with the 97,273-word vocabulary
in both packages, every frame read."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_KFS = 6           # 3 database and 3 query keyframes
# f32 L1 scores: the packages sum the same terms in other orders (a dense
# row sum; the inverted file's segment sum against JAX's scatter-add)
SCORE_ATOL = 1e-6
VOCS = ("voc_synth", "voc_synth_100k")


def _tool():
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    return importlib.import_module("eval_vocab_pr")


def test_workload_poses_equal_the_tools():
    """workload(560): the JAX package's room and orbit, jittered by the
    tool's draws and its _rotvec, equal bit for bit."""
    from orb_slam2_comment_tpu.utils import render as jr
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as E

    tool = _tool()
    base = jr.room_loop_trajectory(280, radius=1.6, loops=1.0)
    r = np.random.default_rng(7)
    jit = []
    for T in base:
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = tool._rotvec(r.normal(0, 0.004, 3))
        d[:3, 3] = r.normal(0, 0.05, 3)
        jit.append((d @ T).astype(np.float32))
    scene, poses = E.workload(560)
    np.testing.assert_array_equal(poses, np.concatenate([base, np.stack(jit)]))
    assert poses.shape == (560, 4, 4)
    jscene = jr.make_room(seed=3, size=(8.0, 3.0, 8.0), n_boxes=6)
    assert scene.background == jscene.background
    for a, b in zip(scene.quads, jscene.quads, strict=True):
        for f in ("origin", "eu", "ev", "tex"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert E.K == (520.0, 520.0, 320.0, 240.0)


@pytest.fixture(scope="module")
def small():
    """The workload at N_KFS keyframes rendered once by the port (its
    renderer is held to JAX's by test_port_copies_equal_jax), extracted
    from the same f32 images by both packages."""
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as E

    from orb_slam2_comment_tpu_torch.ops import orb as torb

    _, poses = E.workload(N_KFS)
    images = E.render_all(N_KFS)

    jcfg = jorb.ORBConfig(n_features=1000, n_levels=8)
    jf, jpyrs = zip(*(jorb.extract(jnp.asarray(img.astype(np.float32)), jcfg)
                      for img in images))
    td, tv, _ = E.extract_all(images, "cpu")
    return dict(poses=poses, images=images, jfeats=jf, jpyrs=jpyrs,
                jdesc=np.stack([np.asarray(f.desc) for f in jf]),
                jvalid=np.stack([np.asarray(f.valid) for f in jf]), tdesc=td, tvalid=tv)


def _bf16_tie_levels(jpyr, tpyr):
    """The pyramid levels holding a pixel whose two packages' f32 values
    round to other bf16 values (the BRIEF product's input precision)."""
    return {lvl for lvl, (a, b) in enumerate(zip(jpyr, tpyr))
            if (torch.from_numpy(np.array(a)).bfloat16() != b.bfloat16()).any()}


def test_extraction_like_jax(small):
    """orb.extract on the tool's f32 images: the same valid features,
    keypoints and octaves in both packages, and the same descriptors but
    for rows whose pyramid level holds a pixel the two packages' f32
    resizes leave one ulp apart across a bf16 rounding boundary (at most
    2 rows of the 6000, each at most 2 bits). Such a pixel enters the
    BRIEF product rounded to bf16 0.25-1 apart, which moves a product by
    a multiple of 1/128 and can flip its sign bit: a tie, not a fault."""
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    assert small["images"].dtype == np.float32 and small["images"].shape == (N_KFS, 480, 640)
    np.testing.assert_array_equal(small["tvalid"].numpy(), small["jvalid"])
    assert small["jvalid"].sum(1).min() > 500
    td = small["tdesc"].numpy().view(np.uint32)
    rows = np.argwhere((td != small["jdesc"]).any(-1))
    assert len(rows) <= 2, rows
    for i in sorted({int(i) for i, _ in rows} | {0}):
        tf, tpyr = torb.extract(torch.from_numpy(small["images"][i]), torb.ORBConfig(1000, 8))
        jf = small["jfeats"][i]
        np.testing.assert_array_equal(tf.desc.numpy().view(np.uint32), td[i])
        np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
        np.testing.assert_array_equal(tf.octave.numpy(), np.asarray(jf.octave))
        ties = _bf16_tie_levels(small["jpyrs"][i], tpyr)
        for k in rows[rows[:, 0] == i, 1]:
            bits = np.unpackbits((td[i, k] ^ small["jdesc"][i, k]).view(np.uint8)).sum()
            assert bits <= 2 and int(tf.octave[k]) in ties, (i, k, ties)


def _jax_evaluate(jvoc, descs, valids, poses):
    """tools/eval_vocab_pr.py's per-vocabulary loop over the JAX package,
    with each query's words, scores, candidates and dropped postings."""
    from orb_slam2_comment_tpu.models.keyframe_database import KeyFrameDatabase, _scores_kernel
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.examples.eval_vocab_pr import _centers_and_axes

    half = len(poses) // 2
    db = KeyFrameDatabase(jvoc, max_kfs=half, n_feat=descs.shape[1])
    for k in range(half):
        db.add(k, jnp.asarray(descs[k]), jnp.asarray(valids[k]))
    c_all, fwd_all = _centers_and_axes(poses)
    out = []
    for q in range(half, len(poses)):
        words, _, vec = jb.transform(jvoc, jnp.asarray(descs[q]), jnp.asarray(valids[q]))
        dropped = 0
        if db.sparse:
            sc, _ = db.scores_device(q_words_feat=words)
            qw, qweight = jb.sparse_bow(jvoc.word_weight, words)
            dropped = int(jb.inverted_file_query(*db.postings(), qw, qweight, kmax=half)[2])
        else:
            sc, _ = _scores_kernel(db.bow, db.valid, vec)
        sc = np.asarray(sc)[:half]
        order = np.argsort(-sc)
        d = np.linalg.norm(c_all[:half] - c_all[q], axis=1)
        ang = np.degrees(np.arccos(np.clip(fwd_all[:half] @ fwd_all[q], -1, 1)))
        good = (d < 0.35) & (ang < 12.0)
        top = int(np.argmax(sc))
        out.append(dict(q=q, words=np.asarray(words), scores=sc, top1=top,
                        top2=[int(i) for i in order[:2]],
                        hit=bool(good[top]) if good.any() else None,
                        hit2=bool(good[order[:2]].any()) if good.any() else None,
                        n_dropped=dropped))
    return db.sparse, out


@pytest.mark.parametrize("voc", VOCS)
def test_evaluation_like_jax(small, voc):
    """evaluate() against the tool's loop in JAX on the same descriptors
    (JAX's): the database mode (dense at 9991 words, the inverted file at
    97,273), every query's words, top-1, top-2, hits and dropped postings
    equal, scores within SCORE_ATOL; every query is a hit. On the port's
    own descriptors: the same top-1, top-2, hits and dropped postings."""
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as E
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET, VOC_ASSET_100K
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    tpath = VOC_ASSET if voc == "voc_synth" else VOC_ASSET_100K
    jvoc = jb.load_vocabulary(os.path.join(ROOT, "orb_slam2_comment_tpu", "assets",
                                           voc + ".npz"))
    tvoc = tb.load_vocabulary(tpath)
    sparse, jrecs = _jax_evaluate(jvoc, small["jdesc"], small["jvalid"], small["poses"])
    shared = torch.from_numpy(small["jdesc"].view(np.int32))
    res = E.evaluate(tvoc, shared, small["tvalid"], small["poses"], "cpu", keep=N_KFS)
    own = E.evaluate(tvoc, small["tdesc"], small["tvalid"], small["poses"], "cpu")
    assert sparse == (voc == "voc_synth_100k") == (res["mode"] == "sparse/inverted-file")
    assert res["n_words"] == jvoc.n_words == (97273 if sparse else 9991)
    assert len(res["records"]) == len(res["kept"]) == len(jrecs) == N_KFS // 2
    for j, t, o, kept in zip(jrecs, res["records"], own["records"], res["kept"], strict=True):
        assert t["q"] == kept["q"] == j["q"]
        np.testing.assert_array_equal(kept["words"], j["words"])
        np.testing.assert_allclose(kept["scores"], j["scores"], rtol=0, atol=SCORE_ATOL)
        for k in ("top1", "top2", "hit", "hit2", "n_dropped"):
            assert t[k] == j[k] == o[k], (k, t[k], j[k], o[k])
    assert res["queries"] == N_KFS // 2 and res["recall@1"] == 1.0 == res["recall@2"]
    assert res["n_dropped_total"] == sum(r["n_dropped"] for r in jrecs)
    assert np.isfinite(res["median_margin"]) and res["median_margin"] > 0


def test_inverted_file_past_the_cap_like_jax():
    """The 97,273-word inverted file with posting lists past the cap of 96
    (L of bow.inverted_file_query): 120 keyframes of 256 word ids, 24
    words shared by all, so that which postings survive the cap sets the
    scores. Each package builds its rows with its own sparse_bow and
    answers scores_device(q_words_feat=...): scores within SCORE_ATOL,
    equal shared-word counts and equal dropped postings (some), before
    and after erasing 30 keyframes (the lists rebuilt under the cap)."""
    from orb_slam2_comment_tpu.models import keyframe_database as jdb
    from orb_slam2_comment_tpu.ops import bow as jb
    from orb_slam2_comment_tpu_torch.models import keyframe_database as tdb
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET_100K
    from orb_slam2_comment_tpu_torch.ops import bow as tb

    jvoc = jb.load_vocabulary(os.path.join(ROOT, "orb_slam2_comment_tpu", "assets",
                                           "voc_synth_100k.npz"))
    tvoc = tb.load_vocabulary(VOC_ASSET_100K)
    kmax, n, n_kfs, W = 128, 256, 120, jvoc.n_words
    r = np.random.default_rng(11)
    shared = r.choice(W, 24, replace=False)
    words = r.integers(0, W, (kmax, n)).astype(np.int32)
    words[:, :24] = shared
    words[:, 24:40] = r.choice(shared, (kmax, 16))      # repeated shared words
    words[:, 40:][r.random((kmax, n - 40)) < 0.05] = -1  # invalid features
    jd, td = jdb.KeyFrameDatabase(jvoc, kmax, n), tdb.KeyFrameDatabase(tvoc, kmax, n, "cpu")
    assert jd.sparse and td.sparse
    for k in range(n_kfs):
        juw, jww = jb.sparse_bow(jvoc.word_weight, jnp.asarray(words[k]))
        tuw, tww = tb.sparse_bow(tvoc.word_weight, torch.from_numpy(words[k]))
        np.testing.assert_array_equal(tuw.numpy(), np.asarray(juw))
        jd.sp_word, jd.sp_w = jd.sp_word.at[k].set(juw), jd.sp_w.at[k].set(jww)
        jd.valid = jd.valid.at[k].set(True)
        td.sp_word[k], td.sp_w[k], td.valid[k] = tuw, tww, True
    queries = [words[5], words[117], r.integers(0, W, n).astype(np.int32)]
    queries.append(np.where(r.random(n) < 0.5, words[60], queries[-1]).astype(np.int32))

    def compare():
        dropped = []
        for q in queries:
            (js, jc), (ts, tc) = (jd.scores_device(q_words_feat=jnp.asarray(q)),
                                  td.scores_device(q_words_feat=torch.from_numpy(q)))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_ATOL)
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            jn = int(jb.inverted_file_query(*jd.postings(), *jb.sparse_bow(
                jvoc.word_weight, jnp.asarray(q)), kmax=kmax)[2])
            tn = int(tb.inverted_file_query(*td.postings(), *tb.sparse_bow(
                tvoc.word_weight, torch.from_numpy(q)), kmax=kmax)[2])
            assert tn == jn
            dropped.append(tn)
        return dropped

    dropped = compare()
    # each shared word's list holds 120 postings: 24 past the cap per word
    assert dropped[0] == dropped[1] == 24 * 24 and dropped[2] == 0 < dropped[3]
    for k in range(30):
        jd.erase(k)
        td.erase(k)
    assert compare() == [0, 0, 0, 0]


_SLOW = pytest.mark.skipif(os.environ.get("RUN_SLOW_TESTS", "") in ("", "0"),
                           reason="the bench-width orbit in both packages is opt-in "
                                  "(RUN_SLOW_TESTS=1); PERF.md records its result")


@_SLOW
def test_orbit_with_the_large_vocabulary_like_jax():
    """chip_smoke.py's loop path on the CPU with the 97,273-word vocabulary
    (bench config, the 56 orbit frames in sensor dtypes), every frame read,
    in both packages: the same keyframe frames, the same detections
    queued and harvested (call, keyframe, pump), the same loop pair (or
    none in both), every frame tracked."""
    import chip_smoke
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET_100K
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem

    cfg = chip_smoke.bench_config()
    frames = chip_smoke.render_orbit()
    jpath = os.path.join(ROOT, "orb_slam2_comment_tpu", "assets", "voc_synth_100k.npz")
    runs = []
    for system in (JSystem(JConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
                           vocabulary_path=jpath),
                   TSystem(cfg, vocabulary_path=VOC_ASSET_100K, device="cpu")):
        assert system.db.sparse
        runs.append(_orbit_record(system, frames))
    (j, t) = runs
    print(f"\n97k orbit: JAX loops {j['loops']} keyframes {j['n_kfs']}; port loops "
          f"{t['loops']} keyframes {t['n_kfs']}")
    assert t["states"] == j["states"] and all(s == 1 for s in t["states"])
    assert t["kf_frames"] == j["kf_frames"]
    assert t["queued"] == j["queued"] and t["harvests"] == j["harvests"]
    assert t["loops"] == j["loops"]


def _orbit_record(system, frames):
    """Track every frame (each output read) and record the states, the
    frames that made keyframes, the (call, keyframe, pump) of each
    detection queued and harvested, and the loop edges."""
    lc = system.loop_closer
    r = dict(states=[], kf_frames=[], queued=[], harvests=[])
    finish, process = lc._finish_detect, lc.process

    def record(k, *a):
        r["harvests"].append((system.frame_id, k, lc._pump_count))
        return finish(k, *a)

    def queue(k):
        r["queued"].append((system.frame_id, k, lc._pump_count))
        return process(k)

    lc._finish_detect, lc.process = record, queue
    for i, f in enumerate(frames):
        out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        r["states"].append(out.state)
        if out.created_kf:
            r["kf_frames"].append(i)
    system.shutdown()
    lc._finish_detect, lc.process = finish, process
    r["loops"] = [tuple(int(x) for x in e[:2]) for e in lc.loop_edges]
    r["n_kfs"] = system.tracker.n_kfs
    return r
