"""The port's whole RGB-D slice against the JAX package on the CPU:
System.track_rgbd over a forward synthetic sequence (the config of
tests/test_determinism.py) in both packages, relocalization of a lost
tracker, loop closing on the orbit of tests/test_loop_closing.py, plus the
port's determinism, its refusal of configurations outside the slice, and
its independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_FRAMES = 22
N_RERUN = 12


def _cfg_kw():
    from orb_slam2_comment_tpu.utils import synthetic as syn

    K = syn.DEFAULT_K
    return dict(sensor="rgbd", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                bf=K[0] * syn.DEFAULT_BASELINE, n_features=500, n_levels=4,
                max_keyframes=32, max_points=8192, grow_capacity=False, match_th_scale=1.5)


def _run(system, frames):
    recs = []
    for f in frames:
        out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
        recs.append((out.state, out.n_inliers, out.created_kf,
                     None if out.Tcw is None else np.asarray(out.Tcw, np.float64)))
    system.shutdown()
    return recs


@pytest.fixture(scope="module")
def runs():
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    scene = syn.make_scene(n_points=2000, seed=0, extent=(8.0, 5.0, 8.0), z_near=1.0)
    poses = syn.make_trajectory("forward", n_frames=N_FRAMES, step=0.03)
    frames = list(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, depth=True))
    # reading out.state resolves each frame before the next one, so the
    # JAX pipeline runs in the same order as the port's synchronous tracker
    js = JSystem(JConfig(**_cfg_kw()), enable_loop_closing=False)
    jrec = _run(js, frames)
    ts = TSystem(TConfig(**_cfg_kw()), enable_loop_closing=False, device="cpu")
    trec = _run(ts, frames)
    ts2 = TSystem(TConfig(**_cfg_kw()), enable_loop_closing=False, device="cpu")
    trec2 = _run(ts2, frames[:N_RERUN])
    return frames, (js, jrec), (ts, trec), trec2


def test_slice_tracks_like_jax(runs):
    """Every frame tracked in both, the same keyframes, per-frame
    translations within 1 mm and ATE within 0.5 mm of JAX's. Not exact: the
    pyramid resize products and the LM/BA sums round differently in the
    two frameworks (observed: translations agree to ~3e-5 m, equal inlier
    counts and keyframe frames)."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    frames, (js, jrec), (ts, trec), _ = runs
    assert all(r[0] == 1 for r in jrec) and all(r[0] == 1 for r in trec)
    assert [r[2] for r in trec] == [r[2] for r in jrec]
    assert ts.tracker.n_kfs == js.tracker.n_kfs >= 3
    dt = max(np.abs(a[3][:3, 3] - b[3][:3, 3]).max() for a, b in zip(trec, jrec))
    assert dt <= 1e-3, dt
    n_inl_diff = max(abs(a[1] - b[1]) for a, b in zip(trec, jrec))
    assert n_inl_diff <= 5, n_inl_diff
    gt = [f["Tcw_gt"] for f in frames]
    ate_t = ate_rmse([r[3] for r in trec], gt)
    ate_j = ate_rmse([r[3] for r in jrec], gt)
    assert ate_t <= ate_j + 5e-4, (ate_t, ate_j)
    assert ate_t < 0.02


def test_slice_is_deterministic(runs):
    _, _, (_, trec), trec2 = runs
    for a, b in zip(trec[:N_RERUN], trec2):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])


def test_relocalization_like_jax(runs):
    """A tracker forced LOST (as tests/test_system.py:88-104 does) gets a
    previously seen view: both packages relocalize it, translations within
    1e-3 m and inliers within 5. The frame goes to the tracker directly:
    System.track_rgbd would first auto-reset this map of <= 5 keyframes."""
    from orb_slam2_comment_tpu.models.tracking import LOST

    frames, (js, _), (ts, _), _ = runs
    f = frames[8]
    outs = []
    for sys_ in (js, ts):
        sys_.tracker.state = LOST
        sys_.tracker.velocity = None
        outs.append(sys_.tracker.track_rgbd_arrays(N_FRAMES + 1, 99.0, f["image"], f["depth"]))
    jo, to = outs
    assert jo.state == 1 and to.state == 1
    dt = np.abs(np.asarray(to.Tcw)[:3, 3] - np.asarray(jo.Tcw)[:3, 3]).max()
    assert dt <= 1e-3, dt
    assert abs(to.n_inliers - jo.n_inliers) <= 5
    assert np.linalg.norm(np.asarray(to.Tcw)[:3, 3] - f["Tcw_gt"][:3, 3]) < 0.02


def _orbit_pair(lagged: bool):
    """The orbit of tests/test_loop_closing.py at its widths (600 x 4, 80
    KFs, 24576 points, fused tracking), default System with loop closing,
    in both packages: every frame's output read as it returns, or (lagged)
    each frame resolved and read `pipeline_lag` calls after it arrives
    (`_flush_upto(i - lag)`, as bench.py's warm-up does). Besides the
    poses, records the (call, keyframe, pump) of every detection queued
    and harvested, the frames that made keyframes and the port's side
    slots (the detection packs riding the stats batches)."""
    from orb_slam2_comment_tpu.models.system import System as JSystem
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig as JConfig
    from orb_slam2_comment_tpu_torch.models.system import System as TSystem
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig as TConfig

    kw = dict(_cfg_kw(), n_features=600, max_keyframes=80, max_points=24576)
    scene = syn.make_scene(n_points=1800, seed=0, extent=(14.0, 8.0, 20.0))
    base = syn.make_trajectory("orbit", n_frames=44)
    frames = list(syn.render_sequence(scene, np.concatenate([base, base[:12]]),
                                      K=syn.DEFAULT_K, depth=True))
    res = []
    for system in (JSystem(JConfig(**kw)), TSystem(TConfig(**kw), device="cpu")):
        lc = system.loop_closer
        r = dict(system=system, est=[], gt=[], lost=[], states=[], harvests=[], queued=[],
                 sides=[], kf_frames=[])
        finish, process = lc._finish_detect, lc.process

        def record(k, *a, system=system, r=r, finish=finish):
            r["harvests"].append((system.frame_id, k, system.loop_closer._pump_count))
            return finish(k, *a)

        def queue(k, system=system, r=r, process=process):
            r["queued"].append((system.frame_id, k, system.loop_closer._pump_count))
            return process(k)

        lc._finish_detect, lc.process = record, queue
        if isinstance(system, TSystem):
            enq = system.tracker.enqueue_side

            def enqueue(*a, enq=enq, r=r):
                r["sides"].append(enq(*a))
                return r["sides"][-1]

            system.tracker.enqueue_side = enqueue

        def read(i, out, r=r):
            r["states"].append(out.state)
            if out.created_kf:
                r["kf_frames"].append(i)
            if out.Tcw is None:
                r["lost"].append(i)
            else:
                r["est"].append(np.asarray(out.Tcw, np.float64))
                r["gt"].append(frames[i]["Tcw_gt"])

        outs, lag = [], system.cfg.pipeline_lag
        for i, f in enumerate(frames):
            outs.append(system.track_rgbd(f["image"], f["depth"], f["timestamp"]))
            if not lagged:
                read(i, outs[-1])
            elif i >= lag:
                system.tracker._flush_upto(i - lag)
                read(i - lag, outs[i - lag])
        system.shutdown()
        if lagged:
            for i in range(max(len(frames) - lag, 0), len(frames)):
                read(i, outs[i])
        lc._finish_detect, lc.process = finish, process
        res.append(r)
    return res


@pytest.fixture(scope="module")
def orbit_runs():
    """_orbit_pair with every output read as it returns."""
    return _orbit_pair(lagged=False)


def test_orbit_closes_the_same_loop_as_jax(orbit_runs):
    """The orbit with loop closing: both packages close a loop on the same
    keyframe pair, lose the same frames, and reach ATEs within 5 mm of
    each other."""
    from orb_slam2_comment_tpu_torch.utils.trajectory import ate_rmse

    res = []
    for r in orbit_runs:
        system = r["system"]
        assert system.n_loops >= 1
        pair = tuple(system.loop_closer.loop_edges[0][:2])
        res.append((pair, r["lost"], ate_rmse(r["est"], r["gt"]), system.tracker.n_kfs))
    (jpair, jlost, jate, jk), (tpair, tlost, tate, tk) = res
    assert tpair == jpair, (tpair, jpair)
    assert tlost == jlost, (tlost, jlost)
    assert abs(tate - jate) < 5e-3, (tate, jate)
    assert tate < 0.10


def test_orbit_harvests_wait_for_landed_transfers_like_jax(orbit_runs):
    """The orbit's loop detections in the asynchronous pipeline (every
    output read, so JAX's pull futures are settled at each read): the
    detection packs ride the stats batches (every side slot done), a pack
    is harvested at least 4 pumps after it was queued (but at shutdown,
    which forces them), and the call and pump of every queueing and
    harvest, its keyframe and the per-frame states equal JAX's."""
    j, t = orbit_runs
    assert t["harvests"] == j["harvests"] and len(t["harvests"]) >= 3
    assert t["queued"] == j["queued"] and t["states"] == j["states"]
    assert t["sides"] and all(s.done() for s in t["sides"])
    born = {k: p for _, k, p in t["queued"]}
    n = len(t["states"])
    assert all(p - born[k] >= 4 for c, k, p in t["harvests"] if c < n)


@pytest.mark.skipif(os.environ.get("RUN_SLOW_TESTS", "") in ("", "0"),
                    reason="a second orbit in both packages is opt-in (RUN_SLOW_TESTS=1); "
                           "PERF.md records its result")
def test_lagged_orbit_harvests_like_jax():
    """The orbit resolved `pipeline_lag` frames late in both packages (the
    side channel under bench.py's flush schedule): the call and pump of
    every detection queued and harvested, its keyframe, the frames that
    made keyframes, the per-frame states and the loop pair equal JAX's,
    every side slot landed, and a pack is harvested at least 4 pumps after
    it was queued (but at shutdown)."""
    j, t = _orbit_pair(lagged=True)
    assert t["harvests"] == j["harvests"] and len(t["harvests"]) >= 3
    assert t["queued"] == j["queued"] and t["states"] == j["states"]
    assert t["kf_frames"] == j["kf_frames"]
    assert t["sides"] and all(s.done() for s in t["sides"])
    pairs = [tuple(r["system"].loop_closer.loop_edges[0][:2]) if r["system"].n_loops else None
             for r in (j, t)]
    assert pairs[0] == pairs[1] and pairs[0] is not None, pairs
    born = {k: p for _, k, p in t["queued"]}
    n = len(t["states"])
    assert all(p - born[k] >= 4 for c, k, p in t["harvests"] if c < n)
    print(f"\nlagged orbit: loop {pairs[1]}, {len(t['harvests'])} harvests, keyframes at "
          f"{t['kf_frames']}")


def test_detection_pack_with_no_frame_pending(orbit_runs):
    """A keyframe's detection queued when the pipeline holds no frame (after
    shutdown) rides no stats batch: 4 pumps later it is still not
    harvested, because its transfer has not landed; forcing the harvest
    ships it alone, as JAX's `_force_side` does, and the harvested pack
    equals the pack computed on the device; both packages do the same."""
    from orb_slam2_comment_tpu_torch.models import loop_closing as tlc

    got = {}
    for name, r in zip(("jax", "port"), orbit_runs):
        system = r["system"]
        lc, t = system.loop_closer, system.tracker
        assert not (t._pending or t._stageA or t._upQ or t._batchQ)
        kf = t.n_kfs - 1
        lc.last_loop_kf = -(1 << 30)
        seen = []
        finish = lc._finish_detect
        lc._finish_detect = lambda k, W, s, c, v: seen.append((k, W, s, c, v)) or False
        lc.process(kf)
        slot = lc._detect_q[-1][2]
        lc._pump_count += 4
        lc._drain_detect(force=False)
        pending = (len(lc._detect_q), slot.done(), len(t._sideQ), len(seen))
        lc._drain_detect(force=True)
        lc._finish_detect = finish
        got[name] = (pending, seen, len(t._sideQ))
    assert got["port"][0] == got["jax"][0] == (1, False, 1, 0)
    assert got["port"][2] == got["jax"][2] == 0
    (k, W, s, c, v), = got["port"][1]
    (kj, Wj, sj, cj, vj), = got["jax"][1]
    ts = orbit_runs[1]["system"]
    sc, cm = tlc.scores_dense(ts.db.bow, ts.db.valid, ts.db.bow[k])
    P = tlc._detect_pack(ts.tracker.map, sc, cm).numpy()
    K = P.shape[0]
    np.testing.assert_array_equal(W, P[:, :K].astype(np.int32))
    np.testing.assert_array_equal(v, P[:, K + 2] > 0.5)
    assert k == kj and W.shape == Wj.shape
    np.testing.assert_array_equal(v, vj)


def test_slice_refuses_what_it_does_not_port():
    """A sensor the port does not run raises; the monolithic mapper, the
    staged ladder, capacity growth and localization-only mode are
    admitted."""
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    base = dict(_cfg_kw(), max_keyframes=8, max_points=1024)
    with pytest.raises(NotImplementedError):
        System(SlamConfig(**dict(base, sensor="rgbd_imu")), device="cpu")
    for kw in (dict(chunked_mapper=False), dict(fused_tracking=False)):
        s = System(SlamConfig(**dict(base, **kw)), device="cpu")
        assert s.mapper.process in s.tracker.new_kf_callbacks
    assert System(SlamConfig(**dict(base, localization_only=True)),
                  device="cpu").cfg.localization_only
    assert System(SlamConfig(**dict(base, grow_capacity=True)), device="cpu").cfg.grow_capacity


def test_system_needs_cuda_unless_told_cpu():
    """No silent CPU fallback: the default device is CUDA, and without one
    System(cfg) raises; device="cpu" builds the default (loop-closing)
    system."""
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    cfg = SlamConfig(**dict(_cfg_kw(), max_keyframes=8, max_points=1024))
    if torch.cuda.is_available():
        assert System(cfg).tracker.map.kf_pose.is_cuda
    else:
        with pytest.raises(RuntimeError):
            System(cfg)
    s = System(cfg, device="cpu")
    assert s.loop_closer is not None and s.db is not None


@pytest.mark.parametrize("which", ["tracker", "database"])
def test_public_classes_need_cuda_unless_told_cpu(which):
    """Tracker and KeyFrameDatabase default to the card as System does:
    without one they raise, and device="cpu" builds them on the CPU."""
    from orb_slam2_comment_tpu_torch.models.keyframe_database import KeyFrameDatabase
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET
    from orb_slam2_comment_tpu_torch.models.tracking import Tracker
    from orb_slam2_comment_tpu_torch.ops import bow
    from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

    cfg = SlamConfig(**dict(_cfg_kw(), max_keyframes=8, max_points=1024))
    if which == "tracker":
        def build(**kw):
            return Tracker(cfg, **kw).map.kf_pose
    else:
        voc = bow.load_vocabulary(VOC_ASSET)

        def build(**kw):
            return KeyFrameDatabase(voc, 8, 64, **kw).valid
    if torch.cuda.is_available():
        assert build().is_cuda
    else:
        with pytest.raises(RuntimeError):
            build()
    assert build(device="cpu").device.type == "cpu"


def test_port_never_imports_jax():
    """In a fresh process, import every module of the port, chip_smoke and
    its prev_kernels, load both packaged vocabularies, build the
    place-recognition workload and render a frame: no jax module is
    loaded, no loaded module's file and no opened file lies in the JAX
    package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, os, pkgutil, sys\n"
        "ref = os.path.join(os.getcwd(), 'orb_slam2_comment_tpu') + os.sep\n"
        "opened = []\n"
        "def hook(ev, args):\n"
        "    if ev == 'open' and isinstance(args[0], str) and "
        "os.path.abspath(args[0]).startswith(ref):\n"
        "        opened.append(args[0])\n"
        "sys.addaudithook(hook)\n"
        "import orb_slam2_comment_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, prev_kernels\n"
        "from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr\n"
        "from orb_slam2_comment_tpu_torch.ops import bow\n"
        "from orb_slam2_comment_tpu_torch.utils import synthetic as syn\n"
        "for path in eval_vocab_pr.default_vocabularies():\n"
        "    bow.load_vocabulary(path)\n"
        "eval_vocab_pr.workload(4)\n"
        "scene = syn.make_scene(n_points=50, seed=0)\n"
        "syn.render(scene, syn.make_trajectory('forward', 2)[1], syn.DEFAULT_K, (48, 64))\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'orb_slam2_comment_tpu' not in sys.modules\n"
        "files = [getattr(m, '__file__', None) or '' for m in list(sys.modules.values())]\n"
        "bad = [f for f in files if os.path.abspath(f).startswith(ref)]\n"
        "assert not bad, bad\n"
        "assert not opened, opened\n"
        "print(len(files))\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _same_constants():
    from orb_slam2_comment_tpu import constants as J
    from orb_slam2_comment_tpu_torch import constants as T

    names = sorted(k for k in vars(T) if k.isupper())
    assert names == sorted(k for k in vars(J) if k.isupper())
    for k in names:
        assert getattr(T, k) == getattr(J, k) and type(getattr(T, k)) is type(getattr(J, k)), k


def _same_frames():
    from orb_slam2_comment_tpu.utils import synthetic as J
    from orb_slam2_comment_tpu_torch.utils import synthetic as T

    for name in ("DEFAULT_K", "DEFAULT_HW", "DEFAULT_BASELINE"):
        assert getattr(T, name) == getattr(J, name)
    hw = (96, 128)
    for kind in ("forward", "orbit", "circle_translate", "jitter"):
        np.testing.assert_array_equal(T.make_trajectory(kind, 3, seed=2),
                                      J.make_trajectory(kind, 3, seed=2))
    js, ts = J.make_scene(n_points=150, seed=1), T.make_scene(n_points=150, seed=1)
    for f in ("points", "e1", "e2", "normal", "half_m", "texture"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    poses = J.make_trajectory("forward", 3, step=0.05)
    for kw in (dict(depth=True), dict(stereo=True)):
        for a, b in zip(T.render_sequence(ts, poses, hw=hw, **kw),
                        J.render_sequence(js, poses, hw=hw, **kw)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _same_trajectory_eval():
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils import trajectory as J
    from orb_slam2_comment_tpu_torch.utils import trajectory as T

    r = np.random.default_rng(3)
    gt = syn.make_trajectory("orbit", 12)
    est = gt.astype(np.float64)
    est[:, :3, 3] += r.normal(0, 0.01, (12, 3))
    for align in ("first", "umeyama"):
        assert T.ate_rmse(est, gt, align) == J.ate_rmse(est, gt, align)
    src, dst = r.normal(size=(20, 3)), r.normal(size=(20, 3))
    for scale in (False, True):
        a, (s, R, t) = T.umeyama_align(src, dst, scale)
        b, (s2, R2, t2) = J.umeyama_align(src, dst, scale)
        np.testing.assert_array_equal(a, b)
        assert s == s2
        np.testing.assert_array_equal(R, R2)
        np.testing.assert_array_equal(t, t2)


def _same_vocabulary():
    import orb_slam2_comment_tpu
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET

    ref = os.path.join(os.path.dirname(orb_slam2_comment_tpu.__file__), "assets",
                       "voc_synth.npz")
    with open(VOC_ASSET, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def _same_vocabulary_100k():
    """The 97,273-word vocabulary, whose database is the inverted file."""
    import orb_slam2_comment_tpu
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET_100K

    ref = os.path.join(os.path.dirname(orb_slam2_comment_tpu.__file__), "assets",
                       "voc_synth_100k.npz")
    with open(VOC_ASSET_100K, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def _same_vocab_pr_workload():
    """The jitter rotation of tools/eval_vocab_pr.py, in the port's
    examples/eval_vocab_pr.py (its poses: tests/test_torch_placerec.py)."""
    from orb_slam2_comment_tpu_torch.examples import eval_vocab_pr as T

    _same_source(_tools_module("eval_vocab_pr"), T, ("_rotvec",))


def _same_vocab_training():
    from orb_slam2_comment_tpu.ops import bow as J
    from orb_slam2_comment_tpu_torch.ops import bow as T

    r = np.random.default_rng(5)
    desc = r.integers(0, 2 ** 32, (600, 8), dtype=np.uint64).astype(np.uint32)
    for kw in (dict(k=8, depth=3, seed=0), dict(k=5, depth=2, levels_up=1, seed=3, iters=4)):
        a, b = J.train_vocabulary(desc, **kw), T.train_vocabulary(desc, **kw)
        for f in ("children", "node_word", "word_weight"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), f)
        np.testing.assert_array_equal(b.node_desc.numpy().view(np.uint32), np.asarray(a.node_desc))
        assert (b.group_depth, b.depth, b.k) == (a.group_depth, a.depth, a.k)
    bits = r.integers(0, 2, (7, 256)).astype(np.uint8)
    np.testing.assert_array_equal(T._majority(bits), J._majority(bits))
    np.testing.assert_array_equal(T._hamming_np(bits, bits[::-1]), J._hamming_np(bits, bits[::-1]))


def _same_vocab_text():
    import tempfile

    from orb_slam2_comment_tpu.ops import bow as J
    from orb_slam2_comment_tpu_torch.ops import bow as T

    r = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "voc.txt")
        with open(p, "w") as f:
            f.write("4 2 0 0\n")
            for i in range(20):
                row = [i // 4, int(i >= 4), *r.integers(0, 256, 32), f"{r.random():.6f}"]
                f.write(" ".join(str(v) for v in row) + "\n")
        # the port's vectorized tokenizer against the reference's line parser
        for x, y in zip(J._parse_orb_vocab_py(p), T._parse_orb_vocab(p), strict=True):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        with open(p) as f:
            lines = f.readlines()
        # a short node line, and a token that is no number at the start of
        # the third node (where the number stream would stop at 2 x 35), are
        # refused rather than read misaligned or cut short
        cut = lines[3]
        for bad in (lines + ["1 0 5\n"], lines[:3] + ["x" + cut[cut.index(" "):]] + lines[4:]):
            with open(p, "w") as f:
                f.writelines(bad)
            with pytest.raises(ValueError):
                T._parse_orb_vocab(p)


def _same_source(jmod, tmod, names):
    import inspect

    for name in names:
        assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(
            getattr(jmod, name)), name


def _same_settings_readers():
    from orb_slam2_comment_tpu.utils import config as J
    from orb_slam2_comment_tpu_torch.utils import config as T

    _same_source(J, T, ("load_yaml_settings", "load_rectification"))


def _same_dataset_readers():
    from orb_slam2_comment_tpu.utils import datasets as J
    from orb_slam2_comment_tpu_torch.utils import datasets as T

    _same_source(J, T, ("SequenceItem", "load_tum_mono", "load_tum_rgbd", "load_kitti",
                        "load_euroc", "stereo_rectify_maps", "remap"))


def _same_renderer():
    """Every function, class and constant of the renderer but its two PNG
    writers, which go through the port's codec."""
    import inspect

    from orb_slam2_comment_tpu.utils import render as J
    from orb_slam2_comment_tpu_torch.utils import render as T

    names = [k for k, v in vars(J).items() if not k.startswith("__")
             and getattr(v, "__module__", None) == J.__name__]
    assert len(names) > 15 and {"_write_png_gray8", "_write_png_gray16"} <= set(names)
    _same_source(J, T, [k for k in names if not k.startswith("_write_png")])
    assert [k for k, v in vars(T).items() if inspect.isfunction(v) or inspect.isclass(v)
            if v.__module__ == T.__name__] == names
    assert T.DEPTH_FACTOR_TUM == J.DEPTH_FACTOR_TUM


def _same_ar():
    """utils/ar.py is a verbatim copy."""
    import inspect

    from orb_slam2_comment_tpu.utils import ar as J
    from orb_slam2_comment_tpu_torch.utils import ar as T

    assert inspect.getsource(T) == inspect.getsource(J)


def _tools_module(name):
    import importlib

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    return importlib.import_module(name)


def _same_dataset_makers():
    """The three sequence makers of tools/make_datasets.py and their
    intrinsics, in the port's examples/make_datasets.py."""
    from orb_slam2_comment_tpu_torch.examples import make_datasets as T

    J = _tools_module("make_datasets")
    _same_source(J, T, ("make_room_loop", "make_desk", "make_street"))
    for k in ("K_TUM", "HW_TUM", "K_KITTI", "HW_KITTI", "BASELINE_KITTI"):
        assert getattr(T, k) == getattr(J, k), k
    assert list(T.ALL) == list(J.ALL)


def _same_h2h_evaluation():
    """The trajectory readers and evaluators of tools/head_to_head.py, in
    the port's examples/head_to_head.py."""
    from orb_slam2_comment_tpu_torch.examples import head_to_head as T

    J = _tools_module("head_to_head")
    _same_source(J, T, ("load_tum_traj", "load_kitti_traj", "associate", "evaluate_ate",
                        "eval_tum", "eval_kitti"))
    assert T.SEQS == J.SEQS


@pytest.mark.parametrize("check", [_same_constants, _same_frames, _same_trajectory_eval,
                                   _same_vocabulary, _same_vocabulary_100k,
                                   _same_vocab_training, _same_vocab_text,
                                   _same_settings_readers, _same_dataset_readers,
                                   _same_renderer, _same_ar, _same_dataset_makers,
                                   _same_h2h_evaluation, _same_vocab_pr_workload],
                         ids=lambda f: f.__name__[6:])
def test_port_copies_equal_jax(check):
    """The port's own copies of the JAX package's numpy-only modules and of
    its vocabulary stay equal to the originals."""
    check()
