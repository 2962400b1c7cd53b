"""Loop-detection precision/recall at vocabulary scale — the port's twin
of `tools/eval_vocab_pr.py`.

Builds a place-recognition workload from the textured room renderer: two
traversals of the same room orbit (the second with pose jitter, so
revisits are near- but not exact-duplicates), extracts ORB per
"keyframe", indexes the FIRST traversal in a KeyFrameDatabase, and
queries every SECOND-traversal keyframe. A query is a hit if the
top-scoring candidate's ground-truth pose lies within (0.35 m, 12 deg) of
the query's. The database is dense for the 9991-word vocabulary and the
inverted file (keyframe_database.SPARSE_W_THRESHOLD) for the 97,273-word
one; the inverted file also reports the postings it dropped past each
query word's cap of 96 (bow.inverted_file_query).

    python -m orb_slam2_comment_tpu_torch.examples.eval_vocab_pr [n_kfs] [voc.npz ...] \\
        [--device cuda|cpu] [--cache PATH]

Rendering runs in one spawned process per core. Without vocabulary paths
it evaluates the port's two packaged ones. With
`--cache PATH` the descriptors are read from PATH if it exists and
written there otherwise; without it nothing is written.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

K = (520.0, 520.0, 320.0, 240.0)
HIT_DIST_M = 0.35
HIT_ANGLE_DEG = 12.0


def _rotvec(v):
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = v / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx
            + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


def workload(n_kfs: int):
    """(scene, poses [2 * (n_kfs // 2), 4, 4] f32): the room orbit, then
    the same orbit with every pose jittered (rotation N(0, 0.004) rad per
    axis, translation N(0, 0.05) m, drawn from default_rng(7))."""
    from orb_slam2_comment_tpu_torch.utils import render as rr

    scene = rr.make_room(seed=3, size=(8.0, 3.0, 8.0), n_boxes=6)
    base = rr.room_loop_trajectory(n_kfs // 2, radius=1.6, loops=1.0)
    r = np.random.default_rng(7)
    jit = []
    for T in base:
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = _rotvec(r.normal(0, 0.004, 3))
        d[:3, 3] = r.normal(0, 0.05, 3)
        jit.append((d @ T).astype(np.float32))
    return scene, np.concatenate([base, np.stack(jit)])


# a render worker's workload, built once by _init_worker in each process
_WORKER = {}


def _init_worker(n_kfs):
    _WORKER["workload"] = workload(n_kfs)


def _render_one(i):
    from orb_slam2_comment_tpu_torch.utils import render as rr

    scene, poses = _WORKER["workload"]
    return rr.render_quads(scene, poses[i], K)[0]


def render_all(n_kfs: int, workers: int = 1, out=None):
    """The f32 gray image (render_quads at 480x640) of every keyframe of
    workload(n_kfs), in a pool of `workers` spawned processes when
    workers > 1, each building the workload once. `out`, when given, is
    an [n, 480, 640] f32 array (e.g. a memory map) filled in place."""
    from orb_slam2_comment_tpu_torch.utils import render as rr

    if workers > 1:
        import concurrent.futures as cf
        import multiprocessing

        n = 2 * (n_kfs // 2)
        with cf.ProcessPoolExecutor(max_workers=workers,
                                    mp_context=multiprocessing.get_context("spawn"),
                                    initializer=_init_worker, initargs=(n_kfs,)) as ex:
            return _collect(ex.map(_render_one, range(n), chunksize=4), out)
    scene, poses = workload(n_kfs)
    return _collect((rr.render_quads(scene, T, K)[0] for T in poses), out)


def _collect(imgs, out):
    if out is None:
        return np.stack(list(imgs))
    for i, img in enumerate(imgs):
        out[i] = img
    return out


def extract_all(images, device, n_features: int = 1000, n_levels: int = 8):
    """orb.extract on each f32 image on `device`. Returns (descriptors
    [n, N, 8] int32, valid [n, N] bool, both on the device, and the
    extraction's ms per keyframe, resolved)."""
    from orb_slam2_comment_tpu_torch.ops import orb

    cfg = orb.ORBConfig(n_features=n_features, n_levels=n_levels)
    dev = torch.device(device)
    descs, valids = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for img in images:
        ff, _ = orb.extract(torch.from_numpy(np.array(img, np.float32)).to(dev), cfg)
        descs.append(ff.desc)
        valids.append(ff.valid)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(len(descs), 1)
    return torch.stack(descs), torch.stack(valids), ms


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _centers_and_axes(poses):
    c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])
    fwd = np.stack([T[:3, :3].T @ [0, 0, 1] for T in poses])
    return c, fwd


def evaluate(voc, descs, valids, poses, device, n_queries=None, keep: int = 0):
    """Index the first half of the keyframes in a KeyFrameDatabase on
    `device` and query each keyframe of the second half (the first
    `n_queries` of them, or all): through `scores_dense` for a dense
    database, `scores_device(q_words_feat=...)` for the inverted file.
    Returns the mode, the vocabulary's size, the queries with a true
    match, recall@1 and @2, the median margin of the best true over the
    best false score, ms per query (its BoW transform, the scores and
    their read, over every query), the largest and total postings the
    inverted file dropped, a record per query (top-1, top-2, hits,
    dropped postings), for the first `keep` queries their word ids and
    scores, and the database."""
    from orb_slam2_comment_tpu_torch.models.keyframe_database import (
        KeyFrameDatabase, scores_dense)
    from orb_slam2_comment_tpu_torch.ops import bow

    dev = torch.device(device)
    half = len(poses) // 2
    descs, valids = descs.to(dev), valids.to(dev)
    db = KeyFrameDatabase(voc, max_kfs=half, n_feat=descs.shape[1], device=dev)
    for k in range(half):
        db.add(k, descs[k], valids[k])
    c_all, fwd_all = _centers_and_axes(poses)
    end = len(poses) if n_queries is None else min(len(poses), half + n_queries)
    hits = at2 = n_q = 0
    margins, records, kept, t_query = [], [], [], 0.0
    for q in range(half, end):
        _sync(dev)
        t0 = time.perf_counter()
        words, _, vec = bow.transform(voc, descs[q], valids[q])
        if db.sparse:
            sc, _ = db.scores_device(q_words_feat=words)
        else:
            sc, _ = scores_dense(db.bow, db.valid, vec)
        sc = sc.cpu().numpy()[:half]
        t_query += time.perf_counter() - t0
        dropped = 0
        if db.sparse:
            qw, qweight = bow.sparse_bow(voc.word_weight, words)
            dropped = int(bow.inverted_file_query(*db.postings(), qw, qweight, kmax=half)[2])
        top = int(np.argmax(sc))
        order = np.argsort(-sc)
        d = np.linalg.norm(c_all[:half] - c_all[q], axis=1)
        ang = np.degrees(np.arccos(np.clip(fwd_all[:half] @ fwd_all[q], -1, 1)))
        good = (d < HIT_DIST_M) & (ang < HIT_ANGLE_DEG)
        rec = dict(q=q, top1=top, top2=[int(i) for i in order[:2]], hit=None, hit2=None,
                   n_dropped=dropped)
        if len(kept) < keep:
            kept.append(dict(q=q, words=words.cpu().numpy(), scores=sc))
        records.append(rec)
        if not good.any():
            continue
        n_q += 1
        rec["hit"], rec["hit2"] = bool(good[top]), bool(good[order[:2]].any())
        hits += rec["hit"]
        at2 += rec["hit2"]
        if (~good).any():
            margins.append(float(sc[good].max() - sc[~good].max()))
    drops = [r["n_dropped"] for r in records]
    return {"mode": "sparse/inverted-file" if db.sparse else "dense", "n_words": voc.n_words,
            "queries": n_q, "recall@1": hits / max(n_q, 1), "recall@2": at2 / max(n_q, 1),
            "median_margin": float(np.median(margins)) if margins else float("nan"),
            "ms_per_query": t_query / max(n_q, 1) * 1e3,
            "n_dropped_max": max(drops, default=0), "n_dropped_total": int(sum(drops)),
            "records": records, "kept": kept, "db": db}


def line(name: str, res: dict) -> str:
    """The tool's printed line for one vocabulary."""
    return (f"[{name}] W={res['n_words']} mode={res['mode']} "
            f"queries={res['queries']} recall@1={res['recall@1']:.3f} "
            f"recall@2={res['recall@2']:.3f} "
            f"median_margin={res['median_margin']:+.4f} "
            f"({res['ms_per_query']:.1f} ms/query)")


def default_vocabularies():
    from orb_slam2_comment_tpu_torch.models.system import VOC_ASSET, VOC_ASSET_100K

    return [VOC_ASSET, VOC_ASSET_100K]


def main(argv=None):
    from orb_slam2_comment_tpu_torch.ops import bow
    from orb_slam2_comment_tpu_torch.utils.config import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("n_kfs", nargs="?", type=int, default=560)
    ap.add_argument("vocabularies", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default=None,
                    help="read the descriptors from this .npz if it exists, else write them")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "eval_vocab_pr")
    vocs = args.vocabularies or default_vocabularies()
    _, poses = workload(args.n_kfs)
    if args.cache and os.path.exists(args.cache):
        z = np.load(args.cache)
        descs, valids = torch.from_numpy(z["descs"]), torch.from_numpy(z["valids"])
        print(f"loaded cached descriptors {args.cache}", flush=True)
    else:
        t0 = time.perf_counter()
        workers = os.cpu_count() or 1
        images = render_all(args.n_kfs, workers)
        print(f"rendered {len(images)} keyframes in {time.perf_counter() - t0:.1f} s "
              f"({workers} processes)", flush=True)
        descs, valids, ms = extract_all(images, dev)
        print(f"extracted on {dev}: {ms:.2f} ms per keyframe", flush=True)
        if args.cache:
            np.savez_compressed(args.cache, descs=descs.cpu().numpy(),
                                valids=valids.cpu().numpy())
    for vpath in vocs:
        if not os.path.exists(vpath):
            print(f"[skip] {vpath} missing", flush=True)
            continue
        res = evaluate(bow.load_vocabulary(vpath, dev), descs, valids, poses, dev)
        print(line(os.path.basename(vpath), res), flush=True)
        print(f"[{os.path.basename(vpath)}] n_dropped max={res['n_dropped_max']} "
              f"total={res['n_dropped_total']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
