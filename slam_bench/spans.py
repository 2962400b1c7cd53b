"""Arithmetic on the port's own spans and counters
(`orb_slam2_comment_tpu_torch/utils/trace.py`) in a traced run: self time
by span name, device time by the port span a kernel or copy was launched
in (through the profiler's correlation ids), idle gaps named by the port
span open at their middle, and the per-stage figures read from them.

A session's spans are one thread's (`thread_spans`): int64 `start`,
`end`, `frame`; int32 `name` (into `names`) and `parent` (an index into
the same arrays, -1 at the root); in start order, properly nested. Times
are int64 nanoseconds of the wall clock, as in reduce.py.
"""

from __future__ import annotations

import numpy as np

from slam_bench import reduce

# the per-stage figures: name -> (span names, what is summed); each is per
# frame handed in, `detect.host_ms_per_kf` per keyframe created
HOST_STAGES = {
    "extract.host_ms": ("extract",),
    "track.host_ms": ("track", "kf_create"),
    "mapper.host_ms": ("mapper.",),
}
DEVICE_STAGES = {
    "extract.device_ms": ("extract",),
    "stereo.match_device_ms": ("stereo_match",),
    "track.device_ms": ("track", "kf_create"),
    "mapper.device_ms": ("mapper.",),
}
DETECT = ("kf_callbacks", "detect.harvest")
TOP_OPS = 12   # device operations whose time is split by span
# the launches of each kernel and the spans that own them (the clock check)
OWNERS = {"K1": ("fast_nms_levels_kernel", ("extract",)),
          "K3": ("pose_lm_kernel", ("track", "host_path", "reloc")),
          "K4": ("lba_build_kernel", ("mapper.ba1", "mapper.ba2", "mapper.ba3"))}


def matches(name: str, patterns) -> bool:
    """A span name against names and prefixes (a pattern ending in '.')."""
    return any(name.startswith(p) if p.endswith(".") else name == p for p in patterns)


def thread_spans(rec: dict, thread: int) -> dict:
    """The spans of `trace.take()` recorded on one thread (all closed), in
    start order, parents re-indexed."""
    keep = np.nonzero(rec["thread"] == thread)[0]
    keep = keep[np.argsort(rec["start"][keep], kind="stable")]
    new = np.full(len(rec["start"]) + 1, -1, np.int64)   # [-1] reads -1
    new[keep] = np.arange(len(keep))
    return dict(start=rec["start"][keep], end=rec["end"][keep], name=rec["name"][keep],
                parent=new[rec["parent"][keep]].astype(np.int32), frame=rec["frame"][keep],
                names=list(rec["names"]))


def self_ns(sp: dict) -> np.ndarray:
    """Each span's duration less the time its children cover (children
    of a span on one thread run one after another)."""
    dur = sp["end"] - sp["start"]
    child = np.zeros_like(dur)
    has = sp["parent"] >= 0
    np.add.at(child, sp["parent"][has], dur[has])
    return dur - child


def innermost(sp: dict, t) -> np.ndarray:
    """Index of the innermost span open at each time t, -1 where none: the
    last span started by t, or the nearest of its ancestors still open."""
    t = np.asarray(t, np.int64)
    j = np.searchsorted(sp["start"], t, side="right") - 1
    while True:
        closed = np.zeros(len(j), bool)
        live = j >= 0
        closed[live] = sp["end"][j[live]] <= t[live]
        if not closed.any():
            return j
        j[closed] = sp["parent"][j[closed]]


def in_window(sp: dict, t0: int, t1: int) -> np.ndarray:
    """The spans that start inside [t0, t1]."""
    return (sp["start"] >= t0) & (sp["start"] <= t1)


def sums_by_name(sp: dict, values: np.ndarray, mask=None) -> dict:
    """{span name: summed values} over the spans in `mask`."""
    if mask is None:
        mask = np.ones(len(values), bool)
    acc = np.bincount(sp["name"][mask], weights=values[mask].astype(np.float64),
                      minlength=len(sp["names"]))
    return {n: float(v) for n, v in zip(sp["names"], acc) if v}


def outermost_of(sp: dict, patterns) -> np.ndarray:
    """The spans named by `patterns` with no such span among their
    ancestors (so that nested ones are not counted twice)."""
    hit = np.array([matches(n, patterns) for n in sp["names"]], bool)[sp["name"]] \
        if len(sp["name"]) else np.zeros(0, bool)
    covered = np.zeros(len(hit), bool)
    for i, p in enumerate(sp["parent"].tolist()):
        covered[i] = p >= 0 and (covered[p] or hit[p])
    return hit & ~covered


def launch_times(op_corr, launch_corr, launch_t) -> np.ndarray:
    """For each device operation, the host time of the runtime call that
    launched it (the record with the same correlation id), -1 where there
    is none."""
    op_corr = np.asarray(op_corr, np.int64)
    lc = np.asarray(launch_corr, np.int64)
    lt = np.asarray(launch_t, np.int64)
    if not len(lc):
        return np.full(len(op_corr), -1, np.int64)
    o = np.argsort(lc, kind="stable")
    lc, lt = lc[o], lt[o]
    k = np.clip(np.searchsorted(lc, op_corr), 0, len(lc) - 1)
    return np.where(lc[k] == op_corr, lt[k], -1)


def attribute(sp: dict, t_launch) -> np.ndarray:
    """The innermost span open at each launch, -1 outside every span,
    -2 where no launch record was found."""
    t_launch = np.asarray(t_launch, np.int64)
    j = innermost(sp, np.maximum(t_launch, 0))
    return np.where(t_launch < 0, -2, j)


def gap_labels(gs, ge, sessions, top: int = 10):
    """The `top` longest gaps, each named by what every session was doing
    at its middle: the benchmark's own kind (`track_call`, `resolve_wait`,
    `drain`), followed by the innermost port span open then
    (`track_call/mapper.fuse`); "between_calls" where no session was in a
    span. sessions: [(benchmark spans as reduce.open_span takes them,
    port spans or None)]."""
    order = np.argsort(-(ge - gs), kind="stable")[:top]
    out = []
    for j in order:
        mid = int((gs[j] + ge[j]) // 2)
        kinds = set()
        for bench, sp in sessions:
            kind = reduce.open_span(bench, mid)
            if kind is None:
                continue
            if sp is not None and len(sp["start"]):
                i = int(innermost(sp, [mid])[0])
                if i >= 0:
                    kind += "/" + sp["names"][sp["name"][i]]
            kinds.add(kind)
        out.append(["+".join(sorted(kinds)) if kinds else "between_calls",
                    float(ge[j] - gs[j]) / 1e9])
    return out


def bench_spans(window: dict):
    """A session's benchmark spans (track_call, resolve_wait, drain), as
    run.device_summary builds them for reduce.label_gaps."""
    s, e, k = [window["t0"], window["drain"][0:1]], [window["t1"], window["drain"][1:2]], [
        ["track_call"] * len(window["t0"]), ["drain"]]
    if window["t2"] is not None:
        s.append(window["t1"])
        e.append(window["t2"])
        k.append(["resolve_wait"] * len(window["t1"]))
    s = np.concatenate([np.asarray(v, np.int64) for v in s])
    e = np.concatenate([np.asarray(v, np.int64) for v in e])
    k = [v for part in k for v in part]
    o = np.argsort(s, kind="stable")
    return s[o], e[o], [k[j] for j in o]


def _table(names, pred) -> np.ndarray:
    """pred over a name table, with a False after it (index -1)."""
    return np.array([bool(pred(n)) for n in names] + [False], bool)


OUTSIDE, NO_RECORD = "(outside spans)", "(no launch record)"


def device_by_span(sp: dict, tr: dict, launch_corr, launch_t):
    """One session's device seconds by the span each operation was
    launched in (OUTSIDE, NO_RECORD), the same split for each operation
    name ({op: {span: s}}), and for each kernel of OWNERS its launches
    and those in its owner spans."""
    who = attribute(sp, launch_times(tr["corr"], launch_corr, launch_t))
    nid = np.where(who >= 0, sp["name"][np.maximum(who, 0)], -1)
    labels = list(sp["names"]) + [NO_RECORD, OUTSIDE]   # index -2, -1
    col = np.where(who >= 0, nid, len(labels) + np.maximum(who, -2))
    dur = (tr["end"] - tr["start"]).astype(np.float64) / 1e9
    n_l = len(labels)
    acc = np.bincount(tr["name"].astype(np.int64) * n_l + col, weights=dur,
                      minlength=len(tr["names"]) * n_l).reshape(len(tr["names"]), n_l)
    by_op = {op: {labels[c]: float(row[c]) for c in np.nonzero(row)[0]}
             for op, row in zip(tr["names"], acc) if row.any()}
    out = {labels[c]: float(v) for c, v in enumerate(acc.sum(0)) if v}
    owned = {}
    for k, (kernel, owners) in OWNERS.items():
        mine = _table(tr["names"], lambda n: kernel in n)[tr["name"]]
        hit = _table(sp["names"], lambda n: matches(n, owners))[nid]   # -1 reads False
        owned[k] = (int((mine & hit).sum()), int(mine.sum()))
    return out, owned, int((who == -2).sum()), by_op


def stages(run: dict) -> dict:
    """Per-stage figures of a traced run whose sessions carry `stages`
    (the port's spans, counter deltas, launch records, sync sites and
    garbage collections): the nine per-stage metrics (device ones only
    with a device trace), host self time and device time by span name (ms
    per frame), counters per frame, the clock check (share of each
    kernel's launches in its owner spans), the sync-debug warnings by site
    and by innermost span, collection time by generation, the self time
    of `call` against the call's own clock, and the idle gaps named by
    port spans. None when no session carries spans."""
    wins = [x for x in run["sessions"] if (x.get("stages") or {}).get("spans")]
    frames = run["frames"]
    if not wins or not frames:
        return None
    t0, t1 = run["t_go"], run["t_end"]
    kf = sum(x["kf_created"] for x in run["sessions"])
    host, total, dev, counts, owned, by_op = {}, {}, {}, {}, {}, {}
    syncs_site, syncs_span, gc_ns, gc_n = {}, {}, {}, {}
    detect_ns = n_spans = no_record = n_ops = 0
    for x in wins:
        st, sp = x["stages"], x["stages"]["spans"]
        inw = in_window(sp, t0, t1)
        n_spans += int(inw.sum())
        for k, v in sums_by_name(sp, self_ns(sp), inw).items():
            host[k] = host.get(k, 0.0) + v
        for k, v in sums_by_name(sp, sp["end"] - sp["start"], inw).items():
            total[k] = total.get(k, 0.0) + v
        detect_ns += int((sp["end"] - sp["start"])[outermost_of(sp, DETECT) & inw].sum())
        for k, v in st["counters"].items():
            counts[k] = counts.get(k, 0) + v
        for t_a, t_b, g in np.asarray(st.get("gc", np.zeros((0, 3))), np.int64).tolist():
            if t0 <= t_a <= t1:
                gc_ns[g] = gc_ns.get(g, 0) + t_b - t_a
                gc_n[g] = gc_n.get(g, 0) + 1
        for (site, name), n in sync_sites(st, sp).items():
            syncs_site[site] = syncs_site.get(site, 0) + n
            syncs_span[name] = syncs_span.get(name, 0) + n
        tr = x.get("trace")
        if tr is None or "corr" not in tr:
            continue
        d, o, miss, ops = device_by_span(sp, tr, st["launch_corr"], st["launch_t"])
        for k, v in d.items():
            dev[k] = dev.get(k, 0.0) + v
        for op, split in ops.items():
            acc = by_op.setdefault(op, {})
            for k, v in split.items():
                acc[k] = acc.get(k, 0.0) + v
        for k, (a, b) in o.items():
            acc = owned.setdefault(k, [0, 0])
            acc[0] += a
            acc[1] += b
        no_record += miss
        n_ops += len(tr["corr"])
    ms_frame = 1e-6 / frames
    metrics = {name: sum(v for k, v in host.items() if matches(k, pats)) * ms_frame
               for name, pats in HOST_STAGES.items()}
    if kf:
        metrics["detect.host_ms_per_kf"] = detect_ns * 1e-6 / kf
    metrics["pipeline.transfer_wait_ms"] = sum(
        v for k, v in host.items() if k.startswith("transfer_wait.")) * ms_frame
    for name, pats in DEVICE_STAGES.items():
        v = sum(s for k, s in dev.items() if matches(k, pats))
        if v:
            metrics[name] = v * 1e3 / frames
    call_ms = sum(float((x["t1"] - x["t0"]).sum()) for x in run["sessions"]) / 1e6 / frames
    out = dict(
        metrics=metrics,
        host_self_ms_per_frame={k: v * ms_frame for k, v in sorted(
            host.items(), key=lambda kv: -kv[1])},
        host_total_ms_per_frame={k: v * ms_frame for k, v in sorted(
            total.items(), key=lambda kv: -kv[1])},
        device_ms_per_frame={k: v * 1e3 / frames for k, v in sorted(
            dev.items(), key=lambda kv: -kv[1])},
        top_ops_by_span={op[:120]: {k: v * 1e3 / frames for k, v in sorted(
            split.items(), key=lambda kv: -kv[1])} for op, split in sorted(
                by_op.items(), key=lambda kv: -sum(kv[1].values()))[:TOP_OPS]},
        counters_per_frame={k: v / frames for k, v in sorted(counts.items())},
        bench_call_ms=call_ms,
        call_self_pct=100.0 * host.get("call", 0.0) * ms_frame / call_ms if call_ms else None,
        clock_check={k: (a / b if b else None) for k, (a, b) in owned.items()},
        kernel_launches={k: b for k, (a, b) in owned.items()},
        ops_without_launch_record=[no_record, n_ops],
        syncs_by_site=dict(sorted(syncs_site.items(), key=lambda kv: -kv[1])),
        syncs_by_span=dict(sorted(syncs_span.items(), key=lambda kv: -kv[1])),
        gc_ms_per_frame={f"gen{g}": v * ms_frame for g, v in sorted(gc_ns.items())},
        gc_collections={f"gen{g}": v for g, v in sorted(gc_n.items())},
        spans_per_frame=n_spans / frames,
        dropped=sum(x["stages"]["dropped"] for x in wins))
    if run.get("device") is not None:
        starts = np.concatenate([x["trace"]["start"] for x in run["sessions"]])
        ends = np.concatenate([x["trace"]["end"] for x in run["sessions"]])
        gs, ge = reduce.gaps(starts, ends, t0, t1)
        out["idle_gaps"] = gap_labels(gs, ge, [
            (bench_spans(x), (x.get("stages") or {}).get("spans")) for x in run["sessions"]])
    return out


def sync_sites(st: dict, sp: dict) -> dict:
    """{(file:line, innermost port span): warnings} of one session's
    sync-debug warnings."""
    t = np.asarray(st["sync_t"], np.int64)
    if not len(t):
        return {}
    j = innermost(sp, t) if len(sp["start"]) else np.full(len(t), -1)
    out = {}
    for site, i in zip(st["sync_site"], j.tolist()):
        key = (site, sp["names"][sp["name"][i]] if i >= 0 else "(none)")
        out[key] = out.get(key, 0) + 1
    return out
