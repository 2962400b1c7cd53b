#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json (at the root of the checkout) that
names a configuration (`slam_bench/configs/<name>.json`) and a traffic mix
(`slam_bench/traffic/<name>.json`). The run builds the port's kernels
once, spawns one process per session of the mix (`session.py`), waits
until every session has rendered its frames and warmed up, starts them
together, and measures `--seconds` of closed-loop tracking. With
`--trace 0` the last line of standard output holds the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, each read by
`slam_bench/metrics/<name>.py`. `correct` holds each session's timed
outputs against the plain reference (`reference/judge.py`) under the
limits of `slam_bench/limits/<workload>.json`; the numbers compared and
their limits are the last lines of standard error and the last key of
the result. `--control 1` also reports what the reference one precision
down reads in the program's place, and whether the limits pass it
(`control_correct`; used to set the limits, the benchmark's own runs do
not pass it).

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), when a session fails before its window, or when
JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import multiprocessing as mp  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from multiprocessing.connection import wait  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
READY_TIMEOUT_S = 900
CHECK_TIMEOUT_S = 300


class Bench:
    """The benchmark's files as BENCHMARK.json names them, found by name."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def cell(self, workload: str):
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = json.loads((self.root / conf["file"]).read_text())
        from slam_bench import traffic

        mix = traffic.load_mix(self.dir / "traffic" / f"{w['traffic']}.json")
        return w, config, mix

    def metrics(self, workload: str, kind: str):
        """(name, unit, reader) of the cell's metrics of one kind."""
        out = []
        for m in self.spec[kind]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            reader = None
            if kind == "per_layer":
                path = self.dir / "metrics" / f"{m['name']}.py"
                sp = importlib.util.spec_from_file_location(f"slam_bench_metric_{m['name']}", path)
                mod = importlib.util.module_from_spec(sp)
                sp.loader.exec_module(mod)
                reader = mod.read
            out.append((m["name"], m["unit"], reader))
        return out


def smi():
    """The card's name, power limit and maximum SM clock (nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.splitlines()[0]
        name, limit, clock = (v.strip() for v in out.split(","))
        return dict(name=name, power_limit_w=float(limit), max_sm_clock_mhz=float(clock))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _recv_all(conns, tag: str, timeout: float):
    """One message of kind `tag` from every session, in session order;
    an error or a dead session raises."""
    got = {}
    deadline = time.time() + timeout
    while len(got) < len(conns):
        left = deadline - time.time()
        if left <= 0:
            raise RuntimeError(f"sessions did not report {tag} in {timeout:.0f} s")
        for c in wait([c for i, c in enumerate(conns) if i not in got], timeout=left):
            i = conns.index(c)
            try:
                kind, body = c.recv()
            except EOFError:
                raise RuntimeError(f"session {i} ended before reporting {tag}") from None
            if kind == "error":
                raise RuntimeError(f"session {i} failed:\n{body}")
            got[i] = body
    return [got[i] for i in range(len(conns))]


def run_cell(args, root: Path, device: str = "cuda", inprocess: bool = False):
    """Run the cell; returns (the result dict, what the comment line
    reports), printing nothing. `inprocess` runs the sessions as threads
    of this process (tests that patch the program)."""
    bench = Bench(root)
    w, config, mix = bench.cell(args.workload)
    from slam_bench import reduce
    from slam_bench.reference import judge

    card = None
    if device == "cuda":
        card = smi()
        from orb_slam2_comment_tpu_torch import _build

        _build.library()
    ctx = mp.get_context("spawn")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    os.environ.setdefault("USE_FLAX", "0")
    procs, conns = [], []
    from slam_bench import session

    try:
        for i in range(int(mix["sessions"])):
            parent, child = ctx.Pipe()
            spec = dict(root=str(root), index=i, seed=args.seed, seconds=float(args.seconds),
                        trace=bool(args.trace), control=bool(args.control), device=device,
                        config=config, mix=mix, threads=1)
            if inprocess:
                p = threading.Thread(target=session.main, args=(child, spec), daemon=True)
                p.start()
            else:
                p = ctx.Process(target=session.main, args=(child, spec), daemon=True)
                p.start()
                child.close()
            procs.append(p)
            conns.append(parent)
        ready = _recv_all(conns, "ready", READY_TIMEOUT_S)
        setup_s = time.time() - T_START
        print(f"# sessions ready after {setup_s:.1f} s", file=sys.stderr, flush=True)
        t_go = time.time() + 0.05
        for c in conns:
            c.send(t_go)
        windows = _recv_all(conns, "window", float(args.seconds) + 300)
        checks = _recv_all(conns, "check", CHECK_TIMEOUT_S)
    finally:
        for c in conns:
            c.close()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive() and not inprocess:
                p.terminate()
                p.join(timeout=10)
    t_go_ns = int(t_go * 1e9)
    t_end_ns = max(x["drain"][1] for x in windows)
    window_s = (t_end_ns - t_go_ns) / 1e9
    frames = sum(x["frames"] for x in windows)
    failed = sum(x["frames"] - x["ok"] for x in windows)
    ran_out = [x["index"] for x in windows if x["ran_out"]]
    bad_sessions = [x["index"] for x in windows if x["resets"]]
    resolved = mix["read"] == "resolved"
    run = dict(workload=w, config=config, mix=mix, window_s=window_s, frames=frames,
               sessions=windows, t_go=t_go_ns, t_end=t_end_ns, device=None, card=card)
    if args.trace and device == "cuda":
        run["device"] = device_summary(run, windows, t_go_ns, t_end_ns, card)
    numbers = judge.combine(checks)
    limits = judge.load_limits(bench.dir, w["name"])
    ok, rows = judge.verdict(numbers, limits)
    correct = ok and failed == 0 and not ran_out and not bad_sessions
    metrics = {}
    if args.trace:
        for name, unit, reader in bench.metrics(w["name"], "per_layer"):
            v = reader(run)
            if v is not None:
                metrics[name] = dict(value=float(v), unit=unit)
    else:
        e2e = dict(fps=reduce.rate(frames, window_s), setup_s=setup_s)
        if resolved:
            lat = [(x["t2"] - x["t0"]) / 1e6 for x in windows]
            e2e["frame_p95_ms"] = reduce.percentile(
                [v for arr in lat for v in arr.tolist()], 95.0)
        for name, unit, _ in bench.metrics(w["name"], "end_to_end"):
            if name in e2e:
                metrics[name] = dict(value=float(e2e[name]), unit=unit)
    dev_info = dict(platform="gpu" if device == "cuda" else "cpu",
                    kind=windows[0]["device_kind"], count=int(w["chips"]),
                    memory_peak_bytes=int(sum(x["memory_peak"] for x in windows)))
    if run["device"] is not None:
        dev_info["busy_s"] = run["device"]["busy_s"]
        dev_info["window_s"] = run["device"]["window_s"]
    result = dict(correct=bool(correct), attempted=int(frames), failed=int(failed),
                  metrics=metrics, device=dev_info)
    if run["device"] is not None:
        result["breakdown"] = run["device"]["breakdown"]
    extra = dict(setup=dict(render_s=[r["render_s"] for r in ready],
                            warm_frames=[r["warm_frames"] for r in ready]),
                 sessions=[dict(frames=x["frames"], ok=x["ok"], kf=x["kf_created"],
                                first=x["first"])
                           for x in windows], card=card, ran_out=ran_out,
                 resets=bad_sessions, readings=checks,
                 modules=[x["modules"] for x in windows])
    if args.control:
        result["control"] = judge.combine([c["control"] for c in checks])
        result["control_correct"] = judge.verdict(result["control"], limits)[0]
    result["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    return result, extra


def device_summary(run, windows, t0: int, t1: int, card):
    """Busy and idle time of the card over the window from the sessions'
    traces, the device time by operation, the K1 and K3 bounds, and the
    longest idle gaps named by what the host was doing."""
    import numpy as np

    from slam_bench import reduce, roofline

    traces = [x["trace"] for x in windows]
    starts = np.concatenate([t["start"] for t in traces])
    ends = np.concatenate([t["end"] for t in traces])
    busy = reduce.busy_ns(starts, ends, t0, t1) / 1e9
    names = reduce.by_name(traces)
    slam = run["config"]["slam"]
    sizes = [(max(int(round(slam["height"] / s)), 64), max(int(round(slam["width"] / s)), 64))
             for s in [slam["scale_factor"] ** l for l in range(int(slam["n_levels"]))]]
    rate = (roofline.minmax_rate(windows[0]["sms"], card["max_sm_clock_mhz"])
            if card else None)
    spans = []
    for x in windows:
        s, e, k = [x["t0"], x["drain"][0:1]], [x["t1"], x["drain"][1:2]], [
            ["track_call"] * len(x["t0"]), ["drain"]]
        if x["t2"] is not None:
            s.append(x["t1"])
            e.append(x["t2"])
            k.append(["resolve_wait"] * len(x["t1"]))
        s = np.concatenate([np.asarray(v, np.int64) for v in s])
        e = np.concatenate([np.asarray(v, np.int64) for v in e])
        k = [v for part in k for v in part]
        o = np.argsort(s, kind="stable")
        spans.append((s[o], e[o], [k[j] for j in o]))
    gs, ge = reduce.gaps(starts, ends, t0, t1)
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        busy_s=busy, window_s=(t1 - t0) / 1e9, names=names,
        k1_bound_s=roofline.k1_bound_s(sizes, rate) if rate else None,
        k3_bound_s=sum(roofline.k3_bound_s(B, n, v) for x in windows for B, n, v in (x["k3"] or [])),
        breakdown=dict(device_ops=[[n[:160], v[0]] for n, v in top],
                       idle_gaps=reduce.label_gaps(gs, ge, spans)))


def main(argv=None, device: str = "cuda", root: Path = HERE.parent, inprocess: bool = False):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    if device == "cuda":
        import torch

        w = {x["name"]: x for x in Bench(root).spec["workloads"]}.get(args.workload)
        need = int(w["chips"]) if w else 1
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"slam_bench: needs {need} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    result, extra = run_cell(args, Path(root), device, inprocess)
    from slam_bench import forbidden_modules

    bad = sorted(set(forbidden_modules()).union(*extra.pop("modules")))
    if bad:
        print(f"slam_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("# " + json.dumps(extra, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)),
          flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
