"""BENCHMARK.json and the command line against the benchmark's contract:
the file's keys and names, the refusal without a card, and the result
line of a tiny CPU run."""

import json
import re
import subprocess
import sys

import pytest

from slam_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["slam_bench"] and s["command"][1] == "slam_bench/run.py"
    assert 1 <= s["run_seconds"] <= 51
    names = [c["name"] for c in s["configs"]] + [w["name"] for w in s["workloads"]]
    names += [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (tiny.REPO / c["file"]).exists() and c["file"].startswith("slam_bench/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (tiny.BENCH / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and (tiny.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_refuses_without_a_card():
    """Run as the driver runs it: with no CUDA device (this sandbox) it
    exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    w = spec()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "slam_bench/run.py", "--workload", w, "--seed",
                        str(2 ** 31 + 5), "--seconds", "10", "--trace", "0"],
                       capture_output=True, text=True, cwd=tiny.REPO, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_result_line(tiny_run):
    rc, out, err = tiny_run
    assert rc == 0, err[-3000:]
    r = json.loads(out[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"fps", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"extract_diff_pct", "pose_dT", "lba_err", "ate_mm"}
    # the numbers compared, each beside its limit, are standard error's last lines
    tail = err.strip().splitlines()[-4:]
    assert all(line.startswith("check ") and "limit" in line for line in tail)


def test_control_fails_a_limit(tiny_run):
    """The reference one precision down, put in the program's place, fails
    at least one of the limits the sound run passes."""
    rc, out, err = tiny_run
    assert rc == 0, err[-3000:]
    r = json.loads(out[-1])
    fails = [k for k, v in r["control"].items()
             if v is not None and v > r["checks"][k]["limit"]]
    assert fails, r["control"]


def test_control_is_not_correct(tiny_run):
    """The harness's own verdict on the control's numbers: not correct."""
    rc, out, err = tiny_run
    assert rc == 0, err[-3000:]
    r = json.loads(out[-1])
    assert r["correct"] is True and r["control_correct"] is False, r["control"]


def test_verdict_optional_number():
    """A number marked optional may be absent (the window ran nothing it
    reads); present, it is held to its limit; any other absent number
    fails the run."""
    from slam_bench.reference import judge

    lim = {"pose_dT": {"limit": 1e-3}, "lba_err": {"limit": 0.1, "optional": True}}
    assert judge.verdict({"pose_dT": 1e-4, "lba_err": None}, lim)[0] is True
    assert judge.verdict({"pose_dT": 1e-4, "lba_err": 0.2}, lim)[0] is False
    assert judge.verdict({"pose_dT": None, "lba_err": 0.05}, lim)[0] is False
