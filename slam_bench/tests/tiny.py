"""A tiny checkout for the benchmark's CPU tests: a copy of slam_bench/
with a BENCHMARK.json of one small RGB-D cell (320x240, 500 features, 4
levels, one session walking 4 m of hall), so that a whole run fits in a
test."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "slam_bench"
CELL = "tiny_rgbd.tiny-pipelined"
LIMITS = {"extract_diff_pct": {"limit": 1.0}, "pose_dT": {"limit": 5e-4},
          "lba_err": {"limit": 1e-3}, "ate_mm": {"limit": 100.0}}


def make_checkout(tmp: Path, read: str = "pipelined") -> Path:
    """tmp/ as a checkout holding the tiny cell; returns tmp."""
    shutil.copytree(BENCH, tmp / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(name="tiny_rgbd", source="slam_bench/tests/tiny.py",
                            file="slam_bench/configs/tiny_rgbd.json", reduced=[], why="test")]
    spec["workloads"] = [dict(name=CELL, config="tiny_rgbd", traffic="tiny-pipelined",
                              chips=1, why="test")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    conf = json.loads((BENCH / "configs" / "rgbd_tum3.json").read_text())
    conf["slam"].update(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                        n_features=500, n_levels=4)
    (tmp / "slam_bench" / "configs" / "tiny_rgbd.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / "explore-pipelined.json").read_text())
    mix.update(sessions=1, read=read, frames=80, supersample=1, warm_keyframes=2,
               check=dict(keyframes=1, pose_calls=2, lba_calls=1))
    mix["scene"].update(length=4.0, tex_size=192)
    mix["trajectory"].update(step=0.03)
    (tmp / "slam_bench" / "traffic" / "tiny-pipelined.json").write_text(json.dumps(mix))
    (tmp / "slam_bench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    return tmp


def run_subprocess(tmp: Path, *args, timeout: int = 600):
    """The tiny cell run on the CPU in a fresh interpreter: (exit code,
    stdout lines, stderr)."""
    code = ("import sys; from pathlib import Path; "
            f"sys.path[:0] = [{str(tmp)!r}, {str(REPO)!r}]; "
            "from slam_bench import run; "
            f"sys.exit(run.main(sys.argv[1:], device='cpu', root=Path({str(tmp)!r})))")
    p = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                       timeout=timeout, cwd=tmp)
    return p.returncode, p.stdout.splitlines(), p.stderr


def run_inprocess(tmp: Path, *args):
    """The tiny cell run with its session as a thread of this process, so
    that a patch of the program reaches it: (exit code, result dict)."""
    for p in (str(REPO), str(tmp)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from slam_bench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(list(args), device="cpu", root=tmp, inprocess=True)
    lines = out.getvalue().splitlines()
    return rc, json.loads(lines[-1]) if rc == 0 else None


def args(seed: int, trace: int = 0, seconds: int = 4, control: int = 0):
    return ["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--control", str(control)]
