"""Time build variants of kernel K1 (orb_slam2_comment_tpu_torch/csrc/fast_nms.cu)
against each other and against its earlier design, on one frame's level stack.

Each variant is the committed source with one constant or line changed by
text substitution; all are built at once (one nvcc each) under
build/k1_variants/. The variants that compute K1 are held to the plain
version under torch.equal; the two probes ("no_score": the score replaced
by a sum of 4 ring differences, "bright_only": the dark polarity dropped)
are timed only, to split the kernel's time into the score and the rest.
Device time per frame from CUDA graphs (50 launches per replay), every
variant timed twice, in turns (forward, then backward order).

    python3 prev_kernels/k1_variants.py     # from the repository root, on a GPU

Prints one line per variant (registers, stack, spills from ptxas) and a
last line `K1_VARIANTS {json}` of device ms per frame.
"""

from __future__ import annotations

import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

import chip_smoke as cs  # noqa: E402
import prev_kernels  # noqa: E402
from orb_slam2_comment_tpu_torch import _build  # noqa: E402
from orb_slam2_comment_tpu_torch.ops import orb  # noqa: E402

_SRC = (_ROOT / "orb_slam2_comment_tpu_torch" / "csrc" / "fast_nms.cu").read_text()
_TILE_LINE = f"constexpr int OUT_H = {orb.K1_TILE[0]};"


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant substitution does not apply: {old!r}")
    return src.replace(old, new)


def variants():
    """name -> (source, output tile rows, computes K1)."""
    th = orb.K1_TILE[0]
    rows = {f"tile_{n}_rows": (_sub(_SRC, _TILE_LINE, f"constexpr int OUT_H = {n};"), n, True)
            for n in (14, 62, 126) if n != th}
    score = "  float d[16], a[16], b[16], t[16], u[16];\n  ring_diffs(p, d);\n"
    return {
        "as_committed": (_SRC, th, True),
        **rows,
        "four_warps": (_sub(_SRC, "constexpr int WARPS = 8;", "constexpr int WARPS = 4;"), th, True),
        "no_score": (_sub(_SRC, score, score + "  return d[0] + d[5] + d[9] + d[13];\n"), th, False),
        "bright_only": (_sub(_SRC, "  return fmaxf(bright, -dark);", "  return bright;"), th, False),
    }


def build(name: str, src: str, out_dir: Path) -> Path:
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    so = out_dir / f"lib{name}.so"
    _build.compile_library([cu], so, out_dir / f"{name}.log")
    return so


def main():
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _ROOT / "build" / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    vs = variants()
    with ThreadPoolExecutor(len(vs)) as pool:
        sos = dict(zip(vs, pool.map(lambda kv: build(kv[0], kv[1][0], out_dir), vs.items())))
    for name in vs:
        log = (out_dir / f"{name}.log").read_text()
        info = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "stack frame" in ln or "registers" in ln]
        print(f"# {name}: " + "; ".join(info), flush=True)

    dev = torch.device("cuda")
    cfg = cs.bench_config()
    img = torch.from_numpy(cs.render_frames(1)[0]["image"]).to(dev).float()
    pyr, stack, sizes = cs.k1_inputs(img, cfg.orb)
    sizes = tuple(sizes)
    n_out = sum(h * w for h, w in sizes)
    runs = {}
    for name, (_, rows, computes_k1) in vs.items():
        lib = ctypes.CDLL(str(sos[name]))
        lib.slam_fast_nms.argtypes = [ctypes.c_void_p] * 4
        lib.slam_fast_nms.restype = ctypes.c_int
        saved = orb.K1_TILE
        orb.K1_TILE = (rows, saved[1])
        try:
            table = orb.k1_table.__wrapped__(sizes, *stack.shape[1:])
        finally:
            orb.K1_TILE = saved

        def run(lib=lib, table=table):
            out = torch.empty(n_out, dtype=torch.float32, device=dev)
            _build.check(lib.slam_fast_nms(_build.ptr(stack), _build.ptr(out), table.ctypes.data,
                                           _build.stream_of(stack)), "slam_fast_nms variant")
            return orb.k1_views(out, sizes, table)

        if computes_k1:
            cs.check_k1_levels(pyr, run(), name)
        else:
            run()
        runs[name] = (run, int(table[-1]))
    runs["earlier_per_level"] = (lambda: [prev_kernels.fast_nms_prev(lv) for lv in pyr], 0)
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(cs.graph_ms(runs[name][0], n=50))
    torch.cuda.synchronize()
    print("K1_VARIANTS " + json.dumps({name: dict(blocks=runs[name][1], device_ms=times[name])
                                       for name in runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
