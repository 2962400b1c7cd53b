"""Build and bind the hand-written CUDA kernels.

Each source under `csrc/*.cu` compiles with its own `nvcc`, all in
parallel, and the objects link into one shared library with a plain C
interface, loaded with ctypes. The library lands in
`build/torch_kernels/` at the repository root, named by a hash of the
sources, so a checkout builds it at first use and reuses it afterwards.

Every C entry point takes device pointers and the CUDA stream as `void*`,
ints as `int`, floats as `float`, launches on that stream without
synchronising, and returns `cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "torch_kernels"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures, checked against csrc/*.cu
_SIGNATURES = {
    # stack, out, host launch table (ops/orb.py::k1_table), stream
    "slam_fast_nms": [_P, _P, _P, _P],
    # padded, lyx, out, n, L, Hp, Wp, stream
    "slam_gather_patches": [_P, _P, _P, _I, _I, _I, _I, _P],
    # Tcw0, X, obs, octave, stereo, valid, invs2_levels, Tcw_out, inliers,
    # n_inliers, B, n, n_levels, 5 batch strides, fx, fy, cx, cy, bf, rounds,
    # iters, robust_rounds, stream
    "slam_pose_lm": [_P] * 10 + [_I] * 8 + [_F] * 5 + [_I] * 3 + [_P],
    # cam_T, pts, uvr, inv_s2, stereo, ok, obs_pt, cam_free, perm, seg, sys,
    # n_in, scratch, tickets, Nc, Np, N_per, F, chunks, robust,
    # fx, fy, cx, cy, bf, stream
    "slam_lba_build": [_P] * 14 + [_I] * 6 + [_F] * 5 + [_P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(src_dir: Path = _SRC, stem: str = "libslam_kernels") -> Path:
    """The library built from src_dir's sources, named by their hash."""
    sources = sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))
    h = hashlib.sha1()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return _BUILD / f"{stem}_{h.hexdigest()[:12]}.so"


def compile_library(sources, so: Path, log: Path):
    """One nvcc per source, all started together, then one link into `so`;
    the compilers' output (`-Xptxas -v`) goes to `log`."""
    objdir = so.parent / f"{so.stem}.{os.getpid()}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    out_log, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        out_log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-3000:]}")
    log.write_text("".join(out_log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    shutil.rmtree(objdir, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    so = library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        compile_library(sorted(_SRC.glob("*.cu")), so, _BUILD / "nvcc.log")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, name: str, dtype, shape=None):
    """Validate a kernel argument: CUDA, dtype, contiguous, shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def batch_stride(t, name: str, dtype, shape) -> int:
    """Validate a per-item kernel argument [B, ...] on any device: dtype,
    shape, the trailing axes packed. The batch axis may be broadcast
    (stride 0). Returns the batch stride in elements."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: expected packed trailing axes, got strides {t.stride()}")
    return t.stride(0) if t.shape[0] > 1 else 0
