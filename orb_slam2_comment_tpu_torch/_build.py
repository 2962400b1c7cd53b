"""Build and bind the hand-written CUDA kernels.

All sources under `csrc/*.cu` compile with one `nvcc` call into one shared
library with a plain C interface, loaded with ctypes. The library lands in
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
    # img, out, h, w, margin, stream
    "slam_fast_nms": [_P, _P, _I, _I, _I, _P],
    # padded, lyx, out, n, L, Hp, Wp, stream
    "slam_gather_patches": [_P, _P, _P, _I, _I, _I, _I, _P],
    # X, obs, invs2, comp, valid, delta, chi2th, pose0, pose_out, inl, B, n,
    # fx, fy, cx, cy, bf, rounds, iters, robust_rounds, stream
    "slam_pose_lm": [_P] * 10 + [_I] * 2 + [_F] * 5 + [_I] * 3 + [_P],
    # cam_T, pts, uvr, wbase, urmask, obs_pt, cam_free, perm, seg,
    # cam_out, pp_out, e_out, Nc, Np, N_per, F, robust,
    # fx, fy, cx, cy, bf, stream
    "slam_lba_build": [_P] * 12 + [_I] * 5 + [_F] * 5 + [_P],
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


def library_path() -> Path:
    sources = sorted(_SRC.glob("*.cu")) + sorted(_SRC.glob("*.cuh"))
    h = hashlib.sha1()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return _BUILD / f"libslam_kernels_{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    so = library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp),
            *[str(s) for s in sorted(_SRC.glob("*.cu"))],
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (_BUILD / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
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
