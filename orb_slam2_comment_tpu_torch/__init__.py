"""orb_slam2_comment_tpu_torch — the RGB-D main path of orb_slam2_comment_tpu
in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The JAX package `orb_slam2_comment_tpu` is the reference this package is
held against; module and function names mirror it (`ops/`, `models/`,
`utils/`) so each counterpart is easy to find. This package imports torch
and never jax.

The four Pallas TPU kernels of the reference are CUDA C++ kernels under
`csrc/`, built at first use into `build/torch_kernels/` (see `_build.py`).
Every kernel wrapper takes its plain PyTorch twin for CPU tensors and
launches the kernel (or raises) for CUDA tensors.
"""

import importlib.util as _ilu
import os as _os
import sys as _sys

import torch as _torch

# The reference forces full-precision f32 matmuls
# (orb_slam2_comment_tpu/__init__.py: jax_default_matmul_precision
# "highest"); the geometry, LM solves and the Hamming / BRIEF products rely
# on exact f32 accumulation. TF32 or reduced-precision bf16 reductions
# would flip descriptor bits and perturb the solvers.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_torch.set_float32_matmul_precision("highest")

_REF_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    "orb_slam2_comment_tpu",
)


def _load_reference_file(relpath: str, name: str):
    """Load one numpy-only file of the JAX package by path, so the repo
    keeps a single copy of it. Importing it as a package module would run
    `orb_slam2_comment_tpu/__init__.py`, which imports jax."""
    full = f"{__name__}._ref_{name}"
    if full in _sys.modules:
        return _sys.modules[full]
    spec = _ilu.spec_from_file_location(full, _os.path.join(_REF_DIR, relpath))
    mod = _ilu.module_from_spec(spec)
    # registered before exec: dataclasses resolve their module by name
    _sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


from orb_slam2_comment_tpu_torch import constants  # noqa: E402,F401

__version__ = "0.1.0"
