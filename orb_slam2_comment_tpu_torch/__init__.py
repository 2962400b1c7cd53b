"""orb_slam2_comment_tpu_torch — the RGB-D main path of orb_slam2_comment_tpu
in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The JAX package `orb_slam2_comment_tpu` is the reference this package is
held against; module and function names mirror it (`ops/`, `models/`,
`utils/`) so each counterpart is easy to find. This package imports torch
and never jax, and reads no file of the JAX package: its constants,
synthetic scenes, trajectory evaluation and vocabulary are its own copies,
held equal to the reference's by tests/test_torch_system.py.

The four Pallas TPU kernels of the reference are CUDA C++ kernels under
`csrc/`, built at first use into `build/torch_kernels/` (see `_build.py`).
Every kernel wrapper takes its plain PyTorch twin for CPU tensors and
launches the kernel (or raises) for CUDA tensors.
"""

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

from orb_slam2_comment_tpu_torch import constants  # noqa: E402,F401

__version__ = "0.1.0"
