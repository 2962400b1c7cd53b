"""The benchmark of the PyTorch and CUDA port (`orb_slam2_comment_tpu_torch`):
concurrent SLAM sessions on one card. `run.py` is the entry point."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_comment_tpu")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))
