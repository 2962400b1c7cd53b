"""Synthetic scenes, trajectories and renders (numpy only), loaded by path
from the JAX package's `utils/synthetic.py`."""

from orb_slam2_comment_tpu_torch import _load_reference_file

_ref = _load_reference_file("utils/synthetic.py", "synthetic")
globals().update(
    {k: v for k, v in vars(_ref).items() if not k.startswith("__")}
)
del _ref
