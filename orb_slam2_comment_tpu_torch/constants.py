"""Behavioural constants, loaded by path from the JAX package's
`constants.py` (one copy in the repo; see `_load_reference_file`)."""

from orb_slam2_comment_tpu_torch import _load_reference_file

_ref = _load_reference_file("constants.py", "constants")
globals().update(
    {k: v for k, v in vars(_ref).items() if not k.startswith("__")}
)
del _ref
