"""Trajectory evaluation (`camera_centers`, `ate_rmse`, `umeyama_align`),
loaded by path from the JAX package's `utils/trajectory.py`, whose
module level is numpy only. Its TUM/KITTI writers call jax and are not
exported here."""

from orb_slam2_comment_tpu_torch import _load_reference_file

_ref = _load_reference_file("utils/trajectory.py", "trajectory")
camera_centers = _ref.camera_centers
ate_rmse = _ref.ate_rmse
umeyama_align = _ref.umeyama_align
del _ref
