"""Shared plumbing for the port's ROS nodes (Examples/ROS/ORB_SLAM2/src/*.cc),
the twin of the JAX package's `examples/ros/ros_common.py`.

The nodes subscribe to the reference's topics and drive the port's System
API. rospy and cv_bridge are imported only when a node starts, with a
clear error where they are missing; the rest is plain numpy.
"""

from __future__ import annotations

import sys


def require_ros():
    try:
        import rospy  # noqa: F401
        from cv_bridge import CvBridge  # noqa: F401
    except ImportError as e:  # pragma: no cover - no ROS here
        raise SystemExit(
            "ROS (rospy + cv_bridge) is not available in this environment. "
            "These nodes mirror Examples/ROS/ORB_SLAM2/src/*.cc and run "
            f"under a standard ROS1 install: ({e})")
    import rospy
    from cv_bridge import CvBridge

    return rospy, CvBridge()


def node_args(names, argv=None):
    """The node's positional arguments (the reference's argv) and the
    `--device` option (default cuda), or None when the count is wrong."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != len(names):
        print(f"Usage: {' '.join(names)} [--device cpu|cuda]")
        return None
    return argv, device


def to_gray(img):
    import numpy as np

    if img.ndim == 2:
        return img
    # ITU-601, matching the reference's cvtColor (Tracking.cc:172-197)
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.float32)


def build_system(vocabulary_path, settings_path, sensor, device="cuda"):
    from orb_slam2_comment_tpu_torch.models.system import System
    from orb_slam2_comment_tpu_torch.utils.config import load_yaml_settings

    cfg = load_yaml_settings(settings_path, sensor)
    voc = None if vocabulary_path in ("-", "", None) else vocabulary_path
    return System(cfg, vocabulary_path=voc, device=device), cfg
