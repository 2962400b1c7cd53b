"""rgbd_tum — argv parity with Examples/RGB-D/rgbd_tum.cc:

    python -m orb_slam2_comment_tpu_torch.examples.rgbd_tum path_to_vocabulary path_to_settings path_to_sequence path_to_association [--device cpu]
"""
from orb_slam2_comment_tpu_torch.examples.run_dataset import shim

if __name__ == "__main__":
    shim("rgbd", "tum_rgbd", None, ("associations",), "CameraTrajectory")
