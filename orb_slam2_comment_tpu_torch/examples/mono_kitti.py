"""mono_kitti — argv parity with Examples/Monocular/mono_kitti.cc:

    python -m orb_slam2_comment_tpu_torch.examples.mono_kitti path_to_vocabulary path_to_settings path_to_sequence [--device cpu]
"""
from orb_slam2_comment_tpu_torch.examples.run_dataset import shim

if __name__ == "__main__":
    shim("monocular", "kitti", None, (), "KeyFrameTrajectory")
