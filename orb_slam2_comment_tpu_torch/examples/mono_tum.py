"""mono_tum — argv parity with Examples/Monocular/mono_tum.cc:

    python -m orb_slam2_comment_tpu_torch.examples.mono_tum path_to_vocabulary path_to_settings path_to_sequence [--device cpu]
"""
from orb_slam2_comment_tpu_torch.examples.run_dataset import shim

if __name__ == "__main__":
    shim("monocular", "tum_mono", None, (), "KeyFrameTrajectory")
