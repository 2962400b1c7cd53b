"""mono_euroc — argv parity with Examples/Monocular/mono_euroc.cc:

    python -m orb_slam2_comment_tpu_torch.examples.mono_euroc path_to_vocabulary path_to_settings path_to_sequence path_to_times_file [--device cpu]
"""
from orb_slam2_comment_tpu_torch.examples.run_dataset import shim

if __name__ == "__main__":
    shim("monocular", "euroc", None, ("timestamps",), "KeyFrameTrajectory")
