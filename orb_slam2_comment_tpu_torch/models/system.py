"""Public API — the RGB-D slice of `orb_slam2_comment_tpu/models/system.py`
(the reference's System class).

`System(cfg).track_rgbd(image, depth_map, timestamp)` runs initialization,
tracking, keyframe creation and the chunked local mapper. Loop closing, the
keyframe database, relocalization, other sensors and map save/load are
outside this port's slice and raise NotImplementedError.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from orb_slam2_comment_tpu_torch.models.tracking import Tracker, check_slice
from orb_slam2_comment_tpu_torch.ops import bow as bow_mod
from orb_slam2_comment_tpu_torch.utils.config import SlamConfig

# the reference's packaged vocabulary, read as data (np.load)
VOC_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "orb_slam2_comment_tpu", "assets", "voc_synth.npz")


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class System:
    def __init__(self, cfg: SlamConfig, vocabulary: Optional[bow_mod.Vocabulary] = None,
                 vocabulary_path: Optional[str] = None,
                 enable_loop_closing: Optional[bool] = None, device=None):
        check_slice(cfg)
        loop = cfg.enable_loop_closing if enable_loop_closing is None else enable_loop_closing
        if loop:
            raise NotImplementedError(
                "loop closing and the keyframe database are outside the port's slice; "
                "pass enable_loop_closing=False")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else default_device()
        self.tracker = Tracker(cfg, self.device)
        if vocabulary is None:
            path = vocabulary_path or VOC_ASSET
            if path.endswith(".txt") or not os.path.exists(path):
                raise NotImplementedError(
                    f"vocabulary {path!r}: the port reads the reference's .npz "
                    "vocabularies only (no text vocabularies, no bootstrap training)")
            vocabulary = bow_mod.load_vocabulary(path, self.device)
        self.voc = vocabulary
        # the node gate must key the same tree depth as the frame-side ids
        if self.voc.group_depth == cfg.voc_levels:
            self.tracker.set_vocabulary_gate(self.voc)
        self.tracker.new_kf_callbacks.append(self._on_new_kf)
        self.frame_id = 0

    def _on_new_kf(self, kf_id: int):
        # no loop closer will harvest this KF: release the creation-time
        # SetNotErase hold at once, as the reference does without one
        self.tracker.set_kf_erasable(kf_id)

    def track_rgbd(self, image, depth_map, timestamp):
        out = self.tracker.track_rgbd_arrays(self.frame_id, timestamp, image, depth_map)
        self.frame_id += 1
        return out

    @property
    def trajectory(self):
        """Per-frame (timestamp, Tcr, ref_kf, state) records."""
        return self.tracker.trajectory

    def get_tracking_state(self):
        return self.tracker.state

    def shutdown(self):
        """Run the local mapper to idle (System::Shutdown's drain)."""
        self.tracker._drain_mapper()
