"""Public API — the port of `orb_slam2_comment_tpu/models/system.py` (the
reference's System class) for RGB-D, stereo and monocular input.

`System(cfg)` wires tracking, the chunked local mapper, the keyframe
database, relocalization and — with `enable_loop_closing` (the config's
default, True) — the loop closer with its chunked background global BA.
`track_rgbd(image, depth_map, timestamp)`, `track_stereo(image_left,
image_right, timestamp)` and `track_monocular(image, timestamp)`, each for
its `cfg.sensor`, auto-reset a map lost with at most 5 keyframes, track
the frame and pump one background-GBA chunk.

The device is CUDA unless `device=` says otherwise; without a CUDA device
`System(cfg)` raises rather than falling back to the CPU. Localization
mode, capacity growth and map save/load raise NotImplementedError.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from orb_slam2_comment_tpu_torch.models.keyframe_database import KeyFrameDatabase
from orb_slam2_comment_tpu_torch.models.loop_closing import LoopCloser
from orb_slam2_comment_tpu_torch.models.relocalization import AdaptiveRelocalizer
from orb_slam2_comment_tpu_torch.models.tracking import LOST, Tracker, check_slice
from orb_slam2_comment_tpu_torch.ops import bow as bow_mod
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import optim, ransac
from orb_slam2_comment_tpu_torch.utils.config import (
    MONOCULAR, RGBD, STEREO, SlamConfig, resolve_device)

# the port's copy of the reference's packaged vocabulary (byte-equal)
VOC_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "voc_synth.npz")


def _warm_up(cfg: SlamConfig, device):
    """Run relocalization's and loop closing's solvers once on a tiny
    problem. Their first call in a process imports torch's forward-AD
    machinery and loads kernels: seconds of host time on the card
    (PERF.md), paid here rather than in the frame that relocalizes
    or closes the first loop."""
    g = torch.Generator().manual_seed(0)
    X = (torch.rand((16, 3), generator=g) + torch.tensor([0.0, 0.0, 2.0])).to(device)
    uv = geo.project(cfg.K, X)
    ones = torch.ones(16, device=device)
    ok = ones > 0
    sigma2 = torch.ones(1, device=device)
    ransac.pnp_ransac(X, uv, torch.zeros(16, dtype=torch.int32, device=device), ok, sigma2, cfg.K)
    eye = torch.eye(4, device=device)
    optim.sim3_optimize(eye, X, X, uv, uv, ones, ones, ok, cfg.K, cfg.K, iters=1)
    i = torch.zeros(1, dtype=torch.int32, device=device)
    optim.essential_graph_optimize(eye.expand(2, 4, 4).contiguous(), ok[:2],
                                   torch.arange(2, device=device) == 0,
                                   i, i + 1, eye[None], ok[:1], iters=1)


class System:
    def __init__(self, cfg: SlamConfig, vocabulary: Optional[bow_mod.Vocabulary] = None,
                 vocabulary_path: Optional[str] = None,
                 enable_loop_closing: Optional[bool] = None, device=None):
        check_slice(cfg)
        self.device = resolve_device(device, "System")
        self.cfg = cfg
        _warm_up(cfg, self.device)
        if vocabulary is None:
            path = vocabulary_path or VOC_ASSET
            if path.endswith(".txt") or not os.path.exists(path):
                raise NotImplementedError(
                    f"vocabulary {path!r}: the port reads the reference's .npz "
                    "vocabularies only (no text vocabularies, no bootstrap training)")
            vocabulary = bow_mod.load_vocabulary(path, self.device)
        self.voc = vocabulary
        self._loop_enabled = (cfg.enable_loop_closing if enable_loop_closing is None
                              else enable_loop_closing)
        self._loops_closed_prev = 0
        self.n_resets = 0
        self._reloc = AdaptiveRelocalizer()   # its retry streak outlives resets
        self.frame_id = 0
        self._build()

    def _build(self):
        """Tracker, database, relocalizer and loop closer, wired by hooks
        (System::System, src/System.cc:54-110)."""
        cfg = self.cfg
        self.tracker = Tracker(cfg, self.device)
        self.db = KeyFrameDatabase(self.voc, cfg.max_keyframes, self.tracker._n_slots(),
                                   self.device)
        self.loop_closer = (LoopCloser(cfg, self.tracker, self.db) if self._loop_enabled
                            else None)
        self.tracker.reloc_fn = self._relocalize
        # the node gate must key the same tree depth as the frame-side ids
        self._gate_active = self.voc.group_depth == cfg.voc_levels
        if self._gate_active:
            self.tracker.set_vocabulary_gate(self.voc)
        self.tracker.new_kf_callbacks.append(self._on_new_kf)
        # compaction renumbers point ids; the background GBA snapshot holds
        # old ones (mbStopGBA on map interference, src/LoopClosing.cc:410-423)
        self.tracker.compact_callbacks.append(self._on_compact)

    def _on_compact(self):
        if self.loop_closer is not None:
            self.loop_closer.abort_background()

    def _on_new_kf(self, kf_id: int):
        if self.loop_closer is None:
            # no detection will be harvested: release the creation-time
            # SetNotErase hold at once
            self.tracker.set_kf_erasable(kf_id)
        m = self.tracker.map
        self.db.add(kf_id, m.kf_desc[kf_id], m.kf_feat_valid[kf_id])
        if self._gate_active:
            # host-path keyframes get their node-gate groups here; device
            # keyframes already carry the same row
            self.tracker.set_kf_groups(kf_id, self.db.groups[kf_id])
        if self.loop_closer is not None:
            self.loop_closer.process(kf_id)

    def _relocalize(self, frame):
        return self._reloc(self.tracker.map, self.db, frame, self.cfg)

    @property
    def n_loops(self):
        """Loops closed so far, across resets."""
        n = self._loops_closed_prev
        if self.loop_closer is not None:
            n += self.loop_closer.n_loops_closed
        return n

    def _maybe_auto_reset(self):
        """Lost soon after initialization with <= 5 KFs: start over
        (Tracking::Track, src/Tracking.cc:472-480)."""
        t = self.tracker
        if t.state == LOST and 0 < t.n_kfs <= 5:
            print("Track lost soon after initialisation, resetting...")
            self.reset()

    def _pump_background(self):
        # one bounded chunk of any in-flight global BA per frame (the
        # reference's concurrent GBA thread, LoopClosing.cc:575-579)
        if self.loop_closer is not None:
            self.loop_closer.pump_background()

    def _track(self, sensor: str, entry: str, *images_and_ts):
        if self.cfg.sensor != sensor:
            raise ValueError(f"a {sensor} frame for a {self.cfg.sensor!r} system")
        self._maybe_auto_reset()   # may replace the tracker
        out = getattr(self.tracker, entry)(self.frame_id, images_and_ts[-1],
                                           *images_and_ts[:-1])
        self._pump_background()
        self.frame_id += 1
        return out

    def track_rgbd(self, image, depth_map, timestamp):
        return self._track(RGBD, "track_rgbd_arrays", image, depth_map, timestamp)

    def track_stereo(self, image_left, image_right, timestamp):
        return self._track(STEREO, "track_stereo_arrays", image_left, image_right,
                           timestamp)

    def track_monocular(self, image, timestamp):
        """The reference extracts 2x features while not initialized
        (Tracking.cc:243-247); this keeps one budget for every frame, as
        the JAX package does."""
        return self._track(MONOCULAR, "track_mono_arrays", image, timestamp)

    @property
    def trajectory(self):
        """Per-frame (timestamp, Tcr, ref_kf, state) records."""
        return self.tracker.trajectory

    def get_tracking_state(self):
        return self.tracker.state

    def reset(self):
        """Full reset (System::Reset + Tracking::Reset): a new map,
        database and tracking state; the frame counter carries on."""
        self.n_resets += 1
        if self.loop_closer is not None:
            self._loops_closed_prev += self.loop_closer.n_loops_closed
            self.loop_closer.abort_background()
        self._build()

    def shutdown(self):
        """Run the local mapper to idle and finish any queued loop
        detection and background GBA (System::Shutdown)."""
        self.tracker._drain_mapper()
        if self.loop_closer is not None:
            self.loop_closer.finish_background()
        self.tracker._drain_mapper()
