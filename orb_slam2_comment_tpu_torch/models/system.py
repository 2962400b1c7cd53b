"""Public API — the port of `orb_slam2_comment_tpu/models/system.py` (the
reference's System class) for RGB-D, stereo and monocular input.

`System(cfg)` wires tracking, the local mapper (chunked inside the frame
step by default; with `cfg.chunked_mapper` or `cfg.fused_tracking` False
the monolithic `LocalMapper`, run per keyframe), the keyframe database,
relocalization and — with `enable_loop_closing` (the config's default,
True) — the loop closer with its chunked background global BA.
`track_rgbd(image, depth_map, timestamp)`, `track_stereo(image_left,
image_right, timestamp)` and `track_monocular(image, timestamp)`, each for
its `cfg.sensor`, auto-reset a map lost with at most 5 keyframes (not in
localization mode), track the frame and pump one background-GBA chunk.
A fused frame returns a `tracking.LazyTrackOutput` at once: reading one
of its fields waits for that frame, and the tracking state, `trajectory`
and the keyframe callbacks move when the tracker's batched stats resolve,
up to a few batches behind. `shutdown`, the savers, `save_map`, the
state queries but `get_tracking_state`, and `reset` resolve everything
first.

Besides: the localization-mode switches, the state queries, the TUM and
KITTI trajectory savers, and map save/load in the reference's npz format
(a map saved by either package loads in the other). The vocabulary is the
packaged asset unless one is given (a `.txt` path is read as ORBvoc.txt);
without the asset one is trained from the first keyframe's descriptors.

With `cfg.grow_capacity` (the default) the map, the database and every
component move to the next capacity tier when the map is ~85% full.

The device is CUDA unless `device=` says otherwise; without a CUDA device
`System(cfg)` raises rather than falling back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.models import map_state as ms
from orb_slam2_comment_tpu_torch.models.keyframe_database import KeyFrameDatabase
from orb_slam2_comment_tpu_torch.models.local_mapping import LocalMapper
from orb_slam2_comment_tpu_torch.models.loop_closing import LoopCloser
from orb_slam2_comment_tpu_torch.models.relocalization import AdaptiveRelocalizer
from orb_slam2_comment_tpu_torch.models.tracking import (
    LOST, NO_IMAGES_YET, OK, Tracker, check_slice)
from orb_slam2_comment_tpu_torch.ops import bow as bow_mod
from orb_slam2_comment_tpu_torch.ops import geometry as geo
from orb_slam2_comment_tpu_torch.ops import optim, ransac
from orb_slam2_comment_tpu_torch.utils import trajectory as traj
from orb_slam2_comment_tpu_torch.utils.config import (
    MONOCULAR, RGBD, STEREO, SlamConfig, resolve_device)

# the port's copies of the reference's packaged vocabularies (byte-equal):
# the 9991-word default and the 97,273-word one, whose database is the
# inverted file (keyframe_database.SPARSE_W_THRESHOLD)
VOC_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "voc_synth.npz")
VOC_ASSET_100K = os.path.join(os.path.dirname(VOC_ASSET), "voc_synth_100k.npz")


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
        if vocabulary is None and vocabulary_path:
            if vocabulary_path.endswith(".txt"):
                vocabulary = bow_mod.load_orb_vocab(vocabulary_path, device=self.device)
            else:
                vocabulary = bow_mod.load_vocabulary(vocabulary_path, self.device)
        if vocabulary is None and vocabulary_path is None and os.path.exists(VOC_ASSET):
            # the packaged vocabulary (ORBVocabulary::loadFromTextFile,
            # src/System.cc:64-65); without it, first-keyframe bootstrap
            vocabulary = bow_mod.load_vocabulary(VOC_ASSET, self.device)
        self.voc = vocabulary
        self._loop_enabled = (cfg.enable_loop_closing if enable_loop_closing is None
                              else enable_loop_closing)
        self._loops_closed_prev = 0
        self.n_resets = 0
        self._last_seen_big_change = 0
        self._reloc = AdaptiveRelocalizer()   # its retry streak outlives resets
        self.frame_id = 0
        self._build()

    def _build(self):
        """A new tracker with its hooks, then the database side once a
        vocabulary exists (System::System, src/System.cc:54-110)."""
        self.tracker = Tracker(self.cfg, self.device)
        self.mapper = LocalMapper(self.cfg, self.tracker)
        if not (self.cfg.chunked_mapper and self.cfg.fused_tracking):
            # the chunked mapper runs inside the frame step; this callback
            # would map every keyframe twice there
            self.tracker.new_kf_callbacks.append(self.mapper.process)
        self.db: Optional[KeyFrameDatabase] = None
        self.loop_closer: Optional[LoopCloser] = None
        self._gate_active = False
        if self.voc is not None:
            self._init_db()
        else:
            self.tracker.new_kf_callbacks.append(self._maybe_bootstrap_vocab)
        self.tracker.new_kf_callbacks.append(self._on_new_kf)
        # compaction renumbers point ids; the background GBA snapshot holds
        # old ones (mbStopGBA on map interference, src/LoopClosing.cc:410-423)
        self.tracker.compact_callbacks.append(self._on_compact)
        self.tracker.grow_callbacks.append(self._on_grow)

    def _init_db(self):
        """Database, relocalization hook, loop closer and node gate for
        the current vocabulary."""
        cfg = self.cfg
        self.db = KeyFrameDatabase(self.voc, cfg.max_keyframes, self.tracker._n_slots(),
                                   self.device)
        if self._loop_enabled:
            self.loop_closer = LoopCloser(cfg, self.tracker, self.db)
        self.tracker.reloc_fn = self._relocalize
        # the node gate must key the same tree depth as the frame-side ids
        self._gate_active = self.voc.group_depth == cfg.voc_levels
        if self._gate_active:
            self.tracker.set_vocabulary_gate(self.voc)

    def _maybe_bootstrap_vocab(self, kf_id: int):
        """No vocabulary given and no asset: train one on the first
        keyframe's descriptors and wire the database side."""
        if self.voc is not None:
            return
        m = self.tracker.map
        desc = m.kf_desc[kf_id].cpu().numpy().view(np.uint32)
        valid = m.kf_feat_valid[kf_id].cpu().numpy()
        self.voc = bow_mod.train_vocabulary(desc[valid], k=8, depth=3, seed=0,
                                            device=self.device)
        self._init_db()

    def _on_compact(self):
        if self.loop_closer is not None:
            self.loop_closer.abort_background()

    def _on_grow(self, new_cfg: SlamConfig):
        """A capacity tier reached (Tracker._maybe_grow): the new cfg to
        every component, and the database widened. A background GBA in
        flight carries on: growth keeps every id, and its result is padded
        to the grown map when applied."""
        self.cfg = new_cfg
        self.mapper.cfg = new_cfg
        if self.loop_closer is not None:
            self.loop_closer.cfg = new_cfg
        if self.db is not None:
            self.db.grow(new_cfg.max_keyframes)

    def _on_new_kf(self, kf_id: int):
        if self.db is None or self.loop_closer is None:
            # no detection will be harvested: release the creation-time
            # SetNotErase hold at once
            self.tracker.set_kf_erasable(kf_id)
        if self.db is None:
            return
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
        (Tracking::Track, src/Tracking.cc:472-480) — never in
        localization mode, whose map is not its own to discard."""
        t = self.tracker
        if t.state == LOST and 0 < t.n_kfs <= 5 and not self.cfg.localization_only:
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
        """Per-frame (timestamp, Tcr, ref_kf, state) records of the frames
        resolved so far (`shutdown` resolves the rest)."""
        return self.tracker.trajectory

    # -- mode switches (System.cc:268-299) -------------------------------------
    def activate_localization_mode(self):
        """Track against the map without creating keyframes; frames off the
        map fall back to visual odometry (rgbd and stereo)."""
        self.cfg = dataclasses.replace(self.cfg, localization_only=True)
        self.tracker.cfg = self.cfg

    def deactivate_localization_mode(self):
        self.cfg = dataclasses.replace(self.cfg, localization_only=False)
        self.tracker.cfg = self.cfg

    def reset(self):
        """Full reset (System::Reset + Tracking::Reset): a new map,
        database and tracking state; the frame counter carries on. The
        pipeline is resolved first, into the old tracker."""
        self.n_resets += 1
        if self.loop_closer is not None:
            self._loops_closed_prev += self.loop_closer.n_loops_closed
            self.loop_closer.abort_background()
        self.tracker._flush_all()
        self._build()

    def shutdown(self):
        """Resolve the pipeline, run the local mapper to idle and finish any
        queued loop detection and background GBA (System::Shutdown)."""
        self.tracker._flush_all()
        if self.loop_closer is not None:
            self.loop_closer.finish_background()
        self.tracker._flush_all()

    # -- state queries (System.cc:282-299, 474-491) ----------------------------
    def get_tracking_state(self):
        """The state of the last resolved frame (lagged, as the reference's)."""
        return self.tracker.state

    def get_tracked_map_points(self):
        """Map point ids associated with the last tracked frame."""
        t = self.tracker
        t._flush_all()
        if t.ds is not None:
            a = t.ds.last_assoc.cpu().numpy()
        elif t.last_frame is not None and t.last_frame.assoc is not None:
            a = t.last_frame.assoc.cpu().numpy()
        else:
            return np.empty(0, np.int64)
        return a[a >= 0]

    def get_tracked_keypoints(self):
        """Undistorted keypoints of the last host-path frame that carry a
        map-point association (System::GetTrackedKeyPointsUn,
        src/System.cc:484-491)."""
        t = self.tracker
        t._flush_all()
        if t.last_frame is None:
            return np.empty((0, 2), np.float32)
        a = t.last_frame.assoc.cpu().numpy()
        return t.last_frame.feats.xy.cpu().numpy()[a >= 0]

    def map_changed(self):
        """Latched big-change poll (System::MapChanged, src/System.cc:282-293):
        True once per loop correction or reset since the previous call."""
        idx = self._big_change_idx()
        if idx > self._last_seen_big_change:
            self._last_seen_big_change = idx
            return True
        return False

    def _big_change_idx(self):
        return self.n_resets + self.n_loops

    # -- trajectory savers (System.cc:322-472) ---------------------------------
    def _settle(self):
        """The pipeline resolved, the mapper idle and any background GBA
        applied, as the savers and save_map need the map."""
        self.tracker._flush_all()
        if self.loop_closer is not None:
            self.loop_closer.finish_background()

    def _frame_poses(self):
        self._settle()
        m = self.tracker.map
        kf_pose = m.kf_pose.cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        kf_parent = m.kf_parent.cpu().numpy()
        kf_Tcp = m.kf_Tcp.cpu().numpy()
        out = []
        for ts, Tcr, ref, state in self.trajectory:
            if state != OK or ref < 0:
                continue
            # walk the spanning tree through culled reference keyframes
            # (System::SaveTrajectoryTUM bad-KF walk, src/System.cc:350-360)
            Trw = np.eye(4)
            while ref >= 0 and not kf_valid[ref]:
                Trw = Trw @ kf_Tcp[ref]
                ref = kf_parent[ref]
            if ref < 0:
                continue
            out.append((ts, Tcr @ Trw @ kf_pose[ref]))
        return out

    def save_trajectory_tum(self, path):
        fp = self._frame_poses()
        traj.save_tum(path, [t for t, _ in fp], [T for _, T in fp])

    def save_trajectory_kitti(self, path):
        fp = self._frame_poses()
        traj.save_kitti(path, [T for _, T in fp])

    def save_keyframe_trajectory_tum(self, path):
        self._settle()
        m = self.tracker.map
        idx = np.where(m.kf_valid.cpu().numpy())[0]
        # host-side float64 timestamps (the map's copy is f32, which
        # quantizes TUM epoch stamps to ~128 s)
        ts = self.tracker.kf_ts_host
        poses = m.kf_pose.cpu().numpy()
        traj.save_tum(path, ts[idx].tolist(), [poses[i] for i in idx])

    # -- map save/load (real, unlike the reference's TODO) ---------------------
    def save_map(self, path):
        """The MapState fields in the reference's dtypes, the keyframe and
        point cursors and the loop edges, as one compressed npz."""
        self._settle()
        extra = {}
        if self.loop_closer is not None and self.loop_closer.loop_edges:
            le = self.loop_closer.loop_edges
            extra["loop_edge_ids"] = np.asarray([(a, b) for a, b, _ in le], np.int32)
            extra["loop_edge_S"] = np.stack([S for _, _, S in le])
        np.savez_compressed(path, **ms.to_numpy(self.tracker.map),
                            n_kfs=self.tracker.n_kfs, n_pts=self.tracker.n_pts, **extra)

    def load_map(self, path):
        """Adopt a saved map, as the reference does: its arrays (fields
        missing from the file from an empty map at this System's tier),
        keyframe count and point cursor; the database re-indexes every
        keyframe slot below n_kfs and the tracker starts LOST (relocalizes
        on the next frame).

        Everything else stays: this System's cfg and database tier (a file
        from a larger tier keeps its rows, the database drops those at or
        above its own, and capacity growth catches up on a later frame),
        database entries above the loaded n_kfs, a background GBA in flight,
        queued detections, the pipeline, the device state, velocity,
        `last_frame` and trajectory."""
        z = np.load(path)
        t = self.tracker
        empty = ms.empty_map(self.cfg.max_keyframes, self.cfg.max_points, t._n_slots(),
                             self.device)
        t.map = ms.MapState(**{
            f: ms.tensor_from_numpy(z[f], self.device) if f in z else getattr(empty, f)
            for f in ms.MapState.field_names()})
        t.n_kfs = int(z["n_kfs"])
        t.n_pts = int(z["n_pts"])
        if self.loop_closer is not None and "loop_edge_ids" in z:
            self.loop_closer.loop_edges = [
                (int(a), int(b), S) for (a, b), S in zip(z["loop_edge_ids"], z["loop_edge_S"])]
        if self.db is not None:
            m = t.map
            rows = self.db.groups.shape[0]
            for k in range(t.n_kfs):
                self.db.add(k, m.kf_desc[k], m.kf_feat_valid[k])
                # a row past the database's tier reads its last row, as the
                # reference's clamped gather does
                t.set_kf_groups(k, self.db.groups[min(k, rows - 1)])
        t.state = LOST if t.n_kfs else NO_IMAGES_YET
        t.ref_kf = max(t.n_kfs - 1, -1)
