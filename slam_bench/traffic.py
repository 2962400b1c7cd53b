"""The general traffic generator: one session's frames from a mix file.

A traffic mix (`traffic/<name>.json`) is data: how many sessions run at
once, how their outputs are read (`pipelined`: nothing is waited for in
the window, the pipeline is drained at its end; `resolved`: each pose is
read before the next frame goes in), the scene and the trajectory by the
name of a generator in `scene.py` with its parameters, the frames each
session has ready, the keyframes that warm-up waits for, the sensor noise,
how many timed items each session hands to the correctness check, and
the `pool` its sequences come from (see `session_seeds`).

Each session renders its own sequence on the card and keeps it in host
memory in the sensor's types: uint8 gray, plus uint16 depth in units of
1/DepthMapFactor m (RGB-D) or a uint8 right image (stereo), through the
configuration's lens distortion where it states one. Ground truth is the
trajectory made here. A rendered sequence is kept in the checkout's
frame cache (`build/slam_bench/frames/`), keyed by everything that makes
its pixels, so a later run of any mix that holds the same sequence loads
it instead of rendering it again.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from slam_bench import render
from slam_bench.scene import SCENES, TRAJECTORIES

CHUNK = 32   # frames rendered per copy to host memory
CAMERA_KEYS = ("sensor", "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "width",
               "height", "bf", "depth_map_factor")
SEQUENCE_KEYS = ("frames", "scene", "trajectory", "noise", "supersample", "pool")


def cache_dir(root) -> Path:
    """The frame cache of the checkout at `root` (a fixed path)."""
    return Path(root) / "build" / "slam_bench" / "frames"


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix["read"] not in ("pipelined", "resolved"):
        raise ValueError(f"{path}: read must be pipelined or resolved, not {mix['read']!r}")
    if int(mix["sessions"]) < 1 or int(mix["frames"]) < 1:
        raise ValueError(f"{path}: sessions and frames must be positive")
    return mix


def session_seeds(seed: int, index: int, mix: dict) -> dict:
    """Independent streams for one session of one run: scene, trajectory,
    sensor noise, and the sample of timed items the check reads. Every
    run of a mix holds the same set of sequences (scene, trajectory and
    noise of members 0..sessions-1 of the mix's `pool`), which the seed
    hands out to the sessions in an order of its own, so that the work of
    a run is the same for every seed; the sample of items that the check
    reads is the seed's."""
    run = int(seed) % (1 << 64)
    sample = int(np.random.SeedSequence([run, int(index)]).generate_state(1)[0])
    member = int(np.random.default_rng(run).permutation(int(mix["sessions"]))[index])
    src = [int(mix["pool"]), member]
    scene, traj, noise = (int(v) for v in np.random.SeedSequence(src).generate_state(3))
    return dict(scene=scene, trajectory=traj, noise=noise, sample=sample, member=member)


@dataclass
class Sequence:
    images: np.ndarray            # [N, H, W] uint8 (the left image for stereo)
    depth: Optional[np.ndarray]   # [N, H, W] uint16 (RGB-D)
    right: Optional[np.ndarray]   # [N, H, W] uint8 (stereo)
    poses: np.ndarray             # [N, 4, 4] float64 ground-truth Tcw
    fps: float

    def __len__(self):
        return self.images.shape[0]

    def timestamp(self, i: int) -> float:
        return i / self.fps

    def inputs(self, i: int):
        """The arguments after the image that System.track_* takes."""
        second = self.depth[i] if self.depth is not None else self.right[i]
        return self.images[i], second, self.timestamp(i)


def trajectory(mix: dict, seeds: dict) -> np.ndarray:
    """The [N, 4, 4] ground-truth Tcw of one session."""
    kw = dict(mix["trajectory"])
    return TRAJECTORIES[kw.pop("kind")](int(mix["frames"]), seed=seeds["trajectory"] % (1 << 32),
                                        **kw)


def make_scene(mix: dict, seeds: dict):
    kw = dict(mix["scene"])
    return SCENES[kw.pop("kind")](seed=seeds["scene"] % (1 << 32), **kw)


def distortion(slam: dict):
    """(k1, k2, p1, p2, k3) of the configuration, None for an ideal
    pinhole."""
    d = tuple(float(slam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2", "k3"))
    return d if any(d) else None


def cache_key(slam: dict, mix: dict, member: int) -> str:
    """What makes one pool member's pixels: the camera, the mix's
    sequence parameters, the member, and the generator's own sources."""
    h = hashlib.sha256()
    h.update(json.dumps([{k: slam.get(k) for k in CAMERA_KEYS},
                         {k: mix.get(k) for k in SEQUENCE_KEYS}, int(member)],
                        sort_keys=True).encode())
    here = Path(__file__).resolve().parent
    for f in ("traffic.py", "scene.py", "render.py"):
        h.update((here / f).read_bytes())
    return h.hexdigest()[:24]


def render_frames(slam: dict, mix: dict, seeds: dict, poses: np.ndarray, device):
    """Render one session's frames on `device` and bring them to host
    memory: (images, depth or None, right or None)."""
    scene = make_scene(mix, seeds)
    K = (slam["fx"], slam["fy"], slam["cx"], slam["cy"])
    hw = (int(slam["height"]), int(slam["width"]))
    rnd = render.Renderer(scene, K, hw, device, mix.get("supersample", 2), mix.get("noise", 1.5),
                          distortion(slam))
    sensor = slam["sensor"]
    n = len(poses)
    images = np.empty((n,) + hw, np.uint8)
    depth = np.empty((n,) + hw, np.uint16) if sensor == "rgbd" else None
    right = np.empty((n,) + hw, np.uint8) if sensor == "stereo" else None
    baseline = slam["bf"] / slam["fx"]
    base = seeds["noise"]
    for c0 in range(0, n, CHUNK):
        gray, second = [], []
        for i in range(c0, min(n, c0 + CHUNK)):
            img, dep = rnd.render(poses[i], seed=base + 2 * i)
            gray.append(render.to_gray8(img))
            if sensor == "rgbd":
                second.append(render.to_depth16(dep, float(slam["depth_map_factor"])))
            elif sensor == "stereo":
                second.append(render.to_gray8(rnd.render(poses[i], baseline=baseline,
                                                         seed=base + 2 * i + 1)[0]))
        images[c0:c0 + len(gray)] = torch.stack(gray).cpu().numpy()
        if depth is not None:
            depth[c0:c0 + len(gray)] = torch.stack(second).cpu().numpy().astype(np.uint16)
        if right is not None:
            right[c0:c0 + len(gray)] = torch.stack(second).cpu().numpy()
    return images, depth, right


def make_sequence(slam: dict, mix: dict, seed: int, index: int, device,
                  cache: Optional[Path] = None) -> Sequence:
    """One session's sequence: loaded from the frame cache under `cache`
    where it holds it, else rendered (and stored there)."""
    seeds = session_seeds(seed, index, mix)
    poses = trajectory(mix, seeds)
    second = "depth" if slam["sensor"] == "rgbd" else "right"
    d = Path(cache) / cache_key(slam, mix, seeds["member"]) if cache is not None else None
    if d is not None and (d / "images.npy").exists():
        images = np.load(d / "images.npy")
        other = np.load(d / f"{second}.npy")
        arrays = (images, other, None) if second == "depth" else (images, None, other)
    else:
        arrays = render_frames(slam, mix, seeds, poses, device)
        if d is not None:
            part = d.with_name(f"{d.name}.part{os.getpid()}")
            part.mkdir(parents=True, exist_ok=True)
            np.save(part / "images.npy", arrays[0])
            np.save(part / f"{second}.npy", arrays[1] if second == "depth" else arrays[2])
            try:
                os.rename(part, d)
            except OSError:   # another process stored it first
                for f in part.iterdir():
                    f.unlink()
                part.rmdir()
    return Sequence(*arrays, poses, float(slam["fps"]))
