"""The port's run_dataset twin on the CPU beside the JAX driver, on
tests/test_examples.py's 8-frame TUM RGB-D and 6-frame KITTI stereo
fixtures (written by tests/test_torch_drivers.py's helpers): the same
trajectories, warm prestaged replays, and the card as the default
device."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_drivers import datasets  # noqa: F401  (the on-disk fixtures)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _read_rows(path):
    return np.asarray([[float(x) for x in line.split()]
                       for line in Path(path).read_text().strip().splitlines()])


@pytest.mark.parametrize("case", ["rgbd_tum", "stereo_kitti"])
def test_run_dataset_like_jax(case, datasets, tmp_path, monkeypatch):
    """The run_dataset twin with device="cpu" beside the JAX driver on the
    same files: the same number of rows in the TUM and KITTI files, and
    every camera centre within 1 mm of JAX's (test_torch_system.py's
    per-frame tolerance)."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset as trd

    sys.path.insert(0, str(REPO))
    from examples import run_dataset as jrd

    root = datasets["tum" if case == "rgbd_tum" else "kitti"]
    args = (("rgbd", "tum_rgbd") if case == "rgbd_tum" else ("stereo", "kitti")) + (str(root),)
    kw = dict(settings=str(root / "settings.yaml"), vocabulary=None,
              associations=str(root / "associations.txt") if case == "rgbd_tum" else None)
    monkeypatch.chdir(tmp_path)
    jrd.run(*args, out_prefix="jax", **kw)
    system = trd.run(*args, out_prefix="torch", device="cpu", **kw)
    assert system.tracker.map.kf_pose.device.type == "cpu"
    n = 8 if case == "rgbd_tum" else 6
    for suffix, cols in (("_tum.txt", slice(1, 4)), ("_kitti.txt", [3, 7, 11])):
        a, b = _read_rows(f"torch{suffix}"), _read_rows(f"jax{suffix}")
        assert a.shape == b.shape and a.shape[0] == n
        assert np.abs(a[:, cols] - b[:, cols]).max() < 1e-3
    a, b = _read_rows("torch_kf_tum.txt"), _read_rows("jax_kf_tum.txt")
    assert a.shape == b.shape


def test_run_dataset_warm_runs_prestaged(datasets, tmp_path, monkeypatch):
    """runs=2 with prestage (frames decoded and on the device before the
    timed loop): the second run, in a fresh System, writes the same TUM
    file as one cold run, and `timings` gets that run's per-frame
    seconds."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset as trd

    root = datasets["tum"]
    kw = dict(settings=str(root / "settings.yaml"), associations=str(root / "associations.txt"),
              device="cpu")
    monkeypatch.chdir(tmp_path)
    trd.run("rgbd", "tum_rgbd", str(root), out_prefix="cold", **kw)
    times = []
    trd.run("rgbd", "tum_rgbd", str(root), out_prefix="warm", runs=2, prestage=True,
            timings=times, **kw)
    assert (tmp_path / "cold_tum.txt").read_text() == (tmp_path / "warm_tum.txt").read_text()
    assert len(times) == 8 and all(t > 0 for t in times)


def test_run_dataset_counts_tracked_frames_from_the_trajectory(datasets, tmp_path,
                                                               monkeypatch, capsys):
    """The driver reads a frame's output only where it prints (every 20th
    frame; the first is the initializing host-path frame) and counts the
    tracked frames from the trajectory after shutdown, as the JAX driver
    leaves the pipeline unread: no lazy output is read on the 8-frame TUM
    fixture, and the count is 8 of 8, the trajectory's OK rows."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset as trd
    from orb_slam2_comment_tpu_torch.models import tracking

    reads = []
    get = tracking.LazyTrackOutput._get
    monkeypatch.setattr(tracking.LazyTrackOutput, "_get",
                        lambda self: reads.append(self._fid) or get(self))
    root = datasets["tum"]
    monkeypatch.chdir(tmp_path)
    system = trd.run("rgbd", "tum_rgbd", str(root), settings=str(root / "settings.yaml"),
                     associations=str(root / "associations.txt"), out_prefix="count",
                     device="cpu")
    assert reads == []
    n_ok = sum(1 for r in system.trajectory if r[3] == tracking.OK)
    assert n_ok == 8
    assert "tracked frames: 8/8" in capsys.readouterr().out


def test_drivers_need_cuda_unless_told_cpu(datasets, tmp_path, monkeypatch):
    """The drivers default to the card and raise without one, before
    reading a frame; the argv shims take --device."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset as trd

    root = datasets["tum"]
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            trd.main(["rgbd", "tum_rgbd", str(root), "--associations",
                      str(root / "associations.txt")])
        assert not list(tmp_path.iterdir())
    s = trd.shim("rgbd", "tum_rgbd", ["-", str(root / "settings.yaml"), str(root),
                                      str(root / "associations.txt"), "--device", "cpu"],
                 ("associations",), "CameraTrajectory")
    assert s.cfg.n_features == 600 and s.cfg.grow_capacity
    assert len(_read_rows(tmp_path / "CameraTrajectory_tum.txt")) == 8
