"""The port's run_dataset twin on the CPU beside the JAX driver, on
tests/test_examples.py's 8-frame TUM RGB-D and 6-frame KITTI stereo
fixtures (written by tests/test_torch_drivers.py's helpers): the same
trajectories, warm prestaged replays, and the card as the default
device. The port's driver runs once per sequence, in the module
fixture `port_runs`; the tests read that run's files."""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_drivers import datasets  # noqa: F401  (the on-disk fixtures)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CASES = ("rgbd_tum", "stereo_kitti")


def _read_rows(path):
    return np.asarray([[float(x) for x in line.split()]
                       for line in Path(path).read_text().strip().splitlines()])


def _driver_args(case, datasets):
    """(positional args, keyword args) of run_dataset.run for a case."""
    root = datasets["tum" if case == "rgbd_tum" else "kitti"]
    args = (("rgbd", "tum_rgbd") if case == "rgbd_tum" else ("stereo", "kitti")) + (str(root),)
    kw = dict(settings=str(root / "settings.yaml"), vocabulary=None,
              associations=str(root / "associations.txt") if case == "rgbd_tum" else None)
    return args, kw


@pytest.fixture(scope="module")
def port_runs(datasets, tmp_path_factory):
    """The port's driver once on each sequence with device="cpu", writing
    torch_*: {case: (its output directory, the System it returns, the
    frame ids whose lazy output was read, what it printed)}."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset as trd
    from orb_slam2_comment_tpu_torch.models import tracking

    get = tracking.LazyTrackOutput._get
    out = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(f"port_{case}")
        args, kw = _driver_args(case, datasets)
        reads, printed = [], io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
            mp.setattr(tracking.LazyTrackOutput, "_get",
                       lambda self, reads=reads: reads.append(self._fid) or get(self))
            mp.chdir(d)
            system = trd.run(*args, out_prefix="torch", device="cpu", **kw)
        out[case] = (d, system, reads, printed.getvalue())
    return out


@pytest.mark.parametrize("case", CASES)
def test_run_dataset_like_jax(case, datasets, port_runs, tmp_path, monkeypatch):
    """The run_dataset twin with device="cpu" beside the JAX driver on the
    same files: the same number of rows in the TUM and KITTI files, and
    every camera centre within 1 mm of JAX's (test_torch_system.py's
    per-frame tolerance)."""
    sys.path.insert(0, str(REPO))
    from examples import run_dataset as jrd

    args, kw = _driver_args(case, datasets)
    monkeypatch.chdir(tmp_path)
    jrd.run(*args, out_prefix="jax", **kw)
    d, system, _, _ = port_runs[case]
    assert system.tracker.map.kf_pose.device.type == "cpu"
    n = 8 if case == "rgbd_tum" else 6
    for suffix, cols in (("_tum.txt", slice(1, 4)), ("_kitti.txt", [3, 7, 11])):
        a, b = _read_rows(d / f"torch{suffix}"), _read_rows(f"jax{suffix}")
        assert a.shape == b.shape and a.shape[0] == n
        assert np.abs(a[:, cols] - b[:, cols]).max() < 1e-3
    a, b = _read_rows(d / "torch_kf_tum.txt"), _read_rows("jax_kf_tum.txt")
    assert a.shape == b.shape


def test_run_dataset_warm_runs_prestaged(datasets, port_runs, tmp_path, monkeypatch):
    """runs=2 with prestage (frames decoded and on the device before the
    timed loop): the second run, in a fresh System, writes the same TUM
    file as one cold run, and `timings` gets that run's per-frame
    seconds."""
    from orb_slam2_comment_tpu_torch.examples import run_dataset as trd

    root = datasets["tum"]
    kw = dict(settings=str(root / "settings.yaml"), associations=str(root / "associations.txt"),
              device="cpu")
    monkeypatch.chdir(tmp_path)
    times = []
    trd.run("rgbd", "tum_rgbd", str(root), out_prefix="warm", runs=2, prestage=True,
            timings=times, **kw)
    cold = port_runs["rgbd_tum"][0] / "torch_tum.txt"
    assert cold.read_text() == (tmp_path / "warm_tum.txt").read_text()
    assert len(times) == 8 and all(t > 0 for t in times)


def test_run_dataset_counts_tracked_frames_from_the_trajectory(port_runs):
    """The driver reads a frame's output only where it prints (every 20th
    frame; the first is the initializing host-path frame) and counts the
    tracked frames from the trajectory after shutdown, as the JAX driver
    leaves the pipeline unread: no lazy output is read on the 8-frame TUM
    fixture, and the count is 8 of 8, the trajectory's OK rows."""
    from orb_slam2_comment_tpu_torch.models import tracking

    _, system, reads, printed = port_runs["rgbd_tum"]
    assert reads == []
    n_ok = sum(1 for r in system.trajectory if r[3] == tracking.OK)
    assert n_ok == 8
    assert "tracked frames: 8/8" in printed


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
