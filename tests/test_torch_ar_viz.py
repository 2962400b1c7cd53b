"""The port's AR helpers, viewer and AR demo (orb_slam2_comment_tpu_torch.
utils.ar, utils.viz, examples.ar_demo) against the JAX package's on the
inputs of tests/test_ar.py and tests/test_viz.py, on the CPU."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_ar  # noqa: E402
import test_viz  # noqa: E402


def _port_map(jmap):
    from orb_slam2_comment_tpu_torch.models import map_state as ms

    return ms.from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()})


@pytest.mark.parametrize("case", ["plane", "random", "few", "noisy"])
def test_detect_plane_like_jax(case):
    """Equal (normal, origin), or None in both."""
    from orb_slam2_comment_tpu.utils import ar as J
    from orb_slam2_comment_tpu_torch.utils import ar as T

    pts, seed = {
        "plane": (test_ar._plane_cloud(), 1),
        "random": (np.random.RandomState(0).uniform(-5, 5, (300, 3)) + [0, 0, 8], 0),
        "few": (np.zeros((5, 3)), 0),
        "noisy": (test_ar._plane_cloud(noise=0.01, outliers=120, seed=3), 2),
    }[case]
    a, b = T.detect_plane(pts, np.eye(4), seed=seed), J.detect_plane(pts, np.eye(4), seed=seed)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("case", ["front", "behind"])
def test_render_cube_like_jax(case):
    from orb_slam2_comment_tpu.utils import ar as J
    from orb_slam2_comment_tpu_torch.utils import ar as T

    if case == "front":
        args = (np.full((240, 320), 128, np.uint8), np.eye(4), (260.0, 260.0, 160.0, 120.0),
                np.array([0.0, -1.0, 0.0]), np.array([0.0, 0.5, 4.0]))
        size = 0.6
    else:
        args = (np.full((120, 160), 50, np.uint8), np.eye(4), (100.0, 100.0, 80.0, 60.0),
                np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, -3.0]))
        size = 0.5
    a, b = T.render_cube(*args, size=size), J.render_cube(*args, size=size)
    np.testing.assert_array_equal(a, b)
    if case == "front":
        assert ((a[..., 1] == 255) & (a[..., 0] == 0)).sum() > 50


@pytest.mark.parametrize("state", [1, 2])
def test_annotate_frame_like_jax(state):
    """Tensor features and associations give the JAX package's image."""
    from orb_slam2_comment_tpu.utils import viz as J
    from orb_slam2_comment_tpu_torch.utils import viz as T

    img = np.full((120, 160), 100, np.uint8)
    f = test_viz.FakeFeats()
    assoc = np.full(30, -1)
    assoc[:10] = np.arange(10)
    tf = SimpleNamespace(xy=torch.from_numpy(f.xy), valid=torch.from_numpy(f.valid))
    a = T.annotate_frame(torch.from_numpy(img), tf, torch.from_numpy(assoc), state=state,
                         n_kfs=3, n_pts=150)
    b = J.annotate_frame(img, f, assoc, state=state, n_kfs=3, n_pts=150)
    np.testing.assert_array_equal(a, b)
    assert ((a[..., 1] == 220) & (a[..., 0] == 0)).sum() > 20


@pytest.mark.parametrize("min_weight", [100, 121])
def test_covisibility_edges_like_jax(min_weight):
    from orb_slam2_comment_tpu.utils import viz as J
    from orb_slam2_comment_tpu_torch.utils import viz as T

    jm = test_viz._small_map()
    got = T.covisibility_edges(_port_map(jm), min_weight)
    assert got == J.covisibility_edges(jm, min_weight)
    assert len(got) == (3 if min_weight == 100 else 0)


def test_plot_map_writes_png(tmp_path):
    from orb_slam2_comment_tpu_torch.utils import viz as T

    p = str(tmp_path / "map.png")
    out = T.plot_map(_port_map(test_viz._small_map()), trajectory=[torch.eye(4)], out_path=p,
                     current_Tcw=np.eye(4), loop_edges=[(0, 2)])
    assert out == p and os.path.getsize(p) > 1000


def test_viewer_snapshots(tmp_path):
    """Every `period` frames: the annotated frame (read back through
    pngio, equal to annotate_frame's) and the map view."""
    from orb_slam2_comment_tpu_torch.utils import pngio
    from orb_slam2_comment_tpu_torch.utils import viz as T

    m = _port_map(test_viz._small_map())
    system = SimpleNamespace(tracker=SimpleNamespace(map=m, state=1, n_kfs=3))
    v = T.Viewer(system, out_dir=str(tmp_path / "views"), period=2)
    img = np.full((120, 160), 90, np.uint8)
    f = test_viz.FakeFeats()
    assert v.update(img, f) is None
    paths = v.update(img, f, Tcw=np.eye(4))
    assert [os.path.basename(p) for p in paths] == ["frame_00002.png", "map_00002.png"]
    np.testing.assert_array_equal(pngio.read(paths[0]),
                                  T.annotate_frame(img, f, None, 1, 3, int(m.pt_valid.sum())))
    assert os.path.getsize(paths[1]) > 1000


def test_ar_demo_runs_on_cpu(tmp_path):
    """The port's ar_demo over 12 frames with --device cpu: a plane is
    found and cube frames are written as PNG."""
    from orb_slam2_comment_tpu_torch.examples import ar_demo
    from orb_slam2_comment_tpu_torch.utils import pngio

    out = tmp_path / "ar"
    assert ar_demo.main(["--frames", "12", "--out", str(out), "--device", "cpu"]) == 0
    files = sorted(out.iterdir())
    assert files
    img = pngio.read(str(files[-1]))
    assert img.shape == (480, 640, 3) and img.dtype == np.uint8
    assert ((img[..., 1] == 255) & (img[..., 0] == 0)).sum() > 20
