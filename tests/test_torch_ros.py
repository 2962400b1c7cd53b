"""The port's four ROS nodes (orb_slam2_comment_tpu_torch.examples.ros) under
the rospy stub of tests/rosstubs/, on the CPU: the pattern of
tests/test_drivers_all.py's ROS tests (600 features x 4 levels), with
`--device cpu`."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from orb_slam2_comment_tpu_torch.utils import synthetic as syn  # noqa: E402

K = syn.DEFAULT_K
B = syn.DEFAULT_BASELINE
STUBS = str(Path(__file__).resolve().parent / "rosstubs")
NODES = ("ros_mono", "ros_rgbd", "ros_stereo", "ros_mono_ar")
_STUB_MODS = ("rospy", "cv_bridge", "message_filters", "message_filters_registry",
              "sensor_msgs", "sensor_msgs.msg")


def _settings(path, fps=20.0):
    path.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0]}\nCamera.fy: {K[1]}\nCamera.cx: {K[2]}\nCamera.cy: {K[3]}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        f"Camera.bf: {K[0] * B}\nCamera.fps: {fps}\nCamera.RGB: 1\n"
        "Camera.width: 640\nCamera.height: 480\n"
        "ThDepth: 40.0\nDepthMapFactor: 5000.0\n"
        "ORBextractor.nFeatures: 600\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 4\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\nMatcher.thScale: 1.5\n")
    return str(path)


def _mono_poses(n=14):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = -0.12 * np.arange(n)
    poses[:, 2, 3] = -0.02 * np.arange(n)
    return poses


def _check_tum_traj(path, min_rows):
    rows = [r.split() for r in Path(path).read_text().strip().splitlines()]
    assert len(rows) >= min_rows, f"{len(rows)} trajectory rows"
    for r in rows:
        assert len(r) == 8
        assert abs(np.linalg.norm([float(x) for x in r[4:]]) - 1.0) < 1e-3
    return rows


@pytest.fixture()
def ros_env(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(STUBS)
    monkeypatch.chdir(tmp_path)
    for mod in _STUB_MODS:
        sys.modules.pop(mod, None)
    import message_filters_registry as registry
    import rospy

    rospy.reset()
    registry.reset()
    yield rospy
    for mod in _STUB_MODS:
        sys.modules.pop(mod, None)


def _node(name):
    import importlib

    return importlib.import_module(f"orb_slam2_comment_tpu_torch.examples.ros.{name}")


def _img(a, ts):
    from sensor_msgs.msg import Image

    return Image(np.clip(a, 0, 255).astype(np.uint8), ts)


@pytest.mark.parametrize("name", NODES)
def test_ros_node_usage(ros_env, name, capsys):
    """A wrong argument count prints the usage and returns 1 before ROS is
    touched."""
    assert _node(name).main(["-"]) == 1
    assert "Usage:" in capsys.readouterr().out


def test_ros_mono_node(ros_env, tmp_path):
    rospy = ros_env
    scene = syn.make_scene(n_points=1600, seed=0, extent=(8.0, 6.0, 8.0), z_near=1.5)
    for f in syn.render_sequence(scene, _mono_poses(), K=K):
        rospy.PLAYBACK.append(("/camera/image_raw", _img(f["image"], f["timestamp"])))
    argv = ["-", _settings(tmp_path / "settings.yaml"), "--device", "cpu"]
    assert _node("ros_mono").main(argv) == 0
    _check_tum_traj(tmp_path / "KeyFrameTrajectory.txt", min_rows=2)


def test_ros_rgbd_node(ros_env, tmp_path):
    from sensor_msgs.msg import Image

    rospy = ros_env
    scene = syn.make_scene(n_points=1400, seed=0)
    poses = syn.make_trajectory("jitter", n_frames=8, step=0.05)
    for f in syn.render_sequence(scene, poses, K=K, depth=True):
        rospy.PLAYBACK.append(("/camera/rgb/image_raw", _img(f["image"], f["timestamp"])))
        rospy.PLAYBACK.append(("/camera/depth_registered/image_raw",
                               Image(f["depth"].astype(np.float32), f["timestamp"])))
    argv = ["-", _settings(tmp_path / "settings.yaml"), "--device", "cpu"]
    assert _node("ros_rgbd").main(argv) == 0
    rows = _check_tum_traj(tmp_path / "KeyFrameTrajectory.txt", min_rows=1)
    # the first keyframe sits at the first ground-truth camera
    Twc0 = np.linalg.inv(poses[0])
    np.testing.assert_allclose([float(x) for x in rows[0][1:4]], Twc0[:3, 3], atol=0.02)


def test_ros_stereo_node(ros_env, tmp_path):
    rospy = ros_env
    scene = syn.make_scene(n_points=1400, seed=0)
    poses = syn.make_trajectory("jitter", n_frames=8, step=0.05)
    for f in syn.render_sequence(scene, poses, K=K, stereo=True, baseline=B):
        rospy.PLAYBACK.append(("/camera/left/image_raw", _img(f["image"], f["timestamp"])))
        rospy.PLAYBACK.append(("/camera/right/image_raw",
                               _img(f["image_right"], f["timestamp"])))
    argv = ["-", _settings(tmp_path / "settings.yaml"), "false", "--device", "cpu"]
    assert _node("ros_stereo").main(argv) == 0
    _check_tum_traj(tmp_path / "KeyFrameTrajectory.txt", min_rows=1)


def test_ros_stereo_node_refuses_missing_rectification(ros_env, tmp_path):
    """do_rectify=true without LEFT./RIGHT. calibration blocks: the
    reference's error, exit code 1."""
    argv = ["-", _settings(tmp_path / "settings.yaml"), "true", "--device", "cpu"]
    assert _node("ros_stereo").main(argv) == 1


def test_ros_mono_ar_node(ros_env, tmp_path):
    rospy = ros_env
    # a dominant ground plane, so the plane RANSAC can succeed
    scene = syn.make_scene(n_points=1600, seed=0, extent=(8.0, 6.0, 8.0), z_near=1.5,
                           planar_frac=0.6)
    for f in syn.render_sequence(scene, _mono_poses(18), K=K):
        rospy.PLAYBACK.append(("/camera/image_raw", _img(f["image"], f["timestamp"])))
    argv = ["-", _settings(tmp_path / "settings.yaml"), "--device", "cpu"]
    assert _node("ros_mono_ar").main(argv) == 0
    pubs = [m for t, m in rospy.published() if t == "/orb_slam2/ar_image"]
    assert pubs, "the AR node never published an overlay frame"
