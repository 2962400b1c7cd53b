"""The frozen generator: the same seed gives the same frames, another
seed other frames; the renderer's depth is the ray's z."""

import numpy as np
import pytest
import torch

from slam_bench import render, scene, traffic
from slam_bench.reference import ref_orb

TUM1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)

SLAM = dict(sensor="rgbd", fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120,
            fps=30.0, bf=40.0, depth_map_factor=5000.0)
MIX = dict(sessions=2, read="pipelined", frames=4, supersample=1, noise=1.5, pool=3,
           scene=dict(kind="hall", length=3.0, tex_size=64),
           trajectory=dict(kind="hall_walk", step=0.05))


def test_same_seed_same_frames():
    a = traffic.make_sequence(SLAM, MIX, 2 ** 31 + 9, 0, "cpu")
    b = traffic.make_sequence(SLAM, MIX, 2 ** 31 + 9, 0, "cpu")
    c = traffic.make_sequence(SLAM, MIX, 2 ** 31 + 9, 1, "cpu")
    assert a.images.dtype == np.uint8 and a.depth.dtype == np.uint16
    assert np.array_equal(a.images, b.images) and np.array_equal(a.depth, b.depth)
    assert np.array_equal(a.poses, b.poses)
    assert not np.array_equal(a.images, c.images)


def test_every_seed_hands_out_the_same_pool():
    """Another seed gives the same set of sequences in its own order."""
    seeds = [traffic.session_seeds(s, i, MIX) for s in range(6) for i in range(2)]
    members = {(x["member"], x["scene"], x["trajectory"], x["noise"]) for x in seeds}
    assert len(members) == 2
    assert {tuple(traffic.session_seeds(s, i, MIX)["member"] for i in range(2))
            for s in range(6)} == {(0, 1), (1, 0)}


def test_stereo_pair_and_depth():
    slam = dict(SLAM, sensor="stereo", bf=130.0 * 0.5)
    s = traffic.make_sequence(slam, MIX, 5, 0, "cpu")
    assert s.depth is None and s.right.shape == s.images.shape
    assert not np.array_equal(s.images, s.right)


def test_wall_depth_is_its_distance():
    """A camera at the origin looking down +z at the hall's far end wall
    (z = length) reads that distance at the centre pixel."""
    sc = scene.make_hall(seed=1, length=6.0, tex_size=64, box_every=100.0)
    r = render.Renderer(sc, (130.0, 130.0, 80.0, 60.0), (120, 160), "cpu", 1, 0.0)
    img, dep = r.render(np.eye(4))
    assert abs(float(dep[60, 80]) - 6.0) < 1e-4
    assert float(img.min()) >= 0 and float(img.max()) <= 255
    d16 = render.to_depth16(torch.tensor([[1.0, 20.0]]), 5000.0)
    assert d16.tolist() == [[5000, 0]]   # past the format's range: no measurement


def test_frame_cache_gives_the_rendered_frames(tmp_path):
    """A second session of the same pool member loads what the first
    rendered; another member renders (and stores) its own."""
    a = traffic.make_sequence(SLAM, MIX, 2 ** 31 + 9, 0, "cpu", cache=tmp_path)
    assert len(list(tmp_path.iterdir())) == 1
    b = traffic.make_sequence(SLAM, MIX, 2 ** 31 + 9, 0, "cpu", cache=tmp_path)
    assert np.array_equal(a.images, b.images) and np.array_equal(a.depth, b.depth)
    assert np.array_equal(a.poses, b.poses)
    traffic.make_sequence(SLAM, MIX, 2 ** 31 + 9, 1, "cpu", cache=tmp_path)
    assert len(list(tmp_path.iterdir())) == 2
    assert traffic.cache_key(SLAM, MIX, 0) != traffic.cache_key(dict(SLAM, k1=0.1), MIX, 0)


@pytest.mark.parametrize("dist", [TUM1_DIST, (-0.3, 0.1, 0.001, -0.002, 0.0)])
def test_distortion_round_trip(dist):
    """The renderer's ray grid and the reference's undistortion invert the
    radial-tangential model the configuration states."""
    K = (130.0, 130.0, 80.0, 60.0)
    u, v = np.meshgrid(np.arange(0.0, 160.0, 3.0), np.arange(0.0, 120.0, 3.0))
    xd, yd = (u.ravel() - K[2]) / K[0], (v.ravel() - K[3]) / K[1]
    x, y = render.undistort_normalized(xd, yd, dist)
    ex, ey = render.distort_normalized(x, y, dist)
    assert max(np.abs(ex - xd).max(), np.abs(ey - yd).max()) < 1e-9
    xy = torch.from_numpy(np.stack([u.ravel(), v.ravel()], -1))
    ref = ref_orb.undistort(xy, K, dist).numpy()
    assert np.abs(ref - np.stack([x * K[0] + K[2], y * K[1] + K[3]], -1)).max() < 1e-6


def test_distorted_frame_sees_the_same_wall():
    """Through a distortion the centre ray is unchanged and the image
    still covers the scene: the far wall's depth at the principal point."""
    sc = scene.make_hall(seed=1, length=6.0, tex_size=64, box_every=100.0)
    r = render.Renderer(sc, (130.0, 130.0, 80.0, 60.0), (120, 160), "cpu", 1, 0.0, TUM1_DIST)
    plain = render.Renderer(sc, (130.0, 130.0, 80.0, 60.0), (120, 160), "cpu", 1, 0.0)
    img, dep = r.render(np.eye(4))
    img0, _ = plain.render(np.eye(4))
    assert abs(float(dep[60, 80]) - 6.0) < 1e-4
    assert float((img - img0).abs().mean()) > 1.0
