"""The metric arithmetic on synthetic timelines."""

import importlib.util

import numpy as np
import pytest

from slam_bench import reduce, roofline
from slam_bench.tests import tiny


def metric(name):
    sp = importlib.util.spec_from_file_location(name, tiny.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def test_rate_counts_the_drain():
    """fps is every frame handed in over the whole window, the drain
    included: 300 frames in 10 s of calls and 2 s of drain."""
    assert reduce.rate(300, 12.0) == pytest.approx(25.0)


def test_p95_over_every_frame():
    lat = [np.arange(1, 101, dtype=float), np.full(100, 50.0)]
    allv = np.concatenate(lat)
    assert reduce.percentile(allv, 95) == pytest.approx(np.percentile(allv, 95))
    assert reduce.percentile(allv, 95) != pytest.approx(np.mean([np.percentile(v, 95)
                                                                for v in lat]))


def test_union_and_idle():
    s = np.array([0, 5, 7, 20, 30], np.int64)
    e = np.array([10, 6, 12, 25, 31], np.int64)
    bs, be = reduce.union(s, e)
    assert bs.tolist() == [0, 20, 30] and be.tolist() == [12, 25, 31]
    assert reduce.busy_ns(s, e, 0, 40) == 12 + 5 + 1
    assert reduce.busy_ns(s, e, 8, 22) == 4 + 2          # clipped to the window
    gs, ge = reduce.gaps(s, e, 0, 40)
    assert list(zip(gs.tolist(), ge.tolist())) == [(12, 20), (25, 30), (31, 40)]


def test_idle_gaps_named_by_open_spans():
    gs, ge = np.array([100, 300]), np.array([200, 340])
    a = (np.array([90, 250]), np.array([210, 260]), ["track_call", "track_call"])
    b = (np.array([280]), np.array([400]), ["resolve_wait"])
    assert reduce.label_gaps(gs, ge, [a, b]) == [["track_call", 100e-9],
                                                ["resolve_wait", 40e-9]]
    assert reduce.label_gaps(np.array([500]), np.array([510]), [a, b]) == [
        ["between_calls", 10e-9]]


def test_device_readers_on_a_synthetic_trace():
    """idle share from the union; K1's roofline as launches x bound over
    its device time; K3's as summed bounds over its device time."""
    trace = dict(start=np.array([0, 10, 50], np.int64), end=np.array([20, 30, 60], np.int64),
                 name=np.array([0, 1, 1], np.int32),
                 names=["fast_nms_levels_kernel(Levels)", "pose_lm_kernel(float const*)"])
    names = reduce.by_name([trace, trace])
    assert names["fast_nms_levels_kernel(Levels)"] == [pytest.approx(40e-9), 2]
    k3 = roofline.k3_bound_s(1, 1000, 500) + roofline.k3_bound_s(5, 1000, 2000)
    run = dict(device=dict(busy_s=40e-9, window_s=100e-9, names=names, k1_bound_s=5e-9,
                           k3_bound_s=k3))
    assert metric("device.idle_pct")(run) == pytest.approx(60.0)
    assert metric("K1_roofline")(run) == pytest.approx(100.0 * 2 * 5e-9 / 40e-9)
    assert metric("K3_roofline")(run) == pytest.approx(100.0 * k3 / 60e-9)
    assert metric("K1_roofline")(dict(device=None)) is None


def test_bounds_are_chip_smokes():
    """The frozen bounds give chip_smoke's K1 and K3 rows (PERF.md, run
    11.4): K1 at 480x640 0.008107 ms, K3 over 1000 edges 0.000172 ms."""
    sizes = [(max(int(round(480 / 1.2 ** l)), 64), max(int(round(640 / 1.2 ** l)), 64))
             for l in range(8)]
    rate = roofline.minmax_rate(132, 1980.0)
    assert roofline.k1_bound_s(sizes, rate) * 1e3 == pytest.approx(0.008107, rel=2e-3)
    n_valid = int(0.9 * 1000)
    assert roofline.k3_bound_s(1, 1000, n_valid) * 1e3 == pytest.approx(0.000172, rel=0.05)


def test_host_readers():
    s = dict(t0=np.array([0, 100], np.int64), t1=np.array([40e6, 130e6], np.int64),
             t2=np.array([50e6, 200e6], np.int64), syncs=6, transfer_waits=2, kf_created=3)
    run = dict(sessions=[s, dict(s, t2=None, syncs=None)], frames=4)
    assert metric("host.call_ms")(run) == pytest.approx((40 + 130 - 0.0001) / 2, rel=1e-6)
    assert metric("host.syncs_per_frame")(run) is None
    assert metric("pipeline.transfer_waits_per_frame")(run) == pytest.approx(1.0)
    assert metric("mapper.kf_per_100_frames")(run) == pytest.approx(150.0)
    assert metric("resolve.wait_p95_ms")(run) == pytest.approx(
        np.percentile([10.0, 70.0], 95))
