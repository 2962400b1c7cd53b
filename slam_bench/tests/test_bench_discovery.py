"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and entries alone: the harness finds each by name."""

import json

from slam_bench.tests import tiny


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    tmp = tiny.make_checkout(tmp_path)
    b = tmp / "slam_bench"
    conf = json.loads((b / "configs" / "tiny_rgbd.json").read_text())
    conf["slam"]["th_depth"] = 45.0
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "tiny-pipelined.json").read_text())
    mix["read"] = "resolved"
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "dummy.frames.py").write_text(
        "def read(run):\n    return float(run['frames'])\n")
    (b / "limits" / "dummy_cfg.dummy-mix.json").write_text(
        (b / "limits" / f"{tiny.CELL}.json").read_text())
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="dummy_cfg", source="test",
                                file="slam_bench/configs/dummy_cfg.json", reduced=[],
                                why="test"))
    spec["workloads"].append(dict(name="dummy_cfg.dummy-mix", config="dummy_cfg",
                                  traffic="dummy-mix", chips=1, why="test"))
    spec["per_layer"].append(dict(name="dummy.frames", unit="frames", better="higher",
                                  source="host_clock", layer="test", moves="fps",
                                  workloads=["dummy_cfg.dummy-mix"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    argv = tiny.args(2 ** 33 + 1, trace=1, seconds=2)
    argv[1] = "dummy_cfg.dummy-mix"
    rc, out, err = tiny.run_subprocess(tmp, *argv)
    assert rc == 0, err[-3000:]
    r = json.loads(out[-1])
    assert r["metrics"]["dummy.frames"]["value"] == r["attempted"] > 0
    assert r["metrics"]["dummy.frames"]["unit"] == "frames"
    assert "host.call_ms" in r["metrics"] and "resolve.wait_p95_ms" in r["metrics"]
    # a device metric finds no trace on the CPU and is left out, never 0
    assert "device.idle_pct" not in r["metrics"] and "K1_roofline" not in r["metrics"]
