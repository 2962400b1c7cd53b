"""Nothing a run loads may be JAX or the JAX package, by whole top-level
name."""

import json

from slam_bench import forbidden_modules
from slam_bench.tests import tiny


def test_names_compared_whole():
    assert forbidden_modules(["orb_slam2_comment_tpu_torch", "orb_slam2_comment_tpu_torch.ops",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                              "orb_slam2_comment_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "orb_slam2_comment_tpu"]


def test_tiny_run_loads_none(tiny_run):
    """After a tiny CPU run nothing forbidden is loaded in the parent or
    the session process: the run checks both and exits 0 only then."""
    rc, out, err = tiny_run
    assert rc == 0, err[-3000:]
    assert json.loads(out[-1])["attempted"] > 0


def test_a_loaded_jax_package_is_refused(tmp_path, monkeypatch):
    """A forbidden name in sys.modules after the window: non-zero exit,
    no result line."""
    import sys
    import types

    tmp = tiny.make_checkout(tmp_path)
    monkeypatch.setitem(sys.modules, "orb_slam2_comment_tpu", types.ModuleType("x"))
    rc, result = tiny.run_inprocess(tmp, *tiny.args(7, seconds=1))
    assert rc != 0 and result is None
