"""The check fails a run whose timed path is broken underneath: a pose
solve that returns its state unchanged, a linearization that leaves half
of its observations out, an extraction that alters its answer. (Cells on
one card have no exchange between chips to leave out.) The session runs
as a thread of this process so that the patch reaches it."""

import pytest
import torch

from slam_bench.tests import tiny


def _stale_pose(monkeypatch):
    from orb_slam2_comment_tpu_torch.ops import optim

    real = optim.pose_optimize

    def pose_optimize(Tcw0, *a, **k):
        res = real(Tcw0, *a, **k)
        return res._replace(Tcw=Tcw0.clone())

    monkeypatch.setattr(optim, "pose_optimize", pose_optimize)


def _half_batch(monkeypatch):
    from orb_slam2_comment_tpu_torch.ops import lba_cuda

    real = lba_cuda.build_system

    def build_system(prep, cam_T, pts, obs_ok, robust, K, bf):
        keep = torch.arange(obs_ok.shape[0], device=obs_ok.device) % 2 == 0
        return real(prep, cam_T, pts, obs_ok & keep, robust, K, bf)

    monkeypatch.setattr(lba_cuda, "build_system", build_system)


def _altered_answer(monkeypatch):
    from orb_slam2_comment_tpu_torch.ops import orb

    real = orb._extract_impl

    def extract(image, cfg, shape):
        feats, pyr, stack = real(image, cfg, shape)
        return feats.replace(desc=feats.desc ^ 1), pyr, stack

    monkeypatch.setattr(orb, "_extract_impl", extract)


@pytest.mark.parametrize("fault,number", [(_stale_pose, "pose_dT"), (_half_batch, "lba_err"),
                                          (_altered_answer, "extract_diff_pct")])
def test_fault_makes_correct_false(tmp_path, monkeypatch, fault, number):
    tmp = tiny.make_checkout(tmp_path)
    fault(monkeypatch)
    rc, r = tiny.run_inprocess(tmp, *tiny.args(2 ** 31 + 17, seconds=3))
    assert rc == 0 and r is not None
    assert r["correct"] is False
    c = r["checks"][number]
    assert c["value"] is not None and c["value"] > c["limit"], r["checks"]
