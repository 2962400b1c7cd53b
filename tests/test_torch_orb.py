"""Parity of the port's ORB extraction (orb_slam2_comment_tpu_torch.ops.orb)
with the JAX package on the CPU: kernel K1 (FAST + NMS) and K2 (patch
gather) through their plain versions against the Pallas kernels in
interpret mode, the BRIEF matrix, and whole-image extraction."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(134, 178), (96, 128)])
def test_fast_nms_plain_bit_equal(hw):
    """K1's plain version is bit-equal to fast_nms_pallas (interpret) and to
    the JAX jnp path: FAST scores are max/min of f32 differences and the
    NMS tie-break is exact, so nothing may differ."""
    from orb_slam2_comment_tpu import constants as C
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    h, w = hw
    r = np.random.default_rng(0)
    # integer-valued like level 0, plus a resampled-looking real-valued image
    for img_np in (r.integers(0, 255, (h, w)).astype(np.float32),
                   (r.random((h, w)) * 255).astype(np.float32)):
        img = jnp.asarray(img_np)
        got = torb.fast_nms(torch.from_numpy(img_np)).numpy()
        pal = np.asarray(jorb.fast_nms_pallas(img, interpret=True))
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        m = C.EDGE_THRESHOLD
        inb = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
        ref = np.asarray(jorb._nms3(jnp.where(inb, jorb.fast_score_map(img), 0.0)))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pal)


def test_gather_patches_plain_bit_equal():
    """K2's plain version equals gather_patches_pallas (interpret) on the
    48x48 patch, bit for bit."""
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    r = np.random.default_rng(1)
    L, Hp, Wp = 4, 160, 640
    padded = r.normal(size=(L, Hp, Wp)).astype(np.float32)
    n = 37
    lyx = np.stack([r.integers(0, L, n), r.integers(0, Hp - jorb._GATHER_BH, n),
                    r.integers(0, Wp - jorb._GATHER_BW, n)], axis=1).astype(np.int32)
    pal = np.asarray(jorb.gather_patches_pallas(jnp.asarray(padded), jnp.asarray(lyx),
                                                interpret=True))[:, :, :48]
    got = torb.gather_patches(torch.from_numpy(padded), torch.from_numpy(lyx)).numpy()
    np.testing.assert_array_equal(got, pal)


def test_brief_matrix_and_pattern_array_equal():
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(torb._brief_matrix_np(), jorb._brief_matrix_np())


def test_pack_unpack_bits_match():
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    r = np.random.default_rng(2)
    bits = r.random((17, 256)) < 0.5
    jd = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    td = torb.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(td.view(np.uint32), jd)
    js = np.asarray(jorb.unpack_descriptors_signed(jnp.asarray(jd), jnp.float32))
    ts = torb.unpack_descriptors_signed(torch.from_numpy(td)).numpy()
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("cfg_kw,hw", [
    (dict(n_features=500, n_levels=4), (240, 320)),
    (dict(n_features=1000, n_levels=8), (480, 640)),
])
def test_extraction_matches_jax(cfg_kw, hw):
    """Whole-image extraction against the JAX CPU path. The pyramid levels
    come from f32 resize products whose summation order differs between
    the frameworks, so level scores can differ in the last ulp and flip a
    tie; the bar is the reference's own cross-path bar
    (tests/test_tpu_parity.py): equal valid counts, xy within 1e-3, fewer
    than 1% of descriptor rows differing."""
    from orb_slam2_comment_tpu.ops import orb as jorb
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    h, w = hw
    K = (520.0 * w / 640, 520.0 * h / 480, w / 2.0, h / 2.0)
    scene = syn.make_scene(n_points=1500, seed=3)
    img = syn.render(scene, np.eye(4, dtype=np.float32), K, (h, w), seed=7)
    img = np.clip(img, 0, 255).astype(np.uint8)
    jf, _ = jorb.extract(jnp.asarray(img), jorb.ORBConfig(**cfg_kw))
    tf, _ = torb.extract(torch.from_numpy(img), torb.ORBConfig(**cfg_kw))
    va, vb = tf.valid.numpy(), np.asarray(jf.valid)
    assert va.sum() == vb.sum() and va.sum() > 0.5 * va.shape[0]
    np.testing.assert_allclose(tf.xy.numpy()[va], np.asarray(jf.xy)[vb], atol=1e-3)
    np.testing.assert_array_equal(tf.octave.numpy(), np.asarray(jf.octave))
    da = tf.desc.numpy().view(np.uint32)[va]
    db = np.asarray(jf.desc)[vb]
    mismatch = (da != db).any(axis=1).mean()
    assert mismatch < 0.01, f"{mismatch * 100:.2f}% descriptor rows differ"
    # IC angles: moments of bf16-rounded pixels summed in another order;
    # atan2 of small moments magnifies that (observed max 2.7e-3 rad)
    np.testing.assert_allclose(tf.angle.numpy()[va], np.asarray(jf.angle)[vb], atol=5e-3)
