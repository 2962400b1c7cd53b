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


def _jax_k1(level_np):
    """K1 of the JAX package on one level: (fast_nms_pallas in interpret
    mode, _nms3(where(inb, fast_score_map))) as numpy."""
    from orb_slam2_comment_tpu import constants as C
    from orb_slam2_comment_tpu.ops import orb as jorb

    h, w = level_np.shape
    img = jnp.asarray(level_np)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    m = C.EDGE_THRESHOLD
    inb = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    return (np.asarray(jorb.fast_nms_pallas(img, interpret=True)),
            np.asarray(jorb._nms3(jnp.where(inb, jorb.fast_score_map(img), 0.0))))


@pytest.mark.parametrize("hw", [(134, 178), (96, 128)])
def test_fast_nms_plain_bit_equal(hw):
    """K1's plain version is bit-equal to fast_nms_pallas (interpret) and to
    the JAX jnp path: FAST scores are max/min of f32 differences and the
    NMS tie-break is exact, so nothing may differ."""
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    h, w = hw
    r = np.random.default_rng(0)
    # integer-valued like level 0, plus a resampled-looking real-valued image
    for img_np in (r.integers(0, 255, (h, w)).astype(np.float32),
                   (r.random((h, w)) * 255).astype(np.float32)):
        got = torb.fast_nms_plain(torch.from_numpy(img_np)).numpy()
        pal, ref = _jax_k1(img_np)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("kind", ["integer", "real"])
def test_fast_nms_levels_stack_bit_equal(kind):
    """The stack entry of K1 on the CPU: a 3-level zero-padded stack, each
    level bit-equal to fast_nms_pallas (interpret) and to the JAX jnp
    path."""
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    r = np.random.default_rng(0)
    sizes = [(134, 178), (112, 148), (93, 124)]
    levels = [r.integers(0, 255, hw).astype(np.float32) if kind == "integer"
              else (r.random(hw) * 255).astype(np.float32) for hw in sizes]
    stack = torb._level_stack([torch.from_numpy(lv) for lv in levels], sizes[0])
    got = torb.fast_nms_levels(stack, sizes)
    assert len(got) == 3
    for lv, g in zip(levels, got):
        pal, ref = _jax_k1(lv)
        np.testing.assert_array_equal(g.numpy(), ref)
        np.testing.assert_array_equal(g.numpy(), pal)


def _tile_rects(table, head):
    """[T, 6] rows (level, y0, x0, y1, x1, border) of every tile of a K1
    table, decoded as csrc/fast_nms.cu decodes its block index: pixels
    [y0, y1) x [x0, x1) of the level; border = the tile lies wholly
    outside the level's mask, so the kernel writes zeros there."""
    L, m, th, tw = int(table[0]), int(table[4]), int(table[5]), int(table[6])
    hs, ws, tiles_x = (table[head + i * L:head + (i + 1) * L] for i in range(3))
    start = table[head + 4 * L:]
    rows = []
    for t in range(int(start[L])):
        lv = 0
        while lv + 1 < L and t >= start[lv + 1]:
            lv += 1
        h, w, i = int(hs[lv]), int(ws[lv]), t - int(start[lv])
        y0, x0 = (i // int(tiles_x[lv])) * th, (i % int(tiles_x[lv])) * tw
        y1, x1 = min(y0 + th, h), min(x0 + tw, w)
        border = y1 <= m or y0 >= h - m or x1 <= m or x0 >= w - m
        rows.append((lv, y0, x0, y1, x1, int(border)))
    return np.asarray(rows, np.int64)


@pytest.mark.parametrize("hw", [(480, 640), (376, 1241)])
def test_k1_tile_table_covers_each_pixel_once(hw):
    """K1's host tile table over an 8-level pyramid: every pixel of every
    level in exactly one tile, no tile crossing its level, and the tiles
    flagged as border exactly those with no pixel inside the mask. A stack
    too small for a level is refused."""
    from orb_slam2_comment_tpu_torch import constants as C
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    sizes = tuple(torb.ORBConfig(n_levels=8).level_sizes(*hw))
    Hp, Wp = torb._level_stack([torch.zeros(hw)], hw).shape[1:]
    table = torb.k1_table(sizes, Hp, Wp)
    rects = _tile_rects(table, torb.K1_HEAD)
    m = C.EDGE_THRESHOLD
    assert int(table[0]) == 8 and rects[:, 5].any()
    for lv, (h, w) in enumerate(sizes):
        mine = rects[rects[:, 0] == lv]
        assert (mine[:, 1] >= 0).all() and (mine[:, 3] <= h).all()
        assert (mine[:, 2] >= 0).all() and (mine[:, 4] <= w).all()
        cover = np.zeros((h, w), np.int32)
        inb = np.zeros((h, w), bool)
        inb[m:h - m, m:w - m] = True
        for _, y0, x0, y1, x1, border in mine:
            cover[y0:y1, x0:x1] += 1
            assert bool(border) == (not inb[y0:y1, x0:x1].any())
        assert (cover == 1).all()
    # the per-level views of the kernel's flat output partition it in order
    flat = torch.arange(sum(h * w for h, w in sizes))
    views = torb.k1_views(flat, sizes, table)
    assert [tuple(v.shape) for v in views] == list(sizes)
    assert torch.equal(torch.cat([v.reshape(-1) for v in views]), flat)
    with pytest.raises(ValueError):
        torb.k1_table(sizes, sizes[0][0], Wp)


@pytest.mark.parametrize("hw", [(96, 128), (70, 90)])
def test_k1_stack_zeros_equal_edge_replication(hw):
    """Scoring a level from the stack's 3-px zeros gives the plain output
    of the edge-replicated level, inside the mask and outside it: only
    pixels >= 19 px from the border get a score, and their ring and NMS
    window lie inside the level."""
    from orb_slam2_comment_tpu_torch import constants as C
    from orb_slam2_comment_tpu_torch.ops import orb as torb

    h, w = hw
    pd, m = torb._PATCH_PAD, C.EDGE_THRESHOLD
    level = torch.from_numpy((np.random.default_rng(4).random(hw) * 255).astype(np.float32))
    stack = torb._level_stack([level], hw)
    # the score map read from the zeros round the level (cropped so that no
    # ring reaches past them)
    zeros_score = torb.fast_score_map(stack[0, :h + 2 * pd, :w + 2 * pd])[pd:pd + h, pd:pd + w]
    inb = torch.zeros(hw, dtype=torch.bool)
    inb[m:h - m, m:w - m] = True
    from_zeros = torb._nms3(torch.where(inb, zeros_score, torch.zeros_like(level)))
    plain = torb.fast_nms_plain(level)
    assert torch.equal(from_zeros, plain)
    assert not torch.equal(zeros_score[~inb], torb.fast_score_map(level)[~inb])
    assert (plain[~inb] == 0).all() and (plain[inb] > 0).any()


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
