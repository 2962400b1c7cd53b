"""What the port's drivers read, against the JAX package on the CPU: the
PNG codec (against PIL and the JAX package's readers), the settings
readers, the four dataset loaders, the renderer and the run_synthetic
twin. tests/test_torch_run_dataset.py drives the run_dataset twin on the
fixtures written here."""

import importlib
import io
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)



def _pil_png(arr, **kw):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="PNG", **kw)
    return b.getvalue()


def _pil_read(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _texture(h=60, w=80, seed=0):
    """Smooth rows with noise, so PIL's adaptive filtering picks several
    row filters."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return (128 + 60 * np.sin(x / 7.0) + 50 * np.cos(y / 5.0)
            + r.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)


def _images():
    g = _texture()
    rgb = np.stack([g, g[::-1], np.roll(g, 7, 1)], -1)
    return dict(gray8=g, gray16=(g.astype(np.uint16) * 257 + 11).astype(np.uint16), rgb=rgb,
                rgba=np.concatenate([rgb, g[..., None]], -1))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb", "rgba"])
def test_png_reads_what_pil_writes(kind):
    """pngio decodes PIL's files to PIL's own arrays, exactly."""
    from orb_slam2_comment_tpu_torch.utils import pngio

    data = _pil_png(_images()[kind])
    want = _pil_read(data)
    got = pngio.decode(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["palette", "gray_alpha", "interlaced", "not_png"])
def test_png_refuses_what_it_does_not_read(kind):
    """Palette, gray-with-alpha and interlaced PNGs, and other files, raise
    ValueError rather than decode wrongly."""
    from PIL import Image

    from orb_slam2_comment_tpu_torch.utils import pngio

    rgb, g = _images()["rgb"], _images()["gray8"]
    b = io.BytesIO()
    if kind == "palette":
        Image.fromarray(rgb).quantize(colors=32).save(b, format="PNG")
    elif kind == "gray_alpha":
        Image.fromarray(np.stack([g, g[::-1]], -1), mode="LA").save(b, format="PNG")
    elif kind == "interlaced":   # the IHDR's interlace byte set, its CRC redone
        data = bytearray(_filtered_png(g, 0))
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        b.write(bytes(data))
    else:
        Image.fromarray(g).save(b, format="BMP")
    with pytest.raises(ValueError):
        pngio.decode(b.getvalue())


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit gray or RGB PNG whose every row uses filter `ftype`,
    encoded here straight from the PNG specification's definitions."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(x)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    ctype = 0 if img.ndim == 2 else 2
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_row_filters(ftype):
    """Each of the five row filters, on gray and RGB rows: pngio and PIL
    both give back the image exactly."""
    from orb_slam2_comment_tpu_torch.utils import pngio

    for img in (_images()["gray8"], _images()["rgb"]):
        data = _filtered_png(img, ftype)
        np.testing.assert_array_equal(_pil_read(data), img)
        np.testing.assert_array_equal(pngio.decode(data), img)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb"])
def test_png_round_trip(kind, tmp_path):
    """pngio writes what it and PIL read back exactly."""
    from orb_slam2_comment_tpu_torch.utils import pngio

    img = _images()[kind]
    pngio.write(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    for got in (pngio.read(str(tmp_path / "a.png")), _pil_read(data)):
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError):
        pngio.encode(_images()["rgba"])


def _jax_native_reader():
    """The JAX package's native PNG reader, which its load_image_gray and
    load_image_gray_u8 call (imported again here: the first import, racing
    other processes that build it, can fail)."""
    try:
        return importlib.import_module("orb_slam2_comment_tpu._native.slamio")
    except ImportError:
        return None


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray8", "gray16"])
def test_gray_like_jax(kind, tmp_path):
    """The port's f32 and u8 gray equal the JAX package's load_image_gray
    and load_image_gray_u8 (its native reader) on the same PNG, exactly."""
    from orb_slam2_comment_tpu.utils import datasets as jds
    from orb_slam2_comment_tpu_torch.utils import datasets as tds

    p = str(tmp_path / "c.png")
    Path(p).write_bytes(_pil_png(_images()[kind]))
    native = _jax_native_reader()
    if jds._slamio() is not None:
        jf, ju = jds.load_image_gray(p), jds.load_image_gray_u8(p)
    elif native is not None:
        jf, ju = native.read_image(p, kind=0), native.read_image(p, kind=2)
    else:   # no toolchain: slamio's formula, written out
        a = _pil_read(Path(p).read_bytes())
        if a.ndim == 3:
            a = a.astype(np.float32)
            a = (np.float32(0.299) * a[..., 0] + np.float32(0.587) * a[..., 1]
                 + np.float32(0.114) * a[..., 2])
        jf = a.astype(np.float32)
        ju = (np.minimum(jf, 255) + np.float32(0.5)).astype(np.uint8)
    tf, tu = tds.load_image_gray(p), tds.load_image_gray_u8(p)
    assert tf.dtype == np.float32 and tu.dtype == np.uint8
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tu, ju)


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

def _settings_tum(fx, fy, cx, cy, bf, extra=""):
    """tests/test_examples.py's TUM settings (plus `extra`)."""
    return ("%YAML:1.0\n"
            f"Camera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.bf: {bf}\n"
            "Camera.fps: 30.0\nCamera.RGB: 1\n"
            "Camera.width: 640\nCamera.height: 480\n"
            "ThDepth: 40.0\nDepthMapFactor: 5000.0\n"
            "ORBextractor.nFeatures: 600\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 4\nORBextractor.iniThFAST: 20\n"
            "ORBextractor.minThFAST: 7\n" + extra)


def _settings_kitti(fx, fy, cx, cy, bf):
    """tests/test_examples.py's KITTI settings."""
    return ("%YAML:1.0\n"
            f"Camera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.bf: {bf}\n"
            "Camera.fps: 10.0\nCamera.RGB: 1\nThDepth: 35.0\n"
            "ORBextractor.nFeatures: 600\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 4\nORBextractor.iniThFAST: 20\n"
            "ORBextractor.minThFAST: 7\n")


def _ocv_mat(name, rows, cols, vals):
    """tests/test_drivers_all.py's OpenCV matrix node."""
    data = ", ".join(f"{v:.12f}" for v in np.asarray(vals).ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
            f"   dt: d\n   data: [{data}]\n")


def _euroc_rectification():
    """The LEFT./RIGHT. blocks of tests/test_drivers_all.py's stereo EuRoC
    settings: raw cameras yawed +-0.8 deg, undistorted, the rectified
    pair's K and baseline."""
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    fx, fy, cx, cy = syn.DEFAULT_K
    Km = [fx, 0, cx, 0, fy, cy, 0, 0, 1]
    P = [fx, 0, cx, 0, 0, fy, cy, 0, 0, 0, 1, 0]
    Pr = [fx, 0, cx, -fx * syn.DEFAULT_BASELINE, 0, fy, cy, 0, 0, 0, 1, 0]
    th = np.deg2rad(0.8)

    def yaw(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    return ("LEFT.height: 480\nLEFT.width: 640\n" + _ocv_mat("LEFT.D", 1, 5, [0.0] * 5)
            + _ocv_mat("LEFT.K", 3, 3, Km) + _ocv_mat("LEFT.R", 3, 3, yaw(th))
            + _ocv_mat("LEFT.P", 3, 4, P) + "RIGHT.height: 480\nRIGHT.width: 640\n"
            + _ocv_mat("RIGHT.D", 1, 5, [0.01, -0.002, 0.0, 0.0, 0.0])
            + _ocv_mat("RIGHT.K", 3, 3, Km) + _ocv_mat("RIGHT.R", 3, 3, yaw(-th))
            + _ocv_mat("RIGHT.P", 3, 4, Pr))


def _settings_files(d):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    fx, fy, cx, cy = syn.DEFAULT_K
    bf = fx * syn.DEFAULT_BASELINE
    files = dict(tum=_settings_tum(fx, fy, cx, cy, bf), kitti=_settings_kitti(fx, fy, cx, cy, bf),
                 euroc=_settings_tum(fx, fy, cx, cy, bf, "Matcher.thScale: 1.5\n"
                                     + _euroc_rectification()))
    for k, v in files.items():
        (d / f"{k}.yaml").write_text(v)
    return {k: str(d / f"{k}.yaml") for k in files}


@pytest.mark.parametrize("which", ["tum", "kitti", "euroc"])
def test_settings_like_jax(which, tmp_path):
    """load_yaml_settings gives JAX's SlamConfig field for field (the
    derived intrinsics too), for each sensor; load_rectification gives
    JAX's arrays where the file has the blocks and None where it has
    not."""
    import dataclasses

    from orb_slam2_comment_tpu.utils import config as jc
    from orb_slam2_comment_tpu_torch.utils import config as tc

    path = _settings_files(tmp_path)[which]
    for sensor in ("rgbd", "stereo", "monocular"):
        a, b = tc.load_yaml_settings(path, sensor), jc.load_yaml_settings(path, sensor)
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert (a.K, a.baseline, a.depth_threshold, a.th_low, a.orb.level_budgets()) == (
            b.K, b.baseline, b.depth_threshold, b.th_low, b.orb.level_budgets())
    ra, rb = tc.load_rectification(path), jc.load_rectification(path)
    assert (ra is None) == (rb is None) == (which != "euroc")
    if ra is not None:
        assert ra[8] == rb[8] == (480, 640)
        for x, y in zip(ra[:8], rb[:8], strict=True):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# loaders and the renderer
# ---------------------------------------------------------------------------

def _frames(n, stereo=False, depth=False):
    from orb_slam2_comment_tpu_torch.utils import synthetic as syn

    scene = syn.make_scene(n_points=1400, seed=0)
    poses = syn.make_trajectory("jitter", n_frames=n, step=0.05)
    return list(syn.render_sequence(scene, poses, K=syn.DEFAULT_K, stereo=stereo, depth=depth))


def _u8(a):
    return np.clip(a, 0, 255).astype(np.uint8)


def _write_tum(root, n):
    """tests/test_examples.py's TUM RGB-D fixture: PIL-written PNGs,
    uint16 depth at 5000 units per metre, an associations file."""
    from PIL import Image

    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    lines, mono = [], ["# comment line"]
    for i, f in enumerate(_frames(n, depth=True)):
        ts = f["timestamp"]
        Image.fromarray(_u8(f["image"])).save(root / "rgb" / f"{i}.png")
        Image.fromarray(np.clip(f["depth"] * 5000.0, 0, 65535).astype(np.uint16)).save(
            root / "depth" / f"{i}.png")
        lines.append(f"{ts:.6f} rgb/{i}.png {ts:.6f} depth/{i}.png")
        mono.append(f"{ts:.6f} rgb/{i}.png")
    (root / "associations.txt").write_text("\n".join(lines) + "\n")
    (root / "rgb.txt").write_text("\n".join(mono) + "\n")


def _write_kitti(root, n):
    from PIL import Image

    (root / "image_0").mkdir()
    (root / "image_1").mkdir()
    times = []
    for i, f in enumerate(_frames(n, stereo=True)):
        Image.fromarray(_u8(f["image"])).save(root / "image_0" / f"{i:06d}.png")
        Image.fromarray(_u8(f["image_right"])).save(root / "image_1" / f"{i:06d}.png")
        times.append(f"{f['timestamp']:.6e}")
    (root / "times.txt").write_text("\n".join(times) + "\n")


def _write_euroc(root, n):
    from PIL import Image

    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
    names = []
    for i, f in enumerate(_frames(n, stereo=True)):
        ns = int(round(1.4e9 + i * 5e7))
        Image.fromarray(_u8(f["image"])).save(root / "mav0" / "cam0" / "data" / f"{ns}.png")
        Image.fromarray(_u8(f["image_right"])).save(root / "mav0" / "cam1" / "data" / f"{ns}.png")
        names.append(f"{ns}")
    (root / "timestamps.txt").write_text("\n".join(names) + "\n")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    tum, kitti, euroc = (tmp_path_factory.mktemp(n) for n in ("tum", "kitti", "euroc"))
    _write_tum(tum, 8)
    _write_kitti(kitti, 6)
    _write_euroc(euroc, 3)
    settings = _settings_files(tmp_path_factory.mktemp("settings"))
    for root, which in ((tum, "tum"), (kitti, "kitti"), (euroc, "euroc")):
        (root / "settings.yaml").write_text(Path(settings[which]).read_text())
    return dict(tum=tum, kitti=kitti, euroc=euroc)


@pytest.mark.parametrize("loader", ["tum_mono", "tum_rgbd", "kitti", "euroc"])
def test_loaders_like_jax(loader, datasets):
    """The same SequenceItems as JAX's loader, and through FramePrefetcher
    the same decoded frames (u8 gray, u16 depth), exactly."""
    from orb_slam2_comment_tpu.utils import datasets as jds
    from orb_slam2_comment_tpu_torch.utils import datasets as tds

    root = datasets["tum" if loader.startswith("tum") else loader]
    args = {"tum_mono": (str(root),), "tum_rgbd": (str(root), str(root / "associations.txt")),
            "kitti": (str(root),), "euroc": (str(root), str(root / "timestamps.txt"))}[loader]
    fn = {"tum_mono": "load_tum_mono", "tum_rgbd": "load_tum_rgbd", "kitti": "load_kitti",
          "euroc": "load_euroc"}[loader]
    ti, ji = getattr(tds, fn)(*args), getattr(jds, fn)(*args)
    assert [vars(a) for a in ti] == [vars(b) for b in ji] and len(ti) >= 3
    for a, b in zip(tds.FramePrefetcher(ti, lookahead=2, threads=2),
                    jds.FramePrefetcher(ji, lookahead=2, threads=2), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            if k != "timestamp":
                assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_rectification_maps_like_jax(datasets):
    """stereo_rectify_maps from the EuRoC settings and remap of its frames
    equal JAX's."""
    from orb_slam2_comment_tpu.utils import datasets as jds
    from orb_slam2_comment_tpu_torch.utils import config as tc
    from orb_slam2_comment_tpu_torch.utils import datasets as tds

    rect = tc.load_rectification(str(datasets["euroc"] / "settings.yaml"))
    tm, jm = tds.stereo_rectify_maps(*rect[:8], rect[8]), jds.stereo_rectify_maps(*rect[:8],
                                                                                   rect[8])
    img = tds.load_image_gray(tds.load_euroc(str(datasets["euroc"]),
                                             str(datasets["euroc"] / "timestamps.txt"))[0].image)
    for (tx, ty), (jx, jy) in zip(tm, jm, strict=True):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tds.remap(img, tx, ty), jds.remap(img, jx, jy))


def test_renderer_like_jax(tmp_path):
    """The renderer's scenes, trajectories and images equal JAX's for the
    same seeds, and a written TUM sequence reads back to the same arrays
    and lists as JAX's writer's (the port encodes through pngio, JAX
    through PIL)."""
    from orb_slam2_comment_tpu.utils import render as jr
    from orb_slam2_comment_tpu_torch.utils import render as tr
    from orb_slam2_comment_tpu_torch.utils import pngio

    np.testing.assert_array_equal(tr.make_texture(3, size=96), jr.make_texture(3, size=96))
    for make in ("make_room", "make_street"):
        a, b = getattr(tr, make)(seed=5), getattr(jr, make)(seed=5)
        assert len(a.quads) == len(b.quads)
        for qa, qb in zip(a.quads, b.quads):
            for f in vars(qb):
                np.testing.assert_array_equal(getattr(qa, f), getattr(qb, f))
    for traj, kw in (("room_loop_trajectory", {}), ("desk_trajectory", dict(seed=3)),
                     ("street_trajectory", dict(seed=5))):
        np.testing.assert_array_equal(getattr(tr, traj)(12, **kw), getattr(jr, traj)(12, **kw))
    K, hw = (260.0, 260.0, 80.0, 60.0), (120, 160)
    scene_t, scene_j = tr.make_room(seed=13, size=(7.0, 3.0, 7.0)), jr.make_room(
        seed=13, size=(7.0, 3.0, 7.0))
    poses = jr.desk_trajectory(3, seed=3)
    for a, b in zip(tr.render_quads(scene_t, poses[1], K, hw, seed=4),
                    jr.render_quads(scene_j, poses[1], K, hw, seed=4)):
        np.testing.assert_array_equal(a, b)
    tr.write_tum_rgbd(str(tmp_path / "t"), scene_t, poses, K, hw, workers=1)
    jr.write_tum_rgbd(str(tmp_path / "j"), scene_j, poses, K, hw, workers=1)
    for name in ("rgb.txt", "depth.txt", "associations.txt", "groundtruth.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    for sub in ("rgb", "depth"):
        files = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "t" / sub)) == files and len(files) == 3
        for fn in files:
            np.testing.assert_array_equal(pngio.read(str(tmp_path / "t" / sub / fn)),
                                          _pil_read((tmp_path / "j" / sub / fn).read_bytes()))
    tr.write_settings_yaml(str(tmp_path / "t.yaml"), K, hw, 30.0, bf=40.0, depth_factor=5000.0)
    jr.write_settings_yaml(str(tmp_path / "j.yaml"), K, hw, 30.0, bf=40.0, depth_factor=5000.0)
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()


def test_run_synthetic_twin(capsys):
    """The synthetic driver's twin on the CPU: every frame tracked and a
    small trajectory error printed."""
    from orb_slam2_comment_tpu_torch.examples import run_synthetic

    ate = run_synthetic.main(["--sensor", "rgbd", "--frames", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tracked 6/6 frames" in out and ate < 0.02
