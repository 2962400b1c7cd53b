"""PNG reading and writing on the standard library's zlib and numpy.

The port's one image codec, for the dataset loaders and the renderer's
writers: it needs no PIL, cv2 or libpng. It reads non-interlaced 8-bit
gray, RGB and RGBA and 16-bit gray, with every row filter (None, Sub, Up,
Average, Paeth); it writes 8-bit and 16-bit gray and 8-bit RGB with
filter None.

Colour becomes gray as the JAX package's native reader (csrc/slamio.cc)
makes it: alpha dropped, 0.299 R + 0.587 G + 0.114 B in f32, and for the
u8 kind that value plus 0.5, truncated.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: gray, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth_row(cur: bytearray, prior: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `raw` (each row: a filter byte, then
    `stride` bytes). Returns the [h, stride] uint8 scanlines."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG: image data is short")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(kinds.max())}")
    out = rows[:, 1:].copy()
    if not kinds.any():
        return out
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        k = kinds[y]
        cur = out[y]
        if k == 1:     # Sub: running sum per channel, modulo 256
            cur = cur.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif k == 2:   # Up
            cur = cur + prior
        elif k in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if k == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        out[y] = cur
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] (gray, uint8 or uint16), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA, uint8)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError("PNG: interlaced images are not read")
    if ctype not in _CHANNELS or depth not in (8, 16) or (ctype != 0 and depth != 8):
        raise ValueError(f"PNG: colour type {ctype} at {depth} bits is not read")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    return img.reshape(h, w, ch) if ch > 1 else img.reshape(h, w)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _gray_f32(img: np.ndarray) -> np.ndarray:
    """slamio's gray: 8-bit gray and 16-bit gray as they are, colour by
    the f32 weighted sum (alpha dropped)."""
    if img.ndim == 2:
        return img.astype(np.float32)
    p = img.astype(np.float32)
    return (np.float32(0.299) * p[..., 0] + np.float32(0.587) * p[..., 1]
            + np.float32(0.114) * p[..., 2])


def read_gray(path: str) -> np.ndarray:
    """f32 gray in 0..255 (0..65535 for 16-bit gray)."""
    return _gray_f32(read(path))


def read_gray_u8(path: str) -> np.ndarray:
    """u8 gray: slamio's f32 gray clamped to 0..255, plus 0.5, truncated."""
    return (np.minimum(_gray_f32(read(path)), np.float32(255))
            + np.float32(0.5)).astype(np.uint8)


def read_u16(path: str) -> np.ndarray:
    """The raw samples of a 16-bit gray PNG (TUM depth)."""
    img = read(path)
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError(f"{path}: expected a 16-bit gray PNG")
    return img


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """[H, W] uint8 or uint16 gray, or [H, W, 3] uint8 RGB -> PNG bytes
    (filter None)."""
    img = np.asarray(img)
    rgb = img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    if not (rgb or (img.ndim == 2 and img.dtype in (np.uint8, np.uint16))):
        raise ValueError("PNG: only 8-bit and 16-bit gray and 8-bit RGB images are written")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8).reshape(h, -1)],
                         axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2 if rgb else 0,
                                                     0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
