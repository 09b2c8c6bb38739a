"""Minimal dependency-free PNG codec (8-bit RGB/RGBA/gray, non-interlaced).

The reference loads its texture atlas from PNG via SDL_image
(src/Atlas.cpp:11-18) and the app writes no images; here the framework both
loads atlas sheets and writes rendered frames without external imaging
dependencies (zlib + struct only).  Filters 0-4 (None/Sub/Up/Average/Paeth)
are implemented for decode; encode uses filter 0.  A copy of
octree_raymarcher_tpu/utils/png.py.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def save_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H,W] gray, [H,W,3] RGB, or [H,W,4] RGBA (float in [0,1]
    is converted)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if a.ndim == 2:
        color, channels = 0, 1
        a = a[..., None]
    elif a.shape[2] == 3:
        color, channels = 2, 3
    elif a.shape[2] == 4:
        color, channels = 6, 4
    else:
        raise ValueError(f"unsupported shape {a.shape}")
    h, w = a.shape[:2]
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG; returns uint8 [H,W,C] (C=1/3/4;
    palette images are expanded to RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _SIG, "not a PNG"
    pos = 8
    w = h = color = None
    idat = []
    palette = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", body)
            assert depth == 8, f"bit depth {depth} unsupported (only 8)"
            assert inter == 0, "interlaced PNG unsupported"
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    assert len(raw) == h * (stride + 1), (len(raw), h, stride)

    out = np.empty((h, stride), dtype=np.uint8)
    bpp = channels
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw, np.uint8, count=stride, offset=y * (stride + 1) + 1
        ).copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype in (1, 3, 4):  # Sub / Average / Paeth need a scalar scan
            for x in range(stride):
                a = int(line[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ftype == 1:
                    line[x] = (int(line[x]) + a) & 0xFF
                elif ftype == 3:
                    line[x] = (int(line[x]) + (a + b) // 2) & 0xFF
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pr = int(
                        _paeth(np.uint8(a), np.uint8(b), np.uint8(c))
                    )
                    line[x] = (int(line[x]) + pr) & 0xFF
        else:
            raise ValueError(f"unknown filter {ftype}")
        out[y] = line
        prev = line
    img = out.reshape(h, w, channels)
    if color == 3:
        assert palette is not None, "palette PNG without PLTE"
        img = palette[img[..., 0]]
    return img


__all__ = ["save_png", "load_png"]
