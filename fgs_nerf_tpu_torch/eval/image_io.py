"""8-bit PNG files with the standard library alone (``zlib``, ``struct``).

The machine with the card has no image package, so the port writes its
render dumps (``eval/render.py``) and reads Blender-style frames
(``data/blender.py``) here: non-interlaced 8-bit grayscale, RGB and
RGBA, every PNG row filter on read, filter 0 on write.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (grayscale), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA) image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"write_png: 1, 3 or 4 channels, got {c}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, w * c)],
        axis=1)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (v.astype(np.int16) for v in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG -> uint8 [H, W] or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: only 8-bit non-interlaced gray/RGB/RGBA PNGs are read "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 2:
            cur = line + prev
        else:
            # Sub, Average and Paeth depend on the decoded left neighbour:
            # decode one pixel (c bytes) at a time
            cur = np.zeros(stride, np.uint8)
            for x in range(0, stride, c):
                left = cur[x - c:x] if x else np.zeros(c, np.uint8)
                up = prev[x:x + c]
                if ft == 1:
                    pred = left
                elif ft == 3:
                    pred = ((left.astype(np.uint16) + up) // 2).astype(np.uint8)
                elif ft == 4:
                    ul = prev[x - c:x] if x else np.zeros(c, np.uint8)
                    pred = _paeth(left, up, ul)
                else:
                    raise ValueError(f"{path}: bad PNG filter type {ft}")
                cur[x:x + c] = line[x:x + c] + pred
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, c)
    return img[..., 0] if c == 1 else img
