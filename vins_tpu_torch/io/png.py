"""Grayscale PNG decoding and writing, in Python and numpy.

Counterpart of `vins_tpu/io/png.py` with one implementation (its Python
decoder; there is no native library here).  It reads the formats robotics
datasets emit: gray-8, gray-16 (high byte), gray+alpha and RGB(A) → BT.601
luma, with all five row filters; no interlacing.  The None and Up filters
and the left-sum of Sub are whole-row numpy operations; Average and Paeth
depend on the reconstructed byte to their left, so they run as a loop over
the row's bytes on Python integers.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth_row(cur: list, prev: list, bpp: int) -> list:
    out = cur[:]
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def _average_row(cur: list, prev: list, bpp: int) -> list:
    out = cur[:]
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + prev[x]) >> 1)) & 0xFF
    return out


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of [h, 1 + stride] decompressed rows."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f = int(raw[y, 0])
        cur = raw[y, 1:]
        if f == 0:
            row = cur
        elif f == 1:  # Sub: a running sum of each byte lane, modulo 256
            lanes = cur.reshape(-1, bpp).astype(np.int64)
            row = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:  # Up
            row = cur + prev  # uint8 arithmetic wraps modulo 256
        elif f == 3:
            row = np.asarray(_average_row(cur.tolist(), prev.tolist(), bpp), np.uint8)
        elif f == 4:
            row = np.asarray(_paeth_row(cur.tolist(), prev.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        out[y] = row
        prev = out[y]
    return out


def read_png_gray(path: str) -> np.ndarray:
    """Decode a PNG to a uint8 grayscale [H,W] array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    off = 8
    idat = []
    w = h = depth = ctype = None
    while off + 8 <= len(data):
        (clen,) = struct.unpack(">I", data[off:off + 4])
        typ = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + clen]
        if typ == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if interlace != 0:
                raise ValueError(f"{path}: interlaced PNG unsupported")
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
        off += 12 + clen
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    if not (depth == 8 or (depth == 16 and ch == 1)):
        raise ValueError(f"{path}: unsupported bit depth {depth} for color type {ctype}")
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    px = _unfilter(raw, bpp).reshape(h, w, bpp)
    if ch <= 2:  # gray-8, gray-16 (its high byte comes first), gray+alpha
        return px[:, :, 0].copy()
    rgb = px[:, :, :3].astype(np.uint32)
    return ((299 * rgb[:, :, 0] + 587 * rgb[:, :, 1] + 114 * rgb[:, :, 2]) // 1000
            ).astype(np.uint8)


def write_png_gray(path: str, img: np.ndarray):
    """Minimal PNG writer (filter 0, gray-8)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape

    def chunk(typ, body):
        crc = zlib.crc32(typ + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + typ + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
