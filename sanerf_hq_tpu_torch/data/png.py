"""Minimal 8-bit PNG reader and writer (zlib + numpy), so scenes and
results need no image library."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels


def encode_png(img: np.ndarray) -> bytes:
    """img: uint8 [H, W] or [H, W, 1|2|3|4] -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)],
                         axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                              0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    """img: uint8 [H, W] or [H, W, 1|2|3|4]."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str) -> np.ndarray:
    """8-bit, non-interlaced grey / grey+alpha / RGB / RGBA PNG file ->
    uint8 [H, W, C]."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "PNG data") -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced grey / grey+alpha / RGB / RGBA
    PNG file -> uint8 [H, W, C]."""
    if data[:8] != _SIG:
        raise ValueError(f"{name} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{name}: only 8-bit non-interlaced grey/RGB(A) PNGs are read "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    C = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, W * C + 1)
    out = np.zeros((H, W * C), np.int32)
    prev = np.zeros(W * C, np.int32)
    for y in range(H):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(W, C), axis=0).reshape(-1) & 255
        elif f == 2:  # Up
            cur = (line + prev) & 255
        else:  # Average / Paeth depend on the reconstructed left pixel
            cur = np.zeros(W * C, np.int32)
            left, upleft = np.zeros(C, np.int32), np.zeros(C, np.int32)
            for x in range(W):
                s = slice(x * C, (x + 1) * C)
                up = prev[s]
                pred = (left + up) // 2 if f == 3 else _paeth(left, up, upleft)
                cur[s] = (line[s] + pred) & 255
                left, upleft = cur[s], up
        out[y] = prev = cur
    return out.reshape(H, W, C).astype(np.uint8)
