"""8-bit PNG files through the standard library's zlib and numpy
(`read_image` reads other formats through cv2).

The JAX package writes and reads its PNGs (render galleries, rendered
views, the metrics CLI's directories) with imageio, which the port's GPU
machine does not have; the port's PNGs all go through this module, on the
card and on the CPU alike. It handles 8-bit gray, gray + alpha, RGB and
RGBA, not interlaced; it writes every row with filter 0 (None) and reads
all five row filters. The arrays equal imageio's (pixel for pixel, both
ways; tests/test_torch_image_io.py).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C = 1, 2, 3, 4) image."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], got {a.shape}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline of the five PNG filters (PNG specification, section 9)."""
    if kind == 0:
        return line
    if kind == 2:                                     # Up
        return line + prior
    if kind == 1:                                     # Sub: a running sum per byte lane
        lanes = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:                                 # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        elif kind == 4:                               # Paeth
            cc = up[i - bpp] if i >= bpp else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out[i] = (out[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W] (gray) or [H, W, C] (C = 2, 3, 4), as imageio returns."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit gray / gray+alpha / RGB / RGBA, not "
                         f"interlaced, are read (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * c
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} image bytes, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def read_image(path: str) -> np.ndarray:
    """uint8 pixels of an image file in imageio's channel order: PNG files
    through `read_png`, other formats (JPEG, ...) through cv2, BGR(A)
    reordered to RGB(A). cv2's and imageio's JPEG decoders may differ by a
    level."""
    if path.lower().endswith(".png"):
        return read_png(path)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cv2 could not read {path}")
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]] if img.shape[2] >= 3 else img
    return np.ascontiguousarray(img)
