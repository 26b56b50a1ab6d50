"""Minimal dependency-free PNG reader — closes the heightmap-import loop.

The reference imports real image files and extracts ITU-R 601 luminance on
a canvas (js/import-main.js:27-69); this module does the same for the CLI's
``import-heightmap`` so users can feed PNGs directly instead of ``.npy``
dumps. Supports 8-bit grayscale / RGB / RGBA / gray+alpha, all five PNG
scanline filters, non-interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def load_png(path: str) -> np.ndarray:
    """Decode a PNG into [H, W, C] uint8 (C per color type)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")

    pos = 8
    idat = b""
    w = h = None
    bit_depth = color_type = interlace = None
    palette = None
    while pos + 8 <= len(data):
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + ln

    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    if bit_depth != 8:
        raise ValueError(f"{path}: only 8-bit PNGs supported "
                         f"(got bit depth {bit_depth})")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs not supported")

    if color_type == 3:  # palette
        c_in = 1
    elif color_type in _CHANNELS:
        c_in = _CHANNELS[color_type]
    else:
        raise ValueError(f"{path}: unsupported color type {color_type}")

    raw = zlib.decompress(idat)
    stride = w * c_in
    expected = (stride + 1) * h
    if len(raw) < expected:
        raise ValueError(f"{path}: truncated image data")
    rows = np.frombuffer(raw[:expected], np.uint8).reshape(h, stride + 1)
    filters = rows[:, 0]
    scan = rows[:, 1:].astype(np.int16)

    out = np.zeros((h, stride), np.uint8)
    bpp = c_in
    for y in range(h):
        f = filters[y]
        cur = scan[y].copy()
        up = out[y - 1].astype(np.int16) if y > 0 else np.zeros(stride, np.int16)
        if f == 0:
            rec = cur
        elif f == 2:  # Up
            rec = cur + up
        elif f == 1:  # Sub — cumulative along x with stride bpp
            rec = cur.copy()
            for x in range(bpp, stride):
                rec[x] += rec[x - bpp]
        elif f == 3:  # Average — predictors must see MASKED bytes
            rec = cur.copy()
            for x in range(stride):
                left = int(rec[x - bpp]) & 0xFF if x >= bpp else 0
                rec[x] = (int(cur[x]) + ((left + int(up[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            rec = cur.copy()
            for x in range(stride):
                a = int(rec[x - bpp]) & 0xFF if x >= bpp else 0
                b = int(up[x])
                c = int(out[y - 1, x - bpp]) if (y > 0 and x >= bpp) else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown filter {f}")
        out[y] = (rec & 0xFF).astype(np.uint8)

    img = out.reshape(h, w, c_in)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        img = palette[img[:, :, 0]]
    return img


def luminance(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, rounded — exactly the reference's grayscale
    extraction (js/import-main.js:60-63). Black = ocean, bright = high."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img.astype(np.uint8)
    c = img.shape[2]
    if c == 1:
        return img[:, :, 0].astype(np.uint8)
    if c == 2:  # gray + alpha
        return img[:, :, 0].astype(np.uint8)
    rgb = img[:, :, :3].astype(np.float64)
    return np.round(0.299 * rgb[:, :, 0] + 0.587 * rgb[:, :, 1]
                    + 0.114 * rgb[:, :, 2]).astype(np.uint8)


def load_heightmap_gray(path: str) -> np.ndarray:
    """[H, W] uint8 grayscale from a .png or .npy file."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 3:
            return luminance(arr)
        return arr.astype(np.uint8)
    return luminance(load_png(path))
