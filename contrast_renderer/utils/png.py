"""Minimal PNG writer (pure Python, zlib only).

Replaces the reference's windowing/present path for offline frame
output — there is no surface to present to on a headless host, so frames go
to RGBA PNG files (SURVEY §2 crate-replacement table: winit → frame
driver)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 4) float [0,1] or uint8 RGBA image as PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    if image.shape[-1] == 3:
        image = np.concatenate(
            [image, np.full(image.shape[:-1] + (1,), 255, np.uint8)], axis=-1
        )
    height, width = image.shape[:2]
    raw = b"".join(
        b"\x00" + image[y].tobytes() for y in range(height)
    )
    header = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(data)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGBA PNG written by `write_png` (supports the five
    standard row filters) into a (H, W, 4) uint8 array."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    width = height = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            width, height, depth, color = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and color == 6, "only 8-bit RGBA supported"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = width * 4
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    offset = 0
    for y in range(height):
        filter_type = raw[offset]
        row = np.frombuffer(
            raw, np.uint8, count=stride, offset=offset + 1
        ).astype(np.int32)
        offset += 1 + stride
        if filter_type == 1:  # Sub
            for x in range(4, stride):
                row[x] = (row[x] + row[x - 4]) & 0xFF
        elif filter_type == 2:  # Up
            row = (row + prev) & 0xFF
        elif filter_type == 3:  # Average
            for x in range(stride):
                left = row[x - 4] if x >= 4 else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif filter_type == 4:  # Paeth
            for x in range(stride):
                a = row[x - 4] if x >= 4 else 0
                b = prev[x]
                c = prev[x - 4] if x >= 4 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        out[y] = row.astype(np.uint8)
        prev = row
    return out.reshape(height, width, 4)


def unpremultiply(image: np.ndarray) -> np.ndarray:
    """Convert premultiplied RGBA float to straight RGBA."""
    image = np.asarray(image, np.float32)
    alpha = image[..., 3:4]
    rgb = np.where(alpha > 0, image[..., :3] / np.maximum(alpha, 1e-6), 0.0)
    return np.concatenate([rgb, alpha], axis=-1)
