"""A PNG writer on the standard library: 8-bit RGB, zlib-compressed, with
the title in a `tEXt` chunk.

The JAX package composes its snapshot and frame PNGs with matplotlib; the
port builds every image as an (H, W, 3) array and writes it here, so it
needs neither matplotlib nor PIL.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def to_rgb8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats in [0, 1] (clipped) -> uint8; uint8 passes through."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path: Path | str, img: np.ndarray, title: str = "") -> Path:
    """Write an (H, W, 3) image (uint8, or floats in [0, 1]) as an RGB8 PNG:
    one IHDR, a `tEXt` "Title" chunk when `title` is set, one IDAT of
    filter-0 rows, IEND."""
    rgb = np.ascontiguousarray(to_rgb8(img))
    if rgb.ndim != 3 or rgb.shape[2] != 3 or min(rgb.shape[:2]) < 1:
        raise ValueError(f"want an (H, W, 3) image, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # filter byte 0 per row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    out = [SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    if title:
        out.append(_chunk(b"tEXt", b"Title\x00"
                          + title.encode("latin-1", "replace")))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"".join(out))
    return path


def png_size(path: Path | str) -> tuple:
    """(width, height) from a PNG's IHDR."""
    head = Path(path).read_bytes()[:24]
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])
