"""PNG image I/O.

The reference vendors stb_image / stb_image_write purely for PNG dumps
(``src/Splats.cpp:516-540`` ``saveImage``). Here we use PIL when available and
fall back to a minimal pure-Python PNG writer (zlib, filter 0 on every row),
``encode_png``, so the framework has zero hard image dependencies.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    from PIL import Image  # type: ignore

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def to_uint8(image: np.ndarray) -> np.ndarray:
    """Float image in [0, 1] (H, W, 3|4) -> uint8, clamped like ``saveImage``."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    return img


def save_png(path: str, image: np.ndarray) -> None:
    """Save (H, W, 3|4) image; float inputs are interpreted as [0, 1]."""
    img = to_uint8(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if _HAVE_PIL:
        Image.fromarray(img).save(path)
        return
    with open(path, "wb") as f:
        f.write(encode_png(img))


def load_png(path: str) -> np.ndarray:
    """Load a PNG as float32 (H, W, C) in [0, 1]."""
    if _HAVE_PIL:
        return np.asarray(Image.open(path), dtype=np.float32) / 255.0
    raise RuntimeError("PNG loading requires PIL")  # pragma: no cover


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 image -> the bytes of a PNG file, in memory, with
    no PIL: 8-bit RGB or RGBA, every row filter 0, zlib level 6. The same
    array always gives the same bytes."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes (H, W, 3|4) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
