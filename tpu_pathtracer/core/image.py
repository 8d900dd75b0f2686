"""Image output/input: tonemapping, PPM/PNG writers, metrics.

No imaging library is needed: PNGs are written with zlib and struct.

Mirrors the reference display path: accumulation buffer / framenumber,
clamp to [0,1], gamma 1/2.2, 8-bit quantize (src/renderkernel.cu:959-977 and
writeToPPM src/Util.cpp:14-23 via pixelToInt src/Util.h:57).
"""
from __future__ import annotations

import numpy as np


def tonemap(accum, frame_count):
    """accum: float array [H,W,3] of summed radiance; returns uint8 [H,W,3].

    Uses the PPM writer's quantization `int(pow(clamp(x), 1/2.2) * 255 + .5)`
    (reference src/Util.h:57)."""
    img = np.asarray(accum, dtype=np.float64) / max(int(frame_count), 1)
    img = np.clip(img, 0.0, 1.0)
    img = np.power(img, 1.0 / 2.2)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path, accum, frame_count):
    img = tonemap(accum, frame_count)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P3\n%d %d\n%d\n" % (w, h, 255))
        flat = img.reshape(-1, 3)
        lines = [b"%d %d %d " % tuple(px) for px in flat]
        f.write(b"".join(lines))


def read_ppm(path):
    with open(path, "rb") as f:
        data = f.read().split()
    assert data[0] == b"P3"
    w, h, maxv = int(data[1]), int(data[2]), int(data[3])
    px = np.array(data[4:4 + w * h * 3], dtype=np.float64).reshape(h, w, 3)
    return px / maxv


def encode_png(img):
    """uint8 [H,W,3] RGB -> PNG file bytes (8-bit truecolor, no interlace,
    filter type 0 on every row), with the standard library only."""
    import struct
    import zlib
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("encode_png wants [H,W,3] RGB, got %r" % (img.shape,))
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img, frame_count=None):
    """Write an 8-bit RGB PNG. With frame_count, `img` is a summed-radiance
    accumulation [H,W,3] and is tonemapped first; without it, `img` is
    already a uint8 [H,W,3] image."""
    if frame_count is not None:
        img = tonemap(img, frame_count)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def srgb_to_linear(c):
    """sRGB EOTF. The reference binds its color texture with sRGB=true
    (src/renderkernel.cu:1035) so CUDA decodes texels to linear; we decode at
    load time instead."""
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def rmse(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
