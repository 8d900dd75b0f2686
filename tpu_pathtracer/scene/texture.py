"""Texture and environment-map sampling in jnp.

The reference binds CUDA texture objects (src/renderkernel.cu:1021-1038):
  * HDR envmap: clamp address mode, linear filter, normalized coords.
  * Color texture: wrap address mode, linear filter, sRGB decode.
Here textures are plain arrays; we implement bilinear filtering with the
matching wrap/clamp semantics, and decode sRGB at load time.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.image import srgb_to_linear
from ..core.vecmath import TWO_PI, PI


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H,W,C] (C = 3 for RGB, 4 for RGBA), standard
    library only. Supports what texture assets use: 8-bit truecolor with or
    without alpha, no interlace, all five row filters. Anything else raises
    ValueError naming what was found."""
    import struct
    import zlib
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            "unsupported PNG: bit depth %d, color type %d, interlace %d "
            "(want 8-bit RGB or RGBA, not interlaced)"
            % (depth, ctype, interlace))
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * channels
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:                       # Sub: running sum per channel
            cur = (np.cumsum(line.reshape(w, channels), axis=0)
                   & 0xFF).reshape(-1)
        elif ftype == 2:                       # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):                  # Average, Paeth
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                if ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b = prev[x]
                    c = prev[x - channels] if x >= channels else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError("corrupt PNG: row filter %d" % ftype)
        out[y] = cur
        prev = cur
    return out.reshape(h, w, channels)


def load_texture(path) -> np.ndarray:
    """Load an 8-bit RGB/RGBA PNG -> linear float32 [H,W,3] (sRGB decoded,
    matching colorTexture.sRGB = true at src/renderkernel.cu:1035; alpha
    is dropped)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())[..., :3].astype(np.float32) / 255.0
    return srgb_to_linear(img).astype(np.float32)


def _bilinear(tex, u, v, wrap_u, wrap_v):
    """tex: [H,W,3]; u,v in normalized coords; CUDA-convention linear filter
    (sample centers at texel centers: subtract 0.5 before floor)."""
    H, W = tex.shape[0], tex.shape[1]
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    if wrap_u:
        x0 = jnp.mod(x0, W)
        x1 = jnp.mod(x1, W)
    else:
        x0 = jnp.clip(x0, 0, W - 1)
        x1 = jnp.clip(x1, 0, W - 1)
    if wrap_v:
        y0 = jnp.mod(y0, H)
        y1 = jnp.mod(y1, H)
    else:
        y0 = jnp.clip(y0, 0, H - 1)
        y1 = jnp.clip(y1, 0, H - 1)
    flat = tex.reshape(-1, tex.shape[-1])
    c00 = jnp.take(flat, y0 * W + x0, axis=0)
    c01 = jnp.take(flat, y0 * W + x1, axis=0)
    c10 = jnp.take(flat, y1 * W + x0, axis=0)
    c11 = jnp.take(flat, y1 * W + x1, axis=0)
    fx = fx[..., None]
    fy = fy[..., None]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
            + c10 * (1 - fx) * fy + c11 * fx * fy)


def sample_texture(tex, u, v):
    """Color texture fetch: wrap/wrap bilinear (src/renderkernel.cu:1030-1038)."""
    return _bilinear(tex, jnp.mod(u, 1.0), jnp.mod(v, 1.0), wrap_u=True, wrap_v=True)


def make_quad_texture(tex, wrap_u, wrap_v):
    """Precompute the 2x2 bilinear footprint per texel: quad[y,x] =
    [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)] with wrap/clamp applied at
    build time. A bilinear fetch then costs ONE 12-float row gather instead
    of four 3-float gathers — gathers inside the bounce loop are the
    expensive primitive, so this is a 4x cut of the gathered indices."""
    import numpy as np
    t = np.asarray(tex, np.float32)
    H, W, _ = t.shape
    if wrap_u:
        xn = np.roll(t, -1, axis=1)
    else:
        xn = np.concatenate([t[:, 1:], t[:, -1:]], axis=1)
    if wrap_v:
        yn = np.roll(t, -1, axis=0)
        yxn = np.roll(xn, -1, axis=0)
    else:
        yn = np.concatenate([t[1:], t[-1:]], axis=0)
        yxn = np.concatenate([xn[1:], xn[-1:]], axis=0)
    quad = np.concatenate([t, xn, yn, yxn], axis=-1)  # (H,W,12)
    return quad.reshape(H * W, 12)


def _bilinear_quad(quad, H, W, u, v, wrap_u, wrap_v):
    """Bilinear sample from a quad texture (single gather)."""
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    if wrap_u:
        x0 = jnp.mod(x0, W)
    else:
        x0 = jnp.clip(x0, 0, W - 1)
    if wrap_v:
        y0 = jnp.mod(y0, H)
    else:
        y0 = jnp.clip(y0, 0, H - 1)
    q = jnp.take(quad, y0 * W + x0, axis=0)           # [...,12]
    return (q[..., 0:3] * (1 - fx) * (1 - fy) + q[..., 3:6] * fx * (1 - fy)
            + q[..., 6:9] * (1 - fx) * fy + q[..., 9:12] * fx * fy)


def _uv_from_dir(raydir, rotation):
    x = raydir[..., 0]
    y = raydir[..., 1]
    z = raydir[..., 2]
    longlat_x = jnp.arctan2(x, z)
    longlat_x = jnp.where(longlat_x < 0.0, longlat_x + TWO_PI, longlat_x)
    u = jnp.mod(longlat_x / TWO_PI + rotation, 1.0)
    v = jnp.arccos(jnp.clip(y, -1.0, 1.0)) / PI
    return u, v


def sample_envmap_quad_pdf(quad16, H, W, raydir, rotation):
    """Environment radiance + sampler pdf from ONE row gather.

    quad16: (H*W, 16) = the 12 bilinear-footprint channels of
    make_quad_texture plus the 4 corner texels' pdf_uv values (cols 12:16,
    same neighbor/clamp layout). Returns (L [...,3] bilinear radiance,
    p_uv [...] the EXACT pdf_uv of the texel floor(u*W), floor(v*H) —
    selected, not interpolated, so it equals envsample.env_pdf_of_dir's
    gather bit for bit). Folding the pdf into the miss-path fetch removes
    a separate full-width gather per wave from the integrators."""
    u, v = _uv_from_dir(raydir, rotation)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    q = jnp.take(quad16, y0i * W + x0i, axis=0)        # [...,16]
    L = (q[..., 0:3] * (1 - fx) * (1 - fy) + q[..., 3:6] * fx * (1 - fy)
         + q[..., 6:9] * (1 - fx) * fy + q[..., 9:12] * fx * fy)
    # nearest-texel pdf: which of the 4 build-clamped corners holds texel
    # (floor(u*W), floor(v*H))
    sx = jnp.clip((u * W).astype(jnp.int32) - x0i, 0, 1)
    sy = jnp.clip((v * H).astype(jnp.int32) - y0i, 0, 1)
    p00, p01 = q[..., 12], q[..., 13]
    p10, p11 = q[..., 14], q[..., 15]
    p_uv = jnp.where(sy == 0, jnp.where(sx == 0, p00, p01),
                     jnp.where(sx == 0, p10, p11))
    return L, p_uv


def sample_texture_quad(quad, H, W, u, v):
    """Color texture fetch via quad rows: wrap/wrap bilinear."""
    return _bilinear_quad(quad, H, W, jnp.mod(u, 1.0), jnp.mod(v, 1.0),
                          wrap_u=True, wrap_v=True)


def sample_envmap_quad(quad, H, W, raydir, rotation):
    """Environment lookup via quad rows (envLight mapping,
    src/renderkernel.cu:422-437; clamp addressing)."""
    u, v = _uv_from_dir(raydir, rotation)
    return _bilinear_quad(quad, H, W, u, v, wrap_u=False, wrap_v=False)


def sample_envmap(env, raydir, rotation):
    """HDR environment lookup; mirrors envLight (src/renderkernel.cu:422-437):
    lat-long mapping with Y up, u = atan2(x, z)/2pi + rotation (mod 1),
    v = acos(y)/pi, clamp address mode, bilinear filter."""
    u, v = _uv_from_dir(raydir, rotation)
    return _bilinear(env, u, v, wrap_u=False, wrap_v=False)
