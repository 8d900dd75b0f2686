"""Vector math over batched [..., 3] jnp arrays.

The reference carries Vec3f scalars per CUDA thread (src/linear_math.h);
here every quantity is a column of a wavefront, so all helpers below operate on
arrays whose last axis is the xyz component axis and vectorize over leading
axes for free.
"""
from __future__ import annotations

import jax.numpy as jnp

# Constants mirroring reference src/mathDefine.h
PI = 3.1415926535897932384626433832795
TWO_PI = 2.0 * PI
FOUR_PI = 4.0 * PI
EIGHT_PI = 8.0 * PI
INV_PI = 1.0 / PI
INV_4PI = 1.0 / FOUR_PI
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
SQRT_ONE_THIRD = 0.5773502691896257645091487805019574556476

# Ray epsilons (reference src/renderkernel.cu:45-47)
RAY_MIN = 1e-4
RAY_MAX = 1e20


def dot(a, b):
    """Batched dot product over the last axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def dotk(a, b):
    """Batched dot product, keepdims=True (handy for broadcasting)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a, eps=1e-20):
    return a * jnp.reciprocal(jnp.sqrt(jnp.maximum(jnp.sum(a * a, axis=-1, keepdims=True), eps)))


def reflect(d, n):
    """Mirror reflect direction d about normal n (matches reference
    `raydir - n * dot(n, raydir) * 2`, src/renderkernel.cu:644)."""
    return d - n * 2.0 * dotk(n, d)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def channel_select(c, ch):
    """Per-lane RGB channel pick: c[i, ch[i]] as a branch-free select.

    Bit-identical to `take_along_axis(c, ch[:, None], 1)[:, 0]`, but that
    form lowers to a per-index XLA gather over the near-duplicate index
    pattern ch in {0,1,2}, which serialises on duplicate rows. The
    two-select form is plain elementwise work that fuses."""
    return jnp.where(ch == 0, c[..., 0],
                     jnp.where(ch == 1, c[..., 1], c[..., 2]))


def make_basis(n):
    """Build an orthonormal basis (u, v) around unit normal n.

    Mirrors reference `localizeSample` (src/reflection.cuh:34-46): pick the
    cardinal axis whose |component| < sqrt(1/3), u = normalize(cross(n, w)),
    v = cross(n, u). Branch-free via where-selection.
    """
    ax = jnp.abs(n[..., 0:1])
    ay = jnp.abs(n[..., 1:2])
    ex = jnp.zeros_like(n).at[..., 0].set(1.0)
    ey = jnp.zeros_like(n).at[..., 1].set(1.0)
    ez = jnp.zeros_like(n).at[..., 2].set(1.0)
    w = jnp.where(ax < SQRT_ONE_THIRD, ex, jnp.where(ay < SQRT_ONE_THIRD, ey, ez))
    u = normalize(jnp.cross(n, w))
    v = jnp.cross(n, u)
    return u, v


def concentric_sample_disk(u1, u2):
    """PBRT concentric disk mapping (reference src/reflection.cuh:50-67)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    safe_ox = jnp.where(ox == 0.0, 1.0, ox)
    safe_oy = jnp.where(oy == 0.0, 1.0, oy)
    theta = jnp.where(use_x, PI_OVER_4 * (oy / safe_ox),
                      PI_OVER_2 - PI_OVER_4 * (ox / safe_oy))
    degenerate = (ox == 0.0) & (oy == 0.0)
    dx = jnp.where(degenerate, 0.0, r * jnp.cos(theta))
    dy = jnp.where(degenerate, 0.0, r * jnp.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2, n):
    """Cosine-weighted direction about n. Matches reference
    `lambertianReflection` (src/reflection.cuh:75-83): sample the concentric
    disk, lift to hemisphere, rotate into the (u, n, v) frame."""
    dx, dy = concentric_sample_disk(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
    u, v = make_basis(n)
    d = dx[..., None] * u + dy[..., None] * v + z[..., None] * n
    return normalize(d)


def barycentric(p, a, b, c):
    """Barycentric coordinates of p in triangle (a,b,c); mirrors reference
    Barycentric (src/mymath.h:17-31). Returns (u, v, w) with p=u*a+v*b+w*c."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return u, v, w
