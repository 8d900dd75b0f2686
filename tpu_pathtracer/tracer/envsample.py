"""Environment-map importance sampling with multiple importance sampling.

The reference only finds the environment through BSDF sampling
(envLight on miss, src/renderkernel.cu:422-437,553-557), which is extremely
noisy for small bright sources (sun disks). BASELINE config #2 calls for
envmap importance sampling, so diffuse lanes additionally draw next-event
rays from the luminance-weighted lat-long distribution, combined with BSDF
sampling by the power heuristic. BSDF-found environment hits are
down-weighted by the complementary MIS weight so nothing is double counted.

Distribution build (host): p(row) ~ sum_col L(row,col) sin(theta_row);
p(col|row) ~ L(row,col). Sampling inverts the two CDFs with vectorized
searchsorted; pdf(dir) = p(u,v) * (W*H) / (2 pi^2 sin(theta)).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.vecmath import PI, TWO_PI, INV_PI


def build_env_distribution(env, topk=16384):
    """env: [H,W,3] float. Returns dict of numpy arrays for the sampler.

    The sampler uses Walker's alias method over the texel distribution:
    drawing a direction costs ONE gather of a packed row, where an in-loop
    binary CDF search costs one gather pass per level.

    topk: NEE draws are restricted to the `topk` BRIGHTEST texels (by
    sin-weighted luminance), with the pdf renormalized over that subset
    and reported as 0 elsewhere — still unbiased under MIS (BSDF sampling
    covers the remainder with weight 1 there; the reference has no NEE at
    all). Two reasons: a small alias table is a cheaper gather target
    than a large one, and restricting draws to the bright (sun) texels
    keeps neighbouring shadow rays directionally coherent — the
    unrestricted draw's sky-texel tail made the anyhit traversal the most
    expensive NEE stage in earlier tuning.
    topk<=0 disables the restriction. Envs with H*W <= topk are unchanged.
    """
    env = np.asarray(env, np.float32)
    H, W, _ = env.shape
    lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
           + 0.0722 * env[..., 2]).astype(np.float64)
    theta = (np.arange(H) + 0.5) / H * np.pi
    weighted = (lum * np.sin(theta)[:, None] + 1e-12).reshape(-1)
    n = H * W

    if topk and topk > 0 and topk < n:
        sel = np.argpartition(weighted, n - topk)[n - topk:]
        sel.sort()
    else:
        sel = np.arange(n)
    k = sel.shape[0]
    w_sel = weighted[sel]
    total = w_sel.sum()
    # pdf over the [0,1]^2 uv square, renormalized over the selected set;
    # exactly 0 outside it (the BSDF-side MIS weight then degenerates to 1
    # there — nothing is double counted)
    pdf_uv = np.zeros(n)
    pdf_uv[sel] = w_sel * (H * W) / total

    # ---- alias table over the selected texels ----
    # production path: exact Vose in C (accel/native/alias.cpp) — the
    # interpreted loop below is the correctness reference but takes minutes
    # at real envmap sizes (2048x1024 = 2M texels)
    p = (w_sel / total) * k                     # mean 1
    from ..accel.native_build import alias_build_native
    native = alias_build_native(p)
    if native is not None:
        prob, alias = native
    else:
        prob = np.ones(k)
        alias = np.arange(k, dtype=np.int64)
        small = [i for i in range(k) if p[i] < 1.0]
        large = [i for i in range(k) if p[i] >= 1.0]
        p = p.copy()
        while small and large:
            s = small.pop()
            l = large.pop()
            prob[s] = p[s]
            alias[s] = l
            p[l] = p[l] - (1.0 - p[s])
            (small if p[l] < 1.0 else large).append(l)
    # packed row: [prob, alias_row(bitcast), pdf_uv[self], pdf_uv[alias],
    #              rgb_self(3), rgb_alias(3), texel_self(bitcast),
    #              texel_alias(bitcast)] — radiance rides along so the NEE
    # draw needs no second envmap gather: sampled directions point at
    # texel centers, where bilinear interpolation equals the texel value
    # (verified against sample_envmap_quad in tests/test_envsample.py).
    # texel ids are explicit because rows index the SELECTED set, not the
    # full texel grid.
    packed = np.zeros((k, 12), np.float32)
    packed[:, 0] = prob
    packed[:, 1] = alias.astype(np.int32).view(np.float32)
    flat_pdf = pdf_uv
    packed[:, 2] = flat_pdf[sel]
    packed[:, 3] = flat_pdf[sel[alias]]
    rgb = env.reshape(-1, 3)
    packed[:, 4:7] = rgb[sel]
    packed[:, 7:10] = rgb[sel[alias]]
    packed[:, 10] = sel.astype(np.int32).view(np.float32)
    packed[:, 11] = sel[alias].astype(np.int32).view(np.float32)
    return {
        "env_alias": packed,
        "env_pdf_uv": pdf_uv.reshape(H, W).astype(np.float32),
    }


def _dir_from_uv(u, v, rotation):
    """Inverse of the envLight lat-long mapping (src/renderkernel.cu:425-430):
    u = (atan2(x, z)/2pi + rot) mod 1, v = acos(y)/pi."""
    phi = (u - rotation) * TWO_PI
    theta = v * PI
    sin_t = jnp.sin(theta)
    return jnp.stack([sin_t * jnp.sin(phi), jnp.cos(theta),
                      sin_t * jnp.cos(phi)], axis=-1)


def env_pdf_of_dir(scene, raydir, rotation):
    """Solid-angle pdf of the env sampler for given directions [N,3]."""
    from ..scene.texture import _uv_from_dir
    pdf_uv = scene["env_pdf_uv"]
    H, W = pdf_uv.shape
    y = raydir[:, 1]
    u, v = _uv_from_dir(raydir, rotation)
    xi = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
    p_uv = jnp.take(pdf_uv.reshape(-1), yi * W + xi)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - y * y, 1e-8))
    return p_uv / (2.0 * PI * PI * sin_t)


def sample_env(scene, u1, u2, rotation):
    """Draw directions via the alias table: one gather per lane.
    Returns (dir [N,3], pdf [N], radiance [N,3]) — the radiance is packed
    in the alias row, so the draw + light evaluation is a single gather.
    Rows cover the top-k selected texels (build_env_distribution); texel
    ids ride the row as bitcast int columns."""
    packed = scene["env_alias"]       # [k, 12]
    H, W = scene["env_pdf_uv"].shape
    k = packed.shape[0]
    bin0 = jnp.clip((u1 * k).astype(jnp.int32), 0, k - 1)
    row = jnp.take(packed, bin0, axis=0)            # the ONE gather
    prob = row[:, 0]
    take_alias = u2 >= prob
    texel = jax.lax.bitcast_convert_type(
        jnp.where(take_alias, row[:, 11], row[:, 10]), jnp.int32)
    pdf_uv = jnp.where(take_alias, row[:, 3], row[:, 2])
    L = jnp.where(take_alias[:, None], row[:, 7:10], row[:, 4:7])
    rowi = texel // W
    coli = texel % W
    u = (coli.astype(jnp.float32) + 0.5) / W
    v = (rowi.astype(jnp.float32) + 0.5) / H
    d = _dir_from_uv(u, v, rotation)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - d[:, 1] ** 2, 1e-8))
    pdf = pdf_uv / (2.0 * PI * PI * sin_t)
    return d, pdf, L


def sample_env_dir(scene, u1, u2, rotation):
    """Back-compat wrapper: (dir, pdf) only."""
    d, pdf, _ = sample_env(scene, u1, u2, rotation)
    return d, pdf


def power_heuristic(pf, pg):
    pf2 = pf * pf
    return pf2 / jnp.maximum(pf2 + pg * pg, 1e-20)
