"""BSSRDF subsurface scattering — wavefront probe machinery.

Re-architecture of the reference MAT_SUBSURFACE path
(src/renderkernel.cu:698-844 + src/bssrdf.cuh): after the entry interface
refracts, the reference walks up to 3 probe-ray segments, reservoir-sampling
among surface hits of the same material, then evaluates the dual-beam profile
with 3-axis MIS. Here the probe loop is a statically unrolled 3-iteration
sequence of masked wavefront traversals (matching maxLoopNum=3,
src/renderkernel.cu:727); all per-thread locals become lane columns.

Profile evaluation uses the sum-of-exponentials fast path (USE_SOE,
src/bssrdf.cuh:8,262-276,355-360,402-405), the reference's default. The
tabulated Catmull-Rom path's table is produced by bssrdf/tabulate.py and
validated against it in tests.

Reference quirks kept deliberately:
* the r1-reuse cascade in probe-axis selection (src/bssrdf.cuh:291-297) and
  the subsequent `r1 < 0.5` radius x3 test against the *modified* r1
  (src/bssrdf.cuh:304);
* `probeRayVec` passed to calculateBSSRDF is the last probe hit's vector,
  not necessarily the reservoir-selected one (src/renderkernel.cu:756,803).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.vecmath import (RAY_MIN, RAY_MAX, FOUR_PI, EIGHT_PI, dot,
                            normalize, make_basis, length, channel_select)
from ..core.rng import RaySampler
from ..materials.fresnel import fresnel_dielectric, fresnel_moment_1
from ..materials.bsdf import lambertian_sample
from .traverse import intersect_scene


def param_soe(A):
    """Searchlight-configuration SoE parameter (src/bssrdf.cuh:262-276)."""
    p = jnp.abs(A - 0.8)
    return 1.85 - A + 7.0 * p * p * p


def calculate_bssrdf_soe(ns, normal_next, sigma_t, rho, d, ss, ts):
    """SoE profile + 3-axis/3-channel MIS pdf (calculateBSSRDF,
    src/bssrdf.cuh:319-436, USE_SOE branches). Returns beta [N,3]."""
    radius = length(d)
    d_local = jnp.stack([dot(ss, d), dot(ts, d), dot(ns, d)], axis=-1) ** 2
    radius_proj = jnp.sqrt(jnp.stack([
        d_local[:, 1] + d_local[:, 2],
        d_local[:, 2] + d_local[:, 0],
        d_local[:, 0] + d_local[:, 1]], axis=-1))
    axis_channel_pdf = jnp.stack([
        jnp.abs(dot(ss, normal_next)) * (0.25 / 3.0),
        jnp.abs(dot(ts, normal_next)) * (0.25 / 3.0),
        jnp.abs(dot(ns, normal_next)) * (0.5 / 3.0)], axis=-1)

    s = param_soe(rho)
    pdf = jnp.zeros(radius.shape, jnp.float32)
    for axis in range(3):
        rp = radius_proj[:, axis]
        e1 = jnp.exp(-s * rp[:, None] * sigma_t)
        e2 = jnp.exp(-s * rp[:, None] * sigma_t / 3.0) / 3.0
        axis_pdf = (e1 + e2) / FOUR_PI * rho * s * sigma_t
        axis_pdf = jnp.where((rp > 1e-4)[:, None],
                             axis_pdf / jnp.maximum(rp, 1e-4)[:, None],
                             axis_pdf)
        pdf = pdf + jnp.sum(axis_pdf, axis=-1) * axis_channel_pdf[:, axis]

    e1 = jnp.exp(-s * radius[:, None] * sigma_t)
    e2 = jnp.exp(-s * radius[:, None] * sigma_t / 3.0)
    Sr = (e1 + e2) / EIGHT_PI * rho * s * sigma_t
    Sr = jnp.where((radius > 1e-4)[:, None],
                   Sr / jnp.maximum(radius, 1e-4)[:, None], Sr)
    beta = jnp.minimum(Sr / jnp.maximum(pdf, 1e-20)[:, None], 10.0)
    return beta


def calculate_bssrdf_table(scene, ns, normal_next, sigma_t, rho, d, ss, ts):
    """Tabulated profile + 3-axis/3-channel MIS pdf (calculateBSSRDF non-SoE
    branches, src/bssrdf.cuh:361-431). Returns beta [N,3]."""
    from ..bssrdf.sample import eval_profile_table
    t_rho = scene["bssrdf_rho"]
    t_rad = scene["bssrdf_radius"]
    t_prof = scene["bssrdf_profile"]
    t_eff = scene["bssrdf_rho_eff"]

    radius = length(d)
    d_local = jnp.stack([dot(ss, d), dot(ts, d), dot(ns, d)], axis=-1) ** 2
    radius_proj = jnp.sqrt(jnp.stack([
        d_local[:, 1] + d_local[:, 2],
        d_local[:, 2] + d_local[:, 0],
        d_local[:, 0] + d_local[:, 1]], axis=-1))
    axis_channel_pdf = jnp.stack([
        jnp.abs(dot(ss, normal_next)) * (0.25 / 3.0),
        jnp.abs(dot(ts, normal_next)) * (0.25 / 3.0),
        jnp.abs(dot(ns, normal_next)) * (0.5 / 3.0)], axis=-1)

    sigma_t2 = sigma_t * sigma_t
    pdf = jnp.zeros(radius.shape, jnp.float32)
    for axis in range(3):
        axis_pdf = jnp.zeros(radius.shape, jnp.float32)
        for ch in range(3):
            r_opt = radius_proj[:, axis] * sigma_t[:, ch]
            sr, re, valid = eval_profile_table(t_rho, t_rad, t_prof, t_eff,
                                               rho[:, ch], r_opt)
            channel_pdf = sr * sigma_t2[:, ch] / jnp.maximum(re, 1e-12)
            channel_pdf = jnp.where(r_opt > 1e-4,
                                    channel_pdf / jnp.maximum(r_opt, 1e-4),
                                    channel_pdf)
            axis_pdf = axis_pdf + jnp.where(valid,
                                            jnp.maximum(0.0, channel_pdf), 0.0)
        pdf = pdf + axis_pdf * axis_channel_pdf[:, axis]

    srs = []
    for ch in range(3):
        r_opt = radius * sigma_t[:, ch]
        sr, _, valid = eval_profile_table(t_rho, t_rad, t_prof, t_eff,
                                          rho[:, ch], r_opt)
        sr = jnp.where(r_opt > 1e-4, sr / jnp.maximum(r_opt, 1e-4), sr)
        srs.append(jnp.where(valid, jnp.maximum(0.0, sr * sigma_t2[:, ch]),
                             0.0))
    Sr = jnp.stack(srs, axis=-1)
    return jnp.minimum(Sr / jnp.maximum(pdf, 1e-20)[:, None], 10.0)


def _sample_probe_ray(r1, r2, r3, normal, hitpoint, sigma_t, rho, vx, vy,
                      scene=None, use_soe=True):
    """sampleBSSRDFprobeRay (src/bssrdf.cuh:278-317); SoE path by default,
    tabulated inverse-CDF path when use_soe=False.
    Returns (orig, dir, ray_length, radius)."""
    ch = jnp.clip((r1 * 3.0).astype(jnp.int32), 0, 2)
    r1 = r1 * 3.0 - ch.astype(jnp.float32)

    axis_n = r1 < 0.5
    axis_x = (r1 >= 0.5) & (r1 < 0.75)

    probe_dir = jnp.where(axis_n[:, None], normal,
                          jnp.where(axis_x[:, None], vx, vy))
    probex = jnp.where(axis_n[:, None], vx,
                       jnp.where(axis_x[:, None], normal, vx))
    probey = jnp.where(axis_n[:, None], vy,
                       jnp.where(axis_x[:, None], vy, normal))
    # the reference's in-place r1 updates (quirk kept; see module docstring)
    r1 = jnp.where(axis_n, r1 * 2.0,
                   jnp.where(axis_x, r1 * (r1 - 0.5) * 4.0,
                             r1 * (r1 - 0.75) * 4.0))

    # branch-free channel pick: the take_along_axis form lowers to a
    # per-index gather (6 calls/wave across the 3 probes; see
    # vecmath.channel_select)
    st_ch = jnp.maximum(channel_select(sigma_t, ch), 1e-12)
    rho_ch = channel_select(rho, ch)
    if use_soe:
        s = param_soe(rho_ch)
        radius = -jnp.log(jnp.maximum(1.0 - r2 * 0.99, 1e-12)) / st_ch / s
        radius_max = -jnp.log(0.01) / st_ch / s
        # the radius x3 only exists on the SoE path (src/bssrdf.cuh:304-307)
        x3 = r1 < 0.5
        radius = jnp.where(x3, radius * 3.0, radius)
        radius_max = jnp.where(x3, radius_max * 3.0, radius_max)
    else:
        from ..bssrdf.sample import sample_bssrdf_radius_table
        radius = sample_bssrdf_radius_table(
            scene["bssrdf_rho"], scene["bssrdf_radius"],
            scene["bssrdf_profile"], scene["bssrdf_cdf"],
            st_ch, rho_ch, r2 * 0.99)
        radius_max = sample_bssrdf_radius_table(
            scene["bssrdf_rho"], scene["bssrdf_radius"],
            scene["bssrdf_profile"], scene["bssrdf_cdf"],
            st_ch, rho_ch, jnp.full(rho_ch.shape, 0.99, jnp.float32))

    phi = 2.0 * jnp.pi * r3
    ray_len = 2.0 * jnp.sqrt(jnp.maximum(
        radius_max * radius_max - radius * radius, 0.0))
    orig = hitpoint + radius[:, None] * (probex * jnp.cos(phi)[:, None]
                                         + probey * jnp.sin(phi)[:, None]) \
        - (ray_len * 0.5)[:, None] * probe_dir
    return orig, probe_dir, ray_len, radius


def bssrdf_scatter(scene, settings, rng, hitpoint, normal2, mat, mat_id,
                   objcol, lanes):
    """The probe loop. Returns (rng, new_orig, new_dir, mask_mul, ok).

    Only `lanes` participate; others get don't-care outputs with ok=False.
    """
    from .wavefront import fetch_attributes  # local import to avoid cycle

    N = hitpoint.shape[0]
    rho = objcol
    sigma_t = 1.0 / jnp.maximum(mat["mfp"], 1e-12)
    vx, vy = make_basis(normal2)

    MAX_RATIO = 10.0
    MIN_NORMAL_DOT = 0.1

    need_new = jnp.ones((N,), bool)
    select_this = jnp.zeros((N,), bool)
    hit_count = jnp.zeros((N,), jnp.int32)
    hit_per_probe = jnp.zeros((N,), jnp.int32)
    probe_hit_count = jnp.zeros((N,), jnp.int32)
    probe_orig = hitpoint
    probe_dir = normal2
    probe_len = jnp.zeros((N,), jnp.float32)
    sampled_radius = jnp.ones((N,), jnp.float32)
    res_point = hitpoint
    res_normal = normal2
    res_color = objcol
    last_vec = jnp.zeros((N, 3), jnp.float32)

    use_soe = getattr(settings, "bssrdf_use_soe", True)
    for _ in range(settings.bssrdf_probes):
        rng, (r1, r2, r3, r4) = RaySampler.next_n(rng, 4)
        # ---- spawn a new probe ray where needed ----
        s_orig, s_dir, s_len, s_rad = _sample_probe_ray(
            r1, r2, r3, normal2, hitpoint, sigma_t, rho, vx, vy,
            scene=scene, use_soe=use_soe)
        commit = need_new & select_this
        probe_hit_count = jnp.where(commit, hit_per_probe, probe_hit_count)
        select_this = jnp.where(need_new, False, select_this)
        hit_per_probe = jnp.where(need_new, 0, hit_per_probe)
        probe_orig = jnp.where(need_new[:, None], s_orig, probe_orig)
        probe_dir = jnp.where(need_new[:, None], s_dir, probe_dir)
        probe_len = jnp.where(need_new, s_len, probe_len)
        sampled_radius = jnp.where(need_new, s_rad, sampled_radius)

        # ---- probe traversal (masked) ----
        # tmax clamps to the sampled probe length: hits beyond it are
        # discarded anyway, and short rays prune traversal early (the
        # reference's probe rays carry the same tMax semantics)
        from .wavefront import trace_rays
        slot, dist = trace_rays(scene, settings, probe_orig, probe_dir,
                                RAY_MIN, probe_len, anyhit=False,
                                active=lanes)
        got_hit = lanes & (slot >= 0)

        hp_any = probe_orig + probe_dir * dist[:, None]
        vec = hp_any - hitpoint
        real_radius = length(vec)
        last_vec = jnp.where(got_hit[:, None], vec, last_vec)

        hit_uv, smooth_n, surface_mat, geo_n = fetch_attributes(scene, slot,
                                                                hp_any)
        probe_obj_color = objcol
        if settings.use_texture:
            from .wavefront import texture_radiance
            tex = texture_radiance(scene, hit_uv)
            probe_obj_color = jnp.where(
                (mat["useTexture"] != 0)[:, None], tex, probe_obj_color)
        normal_dot = jnp.abs(dot(normalize(smooth_n), probe_dir))

        valid = got_hit & (surface_mat == mat_id) \
            & (real_radius / jnp.maximum(sampled_radius, 1e-12) < MAX_RATIO) \
            & (normal_dot > MIN_NORMAL_DOT)

        new_hit_count = hit_count + valid.astype(jnp.int32)
        take = valid & ((new_hit_count == 1)
                        | (r4 < 1.0 / jnp.maximum(new_hit_count, 1).astype(jnp.float32)))
        hit_count = new_hit_count
        hit_per_probe = hit_per_probe + valid.astype(jnp.int32)

        chosen_n = jnp.where((mat["useNormal"] != 0)[:, None], smooth_n, geo_n)
        res_point = jnp.where(take[:, None], hp_any, res_point)
        res_normal = jnp.where(take[:, None], chosen_n, res_normal)
        res_color = jnp.where(take[:, None], probe_obj_color, res_color)
        select_this = jnp.where(take, True, select_this)

        # ---- advance to next segment / next probe ----
        # (a miss now includes the beyond-probe-length case, since the
        # trace's tmax is the probe length)
        probe_len = jnp.where(got_hit, probe_len - dist, probe_len)
        probe_orig = jnp.where(got_hit[:, None],
                               hp_any + RAY_MIN * probe_dir, probe_orig)
        need_new = ~got_hit

    probe_hit_count = jnp.where(select_this, hit_per_probe, probe_hit_count)
    ok = lanes & (hit_count > 0)

    mask_mul = (probe_hit_count.astype(jnp.float32)[:, None]
                * res_color * objcol * 0.8)

    next_normal = normalize(res_normal)
    rng, (u1, u2) = RaySampler.next_n(rng, 2)
    next_dir = lambertian_sample(u1, u2, next_normal)

    if use_soe:
        beta = calculate_bssrdf_soe(normal2, next_normal, sigma_t, rho,
                                    last_vec, vx, vy)
    else:
        beta = calculate_bssrdf_table(scene, normal2, next_normal, sigma_t,
                                      rho, last_vec, vx, vy)
    mask_mul = mask_mul * beta

    # exit Fresnel factor (src/renderkernel.cu:808); the pre-outS product is
    # the reference's importanceSamplingMask (:805), needed by the
    # distant-light NEE at the exit point (:815-841)
    is_mul = mask_mul
    eta_t = mat["etaT"]
    out_s = (1.0 - fresnel_dielectric(dot(next_dir, next_normal), 1.0, eta_t)) \
        / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))
    mask_mul = mask_mul * out_s[:, None]

    new_orig = res_point + RAY_MIN * next_normal
    return rng, new_orig, next_dir, mask_mul, ok, is_mul, next_normal
