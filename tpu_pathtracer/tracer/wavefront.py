"""The wavefront path integrator.

Wavefront re-architecture of the reference's per-pixel megakernel
(renderKernel, src/renderkernel.cu:472-855): the per-thread locals become SoA
columns over a lane axis, the bounce loop becomes a lax.while_loop whose body
is one wavefront iteration (intersect -> classify -> shade -> respawn), and
the material switch (src/renderkernel.cu:603-848) becomes branch-free: every
BSDF is evaluated for every lane (cheap elementwise math) and the result
selected by material id — the heavy, gather-bound traversal runs exactly
once per bounce.

Adaptive bounce budget matches the reference: start LIGHT_BOUNCE_NUM_MIN=2,
specular events extend by 1, hard cap LIGHT_BOUNCE_NUM_MAX=16
(src/renderkernel.cu:50-52,512,525,641,...).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core.vecmath import (
    RAY_MIN, RAY_MAX, INV_PI, PI, dot, dotk, normalize, reflect, barycentric,
)

from ..core.rng import RaySampler
from ..scene.config import (
    MAT_EMIT, MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_DIFF_REFL, MAT_FRESNEL,
    MAT_NULL, MAT_SUBSURFACE,
)
from ..scene.texture import sample_texture_quad, sample_envmap_quad
from ..materials.bsdf import (
    lambertian_sample, specular_glass_sample, ggx_reflection_sample,
    rough_glass_sample, microfacet_interface_sample, fresnel_blend_sample,
    henyey_greenstein_sample,
)
from .traverse import intersect_scene
from .medium import medium_interaction
from .bssrdf_shade import bssrdf_scatter


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static (trace-time) configuration; the analog of the reference's
    compile-time macros (src/renderkernel.cu:45-54)."""
    bounce_min: int = 2
    bounce_max: int = 16
    use_envmap: bool = True
    use_texture: bool = True
    has_media: bool = False
    has_bssrdf: bool = False
    use_distant_light: bool = False
    stack_depth: int = 64
    bssrdf_probes: int = 3   # maxLoopNum, src/renderkernel.cu:727
    bssrdf_use_soe: bool = True  # USE_SOE, src/bssrdf.cuh:8
    # next-event estimation toward the envmap with MIS (BASELINE config 2);
    # the reference is BSDF-sampling-only, which fireflies on sun disks
    env_importance_sampling: bool = True
    # NEE draws restricted to the top-k brightest texels (pdf renormalized
    # over the subset, 0 elsewhere — unbiased under MIS; see
    # envsample.build_env_distribution: a small alias table is a cheap
    # gather, and shadow rays toward a few bright texels stay coherent).
    # <= 0 disables; envs with fewer texels are unaffected.
    env_nee_topk: int = 16384
    # integrator: "bounce" = classic full-width bounce loop, "regen" = path
    # regeneration (constant-width always-active pool; see tracer/regen.py)
    integrator: str = "regen"
    # pool ordering discipline: "inplace" respawns dead lanes where they
    # died (the pool degrades into a pixel-mixed soup), "compact"
    # stable-compacts survivors to the front each wave and appends fresh
    # spawns at the tail, so neighbouring lanes hold rays of mostly one
    # spawn generation (consecutive queue samples = consecutive swizzled
    # pixels = one 32x32 tile neighbourhood) and the active set is an
    # exact lane prefix. The classic wavefront compaction step (Laine et
    # al.) as a pool permutation; its cost against "inplace" on the GPU is
    # not measured yet.
    regen_order: str = "compact"
    # compact-permute implementation: "gather" = argsort + one (P,13-16)
    # row-gather, "sort" = one stable 17-operand lax.sort moving every
    # pool column as a sort payload, with the pool's vector state carried
    # as per-channel (P,) planes so the sort's operands are the carry
    # itself.
    regen_permute: str = "gather"
    # regen pool width cap (lanes), decoupled from the image: frames
    # larger than the cap run a fixed-width pool and take proportionally
    # more waves; the sample queue spans all pixels either way. <= 0 means
    # image-sized.
    pool_lanes: int = 1 << 20
    # profiling hook (bench stage pricing): duplicate ONE stage of the
    # regen wave and consume the copy with x0.0, so (t_dup - t_base) is that
    # stage's marginal in-situ cost — the only way to price a stage inside
    # a fused XLA program (deleting a stage instead lets XLA DCE shared
    # work and under-reports). "" = off; one of "ext_trace", "shadow_trace",
    # "permute", "scatter", "sample_env", "respawn", "fetch", "envmiss",
    # "texture", "shade".
    dup_stage: str = ""
    # image-accumulation discipline for the regen integrator: "deferred"
    # carries per-path radiance in three extra pool columns (it rides the
    # compact permute) and scatter-adds only the compacted dead TAIL
    # window (pool/4 indices) when paths finish, with a lax.cond full-pool
    # flush on the rare wave where more than pool/4 lanes die. "ring"
    # (default) goes one step further: the dead tail window is COPIED
    # (contiguous dynamic_update_slice — bandwidth, not per-index) into a
    # 4x-pool-sized cross-wave ring and the per-index image scatter runs
    # only when the ring can't take another window, so scattered indices
    # track actual deaths (~1.14x per death vs ~1.8x for the per-wave
    # window). "wave" scatter-adds every lane's contribution every wave
    # (the scatter is per-index, so it costs the full pool width each
    # wave). Deferral/ring need the compaction tail (regen_order=
    # "compact"); "wave" is used otherwise.
    scatter_mode: str = "ring"
    # dense fresh-death flush: paths that die in the SAME wave that
    # spawned them (first-segment deaths — sky-direct pixels, about half
    # of all deaths on the demo scene) never enter the ring/scatter path.
    # Within the spawn window the queue->pool mapping is affine (respawn
    # hands dead-tail lanes consecutive sample ids), so their banked
    # radiance rides ONE dynamic-slice add into a pixel-ordered dense
    # buffer — bandwidth, not a per-index scatter. A 3-class compaction
    # key (alive < fresh-dead < old-dead) keeps the non-fresh deaths an
    # exact tail suffix so the ring banks and scatters only them. Requires
    # deferred radiance (scatter_mode "deferred"/"ring" + regen_order
    # "compact").
    dense_fresh_flush: bool = True
    distant_light_L: tuple = (1.2, 1.2, 1.2)      # src/renderkernel.cu:521
    distant_light_dir: tuple = (0.0, 1.3, -3.6)   # src/renderkernel.cu:522
    # traversal: "auto" = the CUDA per-ray kernel (ops/traverse.cu) on a
    # GPU backend and the plain step machine (traverse.intersect_scene)
    # elsewhere; "plain" forces the step machine on every backend (the
    # reference for the kernel's A/B and device gates)
    traversal: str = "auto"
    # merged env+texture per-wave gather (wavefront.env_tex_merged): the
    # env-miss and texture fetches are mutually exclusive per lane, so one
    # gather on the concatenated table serves both. Off = the two separate
    # full-width gathers, for A/B.
    merge_envtex: bool = True


def trace_rays(scene, settings: RenderSettings, orig, raydir, tmin, tmax,
               anyhit=False, active=None, active_prefix=None):
    """The traversal seam: the CUDA kernel when the process's default
    backend is a GPU (and settings.traversal is "auto"), the plain step
    machine otherwise. A kernel library that fails to build or load
    raises; there is no silent fallback.

    active: (N,) bool mask of lanes to trace (None = all). active_prefix:
    optional traced scalar asserting the active set is the exact lane
    prefix [0, n) (the regen pool's compaction invariant); the kernel
    retires lanes >= n at once. The plain path uses the mask, which the
    caller must therefore still pass."""
    mode = settings.traversal
    if mode not in ("auto", "plain"):
        raise ValueError("unknown traversal %r (want auto/plain)" % (mode,))
    if mode == "auto" and jax.default_backend() == "gpu":
        from ..ops.traverse_gpu import gpu_intersect
        return gpu_intersect(scene["packed"], orig, raydir, tmin, tmax,
                             anyhit=anyhit, active=active,
                             active_prefix=active_prefix)
    return intersect_scene(
        None, None, scene["num_nodes"], orig, raydir, tmin, tmax,
        anyhit=anyhit, stack_depth=settings.stack_depth, active=active,
        packed=scene["packed"], tile_size=None)


def pack_tri_attributes(tri_pos, tri_uv, tri_nrm, tri_mat,
                        prims=None, num_nodes=0):
    """Pack the per-slot attribute streams into one (Kt,28) array so the
    shading stage pays ONE gather per lane instead of five (per-lane
    gathers inside the bounce loop dominate if not fused). Columns: pos[0:9] uv[9:15] nrm[15:24] mat[24] (bitcast)
    geo_n[25:28].

    geo_n precomputes woop_geometric_normal's cross(m1.xyz, m2.xyz) per
    slot from the unified stream's Woop rows (bit-identical inputs and
    f32 ops), removing a second full-width (1M,12) row-gather chain from
    every wave. prims=None (tests/back-compat)
    leaves the geo_n columns zero."""
    import numpy as np
    Kt = tri_pos.shape[0]
    out = np.zeros((Kt, 28), np.float32)
    out[:, 0:9] = tri_pos
    out[:, 9:15] = tri_uv
    out[:, 15:24] = tri_nrm
    out[:, 24] = np.asarray(tri_mat, np.int32).view(np.float32)
    if prims is not None:
        p = np.asarray(prims[num_nodes:num_nodes + Kt], np.float32)
        out[:, 25:28] = np.cross(p[:, 4:7], p[:, 8:11])
    return out


def fetch_attributes(scene, hit_slot, hitpoint):
    """Barycentric-interpolated uv + smooth normal + geometric normal at
    the hit (textureFetching, src/renderkernel.cu:440-466 + the :392
    Woop-row cross). Single packed gather.
    Returns (hit_uv, smooth_n, mat_id, tri_n); tri_n is zero on miss
    lanes, matching woop_geometric_normal."""
    safe = jnp.maximum(hit_slot, 0)
    a = jnp.take(scene["tri_attr"], safe, axis=0)      # [N,28]
    p0, p1, p2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    u, v, w = barycentric(hitpoint, p0, p1, p2)
    hit_uv = (u[:, None] * a[:, 9:11] + v[:, None] * a[:, 11:13]
              + w[:, None] * a[:, 13:15])
    smooth_n = (u[:, None] * a[:, 15:18] + v[:, None] * a[:, 18:21]
                + w[:, None] * a[:, 21:24])
    mat_id = jax.lax.bitcast_convert_type(a[:, 24], jnp.int32)
    tri_n = jnp.where((hit_slot >= 0)[:, None], a[:, 25:28], 0.0)
    return hit_uv, smooth_n, mat_id, tri_n


# material table column layout (see materials_to_arrays / pack_mat_table)
_MAT_COLS = {
    "refltype": (0, 1), "objcol": (1, 4), "emit": (4, 7), "alphax": (7, 8),
    "alphay": (8, 9), "kd": (9, 10), "ks": (10, 11), "etaT": (11, 12),
    "useNormal": (12, 13), "useTexture": (13, 14), "F0": (14, 17),
    "tangent": (17, 20), "mfp": (20, 23), "med_sigma_s": (23, 26),
    "med_sigma_a": (26, 29), "med_g": (29, 30), "has_medium": (30, 31),
}
_INT_MAT_COLS = ("refltype", "useNormal", "useTexture", "has_medium")


def pack_mat_table(mat_arrays):
    """Pack material SoA columns into one (M,31) f32 table."""
    import numpy as np
    M = mat_arrays["refltype"].shape[0]
    t = np.zeros((M, 31), np.float32)
    for k, (a, b) in _MAT_COLS.items():
        v = np.asarray(mat_arrays[k], np.float32)
        t[:, a:b] = v.reshape(M, b - a)
    return t


def gather_material(scene, mat_id):
    """Fetch per-lane material params. Material counts are tiny (<= dozens),
    so instead of a gather this is a one-hot matmul against the packed
    (M,31) table — no gather at all (the branch-free analog of the
    gpuMatDesc fetch at src/renderkernel.cu:570-582). HIGHEST precision:
    a GPU may otherwise run an f32 product in TF32, which would round
    every material parameter to ~3 decimal digits."""
    table = scene["mat_table"]                     # (M,31)
    M = table.shape[0]
    oh = (mat_id[:, None] == jnp.arange(M, dtype=jnp.int32)[None, :])
    rows = jnp.dot(oh.astype(jnp.float32), table,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)  # (N,31)
    m = {}
    for k, (a, b) in _MAT_COLS.items():
        v = rows[:, a:b] if b - a > 1 else rows[:, a]
        if k in _INT_MAT_COLS:
            v = v.astype(jnp.int32)
        m[k] = v
    return m


def env_radiance(scene, settings: RenderSettings, raydir, env_rotation):
    if settings.use_envmap:
        return sample_envmap_quad(scene["envmap_quad"], scene["env_h"],
                                  scene["env_w"], raydir, env_rotation)
    return jnp.broadcast_to(scene["env_const"], raydir.shape)


def env_miss_weighted(scene, settings: RenderSettings, raydir, bsdf_pdf,
                      env_rotation):
    """Environment radiance already weighted by the BSDF-side MIS factor.

    bsdf_pdf: per-lane solid-angle pdf of the draw that produced `raydir`
    at the previous diffuse vertex, or a NEGATIVE sentinel when no env
    next-event estimation happened there (weight 1). The sampler pdf comes
    out of the SAME quad-row gather as the radiance (cols 12:16, see
    texture.sample_envmap_quad_pdf) — this replaces a separate
    env_pdf_of_dir gather per wave, with bit-identical results."""
    if not settings.use_envmap:
        return jnp.broadcast_to(scene["env_const"], raydir.shape)
    if not settings.env_importance_sampling:
        return env_radiance(scene, settings, raydir, env_rotation)
    from ..scene.texture import sample_envmap_quad_pdf
    from .envsample import power_heuristic
    L, p_uv = sample_envmap_quad_pdf(
        scene["envmap_quad"], scene["env_h"], scene["env_w"], raydir,
        env_rotation)
    y = raydir[:, 1]
    sin_t = jnp.sqrt(jnp.maximum(1.0 - y * y, 1e-8))
    pdf_e = p_uv / (2.0 * PI * PI * sin_t)
    w = jnp.where(bsdf_pdf < 0.0, 1.0, power_heuristic(bsdf_pdf, pdf_e))
    return w[:, None] * L


def texture_radiance(scene, hit_uv):
    return sample_texture_quad(scene["texture_quad"], scene["tex_h"],
                               scene["tex_w"], hit_uv[:, 0], hit_uv[:, 1])


def pack_envtex_quad(env_quad16, tex_quad12):
    """Concatenate the 16-col env quad table and the (zero-padded) 12-col
    texture quad table into ONE gather target. A pool lane is either a
    MISS (env fetch) or a SURFACE hit (texture fetch) — the two full-width
    per-wave gathers are mutually exclusive per lane, and a per-index
    gather costs about the same on the merged table as on either source
    table alone — so merging halves the number of gathered indices. Env
    rows come first; texture row r sits at
    env_h*env_w + r."""
    import numpy as np
    e = np.asarray(env_quad16, np.float32)
    t = np.asarray(tex_quad12, np.float32)
    out = np.zeros((e.shape[0] + t.shape[0], 16), np.float32)
    out[:e.shape[0]] = e
    out[e.shape[0]:, :12] = t
    return out


def env_tex_merged(scene, settings: RenderSettings, raydir, bsdf_pdf,
                   env_rotation, miss, hit_uv):
    """MIS-weighted env-miss radiance AND texture radiance from ONE gather
    on the merged envtex_quad table (see pack_envtex_quad).

    Returns (env_weighted_L [N,3], tex_rgb [N,3]) with values bit-identical
    to env_miss_weighted / texture_radiance: the per-lane interpolation
    math is the same op sequence, only the row SOURCE is merged (a miss
    lane's row holds the env quad, any other lane's the texture quad; each
    consumer is already masked to its own lane class). Requires envmap
    importance sampling (the 16-col env rows carry pdf_uv in cols 12:16)."""
    from ..scene.texture import _uv_from_dir
    from .envsample import power_heuristic
    He, We = scene["env_h"], scene["env_w"]
    Ht, Wt = scene["tex_h"], scene["tex_w"]
    KE = He * We
    # env indexing (clamp) — the sample_envmap_quad_pdf address math
    u_e, v_e = _uv_from_dir(raydir, env_rotation)
    xe = u_e * We - 0.5
    ye = v_e * He - 0.5
    xe0 = jnp.floor(xe)
    ye0 = jnp.floor(ye)
    fxe = (xe - xe0)[..., None]
    fye = (ye - ye0)[..., None]
    xe0i = jnp.clip(xe0.astype(jnp.int32), 0, We - 1)
    ye0i = jnp.clip(ye0.astype(jnp.int32), 0, He - 1)
    env_row = ye0i * We + xe0i
    # texture indexing (wrap) — the sample_texture_quad address math.
    # Miss lanes can carry non-finite hit_uv (hitpoint at t=RAY_MAX); their
    # int casts are backend-defined but finite, the mod keeps the row in
    # range, and the where() below never selects it.
    u_t = jnp.mod(hit_uv[:, 0], 1.0)
    v_t = jnp.mod(hit_uv[:, 1], 1.0)
    xt = u_t * Wt - 0.5
    yt = v_t * Ht - 0.5
    xt0 = jnp.floor(xt)
    yt0 = jnp.floor(yt)
    fxt = (xt - xt0)[..., None]
    fyt = (yt - yt0)[..., None]
    xt0i = jnp.mod(xt0.astype(jnp.int32), Wt)
    yt0i = jnp.mod(yt0.astype(jnp.int32), Ht)
    tex_row = KE + yt0i * Wt + xt0i

    q = jnp.take(scene["envtex_quad"], jnp.where(miss, env_row, tex_row),
                 axis=0)                                   # [N,16]
    L = (q[..., 0:3] * (1 - fxe) * (1 - fye) + q[..., 3:6] * fxe * (1 - fye)
         + q[..., 6:9] * (1 - fxe) * fye + q[..., 9:12] * fxe * fye)
    sx = jnp.clip((u_e * We).astype(jnp.int32) - xe0i, 0, 1)
    sy = jnp.clip((v_e * He).astype(jnp.int32) - ye0i, 0, 1)
    p00, p01 = q[..., 12], q[..., 13]
    p10, p11 = q[..., 14], q[..., 15]
    p_uv = jnp.where(sy == 0, jnp.where(sx == 0, p00, p01),
                     jnp.where(sx == 0, p10, p11))
    y = raydir[:, 1]
    sin_t = jnp.sqrt(jnp.maximum(1.0 - y * y, 1e-8))
    pdf_e = p_uv / (2.0 * PI * PI * sin_t)
    w = jnp.where(bsdf_pdf < 0.0, 1.0, power_heuristic(bsdf_pdf, pdf_e))
    env_L = w[:, None] * L
    tex_L = (q[..., 0:3] * (1 - fxt) * (1 - fyt)
             + q[..., 3:6] * fxt * (1 - fyt)
             + q[..., 6:9] * (1 - fxt) * fyt + q[..., 9:12] * fxt * fyt)
    return env_L, tex_L


def shade(scene, settings, rng, raydir, n, nl, into, mat, objcol):
    """Evaluate all material branches and select by refltype.

    Returns (rng, next_dir, mask_mul [N,3], offset_steps [N] — the multiple of
    RAY_MIN*nl added to the hitpoint, terminate [N], bounce_inc [N],
    refract_glass [N] — lanes that refracted through a medium interface)."""
    N = raydir.shape[0]
    rng, (u1, u2, u3, u4, u5, u6) = RaySampler.next_n(rng, 6)
    refl_t = mat["refltype"]
    one3 = jnp.ones((N, 3), jnp.float32)

    # --- MAT_DIFF (src/renderkernel.cu:604-639) ---
    d_dir = lambertian_sample(u1, u2, nl)
    d_mul = mat["kd"][:, None] * objcol
    # --- MAT_REFL (:640-655); mirror offsets twice (quirk kept) ---
    mirror = mat["alphax"] == 0.0
    mir_dir = normalize(reflect(raydir, n))
    g_dir, g_beta = ggx_reflection_sample(
        u1, u2, raydir, nl, mat["tangent"], mat["F0"],
        mat["alphax"], mat["alphay"])
    r_dir = jnp.where(mirror[:, None], mir_dir, g_dir)
    r_mul = jnp.where(mirror[:, None],
                      mat["ks"][:, None] * objcol,
                      mat["ks"][:, None] * g_beta * objcol)
    r_off = jnp.where(mirror, 2.0, 1.0)
    # --- MAT_DIFF_REFL (:656-669) ---
    dr_spec = u5 < mat["ks"] / jnp.maximum(mat["ks"] + mat["kd"], 1e-7)
    dr_dir = jnp.where(dr_spec[:, None], g_dir, d_dir)
    dr_mul = jnp.where(dr_spec[:, None], g_beta, objcol)
    # --- MAT_FRESNEL (:670-675) ---
    f_dir, f_beta = fresnel_blend_sample(
        u1, u2, u3, raydir, nl, mat["kd"][:, None] * objcol, mat["F0"],
        mat["alphax"])
    # --- MAT_GLASS (:676-694) ---
    sg_dir, sg_refl = specular_glass_sample(u1, into, raydir, nl, mat["etaT"])
    rg_dir, rg_beta, rg_refl = rough_glass_sample(
        u1, u2, into, raydir, nl, mat["etaT"], mat["alphax"])
    smooth = mat["alphax"] == 0.0
    gl_refl = jnp.where(smooth, sg_refl, rg_refl)
    gl_dir = jnp.where(smooth[:, None], sg_dir, rg_dir)
    eta2 = mat["etaT"] * mat["etaT"]
    rg_mul = rg_beta[:, None] * objcol \
        * jnp.where((~rg_refl & ~into)[:, None], eta2[:, None], 1.0)
    gl_mul = jnp.where(smooth[:, None], one3, rg_mul)
    gl_off = jnp.where(gl_refl, 1.0, -1.0)
    # --- MAT_SUBSURFACE entry interface (:698-707) ---
    ss_m, ss_rdir, ss_beta, ss_refl = microfacet_interface_sample(
        u1, u2, into, raydir, nl, mat["etaT"], mat["alphax"])
    ss_refl_mul = ss_beta[:, None] * mat["ks"][:, None] * objcol

    # select by material id
    next_dir = d_dir
    next_dir = jnp.where((refl_t == MAT_REFL)[:, None], r_dir, next_dir)
    next_dir = jnp.where((refl_t == MAT_DIFF_REFL)[:, None], dr_dir, next_dir)
    next_dir = jnp.where((refl_t == MAT_FRESNEL)[:, None], f_dir, next_dir)
    next_dir = jnp.where((refl_t == MAT_GLASS)[:, None], gl_dir, next_dir)
    next_dir = jnp.where((refl_t == MAT_SUBSURFACE)[:, None], ss_rdir, next_dir)
    next_dir = jnp.where((refl_t == MAT_NULL)[:, None], raydir, next_dir)

    mask_mul = d_mul
    mask_mul = jnp.where((refl_t == MAT_REFL)[:, None], r_mul, mask_mul)
    mask_mul = jnp.where((refl_t == MAT_DIFF_REFL)[:, None], dr_mul, mask_mul)
    mask_mul = jnp.where((refl_t == MAT_FRESNEL)[:, None], f_beta, mask_mul)
    mask_mul = jnp.where((refl_t == MAT_GLASS)[:, None], gl_mul, mask_mul)
    mask_mul = jnp.where((refl_t == MAT_SUBSURFACE)[:, None], ss_refl_mul, mask_mul)
    mask_mul = jnp.where((refl_t == MAT_NULL)[:, None], one3, mask_mul)

    offset = jnp.ones((N,), jnp.float32)
    offset = jnp.where(refl_t == MAT_REFL, r_off, offset)
    offset = jnp.where(refl_t == MAT_DIFF_REFL, 0.0, offset)
    offset = jnp.where(refl_t == MAT_FRESNEL, 0.0, offset)
    offset = jnp.where(refl_t == MAT_GLASS, gl_off, offset)
    offset = jnp.where(refl_t == MAT_SUBSURFACE, 1.0, offset)
    offset = jnp.where(refl_t == MAT_NULL, -1.0, offset)

    terminate = refl_t == MAT_EMIT

    bounce_inc = jnp.zeros((N,), jnp.int32)
    is_specular_event = (
        (refl_t == MAT_REFL)
        | ((refl_t == MAT_DIFF_REFL) & dr_spec)
        | (refl_t == MAT_FRESNEL)
        | (refl_t == MAT_GLASS)
        | ((refl_t == MAT_SUBSURFACE) & ss_refl))
    bounce_inc = is_specular_event.astype(jnp.int32)

    # lanes entering a refractive interface (for medium tracking)
    glass_refract = (refl_t == MAT_GLASS) & ~gl_refl
    ss_refract = (refl_t == MAT_SUBSURFACE) & ~ss_refl

    aux = {
        "glass_refract": glass_refract,
        "ss_refract": ss_refract,
        "ss_normal": ss_m,
        "u": (u1, u2, u3, u4, u5, u6),
    }
    return rng, next_dir, mask_mul, offset, terminate, bounce_inc, aux


def make_integrator(settings: RenderSettings):
    """Build the jit-able integrator body closed over static settings."""

    def integrate(scene, rng, orig, raydir, cam_env_rotation):
        """Trace paths to completion. orig/raydir: [N,3] primary rays.
        Returns (rng, radiance [N,3])."""
        N = orig.shape[0]
        mask = jnp.ones((N, 3), jnp.float32)
        accum = jnp.zeros((N, 3), jnp.float32)
        active = jnp.ones((N,), bool)
        light_bounce_num = jnp.full((N,), settings.bounce_min, jnp.int32)
        bounce = jnp.int32(0)
        # medium state: material id of the medium the ray is inside (-1 none)
        medium_id = jnp.full((N,), -1, jnp.int32)

        def cond(st):
            return jnp.any(st["active"]) & (st["bounce"] < settings.bounce_max)

        def body(st):
            rng = st["rng"]
            orig = st["orig"]
            raydir = st["raydir"]
            mask = st["mask"]
            accum = st["accum"]
            active = st["active"]
            lbn = st["lbn"]
            medium_id = st["medium_id"]

            hit_slot, hit_t = trace_rays(
                scene, settings, orig, raydir, RAY_MIN, RAY_MAX,
                anyhit=False, active=active)

            # ---------- participating media (wired-in HomogeneousMedium,
            # src/reflection.cuh:152-197) ----------
            if settings.has_media:
                rng, orig, raydir, mask, sampled_medium = medium_interaction(
                    scene, rng, orig, raydir, mask, hit_t, medium_id, active)
                # scattering inside a medium extends the bounce budget (like
                # the reference's specular events); dense media need many
                # scatter events to cross
                lbn = jnp.where(sampled_medium,
                                jnp.minimum(lbn + 1, settings.bounce_max),
                                lbn)
            else:
                sampled_medium = jnp.zeros((N,), bool)

            surf = active & ~sampled_medium

            # ---------- environment miss (src/renderkernel.cu:553-557) ----
            # DEFERRED: each lane reaches the environment at most once, so
            # record (direction, throughput) here and evaluate the envmap
            # once after the bounce loop instead of paying its bilinear
            # gather every iteration.
            miss = surf & (hit_t > 1e10)
            miss_dir = jnp.where(miss[:, None], raydir, st["miss_dir"])
            # bsdf_pdf carries the pdf of the draw that produced this ray
            # when the previous vertex also did env next-event estimation
            # (negative = no NEE there, MIS weight 1); the weight itself is
            # applied in the single deferred env fetch after the loop
            miss_mask = jnp.where(miss[:, None], mask, st["miss_mask"])
            miss_bpdf = jnp.where(miss, st["bsdf_pdf"], st["miss_bpdf"])
            active = active & ~miss
            surf = surf & ~miss

            # ---------- surface interaction ----------
            hitpoint = orig + raydir * hit_t[:, None]
            hit_uv, smooth_n, mat_id, tri_n = fetch_attributes(
                scene, hit_slot, hitpoint)
            mat = gather_material(scene, mat_id)
            use_sn = mat["useNormal"] != 0
            n = normalize(jnp.where(use_sn[:, None], smooth_n, tri_n))

            objcol = mat["objcol"]
            if settings.use_texture:
                tex = texture_radiance(scene, hit_uv)
                objcol = jnp.where((mat["useTexture"] != 0)[:, None], tex, objcol)

            into = dot(n, raydir) < 0.0
            nl = jnp.where(into[:, None], n, -n)

            # emission (src/renderkernel.cu:600)
            accum = accum + jnp.where(surf[:, None], mask * mat["emit"], 0.0)

            rng, next_dir, mask_mul, offset, term, binc, aux = shade(
                scene, settings, rng, raydir, n, nl, into, mat, objcol)

            # ---------- BSSRDF probe machinery ----------
            if settings.has_bssrdf:
                ss_lanes = surf & aux["ss_refract"]
                (rng, bs_orig, bs_dir, bs_mul, bs_ok, bs_is_mul,
                 bs_normal) = bssrdf_scatter(
                    scene, settings, rng, hitpoint, aux["ss_normal"], mat,
                    mat_id, objcol, ss_lanes)
                # lanes whose probe found a surface continue from there;
                # failed probes fall back to the entry reflection branch with
                # beta*ks*objcol (src/renderkernel.cu:785-789) — that is what
                # shade() already produced in mask_mul for ss lanes.
                use_bs = ss_lanes & bs_ok
            else:
                use_bs = jnp.zeros((N,), bool)
                bs_orig = hitpoint
                bs_dir = next_dir
                bs_mul = mask_mul
                bs_is_mul = mask_mul
                bs_normal = nl

            new_orig = hitpoint + nl * (offset * RAY_MIN)[:, None]
            new_orig = jnp.where(use_bs[:, None], bs_orig, new_orig)
            new_dir = jnp.where(use_bs[:, None], bs_dir, next_dir)
            new_mul = jnp.where(use_bs[:, None], bs_mul, mask_mul)

            mask_prev = mask
            mask = jnp.where(surf[:, None], mask * new_mul, mask)
            orig = jnp.where(surf[:, None], new_orig, orig)
            raydir = jnp.where(surf[:, None], new_dir, raydir)

            # ---------- envmap next-event estimation + MIS ----------
            bsdf_pdf = st["bsdf_pdf"]
            if settings.use_envmap and settings.env_importance_sampling:
                from .envsample import sample_env, power_heuristic
                rng, (e1, e2) = RaySampler.next_n(rng, 2)
                d_env, pdf_env, L_env = sample_env(scene, e1, e2,
                                                   cam_env_rotation)
                cos_e = dot(d_env, nl)
                diff_lane = surf & (mat["refltype"] == MAT_DIFF)
                cand = diff_lane & (cos_e > 0.0) & (pdf_env > 1e-12)
                s_slot, s_t = trace_rays(scene, settings, orig, d_env,
                                         RAY_MIN, RAY_MAX, anyhit=True,
                                         active=cand)
                lit = cand & (s_t > 1e10)
                f = mat["kd"][:, None] * objcol * INV_PI
                pdf_b = jnp.maximum(cos_e, 0.0) * INV_PI
                w = power_heuristic(pdf_env, pdf_b)
                scale = cos_e / jnp.maximum(pdf_env, 1e-12) * w
                accum = accum + jnp.where(
                    lit[:, None], mask_prev * f * scale[:, None] * L_env, 0.0)
                # record the BSDF pdf of the new direction on diffuse
                # lanes; the complementary MIS weight is computed at the
                # deferred env fetch (env pdf rides the same quad gather)
                cos_n = jnp.maximum(dot(raydir, nl), 0.0)
                pdf_bn = cos_n * INV_PI
                bsdf_pdf = jnp.where(
                    surf & diff_lane, pdf_bn,
                    jnp.where(surf, -1.0, bsdf_pdf))

            # ---------- distant light importance sampling ----------
            # (USE_DISTANT_LIGHT, src/renderkernel.cu:54,611-636,815-841:
            # MAT_DIFF and BSSRDF-exit lanes fire a shadow ray toward the
            # fixed distant light and add a power-heuristic-weighted term.
            # Note the reference multiplies the already-albedo-scaled mask
            # by f = objcol/pi again — quirk kept.)
            if settings.use_distant_light:
                from ..materials.fresnel import (
                    fresnel_dielectric, fresnel_moment_1)
                ddis = normalize(jnp.asarray(settings.distant_light_dir,
                                             jnp.float32))
                ldis = jnp.asarray(settings.distant_light_L, jnp.float32)
                diff_lane = surf & (mat["refltype"] == MAT_DIFF)
                cos_th = dot(jnp.broadcast_to(ddis, raydir.shape), nl)
                cand = diff_lane & (cos_th >= 0.0)
                # BSSRDF exit points also sample the distant light
                # (src/renderkernel.cu:815-841)
                bs_lane = surf & use_bs
                cos_b = dot(jnp.broadcast_to(ddis, raydir.shape),
                            normalize(bs_normal))
                cand_b = bs_lane & (cos_b >= 0.0)
                s_slot, s_t = trace_rays(
                    scene, settings, orig, jnp.broadcast_to(ddis, raydir.shape),
                    RAY_MIN, RAY_MAX, anyhit=True, active=cand | cand_b)
                lit = cand & (s_t > 1e10)
                f = objcol * INV_PI
                light_pdf = 1.0
                scat_pdf = jnp.abs(cos_th) * INV_PI
                w = (scat_pdf + light_pdf) / (scat_pdf * scat_pdf
                                              + light_pdf * light_pdf)
                contrib = mask * f * ldis * w[:, None]
                accum = accum + jnp.where(lit[:, None], contrib, 0.0)
                lit_b = cand_b & (s_t > 1e10)
                eta_t = mat["etaT"]
                surface_f = ((1.0 - fresnel_dielectric(
                    jnp.abs(cos_b), 1.0, eta_t))
                    / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))) * INV_PI
                pdf_b2 = jnp.abs(cos_b) * INV_PI
                w_b = (pdf_b2 + 1.0) / (pdf_b2 * pdf_b2 + 1.0)
                accum = accum + jnp.where(
                    lit_b[:, None],
                    mask_prev * bs_is_mul * (surface_f * w_b)[:, None] * ldis,
                    0.0)
            lbn = jnp.where(surf, jnp.minimum(
                lbn + binc, settings.bounce_max), lbn)
            active = active & ~(surf & term)

            # medium tracking: entering/leaving refractive interfaces
            if settings.has_media:
                entered = surf & aux["glass_refract"] & into \
                    & (mat["has_medium"] != 0)
                left = surf & aux["glass_refract"] & ~into
                medium_id = jnp.where(entered, mat_id, medium_id)
                medium_id = jnp.where(left, -1, medium_id)

            bounce = st["bounce"] + 1
            active = active & (bounce < lbn)
            return {
                "rng": rng, "orig": orig, "raydir": raydir, "mask": mask,
                "accum": accum, "active": active, "lbn": lbn,
                "bounce": bounce, "medium_id": medium_id,
                "miss_dir": miss_dir, "miss_mask": miss_mask,
                "miss_bpdf": miss_bpdf, "bsdf_pdf": bsdf_pdf,
            }

        st = {
            "rng": rng, "orig": orig, "raydir": raydir, "mask": mask,
            "accum": accum, "active": active, "lbn": light_bounce_num,
            "bounce": bounce, "medium_id": medium_id,
            "miss_dir": jnp.zeros((N, 3), jnp.float32),
            "miss_mask": jnp.zeros((N, 3), jnp.float32),
            "miss_bpdf": jnp.full((N,), -1.0, jnp.float32),
            "bsdf_pdf": jnp.full((N,), -1.0, jnp.float32),
        }
        st = jax.lax.while_loop(cond, body, st)
        # deferred environment contribution (once per path), MIS-weighted
        env = env_miss_weighted(scene, settings, st["miss_dir"],
                                st["miss_bpdf"], cam_env_rotation)
        return st["rng"], st["accum"] + st["miss_mask"] * env

    return integrate
