"""Path-regeneration wavefront integrator.

The classic bounce-loop integrator (wavefront.make_integrator) runs every
iteration at full width even when only the long glass paths survive
(a small share of lanes late in the frame). This integrator instead keeps a constant-width pool of ALWAYS-ACTIVE paths:
when a path terminates its radiance is scatter-added into the accumulation
buffer and the lane immediately respawns with the next unspawned camera
sample (possibly of a later frame). Total wave count ~= total path segments
/ pool width — no full-width iteration is wasted on dead lanes. This is the
"compact/regenerate" wavefront design (SURVEY.md §7 step 2; Laine et al.'s
path regeneration), and is only possible because RNG is counter-based per
(frame, pixel): a respawned lane reproduces exactly the stream the classic
integrator would have used, so both integrators produce identical sample
values (tests assert this).

Media and BSSRDF lanes run through the same shade machinery as the classic
integrator.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import RAY_MIN, RAY_MAX, INV_PI, dot, normalize
from ..core.rng import RaySampler, wang_hash
from ..scene.config import MAT_DIFF
from .wavefront import (
    RenderSettings, trace_rays, fetch_attributes, gather_material,
    env_miss_weighted, env_tex_merged, texture_radiance, shade,
)
from .medium import medium_interaction
from .bssrdf_shade import bssrdf_scatter
from .renderer import generate_camera_rays, lane_pixel_xy


# ring capacity as a multiple of the pool: scattered indices per death =
# F/(F-1/2); 4 (=1.14x) beat both 1 (=2x, ties the windowed flush) and 8
# (=1.07x: the rarer flush is bigger and the 2x buffer costs more than the
# 0.07x index saving) in earlier tuning; unmeasured on the GPU
_RING_FACTOR = 4


def make_regen_integrator(settings: RenderSettings, width, height,
                          with_stats=False, stop_after_waves=0):
    """Returns integrate_frames(scene, cam_vec, frame0, lane0, accum,
    n_frames) — lane0 is the shard's global lane offset (0 single-chip).

    with_stats=True additionally returns the number of rays actually traced
    (extension + NEE shadow), the honest denominator for end-to-end Mrays/s
    (bench.py) — the analog of counting the reference's per-bounce kernel
    launches + shadow rays rather than only primary samples.

    Respawn pulls from one GLOBAL sample queue (across frames). A
    block-local-queue variant — each 1024-lane block respawning only its
    own 32x32 pixel tile's samples — lost end to end in earlier tuning
    (block stragglers idle whole blocks) and was deleted; the compact
    pool ordering keeps neighbouring lanes coherent instead."""

    if settings.regen_order == "compact" and settings.bounce_max > 127:
        # the compact permute packs bounce into bits 24..30 of one int32
        # column (lbn into 16..23); a larger budget would corrupt state
        raise ValueError("regen_order='compact' requires bounce_max <= 127 "
                         "(bounce rides a 7-bit field of the packed "
                         "permute column)")

    deferred = (settings.scatter_mode in ("deferred", "ring")
                and settings.regen_order == "compact")
    ring_mode = deferred and settings.scatter_mode == "ring"
    dense_mode = deferred and settings.dense_fresh_flush
    # "sort" permute: the pool's vector state (orig/dir/mask/L) is carried
    # as per-channel (P,) PLANES and the whole compaction permute is ONE
    # stable multi-payload lax.sort whose operands are the carry itself —
    # no concat into a (P,16) gather operand, no per-index row-gather, no
    # slice/re-stack layout conversions (see RenderSettings.regen_permute).
    if settings.regen_permute not in ("gather", "sort"):
        # a typo must not silently behave as "gather"
        raise ValueError("unknown regen_permute %r (want gather/sort)"
                         % (settings.regen_permute,))
    sort_mode = settings.regen_permute == "sort"
    if sort_mode and settings.regen_order != "compact":
        raise ValueError("regen_permute='sort' requires "
                         "regen_order='compact'")

    def integrate_frames(scene, cam_vec, frame0, lane0, accum, n_frames):
        N = accum.shape[0]          # pixels owned by this shard
        # pool width is DECOUPLED from the image: huge frames run a
        # capped pool and just take more waves; the sample queue spans all
        # pixels either way. pool_lanes <= 0 means image-sized.
        P = N if settings.pool_lanes <= 0 else min(settings.pool_lanes, N)
        tot = jnp.uint32(N) * jnp.uint32(n_frames)  # total samples to spawn

        # accum rides the loop as THREE separate (N,) channel planes,
        # each the target of a 1-d scatter-add (chosen over one (N,3) row
        # scatter and one flat (3N,) plane in earlier tuning;
        # unmeasured on the GPU).
        #
        # The planes are additionally SWIZZLED: slot h(p) = (p % 1024)*B
        # + p//1024 holds pixel p (B = ceil(N/1024)). Deaths arrive in
        # tile-coherent bursts of near-CONSECUTIVE pixel indices; the
        # swizzle turns bursts into stride-B sequences, which a scatter
        # without a coalescing fast path serialises less. Un-swizzling is
        # one (1024, B) transpose per plane per CALL, and per-pixel float
        # add order is unchanged so results stay bit-identical. Whether
        # the GPU's scatter needs it is not measured (ROADMAP.md).
        _SA = 1024
        _SB = -(-N // _SA)
        _NS = _SA * _SB

        def _swz(p):
            return (p & (_SA - 1)) * _SB + (p >> 10)

        def _scramble(c):
            if _NS != N:
                c = jnp.pad(c, (0, _NS - N))
            return jnp.transpose(c.reshape(_SB, _SA)).reshape(-1)

        def _unscramble(c):
            return jnp.transpose(c.reshape(_SA, _SB)).reshape(-1)[:N]

        bc_f = lambda v: jax.lax.bitcast_convert_type(v, jnp.float32)
        bc_i = lambda v: jax.lax.bitcast_convert_type(v, jnp.int32)

        st = {
            "accum": tuple(_scramble(accum[:, c]) for c in range(3)),
            "waves": jnp.uint32(0),
            "next": jnp.uint32(0),
            # popcount(active) carried as a scalar (compact mode reads it
            # instead of re-reducing the mask every wave)
            "alive": jnp.uint32(0),
            "active": jnp.zeros((P,), bool),
            "orig": (tuple(jnp.zeros((P,), jnp.float32) for _ in range(3))
                     if sort_mode else jnp.zeros((P, 3), jnp.float32)),
            "dir": ((jnp.zeros((P,), jnp.float32),
                     jnp.zeros((P,), jnp.float32),
                     jnp.ones((P,), jnp.float32)) if sort_mode
                    else jnp.zeros((P, 3), jnp.float32).at[:, 2].set(1.0)),
            "mask": (tuple(jnp.zeros((P,), jnp.float32) for _ in range(3))
                     if sort_mode else jnp.zeros((P, 3), jnp.float32)),
            "rng": jnp.zeros((P,), jnp.uint32),
            "lbn": jnp.zeros((P,), jnp.int32),
            "bounce": jnp.zeros((P,), jnp.int32),
            "pixel": jnp.zeros((P,), jnp.int32),
            "medium_id": jnp.full((P,), -1, jnp.int32),
            "bsdf_pdf": jnp.full((P,), -1.0, jnp.float32),
        }
        if with_stats:
            # traced-ray counter (bench's honest Mrays/s denominator).
            # Carried ONLY when asked for: the NEE candidate count costs a
            # full-width cross-lane reduce per wave, which no production
            # caller should pay — tools/render.py and
            # the timed bench path run with_stats=False and read the ray
            # count from one untimed stats-enabled execution instead.
            st["rays"] = jnp.float32(0.0)
        if deferred:
            # per-path radiance, flushed to the image when the path dies
            st["L"] = (tuple(jnp.zeros((P,), jnp.float32) for _ in range(3))
                       if sort_mode else jnp.zeros((P, 3), jnp.float32))
        if ring_mode:
            # cross-wave dead-path bank: each wave's dead tail is COPIED
            # (contiguous dynamic_update_slice — bandwidth, not per-index)
            # into this ring and the per-index image scatter runs only when
            # the ring can't take another window. Scattered indices per
            # death = R/(R-Kw): capacity must be MUCH larger than the
            # append window for the amortization to beat the per-wave
            # windowed flush (R=P ties it at ~1.8x; R=4P gives ~1.14x).
            # Cols: L r/g/b + pixel as float value (bitcast pixels are
            # denormal bit patterns, which a device may flush to 0 — see
            # _flush_ring).
            st["ring"] = jnp.zeros((_RING_FACTOR * P, 4), jnp.float32)
            st["fill"] = jnp.int32(0)
        if dense_mode:
            # pixel-ordered accumulator for FIRST-SEGMENT deaths (paths
            # that die in the wave that spawned them): within the spawn
            # window the queue->pool mapping is affine, so these flush as
            # one dynamic-slice ADD (bandwidth) instead of riding the
            # ring's per-index scatter. P pad rows absorb the per-frame
            # queue wraparound; folded back onto the head once per call.
            st["dense"] = jnp.zeros((N + P, 3), jnp.float32)

        def cond(st):
            if settings.regen_order == "compact":
                # popcount(active) rides the loop as a SCALAR (see body:
                # spawn/death counts are closed-form), so the classic
                # any() full-width reduce disappears
                go = (st["next"] < tot) | (st["alive"] > 0)
            else:
                go = (st["next"] < tot) | jnp.any(st["active"])
            if stop_after_waves:
                # diagnostic hook (perf probes): freeze the pool after k
                # waves so the mid-frame ray population can be measured
                # standalone (bench.py, chip_smoke.py)
                go = go & (st["waves"] < stop_after_waves)
            return go

        def body(st):
            accum = st["accum"]
            src_st = st
            if sort_mode:
                # planar carry -> (P,3) views: consumers either slice
                # columns (stack-then-slice simplifies away) or run
                # elementwise (the stack fuses), so no copies materialize
                src_st = dict(st)
                planar = ("orig", "dir", "mask") + (("L",) if deferred
                                                    else ())
                for f in planar:
                    src_st[f] = jnp.stack(st[f], axis=1)
            active = src_st["active"]

            # ------------- respawn dead lanes (global queue) -------------
            # in compact mode EVERY per-wave population count is a scalar:
            # popcount(active) is carried in the state ("alive"), dead
            # lanes are an exact tail suffix (rank is iota arithmetic),
            # and the spawn count is min(queue remainder, n_dead) — so
            # the respawn pass does ZERO full-width reductions (the
            # classic form pays sum(dead) + sum(spawn) + sum(active) +
            # a cond any() per wave).
            dead = ~active
            du = dead.astype(jnp.uint32)
            if settings.regen_order == "compact":
                n_dead = jnp.uint32(P) - st["alive"]
                iota = jnp.arange(P, dtype=jnp.uint32)
                rank = jnp.where(dead, iota - (jnp.uint32(P) - n_dead), 0)
                rem = jnp.where(st["next"] < tot, tot - st["next"],
                                jnp.uint32(0))
                n_spawn = jnp.minimum(rem, n_dead)
            else:
                rank = jnp.cumsum(du) - du          # exclusive
            sid = st["next"] + rank                 # (N,)
            spawn = dead & (sid < tot)
            pixel_new = (sid % jnp.uint32(N)).astype(jnp.int32)
            frame_new = frame0 + (sid // jnp.uint32(N)).astype(jnp.uint32)
            if settings.regen_order == "compact":
                nxt = st["next"] + n_spawn
            else:
                nxt = st["next"] + jnp.sum(spawn, dtype=jnp.uint32)
            pixel_glob = pixel_new + lane0.astype(jnp.int32)
            rng_new = RaySampler.init(wang_hash(frame_new),
                                      pixel_glob.astype(jnp.uint32))
            # closed-form de-swizzle: a few int ops instead of a pool-wide
            # table gather
            pxi, pyi = lane_pixel_xy(pixel_glob, width, height)
            px = pxi.astype(jnp.float32)
            py = pyi.astype(jnp.float32)
            rng_new, o_new, d_new = generate_camera_rays(cam_vec, rng_new,
                                                         px, py)
            if settings.dup_stage == "respawn":
                # perturbed px defeats CSE; consumed with x0.0
                r2, o2, d2 = generate_camera_rays(cam_vec, rng_new,
                                                  px + 1e-6, py)
                o_new = o_new + 0.0 * (o2 + d2 + r2[:, None].astype(
                    jnp.float32))
            sel = spawn[:, None]
            orig = jnp.where(sel, o_new, src_st["orig"])
            raydir = jnp.where(sel, d_new, src_st["dir"])
            mask = jnp.where(sel, 1.0, src_st["mask"])
            rng = jnp.where(spawn, rng_new, src_st["rng"])
            lbn = jnp.where(spawn, settings.bounce_min, src_st["lbn"])
            bounce = jnp.where(spawn, 0, src_st["bounce"])
            pixel = jnp.where(spawn, pixel_new, src_st["pixel"])
            medium_id = jnp.where(spawn, -1, src_st["medium_id"])
            bsdf_pdf = jnp.where(spawn, -1.0, src_st["bsdf_pdf"])
            if deferred:
                ell = jnp.where(sel, 0.0, src_st["L"])
            active = active | spawn
            if settings.regen_order == "compact":
                n_act_u = st["alive"] + n_spawn     # popcount(active)
            rays = None
            if with_stats:
                if settings.regen_order == "compact":
                    rays = st["rays"] + n_act_u.astype(jnp.float32)
                else:
                    rays = st["rays"] + jnp.sum(active, dtype=jnp.float32)

            # ---------------- one wavefront segment ----------------
            # a single wave-level RNG draw keeps lanes independent; all
            # draws below consume the per-lane stream exactly like the
            # classic integrator.
            # In compact mode the active set is an exact lane PREFIX
            # (survivors compacted to the front, respawn fills the dead
            # tail in rank order), so the trace gets the count as a
            # device scalar and the kernel retires lanes past it at once.
            n_act = None
            if settings.regen_order == "compact":
                n_act = n_act_u.astype(jnp.int32)
            hit_slot, hit_t = trace_rays(scene, settings, orig, raydir,
                                         RAY_MIN, RAY_MAX, anyhit=False,
                                         active=active, active_prefix=n_act)
            if settings.dup_stage == "ext_trace":
                _, ht2 = trace_rays(scene, settings, orig, raydir,
                                    RAY_MIN * 1.0000001, RAY_MAX,
                                    anyhit=False, active=active,
                                    active_prefix=n_act)
                hit_t = hit_t + 0.0 * ht2

            if settings.has_media:
                rng, orig, raydir, mask, sampled_medium = medium_interaction(
                    scene, rng, orig, raydir, mask, hit_t, medium_id, active)
                lbn = jnp.where(sampled_medium,
                                jnp.minimum(lbn + 1, settings.bounce_max),
                                lbn)
            else:
                sampled_medium = jnp.zeros((P,), bool)

            surf = active & ~sampled_medium
            miss = surf & (hit_t > 1e10)

            hitpoint = orig + raydir * hit_t[:, None]
            hit_uv, smooth_n, mat_id, tri_n = fetch_attributes(
                scene, hit_slot, hitpoint)
            if settings.dup_stage == "fetch":
                u2_, n2_, m2_, t2_ = fetch_attributes(scene, hit_slot,
                                                      hitpoint + 1e-7)
                hit_uv = hit_uv + 0.0 * u2_
                smooth_n = smooth_n + 0.0 * n2_
                mat_id = mat_id + 0 * m2_
                tri_n = tri_n + 0.0 * t2_
            # radiance + sampler pdf ride ONE gather; bsdf_pdf (recorded at
            # the previous diffuse vertex, negative = weight 1) closes MIS.
            # When the merged envtex table exists, the env-miss fetch and
            # the texture fetch share that one gather (a lane is either a
            # miss or a surface hit — wavefront.env_tex_merged).
            merged_et = (settings.merge_envtex and settings.use_texture
                         and settings.use_envmap
                         and settings.env_importance_sampling
                         and "envtex_quad" in scene)
            if merged_et:
                env, tex_rgb = env_tex_merged(scene, settings, raydir,
                                              bsdf_pdf, cam_vec[15],
                                              miss, hit_uv)
                if settings.dup_stage in ("envmiss", "texture"):
                    # perturb hit_uv (feeds the gather ROW computation)
                    # so the duplicate's jnp.take is not CSE'd with the
                    # real one — perturbing only bsdf_pdf would leave
                    # identical gather indices and price ~0 for a stage
                    # whose cost IS the gather
                    e2, t2 = env_tex_merged(scene, settings, raydir,
                                            bsdf_pdf + 1e-7, cam_vec[15],
                                            miss, hit_uv + 1e-7)
                    env = env + 0.0 * e2
                    tex_rgb = tex_rgb + 0.0 * t2
            else:
                tex_rgb = None
                env = env_miss_weighted(scene, settings, raydir, bsdf_pdf,
                                        cam_vec[15])
                if settings.dup_stage == "envmiss":
                    # perturbed pdf defeats CSE; consumed with x0.0
                    e2 = env_miss_weighted(scene, settings, raydir,
                                           bsdf_pdf + 1e-7, cam_vec[15])
                    env = env + 0.0 * e2
            # radiance is ADDITIVE: every term is final when it occurs, so
            # this wave's contributions are scatter-added into the image at
            # the end of the wave instead of riding an accumulator column
            # through the pool permute (3 fewer permuted columns)
            contrib = jnp.where(miss[:, None], mask * env, 0.0)
            surf = surf & ~miss

            mat = gather_material(scene, mat_id)
            use_sn = mat["useNormal"] != 0
            n = normalize(jnp.where(use_sn[:, None], smooth_n, tri_n))
            objcol = mat["objcol"]
            if settings.use_texture:
                if tex_rgb is not None:
                    tex = tex_rgb
                else:
                    tex = texture_radiance(scene, hit_uv)
                    if settings.dup_stage == "texture":
                        t2 = texture_radiance(scene, hit_uv + 1e-7)
                        tex = tex + 0.0 * t2
                objcol = jnp.where((mat["useTexture"] != 0)[:, None], tex,
                                   objcol)
            into = dot(n, raydir) < 0.0
            nl = jnp.where(into[:, None], n, -n)
            contrib = contrib + jnp.where(surf[:, None],
                                          mask * mat["emit"], 0.0)

            rng, next_dir, mask_mul, offset, term, binc, aux = shade(
                scene, settings, rng, raydir, n, nl, into, mat, objcol)
            if settings.dup_stage == "shade":
                # same pre-draw rng state, perturbed raydir defeats CSE
                _, nd2, mm2, of2, _, _, _ = shade(
                    scene, settings, src_st["rng"], raydir * 1.0000001, n, nl,
                    into, mat, objcol)
                next_dir = next_dir + 0.0 * nd2
                mask_mul = mask_mul + 0.0 * mm2
                offset = offset + 0.0 * of2

            if settings.has_bssrdf:
                ss_lanes = surf & aux["ss_refract"]
                (rng, bs_orig, bs_dir, bs_mul, bs_ok, bs_is_mul,
                 bs_normal) = bssrdf_scatter(
                    scene, settings, rng, hitpoint, aux["ss_normal"], mat,
                    mat_id, objcol, ss_lanes)
                use_bs = ss_lanes & bs_ok
            else:
                use_bs = jnp.zeros((P,), bool)
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

            if settings.use_envmap and settings.env_importance_sampling:
                from .envsample import sample_env, power_heuristic
                rng, (e1, e2) = RaySampler.next_n(rng, 2)
                d_env, pdf_env, L_env = sample_env(scene, e1, e2,
                                                   cam_vec[15])
                if settings.dup_stage == "sample_env":
                    # swapped args defeat CSE; consumed with x0.0
                    d2, p2, L2 = sample_env(scene, e2, e1, cam_vec[15])
                    pdf_env = pdf_env + 0.0 * (p2 + d2[:, 0] + L2[:, 0])
                cos_e = dot(d_env, nl)
                diff_lane = surf & (mat["refltype"] == MAT_DIFF)
                cand = diff_lane & (cos_e > 0.0) & (pdf_env > 1e-12)
                if with_stats:
                    rays = rays + jnp.sum(cand, dtype=jnp.float32)
                s_slot, s_t = trace_rays(scene, settings, orig, d_env,
                                         RAY_MIN, RAY_MAX, anyhit=True,
                                         active=cand)
                if settings.dup_stage == "shadow_trace":
                    _, st2 = trace_rays(scene, settings, orig, d_env,
                                        RAY_MIN * 1.0000001, RAY_MAX,
                                        anyhit=True, active=cand)
                    s_t = s_t + 0.0 * st2
                lit = cand & (s_t > 1e10)
                f = mat["kd"][:, None] * objcol * INV_PI
                pdf_b = jnp.maximum(cos_e, 0.0) * INV_PI
                w = power_heuristic(pdf_env, pdf_b)
                scale = cos_e / jnp.maximum(pdf_env, 1e-12) * w
                contrib = contrib + jnp.where(
                    lit[:, None], mask_prev * f * scale[:, None] * L_env, 0.0)
                cos_n = jnp.maximum(dot(raydir, nl), 0.0)
                bsdf_pdf = jnp.where(
                    surf & diff_lane, cos_n * INV_PI,
                    jnp.where(surf, -1.0, bsdf_pdf))

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
                if with_stats:
                    rays = rays + jnp.sum(cand | cand_b, dtype=jnp.float32)
                s_slot, s_t = trace_rays(
                    scene, settings, orig,
                    jnp.broadcast_to(ddis, raydir.shape),
                    RAY_MIN, RAY_MAX, anyhit=True, active=cand | cand_b)
                lit = cand & (s_t > 1e10)
                f = objcol * INV_PI
                pdf_s = jnp.abs(cos_th) * INV_PI
                w = (pdf_s + 1.0) / (pdf_s * pdf_s + 1.0)
                contrib = contrib + jnp.where(
                    lit[:, None], mask * f * ldis * w[:, None], 0.0)
                lit_b = cand_b & (s_t > 1e10)
                eta_t = mat["etaT"]
                surface_f = ((1.0 - fresnel_dielectric(
                    jnp.abs(cos_b), 1.0, eta_t))
                    / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))) * INV_PI
                pdf_b2 = jnp.abs(cos_b) * INV_PI
                w_b = (pdf_b2 + 1.0) / (pdf_b2 * pdf_b2 + 1.0)
                contrib = contrib + jnp.where(
                    lit_b[:, None],
                    mask_prev * bs_is_mul * (surface_f * w_b)[:, None] * ldis,
                    0.0)

            lbn = jnp.where(surf, jnp.minimum(lbn + binc,
                                              settings.bounce_max), lbn)
            if settings.has_media:
                entered = surf & aux["glass_refract"] & into \
                    & (mat["has_medium"] != 0)
                left = surf & aux["glass_refract"] & ~into
                medium_id = jnp.where(entered, mat_id, medium_id)
                medium_id = jnp.where(left, -1, medium_id)

            bounce = jnp.where(active, bounce + 1, bounce)
            finished = active & (
                miss | (surf & term) | (bounce >= lbn)
                | (bounce >= settings.bounce_max))
            if deferred:
                # bank this wave's contributions on the path; the image
                # scatter happens at path death from the compacted tail
                # window (see the flush after the permute below)
                ell = ell + contrib
            if dense_mode:
                # ---- dense fresh-death flush (first-segment deaths) ----
                # Lanes spawned THIS wave sit in the dead-tail suffix the
                # respawn filled: row i holds sample sid = next0 + i -
                # (P - n_dead), so its pixel (sid % N) is AFFINE in i.
                # Their whole-path radiance (spawned and died this wave =
                # ell is exactly this wave's contrib) flushes as one
                # (P,3) dynamic-slice add into the pixel-ordered dense
                # buffer — a bandwidth op, vs the per-index cost the ring
                # drain pays for every scattered index. Zeroed L + pixel keep
                # them invisible to the ring (all-zero rows past its
                # cursor) and the 3-class compaction key below keeps the
                # OLD deaths an exact tail suffix so the ring's cursor
                # advances only by their count.
                fresh_dead = spawn & finished
                n_fd = jnp.sum(fresh_dead, dtype=jnp.int32)
                wv = jnp.where(fresh_dead[:, None], ell, 0.0)
                # row 0 maps to sample next0 - (P - n_dead); add N - P
                # (>= 0: P <= N) to keep the uint math wrap-free, then
                # wrap mod N. Valid while total spawned samples stay
                # under 2^32 (4.1e9 rays/call — far past any bench run).
                base = ((st["next"] + n_dead + jnp.uint32(N - P))
                        % jnp.uint32(N)).astype(jnp.int32)
                ds = jax.lax.dynamic_slice(st["dense"], (base, 0), (P, 3))
                dense_new = jax.lax.dynamic_update_slice(
                    st["dense"], ds + wv, (base, 0))
                ell = jnp.where(fresh_dead[:, None], 0.0, ell)
                pixel = jnp.where(fresh_dead, 0, pixel)
            else:
                fresh_dead = None
                n_fd = jnp.int32(0)
            if not deferred:
                # scatter-add this wave's contributions into the image
                # (channel-split: three 1-d scatters, see the accum
                # planes above)
                ar_, ag_, ab_ = accum
                hp = _swz(pixel)
                ar_ = ar_.at[hp].add(contrib[:, 0])
                ag_ = ag_.at[hp].add(contrib[:, 1])
                ab_ = ab_.at[hp].add(contrib[:, 2])
                if settings.dup_stage == "scatter":
                    ar_ = ar_.at[hp].add(0.0 * contrib[:, 0])
                    ag_ = ag_.at[hp].add(0.0 * contrib[:, 1])
                    ab_ = ab_.at[hp].add(0.0 * contrib[:, 2])
                accum = (ar_, ag_, ab_)
            if settings.regen_order == "compact":
                # the ONE remaining full-width reduce: this wave's deaths
                # (everything else derives from the carried alive scalar)
                alive_new = n_act_u - jnp.sum(finished, dtype=jnp.uint32)
            else:
                alive_new = jnp.sum(active & ~finished, dtype=jnp.uint32)
            active = active & ~finished

            out = {
                "accum": accum, "waves": st["waves"] + 1,
                "next": nxt, "active": active, "alive": alive_new,
                "orig": orig, "dir": raydir, "mask": mask,
                "rng": rng, "lbn": lbn, "bounce": bounce, "pixel": pixel,
                "medium_id": medium_id, "bsdf_pdf": bsdf_pdf,
            }
            if with_stats:
                out["rays"] = rays
            if deferred:
                out["L"] = ell
            if dense_mode:
                out["dense"] = dense_new
            if ring_mode:
                out["ring"] = st["ring"]
                out["fill"] = st["fill"]
            if settings.regen_order == "compact":
                # stable-compact survivors to the front; dead lanes collect
                # at the tail where next wave's respawn (rank order) hands
                # them CONSECUTIVE queue samples — so fresh neighbouring
                # lanes are whole 32x32-tile neighbourhoods and survivors
                # keep their generation's spatial order.
                su = active.astype(jnp.int32)
                # survivor ordering: HIT-SLOT major (exact flattened-BVH
                # slot of this wave's hit = DFS order = true tree
                # locality), direction octant minor, dead lanes to an
                # exact tail suffix via a stable argsort. Next wave's
                # neighbouring lanes (one warp on the GPU) then hold rays
                # that start on the SAME surface region and leave in
                # similar directions, so their traversal working sets
                # overlap (this beat octant-major order, bucketed slots
                # and Morton keys in earlier tuning; unmeasured on the
                # GPU). Any survivor order is correctness-neutral: queue
                # sample assignment is arbitrary and per-pixel sums are
                # unchanged.
                d_ = out["dir"]
                oct_ = ((d_[:, 0] < 0).astype(jnp.int32)
                        | ((d_[:, 1] < 0).astype(jnp.int32) << 1)
                        | ((d_[:, 2] < 0).astype(jnp.int32) << 2))
                dead_key = jnp.int32(2 ** 30)
                if dense_mode:
                    # 3-class order: alive < fresh-dead < old-dead, so the
                    # densely-flushed fresh deaths sit BETWEEN survivors
                    # and the ring-bound old deaths — the old deaths stay
                    # an exact tail suffix and the ring cursor advances
                    # only by their count (fresh rows bank as zeros past
                    # it). Next wave's respawn still sees all dead lanes
                    # as one contiguous suffix (fresh + old).
                    dead_key = dead_key + jnp.where(fresh_dead, 0, 1)
                key = jnp.where(active,
                                (jnp.maximum(hit_slot, 0) << 3) | oct_,
                                dead_key)
                if sort_mode:
                    # ONE stable multi-payload sort replaces argsort + the
                    # (P,16) row-gather. The planar carry makes the sort's
                    # operands the carry itself, so no slice/re-stack
                    # conversions materialize around it.
                    pack = ((out["medium_id"] + 1)
                            | (su << 8)
                            | (out["lbn"] << 16)
                            | (out["bounce"] << 24))
                    ops = [key,
                           out["orig"][:, 0], out["orig"][:, 1],
                           out["orig"][:, 2],
                           out["dir"][:, 0], out["dir"][:, 1],
                           out["dir"][:, 2],
                           out["mask"][:, 0], out["mask"][:, 1],
                           out["mask"][:, 2],
                           out["bsdf_pdf"], out["rng"], out["pixel"], pack]
                    if deferred:
                        ops += [out["L"][:, 0], out["L"][:, 1],
                                out["L"][:, 2]]
                    srt = jax.lax.sort(tuple(ops), num_keys=1,
                                       is_stable=True)
                    if settings.dup_stage == "permute":
                        srt2 = jax.lax.sort(
                            (key + 1,) + tuple(ops[1:]), num_keys=1,
                            is_stable=True)
                        srt = tuple(
                            s + (0.0 * s2 if s.dtype == jnp.float32
                                 else 0 * s2)
                            for s, s2 in zip(srt, srt2))
                    out["orig"] = srt[1:4]
                    out["dir"] = srt[4:7]
                    out["mask"] = srt[7:10]
                    out["bsdf_pdf"] = srt[10]
                    out["rng"] = srt[11]
                    out["pixel"] = srt[12]
                    pk = srt[13]
                    out["medium_id"] = (pk & 0xFF) - 1
                    out["active"] = ((pk >> 8) & 1) != 0
                    out["lbn"] = (pk >> 16) & 0xFF
                    out["bounce"] = pk >> 24
                    if deferred:
                        out["L"] = srt[14:17]
                        if ring_mode:
                            (out["accum"], out["ring"],
                             out["fill"]) = _flush_ring(out, n_fd)
                        else:
                            out["accum"] = _flush(out)
                        # flushed radiance must not flush twice
                        out["L"] = tuple(
                            jnp.where(out["active"], c, 0.0)
                            for c in out["L"])
                    return out
                src = jnp.argsort(key, stable=True).astype(jnp.int32)
                # ONE merged row-gather moves the whole pool state (a
                # gather's cost is per index, nearly independent of the
                # column count up to 16). Int columns ride as bitcast f32
                # (bit-exact: the bits are only moved, never computed
                # with). The "sort" permute above is the alternative.
                # pack: medium_id+1 (8b) | active (1b @8) | lbn (8b @16) |
                # bounce (7b @24); bounce/lbn <= bounce_max <= 127
                pack = ((out["medium_id"] + 1)
                        | (su << 8)
                        | (out["lbn"] << 16)
                        | (out["bounce"] << 24))
                cols = [out["orig"], out["dir"], out["mask"],
                        out["bsdf_pdf"][:, None],
                        bc_f(out["rng"].astype(jnp.int32))[:, None],
                        bc_f(out["pixel"])[:, None],
                        bc_f(pack)[:, None]]
                if deferred:
                    cols.append(out["L"])          # 13 -> 16 cols, ~free
                pmat = jnp.concatenate(cols, axis=1)
                pmat = jnp.take(pmat, src, axis=0)
                if settings.dup_stage == "permute":
                    pmat = pmat + 0.0 * jnp.take(pmat, src, axis=0)
                out["orig"], out["dir"], out["mask"] = (
                    pmat[:, 0:3], pmat[:, 3:6], pmat[:, 6:9])
                out["bsdf_pdf"] = pmat[:, 9]
                out["rng"] = bc_i(pmat[:, 10]).astype(jnp.uint32)
                out["pixel"] = bc_i(pmat[:, 11])
                pk = bc_i(pmat[:, 12])
                out["medium_id"] = (pk & 0xFF) - 1
                out["active"] = ((pk >> 8) & 1) != 0
                out["lbn"] = (pk >> 16) & 0xFF
                out["bounce"] = pk >> 24
                if deferred:
                    out["L"] = pmat[:, 13:16]
                    if ring_mode:
                        (out["accum"], out["ring"],
                         out["fill"]) = _flush_ring(out, n_fd)
                    else:
                        out["accum"] = _flush(out)
                    # flushed radiance must not flush twice: a dead lane
                    # can sit in the tail for many waves once the sample
                    # queue is exhausted
                    out["L"] = jnp.where(out["active"][:, None],
                                         out["L"], 0.0)
            return out

        # windowed-flush window = half the pool: a quarter-pool window
        # overflowed to the full-flush branch on most waves; the half-pool
        # window catches nearly every wave while still halving the scatter
        Kw = max(P // 2, 1)
        # ring append window = 3/4 pool: steady-state deaths are
        # ~0.48-0.7P per wave on the demo scene — right AT a half-pool
        # window, which fired the full-pool fallback on almost half the
        # waves. 3/4 makes the fallback rare while the P-rung
        # _ring_scatter ladder keeps flush windows tight.
        Kr = max(3 * P // 4, 1)

        def _flush(out):
            """Scatter dead paths' banked radiance into the image.

            After compaction dead lanes are an EXACT tail suffix, so when
            <= Kw lanes are dead the scatter touches only the last Kw pool
            rows — the scatter-add's cost is per index, so a smaller window
            cuts the per-wave image-accumulation cost in proportion. The rare wave where more than Kw lanes
            die (a frame's last wave, mass sky misses) takes the full-pool
            branch of the cond instead — nothing is ever dropped."""
            acc = out["accum"]
            n_alive = out["alive"].astype(jnp.int32)
            act = out["active"]

            def Lc(c):
                # L is a 3-tuple of planes under the sort permute, a (P,3)
                # matrix under the gather permute
                return (out["L"][c] if isinstance(out["L"], tuple)
                        else out["L"][:, c])

            def flush_window(a):
                ar_, ag_, ab_ = a
                lw = [jnp.where(act[P - Kw:], 0.0, Lc(c)[P - Kw:])
                      for c in range(3)]
                pw = _swz(out["pixel"][P - Kw:])
                return (ar_.at[pw].add(lw[0]), ag_.at[pw].add(lw[1]),
                        ab_.at[pw].add(lw[2]))

            def flush_full(a):
                ar_, ag_, ab_ = a
                lf = [jnp.where(act, 0.0, Lc(c)) for c in range(3)]
                pf = _swz(out["pixel"])
                return (ar_.at[pf].add(lf[0]), ag_.at[pf].add(lf[1]),
                        ab_.at[pf].add(lf[2]))

            fits = (P - n_alive) <= Kw
            acc = jax.lax.cond(fits, flush_window, flush_full, acc)
            if settings.dup_stage == "scatter":
                acc = acc + 0.0 * jax.lax.cond(fits, flush_window,
                                               flush_full, acc)
            return acc

        def _ring_scatter(acc, ring, fill):
            """Scatter the ring's banked (L, pixel) rows [0, fill) into the
            image and return (acc, zeroed ring). The scatter cost is
            per-index of the window passed, so a static ladder picks the
            smallest prefix window covering fill. Rungs every P/4
            rows: the mid-loop pre-flush fires at fill > R - Kr (= 3.25P
            at the defaults), so P-granular rungs always paid the full-R
            scatter — ~1.23 scattered idx/death; P/4 rungs track fill to
            ~1.06. (A while_loop that drained in P-row chunks lowered to a
            slower scatter than this static-window form and was
            reverted.)

            The scatter is UNMASKED: the ring keeps the invariant that
            rows >= fill are all-zero (initial zeros; the append writes
            zeros into its window's garbage rows; the drain re-zeroes the
            prefix it scattered), so stale rows contribute +0.0 to pixel 0
            without the per-row iota/compare/select chain the masked form
            paid on up-to-4P rows per drain (the zero-write is a ~free
            bandwidth store; the mask was elementwise work on the
            scatter's critical path)."""
            R = ring.shape[0]
            rung_step = max(P // 4, 1)

            def scat(w):
                def go(args):
                    (ar_, ag_, ab_), r = args
                    pix = r[:w, 3].astype(jnp.int32)
                    lw = r[:w, 0:3]
                    ar_ = ar_.at[pix].add(lw[:, 0])
                    ag_ = ag_.at[pix].add(lw[:, 1])
                    ab_ = ab_.at[pix].add(lw[:, 2])
                    if settings.dup_stage == "scatter":
                        a2 = ar_.at[pix].add(lw[:, 0] * 1.0000001)
                        b2 = ag_.at[pix].add(lw[:, 1] * 1.0000001)
                        c2 = ab_.at[pix].add(lw[:, 2] * 1.0000001)
                        ar_ = ar_ + 0.0 * a2
                        ag_ = ag_ + 0.0 * b2
                        ab_ = ab_ + 0.0 * c2
                    # restore the rows-past-fill-are-zero invariant for
                    # the next fill cycle (static-width prefix store)
                    r = r.at[:w].set(0.0)
                    return (ar_, ag_, ab_), r
                return go

            def ladder(lo):
                # smallest rung in {lo, lo+P/4, ..., R} covering fill
                if lo >= R:
                    return scat(R)
                return lambda ar: jax.lax.cond(fill <= lo, scat(lo),
                                               ladder(lo + rung_step), ar)
            return ladder(rung_step)((acc, ring))

        def _flush_ring(out, n_fd_=jnp.int32(0)):
            """Ring-banked variant of _flush (scatter_mode="ring").

            The compacted dead tail is a contiguous suffix, so banking it
            is ONE (Kr,4) dynamic_update_slice — a bandwidth copy, no
            per-index cost. The window is written ROW-REVERSED so the
            n_dead dead rows land FIRST at the fill cursor; the alive-row
            garbage behind them sits past the cursor and is either
            overwritten by the next wave's copy or masked at scatter time.
            The per-index image scatter runs only when the ring can't take
            another window plus once after the loop — total scattered
            indices track actual deaths instead of a window every wave.
            Waves where more than Kr lanes die (frame-final sky waves,
            queue exhaustion) bypass the ring with the full-pool direct
            scatter, exactly like _flush's fallback branch."""
            acc, ring, fill = out["accum"], out["ring"], out["fill"]
            # fresh deaths were densely flushed this wave (L and pixel
            # zeroed, sorted between survivors and old deaths): the ring
            # banks only the OLD deaths — the exact tail suffix of
            # n_dead rows. Fresh rows inside the copied window are
            # all-zero, so they satisfy the rows-past-fill invariant.
            n_dead = P - out["alive"].astype(jnp.int32) - n_fd_

            def pre_flush(args):
                a, r, f = args
                a, r = _ring_scatter(a, r, f)
                return a, r, jnp.int32(0)

            acc, ring, fill = jax.lax.cond(fill + Kr > ring.shape[0],
                                           pre_flush, lambda args: args,
                                           (acc, ring, fill))

            def Lc(c):
                return (out["L"][c] if isinstance(out["L"], tuple)
                        else out["L"][:, c])

            def append(args):
                a, r, f = args
                act_w1 = out["active"][P - Kr:]
                lw = [jnp.where(act_w1, 0.0, Lc(c)[P - Kr:])
                      for c in range(3)]
                # dead lanes are the pool's exact tail suffix, so within
                # this window they are its LAST n_dead rows; after the
                # reversal below they land first. The window's alive-lane
                # rows (past the cursor after the copy) must be ALL-ZERO
                # — pixel column included — to keep the ring's
                # rows-past-fill-are-zero invariant that lets the drain
                # scatter unmasked.
                # pixel rides as a float VALUE, not a bitcast: pixel
                # indices < 2^23 are DENORMAL f32 bit patterns, and a
                # device that flushes denormals to zero in the
                # reverse/concat/DUS pipeline reads a bitcast-carried
                # pixel column back all-zero (every banked path's
                # radiance lands on pixel 0, skies go black) while every
                # CPU test passes. Float values are
                # exact for any pixel index < 2^24 (the swizzled slot is
                # < N + 1023, still well under 2^24 at any supported
                # resolution). The ring banks the SWIZZLED slot so the
                # drain scatters it as-is.
                pw = jnp.where(act_w1, 0.0,
                               _swz(out["pixel"][P - Kr:])
                               .astype(jnp.float32))
                win = jnp.stack(lw + [pw], axis=1)[::-1]
                if settings.dup_stage == "scatter":
                    r2 = jax.lax.dynamic_update_slice(
                        r, win * 1.0000001, (f, jnp.int32(0)))
                    r = r + 0.0 * r2
                r = jax.lax.dynamic_update_slice(r, win, (f, jnp.int32(0)))
                return a, r, f + n_dead

            def fallback(args):
                (ar_, ag_, ab_), r, f = args
                lf = [jnp.where(out["active"], 0.0, Lc(c))
                      for c in range(3)]
                pf = _swz(out["pixel"])
                ar_ = ar_.at[pf].add(lf[0])
                ag_ = ag_.at[pf].add(lf[1])
                ab_ = ab_.at[pf].add(lf[2])
                if settings.dup_stage == "scatter":
                    a2 = ar_.at[pf].add(lf[0] * 1.0000001)
                    b2 = ag_.at[pf].add(lf[1] * 1.0000001)
                    c2 = ab_.at[pf].add(lf[2] * 1.0000001)
                    ar_ = ar_ + 0.0 * a2
                    ag_ = ag_ + 0.0 * b2
                    ab_ = ab_ + 0.0 * c2
                return (ar_, ag_, ab_), r, f

            return jax.lax.cond(n_dead <= Kr, append, fallback,
                                (acc, ring, fill))

        st = jax.lax.while_loop(cond, body, st)
        if stop_after_waves:
            if sort_mode:      # probes expect (P,3) vector state
                st = dict(st)
                for f in ("orig", "dir", "mask") + (("L",) if deferred
                                                    else ()):
                    st[f] = jnp.stack(st[f], axis=1)
            return st          # raw pool state for perf probes
        if ring_mode:
            # drain what the loop banked but never had to scatter
            st["accum"], _ = _ring_scatter(st["accum"], st["ring"],
                                           st["fill"])
        acc_out = jnp.stack([_unscramble(c) for c in st["accum"]], axis=1)
        if dense_mode:
            # fold the queue-wrap pad rows back onto the head and add the
            # densely-flushed first-segment radiance (pixel-ordered, so it
            # adds straight onto the un-swizzled accum). One dense add per
            # CALL; per-pixel add order within a frame is unchanged (each
            # pixel's path dies exactly once per frame).
            d = st["dense"]
            acc_out = acc_out + d[:N].at[:P].add(d[N:N + P])
        if with_stats:
            return acc_out, st["waves"], st["rays"]
        return acc_out, st["waves"]

    return integrate_frames
