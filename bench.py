#!/usr/bin/env python
"""Benchmark against BASELINE.json: "Mrays/sec + time-to-1024spp at 1080p
(TestObj scene)", on one NVIDIA GPU.

Prints ONE JSON line whose headline is the WEAKEST of the baseline axes:

  axis 1  traversal_mrays_per_sec   coherent-primary BVH traversal at
                                    1024^2 through the traversal seam
                                    (wavefront.trace_rays -> the CUDA
                                    kernel); baseline bar 100 Mrays/s.
  axis 2  render_mrays_per_sec_1080p  end-to-end progressive render at
                                    1920x1080 counting rays actually traced
                                    (path segments + NEE shadow rays),
                                    against the same 100 Mrays/s bar: the
                                    reference's whole value proposition is
                                    the interactive 1080p loop
                                    (reference src/main.cpp:154-247).

Also: the incoherent (cosine-bounce) and frozen mid-frame regen-pool
traversal rates; 1-spp frame times for the 1080p and 1024^2 demo, its
media and subsurface variants, the 135k-triangle large scene and the
~104k-triangle organic subsurface and media scenes; the per-frame device
time by category from the profiler trace (utils/profiling.py); and
time_to_1024spp_1080p_min, the 1080p frame time times 1024 (an
extrapolation, not a measured wall clock).

Before any number it runs the device gates (utils/device_gates.py): the
kernel against the brute-force oracle and the plain traversal, regen
against the classic bounce integrator, and device renders against the CPU
goldens. A failed gate or axis fails the run; nothing is caught.

Method: every timing is the median wall time of several calls after a
warm-up, each ending in block_until_ready. Every result names the device
(platform, device_kind, count). Without a GPU the script exits non-zero.
One process: it never starts a second JAX process on the card.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _median_time(fn, reps=5):
    import jax
    jax.block_until_ready(fn())  # warm (compiles)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    from tpu_pathtracer.utils import compcache
    compcache.enable()
    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench.py measures the GPU; JAX found %r" % dev.platform,
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "count": len(jax.devices())}
    from tpu_pathtracer.scene.demo import (
        testobj_scene, default_camera, large_scene)
    from tpu_pathtracer.scene import procedural
    from tpu_pathtracer.tracer.renderer import Renderer, generate_camera_rays
    from tpu_pathtracer.tracer.regen import make_regen_integrator
    from tpu_pathtracer.tracer.wavefront import trace_rays
    from tpu_pathtracer.tracer.traverse import woop_geometric_normal
    from tpu_pathtracer.core.rng import RaySampler, wang_hash
    from tpu_pathtracer.core.vecmath import RAY_MIN, RAY_MAX
    from tpu_pathtracer.utils import device_gates as gates

    gate_log = {}

    def record(key, value):
        gate_log[key] = value

    fb, mats, envmap, texture = testobj_scene(cache_dir=".bvh_cache")
    W = H = 1024
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W, height=H)
    N = r.width * r.height
    cam_vec = jnp.asarray(default_camera(W, H).build_render_camera()
                          .as_array())
    rng = RaySampler.init(wang_hash(jnp.uint32(1)),
                          jnp.arange(N, dtype=jnp.uint32))
    _, orig, raydir = generate_camera_rays(
        cam_vec, rng, jnp.asarray(r._lane_px, jnp.float32),
        jnp.asarray(r._lane_py, jnp.float32))

    # ---------------- on-device correctness gates ----------------
    lg_parts = large_scene(cache_dir=".bvh_cache")
    lg_r = Renderer(*lg_parts[:2], envmap=lg_parts[2], texture=lg_parts[3],
                    width=W, height=H)
    gates.kernel_gates(record, "demo", fb,
                       procedural.make_test_scene().tri_vertices(), 4096,
                       256, (orig, raydir))
    gates.kernel_gates(record, "large", lg_parts[0],
                       procedural.make_large_scene().tri_vertices(), 1024,
                       32, (orig, raydir))
    gates.regen_vs_bounce(record, fb, mats, envmap, texture)
    gm = gates.load_golden_module(ROOT)
    gcfg = gm._configs()
    for gname in ("c4_media", "c5_bssrdf", "c6_organic_sss",
                  "c7_organic_media"):
        want = np.load(os.path.join(ROOT, "tests", "goldens",
                                    gname + ".npz"))["img"]
        gates.golden_gate(record, gname, gm._render(gname, gcfg[gname]),
                          want)

    # ---------------- traversal axes ----------------
    def trace_rate(rend, o, d):
        f = jax.jit(lambda o_, d_: trace_rays(rend.scene, rend.settings, o_,
                                              d_, RAY_MIN, RAY_MAX))
        sec = _median_time(lambda: f(o, d))
        return o.shape[0] / sec / 1e6

    trav_mrays = trace_rate(r, orig, raydir)

    # incoherent: cosine-hemisphere bounce rays spawned from the real
    # primary-hit distribution
    hs, ht = trace_rays(r.scene, r.settings, orig, raydir, RAY_MIN, RAY_MAX)
    gn = np.asarray(woop_geometric_normal(r.scene["prims"],
                                          r.scene["num_nodes"], hs))
    o_np, d_np = np.asarray(orig), np.asarray(raydir)
    gn = np.where((np.sum(gn * d_np, -1) < 0.0)[:, None], gn, -gn)
    hp = o_np + d_np * np.asarray(ht)[:, None]
    prng = np.random.default_rng(7)
    u1 = prng.uniform(size=N).astype(np.float32)
    u2 = prng.uniform(size=N).astype(np.float32)
    rad, phi = np.sqrt(u1), 2.0 * np.pi * u2
    t1 = np.cross(gn, np.where(np.abs(gn[:, 2:3]) < 0.9,
                               [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]))
    t1 /= np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-12)
    t2 = np.cross(gn, t1)
    bd = (t1 * (rad * np.cos(phi))[:, None] + t2 * (rad * np.sin(phi))[:, None]
          + gn * np.sqrt(np.maximum(1.0 - u1, 0.0))[:, None])
    hit_idx = np.where(np.asarray(hs) >= 0)[0]
    wrap = hit_idx[np.arange(N) % hit_idx.size]   # fill misses w/ real hits
    incoh_mrays = trace_rate(
        r, jnp.asarray((hp + gn * 1e-3)[wrap].astype(np.float32)),
        jnp.asarray(bd[wrap].astype(np.float32)))

    # the real mid-frame population: the regen pool frozen after 3 waves
    def midframe_rate(rend):
        pool = jax.jit(make_regen_integrator(rend.settings, W, H,
                                             stop_after_waves=3),
                       static_argnames=("n_frames",))(
            rend.scene, cam_vec, jnp.uint32(1), jnp.uint32(0),
            rend.zeros_accum(), n_frames=4)
        return trace_rate(rend, pool["orig"], pool["dir"])

    midframe_mrays = midframe_rate(r)

    # ---------------- end-to-end frame axes ----------------
    def frame_cost(width, height, parts=None, reps=5):
        """(ms per 1-spp frame, rays traced per frame, waves per frame) of
        the default (regen) integrator; rays and waves come from one
        stats-enabled execution, the time from the production program."""
        p_fb, p_mats, p_env, p_tex = parts or (fb, mats, envmap, texture)
        rr = Renderer(p_fb, p_mats, envmap=p_env, texture=p_tex,
                      width=width, height=height)
        cv = jnp.asarray(default_camera(width, height)
                         .build_render_camera().as_array())
        fn = jax.jit(make_regen_integrator(rr.settings, width, height),
                     static_argnames=("n_frames",))
        fn_stats = jax.jit(make_regen_integrator(rr.settings, width, height,
                                                 with_stats=True),
                           static_argnames=("n_frames",))
        accum = rr.zeros_accum()
        sec = _median_time(lambda: fn(rr.scene, cv, jnp.uint32(1),
                                      jnp.uint32(0), accum, n_frames=1),
                           reps=reps)
        _, waves, rays = fn_stats(rr.scene, cv, jnp.uint32(1), jnp.uint32(0),
                                  accum, n_frames=1)
        return sec * 1e3, float(rays), int(waves)

    ms_hd, rays_hd, waves_hd = frame_cost(1920, 1080)
    render_mrays = rays_hd / (ms_hd / 1e3) / 1e6
    ms_sq, rays_sq, waves_sq = frame_cost(1024, 1024)
    wl = {}
    for variant in ("media", "subsurface"):
        wl[variant] = frame_cost(1024, 1024, parts=testobj_scene(
            cache_dir=".bvh_cache", variant=variant))[0]
    lg_ms, lg_rays, _ = frame_cost(1024, 1024, parts=lg_parts)
    org = {}
    for gname in ("c6_organic_sss", "c7_organic_media"):
        org[gname] = frame_cost(1024, 1024, parts=gcfg[gname][:4])[0]

    # ---------------- per-category device time (profiler) ----------------
    from tpu_pathtracer.utils.profiling import profile_frames
    fn_b = jax.jit(make_regen_integrator(r.settings, W, H),
                   static_argnames=("n_frames",))
    acc_b = r.zeros_accum()
    breakdown = profile_frames(
        lambda: fn_b(r.scene, cam_vec, jnp.uint32(1), jnp.uint32(0), acc_b,
                     n_frames=1),
        os.path.join(ROOT, "chiprun_out", "bench_trace"))

    ax1 = trav_mrays / 100.0
    ax2 = render_mrays / 100.0
    extra = {
        "device": device,
        "traversal_mrays_per_sec": trav_mrays,
        "incoherent_mrays_per_sec": incoh_mrays,
        "midframe_mrays_per_sec": midframe_mrays,
        "render_mrays_per_sec_1080p": render_mrays,
        "time_to_1024spp_1080p_min_extrapolated": ms_hd * 1024.0 / 60e3,
        "baseline_time_to_1024spp_1080p_min": 
            rays_hd * 1024.0 / 100e6 / 60.0,
        "ms_per_frame_1spp_1080p": ms_hd,
        "rays_per_frame_1080p": rays_hd,
        "waves_per_frame_1080p": waves_hd,
        "ms_per_frame_1spp": ms_sq,
        "rays_per_frame_1024": rays_sq,
        "waves_per_frame_1024": waves_sq,
        "ms_per_frame_1spp_media": wl["media"],
        "ms_per_frame_1spp_sss": wl["subsurface"],
        "traversal_mrays_per_sec_large_scene": trace_rate(lg_r, orig,
                                                            raydir),
        "midframe_mrays_per_sec_large_scene": midframe_rate(lg_r),
        "ms_per_frame_1spp_large_scene": lg_ms,
        "render_mrays_per_sec_large_scene": lg_rays / (lg_ms / 1e3)
                                               / 1e6,
        "ms_per_frame_1spp_sss_large_scene": org["c6_organic_sss"],
        "ms_per_frame_1spp_media_large_scene": org["c7_organic_media"],
        "frame_breakdown_ms_1024": breakdown,
        "gates": gate_log,
        "vs_baseline_traversal": ax1,
        "vs_baseline_render": ax2,
        "methodology": "median of 5 block_until_ready-synchronised calls "
                       "after a warm-up; headline = weakest baseline axis",
    }
    if ax1 <= ax2:
        head = {"metric": "traversal_mrays_per_sec",
                "value": trav_mrays, "unit": "Mrays/s",
                "vs_baseline": ax1}
    else:
        head = {"metric": "render_mrays_per_sec_1080p",
                "value": render_mrays, "unit": "Mrays/s",
                "vs_baseline": ax2}
    head["device"] = device
    head["extra"] = extra
    print(json.dumps(head))
    return 0


if __name__ == "__main__":
    sys.exit(main())
