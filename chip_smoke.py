#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU (Hopper: the traversal
kernel is compiled for sm_90a), at full size.

    python chip_smoke.py               # all phases on one card
    python chip_smoke.py --four-gpus   # only the sharded 4-card phase

Phases, in order; any failure exits non-zero and no phase is skipped:
  1. the card (nvidia-smi name and power limit) and jax.devices();
  2. build and load the CUDA traversal library (ops/traverse.cu);
  3. kernel gates: the kernel against the brute-force oracle and against
     the plain traversal on the same device, on the demo and the large
     scene (closest hit, anyhit hit/miss, sparse mask, active prefix);
  4. renders: tools/render.py's path on the demo at 1920x1080, regen
     against the classic bounce integrator at 128^2, the media and
     subsurface golden gates, one 1024^2 frame each of the media and
     subsurface variants and of the 135k-triangle large scene;
  5. compiled.memory_analysis() of the 1080p render step;
  6. traversal and 1-spp frame times, kernel against plain.

With --four-gpus it runs only the ShardedRenderer over 4 cards at 1080p,
compared with the 1-card accumulation.

The last line of stdout is one JSON object: {"ok": true, "device":
{"platform", "kind", "count"}}. Without a GPU it exits non-zero before
printing any result. Measurements go on earlier lines and, in full, to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
RESULTS = {}


def log(*a):
    print(*a, flush=True)


def record(key, value):
    RESULTS[key] = value
    log("%s: %s" % (key, json.dumps(value)))


def timed(fn, reps=5):
    """Median wall seconds of fn() after one warm-up call, each call
    synchronised with block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ----------------------------------------------------------------- phase 1
def phase_card():
    import jax
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    record("nvidia_smi", smi)
    record("jax_devices", [str(d) for d in jax.devices()])
    return smi


# ----------------------------------------------------------------- phase 2
def phase_build():
    from tpu_pathtracer.ops import traverse_gpu
    t0 = time.perf_counter()
    path = traverse_gpu.build()
    traverse_gpu.load()
    record("kernel_library", {"path": os.path.relpath(path, ROOT),
                              "build_and_load_s": time.perf_counter() - t0})


# ----------------------------------------------------------------- phase 3
def primary_rays(renderer, width, height):
    import jax.numpy as jnp
    from tpu_pathtracer.core.rng import RaySampler, wang_hash
    from tpu_pathtracer.scene.demo import default_camera
    from tpu_pathtracer.tracer.renderer import generate_camera_rays
    cam = jnp.asarray(default_camera(width, height).build_render_camera()
                      .as_array())
    rng = RaySampler.init(wang_hash(jnp.uint32(1)),
                          jnp.arange(width * height, dtype=jnp.uint32))
    _, o, d = generate_camera_rays(
        cam, rng, jnp.asarray(renderer._lane_px, jnp.float32),
        jnp.asarray(renderer._lane_py, jnp.float32))
    return o, d


def phase_kernel_gates(scenes):
    from tpu_pathtracer.scene import procedural
    from tpu_pathtracer.utils.device_gates import kernel_gates
    (fb, *_), r = scenes["demo"]
    kernel_gates(record, "demo", fb,
                 procedural.make_test_scene().tri_vertices(), 4096, 256,
                 primary_rays(r, 1024, 1024))
    (fb, *_), r = scenes["large"]
    kernel_gates(record, "large", fb,
                 procedural.make_large_scene().tri_vertices(), 1024, 32,
                 primary_rays(r, 1024, 1024))


# ----------------------------------------------------------------- phase 4
def _check_image(name, accum, spp):
    a = np.asarray(accum)
    mean = float(a.mean()) / spp
    record("render_" + name, {"shape": list(a.shape), "mean_radiance": mean,
                              "finite": bool(np.all(np.isfinite(a)))})
    assert np.all(np.isfinite(a)), "%s: non-finite pixels" % name
    assert mean > 1e-3, "%s: black image (mean %.3g)" % name


def phase_renders(scenes):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import render as render_tool
    from tpu_pathtracer.core.image import write_png
    from tpu_pathtracer.scene.demo import (
        default_camera, testobj_scene, large_scene)
    from tpu_pathtracer.tracer.renderer import Renderer
    from tpu_pathtracer.utils.device_gates import (
        golden_gate, load_golden_module, regen_vs_bounce)

    os.makedirs(OUT_DIR, exist_ok=True)
    spp = 4
    args = render_tool.parse_args(
        ["--demo", "default", "--width", "1920", "--height", "1080",
         "--spp", str(spp), "--out", os.path.join(OUT_DIR, "demo_1080p.png")])
    t0 = time.perf_counter()
    r1080, accum = render_tool.render(args)
    _check_image("demo_1080p_%dspp" % spp, accum, spp)
    write_png(args.out, r1080.accum_to_image(accum, spp))
    record("render_demo_1080p_wall_s", time.perf_counter() - t0)

    fb, mats, env, tex = testobj_scene(cache_dir=".bvh_cache")
    regen_vs_bounce(record, fb, mats, env, tex)
    gm = load_golden_module(ROOT)
    cfg = gm._small_configs()
    for name in ("c4_media", "c5_bssrdf"):
        want = np.load(os.path.join(ROOT, "tests", "goldens",
                                    name + ".npz"))["img"]
        golden_gate(record, name, gm._render(name, cfg[name]), want)

    # one 1024^2 frame of each workload variant and of the large scene
    for name, parts in (
            ("media", testobj_scene(cache_dir=".bvh_cache", variant="media")),
            ("subsurface", testobj_scene(cache_dir=".bvh_cache",
                                         variant="subsurface")),
            ("large", large_scene(cache_dir=".bvh_cache"))):
        rr = Renderer(parts[0], parts[1], envmap=parts[2], texture=parts[3],
                      width=1024, height=1024)
        rc = default_camera(1024, 1024).build_render_camera()
        t0 = time.perf_counter()
        acc = rr.render_frames(rr.zeros_accum(), rc, 1, 1)
        _check_image(name + "_1024_1spp", acc, 1)
        record("render_%s_1024_first_frame_s" % name,
               time.perf_counter() - t0)
    return r1080


# ----------------------------------------------------------------- phase 5
def phase_memory(r1080):
    import jax.numpy as jnp
    from tpu_pathtracer.scene.demo import default_camera
    cam = jnp.asarray(default_camera(1920, 1080).build_render_camera()
                      .as_array())
    compiled = r1080._frames_fn.lower(
        r1080.scene, cam, jnp.uint32(1), jnp.uint32(0), r1080.zeros_accum(),
        n_frames=1).compile()
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
            "alias_size_in_bytes")
    record("memory_analysis_1080p_step",
           {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)})


# ----------------------------------------------------------------- phase 6
def phase_timings(scenes):
    import dataclasses
    import jax
    import jax.numpy as jnp
    from tpu_pathtracer.core.vecmath import RAY_MIN, RAY_MAX
    from tpu_pathtracer.ops.traverse_gpu import gpu_intersect
    from tpu_pathtracer.scene.demo import default_camera
    from tpu_pathtracer.tracer.regen import make_regen_integrator
    from tpu_pathtracer.tracer.renderer import Renderer
    from tpu_pathtracer.tracer.traverse import intersect_scene

    (fb, mats, env, tex), r = scenes["demo"]
    packed = r.scene["packed"]
    sd = r.settings.stack_depth
    variants = {
        "kernel": lambda o, d: gpu_intersect(packed, o, d, RAY_MIN, RAY_MAX),
        "plain_untiled": lambda o, d: intersect_scene(
            None, None, 0, o, d, RAY_MIN, RAY_MAX, stack_depth=sd,
            packed=packed, tile_size=None),
        "plain_tiled_131072": lambda o, d: intersect_scene(
            None, None, 0, o, d, RAY_MIN, RAY_MAX, stack_depth=sd,
            packed=packed, tile_size=1 << 17),
    }
    cam = jnp.asarray(default_camera(1024, 1024).build_render_camera()
                      .as_array())
    pool = jax.jit(make_regen_integrator(r.settings, 1024, 1024,
                                         stop_after_waves=3),
                   static_argnames=("n_frames",))(
        r.scene, cam, jnp.uint32(1), jnp.uint32(0), r.zeros_accum(),
        n_frames=4)
    workloads = {"primary_1024": primary_rays(r, 1024, 1024),
                 "midframe_pool_1024": (pool["orig"], pool["dir"])}
    for wname, (o, d) in workloads.items():
        row = {}
        for vname, fn in variants.items():
            f = jax.jit(fn)
            sec = timed(lambda: f(o, d))
            row[vname] = {"ms": sec * 1e3,
                          "mrays_per_s": o.shape[0] / sec / 1e6}
        record("trace_" + wname, row)

    for w, h in ((1024, 1024), (1920, 1080)):
        row = {}
        rc = default_camera(w, h).build_render_camera()
        base = Renderer(fb, mats, envmap=env, texture=tex, width=w,
                        height=h)
        for trav in ("auto", "plain"):
            rr = Renderer(fb, mats, envmap=env, texture=tex, width=w,
                          height=h,
                          base_scene=base.scene,
                          settings=dataclasses.replace(base.settings,
                                                       traversal=trav))
            acc = rr.zeros_accum()
            sec = timed(lambda: rr.render_frames(acc, rc, 1, 1), reps=5)
            row["kernel" if trav == "auto" else "plain"] = {"ms": sec * 1e3}
        record("frame_1spp_%dx%d" % (w, h), row)


# ------------------------------------------------------------- four cards
def phase_four_gpus(w=1920, h=1080, spp=4):
    import jax
    from tpu_pathtracer.parallel.sharding import ShardedRenderer, make_mesh
    from tpu_pathtracer.scene.demo import default_camera, testobj_scene
    from tpu_pathtracer.tracer.renderer import Renderer
    assert len(jax.devices()) >= 4, "need 4 devices, have %d" % len(
        jax.devices())
    fb, mats, env, tex = testobj_scene(cache_dir=".bvh_cache")
    rc = default_camera(w, h).build_render_camera()
    r = Renderer(fb, mats, envmap=env, texture=tex, width=w, height=h)
    one = np.asarray(r.render_frames(r.zeros_accum(), rc, 1, spp))
    sr = ShardedRenderer(r, mesh=make_mesh(jax.devices()[:4]))
    acc = sr.render_frames(sr.zeros_accum(), rc, 1, spp)
    four = np.asarray(acc)[:w * h]
    d = np.abs(four - one) / spp
    mean_ratio = float(four.mean()) / float(one.mean())
    sec = timed(lambda: sr.render_frames(acc, rc, 1, 1), reps=5)
    sec1 = timed(lambda: r.render_frames(r.zeros_accum(), rc, 1, 1), reps=5)
    record("four_gpus_%dx%d" % (w, h), {
        "max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
        "mean_ratio": mean_ratio, "spp": spp,
        "frame_ms_4gpu": sec * 1e3, "frame_ms_1gpu": sec1 * 1e3})
    # Same per-(frame, global pixel) RNG on both sides: every sample is
    # the same path, so only the per-pixel summation order of the image
    # scatter (atomics) and per-device float contraction differ.
    assert np.all(np.isfinite(four))
    assert float(d.mean()) < 1e-5, "4-card vs 1-card mean |diff|"
    assert abs(mean_ratio - 1.0) < 1e-4, "4-card vs 1-card brightness"


# ------------------------------------------------------------------ main
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print("chip_smoke: no GPU (JAX platform %r)" % devs[0].platform,
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from tpu_pathtracer.utils import compcache
    compcache.enable()

    smi = phase_card()
    t_all = time.perf_counter()
    if args.four_gpus:
        phase_build()
        phase_four_gpus()
    else:
        from tpu_pathtracer.scene.demo import testobj_scene, large_scene
        from tpu_pathtracer.tracer.renderer import Renderer
        scenes = {}
        for key, parts in (("demo", testobj_scene(cache_dir=".bvh_cache")),
                           ("large", large_scene(cache_dir=".bvh_cache"))):
            r = Renderer(parts[0], parts[1], envmap=parts[2],
                         texture=parts[3], width=1024, height=1024)
            scenes[key] = (parts, r)
        phase_build()
        phase_kernel_gates(scenes)
        phase_memory(phase_renders(scenes))
        phase_timings(scenes)
    record("wall_s", time.perf_counter() - t_all)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke%s.json" % (
            "_four_gpus" if args.four_gpus else "")), "w") as f:
        json.dump(RESULTS, f, indent=1)
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
