#!/usr/bin/env python
"""1920x1080 default-scene showcase through the FULL asset pipeline at
real asset scale: a 2048x1024 (2M-texel) HDR sky written + re-read through
the first-party RGBE codec, alias-built natively, then progressively
rendered on the GPU (the reference's native resolution and its pisa.hdr
flow, /root/reference/src/main.cpp:372-406 + renderkernel.cu:1043-1046).

Usage: python tools/showcase_1080p.py [--spp 256] [--out renders/showcase_1080p.png]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--out", default="renders/showcase_1080p.png")
    ap.add_argument("--env-size", type=int, default=2048)
    ap.add_argument("--cache-dir", default=".bvh_cache")
    args = ap.parse_args()

    from tpu_pathtracer.scene import procedural
    from tpu_pathtracer.scene.demo import testobj_scene, default_camera
    from tpu_pathtracer.scene.hdr import write_hdr, read_hdr
    from tpu_pathtracer.tracer.renderer import Renderer
    from PIL import Image

    W, H = 1920, 1080
    fb, mats, _, texture = testobj_scene(cache_dir=args.cache_dir)

    # asset-scale env through the real IO path
    t0 = time.perf_counter()
    env = procedural.make_sky_envmap(args.env_size, args.env_size // 2)
    tmp = os.path.join(args.cache_dir, "showcase_sky.hdr")
    write_hdr(tmp, env)
    env = read_hdr(tmp)
    t_io = time.perf_counter() - t0

    t0 = time.perf_counter()
    r = Renderer(fb, mats, envmap=env, texture=texture, width=W, height=H)
    t_build = time.perf_counter() - t0   # includes the 2M-texel alias build

    rc = default_camera(W, H).build_render_camera()
    accum = r.zeros_accum()
    t0 = time.perf_counter()
    accum = r.render_frames(accum, rc, 1, 1)
    np.asarray(accum)
    t_first = time.perf_counter() - t0   # compile + frame 1
    t0 = time.perf_counter()
    done = 1
    while done < args.spp:
        step = min(32, args.spp - done)
        accum = r.render_frames(accum, rc, done + 1, step)
        done += step
    img = r.accum_to_image(accum, done)
    t_rest = time.perf_counter() - t0
    Image.fromarray(img, "RGB").save(args.out)
    print("env io %.2fs | renderer build (incl 2M-texel alias) %.2fs | "
          "first frame (compile) %.1fs | %d more spp %.1fs (%.0f ms/frame)"
          % (t_io, t_build, t_first, done - 1, t_rest,
             t_rest * 1e3 / max(done - 1, 1)))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
