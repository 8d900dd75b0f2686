#!/usr/bin/env python
"""Device-side profile of one 1-spp regen frame on the GPU.

Renders one warm-up frame, then one frame under jax.profiler, and prints
the device window, busy time, idle share, time by category
(utils/profiling.py) and the kernels that took the most device time.

  python tools/profile_frame.py --wh 1024
  python tools/profile_frame.py --w 1920 --h 1080 --demo media
  python tools/profile_frame.py --set regen_order='"inplace"'

The trace stays in --logdir for a closer look (Perfetto or
jax.profiler.ProfileData).
"""
import argparse
import ast
import collections
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wh", type=int, default=1024)
    ap.add_argument("--w", type=int, default=0, help="width (0 = --wh)")
    ap.add_argument("--h", type=int, default=0, help="height (0 = --wh)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--demo", default="default")
    ap.add_argument("--logdir", default=os.path.join(
        os.path.dirname(__file__), "..", "chiprun_out", "profile_frame"))
    ap.add_argument("--set", default="",
                    help="comma-separated RenderSettings field=value "
                         "overrides (Python literals)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tpu_pathtracer.scene.demo import testobj_scene, default_camera
    from tpu_pathtracer.tracer.renderer import Renderer
    from tpu_pathtracer.tracer.regen import make_regen_integrator
    from tpu_pathtracer.utils import compcache, profiling
    compcache.enable()

    fb, mats, envmap, texture = testobj_scene(cache_dir=".bvh_cache",
                                              variant=args.demo)
    W = args.w or args.wh
    H = args.h or args.wh
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W, height=H)
    st = r.settings
    if args.set:
        ov = {}
        for pair in args.set.split(","):
            k, v = pair.split("=", 1)
            ov[k] = ast.literal_eval(v)
        st = dataclasses.replace(st, **ov)
    cv = jnp.asarray(default_camera(W, H).build_render_camera().as_array())
    fn = jax.jit(make_regen_integrator(st, W, H),
                 static_argnames=("n_frames",))
    accum = r.zeros_accum()

    summary = profiling.profile_frames(
        lambda: fn(r.scene, cv, jnp.uint32(1), jnp.uint32(0), accum,
                   n_frames=1), args.logdir)
    print(json.dumps({"device": jax.devices()[0].device_kind,
                      "width": W, "height": H, **summary}, indent=1))
    events = profiling.device_events(profiling.load_trace(args.logdir))
    dur, cnt = collections.Counter(), collections.Counter()
    for e in events:
        dur[e["name"]] += e.get("dur", 0.0) / 1e3
        cnt[e["name"]] += 1
    for name, ms in dur.most_common(args.top):
        print("%9.3f ms  x%-5d %-13s %s" % (
            ms, cnt[name], profiling.category({"name": name}), name[:90]))


if __name__ == "__main__":
    main()
