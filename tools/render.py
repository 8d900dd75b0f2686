#!/usr/bin/env python
"""Headless progressive renderer CLI.

The analog of the reference app driver (src/main.cpp): loads a scene (JSON
desc or built-in demo), renders progressively, prints a once-per-second stats
line (src/main.cpp:204-209), writes periodic snapshots (the 5 s / 50 s PPM
dumps, src/main.cpp:211-232), and checkpoints the accumulation buffer so long
renders resume across processes (upgrade over the reference's in-session-only
accumulation, SURVEY.md §5).

Examples:
  python tools/render.py --demo default --spp 64 --size 512 --out out.png
  python tools/render.py --scene data/sceneDesc.json --spp 256 --out img.png
  python tools/render.py --demo media --resume ckpt.npz --spp 1024
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpu_pathtracer.core.image import write_png, write_ppm  # noqa: E402
from tpu_pathtracer.utils.timing import RateMeter  # noqa: E402


def save_checkpoint(path, accum, frame, meta):
    np.savez_compressed(path, accum=np.asarray(accum), frame=frame, **meta)


def load_checkpoint(path):
    z = np.load(path)
    return z["accum"], int(z["frame"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", help="sceneDesc.json path")
    ap.add_argument("--demo", help="built-in demo variant: default, large, "
                    "lambertian, gold, subsurface, media, head, "
                    "organic_sss, organic_media")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--snapshot-every", type=float, default=0.0,
                    help="write <out>.snap.png every N seconds")
    ap.add_argument("--checkpoint", help="checkpoint file (npz)")
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    help="checkpoint every N frames")
    ap.add_argument("--resume", help="resume from checkpoint file")
    ap.add_argument("--cache-dir", default=".bvh_cache")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="persistent XLA compile cache ('' disables); "
                         "default: $JAX_COMPILATION_CACHE_DIR, else "
                         ".jax_cache at the checkout root")
    ap.add_argument("--multichip", action="store_true",
                    help="shard lanes over all available devices")
    ap.add_argument("--camera", help=".cam binary file to load")
    return ap.parse_args(argv)


def build_renderer(args):
    """(renderer, render_camera, width, height) for the parsed args."""
    W = args.width or args.size
    H = args.height or args.size

    if args.scene:
        from tpu_pathtracer.scene.config import load_scene_desc
        from tpu_pathtracer.tracer.renderer import renderer_from_scene_desc
        desc = load_scene_desc(args.scene)
        desc.width, desc.height = W, H
        base_dir = os.path.dirname(args.scene)
        renderer = renderer_from_scene_desc(desc, base_dir=base_dir,
                                            cache_dir=args.cache_dir)
        cam_file = desc.camFile
    else:
        from tpu_pathtracer.scene.demo import testobj_scene, head_scene
        from tpu_pathtracer.tracer.renderer import Renderer
        if args.demo == "head":
            fb, mats, envmap, texture = head_scene(cache_dir=args.cache_dir)
        elif args.demo == "large":
            from tpu_pathtracer.scene.demo import large_scene
            fb, mats, envmap, texture = large_scene(cache_dir=args.cache_dir)
        elif args.demo in ("organic_sss", "organic_media"):
            from tpu_pathtracer.scene.demo import large_organic_scene
            fb, mats, envmap, texture = large_organic_scene(
                cache_dir=args.cache_dir, variant=args.demo.split("_")[1])
        else:
            fb, mats, envmap, texture = testobj_scene(
                cache_dir=args.cache_dir, variant=args.demo or "default")
        renderer = Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=W, height=H)
        cam_file = None

    from tpu_pathtracer.scene.demo import default_camera
    from tpu_pathtracer.scene.camera import InteractiveCamera
    if args.camera or cam_file:
        icam = InteractiveCamera.load_cam(args.camera or cam_file)
        icam.set_resolution(W, H)
    else:
        icam = default_camera(W, H)
    rc = icam.build_render_camera()

    if args.multichip:
        from tpu_pathtracer.parallel.sharding import ShardedRenderer
        renderer = ShardedRenderer(renderer)
    return renderer, rc, W, H


def render(args):
    """Render progressively per the parsed args; returns (renderer,
    accum). Writes snapshots and checkpoints as asked, not the final
    image."""
    renderer, rc, W, H = build_renderer(args)
    accum = renderer.zeros_accum()
    start_frame = 0
    if args.resume and os.path.exists(args.resume):
        a, start_frame = load_checkpoint(args.resume)
        import jax.numpy as jnp
        accum = jnp.asarray(a)
        print("resumed at frame %d from %s" % (start_frame, args.resume))

    meter = RateMeter()
    last_snap = time.time()
    # several progressive samples per device dispatch
    batch = max(1, min(32, args.spp // 8))
    frame = start_frame + 1
    while frame <= args.spp:
        n = min(batch, args.spp - frame + 1)
        accum = renderer.render_frames(accum, rc, frame, n)
        frame += n
        meter.tick(W * H * n)
        done = frame - 1  # frames completed
        if args.snapshot_every and time.time() - last_snap > args.snapshot_every:
            write_png(args.out + ".snap.png",
                      renderer.accum_to_image(accum, done))
            last_snap = time.time()
        ck = args.checkpoint or args.resume
        if ck and done % args.checkpoint_every < batch:
            save_checkpoint(ck, accum, done, {"width": W, "height": H})
    return renderer, accum


def main(argv=None):
    args = parse_args(argv)
    from tpu_pathtracer.utils import compcache
    compcache.enable(args.compile_cache_dir)

    t_wall0 = time.time()
    renderer, accum = render(args)
    if args.out.endswith(".ppm"):
        write_ppm(args.out, renderer.accum_to_buffer(accum), args.spp)
    else:
        write_png(args.out, renderer.accum_to_image(accum, args.spp))
    wall_s = time.time() - t_wall0
    print("wrote %s (%d spp), wall %.1f s" % (args.out, args.spp, wall_s))
    ck = args.checkpoint or args.resume
    if ck:
        save_checkpoint(ck, accum, args.spp,
                        {"width": args.width or args.size,
                         "height": args.height or args.size})

if __name__ == "__main__":
    main()
