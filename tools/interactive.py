#!/usr/bin/env python
"""Interactive progressive viewer in the terminal.

Replaces the reference's GLUT window + mouse/keyboard handlers
(src/main.cpp:717-760, src/MouseKeyboardInput.h) with an ANSI truecolor
half-block display and termios raw input, keeping the same bindings:

  w/a/s/d  move camera (goForward/strafe)     r/f  altitude up/down
  arrows   yaw / pitch                        [ ]  orbit radius
  g/h      aperture -/+                       t/y  focal distance +/-
  n/m      rotate envmap (also: shift-drag)
  space    reset accumulation (buffer_reset)  ,/.  save / load camera (.cam)
  q / ESC  save output500.ppm and exit

Mouse (xterm SGR 1006 reporting, enabled while the viewer runs — the
same gestures as the reference's GLUT handlers,
src/MouseKeyboardInput.h:67-111):

  left-drag    orbit (yaw / pitch)
  right-drag   orbit radius (zoom)
  shift-drag   rotate the environment map
  wheel        orbit radius

Any camera change resets the accumulation buffer, exactly like the
reference's buffer_reset flag. Snapshots are written at 5 s and 50 s
(output5.ppm / output50.ppm, parity with src/main.cpp:211-232), plus a
once-per-second stats line (src/main.cpp:204-209).
"""
from __future__ import annotations

import os
import select
import sys
import termios
import time
import tty

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def half_block_frame(img):
    """img: uint8 [H,W,3] with H even -> ANSI string, 2 pixels per cell."""
    H, W, _ = img.shape
    rows = []
    for y in range(0, H - 1, 2):
        cells = []
        for x in range(W):
            t = img[y, x]
            b = img[y + 1, x]
            cells.append("\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm▀"
                         % (t[0], t[1], t[2], b[0], b[1], b[2]))
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def decode_sgr_mouse(params, final):
    """Decode one xterm SGR-1006 mouse report \\x1b[<b;x;y(M|m).

    Returns ("MOUSE", kind, button, shift, x, y) where kind is "press",
    "drag", "release" or "wheel"; button is 0 left / 1 middle / 2 right
    (wheel: +1 up / -1 down). None on a malformed report."""
    try:
        b, x, y = (int(p) for p in params.split(";"))
    except ValueError:
        return None
    shift = bool(b & 4)
    if b & 64:                       # wheel: 64 = up, 65 = down
        return ("MOUSE", "wheel", 1 if (b & 3) == 0 else -1, shift, x, y)
    kind = ("release" if final == "m"
            else "drag" if b & 32 else "press")
    return ("MOUSE", kind, b & 3, shift, x, y)


class RawInput:
    # 1002 = button-event (drag) tracking; 1006 = SGR extended coords
    _MOUSE_ON = "\x1b[?1002h\x1b[?1006h"
    _MOUSE_OFF = "\x1b[?1002l\x1b[?1006l"

    def __enter__(self):
        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        sys.stdout.write(self._MOUSE_ON)
        sys.stdout.flush()
        return self

    def __exit__(self, *a):
        sys.stdout.write(self._MOUSE_OFF)
        sys.stdout.flush()
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def poll(self):
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch != "\x1b":
                keys.append(ch)
                continue
            if not select.select([sys.stdin], [], [], 0.01)[0]:
                keys.append("ESC")
                continue
            c1 = sys.stdin.read(1)
            if c1 != "[":
                keys.append("ESC")
                continue
            c2 = sys.stdin.read(1)
            if c2 in "ABCD":
                keys.append({"A": "UP", "B": "DOWN", "C": "RIGHT",
                             "D": "LEFT"}[c2])
            elif c2 == "<":
                params = ""
                while True:
                    c = sys.stdin.read(1)
                    if c in "Mm" or not c:
                        break
                    params += c
                ev = decode_sgr_mouse(params, c)
                if ev is not None:
                    keys.append(ev)
            else:
                keys.append("ESC")
        return keys


class MouseOrbit:
    """Drag state machine mapping SGR mouse events onto the interactive
    camera — the reference's motion/mouse handlers
    (src/MouseKeyboardInput.h:67-111) with the same gesture map."""

    YAW_PER_CELL = 0.01     # rad per terminal cell (2 image px vertically)
    PITCH_PER_CELL = 0.02
    RADIUS_PER_CELL = 0.05
    ENV_PER_CELL = 0.002    # envmap rotation is in [0,1) turns

    def __init__(self):
        self.last = None     # (x, y) of the previous press/drag report

    def apply(self, ev, icam):
        """Returns True if the camera changed (=> reset accumulation)."""
        _, kind, button, shift, x, y = ev
        if kind == "wheel":
            icam.change_radius(-button * self.RADIUS_PER_CELL * 3.0)
            return True
        if kind == "press":
            self.last = (x, y)
            return False
        if kind == "release":
            self.last = None
            return False
        # drag
        if self.last is None:
            self.last = (x, y)
            return False
        dx, dy = x - self.last[0], y - self.last[1]
        self.last = (x, y)
        if dx == 0 and dy == 0:
            return False
        if shift:
            icam.env_map_rotation = (
                icam.env_map_rotation + dx * self.ENV_PER_CELL) % 1.0
        elif button == 2:
            icam.change_radius(dy * self.RADIUS_PER_CELL)
        else:
            icam.change_yaw(-dx * self.YAW_PER_CELL)
            icam.change_pitch(-dy * self.PITCH_PER_CELL)
        return True


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", default="default")
    ap.add_argument("--scene")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--cam", default="viewer.cam")
    ap.add_argument("--cache-dir", default=".bvh_cache")
    ap.add_argument("--batch", type=int, default=4,
                    help="samples per device dispatch")
    ap.add_argument("--preview-div", type=int, default=2,
                    help="moving-camera preview downscale (2 = half-res, "
                         "4 = quarter-res)")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="persistent XLA compile cache ('' disables); "
                         "default: $JAX_COMPILATION_CACHE_DIR, else "
                         ".jax_cache at the checkout root")
    args = ap.parse_args()

    from tpu_pathtracer.utils import compcache
    compcache.enable(args.compile_cache_dir)

    from tpu_pathtracer.scene.demo import testobj_scene, default_camera
    from tpu_pathtracer.scene.camera import InteractiveCamera
    from tpu_pathtracer.tracer.renderer import Renderer
    from tpu_pathtracer.core.image import write_ppm

    W = H = args.size
    settings = None
    if args.scene:
        from tpu_pathtracer.scene.config import load_scene_desc
        from tpu_pathtracer.tracer.renderer import scene_parts_from_desc
        desc = load_scene_desc(args.scene)
        fb, mats, envmap, texture, settings = scene_parts_from_desc(
            desc, base_dir=os.path.dirname(args.scene),
            cache_dir=args.cache_dir)
    else:
        fb, mats, envmap, texture = testobj_scene(cache_dir=args.cache_dir,
                                                  variant=args.demo)
    renderer = Renderer(fb, mats, envmap=envmap, texture=texture,
                        width=W, height=H, settings=settings)
    icam = default_camera(W, H)
    if os.path.exists(args.cam):
        icam = InteractiveCamera.load_cam(args.cam)
        icam.set_resolution(W, H)

    # downscaled preview renderer: while the camera is moving we trade
    # resolution for latency (the reference keeps full res and simply
    # drops to low accumulation; a reduced-res preview keeps the moving
    # camera responsive when a full-res frame is slow — the frame cost
    # scales with pixels, so half-res costs about a quarter).
    # Shares the full renderer's device scene arrays (base_scene) — only
    # the lane tables differ. Enabled only when the upscale is exact,
    # else moving frames simply render at full res.
    renderer_lo = None
    div = max(1, args.preview_div)
    if div > 1 and W % div == 0 and H % div == 0 and W >= 32 * div \
            and H >= 32 * div:
        Wl, Hl = W // div, H // div
        renderer_lo = Renderer(fb, mats, envmap=envmap, texture=texture,
                               width=Wl, height=Hl, settings=settings,
                               base_scene=renderer.scene)

    accum = renderer.zeros_accum()
    frame = 0
    t_start = time.time()
    wrote5 = wrote50 = False
    last_stats = 0.0
    last_move = -1.0

    # key bindings per src/MouseKeyboardInput.h:26-64
    def apply(k):
        scale = 0.1
        if k == "w":
            icam.go_forward(scale)
        elif k == "s":
            icam.go_forward(-scale)
        elif k == "a":
            icam.strafe(-scale)
        elif k == "d":
            icam.strafe(scale)
        elif k == "r":
            icam.change_altitude(scale)
        elif k == "f":
            icam.change_altitude(-scale)
        elif k == "g":
            icam.change_aperture_diameter(-scale)
        elif k == "h":
            icam.change_aperture_diameter(scale)
        elif k == "t":
            icam.change_focal_distance(scale)
        elif k == "y":
            icam.change_focal_distance(-scale)
        elif k == "LEFT":
            icam.change_yaw(0.02)
        elif k == "RIGHT":
            icam.change_yaw(-0.02)
        elif k == "UP":
            icam.change_pitch(0.02)
        elif k == "DOWN":
            icam.change_pitch(-0.02)
        elif k == "[":
            icam.change_radius(-scale)
        elif k == "]":
            icam.change_radius(scale)
        elif k == "n":
            # envmap rotation (also on shift-drag, as in the reference —
            # src/MouseKeyboardInput.h:88-92)
            icam.env_map_rotation = (icam.env_map_rotation + 0.01) % 1.0
        elif k == "m":
            icam.env_map_rotation = (icam.env_map_rotation - 0.01) % 1.0
        elif k == ",":
            icam.save_cam(args.cam)
            return False
        elif k == ".":
            if os.path.exists(args.cam):
                nonlocal_icam = InteractiveCamera.load_cam(args.cam)
                icam.__dict__.update(nonlocal_icam.__dict__)
        elif k == " ":
            return True
        else:
            return False
        return True  # camera changed -> reset accumulation

    sys.stdout.write("\x1b[2J")  # clear
    mouse = MouseOrbit()
    with RawInput() as inp:
        while True:
            reset = False
            quit_ = False
            for k in inp.poll():
                if isinstance(k, tuple) and k[0] == "MOUSE":
                    reset = mouse.apply(k, icam) or reset
                elif k in ("q", "ESC"):
                    quit_ = True
                else:
                    reset = apply(k) or reset
            if quit_:
                break
            now = time.time()
            if reset:
                accum = renderer.zeros_accum()
                frame = 0
                last_move = now
            moving = (now - last_move) < 0.25 and renderer_lo is not None
            if moving:
                # half-res single-sample preview while the camera moves
                icam.set_resolution(Wl, Hl)
                rc = icam.build_render_camera()
                icam.set_resolution(W, H)
                acc_lo = renderer_lo.render_frames(
                    renderer_lo.zeros_accum(), rc, 1, 1)
                img = renderer_lo.accum_to_image(acc_lo, 1)
                img = img.repeat(H // Hl, axis=0).repeat(W // Wl, axis=1)
            else:
                rc = icam.build_render_camera()
                accum = renderer.render_frames(accum, rc, frame + 1,
                                               args.batch)
                frame += args.batch
                img = renderer.accum_to_image(accum, frame)
            sys.stdout.write("\x1b[H" + half_block_frame(img))
            el = time.time() - t_start
            if el - last_stats >= 1.0:
                sys.stdout.write(
                    "\n\x1b[0mtime %.1fs  frames %d  %.1f spp/s   "
                    "[wasd/rf move, arrows look, g/h t/y lens, space reset, "
                    "q quit]" % (el, frame, frame / el))
                last_stats = el
            sys.stdout.flush()
            if el > 5 and not wrote5:
                write_ppm("output5.ppm", renderer.accum_to_buffer(accum), frame)
                wrote5 = True
            if el > 50 and not wrote50:
                write_ppm("output50.ppm", renderer.accum_to_buffer(accum), frame)
                wrote50 = True

    write_ppm("output500.ppm", renderer.accum_to_buffer(accum), max(frame, 1))
    print("\nsaved output500.ppm (%d spp)" % frame)


if __name__ == "__main__":
    main()
