"""Progressive renderer: camera ray generation + frame accumulation.

The analog of the reference frame path pathTracingKernel + disp()
(src/renderkernel.cu:862-981, src/main.cpp:154-247): each call renders one
sample per pixel (NUM_SAMPLE=1) and adds it into a persistent accumulation
buffer; display divides by frame count and gamma-encodes. Scene data crosses
to the device once at construction; per frame only the packed camera vector
and the frame index cross the boundary.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..core.rng import RaySampler, wang_hash
from ..core.vecmath import TWO_PI, PI, normalize
from ..scene.config import (
    SceneDesc, materials_to_arrays, MAT_SUBSURFACE,
)
from ..scene.camera import RenderCamera
from .wavefront import RenderSettings, make_integrator


import functools


@functools.lru_cache(maxsize=2)
def _bssrdf_table_cached(g=0.0, eta=1.4):
    from ..bssrdf.tabulate import compute_beam_diffusion_table
    return compute_beam_diffusion_table(g=g, eta=eta)


def lane_pixel_xy(pixel_index, width, height, block=32):
    """Closed-form inverse of the 32x32 block swizzle (Renderer.__init__):
    pixel lane index -> (px, py) int32, matching the _lane_px/_lane_py
    tables bit for bit for ANY width/height (partial edge blocks included).

    Pure integer arithmetic, no gather: the regen respawn needs (px, py)
    per fresh lane every wave, and a handful of elementwise int ops is
    cheaper than a pool-wide table gather.

    Layout recap: lanes walk 32x32 pixel blocks row-major; blocks at the
    right/bottom image edge are clipped to the image and their lanes are
    compacted (local row-major within the clipped block)."""
    b = int(block)
    W, H = int(width), int(height)
    i = pixel_index.astype(jnp.int32)
    full_rows = H // b
    rem_h = H - full_rows * b
    full_cols = W // b
    rem_w = W - full_cols * b
    row_lanes = W * b                     # lanes per full-height block row
    blk_row = i // row_lanes              # == full_rows for the partial row
    l2 = i - blk_row * row_lanes
    bh_cur = jnp.where(blk_row < full_rows, b, max(rem_h, 1))
    blk_lanes = b * bh_cur                # lanes per full-width block here
    col_blk = l2 // blk_lanes             # == full_cols for the partial col
    l3 = l2 - col_blk * blk_lanes
    bw_cur = jnp.where(col_blk < full_cols, b, max(rem_w, 1))
    px = col_blk * b + l3 % bw_cur
    py = blk_row * b + l3 // bw_cur
    return (jnp.clip(px, 0, W - 1).astype(jnp.int32),
            jnp.clip(py, 0, H - 1).astype(jnp.int32))


def generate_camera_rays(cam_vec, rng, pixel_x, pixel_y):
    """Primary ray generation: AA jitter + thin-lens DOF, exactly the
    pathTracingKernel sequence (src/renderkernel.cu:895-954).

    cam_vec: flat [16] f32 (see RenderCamera.as_array).
    pixel_x, pixel_y: [N] pixel coordinates (pixel_y bottom-up like the
    reference's `scrheight - y - 1`).
    Returns (rng, orig [N,3], dir [N,3]).
    """
    res_x, res_y = cam_vec[0], cam_vec[1]
    cam_pos = cam_vec[2:5]
    cam_view = cam_vec[5:8]
    cam_up = cam_vec[8:11]
    fov_x, fov_y = cam_vec[11], cam_vec[12]
    aperture = cam_vec[13]
    focal = cam_vec[14]

    view = cam_view / jnp.linalg.norm(cam_view)
    up = cam_up / jnp.linalg.norm(cam_up)
    horiz_axis = jnp.cross(view, up)
    horiz_axis = horiz_axis / jnp.linalg.norm(horiz_axis)
    vert_axis = jnp.cross(horiz_axis, view)
    vert_axis = vert_axis / jnp.linalg.norm(vert_axis)

    middle = cam_pos + view
    horizontal = horiz_axis * jnp.tan(fov_x * 0.5 * (PI / 180.0))
    vertical = vert_axis * jnp.tan(-fov_y * 0.5 * (PI / 180.0))

    rng, (jx, jy, r1, r2) = RaySampler.next_n(rng, 4)
    sx = (jx - 0.5 + pixel_x) / (res_x - 1.0)
    sy = (jy - 0.5 + pixel_y) / (res_y - 1.0)

    point_on_plane = middle[None, :] \
        + (2.0 * sx - 1.0)[:, None] * horizontal[None, :] \
        + (2.0 * sy - 1.0)[:, None] * vertical[None, :]
    point_on_image = cam_pos[None, :] + (point_on_plane - cam_pos[None, :]) * focal

    angle = TWO_PI * r1
    dist = aperture * jnp.sqrt(r2)
    ap_x = jnp.cos(angle) * dist
    ap_y = jnp.sin(angle) * dist
    aperture_point = cam_pos[None, :] + horiz_axis[None, :] * ap_x[:, None] \
        + vert_axis[None, :] * ap_y[:, None]
    aperture_point = jnp.where(aperture > 1e-5, aperture_point,
                               jnp.broadcast_to(cam_pos, aperture_point.shape))

    raydir = normalize(point_on_image - aperture_point)
    return rng, aperture_point, raydir


class Renderer:
    """Holds device-resident scene arrays and the jitted frame function.

    Usage:
        r = Renderer(flat_bvh, materials, envmap=..., texture=..., width=W,
                     height=H)
        accum = r.zeros_accum()
        for frame in range(1, spp + 1):
            accum = r.render_frame(accum, camera, frame)
        img = tonemap(np.asarray(accum).reshape(H, W, 3), spp)
    """

    def __init__(self, flat_bvh, materials, envmap=None, texture=None,
                 width=512, height=512, settings: RenderSettings = None,
                 lane_chunk=None, env_const=(0.0, 0.0, 0.0),
                 base_scene=None):
        """base_scene: share the resolution-independent device arrays
        (BVH stream, material/attribute tables, envmap quad + alias
        distribution, textures) of an existing Renderer.scene instead of
        re-uploading them — for secondary renderers at other resolutions
        (e.g. the interactive preview). The caller must pass the same
        flat_bvh/materials/envmap/texture the base was built with."""
        self.width = int(width)
        self.height = int(height)
        mat_arrays = materials_to_arrays(materials)
        has_bssrdf = bool(np.any(mat_arrays["refltype"] == MAT_SUBSURFACE))
        has_media = bool(np.any(mat_arrays["has_medium"] != 0))
        if settings is None:
            settings = RenderSettings(
                use_envmap=envmap is not None,
                use_texture=texture is not None,
                has_media=has_media,
                has_bssrdf=has_bssrdf,
            )
        # stack depth only needs the tree's actual depth
        settings = dataclasses.replace(
            settings, stack_depth=min(settings.stack_depth,
                                      int(flat_bvh.max_depth) + 2))
        self.settings = settings

        if base_scene is not None:
            scene = {k: v for k, v in base_scene.items()
                     if not k.startswith("lane_")}
        else:
            from .traverse import pack_stream
            from .wavefront import pack_tri_attributes, pack_mat_table
            scene = {
                "prims": jnp.asarray(flat_bvh.prims),
                "packed": jnp.asarray(pack_stream(flat_bvh.prims, flat_bvh.meta)),
                "num_nodes": flat_bvh.num_nodes,
                "tri_attr": jnp.asarray(pack_tri_attributes(
                    flat_bvh.tri_pos, flat_bvh.tri_uv, flat_bvh.tri_nrm,
                    flat_bvh.tri_mat, prims=flat_bvh.prims,
                    num_nodes=flat_bvh.num_nodes)),
                "tri_mat": jnp.asarray(flat_bvh.tri_mat),
                "mat_table": jnp.asarray(pack_mat_table(mat_arrays)),
                "env_const": jnp.asarray(env_const, jnp.float32),
            }
            if settings.has_bssrdf:
                # PBD table (g=0, eta=1.4, 100x64), matching initBssrdfTable
                # (src/main.cpp:408-415); used by the tabulated sampling path
                # and available to the SoE path's tests
                from ..bssrdf.tabulate import compute_beam_diffusion_table
                tbl = _bssrdf_table_cached()
                scene["bssrdf_rho"] = jnp.asarray(tbl.rho, jnp.float32)
                scene["bssrdf_radius"] = jnp.asarray(tbl.radius, jnp.float32)
                scene["bssrdf_profile"] = jnp.asarray(tbl.profile, jnp.float32)
                scene["bssrdf_cdf"] = jnp.asarray(tbl.profile_cdf, jnp.float32)
                scene["bssrdf_rho_eff"] = jnp.asarray(tbl.rho_eff, jnp.float32)

            from ..scene.texture import make_quad_texture
            if envmap is not None:
                env = np.asarray(envmap, np.float32)
                equad = make_quad_texture(env, wrap_u=False, wrap_v=False)
                scene["env_h"], scene["env_w"] = env.shape[0], env.shape[1]
                if settings.env_importance_sampling:
                    from .envsample import build_env_distribution
                    dist = build_env_distribution(
                        env, topk=settings.env_nee_topk)
                    for k, v in dist.items():
                        scene[k] = jnp.asarray(v)
                    # fold the sampler pdf into the quad rows (cols 12:16, same
                    # clamped-neighbor layout) so the miss-path fetch returns
                    # radiance AND pdf from one gather (texture.py
                    # sample_envmap_quad_pdf) — no separate env_pdf_of_dir pass
                    p = dist["env_pdf_uv"].astype(np.float32)
                    pxn = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
                    pyn = np.concatenate([p[1:], p[-1:]], axis=0)
                    pyxn = np.concatenate([pxn[1:], pxn[-1:]], axis=0)
                    pq = np.stack([p, pxn, pyn, pyxn], axis=-1).reshape(-1, 4)
                    equad = np.concatenate([equad, pq], axis=1)
                scene["envmap_quad"] = jnp.asarray(equad)
            if texture is not None:
                tex = np.asarray(texture, np.float32)
                tquad = make_quad_texture(tex, wrap_u=True, wrap_v=True)
                scene["texture_quad"] = jnp.asarray(tquad)
                scene["tex_h"], scene["tex_w"] = tex.shape[0], tex.shape[1]
                if (envmap is not None and settings.env_importance_sampling
                        and settings.use_texture):
                    # merged env+texture gather target: one per-wave gather
                    # replaces two (wavefront.pack_envtex_quad)
                    from .wavefront import pack_envtex_quad
                    scene["envtex_quad"] = jnp.asarray(
                        pack_envtex_quad(equad, tquad))
        self.scene = scene

        n_pixels = self.width * self.height
        # default: the whole image in one chunk — one device dispatch per
        # call; chunking only pays for images too large for memory
        # (> ~8M pixels)
        self.lane_chunk = int(lane_chunk or min(n_pixels, 1 << 23))
        self._integrate = make_integrator(settings)
        self._frame_fn = jax.jit(self._render_chunk)
        self._frames_fn = jax.jit(self._render_frames_chunk,
                                  static_argnames=("n_frames",))

        # Lane -> pixel swizzle: lanes are laid out in 32x32 pixel blocks
        # instead of row-major strips, so neighbouring lanes (one warp,
        # one thread block) trace neighbouring rays through the same BVH
        # nodes.
        bs = 32
        W, H = self.width, self.height
        bw = -(-W // bs)
        lanes = np.arange(bw * -(-H // bs) * bs * bs, dtype=np.int64)
        blk = lanes // (bs * bs)
        within = lanes % (bs * bs)
        px = (blk % bw) * bs + within % bs
        py = (blk // bw) * bs + within // bs
        valid = (px < W) & (py < H)
        px = px[valid][:n_pixels]
        py = py[valid][:n_pixels]
        self._lane_px = px.astype(np.int32)
        self._lane_py = py.astype(np.int32)
        # pad so per-chunk dynamic slices stay in bounds (chunk multiple,
        # plus headroom for ShardedRenderer's device-rounded lane count)
        n_pad = (-(-n_pixels // self.lane_chunk) * self.lane_chunk
                 - n_pixels + 8192)
        self.scene["lane_px"] = jnp.asarray(np.pad(self._lane_px, (0, n_pad)))
        self.scene["lane_py"] = jnp.asarray(np.pad(self._lane_py, (0, n_pad)))
        # (the regen respawn derives (px, py) arithmetically via
        # lane_pixel_xy — no table gather)

    # ------------------------------------------------------------------
    def _render_chunk(self, scene, cam_vec, frame_hash, lane0, accum_chunk,
                      integrate=None):
        """Render 1 spp for lanes [lane0, lane0 + chunk) and accumulate."""
        integrate = integrate if integrate is not None else self._integrate
        n = accum_chunk.shape[0]
        lane_ids = lane0 + jnp.arange(n, dtype=jnp.uint32)
        rng = RaySampler.init(frame_hash, lane_ids)
        # block-swizzled lane -> pixel mapping (see __init__). pixel_y 0 is
        # the TOP of the image: the reference's `vertical` is negated
        # (src/renderkernel.cu:906) and its buffer row holds pixely = row
        # (i = (h-y-1)*w + x with pixely = h-y-1, :887-889).
        sl = jax.lax.dynamic_slice(scene["lane_px"], (lane0.astype(jnp.int32),), (n,))
        pixel_x = sl.astype(jnp.float32)
        sl = jax.lax.dynamic_slice(scene["lane_py"], (lane0.astype(jnp.int32),), (n,))
        pixel_y = sl.astype(jnp.float32)
        rng, orig, raydir = generate_camera_rays(cam_vec, rng, pixel_x, pixel_y)
        rng, radiance = integrate(scene, rng, orig, raydir, cam_vec[15])
        return accum_chunk + radiance

    def _render_frames_chunk(self, scene, cam_vec, frame0, lane0,
                             accum_chunk, *, n_frames):
        """Accumulate n_frames progressive samples in ONE device program
        (amortizes dispatch latency across samples)."""
        if self.settings.integrator == "regen":
            from .regen import make_regen_integrator
            fn = make_regen_integrator(self.settings, self.width, self.height)
            acc, _waves = fn(scene, cam_vec, frame0, lane0, accum_chunk,
                             n_frames)
            return acc
        from ..core.rng import wang_hash

        def body(i, acc):
            fh = wang_hash(frame0 + i.astype(jnp.uint32))
            return self._render_chunk(scene, cam_vec, fh, lane0, acc)
        return jax.lax.fori_loop(0, n_frames, body, accum_chunk)

    # ------------------------------------------------------------------
    def zeros_accum(self):
        return jnp.zeros((self.width * self.height, 3), jnp.float32)

    def render_frame(self, accum, camera: RenderCamera, frame_number: int):
        """One progressive sample per pixel; frame_number starts at 1
        (the reference increments before rendering, src/main.cpp:167)."""
        return self.render_frames(accum, camera, frame_number, 1)

    # max samples per device dispatch: bounds the length of one device
    # program, so progress reports and checkpoints stay regular
    MAX_FRAMES_PER_DISPATCH = 32

    def render_frames(self, accum, camera: RenderCamera, frame_start: int,
                      n_frames: int):
        """Accumulate n_frames samples per pixel in as few device dispatches
        as possible (frame numbers frame_start .. frame_start+n_frames-1)."""
        cap = self.MAX_FRAMES_PER_DISPATCH
        if n_frames > cap:
            done = 0
            while done < n_frames:
                step = min(cap, n_frames - done)
                accum = self.render_frames(accum, camera,
                                           frame_start + done, step)
                done += step
            return accum
        cam_vec = jnp.asarray(camera.as_array())
        f0 = jnp.uint32(frame_start)
        n = accum.shape[0]
        chunk = self.lane_chunk
        if n <= chunk:
            return self._frames_fn(self.scene, cam_vec, f0, jnp.uint32(0),
                                   accum, n_frames=n_frames)
        out = []
        for lane0 in range(0, n, chunk):
            sl = accum[lane0:lane0 + chunk]
            pad = chunk - sl.shape[0]
            if pad:
                sl = jnp.pad(sl, ((0, pad), (0, 0)))
            res = self._frames_fn(self.scene, cam_vec, f0, jnp.uint32(lane0),
                                  sl, n_frames=n_frames)
            out.append(res[:chunk - pad] if pad else res)
        return jnp.concatenate(out, axis=0)

    def accum_to_image(self, accum, frame_count):
        """Tonemap the lane-ordered accumulation into an [H,W,3] uint8 image.

        Dispatch is TYPE-based: a jax array takes the on-device f32
        tonemap + uint8-quantize path and reads back uint8 (a quarter of
        the f32 bytes); an np.ndarray takes the host f64 tonemap
        (core.image.tonemap). The two can differ by at most 1 uint8 step
        (f32 vs f64 pow before rounding) — tool authors who need
        bit-stable output across call sites should pass one type
        consistently."""
        from ..core.image import tonemap
        import numpy as _np
        if not isinstance(accum, _np.ndarray):
            # device-side tonemap + uint8 quantize, THEN read back, so
            # every snapshot/preview readback moves uint8 (4x less). Same
            # quantization as core.image.tonemap (f32 instead of f64 —
            # at most 1 ulp before rounding).
            fc = max(int(frame_count), 1)
            u8 = jnp.clip(accum[:self.width * self.height]
                          / jnp.float32(fc), 0.0, 1.0)
            u8 = (jnp.power(u8, jnp.float32(1.0 / 2.2)) * 255.0
                  + 0.5).astype(jnp.uint8)
            img = np.zeros((self.height, self.width, 3), np.uint8)
            img[self._lane_py, self._lane_px] = np.asarray(u8)
            return img
        return tonemap(self.accum_to_buffer(accum), frame_count)

    def accum_to_buffer(self, accum):
        """Unswizzle the lane-ordered accumulation into an [H,W,3] buffer."""
        a = np.asarray(accum)[:self.width * self.height]
        img = np.zeros((self.height, self.width, 3), np.float32)
        img[self._lane_py, self._lane_px] = a
        return img


def scene_parts_from_desc(desc: SceneDesc, base_dir="", cache_dir=None):
    """Load (fb, materials, envmap, texture, settings) per the SceneDesc —
    the pieces renderer_from_scene_desc assembles, for callers that pick
    their own resolution (e.g. the interactive viewer)."""
    import os
    from ..scene.objloader import load_obj
    from ..scene.plyloader import load_ply
    from ..scene.hdr import read_hdr
    from ..scene.texture import load_texture
    from ..accel.cache import load_or_build

    path = os.path.join(base_dir, desc.scenefile)
    if path.endswith(".obj"):
        mesh = load_obj(path, desc.mat_id_map)
    elif path.endswith(".ply"):
        mesh = load_ply(path)
    else:
        raise ValueError("unsupported scene file %r" % desc.scenefile)

    fb = load_or_build(mesh, cache_dir=cache_dir)
    envmap = None
    if desc.HDRmapname and desc.use_envmap:
        envmap = read_hdr(os.path.join(base_dir, desc.HDRmapname))
    texture = None
    if desc.textureFile:
        texture = load_texture(os.path.join(base_dir, desc.textureFile))
    settings = RenderSettings(
        bounce_min=desc.bounce_min,
        bounce_max=desc.bounce_max,
        use_envmap=envmap is not None,
        use_texture=texture is not None,
        has_media=any(m.medium is not None for m in desc.materials),
        has_bssrdf=any(m.refltype == MAT_SUBSURFACE for m in desc.materials),
        use_distant_light=desc.use_distant_light,
        distant_light_L=tuple(desc.distant_light_L),
        distant_light_dir=tuple(desc.distant_light_dir),
    )
    return fb, desc.materials, envmap, texture, settings


def renderer_from_scene_desc(desc: SceneDesc, base_dir="", cache_dir=None):
    """Assemble a Renderer from a SceneDesc the way main() does
    (src/main.cpp:672-760): load mesh, build/cache BVH, load HDR + texture."""
    fb, mats, envmap, texture, settings = scene_parts_from_desc(
        desc, base_dir=base_dir, cache_dir=cache_dir)
    return Renderer(fb, mats, envmap=envmap, texture=texture,
                    width=desc.width, height=desc.height, settings=settings)
