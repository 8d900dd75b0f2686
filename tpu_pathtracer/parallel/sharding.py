"""Multi-chip rendering: shard the wavefront over a device mesh.

The reference is single-GPU (`cudaSetDevice(0)`, src/main.cpp:723); path
tracing is embarrassingly parallel over pixels, so the scale-out is:
replicate the scene, shard the lane axis (pixels) across chips via
shard_map over a 1-D mesh, render locally, and let the final image assembly
be a no-op gather of the sharded accumulation buffer. No per-bounce
communication exists because every path is independent (SURVEY.md §2.3).

Both integrators run sharded: the classic bounce loop and the DEFAULT
path-regeneration integrator. Regen shards naturally because each shard owns
a contiguous lane range and runs its own constant-width pool over its own
(pixel, frame) sample queue — the counter-based per-(frame, global pixel)
RNG means every sample value is identical to the single-device render, and
each shard's `while_loop` runs its own trip count with zero collectives.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding


def make_mesh(devices=None, axis_name="lanes"):
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


class ShardedRenderer:
    """Wraps a Renderer to run progressive frames sharded over a mesh.

    The accumulation buffer lives sharded on-device; `render_frame` /
    `render_frames` mirror Renderer's API. Lane count is padded to a
    multiple of the mesh size.
    """

    def __init__(self, renderer, mesh: Mesh = None):
        from ..tracer.renderer import Renderer  # noqa: F401 (typing only)
        self.base = renderer
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        n_dev = self.mesh.devices.size
        n = renderer.width * renderer.height
        self.n_lanes = ((n + n_dev - 1) // n_dev) * n_dev

        lane_sharding = NamedSharding(self.mesh, P(self.axis))
        repl = NamedSharding(self.mesh, P())
        self._lane_sharding = lane_sharding

        # place scene replicated once
        self.scene = {
            k: (jax.device_put(v, repl) if hasattr(v, "shape") else v)
            for k, v in renderer.scene.items()
        }

        # traversal goes through the same seam as the single-device path
        # (wavefront.trace_rays): on a GPU the kernel runs per shard under
        # shard_map
        settings = self.settings = renderer.settings

        if settings.integrator == "regen":
            from ..tracer.regen import make_regen_integrator
            regen_fn = make_regen_integrator(settings, renderer.width,
                                             renderer.height)

            def local(scene, cam_vec, frame0, accum_chunk, *, n_frames):
                idx = jax.lax.axis_index(self.axis)
                chunk = accum_chunk.shape[0]
                lane0 = (idx * chunk).astype(jnp.uint32)
                acc, _waves = regen_fn(scene, cam_vec, frame0, lane0,
                                       accum_chunk, n_frames)
                return acc
        else:
            from ..tracer.wavefront import make_integrator
            from ..core.rng import wang_hash
            integrate = make_integrator(settings)

            def local(scene, cam_vec, frame0, accum_chunk, *, n_frames):
                idx = jax.lax.axis_index(self.axis)
                chunk = accum_chunk.shape[0]
                lane0 = (idx * chunk).astype(jnp.uint32)

                def body(i, acc):
                    fh = wang_hash(frame0 + i.astype(jnp.uint32))
                    return renderer._render_chunk(scene, cam_vec, fh, lane0,
                                                  acc, integrate=integrate)
                return jax.lax.fori_loop(0, n_frames, body, accum_chunk)

        def frames_fn(scene, cam_vec, frame0, accum, n_frames):
            # check_vma=False: the integrator's while_loop carries start from
            # broadcast constants (unvarying) and become lane-varying after
            # one iteration, which the varying-manual-axes checker rejects;
            # the computation itself is trivially per-lane correct (and the
            # regen pool's trip count is legitimately per-shard).
            import functools
            return jax.shard_map(
                functools.partial(local, n_frames=n_frames), mesh=self.mesh,
                in_specs=(P(), P(), P(), P(self.axis)),
                out_specs=P(self.axis), check_vma=False)(
                    scene, cam_vec, frame0, accum)

        self._frames_fn = jax.jit(frames_fn, static_argnames=("n_frames",))

    def zeros_accum(self):
        return jax.device_put(
            jnp.zeros((self.n_lanes, 3), jnp.float32), self._lane_sharding)

    def render_frame(self, accum, camera, frame_number: int):
        return self.render_frames(accum, camera, frame_number, 1)

    def render_frames(self, accum, camera, frame_start: int, n_frames: int):
        """Accumulate n_frames progressive samples (frame numbers
        frame_start .. frame_start+n_frames-1), sharded over the mesh."""
        cap = self.base.MAX_FRAMES_PER_DISPATCH
        done = 0
        while done < n_frames:
            step = min(cap, n_frames - done)
            cam_vec = jnp.asarray(camera.as_array())
            accum = self._frames_fn(self.scene, cam_vec,
                                    jnp.uint32(frame_start + done), accum,
                                    n_frames=step)
            done += step
        return accum

    def accum_to_image(self, accum, frame_count):
        return self.base.accum_to_image(accum, frame_count)

    def accum_to_buffer(self, accum):
        return self.base.accum_to_buffer(accum)
