"""The CUDA traversal kernel on the card, against the plain traversal and
the brute-force oracle. Skips without a GPU; run on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_pathtracer.accel import flatten_mesh_bvh
from tpu_pathtracer.core.vecmath import RAY_MIN, RAY_MAX
from tpu_pathtracer.scene import procedural
from tpu_pathtracer.tracer.traverse import (
    brute_force_intersect, intersect_scene, pack_stream,
)

pytestmark = pytest.mark.gpu


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.3, 3, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("active", ["all", "mask", "prefix"])
def test_kernel_matches_plain_and_brute_force(gpu, anyhit, active):
    from tpu_pathtracer.ops.traverse_gpu import gpu_intersect
    mesh = procedural.make_test_scene()
    fb = flatten_mesh_bvh(mesh)
    packed = jnp.asarray(pack_stream(fb.prims, fb.meta))
    n = 3000
    o, d = _rays(n, 1)
    act = np.ones(n, bool)
    prefix = None
    if active == "mask":
        act = np.arange(n) % 3 != 1
    elif active == "prefix":
        prefix = jnp.int32(1777)
        act = np.arange(n) < 1777
    ks, kt = gpu_intersect(packed, jnp.asarray(o), jnp.asarray(d), RAY_MIN,
                           RAY_MAX, anyhit=anyhit, active=jnp.asarray(act)
                           if active == "mask" else None,
                           active_prefix=prefix)
    ps, pt = intersect_scene(None, None, fb.num_nodes, jnp.asarray(o),
                             jnp.asarray(d), RAY_MIN, RAY_MAX, anyhit=anyhit,
                             active=jnp.asarray(act), packed=packed,
                             stack_depth=min(64, fb.max_depth + 2),
                             tile_size=None)
    ks, kt, ps, pt = map(np.asarray, (ks, kt, ps, pt))
    assert np.all(ks[~act] == -1) and np.all(kt[~act] == RAY_MAX)
    bt, _ = brute_force_intersect(mesh.tri_vertices(), o, d, RAY_MIN, RAY_MAX)
    assert ((ks >= 0) == (ps >= 0)).mean() >= 0.999
    assert ((ks[act] >= 0) == (bt[act] >= 0)).mean() >= 0.999
    if not anyhit:
        ours = np.where(ks >= 0, fb.tri_orig[np.maximum(ks, 0)], -1)
        assert (ours[act] == bt[act]).mean() >= 0.999
        same = act & (ks == ps) & (ks >= 0)
        np.testing.assert_allclose(kt[same], pt[same], rtol=1e-4)


def test_kernel_frame_matches_plain_frame(gpu):
    from tpu_pathtracer.scene.demo import default_camera, testobj_scene
    from tpu_pathtracer.tracer import Renderer
    fb, mats, env, tex = testobj_scene(cache_dir=".bvh_cache")
    base = Renderer(fb, mats, envmap=env, texture=tex, width=64, height=64)
    rc = default_camera(64, 64).build_render_camera()
    img = {}
    for trav in ("auto", "plain"):
        r = Renderer(fb, mats, envmap=env, texture=tex, width=64, height=64,
                     base_scene=base.scene,
                     settings=dataclasses.replace(base.settings,
                                                  traversal=trav))
        img[trav] = np.asarray(r.render_frames(r.zeros_accum(), rc, 1, 4))
    d = np.abs(img["auto"] - img["plain"])
    # same paths up to float contraction in the two traversals: a path
    # that flips a hit near an edge changes one pixel, not the image
    assert np.median(d) < 1e-4
    assert abs(img["auto"].mean() / img["plain"].mean() - 1.0) < 0.01
