import numpy as np
import jax.numpy as jnp
import pytest

from tpu_pathtracer.scene import procedural
from tpu_pathtracer.scene.mesh import TriangleMesh
from tpu_pathtracer.accel import flatten_mesh_bvh
from tpu_pathtracer.tracer.traverse import (
    intersect_scene, brute_force_intersect, woop_geometric_normal,
)


@pytest.fixture(scope="module")
def scene():
    sphere = procedural.make_uv_sphere((0, 0.5, 0), 1.0, 0, n_lat=10, n_lon=14)
    plane = procedural.make_plane((0, 0, 0), 8, 8, 0)
    mesh = TriangleMesh.concatenate([sphere, plane])
    fb = flatten_mesh_bvh(mesh)
    return mesh, fb


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    orig = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    orig[:, 1] = rng.uniform(0.2, 3, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return orig, d


def test_traversal_matches_brute_force(scene):
    mesh, fb = scene
    orig, d = _random_rays(1500, 0)
    slot, t = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, 1e20)
    slot = np.asarray(slot)
    t = np.asarray(t)
    bf_tri, bf_t = brute_force_intersect(mesh.tri_vertices(), orig, d, 1e-4, 1e20)
    assert np.array_equal(slot >= 0, bf_tri >= 0)
    both = (slot >= 0) & (bf_tri >= 0)
    ours_tri = fb.tri_orig[np.maximum(slot, 0)]
    assert np.all(ours_tri[both] == bf_tri[both])
    np.testing.assert_allclose(t[both], bf_t[both], rtol=1e-3, atol=1e-4)


def test_anyhit_terminates_with_hit(scene):
    mesh, fb = scene
    orig, d = _random_rays(800, 1)
    slot_c, t_c = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, 1e20, anyhit=False)
    slot_a, t_a = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, 1e20, anyhit=True)
    # anyhit finds a hit iff closest-hit does, and its t is >= tmin, <= tmax
    np.testing.assert_array_equal(np.asarray(slot_a) >= 0,
                                  np.asarray(slot_c) >= 0)
    hit = np.asarray(slot_a) >= 0
    assert np.all(np.asarray(t_a)[hit] >= np.asarray(t_c)[hit] - 1e-5)


def test_inactive_lanes_do_nothing(scene):
    mesh, fb = scene
    orig, d = _random_rays(64, 2)
    active = np.zeros(64, bool)
    active[::2] = True
    slot, t = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, 1e20,
        active=jnp.asarray(active))
    slot = np.asarray(slot)
    assert np.all(slot[1::2] == -1), "inactive lanes must report no hit"


def test_tmax_respected(scene):
    mesh, fb = scene
    # keep the ray off the sphere's x=0 vertex seam: a ray exactly on a
    # shared triangle edge can round outside both triangles in f32
    orig = np.tile(np.array([[0.07, 0.55, 5.0]], np.float32), (4, 1))
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (4, 1))
    # front sphere surface at z=1 -> t=4
    slot, t = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, jnp.asarray([3.0, 4.5, 10.0, 0.5], jnp.float32))
    slot = np.asarray(slot)
    assert slot[0] == -1     # tmax too small
    assert slot[1] >= 0
    assert slot[2] >= 0
    assert slot[3] == -1


def test_geometric_normal_faces_triangle(scene):
    mesh, fb = scene
    orig, d = _random_rays(500, 3)
    slot, t = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, 1e20)
    n = np.asarray(woop_geometric_normal(jnp.asarray(fb.prims), fb.num_nodes, slot))
    slot = np.asarray(slot)
    hit = slot >= 0
    # compare against true face normal up to sign
    tri = fb.tri_orig[np.maximum(slot, 0)]
    tv = mesh.tri_vertices()[np.maximum(tri, 0)]
    face_n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    face_n /= np.maximum(np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-20)
    nn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    align = np.abs(np.sum(nn * face_n, -1))
    assert np.all(align[hit] > 0.999)


@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("active", ["mask", "prefix"])
def test_plain_matches_brute_force_with_active_set(scene, anyhit, active):
    """The plain traversal (the CPU path and the kernel's reference)
    against the brute-force oracle, with a sparse mask or a lane-prefix
    active set: inactive lanes return (-1, tmax), active ones match."""
    mesh, fb = scene
    n = 900
    orig, d = _random_rays(n, 4)
    act = (np.arange(n) % 4 != 0) if active == "mask" else np.arange(n) < 611
    slot, t = intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(orig), jnp.asarray(d), 1e-4, 1e20, anyhit=anyhit,
        active=jnp.asarray(act), stack_depth=fb.max_depth + 2)
    slot, t = np.asarray(slot), np.asarray(t)
    assert np.all(slot[~act] == -1) and np.all(t[~act] == np.float32(1e20))
    bf_tri, bf_t = brute_force_intersect(mesh.tri_vertices(), orig, d,
                                         1e-4, 1e20)
    np.testing.assert_array_equal(slot[act] >= 0, bf_tri[act] >= 0)
    if not anyhit:
        ours = fb.tri_orig[np.maximum(slot, 0)]
        both = act & (slot >= 0)
        assert np.all(ours[both] == bf_tri[both])
        np.testing.assert_allclose(t[both], bf_t[both], rtol=1e-3,
                                   atol=1e-4)
