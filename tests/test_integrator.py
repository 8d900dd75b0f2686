import numpy as np
import pytest

from tpu_pathtracer.scene import procedural, MatDesc
from tpu_pathtracer.scene.config import (
    MAT_DIFF, MAT_REFL, MAT_GLASS, MAT_EMIT, MAT_NULL,
)
from tpu_pathtracer.scene.camera import InteractiveCamera
from tpu_pathtracer.accel import flatten_mesh_bvh
from tpu_pathtracer.tracer import Renderer, RenderSettings


def _camera(W, H, pitch=0.25, radius=4.0, center=(0.0, 0.8, 0.0), fovx=60):
    cam = InteractiveCamera()
    cam.center_position = center
    cam.radius = radius
    cam.pitch = pitch
    cam.set_resolution(W, H)
    cam.set_fovx(fovx)
    return cam.build_render_camera()


def _render(r, rc, spp):
    accum = r.zeros_accum()
    for f in range(1, spp + 1):
        accum = r.render_frame(accum, rc, f)
    return np.asarray(accum) / spp


@pytest.fixture(scope="module")
def sphere_bvh():
    return flatten_mesh_bvh(
        procedural.make_uv_sphere((0, 0.0, 0), 1.0, 0, n_lat=16, n_lon=24))


def test_white_furnace_diffuse(sphere_bvh):
    """A perfectly white lambertian object in a constant unit environment must
    render to exactly 1 everywhere (f*cos/pdf = albedo = 1)."""
    W = H = 48
    r = Renderer(
        sphere_bvh, [MatDesc(refltype=MAT_DIFF, kd=1.0)],
        width=W, height=H, env_const=(1.0, 1.0, 1.0),
        settings=RenderSettings(bounce_min=16, bounce_max=16,
                                use_envmap=False, use_texture=False))
    img = _render(r, _camera(W, H, pitch=0.0, radius=4, center=(0, 0, 0)), 32)
    # every path eventually escapes into the unit furnace; mean must be ~1
    assert abs(img.mean() - 1.0) < 0.015
    assert np.all(np.isfinite(img))


def test_white_furnace_mirror(sphere_bvh):
    """Perfect mirror (ks=1) in a unit furnace is exactly 1 (specular chains
    extend the adaptive bounce budget so every path escapes)."""
    W = H = 32
    r = Renderer(
        sphere_bvh, [MatDesc(refltype=MAT_REFL, alphax=0.0, ks=1.0)],
        width=W, height=H, env_const=(1.0, 1.0, 1.0),
        settings=RenderSettings(bounce_min=2, bounce_max=16,
                                use_envmap=False, use_texture=False))
    img = _render(r, _camera(W, H, pitch=0.0, radius=4, center=(0, 0, 0)), 8)
    np.testing.assert_allclose(img, 1.0, atol=1e-3)


def test_emissive_surface(sphere_bvh):
    W = H = 32
    r = Renderer(
        sphere_bvh, [MatDesc(refltype=MAT_EMIT, emit=(2.0, 1.0, 0.5))],
        width=W, height=H, env_const=(0.0, 0.0, 0.0),
        settings=RenderSettings(use_envmap=False, use_texture=False))
    img = _render(r, _camera(W, H, pitch=0.0, radius=3, center=(0, 0, 0)), 4)
    img = img.reshape(H, W, 3)
    center = img[H // 2, W // 2]
    np.testing.assert_allclose(center, (2.0, 1.0, 0.5), atol=1e-4)
    # background is black
    assert img[0, 0].max() < 1e-6


def test_null_material_passthrough(sphere_bvh):
    """MAT_NULL passes rays through unchanged -> image equals pure env."""
    W = H = 32
    r = Renderer(
        sphere_bvh, [MatDesc(refltype=MAT_NULL)],
        width=W, height=H, env_const=(0.3, 0.5, 0.7),
        settings=RenderSettings(bounce_min=16, bounce_max=16,
                                use_envmap=False, use_texture=False))
    img = _render(r, _camera(W, H, pitch=0.0, radius=3, center=(0, 0, 0)), 4)
    # grazing silhouette rays can exhaust the bounce cap and return black
    # (the reference's capped paths do the same); demand 99% exact
    err = np.abs(img.reshape(-1, 3) - np.array([0.3, 0.5, 0.7])).max(-1)
    assert (err < 1e-3).mean() > 0.99
    assert abs(img.reshape(-1, 3).mean(0)[0] - 0.3) < 2e-3


def test_glass_furnace_near_unity(sphere_bvh):
    """Smooth glass in a furnace: energy preserved up to bounce-capped paths."""
    W = H = 32
    r = Renderer(
        sphere_bvh, [MatDesc(refltype=MAT_GLASS, etaT=1.5)],
        width=W, height=H, env_const=(1.0, 1.0, 1.0),
        settings=RenderSettings(bounce_min=4, bounce_max=16,
                                use_envmap=False, use_texture=False))
    img = _render(r, _camera(W, H, pitch=0.0, radius=4, center=(0, 0, 0)), 16)
    assert img.mean() > 0.93
    assert img.mean() < 1.02


def test_progressive_accumulation_reduces_variance():
    mesh = procedural.make_test_scene()
    fb = flatten_mesh_bvh(mesh)
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=False),
            MatDesc(refltype=MAT_DIFF),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    W = H = 48
    r = Renderer(fb, mats, envmap=env, width=W, height=H,
                 settings=RenderSettings(use_envmap=True, use_texture=False))
    rc = _camera(W, H)
    a1 = _render(r, rc, 2)
    a2 = _render(r, rc, 16)
    # compare noise: variance of laplacian should drop
    def lap_var(img):
        im = img.reshape(H, W, 3).mean(-1)
        return np.var(im[1:-1, 1:-1] * 4 - im[:-2, 1:-1] - im[2:, 1:-1]
                      - im[1:-1, :-2] - im[1:-1, 2:])
    assert lap_var(a2) < lap_var(a1)
    # deterministic given frame numbers
    b1 = _render(r, rc, 2)
    np.testing.assert_array_equal(a1, b1)


def test_base_scene_sharing_renders_identically():
    """Renderer(base_scene=...) must reuse the resolution-independent
    device arrays (same objects, no re-upload) and produce the same image
    as a freshly built renderer at the same resolution (the interactive
    viewer's preview path)."""
    mesh = procedural.make_test_scene()
    fb = flatten_mesh_bvh(mesh)
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=False),
            MatDesc(refltype=MAT_DIFF),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    st = RenderSettings(use_envmap=True, use_texture=False)
    base = Renderer(fb, mats, envmap=env, width=64, height=64, settings=st)
    fresh = Renderer(fb, mats, envmap=env, width=32, height=32, settings=st)
    shared = Renderer(fb, mats, envmap=env, width=32, height=32, settings=st,
                      base_scene=base.scene)
    # heavy arrays are the SAME device buffers, lane tables are rebuilt
    for k in ("packed", "tri_attr", "mat_table", "envmap_quad"):
        assert shared.scene[k] is base.scene[k], k
    assert shared.scene["lane_px"] is not base.scene["lane_px"]
    rc = _camera(32, 32)
    np.testing.assert_array_equal(np.asarray(_render(fresh, rc, 2)),
                                  np.asarray(_render(shared, rc, 2)))


def test_workload_class_packet_shape(sphere_bvh):
    """Derived RenderSettings classify the workload (surface, media,
    subsurface) from the materials and bound the traversal stack by the
    tree's depth. No per-class packet shape is derived any more: the GPU
    kernel traces one ray per thread, so the classes share one traversal
    configuration."""
    import dataclasses
    from tpu_pathtracer.scene.config import MAT_SUBSURFACE
    assert not any(f.name.startswith("packet_")
                   for f in dataclasses.fields(RenderSettings))
    surf = Renderer(sphere_bvh, [MatDesc(refltype=MAT_DIFF, kd=1.0)],
                    width=32, height=32)
    assert not surf.settings.has_media and not surf.settings.has_bssrdf
    assert surf.settings.stack_depth == min(64, sphere_bvh.max_depth + 2)
    assert surf.settings.traversal == "auto"
    med = Renderer(sphere_bvh, [MatDesc(refltype=MAT_GLASS, medium="jade")],
                   width=32, height=32)
    assert med.settings.has_media and not med.settings.has_bssrdf
    sss = Renderer(sphere_bvh,
                   [MatDesc(refltype=MAT_SUBSURFACE)],
                   width=32, height=32)
    assert sss.settings.has_bssrdf and not sss.settings.has_media
    # explicit settings are never second-guessed (beyond the stack bound)
    explicit = Renderer(sphere_bvh,
                        [MatDesc(refltype=MAT_SUBSURFACE)],
                        width=32, height=32,
                        settings=RenderSettings(has_bssrdf=True,
                                                traversal="plain"))
    assert explicit.settings.traversal == "plain"
    assert explicit.settings.has_bssrdf
