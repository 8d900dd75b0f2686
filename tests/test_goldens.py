"""Golden-image regression tests.

The reference verified visually (renderingResult gallery, SURVEY.md §4); we
pin fixed-seed low-spp renders of the BASELINE configs as stored goldens and
compare by RMSE. Goldens are generated on the CPU backend (tests force it),
so they are bit-stable across machines; regenerate with
  python tests/test_goldens.py regen
after intentional changes to sampling or materials.
"""
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


import functools


@functools.lru_cache(maxsize=1)
def _small_configs():
    """Configs 1-5, on the 4.4k-triangle demo scene."""
    from tpu_pathtracer.scene import MatDesc
    from tpu_pathtracer.scene.config import (
        MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_FRESNEL, MAT_SUBSURFACE,
    )
    from tpu_pathtracer.scene.demo import testobj_scene
    from tpu_pathtracer.tracer import RenderSettings

    fb, mats, envmap, texture = testobj_scene(cache_dir=".bvh_cache_tests")

    # config 1: lambertian + texture, pinhole (BASELINE #1)
    mats1 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_DIFF, objcol=(0.9, 0.3, 0.25)),
             MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.9, 0.35)),
             MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.35, 0.9))]
    # config 2: microfacet + fresnel blend + env IS (BASELINE #2)
    mats2 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                     kd=5.0, ks=1.0),
             MatDesc(refltype=MAT_REFL, alphax=0.2, alphay=0.2),
             MatDesc(refltype=MAT_REFL)]
    # config 3: specular + rough glass with DOF (BASELINE #3)
    mats3 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_GLASS, alphax=0.15, etaT=1.5),
             MatDesc(refltype=MAT_GLASS),
             MatDesc(refltype=MAT_REFL)]
    # config 4: homogeneous media (BASELINE #4)
    mats4 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_DIFF),
             MatDesc(refltype=MAT_GLASS, medium="tea"),
             MatDesc(refltype=MAT_REFL)]
    # config 5: tabulated BSSRDF (BASELINE #5)
    mats5 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                     alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2),
             MatDesc(refltype=MAT_GLASS),
             MatDesc(refltype=MAT_REFL)]

    base = dict(use_envmap=True, use_texture=True)
    return {
        "c1_lambertian": (fb, mats1, envmap, texture,
                          RenderSettings(bounce_min=2, bounce_max=6, **base),
                          0.0),
        "c2_microfacet": (fb, mats2, envmap, texture,
                          RenderSettings(bounce_min=2, bounce_max=8, **base),
                          0.0),
        "c3_glass_dof": (fb, mats3, envmap, texture,
                         RenderSettings(bounce_min=2, bounce_max=10, **base),
                         0.05),
        "c4_media": (fb, mats4, envmap, texture,
                     RenderSettings(bounce_min=2, bounce_max=10,
                                    has_media=True, **base), 0.0),
        "c5_bssrdf": (fb, mats5, envmap, texture,
                      RenderSettings(bounce_min=3, bounce_max=10,
                                     has_bssrdf=True, **base), 0.0),
    }


@functools.lru_cache(maxsize=1)
def _configs():
    # configs 6/7: media + BSSRDF at reference scale on irregular geometry
    # (the head.ply-class ~104k-tri organic blob). The goldens pin the CPU
    # result; the device gates (bench.py, chip_smoke.py) compare device
    # renders against them.
    from tpu_pathtracer.scene.demo import large_organic_scene
    from tpu_pathtracer.tracer import RenderSettings
    fb6, mats6, env6, tex6 = large_organic_scene(
        cache_dir=".bvh_cache_tests", variant="sss")
    fb7, mats7, env7, tex7 = large_organic_scene(
        cache_dir=".bvh_cache_tests", variant="media")
    base = dict(use_envmap=True, use_texture=True)
    return {
        **_small_configs(),
        "c6_organic_sss": (fb6, mats6, env6, tex6,
                           RenderSettings(bounce_min=3, bounce_max=10,
                                          has_bssrdf=True, **base), 0.0),
        "c7_organic_media": (fb7, mats7, env7, tex7,
                             RenderSettings(bounce_min=2, bounce_max=10,
                                            has_media=True, **base), 0.0),
    }


def _render(name, spec, spp=12, size=96):
    from tpu_pathtracer.tracer import Renderer
    from tpu_pathtracer.scene.demo import default_camera
    fb, mats, envmap, texture, settings, aperture = spec
    r = Renderer(fb, mats, envmap=envmap, texture=texture,
                 width=size, height=size, settings=settings)
    cam = default_camera(size, size)
    cam.aperture_radius = aperture
    cam.focal_distance = 4.0
    rc = cam.build_render_camera()
    accum = r.render_frames(r.zeros_accum(), rc, 1, spp)
    return r.accum_to_buffer(np.asarray(accum) / spp)


_NAMES = ["c1_lambertian", "c2_microfacet", "c3_glass_dof", "c4_media",
          "c5_bssrdf", "c6_organic_sss", "c7_organic_media"]


def test_names_cover_all_configs():
    # _NAMES is static so collection stays lazy; it must track _configs()
    # or a newly added config would regen a golden nobody ever tests
    assert set(_NAMES) == set(_configs().keys())


@pytest.mark.parametrize("name", _NAMES)
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    if not os.path.exists(path):
        pytest.skip("golden missing; run: python tests/test_goldens.py regen")
    spec = _configs()[name]
    img = _render(name, spec)
    want = np.load(path)["img"]
    rmse = float(np.sqrt(np.mean((img - want) ** 2)))
    assert np.all(np.isfinite(img))
    assert rmse < 1e-4, "%s drifted from golden: RMSE %.2e" % (name, rmse)


if __name__ == "__main__":
    import sys
    # goldens are CPU-pinned by definition — force the platform HERE so a
    # bare `python tests/test_goldens.py regen` can't silently grab an
    # accelerator (outside pytest, conftest's CPU pin does not apply)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for name, spec in _configs().items():
            img = _render(name, spec)
            np.savez_compressed(os.path.join(GOLDEN_DIR, name + ".npz"),
                                img=img.astype(np.float32))
            print("wrote", name, "mean", img.mean())
