"""Path-regeneration integrator vs the classic bounce loop."""
import dataclasses

import numpy as np
import pytest

from tpu_pathtracer.scene import procedural, MatDesc
from tpu_pathtracer.scene.config import (
    MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_FRESNEL,
)
from tpu_pathtracer.scene.demo import default_camera
from tpu_pathtracer.accel import load_or_build
from tpu_pathtracer.tracer import Renderer, RenderSettings


def test_regen_matches_bounce_integrator(tmp_path):
    """Counter-based RNG makes both integrators produce the same sample
    values; only float accumulation order may differ."""
    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                    kd=5.0, ks=1.0),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    tex = procedural.make_checker_texture(64)
    W = H = 48
    rc = default_camera(W, H).build_render_camera()
    s = RenderSettings(bounce_min=2, bounce_max=16, use_envmap=True,
                       use_texture=True, integrator="bounce")
    out = {}
    for mode in ("bounce", "regen"):
        r = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=H,
                     settings=dataclasses.replace(s, integrator=mode))
        out[mode] = np.asarray(r.render_frames(r.zeros_accum(), rc, 1, 3))
    d = np.abs(out["bounce"] - out["regen"])
    assert d.mean() < 1e-5
    assert d.max() < 5e-3  # isolated float-order differences only
    assert out["regen"].mean() == pytest.approx(out["bounce"].mean(),
                                                rel=1e-4)


def test_regen_compact_order_matches_inplace(tmp_path):
    """The compact pool permutation must not change anything observable:
    same sample values, same wave count, same traced-ray count."""
    import jax
    import jax.numpy as jnp
    from tpu_pathtracer.tracer.regen import make_regen_integrator

    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                    kd=5.0, ks=1.0),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    tex = procedural.make_checker_texture(64)
    W = H = 48
    rc = default_camera(W, H).build_render_camera()
    out = {}
    for order in ("inplace", "compact"):
        r = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=H,
                     settings=None)
        st = dataclasses.replace(r.settings, regen_order=order)
        fn = jax.jit(make_regen_integrator(st, W, H, with_stats=True),
                     static_argnames=("n_frames",))
        acc, waves, rays = fn(r.scene, jnp.asarray(rc.as_array()),
                              jnp.uint32(1), jnp.uint32(0), r.zeros_accum(),
                              n_frames=2)
        out[order] = (np.asarray(acc), int(waves), float(rays))
    d = np.abs(out["inplace"][0] - out["compact"][0])
    assert d.max() < 5e-3 and d.mean() < 1e-5
    assert out["inplace"][1] == out["compact"][1]
    assert out["inplace"][2] == out["compact"][2]
    # sanity on the stats counter itself: >= 1 extension ray per path
    assert out["inplace"][2] >= W * H * 2


def test_regen_capped_pool_matches_full(tmp_path):
    """pool_lanes < W*H runs a narrower always-active pool over the same
    sample queue: per-sample RNG streams are identical, so the image must
    match the full-width pool to float-accumulation order, with the same
    traced-ray total (more, narrower waves)."""
    import jax
    import jax.numpy as jnp
    from tpu_pathtracer.tracer.regen import make_regen_integrator

    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    W = H = 48
    rc = default_camera(W, H).build_render_camera()
    out = {}
    for pool in (0, 512):   # 0 = image-sized (2304 lanes); 512 caps
        r = Renderer(fb, mats, envmap=env, width=W, height=H, settings=None)
        st = dataclasses.replace(r.settings, pool_lanes=pool)
        fn = jax.jit(make_regen_integrator(st, W, H, with_stats=True),
                     static_argnames=("n_frames",))
        acc, waves, rays = fn(r.scene, jnp.asarray(rc.as_array()),
                              jnp.uint32(1), jnp.uint32(0), r.zeros_accum(),
                              n_frames=2)
        out[pool] = (np.asarray(acc), int(waves), float(rays))
    d = np.abs(out[0][0] - out[512][0])
    assert d.max() < 5e-3 and d.mean() < 1e-5
    assert out[0][2] == out[512][2]          # same path segments traced
    assert out[512][1] > out[0][1]           # narrower pool -> more waves


def test_lane_pixel_xy_matches_swizzle_tables():
    """The closed-form de-swizzle must reproduce the Renderer's lane->pixel
    tables bit for bit, including clipped edge blocks (W or H not a
    multiple of 32)."""
    import jax.numpy as jnp
    from tpu_pathtracer.tracer.renderer import lane_pixel_xy

    bs = 32
    for W, H in [(64, 64), (48, 48), (37, 23), (1920, 1080), (100, 129),
                 (31, 7), (128, 96)]:
        # reference construction (Renderer.__init__)
        bw = -(-W // bs)
        lanes = np.arange(bw * -(-H // bs) * bs * bs, dtype=np.int64)
        blk = lanes // (bs * bs)
        within = lanes % (bs * bs)
        px = (blk % bw) * bs + within % bs
        py = (blk // bw) * bs + within // bs
        valid = (px < W) & (py < H)
        px = px[valid][: W * H]
        py = py[valid][: W * H]

        ax, ay = lane_pixel_xy(jnp.arange(W * H, dtype=jnp.int32), W, H)
        np.testing.assert_array_equal(np.asarray(ax), px, err_msg=f"{W}x{H}")
        np.testing.assert_array_equal(np.asarray(ay), py, err_msg=f"{W}x{H}")

def test_regen_ring_scatter_matches_deferred(tmp_path):
    """scatter_mode="ring" banks dead tails in a cross-wave ring and
    scatters only when the ring nears full — per-pixel sums must match the
    per-wave deferred flush to float order, with identical wave/ray counts.
    The capped pool forces many waves (several ring appends + mid-loop
    pre-flushes + the post-loop drain all execute)."""
    import jax
    import jax.numpy as jnp
    from tpu_pathtracer.tracer.regen import make_regen_integrator

    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    W = H = 48
    rc = default_camera(W, H).build_render_camera()
    out = {}
    for mode, pool in [("deferred", 0), ("ring", 0), ("ring", 512)]:
        r = Renderer(fb, mats, envmap=env, width=W, height=H, settings=None)
        st = dataclasses.replace(r.settings, scatter_mode=mode,
                                 pool_lanes=pool)
        fn = jax.jit(make_regen_integrator(st, W, H, with_stats=True),
                     static_argnames=("n_frames",))
        acc, waves, rays = fn(r.scene, jnp.asarray(rc.as_array()),
                              jnp.uint32(1), jnp.uint32(0), r.zeros_accum(),
                              n_frames=2)
        out[(mode, pool)] = (np.asarray(acc), int(waves), float(rays))
    ref = out[("deferred", 0)]
    for k, v in out.items():
        d = np.abs(v[0] - ref[0])
        assert d.max() < 5e-3 and d.mean() < 1e-5, k
        assert v[2] == ref[2], k                 # same path segments
    assert out[("ring", 0)][1] == ref[1]         # same wave count


@pytest.mark.parametrize("scatter_mode", ["deferred", "ring"])
def test_regen_deferred_full_flush_overflow(tmp_path, scatter_mode):
    """A sky-dominated view kills (nearly) the whole pool in wave 1 —
    more than the half-pool flush window — forcing the deferred scatter's
    lax.cond full-pool branch (for "ring", a full-width dead tail in the
    always-append window plus early ring wrap into the chunked drain).
    Radiance must match the classic integrator exactly (nothing dropped,
    nothing flushed twice)."""
    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_FRESNEL), MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    tex = procedural.make_checker_texture(64)
    W = H = 48
    cam = default_camera(W, H, center=(0.0, 30.0, 0.0))  # look at the sky
    rc = cam.build_render_camera()
    out = {}
    for mode in ("bounce", "regen"):
        r = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=H,
                     settings=RenderSettings(integrator=mode,
                                             scatter_mode=scatter_mode))
        out[mode] = np.asarray(r.render_frames(r.zeros_accum(), rc, 1, 2))
    assert np.isfinite(out["regen"]).all()
    d = np.abs(out["bounce"] - out["regen"])
    assert d.max() < 5e-3
    assert out["regen"].mean() == pytest.approx(out["bounce"].mean(),
                                                rel=1e-4)
    assert out["regen"].mean() > 0.1            # sky is actually bright


def test_regen_with_stats_identical_render(tmp_path):
    """The with_stats ray counter is diagnostics-only: carrying it (and
    its per-wave cross-lane reduces) must not change the rendered image
    bit-for-bit, the wave count, or the accumulation. Guards the gating
    refactor that removed the counter from the production program."""
    import jax
    import jax.numpy as jnp
    from tpu_pathtracer.tracer.regen import make_regen_integrator

    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    tex = procedural.make_checker_texture(64)
    W = H = 48
    rc = default_camera(W, H).build_render_camera()
    r = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=H)
    out = {}
    for ws in (False, True):
        fn = jax.jit(make_regen_integrator(r.settings, W, H,
                                           with_stats=ws),
                     static_argnames=("n_frames",))
        res = fn(r.scene, jnp.asarray(rc.as_array()), jnp.uint32(1),
                 jnp.uint32(0), r.zeros_accum(), n_frames=2)
        out[ws] = (np.asarray(res[0]), int(res[1]),
                   float(res[2]) if ws else None)
    assert np.array_equal(out[False][0], out[True][0])   # bit-identical
    assert out[False][1] == out[True][1]                 # same waves
    assert out[True][2] >= W * H * 2                     # counter sane


def test_sort_permute_bit_identical():
    """regen_permute='sort' (planar carry + one stable multi-payload
    lax.sort) must reproduce the gather permute BIT-EXACTLY: the stable
    sort realizes the same permutation as the stable argsort, and planar
    carries only move bits. Covers surface, capped-pool/ring, media and
    BSSRDF pool layouts."""
    import dataclasses
    import numpy as np
    from tpu_pathtracer.scene import procedural, MatDesc
    from tpu_pathtracer.scene.config import (
        MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_SUBSURFACE)
    from tpu_pathtracer.scene.demo import default_camera
    from tpu_pathtracer.accel import flatten_mesh_bvh
    from tpu_pathtracer.tracer import Renderer, RenderSettings

    mesh = procedural.make_test_scene()
    fb = flatten_mesh_bvh(mesh)
    env = procedural.make_sky_envmap(64, 32)
    W = H = 64
    rc = default_camera(W, H).build_render_camera()
    base = [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
            MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
    sss = [MatDesc(refltype=MAT_DIFF),
           MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                   alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2),
           MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
    media = [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
             MatDesc(refltype=MAT_GLASS, medium="jade"),
             MatDesc(refltype=MAT_REFL)]
    cases = [(base, {}), (base, dict(pool_lanes=256)),
             (media, dict(has_media=True)), (sss, dict(has_bssrdf=True))]
    for mats, extra in cases:
        imgs = {}
        for pm in ("gather", "sort"):
            st = RenderSettings(use_envmap=True, use_texture=False,
                                integrator="regen", regen_permute=pm,
                                **extra)
            r = Renderer(fb, mats, envmap=env, width=W, height=H,
                         settings=st)
            imgs[pm] = np.asarray(
                r.render_frames(r.zeros_accum(), rc, 1, 2))
        assert np.array_equal(imgs["gather"], imgs["sort"]), str(extra)


def test_merged_envtex_gather_bit_identical(tmp_path):
    """The merged env+texture gather (wavefront.env_tex_merged, round 5)
    must be BIT-identical to the two separate full-width gathers: same
    rows, same interpolation op sequence, only the gather source merged."""
    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                    kd=5.0, ks=1.0),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    tex = procedural.make_checker_texture(64)
    W = H = 48
    rc = default_camera(W, H).build_render_camera()
    out = {}
    for merge in (True, False):
        r = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=H)
        assert "envtex_quad" in r.scene
        r2 = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=H,
                      base_scene=r.scene,
                      settings=dataclasses.replace(r.settings,
                                                   merge_envtex=merge))
        out[merge] = np.asarray(r2.render_frames(r2.zeros_accum(), rc, 1, 2))
    assert np.array_equal(out[True], out[False])
    assert out[True].mean() > 0.0


def test_unknown_variant_raises():
    from tpu_pathtracer.scene.demo import testobj_scene
    with pytest.raises(ValueError):
        testobj_scene(variant="lambertain")   # typo must not render default
