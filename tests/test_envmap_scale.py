"""Real-asset-scale envmap end-to-end (VERDICT r02 missing #4).

The reference loads a multi-megapixel HDR (pisa.hdr) through initHDR
(/root/reference/src/main.cpp:372-406) at startup. This test pushes a
2048x1024 (2M-texel) HDR through the SAME first-party pipeline: write_hdr
-> read_hdr (RLE round-trip) -> build_env_distribution (native Vose alias
over 2M texels, must be sub-second — the interpreted fallback takes
minutes) -> full render with env importance sampling, on the CPU.
"""
import time

import numpy as np

from tpu_pathtracer.scene import procedural, MatDesc
from tpu_pathtracer.scene.config import MAT_DIFF, MAT_REFL
from tpu_pathtracer.scene.demo import default_camera
from tpu_pathtracer.accel import load_or_build
from tpu_pathtracer.tracer import Renderer


def test_megapixel_envmap_end_to_end(tmp_path):
    env = procedural.make_sky_envmap(2048, 1024)
    assert env.shape == (1024, 2048, 3)

    # HDR IO round-trip at asset scale (RGBE quantization ~1% relative)
    from tpu_pathtracer.scene.hdr import write_hdr, read_hdr
    p = str(tmp_path / "sky2k.hdr")
    write_hdr(p, env)
    back = read_hdr(p)
    assert back.shape == env.shape
    rel = np.abs(back - env) / np.maximum(np.abs(env), 1e-3)
    assert np.median(rel) < 0.01 and rel.max() < 0.05

    # alias-table build over 2M texels must be sub-second (native Vose;
    # the reference's CDF build in initHDR is likewise O(n) at startup)
    from tpu_pathtracer.tracer.envsample import build_env_distribution
    # CPU time, best of 2: wall-clock asserts flake when the box is loaded
    # (e.g. a concurrent benchmark saturating host cores); the build is
    # single-threaded C + numpy, ~0.7 s CPU at 2M texels
    dt_full = float("inf")
    for _ in range(2):
        t0 = time.process_time()
        dist = build_env_distribution(back, topk=0)   # full 2M-texel table
        dt_full = min(dt_full, time.process_time() - t0)
    assert dist["env_alias"].shape[0] == 2048 * 1024
    # 5 s bound: typical is ~0.7 s CPU but cache/memory pressure from a
    # concurrent benchmark or profiler run on the same box inflates even
    # process_time (measured 1.04 s and >1.5 s under load) — the
    # interpreted fallback this guards against takes MINUTES, so even a
    # wide margin stays discriminating
    assert dt_full < 5.0, "full-table alias build took %.2fs" % dt_full

    # full render path with the 2M-texel env + default top-k NEE
    mesh = procedural.make_test_scene()
    fb = load_or_build(mesh, cache_dir=str(tmp_path))
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=False),
            MatDesc(refltype=MAT_DIFF, objcol=(0.8, 0.4, 0.3)),
            MatDesc(refltype=MAT_REFL),
            MatDesc(refltype=MAT_REFL, alphax=0.2, alphay=0.2)]
    W = H = 32
    r = Renderer(fb, mats, envmap=back, width=W, height=H)
    rc = default_camera(W, H).build_render_camera()
    img = np.asarray(r.render_frames(r.zeros_accum(), rc, 1, 2))
    assert np.isfinite(img).all()
    assert img.mean() > 0.01          # the sky actually lights the scene
    # sun NEE found the bright texels: some pixels got strong direct light
    assert img.max() > img.mean() * 2.0
