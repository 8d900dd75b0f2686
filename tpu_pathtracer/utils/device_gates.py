"""Correctness gates for a run on the device, shared by chip_smoke.py and
bench.py. Each gate records what it measured through `record(key, value)`
and raises AssertionError when a bound is broken; none is skipped.

Bounds and why:
* kernel slot agreement >= 99.9% against the brute-force oracle and the
  plain traversal: a ray that grazes a shared edge may pick the other
  triangle when the arithmetic differs in the last bit;
* hit_t within rtol 1e-4 where both sides hit the same triangle: nvcc
  contracts a*b+c into FMA by default, and XLA's GPU code may too, so the
  kernel and the plain path differ by a few ulps; the oracle is float64;
* regen against the classic bounce integrator, max |diff| < 5e-3 over a
  2-spp 128^2 image: the same paths, summed in another order;
* device render against a CPU golden: median |diff| < 1e-4, mean within
  1%, RMSE < 0.1. Same-seed device and CPU renders differ by
  transcendental and FMA drift, which on BSSRDF/media flips a few chaotic
  paths (a 1-ulp change picks another reservoir probe), so RMSE is
  dominated by a handful of pixels while the typical pixel agrees; a data
  movement bug moves the median and the mean (a black sky is RMSE > 0.3).
"""
from __future__ import annotations

import numpy as np

from ..core.vecmath import RAY_MIN, RAY_MAX


def random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.3, 3, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def brute_force(tri_verts, o, d, chunk):
    """The brute-force oracle in chunks of `chunk` rays (it holds
    chunk x triangles float64 arrays)."""
    from ..tracer.traverse import brute_force_intersect
    tri, t = [], []
    for i in range(0, o.shape[0], chunk):
        a, b = brute_force_intersect(tri_verts, o[i:i + chunk],
                                     d[i:i + chunk], RAY_MIN, RAY_MAX)
        tri.append(a)
        t.append(b)
    return np.concatenate(tri), np.concatenate(t)


def check_agreement(record, name, fb, slot, t, want_tri, want_t, mask=None):
    """Slot agreement (attribute slot -> original triangle) >= 99.9% and
    hit_t within rtol 1e-4 where both hit the same triangle."""
    slot, t = np.asarray(slot), np.asarray(t)
    ours = np.where(slot >= 0, fb.tri_orig[np.maximum(slot, 0)], -1)
    m = np.ones(ours.shape, bool) if mask is None else mask
    agree = float((ours[m] == want_tri[m]).mean())
    both = m & (ours == want_tri) & (ours >= 0)
    rel = np.abs(t[both] - want_t[both]) / np.maximum(np.abs(want_t[both]),
                                                      1e-30)
    max_rel = float(rel.max()) if rel.size else 0.0
    record("gate_" + name, {"slot_agreement": agree, "hit_t_max_rel":
                            max_rel, "rays": int(m.sum())})
    assert agree >= 0.999, "%s: slot agreement %.5f < 0.999" % (name, agree)
    assert max_rel <= 1e-4, "%s: hit_t rel err %.3g > 1e-4" % (name, max_rel)


def kernel_gates(record, tag, fb, tri_verts, n_rays, chunk, prim_rays):
    """The CUDA kernel against the oracle (closest hit, anyhit hit/miss,
    sparse mask, active prefix) on n_rays random rays, and against the
    plain traversal on the same device on `prim_rays` (orig, dir)."""
    import jax
    import jax.numpy as jnp
    from ..ops.traverse_gpu import gpu_intersect
    from ..tracer.traverse import intersect_scene, pack_stream

    packed = jnp.asarray(pack_stream(fb.prims, fb.meta))
    sd = min(64, fb.max_depth + 2)

    def plain(o, d, anyhit=False):
        return intersect_scene(None, None, fb.num_nodes, o, d, RAY_MIN,
                               RAY_MAX, anyhit=anyhit, stack_depth=sd,
                               packed=packed, tile_size=None)

    with jax.default_matmul_precision("highest"):
        o, d = random_rays(n_rays, 0)
        bt, btt = brute_force(tri_verts, o, d, chunk)
        oj, dj = jnp.asarray(o), jnp.asarray(d)
        ks, kt = gpu_intersect(packed, oj, dj, RAY_MIN, RAY_MAX)
        check_agreement(record, tag + "_closest_vs_brute", fb, ks, kt, bt,
                        btt)

        ah, aht = gpu_intersect(packed, oj, dj, RAY_MIN, RAY_MAX,
                                anyhit=True)
        ah = np.asarray(ah)
        agree = float(((ah >= 0) == (bt >= 0)).mean())
        record("gate_%s_anyhit_vs_brute" % tag, {"hit_miss_agreement": agree})
        assert agree >= 0.999, "%s anyhit: %.5f" % (tag, agree)
        assert np.all((np.asarray(aht) < RAY_MAX) == (ah >= 0)), tag

        # sparse mask and active prefix: inactive lanes are (-1, tmax)
        act = np.arange(n_rays) % 3 == 0
        ms, mt = gpu_intersect(packed, oj, dj, RAY_MIN, RAY_MAX,
                               active=jnp.asarray(act))
        ms, mt = np.asarray(ms), np.asarray(mt)
        assert np.all(ms[~act] == -1) and np.all(mt[~act] == RAY_MAX), tag
        check_agreement(record, tag + "_mask_vs_brute", fb, ms, mt, bt, btt,
                        mask=act)
        n_pre = n_rays // 2 + 7
        ps, pt = gpu_intersect(packed, oj, dj, RAY_MIN, RAY_MAX,
                               active=jnp.ones((n_rays,), bool),
                               active_prefix=jnp.int32(n_pre))
        ps, pt = np.asarray(ps), np.asarray(pt)
        assert np.all(ps[n_pre:] == -1) and np.all(pt[n_pre:] == RAY_MAX), tag
        check_agreement(record, tag + "_prefix_vs_brute", fb, ps, pt, bt,
                        btt, mask=np.arange(n_rays) < n_pre)

        # against the plain traversal on the same device, at full width
        po, pd = prim_rays
        ks, kt = gpu_intersect(packed, po, pd, RAY_MIN, RAY_MAX)
        ref, ref_t = jax.jit(plain)(po, pd)
        ref = np.asarray(ref)
        check_agreement(record, tag + "_closest_vs_plain", fb, ks, kt,
                        np.where(ref >= 0, fb.tri_orig[np.maximum(ref, 0)],
                                 -1), np.asarray(ref_t))
        ka, _ = gpu_intersect(packed, po, pd, RAY_MIN, RAY_MAX, anyhit=True)
        pa, _ = jax.jit(lambda a, b: plain(a, b, anyhit=True))(po, pd)
        agree = float(((np.asarray(ka) >= 0) == (np.asarray(pa) >= 0)).mean())
        record("gate_%s_anyhit_vs_plain" % tag,
               {"hit_miss_agreement": agree, "rays": int(po.shape[0])})
        assert agree >= 0.999, "%s anyhit vs plain: %.5f" % (tag, agree)


def regen_vs_bounce(record, fb, mats, envmap, texture, size=128, spp=2):
    """The default regen integrator against the classic bounce loop."""
    import dataclasses
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer
    base = Renderer(fb, mats, envmap=envmap, texture=texture, width=size,
                    height=size)
    rc = default_camera(size, size).build_render_camera()
    img = {}
    for mode in ("bounce", "regen"):
        r = Renderer(fb, mats, envmap=envmap, texture=texture, width=size,
                     height=size, base_scene=base.scene,
                     settings=dataclasses.replace(base.settings,
                                                  integrator=mode))
        img[mode] = np.asarray(r.render_frames(r.zeros_accum(), rc, 1, spp))
    dmax = float(np.abs(img["bounce"] - img["regen"]).max())
    record("gate_regen_vs_bounce_%d" % size, {"max_abs_diff": dmax})
    assert dmax < 5e-3, "regen vs bounce on device: maxdiff %g" % dmax


def golden_gate(record, name, img, want):
    """A device render against its CPU golden (see the module doc)."""
    d = np.abs(img - want)
    rmse = float(np.sqrt((d ** 2).mean()))
    med = float(np.median(d))
    ratio = float(img.mean()) / max(float(want.mean()), 1e-9)
    record("golden_" + name, {"rmse": rmse, "median_absdiff": med,
                              "mean_ratio": ratio})
    assert np.all(np.isfinite(img)), "%s: non-finite on device" % name
    assert med < 1e-4, "%s: median |diff| %.3g" % (name, med)
    assert abs(ratio - 1.0) < 0.01, "%s: mean ratio %.5f" % (name, ratio)
    assert rmse < 0.1, "%s: RMSE %.4g" % (name, rmse)


def load_golden_module(root):
    """tests/test_goldens.py as a module (its configs and renderer)."""
    import importlib.util
    import os
    path = os.path.join(root, "tests", "test_goldens.py")
    spec = importlib.util.spec_from_file_location("_golden_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
