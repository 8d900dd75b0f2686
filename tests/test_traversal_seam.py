"""The traversal seam (wavefront.trace_rays), the CUDA kernel's Python
wrapper and build (ops/traverse_gpu.py), and the compile-cache rule.

The kernel itself runs only on an NVIDIA GPU (tests/test_traverse_gpu.py,
marked `gpu`); everything around it is plain Python and is tested here.
"""
import fnmatch
import os
import stat
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_pathtracer.ops import traverse_gpu
from tpu_pathtracer.scene import procedural
from tpu_pathtracer.accel import flatten_mesh_bvh
from tpu_pathtracer.tracer.traverse import pack_stream, intersect_scene
from tpu_pathtracer.tracer.wavefront import RenderSettings, trace_rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    fb = flatten_mesh_bvh(procedural.make_test_scene())
    return {"prims": jnp.asarray(fb.prims), "meta": jnp.asarray(fb.meta),
            "packed": jnp.asarray(pack_stream(fb.prims, fb.meta)),
            "num_nodes": fb.num_nodes}


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.3, 3, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture
def fake_gpu(monkeypatch):
    """Backend reported as "gpu", the kernel call replaced by a recorder
    that answers with a recognisable constant."""
    calls = []

    def stub(packed, orig, raydir, tmin, tmax, anyhit=False, active=None,
             active_prefix=None):
        calls.append(dict(packed=packed, anyhit=anyhit, active=active,
                          active_prefix=active_prefix))
        n = orig.shape[0]
        return jnp.full((n,), 7, jnp.int32), jnp.full((n,), 3.0, jnp.float32)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(traverse_gpu, "gpu_intersect", stub)
    return calls


def test_trace_rays_uses_plain_on_cpu(scene, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU backend")
    monkeypatch.setattr(traverse_gpu, "gpu_intersect", boom)
    o, d = _rays(300)
    st = RenderSettings(stack_depth=64)
    slot, t = trace_rays(scene, st, o, d, 1e-4, 1e20)
    ref_slot, ref_t = intersect_scene(scene["prims"], scene["meta"],
                                      scene["num_nodes"], o, d, 1e-4, 1e20)
    np.testing.assert_array_equal(np.asarray(slot), np.asarray(ref_slot))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref_t))


def test_trace_rays_uses_kernel_on_gpu(scene, fake_gpu):
    o, d = _rays(50)
    act = jnp.arange(50) % 2 == 0
    slot, t = trace_rays(scene, RenderSettings(), o, d, 1e-4, 1e20,
                         anyhit=True, active=act,
                         active_prefix=jnp.int32(40))
    assert np.all(np.asarray(slot) == 7) and np.all(np.asarray(t) == 3.0)
    (call,) = fake_gpu
    assert call["packed"] is scene["packed"]
    assert call["anyhit"] is True
    assert call["active"] is act
    assert int(call["active_prefix"]) == 40


def test_trace_rays_plain_forced_on_gpu(scene, fake_gpu):
    o, d = _rays(40)
    slot, _ = trace_rays(scene, RenderSettings(traversal="plain"), o, d,
                         1e-4, 1e20)
    assert fake_gpu == []
    ref, _ = intersect_scene(scene["prims"], scene["meta"],
                             scene["num_nodes"], o, d, 1e-4, 1e20)
    np.testing.assert_array_equal(np.asarray(slot), np.asarray(ref))


def test_unknown_traversal_raises(scene):
    o, d = _rays(8)
    with pytest.raises(ValueError, match="traversal"):
        trace_rays(scene, RenderSettings(traversal="packet"), o, d, 1e-4,
                   1e20)


def _fake_nvcc(path, rc, log):
    """An executable standing in for nvcc: records its argv, creates the
    -o file, exits with rc."""
    path.write_text(
        "#!/bin/sh\n"
        "echo \"$@\" > %s\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        "[ %d -eq 0 ] && echo lib > \"$out\"\n"
        "echo 'error: fake compiler failure' >&2\n"
        "exit %d\n" % (log, rc, rc))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.mark.parametrize("how", ["nvcc_missing", "nvcc_fails"])
def test_trace_rays_raises_when_library_cannot_build(scene, monkeypatch,
                                                     tmp_path, how):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(traverse_gpu, "_registered", False)
    monkeypatch.setattr(traverse_gpu, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(traverse_gpu, "DEFAULT_NVCC",
                        str(tmp_path / "bin" / "nvcc"))
    if how == "nvcc_fails":
        (tmp_path / "bin").mkdir()
        _fake_nvcc(tmp_path / "bin" / "nvcc", 1, tmp_path / "argv")
    o, d = _rays(16)
    with pytest.raises(RuntimeError, match="nvcc"):
        trace_rays(scene, RenderSettings(), o, d, 1e-4, 1e20)
    assert not traverse_gpu._registered
    assert not any(p.suffix == ".so" for p in (tmp_path).rglob("*"))


def test_prepare_args_shapes_and_defaults():
    n = 1000                      # not a multiple of the kernel's block
    packed = np.zeros((9, 16), np.float32)
    o = jnp.zeros((n, 3))
    d = jnp.ones((n, 3))
    args = traverse_gpu.prepare_args(packed, o, d, 1e-4,
                                     jnp.linspace(1.0, 2.0, n))
    pk, oo, dd, tmin, tmax, act, pre = args
    assert pk.shape == (9, 16) and pk.dtype == jnp.float32
    assert oo.shape == dd.shape == (n, 3)
    assert tmin.shape == tmax.shape == (n,)
    assert tmin.dtype == tmax.dtype == jnp.float32
    assert np.all(np.asarray(tmin) == np.float32(1e-4))
    assert float(tmax[-1]) == 2.0
    assert act.dtype == jnp.bool_ and bool(act.all()) and act.shape == (n,)
    assert pre.shape == (1,) and pre.dtype == jnp.int32 and int(pre[0]) == n

    mask = np.arange(n) % 3 == 0
    pre2 = jax.jit(lambda k: traverse_gpu.prepare_args(
        packed, o, d, 1e-4, 1e20, active=jnp.asarray(mask),
        active_prefix=k)[5:])(jnp.int32(123))
    np.testing.assert_array_equal(np.asarray(pre2[0]), mask)
    assert int(pre2[1][0]) == 123


def test_gpu_intersect_output_contract(monkeypatch):
    monkeypatch.setattr(traverse_gpu, "load", lambda: None)
    packed = jnp.zeros((9, 16), jnp.float32)
    out = jax.eval_shape(
        lambda o, d: traverse_gpu.gpu_intersect(
            packed, o, d, 1e-4, 1e20, anyhit=True,
            active_prefix=jnp.int32(3)),
        jax.ShapeDtypeStruct((777, 3), jnp.float32),
        jax.ShapeDtypeStruct((777, 3), jnp.float32))
    assert [(o.shape, o.dtype) for o in out] == [
        ((777,), jnp.int32), ((777,), jnp.float32)]


def _gitignored(rel):
    """True when a .gitignore pattern of this checkout matches `rel`."""
    with open(os.path.join(ROOT, ".gitignore")) as f:
        pats = [p.strip() for p in f if p.strip() and not p.startswith("#")]
    parts = rel.split("/")
    for p in pats:
        q = p.strip("/")
        if "/" in q:
            if fnmatch.fnmatch(rel, q) or rel.startswith(q + "/"):
                return True
        elif any(fnmatch.fnmatch(c, q) for c in parts):
            return True
    return False


def test_build_uses_committed_sources_and_ignored_dir(monkeypatch, tmp_path):
    rels = [os.path.relpath(s, ROOT) for s in traverse_gpu.SOURCES]
    for rel in rels:
        assert not rel.startswith(".."), rel
        assert os.path.isfile(os.path.join(ROOT, rel)), rel
        assert not _gitignored(rel), rel
    if os.path.isdir(os.path.join(ROOT, ".git")):
        tracked = subprocess.run(["git", "ls-files", *rels], cwd=ROOT,
                                 capture_output=True, text=True).stdout
        staged = subprocess.run(["git", "diff", "--cached", "--name-only"],
                                cwd=ROOT, capture_output=True,
                                text=True).stdout
        for rel in rels:
            assert rel in tracked.split() or rel in staged.split(), rel
    build_rel = os.path.relpath(traverse_gpu.BUILD_DIR, ROOT)
    assert _gitignored(build_rel + "/libx.so")
    assert os.path.dirname(traverse_gpu.library_path()) == \
        traverse_gpu.BUILD_DIR

    # a build writes only into the build directory, from those sources
    monkeypatch.setattr(traverse_gpu, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    _fake_nvcc(tmp_path / "cuda" / "bin" / "nvcc", 0, tmp_path / "argv")
    path = traverse_gpu.build()
    assert os.path.dirname(path) == str(tmp_path / "b")
    assert sorted(os.listdir(tmp_path / "b")) == [os.path.basename(path)]
    argv = (tmp_path / "argv").read_text().split()
    assert "-gencode=arch=compute_90a,code=sm_90a" in argv
    assert [a for a in argv if a.endswith(".cu")] == list(
        traverse_gpu.SOURCES)
    # built once: a second call finds it without compiling again
    (tmp_path / "argv").unlink()
    assert traverse_gpu.build() == path
    assert not (tmp_path / "argv").exists()


def test_library_path_tracks_source_content(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(traverse_gpu, "SOURCES", (str(src),))
    a = traverse_gpu.library_path()
    assert traverse_gpu.library_path() == a
    src.write_text("// two\n")
    assert traverse_gpu.library_path() != a


@pytest.mark.parametrize("mode", ["env_var", "default", "disabled"])
def test_compile_cache_location(monkeypatch, tmp_path, mode):
    from tpu_pathtracer.utils import compcache
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    env_dir = str(tmp_path / "from_env")
    if mode == "env_var":
        monkeypatch.setenv(compcache.ENV_VAR, env_dir)
    else:
        monkeypatch.delenv(compcache.ENV_VAR, raising=False)
    got = []
    for sub in ("a", "b"):                    # two different cwds
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        got.append(compcache.enable("" if mode == "disabled" else None))
    assert got[0] == got[1]
    dirs = [v for k, v in updates if k == "jax_compilation_cache_dir"]
    if mode == "env_var":
        assert got[0] == env_dir
        assert updates == [("jax_compilation_cache_dir", env_dir)] * 2
    elif mode == "default":
        assert got[0] == os.path.join(ROOT, ".jax_cache")
        assert dirs == [got[0]] * 2
    else:
        assert got[0] == "" and updates == []
