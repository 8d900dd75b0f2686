"""Build, load and call the CUDA traversal kernel (ops/traverse.cu).

The kernel is compiled with nvcc from the sources committed beside this
file, at first use, into `ops/_build/` (listed in .gitignore). The library
name carries a hash of the sources and the compile command, so an edited
source or flag builds a new library and a stale one is never loaded. To
build ahead of time, run

    python -m tpu_pathtracer.ops.traverse_gpu

On a GPU a library that fails to build or load raises: there is no
fallback to the plain traversal (tracer/traverse.py:intersect_scene), which
stays the reference and the CPU path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "traverse.cu"),)
BUILD_DIR = os.path.join(_HERE, "_build")
TARGET = "tpt_trace_rays"
# sm_90a: Hopper's own target (H100, H200)
_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_registered = False


DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def find_nvcc():
    """nvcc from $CUDA_HOME, then PATH, then the default toolkit prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "traversal kernel cannot be built")


def compile_command(nvcc, out):
    return [nvcc, *_FLAGS, "-I", jax.ffi.include_dir(), "-o", out,
            *SOURCES]


def library_path():
    """Where the library for the current sources, flags and JAX version
    (whose FFI headers it is compiled against) lives."""
    h = hashlib.sha256(" ".join(_FLAGS + (jax.__version__,)).encode())
    for s in SOURCES:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libtraverse_%s.so" % h.hexdigest()[:16])


def build():
    """Compile the library if it is not built yet; return its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.part" % (path, os.getpid())
    cmd = compile_command(find_nvcc(), tmp)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
            res.returncode, " ".join(cmd), res.stderr[-4000:]))
    os.replace(tmp, path)      # atomic: a concurrent builder never half-reads
    return path


def load():
    """Build (if needed), load and register the FFI target once per
    process. Raises RuntimeError when the library cannot be built or
    loaded."""
    global _registered
    with _lock:
        if _registered:
            return
        path = build()
        try:
            lib = ctypes.CDLL(path)
            fn = lib.TptTraceRays
        except (OSError, AttributeError) as e:
            raise RuntimeError("cannot load %s: %s" % (path, e)) from e
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(fn),
                                    platform="CUDA")
        _registered = True


def prepare_args(packed, orig, raydir, tmin, tmax, active=None,
                 active_prefix=None):
    """The kernel's operands: tmin/tmax broadcast to (N,) f32, the active
    mask as (N,) bool (all true when None), and the active-prefix count as
    a (1,) int32 device scalar (N when None). No padding: the kernel
    bounds-checks every lane, so N need not be a multiple of its block."""
    n = orig.shape[0]
    f32 = jnp.float32
    act = (jnp.ones((n,), bool) if active is None
           else jnp.asarray(active, bool).reshape(n))
    pre = n if active_prefix is None else active_prefix
    return (jnp.asarray(packed, f32), jnp.asarray(orig, f32),
            jnp.asarray(raydir, f32),
            jnp.broadcast_to(jnp.asarray(tmin, f32), (n,)),
            jnp.broadcast_to(jnp.asarray(tmax, f32), (n,)),
            act, jnp.asarray(pre, jnp.int32).reshape(1))


def gpu_intersect(packed, orig, raydir, tmin, tmax, anyhit=False,
                  active=None, active_prefix=None):
    """Trace rays with the CUDA kernel. Same contract as
    tracer/traverse.py:intersect_scene: returns (hit_slot [N] int32, -1 on
    miss or inactive; hit_t [N] f32, tmax on miss or inactive).

    active_prefix: optional traced int32 scalar n; lanes >= n are inactive
    whatever `active` says (the regen pool's compacted prefix)."""
    load()
    args = prepare_args(packed, orig, raydir, tmin, tmax, active,
                        active_prefix)
    n = orig.shape[0]
    out = (jax.ShapeDtypeStruct((n,), jnp.int32),
           jax.ShapeDtypeStruct((n,), jnp.float32))
    return jax.ffi.ffi_call(TARGET, out)(*args,
                                         anyhit=np.int32(bool(anyhit)))


if __name__ == "__main__":
    print(build())
