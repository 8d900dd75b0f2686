"""Wavefront path tracer in JAX.

A physically-based rendering framework in JAX, with the full capability
set of the reference CUDA megakernel path tracer
(wangkepfe/CUDA-Path-Tracing, see SURVEY.md):

* SBVH (spatial-split BVH) acceleration over OBJ/PLY triangle meshes
  (reference: src/SplitBVHBuilder.cpp) with Woop-transformed triangle
  intersection (reference: src/CudaBVH.cpp:301).
* Progressive Monte-Carlo path tracing with HDR environment lighting
  (reference: src/renderkernel.cu:472).
* Full material set: lambertian, GGX microfacet (iso/aniso), diffuse+
  reflection blend, Fresnel blend, specular & rough glass, emissive, null
  (reference: src/reflection.cuh).
* Homogeneous participating media (HG phase) and tabulated photon-beam-
  diffusion BSSRDF subsurface scattering (reference: src/bssrdf.cpp/.cuh).
* Thin-lens depth of field, AA jitter, textures, JSON scene description
  (reference: src/renderkernel.cu:862, src/SceneDesc.cpp).

Architecture (NOT a port): a batched *wavefront* pipeline over SoA ray
arrays driven by `lax.while_loop`, with a unified primitive stream (BVH
inner nodes and Woop triangles share one (K,16) row layout so traversal
does one row fetch per step), a per-ray CUDA traversal kernel on NVIDIA
GPUs (ops/traverse.cu), branch-free vectorized BSDF dispatch, and
counter-based (PCG) RNG.
"""

__version__ = "0.1.0"
