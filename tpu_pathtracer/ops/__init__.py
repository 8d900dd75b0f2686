"""Hand-written device kernels (CUDA, called through jax.ffi)."""
