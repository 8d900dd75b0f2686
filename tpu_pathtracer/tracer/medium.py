"""Homogeneous participating media, wired into the wavefront.

The reference ships HomogeneousMedium (src/reflection.cuh:152-197) but the
current kernel never calls it (the media gallery images predate the material
refactor — see SURVEY.md §7). We wire it in properly: a ray inside a medium
(tracked per lane by the material id it refracted into) performs
channel-stratified distance sampling each wavefront iteration; if the sampled
distance is shorter than the surface hit it scatters via Henyey-Greenstein,
otherwise it transmits to the surface. The numerics follow HomogeneousMedium
exactly: Beer-Lambert transmittance, density-averaged pdf with the <1e-4
guard, and sigmaS/pdf weighting.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.rng import RaySampler
from ..core.vecmath import channel_select
from ..materials.bsdf import henyey_greenstein_sample


def medium_interaction(scene, rng, orig, raydir, mask, hit_t, medium_id,
                       active):
    """Returns (rng, orig, raydir, mask, sampled_medium).

    Lanes not inside a medium pass through unchanged. Lanes that scatter get
    a new origin (the scatter point) and HG direction; their surface hit this
    iteration is ignored by the caller. Lanes that transmit keep their ray
    but their mask picks up Tr/pdf.
    """
    in_medium = active & (medium_id >= 0)
    rng, (r1, r2, r3, r4) = RaySampler.next_n(rng, 4)

    from .wavefront import gather_material
    med = gather_material(scene, jnp.maximum(medium_id, 0))
    sigma_s = med["med_sigma_s"]
    sigma_a = med["med_sigma_a"]
    g = med["med_g"]
    sigma_t = sigma_s + sigma_a

    # sample a channel (src/reflection.cuh:169)
    ch = jnp.clip((r1 * 3.0).astype(jnp.int32), 0, 2)
    # branch-free pick (take_along_axis lowers to a per-index gather for
    # this duplicate-heavy index pattern — see vecmath)
    st_ch = jnp.maximum(channel_select(sigma_t, ch), 1e-12)

    dist = -jnp.log(jnp.maximum(1.0 - r2, 1e-12)) / st_ch
    scene_t = hit_t
    sampled = in_medium & (dist < scene_t)
    t = jnp.minimum(jnp.where(sampled, dist, scene_t), 1e20)

    Tr = jnp.exp(-sigma_t * t[:, None])
    density = jnp.where(sampled[:, None], sigma_t * Tr, Tr)
    pdf = jnp.mean(density, axis=-1)
    pdf = jnp.where(pdf < 1e-4, 1.0, pdf)
    weight = jnp.where(sampled[:, None], Tr * sigma_s, Tr) / pdf[:, None]
    mask = jnp.where(in_medium[:, None], mask * weight, mask)

    scatter_point = orig + t[:, None] * raydir
    hg_dir = henyey_greenstein_sample(r3, r4, g, raydir)
    orig = jnp.where(sampled[:, None], scatter_point, orig)
    raydir = jnp.where(sampled[:, None], hg_dir, raydir)
    return rng, orig, raydir, mask, sampled
