"""Counter-free stateful per-lane RNG for the wavefront.

The reference seeds one curand sequence per pixel per frame
(`curand_init(WangHash(frame) + threadId)`, src/renderkernel.cu:879-880) and
draws uniforms serially along the path. We keep the same structure, wavefront
style:
each wavefront lane carries a uint32 state column; a draw hashes and advances
every lane in one vector op. The generator is the widely used PCG output hash
over an LCG state — fast (a few integer ops), statistically solid for MC rendering,
and fully deterministic given (frame, lane).

For distribution-level unit tests we also cross-check against jax.random.
"""
from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def wang_hash(x):
    """Wang integer hash; mirrors reference src/Util.cpp:4-12 bit for bit."""
    x = jnp.asarray(x, _U32)
    x = (x ^ _U32(61)) ^ (x >> _U32(16))
    x = x * _U32(9)
    x = x ^ (x >> _U32(4))
    x = x * _U32(0x27D4EB2D)
    x = x ^ (x >> _U32(15))
    return x


def pcg_hash(x):
    """PCG-family output permutation (O'Neill); one round of LCG + xsh-rr."""
    x = jnp.asarray(x, _U32)
    state = x * _U32(747796405) + _U32(2891336453)
    word = ((state >> ((state >> _U32(28)) + _U32(4))) ^ state) * _U32(277803737)
    return (word >> _U32(22)) ^ word


def _to_unit_float(bits):
    # take top 24 bits -> [0,1) with full float32 mantissa coverage
    return (bits >> _U32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


class RaySampler:
    """Per-lane uniform sampler.

    state: uint32 array of shape [N]. Each `next1/next2/next3` call advances
    the state by one LCG step per draw and returns uniforms in [0,1).
    Functional style: methods return (new_state, draws) so it can live inside
    lax.while_loop carries.
    """

    @staticmethod
    def init(frame_hash, lane_ids):
        """Seed state; analog of curand_init(hashedframe + threadId)."""
        return pcg_hash(jnp.asarray(frame_hash, _U32) + lane_ids.astype(_U32))

    @staticmethod
    def next(state):
        new_state = state * _U32(747796405) + _U32(2891336453)
        word = ((new_state >> ((new_state >> _U32(28)) + _U32(4))) ^ new_state) * _U32(277803737)
        word = (word >> _U32(22)) ^ word
        return new_state, _to_unit_float(word)

    @staticmethod
    def next_n(state, n):
        outs = []
        for _ in range(n):
            state, u = RaySampler.next(state)
            outs.append(u)
        return state, outs
