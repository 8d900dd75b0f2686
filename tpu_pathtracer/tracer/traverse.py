"""BVH traversal + Woop triangle intersection: the plain (pure-JAX) path.

Functional redesign of the reference's Aila/Laine "Kepler" while-while
traversal (intersectBVHandTriangles, src/renderkernel.cu:136-419) as a
whole-array program. It is the CPU path and the reference that the CUDA
kernel (ops/traverse.cu, the GPU path) is checked against:

* The CUDA kernel keeps a per-thread stack and diverges between the node
  loop and the triangle loop. Here every lane runs a *uniform step
  machine*: each iteration advances each lane's cursor by exactly one
  primitive — an inner node (two slab tests, push/pop) or one Woop
  triangle test — selected by the cursor's sign. Because node rows and
  triangle rows live in one unified (K,16) array (accel/flatten.py,
  pack_stream), each step costs ONE row gather regardless of which kind of
  work the lane does.

* The traversal stack is an (S, N) int32 shift register (push/pop are
  lane-wise selects between shifted copies); S matches the reference's
  STACK_SIZE=64 (src/renderkernel.cu:41) or the tree's depth + 2.

* Same semantics: tmin slab clamping (spanBeginKepler), nearer-child-first
  ordering with far-child push (src/renderkernel.cu:266-278), anyHit early
  termination for shadow rays (src/renderkernel.cu:382-385), and the exact
  Woop intersection tests (src/renderkernel.cu:337-396).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

SENTINEL = jnp.int32(0x76543210)  # same sentinel as src/renderkernel.cu:42
STACK_DEPTH = 64


def _ray_precompute(raydir):
    """ooeps-guarded inverse direction (src/renderkernel.cu:189-192)."""
    ooeps = jnp.float32(2.0 ** -80)
    d = jnp.where(jnp.abs(raydir) > ooeps, raydir,
                  jnp.where(raydir >= 0, ooeps, -ooeps))
    return 1.0 / d


def pack_stream(prims, meta):
    """Pack the (K,12) f32 prim rows and (K,2) i32 meta into one (K,16) f32
    array (meta bitcast into columns 12:14) so traversal needs exactly ONE
    row fetch per step: four 16-byte loads in the CUDA kernel, one gather
    per lane in the plain path. Columns 14:16 are zero padding to the
    64-byte row."""
    import numpy as np
    K = prims.shape[0]
    packed = np.zeros((K, 16), np.float32)
    packed[:, :12] = np.asarray(prims, np.float32)
    packed[:, 12:14] = np.asarray(meta, np.int32).view(np.float32)
    return packed


def intersect_scene(prims, meta, num_nodes, orig, raydir, tmin, tmax,
                    anyhit=False, stack_depth=STACK_DEPTH, active=None,
                    packed=None, tile_size=16384):
    """Trace rays against the flattened BVH.

    prims: [K,12] f32, meta: [K,2] i32 (see accel/flatten.py for layout);
    or pass `packed` [K,16] from pack_stream (preferred — single gather).
    orig, raydir: [N,3]; tmin, tmax: scalar or [N].
    Returns (hit_slot [N] i32 — attribute slot of closest hit or -1,
             hit_t [N] f32).

    Notes:
    * One (K,16) row gather per lane per step (node boxes / Woop triangle +
      bitcast meta share the row).
    * The traversal stack is a shift register laid out (S, N): push/pop are
      lane-wise selects between shifted copies — pure elementwise work
      instead of per-lane dynamic indexing into an (N,S) stack.
    * tile_size: rays are processed in chunks of this many via lax.map, so
      each chunk's while_loop stops at its own slowest ray instead of the
      slowest ray of the whole batch; None traces all rays in one loop.
    * `stack_depth` should be the BVH's max_depth + 2 (FlatBVH.max_depth);
      the default matches the reference's STACK_SIZE=64.
    """
    N = orig.shape[0]
    if packed is None:
        pcols = jnp.concatenate([
            jnp.asarray(prims, jnp.float32),
            jax.lax.bitcast_convert_type(jnp.asarray(meta, jnp.int32),
                                         jnp.float32),
            jnp.zeros((prims.shape[0], 2), jnp.float32)], axis=1)
    else:
        pcols = packed

    if tile_size is not None and N > tile_size:
        T = tile_size
        n_tiles = -(-N // T)
        pad = n_tiles * T - N

        def pad_to(x, fill=0):
            if pad == 0:
                return x
            cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, cfg, constant_values=fill)

        tmin_a = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (N,))
        tmax_a = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (N,))
        act = jnp.ones((N,), bool) if active is None else active
        xs = (
            pad_to(orig).reshape(n_tiles, T, 3),
            pad_to(raydir, 1.0).reshape(n_tiles, T, 3),
            pad_to(tmin_a).reshape(n_tiles, T),
            pad_to(tmax_a).reshape(n_tiles, T),
            pad_to(act, False).reshape(n_tiles, T),
        )

        def one_tile(args):
            o, d, tn, tx, ac = args
            return _intersect_tile(pcols, o, d, tn, tx, anyhit, stack_depth,
                                   ac)

        slot, t = jax.lax.map(one_tile, xs)
        return slot.reshape(-1)[:N], t.reshape(-1)[:N]

    act = active if active is not None else jnp.ones((N,), bool)
    tmin_a = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (N,))
    tmax_a = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (N,))
    return _intersect_tile(pcols, orig, raydir, tmin_a, tmax_a, anyhit,
                           stack_depth, act)


def _intersect_tile(pcols, orig, raydir, tmin, tmax, anyhit, stack_depth,
                    active):
    N = orig.shape[0]

    def fetch(row):
        return jnp.take(pcols, row, axis=0)

    idir = _ray_precompute(raydir)
    ood = orig * idir

    ox, oy, oz = orig[:, 0], orig[:, 1], orig[:, 2]
    dx, dy, dz = raydir[:, 0], raydir[:, 1], raydir[:, 2]
    idx_, idy, idz = idir[:, 0], idir[:, 1], idir[:, 2]
    oodx, oody, oodz = ood[:, 0], ood[:, 1], ood[:, 2]

    stack = jnp.full((stack_depth, N), SENTINEL, jnp.int32)
    cur = jnp.where(active, jnp.zeros((N,), jnp.int32), SENTINEL)
    hit_slot = jnp.full((N,), -1, jnp.int32)
    hit_t = tmax

    def cond(state):
        cur, *_ = state
        return jnp.any(cur != SENTINEL)

    def body(state):
        cur, stack, hit_slot, hit_t = state
        done = cur == SENTINEL
        is_node = (cur >= 0) & ~done
        is_tri = cur < 0

        row = jnp.where(is_tri, ~cur, jnp.where(is_node, cur, 0))
        pm = fetch(row)                        # [N,16] the ONLY gather
        p = pm[:, :12]
        md = jax.lax.bitcast_convert_type(pm[:, 12:14], jnp.int32)

        # ---- inner-node work: two slab tests ----
        c0lox = p[:, 0] * idx_ - oodx
        c0hix = p[:, 1] * idx_ - oodx
        c0loy = p[:, 2] * idy - oody
        c0hiy = p[:, 3] * idy - oody
        c1lox = p[:, 4] * idx_ - oodx
        c1hix = p[:, 5] * idx_ - oodx
        c1loy = p[:, 6] * idy - oody
        c1hiy = p[:, 7] * idy - oody
        c0loz = p[:, 8] * idz - oodz
        c0hiz = p[:, 9] * idz - oodz
        c1loz = p[:, 10] * idz - oodz
        c1hiz = p[:, 11] * idz - oodz
        c0min = jnp.maximum(jnp.maximum(jnp.minimum(c0lox, c0hix),
                                        jnp.minimum(c0loy, c0hiy)),
                            jnp.maximum(jnp.minimum(c0loz, c0hiz), tmin))
        c0max = jnp.minimum(jnp.minimum(jnp.maximum(c0lox, c0hix),
                                        jnp.maximum(c0loy, c0hiy)),
                            jnp.minimum(jnp.maximum(c0loz, c0hiz), hit_t))
        c1min = jnp.maximum(jnp.maximum(jnp.minimum(c1lox, c1hix),
                                        jnp.minimum(c1loy, c1hiy)),
                            jnp.maximum(jnp.minimum(c1loz, c1hiz), tmin))
        c1max = jnp.minimum(jnp.minimum(jnp.maximum(c1lox, c1hix),
                                        jnp.maximum(c1loy, c1hiy)),
                            jnp.minimum(jnp.maximum(c1loz, c1hiz), hit_t))
        trav0 = c0min <= c0max
        trav1 = c1min <= c1max
        child0 = md[:, 0]
        child1 = md[:, 1]
        both = trav0 & trav1
        swap = both & (c1min < c0min)
        near = jnp.where(swap, child1, child0)
        far = jnp.where(swap, child0, child1)
        one = jnp.where(trav0, child0, child1)
        node_next = jnp.where(both, near, one)
        node_push = is_node & both
        node_pop = is_node & ~trav0 & ~trav1

        # ---- triangle work: Woop unit-triangle test ----
        m0x, m0y, m0z, m0w = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        m1x, m1y, m1z, m1w = p[:, 4], p[:, 5], p[:, 6], p[:, 7]
        m2x, m2y, m2z, m2w = p[:, 8], p[:, 9], p[:, 10], p[:, 11]
        Oz = m0w - ox * m0x - oy * m0y - oz * m0z
        invDz = 1.0 / (dx * m0x + dy * m0y + dz * m0z)
        t = Oz * invDz
        Oxx = m1w + ox * m1x + oy * m1y + oz * m1z
        Dxx = dx * m1x + dy * m1y + dz * m1z
        u = Oxx + t * Dxx
        Oyy = m2w + ox * m2x + oy * m2y + oz * m2z
        Dyy = dx * m2x + dy * m2y + dz * m2z
        v = Oyy + t * Dyy
        tri_hit = is_tri & (t > tmin) & (t < hit_t) \
            & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        hit_t = jnp.where(tri_hit, t, hit_t)
        hit_slot = jnp.where(tri_hit, md[:, 0], hit_slot)
        tri_last = md[:, 1] != 0
        tri_stop = is_tri & (tri_last | (tri_hit if anyhit else jnp.zeros_like(tri_last)))
        tri_pop = tri_stop
        tri_next = cur - 1  # ~(row+1) == ~row - 1

        # ---- shift-register stack: push = shift down + new top, pop =
        # shift up. Pure elementwise selects on an (S, N) carry. ----
        need_pop = node_pop | tri_pop
        if anyhit:
            need_pop = need_pop & ~tri_hit
            node_push = node_push & ~tri_hit
        popped_cur = stack[0]  # SENTINEL when empty -> lane done

        new_cur = jnp.where(
            is_node,
            jnp.where(node_pop, popped_cur, node_next),
            jnp.where(is_tri,
                      jnp.where(tri_pop, popped_cur, tri_next),
                      cur))
        if anyhit:
            new_cur = jnp.where(tri_hit, SENTINEL, new_cur)

        pushed = jnp.concatenate([far[None], stack[:-1]], axis=0)
        popped = jnp.concatenate(
            [stack[1:], jnp.full((1, N), SENTINEL, jnp.int32)], axis=0)
        stack = jnp.where(node_push[None], pushed,
                          jnp.where(need_pop[None], popped, stack))

        return new_cur, stack, hit_slot, hit_t

    cur, stack, hit_slot, hit_t = jax.lax.while_loop(
        cond, body, (cur, stack, hit_slot, hit_t))
    return hit_slot, hit_t


def woop_geometric_normal(prims, num_nodes, hit_slot):
    """Geometric normal of the hit triangle = cross(m1.xyz, m2.xyz)
    (src/renderkernel.cu:392); gathered post-traversal from the unified
    stream. hit_slot -1 lanes return zeros."""
    safe = jnp.maximum(hit_slot, 0)
    row = num_nodes + safe
    p = jnp.take(prims, row, axis=0)
    n = jnp.cross(p[:, 4:7], p[:, 8:11])
    return jnp.where((hit_slot >= 0)[:, None], n, 0.0)


def brute_force_intersect(tri_verts, orig, raydir, tmin, tmax):
    """Reference oracle for tests: Möller-Trumbore over all triangles
    (numpy, O(N*T)). Returns (hit_tri [N], hit_t [N])."""
    import numpy as np
    o = np.asarray(orig, np.float64)[:, None, :]
    d = np.asarray(raydir, np.float64)[:, None, :]
    v0 = np.asarray(tri_verts, np.float64)[None, :, 0, :]
    v1 = np.asarray(tri_verts, np.float64)[None, :, 1, :]
    v2 = np.asarray(tri_verts, np.float64)[None, :, 2, :]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, -1)
    inv_det = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o - v0
    u = np.sum(tvec * pvec, -1) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.sum(d * qvec, -1) * inv_det
    t = np.sum(e2 * qvec, -1) * inv_det
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t > tmin) & (t < tmax)
    t = np.where(ok, t, np.inf)
    best = np.argmin(t, axis=1)
    best_t = t[np.arange(t.shape[0]), best]
    hit = np.isfinite(best_t)
    return np.where(hit, best, -1), np.where(hit, best_t, np.asarray(tmax))
