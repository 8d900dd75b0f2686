"""Flatten a BVH into the traversal layout.

Role analog of the reference's CudaBVH Compact2 flattener
(src/CudaBVH.cpp:117-297), redesigned so one fixed-width row serves both
an inner node and a triangle (one fetch per traversal step in the CUDA
kernel and in the plain path). We emit ONE unified primitive stream:

  prims: float32 [K, 12]
    - inner-node row i (i < num_nodes):
        [c0.lo.x, c0.hi.x, c0.lo.y, c0.hi.y,
         c1.lo.x, c1.hi.x, c1.lo.y, c1.hi.y,
         c0.lo.z, c0.hi.z, c1.lo.z, c1.hi.z]
      (same quantity grouping as the reference's n0xy/n1xy/nz texels,
       src/CudaBVH.cpp:224-227)
    - triangle row r (r >= num_nodes): the 3x4 Woop-transformed triangle
      [m0 | m1 | m2] exactly as woopifyTri computes it
      (src/CudaBVH.cpp:301-328).

  meta: int32 [K, 2]
    - node row: (child0, child1) where an inner child is its node row index
      and a leaf child is ~(first triangle row)  [negative => leaf, the same
      sign convention as Compact2's ~triWoopOffset, src/CudaBVH.cpp:177]
    - triangle row: (attr_slot, is_last) where attr_slot indexes the
      attribute streams below and is_last marks the leaf's final triangle
      (fixed-shape replacement for the 0x80000000 terminator texel,
       src/CudaBVH.cpp:208-215).

Attribute streams (indexed by attr_slot, one entry per triangle *reference*):
  tri_pos  f32 [Kt, 9]  original corner positions (the load-bearing
                        "triDebug" stream used for barycentrics,
                        src/renderkernel.cu:440-466)
  tri_uv   f32 [Kt, 6]
  tri_nrm  f32 [Kt, 9]
  tri_mat  i32 [Kt]     material id (pre-resolved through triIndices so the
                        device needs one fewer indirection than
                        src/renderkernel.cu:567-568)
  tri_orig i32 [Kt]     original triangle index

Because node rows and triangle rows have identical width, the traversal inner
loop performs a single 12-float gather per lane per step and decodes it as
either a box pair or a Woop triangle depending on the cursor's sign.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bvh import BVHNode


def woopify(tri_verts: np.ndarray) -> np.ndarray:
    """Batch Woop transform: [T,3,3] corners -> [T,12] rows (m0|m1|m2).

    Matches woopifyTri (src/CudaBVH.cpp:301-328): build the affine matrix with
    columns (v0-v2, v1-v2, cross(v0-v2, v1-v2), v2), invert, then
    m0 = (inv[2,0..2], -inv[2,3]), m1 = inv row 0, m2 = inv row 1.
    Degenerate triangles get a row that can never produce a hit.
    """
    tv = np.asarray(tri_verts, np.float64)
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e0 = v0 - v2
    e1 = v1 - v2
    n = np.cross(e0, e1)
    A = np.stack([e0, e1, n], axis=-1)          # [T,3,3] linear part, columns
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-24
    A_safe = np.where(ok[:, None, None], A, np.eye(3)[None])
    Ainv = np.linalg.inv(A_safe)                # [T,3,3]
    # affine inverse: x_local = Ainv @ (x - v2) => translation = -Ainv @ v2
    t = -np.einsum("tij,tj->ti", Ainv, v2)      # [T,3]
    T = tv.shape[0]
    out = np.zeros((T, 12), np.float64)
    # m0 = (Ainv[2,0], Ainv[2,1], Ainv[2,2], -t[2])
    out[:, 0:3] = Ainv[:, 2, :]
    out[:, 3] = -t[:, 2]
    out[:, 4:7] = Ainv[:, 0, :]
    out[:, 7] = t[:, 0]
    out[:, 8:11] = Ainv[:, 1, :]
    out[:, 11] = t[:, 1]
    # degenerate: m0=(0,0,0,1) -> t = (1 - 0)/(dir.0)=inf -> always misses
    bad = ~ok
    out[bad] = 0.0
    out[bad, 3] = 1.0
    return out.astype(np.float32)


@dataclasses.dataclass
class FlatBVH:
    prims: np.ndarray      # [K,12] f32 unified stream
    meta: np.ndarray       # [K,2] i32
    num_nodes: int
    tri_pos: np.ndarray    # [Kt,9] f32
    tri_uv: np.ndarray     # [Kt,6] f32
    tri_nrm: np.ndarray    # [Kt,9] f32
    tri_mat: np.ndarray    # [Kt] i32
    tri_orig: np.ndarray   # [Kt] i32
    root_lo: np.ndarray
    root_hi: np.ndarray
    max_depth: int = 64    # inner-node depth; bounds the traversal stack

    @property
    def num_tri_slots(self):
        return int(self.tri_pos.shape[0])


def flatten_bvh(root: BVHNode, tri_index_array, tri_verts, tri_uv, tri_nrm,
                tri_mat) -> FlatBVH:
    """DFS-flatten (iterative stack, same traversal order as createCompact's
    stack loop) into the unified stream."""
    # handle a single-leaf root by wrapping it in a trivial inner node
    if root.is_leaf:
        wrapper = BVHNode(root.lo, root.hi, left=root, right=BVHNode(
            root.lo.copy(), root.hi.copy(), tri_start=root.tri_start,
            tri_end=root.tri_start))  # empty right leaf
        root = wrapper

    node_rows = []      # list of 12-float rows (filled later for children)
    node_meta = []      # (child0, child1)
    tri_slots = []      # original tri index per emitted slot
    tri_last = []

    # assign node indices in DFS order
    stack = [(root, 0)]
    node_rows.append(np.zeros(12, np.float32))
    node_meta.append([0, 0])

    while stack:
        node, idx = stack.pop()
        cidx = [0, 0]
        boxes = []
        for i, child in enumerate((node.left, node.right)):
            boxes.append((child.lo, child.hi))
            if not child.is_leaf:
                cidx[i] = len(node_rows)
                node_rows.append(np.zeros(12, np.float32))
                node_meta.append([0, 0])
                stack.append((child, cidx[i]))
            else:
                first_slot = len(tri_slots)
                n_tris = child.tri_end - child.tri_start
                if n_tris == 0:
                    # empty leaf: point at a dedicated always-miss slot; emit
                    # one degenerate triangle
                    tri_slots.append(-1)
                    tri_last.append(1)
                else:
                    for j in range(child.tri_start, child.tri_end):
                        tri_slots.append(int(tri_index_array[j]))
                        tri_last.append(0)
                    tri_last[-1] = 1
                cidx[i] = ~first_slot
        (l0, h0), (l1, h1) = boxes
        node_rows[idx] = np.array([
            l0[0], h0[0], l0[1], h0[1],
            l1[0], h1[0], l1[1], h1[1],
            l0[2], h0[2], l1[2], h1[2]], np.float32)
        node_meta[idx] = [cidx[0], cidx[1]]

    num_nodes = len(node_rows)
    Kt = len(tri_slots)
    slot_tri = np.array(tri_slots, np.int64)
    valid = slot_tri >= 0
    safe_tri = np.where(valid, slot_tri, 0)

    woop = woopify(np.asarray(tri_verts)[safe_tri])
    # degenerate rows for invalid slots
    woop[~valid] = 0.0
    woop[~valid, 3] = 1.0

    prims = np.concatenate([np.stack(node_rows), woop], axis=0).astype(np.float32)

    tmeta = np.zeros((Kt, 2), np.int32)
    tmeta[:, 0] = np.arange(Kt, dtype=np.int32)
    tmeta[:, 1] = np.array(tri_last, np.int32)

    # node meta: rebase leaf children (~slot) onto unified rows (~(num_nodes+slot))
    nmeta = np.array(node_meta, np.int64)
    is_leaf_child = nmeta < 0
    nmeta = np.where(is_leaf_child, ~(num_nodes + ~nmeta), nmeta)
    meta = np.concatenate([nmeta.astype(np.int32), tmeta], axis=0)

    tri_pos = np.asarray(tri_verts, np.float32)[safe_tri].reshape(Kt, 9)
    uv = np.asarray(tri_uv, np.float32)[safe_tri].reshape(Kt, 6)
    nrm = np.asarray(tri_nrm, np.float32)[safe_tri].reshape(Kt, 9)
    mat = np.asarray(tri_mat, np.int32)[safe_tri]
    mat = np.where(valid, mat, -1).astype(np.int32)
    orig = np.where(valid, slot_tri, -1).astype(np.int32)

    return FlatBVH(
        prims=prims, meta=meta, num_nodes=num_nodes,
        tri_pos=tri_pos, tri_uv=uv, tri_nrm=nrm, tri_mat=mat, tri_orig=orig,
        root_lo=np.asarray(root.lo, np.float32),
        root_hi=np.asarray(root.hi, np.float32),
        max_depth=root.max_depth(),
    )


def bfs_reorder_nodes(fb: FlatBVH) -> FlatBVH:
    """Renumber the NODE rows of the unified stream into breadth-first
    order (root stays row 0; triangle rows stay at num_nodes+slot — the
    tri-row addressing contract woop_geometric_normal and the attribute
    packers rely on).

    Why: steps concentrate at the top of the tree (every traversal starts
    at the root), but the DFS emission order scatters near-root nodes
    across the whole row space — BFS makes row index ~ tree depth, so the
    top levels, which every ray visits, share a few cache lines. (Its
    effect on the GPU kernel's cache hit rate is not measured.) Node
    order is semantically free: the cursor encodes rows directly and
    hit_slot is the attr slot, not the row."""
    n = fb.num_nodes
    nm = fb.meta[:n].astype(np.int64)
    order = np.empty(n, np.int64)
    # BFS via a preallocated queue (children appended in (c0, c1) order)
    order[0] = 0
    head, tail = 0, 1
    while head < tail:
        i = order[head]
        head += 1
        for c in (nm[i, 0], nm[i, 1]):
            if c >= 0:
                order[tail] = c
                tail += 1
    assert tail == n, "node graph must be a single tree rooted at row 0"
    perm = np.empty(n, np.int64)          # old row -> new row
    perm[order] = np.arange(n)
    new_nodes = fb.prims[:n][order]
    new_meta = nm[order].copy()
    inner = new_meta >= 0
    new_meta[inner] = perm[new_meta[inner]]
    prims = np.concatenate([new_nodes, fb.prims[n:]], axis=0)
    meta = np.concatenate([new_meta.astype(np.int32), fb.meta[n:]], axis=0)
    return dataclasses.replace(fb, prims=prims, meta=meta)


def flatten_mesh_bvh(mesh, platform=None, params=None, use_native=True):
    """Build + flatten in one go from a TriangleMesh. Uses the C++ builder
    when available (same algorithm, ~100x faster); falls back to the Python
    reference builder."""
    tv = mesh.tri_vertices()
    root = tri_idx = None
    if use_native:
        from .native_build import build_bvh_native
        res = build_bvh_native(tv, platform, params)
        if res is not None:
            root, tri_idx = res
    if root is None:
        from .bvh import build_bvh
        root, tri_idx, _ = build_bvh(tv, platform, params)
    fb = flatten_bvh(root, tri_idx, tv, mesh.uv, mesh.normals,
                     mesh.material_ids)
    return bfs_reorder_nodes(fb)
