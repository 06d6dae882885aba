"""8-wide BVH row table (host build, numpy) — port of ``pbrt_tpu/accel/wide.py``.

Same collapse as the JAX package, statement for statement, so both packages
emit the same rows bit for bit from the same binary SAH tree (reference
semantics: BVHAccel, src/accelerators/bvh.cpp:105-200).

Row layout (W = 80 float32, every field an 8-wide block):
  node row:  [0:8) lo_x  [8:16) hi_x  [16:24) lo_y  [24:32) hi_y
             [32:40) lo_z [40:48) hi_z [48:56) child ref  [56:80) pad
  leaf row:  [0:8) v0_x [8:16) v0_y [16:24) v0_z
             [24:32) e1_x [32:40) e1_y [40:48) e1_z
             [48:56) e2_x [56:64) e2_y [64:72) e2_z
             [72:80) global triangle ids (exact-integer f32, -1 pad)

Child ref encoding (exact small integers in f32): ref >= 0 is a node row,
ref < 0 the leaf row -(ref+1). Empty child slots carry an inverted box
(lo=+1e30, hi=-1e30) so the slab test never reports them.

Motion blur: ``motion_rows`` (M, 80) holds each row's shutter-end deltas
in the same slot-major layout, the triangles' [v0, e1, e2] deltas in a
leaf row and zeros elsewhere (node rows, ids, pads); the traversal lerps
``row + tw * delta``. Instancing: ``row_base`` / ``pid_base`` offset the
child refs and triangle ids, so several objects' tables concatenate into
one shared table.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbrt_torch.accel.bvh import BVH

W_ROW = 80
LEAF_TRIS = 8


@dataclasses.dataclass
class WideBVH:
    rows: np.ndarray            # (M, 80) f32 unified node/leaf table
    motion_rows: np.ndarray | None = None  # (M, 80) shutter-end deltas
    #: exact worst-case traversal stack need of THIS tree: ordered descent
    #: pushes ≤ children-1 entries per node, so the bound is
    #: max over root→node paths of Σ (n_children−1). Sizing the register
    #: to this makes overflow impossible (no dropped far subtrees).
    max_stack: int = 8


def _compute_max_stack(rows: np.ndarray, row_base: int = 0) -> int:
    """f(node) = (n_children−1) + max_k f(child_k); f(leaf) = 0. A table
    built at ``row_base`` holds node refs ``row_base`` on, so the walk
    shifts them back (the JAX package's follows them unshifted, which
    agrees at ``row_base`` 0: every table but a second instanced
    object's)."""
    memo: dict[int, int] = {}

    def node_refs(n):
        refs = rows[n, 48:56].astype(np.int64)
        valid = rows[n, 0:8] <= rows[n, 8:16]
        return [int(r) - row_base if r >= 0 else -1 for r, v in zip(refs, valid) if v]

    # iterative DFS (trees can exceed the recursion limit)
    order: list[int] = []
    seen = set()
    st = [0]
    while st:
        n = st.pop()
        if n in seen:
            continue
        seen.add(n)
        order.append(n)
        st.extend(r for r in node_refs(n) if r >= 0)
    for n in reversed(order):
        kids = node_refs(n)
        if not kids:
            memo[n] = 0
            continue
        memo[n] = (len(kids) - 1) + max(memo.get(r, 0) if r >= 0 else 0 for r in kids)
    return max(memo.get(0, 0), 1)


def build_wide_bvh(
    tree: BVH,
    tri_v0: np.ndarray,   # (T, 3)
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    tri_motion: np.ndarray | None = None,  # (T, 9) deltas of [v0, e1, e2]
    row_base: int = 0,
    pid_base: int = 0,
) -> WideBVH:
    """Collapse a binary BVH over triangles into the unified wide table.

    ``tree.prim_order`` must index triangles (the binary tree is built over
    triangles only; quadrics are tested densely outside the BVH).
    ``tri_motion`` gives ``motion_rows``; ``row_base`` / ``pid_base``
    offset the child refs and triangle ids (wide.py:88-242)."""
    second = tree.node_second
    count = tree.node_count
    lo = tree.node_lo
    hi = tree.node_hi
    order = tree.prim_order

    def surface_area(n):
        d = np.maximum(hi[n] - lo[n], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    # subtree prim counts (reverse order: children have higher indices than
    # parents in the depth-first layout)
    N = len(count)
    subtree = np.zeros(N, np.int64)
    for n in range(N - 1, -1, -1):
        if count[n] > 0:
            subtree[n] = count[n]
        else:
            subtree[n] = subtree[n + 1] + subtree[second[n]]

    rows: list[np.ndarray] = []
    motion: list[np.ndarray] = []

    def alloc() -> int:
        rows.append(None)
        motion.append(np.zeros(W_ROW, np.float32))
        return len(rows) - 1

    def collect_prims(bnode: int) -> list[int]:
        """All prim ids in a binary subtree (DFS)."""
        out, st = [], [bnode]
        while st:
            n = st.pop()
            if count[n] > 0:
                off = second[n]
                out.extend(int(order[off + j]) for j in range(count[n]))
            else:
                st.extend((n + 1, second[n]))
        return out

    def leaf_row(bnode: int) -> int:
        """Pack a whole binary subtree of <= LEAF_TRIS prims into one leaf
        row (SAH splits down to 1-2-prim binary leaves; absorbing the
        subtree here is what fills the 8 triangle slots)."""
        r = alloc()
        prims = collect_prims(bnode)
        assert len(prims) <= LEAF_TRIS
        row = np.zeros(W_ROW, np.float32)
        mrow = motion[r]
        row[72:80] = -1.0
        for j, t in enumerate(prims):
            for ax in range(3):
                row[8 * ax + j] = tri_v0[t][ax]
                row[24 + 8 * ax + j] = tri_e1[t][ax]
                row[48 + 8 * ax + j] = tri_e2[t][ax]
                if tri_motion is not None:
                    mrow[8 * ax + j] = tri_motion[t][ax]
                    mrow[24 + 8 * ax + j] = tri_motion[t][3 + ax]
                    mrow[48 + 8 * ax + j] = tri_motion[t][6 + ax]
            row[72 + j] = float(t + pid_base)
        rows[r] = row
        return r

    def is_leaf_slot(s: int) -> bool:
        return subtree[s] <= LEAF_TRIS

    def expand(bnode: int) -> list[int]:
        """Binary subtree root -> up to 8 slot roots (children of the wide
        node), greedily splitting the largest-SA splittable slot."""
        slots = [bnode + 1, second[bnode]]
        while len(slots) < 8:
            best, best_sa = -1, -1.0
            for i, s in enumerate(slots):
                if count[s] == 0 and not is_leaf_slot(s):
                    sa = surface_area(s)
                    if sa > best_sa:
                        best, best_sa = i, sa
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend((s + 1, second[s]))
        return slots

    # root handling: guarantee row 0 is a node row
    root_row = alloc()
    if count[0] > 0 or subtree[0] <= LEAF_TRIS:
        # whole scene fits one leaf: a 1-child node row pointing at it
        lr = leaf_row(0)
        row = np.full(W_ROW, 0.0, np.float32)
        row[0:8] = 1e30
        row[8:16] = -1e30
        row[16:24] = 1e30
        row[24:32] = -1e30
        row[32:40] = 1e30
        row[40:48] = -1e30
        row[0], row[8] = lo[0][0], hi[0][0]
        row[16], row[24] = lo[0][1], hi[0][1]
        row[32], row[40] = lo[0][2], hi[0][2]
        row[48:56] = 0.0
        row[48] = float(-(lr + row_base + 1))
        rows[root_row] = row
    else:
        work = [(root_row, 0)]
        while work:
            r, bnode = work.pop()
            slots = expand(bnode)
            row = np.zeros(W_ROW, np.float32)
            row[0:8] = 1e30
            row[8:16] = -1e30
            row[16:24] = 1e30
            row[24:32] = -1e30
            row[32:40] = 1e30
            row[40:48] = -1e30
            for j, s in enumerate(slots):
                row[0 + j], row[8 + j] = lo[s][0], hi[s][0]
                row[16 + j], row[24 + j] = lo[s][1], hi[s][1]
                row[32 + j], row[40 + j] = lo[s][2], hi[s][2]
                if count[s] > 0 or is_leaf_slot(s):
                    row[48 + j] = float(-(leaf_row(s) + row_base + 1))
                else:
                    c = alloc()
                    work.append((c, s))
                    row[48 + j] = float(c + row_base)
            rows[r] = row

    out = np.stack(rows).astype(np.float32)
    mout = np.stack(motion) if tri_motion is not None else None
    assert out.shape[0] < (1 << 24), "row index exceeds exact-f32 range"
    need = _compute_max_stack(out, row_base)
    # round up to a sublane multiple; floor of 8
    need = max(8, ((need + 7) // 8) * 8)
    return WideBVH(rows=out, motion_rows=mout, max_stack=need)
