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

The port's own addition, for the motion walks only (the JAX package has no
counterpart): ``time_boxes`` (M, 96), for each node row the box of each
child slot at shutter start and its shutter-end delta, slot-major as the
rows' box fields; the motion kernels lerp it by the ray's weight and
drop the children whose box the ray misses (``time_boxes``' docstring
holds the containment argument).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbrt_torch.accel.bvh import BVH

W_ROW = 80
LEAF_TRIS = 8
#: floats per time-box row: the 6 box fields at shutter start, then their
#: shutter-end deltas, each field 8 slots wide
W_TBOX = 96
#: the pad of a child's time box (``time_boxes``): this share of the largest
#: coordinate of its triangles, plus ``TBOX_PAD_TABLE`` of the table's
TBOX_PAD_NODE = 2.0 ** -10
TBOX_PAD_TABLE = 2.0 ** -16


@dataclasses.dataclass
class WideBVH:
    rows: np.ndarray            # (M, 80) f32 unified node/leaf table
    motion_rows: np.ndarray | None = None  # (M, 80) shutter-end deltas
    #: exact worst-case traversal stack need of THIS tree: ordered descent
    #: pushes ≤ children-1 entries per node, so the bound is
    #: max over root→node paths of Σ (n_children−1). Sizing the register
    #: to this makes overflow impossible (no dropped far subtrees).
    max_stack: int = 8
    #: (M, 96) f32 time boxes of each node row's children (``time_boxes``),
    #: with ``motion_rows`` only
    time_boxes: np.ndarray | None = None


def _node_refs(rows: np.ndarray, n: int, row_base: int) -> list[int]:
    """Node row ``n``'s valid child refs, node refs shifted back by
    ``row_base`` (leaf refs as they are)."""
    refs = rows[n, 48:56].astype(np.int64)
    valid = rows[n, 0:8] <= rows[n, 8:16]
    return [int(r) - row_base if r >= 0 else int(r) for r, v in zip(refs, valid) if v]


def _node_order(rows: np.ndarray, row_base: int) -> list[int]:
    """The node rows reachable from row 0, in DFS preorder (iterative:
    trees can exceed the recursion limit); every child after its parent."""
    order: list[int] = []
    seen = set()
    st = [0]
    while st:
        n = st.pop()
        if n in seen:
            continue
        seen.add(n)
        order.append(n)
        st.extend(r for r in _node_refs(rows, n, row_base) if r >= 0)
    return order


def _compute_max_stack(rows: np.ndarray, row_base: int = 0) -> int:
    """f(node) = (n_children−1) + max_k f(child_k); f(leaf) = 0. A table
    built at ``row_base`` holds node refs ``row_base`` on, so the walk
    shifts them back (the JAX package's follows them unshifted, which
    agrees at ``row_base`` 0: every table but a second instanced
    object's)."""
    memo: dict[int, int] = {}
    node_refs = lambda n: _node_refs(rows, n, row_base)
    order = _node_order(rows, row_base)
    for n in reversed(order):
        kids = node_refs(n)
        if not kids:
            memo[n] = 0
            continue
        memo[n] = (len(kids) - 1) + max(memo.get(r, 0) if r >= 0 else 0 for r in kids)
    return max(memo.get(0, 0), 1)


def _f32_down(x: np.ndarray) -> np.ndarray:
    """The largest float32 ≤ each float64 of ``x``."""
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) > x, np.nextafter(y, np.float32(-np.inf)), y)


def _f32_up(x: np.ndarray) -> np.ndarray:
    """The smallest float32 ≥ each float64 of ``x``."""
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) < x, np.nextafter(y, np.float32(np.inf)), y)


def time_boxes(rows: np.ndarray, motion_rows: np.ndarray, row_base: int = 0) -> np.ndarray:
    """(M, 96) f32: for node row n and child slot k, the child's box at
    shutter start (``[0:48)``, slot-major as the row's box fields) and its
    shutter-end delta (``[48:96)``), the motion kernels' time boxes.
    Every other slot and row holds an inverted box (lo 1e30, hi −1e30)
    with zero deltas.

    Built bottom-up from the leaf rows: each triangle's corners v0, v0 + e1
    and v0 + e2 at shutter start and at start + delta (float64, from the
    float32 rows), a leaf's box at each end the min / max over its valid
    prims, a node's over its children. Then, for a box of largest corner
    coordinate C (start or end, any axis) in a table of largest C_T,
    pad p = 2^-10 C + 2^-16 C_T; lo0 = the float32 at or below lo_start − p,
    dlo = the float32 at or below (lo_end − p) − lo0; hi alike, rounded up.

    Containment, for every weight tw in [0, 1] (``motion_weight`` clamps
    to it) and every float32 tw there:
    1. The corners move linearly in exact arithmetic, x(tw) = x0 + tw·dx,
       so their min over a child is concave in tw and lies at or above the
       chord (1 − tw)·lo_start + tw·lo_end; the chord of a node's box lies
       below its children's chords. lo0 + tw·dlo lies at or below that
       chord less p, as both of its ends do.
    2. The kernel lerps in float32, the product rounded, then added
       (-fmad=false): fl(a + fl(tw·b)) is within u·(|a| + 2|b|)·(1 + u) of
       a + tw·b (u = 2^-24). The box corner's error is so bounded by
       u·(|lo0| + 2|dlo|) and a triangle corner's, V0 + E1 with V0 and E1
       each lerped in float32 by the leaf step, by u·(|v0| + 2|dv0| + |e1|
       + 2|de1|); with every coordinate, edge and delta within a few C,
       both together stay under 2^-19 C, far inside p.
    So the lerped box holds every point V0 + b1·E1 + b2·E2 (b1, b2 ≥ 0,
    b1 + b2 ≤ 1) of every lerped triangle of the child, at least
    p − 2^-19 C inside each face: every point Möller–Trumbore can accept.
    The rest of the pad is for the slab test's rounding (≈ 3u·|lo − o| of
    position per axis: covered for ray origins within ~40 C_T of the
    table's origin) and for Möller–Trumbore's own: its t puts the point
    o + t·d within ~12u·|o − v0|·|d||e1||e2| / |det| of the accepted
    point, covered while |det| stays above ~1.5e-3 |d||e1||e2| (a ray
    farther than ~0.1° from the triangle's plane, at |o − v0| ≈ C). A
    ray that Möller–Trumbore accepts only through its rounding (its det
    within the noise of e1·(d × e2), a ray in or almost in the plane) is
    covered only as far as p reaches. Within those limits a child whose
    time box the ray misses on [tmin, inf) holds no triangle the walk
    would accept, whatever t_best: dropping it changes neither t, prim,
    b1, b2 nor the stack the walk returns to, and an any-hit walk's first
    hit lies outside it (``traverse_cuda``'s culled walk)."""
    rows = np.asarray(rows, np.float32)
    motion_rows = np.asarray(motion_rows, np.float32)
    M = rows.shape[0]
    f64 = lambda a: a.astype(np.float64)
    # every row read as a leaf: (M, 8 slots, 3 corners, 3 axes) at each end
    v0, e1, e2 = (f64(rows[:, 24 * i:24 * i + 24]).reshape(M, 3, 8).transpose(0, 2, 1)
                  for i in range(3))
    dv0, de1, de2 = (f64(motion_rows[:, 24 * i:24 * i + 24]).reshape(M, 3, 8)
                     .transpose(0, 2, 1) for i in range(3))
    start = np.stack([v0, v0 + e1, v0 + e2], 2)
    v0e = v0 + dv0
    end = np.stack([v0e, v0e + (e1 + de1), v0e + (e2 + de2)], 2)
    valid = (rows[:, 72:80] >= 0)[:, :, None, None]
    big = np.float64(np.inf)
    leaf = dict(lo_s=np.where(valid, start, big).min((1, 2)),
                hi_s=np.where(valid, start, -big).max((1, 2)),
                lo_e=np.where(valid, end, big).min((1, 2)),
                hi_e=np.where(valid, end, -big).max((1, 2)),
                c=np.where(valid, np.maximum(np.abs(start), np.abs(end)), 0.0).max((1, 2, 3)))
    order = _node_order(rows, row_base)
    # the largest coordinate of the table's triangles (its leaf rows)
    leaf_rows = sorted({-r - 1 - row_base for n in order for r in _node_refs(rows, n, row_base)
                        if r < 0})
    c_table = float(leaf["c"][leaf_rows].max()) if leaf_rows else 0.0
    node = {}  # node row -> (lo_s, hi_s, lo_e, hi_e, c) of its whole subtree
    out = np.zeros((M, W_TBOX), np.float32)
    out[:, 0:48] = np.repeat(np.float32([1e30, -1e30] * 3), 8)
    for n in reversed(order):
        refs = rows[n, 48:56].astype(np.int64)
        kids = []
        for j in range(LEAF_TRIS):
            if not rows[n, j] <= rows[n, 8 + j]:
                continue  # an empty slot keeps its inverted box
            r = int(refs[j])
            box = (node[r - row_base] if r >= 0
                   else tuple(leaf[k][-r - 1 - row_base] for k in ("lo_s", "hi_s", "lo_e",
                                                                   "hi_e", "c")))
            kids.append(box)
            lo_s, hi_s, lo_e, hi_e, c = box
            p = TBOX_PAD_NODE * c + TBOX_PAD_TABLE * c_table
            lo0 = _f32_down(lo_s - p)
            hi0 = _f32_up(hi_s + p)
            dlo = _f32_down((lo_e - p) - f64(lo0))
            dhi = _f32_up((hi_e + p) - f64(hi0))
            for ax in range(3):
                out[n, 16 * ax + j] = lo0[ax]
                out[n, 16 * ax + 8 + j] = hi0[ax]
                out[n, 48 + 16 * ax + j] = dlo[ax]
                out[n, 48 + 16 * ax + 8 + j] = dhi[ax]
        if not kids:  # no valid child: nothing to bound
            node[n] = (np.full(3, np.inf), np.full(3, -np.inf), np.full(3, np.inf),
                       np.full(3, -np.inf), 0.0)
            continue
        node[n] = (np.min([b[0] for b in kids], 0), np.max([b[1] for b in kids], 0),
                   np.min([b[2] for b in kids], 0), np.max([b[3] for b in kids], 0),
                   max(b[4] for b in kids))
    return out


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
    ``tri_motion`` gives ``motion_rows`` and the port's ``time_boxes``;
    ``row_base`` / ``pid_base`` offset the child refs and triangle ids
    (wide.py:88-242)."""
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
    tbox = time_boxes(out, mout, row_base) if mout is not None else None
    return WideBVH(rows=out, motion_rows=mout, max_stack=need, time_boxes=tbox)
