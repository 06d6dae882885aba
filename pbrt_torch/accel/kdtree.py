"""SAH kd-tree accelerator: host build into packed arrays.

Port of ``pbrt_tpu/accel/kdtree.py`` (reference: src/accelerators/
kdtreeaccel.{h,cpp}: the recursive SAH build over bounding-box edge events,
isectCost 80, traversalCost 1, emptyBonus 0.5, kdtreeaccel.cpp:180-218,
defaults :467). The same numpy statements as the JAX package's, so the
node, CSR and bound arrays are equal bit for bit. Nodes are flat arrays
(split plane, axis, above child; the below child is node + 1, the
reference's layout); a leaf names a range of the CSR primitive-id list.
The walk is ``accel/traverse_kd.py``'s: a (node, tmin, tmax) todo stack
per ray, a CUDA kernel on the card (``csrc/traverse_kd.cu``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: axis codes 0/1/2; 3 marks a leaf (same tag trick as the reference's
#: 2-bit flags field, kdtreeaccel.cpp:31-60)
KD_LEAF = 3


@dataclasses.dataclass
class KdTree:
    node_split: np.ndarray  # (N,) f32 split plane position
    node_axis: np.ndarray  # (N,) i32, KD_LEAF for leaves
    node_above: np.ndarray  # (N,) i32 above-child index (below = node+1)
    node_prim_off: np.ndarray  # (N,) i32 CSR offset (leaves)
    node_prim_cnt: np.ndarray  # (N,) i32 CSR count (leaves)
    prim_ids: np.ndarray  # (M,) i32
    world_lo: np.ndarray  # (3,)
    world_hi: np.ndarray  # (3,)


def build_kdtree(lo: np.ndarray, hi: np.ndarray, isect_cost: float = 80.0,
                 trav_cost: float = 1.0, empty_bonus: float = 0.5,
                 max_prims: int = 8, max_depth: int | None = None) -> KdTree:
    """SAH kd-tree over world-space primitive bounds (lo/hi: (P, 3)).

    Follows the reference's cost model and termination rules
    (kdtreeaccel.cpp:180-290): exact SAH over bbox-edge events per axis,
    retry axes in extent order, refine-failure counter, depth cap
    8 + 1.3·log2(P)."""
    P = len(lo)
    if max_depth is None:
        max_depth = int(np.round(8 + 1.3 * np.log2(max(P, 1) + 1)))

    splits, axes, aboves, offs, cnts = [], [], [], [], []
    leaf_ids: list[np.ndarray] = []  # each leaf's prims, in CSR order
    n_ids = [0]

    def add_leaf(prims):
        splits.append(0.0)
        axes.append(KD_LEAF)
        aboves.append(-1)
        offs.append(n_ids[0])
        cnts.append(len(prims))
        leaf_ids.append(prims)
        n_ids[0] += len(prims)
        return len(splits) - 1

    def build(prims, nlo, nhi, depth, bad_refines):
        n = len(prims)
        if n <= max_prims or depth >= max_depth:
            return add_leaf(prims)
        plo = lo[prims]
        phi = hi[prims]
        d = nhi - nlo
        inv_area = 1.0 / max(
            2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]), 1e-20
        )
        old_cost = isect_cost * n
        best = None  # (cost, axis, split_pos, n_below, below_mask, above_mask)
        for axis in np.argsort(-d):
            axis = int(axis)
            # edge events: starts (lo) and ends (hi), ends sort before
            # starts at equal positions (reference BoundEdge ordering)
            edges = np.concatenate([
                np.stack([plo[:, axis], np.zeros(n)], 1),   # type 0 = start
                np.stack([phi[:, axis], np.ones(n)], 1),    # type 1 = end
            ])
            order = np.lexsort((edges[:, 1] == 0, edges[:, 0]))
            ep = edges[order]
            n_below = np.cumsum(ep[:, 1] == 0)  # starts seen incl. current
            n_above = n - np.cumsum(ep[:, 1] == 1)  # ends not yet passed
            # candidate split at each edge position inside the node bounds
            pos = ep[:, 0]
            inside = (pos > nlo[axis]) & (pos < nhi[axis])
            # counts *at* the candidate: below = starts before this edge,
            # above = n - ends at-or-before (reference updates nBelow after
            # START edges and nAbove before END edges)
            nb = np.where(ep[:, 1] == 0, n_below - 1, n_below)
            na = np.where(ep[:, 1] == 1, n_above, n_above)
            o0, o1 = (axis + 1) % 3, (axis + 2) % 3
            area_b = 2 * (d[o0] * d[o1] + (pos - nlo[axis]) * (d[o0] + d[o1]))
            area_a = 2 * (d[o0] * d[o1] + (nhi[axis] - pos) * (d[o0] + d[o1]))
            pb = area_b * inv_area
            pa = area_a * inv_area
            eb = np.where((nb == 0) | (na == 0), empty_bonus, 0.0)
            cost = trav_cost + isect_cost * (1.0 - eb) * (pb * nb + pa * na)
            cost = np.where(inside, cost, np.inf)
            i = int(np.argmin(cost))
            if np.isfinite(cost[i]) and (
                best is None or cost[i] < best[0]
            ):
                split_pos = pos[i]
                below_mask = plo[:, axis] < split_pos
                above_mask = phi[:, axis] > split_pos
                # prims lying exactly on the plane go below (degenerate
                # flat prims; reference assigns via edge classification)
                flat = (~below_mask) & (~above_mask)
                below_mask = below_mask | flat
                best = (cost[i], axis, split_pos, below_mask, above_mask)
            if best is not None:
                break  # reference retries other axes only when none found
        if best is None:
            return add_leaf(prims)
        cost_i, axis, split_pos, below_mask, above_mask = best
        if cost_i > old_cost:
            bad_refines += 1
        if (cost_i > 4 * old_cost and n < 16) or bad_refines == 3:
            return add_leaf(prims)
        pb_ids = prims[below_mask]
        pa_ids = prims[above_mask]
        me = len(splits)
        splits.append(float(split_pos))
        axes.append(int(axis))
        aboves.append(-1)  # patched after below subtree is built
        offs.append(0)
        cnts.append(0)
        lo_b, hi_b = nlo.copy(), nhi.copy()
        hi_b[axis] = split_pos
        lo_a, hi_a = nlo.copy(), nhi.copy()
        lo_a[axis] = split_pos
        build(pb_ids, lo_b, hi_b, depth + 1, bad_refines)
        aboves[me] = build(pa_ids, lo_a, hi_a, depth + 1, bad_refines)
        return me

    if P == 0:
        add_leaf(np.asarray([], np.int64))
        wlo = np.zeros(3)
        whi = np.ones(3)
    else:
        wlo = lo.min(axis=0)
        whi = hi.max(axis=0)
        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, max_depth * 8 + 10000))
        try:
            build(np.arange(P, dtype=np.int64), wlo.astype(np.float64),
                  whi.astype(np.float64), 0, 0)
        finally:
            sys.setrecursionlimit(old_limit)

    return KdTree(
        node_split=np.asarray(splits, np.float32),
        node_axis=np.asarray(axes, np.int32),
        node_above=np.asarray(aboves, np.int32),
        node_prim_off=np.asarray(offs, np.int32),
        node_prim_cnt=np.asarray(cnts, np.int32),
        prim_ids=(np.concatenate(leaf_ids).astype(np.int32) if n_ids[0]
                  else np.zeros(1, np.int32)),
        world_lo=np.asarray(wlo, np.float32),
        world_hi=np.asarray(whi, np.float32),
    )
