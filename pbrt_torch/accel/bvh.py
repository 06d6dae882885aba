"""Binary BVH over primitive AABBs: SAH, middle or equal-counts splits.

Port of ``pbrt_tpu/accel/bvh.py`` (reference: src/accelerators/bvh.{h,cpp},
flattened depth-first). The SAH split is built by the port's own copy of
the JAX runtime's C++ builder (``csrc/bvh_builder.cpp``), compiled by
``utils/native.py`` with the same flags, so the tree — and the wide rows
collapsed from it — is the same; a failed build raises, there is no Python
fallback for it. The ``middle`` and ``equal`` splits (``splitmethod``,
bvh.py:159-166) are the JAX package's numpy build, statement for
statement, so their trees and wide rows are equal bit for bit too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np

from pbrt_torch.utils import native

MAX_PRIMS_IN_NODE = 4
TRAVERSAL_COST = 0.125


@dataclasses.dataclass
class BVH:
    node_lo: np.ndarray  # (N, 3) f32
    node_hi: np.ndarray  # (N, 3) f32
    node_second: np.ndarray  # (N,) i32: interior → second child; leaf → prim offset
    node_count: np.ndarray  # (N,) i32: 0 = interior, >0 = leaf prim count
    node_axis: np.ndarray  # (N,) i32 split axis (interior)
    prim_order: np.ndarray  # (P,) i32 leaf-order permutation of primitive ids


SPLIT_METHODS = ("sah", "middle", "equal")


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              max_prims_in_node: int = MAX_PRIMS_IN_NODE, method: str = "sah") -> BVH:
    """A build over (P, 3) primitive bounds, split by ``method``."""
    n = len(prim_lo)
    if n == 0:
        raise ValueError("build_bvh needs at least one primitive")
    if method not in SPLIT_METHODS:
        raise ValueError(f"unknown BVH split method {method!r}")
    if method != "sah":
        return _build_split(prim_lo, prim_hi, method, max_prims_in_node)
    lib = native.bvh_lib()
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    max_nodes = 2 * n
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    node_second = np.empty(max_nodes, np.int32)
    node_count = np.empty(max_nodes, np.int32)
    node_axis = np.empty(max_nodes, np.int32)
    prim_order = np.empty(n, np.int32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n_nodes = lib.pbrt_torch_build_bvh(
        fp(lo), fp(hi), n, max_prims_in_node, ctypes.c_float(TRAVERSAL_COST),
        fp(node_lo), fp(node_hi), ip(node_second), ip(node_count),
        ip(node_axis), ip(prim_order), max_nodes,
    )
    if n_nodes < 0:
        raise RuntimeError("native BVH build overflowed its node arrays")
    return BVH(
        node_lo=node_lo[:n_nodes].copy(), node_hi=node_hi[:n_nodes].copy(),
        node_second=node_second[:n_nodes].copy(),
        node_count=node_count[:n_nodes].copy(),
        node_axis=node_axis[:n_nodes].copy(), prim_order=prim_order,
    )


def _build_split(prim_lo, prim_hi, method: str, max_prims_in_node: int) -> BVH:
    """The ``middle`` / ``equal`` build (bvh.py:95-235): a node splits its
    primitives' centroids on their widest axis, at the axis' midpoint or
    at the median in stable order; a single primitive is a leaf, and so
    are ≤ ``max_prims_in_node`` coincident centroids."""
    n = len(prim_lo)
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    centroids = 0.5 * (prim_lo + prim_hi)
    lo_list, hi_list, second_list, count_list, axis_list = [], [], [], [], []
    order: list[int] = []

    def build(idx: np.ndarray) -> int:
        me = len(lo_list)
        lo_list.append(prim_lo[idx].min(axis=0))
        hi_list.append(prim_hi[idx].max(axis=0))
        second_list.append(0)
        count_list.append(0)
        axis_list.append(0)

        def make_leaf():
            second_list[me] = len(order)
            count_list[me] = len(idx)
            order.extend(int(i) for i in idx)

        if len(idx) <= 1:
            make_leaf()
            return me
        c = centroids[idx]
        clo, chi = c.min(axis=0), c.max(axis=0)
        axis = int(np.argmax(chi - clo))
        axis_list[me] = axis
        if chi[axis] - clo[axis] < 1e-12:
            if len(idx) <= max_prims_in_node:
                make_leaf()
                return me
            h = len(idx) // 2
            build(idx[:h])
            second_list[me] = build(idx[h:])
            return me
        if method == "middle":
            mask = c[:, axis] < 0.5 * (clo[axis] + chi[axis])
            if mask.all() or not mask.any():
                mask = np.zeros(len(idx), bool)
                mask[: len(idx) // 2] = True
            left, right = idx[mask], idx[~mask]
        else:
            srt = idx[np.argsort(c[:, axis], kind="stable")]
            h = len(srt) // 2
            left, right = srt[:h], srt[h:]
        build(left)  # first child = me + 1 (depth first)
        second_list[me] = build(right)
        return me

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)
    return BVH(
        node_lo=np.asarray(lo_list, np.float32), node_hi=np.asarray(hi_list, np.float32),
        node_second=np.asarray(second_list, np.int32),
        node_count=np.asarray(count_list, np.int32),
        node_axis=np.asarray(axis_list, np.int32), prim_order=np.asarray(order, np.int32),
    )
