"""NURBS surface → triangle mesh, refined on the host.

Port of ``pbrt_tpu/shapes/nurbs.py`` (reference: src/shapes/nurbs.cpp,
NURBS::Refine :230-290 and CreateNURBSShape :300-346): a (possibly
rational) B-spline surface diced on a 30 × 30 parametric grid, Cox–de
Boor basis matrices for all samples at once, analytic normals from the
rational derivatives. The same numpy statements as the JAX package's, so
the triangles, normals and uvs are equal bit for bit.
"""

from __future__ import annotations

import numpy as np

from pbrt_torch.shapes.mesh import MeshData, to_world_normals, to_world_points

DICE_U = 30
DICE_V = 30


def _basis_matrix(ts: np.ndarray, knots: np.ndarray, n: int, order: int):
    """Cox–de Boor: returns (len(ts), n) basis values and derivatives.

    n control points, degree = order-1, len(knots) == n + order."""
    deg = order - 1
    T = len(ts)
    # zeroth-degree basis: indicator of knot span (half-open; final span
    # closed so t == knots[-1] evaluates)
    N = np.zeros((T, len(knots) - 1), np.float64)
    for j in range(len(knots) - 1):
        lo, hi = knots[j], knots[j + 1]
        if hi > lo:
            inside = (ts >= lo) & (ts < hi)
            N[:, j] = inside
    # close the last non-empty span
    last = np.max(np.nonzero(knots[1:] > knots[:-1])[0]) if (knots[1:] > knots[:-1]).any() else 0
    N[ts >= knots[last + 1], :] = 0.0
    N[ts >= knots[last + 1], last] = 1.0

    dN = np.zeros((T, n), np.float64)
    for d in range(1, deg + 1):
        cols = len(knots) - 1 - d
        Nn = np.zeros((T, cols), np.float64)
        if d == deg:
            dN = np.zeros((T, cols), np.float64)
        for j in range(cols):
            den1 = knots[j + d] - knots[j]
            den2 = knots[j + d + 1] - knots[j + 1]
            t1 = (ts - knots[j]) / den1 if den1 > 0 else 0.0
            t2 = (knots[j + d + 1] - ts) / den2 if den2 > 0 else 0.0
            Nn[:, j] = t1 * N[:, j] + t2 * N[:, j + 1]
            if d == deg:
                g1 = d / den1 if den1 > 0 else 0.0
                g2 = d / den2 if den2 > 0 else 0.0
                dN[:, j] = g1 * N[:, j] - g2 * N[:, j + 1]
        N = Nn
    return N[:, :n], dN[:, :n]


def refine_nurbs(params, object_to_world, reverse_orientation=False) -> MeshData:
    nu = params.find_one_int("nu", -1)
    uorder = params.find_one_int("uorder", -1)
    uknots = np.asarray(params.find_floats("uknots"), np.float64)
    nv = params.find_one_int("nv", -1)
    vorder = params.find_one_int("vorder", -1)
    vknots = np.asarray(params.find_floats("vknots"), np.float64)
    if nu < 0 or uorder < 0 or nv < 0 or vorder < 0:
        raise ValueError("nurbs needs nu/uorder/uknots and nv/vorder/vknots")
    if len(uknots) != nu + uorder or len(vknots) != nv + vorder:
        raise ValueError("nurbs: knot count must be n + order")
    u0 = params.find_one_float("u0", float(uknots[uorder - 1]))
    u1 = params.find_one_float("u1", float(uknots[nu]))
    v0 = params.find_one_float("v0", float(vknots[vorder - 1]))
    v1 = params.find_one_float("v1", float(vknots[nv]))

    P = params.find_points("P")
    if P is not None:
        cp = np.concatenate(
            [np.asarray(P, np.float64).reshape(-1, 3), np.ones((nu * nv, 1))],
            axis=1,
        )
    else:
        Pw = params.find_floats("Pw")
        if Pw is None:
            raise ValueError("nurbs needs P or Pw")
        cp = np.asarray(Pw, np.float64).reshape(-1, 4)
        # homogeneous: premultiply xyz by w (pbrt stores Pw already weighted)
    if cp.shape[0] != nu * nv:
        raise ValueError(f"nurbs: expected {nu * nv} control points")
    # pbrt indexes the net as P[v*nu + u] (nurbs.cpp Refine loop)
    net = cp.reshape(nv, nu, 4)

    us = np.linspace(u0, u1, DICE_U)
    vs = np.linspace(v0, v1, DICE_V)
    Bu, dBu = _basis_matrix(us, uknots, nu, uorder)  # (U, nu)
    Bv, dBv = _basis_matrix(vs, vknots, nv, vorder)  # (V, nv)

    # homogeneous surface points S(v,u) = Bv · net · Buᵀ   (V, U, 4)
    S = np.einsum("vj,juk,iu->vik", Bv, net, Bu)
    Su = np.einsum("vj,juk,iu->vik", Bv, net, dBu)
    Sv = np.einsum("vj,juk,iu->vik", dBv, net, Bu)
    w = S[..., 3:4]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    pts = S[..., :3] / w
    # rational derivative: (Su_xyz - P·Su_w)/w
    dpdu = (Su[..., :3] - pts * Su[..., 3:4]) / w
    dpdv = (Sv[..., :3] - pts * Sv[..., 3:4]) / w
    n = np.cross(dpdu, dpdv)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(ln < 1e-12, 1.0, ln)
    if reverse_orientation:
        n = -n

    V, U = DICE_V, DICE_U
    uu, vv = np.meshgrid(
        (us - u0) / max(u1 - u0, 1e-12), (vs - v0) / max(v1 - v0, 1e-12)
    )
    uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(V - 1):
        for i in range(U - 1):
            a = j * U + i
            idx.append((a, a + 1, a + U + 1))
            idx.append((a, a + U + 1, a + U))
    positions = to_world_points(pts.reshape(-1, 3), object_to_world)
    normals = to_world_normals(n.reshape(-1, 3), object_to_world)
    return MeshData(
        positions=positions.astype(np.float32),
        indices=np.asarray(idx, np.int32),
        normals=normals.astype(np.float32),
        uvs=uvs,
    )
