"""Loop subdivision surfaces, refined to a mesh at scene-build time.

Port of ``pbrt_tpu/shapes/loopsubdiv.py`` (reference: src/shapes/
loopsubdiv.{h,cpp}): the same numpy index-array rules, statement for
statement, so the refined triangles and their normals are the JAX
package's bit for bit. ``nlevels`` 1:4 splits, then the limit surface:
  - even interior vertex: (1 − n·β)·v + β·Σ neighbours, β = 3/16 for
    n = 3, else 3/(8n); even boundary vertex: 3/4·v + 1/8·(its two
    boundary neighbours);
  - odd interior vertex: 3/8·(edge ends) + 1/8·(opposite vertices); odd
    boundary vertex: the edge's midpoint;
  - limit positions with γ = 1/(n + 3/(8β)), boundary 3/5·v + 1/5·(two
    boundary neighbours); area-weighted vertex normals.
"""

from __future__ import annotations

import numpy as np

from pbrt_torch.shapes.mesh import MeshData, compute_vertex_normals, to_world_points


def _beta(n: np.ndarray) -> np.ndarray:
    return np.where(n == 3, 3.0 / 16.0, 3.0 / (8.0 * n))


def _gamma(n: np.ndarray) -> np.ndarray:
    return 1.0 / (n + 3.0 / (8.0 * _beta(n)))


def _build_adjacency(F: np.ndarray, nv: int):
    """Returns (edge→faces map, per-vertex neighbor lists, boundary flags)."""
    edge_faces: dict[tuple, list] = {}
    neighbors: list[set] = [set() for _ in range(nv)]
    for fi, (a, b, c) in enumerate(F):
        for u, v in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            edge_faces.setdefault(key, []).append(fi)
            neighbors[int(u)].add(int(v))
            neighbors[int(v)].add(int(u))
    boundary_edge = {e for e, fs in edge_faces.items() if len(fs) == 1}
    boundary_vertex = np.zeros(nv, bool)
    for u, v in boundary_edge:
        boundary_vertex[u] = True
        boundary_vertex[v] = True
    return edge_faces, neighbors, boundary_edge, boundary_vertex


def _subdivide_once(P: np.ndarray, F: np.ndarray):
    nv = len(P)
    edge_faces, neighbors, boundary_edge, boundary_vertex = _build_adjacency(F, nv)

    # --- even (existing) vertices ---------------------------------------
    newP = np.zeros_like(P)
    # interior rule, vectorized where possible
    for vi in range(nv):
        nbrs = sorted(neighbors[vi])
        n = len(nbrs)
        if n == 0:
            newP[vi] = P[vi]
            continue
        if boundary_vertex[vi]:
            bn = [u for u in nbrs if (min(vi, u), max(vi, u)) in boundary_edge]
            if len(bn) == 2:
                newP[vi] = 0.75 * P[vi] + 0.125 * (P[bn[0]] + P[bn[1]])
            else:  # corner/non-manifold: keep
                newP[vi] = P[vi]
        else:
            b = float(_beta(np.asarray(n)))
            newP[vi] = (1.0 - n * b) * P[vi] + b * P[nbrs].sum(axis=0)

    # --- odd (edge) vertices ---------------------------------------------
    edge_index: dict[tuple, int] = {}
    edge_points = []
    # opposite-vertex lookup per (edge, face)
    face_verts = F
    for e, faces in edge_faces.items():
        u, v = e
        if e in boundary_edge:
            ep = 0.5 * (P[u] + P[v])
        else:
            opp = []
            for fi in faces[:2]:
                tri = face_verts[fi]
                o = [int(x) for x in tri if int(x) not in (u, v)]
                opp.append(o[0])
            ep = 0.375 * (P[u] + P[v]) + 0.125 * (P[opp[0]] + P[opp[1]])
        edge_index[e] = nv + len(edge_points)
        edge_points.append(ep)
    allP = np.vstack([newP, np.asarray(edge_points)])

    # --- new faces (1:4 split) --------------------------------------------
    newF = np.empty((len(F) * 4, 3), np.int64)
    for fi, (a, b, c) in enumerate(F):
        ab = edge_index[(min(a, b), max(a, b))]
        bc = edge_index[(min(b, c), max(b, c))]
        ca = edge_index[(min(c, a), max(c, a))]
        newF[4 * fi + 0] = (a, ab, ca)
        newF[4 * fi + 1] = (ab, b, bc)
        newF[4 * fi + 2] = (ca, bc, c)
        newF[4 * fi + 3] = (ab, bc, ca)
    return allP, newF


def _limit_surface(P: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Push vertices to Loop limit positions
    (reference: loopsubdiv.cpp:280-300)."""
    nv = len(P)
    _, neighbors, boundary_edge, boundary_vertex = _build_adjacency(F, nv)
    out = P.copy()
    for vi in range(nv):
        nbrs = sorted(neighbors[vi])
        n = len(nbrs)
        if n == 0:
            continue
        if boundary_vertex[vi]:
            bn = [u for u in nbrs if (min(vi, u), max(vi, u)) in boundary_edge]
            if len(bn) == 2:
                out[vi] = 0.2 * (P[bn[0]] + P[bn[1]]) + 0.6 * P[vi]
        else:
            g = float(_gamma(np.asarray(n)))
            out[vi] = (1.0 - n * g) * P[vi] + g * P[nbrs].sum(axis=0)
    return out


def refine_loopsubdiv(params, object_to_world, reverse_orientation=False) -> MeshData:
    """'loopsubdiv' shape → world-space mesh
    (reference: CreateLoopSubdivShape + LoopSubdiv::Refine)."""
    nlevels = params.find_one_int("nlevels", 3)
    P = params.find_points("P")
    idx = params.find_ints("indices")
    if P is None or idx is None:
        raise ValueError("loopsubdiv needs P and indices")
    pos = np.asarray(P, np.float64)
    faces = np.asarray(idx, np.int64).reshape(-1, 3)
    for _ in range(nlevels):
        pos, faces = _subdivide_once(pos, faces)
    pos = _limit_surface(pos, faces)
    world = to_world_points(pos, object_to_world).astype(np.float32)
    mesh = MeshData(
        positions=world,
        indices=faces.astype(np.int32),
        normals=None,
        uvs=None,
    )
    normals = compute_vertex_normals(mesh)
    if reverse_orientation:
        normals = -normals
    mesh.normals = normals
    return mesh
