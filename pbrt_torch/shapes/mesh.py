"""Host-side triangle meshes (port of ``pbrt_tpu/shapes/mesh.py``;
reference: src/shapes/trianglemesh.cpp:330+ and heightfield.cpp). Vertices
and normals go to world space at build time, as the reference does
(trianglemesh.cpp:61). ``make_heightfield`` tessellates a heightfield's
z grid over [0, 1]², and ``compute_vertex_normals`` gives the refined
shapes (``loopsubdiv.py``) their area-weighted vertex normals; both are
numpy statement for statement as the JAX package's, so the triangles and
normals are the same bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    positions: np.ndarray  # (V, 3) world space, f32
    indices: np.ndarray  # (F, 3) int32
    normals: np.ndarray | None  # (V, 3) world-space shading normals
    uvs: np.ndarray | None  # (V, 2)


def to_world_points(P, m: np.ndarray) -> np.ndarray:
    """(V, 3) object-space points → world space, in float64."""
    return np.asarray(P, np.float64) @ m[:3, :3].T + m[:3, 3]


def to_world_normals(N: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(V, 3) normals by the inverse transpose of ``m``, normalized."""
    n = N @ np.linalg.inv(m)[:3, :3]
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def make_mesh(params, object_to_world: np.ndarray,
              reverse_orientation: bool = False) -> MeshData:
    P = params.find_points("P")
    idx = params.find_ints("indices")
    if P is None or idx is None:
        raise ValueError("trianglemesh needs P and indices")
    indices = np.asarray(idx, np.int32).reshape(-1, 3)
    N = params.find_normals("N")
    uv = params.find_floats("uv")
    if uv is None:
        uv = params.find_floats("st")
    uvs = np.asarray(uv, np.float32).reshape(-1, 2) if uv is not None else None
    positions = to_world_points(P, object_to_world)
    normals = None
    if N is not None:
        normals = to_world_normals(np.asarray(N, np.float64), object_to_world)
        if reverse_orientation:
            normals = -normals
    return MeshData(
        positions=positions.astype(np.float32), indices=indices,
        normals=None if normals is None else normals.astype(np.float32),
        uvs=uvs,
    )


def make_heightfield(params, object_to_world, reverse_orientation=False) -> MeshData:
    """A ``heightfield`` → its regular-grid mesh (mesh.py:81; reference:
    Heightfield::Refine): nu × nv heights ``Pz`` over [0, 1]², two
    triangles per cell, uv the grid position, no normals."""
    nu = params.find_one_int("nu", -1)
    nv = params.find_one_int("nv", -1)
    z = params.find_floats("Pz")
    if nu < 0 or nv < 0 or z is None or len(z) != nu * nv:
        raise ValueError("heightfield needs nu, nv, Pz[nu*nv]")
    xs, ys = np.meshgrid(np.linspace(0.0, 1.0, nu), np.linspace(0.0, 1.0, nv),
                         indexing="xy")
    pts = np.stack([xs.ravel(), ys.ravel(), np.asarray(z)], axis=-1)
    # cell (x, y): (v0, v1, v2) and (v0, v2, v3), row by row
    v0 = (np.arange(nv - 1)[:, None] * nu + np.arange(nu - 1)[None, :]).ravel()
    faces = np.stack([v0, v0 + 1, v0 + nu + 1, v0, v0 + nu + 1, v0 + nu], -1)
    return MeshData(
        positions=to_world_points(pts, object_to_world).astype(np.float32),
        indices=faces.reshape(-1, 3).astype(np.int32),
        normals=None,
        uvs=pts[:, :2].astype(np.float32),
    )


def compute_vertex_normals(mesh: MeshData) -> np.ndarray:
    """Area-weighted vertex normals (mesh.py:111), float32."""
    p = mesh.positions.astype(np.float64)
    i = mesh.indices
    fn = np.cross(p[i[:, 1]] - p[i[:, 0]], p[i[:, 2]] - p[i[:, 0]])
    vn = np.zeros_like(p)
    for k in range(3):
        np.add.at(vn, i[:, k], fn)
    ln = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(ln, 1e-20)).astype(np.float32)
