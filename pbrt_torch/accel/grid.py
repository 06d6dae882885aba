"""Uniform-grid accelerator: host build into packed CSR voxel lists.

Port of ``pbrt_tpu/accel/grid.py`` (reference: src/accelerators/grid.
{h,cpp}: 3·∛P voxels per unit distance along the longest extent, at most
64 per axis, grid.cpp:31-45; each primitive binned into every voxel its
bound overlaps). The same numpy statements as the JAX package's, so the
voxel offsets, counts and primitive ids are equal bit for bit. The walk is
``accel/traverse_kd.py``'s 3D-DDA, a CUDA kernel on the card
(``csrc/traverse_kd.cu``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class UniformGrid:
    dims: tuple  # (nx, ny, nz) static
    voxel_off: np.ndarray  # (nx*ny*nz,) i32 CSR offsets
    voxel_cnt: np.ndarray  # (nx*ny*nz,) i32
    prim_ids: np.ndarray  # (M,) i32
    world_lo: np.ndarray  # (3,)
    world_hi: np.ndarray  # (3,)


def build_grid(lo: np.ndarray, hi: np.ndarray) -> UniformGrid:
    """Bin world-space primitive bounds into a uniform voxel grid."""
    P = len(lo)
    if P == 0:
        return UniformGrid(
            dims=(1, 1, 1), voxel_off=np.zeros(1, np.int32),
            voxel_cnt=np.zeros(1, np.int32), prim_ids=np.zeros(1, np.int32),
            world_lo=np.zeros(3, np.float32), world_hi=np.ones(3, np.float32),
        )
    wlo = lo.min(axis=0)
    whi = hi.max(axis=0)
    delta = np.maximum(whi - wlo, 1e-6)
    max_ext = delta.max()
    # reference: int cubeRoot = 3 * P^(1/3); voxelsPerUnitDist =
    # cubeRoot / maxExtent; dims clamped to [1, 64] (grid.cpp:31-45)
    vpud = 3.0 * np.cbrt(P) / max_ext
    dims = np.clip((delta * vpud).round().astype(np.int64), 1, 64)
    nx, ny, nz = (int(d) for d in dims)
    width = delta / dims
    inv_w = 1.0 / width

    def vox(p, axis):
        return np.clip(((p - wlo[axis]) * inv_w[axis]).astype(np.int64), 0,
                       dims[axis] - 1)

    v0 = np.stack([vox(lo[:, a], a) for a in range(3)], 1)  # (P, 3)
    v1 = np.stack([vox(hi[:, a], a) for a in range(3)], 1)
    # scatter each prim into all overlapped voxels, x slowest and z fastest
    # within a prim, prims in order (the JAX package's per-prim meshgrid
    # loop, vectorized: the same entries in the same order)
    counts = np.zeros(nx * ny * nz, np.int64)
    ext = v1 - v0 + 1
    span = ext.prod(axis=1)
    pp = np.repeat(np.arange(P, dtype=np.int64), span)
    j = np.arange(len(pp), dtype=np.int64) - np.repeat(np.cumsum(span) - span, span)
    sy, sz = ext[pp, 1], ext[pp, 2]
    gx = v0[pp, 0] + j // (sy * sz)
    gy = v0[pp, 1] + (j // sz) % sy
    gz = v0[pp, 2] + j % sz
    vv = gz + nz * (gy + ny * gx)
    order = np.argsort(vv, kind="stable")
    vv = vv[order]
    pp = pp[order]
    np.add.at(counts, vv, 1)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return UniformGrid(
        dims=(nx, ny, nz),
        voxel_off=offs.astype(np.int32),
        voxel_cnt=counts.astype(np.int32),
        prim_ids=pp.astype(np.int32) if len(pp) else np.zeros(1, np.int32),
        world_lo=np.asarray(wlo, np.float32),
        world_hi=np.asarray(whi, np.float32),
    )
