"""Scene geometry on the device and batched ray intersection.

Port of ``pbrt_tpu/accel/intersect.py`` for the slice (reference:
Scene::Intersect / IntersectP over BVHAccel, src/accelerators/bvh.cpp:
105-200, Triangle::Intersect and Sphere::Intersect). Primitive ids are
global: [0, T) triangles, [T, T+Q) quadrics.

``intersect`` keeps the JAX contract of ``_traverse_wide_batch``: quadrics
are tested densely first (``quad_best``, torch ops) and their result seeds
``t_best`` so the tree prunes on it; the world triangles are found by the
wide traversal (``traverse_cuda.traverse``: the CUDA kernel on a card, its
plain version on the CPU), each row lerped by the ray's shutter weight
(``motion_weight``) in a motion scene; then, in a scene with instances,
the instance phase walks the shared object tables
(``traverse_cuda.traverse_instances``), seeded with that result, and
``Hit.inst`` names the instance of each hit. All six quadric types are
ported: sphere, cylinder, disk, cone, paraboloid and hyperboloid
(``prims.quadric_hits``). Under a kd-tree or grid (``accel_kind``) there
is no wide table and no dense quadric pass: ``traverse_kd`` walks every
primitive, quadrics in its leaves and voxels, as the JAX package's
``_traverse_kd_one`` / ``_traverse_grid_one`` do (intersect.py:1368-1393).

Motion blur is the JAX package's: per-triangle shutter-end deltas of
[v0, e1, e2] (and of the vertex normals) lerped by the ray's time, an
Embree-style vertex buffer, one motion interval per scene. Instancing:
the object-space triangles of objects used by at least two static
``ObjectInstance``s sit at [T_world, T) of the triangle tables, their
tables concatenated in ``inst_rows``, one instance-table row per use.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from pbrt_torch.accel import prims, traverse_cuda, traverse_kd
from pbrt_torch.accel.prims import (CONE, CYLINDER, DISK, HYPERBOLOID,  # noqa: F401
                                    PARABOLOID, SPHERE)
from pbrt_torch.core import geometry as geom

#: intersect calls that ran the world walk, those that ran the instance
#: phase, and those that walked a kd-tree or a grid (on a card, the
#: launches of ``traverse_cuda.WORLD_KERNELS``, of ``INSTANCE_KERNELS`` and
#: of ``traverse_kd.KD_KERNELS`` / ``GRID_KERNELS`` add up to these)
calls = {"intersect": 0, "instances": 0, "kdtree": 0, "grid": 0}


@dataclasses.dataclass
class SceneGeometry:
    """World-space triangle soup + quadric table + the 8-wide row table."""

    tri_v0: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor  # (T, 3)
    tri_e2: torch.Tensor  # (T, 3)
    tri_n0: torch.Tensor  # (T, 3) shading normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_material: torch.Tensor  # (T,) i64
    tri_area_light: torch.Tensor  # (T,) i64, -1 = none
    tri_mesh_id: torch.Tensor  # (T,) i64
    quad_type: torch.Tensor  # (Q,) i64 quadric type code
    quad_o2w: torch.Tensor  # (Q, 4, 4)
    quad_w2o: torch.Tensor  # (Q, 4, 4)
    quad_params: torch.Tensor  # (Q, 8) radius, zmin, zmax, phimax, height,
    #   inner radius, hyperboloid a and c coefficients
    quad_material: torch.Tensor  # (Q,) i64
    quad_area_light: torch.Tensor  # (Q,) i64
    quad_mesh_id: torch.Tensor  # (Q,) i64
    quad_reverse: torch.Tensor  # (Q,) bool
    wide_rows: torch.Tensor | None  # (M, 80) f32
    wide_stack: int = 8  # exact worst-case stack need of this table
    # motion blur: shutter-end deltas, lerped by motion_weight(ray.time)
    tri_motion: torch.Tensor | None = None  # (T, 9) of [v0, e1, e2]
    tri_n_motion: torch.Tensor | None = None  # (T, 9) of [n0, n1, n2]
    motion_time: torch.Tensor | None = None  # (2,) the interval's times
    wide_motion: torch.Tensor | None = None  # (M, 80) of each wide row
    #: (M, 96) each node row's child boxes at shutter start and their
    #: deltas (``wide.time_boxes``): the motion kernels cull by them
    wide_tbox: torch.Tensor | None = None
    # instancing: object tables and one row per static use
    inst_rows: torch.Tensor | None = None  # (Mi, 80) the BLAS tables
    inst_o2w: torch.Tensor | None = None  # (I, 4, 4)
    inst_w2o: torch.Tensor | None = None  # (I, 4, 4)
    inst_root: torch.Tensor | None = None  # (I,) int32 BLAS root row
    inst_lo: torch.Tensor | None = None  # (I, 3) world bounds of each use
    inst_hi: torch.Tensor | None = None  # (I, 3)
    inst_mesh_id: torch.Tensor | None = None  # (I,) i64, one per use
    inst_stack: int = 8  # the BLAS tables' largest stack need
    # the kd-tree or grid accelerator (Accelerator "kdtree" / "grid";
    # accel/kdtree.py, accel/grid.py): no wide table then, every triangle
    # and quadric id in the accelerator's leaves or voxels
    accel_kind: str = "bvh"  # bvh | kdtree | grid
    world_lo: torch.Tensor | None = None  # (3,) f32 bound of every primitive
    world_hi: torch.Tensor | None = None  # (and instance)
    kd_split: torch.Tensor | None = None  # (N,) f32
    kd_axis: torch.Tensor | None = None  # (N,) int32, 3 = leaf
    kd_above: torch.Tensor | None = None  # (N,) int32 (below child = node + 1)
    kd_prim_off: torch.Tensor | None = None  # (N,) int32 CSR
    kd_prim_cnt: torch.Tensor | None = None  # (N,) int32
    kd_prim_ids: torch.Tensor | None = None  # (M,) int32 global prim ids
    grid_dims: tuple | None = None  # (nx, ny, nz)
    grid_off: torch.Tensor | None = None  # (V,) int32 CSR
    grid_cnt: torch.Tensor | None = None  # (V,) int32
    grid_ids: torch.Tensor | None = None  # (M,) int32 global prim ids
    #: host-side, derived: the quadric type codes present (only those are tested)
    quad_active_types: tuple = dataclasses.field(init=False)
    #: host-side, derived: (t0, span) of motion_weight, float32 values
    motion_span: tuple | None = dataclasses.field(init=False)

    def __post_init__(self):
        self.quad_active_types = tuple(sorted(set(self.quad_type.tolist())))
        self.motion_span = None
        if self.motion_time is not None:
            t0, t1 = np.asarray(self.motion_time.cpu(), np.float32)
            self.motion_span = (float(t0), float(np.maximum(t1 - t0, np.float32(1e-9))))

    @functools.cached_property
    def leaf_prims(self) -> traverse_kd.LeafPrims:
        """The kd-tree's and grid's primitive tables (packed triangles,
        int32 quadric types)."""
        return traverse_kd.LeafPrims.of(self)

    @functools.cached_property
    def grid_cell(self) -> torch.Tensor:
        """(3,) f32 voxel widths of the grid, max((hi − lo) / dims, 1e-12)
        (intersect.py:1256-1261)."""
        dims = torch.tensor(self.grid_dims, dtype=torch.float32, device=self.world_lo.device)
        return torch.clamp((self.world_hi - self.world_lo) / dims, min=1e-12).contiguous()

    @property
    def has_motion(self) -> bool:
        return self.motion_time is not None

    @property
    def num_instances(self) -> int:
        return 0 if self.inst_root is None else self.inst_root.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_quadrics(self) -> int:
        return self.quad_type.shape[0]


@dataclasses.dataclass
class Hit:
    t: torch.Tensor  # (R,)
    prim: torch.Tensor  # (R,) i32, -1 = miss
    b1: torch.Tensor  # (R,) barycentric / quadric u
    b2: torch.Tensor  # (R,) barycentric / quadric v
    #: (R,) int32 instance of the hit, -1 = not instanced; None in a scene
    #: without instances
    inst: torch.Tensor | None = None

    @property
    def valid(self):
        return self.prim >= 0


#: 1/d with near-zero components mapped to ±1e20 (intersect.py:395)
make_inv_dir = traverse_cuda.inv_dir


def motion_weight(g: SceneGeometry, time):
    """The ray's time in the scene's motion interval → the lerp weight in
    [0, 1] (intersect.py:1396-1399)."""
    t0, span = g.motion_span
    return torch.clamp((time - t0) / span, 0.0, 1.0)


def quad_test(g: SceneGeometry, o_w, d_w, tmin, tmax, fixed_order: bool = False):
    """Every ray against every quadric, in object space (intersect.py:252;
    ``prims.quadric_hits``). The BVH's dense pass moves the rays by two
    einsums, its fewest launches (on the card a cuBLAS product, whose sum
    order is its own); ``fixed_order`` moves them by ``prims.object_ray``,
    the order of the kd-tree and grid walks, for ``intersect_brute``, which
    those walks are held to bit for bit. o_w, d_w (R, 3); tmin, tmax (R,).
    Returns (hit, t, u, v), each (R, Q)."""
    w2o = g.quad_w2o  # (Q, 4, 4)
    if fixed_order:
        o, d = prims.object_ray(w2o[None], o_w[:, None], d_w[:, None])
    else:
        m3 = w2o[:, :3, :3]
        o = torch.einsum("rj,qij->rqi", o_w, m3) + w2o[:, :3, 3]
        d = torch.einsum("rj,qij->rqi", d_w, m3)
    return prims.quadric_hits(g.quad_type[None], g.quad_params[None], o, d, tmin[:, None],
                              tmax[:, None], g.quad_active_types)


def quad_best(g: SceneGeometry, o, d, tmin, tmax):
    """Dense closest hit over all quadrics (intersect.py:568): (t, prim, b1,
    b2) with prim a global id or -1, t = tmax on a miss."""
    hit, t, u, v = quad_test(g, o, d, tmin, tmax)
    t = torch.where(hit, t, math.inf)
    best = t.argmin(1, keepdim=True)
    has = hit.gather(1, best)[:, 0]
    T = g.num_triangles
    return (
        torch.where(has, t.gather(1, best)[:, 0], tmax),
        torch.where(has, best[:, 0].to(torch.int32) + T, -1).to(torch.int32),
        torch.where(has, u.gather(1, best)[:, 0], 0.0),
        torch.where(has, v.gather(1, best)[:, 0], 0.0),
    )


def intersect(g: SceneGeometry, ray: geom.Ray, any_hit: bool = False) -> Hit:
    """Batched closest-hit (or any-hit) intersection (scene.h:42-53),
    dispatched as ``_intersect_impl`` (intersect.py:1345-1367): the
    quadrics, the world walk (lerped by ``motion_weight`` in a motion
    scene), then the instance phase. The ray is detached from autograd
    first, as ``_intersect_impl`` stops its gradient (intersect.py:1346):
    visibility is discontinuous and the walks have no backward, so no
    ``Hit`` field carries a gradient on any route."""
    ray = geom.Ray(ray.origin.detach(), ray.direction.detach(), ray.tmin.detach(),
                   ray.tmax.detach(), ray.time.detach())
    R = ray.origin.shape[0]
    dev = ray.origin.device
    tmax = ray.tmax.to(torch.float32)
    if g.accel_kind != "bvh":
        # quadrics live in the leaves and voxels (intersect.py:1368-1393):
        # no dense quadric pass first
        calls[g.accel_kind] += 1
        d = ray.direction.contiguous()
        tw = motion_weight(g, ray.time).contiguous() if g.has_motion else None
        walk = traverse_kd.traverse_kd if g.accel_kind == "kdtree" else traverse_kd.traverse_grid
        return Hit(*walk(g, ray.origin.contiguous(), d, make_inv_dir(d).contiguous(),
                         ray.tmin.contiguous(), tmax.contiguous(), any_hit, tw))
    if g.num_quadrics > 0:
        qt, qp, qb1, qb2 = quad_best(g, ray.origin, ray.direction, ray.tmin,
                                     tmax)
    else:
        qt = tmax.clone()
        qp = torch.full((R,), -1, dtype=torch.int32, device=dev)
        qb1 = torch.zeros(R, dtype=torch.float32, device=dev)
        qb2 = torch.zeros(R, dtype=torch.float32, device=dev)
    world = g.num_triangles > 0 and g.wide_rows is not None
    if not world and g.inst_rows is None:
        return Hit(qt, qp, qb1, qb2)
    o = ray.origin.contiguous()
    d = ray.direction.contiguous()
    inv = make_inv_dir(d).contiguous()
    tmin = ray.tmin.contiguous()
    tmax = tmax.contiguous()
    hit = (qt.contiguous(), qp.contiguous(), qb1.contiguous(), qb2.contiguous())
    if world:
        calls["intersect"] += 1
        motion = {}
        if g.has_motion:
            motion = dict(motion_rows=g.wide_motion, time_boxes=g.wide_tbox,
                          tw=motion_weight(g, ray.time).contiguous())
        hit = traverse_cuda.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax,
                                     *hit, any_hit, **motion)
    if g.inst_rows is None:
        return Hit(*hit)
    calls["instances"] += 1
    return Hit(*traverse_cuda.traverse_instances(
        g.inst_rows, g.inst_stack, g.inst_w2o, g.inst_lo, g.inst_hi, g.inst_root,
        o, d, inv, tmin, tmax, *hit, any_hit))


def intersect_brute(g: SceneGeometry, ray: geom.Ray, chunk: int = 2048) -> Hit:
    """Exhaustive all-primitives test — the correctness oracle (reference:
    renderers/aggregatetest.cpp:53-112; JAX ``intersect_brute``). Triangles
    use the unpacked Möller–Trumbore of ``_tri_test`` (intersect.py:215),
    vectorized over ``chunk`` triangles at a time; the nearest hit wins and
    the lowest prim id wins a tie, as in the JAX prim-order loop; quadrics
    by ``quad_test`` in its fixed order, the kd-tree and grid walks'. In a
    motion scene each ray tests the triangles lerped to its weight, the
    product rounded, then added, as the traversal lerps. Instanced objects
    are not covered: their triangles are in object space."""
    o, d = ray.origin, ray.direction
    R = o.shape[0]
    dev = o.device
    tb = ray.tmax.to(torch.float32).clone()
    pb = torch.full((R,), -1, dtype=torch.int32, device=dev)
    x1 = torch.zeros(R, dtype=torch.float32, device=dev)
    x2 = torch.zeros(R, dtype=torch.float32, device=dev)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    tw = motion_weight(g, ray.time) if g.has_motion else None
    for s in range(0, g.num_triangles, chunk):
        if tw is None:
            v0 = g.tri_v0[s:s + chunk][None]
            e1 = g.tri_e1[s:s + chunk][None]
            e2 = g.tri_e2[s:s + chunk][None]
        else:
            w = tw[:, None, None]
            dm = g.tri_motion[s:s + chunk][None]
            v0 = g.tri_v0[s:s + chunk][None] + w * dm[..., 0:3]
            e1 = g.tri_e1[s:s + chunk][None] + w * dm[..., 3:6]
            e2 = g.tri_e2[s:s + chunk][None] + w * dm[..., 6:9]
        dd = d[:, None, :]
        pv = geom.cross(dd.expand(-1, e2.shape[1], -1), e2.expand(R, -1, -1))
        det = geom.dot(e1, pv)
        inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
        tv = o[:, None, :] - v0
        u1 = geom.dot(tv, pv) * inv_det
        qv = geom.cross(tv, e1.expand(R, -1, -1))
        u2 = geom.dot(dd, qv) * inv_det
        t = geom.dot(e2, qv) * inv_det
        h = ((det.abs() >= 1e-12) & (u1 >= 0.0) & (u2 >= 0.0)
             & (u1 + u2 <= 1.0) & (t > ray.tmin[:, None]) & (t < tb[:, None]))
        tc, j = torch.where(h, t, inf).min(1)
        better = tc < tb
        jj = j[:, None]
        tb = torch.where(better, tc, tb)
        pb = torch.where(better, (j + s).to(torch.int32), pb)
        x1 = torch.where(better, u1.gather(1, jj)[:, 0], x1)
        x2 = torch.where(better, u2.gather(1, jj)[:, 0], x2)
    if g.num_quadrics:
        hit, t, u, v = quad_test(g, o, d, ray.tmin, ray.tmax.to(torch.float32),
                                 fixed_order=True)
        T = g.num_triangles
        for q in range(g.num_quadrics):
            h = hit[:, q] & (t[:, q] < tb)
            tb = torch.where(h, t[:, q], tb)
            pb = torch.where(h, T + q, pb)
            x1 = torch.where(h, u[:, q], x1)
            x2 = torch.where(h, v[:, q], x2)
    return Hit(tb, pb, x1, x2)
