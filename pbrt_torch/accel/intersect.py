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
ported: sphere, cylinder, disk, cone, paraboloid and hyperboloid.

Motion blur is the JAX package's: per-triangle shutter-end deltas of
[v0, e1, e2] (and of the vertex normals) lerped by the ray's time, an
Embree-style vertex buffer, one motion interval per scene. Instancing:
the object-space triangles of objects used by at least two static
``ObjectInstance``s sit at [T_world, T) of the triangle tables, their
tables concatenated in ``inst_rows``, one instance-table row per use.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_torch.accel import traverse_cuda
from pbrt_torch.core import geometry as geom

# quadric type codes (intersect.py:44)
SPHERE, CYLINDER, DISK, CONE, PARABOLOID, HYPERBOLOID = range(6)

#: intersect calls that ran the world walk, and those that ran the instance
#: phase (on a card, the launches of ``traverse_cuda.WORLD_KERNELS`` and of
#: ``INSTANCE_KERNELS`` add up to these)
calls = {"intersect": 0, "instances": 0}


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
    # instancing: object tables and one row per static use
    inst_rows: torch.Tensor | None = None  # (Mi, 80) the BLAS tables
    inst_o2w: torch.Tensor | None = None  # (I, 4, 4)
    inst_w2o: torch.Tensor | None = None  # (I, 4, 4)
    inst_root: torch.Tensor | None = None  # (I,) int32 BLAS root row
    inst_lo: torch.Tensor | None = None  # (I, 3) world bounds of each use
    inst_hi: torch.Tensor | None = None  # (I, 3)
    inst_mesh_id: torch.Tensor | None = None  # (I,) i64, one per use
    inst_stack: int = 8  # the BLAS tables' largest stack need
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


def _quadratic(a, b, c):
    """Stable quadratic (pbrt.h:286-311) → (ok, t0 <= t1)."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))

    def safe(x, y):
        return x / torch.where(y.abs() < 1e-20, torch.full_like(y, 1e-20), y)

    t0 = safe(q, a)
    t1 = safe(c, q)
    return ok, torch.minimum(t0, t1), torch.maximum(t0, t1)


def _roots(a, b, c, o, d, tmin, tmax, valid):
    """The nearer of the quadratic's two roots that lies in (tmin, tmax)
    and passes the clip test ``valid(p)`` (pbrt's two-root pattern) →
    (hit, t) with t = inf on a miss."""
    ok, t0, t1 = _quadratic(a, b, c)
    v0 = ok & (t0 > tmin) & (t0 < tmax) & valid(o + t0[..., None] * d)
    v1 = ok & (t1 > tmin) & (t1 < tmax) & valid(o + t1[..., None] * d)
    return v0 | v1, torch.where(v0, t0, torch.where(v1, t1, math.inf))


def quad_test(g: SceneGeometry, o_w, d_w, tmin, tmax):
    """Every ray against every quadric, in object space (intersect.py:252;
    reference: src/shapes/{sphere,cylinder,disk,cone,paraboloid,
    hyperboloid}.cpp). Each type present in the scene is tested on every
    pair and kept where ``quad_type`` names it. o_w, d_w (R, 3); tmin, tmax
    (R,). Returns (hit, t, u, v), each (R, Q)."""
    w2o = g.quad_w2o  # (Q, 4, 4)
    m3 = w2o[:, :3, :3]
    o = torch.einsum("rj,qij->rqi", o_w, m3) + w2o[:, :3, 3]
    d = torch.einsum("rj,qij->rqi", d_w, m3)
    prm = g.quad_params
    radius, zmin, zmax, phimax = prm[:, 0], prm[:, 1], prm[:, 2], prm[:, 3]
    height, inner_r, ah, ch = prm[:, 4], prm[:, 5], prm[:, 6], prm[:, 7]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    tmin_, tmax_ = tmin[:, None], tmax[:, None]
    eps_z = 1e-5

    def phi_ok(p):
        return geom.phi_of(p[..., 0], p[..., 1]) <= phimax + 1e-6

    def z_in(lo, hi):
        return lambda p: (p[..., 2] >= lo) & (p[..., 2] <= hi) & phi_ok(p)

    def sphere():
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (dx * ox + dy * oy + dz * oz)
        c = ox * ox + oy * oy + oz * oz - radius * radius
        return _roots(a, b, c, o, d, tmin_, tmax_, z_in(zmin - eps_z, zmax + eps_z))

    def cylinder():
        a = dx * dx + dy * dy
        b = 2.0 * (dx * ox + dy * oy)
        c = ox * ox + oy * oy - radius * radius
        return _roots(a, b, c, o, d, tmin_, tmax_, z_in(zmin, zmax))

    def disk():
        t = torch.where(dz.abs() < 1e-9, math.inf, (height - oz) / dz)
        p = o + t[..., None] * d
        r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
        v = ((t > tmin_) & (t < tmax_) & torch.isfinite(t) & (r2 <= radius * radius)
             & (r2 >= inner_r * inner_r) & phi_ok(p))
        return v, torch.where(v, t, math.inf)

    def cone():  # apex at z = height, base radius at z = 0
        k = (radius / height) ** 2
        a = dx * dx + dy * dy - k * dz * dz
        b = 2.0 * (dx * ox + dy * oy - k * dz * (oz - height))
        c = ox * ox + oy * oy - k * (oz - height) * (oz - height)
        return _roots(a, b, c, o, d, tmin_, tmax_, z_in(0.0, height))

    def paraboloid():  # z = height·(x² + y²)/radius²
        k = height / (radius * radius)
        a = k * (dx * dx + dy * dy)
        b = 2.0 * k * (dx * ox + dy * oy) - dz
        c = k * (ox * ox + oy * oy) - oz
        return _roots(a, b, c, o, d, tmin_, tmax_, z_in(zmin, zmax))

    def hyperboloid():  # ah·(x² + y²) − ch·z² = 1
        a = ah * (dx * dx + dy * dy) - ch * dz * dz
        b = 2.0 * (ah * (dx * ox + dy * oy) - ch * dz * oz)
        c = ah * (ox * ox + oy * oy) - ch * oz * oz - 1.0
        return _roots(a, b, c, o, d, tmin_, tmax_, z_in(zmin, zmax))

    tests = (sphere, cylinder, disk, cone, paraboloid, hyperboloid)
    hit = t = None
    for code in g.quad_active_types:
        h_k, t_k = tests[code]()
        if hit is None:
            hit, t = h_k, t_k
        else:
            of = g.quad_type == code
            hit, t = torch.where(of, h_k, hit), torch.where(of, t_k, t)
    p = o + t[..., None] * d
    u = geom.phi_of(p[..., 0], p[..., 1]) / torch.clamp(phimax, min=1e-9)
    v = (p[..., 2] - zmin) / torch.clamp(zmax - zmin, min=1e-9)
    return hit, t, torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)


def quad_best(g: SceneGeometry, o, d, tmin, tmax):
    """Dense closest hit over all quadrics (intersect.py:568): (t, prim, b1,
    b2) with prim a global id or -1, t = tmax on a miss."""
    hit, t, u, v = quad_test(g, o, d, tmin, tmax)
    inf = torch.tensor(math.inf, dtype=t.dtype, device=t.device)
    t = torch.where(hit, t, inf)
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
    scene), then the instance phase."""
    R = ray.origin.shape[0]
    dev = ray.origin.device
    tmax = ray.tmax.to(torch.float32)
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
            motion = dict(motion_rows=g.wide_motion,
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
    the lowest prim id wins a tie, as in the JAX prim-order loop. In a
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
        hit, t, u, v = quad_test(g, o, d, ray.tmin, ray.tmax.to(torch.float32))
        T = g.num_triangles
        for q in range(g.num_quadrics):
            h = hit[:, q] & (t[:, q] < tb)
            tb = torch.where(h, t[:, q], tb)
            pb = torch.where(h, T + q, pb)
            x1 = torch.where(h, u[:, q], x1)
            x2 = torch.where(h, v[:, q], x2)
    return Hit(tb, pb, x1, x2)
