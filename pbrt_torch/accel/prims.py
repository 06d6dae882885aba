"""Ray–primitive tests, elementwise: triangles and the six quadrics.

The port's one copy of the JAX package's ``_tri_test_packed``
(``pbrt_tpu/accel/intersect.py:409-434``) and ``_quad_test`` (``:252``;
reference: src/shapes/{trianglemesh,sphere,cylinder,disk,cone,paraboloid,
hyperboloid}.cpp), written as broadcasting torch ops with every sum in a
fixed order and no fused multiply-add, so that a CUDA kernel compiled
with ``-fmad=false`` repeats them bit for bit: ``intersect.quad_test``
(every ray against every quadric) and the kd-tree and grid walks
(``traverse_kd.py``, one primitive per lane, and ``csrc/traverse_kd.cu``)
all call these. ``object_ray`` moves a ray into a quadric's space as
``((x m0 + y m1) + z m2) + m3`` per row of its ``w2o``, as the instance
phase moves its rays; the BVH's dense pass moves them by an einsum
instead (``intersect.quad_test``).
"""

from __future__ import annotations

import math

import torch

from pbrt_torch.core.geometry import phi_of

# quadric type codes (intersect.py:44)
SPHERE, CYLINDER, DISK, CONE, PARABOLOID, HYPERBOLOID = range(6)


def object_ray(w2o, o_w, d_w):
    """Rays (..., 3) into the space of (..., 4, 4) ``w2o`` (broadcast): the
    origin as a point, the direction as a vector, unnormalized; each
    component ((x m0 + y m1) + z m2) + m3, the origin and the direction
    stacked through one broadcast multiply and one sum (fewer launches).
    → (o, d), each (..., 3)."""
    p = torch.stack((o_w, d_w), -2)[..., None, :] * w2o[..., None, :3, :3]
    s = p[..., 0] + p[..., 1] + p[..., 2]
    return s[..., 0, :] + w2o[..., :3, 3], s[..., 1, :]


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


def quadric_hits(typ, prm, o, d, tmin, tmax, active_types):
    """Rays against quadrics, broadcast elementwise: ``typ`` (...) type
    codes, ``prm`` (..., 8) (radius, zmin, zmax, phimax, height, inner
    radius, hyperboloid a and c), rays ``o``, ``d`` (..., 3) in each
    quadric's object space and ``tmin``, ``tmax`` (...). Each type in
    ``active_types`` is evaluated on every element and kept where ``typ``
    names it. → (hit, t, u, v): the nearer root in (tmin, tmax) that passes
    the type's clip test (t = inf on a miss), and the parametric (φ/φmax,
    height fraction) coordinates, 0 on a miss."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    radius, zmin, zmax, phimax = prm[..., 0], prm[..., 1], prm[..., 2], prm[..., 3]
    height, inner_r, ah, ch = prm[..., 4], prm[..., 5], prm[..., 6], prm[..., 7]
    eps_z = 1e-5

    def at(t):
        p = o + t[..., None] * d
        return p[..., 0], p[..., 1], p[..., 2]

    def z_in(lo, hi):
        def valid(t):
            px, py, pz = at(t)
            return (pz >= lo) & (pz <= hi) & (phi_of(px, py) <= phimax + 1e-6)
        return valid

    def roots(a, b, c, valid):
        ok, t0, t1 = _quadratic(a, b, c)
        v0 = ok & (t0 > tmin) & (t0 < tmax) & valid(t0)
        v1 = ok & (t1 > tmin) & (t1 < tmax) & valid(t1)
        return v0 | v1, torch.where(v0, t0, torch.where(v1, t1, math.inf))

    def sphere():
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (dx * ox + dy * oy + dz * oz)
        c = ox * ox + oy * oy + oz * oz - radius * radius
        return roots(a, b, c, z_in(zmin - eps_z, zmax + eps_z))

    def cylinder():
        a = dx * dx + dy * dy
        b = 2.0 * (dx * ox + dy * oy)
        c = ox * ox + oy * oy - radius * radius
        return roots(a, b, c, z_in(zmin, zmax))

    def disk():
        t = torch.where(dz.abs() < 1e-9, math.inf, (height - oz) / dz)
        px, py, _ = at(t)
        r2 = px * px + py * py
        v = ((t > tmin) & (t < tmax) & torch.isfinite(t) & (r2 <= radius * radius)
             & (r2 >= inner_r * inner_r) & (phi_of(px, py) <= phimax + 1e-6))
        return v, torch.where(v, t, math.inf)

    def cone():  # apex at z = height, base radius at z = 0
        k = (radius / height) ** 2
        a = dx * dx + dy * dy - k * dz * dz
        b = 2.0 * (dx * ox + dy * oy - k * dz * (oz - height))
        c = ox * ox + oy * oy - k * (oz - height) * (oz - height)
        return roots(a, b, c, z_in(0.0, height))

    def paraboloid():  # z = height·(x² + y²)/radius²
        k = height / (radius * radius)
        a = k * (dx * dx + dy * dy)
        b = 2.0 * k * (dx * ox + dy * oy) - dz
        c = k * (ox * ox + oy * oy) - oz
        return roots(a, b, c, z_in(zmin, zmax))

    def hyperboloid():  # ah·(x² + y²) − ch·z² = 1
        a = ah * (dx * dx + dy * dy) - ch * dz * dz
        b = 2.0 * (ah * (dx * ox + dy * oy) - ch * dz * oz)
        c = ah * (ox * ox + oy * oy) - ch * oz * oz - 1.0
        return roots(a, b, c, z_in(zmin, zmax))

    tests = (sphere, cylinder, disk, cone, paraboloid, hyperboloid)
    hit = t = None
    for code in active_types:
        h_k, t_k = tests[code]()
        if hit is None:
            hit, t = h_k, t_k
        else:
            of = typ == code
            hit, t = torch.where(of, h_k, hit), torch.where(of, t_k, t)
    px, py, pz = at(t)
    u = phi_of(px, py) / torch.clamp(phimax, min=1e-9)
    v = (pz - zmin) / torch.clamp(zmax - zmin, min=1e-9)
    return hit, t, torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)


def tri_test(row, o, d, tmin, tmax):
    """Möller–Trumbore against packed rows (..., 9) of [v0, e1, e2], the
    same expressions as the wide leaf step's (``traverse_cuda._interpret``)
    → (hit, t, b1, b2)."""
    v0x, v0y, v0z = row[..., 0], row[..., 1], row[..., 2]
    e1x, e1y, e1z = row[..., 3], row[..., 4], row[..., 5]
    e2x, e2y, e2z = row[..., 6], row[..., 7], row[..., 8]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    small = det.abs() < 1e-12
    inv_det = torch.where(small, 0.0, 1.0 / det)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ~small & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & (t > tmin) & (t < tmax)
    return hit, t, b1, b2
