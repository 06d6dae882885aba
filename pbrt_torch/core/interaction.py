"""Surface interactions reconstructed from (t, prim, b1, b2) hits.

Port of ``pbrt_tpu/core/interaction.py`` for triangles and quadrics
(reference: DifferentialGeometry and Intersection,
src/core/{diffgeom,intersection}.h).

Scenes with textures ask for more (``partials``): ∂p/∂v and the shading
normal's ∂n/∂u, ∂n/∂v from the uv-edge system (the bump chain's inputs),
and, given camera ray differentials or a pixel cone spread, the hit's
footprint in uv: the per-pixel-axis differentials (du/dx, dv/dx),
(du/dy, dv/dy), the minor radius and the major axis. Quadrics get ∂p/∂v
alone and no footprint, as in the JAX package. Other scenes compute none
of it.

In a motion scene a triangle's edges and vertex normals are lerped to the
ray's time (interaction.py:107-117); the hit point is the ray's. An
instanced hit's normals, tangents and normal derivatives are rotated by
its instance's matrices (:160-190): normals and their derivatives by the
inverse transpose, tangents unnormalized; each use takes its own mesh id.
Its footprint then solves against the object-space edges, as the JAX
package's does (ROADMAP Queue 3, fact 15).
"""

from __future__ import annotations

import dataclasses

import torch

from pbrt_torch.accel.intersect import (CONE, CYLINDER, DISK, HYPERBOLOID,
                                        PARABOLOID, SPHERE, Hit, SceneGeometry,
                                        motion_weight)
from pbrt_torch.core import geometry as geom


@dataclasses.dataclass
class SurfaceInteraction:
    """SoA over the ray batch; invalid lanes hold harmless defaults."""

    valid: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    p: torch.Tensor  # (R, 3)
    ng: torch.Tensor  # (R, 3) geometric normal, faceforwarded to ns
    ns: torch.Tensor  # (R, 3) shading normal
    uv: torch.Tensor  # (R, 2)
    dpdu: torch.Tensor  # (R, 3)
    wo: torch.Tensor  # (R, 3) -normalize(ray.direction)
    material: torch.Tensor  # (R,) i64, -1 invalid
    area_light: torch.Tensor  # (R,) i64, -1 none
    mesh_id: torch.Tensor  # (R,) i64
    prim: torch.Tensor  # (R,) i32
    ray_epsilon: torch.Tensor  # (R,)
    # with ``partials`` only (scenes with textures):
    dpdv: torch.Tensor = None  # (R, 3) world units per uv unit
    dndu: torch.Tensor = None  # (R, 3)
    dndv: torch.Tensor = None  # (R, 3)
    uv_sigma: torch.Tensor = None  # (R,) footprint's minor radius in uv
    uv_major: torch.Tensor = None  # (R, 2) footprint's major axis in uv
    duvdx: torch.Tensor = None  # (R, 2) (du/dx, dv/dx)
    duvdy: torch.Tensor = None  # (R, 2) (du/dy, dv/dy)


def surface_interaction(g: SceneGeometry, ray: geom.Ray, hit: Hit, spread=None, diffs=None,
                        partials: bool = False) -> SurfaceInteraction:
    """The hit's differential geometry. With ``partials``: dpdv, dndu,
    dndv and the uv footprint, from the camera ray differentials ``diffs``
    (rx_o, rx_d, ry_o, ry_d), world (R, 3) each, projected on the hit's
    tangent plane (diffgeom.cpp:63-100), else from the cone of half-width
    ``spread`` per unit distance, else zero (interaction.py:162-331)."""
    T = g.num_triangles
    Q = g.num_quadrics
    valid = hit.valid
    prim_safe = hit.prim.clamp(min=0).to(torch.int64)
    t_fin = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    p = ray.at(t_fin)
    wo = -geom.normalize(ray.direction)
    neg1 = torch.full(valid.shape, -1, dtype=torch.int64, device=valid.device)
    if T == 0 and Q == 0:
        raise ValueError("surface_interaction: the scene has no primitives")

    if T > 0:
        ti = prim_safe.clamp(0, T - 1)
        b1, b2 = hit.b1, hit.b2
        b0 = 1.0 - b1 - b2
        e1, e2 = g.tri_e1[ti], g.tri_e2[ti]
        n0, n1, n2 = g.tri_n0[ti], g.tri_n1[ti], g.tri_n2[ti]
        uv0, uv1, uv2 = g.tri_uv0[ti], g.tri_uv1[ti], g.tri_uv2[ti]
        if g.has_motion:
            tw = motion_weight(g, ray.time)[:, None]
            dm, dn = g.tri_motion[ti], g.tri_n_motion[ti]
            e1 = e1 + tw * dm[:, 3:6]
            e2 = e2 + tw * dm[:, 6:9]
            n0 = n0 + tw * dn[:, 0:3]
            n1 = n1 + tw * dn[:, 3:6]
            n2 = n2 + tw * dn[:, 6:9]
        ng_t = geom.normalize(geom.cross(e1, e2))
        ns_t = geom.normalize(b0[:, None] * n0 + b1[:, None] * n1
                              + b2[:, None] * n2)
        ng_t = geom.face_forward(ng_t, ns_t)
        uv_t = b0[:, None] * uv0 + b1[:, None] * uv1 + b2[:, None] * uv2
        # parametric ∂p/∂u from the uv-edge system (trianglemesh.cpp:150-180);
        # degenerate uv → normalized e1
        duv1 = uv1 - uv0
        duv2 = uv2 - uv0
        detp = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        okp = detp.abs() > 1e-12
        invp = torch.where(okp, 1.0 / torch.where(okp, detp, 1.0), 0.0)
        dpdu_p = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * invp[:, None]
        dpdu_t = torch.where(okp[:, None], dpdu_p, geom.normalize(e1))
        if partials:
            tri_extra = _triangle_uv_partials(e1, e2, n1 - n0, n2 - n0, ng_t, duv1, duv2,
                                              okp, invp)
        mat_t = g.tri_material[ti]
        al_t = g.tri_area_light[ti]
        mid_t = g.tri_mesh_id[ti]
        if hit.inst is not None and g.inst_rows is not None:
            ii = hit.inst.clamp(min=0).to(torch.int64)
            w2o_r = g.inst_w2o[ii][:, :3, :3]
            o2w_r = g.inst_o2w[ii][:, :3, :3]
            is_inst = (hit.inst >= 0)[:, None]
            normal = lambda n: torch.einsum("ri,rij->rj", n, w2o_r)
            tangent = lambda v: torch.einsum("rij,rj->ri", o2w_r, v)
            ns_t = torch.where(is_inst, geom.normalize(normal(ns_t)), ns_t)
            ng_t = torch.where(is_inst, geom.normalize(normal(ng_t)), ng_t)
            dpdu_t = torch.where(is_inst, tangent(dpdu_t), dpdu_t)
            if partials:
                for k, f in (("dpdv", tangent), ("dndu", normal), ("dndv", normal)):
                    tri_extra[k] = torch.where(is_inst, f(tri_extra[k]), tri_extra[k])
            mid_t = torch.where(hit.inst >= 0, g.inst_mesh_id[ii], mid_t)
        if partials:
            tri_extra.update(_footprint(hit, p, wo, e1, e2, ng_t, dpdu_t, duv1, duv2,
                                        spread, diffs))

    if Q > 0:
        qi = (prim_safe - T).clamp(0, Q - 1)
        w2o = g.quad_w2o[qi]
        o2w = g.quad_o2w[qi]
        p_obj = torch.einsum("rij,rj->ri", w2o[:, :3, :3], p) + w2o[:, :3, 3]
        # each type's implicit gradient in object space (interaction.py:
        # 272-286); normals transform by the inverse transpose
        # (n_world = n_obj @ w2o[:3, :3])
        n_obj = p_obj
        typ = g.quad_type[qi]
        for code in g.quad_active_types:
            if code != SPHERE:
                n_obj = torch.where((typ == code)[:, None],
                                    _quadric_gradient(code, p_obj, g.quad_params[qi]), n_obj)
        n_w = geom.normalize(torch.einsum("ri,rij->rj", n_obj, w2o[:, :3, :3]))
        n_w = torch.where(g.quad_reverse[qi][:, None], -n_w, n_w)
        x, y = p_obj[:, 0], p_obj[:, 1]
        dpdu_obj = torch.stack([-y, x, torch.zeros_like(x)], -1)
        dpdu_q = geom.normalize(torch.einsum("rij,rj->ri", o2w[:, :3, :3],
                                             dpdu_obj))
        uv_q = torch.stack([hit.b1, hit.b2], -1)
        if partials:
            dpdv_q = geom.normalize(geom.cross(dpdu_q, n_w))
        mat_q = g.quad_material[qi]
        al_q = g.quad_area_light[qi]
        mid_q = g.quad_mesh_id[qi]

    extra = {}
    if T > 0 and Q > 0:
        is_tri1 = hit.prim < T
        is_tri = is_tri1[:, None]
        if partials:
            # quadric lanes: no normal derivatives and no footprint
            extra = {k: torch.where(is_tri if v.dim() == 2 else is_tri1, v, 0.0)
                     for k, v in tri_extra.items() if k != "dpdv"}
            extra["dpdv"] = torch.where(is_tri, tri_extra["dpdv"], dpdv_q)
        ng = torch.where(is_tri, ng_t, n_w)
        ns = torch.where(is_tri, ns_t, n_w)
        uv = torch.where(is_tri, uv_t, uv_q)
        dpdu = torch.where(is_tri, dpdu_t, dpdu_q)
        material = torch.where(is_tri1, mat_t, mat_q)
        area_light = torch.where(is_tri1, al_t, al_q)
        mesh_id = torch.where(is_tri1, mid_t, mid_q)
    elif T > 0:
        ng, ns, uv, dpdu = ng_t, ns_t, uv_t, dpdu_t
        material, area_light, mesh_id = mat_t, al_t, mid_t
        if partials:
            extra = tri_extra
    else:
        ng, ns, uv, dpdu = n_w, n_w, uv_q, dpdu_q
        material, area_light, mesh_id = mat_q, al_q, mid_q
        if partials:
            z2 = torch.zeros_like(uv_q)
            extra = dict(dpdv=dpdv_q, dndu=torch.zeros_like(p), dndv=torch.zeros_like(p),
                         uv_sigma=torch.zeros_like(hit.t), uv_major=z2, duvdx=z2, duvdy=z2)

    return SurfaceInteraction(
        valid=valid, t=hit.t, p=p, ng=ng, ns=ns, uv=uv, dpdu=dpdu, wo=wo,
        material=torch.where(valid, material, neg1),
        area_light=torch.where(valid, area_light, neg1),
        mesh_id=torch.where(valid, mesh_id, neg1),
        prim=hit.prim, ray_epsilon=1e-3 * hit.t.abs(), **extra,
    )


def _triangle_uv_partials(e1, e2, dn1, dn2, ng, duv1, duv2, okp, invp) -> dict:
    """A triangle hit's dpdv, dndu, dndv: the uv-edge system that gives
    dpdu (Triangle::GetShadingGeometry; interaction.py:125-158)."""
    inv = invp[:, None]
    ok = okp[:, None]
    return dict(
        dpdv=torch.where(ok, (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv,
                         geom.cross(ng, geom.normalize(e1))),
        dndu=torch.where(ok, (duv2[:, 1:2] * dn1 - duv1[:, 1:2] * dn2) * inv, 0.0),
        dndv=torch.where(ok, (-duv2[:, 0:1] * dn1 + duv1[:, 0:1] * dn2) * inv, 0.0),
    )


def _footprint(hit, p, wo, e1, e2, ng, dpdu, duv1, duv2, spread, diffs) -> dict:
    """A triangle hit's uv footprint (interaction.py:191-260): the minor
    radius, the major axis and the per-pixel-axis differentials."""
    if spread is None and diffs is None:
        z2 = torch.zeros_like(duv1)
        return dict(uv_sigma=torch.zeros_like(hit.t), uv_major=z2, duvdx=z2, duvdy=z2)
    # world → uv through the barycentric solve on the edge Gram matrix
    g11, g12, g22 = geom.dot(e1, e1), geom.dot(e1, e2), geom.dot(e2, e2)
    det = torch.clamp(g11 * g22 - g12 * g12, min=1e-20)

    def to_uv(delta):
        d1, d2 = geom.dot(e1, delta), geom.dot(e2, delta)
        a = (g22 * d1 - g12 * d2) / det
        b = (g11 * d2 - g12 * d1) / det
        return a[:, None] * duv1 + b[:, None] * duv2

    if diffs is not None:
        # the offset rays meet the tangent plane; a lane parallel to it or
        # not finite gets zero differentials (the reference's unsolved case)
        rx_o, rx_d, ry_o, ry_d = diffs
        d_pl = geom.dot(ng, p)

        def proj_delta(o_, dr):
            den = geom.dot(ng, dr)
            ok_ = den.abs() > 1e-12
            tpr = (d_pl - geom.dot(ng, o_)) / torch.where(ok_, den, 1.0)
            dp = o_ + tpr[:, None] * dr - p
            good = (ok_ & torch.isfinite(tpr))[:, None]
            return torch.where(good & torch.isfinite(dp), dp, 0.0)

        ax1 = to_uv(proj_delta(rx_o, rx_d))
        ax2 = to_uv(proj_delta(ry_o, ry_d))
        ax1 = torch.where(torch.isfinite(ax1), ax1, 0.0)
        ax2 = torch.where(torch.isfinite(ax2), ax2, 0.0)
    else:
        # the cone's circular section on the surface: minor axis across the
        # view direction, major along it stretched by 1/cos θ
        w_fp = torch.where(torch.isfinite(hit.t), hit.t, 0.0).abs() * spread
        perp = geom.cross(ng, wo)
        pl = geom.length(perp)[:, None]
        perp = torch.where(pl > 1e-8, perp / torch.clamp(pl, min=1e-20), dpdu)
        par = geom.normalize(geom.cross(perp, ng))
        cos_i = torch.clamp(geom.absdot(wo, ng), 1e-3, 1.0)
        ax1 = to_uv(w_fp[:, None] * perp)
        ax2 = to_uv((w_fp / cos_i)[:, None] * par)
    l1, l2 = geom.length(ax1), geom.length(ax2)
    return dict(uv_sigma=torch.minimum(l1, l2),
                uv_major=torch.where((l1 >= l2)[:, None], ax1, ax2), duvdx=ax1, duvdy=ax2)


def _quadric_gradient(code, p_obj, prm):
    """The object-space normal direction of a non-sphere quadric at p_obj
    (the sphere's is p_obj itself)."""
    x, y, z = p_obj[:, 0], p_obj[:, 1], p_obj[:, 2]
    radius, height = prm[:, 0], prm[:, 4]
    if code == CYLINDER:
        return torch.stack([x, y, torch.zeros_like(z)], -1)
    if code == DISK:
        return torch.stack([torch.zeros_like(x), torch.zeros_like(y), torch.ones_like(z)], -1)
    if code == CONE:
        k = (radius / torch.clamp(height, min=1e-9)) ** 2
        return torch.stack([x, y, -k * (z - height)], -1)
    if code == PARABOLOID:
        k = height / torch.clamp(radius * radius, min=1e-9)
        return torch.stack([2 * k * x, 2 * k * y, -torch.ones_like(z)], -1)
    if code == HYPERBOLOID:
        ah, ch = prm[:, 6], prm[:, 7]
        return torch.stack([ah * x, ah * y, -ch * z], -1)
    raise ValueError(f"quadric type {code}")


def offset_ray_origin(p, ng, w, eps):
    """Spawn point offset along the geometric normal, toward w."""
    sign = torch.where(geom.dot(ng, w) >= 0.0, 1.0, -1.0)
    return p + (sign * eps)[..., None] * ng
