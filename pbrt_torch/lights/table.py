"""Light table: point, spot, distant, infinite, projection and
goniometric lights, and diffuse area lights on spheres and triangle meshes.

Port of ``pbrt_tpu/lights/table.py`` (reference: src/lights/{point,spot,
distant,infinite,projection,goniometric,diffuse}.cpp, with
Sphere::Sample(p, ...) cone sampling, src/shapes/sphere.cpp:230-270, and
ShapeSet area sampling, core/light.cpp:36-70): ``sample_li`` (:335),
``pdf_li``'s infinite-light half (:590-606), ``le_escaped`` (:616),
``pdf_li_hit`` (:648) and ``emitted_radiance`` (:637), and the
emission side that starts photon and VPL paths: ``sample_le`` (:547;
each light's Light::Sample_L(scene, ...) overload) with
``area_sample_point`` (:510), ``world_center`` / ``world_radius`` (the
distant and infinite lights' disk) and ``power_dist``, the light-power
``Distribution1D`` that picks the emitting light (builder.py:1108-1111).

The infinite light is constant or maps a lat-long image (``env_map``, one
per table: as in the JAX package, only the first mapped light keeps its
map) sampled through a ``Distribution2D`` of the map's mean over bins
(infinite.cpp:77-95, 187-229). Projection and goniometric lights look up
stacked maps of one common size (``lmap``) bilinearly.

Rows are in the JAX package's order: every ``LightSource`` first, then the
area lights in shape order. A surface's ``area_light`` index counts area
lights only, so the emission and MIS lookups read row ``area_row0 +
area_light``. (The JAX package reads row ``area_light`` and so takes a
``LightSource`` row's values where a scene has both families.)

``sample_li`` evaluates each light type present in the table on every lane
and keeps, per lane, the one its light has (masked evaluation, as the JAX
package's ``lax.switch`` over ``active_types``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import sampling as smp

# the JAX package's light type codes (lights/table.py:28)
POINT, SPOT, DISTANT, AREA, INFINITE, PROJECTION, GONIO = range(7)
#: area-light shape kinds: a sphere quadric row, a triangle range
SHAPE_SPHERE, SHAPE_MESH = 1, 2


@dataclasses.dataclass
class LightTable:
    type: torch.Tensor  # (L,) i64 light type code
    emit: torch.Tensor  # (L, S): I (point, spot), L (distant, area)
    pos: torch.Tensor  # (L, 3) world position (point, spot)
    dirw: torch.Tensor  # (L, 3) world direction (distant: propagation; spot: axis)
    cos_total: torch.Tensor  # (L,) spot outer cone cos
    cos_falloff: torch.Tensor  # (L,) spot inner cone cos
    shape_kind: torch.Tensor  # (L,) i64 0 none, 1 sphere, 2 triangle range
    quad_idx: torch.Tensor  # (L,) i64 sphere row in SceneGeometry
    tri_start: torch.Tensor  # (L,) i64 first triangle
    tri_count: torch.Tensor  # (L,) i64
    cdf_offset: torch.Tensor  # (L,) i64 offset into tri_cdf
    total_area: torch.Tensor  # (L,)
    tri_cdf: torch.Tensor  # (K,) the mesh lights' inclusive area CDFs, concatenated
    l2w: torch.Tensor  # (L, 4, 4) light to world
    w2l: torch.Tensor  # (L, 4, 4)
    env_id: torch.Tensor  # (L,) i64 0: the light maps env_map; -1 constant
    env_map: torch.Tensor  # (H, W, S) lat-long radiance ((1, 1, S) ones if none)
    env_dist: smp.Distribution2D  # over (u, v) of env_map's mean + 1e-6
    lmap_id: torch.Tensor  # (L,) i64 projection / goniometric map, -1 none
    lmap: torch.Tensor  # (P, Hm, Wm, S) ((1, 1, 1, S) ones if none)
    proj_screen: torch.Tensor  # (L, 4) x0, x1, y0, y1 of the projection's screen
    proj_invtan: torch.Tensor  # (L,) 1/tan(fov/2)
    #: the scene's bounding sphere (builder.py:874-875): the distant and
    #: infinite lights emit from a disk of this radius
    world_center: torch.Tensor = None  # (3,)
    world_radius: torch.Tensor = None  # ()
    #: light selection by power, max(mean(emit), 1e-6) per row
    power_dist: smp.Distribution1D = None
    # host-side, derived from the rows:
    #: the row of area light 0 (the LightSource rows before it)
    area_row0: int = dataclasses.field(init=False)
    #: the light type codes present (only those are evaluated)
    active_types: tuple = dataclasses.field(init=False)
    #: the area lights' shape kinds present (only those are evaluated)
    area_shapes: frozenset = dataclasses.field(init=False)
    #: (row, cdf_offset, tri_count) of each mesh area light
    mesh_segments: tuple = dataclasses.field(init=False)
    #: the infinite lights' rows, and whether each maps env_map
    infinite_rows: tuple = dataclasses.field(init=False)
    infinite_mapped: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        typ, kind = self.type.tolist(), self.shape_kind.tolist()
        off, cnt = self.cdf_offset.tolist(), self.tri_count.tolist()
        area = [i for i, t in enumerate(typ) if t == AREA]
        self.area_row0 = area[0] if area else len(typ)
        self.active_types = tuple(sorted(set(typ)))
        self.area_shapes = frozenset(kind[i] for i in area)
        self.mesh_segments = tuple((i, off[i], cnt[i]) for i in area if kind[i] == SHAPE_MESH)
        env = self.env_id.tolist()
        self.infinite_rows = tuple(i for i, t in enumerate(typ) if t == INFINITE)
        self.infinite_mapped = tuple(env[i] >= 0 for i in self.infinite_rows)

    @property
    def count(self) -> int:
        return self.emit.shape[0]


@dataclasses.dataclass
class LightSample:
    wi: torch.Tensor  # (R, 3) unit, toward the light
    L: torch.Tensor  # (R, S)
    pdf: torch.Tensor  # (R,) solid-angle pdf (1 for delta lights)
    dist: torch.Tensor  # (R,) distance to the sampled point (inf: distant)
    is_delta: torch.Tensor  # (R,) bool


def _sphere_of(lt: LightTable, g, li):
    qi = lt.quad_idx[li]
    o2w = g.quad_o2w[qi]
    center = o2w[:, :3, 3]
    radius = g.quad_params[qi, 0] * torch.linalg.vector_norm(o2w[:, :3, 0], dim=-1)
    return center, radius


def _cone(center, radius, p):
    d = center - p
    dist2 = torch.clamp(geom.dot(d, d), min=1e-12)
    inside = dist2 - radius * radius < 1e-4
    sin2_max = torch.clamp(radius * radius / dist2, 0.0, 1.0 - 1e-7)
    cos_max = torch.sqrt(1.0 - sin2_max)
    return d, dist2, inside, cos_max


def _toward(pos, p):
    """Unit direction from p to ``pos``, its distance and squared distance."""
    d = pos - p
    dist2 = torch.clamp(geom.dot(d, d), min=1e-12)
    dist = torch.sqrt(dist2)
    return d / dist[:, None], dist, dist2


def _point(lt, li, emit, p):
    wi, dist, dist2 = _toward(lt.pos[li], p)
    return wi, emit / dist2[:, None], dist


def _spot(lt, li, emit, p):
    """(lights/spot.cpp Falloff + Sample_L)."""
    wi, dist, dist2 = _toward(lt.pos[li], p)
    cos_t = geom.dot(-wi, lt.dirw[li])
    ct, cf = lt.cos_total[li], lt.cos_falloff[li]
    delta = torch.clamp((cos_t - ct) / torch.clamp(cf - ct, min=1e-9), 0.0, 1.0)
    falloff = torch.where(cos_t < ct, 0.0,
                          torch.where(cos_t > cf, 1.0, delta ** 2 * delta ** 2))
    return wi, emit * falloff[:, None] / dist2[:, None], dist


def _area_sphere(lt, g, li, p, u1, u2):
    """Uniform cone from outside, uniform area from inside."""
    center, radius = _sphere_of(lt, g, li)
    d, dist2, inside, cos_max = _cone(center, radius, p)
    dc = torch.sqrt(dist2)
    wz = d / dc[:, None]
    wx, wy = geom.coordinate_system(wz)
    ct = (1.0 - u1) + u1 * cos_max
    wi_cone = geom.spherical_direction_basis(
        torch.sqrt(torch.clamp(1.0 - ct ** 2, min=0.0)), ct,
        2.0 * math.pi * u2, wx, wy, wz,
    )
    pdf_cone = smp.uniform_cone_pdf(cos_max)
    b = geom.dot(wi_cone, d)
    disc = b * b - dist2 + radius * radius
    t_hit = b - torch.sqrt(torch.clamp(disc, min=0.0))
    sp = smp.uniform_sample_sphere(u1, u2)
    p_l = center + radius[:, None] * sp
    d_in = p_l - p
    dist_in = torch.clamp(geom.length(d_in), min=1e-9)
    wi_in = d_in / dist_in[:, None]
    cos_l = torch.clamp(geom.dot(sp, -wi_in), min=1e-9)
    area = 4.0 * math.pi * radius * radius
    pdf_in = dist_in * dist_in / (cos_l * area)
    return (torch.where(inside[:, None], wi_in, wi_cone), lt.emit[li],
            torch.where(inside, pdf_in, pdf_cone), torch.where(inside, dist_in, t_hit))


def _mesh_triangle(lt: LightTable, li, u1):
    """The triangle an area-CDF inversion picks, per lane: k = the count of
    the light's CDF entries below u1 (torch.searchsorted on each mesh
    light's segment), clipped to its range, as the JAX package's
    ``sum(tri_cdf < u1 & in_range)``; → (global triangle, u1 rescaled
    within the picked cell)."""
    u1c = u1.contiguous()
    k = torch.zeros_like(li)
    for row, off, cnt in lt.mesh_segments:
        k_row = torch.searchsorted(lt.tri_cdf[off:off + cnt], u1c)
        k = torch.where(li == row, k_row, k)
    k = torch.minimum(k, torch.clamp(lt.tri_count[li], min=1) - 1)
    off = lt.cdf_offset[li]
    lower = torch.where(k > 0, lt.tri_cdf[(off + k - 1).clamp(min=0)], 0.0)
    upper = lt.tri_cdf[off + k]
    u1r = torch.clamp((u1 - lower) / torch.clamp(upper - lower, min=1e-9), 0.0, 1.0)
    return lt.tri_start[li] + k, u1r


def _area_mesh(lt, g, li, p, u1, u2):
    """Area-weighted triangle pick, then a uniform point on it."""
    ti, u1r = _mesh_triangle(lt, li, u1)
    b0, b1 = smp.uniform_sample_triangle(u1r, u2)
    e1, e2 = g.tri_e1[ti], g.tri_e2[ti]
    p_l = g.tri_v0[ti] + b0[:, None] * e1 + b1[:, None] * e2
    n_l = geom.normalize(geom.cross(e1, e2))
    d = p_l - p
    dist = torch.clamp(geom.length(d), min=1e-9)
    wi = d / dist[:, None]
    cos_nl = geom.dot(n_l, -wi)
    pdf = dist * dist / torch.clamp(cos_nl.abs() * lt.total_area[li], min=1e-12)
    # one-sided emission: L only where the light's front side faces p
    L = torch.where((cos_nl > 0.0)[:, None], 1.0, 0.0) * lt.emit[li]
    return wi, L, pdf, dist


def _area(lt, g, li, p, u1, u2):
    """Only the shape kinds the table has are evaluated (the JAX package
    evaluates both where the scene has quadrics and triangles, and keeps the
    light's; the kept values are the same)."""
    if SHAPE_MESH not in lt.area_shapes:
        return _area_sphere(lt, g, li, p, u1, u2)
    if SHAPE_SPHERE not in lt.area_shapes:
        return _area_mesh(lt, g, li, p, u1, u2)
    sphere = (lt.shape_kind[li] == SHAPE_SPHERE)
    s, m = _area_sphere(lt, g, li, p, u1, u2), _area_mesh(lt, g, li, p, u1, u2)
    return tuple(torch.where(sphere[:, None] if a.dim() == 2 else sphere, a, b)
                 for a, b in zip(s, m))


def _rot(m, v):
    """The rotation part of (R, 4, 4) matrices, or of one (4, 4), applied
    to v (R, 3)."""
    return (m[..., :3, 0] * v[:, 0:1] + m[..., :3, 1] * v[:, 1:2]) + m[..., :3, 2] * v[:, 2:3]


def _env_texel(lt: LightTable, u, v):
    """env_map's texel at (u, v), nearest (floor), clamped."""
    H, W = lt.env_map.shape[0], lt.env_map.shape[1]
    x = (u * W).to(torch.int64).clamp(0, W - 1)
    y = (v * H).to(torch.int64).clamp(0, H - 1)
    return lt.env_map[y, x]


def _infinite(lt: LightTable, li, emit, u1, u2):
    """(infinite.cpp:187-229): a direction from the map's Distribution2D
    (pdf over the sphere pdf_uv / (2π² sin θ)) for a mapped light, a
    uniform one for a constant light; only the cases the table holds are
    evaluated."""
    mapped = set(lt.infinite_mapped)
    out = None
    if True in mapped:
        (u, v), pdf_uv = lt.env_dist.sample_continuous(u1, u2)
        theta = v * math.pi
        phi = u * 2.0 * math.pi
        st, ct = torch.sin(theta), torch.cos(theta)
        wi_l = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        pdf = pdf_uv / torch.clamp(2.0 * math.pi * math.pi * st, min=1e-9)
        out = (_rot(lt.l2w[li], wi_l), _env_texel(lt, u, v) * emit, pdf)
    if False in mapped:
        const = (smp.uniform_sample_sphere(u1, u2), emit,
                 torch.full_like(u1, smp.UNIFORM_SPHERE_PDF))
        if out is None:
            out = const
        else:
            has_env = lt.env_id[li] >= 0
            out = tuple(torch.where(has_env[:, None] if a.dim() == 2 else has_env, a, b)
                        for a, b in zip(out, const))
    return out + (torch.full_like(u1, math.inf),)


def _light_dir(lt: LightTable, li, wi):
    """The direction from the light to p (−wi) in the light's frame."""
    return _rot(lt.w2l[li], -wi)


def _lmap_bilinear(lt: LightTable, mi, u, v):
    """Bilinear lookup of the stacked projection / goniometric maps (R, S)."""
    H, W = lt.lmap.shape[1], lt.lmap.shape[2]
    mi = mi.clamp(min=0)
    x = torch.clamp(u * W - 0.5, 0.0, W - 1.0)
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    m = lt.lmap
    return (m[mi, y0, x0] * (1 - fx) * (1 - fy) + m[mi, y0, x1] * fx * (1 - fy)
            + m[mi, y1, x0] * (1 - fx) * fy + m[mi, y1, x1] * fx * fy)


def _projection(lt: LightTable, li, emit, p):
    """(lights/projection.cpp Projection + Sample_L): a point light scaled
    by the texel its perspective screen shows toward p, 0 outside it."""
    wi, dist, dist2 = _toward(lt.pos[li], p)
    wl = _light_dir(lt, li, wi)
    z = wl[:, 2]
    invt = lt.proj_invtan[li]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    xs = wl[:, 0] / zs * invt
    ys = wl[:, 1] / zs * invt
    x0, x1, y0, y1 = lt.proj_screen[li].unbind(-1)
    inside = (z > 1e-3) & (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    u = torch.clamp((xs - x0) / torch.clamp(x1 - x0, min=1e-9), 0.0, 1.0)
    v = torch.clamp((ys - y0) / torch.clamp(y1 - y0, min=1e-9), 0.0, 1.0)
    texel = _lmap_bilinear(lt, lt.lmap_id[li], u, v)
    L = torch.where(inside, 1.0, 0.0)[:, None] * texel * emit / dist2[:, None]
    return wi, L, dist


def _gonio(lt: LightTable, li, emit, p):
    """(lights/goniometric.cpp Scale): a point light scaled by its
    photometric map, looked up with y and z swapped."""
    wi, dist, dist2 = _toward(lt.pos[li], p)
    wl = geom.normalize(_light_dir(lt, li, wi))
    theta = torch.acos(torch.clamp(wl[:, 1], -1.0, 1.0))
    phi = geom.phi_of(wl[:, 0], wl[:, 2])
    texel = _lmap_bilinear(lt, lt.lmap_id[li], phi / (2.0 * math.pi), theta / math.pi)
    return wi, texel * emit / dist2[:, None], dist


def sample_li(lt: LightTable, g, light_idx, p, u1, u2) -> LightSample:
    """Sample light ``light_idx`` (R,) as seen from p (R, 3) with the
    uniforms u1, u2 (R,)."""
    emit = lt.emit[light_idx]
    one = torch.ones_like(u1)
    out = None
    for code in lt.active_types:
        if code == POINT:
            wi, L, dist = _point(lt, light_idx, emit, p)
            res = (wi, L, one, dist, True)
        elif code == SPOT:
            wi, L, dist = _spot(lt, light_idx, emit, p)
            res = (wi, L, one, dist, True)
        elif code == DISTANT:
            wi = -lt.dirw[light_idx]
            res = (wi, emit, one, torch.full_like(u1, math.inf), True)
        elif code == AREA:
            res = _area(lt, g, light_idx, p, u1, u2) + (False,)
        elif code == INFINITE:
            res = _infinite(lt, light_idx, emit, u1, u2) + (False,)
        elif code == PROJECTION:
            wi, L, dist = _projection(lt, light_idx, emit, p)
            res = (wi, L, one, dist, True)
        elif code == GONIO:
            wi, L, dist = _gonio(lt, light_idx, emit, p)
            res = (wi, L, one, dist, True)
        else:
            raise ValueError(f"unknown light type {code}")
        res = res[:4] + (torch.full(u1.shape, res[4], dtype=torch.bool, device=u1.device),)
        if out is None:
            out = res
        else:
            m = lt.type[light_idx] == code
            out = tuple(torch.where(m[:, None] if a.dim() == 2 else m, a, b)
                        for a, b in zip(res, out))
    wi, L, pdf, dist, is_delta = out
    return LightSample(wi=wi, L=L, pdf=pdf, dist=dist, is_delta=is_delta)


def pdf_li(lt: LightTable, light_idx, wi):
    """The solid-angle pdf ``sample_li`` gives direction wi for an infinite
    light (lights/table.py:590-606; its area half is ``pdf_li_hit``'s): the
    map's pdf_uv / (2π² sin θ), or 1/4π for a constant light; 0 for other
    types."""
    inf = lt.type[light_idx] == INFINITE
    pdf = torch.full_like(wi[:, 0], smp.UNIFORM_SPHERE_PDF)
    if True in lt.infinite_mapped:
        wl = _rot(lt.w2l[light_idx], wi)
        theta = torch.acos(torch.clamp(wl[:, 2], -1.0, 1.0))
        p_uv = lt.env_dist.pdf(geom.phi_of(wl[:, 0], wl[:, 1]) / (2.0 * math.pi),
                               theta / math.pi)
        env = p_uv / torch.clamp(2.0 * math.pi * math.pi * torch.sin(theta), min=1e-9)
        pdf = torch.where(lt.env_id[light_idx] >= 0, env, pdf)
    return torch.where(inf, pdf, 0.0)


def le_escaped(lt: LightTable, d):
    """Σ over the infinite lights of the radiance an escaped ray of
    direction d (R, 3) sees (samplerrenderer.cpp:241-242), in row order."""
    total = torch.zeros(d.shape[:1] + lt.emit.shape[1:], dtype=d.dtype, device=d.device)
    for row, mapped in zip(lt.infinite_rows, lt.infinite_mapped):
        if mapped:
            w = geom.normalize(_rot(lt.w2l[row], d))
            u = geom.phi_of(w[:, 0], w[:, 1]) / (2.0 * math.pi)
            v = torch.acos(torch.clamp(w[:, 2], -1.0, 1.0)) / math.pi
            total = total + _env_texel(lt, u, v) * lt.emit[row]
        else:
            total = total + lt.emit[row]
    return total


def pdf_li_hit(lt: LightTable, g, light_idx, p_shade, d, t_hit, n_light):
    """Solid-angle pdf that ``sample_li`` gives the direction of ``d`` (the
    ray direction, normalized here) toward the emissive primitive a
    BSDF-sampled ray hit at distance ``t_hit`` with normal ``n_light`` (for
    MIS): the uniform-cone pdf of a sphere, t²/(|cos θ_l|·A) of a mesh; 0
    where light_idx < 0. ``light_idx`` is the surface's area-light index."""
    row = lt.area_row0 + light_idx.clamp(min=0)

    def sphere():
        center, radius = _sphere_of(lt, g, row)
        _, _, inside, cos_max = _cone(center, radius, p_shade)
        return torch.where(inside, smp.UNIFORM_SPHERE_PDF, smp.uniform_cone_pdf(cos_max))

    def mesh():
        cos_l = geom.dot(n_light, -geom.normalize(d)).abs()
        return (t_hit * t_hit) / torch.clamp(cos_l * lt.total_area[row], min=1e-12)

    if SHAPE_MESH not in lt.area_shapes:
        pdf = sphere()
    elif SHAPE_SPHERE not in lt.area_shapes:
        pdf = mesh()
    else:
        pdf = torch.where(lt.shape_kind[row] == SHAPE_SPHERE, sphere(), mesh())
    return torch.where(light_idx >= 0, pdf, 0.0)


def emitted_radiance(lt: LightTable, light_idx, n_light, wo):
    """One-sided diffuse emission L(p, n, w) (diffuse.h:49-52) of area
    light ``light_idx`` (the surface's area-light index; -1 none)."""
    front = geom.dot(n_light, wo) > 0.0
    row = lt.area_row0 + light_idx.clamp(min=0)
    return torch.where(((light_idx >= 0) & front)[:, None], lt.emit[row], 0.0)


# ---------------------------------------------------------------------------
# emission sampling (lights/table.py:385-555)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EmissionSample:
    """What ``sample_le`` returns (Light::Sample_L(scene, ...))."""

    p: torch.Tensor  # (R, 3) ray origin on or at the light
    d: torch.Tensor  # (R, 3) unit emission direction (light → scene)
    n: torch.Tensor  # (R, 3) the light's normal at p
    Le: torch.Tensor  # (R, S) emitted radiance or intensity
    pdf: torch.Tensor  # (R,) joint (area × direction) pdf


def area_sample_point(lt: LightTable, g, li, u1, u2):
    """A uniform-by-area point on area light ``li``'s shape → (p, n,
    pdf_area) (ShapeSet::Sample, core/light.cpp:36-70; table.py:510-545):
    a sphere's whole surface, or an area-CDF triangle pick."""

    def sphere():
        center, radius = _sphere_of(lt, g, li)
        sp = smp.uniform_sample_sphere(u1, u2)
        area = 4.0 * math.pi * radius * radius
        return center + radius[:, None] * sp, sp, 1.0 / torch.clamp(area, min=1e-12)

    def mesh():
        ti, u1r = _mesh_triangle(lt, li, u1)
        b0, b1 = smp.uniform_sample_triangle(u1r, u2)
        e1, e2 = g.tri_e1[ti], g.tri_e2[ti]
        p_l = g.tri_v0[ti] + b0[:, None] * e1 + b1[:, None] * e2
        return (p_l, geom.normalize(geom.cross(e1, e2)),
                1.0 / torch.clamp(lt.total_area[li], min=1e-12))

    if SHAPE_MESH not in lt.area_shapes:
        return sphere()
    if SHAPE_SPHERE not in lt.area_shapes:
        return mesh()
    is_sphere = lt.shape_kind[li] == SHAPE_SPHERE
    return tuple(torch.where(is_sphere[:, None] if a.dim() == 2 else is_sphere, a, b)
                 for a, b in zip(sphere(), mesh()))


def _proj_gonio_scale(lt: LightTable, li, w, is_proj: bool):
    """The angular factor of emitted direction w (light → scene)
    (ProjectionLight::Projection, GonioPhotometricLight::Scale;
    table.py:370-383): w in the light's frame, normalized."""
    wl = geom.normalize(_rot(lt.w2l[li], w))
    if is_proj:
        z = wl[:, 2]
        invt = lt.proj_invtan[li]
        zs = torch.where(z.abs() < 1e-9, 1e-9, z)
        xs = wl[:, 0] / zs * invt
        ys = wl[:, 1] / zs * invt
        x0, x1, y0, y1 = lt.proj_screen[li].unbind(-1)
        inside = (z > 1e-3) & (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
        u = torch.clamp((xs - x0) / torch.clamp(x1 - x0, min=1e-9), 0.0, 1.0)
        v = torch.clamp((ys - y0) / torch.clamp(y1 - y0, min=1e-9), 0.0, 1.0)
        return torch.where(inside, 1.0, 0.0)[:, None] * _lmap_bilinear(lt, lt.lmap_id[li], u, v)
    theta = torch.acos(torch.clamp(wl[:, 1], -1.0, 1.0))
    phi = geom.phi_of(wl[:, 0], wl[:, 2])
    return _lmap_bilinear(lt, lt.lmap_id[li], phi / (2.0 * math.pi), theta / math.pi)


def _disk_origin(lt: LightTable, d, u1, u2):
    """A point on the world-radius disk through the scene's centre, normal
    to d, moved back by the radius (distant.cpp:63-87)."""
    v1, v2 = geom.coordinate_system(d)
    d1, d2 = smp.concentric_sample_disk(u1, u2)
    wr = lt.world_radius
    pdisk = lt.world_center + wr * (d1[:, None] * v1 + d2[:, None] * v2)
    return pdisk - wr * d


def _le_infinite(lt: LightTable, li, emit, u1, u2, u3, u4):
    """(infinite.cpp:220-250): a direction from the map's distribution
    (propagating inward) or uniform for a constant light, its origin on the
    world disk; pdf = direction pdf / (π r²)."""
    mapped = set(lt.infinite_mapped)
    out = None
    if True in mapped:
        (u, v), pdf_uv = lt.env_dist.sample_continuous(u1, u2)
        theta = v * math.pi
        phi = u * 2.0 * math.pi
        st, ct = torch.sin(theta), torch.cos(theta)
        wi_l = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        pdf_dir = pdf_uv / torch.clamp(2.0 * math.pi * math.pi * st, min=1e-9)
        out = (-_rot(lt.l2w[li], wi_l), _env_texel(lt, u, v) * emit, pdf_dir)
    if False in mapped:
        const = (smp.uniform_sample_sphere(u1, u2), emit,
                 torch.full_like(u1, smp.UNIFORM_SPHERE_PDF))
        if out is None:
            out = const
        else:
            has_env = lt.env_id[li] >= 0
            out = tuple(torch.where(has_env[:, None] if a.dim() == 2 else has_env, a, b)
                        for a, b in zip(out, const))
    d, Le, pdf_dir = out
    wr = lt.world_radius
    return _disk_origin(lt, d, u3, u4), d, d, Le, pdf_dir / (math.pi * wr * wr)


def sample_le(lt: LightTable, g, light_idx, u1, u2, u3, u4) -> EmissionSample:
    """An emitted ray of light ``light_idx`` (R,) from the uniforms u1..u4
    (R,) (Light::Sample_L(scene, ...); table.py:399-507): point, goniometric
    and projection lights a uniform sphere of directions (the projection's
    window zeroes Le outside it), a spot its cone with the falloff, a
    distant light a disk of the world's radius, an area light a point by
    area and a uniform direction turned to its normal's side, an infinite
    light its map's direction (or a uniform one) from the world disk. Each
    type the table holds is evaluated on every lane and kept where the
    lane's light has it."""
    emit = lt.emit[light_idx]
    sphere_pdf = torch.full_like(u1, smp.UNIFORM_SPHERE_PDF)
    out = None
    for code in lt.active_types:
        if code in (POINT, PROJECTION, GONIO):
            d = smp.uniform_sample_sphere(u1, u2)
            Le = emit if code == POINT else (
                _proj_gonio_scale(lt, light_idx, d, code == PROJECTION) * emit)
            res = (lt.pos[light_idx], d, d, Le, sphere_pdf)
        elif code == SPOT:
            ct = lt.cos_total[light_idx]
            axis = lt.dirw[light_idx]
            ax, ay = geom.coordinate_system(axis)
            dl = smp.uniform_sample_cone(u1, u2, ct)
            d = (dl[:, 0:1] * ax + dl[:, 1:2] * ay) + dl[:, 2:3] * axis
            cos_t = geom.dot(d, axis)
            cf = lt.cos_falloff[light_idx]
            delta = torch.clamp((cos_t - ct) / torch.clamp(cf - ct, min=1e-9), 0.0, 1.0)
            falloff = torch.where(cos_t < ct, 0.0,
                                  torch.where(cos_t > cf, 1.0, delta ** 2 * delta ** 2))
            res = (lt.pos[light_idx], d, d, emit * falloff[:, None], smp.uniform_cone_pdf(ct))
        elif code == DISTANT:
            d = lt.dirw[light_idx]
            wr = lt.world_radius
            res = (_disk_origin(lt, d, u1, u2), d, d, emit,
                   torch.full_like(u1, 1.0) / (math.pi * wr * wr))
        elif code == AREA:
            p_l, n_l, pdf_a = area_sample_point(lt, g, light_idx, u1, u2)
            d = smp.uniform_sample_sphere(u3, u4)
            d = torch.where((geom.dot(d, n_l) < 0.0)[:, None], -d, d)
            res = (p_l, d, n_l, emit, pdf_a * (0.5 / math.pi))
        elif code == INFINITE:
            res = _le_infinite(lt, light_idx, emit, u1, u2, u3, u4)
        else:
            raise ValueError(f"unknown light type {code}")
        if out is None:
            out = res
        else:
            m = lt.type[light_idx] == code
            out = tuple(torch.where(m[:, None] if a.dim() == 2 else m, a, b)
                        for a, b in zip(res, out))
    p, d, n, Le, pdf = out
    return EmissionSample(p=p, d=d, n=n, Le=Le, pdf=pdf)
