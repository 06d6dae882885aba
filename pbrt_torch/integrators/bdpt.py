"""The Metropolis renderer's bidirectional path estimator (port of
``pbrt_tpu/integrators/bdpt.py``; reference: src/renderers/metropolis.cpp
GeneratePath :187-290, Lbidir :387-470).

``trace_bidir`` builds, for the whole wavefront, a camera subpath and a
light subpath of D = ``max_depth`` vertices each (``_gen_subpath``: per
vertex its point, normals, shading frame, lane material, throughput and
whether its material is specular only), then combines them per camera
vertex i: emitted light where the bounce before was specular; one-light
NEE weighted 1 / (i + 1 − nSpec[i + 1]); and a connection to every light
vertex j, f_c · f_l · G with an any-hit shadow ray, weighted 1 / (i + j + 2
− nSpec[i + j + 2]), specular vertices left out of both (metropolis.cpp:
398-459); rays that escape after a specular bounce collect the infinite
lights. The light subpath starts as the JAX package starts it: a light
picked uniformly, a point on it from ``sample_li`` at the world centre (2
world radii out for a light at infinity), a uniform-sphere direction,
throughput L · 4π · n_lights / pdf.

Every decision reads the primary-sample vector u (R, ``n_dims_bidir(D)``):
the path integrator's camera and bounce columns (``PrimarySource``), then
the light subpath's 5 emission columns and 3 BSDF columns per bounce
(``_LightSource``). The JAX package's fallback to fresh keys when no
vector is given is not reached by any renderer and is not ported.

Kept as the JAX package has it: the BSDF samples and connection BSDFs
take no geometric-normal test; a dead lane's later vertices are invalid.
Dead lanes, and connections that cannot contribute, trace no ray (tmax 0).

In a scene with volumes only the NEE at camera vertex i is attenuated,
its shadow segment's transmittance jittered by ``media[:, i]`` (the
chain's key folded with i·16 + VOLUME, bdpt.py:206-209 into path.py:
224-231). The light-vertex connections take a bare any-hit test with no
transmittance, and no camera segment is integrated, though the JAX
docstring (bdpt.py:21) says connection rays are attenuated (ROADMAP fact
52, copied).
"""

from __future__ import annotations

import math

import torch

from pbrt_torch.accel.intersect import intersect
from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core.interaction import offset_ray_origin, surface_interaction
from pbrt_torch.integrators.path import (PrimarySource, _nee_one_light, _shadow_unoccluded,
                                         apply_textures)
from pbrt_torch.lights import table as lights_mod
from pbrt_torch.materials import table as mat_mod


class _LightSource:
    """The light subpath's block of the primary-sample vector, after the
    path integrator's columns (bdpt.py:42-65)."""

    EMIT_DIMS = 5  # light pick, area u1 / u2, direction u1 / u2
    PER_BOUNCE = 3  # BSDF lobe, u1, u2

    def __init__(self, u, max_depth: int):
        self.u = u
        self.base = PrimarySource.n_dims(max_depth)

    def emit(self):
        return self.u[:, self.base:self.base + self.EMIT_DIMS]

    def bsdf(self, bounce: int):
        c = self.base + self.EMIT_DIMS + bounce * self.PER_BOUNCE
        return self.u[:, c:c + self.PER_BOUNCE]


def n_dims_bidir(max_depth: int) -> int:
    """The primary-sample vector's length: 5 + 7·D + 5 + 3·D (bdpt.py:68)."""
    return (PrimarySource.n_dims(max_depth) + _LightSource.EMIT_DIMS
            + _LightSource.PER_BOUNCE * max_depth)


def _gen_subpath(scene, ray, n_verts: int, bsdf_uniforms):
    """GeneratePath (bdpt.py:74-134): ``n_verts`` vertices from ``ray``,
    bounce b's BSDF sample from ``bsdf_uniforms(b)`` (R, 3) → (the
    vertices as dicts, (throughput, direction, previous bounce specular) of
    the lanes that escaped)."""
    g = scene.geometry
    R = ray.origin.shape[0]
    dev = ray.origin.device
    S = scene.materials.kd.shape[-1]
    alpha = torch.ones((R, S), dtype=torch.float32, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    esc_alpha = torch.zeros((R, S), dtype=torch.float32, device=dev)
    esc_dir = ray.direction
    esc_prev_spec = torch.zeros(R, dtype=torch.bool, device=dev)
    prev_spec = torch.ones(R, dtype=torch.bool, device=dev)  # the origin counts as specular
    spread = scene.pixel_spread if scene.pixel_spread > 0.0 else None
    verts = []
    for b in range(n_verts):
        hit = intersect(g, ray)
        if scene.has_textures:
            si = surface_interaction(g, ray, hit, partials=True, spread=spread)
        else:
            si = surface_interaction(g, ray, hit)
        escaped_now = alive & ~si.valid
        esc_alpha = torch.where(escaped_now[:, None], alpha, esc_alpha)
        esc_dir = torch.where(escaped_now[:, None], geom.normalize(ray.direction), esc_dir)
        esc_prev_spec = torch.where(escaped_now, prev_spec, esc_prev_spec)
        alive = alive & si.valid
        lm = mat_mod.gather_lane(scene.materials, si.material)
        if scene.has_textures:
            si, lm = apply_textures(scene, si, lm)
        ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
        wo_local = bxdf.world_to_local(si.wo, ss, ts, si.ns)
        verts.append(dict(valid=alive, si=si, lm=lm, alpha=alpha, wo_local=wo_local,
                          frame=(ss, ts, si.ns), specular=mat_mod.has_delta_only(lm),
                          prev_spec=prev_spec, first_t=hit.t))
        ub = bsdf_uniforms(b)
        wi_local, f, pdf, is_delta = mat_mod.bsdf_sample(lm, wo_local, ub[:, 0], ub[:, 1],
                                                         ub[:, 2])
        wi = bxdf.local_to_world(wi_local, ss, ts, si.ns)
        cos_i = geom.absdot(wi, si.ns)
        ok = alive & (pdf > 0.0) & (f > 0.0).any(-1)
        alpha = torch.where(ok[:, None],
                            alpha * f * (cos_i / torch.clamp(pdf, min=1e-12))[:, None], alpha)
        prev_spec = is_delta
        alive = ok
        o_new = offset_ray_origin(si.p, si.ng, wi, si.ray_epsilon)
        ray = geom.Ray.make(torch.where(alive[:, None], o_new, ray.origin),
                            torch.where(alive[:, None], wi, ray.direction),
                            tmax=torch.where(alive, math.inf, 0.0), time=ray.time)
    return verts, (esc_alpha, esc_dir, esc_prev_spec)


def trace_bidir(scene, rays, cfg, uniforms, media=None):
    """Lbidir over the wavefront (bdpt.py:137-248) → (L (R, S), first hit
    t (R,)); ``uniforms`` (R, ``n_dims_bidir(cfg.max_depth)``); ``media``:
    the media block of a scene with volumes, ``media[:, i]`` the
    transmittance jitter of camera vertex i's NEE."""
    if scene.has_volumes and media is None:
        raise ValueError("a scene with volumes needs its media block")
    g, lt = scene.geometry, scene.lights
    R = rays.origin.shape[0]
    D = cfg.max_depth
    dev = rays.origin.device
    source = PrimarySource(uniforms)
    light_src = _LightSource(uniforms, D)
    cam, (e_alpha, e_dir, e_prev) = _gen_subpath(
        scene, rays, D, lambda b: source.get(b, PrimarySource.BSDF_SAMPLE, 3))
    first_hit_t = torch.where(cam[0]["valid"], cam[0]["first_t"], 0.0)
    L = torch.zeros((R, scene.materials.kd.shape[-1]), dtype=torch.float32, device=dev)
    if lt.count == 0:
        return L, first_hit_t

    # the light subpath: a uniform pick, a point on the light toward the
    # world centre, a uniform-sphere direction (bdpt.py:157-180)
    n_lights = lt.count
    ue = light_src.emit()
    li = torch.clamp((ue[:, 0] * n_lights).to(torch.int64), max=n_lights - 1)
    center = lt.world_center.expand(R, 3)
    ls0 = lights_mod.sample_li(lt, g, li, center, ue[:, 1], ue[:, 2])
    p0 = center + ls0.wi * torch.where(torch.isfinite(ls0.dist), ls0.dist,
                                       2.0 * lt.world_radius)[:, None]
    ct = 1.0 - 2.0 * ue[:, 3]
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = 2 * math.pi * ue[:, 4]
    d0 = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    alpha_l0 = ls0.L * (4.0 * math.pi * n_lights / torch.clamp(ls0.pdf, min=1e-9))[:, None]
    lray = geom.Ray.make(p0 + 1e-3 * d0, d0, time=rays.time)
    lverts, _ = _gen_subpath(scene, lray, D, light_src.bsdf)
    for v in lverts:
        v["alpha"] = v["alpha"] * alpha_l0

    # nSpec[k]: the specular pairs among the strategies of length k
    # (metropolis.cpp:398-403)
    n_spec = [torch.zeros(R, dtype=torch.int64, device=dev) for _ in range(2 * D + 2)]
    for i in range(D):
        for j in range(D):
            sij = ((cam[i]["specular"] | lverts[j]["specular"]) & cam[i]["valid"]
                   & lverts[j]["valid"])
            n_spec[i + j + 2] = n_spec[i + j + 2] + sij.to(torch.int64)

    for i, vc in enumerate(cam):
        si_c, active = vc["si"], vc["valid"]
        # emitted light where the bounce before was specular (:412-414); a
        # scene without area lights has no emission row to read
        if lights_mod.AREA in lt.active_types:
            le = lights_mod.emitted_radiance(lt, si_c.area_light, si_c.ng, si_c.wo)
            L = L + torch.where((active & vc["prev_spec"])[:, None], vc["alpha"] * le, 0.0)
        nee = _nee_one_light(scene, si_c, vc["lm"], vc["wo_local"], vc["frame"], source, i,
                             active & ~vc["specular"], media)
        denom = torch.clamp(i + 1 - n_spec[i + 1], min=1).to(torch.float32)
        L = L + vc["alpha"] * nee / denom[:, None]
        # connections to the light vertices (:437-459)
        for j, vl in enumerate(lverts):
            si_l = vl["si"]
            pair_ok = active & vl["valid"] & ~vc["specular"] & ~vl["specular"]
            delta = si_l.p - si_c.p
            dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-12)
            w = delta / torch.sqrt(dist2)[:, None]
            fc = mat_mod.bsdf_f(vc["lm"], vc["wo_local"], bxdf.world_to_local(w, *vc["frame"]))
            fl = mat_mod.bsdf_f(vl["lm"], vl["wo_local"], bxdf.world_to_local(-w, *vl["frame"]))
            pair_ok = pair_ok & (fc > 0).any(-1) & (fl > 0).any(-1)
            dist = torch.sqrt(dist2)
            vis = _shadow_unoccluded(g, si_c.p, si_c.ng, w,
                                     torch.where(pair_ok, dist * 0.999, 0.0), si_c.ray_epsilon)
            G = geom.absdot(si_c.ns, w) * geom.absdot(si_l.ns, w) / dist2
            wt = 1.0 / torch.clamp(i + j + 2 - n_spec[i + j + 2], min=1).to(torch.float32)
            contrib = vc["alpha"] * fc * fl * vl["alpha"] * (G * wt)[:, None]
            L = L + torch.where((pair_ok & vis)[:, None], contrib, 0.0)

    # escaped rays after a specular bounce (:462-466)
    return L + torch.where(e_prev[:, None], e_alpha * lights_mod.le_escaped(lt, e_dir),
                           0.0), first_hit_t
