"""The path integrator as a wavefront (port of ``pbrt_tpu/integrators/path.py``
for ``kind="path"``; reference: src/integrators/path.cpp:44-110 with
UniformSampleOneLight / EstimateDirect, core/integrator.cpp:74-180).

Per bounce: closest-hit traversal → emitted/escaped radiance with MIS
(``accumulate_hit``) → one-light next-event estimation with an any-hit
shadow ray → BSDF sampling → Russian roulette after bounce ``rr_depth``.
Dead lanes are masked, not compacted; their rays get tmax = 0 so the
traversal lets them go at once.

Randomness: every decision reads a column of an explicit (R, 5 + 7·D)
primary-sample array through ``PrimarySource`` (path.py:129-160): columns
[0:5) are the camera's, and bounce b owns the block of 7 at 5 + 7b:
[light_sel, light_u1, light_u2, bsdf_lobe, bsdf_u1, bsdf_u2, rr]. The
renderer fills the bounce columns from the same threefry keys as the JAX
package's ``BatchedKeySource`` (``core/rng.py``), whose eighth, unread
"spare" column per bounce is dropped, so a seed gives the same bits in both
packages; fed the same array, both trace the same paths
(tests/test_torch_path.py).

Written differently from the reference on purpose:
- the RR gate is a real boolean (path.py:682 applies ``~`` to a Python
  bool and leans on int32 promotion to get the same masks);
- the pending shadow ray's tmax is zeroed once (path.py:249 zeroes it a
  second time, which changes nothing);
- textures, volumes and the merged shadow+closest batch are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_torch.accel.intersect import SceneGeometry, intersect
from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import spectrum as spec
from pbrt_torch.core.interaction import offset_ray_origin, surface_interaction
from pbrt_torch.lights import table as lights_mod
from pbrt_torch.materials import table as mat_mod


@dataclasses.dataclass
class RenderScene:
    geometry: SceneGeometry
    materials: mat_mod.MaterialTable
    lights: lights_mod.LightTable


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    kind: str = "path"
    max_depth: int = 5
    rr_depth: int = 3  # RR starts after this many bounces (path.cpp:95)
    n_bins: int = 32


class PrimarySource:
    """Uniform columns of an explicit (R, 5 + 7·D) array (path.py:129)."""

    CAMERA_DIMS = 5
    PER_BOUNCE = 7
    LIGHT_SELECT, LIGHT_SAMPLE, BSDF_SAMPLE, ROULETTE = 0, 1, 3, 6

    def __init__(self, u):
        self.u = u

    @staticmethod
    def n_dims(max_depth: int) -> int:
        return PrimarySource.CAMERA_DIMS + PrimarySource.PER_BOUNCE * max_depth

    def get(self, bounce: int, offset: int, n: int):
        col = self.CAMERA_DIMS + bounce * self.PER_BOUNCE + offset
        return self.u[:, col:col + n]


def _shadow_unoccluded(g, p, ng, wi, dist, eps):
    """Any-hit shadow rays; True where the light point is visible
    (VisibilityTester::Unoccluded)."""
    o = offset_ray_origin(p, ng, wi, eps)
    big = torch.full_like(dist, 1e30)
    tmax = torch.where(torch.isfinite(dist), dist * (1.0 - 1e-3) - eps, big)
    rays = geom.Ray(origin=o, direction=wi, tmin=torch.zeros_like(dist),
                    tmax=torch.clamp(tmax, min=0.0), time=torch.zeros_like(dist))
    return ~intersect(g, rays, any_hit=True).valid


def _nee_one_light(scene: RenderScene, si, lm, wo_local, frame, source,
                   bounce: int, active):
    """One-light NEE with MIS; (R, S) already times the light count."""
    lt = scene.lights
    n_lights = lt.count
    ss, ts, ns = frame
    u_sel = source.get(bounce, PrimarySource.LIGHT_SELECT, 1)[:, 0]
    u = source.get(bounce, PrimarySource.LIGHT_SAMPLE, 2)
    light_idx = torch.clamp((u_sel * n_lights).to(torch.int64), max=n_lights - 1)
    ls = lights_mod.sample_li(lt, scene.geometry, light_idx, si.p, u[:, 0], u[:, 1])
    wi_local = bxdf.world_to_local(ls.wi, ss, ts, ns)
    ng_loc = bxdf.world_to_local(si.ng, ss, ts, ns)
    f = mat_mod.bsdf_f(lm, wo_local, wi_local, ng_loc=ng_loc)
    cos_i = geom.absdot(ls.wi, ns)
    candidate = (active & (ls.pdf > 0.0) & (cos_i > 0.0)
                 & (f > 0.0).any(-1) & (ls.L > 0.0).any(-1))
    pdf_b = mat_mod.bsdf_pdf(lm, wo_local, wi_local)
    w_mis = smp.power_heuristic(1.0, ls.pdf, 1.0, pdf_b)  # area lights: not delta
    contrib = f * ls.L * (cos_i * w_mis / torch.clamp(ls.pdf, min=1e-12))[:, None]
    # zero-contribution lanes get dist 0 → tmax 0 → no traversal
    visible = _shadow_unoccluded(
        scene.geometry, si.p, si.ng, ls.wi,
        torch.where(candidate, ls.dist, 0.0), si.ray_epsilon,
    )
    ok = candidate & visible
    return torch.where(ok[:, None], contrib * n_lights, 0.0)


def trace_radiance(scene: RenderScene, rays: geom.Ray, cfg: IntegratorConfig,
                   uniforms: torch.Tensor):
    """(R,) rays → (L (R, S), first_hit_t (R,)). ``uniforms`` is the
    (R, 5 + 7·max_depth) primary-sample array (see the module docstring)."""
    if cfg.kind != "path":
        raise NotImplementedError(f"integrator {cfg.kind!r} is not ported yet")
    S = scene.materials.kd.shape[-1]
    R = rays.origin.shape[0]
    dev = rays.origin.device
    g = scene.geometry
    lt = scene.lights
    n_lights = max(lt.count, 1)
    source = PrimarySource(uniforms)

    def accumulate_hit(L, ray, hit, si, throughput, alive, specular_bounce,
                       prev_bsdf_pdf):
        """Emissive-hit accumulation with MIS weights (no env lights)."""
        if lt.count == 0:
            return L
        le = lights_mod.emitted_radiance(lt, si.area_light, si.ng, si.wo)
        pdf_light_hit = lights_mod.pdf_li_hit(lt, g, si.area_light, ray.origin)
        w_hit = torch.where(
            specular_bounce, 1.0,
            smp.power_heuristic(1.0, prev_bsdf_pdf, 1.0, pdf_light_hit / n_lights),
        )
        emissive = si.valid & alive & (si.area_light >= 0)
        return L + torch.where(emissive[:, None],
                               throughput * le * w_hit[:, None], 0.0)

    ray = rays
    L = torch.zeros((R, S), dtype=torch.float32, device=dev)
    throughput = torch.ones((R, S), dtype=torch.float32, device=dev)
    alive = geom.length_sq(rays.direction) > 0.5
    specular_bounce = torch.ones(R, dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.ones(R, dtype=torch.float32, device=dev)
    first_hit_t = torch.zeros(R, dtype=torch.float32, device=dev)
    for bounce in range(cfg.max_depth):
        hit = intersect(g, ray)
        si = surface_interaction(g, ray, hit)
        if bounce == 0:
            first_hit_t = torch.where(si.valid, hit.t, 0.0)
        L = accumulate_hit(L, ray, hit, si, throughput, alive,
                           specular_bounce, prev_bsdf_pdf)
        alive = alive & si.valid

        lm = mat_mod.gather_lane(scene.materials, si.material)
        ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
        frame = (ss, ts, si.ns)
        wo_local = bxdf.world_to_local(si.wo, ss, ts, si.ns)

        nee_active = alive & ~mat_mod.has_delta_only(lm)
        if lt.count > 0:
            L = L + throughput * _nee_one_light(
                scene, si, lm, wo_local, frame, source, bounce, nee_active)

        ub = source.get(bounce, PrimarySource.BSDF_SAMPLE, 3)
        wi_local, f, pdf, is_delta = mat_mod.bsdf_sample(
            lm, wo_local, ub[:, 0], ub[:, 1], ub[:, 2],
            ng_loc=bxdf.world_to_local(si.ng, ss, ts, si.ns),
        )
        wi_world = bxdf.local_to_world(wi_local, ss, ts, si.ns)
        cos_i = geom.absdot(wi_world, si.ns)
        ok = alive & (pdf > 0.0) & (f > 0.0).any(-1)
        throughput = torch.where(
            ok[:, None],
            throughput * f * (cos_i / torch.clamp(pdf, min=1e-12))[:, None],
            throughput,
        )
        alive = ok
        specular_bounce = is_delta & ok
        prev_bsdf_pdf = pdf

        # Russian roulette (path.cpp:95-100), a boolean gate
        if bounce > cfg.rr_depth:
            cont_p = torch.clamp(spec.luminance(throughput), max=0.5)
            u_rr = source.get(bounce, PrimarySource.ROULETTE, 1)[:, 0]
            survive = u_rr < cont_p
            throughput = torch.where(
                (alive & survive)[:, None],
                throughput / torch.clamp(cont_p, min=1e-6)[:, None],
                throughput,
            )
            alive = alive & survive

        o_new = offset_ray_origin(si.p, si.ng, wi_world, si.ray_epsilon)
        ray = geom.Ray(
            origin=torch.where(alive[:, None], o_new, ray.origin),
            direction=torch.where(alive[:, None], wi_world, ray.direction),
            tmin=torch.zeros_like(ray.tmin),
            tmax=torch.where(alive, math.inf, 0.0),
            time=ray.time,
        )
    # one more intersection to collect Le on the last segment
    hit = intersect(g, ray)
    si = surface_interaction(g, ray, hit)
    if cfg.max_depth == 0:
        first_hit_t = torch.where(si.valid, hit.t, 0.0)
    L = accumulate_hit(L, ray, hit, si, throughput, alive, specular_bounce,
                       prev_bsdf_pdf)
    return L, first_hit_t
