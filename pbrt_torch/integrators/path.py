"""The surface integrators as a wavefront (port of
``pbrt_tpu/integrators/path.py``; reference: src/integrators/path.cpp:44-110
with UniformSampleOneLight / EstimateDirect, core/integrator.cpp:74-180;
directlighting.cpp, whitted.cpp, ambientocclusion.cpp:47-87 and the fork's
metadata.cpp:42-80).

``path``, ``directlighting`` and ``whitted`` share one bounce loop:
closest-hit traversal → emitted radiance with MIS (``accumulate_hit``) →
one-light next-event estimation with an any-hit shadow ray → BSDF sampling
→ Russian roulette after bounce ``rr_depth`` (``path`` only). The direct
integrators continue only along delta lobes (specular recursion);
``directlighting`` shoots its non-delta BSDF sample as a gather-only lane
that collects Le with MIS on the next segment and stops (EstimateDirect's
BSDF half, path.py:655-672), ``whitted`` drops it (path.py:664). Dead
lanes are masked, not compacted; their rays get tmax = 0 so the traversal
lets them go at once. ``ambientocclusion`` casts ``ao_nsamples``
cosine-distributed any-hit rays from the first hit (``_ao_li``);
``metadata`` returns the first hit's depth, mesh id or material id + 1 as
radiance (``_metadata_li``).

Randomness: every decision reads a column of an explicit primary-sample
array whose columns [0:5) are the camera's. For the bounce loop the array
is (R, 5 + 7·D) (``PrimarySource``, path.py:129-160): bounce b owns the
block of 7 at 5 + 7b: [light_sel, light_u1, light_u2, bsdf_lobe, bsdf_u1,
bsdf_u2, rr]. The renderer fills the bounce columns from the same threefry
keys as the JAX package's ``BatchedKeySource`` (``core/rng.py``), whose
eighth, unread "spare" column per bounce is dropped, so a seed gives the
same bits in both packages. For ambient occlusion the array is (R, 5 +
2·n): sample s reads columns 5 + 2s and 6 + 2s, the uniforms the JAX
package draws from the lane key folded with s·16 + BSDF_SAMPLE
(path.py:783-784). Metadata reads only the camera columns. Fed the same
array, both packages trace the same paths (tests/test_torch_path.py,
test_torch_integrators.py).

Kept as the JAX package has it (the port is held to it): NEE samples one
light whatever ``strategy`` says, ``whitted`` weights its light samples by
the MIS power heuristic without the BSDF half, and a kind that is not in
``KINDS`` runs the bounce loop with no kind's extras: ``path`` without
Russian roulette (path.py:677).

Written differently from the reference on purpose:
- the RR gate is a real boolean (path.py:682 applies ``~`` to a Python
  bool and leans on int32 promotion to get the same masks);
- the pending shadow ray's tmax is zeroed once (path.py:249 zeroes it a
  second time, which changes nothing);
- emission and the MIS pdf of a hit area light read its own light-table
  row (``lights/table.py``);
- the merged shadow+closest batch is not ported.

Participating media (``media/volumes.py``), where the scene has volumes,
in ``path``, ``directlighting`` and ``whitted`` (``ambientocclusion`` and
``metadata`` return before them, as in the JAX package): every NEE
contribution is multiplied by the transmittance of its shadow segment,
[0, dist] or [0, 1e4] toward an infinite distance (EstimateDirect's
Renderer::Transmittance, integrator.cpp:130; path.py:224-235), and after
the bounce loop the camera segment, [0, first hit] or [0, 1e4] on a miss,
gives ``T·L + Lv`` from the ``emission`` or ``single`` volume integrator
(samplerrenderer.cpp:244-246; path.py:748-771). Their uniforms come in a
media block beside the primary-sample array (``core/rng.py``:
``volume_uniforms``): bounce b's transmittance jitter in column b
(column 0 is also the camera segment's), then single scattering's three
per march step.

Textures (``apply_textures``, path.py:267-374) bind Kd and Ks per lane,
the fork's normal map, and pbrt's Material::Bump chain, before the
shading frame is built, in every kind that shades in the bounce loop.
Their footprint comes from the camera rays' differentials at the first
hit only (later bounces get none: unfiltered lookups and the bump
chain's .01 offsets), or from the pixel cone where no differentials are
given. A scene without textures computes none of it.

The preprocess integrators (``integrators/{dipole,photonmap,igi,
irradiance}.py``) run on the same loop. ``dipolesubsurface``, ``igi``
and ``photonmap`` are direct kinds (specular recursion, one gather-only
BSDF sample); after NEE each adds its term where NEE is active, as
path.py:596-645 does: the photon density estimate, the VPL sum (its picks
in the wave's ``draws["vpl"]``, bounce b's 8 at columns 8b …), or at a
subsurface hit (1/π)·Ft·Fdt·Mo. ``irradiancecache`` is
``irradiance_cache_li``: a ``directlighting`` trace plus the cached
gather, whose nested traces read ``draws["fill"]`` and ``draws["miss"]``.
``useprobes`` is ``useprobes_li``: a ``directlighting`` trace plus the
probes' irradiance (``integrators/irradiance.py``); ``diffuseprt`` and
``glossyprt`` are ``integrators/prt.py``'s first-hit estimators, whose
per-hit directions are the wave's ``draws["prt"]`` (path.py:396-407).

A ray that leaves the scene collects the infinite lights' radiance; a
mix material's lanes (``materials/table.py:MixLane``) and the measured
lobes' pools go through NEE and BSDF sampling as any other row's, and
transmitted continuations leave from the far side of the surface
(``offset_ray_origin`` picks its side by the direction).
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
from pbrt_torch.integrators import dipole, igi, photonmap
from pbrt_torch.lights import table as lights_mod
from pbrt_torch.materials import table as mat_mod
from pbrt_torch.media import volumes as vol_mod
from pbrt_torch.textures import texture as tex_mod

#: the integrator kinds the port renders
KINDS = ("path", "directlighting", "whitted", "ambientocclusion", "metadata",
         "dipolesubsurface", "igi", "photonmap", "irradiancecache", "useprobes",
         "diffuseprt", "glossyprt")
#: Russian roulette's cap and floor of the continuation probability
#: (path.py:679, :685): CPU scalars, which a CUDA op reads without a copy
_RR_CAP = torch.tensor(0.5)
_RR_FLOOR = torch.tensor(1e-6)
#: kinds whose BSDF samples continue only along delta lobes (path.py:656-657);
#: all but whitted also shoot their non-delta sample to gather Le
DIRECT_KINDS = ("directlighting", "whitted", "dipolesubsurface", "igi", "photonmap")


@dataclasses.dataclass
class RenderScene:
    geometry: SceneGeometry
    materials: mat_mod.MaterialTable
    lights: lights_mod.LightTable
    textures: tex_mod.TextureTable | None = None
    volumes: vol_mod.VolumeTable | None = None
    #: the preprocess products (path.py:51-55): dipole.SubsurfaceData,
    #: igi.VPLSet, photonmap.PhotonMaps, irradiance.ProbeGrid (useprobes'
    #: input), prt.PRTData (diffuseprt / glossyprt)
    subsurface: object = None
    vpls: object = None
    photons: object = None
    probes: object = None
    prt: object = None
    has_textures: bool = False
    has_volumes: bool = False
    has_subsurface: bool = False
    has_vpls: bool = False
    has_photons: bool = False
    #: the pixel cone's half-width per unit distance, for texture footprints
    #: without ray differentials (0: no footprint)
    pixel_spread: float = 0.0


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    kind: str = "path"  # one of KINDS
    max_depth: int = 5
    strategy: str = "all"  # directlighting's (parsed; NEE samples one light)
    rr_depth: int = 3  # RR starts after this many bounces (path.cpp:95)
    ao_nsamples: int = 4
    ao_maxdist: float = math.inf
    metadata_channel: str = "depth"  # depth | mesh_mask | material_mask
    volume_kind: str = "emission"  # emission | single | none
    n_bins: int = 32
    prt_nsamples: int = 32  # diffuseprt / glossyprt samples per hit (path.py:77)
    # the irradiance cache's knobs (irradiancecache.cpp:377-383; path.py:78-83)
    ic_minweight: float = 0.5
    ic_minspacing: float = 2.5  # in pixel spacings
    ic_maxspacing: float = 15.0
    ic_maxangle: float = 10.0  # degrees
    ic_stride: int = 8  # cache entries: every ic_stride-th lane of a wave


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
    (VisibilityTester::Unoccluded). Their wavelength stays 0, as the JAX
    package's (path.py:174)."""
    o = offset_ray_origin(p, ng, wi, eps)
    tmax = torch.where(torch.isfinite(dist), dist * (1.0 - 1e-3) - eps, 1e30)
    rays = geom.Ray(origin=o, direction=wi, tmin=torch.zeros_like(dist),
                    tmax=torch.clamp(tmax, min=0.0), time=torch.zeros_like(dist))
    return ~intersect(g, rays, any_hit=True).valid


def _nee_one_light(scene: RenderScene, si, lm, wo_local, frame, source,
                   bounce: int, active, media=None):
    """One-light NEE with MIS (delta lights weigh 1); (R, S) already times
    the light count. With volumes, ``media[:, bounce]`` is the shadow
    segment's transmittance jitter."""
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
    w_mis = torch.where(ls.is_delta, 1.0, smp.power_heuristic(1.0, ls.pdf, 1.0, pdf_b))
    contrib = f * ls.L * (cos_i * w_mis / torch.clamp(ls.pdf, min=1e-12))[:, None]
    if scene.has_volumes:
        t1 = torch.where(torch.isfinite(ls.dist), ls.dist, 1e4)
        contrib = contrib * vol_mod.transmittance(scene.volumes, si.p, ls.wi,
                                                  torch.zeros_like(t1), t1, media[:, bounce])
    # zero-contribution lanes get dist 0 → tmax 0 → no traversal
    visible = _shadow_unoccluded(
        scene.geometry, si.p, si.ng, ls.wi,
        torch.where(candidate, ls.dist, 0.0), si.ray_epsilon,
    )
    ok = candidate & visible
    return torch.where(ok[:, None], contrib * n_lights, 0.0)


def apply_textures(scene: RenderScene, si, lm):
    """Texture-bound Kd and Ks (clamped at 0, per sub-row of a mix lane),
    the normal map (evaluated without a footprint; it takes precedence
    where it is not black) and the bump map's displaced partials
    (Material::Bump, material.cpp:40-84) → (si, lm) (path.py:267-374)."""
    tt, mats = scene.textures, scene.materials
    rows = mats.tex_rows
    mi = si.material.clamp(min=0)
    fp = (si.uv_sigma, si.uv_major) if scene.pixel_spread > 0.0 else (None, None)

    def override(cur, col, mat_rows):
        if cur is None or not rows[col]:  # a field no lobe reads, or no texture
            return cur
        tid = getattr(mats, col)[mat_rows]
        val = torch.clamp(tex_mod.eval_spectrum(tt, tid, si.uv, si.p, *fp, rows=rows[col]),
                          min=0.0)
        return torch.where((tid >= 0)[:, None], val, cur)

    def apply_one(lane, mat_rows):
        return dataclasses.replace(lane, kd=override(lane.kd, "kd_tex", mat_rows),
                                   ks=override(lane.ks, "ks_tex", mat_rows))

    if isinstance(lm, mat_mod.MixLane):
        lm = dataclasses.replace(lm, lm1=apply_one(lm.lm1, lm.m1), lm2=apply_one(lm.lm2, lm.m2))
    else:
        lm = apply_one(lm, mi)
    use_nm = None
    if rows["normal_tex"]:
        # the fork's normal map: a tangent-space normal from RGB
        ntid = mats.normal_tex[mi]
        nm_spec = tex_mod.eval_spectrum(tt, ntid, si.uv, si.p, rows=rows["normal_tex"])
        t = 2.0 * spec.to_rgb(nm_spec) - 1.0
        ss0, ts0 = bxdf.make_shading_frame(si.ns, si.dpdu)
        n_new = geom.normalize(t[:, 0:1] * ss0 + t[:, 1:2] * ts0 + t[:, 2:3] * si.ns)
        use_nm = (ntid >= 0) & (nm_spec > 1e-6).any(-1)
        si = dataclasses.replace(si, ns=torch.where(use_nm[:, None], n_new, si.ns))
    if mats.has_bump:
        btid = mats.bump_tex[mi]
        has_b = btid >= 0 if use_nm is None else (btid >= 0) & ~use_nm
        # per-axis offsets from the uv differentials, .01 without them
        du = 0.5 * (si.duvdx[:, 0].abs() + si.duvdy[:, 0].abs())
        dv = 0.5 * (si.duvdx[:, 1].abs() + si.duvdy[:, 1].abs())
        du = torch.where(du > 1e-9, du, 0.01)
        dv = torch.where(dv > 1e-9, dv, 0.01)
        # the displacement at p, at u + du and at v + dv, in one evaluation
        zero = torch.zeros_like(du)
        uv3 = torch.cat([si.uv, si.uv + torch.stack([du, zero], -1),
                         si.uv + torch.stack([zero, dv], -1)])
        p3 = torch.cat([si.p, si.p + du[:, None] * si.dpdu, si.p + dv[:, None] * si.dpdv])
        fp3 = [None if x is None else torch.cat([x, x, x]) for x in fp]
        d0, d_u, d_v = tex_mod.eval_float(tt, btid.repeat(3), uv3, p3, *fp3,
                                          rows=rows["bump_tex"]).chunk(3)
        dpdu_b = si.dpdu + ((d_u - d0) / du)[:, None] * si.ns + d0[:, None] * si.dndu
        dpdv_b = si.dpdv + ((d_v - d0) / dv)[:, None] * si.ns + d0[:, None] * si.dndv
        n_b = geom.face_forward(geom.normalize(geom.cross(dpdu_b, dpdv_b)), si.ng)
        hb = has_b[:, None]
        si = dataclasses.replace(si, ns=torch.where(hb, n_b, si.ns),
                                 dpdu=torch.where(hb, dpdu_b, si.dpdu),
                                 dpdv=torch.where(hb, dpdv_b, si.dpdv))
    return si, lm


def trace_radiance(scene: RenderScene, rays: geom.Ray, cfg: IntegratorConfig,
                   uniforms: torch.Tensor, diffs=None, media=None, draws=None):
    """(R,) rays → (L (R, S), first_hit_t (R,)). ``uniforms`` is the kind's
    primary-sample array (see the module docstring); ``diffs``: the camera
    rays' differentials (rx_o, rx_d, ry_o, ry_d), read by textures at the
    first hit; ``media``: the media block of a scene with volumes;
    ``draws``: the wave's draws of ``igi``, ``irradiancecache``,
    ``diffuseprt`` and ``glossyprt`` (``renderers/sampler.py:
    integrator_draws``)."""
    if cfg.kind == "metadata":
        return _metadata_li(scene, rays, cfg)
    if cfg.kind == "ambientocclusion":
        return _ao_li(scene, rays, cfg, uniforms)
    if cfg.kind == "irradiancecache":
        from pbrt_torch.integrators.irradiance import irradiance_cache_li

        return irradiance_cache_li(scene, rays, cfg, uniforms, draws, media)
    if cfg.kind == "useprobes":
        from pbrt_torch.integrators.irradiance import useprobes_li

        return useprobes_li(scene, rays, cfg, uniforms, media)
    if cfg.kind in ("diffuseprt", "glossyprt"):
        from pbrt_torch.integrators import prt

        li = prt.diffuseprt_li if cfg.kind == "diffuseprt" else prt.glossyprt_li
        return li(scene, rays, cfg, draws)
    S = scene.materials.kd.shape[-1]
    R = rays.origin.shape[0]
    dev = rays.origin.device
    g = scene.geometry
    lt = scene.lights
    n_lights = max(lt.count, 1)
    source = PrimarySource(uniforms)
    if scene.has_volumes and media is None:
        raise ValueError("a scene with volumes needs its media block")
    use_vpls = cfg.kind == "igi" and scene.has_vpls
    if use_vpls and draws is None:
        raise ValueError("igi needs the wave's VPL picks (draws)")

    def accumulate_hit(L, ray, hit, si, throughput, alive, specular_bounce,
                       prev_bsdf_pdf):
        """Escaped rays' environment radiance and emissive hits, each with
        its MIS weight (path.py:440-494). The escape weight takes the pdf
        of the first infinite light only, while the radiance sums them all
        (path.py:454-458), as the JAX package does."""
        if lights_mod.INFINITE in lt.active_types:
            first = torch.full_like(si.area_light, lt.infinite_rows[0])
            pdf_env = lights_mod.pdf_li(lt, first, ray.direction)
            w_env = torch.where(
                specular_bounce, 1.0,
                smp.power_heuristic(1.0, prev_bsdf_pdf, 1.0, pdf_env / n_lights))
            le_bg = lights_mod.le_escaped(lt, ray.direction)
            L = L + torch.where((alive & ~si.valid)[:, None],
                                throughput * le_bg * w_env[:, None], 0.0)
        if lights_mod.AREA not in lt.active_types:
            return L
        le = lights_mod.emitted_radiance(lt, si.area_light, si.ng, si.wo)
        pdf_light_hit = lights_mod.pdf_li_hit(
            lt, g, si.area_light, ray.origin, ray.direction, hit.t, si.ng)
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
    gather_only = torch.zeros(R, dtype=torch.bool, device=dev)
    spread = scene.pixel_spread if scene.pixel_spread > 0.0 else None
    for bounce in range(cfg.max_depth):
        hit = intersect(g, ray)
        if scene.has_textures:
            # differentials hold for the camera rays only: later bounces get
            # no footprint where they were given (path.py:540-556)
            si = surface_interaction(g, ray, hit, partials=True,
                                     spread=spread if bounce == 0 or diffs is None else None,
                                     diffs=diffs if bounce == 0 else None)
        else:
            si = surface_interaction(g, ray, hit)
        if bounce == 0:
            first_hit_t = torch.where(si.valid, hit.t, 0.0)
        L = accumulate_hit(L, ray, hit, si, throughput, alive,
                           specular_bounce, prev_bsdf_pdf)
        # gather-only lanes exist to collect Le along their segment: they stop
        alive = alive & si.valid & ~gather_only

        lm = mat_mod.gather_lane(scene.materials, si.material)
        if scene.has_textures:
            si, lm = apply_textures(scene, si, lm)
        ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
        frame = (ss, ts, si.ns)
        wo_local = bxdf.world_to_local(si.wo, ss, ts, si.ns)

        nee_active = alive & ~mat_mod.has_delta_only(lm)
        if lt.count > 0:
            L = L + throughput * _nee_one_light(
                scene, si, lm, wo_local, frame, source, bounce, nee_active, media)

        # the preprocess integrators' terms (path.py:596-643)
        if cfg.kind == "photonmap" and scene.has_photons:
            lpho = photonmap.radiance_estimate(scene.photons, scene, si, lm)
            L = L + torch.where(nee_active[:, None], throughput * lpho, 0.0)
        if use_vpls:
            u_vpl = draws["vpl"][:, igi.VPL_SAMPLES * bounce:igi.VPL_SAMPLES * (bounce + 1)]
            L = L + throughput * torch.where(
                nee_active[:, None],
                igi.vpl_lighting(scene, scene.vpls, si, lm, wo_local, frame, u_vpl), 0.0)
        if cfg.kind == "dipolesubsurface" and scene.has_subsurface:
            # (1/π)·Ft·Fdt·Mo (DipoleSubsurfaceIntegrator::Li;
            # dipolesubsurface.cpp:290, Fdt = 1 − Fdr(η))
            mi = si.material.clamp(min=0)
            mk = scene.materials.kind[mi]
            is_ss = alive & ((mk == mat_mod.SUBSURFACE) | (mk == mat_mod.KDSUBSURFACE))
            mo = dipole.mo_gather(scene.subsurface, scene.materials, si.p, si.material, is_ss)
            eta_ss = scene.materials.eta[mi]
            ft = 1.0 - bxdf.fresnel_dielectric(bxdf.abs_cos_theta(wo_local), 1.0, eta_ss)
            fdt = 1.0 - dipole.fdr(eta_ss)
            L = L + torch.where(is_ss[:, None],
                                throughput * mo * (ft * fdt / math.pi)[:, None], 0.0)

        ub = source.get(bounce, PrimarySource.BSDF_SAMPLE, 3)
        wi_local, f, pdf, is_delta = mat_mod.bsdf_sample(
            lm, wo_local, ub[:, 0], ub[:, 1], ub[:, 2],
            ng_loc=bxdf.world_to_local(si.ng, ss, ts, si.ns),
        )
        wi_world = bxdf.local_to_world(wi_local, ss, ts, si.ns)
        cos_i = geom.absdot(wi_world, si.ns)
        ok = alive & (pdf > 0.0) & (f > 0.0).any(-1)
        gather_only = torch.zeros_like(ok)
        if cfg.kind in DIRECT_KINDS:
            # specular recursion continues; all but whitted shoot the
            # non-delta sample once, to gather Le (integrator.cpp:145-180)
            if cfg.kind != "whitted":
                gather_only = ok & ~is_delta
            ok = ok & is_delta
        step = ok | gather_only
        throughput = torch.where(
            step[:, None],
            throughput * f * (cos_i / torch.clamp(pdf, min=1e-12))[:, None],
            throughput,
        )
        alive = step
        specular_bounce = is_delta & ok
        prev_bsdf_pdf = pdf

        # Russian roulette (path.cpp:95-100), a boolean gate; minimum and
        # maximum as jnp's, which split the gradient at a tie (clamp passes it)
        if cfg.kind == "path" and bounce > cfg.rr_depth:
            cont_p = torch.minimum(spec.luminance(throughput), _RR_CAP)
            u_rr = source.get(bounce, PrimarySource.ROULETTE, 1)[:, 0]
            survive = u_rr < cont_p
            throughput = torch.where(
                (alive & survive)[:, None],
                throughput / torch.maximum(cont_p, _RR_FLOOR)[:, None],
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
            wavelength=ray.wavelength,
        )
    # one more intersection to collect Le on the last segment
    hit = intersect(g, ray)
    si = surface_interaction(g, ray, hit)
    if cfg.max_depth == 0:
        first_hit_t = torch.where(si.valid, hit.t, 0.0)
    L = accumulate_hit(L, ray, hit, si, throughput, alive, specular_bounce,
                       prev_bsdf_pdf)
    if scene.has_volumes and cfg.volume_kind != "none":
        # the camera segment: T·L + Lv (path.py:748-771; "none": the PRT
        # projection's trace, NEE's transmittance only)
        t_end = torch.where(first_hit_t > 0.0, first_hit_t, 1e4)
        d = geom.normalize(rays.direction)
        t0 = torch.zeros_like(t_end)
        if cfg.volume_kind == "single":
            n_j = media.shape[1] - vol_mod.TAU_STEPS * 3
            Lv, tr = vol_mod.integrate_single_scattering(
                scene.volumes, scene, rays.origin, d, t0, t_end, media[:, 0],
                media[:, n_j:].reshape(R, vol_mod.TAU_STEPS, 3))
        else:
            Lv, tr = vol_mod.integrate_emission(scene.volumes, rays.origin, d, t0, t_end,
                                                media[:, 0])
        L = tr * L + Lv
    return L, first_hit_t


def _first_hit(scene: RenderScene, rays):
    hit = intersect(scene.geometry, rays)
    si = surface_interaction(scene.geometry, rays, hit)
    return hit, si, torch.where(si.valid, hit.t, 0.0)


def _ao_li(scene: RenderScene, rays, cfg: IntegratorConfig, uniforms):
    """Cosine-weighted ambient occlusion (ambientocclusion.cpp:47-87): the
    visible fraction of ``ao_nsamples`` rays of length ``ao_maxdist``."""
    _, si, first_hit_t = _first_hit(scene, rays)
    ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
    n_vis = torch.zeros_like(si.t)
    maxdist = torch.full_like(si.t, cfg.ao_maxdist)
    for s in range(cfg.ao_nsamples):
        col = PrimarySource.CAMERA_DIMS + 2 * s
        w_local = smp.cosine_sample_hemisphere(uniforms[:, col], uniforms[:, col + 1])
        w = geom.face_forward(bxdf.local_to_world(w_local, ss, ts, si.ns), si.ns)
        free = _shadow_unoccluded(scene.geometry, si.p, si.ng, w, maxdist, si.ray_epsilon)
        n_vis = n_vis + free.to(torch.float32)
    frac = torch.where(si.valid, n_vis / cfg.ao_nsamples, 0.0)
    return frac[:, None].expand(-1, cfg.n_bins), first_hit_t


def _metadata_li(scene: RenderScene, rays, cfg: IntegratorConfig):
    """The fork's metadata integrator (metadata.cpp:42-80): depth, mesh id
    or material id + 1 of the first hit as radiance (0 on a miss)."""
    hit, si, first_hit_t = _first_hit(scene, rays)
    if cfg.metadata_channel == "depth":
        v = first_hit_t
    elif cfg.metadata_channel == "mesh_mask":
        v = torch.where(si.valid, si.mesh_id.to(torch.float32), 0.0)
    else:  # material_mask
        v = (torch.where(si.valid, si.material, -1) + 1).to(torch.float32)
    return v[:, None].expand(-1, cfg.n_bins), first_hit_t
