"""Precomputed radiance transfer: ``diffuseprt`` and ``glossyprt`` (port of
``pbrt_tpu/integrators/prt.py``; reference: src/integrators/diffuseprt.cpp,
glossyprt.cpp, core/sh.cpp).

The preprocess (``project_incident_radiance``) projects the incident
radiance at the world bound's centre into SH: D = max(nsamples, 16) rays
in uniform-sphere directions, traced by ``directlighting`` at depth 1,
then one (D, terms)ᵀ × (D, S) product. No sampled direction can hit a
delta light, so its own radiance is absent from ``c_in`` (prt.py:25-27);
its light reflected by the surfaces the rays hit is in it (their NEE
samples it).

At each camera ray's first hit (``_hit_setup``: emitted light there, the
infinite lights' radiance where it escapes, textures bound):
- ``diffuseprt`` projects cos⁺ × visibility of N = ``prt_nsamples``
  uniform-sphere shadow rays into a transfer vector and dots it with
  ``c_in``, times kd/π (a mix lane takes its first material's kd,
  prt.py:140);
- ``glossyprt`` is the reference's direct-sampling branch, not its SH
  rotation (prt.py:17-23): N BSDF samples, each visible one weighted by
  f·|cos|/pdf times the reconstructed, clamped incident radiance.

Randomness, keyed as the JAX package keys it: the projection's directions
are ``uniform(root_key(seed + 77), (D, 2))`` (``rng.flat_uniforms``) and
its trace's bounce block is ``BatchedKeySource`` of the keys (seed + 78,
direction i, sample 0) (one chain launch); the per-hit samples are
``uniform_per(bounce_key(keys, k, LIGHT_SAMPLE | BSDF_SAMPLE), 2 | 3)``
for k < N, the wave's ``draws["prt"]`` (``prt_draws``: one chain launch
per wave and chunk). Dead lanes, and samples that cannot contribute, trace
no shadow ray (tmax 0).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_torch.accel.intersect import intersect
from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import sh
from pbrt_torch.core.interaction import surface_interaction
from pbrt_torch.lights import table as lights_mod
from pbrt_torch.materials import table as mat_mod

#: the projection's key seeds (prt.py:64, :70)
DIRECTION_SEED, TRACE_SEED = 77, 78


@dataclasses.dataclass
class PRTData:
    """The preprocess product: SH lighting coefficients at the scene's
    centre."""

    c_in: torch.Tensor  # (terms, S)
    lmax: int = 4


def project_incident_radiance(scene, cfg, lmax: int, nsamples: int, seed: int = 0) -> PRTData:
    """SHProjectIncidentDirectRadiance (diffuseprt.cpp:48-56; prt.py:53-79)."""
    from pbrt_torch.integrators.path import IntegratorConfig, trace_radiance
    from pbrt_torch.renderers.sampler import key_uniforms

    g = scene.geometry
    dev = g.world_lo.device
    D = max(int(nsamples), 16)
    u = rng.flat_uniforms(rng.root_key(seed + DIRECTION_SEED), D, 2, dev)
    w = smp.uniform_sample_sphere(u[:, 0], u[:, 1])
    center = 0.5 * (g.world_lo + g.world_hi)
    rays = geom.Ray.make(center.expand(D, 3).contiguous(), w)
    root, idx = rng.root_key(seed + TRACE_SEED), torch.arange(D, device=dev)
    dl_cfg = IntegratorConfig(kind="directlighting", max_depth=1, strategy="all",
                              volume_kind="none", n_bins=cfg.n_bins)
    media = rng.volume_uniforms(root, idx, 0, 1, False) if scene.has_volumes else None
    L, _ = trace_radiance(scene, rays, dl_cfg, key_uniforms(dl_cfg, root, idx, 0), media=media)
    return PRTData(c_in=sh.project_directions(w, L, lmax), lmax=lmax)


def prt_draws(root, pixel_index, sample: int, cfg):
    """The wave's per-hit samples, (R, 2N) for ``diffuseprt``, (R, 3N) for
    ``glossyprt``: sample k's at columns nk … nk + n − 1."""
    purpose, n = ((rng.LIGHT_SAMPLE, 2) if cfg.kind == "diffuseprt"
                  else (rng.BSDF_SAMPLE, 3))
    return rng.chain_uniforms(root, pixel_index, sample, chain=[(purpose, cfg.prt_nsamples)],
                              n=n)


def _hit_setup(scene, rays):
    """The first hit, its lane's material and the radiance it starts with
    (prt.py:82-107) → (si, lm, L, first hit t)."""
    from pbrt_torch.integrators.path import apply_textures

    g = scene.geometry
    hit = intersect(g, rays)
    if scene.has_textures:
        spread = scene.pixel_spread if scene.pixel_spread > 0.0 else None
        si = surface_interaction(g, rays, hit, partials=True, spread=spread)
    else:
        si = surface_interaction(g, rays, hit)
    first_hit_t = torch.where(si.valid, hit.t, 0.0)
    lm = mat_mod.gather_lane(scene.materials, si.material)
    if scene.has_textures:
        si, lm = apply_textures(scene, si, lm)
    L = torch.zeros((rays.origin.shape[0], scene.materials.kd.shape[-1]),
                    dtype=torch.float32, device=rays.origin.device)
    lt = scene.lights
    if lt.count > 0:
        # Le at the hit, the infinite lights' radiance where it escapes
        # (diffuseprt.cpp:69; samplerrenderer.cpp:241-242)
        le = lights_mod.emitted_radiance(lt, si.area_light, si.ng, si.wo)
        L = L + torch.where(si.valid[:, None], le, 0.0)
        L = L + torch.where(si.valid[:, None], 0.0, lights_mod.le_escaped(lt, rays.direction))
    return si, lm, L, first_hit_t


def _far(mask):
    """The shadow rays' distance: unbounded where ``mask``, else 0 (no
    traversal)."""
    return torch.where(mask, 1e30, 0.0)


def diffuseprt_li(scene, rays, cfg, draws):
    """DiffusePRTIntegrator::Li (diffuseprt.cpp:63-88; prt.py:110-142)."""
    from pbrt_torch.integrators.path import _shadow_unoccluded

    prt = scene.prt
    si, lm, L, first_hit_t = _hit_setup(scene, rays)
    n = geom.face_forward(si.ns, si.wo)
    N = cfg.prt_nsamples
    u = draws["prt"]
    c_transfer = torch.zeros((L.shape[0], sh.sh_terms(prt.lmax)), dtype=torch.float32,
                             device=L.device)
    for k in range(N):
        w = smp.uniform_sample_sphere(u[:, 2 * k], u[:, 2 * k + 1])
        cos_t = torch.clamp(geom.dot(w, n), min=0.0)
        vis = _shadow_unoccluded(scene.geometry, si.p, si.ng, w, _far(si.valid & (cos_t > 0.0)),
                                 si.ray_epsilon)
        weight = cos_t * vis.to(cos_t.dtype) * (4.0 * math.pi / N)
        c_transfer = c_transfer + sh.sh_evaluate(w, prt.lmax) * weight[:, None]
    lo = torch.clamp(c_transfer @ prt.c_in, min=0.0)  # Lo.Clamp() (diffuseprt.cpp:87)
    kd = lm.lm1.kd if isinstance(lm, mat_mod.MixLane) else lm.kd
    return L + torch.where(si.valid[:, None], kd / math.pi * lo, 0.0), first_hit_t


def glossyprt_li(scene, rays, cfg, draws):
    """GlossyPRTIntegrator::Li by the direct-sampling branch (glossyprt.cpp
    ``#if 0``; prt.py:145-178): E[f·|cos|/pdf · V · L_SH(wi)]."""
    from pbrt_torch.integrators.path import _shadow_unoccluded

    prt = scene.prt
    si, lm, L, first_hit_t = _hit_setup(scene, rays)
    ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
    wo_local = bxdf.world_to_local(si.wo, ss, ts, si.ns)
    N = cfg.prt_nsamples
    u = draws["prt"]
    acc = torch.zeros_like(L)
    for k in range(N):
        wi_local, f, pdf, _ = mat_mod.bsdf_sample(lm, wo_local, u[:, 3 * k], u[:, 3 * k + 1],
                                                  u[:, 3 * k + 2])
        wi = bxdf.local_to_world(wi_local, ss, ts, si.ns)
        cos_i = geom.absdot(wi, si.ns)
        vis = _shadow_unoccluded(scene.geometry, si.p, si.ng, wi, _far(si.valid & (pdf > 0.0)),
                                 si.ray_epsilon)
        li = torch.clamp(sh.reconstruct(wi, prt.c_in, prt.lmax), min=0.0)
        ok = (pdf > 0.0) & vis
        contrib = f * li * (cos_i / torch.clamp(pdf, min=1e-12))[:, None]
        acc = acc + torch.where(ok[:, None], contrib, 0.0) / N
    return L + torch.where(si.valid[:, None], acc, 0.0), first_hit_t
