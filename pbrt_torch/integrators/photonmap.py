"""Photon mapping (port of ``pbrt_tpu/integrators/photonmap.py``; reference:
src/integrators/photonmap.{h,cpp}).

``shoot_photons`` traces light paths as a wavefront: a light picked by
power (``power_dist``), an emitted ray (``lights.sample_le``), then up to
``max_depth`` bounces through the closest-hit traversal, each sampling the
BSDF. Every bounce after the first records a photon where the surface has
a non-delta lobe: caustic where the previous bounce was specular, else
indirect (photonmap.cpp:300-470). ``radiance_estimate`` is a fixed-radius
density estimate over the photons in chunks of ``CHUNK``: the lanes
within the radius (squared distance |p|² − 2 p·q + |q|² ≤ r²) sum the
photons' powers, weighted by the Lambertian kd/π, over π r². The (R, 256)
mask times (256, S) power product is a ``torch.matmul``.

The uniforms are keyed as the JAX package keys them (photonmap.py:53-57,
:96-97): path i's key (root ``seed``, index i, sample 0), its first 5
uniforms for the light pick and emission, then bounce b's 3 under tag
b·16 + PHOTON: two ``keyed_chain_uniforms`` launches on the card.

Kept as the JAX package has it: only ``indirectphotons`` (paths = min(max(
n/16, 1024), 8192)) and ``maxphotondepth`` are read, the radius is 0.02 ×
the world radius, the estimate takes kd/π for every lobe
(photonmap.py:154-156), and ``exphotonmap`` is this integrator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_torch.accel.intersect import intersect
from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.core.interaction import offset_ray_origin, surface_interaction
from pbrt_torch.lights import table as lights_mod
from pbrt_torch.materials import table as mat_mod

#: photons per chunk of the density estimate (photonmap.py:33)
CHUNK = 256
#: the gather radius as a share of the world radius (photonmap.py:43)
RADIUS_SCALE = 0.02


@dataclasses.dataclass
class PhotonMaps:
    p: torch.Tensor  # (N, 3) photon positions
    wi: torch.Tensor  # (N, 3) arrival directions
    alpha: torch.Tensor  # (N, S) powers, already / paths
    is_caustic: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool
    radius: torch.Tensor  # () the gather radius


def light_paths(scene, n_paths: int, max_depth: int, seed: int, photons: bool):
    """The wavefront shared by photon shooting and VPL generation
    (photonmap.py:45-116, igi.py:38-100): per bounce b the path state
    before the bounce's BSDF sample → a list of (si, lm, alpha, alive,
    previous bounce specular, ray direction). ``photons``: the power
    carries the emitter's |cos| (alpha = Le·|cos|/(pdf·pmf)); VPLs' does
    not. Dead lanes' rays get tmax 0."""
    lt, g, mt = scene.lights, scene.geometry, scene.materials
    dev = g.tri_v0.device
    idx = torch.arange(n_paths, dtype=torch.int64, device=dev)
    root = rng.root_key(seed)
    u0 = rng.chain_uniforms(root, idx, 0, n=5)
    ub_all = rng.chain_uniforms(root, idx, 0, chain=[(rng.PHOTON, max_depth)], n=3)
    li, light_pmf = lt.power_dist.sample_discrete(u0[:, 0])
    es = lights_mod.sample_le(lt, g, li, u0[:, 1], u0[:, 2], u0[:, 3], u0[:, 4])
    denom = torch.clamp(es.pdf * light_pmf, min=1e-12)
    if photons:
        cos_l = torch.sum(es.d * es.n, dim=-1).abs()
        alpha = es.Le * (cos_l / denom)[:, None] / n_paths
    else:
        alpha = es.Le / denom[:, None] / n_paths
    ray = geom.Ray.make(es.p + 1e-3 * es.d, es.d)
    alive = torch.ones(n_paths, dtype=torch.bool, device=dev)
    prev_specular = torch.ones(n_paths, dtype=torch.bool, device=dev)
    out = []
    for b in range(max_depth):
        hit = intersect(g, ray)
        si = surface_interaction(g, ray, hit)
        alive = alive & si.valid
        lm = mat_mod.gather_lane(mt, si.material)
        out.append((si, lm, alpha, alive, prev_specular, ray.direction))
        ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
        wo_local = bxdf.world_to_local(si.wo, ss, ts, si.ns)
        ub = ub_all[:, 3 * b:3 * b + 3]
        wi_local, f, pdf, is_delta = mat_mod.bsdf_sample(lm, wo_local, ub[:, 0], ub[:, 1],
                                                         ub[:, 2])
        wi_world = bxdf.local_to_world(wi_local, ss, ts, si.ns)
        cos_i = geom.absdot(wi_world, si.ns)
        ok = alive & (pdf > 0.0)
        alpha = torch.where(ok[:, None],
                            alpha * f * (cos_i / torch.clamp(pdf, min=1e-9))[:, None], alpha)
        prev_specular = is_delta
        alive = ok
        o_new = offset_ray_origin(si.p, si.ng, wi_world, si.ray_epsilon)
        ray = geom.Ray.make(torch.where(alive[:, None], o_new, ray.origin),
                            torch.where(alive[:, None], wi_world, ray.direction),
                            tmax=torch.where(alive, math.inf, 0.0))
    return out


def shoot_photons(scene, n_paths: int = 4096, max_depth: int = 5, seed: int = 17,
                  radius_scale: float = RADIUS_SCALE) -> PhotonMaps:
    """The photon maps of ``n_paths`` light paths (PhotonShootingTask::Run,
    photonmap.cpp:300-470): slot b·n_paths + i holds path i's bounce b."""
    p, wi, a, caustic, ok = [], [], [], [], []
    for b, (si, lm, alpha, alive, prev_spec, d) in enumerate(
            light_paths(scene, n_paths, max_depth, seed, photons=True)):
        deposit = alive & ~mat_mod.has_delta_only(lm) & (b > 0)
        p.append(si.p)
        wi.append(-geom.normalize(d))
        a.append(alpha)
        caustic.append(prev_spec & deposit)
        ok.append(deposit)
    return PhotonMaps(p=torch.cat(p), wi=torch.cat(wi), alpha=torch.cat(a),
                      is_caustic=torch.cat(caustic), valid=torch.cat(ok),
                      radius=scene.lights.world_radius * radius_scale)


def radiance_estimate(maps: PhotonMaps, scene, si, lm, caustic_only=None):
    """Σ kd/π · α over the photons within the radius, / (π r²) (LPhoton,
    photonmap.cpp:200-260; photonmap.py:123-162) → (R, S). ``caustic_only``:
    True the caustic photons, False the indirect ones, None both."""
    if isinstance(lm, mat_mod.MixLane):
        raise NotImplementedError("photonmap with a mix material (the JAX package's "
                                  "estimate reads a mix lane's kd, which it has not)")
    kd = lm.kd if lm.kd is not None else scene.materials.kd[si.material.clamp(min=0)]
    f_diff = kd * bxdf.INV_PI
    p = si.p
    R, S = p.shape[0], maps.alpha.shape[-1]
    r2 = maps.radius * maps.radius
    sel = maps.valid
    if caustic_only is True:
        sel = sel & maps.is_caustic
    elif caustic_only is False:
        sel = sel & ~maps.is_caustic
    p2 = p[:, 0:1] * p[:, 0:1] + p[:, 1:2] * p[:, 1:2] + p[:, 2:3] * p[:, 2:3]
    q2 = maps.p[:, 0] * maps.p[:, 0] + maps.p[:, 1] * maps.p[:, 1] + maps.p[:, 2] * maps.p[:, 2]
    acc = torch.zeros((R, S), dtype=torch.float32, device=p.device)
    for c0 in range(0, maps.p.shape[0], CHUNK):
        q = maps.p[c0:c0 + CHUNK]
        pq = p[:, 0:1] * q[:, 0] + p[:, 1:2] * q[:, 1] + p[:, 2:3] * q[:, 2]
        d2 = p2 - 2.0 * pq + q2[c0:c0 + CHUNK]
        w = ((d2 <= r2) & sel[c0:c0 + CHUNK]).to(torch.float32)
        acc = acc + f_diff * torch.matmul(w, maps.alpha[c0:c0 + CHUNK])
    return acc / (math.pi * r2)
