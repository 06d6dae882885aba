"""Instant global illumination with virtual point lights (port of
``pbrt_tpu/integrators/igi.py``; reference: src/integrators/igi.{h,cpp}).

``generate_vpls`` traces light paths as photon mapping does
(``photonmap.light_paths``, root seed 11) and leaves a VPL at every hit
with a non-delta lobe, the first bounce's included, carrying the path's
power (igi.cpp:60-140). ``vpl_lighting`` sums, at each shading point, 8
VPLs picked uniformly among all N slots (invalid ones add nothing), each
f · G · power with G = cos·cos/d² clamped at 10 and one any-hit shadow
ray, scaled by N/8 (igi.cpp:170-230).

The picks are keyed as the JAX package keys them (path.py:611,
igi.py:111-112): the camera key folded with b·16 + PHOTON at bounce b, then
k·16 + PHOTON for VPL k, one uniform each; the renderer draws a wave's
(R, 8·D) block in one ``keyed_chain_uniforms`` launch (``vpl_picks``).

Kept as the JAX package has it: ``nlights`` sets the paths (max(4·nlights,
256)) and ``maxdepth`` their depth; the clamp is 10 and there are 8 VPLs
per lane whatever ``glimit`` or the scene says, and the pick indexes all
N slots (⌊u·N⌋), invalid ones included, scaled by N/8 (igi.py:137).
"""

from __future__ import annotations

import dataclasses

import torch

from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.integrators.photonmap import light_paths
from pbrt_torch.materials import table as mat_mod

#: VPLs per shading point and the geometric term's clamp (igi.py:104)
VPL_SAMPLES = 8
G_LIMIT = 10.0


@dataclasses.dataclass
class VPLSet:
    p: torch.Tensor  # (N, 3)
    n: torch.Tensor  # (N, 3)
    contrib: torch.Tensor  # (N, S) path power
    valid: torch.Tensor  # (N,) bool


def generate_vpls(scene, n_paths: int = 1024, max_depth: int = 3, seed: int = 11) -> VPLSet:
    """VPLs of ``n_paths`` light paths (IGIIntegrator::Preprocess): slot
    b·n_paths + i holds path i's bounce b."""
    p, n, c, ok = [], [], [], []
    for si, lm, alpha, alive, _, _ in light_paths(scene, n_paths, max_depth, seed,
                                                   photons=False):
        p.append(si.p)
        n.append(si.ns)
        c.append(alpha)
        ok.append(alive & ~mat_mod.has_delta_only(lm))
    return VPLSet(p=torch.cat(p), n=torch.cat(n), contrib=torch.cat(c), valid=torch.cat(ok))


def vpl_picks(root, pixel_index, sample: int, max_depth: int):
    """A wave's VPL picks, (R, 8·max_depth): bounce b's 8 at columns 8b …
    8b + 7 (see the module docstring)."""
    return rng.chain_uniforms(root, pixel_index, sample,
                              chain=[(rng.PHOTON, max(max_depth, 1)), (rng.PHOTON, VPL_SAMPLES)])


def vpl_lighting(scene, vpls: VPLSet, si, lm, wo_local, frame, u, g_limit: float = G_LIMIT):
    """Σ over the lane's picked VPLs of f·G·power with visibility, × N/K
    (igi.py:103-137); ``u`` (R, K) the picks → (R, S)."""
    from pbrt_torch.integrators.path import _shadow_unoccluded

    ss, ts, ns = frame
    N, K = vpls.p.shape[0], u.shape[1]
    total = torch.zeros((si.p.shape[0], vpls.contrib.shape[-1]), dtype=torch.float32,
                        device=si.p.device)
    for k in range(K):
        vi = torch.clamp((u[:, k] * N).to(torch.int64), max=N - 1)
        ok = vpls.valid[vi] & si.valid
        d = vpls.p[vi] - si.p
        dist2 = torch.clamp(torch.sum(d * d, -1), min=1e-9)
        dist = torch.sqrt(dist2)
        wi = d / dist[:, None]
        g = (torch.clamp(geom.dot(wi, ns), min=0.0)
             * torch.clamp(geom.dot(-wi, vpls.n[vi]), min=0.0) / dist2)
        g = torch.clamp(g, max=g_limit)
        f = mat_mod.bsdf_f(lm, wo_local, bxdf.world_to_local(wi, ss, ts, ns))
        # lanes that add nothing get dist 0 → tmax 0 → no traversal
        vis = _shadow_unoccluded(scene.geometry, si.p, si.ng, wi, torch.where(ok, dist, 0.0),
                                 si.ray_epsilon)
        total = total + torch.where(ok[:, None], f * vpls.contrib[vi] * (g * vis)[:, None], 0.0)
    return total * (N / K)
