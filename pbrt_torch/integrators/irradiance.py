"""The irradiance cache as a wavefront, and the probes' integrator (port of
``irradiance_cache_li`` and ``useprobes_li`` in
``pbrt_tpu/integrators/irradiance.py:50-224``; reference:
src/integrators/irradiancecache.{h,cpp}, useprobes.{h,cpp}).

``irradiancecache`` is ``directlighting`` plus a cached hemispherical
gather of indirect irradiance at the camera rays' first diffuse hits, in
three passes per wave:

1. the cache fill: every ``ic_stride``-th lane gathers E from K cosine-
   distributed rays, each traced by a nested ``directlighting``
   ``trace_radiance``, and keeps the reference's (E, wAvg, extent) triple,
   extent = clamp(min hit / 2, minpixelspacing · ps, maxpixelspacing · ps)
   with ps the pixel cone's width at the hit (irradiancecache.cpp:245-271);
2. every lane interpolates over the 8 cache entries around its own along
   the wave, with the reference's error weights 1 − max(d / extent,
   √((1 − n·nᵢ) / (1 − cos maxangle))) (IrradProcess, :308-325), accepted
   where their sum reaches ``minweight``;
3. the lanes the cache cannot serve gather afresh (masked, on the whole
   wave), the reference's cache-miss path.

L adds f(wo, normalize(wAvg)) · E at diffuse hits (:285-287).

Randomness: pass 1 and 3's gather k draws its direction from the camera
key folded with (salt + k)·16 + BSDF_SAMPLE (2 uniforms) and its nested
trace's bounce block from the camera key folded with (salt + 100 + k)·16 +
CAMERA, then BatchedKeySource's tag 15 (path.py:115-120), salt 100 and
300 (irradiance.py:69-74): per pass one ``keyed_chain_uniforms`` launch
for the K directions and one for the K blocks (``cache_draws``), so the
2K + 1 nested traces of a wave read the JAX package's bits. In a scene
with volumes the top-level trace takes the wave's media block and each
nested trace one of its own from the same gather key (irradiance.py:75-76
into path.py:224-231 and volumes.py:190-209): its NEE jitters, folded
with b·16 + VOLUME for b < max(D, 1), one more launch per pass, and under
``single`` its 32 march steps' 3 uniforms, one more (``nested_media``).

Kept as the JAX package has it: ``nsamples`` is the gather count K
(default 4, not the reference's 4096) and ``ic_stride`` is 8, not a
parameter.

``useprobes`` (``useprobes_li``) is ``directlighting`` plus the
irradiance of a ``ProbeGrid`` (``renderers/probes.py`` writes and reads
its file): the first hit's SH coefficients, trilinear over the 8 probes
around it (``_trilerp_probes``, indices clamped to the grid), dotted with
the basis at the viewer-facing normal and the clamped cosine's factors
Â_l (non-zero for l ≤ 2 only), times kd/π at diffuse hits. Kept as the
JAX package has it: the hit takes no ray spread and no textures
(irradiance.py:176-178), and reads the lane's kd, which a mix lane has
not (the JAX package fails there; the port refuses it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_torch.accel.intersect import intersect
from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.core import sh
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import spectrum as spec
from pbrt_torch.core.interaction import offset_ray_origin, surface_interaction
from pbrt_torch.materials import table as mat_mod

#: cache entries each lane looks at (irradiance.py:118)
WINDOW = 8
#: the two gather passes' key salts (irradiance.py:103, :138)
FILL_SALT, MISS_SALT = 100, 300


def cache_stride(cfg, R: int) -> int:
    return max(1, min(cfg.ic_stride, R))


def _pass_draws(root, index, sample: int, cfg, salt: int, volumes: bool = False):
    """(directions (R, 2K), nested bounce blocks (R, 5 + 7·D·K), nested
    media or None) of one gather pass; block k is read through columns
    7·D·k … 7·D·k + 5 + 7·D (``nested_view``). In a scene with volumes the
    media are (jitters (R, J·K), march steps (R, 96·K) under ``single``
    else None), J = max(D, 1): gather k's jitter for bounce b is the
    uniform of its key ``bounce_key(keys, salt + 100 + k, CAMERA)`` folded
    with b·16 + VOLUME, its steps those of its bounce-0 VOLUME key folded
    with s·16 + LIGHT_SAMPLE (path.py:224-231, volumes.py:190-209), as
    ``media_uniforms`` draws a wave's (``nested_media``)."""
    K = cfg.ao_nsamples
    dirs = rng.chain_uniforms(root, index, sample, chain=[(salt * 16 + rng.BSDF_SAMPLE, K)], n=2)
    gather = ((salt + 100) * 16 + rng.CAMERA, K)
    blocks = rng.chain_uniforms(
        root, index, sample, chain=[gather, rng.BATCHED],
        n=rng.PER_BOUNCE_USED * cfg.max_depth, used=rng.PER_BOUNCE_USED,
        drawn=rng.PER_BOUNCE_DRAWN, lead=rng.CAMERA_DIMS)
    media = None
    if volumes:
        jitters = rng.chain_uniforms(root, index, sample,
                                     chain=[gather, (rng.VOLUME, max(cfg.max_depth, 1))])
        steps = (rng.chain_uniforms(root, index, sample,
                                    chain=[gather, rng.VOLUME, (rng.LIGHT_SAMPLE,
                                                                rng.VOLUME_STEPS)],
                                    n=rng.PER_VOLUME_STEP)
                 if cfg.volume_kind == "single" else None)
        media = (jitters, steps)
    return dirs, blocks, media


def cache_draws(root, pixel_index, sample: int, cfg, volumes: bool = False) -> dict:
    """A wave's gather draws: the fill pass's on every ``ic_stride``-th
    lane, the miss pass's on all (see the module docstring); with
    ``volumes``, their nested traces' media too."""
    stride = cache_stride(cfg, pixel_index.shape[0])
    return {"fill": _pass_draws(root, pixel_index[::stride].contiguous(), sample, cfg,
                                FILL_SALT, volumes),
            "miss": _pass_draws(root, pixel_index, sample, cfg, MISS_SALT, volumes)}


def draw_rows(draws: dict, cfg, R: int, a: int, b: int) -> dict:
    """The draws of lanes [a, b) of an R-lane wave, for a trace of those
    lanes alone: the miss pass's rows a … b, the fill pass's rows of the
    wave's fill lanes in [a, b). Those are the chunk's own fill lanes when
    a is a multiple of the wave's stride and the chunk holds at least
    ``ic_stride`` lanes or ends the wave; anything else raises."""
    s = cache_stride(cfg, R)
    if a % s or (b - a < s and b != R):
        raise ValueError(f"irradiancecache: lanes [{a}, {b}) of {R} do not start on the "
                         f"cache stride {s} or end short of it")
    rows = lambda x, lo, hi: None if x is None else x[lo:hi]
    take = lambda d, lo, hi: (rows(d[0], lo, hi), rows(d[1], lo, hi),
                              None if d[2] is None else tuple(rows(m, lo, hi) for m in d[2]))
    return {"fill": take(draws["fill"], a // s, -(-b // s)), "miss": take(draws["miss"], a, b)}


def nested_view(blocks, k: int, max_depth: int):
    """Gather k's primary-sample view of a pass's blocks: its bounce block
    at columns 5 … 5 + 7·D (the 5 camera columns before it belong to the
    block before and are never read: a gather ray is not a camera ray)."""
    w = rng.PER_BOUNCE_USED * max_depth
    return blocks[:, k * w:k * w + rng.CAMERA_DIMS + w]


def nested_media(media, k: int, max_depth: int):
    """Gather k's media block (``renderers/sampler.py:media_uniforms``'
    layout: J jitters, then 96 step uniforms under ``single``), or None."""
    if media is None:
        return None
    jitters, steps = media
    J = max(max_depth, 1)
    block = jitters[:, k * J:(k + 1) * J]
    if steps is None:
        return block
    w = rng.VOLUME_STEPS * rng.PER_VOLUME_STEP
    return torch.cat([block, steps[:, k * w:(k + 1) * w]], -1)


def _gather_irradiance(scene, p, ng, eps, diffuse, n_gather, frame, rays, K, draws,
                       direct_cfg):
    """A cosine-weighted hemisphere gather of K nested ``directlighting``
    traces from each lane's point → (E (R, S), wAvg (R, 3), min hit (R,))
    (irradiancecache.cpp:245-271; irradiance.py:50-80)."""
    from pbrt_torch.integrators.path import trace_radiance

    ss, ts = frame
    dirs, blocks, media = draws
    R = p.shape[0]
    E = torch.zeros((R, scene.materials.kd.shape[-1]), dtype=torch.float32, device=p.device)
    w_avg = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    min_hit = torch.full((R,), math.inf, dtype=torch.float32, device=p.device)
    for k in range(K):
        w_local = smp.cosine_sample_hemisphere(dirs[:, 2 * k], dirs[:, 2 * k + 1])
        w = bxdf.local_to_world(w_local, ss, ts, n_gather)
        o = offset_ray_origin(p, ng, w, eps)
        gather_rays = geom.Ray.make(torch.where(diffuse[:, None], o, rays.origin),
                                    torch.where(diffuse[:, None], w, rays.direction))
        Lg, t_hit = trace_radiance(scene, gather_rays, direct_cfg,
                                   nested_view(blocks, k, direct_cfg.max_depth),
                                   media=nested_media(media, k, direct_cfg.max_depth))
        E = E + Lg * math.pi / K
        w_avg = w_avg + w * spec.luminance(Lg)[:, None]
        min_hit = torch.minimum(min_hit, torch.where(t_hit > 0.0, t_hit, math.inf))
    return E, w_avg, min_hit


def irradiance_cache_li(scene, rays, cfg, uniforms, draws, media=None):
    """directlighting plus the cached indirect gather (IrradianceCacheIntegrator::
    Li + indirectLo, irradiancecache.cpp:195-330; irradiance.py:83-165) →
    (L, first hit t). ``draws``: ``cache_draws`` of the wave; ``media``: its
    media block in a scene with volumes (the top-level trace's)."""
    from pbrt_torch.integrators.path import trace_radiance

    if draws is None:
        raise ValueError("irradiancecache needs the wave's gather draws (cache_draws)")
    if scene.has_volumes and draws["miss"][2] is None:
        raise ValueError("irradiancecache in a scene with volumes needs its gathers' media "
                         "(cache_draws(volumes=True))")
    direct_cfg = dataclasses.replace(cfg, kind="directlighting")
    L_direct, first_t = trace_radiance(scene, rays, direct_cfg, uniforms, media=media)
    g = scene.geometry
    hit = intersect(g, rays)
    si = surface_interaction(g, rays, hit)
    lm = mat_mod.gather_lane(scene.materials, si.material)
    diffuse = si.valid & ~mat_mod.has_delta_only(lm)
    # the hemisphere facing the viewer (irradiancecache.cpp:216)
    n_gather = geom.face_forward(si.ns, si.wo)
    ss, ts = bxdf.make_shading_frame(n_gather, si.dpdu)
    R = rays.origin.shape[0]
    K = cfg.ao_nsamples

    # ---- pass 1: the cache fill at every stride-th lane ------------------
    stride = cache_stride(cfg, R)
    sub = lambda a: a[::stride]
    E_c, wavg_c, minhit_c = _gather_irradiance(
        scene, sub(si.p), sub(si.ng), sub(si.ray_epsilon), sub(diffuse), sub(n_gather),
        (sub(ss), sub(ts)), geom.Ray.make(sub(rays.origin), sub(rays.direction)), K,
        draws["fill"], direct_cfg)
    # the pixel spacing at the entry: the ray cone's width there
    spread = scene.pixel_spread if scene.pixel_spread > 0.0 else 5e-3
    ps_c = spread * torch.clamp(sub(hit.t), min=1e-6)
    ext_c = torch.clamp(minhit_c / 2.0, cfg.ic_minspacing * ps_c, cfg.ic_maxspacing * ps_c)
    valid_c = sub(diffuse)

    # ---- pass 2: error-weighted interpolation over the window -----------
    cos_max = np.cos(np.deg2rad(max(cfg.ic_maxangle, 1e-3)))
    p_c, n_c = sub(si.p), sub(n_gather)
    Rc = p_c.shape[0]
    j0 = torch.arange(R, device=rays.origin.device) // stride
    sum_w = torch.zeros(R, dtype=torch.float32, device=rays.origin.device)
    E_i = torch.zeros((R, E_c.shape[-1]), dtype=torch.float32, device=rays.origin.device)
    wavg_i = torch.zeros((R, 3), dtype=torch.float32, device=rays.origin.device)
    for dj in range(-(WINDOW // 2 - 1), WINDOW // 2 + 1):
        j = torch.clamp(j0 + dj, 0, Rc - 1)
        perr = geom.length(si.p - p_c[j]) / torch.clamp(ext_c[j], min=1e-12)
        ndot = torch.sum(n_gather * n_c[j], dim=-1)
        nerr = torch.sqrt(torch.clamp(1.0 - ndot, min=0.0) / max(1.0 - cos_max, 1e-6))
        err = torch.maximum(perr, nerr)
        wt = torch.where((err < 1.0) & valid_c[j], 1.0 - err, 0.0)
        sum_w = sum_w + wt
        E_i = E_i + wt[:, None] * E_c[j]
        wavg_i = wavg_i + wt[:, None] * wavg_c[j]
    ok = sum_w >= cfg.ic_minweight  # Successful(), irradiancecache.cpp:78
    E_i = E_i / torch.clamp(sum_w, min=1e-12)[:, None]

    # ---- pass 3: the cache misses gather afresh, masked -----------------
    miss = diffuse & ~ok
    E_m, wavg_m, _ = _gather_irradiance(scene, si.p, si.ng, si.ray_epsilon, miss, n_gather,
                                        (ss, ts), rays, K, draws["miss"], direct_cfg)
    E = torch.where(ok[:, None], E_i, E_m)
    w_avg = torch.where(ok[:, None], wavg_i, wavg_m)

    # L_ind = f(wo, normalize(wAvg)) · E (irradiancecache.cpp:285-287)
    wlen = geom.length(w_avg)
    wi_w = w_avg / torch.clamp(wlen, min=1e-12)[:, None]
    f = mat_mod.bsdf_f(lm, bxdf.world_to_local(si.wo, ss, ts, n_gather),
                       bxdf.world_to_local(wi_w, ss, ts, n_gather))
    L_ind = torch.where((wlen > 0.0)[:, None], f * E, 0.0)
    return L_direct + torch.where(diffuse[:, None], L_ind, 0.0), first_t


@dataclasses.dataclass
class ProbeGrid:
    """SH radiance probes at the centres of an (nx, ny, nz) grid over the
    box [lo, hi] (irradiance.py:43-47)."""

    lo: torch.Tensor  # (3,)
    hi: torch.Tensor  # (3,)
    coeffs: torch.Tensor  # (nx, ny, nz, terms, S)
    lmax: int = 4


def _trilerp_probes(probes: ProbeGrid, p):
    """The probes' coefficients at points p (R, 3), trilinear between the
    8 grid centres around each, indices clamped (irradiance.py:199-224) →
    (R, terms, S)."""
    nx, ny, nz = probes.coeffs.shape[:3]
    ext = torch.clamp(probes.hi - probes.lo, min=1e-9)
    dims = torch.tensor([nx, ny, nz], dtype=p.dtype, device=p.device)
    q = (p - probes.lo) / ext * dims - 0.5
    qi = torch.floor(q).to(torch.int64)
    d = q - qi
    acc = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((d[:, 0] if dx else 1 - d[:, 0]) * (d[:, 1] if dy else 1 - d[:, 1])
                     * (d[:, 2] if dz else 1 - d[:, 2]))
                c = probes.coeffs[torch.clamp(qi[:, 0] + dx, 0, nx - 1),
                                  torch.clamp(qi[:, 1] + dy, 0, ny - 1),
                                  torch.clamp(qi[:, 2] + dz, 0, nz - 1)]
                acc = acc + w[:, None, None] * c
    return acc


def useprobes_li(scene, rays, cfg, uniforms, media=None):
    """directlighting plus the probes' irradiance (UseRadianceProbes::Li;
    irradiance.py:168-196) → (L, first hit t). ``uniforms``: the wave's
    directlighting primary-sample array; ``media``: its media block."""
    from pbrt_torch.integrators.path import trace_radiance

    probes = scene.probes
    if probes is None:
        raise ValueError("useprobes needs the scene's probe grid")
    direct_cfg = dataclasses.replace(cfg, kind="directlighting")
    L_direct, first_t = trace_radiance(scene, rays, direct_cfg, uniforms, media=media)
    g = scene.geometry
    si = surface_interaction(g, rays, intersect(g, rays))
    lm = mat_mod.gather_lane(scene.materials, si.material)
    if isinstance(lm, mat_mod.MixLane):
        raise NotImplementedError("useprobes with a mix material (the JAX package reads a "
                                  "mix lane's kd, which it has not)")
    diffuse = si.valid & ~mat_mod.has_delta_only(lm)
    coeffs = _trilerp_probes(probes, si.p)
    basis = sh.sh_evaluate(geom.face_forward(si.ns, si.wo), probes.lmax)
    a_hat = torch.as_tensor(sh.cosine_lobe_coeffs(probes.lmax).astype(np.float32),
                            device=basis.device)
    E = torch.einsum("rt,rts->rs", basis * a_hat, coeffs)
    L_ind = lm.kd * bxdf.INV_PI * torch.clamp(E, min=0.0)
    return L_direct + torch.where(diffuse[:, None], L_ind, 0.0), first_t
