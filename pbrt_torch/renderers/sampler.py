"""Sampler renderer as sample waves over pixel chunks (port of
``pbrt_tpu/renderers/sampler.py``; reference:
src/renderers/samplerrenderer.cpp:60-164, src/samplers/).

One wave renders sample index n for every pixel of a chunk: the scene's
sampler gives the camera sample (image x/y, lens u/v, time) —
lowdiscrepancy's (0,2) sequence with per-pixel scrambles, halton,
bestcandidate, random or stratified (``core/rng.py``) — the surface
integrator traces it, NaN / negative / infinite radiance is zeroed
(samplerrenderer.cpp:119-133), and the film takes the filter-weighted
sample. ``adaptive`` (samplers/adaptive.cpp; sampler.py:365-437) samples as
lowdiscrepancy in two passes: ``minsamples`` waves everywhere, keeping
per pixel the luminance sum, minimum and maximum of its samples and the
minimum and maximum id of the primitive its camera rays hit first (one
more closest-hit traversal of the camera rays per wave, as the JAX
package takes them); then, where the ``contrast`` or ``shapeid`` test asks
for it, waves ``minsamples`` … ``maxsamples`` − 1, the other pixels'
samples weighted 0. Its waves take spp = ``maxsamples``; ``quick`` makes
both counts 1.

Randomness is keyed as in the JAX package (sampler.py:119-132, :316-346),
by threefry from the seed and each pixel's index ``y · W + x`` in the
film array (``core/rng.py``): six scramble words per pixel from sample 0's
key, drawn once per render, and per wave and chunk the integrator's
primary-sample array, one kernel launch on the card (``wave_uniforms``):
the camera columns from the scrambles, then for ``path``,
``directlighting`` and ``whitted`` the bounce block of sample n's key (the
JAX package's ``BatchedKeySource``), for ``ambientocclusion`` each AO
sample's two uniforms, for ``metadata`` nothing more; a scene with volumes
adds the media block (``media_uniforms``, one more launch); ``igi`` adds
its VPL picks, ``irradiancecache`` its gather passes' directions and
nested bounce blocks (with volumes, their media), ``diffuseprt`` and
``glossyprt`` their per-hit samples (``integrator_draws``: one, four (six
or eight) and one ``keyed_chain_uniforms`` launches); ``useprobes`` reads
directlighting's array. So a seed gives the
JAX package's image, on the CPU and on the card, whatever
``chunk_pixels`` is. Padded tail lanes repeat the last pixel, and so its
keys; their weight is 0.

A scene with textures also gets the camera rays' differentials, scaled
about each ray by 1/√spp (ScaleDifferentials, samplerrenderer.cpp:91;
sampler.py:133-144), where the camera has them (the projective ones); they
set the texture footprint of the first hit. Other scenes build none.

A lens camera with diffraction also takes, per wave and chunk, its keyed
normals (``camera_noise``: one ``keyed_camera_normals`` launch on the
card, from the same (pixel, sample) keys, sampler.py:132), and traces at
its default wavelength (550 nm; the eye's 0 reads as 550), as the JAX
sampler passes no wavelength.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_torch.accel.intersect import intersect
from pbrt_torch.core import rng
from pbrt_torch.core import spectrum as spec
from pbrt_torch.film import film as film_mod
from pbrt_torch.integrators import igi, irradiance, prt
from pbrt_torch.integrators.path import trace_radiance


#: integrator kinds that trace no volume
SURFACE_ONLY = ("ambientocclusion", "metadata", "diffuseprt", "glossyprt")


def wave_uniforms(icfg, root, pixel_index, scrambles, sample: int,
                  sampler: str = "lowdiscrepancy", spp: int = 1):
    """The integrator's primary-sample array of one wave (R pixels), its
    camera columns ``sampler``'s at ``spp``: one keyed-kernel launch on the
    card."""
    if icfg.kind == "ambientocclusion":
        return rng.ao_uniforms(root, pixel_index, scrambles, sample, icfg.ao_nsamples,
                               sampler, spp)
    depth = 0 if icfg.kind == "metadata" else icfg.max_depth
    return rng.primary_uniforms(root, pixel_index, scrambles, sample, depth, sampler, spp)


def key_uniforms(icfg, root, index, sample: int):
    """The primary-sample array of lanes keyed as the JAX package keys a
    trace without a camera sample (``KeySource`` / ``BatchedKeySource`` of
    the keys (root, index, sample)): the 5 camera columns zero, then the
    bounce block, or ambient occlusion's samples (one chain launch on the
    card; metadata reads none)."""
    if icfg.kind == "ambientocclusion":
        return rng.chain_uniforms(root, index, sample, chain=[(rng.BSDF_SAMPLE,
                                                               icfg.ao_nsamples)],
                                  n=2, lead=rng.CAMERA_DIMS)
    if icfg.kind == "metadata" or icfg.max_depth == 0:
        return torch.zeros((index.shape[0], rng.CAMERA_DIMS), dtype=torch.float32,
                           device=index.device)
    return rng.chain_uniforms(root, index, sample, chain=[rng.BATCHED],
                              n=rng.PER_BOUNCE_USED * icfg.max_depth, used=rng.PER_BOUNCE_USED,
                              drawn=rng.PER_BOUNCE_DRAWN, lead=rng.CAMERA_DIMS)


def media_uniforms(scene, icfg, root, pixel_index, sample: int):
    """The wave's media block, or None for a scene without volumes or a
    kind that traces none: one ``keyed_volume_uniforms`` launch on the
    card."""
    if not scene.has_volumes or icfg.kind in SURFACE_ONLY:
        return None
    return rng.volume_uniforms(root, pixel_index, sample, max(icfg.max_depth, 1),
                               icfg.volume_kind == "single")


def integrator_draws(scene, icfg, root, pixel_index, sample: int):
    """The wave's draws of the preprocess integrators, or None: ``igi``'s
    VPL picks (``{"vpl": (R, 8·D)}``, one launch on the card),
    ``irradiancecache``'s two gather passes (``{"fill": …, "miss": …}``, two
    launches each; in a scene with volumes one more for the nested traces'
    jitters, and one for their march steps under single scattering) and
    the PRT kinds' per-hit samples (``{"prt": …}``, one launch)."""
    if icfg.kind == "igi" and scene.has_vpls:
        return {"vpl": igi.vpl_picks(root, pixel_index, sample, icfg.max_depth)}
    if icfg.kind == "irradiancecache":
        return irradiance.cache_draws(root, pixel_index, sample, icfg, scene.has_volumes)
    if icfg.kind in ("diffuseprt", "glossyprt"):
        return {"prt": prt.prt_draws(root, pixel_index, sample, icfg)}
    return None


def camera_noise(camera, root, pixel_index, sample: int):
    """The camera's keyed normals of one wave, (R, T, 2), or None for a
    camera without noise tags (every camera but the lens cameras with
    diffraction)."""
    tags = camera.noise_tags
    if not len(tags):
        return None
    return rng.camera_normals(root, pixel_index, sample, tags.start, len(tags))


def ray_differentials(camera, px, py, rays, scale: float):
    """The camera's one-pixel differentials scaled about each ray by
    ``scale`` (sampler.py:133-144)."""
    rx_o, rx_d, ry_o, ry_d = camera.ray_differentials(px, py, rays)
    if scale != 1.0:
        o0, d0 = rays.origin, rays.direction
        rx_o = o0 + (rx_o - o0) * scale
        ry_o = o0 + (ry_o - o0) * scale
        rx_d = d0 + (rx_d - d0) * scale
        ry_d = d0 + (ry_d - d0) * scale
    return rx_o, rx_d, ry_o, ry_d


def render_wave(film_state, scene, camera, filter_table, pixel_x, pixel_y,
                icfg, film_cfg, uniforms, sample_scale=None, diff_scale: float = 1.0,
                noise=None, media=None, stats=None, draws=None):
    """One wave for one pixel chunk; ``uniforms`` is the integrator's
    primary-sample array (camera columns first; ``wave_uniforms``);
    ``diff_scale`` scales a textured scene's ray differentials; ``noise``
    is the camera's (``camera_noise``), ``media`` the media block
    (``media_uniforms``), ``draws`` the integrator's
    (``integrator_draws``). Updates the film in place and returns it; with
    ``stats`` (a list), appends each sample's luminance and the first
    primitive its camera ray hits (adaptive sampling's inputs)."""
    px = pixel_x.to(torch.float32) + uniforms[:, 0]
    py = pixel_y.to(torch.float32) + uniforms[:, 1]
    rays = camera.generate_rays(px, py, uniforms[:, 2], uniforms[:, 3],
                                uniforms[:, 4], noise=noise)
    diffs = (ray_differentials(camera, px, py, rays, diff_scale)
             if scene.has_textures and hasattr(camera, "ray_differentials") else None)
    L, first_t = trace_radiance(scene, rays, icfg, uniforms, diffs=diffs, media=media,
                                draws=draws)
    bad = torch.isnan(L) | (L < 0.0) | torch.isinf(L)
    L = torch.where(bad, 0.0, L)
    if stats is not None:
        stats.append((spec.luminance(L), intersect(scene.geometry, rays).prim))
    return film_mod.add_samples(
        film_state, film_cfg, px, py, L, first_t, filter_table,
        sample_scale=sample_scale, pixel_ids=(pixel_x, pixel_y),
    )


def pixel_chunks(built, seed: int, chunk_pixels: int | None):
    """The film's pixels as chunks of ``chunk_pixels`` lanes (default
    32,768), the last padded with its last pixel at weight 0, on the built
    scene's device → (xs, ys, pixel indices, lane weights (C, chunk)
    each, the root key, the (C, chunk, 6) scramble words)."""
    cfg = built.film_config
    dev = built.device
    x0, x1, y0, y1 = cfg.pixel_bounds
    gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    all_x, all_y = gx.ravel(), gy.ravel()
    n_pix = len(all_x)
    chunk = min(chunk_pixels or (1 << 15), n_pix)
    pad = (-n_pix) % chunk
    if pad:  # repeat the last pixel, weight 0
        all_x = np.concatenate([all_x, np.full(pad, all_x[-1])])
        all_y = np.concatenate([all_y, np.full(pad, all_y[-1])])
    n_chunks = len(all_x) // chunk
    xs = torch.as_tensor(all_x.reshape(n_chunks, chunk), device=dev)
    ys = torch.as_tensor(all_y.reshape(n_chunks, chunk), device=dev)
    pix = ys * cfg.xres + xs
    mask = torch.ones((n_chunks, chunk), dtype=torch.float32, device=dev)
    if pad:
        mask[-1, chunk - pad:] = 0.0
    root = rng.root_key(seed)
    scrambles = rng.pixel_scrambles(root, pix.reshape(-1)).view(n_chunks, chunk, -1)
    return xs, ys, pix, mask, root, scrambles


def adaptive_counts(built, quick: bool = False):
    """(minsamples, maxsamples, method) of the ``adaptive`` sampler
    (sampler.py:376-381): at least 1 and minsamples; 1 and 1 with
    ``quick``."""
    sp = built.sampler_params
    min_s = max(1, sp.find_one_int("minsamples", 4))
    max_s = max(min_s, sp.find_one_int("maxsamples", 32))
    method = sp.find_one_string("method", "contrast")
    return (1, 1, method) if quick else (min_s, max_s, method)


def need_supersampling(method: str, lum_sum, lum_min, lum_max, id_min, id_max, min_s: int):
    """Adaptive's test per pixel (adaptive.cpp:140-165; sampler.py:411-417):
    ``shapeid`` where the first hits' primitive ids differ, ``contrast``
    where a sample's luminance is more than half the mean away from it."""
    if method == "shapeid":
        return id_min != id_max
    avg = lum_sum / min_s
    dev = torch.maximum(lum_max - avg, avg - lum_min)
    return (avg > 0.0) & (dev / torch.clamp(avg, min=1e-20) > 0.5)


def _render_adaptive(built, scene, state, chunks, quick: bool):
    """Adaptive sampling's two passes (see the module docstring). Per-pixel
    statistics live on the chunks' lanes; padded lanes are left out of the
    count and weighted 0. The waves' ray differentials take spp =
    maxsamples, as the JAX package's (sampler.py:136-137)."""
    xs, ys, pix, mask, root, scrambles = chunks
    cfg, icfg, cam = built.film_config, built.integrator, built.camera
    min_s, max_s, method = adaptive_counts(built, quick)
    diff_scale = 1.0 / float(np.sqrt(max_s))
    dev = xs.device
    lum_sum = torch.zeros(xs.shape, dtype=torch.float32, device=dev)
    lum_min = torch.full(xs.shape, math.inf, dtype=torch.float32, device=dev)
    lum_max = torch.full(xs.shape, -math.inf, dtype=torch.float32, device=dev)
    id_min = torch.full(xs.shape, 2**30, dtype=torch.int64, device=dev)
    id_max = torch.full(xs.shape, -(2**30), dtype=torch.int64, device=dev)

    def wave(s, c, scale, stats=None):
        u = wave_uniforms(icfg, root, pix[c], scrambles[c], s, built.sampler_name, max_s)
        render_wave(state, scene, cam, built.filter_table, xs[c], ys[c], icfg, cfg, u,
                    sample_scale=scale, diff_scale=diff_scale,
                    noise=camera_noise(cam, root, pix[c], s),
                    media=media_uniforms(scene, icfg, root, pix[c], s), stats=stats,
                    draws=integrator_draws(scene, icfg, root, pix[c], s))

    for s in range(min_s):
        for c in range(xs.shape[0]):
            stats = []
            wave(s, c, mask[c], stats)
            lum, prim = stats[0]
            lum_sum[c] += lum
            lum_min[c] = torch.minimum(lum_min[c], lum)
            lum_max[c] = torch.maximum(lum_max[c], lum)
            id_min[c] = torch.minimum(id_min[c], prim)
            id_max[c] = torch.maximum(id_max[c], prim)
    need = need_supersampling(method, lum_sum, lum_min, lum_max, id_min, id_max, min_s)
    weight = need.to(torch.float32) * mask
    n_need = int(weight.sum())
    state.adaptive = {"need": n_need, "pixels": int(mask.sum()),
                      "waves": max_s if n_need else min_s}
    if not n_need:
        return state
    for s in range(min_s, max_s):
        for c in range(xs.shape[0]):
            wave(s, c, weight[c])
    return state


def render(built, spp=None, seed: int = 0, chunk_pixels: int | None = None,
           diff_spp: int | None = None, quick: bool = False,
           checkpoint_path: str | None = None, checkpoint_every: int = 8):
    """All sample waves × pixel chunks → the film. Runs on the device the
    built scene lives on. ``diff_spp`` (default: ``spp``) sets the texture
    footprint's scale, 1/√diff_spp of a pixel, so a test can give a
    golden's filter width at fewer samples (sampler.py:256-285);
    ``quick`` renders 1 spp (adaptive: 1 and 1). An adaptive render's film
    carries ``adaptive``: the pixels supersampled, the pixels, the waves.

    ``checkpoint_path`` (sampler.py:250-358): the render resumes from the
    film and wave saved there under the same seed (``film/checkpoint.py``),
    renders its waves in groups of ``checkpoint_every`` and saves after a
    group that ends on a multiple of it, and at the end. The keys are the
    (pixel, sample)'s, so a resumed render equals an uninterrupted one. An
    adaptive render without a checkpoint to resume takes its two passes and
    saves none; resumed, it continues as a plain sampler, as the JAX
    package's does."""
    cfg = built.film_config
    icfg = built.integrator
    spp = 1 if quick else spp if spp is not None else built.pixel_samples
    dspp = diff_spp if diff_spp is not None else spp
    diff_scale = 1.0 / float(np.sqrt(max(dspp, 1)))
    scene = built.scene
    if scene.pixel_spread > 0.0 and dspp > 1:  # the cone footprint's width
        scene = dataclasses.replace(scene, pixel_spread=scene.pixel_spread
                                    / float(np.sqrt(dspp)))
    chunks = pixel_chunks(built, seed, chunk_pixels)
    xs, ys, pix, mask, root, scrambles = chunks
    state, start = None, 0
    if checkpoint_path:
        from pbrt_torch.film.checkpoint import load_checkpoint, save_checkpoint

        ck = load_checkpoint(checkpoint_path, built.device)
        if ck is not None and ck[2] == seed:
            state, start, _ = ck
    if state is None:
        state = film_mod.init_film(cfg, built.device)
        if built.sampler_name == "adaptive":
            return _render_adaptive(built, scene, state, chunks, quick)
    table = built.filter_table
    group = checkpoint_every if checkpoint_path else max(1, spp)
    s = start
    while s < spp:
        for w in range(s, min(s + group, spp)):
            for c in range(xs.shape[0]):
                u = wave_uniforms(icfg, root, pix[c], scrambles[c], w, built.sampler_name, spp)
                render_wave(state, scene, built.camera, table, xs[c], ys[c],
                            icfg, cfg, u, sample_scale=mask[c], diff_scale=diff_scale,
                            noise=camera_noise(built.camera, root, pix[c], w),
                            media=media_uniforms(scene, icfg, root, pix[c], w),
                            draws=integrator_draws(scene, icfg, root, pix[c], w))
        s = min(s + group, spp)
        if checkpoint_path and (s % checkpoint_every == 0 or s == spp):
            save_checkpoint(checkpoint_path, state, s, seed)
    return state
