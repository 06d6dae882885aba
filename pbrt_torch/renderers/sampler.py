"""Sampler renderer as sample waves over pixel chunks (port of
``pbrt_tpu/renderers/sampler.py`` for the lowdiscrepancy sampler; reference:
src/renderers/samplerrenderer.cpp:60-164, src/samplers/lowdiscrepancy.cpp).

One wave renders sample index n for every pixel of a chunk: the (0,2)
sequence with per-pixel scrambles gives the camera sample (image x/y, lens
u/v, time), the surface integrator traces it, NaN / negative / infinite
radiance is zeroed (samplerrenderer.cpp:119-133), and the film takes the
filter-weighted sample.

Randomness is keyed as in the JAX package (sampler.py:119-132, :316-346),
by threefry from the seed and each pixel's index ``y · W + x`` in the
film array (``core/rng.py``): six scramble words per pixel from sample 0's
key, drawn once per render, and per wave and chunk the integrator's
primary-sample array, one kernel launch on the card (``wave_uniforms``):
the camera columns from the scrambles, then for ``path``,
``directlighting`` and ``whitted`` the bounce block of sample n's key (the
JAX package's ``BatchedKeySource``), for ``ambientocclusion`` each AO
sample's two uniforms, for ``metadata`` nothing more. So a seed gives the
JAX package's image, on the CPU and on the card, whatever
``chunk_pixels`` is. Padded tail lanes repeat the last pixel, and so its
keys; their weight is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_torch.core import rng
from pbrt_torch.film import film as film_mod
from pbrt_torch.integrators.path import trace_radiance


def wave_uniforms(icfg, root, pixel_index, scrambles, sample: int):
    """The integrator's primary-sample array of one wave (R pixels): one
    keyed-kernel launch on the card."""
    if icfg.kind == "ambientocclusion":
        return rng.ao_uniforms(root, pixel_index, scrambles, sample, icfg.ao_nsamples)
    depth = 0 if icfg.kind == "metadata" else icfg.max_depth
    return rng.primary_uniforms(root, pixel_index, scrambles, sample, depth)


def render_wave(film_state, scene, camera, filter_table, pixel_x, pixel_y,
                icfg, film_cfg, uniforms, sample_scale=None):
    """One wave for one pixel chunk; ``uniforms`` is the integrator's
    primary-sample array (camera columns first; ``wave_uniforms``). Updates
    the film in place and returns it."""
    px = pixel_x.to(torch.float32) + uniforms[:, 0]
    py = pixel_y.to(torch.float32) + uniforms[:, 1]
    rays = camera.generate_rays(px, py, uniforms[:, 2], uniforms[:, 3],
                                uniforms[:, 4])
    L, first_t = trace_radiance(scene, rays, icfg, uniforms)
    bad = torch.isnan(L) | (L < 0.0) | torch.isinf(L)
    L = torch.where(bad, 0.0, L)
    return film_mod.add_samples(
        film_state, film_cfg, px, py, L, first_t, filter_table,
        sample_scale=sample_scale, pixel_ids=(pixel_x, pixel_y),
    )


def render(built, spp=None, seed: int = 0, chunk_pixels: int | None = None):
    """All sample waves × pixel chunks → the film. Runs on the device the
    built scene lives on."""
    if built.sampler_name not in ("lowdiscrepancy",):
        raise NotImplementedError(
            f"sampler {built.sampler_name!r} is not ported yet")
    dev = built.device
    cfg = built.film_config
    icfg = built.integrator
    spp = spp if spp is not None else built.pixel_samples
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
    state = film_mod.init_film(cfg, dev)
    table = built.filter_table
    for s in range(spp):
        for c in range(n_chunks):
            u = wave_uniforms(icfg, root, pix[c], scrambles[c], s)
            render_wave(state, built.scene, built.camera, table, xs[c], ys[c],
                        icfg, cfg, u, sample_scale=mask[c])
    return state
