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
                noise=None):
    """One wave for one pixel chunk; ``uniforms`` is the integrator's
    primary-sample array (camera columns first; ``wave_uniforms``);
    ``diff_scale`` scales a textured scene's ray differentials; ``noise``
    is the camera's (``camera_noise``). Updates the film in place and
    returns it."""
    px = pixel_x.to(torch.float32) + uniforms[:, 0]
    py = pixel_y.to(torch.float32) + uniforms[:, 1]
    rays = camera.generate_rays(px, py, uniforms[:, 2], uniforms[:, 3],
                                uniforms[:, 4], noise=noise)
    diffs = (ray_differentials(camera, px, py, rays, diff_scale)
             if scene.has_textures and hasattr(camera, "ray_differentials") else None)
    L, first_t = trace_radiance(scene, rays, icfg, uniforms, diffs=diffs)
    bad = torch.isnan(L) | (L < 0.0) | torch.isinf(L)
    L = torch.where(bad, 0.0, L)
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


def render(built, spp=None, seed: int = 0, chunk_pixels: int | None = None,
           diff_spp: int | None = None):
    """All sample waves × pixel chunks → the film. Runs on the device the
    built scene lives on. ``diff_spp`` (default: ``spp``) sets the texture
    footprint's scale, 1/√diff_spp of a pixel, so a test can give a
    golden's filter width at fewer samples (sampler.py:256-285)."""
    if built.sampler_name not in ("lowdiscrepancy",):
        raise NotImplementedError(
            f"sampler {built.sampler_name!r} is not ported yet")
    cfg = built.film_config
    icfg = built.integrator
    spp = spp if spp is not None else built.pixel_samples
    dspp = diff_spp if diff_spp is not None else spp
    diff_scale = 1.0 / float(np.sqrt(max(dspp, 1)))
    scene = built.scene
    if scene.pixel_spread > 0.0 and dspp > 1:  # the cone footprint's width
        scene = dataclasses.replace(scene, pixel_spread=scene.pixel_spread
                                    / float(np.sqrt(dspp)))
    xs, ys, pix, mask, root, scrambles = pixel_chunks(built, seed, chunk_pixels)
    state = film_mod.init_film(cfg, built.device)
    table = built.filter_table
    for s in range(spp):
        for c in range(xs.shape[0]):
            u = wave_uniforms(icfg, root, pix[c], scrambles[c], s)
            render_wave(state, scene, built.camera, table, xs[c], ys[c],
                        icfg, cfg, u, sample_scale=mask[c], diff_scale=diff_scale,
                        noise=camera_noise(built.camera, root, pix[c], s))
    return state
