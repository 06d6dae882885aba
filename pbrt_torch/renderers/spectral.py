"""The fork's per-wavelength renderer, ``Renderer "spectral"`` (port of
``pbrt_tpu/renderers/spectral.py``; reference:
src/renderers/spectralrenderer.cpp).

The film's bins are split into ``nWaveBands`` bands (default 32, a divisor
of the bin count). With ``samplingMethod`` ``singleDirection`` (the
default) every camera sample is traced once per band, its rays carrying
the band's centre wavelength, so a lens camera refracts each band on its
own (spectralrenderer.cpp:124); with ``samplerDirection`` sample s traces
band s mod nWaveBands only. The radiance is cleaned of NaN, infinite and
negative values, read at the traced wavelength (``value_at_wavelength``,
:180) and written into the band's bins (:183-188), zero elsewhere.

Within a sample, the bands share the primary-sample array (its camera
columns the scene's sampler's, ``adaptive`` taking lowdiscrepancy's with
no second pass, as the JAX spectral renderer has none), the media block of
a scene with volumes, the lens camera's keyed normals and the draws of
``igi`` and ``irradiancecache``, since the JAX
package draws them all from the same (pixel, sample) key: they are
computed once per sample and chunk (``wave_uniforms``, ``media_uniforms``,
``camera_noise``) and read by every band. Chunks and
their padding are the sampler renderer's; textured scenes take the pixel
cone footprint with no differentials, as the JAX package's spectral waves
do.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_torch.config import DEFAULT_SPECTRAL, SpectralConfig
from pbrt_torch.core import spectrum as spec
from pbrt_torch.film import film as film_mod
from pbrt_torch.integrators.path import trace_radiance
from pbrt_torch.renderers.sampler import (camera_noise, integrator_draws, media_uniforms,
                                          pixel_chunks, wave_uniforms)


def band_wavelength(band: int, n_bands: int, config: SpectralConfig) -> float:
    """The band's centre wavelength in float32, computed as the JAX
    package computes it (spectral.py:52-58)."""
    delta_wave = (config.lambda_end - config.lambda_start) / n_bands
    f = np.float32
    return float(f(config.lambda_start) + f(delta_wave) * f(band) + f(delta_wave * 0.5))


def spectral_wave(film_state, scene, camera, filter_table, pixel_x, pixel_y, icfg,
                  film_cfg, uniforms, noise, band: int, n_bands: int, config,
                  sample_scale=None, media=None, draws=None):
    """One (sample, band) wave of one chunk: trace at the band's centre
    wavelength, write the radiance there into the band's bins (in place)."""
    px = pixel_x.to(torch.float32) + uniforms[:, 0]
    py = pixel_y.to(torch.float32) + uniforms[:, 1]
    lam = torch.full_like(px, band_wavelength(band, n_bands, config))
    rays = camera.generate_rays(px, py, uniforms[:, 2], uniforms[:, 3], uniforms[:, 4],
                                wavelength=lam, noise=noise)
    L, first_t = trace_radiance(scene, rays, icfg, uniforms, media=media, draws=draws)
    L = torch.where(torch.isnan(L) | (L < 0.0) | torch.isinf(L), 0.0, L)
    width = config.n_bins // n_bands
    L_band = torch.zeros_like(L)
    L_band[:, band * width:(band + 1) * width] = spec.value_at_wavelength(L, lam, config)[:, None]
    return film_mod.add_samples(film_state, film_cfg, px, py, L_band, first_t, filter_table,
                                sample_scale=sample_scale, pixel_ids=(pixel_x, pixel_y))


def spectral_options(built):
    """(nWaveBands, samplingMethod, spectral config) of the scene's
    ``Renderer`` directive; raises on a band count that does not divide the
    bins. Any method but ``singleDirection`` samples one band per sample,
    as in the JAX package (spectral.py:134-137)."""
    params = built.renderer_params
    n_bands = params.find_one_int("nWaveBands", 32) if params else 32
    method = (params.find_one_string("samplingMethod", "singleDirection") if params
              else "singleDirection")
    n_bins = built.film_config.n_bins
    config = DEFAULT_SPECTRAL if n_bins == 32 else SpectralConfig(n_bins=n_bins)
    if n_bands <= 0 or n_bins % n_bands != 0:
        raise ValueError(f"nWaveBands={n_bands} must divide {n_bins}")
    return n_bands, method, config


def render_spectral(built, spp=None, seed: int = 0, chunk_pixels: int | None = None):
    """Every sample × chunk × band wave → the film, on the built scene's
    device (spectral.py:96-157)."""
    n_bands, method, config = spectral_options(built)
    spp = spp if spp is not None else built.pixel_samples
    sampler = built.sampler_name
    cfg, icfg, camera = built.film_config, built.integrator, built.camera
    xs, ys, pix, mask, root, scrambles = pixel_chunks(built, seed, chunk_pixels)
    state = film_mod.init_film(cfg, built.device)
    for s in range(spp):
        bands = range(n_bands) if method == "singleDirection" else (s % n_bands,)
        for c in range(xs.shape[0]):
            u = wave_uniforms(icfg, root, pix[c], scrambles[c], s, sampler, spp)
            noise = camera_noise(camera, root, pix[c], s)
            media = media_uniforms(built.scene, icfg, root, pix[c], s)
            draws = integrator_draws(built.scene, icfg, root, pix[c], s)
            for b in bands:
                spectral_wave(state, built.scene, camera, built.filter_table, xs[c], ys[c],
                              icfg, cfg, u, noise, b, n_bands, config, sample_scale=mask[c],
                              media=media, draws=draws)
    return state
