"""The scene's renderer and its output files (port of
``pbrt_tpu/renderers/dispatch.py``; reference: RenderOptions::MakeRenderer,
api.cpp:1333-1420, and each renderer's film WriteImage).

``sampler`` (the default), ``spectral`` / ``spectralrenderer`` and
``cameras`` render, and so does ``metropolis`` (``renderers/
metropolis.py``); ``aggregatetest`` fires random rays through the
accelerator and brute force and prints how many disagree (it writes no
file); ``surfacepoints`` writes the dipole integrator's Poisson point set
(``renderers/surface_points.py``); ``createprobes`` writes the probe file
(``renderers/probes.py``) on a grid of ⌈extent / ``samplespacing``⌉
probes per axis (default spacing 1, as the JAX package's
dispatch.py:50-58) with ``indirectsamples`` (default 512) clamped to [16,
256] directions, seed 0, and returns its name. Any other name renders as
``sampler``, as the JAX package's does (dispatch.py:76-79).
"""

from __future__ import annotations

import math
import os

from pbrt_torch.film import film as film_mod
from pbrt_torch.film import imageio

def render_scene(built, spp=None, seed: int = 0, quick: bool = False,
                 outfile: str | None = None, chunk_pixels: int | None = None) -> list:
    """Runs the scene's renderer and writes its outputs → their paths.
    ``quick`` renders 1 spp (pbrt's --quick; the adaptive sampler's
    ``minsamples`` and ``maxsamples`` 1)."""
    if quick:
        spp = 1
    name = built.renderer_name
    if name == "createprobes":
        return [_create_probes(built)]
    if name == "surfacepoints":
        from pbrt_torch.renderers.surface_points import render_surface_points

        return render_surface_points(built, quick=quick)
    if name == "aggregatetest":
        from pbrt_torch.renderers.aggregatetest import run_aggregate_test

        n_bad = run_aggregate_test(
            built, niters=built.renderer_params.find_one_int("niters", 100000))
        print(f"[pbrt_torch] aggregatetest: {n_bad} disagreements")
        return []
    if name == "cameras":
        from pbrt_torch.renderers.cameras_renderer import render_cameras

        outputs = []
        for state, suffix in render_cameras(built, spp=spp, seed=seed,
                                            chunk_pixels=chunk_pixels, quick=quick):
            outputs += write_outputs(built, state, outfile, suffix=suffix)
        return outputs
    if name in ("spectral", "spectralrenderer"):
        from pbrt_torch.renderers.spectral import render_spectral

        state = render_spectral(built, spp=spp, seed=seed, chunk_pixels=chunk_pixels)
    elif name == "metropolis":
        from pbrt_torch.renderers.metropolis import render_metropolis

        state = render_metropolis(built, spp=spp, seed=seed, quick=quick)
    else:
        from pbrt_torch.renderers.sampler import render

        state = render(built, spp=spp, seed=seed, chunk_pixels=chunk_pixels, quick=quick)
    return write_outputs(built, state, outfile)


def _create_probes(built) -> str:
    """``Renderer "createprobes"`` (dispatch.py:36-63) → the file written."""
    from pbrt_torch.renderers.probes import create_probes

    p = built.renderer_params
    spacing = p.find_one_float("samplespacing", 1.0)
    g = built.scene.geometry
    ext = (g.world_hi - g.world_lo).tolist()  # float32 extents, as numpy's
    nprobes = tuple(max(1, math.ceil(e / spacing)) for e in ext)
    filename = p.find_one_string("filename", "probes.out")
    create_probes(built, lmax=p.find_one_int("lmax", 4), nprobes=nprobes,
                  nindir=max(16, min(p.find_one_int("indirectsamples", 512), 256)),
                  filename=filename)
    return filename


def write_outputs(built, state, outfile: str | None = None, suffix: str = "") -> list:
    """The film in the format its file name says (dispatch.py:88-120): a
    ``.dat`` (or no extension) writes the spectral planes and an EXR
    preview, ``.exr`` the preview and the planes, ``.pfm`` the preview,
    ``.png`` / ``.tga`` an 8-bit preview; the ``spectralImageNoCamera``
    film also writes ``<name>_depth.exr``. → the paths written."""
    cfg = built.film_config
    filename = outfile or cfg.filename
    base, ext = os.path.splitext(filename)
    base += suffix
    rgb = film_mod.to_rgb_image(state)
    if ext in ("", ".dat"):
        outputs = [film_mod.write_dat(state, cfg, base + ".dat"),
                   imageio.write_exr(base + ".exr", rgb)]
    elif ext == ".exr":
        outputs = [imageio.write_exr(base + ext, rgb),
                   film_mod.write_dat(state, cfg, base + ".dat")]
    else:
        outputs = [imageio.write_image(base + ext, rgb)]
    if cfg.kind.lower() == "spectralimagenocamera":
        outputs.append(film_mod.write_depth_exr(state, base + "_depth.exr"))
    return outputs
