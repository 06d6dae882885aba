"""The scene's renderer and its output files (port of
``pbrt_tpu/renderers/dispatch.py``; reference: RenderOptions::MakeRenderer,
api.cpp:1333-1420, and each renderer's film WriteImage).

``sampler`` (the default), ``spectral`` / ``spectralrenderer`` and
``cameras`` render; ``aggregatetest`` fires random rays through the
accelerator and brute force and prints how many disagree (it writes no
file); ``surfacepoints`` writes the dipole integrator's Poisson point set
(``renderers/surface_points.py``); ``metropolis`` and ``createprobes``
are not ported yet and raise.
"""

from __future__ import annotations

import os

from pbrt_torch.film import film as film_mod
from pbrt_torch.film import imageio

NOT_PORTED = ("metropolis", "createprobes")


def render_scene(built, spp=None, seed: int = 0, quick: bool = False,
                 outfile: str | None = None, chunk_pixels: int | None = None) -> list:
    """Runs the scene's renderer and writes its outputs → their paths.
    ``quick`` renders 1 spp (pbrt's --quick; the adaptive sampler's
    ``minsamples`` and ``maxsamples`` 1)."""
    if quick:
        spp = 1
    name = built.renderer_name
    if name in NOT_PORTED:
        raise NotImplementedError(f"renderer {name!r} is not ported yet")
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
    else:
        from pbrt_torch.renderers.sampler import render

        state = render(built, spp=spp, seed=seed, chunk_pixels=chunk_pixels, quick=quick)
    return write_outputs(built, state, outfile)


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
