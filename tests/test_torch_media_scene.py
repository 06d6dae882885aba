"""The slice end to end on the CPU: ``render(seed)`` of the fog scene under
the single-scattering volume integrator against the JAX package's (its
render compiled whole, about a minute and a half of XLA), the spectral
renderer on a scene with a volume, and the port's command line on a
water-volume scene with the halton sampler.

Tolerances: the render as ``tests/test_torch_film.py``'s (pixels rtol
1e-4, atol 1e-6 on ≥ 99%, per-bin sums within 1e-3 of the largest, weights
rtol 1e-5). The spectral renderer with 32 bands over 32 bins traces each
bin's centre wavelength: at 1 spp its film is the sampler renderer's read
at each band's wavelength (``value_at_wavelength``: halfway to the next
bin), within rtol 1e-5 (the same paths; read before or after the film's
filter weight).
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild

from pbrt_torch import cli
from pbrt_torch.film import film as tfilm
from pbrt_torch.renderers import sampler as tsampler
from pbrt_torch.core import spectrum as tspec
from pbrt_torch.renderers.spectral import band_wavelength, render_spectral, spectral_options
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from test_torch_volumes import jax_pieces_compiled
from torch_parity_util import fog_scene_text, jax_integrator_pieces, write_absorption_curve


def test_single_scattering_render_seed_matches_jax():
    """``render(seed)`` of the 8×8 fog scene (directlighting depth 1, 1 spp,
    single scattering: 32 light samples and shadow rays per camera
    segment), both packages."""
    text = fog_scene_text("single")
    with jax_integrator_pieces(), jax_pieces_compiled():
        js = j_render(jbuild(jload(text)), spp=1, seed=2, chunk_pixels=40, verbose=False)
    tb = tbuild(tload(text), device="cpu")
    assert tb.integrator.volume_kind == "single"
    ts = tsampler.render(tb, spp=1, seed=2, chunk_pixels=40)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)
    # single scattering adds in-scattered light to emission alone
    te = tsampler.render(tbuild(tload(fog_scene_text("emission")), device="cpu"), spp=1, seed=2,
                         chunk_pixels=40)
    assert float(ts.pixels.sum()) > float(te.pixels.sum()) > 0.0


@pytest.mark.parametrize("volume_integrator", ["emission", "single"])
def test_spectral_renderer_with_a_volume(volume_integrator):
    """``render_spectral`` with 32 bands on the fog scene: each band traces
    its bin's centre wavelength through the volume and writes that bin the
    radiance read there, so the film is the sampler renderer's read at the
    bands' wavelengths; any other volume integrator name renders as
    emission."""
    spectral = fog_scene_text(volume_integrator, renderer='Renderer "spectral" '
                              '"integer nWaveBands" [32]')
    sb = tbuild(tload(spectral), device="cpu")
    fs = render_spectral(sb, spp=1, seed=4)
    fr = tsampler.render(tbuild(tload(fog_scene_text(volume_integrator)), device="cpu"),
                         spp=1, seed=4)
    assert fs.pixels.sum() > 0 and torch.isfinite(fs.pixels).all()
    n_bands, _, config = spectral_options(sb)
    lam = lambda b: torch.full(fr.pixels.shape[:2], band_wavelength(b, n_bands, config))
    want = torch.stack([tspec.value_at_wavelength(fr.pixels, lam(b), config)
                        for b in range(n_bands)], -1)
    np.testing.assert_allclose(fs.pixels.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    other = tbuild(tload(fog_scene_text("nosuchintegrator")), device="cpu")
    assert other.integrator.volume_kind == "emission"


def test_cli_water_volume_with_halton(tmp_path):
    """``python -m pbrt_torch.cli scene --cpu`` on a water volume (its
    absorption curve from a file) under single scattering and the halton
    sampler: the .dat is written, finite and lit, and a seed repeats."""
    curve = write_absorption_curve(tmp_path / "abs.txt")
    water = (f'Volume "water" "point p0" [-5 -5 -5] "point p1" [5 5 5] '
             f'"string absorptionCurveFile" ["{curve}"] "spectrum sigma_s" [395 .2 715 .1] '
             '"float g" [.4]')
    scene = tmp_path / "water.pbrt"
    scene.write_text(fog_scene_text("single", spp=2, sampler="halton", volume=water))
    out = tmp_path / "out.dat"
    assert cli.main([str(scene), "--cpu", "--quiet", "--outfile", str(out)]) == 0
    img, header = tfilm.read_dat(str(out))
    assert img.shape == (8, 8, 32) and np.isfinite(img).all() and img.sum() > 0
    assert os.path.exists(tmp_path / "out.exr")
    assert cli.main([str(scene), "--cpu", "--quiet", "--outfile", str(tmp_path / "again.dat")]) == 0
    np.testing.assert_array_equal(tfilm.read_dat(str(tmp_path / "again.dat"))[0], img)
