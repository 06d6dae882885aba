"""Parity of the port's ``whitted``, ``ambientocclusion`` and ``metadata``
integrators with the JAX package (``directlighting`` has its own file,
test_torch_directlighting.py).

Both packages trace the very same camera rays of the tiny built-in scene
(16×16) on the very same scene arrays (``interop`` of the JAX build).
Whitted reads an explicit primary-sample array (``uniforms=``) on both
sides. Ambient occlusion is keyed: the JAX side draws its directions from
the lane keys ``pixel_sample_key(root, pixel, sample)``, the port reads
them from ``rng.ao_uniforms_plain`` of the same root, pixels and sample.

Tolerances: whitted — per-lane L allclose (rtol 1e-4, atol 1e-6) on ≥ 99%
of lanes and per-bin means within 1e-3 relative (as test_torch_path.py:
float order may flip a grazing decision); AO — the visible fraction equal
on ≥ 99% of lanes (an occlusion ray that grazes a surface may flip);
metadata — depth rtol 1e-5, mesh and material ids equal exactly. Whole
``render(seed)`` calls of both packages (each wave's keyed array drawn as
the kind needs it): AO films on ≥ 99% of pixels at rtol 1e-4 and metadata
films at rtol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core import rng as trng
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.integrators.path import IntegratorConfig
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, tiny_scene_text

N = 16


@pytest.fixture(scope="module")
def setup():
    jb = jbuild(jload(tiny_scene_text(N, N)))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(3)
    u = rng.random((N * N, JPS.n_dims(5)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px = (xs + u[:, 0]).astype(np.float32)
    py = (ys + u[:, 1]).astype(np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    tr = TRay.make(torch.as_tensor(np.asarray(jr.origin)),
                   torch.as_tensor(np.asarray(jr.direction)))
    return dict(jb=jb, scene=scene, u=u, jr=jr, tr=tr, pix=np.arange(N * N))


def _jcfg(jb, **kw):
    return dataclasses.replace(jb.integrator, n_bins=32, **kw)


def test_whitted_matches_jax(setup):
    s = setup
    Lj, fj = j_trace(s["jb"].scene, s["jr"], None, _jcfg(s["jb"], kind="whitted", max_depth=5),
                     uniforms=jnp.asarray(s["u"]))
    Lt, ft = t_trace(s["scene"], s["tr"], IntegratorConfig(kind="whitted", max_depth=5),
                     torch.as_tensor(s["u"]))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.sum() > 0
    assert np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    mj, mt = Lj.mean(0), Lt.mean(0)
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
    # delta continuation only: the path integrator's indirect light is gone
    Lp, _ = t_trace(s["scene"], s["tr"], IntegratorConfig(max_depth=5), torch.as_tensor(s["u"]))
    assert (Lp.numpy().sum(-1) > 1.001 * Lt.sum(-1)).sum() >= 5


@pytest.mark.parametrize("n_ao,maxdist", [(4, float("inf")), (3, 1.5)])
def test_ambient_occlusion_matches_jax(setup, n_ao, maxdist):
    s = setup
    sample = 3
    root_j = jrng.root_key(5)
    keys = jrng.pixel_sample_key(root_j, jnp.asarray(s["pix"], jnp.uint32), np.uint32(sample))
    Lj, fj = j_trace(s["jb"].scene, s["jr"], keys,
                     _jcfg(s["jb"], kind="ambientocclusion", ao_nsamples=n_ao,
                           ao_maxdist=maxdist))
    root, pix = trng.root_key(5), torch.as_tensor(s["pix"])
    u = trng.ao_uniforms(root, pix, trng.pixel_scrambles(root, pix), sample, n_ao)
    assert u.shape == (N * N, 5 + 2 * n_ao)
    cfg = IntegratorConfig(kind="ambientocclusion", ao_nsamples=n_ao, ao_maxdist=maxdist)
    Lt, ft = t_trace(s["scene"], s["tr"], cfg, u)
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert Lt.shape == (N * N, 32) and (Lt == Lt[:, :1]).all()
    frac_j, frac_t = Lj[:, 0], Lt[:, 0]
    assert (frac_t == frac_j).mean() >= 0.99
    assert 0.0 < frac_t.mean() < 1.0
    assert np.isin(frac_t, (np.arange(n_ao + 1) / n_ao).astype(np.float32)).all()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)


@pytest.mark.parametrize("channel", ["depth", "mesh_mask", "material_mask"])
def test_metadata_matches_jax(setup, channel):
    s = setup
    Lj, fj = j_trace(s["jb"].scene, s["jr"], None,
                     _jcfg(s["jb"], kind="metadata", metadata_channel=channel))
    Lt, ft = t_trace(s["scene"], s["tr"],
                     IntegratorConfig(kind="metadata", metadata_channel=channel),
                     torch.as_tensor(s["u"][:, :5]))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert Lt.shape == (N * N, 32)
    if channel == "depth":
        np.testing.assert_allclose(Lt, Lj, rtol=1e-5)
    else:
        np.testing.assert_array_equal(Lt, Lj)
        assert len(np.unique(Lt)) >= 3  # a miss (0) and at least two ids
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)


def test_builder_reads_integrator_parameters():
    """The integrator kinds and their parameters as the JAX builder reads
    them, ``metadata``'s channel from ``strategy`` included."""
    for directive in ('"directlighting" "integer maxdepth" [3] "string strategy" ["one"]',
                      '"whitted" "integer maxdepth" [2]',
                      '"ambientocclusion" "integer nsamples" [6] "float maxdist" [2.5]',
                      '"ambientocclusion"',
                      '"metadata" "string strategy" ["mesh_mask"]'):
        text = tiny_scene_text(4, 4).replace('"path" "integer maxdepth" [4]', directive)
        j, t = jbuild(jload(text)).integrator, tbuild(tload(text), device="cpu").integrator
        for f in ("kind", "max_depth", "strategy", "ao_nsamples", "ao_maxdist",
                  "metadata_channel", "n_bins"):
            assert getattr(t, f) == getattr(j, f), (directive, f)


@pytest.mark.parametrize("directive", ['"ambientocclusion" "integer nsamples" [3]',
                                       '"metadata" "string strategy" ["material_mask"]'])
def test_render_seed_matches_jax(directive):
    """The 8×8 tiny scene by both packages' ``render`` (2 spp, seed 4,
    40-pixel chunks: the last chunk is padded)."""
    text = tiny_scene_text(8, 8).replace('"path" "integer maxdepth" [4]', directive)
    js = j_render(jbuild(jload(text)), spp=2, seed=4, chunk_pixels=40, verbose=False)
    ts = render(tbuild(tload(text), device="cpu"), spp=2, seed=4, chunk_pixels=40)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (8, 8, 32) and pt.sum() > 0
    rtol = 1e-4 if "ambient" in directive else 1e-5
    assert np.isclose(pt, pj, rtol=rtol, atol=1e-6).all(-1).mean() >= (
        0.99 if "ambient" in directive else 1.0)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)
