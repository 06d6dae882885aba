"""The port's precomputed radiance transfer (``pbrt_torch/integrators/prt.py``)
against the JAX package's (``pbrt_tpu/integrators/prt.py``), on
``torch_parity_util.prt_scene_text``: a matte floor under a constant sky
and a sphere light, a dark blocker, a plastic and a mirror sphere, 8×8,
lmax 4, ``nsamples`` 8 (16 projection rays, 8 samples per hit).

The JAX side runs eagerly with its per-step pieces compiled once each
(``torch_parity_util.jax_integrator_pieces``, entered once for the
module), reading a hit area light's row as the port does
(``jax_area_rows_like_port``: its rows start with the sky's); the port's
per-lane side takes the JAX package's arrays and its
``PRTData`` through ``interop``, its draws from ``prt_draws`` (the same
threefry chains as the JAX package's keys).

Tolerances: ``c_in`` rtol 1e-5, atol 2e-6 (16 directlighting traces and
a 16-term SH dot product; XLA contracts products into FMAs); the
per-lane radiance rtol 1e-4, atol 1e-6 on ≥ 99% of lanes (a shadow ray
that grazes an edge sees another visibility); ``render(seed)`` pixels
rtol 1e-4, atol 1e-6 on ≥ 98% of the 64 (all but one: under glossyprt a
pixel on the plastic sphere's highlight differs by 1.2e-4, the lobe's
f / pdf through XLA's fused products), per-bin sums rtol 1e-4.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.path as jpath
import pbrt_tpu.integrators.prt as jprt
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core import interaction as jinter
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.materials import table as jmt
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.integrators import path as tpath
from pbrt_torch.integrators import prt
from pbrt_torch.interop import integrator_from_numpy, scene_from_numpy
from pbrt_torch.materials import table as tmt
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import (jax_area_rows_like_port, jax_integrator_pieces, jax_scene_arrays,
                               prt_scene_text)

N = 8
DIFFUSE = '"diffuseprt" "integer nsamples" [8]'
TOL = dict(rtol=1e-4, atol=1e-6)
SAMPLE = 2


def _pieces():
    """``jax_integrator_pieces`` plus the PRT module's own lookups (its
    ``_hit_setup`` imports intersect and surface_interaction at each
    call), with the area-light rows read as the port reads them
    (``jax_area_rows_like_port``)."""
    stack = jax_integrator_pieces()
    stack.enter_context(mock.patch.object(jisect, "intersect", jax.jit(
        jisect.intersect, static_argnames=("any_hit",))))
    stack.enter_context(mock.patch.object(jinter, "surface_interaction", jax.jit(
        jinter.surface_interaction, static_argnames=("spread",))))
    stack.enter_context(jax_area_rows_like_port())
    return stack


@pytest.fixture(scope="module")
def setup():
    """The JAX build and the shared rays and keys; the JAX package's pieces
    stay compiled and patched for every test of the module."""
    with _pieces():
        text = prt_scene_text(DIFFUSE)
        jb = jbuild(jload(text))
        arrays = jax_scene_arrays(jb)
        scene, _, _ = scene_from_numpy(arrays, "cpu")
        rs = np.random.default_rng(8)
        u = rs.random((N * N, 5), dtype=np.float32)
        ys, xs = np.divmod(np.arange(N * N), N)
        jr = jb.camera.generate_rays(jnp.asarray((xs + u[:, 0]).astype(np.float32)),
                                     jnp.asarray((ys + u[:, 1]).astype(np.float32)),
                                     *(jnp.asarray(u[:, k]) for k in (2, 3, 4)))
        pix = np.arange(N * N, dtype=np.int64)
        keys = jrng.pixel_sample_key(jrng.root_key(4), jnp.asarray(pix.astype(np.uint32)),
                                     jnp.uint32(SAMPLE))
        rays = geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction)))
        yield dict(text=text, jb=jb, scene=scene, icfg=integrator_from_numpy(arrays), jr=jr,
                   keys=keys, rays=rays, pix=torch.as_tensor(pix))


def _both_li(s, kind, jscene=None, scene=None):
    """The kind's radiance per lane from the JAX package and from the port
    on the same rays and keys."""
    jcfg = dataclasses.replace(s["jb"].integrator, kind=kind)
    icfg = dataclasses.replace(s["icfg"], kind=kind)
    jli = jprt.diffuseprt_li if kind == "diffuseprt" else jprt.glossyprt_li
    tli = prt.diffuseprt_li if kind == "diffuseprt" else prt.glossyprt_li
    Lj, tj = jli(jscene or s["jb"].scene, s["jr"], s["keys"], jcfg)
    draws = {"prt": prt.prt_draws(rng.root_key(4), s["pix"], SAMPLE, icfg)}
    L, t = tli(scene or s["scene"], s["rays"], icfg, draws)
    return np.asarray(Lj), np.asarray(tj), L.numpy(), t.numpy()


def test_project_incident_radiance_matches_jax(setup):
    """The preprocess product: the port's own build against the JAX
    package's, and the interop copy carries it bit for bit."""
    cj = np.asarray(setup["jb"].scene.prt.c_in)
    tb = tbuild(tload(setup["text"]), device="cpu")
    ct = tb.scene.prt.c_in.numpy()
    assert ct.shape == (25, 32) and tb.scene.prt.lmax == 4 and np.abs(ct[0]).min() > 0.1
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(setup["scene"].prt.c_in.numpy(), cj)
    assert tb.integrator.prt_nsamples == setup["jb"].integrator.prt_nsamples == 8


@pytest.mark.parametrize("kind", ["diffuseprt", "glossyprt"])
def test_prt_li_matches_jax(setup, kind):
    """Per lane, on the JAX package's scene and PRTData: the first hit's
    emission and sky, then the transfer (diffuse) or the BSDF samples
    against the reconstructed lighting (glossy)."""
    Lj, tj, L, t = _both_li(setup, kind)
    assert np.isfinite(L).all() and L.sum() > 0 and (L.sum(-1) > 0).mean() > 0.8
    assert np.isclose(L, Lj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(t, tj, rtol=1e-5)


@pytest.mark.parametrize("kind", ["diffuseprt", "glossyprt"])
def test_render_seed_matches_jax(setup, kind):
    """``render`` of the 8×8 scene (1 spp, seed 3), each package from its
    own build; and the JAX package's PRTData carried through interop into
    the port's build renders as the port's own preprocess."""
    jb = dataclasses.replace(setup["jb"], integrator=dataclasses.replace(
        setup["jb"].integrator, kind=kind))
    js = j_render(jb, spp=1, seed=3, verbose=False)
    text = prt_scene_text(DIFFUSE.replace("diffuseprt", kind))
    tb = tbuild(tload(text), device="cpu")
    pt = render(tb, spp=1, seed=3).pixels.numpy()
    pj = np.asarray(js.pixels)
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.98
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-4)
    fed = dataclasses.replace(tb, scene=dataclasses.replace(tb.scene, prt=setup["scene"].prt))
    pf = render(fed, spp=1, seed=3).pixels.numpy()
    assert np.isclose(pf, pt, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pf.sum((0, 1)), pt.sum((0, 1)), rtol=1e-5)


def test_fact_projection_and_per_hit_sample_counts(setup):
    """Fact: the projection traces max(min(nsamples, 4096), 16) rays, each
    hit takes min(nsamples, 64) samples (builder.py:743-747, :760-764),
    in both packages; the port's default is 4,096 and 64. The JAX side's
    builder is run with the projection recorded, and the projection with
    its trace recorded (each returning zeros)."""
    traced = []

    def spy(real):
        def f(scene, rays, *a, **kw):
            traced.append(rays.origin.shape[0])
            return real(scene, rays, *a, **kw)
        return f

    asked = []

    def j_project(scene, cfg, lmax, nsamples, seed=0):
        asked.append(nsamples)
        return setup["jb"].scene.prt

    def j_trace(scene, rays, keys, cfg, **kw):
        traced.append(rays.origin.shape[0])
        return jnp.zeros((rays.origin.shape[0], cfg.n_bins)), jnp.zeros(rays.origin.shape[0])

    for n, want_rays, want_hit in ((8, 16, 8), (100, 100, 64), (None, 4096, 64)):
        extra = "" if n is None else f' "integer nsamples" [{n}]'
        text = prt_scene_text('"diffuseprt"' + extra)
        traced.clear()
        with mock.patch.object(tpath, "trace_radiance", spy(tpath.trace_radiance)):
            tb = tbuild(tload(text), device="cpu")
        assert traced == [want_rays] and tb.integrator.prt_nsamples == want_hit
        asked.clear()
        with mock.patch.object(jprt, "project_incident_radiance", j_project):
            jb = jbuild(jload(text))
        assert jb.integrator.prt_nsamples == want_hit
        traced.clear()
        with mock.patch.object(jpath, "trace_radiance", j_trace):
            jprt.project_incident_radiance(jb.scene, jb.integrator, 4, asked[0])
        assert traced == [want_rays]


def test_fact_glossyprt_samples_the_bsdf_per_hit(setup):
    """Fact: glossyprt is the direct-sampling branch (prt.py:17-23), not SH
    rotation: each hit draws N BSDF samples and traces N shadow rays, in
    both packages."""
    calls = {"jax": 0, "port": 0}
    real_j, real_t = jmt.bsdf_sample, tmt.bsdf_sample

    def count(side, real):
        def f(*a, **kw):
            calls[side] += 1
            return real(*a, **kw)
        return f

    with mock.patch.object(jmt, "bsdf_sample", count("jax", real_j)), \
            mock.patch.object(tmt, "bsdf_sample", count("port", real_t)):
        _both_li(setup, "glossyprt")
    assert calls == {"jax": 8, "port": 8}


#: every surface of ``PRT_SCENE`` black, so the projection sees only the
#: lights themselves
BLACK = (('"color Kd" [.6 .6 .6]', '"color Kd" [0 0 0]'), ('"color Kd" [.1 .1 .1]',
         '"color Kd" [0 0 0]'), ('"color Kd" [.4 .2 .2] "color Ks" [.4 .4 .4]',
                                 '"color Kd" [0 0 0] "color Ks" [0 0 0]'),
         ('"color Kr" [.8 .8 .8]', '"color Kr" [0 0 0]'))


def _black_view(point_i: str, sky: str) -> str:
    """``PRT_SCENE`` under diffuseprt with every surface black, a point
    light of intensity ``point_i`` in plain view of the world centre, and
    the sky's L ``sky``."""
    text = prt_scene_text(DIFFUSE, lights=f'LightSource "point" "rgb I" [{point_i}] '
                          '"point from" [0 2.5 0]')
    for a, b in BLACK + (('"rgb L" [.6 .7 .8]', f'"rgb L" [{sky}]'),):
        assert a in text
        text = text.replace(a, b)
    return text


def test_fact_delta_lights_are_absent_from_c_in(setup):
    """Fact: a delta light in plain view of the world centre does not
    reach c_in: no projection ray can hit it (prt.py:25-27). It enters
    only as light that the hit surfaces reflect (their NEE samples it):
    with every surface black, a point light of I 40 gives c_in bit for
    bit as one of I 0, while the sky's L does change it, in both
    packages."""
    views = [("40 40 40", ".6 .7 .8"), ("0 0 0", ".6 .7 .8"), ("40 40 40", ".3 .3 .3")]
    cj = [np.asarray(jbuild(jload(_black_view(*v))).scene.prt.c_in) for v in views]
    ct = [tbuild(tload(_black_view(*v)), device="cpu").scene.prt.c_in.numpy() for v in views]
    for c in (cj, ct):
        np.testing.assert_array_equal(c[0], c[1])
        assert np.abs(c[0] - c[2]).max() > 1e-3
    np.testing.assert_allclose(ct[0], cj[0], rtol=1e-5, atol=2e-6)


def test_fact_diffuseprt_takes_a_mix_lanes_first_kd(setup):
    """Fact: on a mix floor (bright .6 and dim at amount .5), diffuseprt
    weights by the first material's kd (prt.py:140): each package's
    radiance equals its own on the plain bright floor."""
    arrays = jax_scene_arrays(setup["jb"])
    jb_mix = jbuild(jload(prt_scene_text(DIFFUSE, floor="mix")))
    jscene = dataclasses.replace(jb_mix.scene, prt=setup["jb"].scene.prt)
    mix_arrays = jax_scene_arrays(jb_mix)
    mix_arrays.update(prt_c_in=arrays["prt_c_in"], prt_lmax=arrays["prt_lmax"])
    scene, _, _ = scene_from_numpy(mix_arrays, "cpu")
    assert scene.materials.has_mix
    Lj, _, L, _ = _both_li(setup, "diffuseprt", jscene=jscene, scene=scene)
    Lj0, _, L0, _ = _both_li(setup, "diffuseprt")
    np.testing.assert_array_equal(L, L0)
    np.testing.assert_array_equal(Lj, Lj0)
