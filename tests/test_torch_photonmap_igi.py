"""The port's photon mapping and instant global illumination
(``pbrt_torch/integrators/photonmap.py``, ``igi.py``) against the JAX
package's (``pbrt_tpu/integrators/photonmap.py``, ``igi.py``), in the tiny
scene closed into a room with a ``subsurface`` and a ``kdsubsurface`` box
(``torch_parity_util.subsurface_scene_text(room=True)``).

The JAX side runs eagerly with its per-step pieces compiled once each
(``torch_parity_util.jax_integrator_pieces``); the port's side takes the
JAX package's arrays (``interop``) or its own build.

Tolerances: which slots hold a photon or a VPL, and which photons are
caustic, equal; per photon or VPL, position atol 1e-4 and direction,
normal and power rtol 1e-4, atol 1e-6 on ≥ 99% of them (the light paths'
hits, up to five bounces deep, drift apart by ulps as XLA contracts
multiply-adds; a bounce off a grazing hit carries that to a few 1e-3);
the density estimate and the
VPL sum rtol 1e-4, atol 1e-6 on ≥ 99% of lanes (a photon an ulp from the
radius counts in one package and not in the other; a VPL's shadow ray
that grazes an edge); ``render(seed)`` as ``tests/test_torch_film.py``'s
(pixels rtol 1e-4, atol 1e-6 on ≥ 99%, per-bin sums rtol 1e-4).
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.igi as jigi
import pbrt_tpu.integrators.photonmap as jpm
from pbrt_tpu.accel.intersect import intersect as jintersect
from pbrt_tpu.bsdf import bxdf as jbxdf
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core.interaction import surface_interaction as jsurface
from pbrt_tpu.materials import table as jmt
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel.intersect import intersect
from pbrt_torch.bsdf import bxdf
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.core.interaction import surface_interaction
from pbrt_torch.integrators import igi, photonmap
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.materials import table as mt
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_integrator_pieces, jax_scene_arrays, subsurface_scene_text

PHOTONMAP = '"photonmap" "integer maxdepth" [2] "integer indirectphotons" [16384]'
IGI = '"igi" "integer maxdepth" [2] "integer nlights" [64]'
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def pieces():
    with jax_integrator_pieces():
        yield


def _pair(integrator):
    text = subsurface_scene_text(integrator, room=True)
    jb = jbuild(jload(text))
    scene, camera, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return dict(text=text, jb=jb, scene=scene, tb=tbuild(tload(text), device="cpu"))


@pytest.fixture(scope="module")
def photons(pieces):
    return _pair(PHOTONMAP)


@pytest.fixture(scope="module")
def vpls(pieces):
    return _pair(IGI)


def first_hits(s, n=256, seed=4):
    """Both packages' first hits of n random camera rays: (JAX si, JAX lane
    material, the port's si, lane material, wo_local, frame)."""
    rs = np.random.default_rng(seed)
    u = rs.random((n, 5), dtype=np.float32)
    px, py = u[:, 0] * 8, u[:, 1] * 8
    jb = s["jb"]
    jr = jb.camera.generate_rays(jnp.asarray(px), jnp.asarray(py), *(jnp.asarray(u[:, k])
                                                                    for k in (2, 3, 4)))
    jsi = jsurface(jb.scene.geometry, jr, jintersect(jb.scene.geometry, jr))
    o, d = (torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction))
    ray = geom.Ray.make(o, d)
    g = s["scene"].geometry
    si = surface_interaction(g, ray, intersect(g, ray))
    lm = mt.gather_lane(s["scene"].materials, si.material)
    ss, ts = bxdf.make_shading_frame(si.ns, si.dpdu)
    return jsi, jmt.gather_lane(jb.scene.materials, jsi.material), si, lm, \
        bxdf.world_to_local(si.wo, ss, ts, si.ns), (ss, ts, si.ns)


def _valid_equal(j, t, names, **tol):
    ok = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), ok)
    for k in names:
        a, b = getattr(t, k).numpy()[ok], np.asarray(getattr(j, k))[ok]
        share = np.isclose(a, b, **tol.get(k, TOL)).all(-1).mean()
        assert share >= 0.99 and np.isfinite(a).all(), (k, share)
    return ok


def test_shoot_photons_matches_jax(photons):
    """The photon maps of the JAX builder's preprocess against the port's on
    the same arrays and in its own build: 1,024 paths (16,384 / 16) of
    depth 5."""
    jp = photons["jb"].scene.photons
    for t in (photonmap.shoot_photons(photons["scene"], n_paths=1024, max_depth=5),
              photons["tb"].scene.photons):
        ok = _valid_equal(jp, t, ("p", "wi", "alpha"), p=dict(rtol=0, atol=1e-4))
        np.testing.assert_array_equal(t.is_caustic.numpy(), np.asarray(jp.is_caustic))
        assert t.p.shape == (5 * 1024, 3) and ok.sum() > 1000
        assert t.is_caustic.any() and (ok & ~t.is_caustic.numpy()).any()
        assert float(t.radius) == float(jp.radius)


def test_radiance_estimate_matches_jax(photons):
    """The density estimate at 256 first hits, all photons and the caustic
    and indirect maps alone."""
    jsi, jlm, si, lm, wo, frame = first_hits(photons)
    jp = photons["jb"].scene.photons
    jframe = (*jbxdf.make_shading_frame(jsi.ns, jsi.dpdu), jsi.ns)
    for which in (None, True, False):
        ref = np.asarray(jpm.radiance_estimate(jp, photons["jb"].scene, jsi, jlm, None, jframe,
                                               caustic_only=which))
        out = photonmap.radiance_estimate(photons["scene"].photons, photons["scene"], si, lm,
                                          caustic_only=which).numpy()
        assert np.isclose(out, ref, **TOL).all(-1).mean() >= 0.99
        if which is None:
            assert (ref.sum(-1) > 0).mean() > 0.2


def test_generate_vpls_matches_jax(vpls):
    """The VPLs of the JAX builder's preprocess (max(4 · 64, 256) paths of
    depth 2) against the port's, on the same arrays and in its own build."""
    jv = vpls["jb"].scene.vpls
    for t in (igi.generate_vpls(vpls["scene"], n_paths=256, max_depth=2),
              vpls["tb"].scene.vpls):
        ok = _valid_equal(jv, t, ("p", "n", "contrib"), p=dict(rtol=0, atol=1e-4))
        assert t.p.shape == (2 * 256, 3) and ok.sum() > 300


def test_vpl_lighting_matches_jax(vpls):
    """The VPL sum at 256 first hits from the same picks: the JAX package's
    keys folded with b·16 + PHOTON and k·16 + PHOTON, the port's
    ``vpl_picks`` block."""
    jsi, jlm, si, lm, wo, frame = first_hits(vpls)
    pix = np.arange(256, dtype=np.int64) * 3
    keys = jrng.bounce_key(jrng.pixel_sample_key(jrng.root_key(2), jnp.asarray(
        pix.astype(np.uint32)), jnp.uint32(0)), 1, jrng.PHOTON)
    jss, jts = jbxdf.make_shading_frame(jsi.ns, jsi.dpdu)
    jwo = jbxdf.world_to_local(jsi.wo, jss, jts, jsi.ns)
    ref = np.asarray(jigi.vpl_lighting(vpls["jb"].scene, vpls["jb"].scene.vpls, jsi, jlm, jwo,
                                       (jss, jts, jsi.ns), keys))
    u = igi.vpl_picks(rng.root_key(2), torch.as_tensor(pix), 0, 2)[:, 8:16]
    out = igi.vpl_lighting(vpls["scene"], vpls["scene"].vpls, si, lm, wo, frame, u).numpy()
    assert (ref.sum(-1) > 0).mean() > 0.3
    assert np.isclose(out, ref, **TOL).all(-1).mean() >= 0.99


@pytest.mark.parametrize("kind", ["photonmap", "igi"])
def test_render_seed_matches_jax(photons, vpls, kind):
    """``render`` of the 8×8 room under each integrator (depth 2, 1 spp,
    seed 3), each package from its own build and preprocess."""
    s = photons if kind == "photonmap" else vpls
    js = j_render(s["jb"], spp=1, seed=3, verbose=False)
    ts = render(s["tb"], spp=1, seed=3)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (8, 8, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-4)
    # the integrator's own term is in the image
    flag = "has_photons" if kind == "photonmap" else "has_vpls"
    off = render(dataclasses.replace(s["tb"], scene=dataclasses.replace(s["tb"].scene,
                                                                        **{flag: False})),
                 spp=1, seed=3).pixels.numpy()
    assert pt.sum() > off.sum() * 1.01


def test_fact_photonmap_parameters(pieces):
    """Facts: photonmap reads only ``indirectphotons`` (paths min(max(n / 16,
    1024), 8192)) and ``maxphotondepth``, its radius is 0.02 × the world
    radius, and ``exphotonmap`` is photonmap, in both packages."""
    for n, paths in ((100, 1024), (40000, 2500), (10**6, 8192)):
        text = subsurface_scene_text(
            f'"exphotonmap" "integer maxdepth" [1] "integer indirectphotons" [{n}] '
            '"integer maxphotondepth" [2] "integer causticphotons" [5] '
            '"float maxdist" [9] "integer nused" [3] "bool finalgather" ["false"]')
        tb = tbuild(tload(text), device="cpu")
        assert tb.integrator.kind == "photonmap" and tb.scene.photons.p.shape[0] == 2 * paths
        assert torch.equal(tb.scene.photons.radius, tb.scene.lights.world_radius * 0.02)
        if n == 100:
            jb = jbuild(jload(text))
            assert jb.integrator.kind == "photonmap"
            assert np.asarray(jb.scene.photons.p).shape[0] == 2 * paths
            np.testing.assert_array_equal(tb.scene.photons.valid.numpy(),
                                          np.asarray(jb.scene.photons.valid))


def test_fact_estimate_takes_lambertian_kd_for_every_lobe(photons):
    """Fact: the density estimate weights every photon by the lane's kd/π,
    whatever its lobes (photonmap.py:154-156): on the plastic sphere's
    lanes, with a glossy lobe, it is kd/π · Σα / (π r²) over the photons in
    reach, in both packages."""
    jsi, jlm, si, lm, _, _ = first_hits(photons, n=512, seed=6)
    maps = photons["scene"].photons
    mat = si.material.numpy()
    plastic = [i for i, k in enumerate(photons["scene"].materials.kind.tolist()) if k == mt.PLASTIC]
    lanes = si.valid.numpy() & np.isin(mat, plastic)
    d2 = ((si.p[:, None, :] - maps.p[None]) ** 2).sum(-1)
    near = ((d2 <= maps.radius ** 2) & maps.valid[None]).float()
    by_hand = (lm.kd * bxdf.INV_PI * (near @ maps.alpha) / (np.pi * maps.radius ** 2)).numpy()
    out = photonmap.radiance_estimate(maps, photons["scene"], si, lm).numpy()
    ref = np.asarray(jpm.radiance_estimate(photons["jb"].scene.photons, photons["jb"].scene,
                                           jsi, jlm, None,
                                           (*jbxdf.make_shading_frame(jsi.ns, jsi.dpdu), jsi.ns)))
    assert lanes.sum() > 10 and (out[lanes].sum(-1) > 0).any()
    np.testing.assert_allclose(out[lanes], by_hand[lanes], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ref[lanes], by_hand[lanes], rtol=1e-4, atol=1e-6)


def test_fact_igi_parameters(pieces):
    """Facts: igi reads ``nlights`` (paths max(4 · nlights, 256)) and
    ``maxdepth``; its clamp is 10 and it takes 8 VPLs per lane whatever
    ``glimit`` or ``nsets`` say, in both packages."""
    base = '"igi" "integer maxdepth" [2] "integer nlights" [{}]'
    for n, paths in ((16, 256), (100, 400)):
        tb = tbuild(tload(subsurface_scene_text(base.format(n))), device="cpu")
        assert tb.scene.vpls.p.shape[0] == 2 * paths
    text = subsurface_scene_text(base.format(16), room=True)
    other = subsurface_scene_text(base.format(16) + ' "float glimit" [.01] "integer nsets" [7]',
                                  room=True)
    films = [render(tbuild(tload(t), device="cpu"), spp=1, seed=1).pixels for t in (text, other)]
    assert torch.equal(*films)
    jfilms = [j_render(jbuild(jload(t)), spp=1, seed=1, verbose=False).pixels
              for t in (text, other)]
    np.testing.assert_array_equal(*(np.asarray(f) for f in jfilms))
    prm = inspect.signature(jigi.vpl_lighting).parameters
    assert igi.G_LIMIT == prm["g_limit"].default == 10.0
    assert igi.VPL_SAMPLES == prm["n_vpl_samples"].default == 8


@pytest.mark.parametrize("kind", ["photonmap", "igi"])
def test_jax_products_through_interop_render_as_the_ports_own(photons, vpls, kind):
    """The JAX builder's photon maps and VPLs, carried across by
    ``interop`` (the ``ph_*`` and ``vpl_*`` arrays), render as the port's own
    preprocess at the same seed."""
    s = photons if kind == "photonmap" else vpls
    tb = s["tb"]
    assert s["scene"].has_photons == (kind == "photonmap")
    assert s["scene"].has_vpls == (kind == "igi")
    films = [render(b, spp=1, seed=2).pixels.numpy()
             for b in (tb, dataclasses.replace(tb, scene=s["scene"]))]
    assert films[0].sum() > 0
    assert np.isclose(films[1], films[0], **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(films[1].sum((0, 1)), films[0].sum((0, 1)), rtol=1e-4)
