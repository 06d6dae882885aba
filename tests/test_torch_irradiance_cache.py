"""The port's irradiance cache (``pbrt_torch/integrators/irradiance.py``)
against the JAX package's (``irradiance_cache_li`` and
``_gather_irradiance``, ``pbrt_tpu/integrators/irradiance.py:50-165``), in
the tiny scene closed into a room with two subsurface boxes
(``torch_parity_util.subsurface_scene_text(room=True)``), 16×16.

The three passes are compared one by one from the same keys: the cache
fill at every 8th lane (E, wAvg, the nearest hit), then the whole
integrator (the window's interpolation and the masked miss gather), then
``render(seed)``. Then the same in a fog
(``torch_parity_util.fog_scene_text`` at 16×16, depth 2) under the
emission and the single-scattering volume integrators: the nested traces'
media blocks bit for bit against ``jax.random``, the radiance per lane
and ``render(seed)``. The JAX side runs eagerly with its per-step pieces
compiled once each (``torch_parity_util.jax_integrator_pieces``, and the
volumes' ``test_torch_volumes.jax_pieces_compiled``); the port's side
takes the JAX package's arrays, its draws from ``cache_draws`` (the same
threefry chains).

Tolerances: E, wAvg and the radiance rtol 1e-4, atol 1e-6 on ≥ 99% of
lanes (each gather is K nested directlighting traces: a shadow ray that
grazes an edge, or a bounce of a lane an ulp off, sees another light
sample); the nearest hit rtol 1e-5; which lanes the cache serves equal;
``render(seed)`` as ``tests/test_torch_film.py``'s (pixels rtol 1e-4,
atol 1e-6 on ≥ 99%, per-bin sums rtol 1e-4).
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.irradiance as jirr
from pbrt_tpu.accel.intersect import intersect as jintersect
from pbrt_tpu.bsdf import bxdf as jbxdf
from pbrt_tpu.core import geometry as jgeom
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
from pbrt_torch.integrators import irradiance as tirr
from pbrt_torch.integrators import path as tpath
from pbrt_torch.interop import integrator_from_numpy, scene_from_numpy
from pbrt_torch.materials import table as tmt
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from test_torch_volumes import jax_pieces_compiled
from torch_parity_util import (fog_scene_text, jax_integrator_pieces, jax_scene_arrays,
                               subsurface_scene_text)

N = 16
CACHE = '"irradiancecache" "integer maxdepth" [2]'
TOL = dict(rtol=1e-4, atol=1e-6)
SAMPLE = 2


@pytest.fixture(scope="module")
def setup():
    with jax_integrator_pieces():
        text = subsurface_scene_text(CACHE, N, N, room=True)
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
        icfg = integrator_from_numpy(arrays)
        draws = tirr.cache_draws(rng.root_key(4), torch.as_tensor(pix), SAMPLE, icfg)
        rays = geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction)))
        yield dict(text=text, jb=jb, scene=scene, jr=jr, keys=keys, icfg=icfg, draws=draws,
                   rays=rays, pix=pix)


def test_config_matches_jax(setup):
    icfg, jcfg = setup["icfg"], setup["jb"].integrator
    assert icfg.kind == jcfg.kind == "irradiancecache"
    for k in ("ic_minweight", "ic_minspacing", "ic_maxspacing", "ic_maxangle", "ic_stride",
              "ao_nsamples", "max_depth"):
        assert getattr(icfg, k) == getattr(jcfg, k), k
    assert tbuild(tload(setup["text"]), device="cpu").integrator == icfg


def test_cache_fill_matches_jax(setup):
    """Pass 1: the gather at every 8th lane's first hit, K = 4 nested
    directlighting traces each."""
    s = setup
    jb, jcfg = s["jb"], s["jb"].integrator
    g = jb.scene.geometry
    jsi = jsurface(g, s["jr"], jintersect(g, s["jr"]))
    jlm = jmt.gather_lane(jb.scene.materials, jsi.material)
    jdiff = jsi.valid & ~jmt.has_delta_only(jlm)
    jn = jgeom.face_forward(jsi.ns, jsi.wo)
    jss, jts = jbxdf.make_shading_frame(jn, jsi.dpdu)
    sub = lambda a: a[::8]
    import jax

    jsi_c = jax.tree_util.tree_map(sub, jsi)
    jr_c = jax.tree_util.tree_map(sub, s["jr"])
    direct = dataclasses.replace(jcfg, kind="directlighting")
    Ej, wj, mj = (np.asarray(a) for a in jirr._gather_irradiance(
        jb.scene, jsi_c, sub(jdiff), sub(jn), (sub(jss), sub(jts)), jr_c, sub(s["keys"]), 4,
        100, direct))
    sc = s["scene"]
    tg = sc.geometry
    rays = s["rays"]
    si = surface_interaction(tg, rays, intersect(tg, rays))
    lm = tmt.gather_lane(sc.materials, si.material)
    diff = si.valid & ~tmt.has_delta_only(lm)
    n_g = geom.face_forward(si.ns, si.wo)
    ss, ts = bxdf.make_shading_frame(n_g, si.dpdu)
    E, w, m = tirr._gather_irradiance(
        sc, sub(si.p), sub(si.ng), sub(si.ray_epsilon), sub(diff), sub(n_g), (sub(ss), sub(ts)),
        geom.Ray.make(sub(rays.origin), sub(rays.direction)), 4, s["draws"]["fill"],
        dataclasses.replace(s["icfg"], kind="directlighting"))
    assert Ej.shape == (N * N // 8, 32) and (Ej.sum(-1) > 0).mean() > 0.5
    assert np.isclose(E.numpy(), Ej, **TOL).all(-1).mean() >= 0.99
    assert np.isclose(w.numpy(), wj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(m.numpy(), mj, rtol=1e-5)


def test_irradiance_cache_li_matches_jax(setup):
    """All three passes: the radiance of every lane; the cache serves some
    lanes and misses others, as the JAX package's window decides."""
    s = setup
    jb = s["jb"]
    Lj, tj = jirr.irradiance_cache_li(jb.scene, s["jr"], s["keys"], jb.integrator)
    u = torch.as_tensor(rng.primary_uniforms_plain(rng.root_key(4), torch.as_tensor(s["pix"]),
                                                   torch.zeros((N * N, 6), dtype=torch.int64),
                                                   SAMPLE, 2))
    served = []
    real = tirr._gather_irradiance

    def spy(scene, p, ng, eps, diffuse, *a):
        served.append(diffuse.clone())
        return real(scene, p, ng, eps, diffuse, *a)

    with mock.patch.object(tirr, "_gather_irradiance", spy):
        L, t = tpath.trace_radiance(s["scene"], s["rays"], s["icfg"], u, draws=s["draws"])
    Lj, L = np.asarray(Lj), L.numpy()
    assert np.isfinite(L).all() and L.sum() > 0
    assert np.isclose(L, Lj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-5)
    miss = served[1].numpy()
    assert 0 < miss.sum() < (N * N) * 0.9


def test_render_seed_matches_jax(setup):
    """``render`` of the 16×16 room (depth 2, 1 spp, seed 3), each package
    from its own build."""
    with jax_integrator_pieces():
        js = j_render(setup["jb"], spp=1, seed=3, verbose=False)
    tb = tbuild(tload(setup["text"]), device="cpu")
    ts = render(tb, spp=1, seed=3)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-4)
    direct = render(dataclasses.replace(tb, integrator=dataclasses.replace(
        tb.integrator, kind="directlighting")), spp=1, seed=3).pixels.numpy()
    assert pt.sum() > direct.sum() * 1.05


def test_fact_nsamples_is_the_gather_count_and_stride_is_fixed(setup):
    """Facts: ``nsamples`` is the gather count K (default 4, not the
    reference's 4096): a wave runs 2K + 1 directlighting traces; and
    ``ic_stride`` is 8, not a parameter; in both packages."""
    for K in (4, 2):
        extra = "" if K == 4 else f' "integer nsamples" [{K}]'
        text = subsurface_scene_text(CACHE + extra + ' "integer stride" [3]', N, N, room=True)
        tb = tbuild(tload(text), device="cpu")
        jcfg = jbuild(jload(text)).integrator
        assert tb.integrator.ao_nsamples == jcfg.ao_nsamples == K
        assert tb.integrator.ic_stride == jcfg.ic_stride == 8
        kinds = []
        real = tpath.trace_radiance

        def spy(scene, rays, cfg, *a, **kw):
            kinds.append(cfg.kind)
            return real(scene, rays, cfg, *a, **kw)

        with mock.patch.object(tpath, "trace_radiance", spy):
            render(tb, spp=1, seed=0)
        assert kinds.count("directlighting") == 2 * K + 1
        draws = tirr.cache_draws(rng.root_key(0), torch.arange(N * N), 0, tb.integrator)
        assert draws["fill"][0].shape == (N * N // 8, 2 * K)
        assert draws["miss"][1].shape == (N * N, 5 + 7 * 2 * K)


# ---------------------------------------------------------------------------
# the cache in a fog: the nested traces' media blocks
# ---------------------------------------------------------------------------

FOG_CACHE = '"irradiancecache" "integer maxdepth" [2]'


def fog_cache_text(volume_integrator):
    """``torch_parity_util.fog_scene_text`` at 16×16 under the cache."""
    return fog_scene_text(volume_integrator, N, N).replace(
        '"directlighting" "integer maxdepth" [1]', FOG_CACHE)


@pytest.mark.parametrize("sample", [0, 2**31 + 1])
def test_fog_nested_media_match_jax_keys(sample):
    """Each gather k of both passes: its media block (``nested_media``)
    bit for bit against the JAX package's draws from its gather keys
    ``bounce_key(keys, salt + 100 + k, CAMERA)``: bounce b's jitter
    ``uniform_per(bounce_key(gkeys, b, VOLUME), 1)`` (path.py:224-231)
    and march step s's ``uniform_per(bounce_key(bounce_key(gkeys, 0,
    VOLUME), s, LIGHT_SAMPLE), 3)`` (volumes.py:190-209); the fill pass on
    every 8th lane. On CPU tensors the wrapper is the plain version."""
    pix = np.concatenate([np.arange(61, dtype=np.int64), [2**31, 2**32 - 1, 7]])
    keys = jrng.pixel_sample_key(jrng.root_key(5), jnp.asarray(pix.astype(np.uint32)),
                                 jnp.uint32(sample))
    cfg = tpath.IntegratorConfig(kind="irradiancecache", max_depth=2, volume_kind="single")
    before = dict(rng.launches)
    draws = tirr.cache_draws(rng.root_key(5), torch.as_tensor(pix), sample, cfg, volumes=True)
    assert rng.launches == before
    for name, salt, rows in (("fill", tirr.FILL_SALT, slice(None, None, 8)),
                             ("miss", tirr.MISS_SALT, slice(None))):
        media = draws[name][2]
        assert media[0].shape == (len(pix[rows]), 2 * 4) and media[1].shape[1] == 96 * 4
        for k in range(4):
            gk = jrng.bounce_key(keys[rows], salt + 100 + k, jrng.CAMERA)
            k_v = jrng.bounce_key(gk, 0, jrng.VOLUME)
            ref = [np.asarray(jrng.uniform_per(jrng.bounce_key(gk, b, jrng.VOLUME), 1))
                   for b in range(2)]
            ref += [np.asarray(jrng.uniform_per(jrng.bounce_key(k_v, s, jrng.LIGHT_SAMPLE), 3))
                    for s in range(32)]
            out = tirr.nested_media(media, k, 2).numpy()
            np.testing.assert_array_equal(out.view(np.int32),
                                          np.concatenate(ref, -1).view(np.int32))
    emission = tirr.cache_draws(rng.root_key(5), torch.as_tensor(pix), sample,
                                dataclasses.replace(cfg, volume_kind="emission"), volumes=True)
    assert emission["miss"][2][1] is None
    np.testing.assert_array_equal(tirr.nested_media(emission["miss"][2], 3, 2).numpy(),
                                  tirr.nested_media(draws["miss"][2], 3, 2).numpy()[:, :2])
    assert tirr.cache_draws(rng.root_key(5), torch.as_tensor(pix), sample, cfg)["fill"][2] is None


@pytest.fixture(scope="module", params=["emission", "single"])
def fog(request):
    """The fog under the cache, both packages: the JAX side's radiance and
    its ``render(seed)`` with its pieces and the volumes' compiled once
    each (``test_torch_volumes.jax_pieces_compiled``); the port's scene from
    the JAX package's arrays."""
    text = fog_cache_text(request.param)
    with jax_integrator_pieces(), jax_pieces_compiled():
        jb = jbuild(jload(text))
        arrays = jax_scene_arrays(jb)
        u = np.random.default_rng(9).random((N * N, 5), dtype=np.float32)
        ys, xs = np.divmod(np.arange(N * N), N)
        jr = jb.camera.generate_rays(jnp.asarray((xs + u[:, 0]).astype(np.float32)),
                                     jnp.asarray((ys + u[:, 1]).astype(np.float32)),
                                     *(jnp.asarray(u[:, k]) for k in (2, 3, 4)))
        pix = np.arange(N * N, dtype=np.int64)
        keys = jrng.pixel_sample_key(jrng.root_key(4), jnp.asarray(pix.astype(np.uint32)),
                                     jnp.uint32(SAMPLE))
        Lj, tj = jirr.irradiance_cache_li(jb.scene, jr, keys, jb.integrator)
        js = j_render(jb, spp=1, seed=3, verbose=False)
    scene, _, _ = scene_from_numpy(arrays, "cpu")
    yield dict(text=text, kind=request.param, scene=scene, icfg=integrator_from_numpy(arrays),
               jr=jr, pix=pix, Lj=np.asarray(Lj), tj=np.asarray(tj),
               jpixels=np.asarray(js.pixels))


def test_fog_irradiance_cache_li_matches_jax(fog):
    """All three passes in the fog (emission and single scattering): the top
    trace with the wave's media block, each nested trace with its own; the
    radiance of every lane, rtol 1e-4, atol 1e-6 on ≥ 99% of lanes, and the
    first-hit t rtol 1e-5."""
    s = fog
    icfg = s["icfg"]
    assert icfg.kind == "irradiancecache" and icfg.volume_kind == s["kind"]
    root, pix = rng.root_key(4), torch.as_tensor(s["pix"])
    u = rng.primary_uniforms_plain(root, pix, torch.zeros((N * N, 6), dtype=torch.int64),
                                   SAMPLE, icfg.max_depth)
    media = rng.volume_uniforms_plain(root, pix, SAMPLE, icfg.max_depth, s["kind"] == "single")
    draws = tirr.cache_draws(root, pix, SAMPLE, icfg, volumes=True)
    rays = geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (s["jr"].origin,
                                                                   s["jr"].direction)))
    L, t = tpath.trace_radiance(s["scene"], rays, icfg, u, media=media, draws=draws)
    L = L.numpy()
    assert np.isfinite(L).all() and L.sum() > 0
    assert np.isclose(L, s["Lj"], **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(t.numpy(), s["tj"], rtol=1e-5)
    # the volumes act: the same lanes without the nested media differ
    with pytest.raises(ValueError, match="media"):
        tpath.trace_radiance(s["scene"], rays, icfg, u, draws=draws)
    with pytest.raises(ValueError, match="volumes=True"):
        tpath.trace_radiance(s["scene"], rays, icfg, u, media=media,
                             draws=tirr.cache_draws(root, pix, SAMPLE, icfg))


def test_fog_render_seed_matches_jax(fog):
    """``render`` of the 16×16 fog under the cache (depth 2, 1 spp, seed
    3), the port from its own build: pixels rtol 1e-4, atol 1e-6 on ≥ 99%,
    per-bin sums rtol 1e-4."""
    tb = tbuild(tload(fog["text"]), device="cpu")
    ts = render(tb, spp=1, seed=3)
    pj, pt = fog["jpixels"], ts.pixels.numpy()
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-4)
