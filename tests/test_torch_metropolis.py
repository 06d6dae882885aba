"""The port's Metropolis renderer and bidirectional estimator
(``pbrt_torch/renderers/metropolis.py``, ``integrators/bdpt.py``) and the
mutation's random numbers (``core/rng.py``) against the JAX package's
(``pbrt_tpu/renderers/metropolis.py``, ``integrators/bdpt.py``,
``jax.random``).

The acceptance test ``u_acc < a`` flips on an ulp of I, so past one step
the chains of two implementations part lane by lane; MLT is held per
piece: the mutation's bits; ``trace_bidir`` per lane on one shared
primary-sample array; one step from one shared state; the renderer's
pipeline (bootstrap, seeding, steps, splats, scale) with the path
evaluation replaced on both sides by the same closed-form stand-in; and
the image only statistically, against a path render, as
``tests/test_metropolis.py`` holds the JAX package's.

Scene: ``tests/test_metropolis.py``'s (a sphere light over a matte
floor) with a mirror and a plastic sphere, depth 2, 8×8. The JAX side runs
eagerly with its per-step pieces compiled once each
(``torch_parity_util.jax_integrator_pieces`` plus the estimator's own
bindings, entered once for the module).

Tolerances: u_large, the sign, is_large and the accept uniforms bit for
bit; u_small within 2.4e-7 (the two libraries' exp differ by an ulp or
two; jnp.log(64.0) is float32 4.158883 in both); ``trace_bidir`` rtol
1e-4, atol 1e-6 on ≥ 98% of the 64 lanes and per-bin sums rtol 1e-4
(its subpaths and connections reach two bounces past hits that XLA
computes with fused products); the evaluation of the shared state and
the bootstrap's luminances rtol 1e-4, atol 1e-6 on ≥ 95% of lanes; one
step's splat rtol 1e-4, atol 1e-6 on ≥ 99% of
pixels, accept decisions equal but where |u_acc − a| < 1e-5; the stand-in
pipeline's film rtol 1e-4, atol 1e-6 on ≥ 99% of pixels; the statistical
image: mean within 15% of the path render's, correlation > 0.85.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.bdpt as jbdpt
import pbrt_tpu.renderers.metropolis as jm
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core import interaction as jinter
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.integrators import bdpt
from pbrt_torch.integrators.path import PrimarySource
from pbrt_torch.interop import integrator_from_numpy, key_from_numpy, scene_from_numpy
from pbrt_torch.renderers import metropolis as tm
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from pbrt_tpu.integrators.path import PrimarySource as JPS
from test_torch_volumes import jax_pieces_compiled
from torch_parity_util import jax_area_rows_like_port, jax_integrator_pieces, jax_scene_arrays

N = 8
DEPTH = 2
#: the stand-in pipeline's bootstrap chunk
CHUNK = 4096
TOL = dict(rtol=1e-4, atol=1e-6)
SCENE = """
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]
SurfaceIntegrator "path" "integer maxdepth" [{depth}]
Renderer "metropolis" "integer samplesperpixel" [{mpp}] {extra}
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  Translate 0 3 0
  AreaLightSource "area" "rgb L" [20 20 20]
  Shape "sphere" "float radius" [.5]
AttributeEnd
Material "matte" "color Kd" [.7 .7 .7]
Shape "trianglemesh" "point P" [-2 -1 2  2 -1 2  2 -1 -6  -2 -1 -6]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
  Material "mirror" "color Kr" [.8 .8 .8]
  Translate .9 -.45 .5
  Shape "sphere" "float radius" [.55]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.4 .4 .4] "float roughness" [.1]
  Translate -.9 -.5 .3
  Shape "sphere" "float radius" [.5]
AttributeEnd
WorldEnd
"""


def scene_text(res=N, spp=1, depth=DEPTH, mpp=16, extra=""):
    return SCENE.format(res=res, spp=spp, depth=depth, mpp=mpp, extra=extra)


def _jkey(k):
    return key_from_numpy(np.asarray(jax.random.key_data(k)))


# ---------------------------------------------------------------------------
# the mutation's random numbers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_split_and_flat_uniforms_match_jax(seed):
    k = jax.random.fold_in(jax.random.key(seed), 1000 + seed % 7)
    for n in (1, 4, 7):
        np.testing.assert_array_equal(rng.split(_jkey(k), n).numpy(),
                                      np.asarray(jax.random.key_data(jax.random.split(k, n))))
    for n, d in ((1, 1), (7, 60), (33, 61), (100, 2)):
        np.testing.assert_array_equal(rng.flat_uniforms(_jkey(k), n, d).numpy(),
                                      np.asarray(jax.random.uniform(k, (n, d))))


@pytest.mark.parametrize("shape,p_large", [((33, 60), 0.25), ((16, 1), 0.5), ((5, 30), 0.0)])
def test_mutate_plain_matches_jax(shape, p_large):
    """``mutate_plain`` against ``_mutate`` and the accept uniforms of
    ``fold_in(key, 99)``: the large steps, the signs, is_large and the
    accept uniforms bit for bit, the small steps within 2.4e-7 (mod 1)."""
    rs = np.random.default_rng(shape[0])
    u = rs.random(shape, dtype=np.float32)
    u[0, 0] = 0.0
    assert rng.neg_log_ratio(rng.MUTATE_S1, rng.MUTATE_S2) == -float(jnp.log(64.0))
    for it in (0, 3, 31):
        k = jax.random.fold_in(jax.random.key(2), 1000 + it)
        ju, jl = (np.asarray(a) for a in jm._mutate(jnp.asarray(u), k, p_large))
        keys = rng.mutate_keys(_jkey(k))
        tu, tl, ta = (a.numpy() for a in rng.mutate_plain(torch.as_tensor(u), keys, p_large))
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tu[tl], ju[jl])
        k1, k2, k3, k4 = jax.random.split(k, 4)
        jsign = np.where(np.asarray(jax.random.uniform(k3, shape)) < 0.5, -1.0, 1.0)
        tsign = np.sign(((tu - u + 0.5) % 1.0) - 0.5)
        np.testing.assert_array_equal(tsign[~tl], jsign[~tl])
        gap = np.abs(tu - ju)
        assert np.minimum(gap, 1 - gap)[~tl].max(initial=0) <= 2.4e-7
        np.testing.assert_array_equal(
            ta, np.asarray(jax.random.uniform(jax.random.fold_in(k, 99), (shape[0],))))
        assert ((0 <= tu) & (tu <= 1)).all()


def test_n_dims_bidir_matches_jax():
    for d in range(1, 7):
        assert bdpt.n_dims_bidir(d) == jbdpt.n_dims_bidir(d)
    assert bdpt.n_dims_bidir(5) == 60 == 40 + 5 + 15


# ---------------------------------------------------------------------------
# the estimator and one step, with the JAX package's pieces compiled once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    isect = jax.jit(jisect.intersect, static_argnames=("any_hit",))
    si = jax.jit(jinter.surface_interaction, static_argnames=("spread",))
    with jax_integrator_pieces(), jax_area_rows_like_port(), \
            mock.patch.object(jbdpt, "intersect", isect), \
            mock.patch.object(jbdpt, "surface_interaction", si), \
            mock.patch.object(jbdpt, "_shadow_unoccluded", jpath._shadow_unoccluded):
        text = scene_text()
        jb = jbuild(jload(text))
        arrays = jax_scene_arrays(jb)
        scene, camera, film = scene_from_numpy(arrays, "cpu")
        R = 64
        rs = np.random.default_rng(11)
        u = rs.random((R, bdpt.n_dims_bidir(DEPTH)), dtype=np.float32)
        yield dict(text=text, jb=jb, scene=scene, camera=camera, film=film, u=u, R=R,
                   icfg=integrator_from_numpy(arrays))


def _port_built(s):
    """The JAX build's arrays as the port's built scene."""
    tb = tbuild(tload(s["text"]), device="cpu")
    return dataclasses.replace(tb, scene=s["scene"], camera=s["camera"], integrator=s["icfg"])


def test_trace_bidir_matches_jax(setup):
    """Per lane on one shared primary-sample array: the camera and light
    subpaths, NEE, the connections and the escaped term."""
    s = setup
    jb, u, R = s["jb"], s["u"], s["R"]
    px, py = u[:, 0] * N, u[:, 1] * N
    jr = jb.camera.generate_rays(*(jnp.asarray(x) for x in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.arange(R), jnp.zeros(R, jnp.int32))
    Lj, tj = jbdpt.trace_bidir(jb.scene, jr, keys, jb.integrator, uniforms=jnp.asarray(u))
    rays = geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction)))
    L, t = bdpt.trace_bidir(s["scene"], rays, s["icfg"], torch.as_tensor(u))
    Lj, L = np.asarray(Lj), L.numpy()
    assert np.isfinite(L).all() and (L.sum(-1) > 0).mean() > 0.2
    assert np.isclose(L, Lj, **TOL).all(-1).mean() >= 0.98
    np.testing.assert_allclose(L.sum(0), Lj.sum(0), rtol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-5)


def _jax_step(jb, u, L, I, px, py, it, p_large, n_chains):
    """The JAX package's step body (metropolis.py:161-186) on a state, its
    own ``_mutate`` and ``_eval_paths``; → (u_new, a, u_acc, splat)."""
    cfg = jb.film_config
    chain_keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.arange(n_chains),
                                       jnp.zeros(n_chains, jnp.int32))
    key_it = jax.random.fold_in(jax.random.key(0), 1000 + it)
    u_new, _ = jm._mutate(u, key_it, p_large)
    L_new, I_new, px_new, py_new = jm._eval_paths(jb, u_new, chain_keys, True)
    a = jnp.clip(I_new / jnp.maximum(I, 1e-12), 0.0, 1.0)
    s = jnp.zeros((cfg.yres, cfg.xres, cfg.n_bins), jnp.float32)
    for px_, py_, L_, w_ in ((px_new, py_new, L_new, jnp.where(
            I_new > 0.0, a / jnp.maximum(I_new, 1e-12), 0.0)),
            (px, py, L, jnp.where(I > 0.0, (1.0 - a) / jnp.maximum(I, 1e-12), 0.0))):
        xi, yi = jnp.floor(px_).astype(jnp.int32), jnp.floor(py_).astype(jnp.int32)
        inside = (xi >= 0) & (xi < cfg.xres) & (yi >= 0) & (yi < cfg.yres)
        s = s.at[jnp.clip(yi, 0, cfg.yres - 1), jnp.clip(xi, 0, cfg.xres - 1)].add(
            jnp.where(inside, w_, 0.0)[:, None] * L_)
    u_acc = jax.random.uniform(jax.random.fold_in(key_it, 99), (u.shape[0],))
    return (np.asarray(u_new), np.asarray(a), np.asarray(u_acc), np.asarray(s),
            np.asarray(L_new))


def test_mlt_step_matches_jax(setup):
    """One bidirectional step of 64 chains from one shared state (the JAX
    package's evaluation of the shared vectors): the evaluation of the
    state, the mutated vectors, the accept decisions and the splat."""
    s = setup
    jb, R = s["jb"], s["R"]
    u = jnp.asarray(s["u"])
    chain_keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.arange(R), jnp.zeros(R, jnp.int32))
    L, I, px, py = jm._eval_paths(jb, u, chain_keys, True)
    built = _port_built(s)
    tL, tI, tpx, tpy = tm._eval_paths(built, torch.as_tensor(s["u"]), torch.arange(R), True, 0)
    assert np.isclose(tL.numpy(), np.asarray(L), **TOL).all(-1).mean() >= 0.95
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(px))
    ju, ja, jacc, jsplat, jL_new = _jax_step(jb, u, L, I, px, py, 5, 0.25, R)
    st = tm.ChainState(*(torch.as_tensor(np.array(a)) for a in (u, L, I, px, py)),
                       splat=torch.zeros((N, N, 32)), accepted=torch.zeros((), dtype=torch.int64))
    u0 = st.u.clone()
    with mock.patch.object(tm, "_eval_paths", wraps=tm._eval_paths) as ev:
        tm.mlt_step(built, st, 5, tm.MLTOptions(p_large=0.25), seed=0)
    u_new = ev.call_args.args[1].numpy()
    gap = np.abs(u_new - ju)
    assert np.minimum(gap, 1 - gap).max() <= 2.4e-7
    accepted = (st.u.numpy() != u0.numpy()).any(-1)
    near = np.abs(jacc - ja) < 1e-5
    np.testing.assert_array_equal(accepted[~near], (jacc < ja)[~near])
    assert 0 < accepted.sum() < R
    pt = st.splat.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, jsplat, **TOL).all(-1).mean() >= 0.99


# ---------------------------------------------------------------------------
# the renderer's pipeline with a closed-form stand-in for the evaluation
# ---------------------------------------------------------------------------


def _stand_in_jax(built, u, keys, bidirectional=False):
    cfg = built.film_config
    v = u[:, 2] * u[:, 3]
    return v[:, None] * jnp.ones((1, cfg.n_bins)), v, u[:, 0] * cfg.xres, u[:, 1] * cfg.yres


def _stand_in_port(seen):
    def f(built, u, index, bidirectional, seed):
        seen.append((index.clone(), bidirectional))
        cfg = built.film_config
        v = u[:, 2] * u[:, 3]
        return v[:, None] * torch.ones((1, cfg.n_bins)), v, u[:, 0] * cfg.xres, u[:, 1] * cfg.yres
    return f


@pytest.mark.parametrize("extra,quick", [("", False), ('"bool bidirectional" ["false"]', True),
                                         ('"integer bootstrapsamples" [40]', False)])
def test_render_pipeline_matches_jax(extra, quick):
    """Both renderers end to end (16 chains, a 4×4 film) with the same
    stand-in for the path evaluation (I = u₂·u₃, L = I in every bin):
    bootstrap, seeding, the steps' mutations, accept decisions and splats,
    and the final scale give the same film. Facts: ``spp`` is ignored;
    ``quick`` divides the mutations per pixel by 16; the bootstrap takes
    min(max(bootstrapsamples, n_chains), 131,072) vectors keyed by chain
    i mod n_chains; ``dodirectseparately`` is never read; the film's
    weight is 1 and its pixels the splat × b / mutations per pixel."""
    text = scene_text(res=4, mpp=32, extra=extra + ' "bool dodirectseparately" ["true"]')
    jb = jbuild(jload(text))
    tb = tbuild(tload(text), device="cpu")
    n_chains = 16
    with mock.patch.object(jm, "_eval_paths", _stand_in_jax):
        js = jm.render_metropolis(jb, spp=99, seed=3, quick=quick, verbose=False,
                                  n_chains=n_chains)
    seen = []
    stats = {}
    with mock.patch.object(tm, "_eval_paths", _stand_in_port(seen)):
        ts = tm.render_metropolis(tb, spp=99, seed=3, quick=quick, n_chains=n_chains,
                                  chunk=CHUNK, stats=stats)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_array_equal(ts.weight.numpy(), np.asarray(js.weight))
    assert (ts.weight.numpy() == 1).all()
    mpp = 32 // 16 if quick else 32
    n_iters = 16 * mpp // n_chains
    nb = min(max(100000 if "bootstrap" not in extra else 40, n_chains), 1 << 17)
    assert stats["iterations"] == n_iters and len(seen) == -(-nb // CHUNK) + 1 + n_iters
    boot = torch.cat([i for i, _ in seen[:-(n_iters + 1)]])
    np.testing.assert_array_equal(boot.numpy(), np.arange(nb) % n_chains)
    assert all(b == ("false" not in extra) for _, b in seen)


def test_seeding_takes_the_jax_selection(setup):
    """The chains start where the JAX package's would from the same
    bootstrap luminances (its own, fed in): ``default_rng(seed).choice``
    ∝ I; and the port's bootstrap luminances equal the JAX package's on
    most vectors."""
    s = setup
    jb = s["jb"]
    nb = 64
    u = jax.random.uniform(jax.random.fold_in(jax.random.key(0), 1), (nb, s["u"].shape[1]))
    keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.arange(nb) % 16,
                                 jnp.zeros(nb, jnp.int32))
    _, Ib, _, _ = jm._eval_paths(jb, u, keys, True)
    Ib = np.asarray(Ib)
    probs = np.maximum(Ib, 0.0)
    probs = probs / probs.sum()
    want = np.random.default_rng(0).choice(nb, 16, p=probs)
    np.testing.assert_array_equal(tm.seed_chains(Ib, 0, 16), want)
    built = _port_built(s)
    u_t = rng.flat_uniforms(rng.fold_in(rng.root_key(0), 1), nb, s["u"].shape[1])
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u))
    _, It, _, _ = tm._eval_paths(built, u_t, torch.arange(nb) % 16, True, 0)
    assert np.isclose(It.numpy(), Ib, **TOL).mean() >= 0.95


@pytest.mark.parametrize("bidir", ["false", "true"])
def test_metropolis_image_matches_path_tracing(bidir):
    """The port's MLT image against its own path render of the same scene
    (16×16, depth 3, 4,096 chains, 64 mutations per pixel, 4,096 bootstrap
    vectors), as ``tests/test_metropolis.py`` holds the JAX package's: the
    mean within 15%, correlation > 0.85."""
    text = scene_text(res=16, spp=32, depth=3, mpp=64,
                      extra=f'"bool bidirectional" ["{bidir}"] "integer bootstrapsamples" [4096]')
    tb = tbuild(tload(text), device="cpu")
    mlt = tm.render_metropolis(tb, seed=0, n_chains=4096).pixels.numpy().mean(-1)
    pt = render(tb, seed=0)
    img = (pt.pixels / torch.clamp(pt.weight[..., None], min=1e-9)).numpy().mean(-1)
    assert 0.85 < mlt.mean() / img.mean() < 1.15
    assert np.corrcoef(mlt.ravel(), img.ravel())[0, 1] > 0.85


# ---------------------------------------------------------------------------
# volumes, and ambient occlusion and metadata under the unidirectional
# estimator
# ---------------------------------------------------------------------------

#: a fog box around the scene's camera and objects
FOG_BOX = ('Volume "homogeneous" "point p0" [-6 -6 -8] "point p1" [6 6 6] '
           '"spectrum sigma_a" [395 .05 715 .08] "spectrum sigma_s" [395 .1 715 .05] '
           '"spectrum Le" [395 .02 715 .01] "float g" [.3]')
#: an absorbing box of the same extent (no scattering, no emission)
ABSORBER = ('Volume "homogeneous" "point p0" [-6 -6 -8] "point p1" [6 6 6] '
            '"spectrum sigma_a" [395 2 715 2] "spectrum sigma_s" [395 0 715 0]')


def fog_text(box=FOG_BOX, volume="single"):
    return scene_text().replace("WorldBegin", f'VolumeIntegrator "{volume}"\nWorldBegin\n{box}', 1)


def _zero_nee(scene, si, *a, **k):
    """A stand-in for the estimators' NEE, in either package: no light."""
    zeros = jnp.zeros if isinstance(si.p, jnp.ndarray) else torch.zeros
    return zeros((si.p.shape[0], scene.materials.kd.shape[-1]))


@pytest.fixture(scope="module")
def fog(setup):
    """The scene in a fog under single scattering, both packages, the JAX
    side's pieces (``setup``'s bindings, still in place) and the volumes'
    compiled once each: ``trace_bidir`` and
    ``_eval_paths`` (bidirectional; unidirectional under ``path``,
    ``ambientocclusion`` and ``metadata``) of one shared primary-sample
    array keyed by 64 chains, and one step from the state it gives; then the
    connection fact's four estimates (an absorbing box or none, NEE kept
    or zeroed)."""
    out = {}
    with jax_pieces_compiled():
        jb = jbuild(jload(fog_text()))
        arrays = jax_scene_arrays(jb)
        scene, camera, film = scene_from_numpy(arrays, "cpu")
        R = 64
        u = np.random.default_rng(12).random((R, bdpt.n_dims_bidir(DEPTH)), dtype=np.float32)
        keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.arange(R), jnp.zeros(R, jnp.int32))
        ju = jnp.asarray(u)
        jr = jb.camera.generate_rays(*(jnp.asarray(x) for x in (u[:, 0] * N, u[:, 1] * N,
                                                               u[:, 2], u[:, 3], u[:, 4])))
        out["bidir"] = [np.asarray(a) for a in jbdpt.trace_bidir(jb.scene, jr, keys,
                                                                 jb.integrator, uniforms=ju)]
        L, I, px, py = jm._eval_paths(jb, ju, keys, True)
        out["eval"] = (L, I, px, py)
        out["step"] = _jax_step(jb, ju, L, I, px, py, 5, 0.25, R)
        up = ju[:, :JPS.n_dims(DEPTH)]
        for kind in ("path", "ambientocclusion", "metadata"):
            jbk = dataclasses.replace(jb, integrator=dataclasses.replace(jb.integrator,
                                                                         kind=kind))
            out[kind] = np.asarray(jm._eval_paths(jbk, up, keys, False)[0])
        u_fact = _connecting_lanes(R)
        jr_fact = jb.camera.generate_rays(*(jnp.asarray(x) for x in (
            u_fact[:, 0] * N, u_fact[:, 1] * N, u_fact[:, 2], u_fact[:, 3], u_fact[:, 4])))
        fact = {}
        for box in ("absorber", "clear"):
            jbb = jbuild(jload(fog_text(ABSORBER if box == "absorber" else "")))
            for nee in ("nee", "no_nee"):
                with (mock.patch.object(jbdpt, "_nee_one_light", _zero_nee) if nee == "no_nee"
                      else mock.patch.object(jbdpt, "_nee_one_light", jbdpt._nee_one_light)):
                    fact[box, nee] = np.asarray(jbdpt.trace_bidir(
                        jbb.scene, jr_fact, keys, jbb.integrator,
                        uniforms=jnp.asarray(u_fact))[0])
        out["fact"] = fact
    yield dict(out, jb=jb, scene=scene, camera=camera, film=film, u=u, R=R, jr=jr,
               u_fact=u_fact, jr_fact=jr_fact, icfg=integrator_from_numpy(arrays),
               text=fog_text())


def _connecting_lanes(R):
    """R primary-sample vectors, first those of 4,096 drawn whose
    estimate without NEE is not black in the port (a connection, or
    emission after a specular bounce, reached a light): in this open scene
    one vector in ~230 connects."""
    cand = np.random.default_rng(13).random((4096, bdpt.n_dims_bidir(DEPTH)), dtype=np.float32)
    tb = tbuild(tload(fog_text("")), device="cpu")
    u = torch.as_tensor(cand)
    rays = tb.camera.generate_rays(u[:, 0] * N, u[:, 1] * N, u[:, 2], u[:, 3], u[:, 4])
    with mock.patch.object(bdpt, "_nee_one_light", _zero_nee):
        hot = (bdpt.trace_bidir(tb.scene, rays, tb.integrator, u)[0].sum(-1) > 0).numpy()
    order = np.concatenate([np.nonzero(hot)[0], np.nonzero(~hot)[0]])
    return cand[order[:R]]


def _fog_built(s, kind=None):
    tb = tbuild(tload(s["text"]), device="cpu")
    icfg = s["icfg"] if kind is None else dataclasses.replace(s["icfg"], kind=kind)
    return dataclasses.replace(tb, scene=s["scene"], camera=s["camera"], integrator=icfg)


def _rays(jr):
    return geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction)))


def test_fog_trace_bidir_matches_jax(fog):
    """``trace_bidir`` per lane in the fog: the NEE at camera vertex i
    attenuated with the jitter ``media[:, i]`` of the chain's key; rtol
    1e-4, atol 1e-6 on ≥ 98% of the 64 lanes, per-bin sums rtol 1e-4."""
    s = fog
    media = rng.volume_uniforms_plain(rng.root_key(7), torch.arange(s["R"]), 0, DEPTH, True)
    L, t = bdpt.trace_bidir(s["scene"], _rays(s["jr"]), s["icfg"], torch.as_tensor(s["u"]),
                            media=media)
    Lj, tj = s["bidir"]
    L = L.numpy()
    assert np.isfinite(L).all() and (L.sum(-1) > 0).mean() > 0.2
    assert np.isclose(L, Lj, **TOL).all(-1).mean() >= 0.98
    np.testing.assert_allclose(L.sum(0), Lj.sum(0), rtol=1e-4)
    np.testing.assert_allclose(t.numpy(), tj, rtol=1e-5)
    with pytest.raises(ValueError, match="media block"):
        bdpt.trace_bidir(s["scene"], _rays(s["jr"]), s["icfg"], torch.as_tensor(s["u"]))


@pytest.mark.parametrize("kind", ["bidirectional", "path", "ambientocclusion", "metadata"])
def test_fog_eval_paths_matches_jax(fog, kind):
    """``_eval_paths`` per lane in the fog, its draws from the chains' keys:
    bidirectional; unidirectional under ``path`` (NEE and the camera
    segment's single scattering keyed by the chain), ``ambientocclusion``
    (its directions from the chain's key, the camera columns from u) and
    ``metadata`` (the camera columns only). rtol 1e-4, atol 1e-6 on ≥ 95%
    of lanes (the bidirectional estimator's two bounces past fused
    products), every lane of AO and metadata equal within that rule."""
    s = fog
    R = s["R"]
    bidir = kind == "bidirectional"
    built = _fog_built(s, None if bidir else kind)
    u = torch.as_tensor(s["u"] if bidir else s["u"][:, :PrimarySource.n_dims(DEPTH)])
    L = tm._eval_paths(built, u, torch.arange(R), bidir, 0)[0].numpy()
    ref = np.asarray(s["eval"][0]) if bidir else s[kind]
    assert np.isfinite(L).all() and L.sum() > 0
    share = np.isclose(L, ref, **TOL).all(-1).mean()
    assert share >= (0.95 if kind in ("bidirectional", "path") else 1.0), share
    if kind == "ambientocclusion":
        assert 0 < (L[:, 0] < 1).sum() < R and set(np.unique(L * 4)) <= set(range(5))


def test_fog_mlt_step_matches_jax(fog):
    """One bidirectional step of 64 chains in the fog from one shared state
    (the JAX package's evaluation): the accept decisions equal but where
    |u_acc − a| < 1e-5, the splat rtol 1e-4, atol 1e-6 on ≥ 99% of pixels."""
    s = fog
    R = s["R"]
    L, I, px, py = s["eval"]
    ju, ja, jacc, jsplat, _ = s["step"]
    st = tm.ChainState(*(torch.as_tensor(np.array(a)) for a in (s["u"], L, I, px, py)),
                       splat=torch.zeros((N, N, 32)), accepted=torch.zeros((), dtype=torch.int64))
    u0 = st.u.clone()
    tm.mlt_step(_fog_built(s), st, 5, tm.MLTOptions(p_large=0.25), seed=0)
    accepted = (st.u.numpy() != u0.numpy()).any(-1)
    near = np.abs(jacc - ja) < 1e-5
    np.testing.assert_array_equal(accepted[~near], (jacc < ja)[~near])
    assert 0 < accepted.sum() < R
    pt = st.splat.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, jsplat, **TOL).all(-1).mean() >= 0.99


def test_fact_mlt_media_jitter_is_the_chains(fog):
    """Fact: the media block comes from each chain's fixed key, not from the
    mutated vector, so a chain keeps one jitter over its iterations: two
    different vectors of one chain draw the same block, and the JAX
    package's NEE jitter is that chain key's (metropolis.py:112-114)."""
    s = fog
    seen = []
    real = tm.media_uniforms

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]

    built = _fog_built(s)
    idx = torch.tensor([3, 3, 9])
    u = torch.as_tensor(np.random.default_rng(1).random((3, s["u"].shape[1]), dtype=np.float32))
    with mock.patch.object(tm, "media_uniforms", spy):
        tm._eval_paths(built, u, idx, True, 0)
    m = seen[0].numpy()
    np.testing.assert_array_equal(m[0], m[1])
    assert not np.array_equal(m[0], m[2])
    keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.asarray([3]), jnp.zeros(1, jnp.int32))
    np.testing.assert_array_equal(
        m[0, 1], np.asarray(jrng.uniform_per(jrng.bounce_key(keys, 1, jrng.VOLUME), 1))[0, 0])


def test_fact_bidir_connections_take_no_transmittance(fog):
    """Fact (copied): the bidirectional estimator attenuates only its NEE.
    With NEE zeroed in both packages, an absorbing box around the whole
    scene (σa 2 on every camera vertex's and light vertex's segment)
    changes no term: the connections, emission and escapes are bit for bit
    those without it; with NEE kept it darkens the image. Lanes: 64
    vectors led by those that connect (``_connecting_lanes``). The port
    within rtol 1e-4, atol 1e-6 of the JAX package on ≥ 98% of lanes."""
    s = fog
    media = rng.volume_uniforms_plain(rng.root_key(7), torch.arange(s["R"]), 0, DEPTH, True)
    out = {}
    for box in ("absorber", "clear"):
        tb = tbuild(tload(fog_text(ABSORBER if box == "absorber" else "")), device="cpu")
        assert tb.scene.has_volumes == (box == "absorber")
        for nee in ("nee", "no_nee"):
            with (mock.patch.object(bdpt, "_nee_one_light", _zero_nee) if nee == "no_nee"
                  else mock.patch.object(bdpt, "_nee_one_light", bdpt._nee_one_light)):
                out[box, nee] = bdpt.trace_bidir(tb.scene, _rays(s["jr_fact"]), tb.integrator,
                                                 torch.as_tensor(s["u_fact"]),
                                                 media=media)[0].numpy()
    for k, v in out.items():
        assert np.isclose(v, s["fact"][k], **TOL).all(-1).mean() >= 0.98, k
    for f in (out, s["fact"]):
        np.testing.assert_array_equal(f["absorber", "no_nee"], f["clear", "no_nee"])
        assert f["absorber", "no_nee"].sum() > 0
        assert f["absorber", "nee"].sum() < 0.9 * f["clear", "nee"].sum()
