"""Parity of the port's differentiable rendering (``pbrt_torch/integrators/
grad.py``) with the JAX package's ``jax.grad`` through ``trace_radiance``.

Both packages trace the same rays with the same primary-sample array (made
from a numpy seed) on the same scene arrays (the JAX build through
``pbrt_torch.interop``). Scenes: ``tests/test_grad.py``'s ``SCENE`` (a
point light over a matte plane; kd, ks, kr, kt, emit at depth 2) and
``TEX_SCENE`` (the plane's Kd a constant texture; pool_rgb, c1 at depth
1), and the tiny built-in scene (plastic and mirror spheres, an area-light
sphere; kd … kt and emit at depth 2). The JAX side is computed once per
scene, ``jax.value_and_grad`` over all its leaves, with its per-step
pieces jitted once (``torch_parity_util.jax_integrator_pieces``).

Then one scene per kind whose draws come from keys (the JAX functions
trace on ``keys``, grad.py:37-42): the fog (``fog_scene_text`` under
``path`` depth 2 and single scattering: the media block), igi in the same
fog (the VPL picks beside the media block; on the tiny scene with its
subsurface boxes the JAX side's compile took 81 s against 33 s here),
the irradiance cache in the fog (the gathers' directions, nested blocks
and media) and
``diffuseprt`` (``prt_scene_text``: the per-hit directions), each
against one ``jax.value_and_grad`` of kd and emit; the port takes the
keyed arrays of the same (pixel, sample) keys (``media_uniforms``,
``integrator_draws``, and for the cache and PRT, which read no primary
sample, ``key_uniforms``).

Tolerances: the loss rtol 1e-5; every gradient rtol 1e-4 with atol 1e-4 ×
its largest magnitude (the two packages' float orders differ by ulps: XLA
contracts multiply-adds). The port's central differences (eps 1e-3, divided by the
step the float32 parameter took, the loss summed in float64): rtol 5e-2,
atol 1e-7, the JAX test's rule. The
chunked two-pass gradient against one pass: the loss and pass 2's
radiance bit for bit, the gradients rtol 1e-5 (the gathers' backward sums
rows in another grouping). The keyed scenes: the loss rtol 1e-4 and
gradients rtol 1e-3 with atol 1e-3 × the largest magnitude (their
radiance sums nested traces, volume marches or 8 directions per hit,
each lane held to rtol 1e-4 by its module's test).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core import interaction as jinter
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.integrators import grad as jgrad
from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as jtrace
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import intersect as isect
from pbrt_torch.accel import traverse_cuda as tc
from pbrt_torch.accel import traverse_kd as tk
from pbrt_torch.core import rng
from pbrt_torch.core.geometry import Ray
from pbrt_torch.integrators import grad as tgrad
from pbrt_torch.integrators import path as tpath
from pbrt_torch.integrators.path import IntegratorConfig
from pbrt_torch.interop import integrator_from_numpy, scene_from_numpy
from pbrt_torch.renderers import sampler as tsampler
from pbrt_torch.scene.api import load_scene_string
from pbrt_torch.scene.builder import build
from test_torch_volumes import jax_pieces_compiled
from torch_parity_util import (fog_scene_text, jax_area_rows_like_port, jax_integrator_pieces,
                               jax_scene_arrays, lights_scene_text, prt_scene_text,
                               tiny_scene_text)

_SRC = open(__file__.replace("test_torch_grad.py", "test_grad.py")).read()
SCENE = _SRC.split('SCENE = """')[1].split('"""')[0]
TEX_SCENE = _SRC.split('TEX_SCENE = """')[1].split('"""')[0]
N = 8
SPECTRA = ("kd", "ks", "kr", "kt")
#: scene → (text, depth, leaves)
SCENES = {"plane": (SCENE, 2, SPECTRA + ("emit",)),
          "texture": (TEX_SCENE, 1, ("pool_rgb", "c1")),
          "tiny": (tiny_scene_text(N, N, 1, 2), 2, SPECTRA + ("emit",))}


def _field(scene, name):
    for part in (scene.materials, scene.lights, scene.textures):
        if hasattr(part, name):
            return getattr(part, name)
    raise KeyError(name)


def _jax_with(s0, params):
    mats = {k: v for k, v in params.items() if k in SPECTRA}
    if mats:
        s0 = dataclasses.replace(s0, materials=jgrad.replace_material_spectra(s0.materials,
                                                                               **mats))
    if "emit" in params:
        s0 = dataclasses.replace(s0, lights=dataclasses.replace(s0.lights, emit=params["emit"]))
    tex = {k: v for k, v in params.items() if k in ("pool_rgb", "c1")}
    if tex:
        s0 = dataclasses.replace(s0, textures=dataclasses.replace(s0.textures, **tex))
    return s0


def _setup(name):
    text, depth, leaves = SCENES[name]
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    u = np.random.default_rng(0).random((N * N, JPS.n_dims(depth)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px, py = (xs + u[:, 0]).astype(np.float32), (ys + u[:, 1]).astype(np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    tr = Ray.make(torch.as_tensor(np.asarray(jr.origin)), torch.as_tensor(np.asarray(jr.direction)))
    jcfg = dataclasses.replace(jb.integrator, max_depth=depth)

    def jloss(*vals):
        s = _jax_with(jb.scene, dict(zip(leaves, vals)))
        return jtrace(s, jr, None, jcfg, uniforms=jnp.asarray(u))[0].mean()

    with jax_integrator_pieces():
        val, g = jax.value_and_grad(jloss, argnums=tuple(range(len(leaves))))(
            *[_field(jb.scene, k) for k in leaves])
    return dict(scene=scene, rays=tr, u=torch.as_tensor(u), cfg=IntegratorConfig(max_depth=depth),
                leaves=leaves, jax_loss=float(val),
                jax_grads={k: np.asarray(x) for k, x in zip(leaves, g)})


@pytest.fixture(scope="module")
def plane():
    return _setup("plane")


@pytest.fixture(scope="module")
def texture():
    return _setup("texture")


@pytest.fixture(scope="module")
def tiny():
    return _setup("tiny")


def _port(s, loss_fn=None, chunk=None):
    params = {k: _field(s["scene"], k) for k in s["leaves"]}
    return tgrad._value_and_grad(s["scene"], s["rays"], s["u"], s["cfg"], params, loss_fn, chunk)


@pytest.mark.parametrize("name", list(SCENES))
def test_gradients_match_jax(name, request):
    """Loss and every leaf's gradient against ``jax.value_and_grad``."""
    s = request.getfixturevalue(name)
    loss, g = _port(s)
    np.testing.assert_allclose(float(loss), s["jax_loss"], rtol=1e-5)
    assert float(loss) > 0
    for k in s["leaves"]:
        a, b = g[k].numpy(), s["jax_grads"][k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=k)
    flowing = ("c1",) if name == "texture" else ("kd", "emit")
    assert all(np.abs(g[k].numpy()).max() > 0 for k in flowing)


def test_api_functions_match_jax(plane, texture):
    """The public functions return the JAX module's keys and the same
    values as the leaf-by-leaf computation above."""
    s = plane
    args = (s["scene"], s["rays"], s["u"], s["cfg"])
    gm = tgrad.grad_wrt_materials(*args)
    assert set(gm) == set(SPECTRA)
    ge = tgrad.grad_wrt_emission(*args)
    val, gv = tgrad.value_and_grads(*args)
    assert set(gv) == {"kd", "emit"}
    np.testing.assert_allclose(float(val), s["jax_loss"], rtol=1e-5)
    for k, x in (("kd", gm["kd"]), ("kd", gv["kd"]), ("emit", ge), ("emit", gv["emit"])):
        b = s["jax_grads"][k]
        np.testing.assert_allclose(x.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    assert float(tgrad.radiance_loss(*args)) == float(val)
    t = texture
    gt = tgrad.grad_wrt_textures(t["scene"], t["rays"], t["u"], t["cfg"])
    assert set(gt) == {"pool_rgb", "c1"}
    np.testing.assert_allclose(gt["c1"].numpy(), t["jax_grads"]["c1"], rtol=1e-4,
                               atol=1e-4 * np.abs(t["jax_grads"]["c1"]).max())


def _loss64(s, **params):
    scene = tgrad._with_params(s["scene"], params)
    L, _ = tpath.trace_radiance(scene, s["rays"], s["cfg"], s["u"])
    return float(L.double().mean())


@pytest.mark.parametrize("leaf,bins", [("kd", (0, 15, 31)), ("emit", (16,))])
def test_gradient_matches_finite_difference(plane, leaf, bins):
    """∂loss/∂kd on bins 0, 15, 31 of the plane's material, ∂loss/∂emit on
    bin 16, against central differences (tests/test_grad.py's rule)."""
    s = plane
    _, g = _port(s)
    x0 = _field(s["scene"], leaf)
    row = int(x0.sum(1).argmax())
    eps = 1e-3
    for b in bins:
        xp, xm = x0.clone(), x0.clone()
        xp[row, b] += eps
        xm[row, b] -= eps
        # the step the float32 parameter took
        fd = (_loss64(s, **{leaf: xp}) - _loss64(s, **{leaf: xm})) / (float(xp[row, b])
                                                                     - float(xm[row, b]))
        assert fd != 0.0
        np.testing.assert_allclose(float(g[leaf][row, b]), fd, rtol=5e-2, atol=1e-7)
    if leaf == "emit":
        assert float(g["emit"][row, bins[0]]) > 0


def test_texture_gradient_matches_finite_difference(texture):
    """∂loss/∂c1 at its largest bin against a central difference."""
    s = texture
    _, g = _port(s)
    gc1 = g["c1"].numpy()
    ti, b = np.unravel_index(np.abs(gc1).argmax(), gc1.shape)
    c1 = s["scene"].textures.c1
    eps = 1e-3
    cp, cm = c1.clone(), c1.clone()
    cp[ti, b] += eps
    cm[ti, b] -= eps
    fd = (_loss64(s, c1=cp) - _loss64(s, c1=cm)) / (float(cp[ti, b]) - float(cm[ti, b]))
    assert abs(fd - gc1[ti, b]) / max(abs(fd), 1e-9) < 0.05, (fd, gc1[ti, b])


@pytest.fixture(scope="module")
def deep():
    """The tiny scene at 16², path depth 5 (roulette at the last bounce),
    the port alone."""
    b = build(load_scene_string(tiny_scene_text(16, 16, 1, 5)), device="cpu")
    u = torch.as_tensor(np.random.default_rng(3).random((256, tpath.PrimarySource.n_dims(5)),
                                                        dtype=np.float32))
    ys, xs = np.divmod(np.arange(256), 16)
    rays = b.camera.generate_rays(torch.as_tensor(xs, dtype=torch.float32) + u[:, 0],
                                  torch.as_tensor(ys, dtype=torch.float32) + u[:, 1],
                                  u[:, 2], u[:, 3], u[:, 4])
    return dict(scene=b.scene, rays=rays, u=u, cfg=b.integrator, leaves=("kd", "emit"))


@pytest.mark.parametrize("loss_fn", [None, lambda L: torch.log1p(L.sum(-1)).pow(2).sum()],
                         ids=["mean", "nonlinear"])
def test_chunked_two_passes_equal_one_pass(deep, loss_fn, monkeypatch):
    """Chunks of 37 lanes (ragged): the loss equal bit for bit, pass 2's
    radiance equal to pass 1's bit for bit chunk by chunk, the gradients
    within rtol 1e-5 of one pass."""
    traced = []
    real = tgrad.trace_radiance

    def record(scene, rays, cfg, u, **kw):
        out = real(scene, rays, cfg, u, **kw)
        traced.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(tgrad, "trace_radiance", record)
    loss1, g1 = _port(deep, loss_fn)
    traced.clear()
    loss2, g2 = _port(deep, loss_fn, chunk=37)
    n = len(traced) // 2
    assert n == 7 and all(torch.equal(a, b) for a, b in zip(traced[:n], traced[n:]))
    assert float(loss1) == float(loss2) > 0
    for k in ("kd", "emit"):
        assert torch.isfinite(g2[k]).all() and g2[k].abs().max() > 0
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g1[k].abs().max()))


def _route_scenes():
    small, _ = chip_smoke.real_scene_text(3, 8)
    return {"bvh": small,
            "kdtree": chip_smoke.accel_scene_text(small, "kdtree"),
            "grid": chip_smoke.accel_scene_text(small, "grid"),
            "motion": chip_smoke.anim_scene_text(3, 8),
            "instances": chip_smoke.instanced_scene_text(3, 8, grid=(2, 2))}


@pytest.mark.parametrize("route", ["bvh", "kdtree", "grid", "motion", "instances"])
def test_hits_carry_no_gradient(route):
    """A ray whose fields require grad gives hits with no ``grad_fn`` on
    every route (quadrics, the wide walk, kd-tree, grid, motion,
    instances), closest and any hit, and the same hits as the detached
    ray."""
    b = build(load_scene_string(_route_scenes()[route]), device="cpu")
    xy = torch.stack(torch.meshgrid(torch.arange(8.), torch.arange(8.), indexing="ij"), -1)
    rays = b.camera.generate_rays(xy[..., 0].reshape(-1) + .5, xy[..., 1].reshape(-1) + .5,
                                  *(torch.full((64,), .5) for _ in range(3)))
    live = Ray(rays.origin.clone().requires_grad_(), rays.direction.clone().requires_grad_(),
               rays.tmin.clone().requires_grad_(), rays.tmax.clone(),
               rays.time.clone().requires_grad_())
    for any_hit in (False, True):
        h = isect.intersect(b.scene.geometry, live, any_hit=any_hit)
        ref = isect.intersect(b.scene.geometry, rays, any_hit=any_hit)
        for f in ("t", "prim", "b1", "b2", "inst"):
            x = getattr(h, f)
            if x is not None:
                assert not x.requires_grad and x.grad_fn is None, f
                assert torch.equal(x, getattr(ref, f)), f
        if not any_hit:
            assert (h.prim >= 0).any()


def test_wrappers_refuse_grad():
    """The walks' dispatch (kernel and plain version alike) refuses an input
    that requires grad, naming the kernel."""
    b = build(load_scene_string(_route_scenes()["bvh"]), device="cpu")
    g = b.scene.geometry
    R = 4
    o = torch.zeros(R, 3, requires_grad=True)
    d = torch.tensor([[0.0, 1.0, 0.0]]).repeat(R, 1)
    inv = isect.make_inv_dir(d)
    tmin, tmax = torch.zeros(R), torch.full((R,), float("inf"))
    seed = (tmax.clone(), torch.full((R,), -1, dtype=torch.int32), torch.zeros(R), torch.zeros(R))
    with pytest.raises(ValueError, match="traverse:"):
        tc.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax, *seed, False)
    inst = build(load_scene_string(_route_scenes()["instances"]), device="cpu").scene.geometry
    with pytest.raises(ValueError, match="traverse_instances:"):
        tc.traverse_instances(inst.inst_rows, inst.inst_stack, inst.inst_w2o, inst.inst_lo,
                              inst.inst_hi, inst.inst_root, o, d, inv, tmin, tmax, *seed, False)
    for acc, walk in (("kdtree", tk.traverse_kd), ("grid", tk.traverse_grid)):
        ga = build(load_scene_string(_route_scenes()[acc]), device="cpu").scene.geometry
        with pytest.raises(ValueError, match=walk.__name__ + ":"):
            walk(ga, o, d, inv, tmin, tmax, False)
    # detached, the same call goes through
    assert tc.traverse(g.wide_rows, g.wide_stack, o.detach(), d, inv, tmin, tmax, *seed,
                       False)[1].shape == (R,)


def test_emission_gradient_keeps_power_dist(monkeypatch):
    """``grad_wrt_emission`` traces with the built light-selection
    distribution (built from the original emit), as the JAX package's: on
    the lights-and-quadrics scene (five lights), each traced scene holds the
    very ``power_dist`` of the build."""
    b = build(load_scene_string(lights_scene_text(8, 8, 1, 1)), device="cpu")
    seen = []
    real = tgrad.trace_radiance

    def record(scene, *a, **kw):
        seen.append(scene.lights)
        return real(scene, *a, **kw)

    monkeypatch.setattr(tgrad, "trace_radiance", record)
    u = torch.as_tensor(np.random.default_rng(1).random((64, tpath.PrimarySource.n_dims(1)),
                                                        dtype=np.float32))
    xy = torch.arange(64)
    rays = b.camera.generate_rays((xy % 8).float() + u[:, 0], (xy // 8).float() + u[:, 1],
                                  u[:, 2], u[:, 3], u[:, 4])
    g = tgrad.grad_wrt_emission(b.scene, rays, u, b.integrator, chunk=40)
    assert g.shape == b.scene.lights.emit.shape and torch.isfinite(g).all()
    assert len(seen) == 4 and b.scene.lights.count == 5
    assert all(lt.power_dist is b.scene.lights.power_dist for lt in seen)
    # pass 1 traces the table's own emit, pass 2 a leaf in its place
    assert [lt.emit is b.scene.lights.emit for lt in seen] == [True, True, False, False]


def test_replace_material_spectra_checks_its_fields(plane):
    m = plane["scene"].materials
    out = tgrad.replace_material_spectra(m, kd=m.kd * 2)
    assert torch.equal(out.kd, m.kd * 2) and out.tex_rows == m.tex_rows
    with pytest.raises(ValueError, match="eta"):
        tgrad.replace_material_spectra(m, eta=m.eta)
    with pytest.raises(ValueError, match="shape"):
        tgrad.replace_material_spectra(m, kd=m.kd[:, :3])


# ---------------------------------------------------------------------------
# scenes whose draws come from keys: volumes, igi, the cache, PRT
# ---------------------------------------------------------------------------

#: scene → (text, JAX traces with the primary-sample array too)
KEYED = {
    "fog": (fog_scene_text("single").replace('"directlighting" "integer maxdepth" [1]',
                                            '"path" "integer maxdepth" [2]'), True),
    "igi": (fog_scene_text("single").replace('"directlighting" "integer maxdepth" [1]',
                                            '"igi" "integer maxdepth" [2] "integer nlights" [16]'),
            True),
    "cache": (fog_scene_text("emission").replace('"directlighting" "integer maxdepth" [1]',
                                                 '"irradiancecache" "integer maxdepth" [1]'),
              False),
    "prt": (prt_scene_text('"diffuseprt" "integer nsamples" [8]'), False),
}
KEYED_LEAVES = ("kd", "emit")
KEY_SEED, KEY_SAMPLE = 6, 1


def _keyed_pieces():
    """The JAX package's pieces compiled once each, the volumes' and PRT's
    lookups too, a hit area light's row read as the port reads it."""
    stack = jax_integrator_pieces()
    stack.enter_context(jax_pieces_compiled())
    stack.enter_context(mock.patch.object(jisect, "intersect", jax.jit(
        jisect.intersect, static_argnames=("any_hit",))))
    stack.enter_context(mock.patch.object(jinter, "surface_interaction", jax.jit(
        jinter.surface_interaction, static_argnames=("spread",))))
    stack.enter_context(jax_area_rows_like_port())
    return stack


@pytest.fixture(scope="module", params=list(KEYED))
def keyed(request):
    """One keyed scene: ``jax.value_and_grad`` of kd and emit on the JAX
    side (keys of (pixel, sample 1), seed 6), the port's scene from its
    arrays with the keyed arrays of the same keys."""
    text, with_u = KEYED[request.param]
    with _keyed_pieces():
        jb = jbuild(jload(text))
        arrays = jax_scene_arrays(jb)
        scene, _, _ = scene_from_numpy(arrays, "cpu")
        icfg = integrator_from_numpy(arrays)
        R = N * N
        u = np.random.default_rng(4).random((R, JPS.n_dims(icfg.max_depth)), dtype=np.float32)
        ys, xs = np.divmod(np.arange(R), N)
        px, py = (xs + u[:, 0]).astype(np.float32), (ys + u[:, 1]).astype(np.float32)
        jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3],
                                                                u[:, 4])))
        pix = np.arange(R, dtype=np.int64)
        keys = jrng.pixel_sample_key(jrng.root_key(KEY_SEED), jnp.asarray(pix.astype(np.uint32)),
                                     jnp.uint32(KEY_SAMPLE))

        def jloss(*vals):
            sc = _jax_with(jb.scene, dict(zip(KEYED_LEAVES, vals)))
            return jtrace(sc, jr, keys, jb.integrator,
                          uniforms=jnp.asarray(u) if with_u else None)[0].mean()

        val, g = jax.value_and_grad(jloss, argnums=(0, 1))(
            *[_field(jb.scene, k) for k in KEYED_LEAVES])
    root, tpix = rng.root_key(KEY_SEED), torch.as_tensor(pix)
    tu = (torch.as_tensor(u) if with_u
          else tsampler.key_uniforms(icfg, root, tpix, KEY_SAMPLE))
    tr = Ray.make(torch.as_tensor(np.asarray(jr.origin)), torch.as_tensor(np.asarray(jr.direction)))
    return dict(name=request.param, scene=scene, rays=tr, u=tu, cfg=icfg, leaves=KEYED_LEAVES,
                media=tsampler.media_uniforms(scene, icfg, root, tpix, KEY_SAMPLE),
                draws=tsampler.integrator_draws(scene, icfg, root, tpix, KEY_SAMPLE),
                jax_loss=float(val), jax_grads={k: np.asarray(x) for k, x in zip(KEYED_LEAVES, g)})


def test_keyed_gradients_match_jax(keyed):
    """The loss and ∂loss/∂kd, ∂loss/∂emit against ``jax.value_and_grad``
    in a fog under path, igi and the irradiance cache, and under diffuseprt;
    the scene needs what the kind draws (media, draws) and kd's gradient
    flows."""
    s = keyed
    expect = {"fog": ("media",), "igi": ("media", "draws"), "cache": ("media", "draws"),
              "prt": ("draws",)}[s["name"]]
    assert all(s[k] is not None for k in expect)
    args = (s["scene"], s["rays"], s["u"], s["cfg"])
    loss, g = tgrad.value_and_grads(*args, media=s["media"], draws=s["draws"])
    np.testing.assert_allclose(float(loss), s["jax_loss"], rtol=1e-4)
    assert float(loss) > 0
    for k in KEYED_LEAVES:
        a, b = g[k].numpy(), s["jax_grads"][k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max(), err_msg=k)
    assert np.abs(g["kd"].numpy()).max() > 0
    if s["name"] != "prt":
        assert np.abs(g["emit"].numpy()).max() > 0
    # the other functions take the same arrays
    gm = tgrad.grad_wrt_materials(*args, media=s["media"], draws=s["draws"])
    ge = tgrad.grad_wrt_emission(*args, media=s["media"], draws=s["draws"])
    assert torch.equal(gm["kd"], g["kd"]) and torch.equal(ge, g["emit"])
    assert float(tgrad.radiance_loss(*args, media=s["media"], draws=s["draws"])) == float(loss)
    if "media" in expect:
        with pytest.raises(ValueError, match="media"):
            tgrad.value_and_grads(*args, draws=s["draws"])


@pytest.fixture(scope="module")
def deep_fog():
    """The fog at 16², ``path`` depth 5 under single scattering, the port
    alone: its arrays keyed by (pixel, sample 0) of seed 2."""
    text = fog_scene_text("single", 16, 16).replace('"directlighting" "integer maxdepth" [1]',
                                                   '"path" "integer maxdepth" [5]')
    b = build(load_scene_string(text), device="cpu")
    xs, ys, pix, mask, root, scr = tsampler.pixel_chunks(b, 2, None)
    u = tsampler.wave_uniforms(b.integrator, root, pix[0], scr[0], 0)
    rays = b.camera.generate_rays(xs[0].float() + u[:, 0], ys[0].float() + u[:, 1], u[:, 2],
                                  u[:, 3], u[:, 4])
    return dict(scene=b.scene, rays=rays, u=u, cfg=b.integrator, leaves=("kd", "emit"),
                media=tsampler.media_uniforms(b.scene, b.integrator, root, pix[0], 0))


def test_chunked_two_passes_equal_one_pass_in_fog(deep_fog, monkeypatch):
    """Chunks of 37 lanes (ragged) in the fog, each chunk its rows of the
    media block: the loss bit for bit, pass 2's radiance equal to pass 1's
    bit for bit chunk by chunk, the gradients within rtol 1e-5 of one
    pass."""
    s = deep_fog
    traced = []
    real = tgrad.trace_radiance

    def record(scene, rays, cfg, u, **kw):
        assert kw["media"].shape == (u.shape[0], 5 + 96)
        out = real(scene, rays, cfg, u, **kw)
        traced.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(tgrad, "trace_radiance", record)
    params = {k: _field(s["scene"], k) for k in s["leaves"]}
    args = (s["scene"], s["rays"], s["u"], s["cfg"], params)
    loss1, g1 = tgrad._value_and_grad(*args, media=s["media"])
    traced.clear()
    loss2, g2 = tgrad._value_and_grad(*args, chunk=37, media=s["media"])
    n = len(traced) // 2
    assert n == 7 and all(torch.equal(a, b) for a, b in zip(traced[:n], traced[n:]))
    assert float(loss1) == float(loss2) > 0
    for k in s["leaves"]:
        assert torch.isfinite(g2[k]).all() and g2[k].abs().max() > 0
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g1[k].abs().max()))


def test_cache_chunks_follow_the_stride():
    """Under irradiancecache each chunk takes the fill draws of its own
    fill lanes: chunks of 16 (a multiple of the stride 8, the last of 4)
    trace as ``render`` traces waves of those lanes, pass 2 equal to pass 1
    bit for bit; a chunk off the stride raises."""
    text = fog_scene_text("emission", 6, 6).replace('"directlighting" "integer maxdepth" [1]',
                                                    '"irradiancecache" "integer maxdepth" [1]')
    b = build(load_scene_string(text), device="cpu")
    ic = b.integrator
    root, pix = rng.root_key(0), torch.arange(36)
    u = tsampler.key_uniforms(ic, root, pix, 0)
    media = tsampler.media_uniforms(b.scene, ic, root, pix, 0)
    draws = tsampler.integrator_draws(b.scene, ic, root, pix, 0)
    rays = b.camera.generate_rays((pix % 6).float() + .5, (pix // 6).float() + .5,
                                  *(torch.full((36,), .5) for _ in range(3)))
    loss, g = tgrad.value_and_grads(b.scene, rays, u, ic, chunk=16, media=media, draws=draws)
    want = torch.cat([tpath.trace_radiance(
        b.scene, tgrad._ray_rows(rays, a, min(a + 16, 36)), ic, u[a:a + 16],
        media=media[a:a + 16], draws=tsampler.integrator_draws(
            b.scene, ic, root, pix[a:a + 16], 0))[0] for a in range(0, 36, 16)])
    assert float(loss) == float(want.mean()) > 0 and torch.isfinite(g["kd"]).all()
    with pytest.raises(ValueError, match="stride"):
        tgrad.value_and_grads(b.scene, rays, u, ic, chunk=12, media=media, draws=draws)
