"""Parity of the port's textured shading with the JAX package on a 16²
textured scene (``torch_parity_util.texture_scene_text``: the tiny scene
with goldens/metal.pbrt's floor at its scale — a substrate with an
imagemap Kd under EWA and a scaled imagemap bump map — a checkerboard Kd
on a sphere, a normal map and a mix whose sub-materials have a
dotted Kd and a checkered Ks, on quads; images from ``chip_smoke.write_texture_data``
in a temporary directory): ``apply_textures`` on the first hits (Kd and Ks
per sub-lane, the normal map, the bump chain), ``path``,
``directlighting`` and ``whitted`` from the same primary-sample array and
camera ray differentials, both packages' ``render(seed)`` with
``diff_spp``, and fact 8 of the JAX package (only Kd, Ks, bumpmap and
normalmap take a texture) on both sides.

The JAX side runs on the JAX package's own arrays through ``interop``.
Its integrator runs eagerly, with its own ``eval_spectrum`` compiled once
per argument signature (ahead of time, ``jax.jit(...).lower().compile()``)
and called in its place: compiled whole, the JAX integrator with textures
takes XLA more than 25 minutes (every evaluation computes all 13 kinds
three times), and eagerly each evaluation takes ~1.4 s. Its ``render``
runs as written, but for ``_render_scan_jit``, which is replaced by the
loop its ``lax.scan`` runs (the same ``render_wave`` calls, eagerly).

Tolerances: Kd and Ks overrides and unbumped normals rtol 1e-4, atol
1e-6; bumped shading normals atol 1e-6, and the bumped dpdu, dpdv atol
1e-5 of their largest component — stated apart because the bump chain
divides the difference of two texture values by du (the footprint's, a
few thousandths in uv here), which magnifies the packages' rounding of
those values; rendered lanes rtol 1e-4,
atol 1e-6 on ≥ 99% of lanes, per-bin means within 1e-3 relative; film
sums rtol 1e-5.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.accel.intersect import intersect as jintersect
from pbrt_tpu.core.interaction import surface_interaction as jsi
from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import apply_textures as j_apply
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.materials import table as jmt
from pbrt_tpu.renderers import sampler as jsampler
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_tpu.textures import texture as jtex
from pbrt_torch.accel.intersect import Hit
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.core.interaction import surface_interaction as tsi
from pbrt_torch.integrators.path import IntegratorConfig
from pbrt_torch.integrators.path import apply_textures as t_apply
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.materials import table as tmt
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, texture_scene_text, tiny_scene_text

N = 16
DEPTH = 3
TOL = dict(rtol=1e-4, atol=1e-6)
BUMP_ATOL = 1e-6


class _CompiledEval:
    """The JAX package's ``eval_spectrum``, compiled ahead of time per
    (lanes, footprint given) signature."""

    def __init__(self):
        self.fn = jtex.eval_spectrum
        self.cache = {}

    def __call__(self, tt, tex_id, uv, p, uv_sigma=None, uv_major=None):
        args = (tt, tex_id, uv, p, uv_sigma, uv_major)
        key = (tex_id.shape, uv_sigma is None, uv_major is None)
        if key not in self.cache:
            self.cache[key] = jax.jit(self.fn).lower(*args).compile()
        return self.cache[key](*args)


def _scan_loop(film_state, scene, camera, filter_table, xs_stack, ys_stack, mask_stack,
               sample_base, root_key, icfg, sampler_name, spp, film_cfg, n_waves,
               diff_scale=None):
    """``_render_scan_jit``'s ``lax.scan`` over (wave, chunk) steps, as the
    loop it runs."""
    C = xs_stack.shape[0]
    for step in range(n_waves * C):
        ci = step % C
        film_state = jsampler.render_wave(
            film_state, scene, camera, filter_table, xs_stack[ci], ys_stack[ci],
            sample_base + step // C, root_key, icfg, sampler_name, spp, film_cfg,
            sample_scale=mask_stack[ci], sorted_pixels=True, diff_scale=diff_scale)
    return film_state


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("texture_scene"))
    chip_smoke.write_texture_data(d, teapot_freq=2)
    text = texture_scene_text(d, N, N, DEPTH)
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(21)
    u = rng.random((N * N, JPS.n_dims(DEPTH)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px = jnp.asarray((xs + u[:, 0]).astype(np.float32))
    py = jnp.asarray((ys + u[:, 1]).astype(np.float32))
    jr = jb.camera.generate_rays(px, py, *(jnp.asarray(u[:, k]) for k in (2, 3, 4)))
    jd = jb.camera.ray_differentials(px, py, jr)
    tr = TRay.make(torch.as_tensor(np.array(jr.origin)), torch.as_tensor(np.array(jr.direction)))
    td = tuple(torch.as_tensor(np.array(a)) for a in jd)
    compiled = _CompiledEval()
    with mock.patch.object(jtex, "eval_spectrum", compiled):
        yield dict(text=text, jb=jb, scene=scene, u=u, jr=jr, jd=jd, tr=tr, td=td)


def test_scene_holds_every_binding(setup):
    mt, tt = setup["scene"].materials, setup["scene"].textures
    assert all(mt.tex_rows[c] for c in ("kd_tex", "ks_tex", "bump_tex", "normal_tex"))
    assert mt.has_bump and mt.has_mix and not mt.tex_rows["sigma_tex"]
    assert set(tt.kinds) == {1, 4, 6, 8} and setup["scene"].pixel_spread > 0


def test_apply_textures_matches_jax(setup):
    """The first hits' textured lanes: Kd and Ks of both sub-lanes, and the
    normal-mapped and bumped shading frame."""
    s = setup
    jg = s["jb"].scene.geometry
    hit = jintersect(jg, s["jr"])
    jsi_ = jsi(jg, s["jr"], hit, spread=s["jb"].scene.pixel_spread, diffs=s["jd"])
    jsi2, jlm = j_apply(s["jb"].scene, jsi_, jmt.gather_lane(s["jb"].scene.materials,
                                                              jsi_.material))
    th = Hit(*(torch.as_tensor(np.array(a)) for a in (hit.t, hit.prim, hit.b1, hit.b2)))
    sc = s["scene"]
    tsi_ = tsi(sc.geometry, s["tr"], th, spread=sc.pixel_spread, diffs=s["td"], partials=True)
    tsi2, tlm = t_apply(sc, tsi_, tmt.gather_lane(sc.materials, tsi_.material))
    valid = tsi2.valid.numpy()
    for sub in ("lm1", "lm2"):
        for f in ("kd", "ks"):
            np.testing.assert_allclose(getattr(getattr(tlm, sub), f).numpy()[valid],
                                       np.asarray(getattr(getattr(jlm, sub), f))[valid],
                                       err_msg=f"{sub}.{f}", **TOL)
    mi = np.maximum(tsi2.material.numpy(), 0)
    bumped = valid & (sc.materials.bump_tex.numpy()[mi] >= 0)
    mapped = valid & (sc.materials.normal_tex.numpy()[mi] >= 0)
    assert bumped.sum() > 30 and mapped.sum() > 5
    ns_t, ns_j = tsi2.ns.numpy(), np.asarray(jsi2.ns)
    np.testing.assert_allclose(ns_t[valid & ~bumped], ns_j[valid & ~bumped], **TOL)
    np.testing.assert_allclose(ns_t[bumped], ns_j[bumped], rtol=0, atol=BUMP_ATOL)
    # the maps did move the normals
    ns0 = tsi_.ns.numpy()
    assert (np.abs(ns_t - ns0).max(-1)[mapped] > 1e-2).mean() > 0.5
    assert (np.abs(ns_t - ns0).max(-1)[bumped] > 1e-4).mean() > 0.5
    for f in ("dpdu", "dpdv"):
        a, b = np.asarray(getattr(jsi2, f))[valid], getattr(tsi2, f).numpy()[valid]
        scale = np.abs(a).max(-1, keepdims=True)
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("kind", ["path", "directlighting", "whitted"])
def test_trace_radiance_matches_jax(setup, kind):
    s = setup
    jcfg = dataclasses.replace(s["jb"].integrator, kind=kind, max_depth=DEPTH, n_bins=32)
    Lj, fj = j_trace(s["jb"].scene, s["jr"], None, jcfg, uniforms=jnp.asarray(s["u"]),
                     diffs=s["jd"])
    Lt, ft = t_trace(s["scene"], s["tr"], IntegratorConfig(kind=kind, max_depth=DEPTH),
                     torch.as_tensor(s["u"]), diffs=s["td"])
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.sum() > 0
    assert np.isclose(Lt, Lj, **TOL).all(-1).mean() >= 0.99
    mj, mt = Lj.mean(0), Lt.mean(0)
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)


def test_render_seed_matches_jax(setup):
    """Both packages' ``render`` (``path`` at depth 3, 1 spp, seed 5, one
    chunk), the footprint scaled as for 16 samples."""
    s = setup
    tb = tbuild(tload(s["text"]), device="cpu")
    assert tb.scene.pixel_spread == s["jb"].scene.pixel_spread
    with mock.patch.object(jsampler, "_render_scan_jit", _scan_loop):
        js = j_render(s["jb"], spp=1, seed=5, verbose=False, diff_spp=16)
    ts = render(tb, spp=1, seed=5, diff_spp=16)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-5)


def test_only_four_parameters_take_a_texture():
    """Fact 8: a texture-bound Kr (or roughness, or index) takes the
    parameter's constant default, on both sides: the glass renders as Kr 1."""
    extra = ('Texture "checks" "spectrum" "checkerboard"\n'
             'Texture "f" "float" "fbm"\n'
             'Material "glass" "texture Kr" "checks" "texture index" "f"\n'
             'Shape "sphere" "float radius" [.3]')
    text = tiny_scene_text().replace("WorldBegin", f"WorldBegin\n{extra}", 1)
    jm = jbuild(jload(text)).scene.materials
    tm = tbuild(tload(text), device="cpu").scene.materials
    row = int(np.nonzero(np.asarray(jm.kind) == jmt.GLASS)[0][0])
    for m in (jm, tm):
        kr = np.asarray(m.kr[row]) if not torch.is_tensor(m.kr) else m.kr[row].numpy()
        np.testing.assert_array_equal(kr, np.ones(32, np.float32))
        assert float(m.eta[row]) == 1.5
        assert all(int(getattr(m, c)[row]) == -1 for c in tmt.TEXTURE_COLUMNS)
