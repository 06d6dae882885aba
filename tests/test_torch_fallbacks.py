"""Names a scene file may hold that neither pbrt-v2's subset here nor the
JAX package knows: the port falls back as the JAX package does, with its
warning where it gives one (``pbrt_tpu/scene/builder.py``,
``renderers/sampler.py``, ``integrators/path.py``).

The seven sites: an unknown accelerator builds the BVH and an unknown BVH
split method is SAH (builder.py:525-545, :527-529); an unknown surface
integrator renders ``path`` (:717-731); an unknown shape is skipped with
a warning (:343-346), an instanced one without a word (:391-393); an
unknown ``LightSource`` is skipped with a warning (:992); an area light's
name is not read (:233-234); an unknown sampler samples as ``random``
(sampler.py:84-87). And ``trace_radiance`` of a kind the JAX package does
not know runs its bounce loop as ``path`` without Russian roulette
(path.py:677). The tiny scene at 8×8, ``path`` depth 2, carries them in two
variants: A the silent ones (an unknown accelerator, sampler and surface
integrator), B the rest (an unknown split, light and shape, an area light
named "diffuse"). Each package renders both with ``render(seed)``, the
JAX side eagerly with its pieces compiled once each
(``torch_parity_util.jax_integrator_pieces``); their warnings are
recorded at the build.

Tolerances: the renders as ``tests/test_torch_film.py``'s (pixels rtol
1e-4, atol 1e-6 on ≥ 98% of the 64, per-bin sums rtol 1e-4); the unknown
kind's radiance per lane rtol 1e-4, atol 1e-6 on ≥ 98% of 256 lanes;
tables and warnings exact.
"""

import contextlib
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.lights.table as jlt
import pbrt_tpu.utils.error as jerr
import pbrt_torch.utils.error as terr
from pbrt_tpu.integrators.path import trace_radiance as jtrace
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.integrators import path as tpath
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import (jax_integrator_pieces, jax_scene_arrays, subsurface_scene_text,
                               tiny_scene_text)

N = 8
TOL = dict(rtol=1e-4, atol=1e-6)
BASE = tiny_scene_text(N, N, 1, 2)
#: variant A: the names the JAX package passes over without a word
SILENT = (BASE.replace('Sampler "lowdiscrepancy"', 'Sampler "sobol"')
          .replace('SurfaceIntegrator "path"', 'SurfaceIntegrator "bidirectional"')
          .replace("WorldBegin", 'Accelerator "qbvh"\n    WorldBegin', 1))
UNKNOWN_SHAPE = 'Shape "bilinearpatch" "point P" [0 0 0  1 0 0  0 1 0  1 1 0]'
UNKNOWN_LIGHT = 'LightSource "bogus" "rgb I" [9 9 9]'
#: variant B: an unknown split, light and shape, the area light renamed
WARNED = (BASE.replace('AreaLightSource "area"', 'AreaLightSource "diffuse"')
          .replace("WorldBegin", 'Accelerator "bvh" "string splitmethod" ["hlbvh"]\n'
                   f"    WorldBegin\n    {UNKNOWN_LIGHT}\n    {UNKNOWN_SHAPE}", 1))
WARNINGS_B = ["shape 'bilinearpatch' not supported yet; skipped",
              "light 'bogus' not supported yet; skipped"]


@contextlib.contextmanager
def recorded(module):
    """The warnings ``module.warning`` gives, in order."""
    seen = []
    with mock.patch.object(module, "warning", seen.append):
        yield seen


def builds(text):
    """(JAX build, its warnings, port build, its warnings)."""
    with recorded(jerr) as jw:
        jb = jbuild(jload(text))
    with recorded(terr) as tw:
        tb = tbuild(tload(text), device="cpu")
    return jb, list(jw), tb, list(tw)


@pytest.fixture(scope="module")
def variants():
    """Both variants and the plain tiny scene, built by both packages, and
    each variant's ``render(seed 4)`` by both."""
    out = {}
    with jax_integrator_pieces():
        for name, text in (("A", SILENT), ("B", WARNED), ("base", BASE)):
            jb, jw, tb, tw = builds(text)
            out[name] = dict(jb=jb, jw=jw, tb=tb, tw=tw)
            if name != "base":
                out[name]["jpixels"] = np.asarray(j_render(jb, spp=1, seed=4,
                                                           verbose=False).pixels)
    return out


def test_silent_fallbacks_warn_in_neither(variants):
    assert variants["A"]["jw"] == variants["A"]["tw"] == []


def test_unknown_accelerator_builds_the_bvh(variants):
    """``Accelerator "qbvh"``: the BVH of the plain scene, in both."""
    a, base = variants["A"], variants["base"]
    tg, bg = a["tb"].scene.geometry, base["tb"].scene.geometry
    assert tg.accel_kind == bg.accel_kind == "bvh"
    np.testing.assert_array_equal(tg.wide_rows.numpy(), bg.wide_rows.numpy())
    np.testing.assert_array_equal(tg.wide_rows.numpy(), np.asarray(a["jb"].scene.geometry.wide_rows))


def test_unknown_split_method_is_sah(variants):
    """``"string splitmethod" ["hlbvh"]``: the SAH tree of the plain scene,
    in both."""
    b, base = variants["B"], variants["base"]
    np.testing.assert_array_equal(b["tb"].scene.geometry.wide_rows.numpy(),
                                  base["tb"].scene.geometry.wide_rows.numpy())
    np.testing.assert_array_equal(b["tb"].scene.geometry.wide_rows.numpy(),
                                  np.asarray(b["jb"].scene.geometry.wide_rows))


def test_unknown_surface_integrator_renders_path(variants):
    a = variants["A"]
    assert a["tb"].integrator.kind == a["jb"].integrator.kind == "path"
    assert a["tb"].integrator.max_depth == a["jb"].integrator.max_depth == 2


def test_unknown_sampler_samples_as_random(variants):
    """The ``sobol`` camera columns are ``random``'s, bit for bit."""
    assert variants["A"]["tb"].sampler_name == "sobol"
    assert rng.sampler_constants("sobol", 3, 4) == rng.sampler_constants("random", 3, 4)
    pix = torch.arange(64)
    scr = rng.pixel_scrambles(rng.root_key(1), pix)
    for fn in (rng.primary_uniforms, rng.ao_uniforms):
        np.testing.assert_array_equal(fn(rng.root_key(1), pix, scr, 2, 2, "sobol", 4).numpy(),
                                      fn(rng.root_key(1), pix, scr, 2, 2, "random", 4).numpy())


def test_unknown_shape_and_light_are_skipped_with_the_warning(variants):
    """The JAX package's two warnings, word for word and in its order; the
    geometry and the light table those of the plain scene."""
    b, base = variants["B"], variants["base"]
    assert b["jw"] == b["tw"] == WARNINGS_B
    tg, bg = b["tb"].scene.geometry, base["tb"].scene.geometry
    assert (tg.num_triangles, tg.num_quadrics) == (bg.num_triangles, bg.num_quadrics)
    lt, blt = b["tb"].scene.lights, base["tb"].scene.lights
    for f in ("type", "emit", "shape_kind", "quad_idx"):
        np.testing.assert_array_equal(getattr(lt, f).numpy(), getattr(blt, f).numpy(), f)
    np.testing.assert_array_equal(lt.type.numpy(), np.asarray(b["jb"].scene.lights.type))


def test_area_light_name_is_not_read(variants):
    """``AreaLightSource "diffuse"`` emits as ``"area"`` does: the sphere's
    row and id as the plain scene's, in both."""
    b, base = variants["B"], variants["base"]
    np.testing.assert_array_equal(b["tb"].scene.geometry.quad_area_light.numpy(),
                                  base["tb"].scene.geometry.quad_area_light.numpy())
    np.testing.assert_array_equal(np.asarray(b["jb"].scene.lights.emit),
                                  np.asarray(variants["base"]["jb"].scene.lights.emit))


@pytest.mark.parametrize("name", ["A", "B"])
def test_fallback_renders_match_jax(variants, name):
    """``render(seed 4)`` of each variant, each package from its own build."""
    v = variants[name]
    pt = render(v["tb"], spp=1, seed=4).pixels.numpy()
    pj = v["jpixels"]
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, **TOL).all(-1).mean() >= 0.98
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-4)


def test_unknown_kind_traces_as_path_without_roulette():
    """``trace_radiance`` with ``cfg.kind`` "bogus": the JAX package's
    radiance per lane on one shared primary-sample array (the tiny scene
    closed into a room, depth 6, 256 lanes), and in the port ``path``'s
    with roulette off (``rr_depth`` past the depth) bit for bit, not
    ``path``'s (roulette after bounce 3 scales the later bounces' light)."""
    jb = jbuild(jload(subsurface_scene_text('"path" "integer maxdepth" [6]', 16, 16,
                                            room=True)))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    R = 256
    u = np.random.default_rng(5).random((R, tpath.PrimarySource.n_dims(6)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(R), 16)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (
        (xs + u[:, 0]).astype(np.float32), (ys + u[:, 1]).astype(np.float32), u[:, 2], u[:, 3],
        u[:, 4])))
    with jax_integrator_pieces():
        Lj = np.asarray(jtrace(jb.scene, jr, None, dataclasses.replace(jb.integrator,
                                                                       kind="bogus"),
                               uniforms=jnp.asarray(u))[0])
    rays = geom.Ray.make(*(torch.as_tensor(np.array(a)) for a in (jr.origin, jr.direction)))
    tu = torch.as_tensor(u)
    cfg = tpath.IntegratorConfig(max_depth=6)
    L = tpath.trace_radiance(scene, rays, dataclasses.replace(cfg, kind="bogus"), tu)[0]
    assert np.isfinite(L.numpy()).all() and L.sum() > 0
    assert np.isclose(L.numpy(), Lj, **TOL).all(-1).mean() >= 0.98
    no_rr = tpath.trace_radiance(scene, rays, dataclasses.replace(cfg, rr_depth=6), tu)[0]
    assert torch.equal(L, no_rr)
    assert not torch.equal(L, tpath.trace_radiance(scene, rays, cfg, tu)[0])


def test_instanced_unknown_shape_is_skipped_without_a_word():
    """An object used twice holding a mesh and an unknown shape: both
    packages share the object and drop the shape silently; the instance
    tables those of the object without it."""
    obj = ('ObjectBegin "o"\n  Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0] '
           '"integer indices" [0 1 2]\n  {extra}\nObjectEnd\n'
           'AttributeBegin Translate -2 0 1 ObjectInstance "o" AttributeEnd\n'
           'AttributeBegin Translate 2 0 1 ObjectInstance "o" AttributeEnd\n')
    with_shape = BASE.replace("WorldEnd", obj.format(extra=UNKNOWN_SHAPE) + "WorldEnd")
    without = BASE.replace("WorldEnd", obj.format(extra="") + "WorldEnd")
    jb, jw, tb, tw = builds(with_shape)
    assert jw == tw == []
    ref = tbuild(tload(without), device="cpu").scene.geometry
    g = tb.scene.geometry
    assert g.inst_rows is not None and g.num_triangles == ref.num_triangles
    for f in ("inst_rows", "inst_o2w", "inst_root", "tri_v0"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), getattr(ref, f).numpy(), f)
    np.testing.assert_array_equal(g.inst_rows.numpy(),
                                  np.asarray(jb.scene.geometry.inst_rows))


def test_fact54_unknown_area_shape_takes_no_id():
    """Fact 54 (repaired): an unknown shape under an ``AreaLightSource``,
    then a sphere under another. The JAX package gives the skipped shape id
    0 and builds no row for it, so the sphere's id 1 has no row; the port
    gives the sphere id 0, its own row. Both warn alike."""
    lit = ('AttributeBegin\n  AreaLightSource "area" "rgb L" [3 3 3]\n  '
           f"{UNKNOWN_SHAPE}\nAttributeEnd\n"
           'AttributeBegin\n  Translate 0 2 3\n  AreaLightSource "area" "rgb L" [5 5 5]\n  '
           'Shape "sphere" "float radius" [.2]\nAttributeEnd\n')
    text = BASE.replace("WorldEnd", lit + "WorldEnd")
    jb, jw, tb, tw = builds(text)
    assert jw == tw == [WARNINGS_B[0]]
    j_ids = np.asarray(jb.scene.geometry.quad_area_light)
    t_ids = tb.scene.geometry.quad_area_light.numpy()
    n_area = int((np.asarray(jb.scene.lights.type) == jlt.AREA).sum())
    assert tb.scene.lights.count == n_area == 2  # the tiny scene's sphere light and this one
    assert j_ids.max() == 2 and t_ids.max() == 1  # the JAX id points past its rows
    # the sphere's row is its own light (L 5), the first the tiny scene's (L 12)
    emit = tb.scene.lights.emit.numpy()[tb.scene.lights.area_row0 + np.array([0, 1])]
    np.testing.assert_allclose(emit[1], emit[0] * 5 / 12, rtol=1e-5)
