"""Parity of the port's ``path`` and ``directlighting`` integrators with the
JAX package on the materials-and-environment scene at 16², first from the
same primary-sample array, then by both packages' ``render(seed)``.

The scene (``torch_parity_util.materials_scene_text``) is the tiny scene
with chip_smoke.py's materials-and-environment additions at its scale: a
mapped infinite light, a projection and a goniometric light beside the
sphere area light (the generated maps of ``chip_smoke.write_material_data``
in a temporary directory), a substrate floor, an uber wall, a glass
sphere, the mirror sphere, the 2,880-triangle blob in metal, and spheres
in shinymetal, anisoward, Oren–Nayar matte, translucent, a mix and both
measured formats: every kind but subsurface, every lobe. The killeroo-
scale version chip_smoke.py renders on the card is not used here: at its
distances (t/r up to ~100 for its light) a float32 sphere hit rounds
differently under XLA's contracted multiply-adds by more than 1e-4 of the
result on 1–2% of lanes, so the stated tolerance would test that rounding.

As in tests/test_torch_light_scene.py, the JAX side runs with
``emitted_radiance`` and ``pdf_li_hit`` wrapped to read an area light's
own row (the scene has ``LightSource`` rows before it). It runs under
``jit`` with its bounce loop rolled (``PBRT_TPU_UNROLL_BOUNCES=0``, its
own switch): run eagerly, its vmapped ``lax.switch`` broadcasts the env
map to every lane, and unrolled, XLA compiles for ~4 minutes.

Tolerances (as test_torch_light_scene.py): per-lane L allclose rtol 1e-4,
atol 1e-6 on ≥ 99% of lanes (a glass or TIR decision, or a lookup at a
texel edge of a map, can move by an ulp), per-bin means within 1e-3
relative, first-hit t rtol 1e-5; film sums rtol 1e-5.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.lights import table as jlt
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.integrators.path import IntegratorConfig
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, materials_scene_text

N = 16
DEPTH = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("materials_scene"))
    chip_smoke.write_material_data(d)
    text = materials_scene_text(d, N, N, DEPTH)
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(12)
    u = rng.random((N * N, JPS.n_dims(DEPTH)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px, py = (xs + u[:, 0]).astype(np.float32), (ys + u[:, 1]).astype(np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    tr = TRay.make(torch.as_tensor(np.array(jr.origin)), torch.as_tensor(np.array(jr.direction)))
    return dict(text=text, jb=jb, scene=scene, u=u, jr=jr, tr=tr)


def _jax_own_rows(row0):
    """The JAX package's area-light lookups at row0 + index, and its bounce
    loop rolled."""
    shift = lambda idx: jnp.where(idx >= 0, idx + row0, idx)
    emit, pdf = jlt.emitted_radiance, jlt.pdf_li_hit
    return (mock.patch.object(jlt, "emitted_radiance",
                              lambda lt, idx, *a: emit(lt, shift(idx), *a)),
            mock.patch.object(jlt, "pdf_li_hit",
                              lambda lt, g, idx, *a: pdf(lt, g, shift(idx), *a)),
            mock.patch.dict("os.environ", {"PBRT_TPU_UNROLL_BOUNCES": "0"}))


def test_scene_holds_every_kind(setup):
    mt, lt = setup["scene"].materials, setup["scene"].lights
    assert set(mt.kind.tolist()) == set(range(14)) - {11, 12}  # all but subsurface
    assert mt.active_lobes == tuple(range(14))
    assert lt.type.tolist() == [4, 5, 6, 3] and lt.area_row0 == 3
    assert lt.infinite_mapped == (True,)


@pytest.mark.parametrize("kind", ["path", "directlighting"])
def test_trace_radiance_matches_jax(setup, kind):
    s = setup
    jcfg = dataclasses.replace(s["jb"].integrator, kind=kind, max_depth=DEPTH, n_bins=32)
    p1, p2, p3 = _jax_own_rows(s["scene"].lights.area_row0)
    with p1, p2, p3:
        Lj, fj = jax.jit(lambda sc, r, uu: j_trace(sc, r, None, jcfg, uniforms=uu))(
            s["jb"].scene, s["jr"], jnp.asarray(s["u"]))
    Lt, ft = t_trace(s["scene"], s["tr"], IntegratorConfig(kind=kind, max_depth=DEPTH),
                     torch.as_tensor(s["u"]))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.sum() > 0
    assert np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    mj, mt = Lj.mean(0), Lt.mean(0)
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)


def test_render_seed_matches_jax(setup):
    """Both packages' ``render`` (``path`` at depth 3, 1 spp, seed 5,
    100-pixel chunks: the last one padded), keyed by threefry."""
    s = setup
    jb = s["jb"]
    tb = tbuild(tload(s["text"]), device="cpu")
    assert jb.integrator.max_depth == tb.integrator.max_depth == DEPTH
    p1, p2, p3 = _jax_own_rows(tb.scene.lights.area_row0)
    with p1, p2, p3:
        js = j_render(jb, spp=1, seed=5, chunk_pixels=100, verbose=False)
    ts = render(tb, spp=1, seed=5, chunk_pixels=100)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    np.testing.assert_allclose(pt.sum((0, 1)), pj.sum((0, 1)), rtol=1e-5)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)
