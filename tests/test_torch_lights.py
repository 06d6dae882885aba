"""Parity of the port's light table (``pbrt_torch/lights/table.py``) with the
JAX package: the builders' tables field by field, ``sample_li`` for each
light type — point, spot (inside the inner cone, in the falloff band and
outside), distant, and area lights on a sphere and on a triangle mesh,
with the area-CDF inversion at its boundaries — and ``pdf_li_hit``'s mesh
case, on the very same scene arrays (``interop`` of the JAX build).

The JAX package indexes its light table with a surface's area-light index
(which counts area lights only), though its rows start with the
``LightSource`` lights; the port reads row ``area_row0 + index``. The
last two tests show both sides of that on a point light plus a sphere
light. Tolerances: rtol / atol 1e-5 (XLA contracts multiply-adds into FMA
on the CPU, the port rounds each operation), on every lane but for
``sample_li``, where ≥ 99.9% of lanes must meet it: a sphere light's cone
sample ends at b − √disc, which cancels where the sampled direction grazes
the sphere (one lane of 2,000 here differs by 1.9e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.lights import table as jlt
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.lights import table as tlt
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, lights_scene_text, tiny_scene_text

FIELDS = ("type", "emit", "pos", "dirw", "cos_total", "cos_falloff", "shape_kind",
          "quad_idx", "tri_start", "tri_count", "cdf_offset", "total_area", "tri_cdf")
TOL = dict(rtol=1e-5, atol=1e-5)
R = 2000


@pytest.fixture(scope="module")
def scenes():
    text = lights_scene_text()
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return jb, scene, tbuild(tload(text), device="cpu")


def test_light_table_matches_jax_builder(scenes):
    """The port's builder gives the JAX builder's table, field by field
    (spectra rtol 1e-6, the rest equal), and its area_row0 is the number
    of LightSource rows; interop's copy says the same."""
    jb, scene, tb = scenes
    jl, tl = jb.scene.lights, tb.scene.lights
    for k in FIELDS:
        a, b = np.asarray(getattr(jl, k)), getattr(tl, k).numpy()
        if k == "emit":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert list(tl.type.tolist()) == [tlt.POINT, tlt.SPOT, tlt.DISTANT, tlt.AREA, tlt.AREA]
    assert tl.area_row0 == scene.lights.area_row0 == 3
    assert tl.active_types == scene.lights.active_types == (0, 1, 2, 3)
    assert tl.mesh_segments == scene.lights.mesh_segments == ((3, 0, 2),)


def _points(rng, n=R):
    return rng.uniform([-3, -1, -3], [3, 2.4, 3], (n, 3)).astype(np.float32)


def _sample_both(jb, scene, li, p, u1, u2):
    lj = jlt.sample_li(jb.scene.lights, jb.scene.geometry, jnp.asarray(li, jnp.int32),
                       jnp.asarray(p), jnp.asarray(u1), jnp.asarray(u2))
    lt = tlt.sample_li(scene.lights, scene.geometry, torch.as_tensor(li, dtype=torch.int64),
                       torch.as_tensor(p), torch.as_tensor(u1), torch.as_tensor(u2))
    return lj, lt


def _assert_samples_match(lj, lt):
    close = np.ones(lt.pdf.shape, bool)
    for k in ("wi", "L", "pdf", "dist"):
        a, b = getattr(lt, k).numpy(), np.asarray(getattr(lj, k))
        c = np.isclose(a, b, equal_nan=True, **TOL)
        close &= c.all(-1) if c.ndim == 2 else c
    assert close.mean() >= 0.999, np.nonzero(~close)[0]
    np.testing.assert_array_equal(lt.is_delta.numpy(), np.asarray(lj.is_delta))


@pytest.mark.parametrize("row,name", [(0, "point"), (1, "spot"), (2, "distant"),
                                      (3, "mesh area"), (4, "sphere area")])
def test_sample_li_matches_jax(scenes, row, name):
    jb, scene, _ = scenes
    rng = np.random.default_rng(row)
    p = _points(rng)
    u1, u2 = rng.random(R, dtype=np.float32), rng.random(R, dtype=np.float32)
    lj, lt = _sample_both(jb, scene, np.full(R, row), p, u1, u2)
    _assert_samples_match(lj, lt)
    assert (lt.L > 0).any(-1).float().mean() > 0.1, name
    if name == "spot":  # points inside the inner cone, in the band and outside
        lt_ = scene.lights
        cos_t = (-lt.wi * lt_.dirw[1]).sum(-1)
        inner, outer = float(lt_.cos_falloff[1]), float(lt_.cos_total[1])
        assert int((cos_t > inner).sum()) > 20
        assert int(((cos_t > outer) & (cos_t < inner)).sum()) > 20
        assert int((cos_t < outer).sum()) > 20
    if name == "distant":
        assert torch.isinf(lt.dist).all()


def test_sample_li_mixed_lights_matches_jax(scenes):
    """Lanes on every light at once (the masked evaluation over types)."""
    jb, scene, _ = scenes
    rng = np.random.default_rng(7)
    p = _points(rng)
    li = rng.integers(0, 5, R)
    lj, lt = _sample_both(jb, scene, li, p, rng.random(R, dtype=np.float32),
                          rng.random(R, dtype=np.float32))
    _assert_samples_match(lj, lt)


def test_mesh_light_cdf_boundaries_match_jax(scenes):
    """u1 exactly on the mesh light's CDF entries, at 0 and just around
    them: the port picks JAX's triangle (count of entries below u1)."""
    jb, scene, _ = scenes
    cdf = scene.lights.tri_cdf.numpy()
    edges = np.concatenate([cdf, [0.0], np.nextafter(cdf, 0), np.nextafter(cdf, 2)])
    u1 = np.clip(np.tile(edges, 40), 0, np.float32(1 - 2**-24)).astype(np.float32)
    n = len(u1)
    rng = np.random.default_rng(8)
    lj, lt = _sample_both(jb, scene, np.full(n, 3), _points(rng, n), u1,
                          rng.random(n, dtype=np.float32))
    _assert_samples_match(lj, lt)


def test_pdf_li_hit_mesh_case_matches_jax(scenes):
    """t² / (|cos θ_l| · A) of the mesh light and the sphere light's cone
    pdf for BSDF-sampled hits; the JAX side is called with the light's
    row, the port with its area-light index."""
    jb, scene, _ = scenes
    rng = np.random.default_rng(9)
    p = _points(rng)
    w = rng.normal(size=(R, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    t = rng.uniform(0.1, 5, R).astype(np.float32)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    area_idx = rng.integers(-1, 2, R)
    row = np.where(area_idx >= 0, area_idx + scene.lights.area_row0, -1)
    pj = jlt.pdf_li_hit(jb.scene.lights, jb.scene.geometry, jnp.asarray(row, jnp.int32),
                        jnp.asarray(p), jnp.asarray(w), jnp.asarray(t), jnp.asarray(n))
    pt = tlt.pdf_li_hit(scene.lights, scene.geometry, torch.as_tensor(area_idx),
                        torch.as_tensor(p), torch.as_tensor(w), torch.as_tensor(t),
                        torch.as_tensor(n))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    assert (pt[torch.as_tensor(area_idx == 0)] > 0).all()


def _point_plus_sphere_light():
    text = tiny_scene_text().replace(
        "WorldBegin", 'WorldBegin\nLightSource "point" "rgb I" [1 1 1] "point from" [0 3 -3]', 1)
    return jbuild(jload(text)), tbuild(tload(text), device="cpu")


def test_jax_area_emission_reads_the_light_source_row():
    """The JAX package's fault: with a point light (I 1) before the sphere
    light (L 12), the sphere's area-light index 0 reads row 0, the point
    light's I."""
    jb, _ = _point_plus_sphere_light()
    jl = jb.scene.lights
    np.testing.assert_array_equal(np.asarray(jl.type), [jlt.POINT, jlt.AREA])
    assert np.asarray(jb.scene.geometry.quad_area_light).max() == 0
    up = jnp.asarray([[0.0, 1.0, 0.0]])
    le = np.asarray(jlt.emitted_radiance(jl, jnp.asarray([0], jnp.int32), up, up))
    np.testing.assert_array_equal(le[0], np.asarray(jl.emit)[0])
    assert not np.allclose(le[0], np.asarray(jl.emit)[1])


def test_port_area_emission_reads_its_own_row():
    """The port reads the sphere light's own row (area_row0 + index)."""
    jb, tb = _point_plus_sphere_light()
    tl = tb.scene.lights
    assert tl.area_row0 == 1
    up = torch.tensor([[0.0, 1.0, 0.0]])
    le = tlt.emitted_radiance(tl, torch.tensor([0]), up, up).numpy()
    np.testing.assert_allclose(le[0], np.asarray(jb.scene.lights.emit)[1], rtol=1e-6)
    assert float(le.min()) > 1.0  # L 12, not the point light's I 1
