"""Parity of the port's ``path`` and ``directlighting`` integrators with the
JAX package on the scene with every ported light and quadric
(``torch_parity_util.lights_scene_text``: a point, a spot and a distant
light, a sphere and a triangle-mesh area light, and a disk, cylinder,
cone, paraboloid and hyperboloid beside the tiny scene's spheres).

The JAX package reads a hit area light's emission and MIS pdf from row
``area_light`` of its light table, whose rows start with the
``LightSource`` lights (test_torch_lights.py shows it); the port reads row
``area_row0 + area_light``. To compare the integrators, the JAX side runs
here with ``emitted_radiance`` and ``pdf_li_hit`` wrapped to add the same
offset; nothing in the JAX package changes.

Tolerances as test_torch_path.py: per-lane L allclose (rtol 1e-4, atol
1e-6) on ≥ 99% of lanes, per-bin means within 1e-3 relative, first-hit t
rtol 1e-5.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.lights import table as jlt
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.integrators.path import IntegratorConfig
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, lights_scene_text

N = 16
DEPTH = 3


@pytest.fixture(scope="module")
def setup():
    jb = jbuild(jload(lights_scene_text(N, N)))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(12)
    u = rng.random((N * N, JPS.n_dims(DEPTH)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px, py = (xs + u[:, 0]).astype(np.float32), (ys + u[:, 1]).astype(np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    tr = TRay.make(torch.as_tensor(np.asarray(jr.origin)),
                   torch.as_tensor(np.asarray(jr.direction)))
    return dict(jb=jb, scene=scene, u=u, jr=jr, tr=tr)


def _jax_trace_own_rows(jb, rays, cfg, u, row0):
    """JAX's trace_radiance with the area-light lookups at row0 + index."""
    shift = lambda idx: jnp.where(idx >= 0, idx + row0, idx)
    emit, pdf = jlt.emitted_radiance, jlt.pdf_li_hit
    with mock.patch.object(jlt, "emitted_radiance",
                           lambda lt, idx, *a: emit(lt, shift(idx), *a)), \
            mock.patch.object(jlt, "pdf_li_hit",
                              lambda lt, g, idx, *a: pdf(lt, g, shift(idx), *a)):
        return j_trace(jb.scene, rays, None, cfg, uniforms=jnp.asarray(u))


@pytest.mark.parametrize("kind", ["path", "directlighting"])
def test_trace_radiance_matches_jax(setup, kind):
    s = setup
    jcfg = dataclasses.replace(s["jb"].integrator, kind=kind, max_depth=DEPTH, n_bins=32)
    row0 = s["scene"].lights.area_row0
    assert row0 == 3
    Lj, fj = _jax_trace_own_rows(s["jb"], s["jr"], jcfg, s["u"], row0)
    Lt, ft = t_trace(s["scene"], s["tr"], IntegratorConfig(kind=kind, max_depth=DEPTH),
                     torch.as_tensor(s["u"]))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert np.isfinite(Lt).all() and Lt.sum() > 0
    assert np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    mj, mt = Lj.mean(0), Lt.mean(0)
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
