"""Parity of the port's path integrator with the JAX package.

Both packages trace the very same rays of the tiny built-in scene (16×16)
on the very same scene arrays (``pbrt_torch.interop.scene_from_numpy`` of
the JAX build), with the same primary-sample array (``uniforms=``), at
depth 4 (no Russian roulette: it starts after bounce 3) and depth 5 (the
bench's depth; roulette at the last bounce).

Lanes may differ where float order flips a decision: a Russian-roulette
draw that lands within an ulp of its continuation probability, or a
grazing ray whose hit/miss or hemisphere test flips — XLA's CPU backend
contracts multiply-adds (FMA) in the JAX traversal and shading, the port
rounds each operation. Hence ≥ 99% of lanes, not all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.interaction import surface_interaction as j_si
from pbrt_tpu.accel.intersect import intersect as j_intersect
from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.lights import table as j_lights
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel.intersect import intersect as t_intersect
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.core.interaction import surface_interaction as t_si
from pbrt_torch.integrators.path import IntegratorConfig, PrimarySource
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.lights import table as t_lights
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, tiny_scene_text

N = 16


@pytest.fixture(scope="module")
def setup():
    jb = jbuild(jload(tiny_scene_text(N, N)))
    scene, camera, film = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(0)
    u = rng.random((N * N, JPS.n_dims(5)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px = (xs + u[:, 0]).astype(np.float32)
    py = (ys + u[:, 1]).astype(np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    tr = TRay.make(torch.as_tensor(np.asarray(jr.origin)),
                   torch.as_tensor(np.asarray(jr.direction)))
    return dict(jb=jb, scene=scene, camera=camera, u=u, jr=jr, tr=tr, px=px, py=py)


def test_camera_rays_match(setup):
    """Perspective rays from the same raster samples; atol 1e-6."""
    s = setup
    tr = s["camera"].generate_rays(*(torch.as_tensor(a) for a in (
        s["px"], s["py"], s["u"][:, 2], s["u"][:, 3], s["u"][:, 4])))
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(s["jr"].origin), atol=1e-6)
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(s["jr"].direction),
                               atol=1e-6)


def test_surface_interaction_and_light_sample_match(setup):
    """First hits, their shading geometry and a light sample from each;
    rtol 1e-5 / atol 1e-5 (FMA contraction on the JAX side)."""
    s = setup
    jg = s["jb"].scene.geometry
    hj = j_intersect(jg, s["jr"])
    ht = t_intersect(s["scene"].geometry, s["tr"])
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    sj = j_si(jg, s["jr"], hj)
    st = t_si(s["scene"].geometry, s["tr"], ht)
    v = np.asarray(sj.valid)
    for k in ("p", "ng", "ns", "uv", "dpdu", "wo"):
        np.testing.assert_allclose(getattr(st, k).numpy()[v], np.asarray(getattr(sj, k))[v],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("material", "area_light", "mesh_id"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)))
    u1, u2 = s["u"][:, 6], s["u"][:, 7]
    lj = j_lights.sample_li(s["jb"].scene.lights, jg, jnp.zeros(N * N, jnp.int32),
                            sj.p, jnp.asarray(u1), jnp.asarray(u2))
    lt = t_lights.sample_li(s["scene"].lights, s["scene"].geometry,
                            torch.zeros(N * N, dtype=torch.int64), st.p,
                            torch.as_tensor(u1), torch.as_tensor(u2))
    for k in ("wi", "L", "pdf", "dist"):
        np.testing.assert_allclose(getattr(lt, k).numpy()[v], np.asarray(getattr(lj, k))[v],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("depth", [4, 5])
def test_trace_radiance_matches_jax(setup, depth):
    """Per-lane L allclose (rtol 1e-4, atol 1e-6) on ≥ 99% of lanes;
    per-bin mean over lanes within 1e-3 relative; first-hit t rtol 1e-5."""
    s = setup
    u = s["u"][:, : JPS.n_dims(depth)]
    jcfg = s["jb"].integrator.__class__(kind="path", max_depth=depth, n_bins=32)
    Lj, fj = j_trace(s["jb"].scene, s["jr"], None, jcfg, uniforms=jnp.asarray(u))
    Lt, ft = t_trace(s["scene"], s["tr"], IntegratorConfig(max_depth=depth),
                     torch.as_tensor(u))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert Lt.shape == Lj.shape == (N * N, 32)
    assert np.isfinite(Lt).all() and Lt.sum() > 0
    lanes = np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1)
    assert lanes.mean() >= 0.99, np.nonzero(~lanes)[0]
    mj, mt = Lj.mean(0), Lt.mean(0)
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)


def test_port_builder_scene_traces_the_same(setup):
    """The port's own build of the scene and the interop copy of the JAX
    build give the same radiance (rtol 1e-5): the builder is held to the
    same tables end to end."""
    s = setup
    tb = tbuild(tload(tiny_scene_text(N, N)), device="cpu")
    u = torch.as_tensor(s["u"][:, : PrimarySource.n_dims(5)])
    cfg = IntegratorConfig(max_depth=5)
    a, _ = t_trace(tb.scene, s["tr"], cfg, u)
    b, _ = t_trace(s["scene"], s["tr"], cfg, u)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_unknown_integrator_traces_as_jax_does(setup):
    """A kind neither package knows: the JAX ``trace_radiance`` runs its
    bounce loop with no kind's extras, ``path`` without roulette
    (path.py:677); the port's the same, per lane against the JAX package's
    (the rule above at depth 5), and bit for bit its own ``path`` with
    roulette off."""
    s = setup
    u = s["u"][:, : JPS.n_dims(5)]
    jcfg = s["jb"].integrator.__class__(kind="bidirectional", max_depth=5, n_bins=32)
    Lj, _ = j_trace(s["jb"].scene, s["jr"], None, jcfg, uniforms=jnp.asarray(u))
    tu = torch.as_tensor(u)
    Lt, _ = t_trace(s["scene"], s["tr"], IntegratorConfig(kind="bidirectional", max_depth=5), tu)
    assert np.isfinite(Lt.numpy()).all() and Lt.sum() > 0
    assert np.isclose(Lt.numpy(), np.asarray(Lj), rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    no_rr, _ = t_trace(s["scene"], s["tr"], IntegratorConfig(max_depth=5, rr_depth=5), tu)
    assert torch.equal(Lt, no_rr)
