"""Parity of the port's quadrics with the JAX package: each of the six types
(sphere, cylinder, disk, cone, paraboloid, hyperboloid) against
``pbrt_tpu.accel.intersect._quad_test`` ray by ray, then closest hits and
their shading geometry (``surface_interaction``) on the scene with every
light and quadric (``torch_parity_util.lights_scene_text``), and the
port's exhaustive ``intersect_brute`` against its own ``intersect``.

Tolerances: hit / miss and prim ids equal on ≥ 99.9% of rays (a root at a
clip boundary may flip with float order); where both hit, t rtol 1e-5 /
atol 1e-5, and the parametric u, v and the shading fields (p, normals,
dpdu) atol 1e-4, on ≥ 99% of those rays and within 1e-3 on all. XLA
contracts multiply-adds into FMA on the CPU, the port rounds each
operation; where a ray grazes a quadric the square root of the small
discriminant magnifies that difference (up to 9e-5 relative in t on a few
rays here, 2e-4 in a hit point 8 units away), u, v divide an object-space
coordinate (up to ~12 units from the origin for the scaled hyperboloid) by
the quadric's z or φ range, and the normals follow the hit point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.core.interaction import surface_interaction as j_si
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.core.interaction import surface_interaction as t_si
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, lights_scene_text

TOL = dict(rtol=1e-5, atol=1e-5)


#: u, v and the shading fields (see the docstring)
UV_TOL = dict(rtol=1e-5, atol=1e-4)


def _close(a, b, tol=TOL, share=0.99):
    """a, b (n, ...) allclose at ``tol`` on ≥ ``share`` of the n rows and
    within 1e-3 on all."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    c = np.isclose(a, b, **tol).reshape(len(a), -1).all(-1)
    assert c.mean() >= share, (c.mean(), np.nonzero(~c)[0][:10])


FIELDS = ("p", "ng", "ns", "uv", "dpdu", "wo")
TYPES = ["sphere", "cylinder", "disk", "cone", "paraboloid", "hyperboloid"]


@pytest.fixture(scope="module")
def scenes():
    text = lights_scene_text(24, 24)
    jb = jbuild(jload(text))
    scene, camera, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return jb, scene, camera, tbuild(tload(text), device="cpu")


def _rays_at(g_t, q, rng, n=3000):
    """Rays from random origins toward random points of quadric q's box."""
    o2w = g_t.quad_o2w[q].numpy().astype(np.float64)
    target = rng.uniform(-1.2, 1.2, (n, 3)) * [1, 1, 1]
    prm = g_t.quad_params[q].numpy()
    scale = max(float(prm[0]), float(prm[4]), float(abs(prm[1])), float(abs(prm[2])), 1.0)
    target = (target * scale) @ o2w[:3, :3].T + o2w[:3, 3]
    o = target + rng.normal(size=(n, 3)) * 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_quadric_tables_match(scenes):
    jb, scene, _, tb = scenes
    jg, tg = jb.scene.geometry, tb.scene.geometry
    for k in ("quad_type", "quad_params", "quad_o2w", "quad_material", "quad_mesh_id",
              "quad_area_light", "quad_reverse"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)), k)
    np.testing.assert_allclose(tg.quad_w2o.numpy(), np.asarray(jg.quad_w2o), rtol=1e-6, atol=1e-7)
    assert tg.quad_active_types == scene.geometry.quad_active_types == tuple(range(6))


@pytest.mark.parametrize("name", TYPES)
def test_quad_test_matches_jax(scenes, name):
    """Each quadric of the type, ray by ray, against ``_quad_test``."""
    jb, scene, _, _ = scenes
    jg, tg = jb.scene.geometry, scene.geometry
    qs = np.nonzero(tg.quad_type.numpy() == TYPES.index(name))[0]
    assert len(qs)
    rng = np.random.default_rng(TYPES.index(name))
    for q in qs:
        o, d = _rays_at(tg, int(q), rng)
        n = len(o)
        tmin, tmax = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
        ref = jax.vmap(lambda a, b, c, e: jisect._quad_test(jg, int(q), a, b, c, e))(
            *(jnp.asarray(x) for x in (o, d, tmin, tmax)))
        hj, tj, uj, vj = (np.asarray(x) for x in ref)
        ht, tt, ut, vt = (x[:, q].numpy() for x in tisect.quad_test(
            tg, *(torch.as_tensor(x) for x in (o, d, tmin, tmax))))
        assert (ht == hj).mean() >= 0.999
        both = ht & hj
        assert both.sum() > 200, (name, int(both.sum()))
        _close(tt[both], tj[both])
        _close(np.stack([ut, vt], -1)[both], np.stack([uj, vj], -1)[both], UV_TOL)


@pytest.fixture(scope="module")
def hits(scenes):
    """Camera rays of a 24×24 frame plus rays aimed at each quadric."""
    jb, scene, camera, _ = scenes
    rng = np.random.default_rng(11)
    ys, xs = np.divmod(np.arange(24 * 24), 24)
    px = torch.as_tensor((xs + rng.random(xs.size)).astype(np.float32))
    py = torch.as_tensor((ys + rng.random(ys.size)).astype(np.float32))
    z = torch.zeros_like(px)
    cam = camera.generate_rays(px, py, z, z, z)
    parts = [(cam.origin.numpy(), cam.direction.numpy())]
    parts += [_rays_at(scene.geometry, q, rng, 500) for q in range(scene.geometry.num_quadrics)]
    o = np.concatenate([p[0] for p in parts])
    d = np.concatenate([p[1] for p in parts])
    jr = JRay.make(jnp.asarray(o), jnp.asarray(d))
    tr = TRay.make(torch.as_tensor(o), torch.as_tensor(d))
    jg, tg = jb.scene.geometry, scene.geometry
    hj, ht = jisect.intersect(jg, jr), tisect.intersect(tg, tr)
    return jg, tg, jr, tr, hj, ht


def test_closest_hits_match_jax(hits):
    """Closest hits over triangles and all quadrics: prim ids equal on
    ≥ 99.9% of rays, t / u / v where both agree; every quadric is hit."""
    jg, tg, _, _, hj, ht = hits
    pj, pt = np.asarray(hj.prim), ht.prim.numpy()
    assert (pj == pt).mean() >= 0.999
    same = (pj == pt) & (pt >= 0)
    _close(ht.t.numpy()[same], np.asarray(hj.t)[same])
    _close(torch.stack([ht.b1, ht.b2], -1).numpy()[same],
           np.stack([np.asarray(hj.b1), np.asarray(hj.b2)], -1)[same], UV_TOL)
    T = tg.num_triangles
    assert set(range(T, T + tg.num_quadrics)) <= set(pt.tolist())


def test_shading_geometry_matches_jax(hits):
    """``surface_interaction`` on the same hits: p, normals (each type's
    gradient, faceforwarded triangles), uv, dpdu, ids."""
    jg, tg, jr, tr, hj, ht = hits
    sj, st = j_si(jg, jr, hj), t_si(tg, tr, ht)
    same = (np.asarray(hj.prim) == ht.prim.numpy()) & np.asarray(sj.valid)
    _close(np.concatenate([getattr(st, k).numpy()[same] for k in FIELDS], -1),
           np.concatenate([np.asarray(getattr(sj, k))[same] for k in FIELDS], -1), UV_TOL)
    for k in ("material", "area_light", "mesh_id"):
        np.testing.assert_array_equal(getattr(st, k).numpy()[same],
                                      np.asarray(getattr(sj, k))[same], k)
    typ = tg.quad_type.numpy()
    q = ht.prim.numpy()[same] - tg.num_triangles
    hit_types = set(typ[q[q >= 0]].tolist())
    assert hit_types == set(range(6)), hit_types


def test_intersect_brute_matches_intersect(hits):
    """The port's exhaustive oracle agrees with its traversal."""
    _, tg, _, tr, _, ht = hits
    hb = tisect.intersect_brute(tg, tr)
    assert (hb.prim == ht.prim).float().mean() >= 0.999
    v = (hb.prim == ht.prim) & (ht.prim >= 0)
    np.testing.assert_allclose(hb.t[v].numpy(), ht.t[v].numpy(), rtol=1e-6)
