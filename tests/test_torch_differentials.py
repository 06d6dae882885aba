"""Parity of the port's camera ray differentials and texture footprints
with the JAX package: ``PerspectiveCamera.ray_differentials``, and
``surface_interaction``'s dpdv, dndu, dndv, uv_sigma, uv_major, duvdx and
duvdy from the differentials and from the pixel cone, on the same hits
(the JAX package's), on triangles with and without uv and per-vertex
normals, with degenerate uv, on spheres, in scenes of triangles and
quadrics, triangles alone and quadrics alone, and on grazing lanes, lanes
whose offset ray runs parallel to the hit plane and lanes that miss.

Both sides run eagerly. Tolerances: differentials, footprints and
partials rtol 1e-4, atol 1e-6 on every lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel.intersect import intersect as jintersect
from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.core.interaction import surface_interaction as jsi
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel.intersect import Hit
from pbrt_torch.core import geometry as tgeom
from pbrt_torch.core.interaction import surface_interaction as tsi
from pbrt_torch.interop import scene_from_numpy
from torch_parity_util import jax_scene_arrays, tiny_scene_text

TOL = dict(rtol=1e-4, atol=1e-6)
RES = 24
FIELDS = ("p", "ng", "ns", "uv", "dpdu", "dpdv", "dndu", "dndv", "uv_sigma", "uv_major",
          "duvdx", "duvdy")
#: what the textured scenes add: a checkerboard bound to the floor (so the
#: scene has textures), a bent quad with uv and per-vertex normals, a quad
#: whose uv are all equal (degenerate), and a quad with neither
EXTRA = """
Texture "c" "spectrum" "checkerboard" "float uscale" [4] "float vscale" [4]
AttributeBegin
  Material "matte" "texture Kd" "c"
  Shape "trianglemesh" "point P" [-2.5 -1 -1  -1 -1 -1.5  -1 .8 -1  -2.5 .6 -.4]
    "integer indices" [0 1 2 0 2 3] "float uv" [0 0 2 0 2 3 0 3]
    "normal N" [-.3 .2 -1  .2 0 -1  .1 .3 -1  -.2 .1 -.9]
  Shape "trianglemesh" "point P" [1 -1 -1.2  2.4 -1 -1.2  2.4 .5 -1.6  1 .5 -1.6]
    "integer indices" [0 1 2 0 2 3] "float uv" [.5 .5 .5 .5 .5 .5 .5 .5]
  Shape "trianglemesh" "point P" [-.6 .9 -1.8  .6 .9 -1.8  .6 1.6 -1.4]
    "integer indices" [0 1 2]
AttributeEnd
"""
SPHERES_ONLY = """
LookAt 0 1.5 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
Texture "c" "spectrum" "checkerboard"
Material "matte" "texture Kd" "c"
Shape "sphere" "float radius" [1]
AttributeBegin
  Translate 1.5 0 .5
  Shape "sphere" "float radius" [.6]
AttributeEnd
WorldEnd
"""


def _scene(kind):
    if kind == "quadrics":
        return SPHERES_ONLY
    text = tiny_scene_text(16, 16).replace("WorldBegin", "WorldBegin\n" + EXTRA, 1)
    if kind == "triangles":  # the tiny scene's three spheres dropped
        text = text.replace('Shape "sphere"', 'Shape "trianglemesh" "point P" '
                            '[90 90 90 91 90 90 90 91 90] "integer indices" [0 1 2] #')
    return text


def _rays(cam, rng):
    """Camera rays over a RES² raster, and their differentials; then 64
    grazing rays (2–6°) onto the floor (y = −1) beside the spheres, half of
    them with an x offset ray parallel to it (no solution: zero
    differentials)."""
    n = RES * RES
    ys, xs = np.divmod(np.arange(n), RES)
    px = ((xs + rng.random(n)) * 16 / RES).astype(np.float32)
    py = ((ys + rng.random(n)) * 16 / RES).astype(np.float32)
    z = jnp.zeros(n)
    r = cam.generate_rays(jnp.asarray(px), jnp.asarray(py), z, z, z)
    d = cam.ray_differentials(jnp.asarray(px), jnp.asarray(py), r)
    g = 64
    o = np.stack([rng.uniform(-6, -3, g), np.full(g, -0.5), np.full(g, -0.5)], -1)
    dg = np.stack([rng.uniform(-.1, .1, g), -rng.uniform(3e-2, 1e-1, g), np.ones(g)], -1)
    dg /= np.linalg.norm(dg, axis=-1, keepdims=True)
    rx = dg + np.array([2e-3, 0, 0])
    rx[::2] = [1.0, 0.0, 0.0]  # parallel to the floor
    ry = dg + np.array([0, 1e-4, 0])
    o_all = np.concatenate([np.asarray(r.origin), o]).astype(np.float32)
    d_all = np.concatenate([np.asarray(r.direction), dg]).astype(np.float32)
    diffs = [np.concatenate([np.asarray(a), b]).astype(np.float32)
             for a, b in zip(d, (o, rx, o, ry))]
    return o_all, d_all, diffs


@pytest.fixture(scope="module", params=["mixed", "triangles", "quadrics"])
def setup(request):
    jb = jbuild(jload(_scene(request.param)))
    scene, cam, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    o, d, diffs = _rays(jb.camera, np.random.default_rng(3))
    jr = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d))
    hit = jintersect(jb.scene.geometry, jr)
    th = Hit(*(torch.as_tensor(np.array(a)) for a in (hit.t, hit.prim, hit.b1, hit.b2)))
    tr = tgeom.Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    return dict(kind=request.param, jb=jb, scene=scene, cam=cam, jr=jr, hit=hit, th=th, tr=tr,
                diffs=diffs)


def test_ray_differentials_match_jax(setup):
    s = setup
    rng = np.random.default_rng(4)
    px = rng.uniform(0, 16, 500).astype(np.float32)
    py = rng.uniform(0, 16, 500).astype(np.float32)
    z = np.zeros(500, np.float32)
    jr = s["jb"].camera.generate_rays(*(jnp.asarray(a) for a in (px, py, z, z, z)))
    tr = s["cam"].generate_rays(*(torch.as_tensor(a) for a in (px, py, z, z, z)))
    jd = s["jb"].camera.ray_differentials(jnp.asarray(px), jnp.asarray(py), jr)
    td = s["cam"].ray_differentials(torch.as_tensor(px), torch.as_tensor(py), tr)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    # one pixel over: the offset direction differs from the ray's
    assert (np.linalg.norm(td[1].numpy() - tr.direction.numpy(), axis=-1) > 1e-3).all()


@pytest.mark.parametrize("source", ["diffs", "spread"])
def test_partials_and_footprints_match_jax(setup, source):
    s = setup
    spread = s["jb"].scene.pixel_spread
    assert spread > 0 and s["scene"].pixel_spread == spread
    kw_j = dict(diffs=tuple(jnp.asarray(a) for a in s["diffs"])) if source == "diffs" else \
        dict(spread=spread)
    kw_t = dict(diffs=tuple(torch.as_tensor(a) for a in s["diffs"])) if source == "diffs" else \
        dict(spread=spread)
    a = jsi(s["jb"].scene.geometry, s["jr"], s["hit"], **kw_j)
    b = tsi(s["scene"].geometry, s["tr"], s["th"], partials=True, **kw_t)
    valid = b.valid.numpy()
    assert valid.sum() > 100 and (~valid).sum() > 0
    for f in FIELDS:
        np.testing.assert_allclose(getattr(b, f).numpy()[valid], np.asarray(getattr(a, f))[valid],
                                   err_msg=f, **TOL)
    sig = b.uv_sigma.numpy()
    T = s["scene"].geometry.num_triangles
    is_tri = valid & (s["th"].prim.numpy() < T)
    if s["kind"] != "quadrics":
        assert (sig[is_tri] > 0).mean() > 0.5
    assert (sig[valid & ~is_tri] == 0).all()  # quadrics have no footprint
    if source == "diffs" and s["kind"] != "quadrics":
        graze = np.zeros_like(valid)
        graze[RES * RES::2] = True  # offset x ray parallel to the floor
        assert (b.duvdx.numpy()[graze & valid] == 0).all() and (graze & valid).sum() > 10


def test_no_partials_without_textures(setup):
    """A scene without textures asks for none: the interaction holds the
    untextured fields only."""
    b = tsi(setup["scene"].geometry, setup["tr"], setup["th"])
    assert all(getattr(b, f) is None for f in FIELDS[5:])
