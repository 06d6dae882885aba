"""Parity of the port's refined shapes and quadric area lights with the JAX
package.

- ``heightfield`` (``shapes/mesh.py:make_heightfield``), ``loopsubdiv``
  (``shapes/loopsubdiv.py``) and ``nurbs`` (``shapes/nurbs.py``) are host
  numpy in both packages: positions, indices, normals and uvs equal bit
  for bit, and so are the builders' triangle tables, wide rows, area-light
  rows and motion deltas of scenes that use them.
- ROADMAP Queue 3, fact 2, copied: every quadric's area light has shape
  kind 1, so ``sample_li`` samples a sphere of radius ``quad_params[0]``,
  a disk's included (``goldens/bunny.pbrt``'s light). The port's
  ``sample_li`` on a disk light equals the JAX package's on every lane:
  wi, L and the distance within rtol / atol 1e-5, as the light tests hold
  them (XLA contracts multiply-adds into FMA on the CPU, the port rounds
  each operation), and the cone pdf 1 / (2π (1 − cos θmax)) within rtol
  1e-4: for a sphere of radius .25 seen from 2–3 units 1 − cos θmax is
  ~4e-3, so an ulp of cos θmax (6e-8) is 1.5e-5 of it (2.7e-5 seen).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.lights import table as jlt
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_tpu.scene.paramset import ParamSet as JParams
from pbrt_tpu.shapes import loopsubdiv as jloop
from pbrt_tpu.shapes import mesh as jmesh
from pbrt_tpu.shapes import nurbs as jnurbs
from pbrt_torch.lights import table as tlt
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from pbrt_torch.scene.paramset import ParamSet as TParams
from pbrt_torch.shapes import loopsubdiv as tloop
from pbrt_torch.shapes import mesh as tmesh
from pbrt_torch.shapes import nurbs as tnurbs
from tests.torch_parity_util import tiny_scene_text

TRI_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2", "tri_uv0",
              "tri_uv1", "tri_uv2", "tri_material", "tri_area_light", "tri_mesh_id")
LIGHT_FIELDS = ("type", "shape_kind", "quad_idx", "tri_start", "tri_count", "cdf_offset",
                "total_area", "tri_cdf")


def _params(entries):
    """The same parameters as the JAX package's and the port's ParamSet."""
    out = []
    for cls in (JParams, TParams):
        p = cls()
        for ptype, name, values in entries:
            p.add(ptype, name, list(values))
        out.append(p)
    return out


def _o2w(seed):
    rng = np.random.default_rng(seed)
    m = np.eye(4)
    m[:3, :3] = rng.normal(size=(3, 3)) * 0.7 + np.eye(3)
    m[:3, 3] = rng.normal(size=3)
    return m


def _assert_mesh_equal(a, b):
    for k in ("positions", "indices", "normals", "uvs"):
        x, y = getattr(a, k), getattr(b, k)
        if x is None:
            assert y is None, k
            continue
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=k)
        assert np.asarray(y).dtype == np.asarray(x).dtype, k


@pytest.mark.parametrize("nu,nv,reverse", [(4, 3, False), (9, 17, True), (2, 2, False)])
def test_heightfield_equals_jax(nu, nv, reverse):
    z = np.random.default_rng(nu * nv).uniform(-0.5, 0.5, nu * nv)
    jp, tp = _params([("integer", "nu", [nu]), ("integer", "nv", [nv]), ("float", "Pz", z)])
    m = _o2w(nu)
    _assert_mesh_equal(jmesh.make_heightfield(jp, m, reverse),
                       tmesh.make_heightfield(tp, m, reverse))


def _control_mesh(kind):
    """A closed octahedron, or an open grid patch with boundary edges."""
    if kind == "closed":
        P = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], float)
        F = [0, 2, 4, 2, 1, 4, 1, 3, 4, 3, 0, 4, 2, 0, 5, 1, 2, 5, 3, 1, 5, 0, 3, 5]
        return P, F
    rng = np.random.default_rng(2)
    ys, xs = np.mgrid[0:4, 0:5]
    P = np.stack([xs.ravel(), ys.ravel(), rng.uniform(0, 0.4, 20)], -1).astype(float)
    F = []
    for y in range(3):
        for x in range(4):
            a = y * 5 + x
            F += [a, a + 1, a + 6, a, a + 6, a + 5]
    return P, F


@pytest.mark.parametrize("kind,nlevels,reverse", [("closed", 0, False), ("closed", 2, False),
                                                  ("open", 1, True), ("open", 3, False)])
def test_loopsubdiv_equals_jax(kind, nlevels, reverse):
    P, F = _control_mesh(kind)
    jp, tp = _params([("integer", "nlevels", [nlevels]), ("point", "P", P.ravel()),
                      ("integer", "indices", F)])
    m = _o2w(7)
    a = jloop.refine_loopsubdiv(jp, m, reverse)
    b = tloop.refine_loopsubdiv(tp, m, reverse)
    _assert_mesh_equal(a, b)
    assert len(b.indices) == len(F) // 3 * 4 ** nlevels
    np.testing.assert_array_equal(tmesh.compute_vertex_normals(b), jmesh.compute_vertex_normals(a))


def _nurbs_entries(case):
    if case == "bilinear":
        return [("integer", "nu", [2]), ("integer", "uorder", [2]),
                ("float", "uknots", [0, 0, 1, 1]), ("integer", "nv", [2]),
                ("integer", "vorder", [2]), ("float", "vknots", [0, 0, 1, 1]),
                ("point", "P", [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0])]
    if case == "rational":  # a quarter circle, extruded
        s = np.sqrt(2.0) / 2.0
        arc = [(1, 0, 0, 1), (s, s, 0, s), (0, 1, 0, 1)]
        Pw = arc + [(x, y, w, w) for (x, y, z, w) in arc]
        return [("integer", "nu", [3]), ("integer", "uorder", [3]),
                ("float", "uknots", [0, 0, 0, 1, 1, 1]), ("integer", "nv", [2]),
                ("integer", "vorder", [2]), ("float", "vknots", [0, 0, 1, 1]),
                ("float", "Pw", np.ravel(Pw))]
    rng = np.random.default_rng(4)  # a cubic 5 × 4 patch, a sub-range of u
    P = np.stack(np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 4)), -1).reshape(-1, 2)
    P = np.concatenate([P, rng.uniform(0, 0.3, (20, 1))], 1)
    return [("integer", "nu", [5]), ("integer", "uorder", [4]),
            ("float", "uknots", [0, 0, 0, 0, 0.5, 1, 1, 1, 1]), ("integer", "nv", [4]),
            ("integer", "vorder", [3]), ("float", "vknots", [0, 0, 0, 0.4, 1, 1, 1]),
            ("point", "P", P.ravel()), ("float", "u0", [0.1]), ("float", "u1", [0.9])]


@pytest.mark.parametrize("case", ["bilinear", "rational", "cubic"])
@pytest.mark.parametrize("reverse", [False, True])
def test_nurbs_equals_jax(case, reverse):
    jp, tp = _params(_nurbs_entries(case))
    m = _o2w(3)
    a, b = jnurbs.refine_nurbs(jp, m, reverse), tnurbs.refine_nurbs(tp, m, reverse)
    _assert_mesh_equal(a, b)
    assert len(b.indices) == 2 * 29 * 29  # the 30 × 30 dice


def refined_scene(extra_world="", accel=""):
    """The tiny scene with a heightfield floor patch, a loop-subdivided
    grid and a cubic NURBS patch, each in its own material."""
    P, F = _control_mesh("open")
    nurbs = " ".join(f'"{t} {n}" [{" ".join(f"{v:g}" for v in vals)}]'
                     for t, n, vals in _nurbs_entries("cubic"))
    z = " ".join(f"{v:.4g}" for v in np.random.default_rng(5).uniform(0, 0.3, 36))
    shapes = f"""
AttributeBegin
  Material "matte" "color Kd" [.3 .5 .3]
  Translate -3 -1 -2
  Rotate -90 1 0 0
  Scale 6 6 1
  Shape "heightfield" "integer nu" [6] "integer nv" [6] "float Pz" [{z}]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [.5 .3 .2] "color Ks" [.3 .3 .3]
  Translate -2.5 -.5 1
  Scale .5 .5 .5
  Shape "loopsubdiv" "integer nlevels" [2] "point P" [{" ".join(f"{v:g}" for v in P.ravel())}]
    "integer indices" [{" ".join(map(str, F))}]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [.2 .3 .6]
  Translate .8 -.8 .5
  Scale 1.5 1.5 1.5
  Shape "nurbs" {nurbs}
AttributeEnd
{extra_world}
"""
    text = tiny_scene_text(16, 16, spp=1, max_depth=2)
    if accel:
        text = text.replace("WorldBegin", accel + "\nWorldBegin", 1)
    return text.replace("WorldEnd", shapes + "WorldEnd")


def _builds(text):
    return jbuild(jload(text)), tbuild(tload(text), device="cpu")


@pytest.mark.parametrize("accel", ["", 'Accelerator "kdtree"', 'Accelerator "grid"'])
def test_builder_tables_equal_jax(accel):
    """The triangle tables of a scene with all three refined shapes, and
    its wide rows or its kd / grid arrays, equal the JAX builder's."""
    jb, tb = _builds(refined_scene(accel=accel))
    jg, tg = jb.scene.geometry, tb.scene.geometry
    assert tg.num_triangles > 500
    for k in TRI_FIELDS:
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)),
                                      err_msg=k)
    if tg.accel_kind == "bvh":
        np.testing.assert_array_equal(tg.wide_rows.numpy(), np.asarray(jg.wide_rows))
    elif tg.accel_kind == "kdtree":
        np.testing.assert_array_equal(tg.kd_prim_ids.numpy(), np.asarray(jg.kd_prim_ids))
    else:
        np.testing.assert_array_equal(tg.grid_ids.numpy(), np.asarray(jg.grid_ids))


def test_refined_shapes_animated_and_instanced_equal_jax():
    """A moving NURBS patch (its shutter-end deltas) and a loop-subdivided
    object used twice through ObjectInstance (one shared copy and table)."""
    P, F = _control_mesh("closed")
    nurbs = " ".join(f'"{t} {n}" [{" ".join(f"{v:g}" for v in vals)}]'
                     for t, n, vals in _nurbs_entries("bilinear"))
    extra = f"""
AttributeBegin
  Translate 0 1 1
  ActiveTransform EndTime
  Translate .3 0 0
  ActiveTransform All
  Shape "nurbs" {nurbs}
AttributeEnd
ObjectBegin "subd"
  Shape "loopsubdiv" "integer nlevels" [1] "point P" [{" ".join(f"{v:g}" for v in P.ravel())}]
    "integer indices" [{" ".join(map(str, F))}]
ObjectEnd
AttributeBegin
  Translate -1 0 -1
  ObjectInstance "subd"
  Translate 2 0 0
  ObjectInstance "subd"
AttributeEnd
"""
    jb, tb = _builds(refined_scene(extra))
    jg, tg = jb.scene.geometry, tb.scene.geometry
    for k in TRI_FIELDS + ("tri_motion", "tri_n_motion", "wide_rows", "wide_motion",
                           "inst_rows", "inst_w2o", "inst_root"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)),
                                      err_msg=k)
    assert tg.num_instances == 2 and tg.tri_motion.abs().sum() > 0


@pytest.fixture(scope="module")
def light_builds():
    """Area lights on a heightfield, a disk (``goldens/bunny.pbrt``'s: a
    disk of radius .25 turned to face down) and a cone, beside a point
    light."""
    extra = """
LightSource "point" "rgb I" [.7 .7 .7] "point from" [0 3 -3]
AttributeBegin
  AreaLightSource "area" "rgb L" [4 4 4]
  Translate -1 2.5 0
  Rotate 90 1 0 0
  Shape "heightfield" "integer nu" [3] "integer nv" [3] "float Pz" [0 .1 0 .1 .2 .1 0 .1 0]
AttributeEnd
AttributeBegin
  AreaLightSource "area" "rgb L" [15 15 15] "integer nsamples" [4]
  Translate 0 2 0
  Rotate 90 1 0 0
  Shape "disk" "float radius" [.25]
AttributeEnd
AttributeBegin
  AreaLightSource "area" "rgb L" [2 2 2]
  Translate 1.5 1.5 1
  Shape "cone" "float radius" [.3] "float height" [.5]
AttributeEnd
"""
    return _builds(refined_scene(extra))


def test_quadric_and_refined_area_light_rows_equal_jax(light_builds):
    """Every area light gets the JAX builder's row: the heightfield's its
    triangle range and area CDF, the disk's and the cone's shape kind 1
    (a sphere) and their quadric's index."""
    jb, tb = light_builds
    jl, tl = jb.scene.lights, tb.scene.lights
    for k in LIGHT_FIELDS:
        np.testing.assert_array_equal(getattr(tl, k).numpy(), np.asarray(getattr(jl, k)), err_msg=k)
    kinds = tl.shape_kind[tl.area_row0:].tolist()
    # the tiny scene's sphere light, the heightfield, the disk, the cone
    assert kinds == [tlt.SHAPE_SPHERE, tlt.SHAPE_MESH, tlt.SHAPE_SPHERE, tlt.SHAPE_SPHERE]
    q = tl.quad_idx[tl.area_row0 + 2:].tolist()
    assert tb.scene.geometry.quad_type[q].tolist() == [2, 3]  # disk, cone


def test_fact2_disk_light_samples_a_sphere_in_both_packages(light_builds):
    """``sample_li`` on the disk light: the same wi, L, pdf and distance in
    both packages, and the samples leave the disk's plane, on the sphere
    of its radius about its centre (the JAX package's rule, copied)."""
    jb, tb = light_builds
    tl, tg = tb.scene.lights, tb.scene.geometry
    row = tl.area_row0 + 2
    n = 2000
    rng = np.random.default_rng(3)
    p = rng.uniform([-2, -1, -2], [2, 1.5, 2], (n, 3)).astype(np.float32)
    u1, u2 = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    # the JAX package reads row si.area_light of its table (fact 1); for
    # sample_li the row is given, the same in both
    lj = jlt.sample_li(jb.scene.lights, jb.scene.geometry, jnp.full(n, row, jnp.int32),
                       jnp.asarray(p), jnp.asarray(u1), jnp.asarray(u2))
    lt = tlt.sample_li(tl, tg, torch.full((n,), row, dtype=torch.int64), torch.as_tensor(p),
                       torch.as_tensor(u1), torch.as_tensor(u2))
    for k, rtol in (("wi", 1e-5), ("L", 1e-5), ("pdf", 1e-4), ("dist", 1e-5)):
        np.testing.assert_allclose(getattr(lt, k).numpy(), np.asarray(getattr(lj, k)),
                                   rtol=rtol, atol=1e-5, err_msg=k)
    hit = (p + lt.wi.numpy() * lt.dist.numpy()[:, None]) - np.array([0, 2, 0])
    r = np.linalg.norm(hit, axis=-1)
    np.testing.assert_allclose(r, 0.25, rtol=1e-3)
    assert np.abs(hit[:, 1]).max() > 0.2  # off the disk's plane: a sphere


def test_refined_scene_renders(light_builds):
    """The scene with refined shapes and quadric lights renders on the CPU:
    finite, non-empty, the disk light lit."""
    from pbrt_torch.renderers.sampler import render

    film = render(light_builds[1], spp=1, seed=0, chunk_pixels=256)
    assert torch.isfinite(film.pixels).all() and float(film.pixels.sum()) > 0
