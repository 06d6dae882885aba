"""Parity of the port's accelerators with the JAX package: the kd-tree and
grid builds (``pbrt_torch/accel/kdtree.py``, ``grid.py``) and the BVH's
``middle`` / ``equal`` splits bit for bit, the plain kd and grid walks
(``accel/traverse_kd.py``) against the JAX package's ``_traverse_kd_one``
/ ``_traverse_grid_one`` (through its ``intersect``) on fuzzed rays over
triangles and all six quadrics, static and in motion, closest and any
hit, and on ``chip_smoke.tie_scene_text``'s ties (every lane, bit for
bit), ``aggregatetest``'s count in both packages, and one
``render(seed)`` per accelerator.

Tolerances: the builds are host numpy in both packages, so their arrays
are equal bit for bit. The walks agree on hit or miss and on the prim
except where two prims' t tie to within XLA's fused multiply-adds (the
JAX side's floats differ from the port's by ulps, more where a sum
cancels): ≥ 99.8% of lanes, t within rtol 2e-5 and b1 / b2 within 2e-4
where the prims agree. A disk's v is (z − zmin) / max(zmax − zmin, 1e-9)
with zmin = zmax, so it is rounding noise over 1e-9 in both packages and
is not compared.
"""

import pathlib
from unittest import mock

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import bvh as jbvh
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.accel.grid import build_grid as j_build_grid
from pbrt_tpu.accel.kdtree import build_kdtree as j_build_kdtree
from pbrt_tpu.accel.wide import LEAF_TRIS, build_wide_bvh as j_build_wide
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.renderers import aggregatetest as jagg
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import bvh as tbvh
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.accel import traverse_kd as tk
from pbrt_torch.accel.grid import build_grid as t_build_grid
from pbrt_torch.accel.kdtree import build_kdtree as t_build_kdtree
from pbrt_torch.accel.wide import build_wide_bvh as t_build_wide
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.renderers import aggregatetest as tagg
from pbrt_torch.renderers.dispatch import render_scene
from pbrt_torch.renderers.sampler import render as t_render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from tests.torch_parity_util import tiny_scene_text

KD_FIELDS = ("node_split", "node_axis", "node_above", "node_prim_off", "node_prim_cnt",
             "prim_ids", "world_lo", "world_hi")
GRID_FIELDS = ("voxel_off", "voxel_cnt", "prim_ids", "world_lo", "world_hi")
BVH_FIELDS = ("node_lo", "node_hi", "node_second", "node_count", "node_axis", "prim_order")


def _boxes(seed, n, spread=0.15):
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1, 1, (n, 1, 3)) + rng.uniform(-spread, spread, (n, 3, 3))
    return tris.min(axis=1), tris.max(axis=1)


def _soup_text(seed=7, n=240):
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-2, 2, (n, 1, 3)) + rng.uniform(-0.3, 0.3, (n, 3, 3))).reshape(-1, 3)
    return ('Shape "trianglemesh" "point P" [' + " ".join(f"{v:.6g}" for v in tris.ravel())
            + '] "integer indices" [' + " ".join(map(str, range(3 * n))) + "]\n")


#: every quadric type (clipped by phimax, zmin / zmax, an inner radius),
#: a heightfield and a triangle soup, small enough for a tier-1 walk
QUADRICS_SCENE = """
LookAt 0 1.5 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Accelerator "@ACC@" @PARAMS@
WorldBegin
AttributeBegin
  Translate 0 4 0
  AreaLightSource "area" "rgb L" [12 12 12]
  Shape "disk" "float radius" [.6] "float innerradius" [.1]
AttributeEnd
@SOUP@
Shape "sphere" "float radius" [1] "float zmin" [-.5] "float zmax" [.8] "float phimax" [270]
Translate 2 0 0
Rotate 30 1 1 0
Shape "cylinder" "float radius" [.5] "float zmin" [-.5] "float zmax" [.5] "float phimax" [300]
Translate -4 0 0
Shape "cone" "float radius" [.5] "float height" [1] "float phimax" [200]
Translate 0 0 2
Shape "paraboloid" "float radius" [.5] "float zmin" [0] "float zmax" [1]
Translate 2 0 0
Shape "hyperboloid" "float zmin" [-.5] "float zmax" [.5] "float phimax" [330]
Translate 0 1 2
Shape "heightfield" "integer nu" [4] "integer nv" [3]
  "float Pz" [0 .1 .2 .1 0 .3 .2 0 .1 .1 .2 0]
Shape "disk" "float radius" [2] "float height" [1]
Translate 1 -1 -3
Shape "sphere" "float radius" [.3]
WorldEnd
"""


def quadrics_scene(acc, params=""):
    return (QUADRICS_SCENE.replace("@ACC@", acc).replace("@PARAMS@", params)
            .replace("@SOUP@", _soup_text()))


def spheres_scene(acc):
    """The soup with three spheres, one of them clipped: the any-hit walk's
    scene (one quadric type keeps the JAX side's compile short)."""
    return f"""
LookAt 0 1.5 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Accelerator "{acc}"
WorldBegin
{_soup_text(11, 200)}
Shape "sphere" "float radius" [1] "float zmin" [-.5] "float zmax" [.8] "float phimax" [270]
Translate 1.5 .5 0
Shape "sphere" "float radius" [.6]
Translate -3 0 .5
Shape "sphere" "float radius" [.4]
WorldEnd
"""


def motion_scene(acc):
    """A small moving mesh (its shutter-end a translation) and a static
    one, under ``acc``."""
    P = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0], [0, 0, 1.2]], np.float32)
    idx = "0 1 4 1 2 4 2 3 4 3 0 4"
    mesh = ('Shape "trianglemesh" "point P" [' + " ".join(f"{v:g}" for v in P.ravel())
            + f'] "integer indices" [{idx}]\n')
    return f"""
LookAt 0 -6 2  0 0 0  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Accelerator "{acc}"
WorldBegin
Shape "sphere" "float radius" [.4]
AttributeBegin
  Translate -1.5 0 0
  ActiveTransform EndTime
  Translate .8 .3 .2
  ActiveTransform All
  {mesh}
AttributeEnd
AttributeBegin
  Translate 1.5 0 0
  {mesh}
  Translate 0 1 0
  {_soup_text(3, 60)}
AttributeEnd
WorldEnd
"""


def _builds(text):
    return jbuild(jload(text)), tbuild(tload(text), device="cpu")


def _rays(lo, hi, n, seed):
    o, d = tagg.aggregate_test_rays(lo, hi, n, seed)
    return o, d


def _aimed_rays(built_t, n, seed):
    """Rays from the scene's box aimed at points near each quadric's
    centre, so every quadric type is hit often."""
    g = built_t.scene.geometry
    rng = np.random.default_rng(seed)
    centres = g.quad_o2w[:, :3, 3].numpy()
    lo, hi = g.world_lo.numpy(), g.world_hi.numpy()
    o = lo + rng.uniform(0, 1, (n, 3)) * (hi - lo)
    target = centres[rng.integers(0, len(centres), n)] + rng.normal(size=(n, 3)) * 0.5
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _compare_hits(jh, th, T, quad_type, min_agree=0.998, min_hits=0.02):
    jp, tp = np.asarray(jh.prim), th.prim.numpy()
    jt, tt = np.asarray(jh.t), th.t.numpy()
    assert (jp >= 0).mean() > min_hits
    agree = jp == tp
    assert agree.mean() >= min_agree, agree.mean()
    hit = agree & (tp >= 0)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=2e-5)
    np.testing.assert_allclose(th.b1.numpy()[hit], np.asarray(jh.b1)[hit], atol=2e-4)
    disk = np.zeros_like(hit)
    q = tp >= T
    disk[q] = quad_type[tp[q] - T] == tisect.DISK
    v = hit & ~disk
    np.testing.assert_allclose(th.b2.numpy()[v], np.asarray(jh.b2)[v], atol=2e-4)
    return agree


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(seed=1, n=300), dict(seed=2, n=1000, max_prims=2, isect_cost=40.0),
    dict(seed=3, n=64, trav_cost=3.0, empty_bonus=0.2), dict(seed=4, n=1)])
def test_kdtree_build_equals_jax(case):
    case = dict(case)
    lo, hi = _boxes(case.pop("seed"), case.pop("n"))
    a, b = j_build_kdtree(lo, hi, **case), t_build_kdtree(lo, hi, **case)
    for k in KD_FIELDS:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
        assert getattr(b, k).dtype == getattr(a, k).dtype, k


@pytest.mark.parametrize("seed,n,spread", [(1, 300, 0.15), (2, 2000, 0.02), (3, 50, 1.5),
                                           (4, 1, 0.1)])
def test_grid_build_equals_jax(seed, n, spread):
    lo, hi = _boxes(seed, n, spread)
    a, b = j_build_grid(lo, hi), t_build_grid(lo, hi)
    assert a.dims == b.dims
    for k in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


@pytest.mark.parametrize("method", ["middle", "equal"])
@pytest.mark.parametrize("seed", [5, 6])
def test_bvh_split_and_wide_rows_equal_jax(method, seed):
    """The binary tree of each split and the wide rows collapsed from it,
    with the degenerate (coincident-centroid) case in the mix."""
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-1, 1, (400, 1, 3)) + rng.uniform(-0.1, 0.1, (400, 3, 3))).astype(
        np.float32)
    tris[:20] = tris[0]  # twenty copies of one triangle
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    lo, hi = tris.min(1), tris.max(1)
    a = jbvh.build_bvh(lo, hi, method=method, max_prims_in_node=LEAF_TRIS)
    b = tbvh.build_bvh(lo, hi, max_prims_in_node=LEAF_TRIS, method=method)
    for k in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    wa, wb = j_build_wide(a, v0, e1, e2), t_build_wide(b, v0, e1, e2)
    np.testing.assert_array_equal(wb.rows, wa.rows)
    assert wb.max_stack == wa.max_stack


@pytest.mark.parametrize("acc,params", [
    ("kdtree", ""), ("kdtreeaccel", '"integer maxprims" [2] "float intersectcost" [30]'),
    ("grid", ""), ("bvh", '"string splitmethod" "middle"'),
    ("bvh", '"string splitmethod" "equal"')])
def test_scene_build_equals_jax(acc, params):
    """The builders attach the same arrays: the kd / grid tables over every
    primitive (quadrics included) and the scene bound, or the wide rows of
    a middle / equal tree."""
    jb, tb = _builds(quadrics_scene(acc, params))
    jg, tg = jb.scene.geometry, tb.scene.geometry
    np.testing.assert_array_equal(tg.world_lo.numpy(), np.asarray(jg.world_lo))
    np.testing.assert_array_equal(tg.world_hi.numpy(), np.asarray(jg.world_hi))
    assert tg.accel_kind == jg.accel_kind
    if acc == "bvh":
        np.testing.assert_array_equal(tg.wide_rows.numpy(), np.asarray(jg.wide_rows))
        assert tg.wide_stack == jg.wide_stack
        return
    assert tg.wide_rows is None and jg.wide_rows is None
    names = (("kd_split", "kd_axis", "kd_above", "kd_prim_off", "kd_prim_cnt", "kd_prim_ids")
             if tg.accel_kind == "kdtree" else ("grid_off", "grid_cnt", "grid_ids"))
    for k in names:
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)), err_msg=k)
    if tg.accel_kind == "grid":
        assert tg.grid_dims == tuple(jg.grid_dims)
    ids = (tg.kd_prim_ids if tg.accel_kind == "kdtree" else tg.grid_ids).numpy()
    assert ids.max() >= tg.num_triangles  # quadrics live in the leaves


def test_unknown_accelerator_and_split_fall_back_to_the_sah_bvh():
    """An accelerator or a BVH split method the JAX package does not know
    builds its SAH BVH there (builder.py:525-545) and in the port: the
    wide rows of the default build, bit for bit, in both."""
    plain = tbuild(tload(tiny_scene_text(4, 4)), device="cpu").scene.geometry
    for line in ('Accelerator "qbvh"', 'Accelerator "bvh" "string splitmethod" "hlbvh"'):
        text = tiny_scene_text(4, 4).replace("WorldBegin", line + "\nWorldBegin", 1)
        g = tbuild(tload(text), device="cpu").scene.geometry
        assert g.accel_kind == "bvh"
        np.testing.assert_array_equal(g.wide_rows.numpy(), plain.wide_rows.numpy())
        np.testing.assert_array_equal(g.wide_rows.numpy(),
                                      np.asarray(jbuild(jload(text)).scene.geometry.wide_rows))


def test_instances_flatten_under_kdtree_and_grid():
    """Under a kd-tree or grid every ObjectInstance is flattened (the JAX
    package's accel_is_bvh), so there is no instance table."""
    head = tiny_scene_text(4, 4)
    obj = ('ObjectBegin "tri"\nShape "trianglemesh" "point P" [0 0 0 1 0 0 0 1 0] '
           '"integer indices" [0 1 2]\nObjectEnd\n'
           'Translate 0 0 1\nObjectInstance "tri"\nTranslate 0 0 1\nObjectInstance "tri"\n')
    for acc, inst in (("bvh", True), ("kdtree", False), ("grid", False)):
        text = head.replace("WorldBegin", f'Accelerator "{acc}"\nWorldBegin', 1).replace(
            "WorldEnd", obj + "WorldEnd")
        jb, tb = _builds(text)
        assert (tb.scene.geometry.inst_rows is not None) == inst
        assert (jb.scene.geometry.inst_rows is not None) == inst
        assert tb.scene.geometry.num_triangles == jb.scene.geometry.num_triangles


# ---------------------------------------------------------------------------
# walks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quadric_builds():
    return {acc: _builds(quadrics_scene(acc)) for acc in ("kdtree", "grid")}


def _walk_case(jb, tb, o, d, any_hit):
    """Both packages' ``intersect`` on the rays (o, d); any-hit on segments
    that end at half or 1.5 times the port's closest hit."""
    tg = tb.scene.geometry
    tray = TRay.make(torch.as_tensor(o), torch.as_tensor(d))
    tmax = None
    if any_hit:
        tc = tisect.intersect(tg, tray)
        scale = np.where(np.random.default_rng(5).uniform(size=len(o)) < 0.5, 0.5, 1.5)
        tmax = np.where(np.isfinite(tc.t.numpy()), tc.t.numpy() * scale, 1e30).astype(np.float32)
        tray = TRay.make(torch.as_tensor(o), torch.as_tensor(d), tmax=torch.as_tensor(tmax))
    th = tisect.intersect(tg, tray, any_hit=any_hit)
    jray = JRay.make(jnp.asarray(o), jnp.asarray(d),
                     tmax=None if tmax is None else jnp.asarray(tmax))
    jh = jisect.intersect(jb.scene.geometry, jray, any_hit=any_hit)
    return th, jh, tray


@pytest.mark.parametrize("acc", ["kdtree", "grid"])
def test_walk_matches_jax(quadric_builds, acc):
    """Closest hit: fuzzed rays (the aggregatetest draws) and rays aimed at
    the quadrics; every quadric type is hit, and the port's walk equals its
    own brute force."""
    jb, tb = quadric_builds[acc]
    tg = tb.scene.geometry
    o1, d1 = _rays(tg.world_lo.numpy(), tg.world_hi.numpy(), 1500, seed=3)
    o2, d2 = _aimed_rays(tb, 1500, seed=4)
    th, jh, tray = _walk_case(jb, tb, np.concatenate([o1, o2]), np.concatenate([d1, d2]), False)
    qt = tg.quad_type.numpy()
    agree = _compare_hits(jh, th, tg.num_triangles, qt)
    tp = th.prim.numpy()
    hit_q = agree & (tp >= tg.num_triangles)
    assert set(qt[tp[hit_q] - tg.num_triangles].tolist()) == set(range(6))
    hb = tisect.intersect_brute(tg, tray)
    assert torch.equal(th.prim, hb.prim) and torch.equal(th.t, hb.t)


@pytest.mark.parametrize("acc", ["kdtree", "grid"])
def test_any_hit_walk_matches_jax(acc):
    """Any hit: the walk ends after the leaf or voxel of its first hit, in
    both packages, so the hits (that leaf's nearest) agree too."""
    jb, tb = _builds(spheres_scene(acc))
    tg = tb.scene.geometry
    o, d = _rays(tg.world_lo.numpy(), tg.world_hi.numpy(), 3000, seed=8)
    th, jh, _ = _walk_case(jb, tb, o, d, True)
    _compare_hits(jh, th, tg.num_triangles, tg.quad_type.numpy())
    assert (th.prim.numpy() >= tg.num_triangles).any()


@pytest.fixture(scope="module")
def motion_builds():
    return {acc: _builds(motion_scene(acc)) for acc in ("kdtree", "grid")}


@pytest.mark.parametrize("acc", ["kdtree", "grid"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_walk_matches_jax(motion_builds, acc, any_hit):
    """Rays at their own shutter times: each triangle lerped by the ray's
    weight in both packages."""
    jb, tb = motion_builds[acc]
    tg = tb.scene.geometry
    assert tg.has_motion and tg.tri_motion.abs().sum() > 0
    o, d = _rays(tg.world_lo.numpy(), tg.world_hi.numpy(), 2500, seed=6)
    time_ = np.random.default_rng(7).uniform(size=len(o)).astype(np.float32)
    tmax = None
    if any_hit:
        tc = tisect.intersect(tg, TRay.make(torch.as_tensor(o), torch.as_tensor(d),
                                            time=torch.as_tensor(time_)))
        scale = np.where(np.random.default_rng(8).uniform(size=len(o)) < 0.5, 0.5, 1.5)
        tmax = np.where(np.isfinite(tc.t.numpy()), tc.t.numpy() * scale, 1e30).astype(np.float32)
    th = tisect.intersect(tg, TRay.make(torch.as_tensor(o), torch.as_tensor(d),
                                        tmax=None if tmax is None else torch.as_tensor(tmax),
                                        time=torch.as_tensor(time_)), any_hit=any_hit)
    jh = jisect.intersect(jb.scene.geometry, JRay.make(
        jnp.asarray(o), jnp.asarray(d), tmax=None if tmax is None else jnp.asarray(tmax),
        time=jnp.asarray(time_)), any_hit=any_hit)
    _compare_hits(jh, th, tg.num_triangles, tg.quad_type.numpy())
    if not any_hit:
        hb = tisect.intersect_brute(tg, TRay.make(torch.as_tensor(o), torch.as_tensor(d),
                                                  time=torch.as_tensor(time_)))
        assert torch.equal(th.prim, hb.prim) and torch.equal(th.t, hb.t)


TIE_RAYS = 3000


def _opt(x, conv):
    return None if x is None else conv(x)


@pytest.fixture(scope="module")
def tie_builds():
    """{(accelerator, motion): (JAX build, port build, the rays' times or
    None, the port's closest hits)} on ``chip_smoke.tie_rays``: the closest
    hits are walked once, for the closest-hit case and the any-hit case's
    segments alike."""
    o, d, tm = chip_smoke.tie_rays(TIE_RAYS, seed=0)
    out = {}
    for acc in ("kdtree", "grid"):
        for motion in (False, True):
            jb, tb = _builds(chip_smoke.tie_scene_text(acc, motion))
            time_ = tm if motion else None
            closest = tisect.intersect(tb.scene.geometry, TRay.make(
                torch.as_tensor(o), torch.as_tensor(d), time=_opt(time_, torch.as_tensor)))
            out[(acc, motion)] = (jb, tb, time_, closest)
    return out


@pytest.mark.parametrize("acc", ["kdtree", "grid"])
@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tie_scene_walk_matches_jax(tie_builds, acc, motion, any_hit):
    """The tie-and-dense scene (``chip_smoke.tie_scene_text``): 70 exact
    copies of one triangle, a cluster of 100 small triangles in planes a
    few ulps apart and a sphere, all in one kd leaf and one grid voxel,
    where a chunked walk that kept the later of equal t or the wrong lane
    would differ. Every coordinate and ray is dyadic, so both packages
    compute each t exactly: the JAX walk and the port's plain walk agree
    on every lane, prim ids equal and t, b1 and b2 bit for bit (b1 / b2 of
    the sphere, atan2 in two libraries, within 1e-6); every hit on the
    copies is on copy 0. Any hit on segments that end 2^-20 past the
    closest hit or 1 past it."""
    jb, tb, time_, closest = tie_builds[(acc, motion)]
    tg = tb.scene.geometry
    T = tg.num_triangles
    group = set(range(chip_smoke.TIE_COPIES + chip_smoke.TIE_CLUSTER)) | {T}
    if acc == "kdtree":
        off, cnt, ids = (x.numpy() for x in (tg.kd_prim_off, tg.kd_prim_cnt, tg.kd_prim_ids))
        cells = [ids[a:a + c] for a, c, ax in zip(off, cnt, tg.kd_axis.numpy()) if ax == 3]
    else:
        off, cnt, ids = (x.numpy() for x in (tg.grid_off, tg.grid_cnt, tg.grid_ids))
        cells = [ids[a:a + c] for a, c in zip(off, cnt)]
    assert any(group <= set(c.tolist()) for c in cells)
    o, d, _ = chip_smoke.tie_rays(TIE_RAYS, seed=0)
    tmax, th = None, closest
    if any_hit:
        past = np.where(np.arange(len(o)) % 2 == 0, 2.0 ** -20, 1.0)
        tc = closest.t.numpy()
        tmax = np.where(np.isfinite(tc), tc + past, 1e30).astype(np.float32)
        th = tisect.intersect(tg, TRay.make(torch.as_tensor(o), torch.as_tensor(d),
                                            tmax=torch.as_tensor(tmax),
                                            time=_opt(time_, torch.as_tensor)), any_hit=True)
    jh = jisect.intersect(jb.scene.geometry, JRay.make(
        jnp.asarray(o), jnp.asarray(d), tmax=_opt(tmax, jnp.asarray),
        time=_opt(time_, jnp.asarray)), any_hit=any_hit)
    tp, jp = th.prim.numpy(), np.asarray(jh.prim)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(th.t.numpy().view(np.int32), np.asarray(jh.t).view(np.int32))
    tri = (tp >= 0) & (tp < T)
    for port, jax_ in ((th.b1, jh.b1), (th.b2, jh.b2)):
        np.testing.assert_array_equal(port.numpy()[tri].view(np.int32),
                                      np.asarray(jax_)[tri].view(np.int32))
        np.testing.assert_allclose(port.numpy()[~tri], np.asarray(jax_)[~tri], atol=1e-6)
    copies = (tp >= 0) & (tp < chip_smoke.TIE_COPIES)
    assert copies.sum() > 100 and (tp[copies] == 0).all()
    assert ((tp >= chip_smoke.TIE_COPIES) & (tp < T)).sum() > 100 and (tp == T).sum() > 10


def test_grid_ray_starting_inside():
    """tests/test_accelerators.py's ray that starts inside the grid: a
    triangle soup and rays from inside it, both packages and brute force."""
    rng = np.random.default_rng(13)
    tris = (rng.uniform(-1, 1, (50, 1, 3)) + rng.uniform(-0.15, 0.15, (50, 3, 3))).reshape(-1, 3)
    text = (tiny_scene_text(4, 4).split("WorldBegin")[0] + 'Accelerator "grid"\nWorldBegin\n'
            + 'Shape "trianglemesh" "point P" [' + " ".join(f"{v:.7g}" for v in tris.ravel())
            + '] "integer indices" [' + " ".join(map(str, range(150))) + "]\nWorldEnd\n")
    jb, tb = _builds(text)
    o = rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tg = tb.scene.geometry
    lo, hi = tg.world_lo.numpy(), tg.world_hi.numpy()
    assert ((o > lo) & (o < hi)).all()
    tray = TRay.make(torch.as_tensor(o), torch.as_tensor(d))
    th = tisect.intersect(tg, tray)
    jh = jisect.intersect(jb.scene.geometry, JRay.make(jnp.asarray(o), jnp.asarray(d)))
    _compare_hits(jh, th, tg.num_triangles, tg.quad_type.numpy())
    hb = tisect.intersect_brute(tg, tray)
    assert torch.equal(th.prim, hb.prim) and torch.equal(th.t, hb.t)


def test_plain_walks_count_their_work(quadric_builds):
    """The plain walks' ``stats`` (the work a bound is reckoned from)
    count what they read, and the dispatch counts each call."""
    for acc, walk in (("kdtree", tk.traverse_kd_plain), ("grid", tk.traverse_grid_plain)):
        tg = quadric_builds[acc][1].scene.geometry
        o, d = _rays(tg.world_lo.numpy(), tg.world_hi.numpy(), 300, seed=9)
        o, d = torch.as_tensor(o), torch.as_tensor(d)
        inv = tisect.make_inv_dir(d)
        stats = {}
        z, inf = torch.zeros(300), torch.full((300,), float("inf"))
        walk(tg, o, d, inv, z, inf, False, stats=stats)
        assert stats["tri_tests"] > 0 and stats["quad_tests"] > 0
        assert 0 < stats["csr_entries"] <= stats["tri_tests"] + stats["quad_tests"]
        assert 0 < stats["tri_rows"] <= tg.num_triangles
        assert 0 < stats["quad_rows"] <= tg.num_quadrics
        assert int(stats["lane_steps"].sum()) == stats["steps"]
        assert stats["nodes" if acc == "kdtree" else "voxels"] > 0
        before = dict(tisect.calls)
        tisect.intersect(tg, TRay.make(o, d))
        assert tisect.calls[acc] == before[acc] + 1


def test_variant_builds_and_launch_with(quadric_builds):
    """The measurement builds of ``csrc/traverse_kd.cu``: each macro of
    ``traverse_kd.VARIANTS`` is one the source reads, and ``launch_with``
    (a given build, no launch counted) takes only CUDA tensors: on the CPU
    it raises instead of walking."""
    src = (pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
           / "traverse_kd.cu").read_text()
    for macros in tk.VARIANTS.values():
        assert all(f"#ifdef {m}\n" in src for m in macros)
    tg = quadric_builds["kdtree"][1].scene.geometry
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.launch_with(None, tg, torch.zeros(2, 3), d, tisect.make_inv_dir(d), torch.zeros(2),
                       torch.full((2,), float("inf")), False)


def test_cpu_walks_never_count_launches(quadric_builds):
    tk.reset_launches()
    tg = quadric_builds["grid"][1].scene.geometry
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    tisect.intersect(tg, TRay.make(o, d))
    assert not any(tk.launches.values())


# ---------------------------------------------------------------------------
# aggregatetest and render(seed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("acc", ["kdtree", "grid", "bvh"])
def test_aggregatetest_count_matches_jax(acc, capsys):
    """The same rays in both packages (the rng draws), the same count: 0
    disagreements, through the ``Renderer "aggregatetest"`` dispatch."""
    text = quadrics_scene(acc).replace(
        "WorldBegin", 'Renderer "aggregatetest" "integer niters" [3000]\nWorldBegin', 1)
    jb, tb = _builds(text)
    tg = tb.scene.geometry
    with mock.patch.object(jagg, "intersect", wraps=jagg.intersect) as spy:
        n_j = jagg.run_aggregate_test(jb, niters=3000)
    jray = spy.call_args.args[1]
    o, d = tagg.aggregate_test_rays(tg.world_lo.numpy(), tg.world_hi.numpy(), 3000, 0)
    np.testing.assert_array_equal(o, np.asarray(jray.origin))
    np.testing.assert_array_equal(d, np.asarray(jray.direction))
    assert render_scene(tb) == []
    assert capsys.readouterr().out.strip() == "[pbrt_torch] aggregatetest: 0 disagreements"
    assert n_j == 0 == tagg.run_aggregate_test(tb, niters=3000)


@pytest.fixture(scope="module")
def seeded_renders():
    """The 16² tiny scene at depth 1 under each accelerator, rendered by
    both packages' render(seed=0, spp=1)."""
    out = {}
    for acc in ("kdtree", "grid"):
        text = tiny_scene_text(16, 16, spp=1, max_depth=1).replace(
            "WorldBegin", f'Accelerator "{acc}"\nWorldBegin', 1)
        jb, tb = _builds(text)
        jf = j_render(jb, spp=1, seed=0, chunk_pixels=256, verbose=False)
        out[acc] = (np.asarray(jf.pixels), t_render(tb, spp=1, seed=0, chunk_pixels=256))
    return out


@pytest.mark.parametrize("acc", ["kdtree", "grid"])
def test_render_seed_matches_jax(seeded_renders, acc):
    """The tolerance of test_torch_film.py::test_render_seed_matches_jax:
    pixels allclose (rtol 1e-4, atol 1e-6) on ≥ 99%, per-bin sums within
    1e-3 relative."""
    pj, tf = seeded_renders[acc]
    pt = tf.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()


def test_accelerators_render_the_bvh_image(seeded_renders):
    """The kd-tree, the grid and the BVH find the same hits, so the three
    images agree up to the order of equal-t ties."""
    text = tiny_scene_text(16, 16, spp=1, max_depth=1)
    pb = t_render(tbuild(tload(text), device="cpu"), spp=1, seed=0,
                  chunk_pixels=256).pixels.numpy()
    for acc in ("kdtree", "grid"):
        pt = seeded_renders[acc][1].pixels.numpy()
        assert np.isclose(pt, pb, rtol=1e-5, atol=1e-7).all(-1).mean() >= 0.99, acc
