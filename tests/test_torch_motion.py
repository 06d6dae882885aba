"""Parity of the port's motion blur with the JAX package: animated
transforms, the wide table's motion rows, traversal and surface
interaction of animated meshes at several ray times, an animated camera,
``render(seed)`` of a 16² motion scene and of
``goldens/anim-killeroos-moving.pbrt`` at 16², and facts 11–13 and 16 of
ROADMAP Queue 3
(shadow rays at time 0, area lights sampled on the start triangles, an
animated quadric at its start transform), each shown on both sides.

Tolerances: XLA's CPU backend contracts ``a*b + c*d`` into FMAs in
compiled code and sums in its own order, while the port rounds every
product and sum as its CUDA kernels do; so hit distances carry rtol 1e-5
(test_torch_intersect's), transforms, rays and shading atol 1e-5 (a few
ulps of values of order 1–10), renders the ≥ 99%-of-pixels rule of
test_torch_film. Host-side arrays built from the same float64 numpy in
the same order (decompositions, deltas, rows) are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.accel import bvh as jbvh
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.accel import wide as jwide
from pbrt_tpu.core import interaction as jinter
from pbrt_tpu.core import transform as jxf
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.lights import table as jlights
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import bvh as tbvh
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.accel import wide as twide
from pbrt_torch.core import interaction as tinter
from pbrt_torch.core import transform as txf
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.integrators import path as tpath
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.lights import table as tlights
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from test_motion_blur import SCENE as MOTION_BLUR_SCENE
from torch_parity_util import jax_integrator_pieces, jax_scene_arrays

#: tests/test_motion_blur.py's scene (a quad swept 2.4 units along x over
#: the shutter) with the lowdiscrepancy sampler the port renders
QUAD = (MOTION_BLUR_SCENE % (0.0, 1.0)).replace('"random"', '"lowdiscrepancy"')


def blob_text(xres=16, integrator='"path" "integer maxdepth" [3]'):
    """A 2,880-triangle blob that moves and turns 200° about y over the
    shutter (its vertices travel along chords), on a static floor, lit by a
    sphere light."""
    P, idx = chip_smoke.blob_mesh(chip_smoke.SMALL_BLOB_FREQ)
    blob = ('Shape "trianglemesh" "point P" [' + " ".join(f"{v:.6g}" for v in P.ravel())
            + '] "integer indices" [' + " ".join(map(str, idx.ravel())) + "]")
    return f"""
LookAt 0 2.5 -5  0 .6 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{xres}]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator {integrator}
WorldBegin
AttributeBegin
  AreaLightSource "area" "rgb L" [6 6 6]
  Translate 1 3.5 -1
  Shape "sphere" "float radius" [.5]
AttributeEnd
Material "matte" "color Kd" [.6 .6 .6]
Shape "trianglemesh" "point P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
  Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.4 .4 .4] "float roughness" [.05]
  ActiveTransform StartTime
  Translate -.8 0 0
  ActiveTransform EndTime
  Translate .8 .4 0
  Rotate 200 0 1 0
  ActiveTransform All
  Scale .02 .02 .02
  Rotate -90 1 0 0
  {blob}
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def scenes():
    """Each scene built by both packages (the port on the CPU)."""
    out = {}
    for name, text in (("quad", QUAD), ("blob", blob_text())):
        out[name] = (jbuild(jload(text)), tbuild(tload(text), device="cpu"))
    return out


# ---------------------------------------------------------------------------
# animated transforms and motion rows
# ---------------------------------------------------------------------------


def _keyframes():
    """Keyframe pairs: a translation, a rotation past 180° (the shorter arc
    is the other way round), a rotation with a scale, and a static pair."""
    m0 = jxf.translate((1, 2, 3)) @ jxf.rotate(10, (0, 1, 0))
    return [
        (jxf.translate((0, 0, 0)), jxf.translate((2, -1, .5))),
        (jxf.rotate(0, (0, 0, 1)), jxf.rotate(250, (0, 0, 1))),
        (m0, jxf.translate((-1, 0, 2)) @ jxf.rotate(120, (1, 1, 0)) @ jxf.scale(2, .5, 1)),
        (m0, m0.copy()),
    ]


@pytest.mark.parametrize("case", range(4))
def test_animated_transform_matches_jax(case):
    """Decomposition bit for bit; interpolate at the shutter's start, middle
    and end and outside it (clamped), atol 1e-5."""
    m0, m1 = _keyframes()[case]
    ja = jxf.AnimatedTransform.from_matrices(m0, m1, 0.25, 1.25)
    ta = txf.AnimatedTransform.from_matrices(m0, m1, 0.25, 1.25)
    for k in ("T", "R", "S", "times", "m_start", "m_end"):
        np.testing.assert_array_equal(getattr(ta, k), np.asarray(getattr(ja, k)), err_msg=k)
    assert ta.is_static == ja.is_static == (case == 3)
    times = np.asarray([0.25, 0.5, 0.75, 1.0, 1.25, -1.0, 3.0], np.float32)
    mj = np.asarray(ja.interpolate(jnp.asarray(times)))
    mt = ta.interpolate(torch.as_tensor(times)).numpy()
    np.testing.assert_allclose(np.broadcast_to(mt, mj.shape), mj, atol=1e-5)
    if case == 1:  # 250° about z slerps the -110° way: halfway is -55°
        np.testing.assert_allclose(mt[2][:3, :3], jxf.rotate(-55, (0, 0, 1))[:3, :3],
                                   atol=1e-5)


@pytest.mark.parametrize("row_base,pid_base", [(0, 0), (37, 1000)])
def test_wide_motion_rows_bit_equal(row_base, pid_base):
    """The rows and motion rows of the same SAH tree, equal to the JAX
    package's bit for bit (node rows' deltas zero), with and without the
    instancing offsets; the stack need at offset 0 too."""
    rng = np.random.default_rng(4)
    tris = (rng.uniform(-1, 1, (300, 1, 3)) + rng.uniform(-.1, .1, (300, 3, 3))).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    dm = rng.normal(size=(300, 9)).astype(np.float32)
    jt = jbvh.build_bvh(tris.min(1), tris.max(1), max_prims_in_node=8)
    tt = tbvh.build_bvh(tris.min(1), tris.max(1), max_prims_in_node=8)
    jw = jwide.build_wide_bvh(jt, v0, e1, e2, tri_motion=dm, row_base=row_base,
                              pid_base=pid_base)
    tw = twide.build_wide_bvh(tt, v0, e1, e2, tri_motion=dm, row_base=row_base,
                              pid_base=pid_base)
    np.testing.assert_array_equal(tw.rows, jw.rows)
    np.testing.assert_array_equal(tw.motion_rows, jw.motion_rows)
    node = np.zeros(len(tw.rows), bool)
    walk = [0]
    while walk:  # the node rows, from the root
        r = walk.pop()
        node[r] = True
        refs = tw.rows[r, 48:56][tw.rows[r, 0:8] <= tw.rows[r, 8:16]].astype(np.int64)
        walk += (refs[refs >= 0] - row_base).tolist()
    assert node.any() and not tw.motion_rows[node].any() and tw.motion_rows.any()
    if row_base == 0:
        assert tw.max_stack == jw.max_stack
    assert twide.build_wide_bvh(tt, v0, e1, e2).max_stack == tw.max_stack


def test_jax_stack_walk_follows_offset_refs():
    """Fact 16: the JAX package's stack need follows a table's offset refs
    unshifted (wide.py:_compute_max_stack), so a table built at a row offset
    past its own length raises; the port shifts them back and gets the
    offset-0 need."""
    rng = np.random.default_rng(4)
    tris = (rng.uniform(-1, 1, (300, 1, 3)) + rng.uniform(-.1, .1, (300, 3, 3))).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    jt = jbvh.build_bvh(tris.min(1), tris.max(1), max_prims_in_node=8)
    tt = tbvh.build_bvh(tris.min(1), tris.max(1), max_prims_in_node=8)
    with pytest.raises(IndexError):
        jwide.build_wide_bvh(jt, v0, e1, e2, row_base=1000)
    assert (twide.build_wide_bvh(tt, v0, e1, e2, row_base=1000).max_stack
            == jwide.build_wide_bvh(jt, v0, e1, e2).max_stack)


@pytest.mark.parametrize("name", ["quad", "blob"])
def test_builder_motion_arrays_match_jax(scenes, name):
    """The builder's motion deltas, interval, world rows (over both
    keyframes' bounds) and motion rows equal the JAX builder's."""
    jb, tb = scenes[name]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    assert jg.has_motion and tg.has_motion
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_motion", "tri_n_motion",
              "motion_time", "wide_rows", "wide_motion"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)),
                                      err_msg=k)
    assert tg.wide_stack == jg.wide_stack


# ---------------------------------------------------------------------------
# traversal, interaction, camera
# ---------------------------------------------------------------------------


def _rays(name, n, seed):
    """Rays at the moving geometry, with times spread over the shutter and
    exactly 0, 0.5 and 1 on the first lanes."""
    rng = np.random.default_rng(seed)
    time = rng.random(n).astype(np.float32)
    time[:3] = (0.0, 0.5, 1.0)
    if name == "quad":  # at the quad's place at the ray's time, and around it
        o = np.tile(np.float32([0, 0, -4]), (n, 1)) + rng.normal(0, .05, (n, 3))
        target = np.stack([2.4 * time - 1.2 + rng.uniform(-.45, .45, n),
                           rng.uniform(-.45, .45, n), np.zeros(n)], -1)
    else:
        o = rng.uniform(-3, 3, (n, 3))
        o[:, 1] = rng.uniform(.5, 3, n)
        o[:, 2] -= 3
        target = rng.normal(0, .6, (n, 3)) + [0, .8, 0]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), time


def _both_rays(o, d, time, tmax=None):
    jr = JRay.make(jnp.asarray(o), jnp.asarray(d), time=jnp.asarray(time),
                   tmax=None if tmax is None else jnp.asarray(tmax))
    tr = TRay.make(torch.as_tensor(o), torch.as_tensor(d), time=torch.as_tensor(time),
                   tmax=None if tmax is None else torch.as_tensor(tmax))
    return jr, tr


@pytest.mark.parametrize("name", ["quad", "blob"])
def test_traversal_hits_match_jax(scenes, name):
    """Closest and any-hit on 600 rays at their own times: hit/miss equal,
    t rtol 1e-5, prims equal but on exact-t ties, b1 b2 atol 1e-4; the
    rays hit the geometry at shutter start, middle and end alike; the
    closest hits equal ``intersect_brute`` on the lerped triangles."""
    jb, tb = scenes[name]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    o, d, time = _rays(name, 600, 1)
    jr, tr = _both_rays(o, d, time)
    j_intersect = jax.jit(jisect.intersect, static_argnames=("any_hit",))
    hj, ht = j_intersect(jg, jr), tisect.intersect(tg, tr)
    pj, pt = np.asarray(hj.prim), ht.prim.numpy()
    np.testing.assert_array_equal(pt >= 0, pj >= 0)
    v = pj >= 0
    assert v.mean() > 0.3
    np.testing.assert_allclose(ht.t.numpy()[v], np.asarray(hj.t)[v], rtol=1e-5)
    assert (pt == pj)[v].mean() >= 0.99
    same = v & (pt == pj)
    for a, b in ((ht.b1, hj.b1), (ht.b2, hj.b2)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], atol=1e-4)
    hb = tisect.intersect_brute(tg, tr)
    np.testing.assert_array_equal(hb.prim.numpy() >= 0, v)
    np.testing.assert_allclose(hb.t.numpy()[v], ht.t.numpy()[v], rtol=1e-6)
    # any-hit: half the segments end before the closest hit
    tmax = np.where(v, np.asarray(hj.t) * np.where(np.arange(600) % 2, 0.5, 1.5), 1e30)
    jr, tr = _both_rays(o, d, time, tmax.astype(np.float32))
    aj = j_intersect(jg, jr, any_hit=True)
    at = tisect.intersect(tg, tr, any_hit=True)
    np.testing.assert_array_equal(at.prim.numpy() >= 0, np.asarray(aj.prim) >= 0)


def test_motion_moves_the_hits(scenes):
    """The quad's hits follow the ray time: a ray at x = -1.2 hits it at
    time 0 and misses at time 1, one at x = +1.2 the other way round, on
    both sides."""
    jb, tb = scenes["quad"]
    o = np.float32([[-1.2, 0, -4], [-1.2, 0, -4], [1.2, 0, -4], [1.2, 0, -4]])
    d = np.tile(np.float32([0, 0, 1]), (4, 1))
    time = np.float32([0, 1, 0, 1])
    jr, tr = _both_rays(o, d, time)
    want = [True, False, False, True]
    assert (np.asarray(jisect.intersect(jb.scene.geometry, jr).prim) >= 0).tolist() == want
    assert (tisect.intersect(tb.scene.geometry, tr).prim.numpy() >= 0).tolist() == want


def _to_port_hit(hj):
    return tisect.Hit(*(torch.as_tensor(np.array(x)) for x in (hj.t, hj.prim, hj.b1, hj.b2)))


@pytest.mark.parametrize("name", ["quad", "blob"])
def test_surface_interaction_matches_jax(scenes, name):
    """On the JAX package's hits: p, ng, ns, uv, dpdu atol 1e-5 (ns and ng
    from the lerped edges and normals), material and mesh ids equal."""
    jb, tb = scenes[name]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    o, d, time = _rays(name, 400, 2)
    jr, tr = _both_rays(o, d, time)
    hj = jisect.intersect(jg, jr)
    sj = jax.jit(jinter.surface_interaction)(jg, jr, hj)
    st = tinter.surface_interaction(tg, tr, _to_port_hit(hj))
    v = np.asarray(sj.valid)
    assert v.mean() > 0.3
    for k in ("p", "ng", "ns", "uv", "dpdu"):
        np.testing.assert_allclose(getattr(st, k).numpy()[v], np.asarray(getattr(sj, k))[v],
                                   atol=1e-5, err_msg=k)
    for k in ("material", "mesh_id"):
        np.testing.assert_array_equal(getattr(st, k).numpy()[v], np.asarray(getattr(sj, k))[v])


CAMERA = """
ActiveTransform StartTime
LookAt 0 2.5 -5  0 .6 0  0 1 0
ActiveTransform EndTime
LookAt 1 3 -4.5  .3 .5 0  0 1 0
Rotate 190 0 0 1
ActiveTransform All
Camera "perspective" "float fov" [40] "float shutteropen" [.2] "float shutterclose" [.9]
  "float lensradius" [.05] "float focaldistance" [5]
"""


def test_animated_camera_rays_match_jax():
    """An animated camera (a move and a roll past 180°) with a thin lens:
    ray origins, directions, times and one-pixel differentials atol 1e-5;
    the builder no longer refuses it, and a static camera keeps its single
    matrix."""
    text = blob_text().replace(
        'LookAt 0 2.5 -5  0 .6 0  0 1 0\nCamera "perspective" "float fov" [40]', CAMERA)
    jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
    assert not jb.camera.cam_to_world.is_static and tb.camera.motion is not None
    assert tbuild(tload(blob_text()), device="cpu").camera.motion is None
    rng = np.random.default_rng(3)
    u = rng.random((5, 300)).astype(np.float32)
    px, py = u[0] * 16, u[1] * 16
    jr = jb.camera.generate_rays(*(jnp.asarray(x) for x in (px, py, u[2], u[3], u[4])))
    tr = tb.camera.generate_rays(*(torch.as_tensor(x) for x in (px, py, u[2], u[3], u[4])))
    for k in ("origin", "direction", "time"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=1e-5, err_msg=k)
    dj = jb.camera.ray_differentials(jnp.asarray(px), jnp.asarray(py), jr)
    dt = tb.camera.ray_differentials(torch.as_tensor(px), torch.as_tensor(py), tr)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the interop path carries the animation: the JAX camera's own arrays
    _, cam, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    ti = cam.generate_rays(*(torch.as_tensor(x) for x in (px, py, u[2], u[3], u[4])))
    np.testing.assert_allclose(ti.direction.numpy(), np.asarray(jr.direction), atol=1e-5)


# ---------------------------------------------------------------------------
# render(seed)
# ---------------------------------------------------------------------------


def test_render_seed_matches_jax():
    """The 16² blob scene (path, depth 3) by both packages' ``render``,
    seed 0, 2 spp: pixels allclose (rtol 1e-4, atol 1e-6) on ≥ 99% of
    pixels (test_torch_film's rule), per-bin sums within 1e-2 relative:
    the glossy blob under a small light turns an ulp of difference in a
    lerped hit (XLA contracts the lerp into an FMA) into another path for
    one of the 512 samples, which carries ~0.4% of the frame. The frame
    differs from the shutter-pinned one (the smear happened)."""
    text = blob_text()
    with jax_integrator_pieces():
        jf = j_render(jbuild(jload(text)), spp=2, seed=0, chunk_pixels=128, verbose=False)
    tf = render(tbuild(tload(text), device="cpu"), spp=2, seed=0, chunk_pixels=128)
    pj, pt = np.asarray(jf.pixels), tf.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-2 * np.abs(sj).max()
    pinned = text.replace('"float fov" [40]',
                          '"float fov" [40] "float shutteropen" [0] "float shutterclose" [0]')
    tp = render(tbuild(tload(pinned), device="cpu"), spp=2, seed=0, chunk_pixels=128)
    assert np.abs(tp.pixels.numpy() - pt).max() > 1e-2 * np.abs(pt).max()


def test_anim_killeroos_golden_matches_jax():
    """``goldens/anim-killeroos-moving.pbrt`` as written at 16² (its two
    killeroos the 2,880-triangle blob, ``chip_smoke.anim_scene_text``):
    both builders give the same motion arrays bit for bit; camera rays at
    their own times hit alike (t rtol 1e-5, prims equal but on ties) with
    the same interactions (normals atol 1e-5; hit points atol 1e-4, a few
    ulps of coordinates of up to 400); ``render(seed=0, spp=2)`` by both
    packages agrees on ≥ 99% of pixels (rtol 1e-4, atol 1e-6), per-bin
    sums within 1e-3 relative."""
    text = chip_smoke.anim_scene_text(chip_smoke.SMALL_BLOB_FREQ, res=16)
    jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
    jg, tg = jb.scene.geometry, tb.scene.geometry
    for k in ("tri_v0", "tri_motion", "tri_n_motion", "wide_rows", "wide_motion"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)),
                                      err_msg=k)
    rng = np.random.default_rng(6)
    u = rng.random((3, 512)).astype(np.float32)
    z = np.zeros(512, np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(x) for x in (u[0] * 16, u[1] * 16, z, z, u[2])))
    tr = tb.camera.generate_rays(*(torch.as_tensor(x) for x in (u[0] * 16, u[1] * 16, z, z,
                                                                u[2])))
    hj, ht = jisect.intersect(jg, jr), tisect.intersect(tg, tr)
    pj, pt = np.asarray(hj.prim), ht.prim.numpy()
    np.testing.assert_array_equal(pt >= 0, pj >= 0)
    v = pj >= 0
    assert ((pj >= 4) & v).sum() > 50  # the killeroos, not only the walls
    np.testing.assert_allclose(ht.t.numpy()[v], np.asarray(hj.t)[v], rtol=1e-5)
    assert (pt == pj)[v].mean() >= 0.99
    sj = jax.jit(jinter.surface_interaction)(jg, jr, hj)
    st = tinter.surface_interaction(tg, tr, _to_port_hit(hj))
    np.testing.assert_allclose(st.p.numpy()[v], np.asarray(sj.p)[v], atol=1e-4)
    for k in ("ng", "ns", "dpdu"):
        np.testing.assert_allclose(getattr(st, k).numpy()[v], np.asarray(getattr(sj, k))[v],
                                   atol=1e-5, err_msg=k)
    jf = j_render(jb, spp=2, seed=0, chunk_pixels=256, verbose=False)
    tf = render(tb, spp=2, seed=0, chunk_pixels=256)
    pj, pt = np.asarray(jf.pixels), tf.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()


# ---------------------------------------------------------------------------
# facts 11-13
# ---------------------------------------------------------------------------


SHADOW = """
LookAt 0 4 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "distant" "rgb L" [3 3 3] "point from" [0 5 0] "point to" [0 0 0]
Material "matte" "color Kd" [.6 .6 .6]
Shape "trianglemesh" "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4] "integer indices" [0 1 2 2 3 0]
AttributeBegin
  ActiveTransform EndTime
  Translate 3 0 0
  ActiveTransform All
  Translate 0 1 0
  AreaLightSource "area" "rgb L" [2 2 2]
  Shape "trianglemesh" "point P" [-.5 0 -.5  .5 0 -.5  .5 0 .5  -.5 0 .5]
    "integer indices" [0 2 1 0 3 2]
AttributeEnd
AttributeBegin
  ActiveTransform EndTime
  Translate 2 0 0
  ActiveTransform All
  Translate -2 .3 1
  Shape "sphere" "float radius" [.3]
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def shadow_scene():
    return jbuild(jload(SHADOW)), tbuild(tload(SHADOW), device="cpu")


def test_fact11_shadow_rays_test_the_shutter_start(shadow_scene):
    """Fact 11: NEE shadow rays carry time 0 (JAX path.py:173, the port's
    ``_shadow_unoccluded``): a floor point under the emissive quad's start
    place is in its shadow whatever the path's time, though at time 1 the
    quad has moved 3 units away and a ray at that time passes."""
    jb, tb = shadow_scene
    p = np.float32([[0, 0, 0], [0.2, 0, -0.1]])
    ng = np.float32([[0, 1, 0], [0, 1, 0]])
    wi, dist, eps = ng.copy(), np.float32([10, 10]), np.float32([1e-3, 1e-3])
    vj = np.asarray(jpath._shadow_unoccluded(jb.scene.geometry, *map(jnp.asarray, (p, ng, wi,
                                                                                 dist, eps))))
    vt = tpath._shadow_unoccluded(tb.scene.geometry, *map(torch.as_tensor, (p, ng, wi, dist,
                                                                          eps))).numpy()
    assert not vj.any() and not vt.any()
    o = p + 1e-3 * ng
    for t_ray, blocked in ((0.0, True), (1.0, False)):
        jr, tr = _both_rays(o, wi, np.full(2, t_ray, np.float32), dist)
        assert ((np.asarray(jisect.intersect(jb.scene.geometry, jr, any_hit=True).prim) >= 0)
                == blocked).all()
        assert ((tisect.intersect(tb.scene.geometry, tr, any_hit=True).prim.numpy() >= 0)
                == blocked).all()


def test_fact12_area_light_samples_the_start_triangles(shadow_scene):
    """Fact 12: the animated emissive quad is sampled on its un-lerped
    start triangles (JAX lights/table.py:246-247): every sampled point lies
    in the start quad (x within ±.5), none in the end one (x near 3), on
    both sides, and the two agree (atol 1e-5)."""
    jb, tb = shadow_scene
    jlt, tlt = jb.scene.lights, tb.scene.lights
    row = int(np.nonzero(np.asarray(jlt.type) == jlights.AREA)[0][0])
    assert int(tlt.area_row0) <= row
    rng = np.random.default_rng(5)
    n = 64
    p = np.tile(np.float32([0, 0, 0]), (n, 1))
    u1, u2 = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    li = np.full(n, row, np.int32)
    sj = jax.jit(jlights.sample_li)(jlt, jb.scene.geometry, *map(jnp.asarray, (li, p, u1, u2)))
    st = tlights.sample_li(tlt, tb.scene.geometry, torch.as_tensor(li.astype(np.int64)),
                           *map(torch.as_tensor, (p, u1, u2)))
    pl_j = p + np.asarray(sj.wi) * np.asarray(sj.dist)[:, None]
    pl_t = p + st.wi.numpy() * st.dist.numpy()[:, None]
    np.testing.assert_allclose(pl_t, pl_j, atol=1e-5)
    assert (np.abs(pl_t[:, 0]) <= 0.5 + 1e-5).all() and np.allclose(pl_t[:, 1], 1, atol=1e-5)


def test_fact13_animated_quadric_keeps_its_start_transform(shadow_scene, capfd):
    """Fact 13: an animated sphere is built at its start transform with a
    warning, on both sides (JAX builder.py:321-325)."""
    jb, tb = shadow_scene
    np.testing.assert_allclose(tb.scene.geometry.quad_o2w.numpy(),
                               np.asarray(jb.scene.geometry.quad_o2w), atol=0)
    np.testing.assert_allclose(tb.scene.geometry.quad_o2w.numpy()[0][:3, 3], [-2, .3, 1])
    text = SHADOW.replace("Translate -2 .3 1", "Translate -2 .3 1.5")
    capfd.readouterr()
    jbuild(jload(text))
    tbuild(tload(text), device="cpu")
    err = capfd.readouterr().err
    assert err.count("animated quadric 'sphere'") == 2
