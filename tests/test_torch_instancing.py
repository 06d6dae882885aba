"""Parity of the port's memory-shared instancing with the JAX package, on
tests/test_instancing.py's wedge scene (one two-triangle object used three
times, one use rotated): the instance table and the object's table, hits
and their instance, instanced against flattened, the metadata mesh ids per
use, surface interaction of instanced hits, ``render(seed)`` (with an
animated camera), and fact 15 of ROADMAP Queue 3 (an instanced hit's
texture footprint).

Tolerances as in test_torch_motion: hit distances rtol 1e-5, shading atol
1e-5, renders the ≥ 99%-of-pixels rule; host-built tables bit for bit.
Instanced against flattened, t within rtol 2e-4 (test_instancing's: the
ray's round trip through the instance's matrices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core import interaction as jinter
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators.path import IntegratorConfig as JCfg
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.core import interaction as tinter
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.integrators.path import IntegratorConfig as TCfg
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from test_instancing import FLAT, FOOTER, HEADER, OBJ, USES
from torch_parity_util import jax_scene_arrays

INSTANCED = HEADER + OBJ + USES + FOOTER
FLATTENED = HEADER + FLAT + FOOTER
#: the same uses with no world triangles: only the instance phase finds hits
ONLY_INSTANCES = HEADER + OBJ + USES + "WorldEnd\n"
_INST = ("inst_rows", "inst_o2w", "inst_w2o", "inst_root", "inst_lo", "inst_hi",
         "inst_mesh_id")
_TRI = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2", "tri_uv0",
        "tri_material", "tri_area_light", "tri_mesh_id")


@pytest.fixture(scope="module")
def built():
    """Each scene by both packages (the port on the CPU)."""
    return {name: (jbuild(jload(text)), tbuild(tload(text), device="cpu"))
            for name, text in (("instanced", INSTANCED), ("flattened", FLATTENED),
                               ("only", ONLY_INSTANCES))}


def _rand_rays(n, seed=0):
    """test_instancing's fuzz rays: origins above the ground, random
    directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 4.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _aimed_rays(n, seed=1):
    """Rays aimed at points of the three wedges, from around them."""
    rng = np.random.default_rng(seed)
    centres = np.float32([[-2.5, .5, -.3], [2.5, .5, -.3], [0, .5, 1.7]])
    target = centres[rng.integers(0, 3, n)] + rng.normal(0, .35, (n, 3))
    o = target + rng.normal(0, 1, (n, 3)) * 3 + [0, 2, -3]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _both(o, d, tmax=None):
    return (JRay.make(jnp.asarray(o), jnp.asarray(d),
                      tmax=None if tmax is None else jnp.asarray(tmax)),
            TRay.make(torch.as_tensor(o), torch.as_tensor(d),
                      tmax=None if tmax is None else torch.as_tensor(tmax)))


@pytest.mark.parametrize("name", ["instanced", "only"])
def test_instance_tables_match_jax(built, name):
    """One shared copy of the wedge (2 triangles after the world's), its
    table at row 0 with ids from T_world, three instance rows with fresh
    mesh ids, world bounds widened by the uses: every array equal to the
    JAX builder's bit for bit."""
    jb, tb = built[name]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    for k in _INST + _TRI:
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)),
                                      err_msg=k)
    assert tg.inst_stack == jg.inst_stack and tg.num_instances == 3
    assert tg.num_triangles == jg.num_triangles == (4 if name == "instanced" else 2)
    if name == "instanced":
        np.testing.assert_array_equal(tg.wide_rows.numpy(), np.asarray(jg.wide_rows))
    else:
        assert tg.wide_rows is None and jg.wide_rows is None
    assert built["flattened"][1].scene.geometry.inst_rows is None


@pytest.mark.parametrize("name", ["instanced", "only"])
@pytest.mark.parametrize("rays", ["fuzz", "aimed"])
def test_hits_and_instance_match_jax(built, name, rays):
    """Closest hit on 512 rays: hit/miss equal, t rtol 1e-5, prim and inst
    equal but on exact-t ties, b1 b2 atol 1e-4; any-hit occlusion equal on
    segments that end before or after the closest hit. The port's
    traversal on the JAX builder's arrays (interop) gives its own result
    bit for bit."""
    jb, tb = built[name]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    o, d = _rand_rays(512) if rays == "fuzz" else _aimed_rays(512)
    jr, tr = _both(o, d)
    hj, ht = jisect.intersect(jg, jr), tisect.intersect(tg, tr)
    pj, pt = np.asarray(hj.prim), ht.prim.numpy()
    np.testing.assert_array_equal(pt >= 0, pj >= 0)
    v = pj >= 0
    assert v.sum() >= 20 and (np.asarray(hj.inst) >= 0).sum() >= 10
    np.testing.assert_allclose(ht.t.numpy()[v], np.asarray(hj.t)[v], rtol=1e-5)
    same = (pt == pj) & (ht.inst.numpy() == np.asarray(hj.inst))
    assert same[v].mean() >= 0.99
    for a, b in ((ht.b1, hj.b1), (ht.b2, hj.b2)):
        np.testing.assert_allclose(a.numpy()[same & v], np.asarray(b)[same & v], atol=1e-4)
    assert ht.inst.dtype == torch.int32 and (ht.inst.numpy()[~v] == -1).all()
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    hi = tisect.intersect(scene.geometry, tr)
    for a, b in zip((hi.t, hi.prim, hi.b1, hi.b2, hi.inst),
                    (ht.t, ht.prim, ht.b1, ht.b2, ht.inst)):
        assert torch.equal(a, b)
    tmax = np.where(v, np.asarray(hj.t) * np.where(np.arange(512) % 2, .5, 1.5), 1e30)
    jr, tr = _both(o, d, tmax.astype(np.float32))
    aj, at = jisect.intersect(jg, jr, any_hit=True), tisect.intersect(tg, tr, any_hit=True)
    np.testing.assert_array_equal(at.prim.numpy() >= 0, np.asarray(aj.prim) >= 0)


def test_instanced_matches_flattened(built):
    """The port's instanced scene against its flattened one (what the
    expansion would produce): hit/miss equal, t rtol 2e-4, any-hit
    occlusion equal (test_instancing's check, on the port)."""
    gi, gf = built["instanced"][1].scene.geometry, built["flattened"][1].scene.geometry
    for o, d in (_rand_rays(512), _aimed_rays(512)):
        tr = TRay.make(torch.as_tensor(o), torch.as_tensor(d))
        hi, hf = tisect.intersect(gi, tr), tisect.intersect(gf, tr)
        assert torch.equal(hi.valid, hf.valid)
        v = hf.valid
        np.testing.assert_allclose(hi.t[v].numpy(), hf.t[v].numpy(), rtol=2e-4, atol=2e-4)
        assert torch.equal(tisect.intersect(gi, tr, any_hit=True).valid,
                           tisect.intersect(gf, tr, any_hit=True).valid)


def test_metadata_mesh_ids_per_use(built):
    """Each use carries its own mesh id (test_instancing's
    test_instancing_metadata_ids), on both sides, through
    ``surface_interaction`` and through the metadata integrator."""
    jb, tb = built["instanced"]
    o = np.float32([[-2.5, 0.75, -0.01], [0.0, 0.75, 1.99], [2.5, 0.5, -3]])
    d = np.float32([[0, 0, 1], [0, 0, 1], [0, 0, 1]])
    jr, tr = _both(o, d)
    hj = jisect.intersect(jb.scene.geometry, jr)
    sj = jinter.surface_interaction(jb.scene.geometry, jr, hj)
    st = tinter.surface_interaction(tb.scene.geometry, tr,
                                    tisect.intersect(tb.scene.geometry, tr))
    ids = st.mesh_id.numpy()
    assert st.valid.all() and len(set(ids.tolist())) == 3
    np.testing.assert_array_equal(ids, np.asarray(sj.mesh_id))
    lj, _ = j_trace(jb.scene, jr, jax.random.split(jax.random.key(0), 3),
                    JCfg(kind="metadata", metadata_channel="mesh_mask"))
    lt, _ = t_trace(tb.scene, tr, TCfg(kind="metadata", metadata_channel="mesh_mask"), None)
    np.testing.assert_array_equal(lt[:, 0].numpy(), np.asarray(lj)[:, 0])
    np.testing.assert_array_equal(lt[:, 0].numpy(), ids.astype(np.float32))


def test_surface_interaction_matches_jax(built):
    """On the JAX package's hits of the aimed rays: p, ng, ns, uv, dpdu and
    the partials dpdv, dndu, dndv (rotated by the instance's matrices),
    atol 1e-5, with a pixel cone's footprint; material and mesh ids
    equal."""
    jb, tb = built["instanced"]
    jg, tg = jb.scene.geometry, tb.scene.geometry
    o, d = _aimed_rays(400, 2)
    jr, tr = _both(o, d)
    hj = jisect.intersect(jg, jr)
    sj = jax.jit(jinter.surface_interaction)(jg, jr, hj, spread=0.01)
    ht = tisect.Hit(*(torch.as_tensor(np.array(x)) for x in (hj.t, hj.prim, hj.b1, hj.b2,
                                                             hj.inst)))
    st = tinter.surface_interaction(tg, tr, ht, spread=0.01, partials=True)
    v = np.asarray(sj.valid) & (np.asarray(hj.inst) >= 0)
    assert v.sum() > 50
    for k in ("p", "ng", "ns", "uv", "dpdu", "dpdv", "dndu", "dndv", "uv_sigma", "duvdx"):
        np.testing.assert_allclose(getattr(st, k).numpy()[v], np.asarray(getattr(sj, k))[v],
                                   atol=1e-5, err_msg=k)
    for k in ("material", "mesh_id"):
        np.testing.assert_array_equal(getattr(st, k).numpy()[v], np.asarray(getattr(sj, k))[v])


#: test_instancing's camera, moving and rolling over the shutter
MOVING_CAMERA = """
ActiveTransform StartTime
LookAt 0 6 -10  0 0 0  0 1 0
ActiveTransform EndTime
LookAt 1 5 -9  .5 0 0  0 1 0
Rotate 10 0 0 1
ActiveTransform All
Camera "perspective" "float fov" [40]
"""


def test_render_seed_matches_jax():
    """The instanced scene seen by an animated camera (24², directlighting,
    2 spp) by both packages' ``render``, seed 0: pixels allclose (rtol
    1e-4, atol 1e-6) on ≥ 99% of pixels, per-bin sums within 1e-3
    relative (test_torch_film's rule); and the port's instanced frame
    against its flattened one, rtol 1e-3 (test_instancing's)."""
    cam = 'LookAt 0 6 -10  0 0 0  0 1 0\nCamera "perspective" "float fov" [40]\n'
    assert cam in HEADER
    moving = lambda text: text.replace(cam, MOVING_CAMERA)
    jb = jbuild(jload(moving(INSTANCED)))
    tb = tbuild(tload(moving(INSTANCED)), device="cpu")
    assert tb.camera.motion is not None and tb.scene.geometry.num_instances == 3
    jf = j_render(jb, spp=2, seed=0, chunk_pixels=256, verbose=False)
    tf = render(tb, spp=2, seed=0, chunk_pixels=256)
    pj, pt = np.asarray(jf.pixels), tf.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    ff = render(tbuild(tload(moving(FLATTENED)), device="cpu"), spp=2, seed=0,
                chunk_pixels=256)
    np.testing.assert_allclose(pt, ff.pixels.numpy(), rtol=1e-3, atol=1e-3)


def test_fact15_instanced_footprint_solves_in_object_space(built):
    """Fact 15: the footprint's uv solve (JAX interaction.py:193-207) takes
    an instanced hit's object-space edges against world-space deltas. On
    the translated wedges that changes nothing; on the wedge turned 40°
    about y its minor radius differs from the flattened scene's by far
    more than rounding. The port copies it: its instanced footprints equal
    the JAX package's (atol 1e-5)."""
    gi_j, gi_t = (b.scene.geometry for b in built["instanced"])
    gf_t = built["flattened"][1].scene.geometry
    o, d = _aimed_rays(600, 3)
    _, tr = _both(o, d)
    hi, hf = tisect.intersect(gi_t, tr), tisect.intersect(gf_t, tr)
    si = tinter.surface_interaction(gi_t, tr, hi, spread=0.01, partials=True)
    sf = tinter.surface_interaction(gf_t, tr, hf, spread=0.01, partials=True)
    inst = hi.inst.numpy()
    rel = (np.abs(si.uv_sigma.numpy() - sf.uv_sigma.numpy())
           / np.maximum(sf.uv_sigma.numpy(), 1e-12))
    turned = inst == 1  # the second use: Translate 2.5 0 0, Rotate 40 0 1 0
    moved = (inst == 0) | (inst == 2)
    assert turned.sum() > 20 and moved.sum() > 20
    assert rel[moved].max() < 1e-4
    assert np.median(rel[turned]) > 1e-2
    jr, _ = _both(o, d)
    sj = jax.jit(jinter.surface_interaction)(gi_j, jr, jisect.intersect(gi_j, jr), spread=0.01)
    np.testing.assert_allclose(si.uv_sigma.numpy()[turned],
                               np.asarray(sj.uv_sigma)[turned], atol=1e-5)
