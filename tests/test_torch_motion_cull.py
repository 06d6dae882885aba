"""The motion walks' time boxes (``wide.time_boxes``) and the culled walk
that reads them (``traverse_cuda.traverse_plain(..., time_boxes=)``, the
motion kernels' plain version), against the union walk and the JAX
package.

- Containment: at tw = 0, 1 and 64 seeded weights, every triangle's
  float32-lerped corners lie inside the float32-lerped time box of each of
  its ancestors' slots, on the motion scenes of ``test_torch_motion.py``
  (the swept quad, the turning blob, anim-killeroos at 16²) and on a
  moving soup.
- Equality: the culled walk and the union walk give the same (t, prim,
  b1, b2) bit for bit, closest and any hit; on the tie-and-dense scene with
  motion under the BVH (``chip_smoke.tie_scene_text("bvh", True)``, every
  coordinate dyadic, so t is exact in any order) both equal the JAX
  package's ``intersect`` bit for bit too (the sphere's b1 / b2, atan2 in
  two libraries, within 1e-6). Elsewhere XLA contracts the lerp and
  Möller–Trumbore into FMAs, so the JAX side is held as
  ``test_torch_motion.py`` holds it (hit or miss equal, prims equal on ≥
  99% of hits, t rtol 1e-5).
- Rays outside the easy part of the proof's cover: almost in the plane of
  a moving triangle at the ray's weight (0°–0.1°) and from 10–1,000 C_T
  away, aimed at its corners, edges and inside, closest and any hit: the
  culled walk equals the union walk bit for bit.
- Work: on a scene whose sweep exceeds its triangles' size the culled walk
  takes strictly fewer node and leaf steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import bvh, traverse_cuda as tc, wide
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from test_torch_motion import QUAD, _rays, blob_text
from torch_parity_util import jax_scene_arrays

#: weights the containment test lerps at: both ends and 64 seeded ones
WEIGHTS = np.concatenate([np.float32([0.0, 1.0]),
                          np.random.default_rng(41).random(64, np.float32)])


def soup(n=1500, seed=36):
    """(v0, e1, e2, deltas) of small triangles each swept ~0.5 along a
    random direction (and deformed a little) over the shutter."""
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-1, 1, (n, 1, 3)) + rng.uniform(-.05, .05, (n, 3, 3))).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    dm = np.concatenate([rng.normal(0, .3, (n, 3)), rng.normal(0, .01, (n, 6))], 1)
    return v0, e1, e2, dm.astype(np.float32)


def soup_table(n=1500, seed=36):
    """The soup's wide table over the union of its start and end bounds,
    as the builder makes it."""
    v0, e1, e2, dm = soup(n, seed)
    corners = lambda a, b, c: np.stack([a, a + b, a + c])
    s = corners(v0, e1, e2)
    e = corners(v0 + dm[:, 0:3], e1 + dm[:, 3:6], e2 + dm[:, 6:9])
    lo, hi = np.minimum(s.min(0), e.min(0)), np.maximum(s.max(0), e.max(0))
    return wide.build_wide_bvh(bvh.build_bvh(lo, hi, max_prims_in_node=8), v0, e1, e2,
                               tri_motion=dm)


@pytest.fixture(scope="module")
def scenes():
    """name → (JAX build or None, the port's geometry on the CPU)."""
    out = {}
    for name, text in (("quad", QUAD), ("blob", blob_text()),
                       ("anim", chip_smoke.anim_scene_text(chip_smoke.SMALL_BLOB_FREQ, res=16)),
                       ("tie", chip_smoke.tie_scene_text("bvh", motion=True))):
        jb = jbuild(jload(text)) if name in ("quad", "blob", "tie") else None
        out[name] = (jb, tbuild(tload(text), device="cpu").scene.geometry)
    return out


def _tables(scenes, name):
    """(rows, motion rows, time boxes) as numpy."""
    if name == "soup":
        w = soup_table()
        return w.rows, w.motion_rows, w.time_boxes
    g = scenes[name][1]
    return g.wide_rows.numpy(), g.wide_motion.numpy(), g.wide_tbox.numpy()


def _slot_paths(rows):
    """leaf row → the (node row, slot) pairs on its path from the root."""
    out, st = {}, [(0, [])]
    while st:
        n, path = st.pop()
        for j in range(8):
            if not rows[n, j] <= rows[n, 8 + j]:
                continue
            r = int(rows[n, 48 + j])
            if r >= 0:
                st.append((r, path + [(n, j)]))
            else:
                out.setdefault(-r - 1, []).extend(path + [(n, j)])
    return out


@pytest.mark.parametrize("name", ["quad", "blob", "anim", "soup"])
def test_time_boxes_contain_lerped_triangles(scenes, name):
    """At every weight of ``WEIGHTS``: each triangle's corners V0, V0 + E1
    and V0 + E2, V0, E1 and E2 lerped in float32 as the leaf step lerps them
    (the product rounded, then added), lie inside the box that every slot
    on its path lerps in float32, at least half the table's share of the
    pad inside each face."""
    rows, mrows, tb = _tables(scenes, name)
    assert tb.shape == (rows.shape[0], wide.W_TBOX) and tb.dtype == np.float32
    w = WEIGHTS[:, None, None]
    paths = _slot_paths(rows)
    coords = []  # every leaf's corners at every weight, for the table's C
    boxes = []
    for leaf, path in paths.items():
        pid = rows[leaf, 72:80]
        k = np.nonzero(pid >= 0)[0]
        field = lambda a, f: a[leaf, 8 * f + k]  # (P,) of field f
        lerp = lambda f0: np.stack([field(rows, f) + w[..., 0] * field(mrows, f)
                                    for f in range(f0, f0 + 3)], -1)  # (K, P, 3) f32
        v0, e1, e2 = lerp(0), lerp(3), lerp(6)
        v0d = v0.astype(np.float64)
        corners = np.stack([v0d, v0d + e1, v0d + e2], 2)  # (K, P, 3, 3)
        coords.append(np.abs(corners).max())
        lo_v, hi_v = corners.min((1, 2)), corners.max((1, 2))  # (K, 3)
        for n, j in path:
            lo0, hi0 = tb[n, [j, 16 + j, 32 + j]], tb[n, [8 + j, 24 + j, 40 + j]]
            dlo, dhi = tb[n, [48 + j, 64 + j, 80 + j]], tb[n, [56 + j, 72 + j, 88 + j]]
            boxes.append((lo0 + w[..., 0] * dlo, hi0 + w[..., 0] * dhi, lo_v, hi_v))
    c_table = max(coords)
    for lo_b, hi_b, lo_v, hi_v in boxes:
        assert lo_b.dtype == np.float32
        margin = 0.5 * wide.TBOX_PAD_TABLE * c_table
        assert (lo_b.astype(np.float64) <= lo_v - margin).all()
        assert (hi_b.astype(np.float64) >= hi_v + margin).all()
    # empty slots and leaf rows keep the inverted box and no delta
    node = {n for path in paths.values() for n, _ in path}
    leaf_rows = sorted(set(range(rows.shape[0])) - node)
    assert (tb[leaf_rows, 0:8] == 1e30).all() and (tb[leaf_rows, 48:] == 0).all()


def _walk_both(rows, stack, mrows, tbox, o, d, tw, any_hit, tmax=None, g=None):
    """(union walk, culled walk, their stats) on the rays, seeded with the
    quadric pass of ``g`` as ``intersect`` seeds them (or with no hit)."""
    R = o.shape[0]
    inv = tisect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(R)
    tmax = torch.full((R,), float("inf")) if tmax is None else tmax
    seeds = (tmax.clone(), torch.full((R,), -1, dtype=torch.int32), torch.zeros(R),
             torch.zeros(R))
    if g is not None and g.num_quadrics:
        seeds = [x.contiguous() for x in tisect.quad_best(g, o, d, tmin, tmax)]
    su, sc = {}, {}
    u = tc.traverse_plain(rows, stack, o, d, inv, tmin, tmax, *seeds, any_hit, stats=su,
                          motion_rows=mrows, tw=tw)
    c = tc.traverse_plain(rows, stack, o, d, inv, tmin, tmax, *seeds, any_hit, stats=sc,
                          motion_rows=mrows, tw=tw, time_boxes=tbox)
    return u, c, su, sc


def _bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["quad", "blob"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_culled_walk_equals_union_walk_and_jax(scenes, name, any_hit):
    """600 rays at their own shutter times (exactly 0, 0.5 and 1 on the
    first): the culled walk equals the union walk bit for bit, closest and
    any hit (half the segments ending before the closest hit), and
    ``intersect`` (which takes the culled walk on the CPU) agrees with the
    JAX package as test_torch_motion holds it."""
    jb, g = scenes[name]
    o, d, time_ = _rays(name, 600, 1)
    to, td, tt = (torch.as_tensor(x) for x in (o, d, time_))
    tw = tisect.motion_weight(g, tt).contiguous()
    tab = (g.wide_rows, g.wide_stack, g.wide_motion, g.wide_tbox)
    tmax = None
    if any_hit:
        closest = _walk_both(*tab, to, td, tw, False, g=g)[0]
        tmax = torch.where(torch.isfinite(closest[0]),
                           closest[0] * torch.where(torch.arange(600) % 2 == 1, 0.5, 1.5),
                           1e30).contiguous()
    u, c, _, _ = _walk_both(*tab, to, td, tw, any_hit, tmax, g=g)
    assert _bits(u, c)
    ht = tisect.intersect(g, TRay.make(to, td, tmax=tmax, time=tt), any_hit=any_hit)
    assert _bits((ht.t, ht.prim, ht.b1, ht.b2), c)
    hj = jax.jit(jisect.intersect, static_argnames=("any_hit",))(
        jb.scene.geometry, JRay.make(jnp.asarray(o), jnp.asarray(d), time=jnp.asarray(time_),
                                     tmax=None if tmax is None else jnp.asarray(tmax.numpy())),
        any_hit=any_hit)
    pj, pt = np.asarray(hj.prim), c[1].numpy()
    np.testing.assert_array_equal(pt >= 0, pj >= 0)
    v = pj >= 0
    assert v.mean() > 0.1
    if not any_hit:
        np.testing.assert_allclose(c[0].numpy()[v], np.asarray(hj.t)[v], rtol=1e-5)
        assert (pt == pj)[v].mean() >= 0.99


@pytest.mark.parametrize("any_hit", [False, True])
def test_tie_scene_bvh_motion_bit_equal_to_jax(scenes, any_hit):
    """The tie-and-dense scene with motion under the BVH, on 3,000 of
    ``chip_smoke.tie_rays`` at their times: exact ties (70 copies of one
    triangle, a cluster a few ulps apart) meet the culling; the culled
    walk, the union walk and the JAX package's ``intersect`` agree bit for
    bit in t, prim, b1 and b2 (the sphere's b1 / b2 within 1e-6): a tie
    among the copies goes to the copy the serial order reaches first, the
    same one in both packages. Any hit on segments that end 2^-20 past the
    closest hit or 1 past it."""
    jb, g = scenes["tie"]
    o, d, tm = chip_smoke.tie_rays(3000, seed=0)
    to, td, tt = (torch.as_tensor(x) for x in (o, d, tm))
    tw = tisect.motion_weight(g, tt).contiguous()
    quad = [x.contiguous() for x in tisect.quad_best(g, to, td, torch.zeros(3000),
                                                      torch.full((3000,), float("inf")))]
    tmax = torch.full((3000,), float("inf"))
    if any_hit:
        closest = tisect.intersect(g, TRay.make(to, td, time=tt))
        past = torch.where(torch.arange(3000) % 2 == 0, 2.0 ** -20, 1.0)
        tmax = torch.where(torch.isfinite(closest.t), closest.t + past, 1e30).contiguous()
        quad = [x.contiguous() for x in tisect.quad_best(g, to, td, torch.zeros(3000), tmax)]
    inv = tisect.make_inv_dir(td).contiguous()
    args = (g.wide_rows, g.wide_stack, to, td, inv, torch.zeros(3000), tmax, *quad, any_hit)
    u = tc.traverse_plain(*args, motion_rows=g.wide_motion, tw=tw)
    c = tc.traverse_plain(*args, motion_rows=g.wide_motion, tw=tw, time_boxes=g.wide_tbox)
    assert _bits(u, c)
    jh = jisect.intersect(jb.scene.geometry, JRay.make(
        jnp.asarray(o), jnp.asarray(d), tmax=jnp.asarray(tmax.numpy()), time=jnp.asarray(tm)),
        any_hit=any_hit)
    T = g.num_triangles
    tp, jp = c[1].numpy(), np.asarray(jh.prim)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(c[0].numpy().view(np.int32), np.asarray(jh.t).view(np.int32))
    tri = (tp >= 0) & (tp < T)
    for port, jax_ in ((c[2], jh.b1), (c[3], jh.b2)):
        np.testing.assert_array_equal(port.numpy()[tri].view(np.int32),
                                      np.asarray(jax_)[tri].view(np.int32))
        np.testing.assert_allclose(port.numpy()[~tri], np.asarray(jax_)[~tri], atol=1e-6)
    copies = (tp >= 0) & (tp < chip_smoke.TIE_COPIES)
    assert copies.sum() > 100 and len(set(tp[copies].tolist())) < chip_smoke.TIE_COPIES
    assert ((tp >= chip_smoke.TIE_COPIES) & (tp < T)).sum() > 100


#: the angles between a grazing ray and the plane of the triangle it is
#: aimed at, in degrees (0: in the plane, up to its float32 rounding)
GRAZING_DEG = (0.0, 0.01, 0.03, 0.1)
#: how far a far ray starts from its target, in multiples of the table's
#: largest triangle coordinate C_T
FAR_FACTORS = (10.0, 100.0, 1000.0)


def _moving_tables(scenes, name):
    """(rows, stack, motion rows, time boxes) as tensors and the moving
    triangles' (v0, e1, e2, deltas) as float32 numpy, with C_T."""
    if name == "soup":
        w = soup_table()
        tab = (torch.as_tensor(w.rows), w.max_stack, torch.as_tensor(w.motion_rows),
               torch.as_tensor(w.time_boxes))
        v0, e1, e2, dm = soup()
    else:
        g = scenes[name][1]
        tab = (g.wide_rows, g.wide_stack, g.wide_motion, g.wide_tbox)
        v0, e1, e2, dm = (x.numpy() for x in (g.tri_v0, g.tri_e1, g.tri_e2, g.tri_motion))
    corners = np.concatenate([v0, v0 + e1, v0 + e2, v0 + dm[:, 0:3],
                              v0 + dm[:, 0:3] + e1 + dm[:, 3:6], v0 + dm[:, 0:3] + e2 + dm[:, 6:9]])
    moving = np.nonzero(np.abs(dm).max(1) > 0)[0]
    return tab, (v0[moving], e1[moving], e2[moving], dm[moving]), float(np.abs(corners).max())


def _aimed(tris, n, seed):
    """n rays' targets: a random triangle of ``tris`` lerped in float32 at a
    random weight (0 and 1 on the first lanes) as the leaf step lerps it,
    and a point of it: by turns a corner (where the time boxes' faces lie,
    so only their pad keeps a hit inside), a point on an edge and one
    inside → (target (n, 3) f64, unit normal, a unit in-plane direction,
    tw (n,) f32)."""
    v0, e1, e2, dm = tris
    rng = np.random.default_rng(seed)
    k = rng.integers(0, v0.shape[0], n)
    tw = rng.random(n, np.float32)
    tw[:2] = (0.0, 1.0)
    lerp = lambda a, da: (a[k] + tw[:, None] * da[k]).astype(np.float64)
    lv0, le1, le2 = lerp(v0, dm[:, 0:3]), lerp(e1, dm[:, 3:6]), lerp(e2, dm[:, 6:9])
    b = rng.dirichlet([2.0, 2.0, 2.0], n)
    corner, edge = np.arange(n) % 3 == 0, np.arange(n) % 3 == 1
    b[corner] = np.eye(3)[rng.integers(0, 3, int(corner.sum()))]
    b[edge, rng.integers(0, 3, int(edge.sum()))] = 0.0
    b /= b.sum(1, keepdims=True)
    target = lv0 + b[:, 1:2] * le1 + b[:, 2:3] * le2
    nrm = np.cross(le1, le2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    u = rng.normal(size=(n, 3))
    u -= (u * nrm).sum(1, keepdims=True) * nrm
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return target, nrm, u, tw


def _cut_both_ways(tab, o, d, tw):
    """Closest hit, then any hit on segments cut at half or 1.5 times the
    closest hit: the culled walk equals the union walk bit for bit on both.
    → the closest hits' prims."""
    u, c, _, _ = _walk_both(*tab, o, d, tw, False)
    assert _bits(u, c)
    R = o.shape[0]
    tmax = torch.where(torch.isfinite(c[0]),
                       c[0] * torch.where(torch.arange(R) % 2 == 1, 0.5, 1.5), 1e30).contiguous()
    ua, ca, _, _ = _walk_both(*tab, o, d, tw, True, tmax)
    assert _bits(ua, ca)
    return c[1]


@pytest.mark.parametrize("name", ["quad", "blob", "soup"])
def test_culled_walk_equals_union_walk_grazing(scenes, name):
    """Rays almost in the plane of a moving triangle at the ray's shutter
    weight, 0°, 0.01°, 0.03° and 0.1° off it on either side, from 0.2 to 2
    units before a corner, an edge point or an inner point of it (where
    Möller–Trumbore accepts, if at all, only through its rounding): the
    culled walk equals the union walk bit for bit, closest and any hit.
    (With the pad set to 0 the quad's corner rays differ.)"""
    tab, tris, _ = _moving_tables(scenes, name)
    n = 1500
    target, nrm, u, tw = _aimed(tris, n, 51)
    rng = np.random.default_rng(52)
    theta = np.radians(np.resize(GRAZING_DEG, n)) * rng.choice([-1.0, 1.0], n)
    d = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * nrm
    o = target - rng.uniform(0.2, 2.0, (n, 1)) * d
    prim = _cut_both_ways(tab, torch.as_tensor(o.astype(np.float32)),
                          torch.as_tensor(d.astype(np.float32)), torch.as_tensor(tw))
    assert int((prim >= 0).sum()) > n // 10


@pytest.mark.parametrize("name", ["quad", "blob", "soup"])
def test_culled_walk_equals_union_walk_far_origins(scenes, name):
    """Rays from 10, 100 and 1,000 times the table's largest coordinate C_T
    away, aimed at a corner, an edge point or an inner point of a moving
    triangle at the ray's shutter weight: the culled walk equals the union walk bit for bit, closest and
    any hit."""
    tab, tris, c_t = _moving_tables(scenes, name)
    n = 1200
    target, _, _, tw = _aimed(tris, n, 53)
    rng = np.random.default_rng(54)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = target - (np.resize(FAR_FACTORS, n) * c_t)[:, None] * d
    prim = _cut_both_ways(tab, torch.as_tensor(o.astype(np.float32)),
                          torch.as_tensor(d.astype(np.float32)), torch.as_tensor(tw))
    assert int((prim >= 0).sum()) > n // 10


@pytest.mark.parametrize("name", ["blob", "soup"])
def test_culled_walk_takes_fewer_steps(scenes, name):
    """The blob moves 1.6 units and turns 200° with triangles ~0.03 across;
    the soup's triangles (~0.1) sweep ~0.5: the culled walk takes strictly
    fewer node steps and leaf steps than the union walk, closest and any
    hit, and its longest lane no more steps, with the same results."""
    if name == "blob":
        g = scenes["blob"][1]
        tab = (g.wide_rows, g.wide_stack, g.wide_motion, g.wide_tbox)
        o, d, time_ = (torch.as_tensor(x) for x in _rays("blob", 600, 3))
        tw = tisect.motion_weight(g, time_).contiguous()
        d = d.contiguous()
    else:
        w = soup_table()
        tab = (torch.as_tensor(w.rows), w.max_stack, torch.as_tensor(w.motion_rows),
               torch.as_tensor(w.time_boxes))
        rng = np.random.default_rng(37)
        o = torch.as_tensor(rng.uniform(-1.2, 1.2, (2000, 3)).astype(np.float32))
        d = torch.as_tensor(rng.normal(size=(2000, 3)).astype(np.float32))
        d = d / d.norm(dim=1, keepdim=True)
        tw = torch.as_tensor(rng.random(2000, np.float32))
    for any_hit in (False, True):
        u, c, su, sc = _walk_both(*tab, o, d, tw, any_hit)
        assert _bits(u, c) and int((u[1] >= 0).sum()) > 50
        assert sc["node_steps"] < su["node_steps"] and sc["leaf_steps"] < su["leaf_steps"]
        assert int(sc["lane_steps"].max()) <= int(su["lane_steps"].max())


def test_motion_walk_needs_the_time_boxes(scenes, monkeypatch):
    """``traverse`` refuses a motion walk without the time-box table, and
    the table without a motion walk, on the CPU as on a card; ``intersect``
    passes the scene's table."""
    g = scenes["quad"][1]
    o, d, time_ = (torch.as_tensor(x) for x in _rays("quad", 64, 4))
    inv = tisect.make_inv_dir(d).contiguous()
    z = torch.zeros(64)
    inf = torch.full((64,), float("inf"))
    seeds = (inf.clone(), torch.full((64,), -1, dtype=torch.int32), z, z)
    args = (g.wide_rows, g.wide_stack, o, d, inv, z, inf, *seeds, False)
    tw = tisect.motion_weight(g, time_).contiguous()
    with pytest.raises(ValueError, match="time_boxes"):
        tc.traverse(*args, motion_rows=g.wide_motion, tw=tw)
    with pytest.raises(ValueError, match="time_boxes"):
        tc.traverse(*args, time_boxes=g.wide_tbox)
    with pytest.raises(ValueError, match="time_boxes"):
        tc.traverse_plain(*args, time_boxes=g.wide_tbox)
    seen = []
    real = tc.traverse_plain
    monkeypatch.setattr(tc, "traverse_plain",
                        lambda *a, **kw: seen.append(kw.get("time_boxes")) or real(*a, **kw))
    tisect.intersect(g, TRay.make(o, d, time=time_))
    assert len(seen) == 1 and seen[0] is g.wide_tbox


@pytest.mark.parametrize("name", ["quad", "blob"])
def test_time_boxes_built_alike(scenes, name):
    """The builder's table, ``build_wide_bvh``'s and the one
    ``scene_from_numpy`` makes from the JAX package's rows are the same,
    bit for bit; a static table has none."""
    jb, g = scenes[name]
    arrays = jax_scene_arrays(jb)
    gi = scene_from_numpy(arrays, "cpu")[0].geometry
    np.testing.assert_array_equal(gi.wide_tbox.numpy(), g.wide_tbox.numpy())
    np.testing.assert_array_equal(
        wide.time_boxes(g.wide_rows.numpy(), g.wide_motion.numpy()), g.wide_tbox.numpy())
    v0, e1, e2, _ = soup(200)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    assert wide.build_wide_bvh(bvh.build_bvh(lo, hi, max_prims_in_node=8), v0, e1,
                               e2).time_boxes is None
