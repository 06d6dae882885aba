"""Parity of the port's traversal (kernel (a)) with the JAX package.

- The plain step against the TPU kernel's own body,
  ``pl.pallas_call(pbrt_tpu.accel.pallas_step._step_kernel, ...,
  interpret=True)`` with ``step_interpret``'s GridSpec.
- The traversal against ``pbrt_tpu.accel.intersect.intersect`` (closest
  and any-hit) and ``intersect_brute``, on the fuzz and deep-stack cases of
  tests/test_intersect.py:251-326 at tier-1 sizes.

Why some comparisons carry a tolerance: XLA's CPU backend contracts
``a*b + c*d`` into ``fma(a, b, c*d)`` in compiled code (the jitted
intersect and the interpreted Pallas body), while the port rounds every
product and sum as its CUDA kernel does (built with -fmad=false). Floats
therefore differ by a few ulps, more where a sum cancels; hit/miss and prim
ids agree except on exact-t ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pbrt_tpu.accel import bvh as jbvh
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.accel import pallas_step
from pbrt_tpu.accel.wide import LEAF_TRIS, build_wide_bvh
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.accel import traverse_cuda as tc
from pbrt_torch.core.geometry import Ray as TRay


def _soup(rng, n=300, spread=0.15):
    centers = rng.uniform(-1, 1, (n, 1, 3))
    return (centers + rng.uniform(-spread, spread, (n, 3, 3))).astype(np.float32)


def _rand_rays(rng, n=400):
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _sphere(c, r):
    o2w = np.eye(4, dtype=np.float32)
    o2w[:3, 3] = c
    return o2w, [r, -r, r, 2 * np.pi, 0, 0, 0, 0]


def _geometries(tris, spheres=()):
    """The same triangles and spheres as a JAX SceneGeometry (wide rows from
    the JAX builder) and as the port's SceneGeometry on the CPU."""
    T, Q = len(tris), len(spheres)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    tree = jbvh.build_bvh(tris.min(1), tris.max(1), max_prims_in_node=LEAF_TRIS)
    wide = build_wide_bvh(tree, v0, e1, e2)
    o2w = np.asarray([s[0] for s in spheres], np.float32).reshape(Q, 4, 4)
    w2o = np.asarray([np.linalg.inv(s[0]) for s in spheres], np.float32).reshape(Q, 4, 4)
    prm = np.asarray([s[1] for s in spheres], np.float32).reshape(Q, 8)
    uv = np.zeros((T, 2), np.float32)
    f, i32 = jnp.asarray, lambda n, v: jnp.full(n, v, jnp.int32)
    jg = jisect.pack_geometry(jisect.SceneGeometry(
        wide_rows=f(wide.rows), wide_stack=wide.max_stack,
        tri_v0=f(v0), tri_e1=f(e1), tri_e2=f(e2), tri_n0=f(fn), tri_n1=f(fn),
        tri_n2=f(fn), tri_uv0=f(uv), tri_uv1=f(uv), tri_uv2=f(uv),
        tri_material=i32(T, 0), tri_area_light=i32(T, -1), tri_mesh_id=i32(T, 0),
        quad_type=i32(Q, 0), quad_o2w=f(o2w), quad_w2o=f(w2o), quad_params=f(prm),
        quad_material=i32(Q, 0), quad_area_light=i32(Q, -1), quad_mesh_id=i32(Q, 0),
        quad_reverse=jnp.zeros(Q, bool), quad_active_types=(0,),
        node_lo=f(tree.node_lo), node_hi=f(tree.node_hi),
        node_second=f(tree.node_second), node_count=f(tree.node_count),
        node_axis=f(tree.node_axis), prim_order=f(tree.prim_order),
        world_lo=f(tris.reshape(-1, 3).min(0)), world_hi=f(tris.reshape(-1, 3).max(0)),
    ))
    t, l64 = torch.as_tensor, lambda n, v: torch.full((n,), v, dtype=torch.int64)
    tg = tisect.SceneGeometry(
        tri_v0=t(v0), tri_e1=t(e1), tri_e2=t(e2), tri_n0=t(fn), tri_n1=t(fn),
        tri_n2=t(fn), tri_uv0=t(uv), tri_uv1=t(uv), tri_uv2=t(uv),
        tri_material=l64(T, 0), tri_area_light=l64(T, -1), tri_mesh_id=l64(T, 0),
        quad_type=l64(Q, 0), quad_o2w=t(o2w), quad_w2o=t(w2o), quad_params=t(prm),
        quad_material=l64(Q, 0), quad_area_light=l64(Q, -1), quad_mesh_id=l64(Q, 0),
        quad_reverse=torch.zeros(Q, dtype=torch.bool),
        wide_rows=t(wide.rows), wide_stack=wide.max_stack,
    )
    return jg, tg


def _hits(g_j, g_t, o, d, any_hit=False, tmax=None):
    jr = JRay.make(jnp.asarray(o), jnp.asarray(d),
                   tmax=None if tmax is None else jnp.asarray(tmax))
    tr = TRay.make(torch.as_tensor(o), torch.as_tensor(d),
                   tmax=None if tmax is None else torch.as_tensor(tmax))
    hj = jisect.intersect(g_j, jr, any_hit=any_hit)
    ht = tisect.intersect(g_t, tr, any_hit=any_hit)
    return ([np.asarray(x) for x in (hj.t, hj.prim, hj.b1, hj.b2)],
            [x.numpy() for x in (ht.t, ht.prim, ht.b1, ht.b2)], jr, tr)


def _assert_closest_match(j, t, prim_agree=0.99, rtol=1e-6):
    """Hit/miss equal; t within rtol; prims equal except on exact-t ties.
    Against the JAX package the callers pass rtol 1e-5: its jitted
    Möller–Trumbore is FMA-contracted (measured up to 2.6e-6 relative)."""
    np.testing.assert_array_equal(t[1] >= 0, j[1] >= 0)
    v = j[1] >= 0
    np.testing.assert_allclose(t[0][v], j[0][v], rtol=rtol)
    assert (t[1] == j[1])[v].mean() >= prim_agree


# ---------------------------------------------------------------------------
# the step against the Pallas kernel body
# ---------------------------------------------------------------------------


def _pallas_step(row, o, d, inv, tmin, t_best, is_node, act):
    """``step_interpret``'s call, with interpret=True."""
    R, BLK = row.shape[0], pallas_step.BLK
    lim = jnp.stack([tmin, t_best], -1)
    flag = jnp.stack([is_node.astype(jnp.float32), act.astype(jnp.float32)], -1)
    spec = lambda w: pl.BlockSpec((BLK, w), lambda i: (i, 0), memory_space=pltpu.VMEM)
    ospec = lambda h: pl.BlockSpec((h, BLK), lambda i: (0, i), memory_space=pltpu.VMEM)
    refs, nhit, leaf = pl.pallas_call(
        pallas_step._step_kernel,
        out_shape=(jax.ShapeDtypeStruct((8, R), jnp.int32),
                   jax.ShapeDtypeStruct((1, R), jnp.int32),
                   jax.ShapeDtypeStruct((4, R), jnp.float32)),
        grid_spec=pl.GridSpec(
            grid=(R // BLK,),
            in_specs=[spec(80), spec(3), spec(3), spec(3), spec(2), spec(2)],
            out_specs=(ospec(8), ospec(1), ospec(4))),
        interpret=True,
    )(row, o, d, inv, lim, flag)
    return (np.asarray(refs), np.asarray(nhit[0]), np.asarray(leaf[0]),
            np.asarray(leaf[1]).astype(np.int32), np.asarray(leaf[2]),
            np.asarray(leaf[3]))


def _step_inputs(seed, R=512):
    """Gathered rows of a soup's wide table with rays that hit: leaf lanes
    aim at a triangle of their row, node lanes at a child box, a quarter of
    the node lanes start at a box corner shared by several children (equal
    entry keys)."""
    rng = np.random.default_rng(seed)
    tris = _soup(rng, 400)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    tree = jbvh.build_bvh(tris.min(1), tris.max(1), max_prims_in_node=LEAF_TRIS)
    rows = build_wide_bvh(tree, v0, e1, e2).rows
    node_rows, leaf_rows, walk = [], [], [0]
    while walk:
        r = walk.pop()
        node_rows.append(r)
        refs = rows[r, 48:56][rows[r, 0:8] <= rows[r, 8:16]].astype(np.int64)
        walk += refs[refs >= 0].tolist()
        leaf_rows += (-refs[refs < 0] - 1).tolist()
    is_node = rng.random(R) < 0.5
    ridx = np.where(is_node, rng.choice(node_rows, R), rng.choice(leaf_rows, R))
    row = rows[ridx]
    o = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    target = np.empty((R, 3), np.float32)
    for i in range(R):
        r = row[i]
        if is_node[i]:
            k = rng.integers(0, 8)
            while r[k] > r[8 + k]:
                k = rng.integers(0, 8)
            lo = r[[k, 16 + k, 32 + k]]
            hi = r[[8 + k, 24 + k, 40 + k]]
            target[i] = lo + rng.random(3) * (hi - lo)
            if i % 4 == 0:
                o[i] = lo  # on a box corner: several boxes enter at tmin
        else:
            ids = np.nonzero(r[72:80] >= 0)[0]
            k = rng.choice(ids)
            a, b = rng.random(2) * 0.5
            target[i] = (r[[k, 8 + k, 16 + k]] + a * r[[24 + k, 32 + k, 40 + k]]
                         + b * r[[48 + k, 56 + k, 64 + k]])
    d = target - o
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    d = d.astype(np.float32)
    inv = tisect.make_inv_dir(torch.as_tensor(d)).numpy()
    tmin = np.zeros(R, np.float32)
    t_best = np.where(rng.random(R) < 0.6, np.inf, rng.uniform(0.2, 4, R)).astype(np.float32)
    act = rng.random(R) < 0.9
    return row, o, d, inv, tmin, t_best, is_node, act


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_step_matches_pallas_kernel_body(seed):
    """n_hit, psel equal; refs[:n_hit] equal as sets per lane, and in order
    where the hit entry keys are distinct (the Pallas network orders ties
    differently from intersect._SORT8, which the port follows). On lanes
    with a hit, tsel rtol 1e-4 and b1, b2 atol 1e-3: the rays aim at small
    triangles from afar, so det is small and the FMA-vs-rounded difference
    (module docstring) is amplified up to ~4e-4 in b2 — both packages are
    that far from the float64 value, checked below."""
    args = _step_inputs(seed)
    row, o, d, inv, tmin, t_best, is_node, act = args
    ref = _pallas_step(*[jnp.asarray(a) for a in args])
    out = [x.numpy() for x in tc.step(*[torch.as_tensor(a) for a in args])]
    refs_j, nhit_j, tsel_j, psel_j, b1_j, b2_j = ref
    refs_t, nhit_t, tsel_t, psel_t, b1_t, b2_t = out
    np.testing.assert_array_equal(nhit_t, nhit_j)
    assert (nhit_t > 1).sum() > 20  # the sort is exercised
    np.testing.assert_array_equal(psel_t, psel_j)
    # entry keys of the hit slots, to find lanes without ties
    lo = np.stack([row[:, 0:8], row[:, 16:24], row[:, 32:40]])
    hi = np.stack([row[:, 8:16], row[:, 24:32], row[:, 40:48]])
    t0 = (lo - o.T[:, :, None]) * inv.T[:, :, None]
    t1 = (hi - o.T[:, :, None]) * inv.T[:, :, None]
    enter = np.maximum(np.minimum(t0, t1).max(0), tmin[:, None])
    n_tied = 0
    for i in range(len(row)):
        n = nhit_j[i]
        assert sorted(refs_t[:n, i]) == sorted(refs_j[:n, i])
        keys = np.sort(enter[i][np.isin(row[i, 48:56].astype(np.int32), refs_j[:n, i])])
        if n > 1 and np.all(np.diff(keys) > 0):
            np.testing.assert_array_equal(refs_t[:n, i], refs_j[:n, i])
        elif n > 1:
            n_tied += 1
    assert n_tied > 0  # the corner origins produce ties
    np.testing.assert_array_equal(np.isinf(tsel_t), np.isinf(tsel_j))
    fin = np.isfinite(tsel_j)
    assert fin.sum() > 50
    np.testing.assert_allclose(tsel_t[fin], tsel_j[fin], rtol=1e-4)
    np.testing.assert_allclose(b1_t[fin], b1_j[fin], atol=1e-3)
    np.testing.assert_allclose(b2_t[fin], b2_j[fin], atol=1e-3)
    # both are float32 evaluations of the same Möller–Trumbore: against the
    # float64 value of the selected triangle, the port is as accurate as
    # the reference (its largest error within 4x the reference's)
    exact = []
    for i in np.nonzero(fin)[0]:
        r = row[i].astype(np.float64)
        k = int(np.nonzero(r[72:80] == psel_j[i])[0][0])
        v0, e1, e2 = (r[[c + k, c + 8 + k, c + 16 + k]] for c in (0, 24, 48))
        dd, oo = d[i].astype(np.float64), o[i].astype(np.float64)
        pv = np.cross(dd, e2)
        det = e1 @ pv
        qv = np.cross(oo - v0, e1)
        exact.append(((e2 @ qv) / det, ((oo - v0) @ pv) / det, (dd @ qv) / det))
    exact = np.asarray(exact).T
    for got_t, got_j, ex in zip((tsel_t, b1_t, b2_t), (tsel_j, b1_j, b2_j), exact):
        err_t = np.abs(got_t[fin] - ex).max()
        err_j = np.abs(got_j[fin] - ex).max()
        assert err_t <= 4.0 * err_j + 1e-6


def _sort_order(net, key):
    key, ref = list(key), list(range(8))
    for i, j in net:
        if key[i] > key[j]:
            key[i], key[j] = key[j], key[i]
            ref[i], ref[j] = ref[j], ref[i]
    return tuple(ref)


def test_sort_networks_sort_but_order_ties_differently():
    """The port's SORT8 is intersect._SORT8. It and the Pallas kernel's
    list both sort every 0/1 input (valid 19-comparator networks) but
    place equal keys differently on 1,520 of the 6,561 three-valued key
    patterns, so the two steps' child order can differ on ties."""
    assert tuple(tc.SORT8) == tuple(jisect._SORT8)
    pallas_net = tuple(pallas_step._SORT8)
    assert len(tc.SORT8) == len(pallas_net) == 19
    for net in (tc.SORT8, pallas_net):
        for bits in range(256):
            key = [(bits >> k) & 1 for k in range(8)]
            assert [key[r] for r in _sort_order(net, key)] == sorted(key)
    keys = np.stack(np.unravel_index(np.arange(3 ** 8), (3,) * 8), -1)
    differ = sum(_sort_order(tc.SORT8, k) != _sort_order(pallas_net, k)
                 for k in keys.tolist())
    assert differ == 1520


def test_step_without_256_lane_blocks():
    """The port's step takes any R (the Pallas launch needs R % 256 == 0);
    a 300-lane call equals the first 300 lanes of the 512-lane call."""
    args = _step_inputs(2)
    full = tc.step(*[torch.as_tensor(a) for a in args])
    part = tc.step(*[torch.as_tensor(a[:300]) for a in args])
    np.testing.assert_array_equal(part[0].numpy(), full[0][:, :300].numpy())
    for a, b in zip(part[1:], full[1:]):
        np.testing.assert_array_equal(a.numpy(), b[:300].numpy())


# ---------------------------------------------------------------------------
# traversal against intersect / intersect_brute
# ---------------------------------------------------------------------------


def test_wide_traversal_matches_jax_fuzz():
    rng = np.random.default_rng(11)
    jg, tg = _geometries(_soup(rng))
    o, d = _rand_rays(rng, 1000)
    j, t, _, tr = _hits(jg, tg, o, d)
    assert (j[1] >= 0).sum() > 20
    _assert_closest_match(j, t, rtol=1e-5)
    b = tisect.intersect_brute(tg, tr)
    _assert_closest_match([x.numpy() for x in (b.t, b.prim)], t)


def test_wide_traversal_mixed_spheres_fuzz():
    rng = np.random.default_rng(13)
    spheres = [_sphere(rng.uniform(-1, 1, 3), 0.3) for _ in range(5)]
    tris = _soup(rng, 150)
    jg, tg = _geometries(tris, spheres)
    o, d = _rand_rays(rng)
    j, t, jr, tr = _hits(jg, tg, o, d)
    assert (t[1] >= len(tris)).sum() > 10  # sphere hits seed t_best
    _assert_closest_match(j, t, rtol=1e-5)
    jb = jisect.intersect_brute(jg, jr)
    tb = tisect.intersect_brute(tg, tr)
    _assert_closest_match([np.asarray(jb.t), np.asarray(jb.prim)],
                          [tb.t.numpy(), tb.prim.numpy()], rtol=1e-5)
    _assert_closest_match([tb.t.numpy(), tb.prim.numpy()], t)


def test_wide_traversal_any_hit_fuzz():
    """Any-hit agrees with JAX on hit/miss (and so with the brute closest
    hit); any reported t is a genuine hit not before the closest one."""
    rng = np.random.default_rng(17)
    jg, tg = _geometries(_soup(rng))
    o, d = _rand_rays(rng, 1000)
    tmax = np.where(rng.random(len(o)) < 0.5, np.inf, rng.uniform(0.1, 3, len(o)))
    tmax = tmax.astype(np.float32)
    j, t, _, tr = _hits(jg, tg, o, d, any_hit=True, tmax=tmax)
    np.testing.assert_array_equal(t[1] >= 0, j[1] >= 0)
    b = tisect.intersect_brute(tg, tr)
    np.testing.assert_array_equal(t[1] >= 0, b.prim.numpy() >= 0)
    v = t[1] >= 0
    assert v.sum() > 20
    assert np.all(t[0][v] >= b.t.numpy()[v] * (1 - 1e-6))


def test_wide_traversal_deep_stack_adversarial():
    """4096 coaxial stacked triangles and rays down the axis: every node on
    the path overlaps the ray, the stack runs to its build-time bound."""
    rng = np.random.default_rng(23)
    n = 4096
    z = np.linspace(0.0, 40.0, n).astype(np.float32)
    tris = np.stack([np.stack([np.full(n, -1.0), np.full(n, -1.0), z], -1),
                     np.stack([np.full(n, 3.0), np.full(n, -1.0), z], -1),
                     np.stack([np.full(n, -1.0), np.full(n, 3.0), z], -1)],
                    axis=1).astype(np.float32)
    jg, tg = _geometries(tris)
    o = np.array([[0.0, 0.0, -1.0]], np.float32).repeat(8, 0)
    o[:, 0] = rng.uniform(-0.5, 0.5, 8)
    d = np.array([[0.0, 0.0, 1.0]], np.float32).repeat(8, 0)
    j, t, _, _ = _hits(jg, tg, o, d)
    assert np.all(t[1] >= 0)
    np.testing.assert_allclose(t[0], 1.0, rtol=1e-6)
    _assert_closest_match(j, t, prim_agree=1.0, rtol=1e-5)
    o2 = np.array([[0.0, 0.0, 20.001]], np.float32)
    d2 = np.array([[0.0, 0.0, -1.0]], np.float32)
    j2, t2, _, tr2 = _hits(jg, tg, o2, d2)
    b2 = tisect.intersect_brute(tg, tr2)
    assert t2[1][0] >= 0
    np.testing.assert_allclose(t2[0], b2.t.numpy(), rtol=1e-6)
    _assert_closest_match(j2, t2, prim_agree=1.0, rtol=1e-5)


def test_plain_traversal_stats_and_tmax_zero():
    """Lanes with tmax = 0 take no step; stats count the work."""
    rng = np.random.default_rng(29)
    _, tg = _geometries(_soup(rng, 200))
    o, d = _rand_rays(rng, 64)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    inv = tisect.make_inv_dir(d)
    z = torch.zeros(64)
    seeds = (z.clone(), torch.full((64,), -1, dtype=torch.int32), z.clone(), z.clone())
    stats = {}
    t, p, _, _ = tc.traverse_plain(tg.wide_rows, tg.wide_stack, o, d, inv, z, z,
                                   *seeds, False, stats=stats)
    lane_steps = stats.pop("lane_steps")
    assert stats == {"node_steps": 0, "leaf_steps": 0, "node_rows": 0, "leaf_rows": 0}
    assert torch.equal(lane_steps, torch.zeros(64, dtype=torch.int64))
    assert bool((p == -1).all()) and bool((t == 0).all())
    inf = torch.full((64,), float("inf"))
    tc.traverse_plain(tg.wide_rows, tg.wide_stack, o, d, inv, z, inf,
                      inf.clone(), *seeds[1:], False, stats=stats)
    assert stats["node_steps"] >= 64 and stats["node_rows"] >= 1
    assert 1 <= stats["leaf_rows"] <= stats["leaf_steps"]
    assert stats["node_rows"] + stats["leaf_rows"] <= tg.wide_rows.shape[0]
