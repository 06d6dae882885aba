"""The instance phase's schedule (``traverse_cuda.traverse_instances_plain``,
the instance kernels' plain version) against the JAX package's serial
phase (``intersect.py:1060-1111``), on the CPU.

The kernels box-test 8 instances a round, one a lane, and each ray steps
through its own candidates, re-testing each at its t of that moment; the
plain version takes the same schedule. It must give each lane the serial
loop's walks, so these tests hold it to JAX's ``intersect`` bit for bit in
t, prim, b1 and b2, with inst equal:

- (a) on the instanced tie scene (``chip_smoke.instance_tie_scene_text``:
  one box used three times, two uses at one transform, the third turned a
  quarter, and a world triangle on their bottom face; every coordinate
  dyadic), where several instances' walks reach the same t and the serial
  order and the strict t < t_best decide, closest and any hit;
- (b) on ``tests/test_instancing.py``'s wedge scenes and the 8-use blob
  scene (``chip_smoke.instanced_scene_text(SMALL_BLOB_FREQ, grid=(4, 2))``)
  at 4,096 seeded rays;
- (c) the per-lane and per-warp stats against the totals;
- (d) ``traverse.cu``'s round width, read as text, against the plain
  version's.

The JAX side runs operation by operation: its unjitted
``intersect._intersect_impl`` with ``lax.while_loop`` and ``lax.fori_loop``
as Python loops, so each operation is dispatched on its own. Compiled
whole, XLA contracts the step's products into FMAs, which the kernels'
``-fmad=false`` and the plain versions do not. XLA's ``dot`` contracts them
even alone, so the instance transform ``o @ M^T`` (``intersect.py:1075-
1076``) is taken in its written order, each column ((x m0 + y m1) + z m2),
by patching the array type's ``@`` for the call; every other operation is
JAX's own.
"""

import pathlib
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity_util  # noqa: F401  (one torch thread per worker)
from pbrt_tpu.accel import intersect as jisect
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.accel import intersect as tisect
from pbrt_torch.accel import traverse_cuda as tc
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from test_instancing import FOOTER, HEADER, OBJ, USES

SOURCE = pathlib.Path(tc.__file__).resolve().parent.parent / "csrc" / "traverse.cu"
N_RAYS = 4096
TEXTS = {
    "tie": chip_smoke.instance_tie_scene_text(),
    "wedge": HEADER + OBJ + USES + FOOTER,
    "wedge_only": HEADER + OBJ + USES + "WorldEnd\n",
    "blob8": chip_smoke.instanced_scene_text(chip_smoke.SMALL_BLOB_FREQ, res=16, grid=(4, 2)),
}
_ARRAY = type(jnp.zeros(1))


def _matmul_in_order(a, b):
    """(R, 3) @ (3, C), each column summed as ((x b0 + y b1) + z b2)."""
    return jnp.stack([a[:, 0] * b[0, c] + a[:, 1] * b[1, c] + a[:, 2] * b[2, c]
                      for c in range(b.shape[1])], -1)


@pytest.fixture(scope="module")
def scenes():
    """name → (JAX build, the port's build on the CPU)."""
    return {name: (jbuild(jload(text)), tbuild(tload(text), device="cpu"))
            for name, text in TEXTS.items()}


def _rays(name, tb):
    """4,096 seeded rays of each scene: the tie scene's along z over its
    footprint, the wedges' half random (test_instancing's fuzz) and half
    aimed at the uses, the blob scene's camera and bounce rays."""
    if name == "tie":
        return chip_smoke.instance_tie_rays(N_RAYS, seed=3)
    if name == "blob8":
        gen = torch.Generator().manual_seed(20)
        o, d, _, _, _ = chip_smoke.camera_and_bounce_rays(tb, torch.device("cpu"), N_RAYS, gen,
                                                          times=False)
        return o.numpy(), d.numpy()
    rng = np.random.default_rng(20)
    n = N_RAYS // 2
    o = rng.uniform(-4, 4, (N_RAYS, 3))
    o[:n, 1] = rng.uniform(0.2, 4.0, n)
    d = rng.normal(size=(N_RAYS, 3))
    centres = np.array([[-2.5, .5, -.3], [2.5, .5, -.3], [0, .5, 1.7]])
    target = centres[rng.integers(0, 3, n)] + rng.normal(0, .35, (n, 3))
    o[n:] = target + rng.normal(0, 1, (n, 3)) * 3 + [0, 2, -3]
    d[n:] = target - o[n:]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _while(cond, body, x):
    while bool(cond(x)):
        x = body(x)
    return x


def _fori(lo, hi, body, x):
    for i in range(int(lo), int(hi)):
        x = body(i, x)
    return x


def _jax_hit(jb, o, d, tmax, any_hit):
    with mock.patch.object(jax.lax, "while_loop", _while), \
            mock.patch.object(jax.lax, "fori_loop", _fori), \
            mock.patch.object(_ARRAY, "__matmul__", _matmul_in_order):
        h = jisect._intersect_impl(jb.scene.geometry, JRay.make(
            jnp.asarray(o), jnp.asarray(d), tmax=None if tmax is None else jnp.asarray(tmax)),
            any_hit)
    return [np.asarray(x) for x in (h.t, h.prim, h.b1, h.b2, h.inst)]


def _port_hit(tb, o, d, tmax, any_hit):
    h = tisect.intersect(tb.scene.geometry, TRay.make(
        torch.as_tensor(o), torch.as_tensor(d),
        tmax=None if tmax is None else torch.as_tensor(tmax)), any_hit=any_hit)
    return [x.numpy() for x in (h.t, h.prim, h.b1, h.b2, h.inst)]


def _cut(t, past):
    """Any-hit segments: on even lanes the closest hit plus ``past``, on odd
    lanes half of it; 1e30 where nothing was hit."""
    lane = np.arange(t.shape[0])
    cut = np.where(lane % 2 == 0, t + np.float32(past), t * np.float32(0.5))
    return np.where(np.isfinite(t), cut, np.float32(1e30)).astype(np.float32)


def _assert_bits(port, jax_, label):
    for name, a, b in zip(("t", "prim", "b1", "b2", "inst"), port, jax_):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{label}: {name}")


def _walks_alone(g, o, d, tmin, tmax):
    """(I, R) each instance's closest t walked alone from no hit (the
    plain phase over that one instance)."""
    R = o.shape[0]
    inv = tisect.make_inv_dir(d).contiguous()
    seeds = (tmax.clone(), torch.full((R,), -1, dtype=torch.int32), torch.zeros(R),
             torch.zeros(R))
    return torch.stack([tc.traverse_instances_plain(
        g.inst_rows, g.inst_stack, g.inst_w2o[n:n + 1], g.inst_lo[n:n + 1],
        g.inst_hi[n:n + 1], g.inst_root[n:n + 1], o, d, inv, tmin, tmax, *seeds, False)[0]
        for n in range(g.num_instances)])


@pytest.mark.parametrize("any_hit", [False, True])
def test_tie_scene_bit_equal_to_jax(scenes, any_hit):
    """(a) The instanced tie scene on 4,096 rays along z: t, prim, b1 and
    b2 bit for bit and inst equal to JAX's ``intersect``, closest hit and
    any hit on segments cut 2^-20 past the closest hit or at half of it.
    The scene ties: on most hit lanes at least two uses' walks alone reach
    the lane's closest t, and from below the world triangle reaches it too;
    the first use in the serial order keeps the hit (inst 0, or -1 where
    the world triangle holds it)."""
    jb, tb = scenes["tie"]
    g = tb.scene.geometry
    assert g.num_instances == 3
    o, d = _rays("tie", tb)
    closest = _port_hit(tb, o, d, None, False)
    tmax = _cut(closest[0], 2.0 ** -20) if any_hit else None
    port = _port_hit(tb, o, d, tmax, any_hit)
    _assert_bits(port, _jax_hit(jb, o, d, tmax, any_hit), f"tie any_hit={any_hit}")
    hit = closest[1] >= 0
    assert hit.mean() > 0.9
    alone = _walks_alone(g, torch.as_tensor(o), torch.as_tensor(d), torch.zeros(N_RAYS),
                         torch.full((N_RAYS,), float("inf"))).numpy()
    reach = (alone == closest[0][None]).sum(0)
    assert (reach[hit] >= 2).mean() > 0.9 and (reach[hit] == 3).sum() > 1000
    world_ties = hit & (closest[4] == -1)  # the world triangle's hit, tied by the uses
    assert world_ties.sum() > 500 and (reach[world_ties] >= 2).all()
    assert set(np.unique(closest[4]).tolist()) == {-1, 0}
    if any_hit:
        assert 0 < (port[1] >= 0).sum() < hit.sum()


@pytest.mark.parametrize("name", ["wedge", "wedge_only", "blob8"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_schedule_bit_equal_to_jax(scenes, name, any_hit):
    """(b) The plain phase's schedule against JAX's serial phase on the
    wedge scenes (the three uses of test_instancing, with and without the
    world's ground) and the 8-use blob scene: 4,096 seeded rays, t, prim,
    b1, b2 bit for bit and inst equal, closest hit and any hit on segments
    cut 2^-20 past the closest hit or at half of it."""
    jb, tb = scenes[name]
    o, d = _rays(name, tb)
    closest = _port_hit(tb, o, d, None, False)
    tmax = _cut(closest[0], 2.0 ** -20) if any_hit else None
    port = _port_hit(tb, o, d, tmax, any_hit)
    _assert_bits(port, _jax_hit(jb, o, d, tmax, any_hit), f"{name} any_hit={any_hit}")
    assert (closest[4] >= 0).sum() >= 30


@pytest.mark.parametrize("name", ["wedge", "blob8"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_sum_to_totals(scenes, name, any_hit):
    """(c) The plain phase's per-lane counts sum to its totals (walks; BLAS
    steps = node + leaf steps); each lane's box tests are whole rounds of
    the instances (every instance for a closest-hit lane that takes part,
    fewer once an any-hit lane has its hit); and per warp of 4 lanes each
    group stepping through its own candidates costs no more than the warp
    walking one instance at a time (its longest walk per instance)."""
    _, tb = scenes[name]
    g = tb.scene.geometry
    o, d = (torch.as_tensor(x) for x in _rays(name, tb))
    R, I = o.shape[0], g.num_instances
    inv = tisect.make_inv_dir(d).contiguous()
    tmin, tmax = torch.zeros(R), torch.full((R,), float("inf"))
    q = (tmax.clone(), torch.full((R,), -1, dtype=torch.int32), torch.zeros(R), torch.zeros(R))
    world = tc.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax, *q, any_hit=any_hit)
    st = {}
    tc.traverse_instances_plain(g.inst_rows, g.inst_stack, g.inst_w2o, g.inst_lo, g.inst_hi,
                                g.inst_root, o, d, inv, tmin, tmax, *world, any_hit, stats=st)
    assert st["walks"] > 0 and int(st["walks_lane"].sum()) == st["walks"]
    assert int(st["lane_steps"].sum()) == st["node_steps"] + st["leaf_steps"]
    assert st["prunes"] == R * I
    box = st["box_tests_lane"]
    assert box.shape == (R,) and int(box.max()) == I
    if any_hit:
        assert int(box.min()) == 0 and int(box.sum()) < R * I
    else:
        assert (box == I).all()
    serial, own = st["warp_serial_steps"], st["warp_own_steps"]
    assert serial.shape == own.shape == ((R + 3) // 4,)
    assert (own <= serial).all() and int(own.sum()) > 0
    lanes = st["lane_steps"].view(-1, 4)
    assert torch.equal(own, lanes.max(1).values)


def test_kernel_round_width_is_plain_round():
    """(d) ``traverse.cu``'s ``kInstanceRound`` (instances a group
    box-tests at once, one a lane) is the plain version's
    ``INSTANCE_ROUND``: 8, the lanes of a group; its ``kInstThreads`` (the
    instance kernels' block) is ``INSTANCE_BLOCK_THREADS``, which the lab
    and ``chip_smoke.py`` read."""
    src = SOURCE.read_text()
    m = re.search(r"constexpr int kInstanceRound = (\d+);", src)
    assert m is not None
    assert int(m.group(1)) == tc.INSTANCE_ROUND == 8
    assert re.search(r"static_assert\(kInstanceRound == kGroup", src)
    m = re.search(r"constexpr int kInstThreads = (\d+);", src)
    assert m is not None and int(m.group(1)) == tc.INSTANCE_BLOCK_THREADS
