"""The arithmetic of the traversal kernels' 8-lane groups, on the CPU.

The CUDA kernels (``pbrt_torch/csrc/traverse.cu``) walk each ray with a
group of 8 lanes: the child sort runs as the 6 layers of
``intersect._SORT8``, one shuffle pair per layer, and a leaf's nearest slot
is a 3-round (t, slot) butterfly. The plain versions in
``accel/traverse_cuda.py`` do the same, so these tests hold that form to the
serial one of the JAX package, and the kernel's layer table, read from the
source as text, to the plain version's.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from pbrt_tpu.accel import intersect as jisect
from pbrt_torch.accel import bvh, wide
from pbrt_torch.accel import traverse_cuda as tc
from pbrt_torch.accel.intersect import make_inv_dir

SOURCE = pathlib.Path(tc.__file__).resolve().parent.parent / "csrc" / "traverse.cu"
NAN, INF = math.nan, math.inf


def _serial_sort(key, ref):
    """``intersect._SORT8`` exchange by exchange on (8, C) tensors."""
    key, ref = list(key), list(ref)
    for i, j in jisect._SORT8:
        s = key[i] > key[j]
        key[i], key[j] = torch.where(s, key[j], key[i]), torch.where(s, key[i], key[j])
        ref[i], ref[j] = torch.where(s, ref[j], ref[i]), torch.where(s, ref[i], ref[j])
    return torch.stack(key), torch.stack(ref)


def _patterns(values):
    """All 3**8 = 6,561 assignments of three values to the 8 slots, (8, C)."""
    idx = np.stack(np.unravel_index(np.arange(3 ** 8), (3,) * 8))
    return torch.as_tensor(np.asarray(values, np.float32)[idx])


def test_layers_partition_the_network():
    """Each layer's pairs are disjoint, so a layer is one step of the
    lanes; the layers in order are the serial network."""
    assert tc.SORT8 == tuple(jisect._SORT8)
    assert len(tc.SORT8_LAYERS) == 6
    for layer, part in zip(tc.SORT8_LAYERS, tc.LAYER_PARTNERS):
        slots = [s for pair in layer for s in pair]
        assert len(slots) == len(set(slots))
        assert all(i < j for i, j in layer)
        assert sorted(part) == list(range(8))
        assert all(part[part[k]] == k for k in range(8))


@pytest.mark.parametrize("values", [(0.0, 1.0, 2.0), (0.5, 1.0, INF), (1.0, NAN, INF),
                                    (NAN, -0.0, 0.0)],
                         ids=["three", "inf", "nan", "nan-zeros"])
def test_layered_sort_equals_serial_sort8(values):
    """(a) Keys (bit for bit) and refs of the 6-layer form equal the serial
    ``intersect._SORT8`` on all 6,561 three-valued patterns, with inf, NaN
    (the min/max helpers' NaN; the kernel's keys are inf there) and signed
    zeros among the values."""
    key = _patterns(values)
    ref = torch.arange(8, dtype=torch.int32)[:, None].expand_as(key).contiguous() * 7 - 3
    k_l, r_l = tc.sort8_layers(key, ref)
    k_s, r_s = _serial_sort(key, ref)
    assert torch.equal(k_l.view(torch.int32), k_s.view(torch.int32))
    assert torch.equal(r_l, r_s)
    if not any(math.isnan(v) for v in values):  # a sort (not a stable one)
        assert torch.equal(k_l, key.sort(0).values)


def _scan_first_min(tc_):
    """The serial leaf pick: slot 0, then any slot with a strictly smaller t."""
    best_t, best_k = tc_[0].clone(), torch.zeros(tc_.shape[1], dtype=torch.int64)
    for k in range(1, 8):
        better = tc_[k] < best_t
        best_t = torch.where(better, tc_[k], best_t)
        best_k = torch.where(better, k, best_k)
    return best_t, best_k


def _pick_cases():
    rng = np.random.default_rng(41)
    ties = rng.integers(0, 3, (8, 4000)).astype(np.float32)  # many equal minima
    ties[rng.random((8, 4000)) < 0.4] = INF
    single = np.full((8, 8), INF, np.float32)
    single[np.arange(8), np.arange(8)] = rng.uniform(0.1, 5.0, 8)  # one hit in slot k
    return {
        "ties": ties,
        "all-inf": np.full((8, 16), INF, np.float32),
        "single-hit": single,
        "distinct": rng.uniform(0, 1, (8, 4000)).astype(np.float32),
        "signed-zeros": rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), (8, 4000)),
    }


@pytest.mark.parametrize("case", list(_pick_cases()))
def test_butterfly_pick_equals_first_minimum(case):
    """(b) The 3-round (t, slot) pick equals the first-minimum scan: ties
    go to the first slot, an all-inf column to slot 0, a single hit to its
    own slot; the t it returns is that slot's, bit for bit."""
    tc_ = torch.as_tensor(_pick_cases()[case])
    t, k = tc.pick_first_min(tc_)
    t_s, k_s = _scan_first_min(tc_)
    assert torch.equal(k, k_s)
    assert torch.equal(t.view(torch.int32), t_s.view(torch.int32))
    assert torch.equal(t.view(torch.int32), tc_.gather(0, k[None])[0].view(torch.int32))
    assert torch.equal(k, tc_.min(0).indices)
    if case == "all-inf":
        assert bool((k == 0).all())
    if case == "single-hit":
        assert torch.equal(k, torch.arange(8))


def test_kernel_layer_table_is_sort8_layers():
    """(c) The kernel's ``kSort8Layers`` (read from the source as text) is
    ``SORT8_LAYERS``, pads dropped, so a typo in the CUDA table fails here."""
    text = SOURCE.read_text()
    m = re.search(r"constexpr\s+int\s+kSort8Layers\[6\]\[4\]\[2\]\s*=\s*\{(.*?)\};", text, re.S)
    assert m, "kSort8Layers not found in traverse.cu"
    pairs = [(int(a), int(b)) for a, b in re.findall(r"\{\s*(-?\d+)\s*,\s*(-?\d+)\s*\}", m.group(1))]
    assert len(pairs) == 24
    layers = tuple(tuple(p for p in pairs[4 * L:4 * L + 4] if p != (-1, -1)) for L in range(6))
    assert layers == tc.SORT8_LAYERS


def test_kernel_names_are_the_sources_kernels():
    """The profile of ``chip_smoke.py`` finds the kernels by these names."""
    text = SOURCE.read_text()
    for name in tc.KERNEL_NAMES.values():
        assert re.search(rf"(__global__\s.*\b|PBRT_TRAVERSE_KERNEL\(){name}\b", text), name


def _soup_table(rng, n=300):
    tris = (rng.uniform(-1, 1, (n, 1, 3)) + rng.uniform(-.15, .15, (n, 3, 3))).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    return wide.build_wide_bvh(bvh.build_bvh(lo, hi, max_prims_in_node=8), v0, e1, e2)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_lane_steps_count_the_walk(any_hit):
    """(d) The plain version's per-lane steps sum to node + leaf steps;
    lanes with tmax == 0 take none, every other lane at least the root."""
    rng = np.random.default_rng(43)
    w = _soup_table(rng)
    R = 256
    o = torch.as_tensor(rng.uniform(-2, 2, (R, 3)).astype(np.float32))
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    tmax = torch.as_tensor(np.where(rng.random(R) < 0.25, 0.0, np.inf).astype(np.float32))
    z = torch.zeros(R)
    seeds = (tmax.clone(), torch.full((R,), -1, dtype=torch.int32), z.clone(), z.clone())
    stats = {}
    _, prim, _, _ = tc.traverse_plain(torch.as_tensor(w.rows), w.max_stack, o, d,
                                      make_inv_dir(d), z, tmax, *seeds, any_hit,
                                      stats=stats)
    steps = stats["lane_steps"]
    assert steps.shape == (R,) and steps.dtype == torch.int64
    assert int(steps.sum()) == stats["node_steps"] + stats["leaf_steps"]
    assert bool((steps[tmax == 0] == 0).all())
    assert bool((steps[tmax != 0] >= 1).all())
    assert int((prim >= 0).sum()) > 5
    assert int(steps.max()) > 2


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_row_counts_split_node_and_leaf(any_hit):
    """The distinct rows of the bound: one ray visits each row of the tree
    at most once, so alone it reads as many node rows and leaf rows as it
    takes node and leaf steps; a batch reads at most its steps' worth."""
    rng = np.random.default_rng(47)
    w = _soup_table(rng)
    rows = torch.as_tensor(w.rows)
    R = 64
    o = torch.as_tensor(rng.uniform(-2, 2, (R, 3)).astype(np.float32))
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    z, inf = torch.zeros(R), torch.full((R,), float("inf"))
    seeds = (inf.clone(), torch.full((R,), -1, dtype=torch.int32), z.clone(), z.clone())
    args = (o, d, make_inv_dir(d), z, inf, *seeds)
    walked = 0
    for lane in range(R):
        one = {}
        tc.traverse_plain(rows, w.max_stack, *(x[lane:lane + 1] for x in args),
                          any_hit, stats=one)
        assert one["node_rows"] == one["node_steps"] >= 1
        assert one["leaf_rows"] == one["leaf_steps"]
        walked += one["leaf_steps"] > 0
    assert walked > 5
    batch = {}
    tc.traverse_plain(rows, w.max_stack, *args, any_hit, stats=batch)
    assert 1 <= batch["node_rows"] <= batch["node_steps"]
    assert 1 <= batch["leaf_rows"] <= batch["leaf_steps"]
    assert batch["node_rows"] + batch["leaf_rows"] <= rows.shape[0]
