"""Wide-BVH traversal: CUDA kernel wrappers and their plain PyTorch versions.

Kernel (a) of the port. It replaces ``pbrt_tpu/accel/pallas_step.py:
_step_kernel`` — the Pallas TPU kernel for the traversal step's interpret
phase — and the XLA step it stands for (``intersect.py:897-979``), together
with the loops around them (``_step_control`` and the warm / straggler
phases of ``_traverse_wide_batch``). The CUDA source is
``pbrt_torch/csrc/traverse.cu``. What bounds it on an H100 is the
dependent chain of a launch's longest ray: each step one L2 round trip for
its row plus a short serial stream of instructions, not the bytes. So a
group of 8 lanes walks each ray, lane k owning the row's slot k: 8× the
threads, the sort as 6 layers of shuffles (``SORT8_LAYERS``), the leaf's
nearest slot as a 3-round (t, slot) butterfly, the stack in shared memory;
the 4 groups of a warp step together, so every shuffle spans the warp.

Wrappers, each kernel with a launch counter (``launches``):

- ``step`` — one interpret step with ``step_interpret``'s contract, any R;
- ``traverse(..., any_hit=False)`` — closest hit, one 8-lane group per ray;
- ``traverse(..., any_hit=True)`` — any hit;
- ``traverse(..., motion_rows=, tw=, time_boxes=)`` — the same walks on a
  motion scene, each row lerped by the ray's shutter weight before the
  step (``intersect.py:873-874``): ``traverse_{closest,any}_motion``. Each
  node step also tests every child's box at the ray's shutter weight
  (``wide.time_boxes``, the port's own table) and drops the children it
  misses from the sorted order: the union walk's result, bit for bit, at a
  fraction of its steps;
- ``traverse_instances`` — the instance phase (``intersect.py:1060-1111``),
  one launch for all instances, seeded with the world walk's result:
  ``traverse_instances_{closest,any}``, which also give each lane's
  instance (−1 where no instance changed the hit). Each group's 8 lanes
  box-test 8 instances at once (``INSTANCE_ROUND``) and the group steps
  through its own ray's candidates in the serial order, re-testing each at
  its t of the moment, so each ray's walks are the serial phase's.

Each takes its plain version when the tensors lie on the CPU and launches
its kernel when they lie on a CUDA device; a CUDA tensor never falls back.
The plain versions (``step_plain``, ``traverse_plain``,
``traverse_instances_plain``) repeat the kernels' arithmetic in the same
operation order, the sort by the same layers and
the leaf pick by the same butterfly, so on the card the two agree bit for
bit; the CPU tests and ``chip_smoke.py`` hold the kernels to them. The
motion kernels' plain version is ``traverse_plain`` with ``time_boxes``
(the culled walk, step for step); without them it is the union walk, the
JAX package's, which both are held to.

Child order follows ``intersect._SORT8`` (the JAX package's default XLA
step), not the Pallas kernel's list, which orders equal entry keys
differently.
"""

from __future__ import annotations

import math

import torch

from pbrt_torch.accel import prims

#: ``intersect._SORT8`` (Batcher odd-even merge network, 19 exchanges) as
#: its 6 layers of disjoint pairs, in the serial order; the kernel's
#: ``kSort8Layers`` (``csrc/traverse.cu``) is the same table
SORT8_LAYERS = (
    ((0, 1), (2, 3), (4, 5), (6, 7)),
    ((0, 2), (1, 3), (4, 6), (5, 7)),
    ((1, 2), (5, 6)),
    ((0, 4), (1, 5), (2, 6), (3, 7)),
    ((2, 4), (3, 5)),
    ((1, 2), (3, 4), (5, 6)),
)
#: the same network flattened: ``intersect._SORT8``
SORT8 = tuple(pair for layer in SORT8_LAYERS for pair in layer)
#: instances a group of the instance kernels box-tests at once, one a lane
#: (``kInstanceRound`` in ``csrc/traverse.cu``)
INSTANCE_ROUND = 8
#: threads a block of the instance kernels (``kInstThreads``: one warp, 4
#: rays); the other traversal kernels' blocks are 128 threads, 16 rays
INSTANCE_BLOCK_THREADS = 32

#: a substring of each kernel's name, as a profiler reports it
KERNEL_NAMES = {"wide_step": "wide_step_kernel",
                "traverse_closest": "traverse_closest_kernel",
                "traverse_any": "traverse_any_kernel",
                "traverse_closest_motion": "traverse_closest_motion_kernel",
                "traverse_any_motion": "traverse_any_motion_kernel",
                "traverse_instances_closest": "traverse_instances_closest_kernel",
                "traverse_instances_any": "traverse_instances_any_kernel"}
#: the world walk's kernels (one launch per ``intersect`` call with a
#: world table) and the instance phase's (one per call with instances)
WORLD_KERNELS = ("traverse_closest", "traverse_any", "traverse_closest_motion",
                 "traverse_any_motion")
INSTANCE_KERNELS = ("traverse_instances_closest", "traverse_instances_any")

#: kernel launches per wrapper (the plain versions count nothing)
launches = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _partners(layer):
    p = list(range(8))
    for i, j in layer:
        p[i], p[j] = j, i
    return p


#: each layer's partner of every slot (a slot in no pair is its own)
LAYER_PARTNERS = tuple(tuple(_partners(layer)) for layer in SORT8_LAYERS)


def sort8_layers(key, ref):
    """Sorts (8, C) ``key`` and its ``ref`` along the slots as the kernel's
    group does: in each layer slot k takes its partner's (key, ref) iff the
    pair's lower slot holds the strictly larger key; a slot in no pair keeps
    its own. Equal to the serial ``SORT8``, ties included."""
    parts = torch.tensor(LAYER_PARTNERS, device=key.device)
    slot = torch.arange(8, device=key.device)[:, None]
    for p in parts:
        ko, ro = key[p], ref[p]
        swap = torch.where(slot < p[:, None], key > ko, ko > key)
        key = torch.where(swap, ko, key)
        ref = torch.where(swap, ro, ref)
    return key, ref


def pick_first_min(tc):
    """(8, C) candidate t → (t, slot) of each column's first minimum, by the
    kernel's 3 butterfly rounds: slot k takes slot k^m's (t, slot) iff it is
    smaller in (t, slot) order. ``tc`` holds no NaN."""
    lanes = torch.arange(8, device=tc.device)
    slot = lanes[:, None].expand_as(tc)
    for m in (1, 2, 4):
        to, so = tc[lanes ^ m], slot[lanes ^ m]
        take = (to < tc) | ((to == tc) & (so < slot))
        tc = torch.where(take, to, tc)
        slot = torch.where(take, so, slot)
    return tc[0], slot[0]


def _interpret(rt, ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, t_best,
               node_mask, leaf_mask, tbt=None):
    """Both interpretations of slot-major rows ``rt`` (80, C) for C lanes.

    Returns (refs (8, C) int32 in sorted order, n_hit (C,) int32, tsel,
    psel int32, b1, b2) — the JAX step's values on every lane. With ``tbt``
    (48, C), the lanes' lerped time boxes of the node row's children, also
    (8, C) bool in sorted order: the child is culled (a valid slot whose
    time box the ray misses on [tmin, inf)), the bit carried through the
    sort beside its ref as the kernel carries it; else None."""
    inf = torch.tensor(math.inf, dtype=rt.dtype, device=rt.device)
    lox, hix = rt[0:8], rt[8:16]
    loy, hiy = rt[16:24], rt[24:32]
    loz, hiz = rt[32:40], rt[40:48]
    t0x = (lox - ox) * ix
    t1x = (hix - ox) * ix
    t0y = (loy - oy) * iy
    t1y = (hiy - oy) * iy
    t0z = (loz - oz) * iz
    t1z = (hiz - oz) * iz
    mn, mx = torch.minimum, torch.maximum
    tn = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    tf = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    enter = mx(tn, tmin)
    exit_ = mn(tf, t_best)
    hit8 = (enter <= exit_) & (lox <= hix) & node_mask
    refs = rt[48:56].to(torch.int32)
    cull = None
    if tbt is not None:
        # the time box's slab test against [tmin, inf), then the cull bit
        # rides the sort in the ref's low bit (ref * 2 + bit, ref < 2^24)
        u0x, u1x = (tbt[0:8] - ox) * ix, (tbt[8:16] - ox) * ix
        u0y, u1y = (tbt[16:24] - oy) * iy, (tbt[24:32] - oy) * iy
        u0z, u1z = (tbt[32:40] - oz) * iz, (tbt[40:48] - oz) * iz
        un = mx(mx(mn(u0x, u1x), mn(u0y, u1y)), mn(u0z, u1z))
        uf = mn(mn(mx(u0x, u1x), mx(u0y, u1y)), mx(u0z, u1z))
        culled = (lox <= hix) & ~(mx(un, tmin) <= uf)
        refs = refs * 2 + culled.to(torch.int32)
    _, refs = sort8_layers(torch.where(hit8, enter, inf), refs)
    if tbt is not None:
        cull = (refs & 1).bool()
        refs = refs >> 1
    n_hit = hit8.sum(0, dtype=torch.int32)

    # the leaf's 8 packed triangles, (8, C, 9) of [v0, e1, e2] per slot
    tri = rt[0:72].reshape(9, 8, -1).permute(1, 2, 0)
    pid = rt[72:80].to(torch.int32)
    hit, t, b1, b2 = prims.tri_test(tri, torch.stack([ox, oy, oz], -1),
                                    torch.stack([dx, dy, dz], -1), tmin, t_best)
    ok8 = leaf_mask & (pid >= 0) & hit
    tsel, jbest = pick_first_min(torch.where(ok8, t, inf))
    jb = jbest[None]
    psel = pid.gather(0, jb)[0]
    b1s = b1.gather(0, jb)[0]
    b2s = b2.gather(0, jb)[0]
    return refs, n_hit, tsel, psel, b1s, b2s, cull


def step_plain(row, o, d, inv, tmin, t_best, is_node, act):
    """(R, 80) gathered rows + per-lane ray state → (refs (8, R) i32,
    n_hit (R,) i32, tsel (R,), psel (R,) i32, b1 (R,), b2 (R,))."""
    rt = row.T
    return _interpret(
        rt, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        inv[:, 0], inv[:, 1], inv[:, 2], tmin, t_best,
        is_node & act, ~is_node & act,
    )[:6]


def _walk_plain(rows, wide_stack, o, d, inv, tmin, state, idx, root: int,
                any_hit: bool, motion_rows=None, tw=None, stats=None, time_boxes=None):
    """Walks lanes ``idx`` from row ``root`` to completion, a Python loop
    over steps with the active lanes compacted each step, updating
    ``state`` = [t, prim, b1, b2] in place. With ``motion_rows``, each
    gathered row is lerped by the lane's ``tw`` first (the product rounded,
    then added). With ``time_boxes`` too, the culled walk: a node step
    drops the children whose lerped time box the ray misses from the
    sorted order (``_interpret``), the rest keep it; it descends to the
    first survivor and pushes the others, nearest on top, or pops.
    → (node_steps, leaf_steps, touched, lane_steps)."""
    t, prim, b1, b2 = state
    R = o.shape[0]
    dev = o.device
    cur = torch.full((R,), root, dtype=torch.int64, device=dev)
    stack = torch.zeros((R, max(wide_stack, 1)), dtype=torch.int64, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    touched = lane_steps = None
    if stats is not None:
        # rows read as a node, rows read as a leaf
        touched = torch.zeros((2, rows.shape[0]), dtype=torch.bool, device=dev)
        lane_steps = torch.zeros(R, dtype=torch.int64, device=dev)
    n_node = n_leaf = 0
    while idx.numel():
        c = cur[idx]
        is_node = c >= 0
        ridx = torch.where(is_node, c, -c - 1)
        if touched is not None:
            touched[(~is_node).long(), ridx] = True
            nn = int(is_node.sum())
            n_node += nn
            n_leaf += idx.numel() - nn
            lane_steps[idx] += 1
        row = rows[ridx]
        if motion_rows is not None:
            row = row + tw[idx][:, None] * motion_rows[ridx]
        rt = row.T
        tbt = None
        if time_boxes is not None:
            tbox = time_boxes[ridx]
            tbt = (tbox[:, :48] + tw[idx][:, None] * tbox[:, 48:]).T
        oi, di, ii = o[idx], d[idx], inv[idx]
        tb = t[idx]
        refs, n_hit, tsel, psel, b1s, b2s, cull = _interpret(
            rt, oi[:, 0], oi[:, 1], oi[:, 2], di[:, 0], di[:, 1], di[:, 2],
            ii[:, 0], ii[:, 1], ii[:, 2], tmin[idx], tb, is_node, ~is_node, tbt,
        )
        if cull is not None:
            # the survivors (sorted positions < n_hit, not culled) first, in
            # their sorted order; they stand for refs[:n_hit] from here on
            surv = (torch.arange(8, device=dev)[:, None] < n_hit) & ~cull
            refs = refs.gather(0, torch.argsort((~surv).to(torch.int8), dim=0, stable=True))
            n_hit = surv.sum(0, dtype=torch.int32)
        # leaf result
        better = tsel < tb
        t[idx] = torch.where(better, tsel, tb)
        prim[idx] = torch.where(better, psel, prim[idx])
        b1[idx] = torch.where(better, b1s, b1[idx])
        b2[idx] = torch.where(better, b2s, b2[idx])
        # descend to the nearest child, push the rest with the nearest on top
        descend = is_node & (n_hit > 0)
        pc = torch.where(descend, n_hit - 1, 0).to(torch.int64)
        s0 = sp[idx]
        # refs[j] for 1 <= j <= pc goes to slot s0 + pc - j (one scatter)
        j = torch.arange(1, 8, device=dev)[:, None]
        m = j <= pc
        stack[idx.expand(7, -1)[m], (s0 + pc - j)[m]] = refs[1:8].to(torch.int64)[m]
        s1 = s0 + pc
        pop = ~descend
        empty = pop & (s1 == 0)
        top = stack[idx, (s1 - 1).clamp(min=0)]
        cur[idx] = torch.where(descend, refs[0].to(torch.int64), top)
        sp[idx] = torch.where(pop & ~empty, s1 - 1, s1)
        done = empty
        if any_hit:
            done = done | (prim[idx] >= 0)
        idx = idx[~done]
    return n_node, n_leaf, touched, lane_steps


def _add_stats(stats, n_node, n_leaf, touched, lane_steps):
    stats["node_steps"] = stats.get("node_steps", 0) + n_node
    stats["leaf_steps"] = stats.get("leaf_steps", 0) + n_leaf
    stats["node_rows"] = stats.get("node_rows", 0) + int((touched[0] & ~touched[1]).sum())
    stats["leaf_rows"] = stats.get("leaf_rows", 0) + int(touched[1].sum())
    stats["lane_steps"] = stats.get("lane_steps", 0) + lane_steps


def traverse_plain(rows, wide_stack, o, d, inv, tmin, tmax, t0, p0, b10,
                   b20, any_hit: bool, stats: dict | None = None,
                   motion_rows=None, tw=None, time_boxes=None):
    """Batched walk of every lane to completion. Same result contract as
    the kernels: (t, prim, b1, b2), seeded with (t0, p0, b10, b20). With
    ``motion_rows`` (M, 80) and ``tw`` (R,), every row is lerped by the
    lane's weight before its step, node rows included: the union walk, the
    JAX package's, which the motion kernels are held to. With
    ``time_boxes`` (M, 96, ``wide.time_boxes``) as well, the culled walk:
    the motion kernels' own plain version, step for step, equal to the
    union walk in (t, prim, b1, b2) bit for bit.

    ``stats`` (optional dict) receives the work this batch needed:
    ``node_steps``, ``leaf_steps``, ``node_rows`` (distinct rows read only
    as a node: a step reads their 7 node fields), ``leaf_rows`` (distinct
    rows read as a leaf: all 10 fields) and ``lane_steps`` ((R,) int64,
    each lane's steps); a dict passed again adds the next batch's counts
    (lane by lane, for the same R)."""
    state = [t0.clone(), p0.clone(), b10.clone(), b20.clone()]
    run = tmax != 0.0
    if any_hit:
        run = run & (state[1] < 0)
    if time_boxes is not None and motion_rows is None:
        raise ValueError("traverse_plain: time_boxes go with motion_rows and tw")
    work = _walk_plain(rows, wide_stack, o, d, inv, tmin, state,
                       torch.nonzero(run).squeeze(1), 0, any_hit, motion_rows, tw,
                       stats, time_boxes)
    if stats is not None:
        _add_stats(stats, *work)
    return tuple(state)


def instance_rays(w2o, o, d):
    """Rays moved into an instance's space by its (4, 4) ``w2o``: o M^T + t
    and d M^T, the direction unnormalized (so t is unchanged), each
    component summed as ((x m0 + y m1) + z m2) + m3, the kernel's order."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    o2 = torch.stack([ox * w2o[r, 0] + oy * w2o[r, 1] + oz * w2o[r, 2] + w2o[r, 3]
                      for r in range(3)], -1)
    d2 = torch.stack([dx * w2o[r, 0] + dy * w2o[r, 1] + dz * w2o[r, 2]
                      for r in range(3)], -1)
    return o2, d2


def inv_dir(d):
    """1/d with near-zero components mapped to ±1e20 (intersect.py:395)."""
    return torch.where(d.abs() < 1e-20, torch.sign(d + 1e-30) * 1e20, 1.0 / d)


def instance_prune(lo, hi, o, inv, tmin, t_best):
    """Lanes whose world ray enters the instance's world box (lo, hi (3,))
    before their best hit (intersect.py:1078-1082)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    mn, mx = torch.minimum, torch.maximum
    tn = mx(mx(mn(t0[:, 0], t1[:, 0]), mn(t0[:, 1], t1[:, 1])), mn(t0[:, 2], t1[:, 2]))
    tf = mn(mn(mx(t0[:, 0], t1[:, 0]), mx(t0[:, 1], t1[:, 1])), mx(t0[:, 2], t1[:, 2]))
    return mx(tn, tmin) <= mn(tf, t_best)


def traverse_instances_plain(rows, stack, w2o, lo, hi, root, o, d, inv, tmin,
                             tmax, t0, p0, b10, b20, any_hit: bool,
                             stats: dict | None = None):
    """The instance phase in the kernels' schedule: each lane box-tests
    ``INSTANCE_ROUND`` instances at a time against its current t, then, in
    instance order, re-tests each candidate of the round at its t of that
    moment (the serial phase's exact prune, intersect.py:1078-1082; any hit
    also once it has a hit) and walks the shared table ``rows`` from its
    root with the ray in the instance's space. t only falls, so a round's
    candidates hold every instance the serial loop walks and the re-test
    keeps exactly those: each lane's walks are the serial phase's. Seeded
    with the world walk's (t0, p0, b10, b20); → (t, prim, b1, b2, inst),
    inst (R,) int32 the last instance that changed a lane's t or prim, else
    −1.

    ``stats`` as ``traverse_plain``'s over all the walks (a row read by
    several counted once), with ``prunes`` (one box test per lane that
    takes part and instance: the bound's count) and ``walks``
    (lane-instance walks); per lane ``walks_lane``, ``lane_steps`` (BLAS
    steps) and ``box_tests_lane`` (the box tests the kernel issues: a
    lane's rounds until it has no candidate left, each of up to 8
    instances); per warp of 4 consecutive lanes (the kernel's 4 groups)
    ``warp_serial_steps``, the schedule of one instance at a time for the
    whole warp (the sum over instances of the longest of its 4 walks), and
    ``warp_own_steps``, each group through its own candidates (the longest
    of the 4 lanes' totals)."""
    state = [t0.clone(), p0.clone(), b10.clone(), b20.clone()]
    t, prim = state[0], state[1]
    R = t.shape[0]
    dev = t.device
    inst = torch.full_like(p0, -1)
    go = tmax != 0.0
    roots = root.tolist()
    I = len(roots)
    total = [0, 0, None, None]  # the walks' work, rows counted once
    W = (R + 3) // 4
    if stats is not None:
        walks_lane = torch.zeros(R, dtype=torch.int64, device=dev)
        box_lane = torch.zeros(R, dtype=torch.int64, device=dev)
        warp_serial = torch.zeros(W, dtype=torch.int64, device=dev)
        stats["prunes"] = stats.get("prunes", 0) + int(go.sum()) * I
    for base in range(0, I, INSTANCE_ROUND):
        ns = range(base, min(I, base + INSTANCE_ROUND))
        # the round: lanes with candidates left test its instances at their t
        live = go & (prim < 0) if any_hit else go
        cand = [live & instance_prune(lo[n], hi[n], o, inv, tmin, t) for n in ns]
        if stats is not None:
            box_lane += live * len(ns)
        for n, c in zip(ns, cand):
            # the exact prune, at t of this moment, before the walk
            run = c & instance_prune(lo[n], hi[n], o, inv, tmin, t)
            if any_hit:
                run = run & (prim < 0)
            idx = torch.nonzero(run).squeeze(1)
            if not idx.numel():
                continue
            o2, d2 = instance_rays(w2o[n], o, d)
            t_was, p_was = t.clone(), prim.clone()
            work = _walk_plain(rows, stack, o2, d2, inv_dir(d2), tmin, state, idx, roots[n],
                               any_hit, stats=stats)
            if stats is not None:
                walks_lane += run
                total[0] += work[0]
                total[1] += work[1]
                total[2] = work[2] if total[2] is None else total[2] | work[2]
                total[3] = work[3] if total[3] is None else total[3] + work[3]
                warp_serial += _per_warp_max(work[3], W)
            inst = torch.where((t != t_was) | (prim != p_was), n, inst)
    if stats is not None:
        if total[2] is None:  # no walk
            total[2:] = (torch.zeros((2, rows.shape[0]), dtype=torch.bool, device=dev),
                         torch.zeros(R, dtype=torch.int64, device=dev))
        stats["walks"] = stats.get("walks", 0) + int(walks_lane.sum())
        for key, v in (("walks_lane", walks_lane), ("box_tests_lane", box_lane),
                       ("warp_serial_steps", warp_serial),
                       ("warp_own_steps", _per_warp_max(total[3], W))):
            stats[key] = stats[key] + v if key in stats else v
        _add_stats(stats, *total)
    return (*state, inst)


def _per_warp_max(lane_values, W: int):
    """(R,) per-lane values → (W,) the largest of each 4 consecutive lanes
    (a warp's 4 groups), the last warp padded with zeros."""
    v = torch.zeros(4 * W, dtype=lane_values.dtype, device=lane_values.device)
    v[:lane_values.shape[0]] = lane_values
    return v.view(W, 4).max(1).values


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def refuse_grad(kernel: str, *tensors):
    """Raises ``ValueError`` naming ``kernel`` if a tensor requires grad:
    the walks have no backward, so their inputs come detached
    (``intersect.intersect``), on the card and on the CPU alike."""
    if any(torch.is_tensor(x) and x.requires_grad for x in tensors):
        raise ValueError(f"{kernel}: an input requires grad; the traversal has no backward "
                         "(detach the ray first, as intersect() does)")


def step(row, o, d, inv, tmin, t_best, is_node, act):
    """One interpret step for R lanes; see ``step_plain`` for the contract."""
    if row.device.type == "cpu":
        return step_plain(row, o, d, inv, tmin, t_best, is_node, act)
    if row.device.type != "cuda":
        raise ValueError(f"step: unsupported device {row.device}")
    from pbrt_torch.utils import native

    R = row.shape[0]
    dev = row.device
    f32, b = torch.float32, torch.bool
    native.check_tensor("row", row, f32, (R, 80), dev)
    for nm, x in (("o", o), ("d", d), ("inv", inv)):
        native.check_tensor(nm, x, f32, (R, 3), dev)
    for nm, x in (("tmin", tmin), ("t_best", t_best)):
        native.check_tensor(nm, x, f32, (R,), dev)
    for nm, x in (("is_node", is_node), ("act", act)):
        native.check_tensor(nm, x, b, (R,), dev)
    lib = native.kernel_lib("traverse.cu")
    refs = torch.empty((8, R), dtype=torch.int32, device=dev)
    n_hit = torch.empty(R, dtype=torch.int32, device=dev)
    tsel = torch.empty(R, dtype=f32, device=dev)
    psel = torch.empty(R, dtype=torch.int32, device=dev)
    b1 = torch.empty(R, dtype=f32, device=dev)
    b2 = torch.empty(R, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (row, o, d, inv, tmin, t_best, is_node,
                                   act, refs, n_hit, tsel, psel, b1, b2)]
    native.check_launch(lib.pbrt_torch_wide_step(*ptrs, R, stream), "wide_step launch")
    launches["wide_step"] += 1
    return refs, n_hit, tsel, psel, b1, b2


def traverse(rows, wide_stack, o, d, inv, tmin, tmax, t0, p0, b10, b20,
             any_hit: bool, fmad: bool = False, motion_rows=None, tw=None,
             time_boxes=None):
    """Closest-hit (or any-hit) walk over the wide table; (t0, p0, b10,
    b20) seed the result (the quadric hit) and bound the search. With
    ``motion_rows``, ``tw`` and the table's ``time_boxes`` it launches the
    motion kernel, which culls by the time boxes (on the CPU: the culled
    plain walk); a motion walk without ``time_boxes`` raises.
    ``fmad=True`` launches the FMA-contracted build (measurement only)."""
    refuse_grad("traverse", rows, o, d, inv, tmin, tmax, t0, p0, b10, b20, motion_rows, tw,
                time_boxes)
    if (motion_rows is None) != (tw is None):
        raise ValueError("traverse: motion_rows and tw go together")
    if (motion_rows is None) != (time_boxes is None):
        raise ValueError("traverse: a motion walk needs the table's time_boxes "
                         "(wide.time_boxes), and only a motion walk takes them")
    if o.device.type == "cpu":
        return traverse_plain(rows, wide_stack, o, d, inv, tmin, tmax, t0,
                              p0, b10, b20, any_hit, motion_rows=motion_rows, tw=tw,
                              time_boxes=time_boxes)
    if o.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {o.device}")
    from pbrt_torch.utils import native

    R = o.shape[0]
    dev = o.device
    f32 = torch.float32
    native.check_tensor("rows", rows, f32, (rows.shape[0], 80), dev)
    motion = motion_rows is not None
    if motion:
        native.check_tensor("motion_rows", motion_rows, f32, tuple(rows.shape), dev)
        native.check_tensor("time_boxes", time_boxes, f32, (rows.shape[0], 96), dev)
        native.check_tensor("tw", tw, f32, (R,), dev)
    _check_rays(native, R, dev, o, d, inv, tmin, tmax, t0, p0, b10, b20)
    lib = native.kernel_lib("traverse.cu", fmad)
    _check_stack(lib, wide_stack)
    t, prim, b1, b2 = _hit_outputs(R, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = (rows, *((motion_rows, time_boxes, tw) if motion else ()), o, d, inv, tmin, tmax,
           t0, p0, b10, b20)
    ptrs = [x.data_ptr() for x in (*ins, t, prim, b1, b2)]
    key = ("traverse_any" if any_hit else "traverse_closest") + ("_motion" if motion else "")
    native.check_launch(getattr(lib, "pbrt_torch_" + key)(*ptrs, R, int(wide_stack), stream),
                        f"{key} launch")
    launches[key] += 1
    return t, prim, b1, b2


def traverse_instances(rows, stack, w2o, lo, hi, root, o, d, inv, tmin, tmax,
                       t0, p0, b10, b20, any_hit: bool):
    """The instance phase over the shared BLAS table ``rows`` (see
    ``traverse_instances_plain``): one launch for all instances.
    w2o (I, 4, 4), lo / hi (I, 3) f32, root (I,) int32."""
    refuse_grad("traverse_instances", rows, w2o, lo, hi, o, d, inv, tmin, tmax, t0, p0, b10,
                b20)
    if o.device.type == "cpu":
        return traverse_instances_plain(rows, stack, w2o, lo, hi, root, o, d, inv,
                                        tmin, tmax, t0, p0, b10, b20, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"traverse_instances: unsupported device {o.device}")
    from pbrt_torch.utils import native

    R = o.shape[0]
    dev = o.device
    f32 = torch.float32
    I = root.shape[0]
    native.check_tensor("rows", rows, f32, (rows.shape[0], 80), dev)
    native.check_tensor("w2o", w2o, f32, (I, 4, 4), dev)
    native.check_tensor("lo", lo, f32, (I, 3), dev)
    native.check_tensor("hi", hi, f32, (I, 3), dev)
    native.check_tensor("root", root, torch.int32, (I,), dev)
    _check_rays(native, R, dev, o, d, inv, tmin, tmax, t0, p0, b10, b20)
    lib = native.kernel_lib("traverse.cu")
    _check_stack(lib, stack)
    t, prim, b1, b2 = _hit_outputs(R, dev)
    inst = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = "traverse_instances_any" if any_hit else "traverse_instances_closest"
    head = [x.data_ptr() for x in (rows, w2o, lo, hi, root)]
    tail = [x.data_ptr() for x in (o, d, inv, tmin, tmax, t0, p0, b10, b20, t, prim, b1,
                                   b2, inst)]
    native.check_launch(getattr(lib, "pbrt_torch_" + key)(*head, I, *tail, R, int(stack),
                                                          stream), f"{key} launch")
    launches[key] += 1
    return t, prim, b1, b2, inst


def _check_rays(native, R, dev, o, d, inv, tmin, tmax, t0, p0, b10, b20):
    for nm, x in (("o", o), ("d", d), ("inv", inv)):
        native.check_tensor(nm, x, torch.float32, (R, 3), dev)
    for nm, x in (("tmin", tmin), ("tmax", tmax), ("t0", t0), ("b10", b10),
                  ("b20", b20)):
        native.check_tensor(nm, x, torch.float32, (R,), dev)
    native.check_tensor("p0", p0, torch.int32, (R,), dev)


def _check_stack(lib, stack):
    # the entry also refuses (as a launch error) a block's stacks, 16 rays ×
    # stack ints, that exceed the device's shared memory per block
    cap = lib.pbrt_torch_max_stack()
    if stack > cap:
        raise ValueError(f"stack {stack} exceeds the kernel's stack cap {cap}")


def _hit_outputs(R, dev):
    f32 = torch.float32
    return (torch.empty(R, dtype=f32, device=dev), torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=f32, device=dev), torch.empty(R, dtype=f32, device=dev))
