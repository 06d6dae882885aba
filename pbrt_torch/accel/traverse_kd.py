"""kd-tree and uniform-grid traversal: CUDA kernel wrappers and their plain
PyTorch versions.

They replace the JAX package's ``_traverse_kd_one`` and
``_traverse_grid_one`` (``pbrt_tpu/accel/intersect.py:1149-1246`` and
``:1249-1313``), XLA ``while_loop``s vmapped over rays, with the leaf loop
``_leaf_chunk_loop`` (``:1122-1146``) and ``_make_test_prim`` (``:437``).
No Pallas kernel stands there. The CUDA source is
``pbrt_torch/csrc/traverse_kd.cu``: a group of G = 32 lanes (a warp) per
ray steps the walk together and tests each leaf's or voxel's prims in
chunks of G, the chunk's first nearest hit found by a (t, position)
reduction.

- kd-tree (reference: KdTreeAccel::Intersect, kdtreeaccel.cpp:374-462):
  the ray is clipped to the world box, then a (node, t0, t1) todo stack of
  ``MAX_STACK`` entries: the near child by ``below_first`` (the ``o ==
  split && d <= 0`` tie), the reference's ordered only-first /
  only-second tests, the far child pushed; a leaf tests its CSR prims in
  order, each against the running best; after a leaf the walk pops, and
  pops again while the best hit precedes the popped segment's t0.
- grid (reference: GridAccel::Intersect, grid.cpp:157-230): a 3D-DDA from
  the entry voxel (clipped to dims − 1), ``next_t`` / ``delta_t`` with
  1e30 on axes the ray does not move along, each voxel's CSR prims
  tested, then a step along the first minimum of ``next_t``; it stops on
  a hit that precedes the voxel's exit, out of the grid, or once the exit
  lies past the best hit. A prim that spans voxels is tested in each (no
  mailbox, as in the JAX package).

Prim ids are global: [0, T) triangles (packed [v0, e1, e2] rows, lerped
``row + tw · delta`` under motion), [T, T + Q) quadrics (``prims.
quadric_hits``). Any-hit stops after the leaf or voxel of its first hit,
as the reference's loop condition does: the whole leaf is tested, so the
any-hit result is that leaf's nearest hit.

Wrappers, each with a launch counter (``launches``): ``traverse_kd`` and
``traverse_grid`` take the plain version when the rays lie on the CPU and
launch their kernel when they lie on a CUDA device, ``traverse_{kd,grid}_
{closest,any}`` and their ``_motion`` twins; a CUDA tensor never falls
back. The plain versions (``traverse_kd_plain``, ``traverse_grid_plain``)
step every live lane once per loop pass, as the JAX ``while_loop`` does,
and test a leaf's prims all at once against the best hit at the leaf's
entry, keeping the first of the nearest: the same result as testing them
in order against the running best, or a chunk at a time against the best
at the chunk's start, as the kernels do. Every float operation is the
kernel's, in its order and without FMA, so on the card the two agree bit
for bit.

For measurement only (``chip_smoke.py`` phase 14, ``scripts/
kd_grid_lab.py``), ``launch_with`` launches a given build of the kernels
(``VARIANTS``: every kernel at the other width; or an earlier tree's)
without counting, and ``kernel_info`` reports a kernel's G, registers
and blocks per SM.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_torch.accel import prims
from pbrt_torch.accel.traverse_cuda import refuse_grad

#: the todo stack's depth (intersect.py:36); a kd-tree's depth is capped at
#: 8 + 1.3·log2(P) (< 40 for 2**24 prims), so a push never finds it full.
#: As in the JAX package, a push past it is dropped and a pop reads the
#: last entry.
MAX_STACK = 64
#: a leaf node's axis code (kdtree.KD_LEAF)
KD_LEAF = 3
#: (lane, prim) pairs a plain walk tests at once (a grid voxel can hold
#: thousands of prims)
PAIR_BLOCK = 1 << 21

#: a substring of each kernel's name, as a profiler reports it
KERNEL_NAMES = {f"traverse_{a}_{s}{m}": f"traverse_{a}_{s}{m}_kernel"
                for a in ("kd", "grid") for s in ("closest", "any") for m in ("", "_motion")}
KD_KERNELS = tuple(k for k in KERNEL_NAMES if k.startswith("traverse_kd_"))
GRID_KERNELS = tuple(k for k in KERNEL_NAMES if k.startswith("traverse_grid_"))

#: kernel launches per wrapper (the plain versions count nothing)
launches = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class LeafPrims:
    """The primitive tables a leaf or voxel reads, in the kernels' types."""

    tri: torch.Tensor  # (T, 9) f32 packed [v0, e1, e2]
    tri_motion: torch.Tensor | None  # (T, 9) f32 shutter-end deltas
    quad_type: torch.Tensor  # (Q,) int32
    quad_w2o: torch.Tensor  # (Q, 4, 4) f32
    quad_params: torch.Tensor  # (Q, 8) f32
    active_types: tuple  # the quadric type codes present

    @staticmethod
    def of(g) -> "LeafPrims":
        tri = torch.cat([g.tri_v0, g.tri_e1, g.tri_e2], 1).to(torch.float32).contiguous()
        motion = None if g.tri_motion is None else g.tri_motion.contiguous()
        return LeafPrims(tri=tri, tri_motion=motion,
                         quad_type=g.quad_type.to(torch.int32).contiguous(),
                         quad_w2o=g.quad_w2o.contiguous(),
                         quad_params=g.quad_params.contiguous(),
                         active_types=g.quad_active_types)

    @property
    def T(self) -> int:
        return self.tri.shape[0]

    @property
    def Q(self) -> int:
        return self.quad_type.shape[0]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def prim_tests(lp: LeafPrims, p, o, d, tmin, tmax, tw=None):
    """Lane i against its one primitive ``p[i]`` (global id) → (hit, t, b1,
    b2), t = inf where it misses."""
    N = p.shape[0]
    dev = o.device
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    t = torch.full((N,), math.inf, dtype=torch.float32, device=dev)
    b1 = torch.zeros(N, dtype=torch.float32, device=dev)
    b2 = torch.zeros(N, dtype=torch.float32, device=dev)
    is_tri = p < lp.T
    for k, tri in ((torch.nonzero(is_tri).squeeze(1), True),
                   (torch.nonzero(~is_tri).squeeze(1), False)):
        if not k.numel():
            continue
        if tri:
            pk = p[k]
            row = lp.tri[pk]
            if tw is not None:
                row = row + tw[k][:, None] * lp.tri_motion[pk]
            h, tt, u1, u2 = prims.tri_test(row, o[k], d[k], tmin[k], tmax[k])
        else:
            q = p[k] - lp.T
            h, tt, u1, u2 = prims.quadric_hits(
                lp.quad_type[q], lp.quad_params[q],
                *prims.object_ray(lp.quad_w2o[q], o[k], d[k]), tmin[k], tmax[k],
                lp.active_types)
        hit[k] = h
        t[k] = torch.where(h, tt, math.inf)
        b1[k] = u1
        b2[k] = u2
    return hit, t, b1, b2


def _leaf_tests(lp, ids, lanes, off, cnt, o, d, tmin, state, tw, stats):
    """Lanes ``lanes`` test the ``cnt`` prims from ``ids[off]`` on, each
    against the best hit at the leaf's entry; the first of the nearest
    hits, if any, becomes the lane's best. ``state`` = [t, prim, b1, b2]
    (R,), updated in place. The (lane, prim) pairs are tested in blocks of
    ``PAIR_BLOCK``, a later block's hit kept only where it is nearer."""
    t_best, prim_best, b1b, b2b = state
    cnt = cnt.to(torch.int64)
    M = int(cnt.sum())
    if stats is not None:
        stats["leaf_visits"] = stats.get("leaf_visits", 0) + lanes.numel()
    if M == 0:
        return
    L = lanes.numel()
    dev = lanes.device
    seg = torch.repeat_interleave(torch.arange(L, device=dev), cnt)
    first_pair = torch.cumsum(cnt, 0) - cnt
    off = off.to(torch.int64)
    t_run = torch.full((L,), math.inf, dtype=torch.float32, device=dev)
    p_run = torch.full((L,), -1, dtype=torch.int64, device=dev)
    u1_run = torch.zeros(L, dtype=torch.float32, device=dev)
    u2_run = torch.zeros(L, dtype=torch.float32, device=dev)
    for s0 in range(0, M, PAIR_BLOCK):
        pair = torch.arange(s0, min(M, s0 + PAIR_BLOCK), device=dev)
        sg = seg[s0:s0 + PAIR_BLOCK]
        entry = off[sg] + (pair - first_pair[sg])
        p = ids[entry].to(torch.int64)
        lane = lanes[sg]
        hit, t, u1, u2 = prim_tests(lp, p, o[lane], d[lane], tmin[lane], t_best[lane],
                                    None if tw is None else tw[lane])
        if stats is not None:
            n_tri = int((p < lp.T).sum())
            stats["tri_tests"] = stats.get("tri_tests", 0) + n_tri
            stats["quad_tests"] = stats.get("quad_tests", 0) + p.numel() - n_tri
            stats.setdefault("csr_seen", []).append(torch.unique(entry))
            stats.setdefault("prims_seen", []).append(torch.unique(p))
        inf = torch.full((L,), math.inf, dtype=torch.float32, device=dev)
        block_min = inf.scatter_reduce(0, sg, t, "amin")
        win = hit & (t == block_min[sg])
        first = torch.full((L,), M, dtype=torch.int64, device=dev).scatter_reduce(
            0, sg[win], pair[win], "amin")
        nearer = (first < M) & (block_min < t_run)
        ln = torch.nonzero(nearer).squeeze(1)
        j = first[ln] - s0
        t_run[ln] = t[j]
        p_run[ln] = p[j]
        u1_run[ln] = u1[j]
        u2_run[ln] = u2[j]
    has = torch.nonzero(p_run >= 0).squeeze(1)
    lw = lanes[has]
    t_best[lw] = t_run[has]
    prim_best[lw] = p_run[has].to(torch.int32)
    b1b[lw] = u1_run[has]
    b2b[lw] = u2_run[has]


def _box(lo, hi, o, inv):
    """The world box's entry and exit along each ray (no tmin / tmax)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    mn, mx = torch.minimum, torch.maximum
    tn, tf = mn(t0, t1), mx(t0, t1)
    return (mx(mx(tn[:, 0], tn[:, 1]), tn[:, 2]),
            mn(mn(tf[:, 0], tf[:, 1]), tf[:, 2]))


def _init_state(o, tmax):
    R = o.shape[0]
    dev = o.device
    return [tmax.clone(), torch.full((R,), -1, dtype=torch.int32, device=dev),
            torch.zeros(R, dtype=torch.float32, device=dev),
            torch.zeros(R, dtype=torch.float32, device=dev)]


def traverse_kd_plain(g, o, d, inv, tmin, tmax, any_hit: bool, tw=None,
                      stats: dict | None = None):
    """The kd walk of every lane → (t, prim, b1, b2), t = tmax and prim −1
    on a miss. ``stats`` (optional dict) receives the work: ``steps`` (lane
    passes), ``node_steps`` (interior nodes), ``leaf_visits``,
    ``tri_tests``, ``quad_tests``, ``nodes`` (distinct nodes read),
    ``csr_entries``, ``tri_rows`` and ``quad_rows`` (distinct ones read)
    and ``lane_steps`` ((R,) int64 passes per lane)."""
    lp = g.leaf_prims
    state = _init_state(o, tmax)
    t_best, prim_best = state[0], state[1]
    R = o.shape[0]
    dev = o.device
    enter, exit_ = _box(g.world_lo, g.world_hi, o, inv)
    mn, mx = torch.minimum, torch.maximum
    ok_box = mx(enter, tmin) <= mn(exit_, tmax)
    t0n = mx(tmin, enter)
    t1n = mn(tmax, exit_)
    node = torch.where(ok_box, 0, -1).to(torch.int64)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    st_n = torch.zeros((R, MAX_STACK), dtype=torch.int64, device=dev)
    st_t0 = torch.zeros((R, MAX_STACK), dtype=torch.float32, device=dev)
    st_t1 = torch.zeros((R, MAX_STACK), dtype=torch.float32, device=dev)
    axis_t = g.kd_axis.to(torch.int64)
    above_t = g.kd_above.to(torch.int64)
    nodes_seen = []
    if stats is not None:
        stats["lane_steps"] = torch.zeros(R, dtype=torch.int64, device=dev)
    idx = torch.nonzero(ok_box).squeeze(1)
    while idx.numel():
        nd = node[idx]
        pop_mode = nd < 0
        nc = nd.clamp(min=0)
        axis = axis_t[nc]
        is_leaf = ~pop_mode & (axis == KD_LEAF)
        interior = ~pop_mode & (axis != KD_LEAF)
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + idx.numel()
            stats["node_steps"] = stats.get("node_steps", 0) + int(interior.sum())
            stats["lane_steps"][idx] += 1
            nodes_seen.append(nc[~pop_mode])
        lf = torch.nonzero(is_leaf).squeeze(1)
        if lf.numel():
            _leaf_tests(lp, g.kd_prim_ids, idx[lf], g.kd_prim_off[nc[lf]],
                        g.kd_prim_cnt[nc[lf]], o, d, tmin, state, tw, stats)
        # interior: the near child next, the far one pushed
        ax = axis.clamp(max=2)
        oa = o[idx, ax]
        split = g.kd_split[nc]
        tplane = (split - oa) * inv[idx, ax]
        below_first = (oa < split) | ((oa == split) & (d[idx, ax] <= 0.0))
        above = above_t[nc]
        first = torch.where(below_first, nc + 1, above)
        second = torch.where(below_first, above, nc + 1)
        t0c, t1c = t0n[idx], t1n[idx]
        only_first = (tplane > t1c) | (tplane <= 0.0)
        only_second = (tplane < t0c) & ~only_first
        both = ~only_first & ~only_second
        push = interior & both
        spc = sp[idx]
        w = torch.nonzero(push & (spc < MAX_STACK)).squeeze(1)
        st_n[idx[w], spc[w]] = second[w]
        st_t0[idx[w], spc[w]] = tplane[w]
        st_t1[idx[w], spc[w]] = t1c[w]
        spc = spc + push.to(torch.int64)
        node_next = torch.where(only_second, second, first)
        t1_next = torch.where(both, tplane, t1c)
        # pop: after a leaf, or again while the best hit precedes the
        # popped segment
        want_pop = pop_mode | is_leaf
        can_pop = spc > 0
        sp_p = (spc - 1).clamp(min=0)
        rd = sp_p.clamp(max=MAX_STACK - 1)
        p_node, p_t0, p_t1 = st_n[idx, rd], st_t0[idx, rd], st_t1[idx, rd]
        again = t_best[idx] < p_t0
        popped = want_pop & can_pop
        node[idx] = torch.where(want_pop, torch.where(can_pop & ~again, p_node, -1),
                                torch.where(interior, node_next, nd))
        t0n[idx] = torch.where(popped, p_t0, t0c)
        t1n[idx] = torch.where(popped, p_t1, torch.where(interior, t1_next, t1c))
        sp[idx] = torch.where(popped, sp_p, spc)
        done = want_pop & ~can_pop
        if any_hit:
            done = done | (prim_best[idx] >= 0)
        idx = idx[~done]
    if stats is not None:
        stats["nodes"] = int(torch.unique(torch.cat(nodes_seen)).numel()) if nodes_seen else 0
        _split_prim_rows(stats, lp)
    return tuple(state)


def _split_prim_rows(stats, lp):
    """Distinct CSR entries, triangle rows and quadric rows read."""
    for key, n in (("csr_seen", "csr_entries"),):
        seen = stats.pop(key, [])
        stats[n] = int(torch.unique(torch.cat(seen)).numel()) if seen else 0
    seen = stats.pop("prims_seen", [])
    u = torch.unique(torch.cat(seen)) if seen else torch.zeros(0, dtype=torch.int64)
    stats["tri_rows"] = int((u < lp.T).sum())
    stats["quad_rows"] = int((u >= lp.T).sum())
    stats.setdefault("tri_tests", 0)
    stats.setdefault("quad_tests", 0)
    stats.setdefault("leaf_visits", 0)


def traverse_grid_plain(g, o, d, inv, tmin, tmax, any_hit: bool, tw=None,
                        stats: dict | None = None):
    """The grid's 3D-DDA for every lane → (t, prim, b1, b2); ``stats`` as
    ``traverse_kd_plain``'s, with ``voxels`` (distinct voxels read) in
    place of ``nodes``."""
    lp = g.leaf_prims
    state = _init_state(o, tmax)
    t_best, prim_best = state[0], state[1]
    R = o.shape[0]
    dev = o.device
    nx, ny, nz = g.grid_dims
    dims = torch.tensor([nx, ny, nz], dtype=torch.int64, device=dev)
    lo = g.world_lo
    width = g.grid_cell
    enter, exit_ = _box(lo, g.world_hi, o, inv)
    t_enter = torch.maximum(enter, tmin)
    alive = (enter <= exit_) & (exit_ >= tmin) & (t_enter <= tmax)
    p_in = o + t_enter[:, None] * d
    # float → int truncation of the entry cell, clamped into the grid (the
    # float clamp first keeps an infinite entry of a dead lane defined)
    cell = torch.maximum(torch.minimum((p_in - lo) / width, dims.to(torch.float32)),
                         torch.full_like(p_in, -1.0))
    vox = torch.minimum(torch.maximum(cell.to(torch.int64), torch.zeros_like(dims)), dims - 1)
    step = torch.where(d >= 0.0, 1, -1).to(torch.int64)
    next_edge = lo + (vox + (step > 0).to(torch.int64)).to(torch.float32) * width
    big = 1e30
    next_t = torch.where(d != 0.0, (next_edge - o) * inv, big)
    delta_t = torch.where(d != 0.0, width * inv.abs(), big)
    V = g.grid_cnt.shape[0]
    voxels_seen = []
    if stats is not None:
        stats["lane_steps"] = torch.zeros(R, dtype=torch.int64, device=dev)
    lanes = torch.arange(R, device=dev)
    idx = torch.nonzero(alive).squeeze(1)
    while idx.numel():
        vx = vox[idx]
        vid = (vx[:, 2] + nz * (vx[:, 1] + ny * vx[:, 0])).clamp(0, V - 1)
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + idx.numel()
            stats["lane_steps"][idx] += 1
            voxels_seen.append(vid)
        _leaf_tests(lp, g.grid_ids, idx, g.grid_off[vid], g.grid_cnt[vid], o, d, tmin,
                    state, tw, stats)
        nt = next_t[idx]
        ax = torch.argmin(nt, 1)
        t_exit = nt[lanes[:idx.numel()], ax]
        tb = t_best[idx]
        done_hit = (prim_best[idx] >= 0) & (tb <= t_exit)
        vnew = vx[lanes[:idx.numel()], ax] + step[idx, ax]
        vox[idx, ax] = vnew
        out = (vnew < 0) | (vnew >= dims[ax])
        next_t[idx, ax] = nt[lanes[:idx.numel()], ax] + delta_t[idx, ax]
        keep = ~done_hit & ~out & (t_exit <= tb)
        if any_hit:
            keep = keep & (prim_best[idx] < 0)
        idx = idx[keep]
    if stats is not None:
        stats["voxels"] = int(torch.unique(torch.cat(voxels_seen)).numel()) if voxels_seen else 0
        _split_prim_rows(stats, lp)
    return tuple(state)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_rays(native, lp, R, dev, o, d, inv, tmin, tmax, tw):
    f32 = torch.float32
    for nm, x in (("o", o), ("d", d), ("inv", inv)):
        native.check_tensor(nm, x, f32, (R, 3), dev)
    for nm, x in (("tmin", tmin), ("tmax", tmax)):
        native.check_tensor(nm, x, f32, (R,), dev)
    native.check_tensor("tri", lp.tri, f32, (lp.T, 9), dev)
    native.check_tensor("quad_type", lp.quad_type, torch.int32, (lp.Q,), dev)
    native.check_tensor("quad_w2o", lp.quad_w2o, f32, (lp.Q, 4, 4), dev)
    native.check_tensor("quad_params", lp.quad_params, f32, (lp.Q, 8), dev)
    if tw is not None:
        native.check_tensor("tw", tw, f32, (R,), dev)
        native.check_tensor("tri_motion", lp.tri_motion, f32, (lp.T, 9), dev)


def _kd_head(native, g, dev):
    N = g.kd_axis.shape[0]
    for nm, x, dt in (("kd_split", g.kd_split, torch.float32), ("kd_axis", g.kd_axis, torch.int32),
                      ("kd_above", g.kd_above, torch.int32),
                      ("kd_prim_off", g.kd_prim_off, torch.int32),
                      ("kd_prim_cnt", g.kd_prim_cnt, torch.int32)):
        native.check_tensor(nm, x, dt, (N,), dev)
    native.check_tensor("kd_prim_ids", g.kd_prim_ids, torch.int32, (g.kd_prim_ids.shape[0],), dev)
    for nm, x in (("world_lo", g.world_lo), ("world_hi", g.world_hi)):
        native.check_tensor(nm, x, torch.float32, (3,), dev)
    return [x.data_ptr() for x in (g.kd_split, g.kd_axis, g.kd_above, g.kd_prim_off,
                                   g.kd_prim_cnt, g.kd_prim_ids, g.world_lo, g.world_hi)]


def _grid_head(native, g, dev):
    nx, ny, nz = g.grid_dims
    V = nx * ny * nz
    for nm, x in (("grid_off", g.grid_off), ("grid_cnt", g.grid_cnt)):
        native.check_tensor(nm, x, torch.int32, (V,), dev)
    native.check_tensor("grid_ids", g.grid_ids, torch.int32, (g.grid_ids.shape[0],), dev)
    for nm, x in (("world_lo", g.world_lo), ("world_hi", g.world_hi), ("grid_cell", g.grid_cell)):
        native.check_tensor(nm, x, torch.float32, (3,), dev)
    return [*(x.data_ptr() for x in (g.grid_off, g.grid_cnt, g.grid_ids, g.world_lo,
                                      g.world_hi, g.grid_cell)),
            nx, ny, nz]


def _launch(lib, kind, g, o, d, inv, tmin, tmax, any_hit, tw):
    """Launches ``kind``'s ("kd" or "grid") walk from ``lib`` → (its
    ``KERNEL_NAMES`` key, (t, prim, b1, b2))."""
    from pbrt_torch.utils import native

    lp = g.leaf_prims
    R = o.shape[0]
    dev = o.device
    head = (_kd_head if kind == "kd" else _grid_head)(native, g, dev)
    _check_rays(native, lp, R, dev, o, d, inv, tmin, tmax, tw)
    f32 = torch.float32
    t = torch.empty(R, dtype=f32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    b1 = torch.empty(R, dtype=f32, device=dev)
    b2 = torch.empty(R, dtype=f32, device=dev)
    motion = tw is not None
    ptr = lambda x: None if x is None else x.data_ptr()
    key = f"traverse_{kind}_{'any' if any_hit else 'closest'}{'_motion' if motion else ''}"
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*head, ptr(lp.tri), ptr(lp.tri_motion if motion else None), lp.T,
            ptr(lp.quad_type), ptr(lp.quad_w2o), ptr(lp.quad_params), lp.Q,
            *(x.data_ptr() for x in (o, d, inv, tmin, tmax)), ptr(tw),
            *(x.data_ptr() for x in (t, prim, b1, b2)), R, stream)
    native.check_launch(getattr(lib, "pbrt_torch_" + key)(*args), f"{key} launch")
    return key, (t, prim, b1, b2)


def _dispatch(kind, g, o, d, inv, tmin, tmax, any_hit, tw):
    name = f"traverse_{kind}"
    refuse_grad(name, o, d, inv, tmin, tmax, tw)
    if o.device.type == "cpu":
        plain = traverse_kd_plain if kind == "kd" else traverse_grid_plain
        return plain(g, o, d, inv, tmin, tmax, any_hit, tw)
    if o.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {o.device}")
    from pbrt_torch.utils import native

    key, hit = _launch(native.kernel_lib("traverse_kd.cu"), kind, g, o, d, inv, tmin, tmax,
                       any_hit, tw)
    launches[key] += 1
    return hit


def traverse_kd(g, o, d, inv, tmin, tmax, any_hit: bool, tw=None):
    """Closest-hit (or any-hit) walk of ``g``'s kd-tree; with ``tw`` (R,)
    the motion kernel, every triangle lerped by the lane's weight."""
    return _dispatch("kd", g, o, d, inv, tmin, tmax, any_hit, tw)


def traverse_grid(g, o, d, inv, tmin, tmax, any_hit: bool, tw=None):
    """Closest-hit (or any-hit) 3D-DDA of ``g``'s grid; with ``tw`` (R,)
    the motion kernel."""
    return _dispatch("grid", g, o, d, inv, tmin, tmax, any_hit, tw)


# ---------------------------------------------------------------------------
# measurement (chip_smoke.py, scripts/kd_grid_lab.py): other builds of the
# kernels, launched on the same inputs; nothing here is on the render path
# ---------------------------------------------------------------------------

#: the build variants ``csrc/traverse_kd.cu`` offers, by the macros that
#: select them: every kernel at the other width (G = 8 instead of 32)
VARIANTS = {"other_width": ("PBRT_KD_OTHER_WIDTH",)}
#: the fields of ``kernel_info``, in ``pbrt_torch_traverse_kd_info``'s order
INFO_FIELDS = ("width", "registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads")


def launch_with(lib, g, o, d, inv, tmin, tmax, any_hit: bool, tw=None):
    """``g``'s walk (kd-tree or grid, by ``g.accel_kind``) launched from
    ``lib``, a build of ``traverse_kd.cu`` (``native.kernel_lib(
    "traverse_kd.cu", defines=VARIANTS[...])``, or an earlier tree's with
    the same entry points) → (t, prim, b1, b2). It counts no launch."""
    refuse_grad("launch_with", o, d, inv, tmin, tmax, tw)
    if o.device.type != "cuda":
        raise ValueError(f"launch_with: unsupported device {o.device}")
    kind = "kd" if g.accel_kind == "kdtree" else "grid"
    return _launch(lib, kind, g, o, d, inv, tmin, tmax, any_hit, tw)[1]


def kernel_info(lib, key: str) -> dict:
    """The kernel ``key`` (of ``KERNEL_NAMES``) as ``lib`` built it: its
    lanes per ray, registers per thread, local and
    static shared bytes, blocks per SM (the CUDA occupancy calculator) and
    threads per block."""
    import ctypes

    from pbrt_torch.utils import native

    out = (ctypes.c_int * len(INFO_FIELDS))()
    native.check_launch(lib.pbrt_torch_traverse_kd_info(key.encode(), out), f"{key} info")
    return dict(zip(INFO_FIELDS, out))
