"""The gather lab on the card (counterpart of ``scripts/pallas_gather_lab.py``).

    python -m pbrt_torch.scripts.gather_lab

On the TPU the lab asked whether a VMEM-resident BVH table beats XLA's HBM
gather. On an H100 it asks what per-lane row gathers from the L2 cost on
their own: each of R lanes gathers 8 rows of a (N, 80) table along a
pseudo-random walk and runs the 8-slot slab test on each. Unlike the
traversal (``csrc/traverse.cu``), the walk's row indices depend only on the
start index, never on loaded data, so the kernel can keep several rows in
flight; the gap between this kernel's time and the traversal's says how much
of the traversal's time is its dependent, divergent walk.

The lab's constants and inputs are the script's: N = 16,384 rows (5 MiB),
R = 32,768 lanes, 8 rounds; ``numpy.random.default_rng(0)`` draws the table,
the start indices, the origins and ``inv = 1 / (u + 0.1)`` in that order.

``gather_lab`` launches the CUDA kernel (``csrc/gather_lab.cu``) for tensors
on a card and takes the plain version, ``gather_lab_plain``, for tensors on
the CPU. The plain version repeats the kernel's arithmetic in its order, so
the two agree bit for bit on the card. ``main()`` needs a card: it times the
kernel (median and min–max of 5 rounds of ``timing.queued_ms``, 50 calls
queued behind a spin kernel each) and the plain version (CUDA events), and
prints them beside the bound and the L2 read ceiling (``l2_ceiling``: the
rate at which coalesced 16-byte reads of the table's slab block come from
L2, and what the lab's 50.3 MB of slab rows take at that rate), with the
card's name and power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_torch.utils import native, timing

N = 16384  # table rows (killeroo scale)
R = 1 << 15  # lanes
ITERS = 8  # gather rounds
ROW = 80  # floats per row
SLAB = 48  # slab columns the rounds read
#: float operations per slot: 6 sub + 6 mul, 5 min/max for tn and 5 for
#: tf, 1 compare, 1 select, 1 add
OPS_PER_SLOT = 25
#: bytes a lane must read and write once: idx (4), o (12), inv (12), out (4)
LANE_BYTES = 32
#: slab bytes the lab's lanes gather from L2 per launch: R x 8 rounds x 192 B
SLAB_BYTES = R * ITERS * SLAB * 4
_LCG_A, _LCG_C = 1103515245, 12345
#: the lane counts and table sizes ``check_cases`` holds the kernel at
CHECK_R = (1, 31, 33, 4093, R)
CHECK_N = (7, 64, N)

#: kernel launches of the wrappers (the plain versions count nothing)
launches = {"gather_lab": 0, "l2_read": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def lcg_next(cur: torch.Tensor, n: int) -> torch.Tensor:
    """``(cur * 1103515245 + 12345) % n`` in int32 with wraparound and
    floor-mod, on int64 tensors holding int32 values."""
    v = (cur * _LCG_A + _LCG_C) & 0xFFFFFFFF
    v = v - ((v >> 31) << 32)  # as a signed 32-bit value
    return torch.remainder(v, n)


def gather_lab_plain(tab, idx, o, inv):
    """tab (N, 80) f32, idx (R,) i32, o / inv (R, 3) f32 → (R,) f32; lanes
    whose idx lies outside [0, N) give NaN."""
    n = tab.shape[0]
    ok = (idx >= 0) & (idx < n)
    cur = torch.where(ok, idx, 0).to(torch.int64)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    ix, iy, iz = inv[:, 0], inv[:, 1], inv[:, 2]
    mn, mx = torch.minimum, torch.maximum
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=tab.device)
    for _ in range(ITERS):
        rt = tab[cur, :SLAB].T
        t0x = (rt[0:8] - ox) * ix
        t1x = (rt[8:16] - ox) * ix
        t0y = (rt[16:24] - oy) * iy
        t1y = (rt[24:32] - oy) * iy
        t0z = (rt[32:40] - oz) * iz
        t1z = (rt[40:48] - oz) * iz
        tn = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
        tf = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
        v = torch.where(tn <= tf, tn, 0.0)
        # the slots in XLA's CPU order (see csrc/gather_lab.cu)
        acc = acc + (((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7])))
        cur = lcg_next(cur, n)
    return torch.where(ok, acc, float("nan"))


def gather_lab(tab, idx, o, inv):
    """The lab's kernel; see ``gather_lab_plain`` for the contract."""
    if tab.device.type == "cpu":
        return gather_lab_plain(tab, idx, o, inv)
    if tab.device.type != "cuda":
        raise ValueError(f"gather_lab: unsupported device {tab.device}")
    n, r = tab.shape[0], idx.shape[0]
    dev = tab.device
    native.check_tensor("tab", tab, torch.float32, (n, ROW), dev)
    if tab.data_ptr() % 16:
        raise ValueError("tab: not 16-byte aligned (rows are read as float4)")
    if n == 0:
        raise ValueError("tab: no rows")
    native.check_tensor("idx", idx, torch.int32, (r,), dev)
    native.check_tensor("o", o, torch.float32, (r, 3), dev)
    native.check_tensor("inv", inv, torch.float32, (r, 3), dev)
    out = torch.empty(r, dtype=torch.float32, device=dev)
    lib = native.kernel_lib("gather_lab.cu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.check_launch(lib.pbrt_torch_gather_lab(
        tab.data_ptr(), idx.data_ptr(), o.data_ptr(), inv.data_ptr(), out.data_ptr(),
        n, r, stream), "gather_lab launch")
    launches["gather_lab"] += 1
    return out


def l2_read_plain(words, reads: int, threads: int):
    """words (n16, 4) int32 → (threads,) int32: for thread g the xor of the
    four words of rows (g + k·threads) mod n16, k < reads."""
    n16 = words.shape[0]
    fold = words[:, 0] ^ words[:, 1] ^ words[:, 2] ^ words[:, 3]
    j = torch.arange(threads, device=words.device) % n16
    x = torch.zeros(threads, dtype=torch.int32, device=words.device)
    for _ in range(reads):
        x ^= fold[j]
        j = (j + threads) % n16
    return x


def l2_read(words, reads: int, threads: int):
    """The L2 read ceiling's kernel (``l2_read_kernel``): thread g reads its
    rows of ``words`` with coalesced 16-byte L2-only loads; see
    ``l2_read_plain`` for what it returns."""
    if words.device.type == "cpu":
        return l2_read_plain(words, reads, threads)
    if words.device.type != "cuda":
        raise ValueError(f"l2_read: unsupported device {words.device}")
    dev = words.device
    native.check_tensor("words", words, torch.int32, (words.shape[0], 4), dev)
    if words.data_ptr() % 16 or words.shape[0] == 0:
        raise ValueError("words: empty or not 16-byte aligned")
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    lib = native.kernel_lib("gather_lab.cu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.check_launch(lib.pbrt_torch_l2_read(
        words.data_ptr(), words.shape[0], reads, out.data_ptr(), threads, stream),
        "l2_read launch")
    launches["l2_read"] += 1
    return out


def l2_ceiling(tab) -> dict:
    """The L2 read rate the lab is held against, on the card: the table's
    slab block (``tab[:, :48]``, 3 MiB, L2-resident) read as ``SLAB_BYTES``
    of coalesced 16-byte words per launch, by 1,024 warps (the lab's launch)
    and by 4,096. Per width: ``queued_rounds``' ms and TB/s; ``best`` the
    faster width's, ``lab_ms`` the lab's slab bytes at its rate. Each
    width's result is checked against ``l2_read_plain`` first."""
    words = tab[:, :SLAB].contiguous().view(torch.int32).view(-1, 4)
    res = {}
    for warps in (R // 32, 4 * R // 32):
        g = 32 * warps
        reads = SLAB_BYTES // (16 * g)
        if not torch.equal(l2_read(words, reads, g), l2_read_plain(words, reads, g)):
            raise SystemExit(f"l2_read disagrees with its plain version at {warps} warps")
        t = timing.queued_rounds(lambda: l2_read(words, reads, g))
        res[warps] = dict(t, tb_s=SLAB_BYTES / t["ms"] / 1e9)
    best = max(res.values(), key=lambda t: t["tb_s"])
    return dict(widths=res, best=best, lab_ms=SLAB_BYTES / best["tb_s"] / 1e9)


def lab_inputs(device, seed: int = 0, n: int = N, r: int = R):
    """The script's inputs (``pallas_gather_lab.main``), drawn in its order."""
    rng = np.random.default_rng(seed)
    tab = rng.random((n, ROW)).astype(np.float32)
    idx = rng.integers(0, n, r).astype(np.int32)
    o = rng.random((r, 3)).astype(np.float32)
    inv = (1.0 / (rng.random((r, 3)) + 0.1)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (tab, idx, o, inv))


def check_cases(device):
    """(n, r, (tab, idx, o, inv)) for each table size of ``CHECK_N`` and lane
    count of ``CHECK_R``: the lab's draw (seeded by n) cut to r lanes, with
    start indices outside [0, n) at lane 0 (-1), lane 31 (n) and the last
    lane (-2**31; the last lane of a ragged tail where r is not a multiple
    of 32). Every other lane starts inside the table."""
    for n in CHECK_N:
        tab, idx, o, inv = lab_inputs(device, seed=n, n=n)
        for r in CHECK_R:
            ix = idx[:r].clone()
            ix[0] = -1
            if r > 31:
                ix[31] = n
            if r > 1:
                ix[r - 1] = -2**31
            yield n, r, (tab, ix, o[:r].contiguous(), inv[:r].contiguous())


def work(idx: torch.Tensor, n: int) -> dict:
    """What these inputs need: distinct rows the walk touches, the bytes
    (each of those rows' 48 slab floats and each lane's inputs and output
    once) and the float operations."""
    touched = torch.zeros(n, dtype=torch.bool, device=idx.device)
    cur = idx.to(torch.int64)
    for _ in range(ITERS):
        touched[cur] = True
        cur = lcg_next(cur, n)
    rows = int(touched.sum())
    r = idx.shape[0]
    return dict(rows_touched=rows, bytes=rows * SLAB * 4 + r * LANE_BYTES,
                ops=r * ITERS * 8 * OPS_PER_SLOT)


def main() -> dict:
    """Times the kernel and the plain version at the lab's shapes on the
    card and measures the L2 read ceiling; prints them and returns ``ms``
    (median of 5 rounds), ``plain_ms``, ``bound_ms``, ``bound_by``,
    ``l2_ms`` (the lab's slab bytes at the ceiling's rate) and the work
    counted by ``work``."""
    if not torch.cuda.is_available():
        raise SystemExit("gather_lab: needs an NVIDIA GPU (torch.cuda.is_available() "
                         "is false)")
    dev = torch.device("cuda", 0)
    tab, idx, o, inv = lab_inputs(dev)
    k = timing.queued_rounds(lambda: gather_lab(tab, idx, o, inv))
    plain_ms = timing.cuda_ms(lambda: gather_lab_plain(tab, idx, o, inv), n=5, warm=1)
    w = work(idx, N)
    b_ms, b_by = timing.bound_ms(w["bytes"], w["ops"])
    l2 = l2_ceiling(tab)
    res = dict(ms=k["ms"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               l2_ms=l2["lab_ms"], **w)
    print(f"gather lab: table {N}x{ROW} = {N * ROW * 4 / 2**20:.2f} MiB, R={R}, "
          f"iters={ITERS}, on {timing.nvidia_smi()}")
    print(f"kernel {k['ms']:.5f} ms median of 5 rounds ({k['min']:.5f}–{k['max']:.5f}; "
          f"host enqueue {k['host_ms']:.4f} ms), plain {plain_ms:.3f} ms; "
          f"{w['rows_touched']} distinct rows, {w['bytes']} bytes, {w['ops']} operations; "
          f"bound {b_ms:.5f} ms ({b_by}), kernel / bound {k['ms'] / b_ms:.2f}x", flush=True)
    widths = ", ".join(f"{t['tb_s']:.3f} TB/s at {wp} warps ({t['ms']:.5f} ms, "
                       f"{t['min']:.5f}–{t['max']:.5f})" for wp, t in l2["widths"].items())
    print(f"L2 read ceiling (coalesced 16-byte reads of the {N * SLAB * 4 / 2**20:.0f} "
          f"MiB slab block, {SLAB_BYTES} bytes per launch): {widths}; the lab's slab bytes "
          f"at the best rate {l2['lab_ms']:.5f} ms, kernel / that {k['ms'] / l2['lab_ms']:.2f}x",
          flush=True)
    return res


if __name__ == "__main__":
    main()
