"""The dipole's Mo gather on ``chip_smoke.py`` phase 15's lane sets, timed
in turns beside its FMA-contracted build and, with ``--parent``, earlier
trees' kernels.

    python -m pbrt_torch.scripts.mo_lab [--parent DIR]... [--rounds 5]

Run from the repository's root (it imports ``chip_smoke`` for the scene
and the lanes); needs a card. Each ``DIR`` is an unpacked earlier tree
(``git archive <rev> | tar -x -C DIR``), named by its last path part. Its
``pbrt_torch/csrc/dipole.cu`` is built with this tree's nvcc flags and
bound with its own ``utils/native.py``'s entry types. A tree whose
``integrators/dipole.py`` has ``launch_with`` and ``kernel_info`` is
launched and described by them. A tree with only the first kernel's entry
(``PARENT_ENTRY``: no lane-list scratch, 256 threads a block, one lane a
warp) is launched by ``launch_parent`` and described by ``cuobjdump``.
Any other tree is refused.

The sets are phase 15's, drawn by ``chip_smoke.mo_lane_sets`` from
``goldens/ss-envmap.pbrt`` as written (its files generated by
``chip_smoke.write_ss_envmap_data`` into a temporary directory): 32,768
first hits of two camera samples, the subsurface hits active, and the same
lanes with ``chip_smoke.MO_SPARSE_SHARE`` of them active (the later
bounces). On each set every bit-exact build is held to its tree's
``mo_gather_plain`` (each parent's from its ``DIR``, in its own order) bit
for bit before it is timed (a build that is not is left untimed, and the
script fails after its JSON line; the FMA-contracted one, a measurement of
what bit equality costs, is compared by its largest error). Then the
builds are timed in the order parents, this, fmad, and back again (the
median and min–max of ``--rounds`` rounds of ``timing.queued_rounds``
each), with ``nvidia-smi``'s SM clock sampled meanwhile. Each build is
described by its registers, blocks per SM and its SASS per (lane, point)
(``chip_smoke.sass_loop_stats``), from which the script takes its
issue-slot bound beside the operation bound; this build also by the share
of (active lane, tile) pairs that took the checked terms. It prints a line
per set and a JSON line of all of it, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import torch

from pbrt_torch.integrators import dipole
from pbrt_torch.utils import native, timing

#: the first kernel's C entry (prm, p, active, q, q2, ea, n_points, R, S, out, stream)
PARENT_ENTRY = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
#: the first kernel: 8 warps a block, a warp a lane (a thread a bin), the
#: 64-point tile's halving tree (no inner loop)
PARENT_GEOMETRY = dict(warps=8, threads=256, tile=64, group=64)
KERNEL = "mo_gather_kernel"


def _tree_module(tree: str, rel: str, name: str):
    """``tree``'s ``pbrt_torch/<rel>`` loaded as module ``name``, beside this
    tree's modules (which its imports resolve to)."""
    path = os.path.join(os.path.abspath(tree), "pbrt_torch", rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_build(tree: str, label: str) -> dict:
    """``tree``'s ``dipole.cu`` built with this tree's flags into
    ``pbrt_torch/_build`` (ptxas' report in ``native.build_log``) and bound
    with its own entry types → dict of lib, run (lib, prm, p, active,
    table → (R, S)), plain (its ``mo_gather_plain``) and info (lib → its
    ``kernel_info``, or None: ``cuobjdump`` and the occupancy count)."""
    entries = _tree_module(tree, "utils/native.py", f"mo_lab_{label}_native").KERNEL_ENTRIES
    entries = entries["dipole.cu"]
    mod = _tree_module(tree, "integrators/dipole.py", f"mo_lab_{label}_dipole")
    own = "pbrt_torch_mo_gather_info" in entries and hasattr(mod, "launch_with") \
        and hasattr(mod, "kernel_info")
    if not own and entries != {"pbrt_torch_mo_gather": PARENT_ENTRY}:
        raise SystemExit(f"mo_lab: {tree}'s dipole.cu has neither an info entry with "
                         f"launch_with and kernel_info nor the first kernel's entry alone "
                         f"({sorted(entries)}); not launched")
    src = os.path.join(os.path.abspath(tree), "pbrt_torch", "csrc", "dipole.cu")
    name = f"pbrt_torch_dipole_{label}"
    so = os.path.join(native.BUILD_DIR, f"lib{name}-{native._digest(src, native.NVCC_FLAGS)}.so")
    if not os.path.exists(so):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", so, src], check=True,
                              capture_output=True, text=True)
        native.build_log[name] = proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return dict(lib=lib, run=mod.launch_with if own else launch_parent,
                plain=mod.mo_gather_plain, info=mod.kernel_info if own else None)


def launch_parent(lib, prm, p, active, table):
    """The first kernel from ``lib`` on the wrapper's inputs → (R, S)."""
    q, q2, ea = table
    R, S = p.shape[0], ea.shape[1]
    out = torch.empty((R, S), dtype=torch.float32, device=p.device)
    native.check_launch(lib.pbrt_torch_mo_gather(
        prm.data_ptr(), p.data_ptr(), active.data_ptr(), q.data_ptr(), q2.data_ptr(),
        ea.data_ptr(), q.shape[0], R, S, out.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream), "parent mo_gather launch")
    return out


def res_usage(lib_path: str, kernel: str) -> dict:
    """``kernel``'s (a substring of its name) registers, stack, shared and
    local bytes, as ``cuobjdump -res-usage`` reports them."""
    tool = os.path.join(os.path.dirname(native.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                          check=True).stdout
    for m in re.finditer(r"Function (\S+):\s*\n?\s*(.*)", text):
        if kernel in m.group(1):
            return {k.lower(): int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                             m.group(2))}
    raise SystemExit(f"res_usage: no function named like {kernel}")


def blocks_per_sm(registers: int, shared: int, threads: int) -> int:
    """Resident blocks per SM of an H100 (compute capability 9.0) for a
    kernel of ``registers`` per thread, ``shared`` static bytes and
    ``threads`` per block: 2,048 threads, 32 blocks, 65,536 registers in
    per-warp units of 256 and 228 KiB of shared memory (1 KiB reserved per
    block) an SM, as the CUDA occupancy calculator counts them."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 233472 // (shared + 1024)
    return min(32, 2048 // threads, by_regs, by_smem)


def build_info(cs, lib, info) -> dict:
    """A build's warps and threads a block, tile and group, registers,
    blocks per SM and SASS per (lane, point): from ``info(lib)`` (its
    tree's ``kernel_info``) where given, else from ``cuobjdump -res-usage``
    and the occupancy calculator's count (``blocks_per_sm``) for the first
    kernel's geometry."""
    if info is not None:
        out = info(lib)
    else:
        use = res_usage(lib._name, KERNEL)
        out = dict(PARENT_GEOMETRY, registers=use.get("reg", 0),
                   local_bytes=use.get("stack", 0), shared_bytes=use.get("shared", 0))
        out["blocks_per_sm"] = blocks_per_sm(out["registers"], out["shared_bytes"],
                                             out["threads"])
    # where the gather is a template, its main path's instance (the other
    # counts the tiles on the checked terms)
    name = KERNEL + "ILb0E" if sum(KERNEL in k for k in cs._sass_functions(lib._name)) > 1 \
        else KERNEL
    out["sass"] = cs.sass_loop_stats(lib._name, name, out["tile"] // out["group"])
    return out


def info_text(info: dict) -> str:
    sass = info["sass"]
    per = lambda k: ", ".join(f"{c} {sass[k][c]:.3g}" for c in ("MUFU", "LDS", "LDL+STL", "BRA",
                                                              "BAR"))
    return (f"{info['registers']} registers, {info['local_bytes']} local bytes, "
            f"{info['blocks_per_sm']} blocks of {info['threads']} per SM, one lane a warp; "
            f"SASS per (lane, point): issued "
            f"{sass['issued']['instructions']:.2f} ({per('issued')}), static "
            f"{sass['static']['instructions']:.2f} ({per('static')}); loop {sass['loop']} + "
            f"{sass['outer']} instructions of {sass['total']}")


def main(argv=None) -> dict:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="an unpacked earlier tree to time beside this one (repeatable)")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mo_lab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = timing.nvidia_smi()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[mo_lab] {torch.cuda.get_device_name(0)}, {sms} SMs; nvidia-smi: {smi}", flush=True)
    builds = {}
    for tree in args.parent:
        label = os.path.basename(os.path.normpath(tree))
        if label in ("this", "fmad") or label in builds:
            raise SystemExit(f"mo_lab: two builds named {label}")
        builds[label] = parent_build(tree, label)
    for n, fmad in (("this", False), ("fmad", True)):
        builds[n] = dict(lib=native.kernel_lib("dipole.cu", fmad=fmad), run=dipole.launch_with,
                         plain=dipole.mo_gather_plain, info=dipole.kernel_info)
    libs = {n: b["lib"] for n, b in builds.items()}
    run_with = {n: b["run"] for n, b in builds.items()}
    plain = {n: b["plain"] for n, b in builds.items()}
    order = list(libs)
    order += order[::-1]
    info = {n: build_info(cs, b["lib"], b["info"]) for n, b in builds.items()}
    for n in libs:
        print(f"[mo_lab] {n}: {info_text(info[n])}", flush=True)
    for name_, log in sorted(native.build_log.items()):
        if "dipole" in name_:
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"[mo_lab] {name_}: {ln.strip()}", flush=True)

    with tempfile.TemporaryDirectory() as data_dir:
        cs.write_ss_envmap_data(data_dir)
        built = cs.load_checked(cs.ss_envmap_scene(data_dir), dev, "goldens/ss-envmap.pbrt")
    ss, mt = built.scene.subsurface, built.scene.materials
    sets = cs.mo_lane_sets(built, dev)
    prm, p, table = sets["prm"], sets["p"], sets["table"]
    Np, S = table[0].shape[0], table[2].shape[1]
    R = p.shape[0]
    rows = []
    for set_name in ("active", "sparse"):
        active = sets[set_name]
        act8 = active.to(torch.uint8)
        n_act = int(active.sum())
        refs = {f: f(ss, mt, sets["si"].p, sets["si"].material, active, params=tuple(prm),
                     table=table) for f in set(plain.values())}
        run = {n: (lambda lib=lib, n=n: run_with[n](lib, prm, p, act8, table))
               for n, lib in libs.items()}
        err, equal = {}, {}
        for n, fn in run.items():
            out, ref = fn(), refs[plain[n]]
            torch.cuda.synchronize()
            err[n] = float((out - ref).abs().max())
            equal[n] = torch.equal(out.view(torch.int32), ref.view(torch.int32))
        wrong = [n for n, v in equal.items() if not v and n != "fmad"]
        tiles = torch.zeros(1, dtype=torch.int64, device=dev)
        dipole.launch_with(libs["this"], prm, p, act8, table, checked=tiles)
        checked = int(tiles) / max(n_act * (Np // dipole.TILE), 1)
        run = {n: fn for n, fn in run.items() if n not in wrong}
        calls = {n: max(1, min(50, int(100.0 / max(timing.cuda_ms(fn, n=1, warm=1), 1e-3))))
                 for n, fn in run.items()}
        ms = {n: [] for n in run}
        with cs.SmClock() as clk:
            for n in order:
                if n in run:
                    ms[n].append(timing.queued_rounds(run[n], args.rounds, calls[n], warm=1))
        mhz = clk.mhz
        op_ms, op_by = timing.bound_ms(
            7 * R * S * 4 + R * (12 + 1) + Np * (3 + 1 + S) * 4 + R * S * 4,
            f32_ops=n_act * ss.points.shape[0] * (cs.OPS_MO_PER_POINT + S * cs.OPS_MO_PER_BIN))
        issue = {n: (cs.issue_bound_ms(n_act, Np, info[n]["sass"]["issued"]["instructions"],
                                       mhz, sms) if mhz else None) for n in libs}
        # the special-function unit takes 16 lanes a clock per SM: a warp's
        # MUFU instruction holds it 2 clocks, 8 of a scheduler's issue slots
        mufu = {n: (cs.issue_bound_ms(n_act, Np, info[n]["sass"]["issued"]["MUFU"] * 8, mhz, sms)
                    if mhz else None) for n in libs}
        rows.append(dict(set=set_name, lanes=R, active=n_act, points=Np, bins=S, sm_mhz=mhz,
                         equal=equal, max_abs_err=err, checked_tile_share=checked, calls=calls,
                         bound_ms=op_ms, bound_by=op_by, issue_bound_ms=issue, mufu_bound_ms=mufu,
                         ms={n: [r["ms"] for r in v] for n, v in ms.items()},
                         min_max={n: [(r["min"], r["max"]) for r in v] for n, v in ms.items()}))
        best = {n: min(r["ms"] for r in ms[n]) for n in run}
        print(f"[mo_lab] {set_name} set: {R} lanes, {n_act} active, {Np} points, {S} bins; "
              f"bit-equal to plain {equal} (fmad max abs err {err['fmad']:.3g}); this build's "
              f"(active lane, tile) pairs on the checked terms {100 * checked:.3f}%; "
              + "; ".join(f"{n} " + ", ".join(f"{r['ms']:.4f} ({r['min']:.4f}–{r['max']:.4f})"
                                               for r in ms[n]) + " ms" for n in run)
              + f"; operation bound {op_ms:.4f} ms ({op_by}), this / bound "
              f"{best.get('this', math.nan) / op_ms:.2f}x; SM clock {mhz} MHz; issue-slot bound "
              + ", ".join(f"{n} {issue[n]:.4f} ms ({best[n] / issue[n]:.2f}x)"
                          for n in run if issue[n])
              + "; MUFU-pipe bound " + ", ".join(f"{n} {mufu[n]:.4f} ms" for n in libs
                                                  if mufu[n])
              + f" ({smi})", flush=True)
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, sms=sms,
                  rounds=args.rounds, order=order, builds=info, sets=rows)
    print(json.dumps(result), flush=True)
    wrong = sorted({n for r in rows for n, v in r["equal"].items() if not v and n != "fmad"})
    if wrong:
        raise SystemExit(f"mo_lab: {wrong} disagree with their plain version (not timed)")
    return result


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
