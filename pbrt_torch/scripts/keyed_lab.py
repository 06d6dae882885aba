"""The redesigned keyed kernels, ``keyed_volume_uniforms``,
``keyed_chain_uniforms``, ``mlt_mutate`` (and its large-only mode) and
``keyed_camera_normals``, timed at every shape their callers use and,
with ``--parent``, in turns beside an earlier tree's.

    python -m pbrt_torch.scripts.keyed_lab [--parent DIR] [--rounds 5]
        [--kernels volume,chain,mutate,normals]

Run from the repository's root (it imports ``chip_smoke`` for its SASS
counts and bounds); needs a card: where the card is on another machine,
the command goes there with a copy of the tree and runs from its root,
e.g. ``python -m pbrt_torch.scripts.keyed_lab --parent
.chip_scratch/parent --kernels mutate,normals``. ``DIR`` is an unpacked
earlier tree (``git archive <rev> | tar -x -C DIR``, in a directory
``.gitignore`` lists): its ``pbrt_torch/csrc/rng.cu`` is built with this
tree's nvcc flags, its
entries bound with the argument types its own
``pbrt_torch/utils/native.py`` gives them (``parent_entries``), and
launched through its own ``pbrt_torch/core/rng.py`` wrappers
(``parent_rng``), so that each build's host enqueue time is its
wrapper's.

The shapes on 32,768 lanes (indices 0 … 32,767, sample 1), ``volume`` and
``chain`` (``SHAPES``): the volume block under emission (5 columns) and
single scattering (101), the irradiance cache's gather directions (4 ×
2), ambient occlusion's keyed directions (``sampler.key_uniforms``: 5 + 4
× 2), the irradiance cache's nested jitters (4 × 5), IGI's VPL picks (8 ·
5), the keyed bounce block at depth 5 (``key_uniforms``: 5 + 35, 7 of 8
counters), the cache's nested bounce blocks (5 + 4 × 35), ``glossyprt``'s
draws (64 × 3) and the cache's single-scattering steps (4 × 32 × 3); the
three that ``keyed_rows`` takes (``ROW_SHAPES``) also on 4,096 and
100,000 lanes (a small chunk; the Metropolis bootstrap). ``mutate``
(``chip_smoke.MUTATE_TIMED``): 16,384 chains × 60 dimensions at p_large
.25, 1 and 0, × 40 at .25, the large-only 100,000 × 60 and 4,096 × 2;
``normals`` (``chip_smoke.NORMALS_TIMED``): 32,768 lanes × 11 tags (the
realistic camera's D-Gauss stack) and × 1 (the ideal camera), 4,096 ×
11 (a small chunk). For each shape every build is held to the plain
version bit for bit, then
timed in the order parent, this, this, parent (the median and min–max of
``--rounds`` rounds of ``timing.queued_rounds`` each, with the median
host enqueue time a call), with ``nvidia-smi``'s SM clock sampled
meanwhile. It prints a line per shape with the bound, this build's
issue-slot bound (``chip_smoke.keyed_tile_timed``'s count for the tiles,
``chip_smoke.rng_timed_case``'s for the other two), each build's
registers (ptxas) and blocks per SM, and a JSON line of all of it, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import torch

from pbrt_torch.core import rng
from pbrt_torch.utils import native, timing

#: the kernels a run may time (``--kernels``)
KERNELS = ("volume", "chain", "mutate", "normals")
#: the wall time one timing round should take, in ms
ROUND_MS = 100.0
LANES = 1 << 15
#: the shapes ``keyed_rows`` takes, timed also on a chunk of 4,096 lanes and
#: on the Metropolis bootstrap's 100,000
ROW_SHAPES = ("volume emission (5)", "cache directions (8)", "AO directions (13)")
ROW_LANES = (4096, 100000)
_GATHER = (416 * 16 + rng.CAMERA, 4)
#: name → ("volume", J, single) or ("chain", chain_uniforms keywords)
SHAPES = {
    "volume emission (5)": ("volume", 5, False),
    "cache directions (8)": ("chain", dict(chain=[(rng.BSDF_SAMPLE, 4)], n=2)),
    "AO directions (13)": ("chain", dict(chain=[(rng.BSDF_SAMPLE, 4)], n=2, lead=5)),
    "cache jitters (20)": ("chain", dict(chain=[_GATHER, (rng.VOLUME, 5)])),
    "VPL picks (40)": ("chain", dict(chain=[(rng.PHOTON, 5), (rng.PHOTON, 8)])),
    "bounce block (40)": ("chain", dict(chain=[rng.BATCHED], n=35, used=7, drawn=8, lead=5)),
    "volume single (101)": ("volume", 5, True),
    "nested blocks (145)": ("chain", dict(chain=[_GATHER, rng.BATCHED], n=35, used=7, drawn=8,
                                          lead=5)),
    "glossyprt (192)": ("chain", dict(chain=[(rng.BSDF_SAMPLE, 64)], n=3)),
    "cache steps (384)": ("chain", dict(chain=[_GATHER, rng.VOLUME, (rng.LIGHT_SAMPLE, 32)],
                                        n=3)),
}


def parent_entries(tree: str) -> dict:
    """The argument types of ``tree``'s ``rng.cu`` entries, as its own
    ``pbrt_torch/utils/native.py`` binds them (loaded as a module of its
    own: it imports the standard library only)."""
    path = os.path.join(os.path.abspath(tree), "pbrt_torch", "utils", "native.py")
    spec = importlib.util.spec_from_file_location("keyed_lab_parent_native", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNEL_ENTRIES["rng.cu"]


def parent_lib(tree: str):
    """``tree``'s ``rng.cu`` built with this tree's flags into
    ``pbrt_torch/_build``, its entries bound as ``tree`` binds them →
    (library, ptxas' report or None where it was built before)."""
    src = os.path.join(os.path.abspath(tree), "pbrt_torch", "csrc", "rng.cu")
    so = os.path.join(native.BUILD_DIR, "libpbrt_torch_rng_parent-"
                      + native._digest(src, native.NVCC_FLAGS) + ".so")
    log = None
    if not os.path.exists(so):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", so, src],
                              check=True, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    for entry, argtypes in parent_entries(tree).items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib, log


def parent_rng(tree: str, lib):
    """``tree``'s ``pbrt_torch/core/rng.py`` as a module of its own whose
    wrappers launch ``lib`` (its ``native.kernel_lib`` returns it, after
    the lookup this tree's wrappers pay): the earlier tree's host code and
    kernels, called as its integrators called them."""
    path = os.path.join(os.path.abspath(tree), "pbrt_torch", "core", "rng.py")
    spec = importlib.util.spec_from_file_location("keyed_lab_parent_rng", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    def kernel_lib(source: str):
        native.kernel_lib(source)
        return lib

    mod.native = types.SimpleNamespace(**{**vars(native), "kernel_lib": kernel_lib})
    return mod


def launch(mod, spec, root, index, sample: int):
    """The wrapper of ``spec``'s kernel in ``mod`` (this tree's ``rng`` or
    ``parent_rng``'s) on the lanes → (R, width)."""
    if spec[0] == "volume":
        return mod.volume_uniforms(root, index, sample, spec[1], spec[2])
    return mod.chain_uniforms(root, index, sample, **spec[1])


def shape_work(spec, R: int):
    """(kind keywords, uniforms, width, tiling, key hashes, bound (ms, by))
    of a shape on R lanes, counted as ``chip_smoke.py`` counts them."""
    import chip_smoke as cs

    if spec[0] == "volume":
        _, J, single = spec
        width = J + 96 * single
        kw = dict(n_jitter=J, single=single)
        bound = timing.bound_ms(
            R * (8 + 4 * width), f32_ops=R * width,
            i32_ops=R * (cs.OPS_AO_LANE_KEY + J * cs.OPS_PER_JITTER
                         + single * (cs.OPS_VOLUME_KEY + 32 * cs.OPS_PER_STEP)))
        return kw, width, width, rng.volume_tiling(R, J, single, rng.sm_count(0)), \
            cs.keyed_key_hashes(R, "volume", **kw), bound
    kw = spec[1]
    tags = rng._chain_tags(kw.get("chain", ()))
    n, lead = kw.get("n", 1), kw.get("lead", 0)
    n_u = math.prod(c for _, c in tags) * n
    hashes = cs.keyed_key_hashes(R, "chain", **kw)
    bound = timing.bound_ms(
        R * (8 + 4 * (lead + n_u)), f32_ops=R * n_u,
        i32_ops=R * (cs.OPS_AO_LANE_KEY + (hashes[0] // R - 2) * cs.OPS_CHAIN_GROUP_TAG
                     + n_u * (cs.OPS_PER_UNIFORM + 2)))
    return kw, n_u, lead + n_u, rng.chain_tiling(R, tags, n, lead, rng.sm_count(0)), hashes, \
        bound


def in_turns(run: dict, order: list, rounds: int):
    """Each build's launch (``run``: name → callable) timed in ``order``
    (``timing.queued_rounds``, as many calls a round as fill ~``ROUND_MS``),
    ``nvidia-smi``'s SM clock sampled meanwhile → (calls, {name: [rounds'
    results in turn order]}, SM MHz or None)."""
    import chip_smoke as cs

    calls = {n: max(1, min(50, int(ROUND_MS / max(timing.cuda_ms(fn, n=1, warm=1), 1e-3))))
             for n, fn in run.items()}
    ms = {n: [] for n in run}
    with cs.SmClock() as clk:
        for n in order:
            ms[n].append(timing.queued_rounds(run[n], rounds, calls[n], warm=1))
    return calls, ms, clk.mhz


def report(name: str, lanes: int, layout: str, equal: dict, ms: dict, bound, issue, mhz,
           reg: dict, occ: dict, smi: str):
    """Prints a shape's line: each build's medians (min–max) and host
    enqueue times in turn order, the bound and issue-slot bound, registers
    and blocks per SM."""
    b_ms, b_by = bound
    best = min(r["ms"] for r in ms["this"])
    print(f"[keyed_lab] {name}, {lanes} lanes, {layout}: bit-equal to plain {equal}; " + "; ".join(
        f"{n} " + ", ".join(f"{r['ms']:.5f} ({r['min']:.5f}–{r['max']:.5f})" for r in v)
        + " ms, host enqueue " + ", ".join(f"{r['host_ms']:.4f}" for r in v) + " ms"
        for n, v in ms.items())
        + f"; bound {b_ms:.5f} ms ({b_by}), this / bound {best / b_ms:.2f}x; issue-slot "
        + (f"bound {issue:.5f} ms (this / issue {best / issue:.2f}x, SM clock {mhz:g} MHz)"
           if issue else "bound not measured (no SM clock read)")
        + f"; registers {reg}, blocks per SM {occ} ({smi})", flush=True)


def main(argv=None) -> dict:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to time, of " + ", ".join(KERNELS))
    args = ap.parse_args(argv)
    kinds = args.kernels.split(",")
    if not set(kinds) <= set(KERNELS):
        raise SystemExit(f"keyed_lab: --kernels {args.kernels}: not of {KERNELS}")
    if not torch.cuda.is_available():
        raise SystemExit("keyed_lab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = timing.nvidia_smi()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[keyed_lab] {torch.cuda.get_device_name(0)}, {sms} SMs; nvidia-smi: {smi}",
          flush=True)
    # build name → (rng module, library, ptxas' report)
    this_lib = native.kernel_lib("rng.cu")
    builds = {"this": (rng, this_lib, native.build_log.get("pbrt_torch_rng"))}
    if args.parent:
        lib, log = parent_lib(args.parent)
        builds = {"parent": (parent_rng(args.parent, lib), lib, log), **builds}
    regs = {n: cs.kernel_registers(lib._name, log) for n, (_, lib, log) in builds.items()}
    order = list(builds) + list(builds)[::-1]
    tiled = [k for k in ("volume", "chain") if k in kinds]
    sass = {f"keyed_{k}_uniforms_kernel": cs.keyed_tile_sass(this_lib._name,
                                                             f"keyed_{k}_uniforms_kernel")
            for k in tiled}
    if sass:
        print("[keyed_lab] this SASS: " + "; ".join(
            f"{k}: a uniform {d['elem']} ({d['elem_pipes']}), a hash with a narrow group's key "
            f"{d['fused']:.1f}, a key hash {d['key']:.1f}, {d['total']} in all"
            for k, d in sass.items()), flush=True)
    root = rng.root_key(0)
    cases = [(name, spec, LANES) for name, spec in SHAPES.items() if spec[0] in tiled]
    cases += [(name, SHAPES[name], lanes) for lanes in ROW_LANES for name in ROW_SHAPES
              if SHAPES[name][0] in tiled]
    rows_out = []
    for name, spec, lanes in cases:
        index = torch.arange(lanes, dtype=torch.int64, device=dev)
        kw, n_u, width, tiling, key_hashes, bound = shape_work(spec, lanes)
        kernel = f"keyed_{spec[0]}_uniforms_kernel"
        run = {n: (lambda mod=mod: launch(mod, spec, root, index, 1))
               for n, (mod, _, _) in builds.items()}
        ref = (rng.volume_uniforms_plain(root, index, 1, spec[1], spec[2]) if spec[0] == "volume"
               else rng.chain_uniforms_plain(root, index, 1, **kw))
        equal = {n: torch.equal(fn().view(torch.int32), ref.view(torch.int32))
                 for n, fn in run.items()}
        if not all(equal.values()):
            raise SystemExit(f"keyed_lab: {name}: a build disagrees with the plain version "
                             f"({equal})")
        calls, ms, mhz = in_turns(run, order, args.rounds)
        t = [int(w) for w in tiling]
        fused = spec[0] == "volume" or spec[1].get("n", 1) == 1 or not t[4]
        issue = (cs.keyed_issue_ms(sass[kernel], lanes * n_u, key_hashes, fused, mhz, sms)
                 if mhz else None)
        ran = kernel if t[4] else kernel.replace("_uniforms_kernel", "_rows_kernel")
        reg = {n: next((v for f, v in r.items() if ran in f), None) for n, r in regs.items()}
        smem = 8 * t[1] * (1 + t[8] + t[11]) if t[4] else 0  # keyed_rows stages no key
        occ = {n: cs.blocks_per_sm(v, smem, t[3]) if v else None for n, v in reg.items()}
        rows_out.append(dict(
            shape=name, lanes=lanes, width=width, uniforms=lanes * n_u, key_hashes=key_hashes[0],
            group_key_hashes=key_hashes[1],
            tile_rows=t[1], tile_cols=t[5], threads=t[3], pass_rows=t[4],
            bands=-(-lanes // t[1]), bound_ms=bound[0], bound_by=bound[1], issue_bound_ms=issue,
            sm_mhz=mhz, equal=equal, calls=calls, registers=reg, blocks_per_sm=occ,
            ms={n: [r["ms"] for r in v] for n, v in ms.items()},
            min_max={n: [(r["min"], r["max"]) for r in v] for n, v in ms.items()},
            host_ms={n: [r["host_ms"] for r in v] for n, v in ms.items()}))
        report(name, lanes, f"tiles of {t[1]} x {t[5]} ({-(-lanes // t[1])} blocks of {t[3]} "
               "threads, " + (f"{t[4]} rows a pass)" if t[4] else
                              f"a row's groups to {t[11]} threads)"),
               equal, ms, bound, issue, mhz, reg, occ, smi)
    labels = [*cs.MUTATE_TIMED] * ("mutate" in kinds) + [*cs.NORMALS_TIMED] * ("normals" in kinds)
    for label in labels:
        case = cs.rng_timed_case(label, dev)
        run = {n: (lambda mod=mod: case["run"](mod)) for n, (mod, _, _) in builds.items()}
        equal = {n: case["equal"](fn()) for n, fn in run.items()}
        if not all(equal.values()):
            raise SystemExit(f"keyed_lab: {label}: a build disagrees with the plain version "
                             f"({equal})")
        calls, ms, mhz = in_turns(run, order, args.rounds)
        issue = case["issue"](this_lib._name, mhz, sms) if mhz else None
        # an earlier tree's kernel of the same entry (one kernel for both of the mutation's
        # modes, or for any tag count, in trees before these designs)
        reg = {n: next((v for f, v in r.items() if case["kernel"] in f), None)
               if n == "this" else next((v for f, v in r.items() if (
                   "keyed_camera_normals" if case["kind"] == "normals" else "mlt_") in f), None)
               for n, r in regs.items()}
        occ = {"this": cs.blocks_per_sm(reg["this"], case["smem"], case["threads"])
               if reg["this"] else None}
        if reg.get("parent"):  # the one-kernel designs: 256 threads and 257 B, or 128 and a tile
            tags = cs.NORMALS_TIMED[label][1] if case["kind"] == "normals" else 0
            occ["parent"] = (cs.blocks_per_sm(reg["parent"], 128 * 2 * min(tags, 16) * 4, 128)
                             if tags else cs.blocks_per_sm(reg["parent"], 257, 256))
        rows_out.append(dict(
            shape=f"{case['kind']} {label}", lanes=case["lanes"], work=case["work"],
            kernel=case["kernel"], threads=case["threads"], smem_bytes=case["smem"],
            bound_ms=case["bound"][0], bound_by=case["bound"][1], issue_bound_ms=issue,
            sm_mhz=mhz, equal=equal, calls=calls, registers=reg, blocks_per_sm=occ,
            ms={n: [r["ms"] for r in v] for n, v in ms.items()},
            min_max={n: [(r["min"], r["max"]) for r in v] for n, v in ms.items()},
            host_ms={n: [r["host_ms"] for r in v] for n, v in ms.items()}))
        report(f"{case['kind']} {label}", case["lanes"],
               f"{case['work']}; {case['kernel']}, blocks of {case['threads']}",
               equal, ms, case["bound"], issue, mhz, reg, occ, smi)
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, sms=sms,
                  rounds=args.rounds, order=order, sass=sass, shapes=rows_out)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
