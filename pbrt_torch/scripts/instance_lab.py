"""The instance phase's two kernels on ``chip_smoke.py`` phase 11(b)'s
permuted set, timed and, with ``--parent``, timed in turns beside an
earlier tree's.

    python -m pbrt_torch.scripts.instance_lab [--parent DIR] [--rounds 5]

Run from the repository's root (it imports ``chip_smoke`` for the scene
and the ray set); needs a card. ``DIR`` is an unpacked earlier tree
(``git archive <rev> | tar -x -C DIR``): its ``pbrt_torch/csrc/traverse.cu``
is built with this tree's nvcc flags, and its instance entries take the
same arguments as this tree's.

The set is phase 11(b)'s timing set (``chip_smoke.instance_lane_sets``'s
``sub``): 64 instanced killeroos (``chip_smoke.instanced_scene_text()``),
1,048,576 camera and bounce rays, 32,768 of them drawn at random, closest
hit seeded with the world walk, any hit on segments cut at 0.5 or 1.5
times the closest hit (``chip_smoke.instance_timed_args``). For each of
the two kernels the script runs the plain phase (the kernels' schedule,
held to the JAX package's serial phase by the CPU tests), holds every build
to it bit for bit, then times the builds in the order parent, this,
this, parent (the median and min–max of ``--rounds`` rounds of
``timing.queued_rounds`` each), and prints a line per kernel with the
bound, the plain phase's per-lane and per-warp counts, each build's
registers (ptxas) and blocks per SM, and a JSON line of all of it, with the
card's name and power limit. With ``--parent`` it also says, kernel by
kernel, whether the world walks (static and motion) and the standalone
step compiled to the same SASS in both trees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from pbrt_torch.accel import traverse_cuda as tc
from pbrt_torch.utils import native, timing

#: the wall time one timing round of a kernel should take, in ms (its calls
#: per round follow from one call's time, 1 to 50)
ROUND_MS = 100.0
#: the kernels the instance phase's change leaves alone (their SASS is
#: compared with the parent's)
OTHER_KERNELS = ("wide_step", "traverse_closest", "traverse_any", "traverse_closest_motion",
                 "traverse_any_motion")


def parent_lib(tree: str):
    """``tree``'s ``traverse.cu`` built with this tree's flags into
    ``pbrt_torch/_build`` → (library, ptxas' report or None where it was
    built before)."""
    src = os.path.join(os.path.abspath(tree), "pbrt_torch", "csrc", "traverse.cu")
    so = os.path.join(native.BUILD_DIR, "libpbrt_torch_traverse_parent-"
                      + native._digest(src, native.NVCC_FLAGS) + ".so")
    log = None
    if not os.path.exists(so):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", so, src],
                              check=True, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    for key in tc.INSTANCE_KERNELS:
        fn = getattr(lib, "pbrt_torch_" + key)
        fn.restype = ctypes.c_int
        fn.argtypes = native.KERNEL_ENTRIES["traverse.cu"]["pbrt_torch_" + key]
    return lib, log


def launch(lib, key, itab, args):
    """The instance kernel ``key`` of ``lib`` on the table ``itab`` and
    the lanes ``args`` → (t, prim, b1, b2, inst); counts no launch."""
    rows, stack, w2o, lo, hi, root = itab
    o = args[0]
    R, dev = o.shape[0], o.device
    out = (torch.empty(R, device=dev), torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, device=dev), torch.empty(R, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev))
    head = [x.data_ptr() for x in (rows, w2o, lo, hi, root)]
    tail = [x.data_ptr() for x in (*args, *out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.check_launch(getattr(lib, "pbrt_torch_" + key)(*head, root.shape[0], *tail, R,
                                                          int(stack), stream), f"{key} launch")
    return out


def main(argv=None) -> dict:
    import chip_smoke as cs
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("instance_lab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = timing.nvidia_smi()
    print(f"[instance_lab] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    libs = {"this": native.kernel_lib("traverse.cu")}
    logs = {"this": native.build_log.get("pbrt_torch_traverse")}
    same_sass = None
    if args.parent:
        libs["parent"], logs["parent"] = parent_lib(args.parent)
        sass = {n: {f: [ins[2:] for ins in body] for f, body in
                    cs._sass_functions(lib._name).items()} for n, lib in libs.items()}
        pick = lambda n, key: next((v for f, v in sass[n].items()
                                    if tc.KERNEL_NAMES[key] + "E" in f), None)
        same_sass = {key: pick("this", key) is not None and pick("this", key) == pick("parent", key)
                     for key in OTHER_KERNELS}
        print(f"[instance_lab] the other traversal kernels' SASS (opcodes and operands) equal "
              f"to the parent's: {same_sass}", flush=True)
    regs = {n: cs.kernel_registers(lib._name, logs.get(n)) for n, lib in libs.items()}
    order = [n for n in ("parent", "this") if n in libs]
    order += order[::-1]
    bits = lambda a, b: all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                            for x, y in zip(a, b))

    built = build(load_scene_string(cs.instanced_scene_text()), device=dev)
    g = built.scene.geometry
    itab = (g.inst_rows, g.inst_stack, g.inst_w2o, g.inst_lo, g.inst_hi, g.inst_root)
    timed = cs.instance_timed_args(g, cs.instance_lane_sets(built, dev))
    # threads a block (the parent's instance kernels had the others' 128)
    # and its stacks' shared memory, one stack of inst_stack ints a ray
    threads = {"this": tc.INSTANCE_BLOCK_THREADS, "parent": 128}
    smem = {n: t // 8 * max(g.inst_stack, 1) * 4 for n, t in threads.items()}
    rows_out = []
    for key, targs in timed.items():
        any_hit = key == "traverse_instances_any"
        R = targs[0].shape[0]
        st = {}
        ref = tc.traverse_instances_plain(*itab, *targs, any_hit, stats=st)
        nbytes = (R * cs.LANE_BYTES_INSTANCES + g.num_instances * cs.INSTANCE_ROW_BYTES
                  + st["node_rows"] * cs.NODE_ROW_BYTES + st["leaf_rows"] * cs.LEAF_ROW_BYTES)
        ops = (st["prunes"] * cs.OPS_PRUNE + st["walks"] * cs.OPS_INSTANCE_RAY
               + st["node_steps"] * cs.OPS_NODE_STEP + st["leaf_steps"] * cs.OPS_LEAF_STEP)
        b_ms, b_by = timing.bound_ms(nbytes, ops)
        run = {}
        for n, lib in libs.items():
            if n == "this":
                run[n] = lambda: tc.traverse_instances(*itab, *targs, any_hit=any_hit)
            else:
                run[n] = lambda lib=lib: launch(lib, key, itab, targs)
        equal = {n: bits(fn(), ref) for n, fn in run.items()}
        calls = {n: max(1, min(50, int(ROUND_MS / max(timing.cuda_ms(fn, n=1, warm=1), 1e-3))))
                 for n, fn in run.items()}
        ms = {n: [] for n in libs}
        for n in order:
            ms[n].append(timing.queued_rounds(run[n], args.rounds, calls[n], warm=1))
        kname = tc.KERNEL_NAMES[key]
        reg = {n: next((v for f, v in r.items() if kname in f), None) for n, r in regs.items()}
        occ = {n: cs.blocks_per_sm(v, smem[n], threads[n]) if v else None
               for n, v in reg.items()}
        f = lambda x: dict(mean=float(x.double().mean()), max=int(x.max()))
        counts = dict(walks_lane=f(st["walks_lane"]), steps_lane=f(st["lane_steps"]),
                      box_tests_lane=f(st["box_tests_lane"]),
                      warp_serial_steps=f(st["warp_serial_steps"]),
                      warp_own_steps=f(st["warp_own_steps"]))
        rows_out.append(dict(
            kernel=key, lanes=R, instances=g.num_instances, bound_ms=b_ms, bound_by=b_by,
            bytes=nbytes, operations=ops, equal=equal, calls=calls, registers=reg,
            blocks_per_sm=occ, counts=counts,
            work={k: st[k] for k in ("prunes", "walks", "node_steps", "leaf_steps", "node_rows",
                                     "leaf_rows")},
            ms={n: [r["ms"] for r in v] for n, v in ms.items()},
            min_max={n: [(r["min"], r["max"]) for r in v] for n, v in ms.items()}))
        best = min(r["ms"] for r in ms["this"])
        print(f"[instance_lab] {key}, {R} lanes, {g.num_instances} instances: bit-equal to the "
              f"plain phase {equal}; "
              + "; ".join(f"{n} " + ", ".join(f"{r['ms']:.4f} ({r['min']:.4f}–{r['max']:.4f})"
                                              for r in ms[n]) + f" ms, {reg[n]} registers, "
                          f"{occ[n]} blocks per SM" for n in libs)
              + f"; bound {b_ms:.5f} ms ({b_by}), this / bound {best / b_ms:.1f}x; "
              f"{cs.instance_schedule_summary(st)} ({smi})", flush=True)
        if not all(equal.values()):
            raise SystemExit(f"instance_lab: a build of {key} disagrees with the plain phase")
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, rounds=args.rounds,
                  order=order, same_sass_as_parent=same_sass, kernels=rows_out)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
