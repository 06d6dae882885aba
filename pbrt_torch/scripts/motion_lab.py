"""The BVH motion walks on ``chip_smoke.py`` phase 11(c)'s permuted set,
timed and, with ``--parent``, timed in turns beside an earlier tree's
motion kernels.

    python -m pbrt_torch.scripts.motion_lab [--parent DIR] [--rounds 5]

Run from the repository's root (it imports ``chip_smoke`` for the scene
and the ray set); needs a card. ``DIR`` is an unpacked earlier tree
(``git archive <rev> | tar -x -C DIR``) whose motion kernels walk the
union boxes alone: its ``pbrt_torch/csrc/traverse.cu`` is built with this
tree's nvcc flags and launched with its own argument list (no time-box
table).

The set is phase 11(c)'s timing set (``chip_smoke.motion_lane_sets``'s
``sub``):
``goldens/anim-killeroos-moving.pbrt`` as written, 1,048,576 camera and
bounce rays at their own shutter times, 32,768 of them drawn at random,
the any-hit segments cut at 0.5 or 1.5 times the closest hit. For each of
the two kernels the script walks the union plain walk (the JAX package's,
the reference) and the culled plain walk (the kernel's own plain version,
whose work gives the bound), holds every build to the union walk bit for
bit, then times the builds in the order parent, this, this, parent (the
median and min–max of
``--rounds`` rounds of ``timing.queued_rounds`` each), and prints a line
per kernel and a JSON line of all of it, with the card's name and power
limit.
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
MOTION_KEYS = ("traverse_closest_motion", "traverse_any_motion")


def parent_lib(tree: str):
    """``tree``'s ``traverse.cu`` built with this tree's flags into
    ``pbrt_torch/_build``, its two motion entries bound with their own
    argument list: rows, deltas, tw, then the rays and outputs as now."""
    src = os.path.join(os.path.abspath(tree), "pbrt_torch", "csrc", "traverse.cu")
    so = os.path.join(native.BUILD_DIR, "libpbrt_torch_traverse_parent-"
                      + native._digest(src, native.NVCC_FLAGS) + ".so")
    if not os.path.exists(so):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", so, src], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for key in MOTION_KEYS:
        fn = getattr(lib, "pbrt_torch_" + key)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp] * 16 + [ci, ci, vp]
    lib.pbrt_torch_max_stack.restype = ctypes.c_int
    return lib


def launch_parent(lib, key, rows, ws, o, d, inv, tmin, tmax, t0, p0, b10, b20, mrows, tw):
    """The parent's motion kernel ``key`` → (t, prim, b1, b2); counts no
    launch."""
    R, dev = o.shape[0], o.device
    out = (torch.empty(R, device=dev), torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, device=dev), torch.empty(R, device=dev))
    ptrs = [x.data_ptr() for x in (rows, mrows, tw, o, d, inv, tmin, tmax, t0, p0, b10, b20,
                                   *out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.check_launch(getattr(lib, "pbrt_torch_" + key)(*ptrs, R, int(ws), stream),
                        f"parent {key} launch")
    return out


def main(argv=None) -> dict:
    import chip_smoke as cs
    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("motion_lab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = timing.nvidia_smi()
    print(f"[motion_lab] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    libs = {"this": None}  # this tree's kernels, through traverse_cuda.traverse
    if args.parent:
        libs["parent"] = parent_lib(args.parent)
    order = [n for n in ("parent", "this") if n in libs]
    order += order[::-1]
    bits = lambda a, b: all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                            for x, y in zip(a, b))

    built = build(load_scene_string(cs.anim_scene_text()), device=dev)
    g = built.scene.geometry
    sets = cs.motion_lane_sets(built, dev)
    pick = lambda x: x[sets["sub"]].contiguous()
    o, d = pick(sets["o"]), pick(sets["d"])
    tw = isect.motion_weight(g, pick(sets["t_ray"])).contiguous()
    inv = isect.make_inv_dir(d).contiguous()
    R = o.shape[0]
    tmin = torch.zeros(R, device=dev)
    rows, ws, mrows, tbox = g.wide_rows, g.wide_stack, g.wide_motion, g.wide_tbox
    rows_out = []
    tmx = torch.full((R,), float("inf"), device=dev)
    for key in MOTION_KEYS:
        any_hit = key == "traverse_any_motion"
        if any_hit:  # phase 11(c)'s segments: 0.5 or 1.5 times the closest hit
            tmx = torch.where(torch.isfinite(ref[0]), ref[0] * pick(sets["scale"]),
                              1e30).contiguous()
        seeds = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmx)]
        targs = (rows, ws, o, d, inv, tmin, tmx, *seeds)
        su, sc = {}, {}
        ref = tc.traverse_plain(*targs, any_hit, stats=su, motion_rows=mrows, tw=tw)
        culled = tc.traverse_plain(*targs, any_hit, stats=sc, motion_rows=mrows, tw=tw,
                                   time_boxes=tbox)
        nbytes, ops = cs.motion_work(sc, o.shape[0])
        b_ms, b_by = timing.bound_ms(nbytes, f32_ops=ops)
        run = {}
        for n, lib in libs.items():
            if n == "parent":
                run[n] = lambda lib=lib: launch_parent(lib, key, *targs, mrows, tw)
            else:
                run[n] = lambda: tc.traverse(*targs, any_hit, motion_rows=mrows, tw=tw,
                                             time_boxes=tbox)
        equal = {n: bits(fn(), ref) for n, fn in run.items()}
        equal["culled plain"] = bits(culled, ref)
        calls = {n: max(1, min(50, int(ROUND_MS / max(timing.cuda_ms(fn, n=1, warm=1), 1e-3))))
                 for n, fn in run.items()}
        ms = {n: [] for n in libs}
        for n in order:
            ms[n].append(timing.queued_rounds(run[n], args.rounds, calls[n], warm=1))
        steps = {w: cs.step_summary(s["lane_steps"]) for w, s in (("union", su), ("culled", sc))}
        rows_out.append(dict(
            kernel=key, lanes=o.shape[0], bound_ms=b_ms, bound_by=b_by, equal=equal,
            calls=calls, work={w: {k: s[k] for k in ("node_steps", "leaf_steps", "node_rows",
                                                     "leaf_rows")}
                               for w, s in (("union", su), ("culled", sc))},
            steps_per_lane={w: dict(mean=v["mean"], max=v["max"]) for w, v in steps.items()},
            ms={n: [r["ms"] for r in v] for n, v in ms.items()},
            min_max={n: [(r["min"], r["max"]) for r in v] for n, v in ms.items()}))
        print(f"[motion_lab] {key}, {o.shape[0]} lanes: bit-equal to the union walk {equal}; "
              + "; ".join(f"{n} " + ", ".join(f"{r['ms']:.4f} ({r['min']:.4f}–{r['max']:.4f})"
                                              for r in ms[n]) + " ms" for n in libs)
              + f"; bound {b_ms:.5f} ms ({b_by}), this / bound "
              f"{min(r['ms'] for r in ms['this']) / b_ms:.1f}x; steps per lane union "
              f"{steps['union']['mean']:.3f} (max {steps['union']['max']}), culled "
              f"{steps['culled']['mean']:.3f} (max {steps['culled']['max']}) ({smi})",
              flush=True)
        if not all(equal.values()):
            raise SystemExit(f"motion_lab: a build of {key} disagrees with the union walk")
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, rounds=args.rounds,
                  order=order, kernels=rows_out)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
