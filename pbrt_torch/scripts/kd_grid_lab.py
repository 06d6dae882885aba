"""The kd-tree and grid kernels on ``chip_smoke.py`` phase 14's ray sets,
timed in turns beside the other builds of ``csrc/traverse_kd.cu`` and,
with ``--parent``, beside an earlier tree's kernels.

    python -m pbrt_torch.scripts.kd_grid_lab [--parent DIR] [--rounds 5]

Run from the repository's root (it imports ``chip_smoke`` for the scenes
and the ray sets); needs a card. ``DIR`` is an unpacked earlier tree
(``git archive <rev> | tar -x -C DIR``): its ``pbrt_torch/csrc/
traverse_kd.cu`` is built with this tree's nvcc flags and launched through
this tree's wrappers (``traverse_kd.launch_with``), so its entry points
must take the same arguments.

The sets are phase 14's timing sets, drawn by ``chip_smoke.kd_ray_sets``:
killeroo-simple under each accelerator, 32,768 lanes drawn from its
262,144 camera and bounce rays, and the motion scene's first 32,768
permuted lanes, their any-hit segments cut by ``chip_smoke.any_tmax``. For
each of the 8 kernels the script counts the plain version's work on its
set (``chip_smoke.kd_work``, the bound), holds every build to the plain
version bit for bit, then times the builds in the order parent, this, the
other width, and back again (the median and min–max of ``--rounds``
rounds of ``timing.queued_rounds`` each), and prints a line per kernel and
a JSON line of all of it, with the card's name and power limit. Each
build's kernels are described by ``traverse_kd.kernel_info`` (the
parent's are not: it has no such entry).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from pbrt_torch.accel import traverse_kd as tk
from pbrt_torch.utils import native, timing

#: the wall time one timing round of a kernel should take, in ms (its calls
#: per round follow from one call's time, 1 to 50)
ROUND_MS = 100.0


def parent_lib(tree: str):
    """``tree``'s ``traverse_kd.cu`` built with this tree's flags into
    ``pbrt_torch/_build``, its eight kernel entries bound."""
    src = os.path.join(os.path.abspath(tree), "pbrt_torch", "csrc", "traverse_kd.cu")
    so = os.path.join(native.BUILD_DIR, "libpbrt_torch_traverse_kd_parent-"
                      + native._digest(src, native.NVCC_FLAGS) + ".so")
    if not os.path.exists(so):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", so, src], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for key in tk.KERNEL_NAMES:
        fn = getattr(lib, "pbrt_torch_" + key)
        fn.restype = ctypes.c_int
        fn.argtypes = native.KERNEL_ENTRIES["traverse_kd.cu"]["pbrt_torch_" + key]
    return lib


def ray_sets(dev):
    """{kernel key: (geometry, (o, d, inv, tmin, tmax, any_hit, tw))}, each
    set phase 14's timing set of that kernel."""
    import chip_smoke as cs
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    text, _ = cs.real_scene_text()
    lib = native.kernel_lib("traverse_kd.cu")
    out = {}
    for acc, short in (("kdtree", "kd"), ("grid", "grid")):
        for m, scene in (("", text), ("_motion", cs.anim_scene_text())):
            b = build(load_scene_string(cs.accel_scene_text(scene, acc)), device=dev)
            g = b.scene.geometry
            rs = cs.kd_ray_sets(b, dev, motion=bool(m))
            sub = rs["timing"]
            o, d, inv, tmin, tmax = (rs[k][sub].contiguous()
                                     for k in ("o", "d", "inv", "tmin", "tmax"))
            tw = None if rs["tw"] is None else rs["tw"][sub].contiguous()
            scale = rs["scale"][sub] if torch.is_tensor(rs["scale"]) else rs["scale"]
            # the closest hit that cuts the any-hit segments: the kernel's,
            # equal to the plain version's bit for bit (phase 14 holds it so)
            tm_a = cs.any_tmax(tk.launch_with(lib, g, o, d, inv, tmin, tmax, False, tw)[0],
                               scale)
            for side, any_hit, tm in (("closest", False, tmax), ("any", True, tm_a)):
                out[f"traverse_{short}_{side}{m}"] = (g, (o, d, inv, tmin, tm, any_hit, tw))
            del b, rs
    return out


def main(argv=None) -> dict:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kd_grid_lab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = timing.nvidia_smi()
    print(f"[kd_grid_lab] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    libs = {"this": native.kernel_lib("traverse_kd.cu")}
    for v, defines in tk.VARIANTS.items():
        libs[v] = native.kernel_lib("traverse_kd.cu", defines=defines)
    if args.parent:
        libs["parent"] = parent_lib(args.parent)
    order = [n for n in ("parent", "this", *tk.VARIANTS) if n in libs]
    order += order[::-1]
    bits = lambda a, b: all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                            for x, y in zip(a, b))
    rows = []
    for key, (geo, (o, d, inv, tmin, tm, any_hit, tw)) in ray_sets(dev).items():
        acc = "kdtree" if key.startswith("traverse_kd") else "grid"
        plain = tk.traverse_kd_plain if acc == "kdtree" else tk.traverse_grid_plain
        stats = {}
        ref = plain(geo, o, d, inv, tmin, tm, any_hit, tw, stats=stats)
        nbytes, ops = cs.kd_work(acc, stats, o.shape[0], motion=tw is not None)
        b_ms, b_by = timing.bound_ms(nbytes, f32_ops=ops)
        run = {n: (lambda lib=lib: tk.launch_with(lib, geo, o, d, inv, tmin, tm, any_hit, tw))
               for n, lib in libs.items()}
        equal = {n: bits(fn(), ref) for n, fn in run.items()}
        calls = {n: max(1, min(50, int(ROUND_MS / max(timing.cuda_ms(fn, n=1, warm=1), 1e-3))))
                 for n, fn in run.items()}
        ms = {n: [] for n in libs}
        for n in order:
            ms[n].append(timing.queued_rounds(run[n], args.rounds, calls[n], warm=1))
        info = {n: tk.kernel_info(lib, key) for n, lib in libs.items() if n != "parent"}
        summ = cs.step_summary(stats["lane_steps"])
        rows.append(dict(kernel=key, lanes=o.shape[0], bound_ms=b_ms, bound_by=b_by,
                         equal=equal, calls=calls, info=info,
                         passes_per_lane=dict(mean=summ["mean"], max=summ["max"]),
                         ms={n: [r["ms"] for r in v] for n, v in ms.items()},
                         min_max={n: [(r["min"], r["max"]) for r in v] for n, v in ms.items()}))
        print(f"[kd_grid_lab] {key}, {o.shape[0]} lanes: bit-equal to plain {equal}; "
              + "; ".join(
                  f"{n} " + ", ".join(f"{r['ms']:.4f} ({r['min']:.4f}–{r['max']:.4f})"
                                      for r in ms[n])
                  + (f" ms, G {info[n]['width']}, {info[n]['registers']} registers, "
                     f"{info[n]['blocks_per_sm']} blocks of {info[n]['threads']} per SM"
                     if n in info else " ms")
                  for n in libs)
              + f"; bound {b_ms:.5f} ms ({b_by}), this / bound "
              f"{min(r['ms'] for r in ms['this']) / b_ms:.1f}x; {cs.work_text(acc, stats)}; "
              f"passes per lane mean {summ['mean']:.2f}, max {summ['max']} ({smi})", flush=True)
        if not all(equal.values()):
            raise SystemExit(f"kd_grid_lab: a build of {key} disagrees with the plain walk")
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, rounds=args.rounds,
                  order=order, kernels=rows)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
