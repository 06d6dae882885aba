"""Command line: ``python -m pbrt_torch.cli scene.pbrt`` renders a scene
on the CUDA card and writes its outputs (port of ``pbrt_tpu/cli.py``;
reference: src/main/pbrt.cpp:36-48).

Flags as the JAX package's: ``--outfile``, ``--quick`` (1 spp),
``--quiet``, ``--verbose``, ``--spp``, ``--seed``. ``--cpu`` runs the
plain PyTorch path on the CPU; without it the render needs a card and
fails when there is none. ``--distributed`` and ``--ndevices`` above 1
raise until the sharded renderer (``parallel/shard.py``) is ported.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pbrt_torch", description="spectral renderer on an NVIDIA GPU (PyTorch + CUDA)")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--outfile", default=None, help="override the output file name")
    ap.add_argument("--quick", action="store_true", help="render with 1 spp")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--spp", type=int, default=None, help="override pixelsamples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ndevices", type=int, default=None,
                    help="devices to shard the render over (only 1 is ported)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the kernels' plain versions")
    ap.add_argument("--distributed", nargs="?", const="", default=None,
                    metavar="COORDINATOR", help="multi-host rendering (not ported)")
    args = ap.parse_args(argv)
    if args.distributed is not None or (args.ndevices or 1) > 1:
        raise NotImplementedError(
            "--distributed and --ndevices > 1 need parallel/shard.py, which is not ported yet")

    from pbrt_torch import resolve_device
    from pbrt_torch.renderers.dispatch import render_scene
    from pbrt_torch.scene.api import load_scene
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import error as err

    err.set_options(quiet=args.quiet, verbose=args.verbose)
    device = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()
    built = build(load_scene(args.scene), device=device)
    if not args.quiet:
        g = built.scene.geometry
        print(f"[pbrt_torch] scene: {g.num_triangles} tris, {g.num_quadrics} quadrics, "
              f"{built.scene.lights.count} lights, {built.scene.materials.count} materials, "
              f"camera {type(built.camera).__name__}, renderer {built.renderer_name!r} on "
              f"{device} (build {time.time() - t0:.2f}s)")
    t1 = time.time()
    outputs = render_scene(built, spp=args.spp, seed=args.seed, quick=args.quick,
                           outfile=args.outfile)
    if not args.quiet:
        print(f"[pbrt_torch] rendered in {time.time() - t1:.2f}s")
        for path in outputs:
            print(f"[pbrt_torch] wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
