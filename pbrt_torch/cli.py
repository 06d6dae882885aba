"""Command line: ``python -m pbrt_torch.cli scene.pbrt`` renders a scene
on the CUDA card and writes its outputs (port of ``pbrt_tpu/cli.py``;
reference: src/main/pbrt.cpp:36-48).

Flags as the JAX package's: ``--outfile``, ``--quick`` (1 spp),
``--quiet``, ``--verbose``, ``--spp``, ``--seed``. ``--cpu`` runs the
plain PyTorch path on the CPU; without it the render needs a card and
fails when there is none. ``--distributed [COORDINATOR]`` with
``--num-processes`` and ``--process-id`` joins a ``torch.distributed``
process group (``parallel/shard.py:init_distributed``: ``nccl`` on the
card, ``gloo`` with ``--cpu``) and, as the JAX CLI does, then renders the
whole image in every process: the scene's renderer never shards, and
``--ndevices`` is parsed and never read (pbrt_tpu/cli.py:26-27, :42-49).
``parallel/shard.py:render_sharded`` is the sharded renderer.
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
                    help="parsed and never read, as in the JAX CLI")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the kernels' plain versions")
    ap.add_argument("--distributed", nargs="?", const="", default=None,
                    metavar="COORDINATOR",
                    help="join a torch.distributed process group; optional coordinator "
                    "host:port (else torch's env:// variables); with --num-processes and "
                    "--process-id")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    from pbrt_torch import resolve_device
    from pbrt_torch.renderers.dispatch import render_scene
    from pbrt_torch.scene.api import load_scene
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import error as err

    err.set_options(quiet=args.quiet, verbose=args.verbose)
    on = "cpu" if args.cpu else None
    if args.distributed is not None:
        from pbrt_torch.parallel.shard import init_distributed

        rank, world = init_distributed(args.distributed or None, args.num_processes,
                                       args.process_id, on)
        if not args.quiet:
            print(f"[pbrt_torch] distributed: process {rank}/{world}")
    device = resolve_device(on)  # after init_distributed, which picks the rank's card
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
    if args.distributed is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
