"""Where the card and the CPU part on the 16² lens-camera references.

    python -m pbrt_torch.scripts.reference_lanes   # from a checkout, on the GPU machine

For each lane that ``chip_smoke.py`` phase 12 logs as apart (camera, render
seed, pixel y, x of the 16² killeroo-scale scene), the lane's wave is
traced on the card and on the CPU from the same keyed arrays, every
``intersect`` call of the integrator recorded, and the first call whose
ray or hit differs is printed: the ulps between the two devices' ray
origin, direction and tmax, and each device's hit primitive and t.
"""

from __future__ import annotations

import os
import sys
import tempfile
from unittest import mock

import torch

#: (camera, seed, y, x) of lanes phase 12 logs apart on an H100
LANES = (("realisticDiffraction", 0, 14, 8), ("realisticDiffraction", 7, 2, 11),
         ("orthographic", 6, 13, 1), ("pinhole", 1, 4, 15), ("idealDiffraction", 7, 3, 8),
         ("environment", 7, 4, 4))


def _ulps(a, b) -> int:
    return int((a.reshape(-1).view(torch.int32) - b.reshape(-1).view(torch.int32)).abs().max())


def trace_lane(text: str, device, seed: int, lane: int):
    """The lane's radiance and its intersect calls (any hit, origin,
    direction, tmax, t, prim) in the wave of sample 0, seed ``seed``."""
    from pbrt_torch.integrators import path as path_mod
    from pbrt_torch.renderers import sampler as sm
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    b = build(load_scene_string(text), device=device)
    xs, ys, pix, _, root, scr = sm.pixel_chunks(b, seed, 256)
    u = sm.wave_uniforms(b.integrator, root, pix[0], scr[0], 0)
    rays = b.camera.generate_rays(xs[0].float() + u[:, 0], ys[0].float() + u[:, 1], u[:, 2],
                                  u[:, 3], u[:, 4], noise=sm.camera_noise(b.camera, root, pix[0], 0))
    calls, real = [], path_mod.intersect

    def record(g, r, any_hit=False):
        h = real(g, r, any_hit=any_hit)
        calls.append((any_hit, *(x[lane].cpu() for x in (r.origin, r.direction, r.tmax, h.t,
                                                          h.prim))))
        return h

    with mock.patch.object(path_mod, "intersect", record):
        L, _ = path_mod.trace_radiance(b.scene, rays, b.integrator, u)
    return float(L[lane].sum()), calls


def main() -> int:
    if not torch.cuda.is_available():
        print("reference_lanes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    data_dir = tempfile.mkdtemp(prefix="reference_lanes_")
    cs.write_lens_data(data_dir)
    small, _ = cs.real_scene_text(cs.SMALL_BLOB_FREQ, res=16)
    for cam, seed, y, x in LANES:
        text = cs.lens_scene_text(small, cam, data_dir)
        (lg, cg), (lc, cc) = (trace_lane(text, d, seed, y * 16 + x) for d in ("cuda", "cpu"))
        print(f"{cam} seed {seed} pixel (y {y}, x {x}): radiance card {lg:.4g}, CPU {lc:.4g}",
              flush=True)
        for k, (a, c) in enumerate(zip(cg, cc)):
            ray_ulps = tuple(_ulps(a[i], c[i]) for i in (1, 2, 3))
            parted = int(a[5]) != int(c[5]) or _ulps(a[4], c[4]) > 64
            if any(ray_ulps) or parted:
                print(f"   call {k} ({'any' if a[0] else 'closest'} hit): origin / direction / "
                      f"tmax ulps {ray_ulps}, prim card {int(a[5])} CPU {int(c[5])}, t "
                      f"{float(a[4]):.7g} / {float(c[4]):.7g}, tmax {float(a[3]):.7g} / "
                      f"{float(c[3]):.7g}", flush=True)
            if parted:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
