"""AggregateTest: the accelerator against brute force on random rays.

Port of ``pbrt_tpu/renderers/aggregatetest.py`` (reference: src/renderers/
aggregatetest.{h,cpp}:53-112): ``niters`` random rays (at most 2**18) from
a box 1.5 times the scene's bound (``world_lo`` / ``world_hi``), 30% of
them along an axis, go through the scene's accelerator (``intersect``)
and through ``intersect_brute``; a ray
disagrees where one finds a hit and the other does not, or both hit with
t more than 1e-4 apart relative to the brute-force t. The rays come from
the same ``numpy.random.default_rng(seed)`` draws as the JAX package's, so
both packages fire the same rays.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_torch.accel.intersect import intersect, intersect_brute
from pbrt_torch.core.geometry import Ray


def aggregate_test_rays(lo, hi, niters: int = 100000, seed: int = 0):
    """(o, d) float32 (n, 3) of the fuzzer's rays, n = min(niters, 2**18)
    (aggregatetest.py:22-37)."""
    rng = np.random.default_rng(seed)
    span = hi - lo
    n = min(niters, 1 << 18)
    o = (lo - 0.25 * span) + rng.uniform(0, 1, (n, 3)) * 1.5 * span
    d = rng.normal(size=(n, 3))
    # bias some rays toward axis-aligned directions (reference :74-80)
    axis_sel = rng.uniform(0, 1, n) < 0.3
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    d[axis_sel] = 0.0
    d[axis_sel, ax[axis_sel]] = sign[axis_sel]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    return o.astype(np.float32), d.astype(np.float32)


def run_aggregate_test(built, niters: int = 100000, seed: int = 0) -> int:
    """→ the number of rays on which the accelerator and brute force
    disagree."""
    g = built.scene.geometry
    dev = built.device
    lo, hi = g.world_lo.cpu().numpy(), g.world_hi.cpu().numpy()
    o_np, d_np = aggregate_test_rays(lo, hi, niters, seed)
    rays = Ray.make(torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev))
    h_accel = intersect(g, rays)
    h_brute = intersect_brute(g, rays)
    miss_mismatch = h_accel.valid != h_brute.valid
    both = h_accel.valid & h_brute.valid
    t_rel = (h_accel.t - h_brute.t).abs() / torch.clamp(h_brute.t.abs(), min=1e-9)
    return int((miss_mismatch | (both & (t_rel > 1e-4))).sum())
