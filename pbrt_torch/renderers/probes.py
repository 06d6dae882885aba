"""``Renderer "createprobes"`` and the probe file (port of
``pbrt_tpu/renderers/probes.py``; reference: src/renderers/createprobes.cpp,
src/integrators/useprobes.cpp).

``create_probes`` traces, from each centre of an (nx, ny, nz) grid over
the world bound, the same ``nindir`` uniform-sphere directions through the
scene's surface integrator, and projects each probe's radiance onto SH
(4π / nindir · Yᵀ L). The P · nindir lanes (probe-major) are keyed as the
JAX package keys its one wavefront, lane i by (seed + 5, i, sample 0), so
tracing them in chunks of ``CHUNK`` gives the same radiance; the
directions are ``uniform(root_key(seed), (nindir, 2))``
(``rng.flat_uniforms``).

The file is the JAX package's text, byte for byte: ``lmax 1 1`` (the two
flags are written and never read), the bound's six float32s as numpy
prints them, ``nx ny nz``, then per probe and term the S coefficients as
``%g``. ``read_probe_file`` reads it back.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.core import sampling as smp
from pbrt_torch.core import sh

#: lanes traced at once
CHUNK = 1 << 15
#: the lanes' key seed offset (probes.py:52)
KEY_SEED = 5


def grid_centers(lo: np.ndarray, hi: np.ndarray, nprobes) -> np.ndarray:
    """The (nx·ny·nz, 3) probe centres, x slowest (probes.py:36-40), in
    float64 as numpy computes them from the float32 bound."""
    axes = [lo[i] + (np.arange(n) + 0.5) / n * (hi[i] - lo[i]) for i, n in enumerate(nprobes)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def create_probes(built, lmax: int = 4, nprobes=(4, 4, 4), nindir: int = 64, seed: int = 0,
                  filename: str | None = None):
    """CreateRadProbes::Render (createprobes.cpp; probes.py:26-74) → (the
    (P, 3) centres, the (P, terms, S) float32 coefficients); writes the
    probe file where ``filename`` is given."""
    from pbrt_torch.integrators.path import trace_radiance
    from pbrt_torch.renderers.sampler import integrator_draws, key_uniforms, media_uniforms

    scene, icfg = built.scene, built.integrator
    g = scene.geometry
    dev = g.world_lo.device
    P = int(np.prod(nprobes))
    n_lanes = P * nindir
    if n_lanes >= 2**31:
        raise ValueError(f"createprobes: {'x'.join(map(str, nprobes))} probes x {nindir} "
                         f"directions = {n_lanes} lanes, over the 32-bit lane index (raise "
                         "samplespacing)")
    lo, hi = g.world_lo.cpu().numpy(), g.world_hi.cpu().numpy()
    centers = grid_centers(lo, hi, nprobes)
    u = rng.flat_uniforms(rng.root_key(seed), nindir, 2, dev)
    w = smp.uniform_sample_sphere(u[:, 0], u[:, 1])
    origins = torch.as_tensor(centers.astype(np.float32), device=dev)
    root = rng.root_key(seed + KEY_SEED)
    L = []
    for c0 in range(0, n_lanes, CHUNK):
        lane = torch.arange(c0, min(c0 + CHUNK, n_lanes), dtype=torch.int64, device=dev)
        rays = geom.Ray.make(origins[lane // nindir], w[lane % nindir])
        Lc, _ = trace_radiance(scene, rays, icfg, key_uniforms(icfg, root, lane, 0),
                               media=media_uniforms(scene, icfg, root, lane, 0),
                               draws=integrator_draws(scene, icfg, root, lane, 0))
        L.append(Lc)
    L = torch.cat(L).view(P, nindir, -1)
    basis = sh.sh_evaluate(w, lmax)
    coeffs = (torch.matmul(basis.T, L) * (4.0 * np.pi / nindir)).cpu().numpy()
    if filename:
        write_probe_file(filename, lmax, lo, hi, nprobes, coeffs)
    return centers, coeffs


def write_probe_file(path: str, lmax: int, lo, hi, nprobes, coeffs) -> str:
    """The probe file's text (probes.py:61-73)."""
    with open(path, "w") as f:
        f.write(f"{lmax} 1 1\n")
        f.write(" ".join(str(v) for v in lo) + " " + " ".join(str(v) for v in hi) + "\n")
        f.write("{} {} {}\n".format(*nprobes))
        for p in range(coeffs.shape[0]):
            for t in range(coeffs.shape[1]):
                f.write(" ".join(f"{v:g}" for v in coeffs[p, t]) + "\n")
    return path


def read_probe_file(path: str, n_bins: int):
    """→ (lmax, lo (3,), hi (3,), (nx, ny, nz), coeffs (P, terms, n_bins)
    float32) (probes.py:77-88); the header's two flags are not read."""
    with open(path) as f:
        lmax = int(f.readline().split()[0])
        bounds = [float(x) for x in f.readline().split()]
        nx, ny, nz = (int(x) for x in f.readline().split())
        terms = sh.sh_terms(lmax)
        coeffs = np.zeros((nx * ny * nz, terms, n_bins), np.float32)
        for p in range(coeffs.shape[0]):
            for t in range(terms):
                coeffs[p, t] = [float(x) for x in f.readline().split()]
    return lmax, np.asarray(bounds[:3]), np.asarray(bounds[3:]), (nx, ny, nz), coeffs
