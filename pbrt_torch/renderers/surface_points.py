"""``Renderer "surfacepoints"``: a Poisson-disk point set on the subsurface
surfaces, written as a points file (port of
``pbrt_tpu/renderers/surface_points.py``; reference:
src/renderers/surfacepoints.{h,cpp}).

All host numpy, as in the JAX package: 65,536 candidates by area on the
subsurface triangles (``dipole.sample_surface_points``, seed 0), thinned in
order to a minimum distance (``poisson_thin``, a greedy pass with a hash of
cells of that size, 27 cells looked at per candidate), each point given an
equal share of the total area and a ray epsilon of 1e-4 · the distance.
The file is the reference's text format, 8 numbers a row
(surfacepoints.cpp:138-150); ``read_points_file`` reads it back.
"""

from __future__ import annotations

import numpy as np

#: candidates drawn before thinning (surface_points.py:61)
CANDIDATES = 1 << 16


def poisson_thin(pts: np.ndarray, min_dist: float) -> np.ndarray:
    """Greedy Poisson-disk thinning: the points in order, each kept unless
    an earlier kept point lies closer than ``min_dist`` → the kept indices
    (surface_points.py:20-53)."""
    if len(pts) == 0 or min_dist <= 0:
        return np.arange(len(pts))
    inv = 1.0 / min_dist
    md2 = min_dist * min_dist
    cells: dict[tuple, list[int]] = {}
    kept: list[int] = []
    keys = np.floor(pts * inv).astype(np.int64)
    for i in range(len(pts)):
        cx, cy, cz = keys[i]
        ok = True
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    for j in cells.get((cx + ox, cy + oy, cz + oz), ()):
                        d = pts[i] - pts[j]
                        if float(d @ d) < md2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            cells.setdefault((cx, cy, cz), []).append(i)
            kept.append(i)
    return np.asarray(kept, np.int64)


def generate_surface_points(built, min_dist: float, seed: int = 0):
    """Poisson-distributed points on the subsurface triangles → (points,
    normals, areas, ray epsilons), or None without such a surface
    (surfacepoints.cpp:179's ``GetBSSRDF(...) != NULL``)."""
    from pbrt_torch.integrators.dipole import sample_surface_points

    sampled = sample_surface_points(built, n_points=CANDIDATES, seed=seed)
    if sampled is None:
        return None
    pts, normals, areas, _mat = sampled
    total_area = float(np.sum(areas))
    keep = poisson_thin(pts, min_dist)
    pts, normals = pts[keep], normals[keep]
    n = len(pts)
    area = np.full(n, total_area / max(n, 1), np.float32)
    eps = np.full(n, 1e-4 * min_dist, np.float32)
    return pts, normals, area, eps


def write_points_file(path: str, pts, normals, areas, eps):
    """The reference's text format (surfacepoints.cpp:140-149) → path."""
    with open(path, "w") as f:
        f.write("# points generated by SurfacePointsRenderer\n")
        f.write("# position (x,y,z), normal (x,y,z), area, rayEpsilon\n")
        for p, n, a, e in zip(pts, normals, areas, eps):
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g} {n[0]:g} {n[1]:g} {n[2]:g} {a:g} {e:g}\n")
    return path


def read_points_file(path: str):
    """A points file → (points (N, 3), normals (N, 3), areas (N,), ray
    epsilons (N,)), float32."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                vals.extend(float(v) for v in line.split())
    arr = np.asarray(vals, np.float32).reshape(-1, 8)
    return arr[:, 0:3], arr[:, 3:6], arr[:, 6], arr[:, 7]


def render_surface_points(built, quick: bool = False, verbose: bool = True) -> list:
    """The renderer (api.cpp:1352-1356; parameters surfacepoints.cpp:265-269):
    ``minsampledistance`` (default 0.25, × 4 with ``quick``) and
    ``filename`` → the files written."""
    p = built.renderer_params
    min_dist = p.find_one_float("minsampledistance", 0.25)
    if quick:
        min_dist *= 4.0
    filename = p.find_one_string("filename", "")
    out = generate_surface_points(built, min_dist)
    if out is None:
        if verbose:
            print("[pbrt_torch] surfacepoints: no BSSRDF surfaces in scene")
        pts = np.zeros((0, 3), np.float32)
        out = (pts, pts.copy(), np.zeros(0, np.float32), np.zeros(0, np.float32))
    pts = out[0]
    if verbose:
        print(f"[pbrt_torch] surfacepoints: {len(pts)} points (minDist {min_dist:g})")
    if filename:
        write_points_file(filename, *out)
        return [filename]
    return []
