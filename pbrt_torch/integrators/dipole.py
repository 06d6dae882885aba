"""Dipole subsurface scattering (port of ``pbrt_tpu/integrators/dipole.py``;
reference: src/integrators/dipolesubsurface.{h,cpp}).

The preprocess places ``MAX_POINTS`` points by area on the triangles whose
material is ``subsurface`` or ``kdsubsurface`` (host numpy, from
``np.random.default_rng(seed)``, as the JAX package draws them), and
computes the direct irradiance at each from 4 one-light samples with any-hit
shadow rays (``compute_irradiance``; dipolesubsurface.cpp:210-247). The
integrator then adds (1/π)·Ft·Fdt·Mo(p) at every subsurface hit, Mo the
dense sum over every point of the Jensen dipole's diffuse reflectance
Rd(d²) times the point's irradiance and area (``mo_gather``; the
reference's octree, dipolesubsurface.cpp:41-131, without its ``maxerror``
cut).

``mo_gather`` launches ``csrc/dipole.cu``'s kernels for lanes on the card
(the active lanes' list, then the gather over them) and runs their plain
version, ``mo_gather_plain``, for lanes on the CPU. Both take a lane's
terms in groups of ``GROUP`` points, sum a group by the pairwise tree
((t0 + t1) + (t2 + t3)) + ((t4 + t5) + (t6 + t7)) and add the group's sum
to the lane's running total in point order, each squared distance
expanded as |p|² − 2 p·q + |q|², clamped at 0, with every 3-term sum in
the order (x + y) + z: the kernel's float operations are the plain
version's, so on the card the two agree bit for bit, and a lane's value
depends on nothing but its own inputs (not on the other lanes, nor on
which are active). The per-lane parameters of Rd (σ′t, σtr, the two
dipole depths and α′/4π) are computed once per call, as torch ops, and
given to both. The points are padded to whole tiles of ``TILE`` (the JAX
package's ``CHUNK``; the kernel stages a tile at a time) with zero
weight. Lanes that are not ``active`` (the integrator's subsurface hits)
get 0.

Kept as the JAX package has it: the integrator never reads a points file
(``prepare_subsurface`` is called without one, pbrt_tpu/scene/builder.py:
815-823), so ``minsampledistance`` and ``maxerror`` change nothing; a points
file read back gets material row 0 (dipole.py:164); the irradiance at a
point takes |cos θ| and a uniform light pick (dipole.py:127-141).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import rng
from pbrt_torch.lights import table as lights_mod
from pbrt_torch.materials.table import KDSUBSURFACE, SUBSURFACE
from pbrt_torch.utils import native

MAX_POINTS = 4096
#: points per tile of the point table (the JAX package's CHUNK)
TILE = 64
#: points per pairwise tree of the Mo sum
GROUP = 8
#: the most bins the kernel takes (one thread per bin, a warp a lane's bins)
MAX_BINS = 32
#: irradiance samples per point (dipole.py:116)
IRRADIANCE_SAMPLES = 4

#: kernel launches per wrapper (the plain version counts nothing): each
#: ``mo_gather_kernel`` call launches two, the lane list and the gather
launches = {"mo_gather": 0}
#: the fields of ``kernel_info``, in ``pbrt_torch_mo_gather_info``'s order
#: (a warp a lane, so ``warps`` is also the lanes a block)
INFO_FIELDS = ("warps", "threads", "tile", "group", "registers", "local_bytes",
               "shared_bytes", "blocks_per_sm")


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class SubsurfaceData:
    """The irradiance point cloud (the octree's payload, flat)."""

    points: torch.Tensor  # (N, 3)
    normals: torch.Tensor  # (N, 3)
    areas: torch.Tensor  # (N,)
    E: torch.Tensor  # (N, S) irradiance
    material: torch.Tensor  # (N,) i64 material row of each point


def fdr(eta):
    """The diffuse Fresnel reflectance's fit (dipolesubsurface.cpp:59-88)."""
    return -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta


def rd_params(sigma_a, sigma_prime_s, eta):
    """(σ′t, σtr, z+, z−, z+², z−², α′/4π), each broadcast to sigma_a's
    shape: what Rd(d²) needs besides d² (dipole.py:52-62)."""
    sigmap_t = torch.clamp(sigma_a + sigma_prime_s, min=1e-6)
    alphap = sigma_prime_s / sigmap_t
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigmap_t)
    f = fdr(eta)
    A = (1.0 + f) / (1.0 - f)
    zpos = 1.0 / sigmap_t
    zneg = -zpos * (1.0 + (4.0 / 3.0) * A)
    return (sigmap_t, sigma_tr, zpos, zneg, zpos * zpos, zneg * zneg,
            alphap / (4.0 * math.pi))


def _rd(d2, prm):
    """Rd from d² and ``rd_params`` (broadcasting), in the kernel's order."""
    sigmap_t, sigma_tr, zpos, zneg, zpos2, zneg2, coef = prm
    dpos = torch.sqrt(d2 + zpos2)
    dneg = torch.sqrt(d2 + zneg2)
    pos = (zpos * (dpos * sigma_tr + 1.0) * torch.exp(-sigma_tr * dpos)
           / torch.clamp(sigmap_t * (dpos * dpos * dpos), min=1e-12))
    neg = (zneg * (dneg * sigma_tr + 1.0) * torch.exp(-sigma_tr * dneg)
           / torch.clamp(sigmap_t * (dneg * dneg * dneg), min=1e-12))
    return torch.clamp(coef * (pos - neg), min=0.0)


def diffusion_rd(d2, sigma_a, sigma_prime_s, eta):
    """Jensen's dipole diffuse reflectance Rd(d²) (DiffusionReflectance,
    dipolesubsurface.cpp:59-88): d2 (...,), the spectral parameters (...,
    S) → (..., S)."""
    return _rd(d2[..., None], rd_params(sigma_a, sigma_prime_s, eta))


def sample_surface_points(built, n_points: int = MAX_POINTS, seed: int = 0):
    """``n_points`` points by area over the subsurface triangles (host
    numpy, dipole.py:76-111) → (points, normals, areas, material rows), or
    None where no triangle has a subsurface material."""
    g, mt = built.scene.geometry, built.scene.materials
    kinds = mt.kind.cpu().numpy()
    tri_mat = g.tri_material.cpu().numpy()
    is_ss = np.isin(kinds[tri_mat], [SUBSURFACE, KDSUBSURFACE])
    if not is_ss.any():
        return None
    idx = np.nonzero(is_ss)[0]
    v0, e1, e2 = (getattr(g, k).cpu().numpy()[idx] for k in ("tri_v0", "tri_e1", "tri_e2"))
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total_area = float(areas.sum())
    gen = np.random.default_rng(seed)
    pick = gen.choice(len(idx), n_points, p=areas / max(areas.sum(), 1e-20))
    u1 = gen.uniform(0, 1, n_points)
    u2 = gen.uniform(0, 1, n_points)
    su = np.sqrt(u1)
    b0, b1 = 1.0 - su, u2 * su
    pts = v0[pick] + b0[:, None] * e1[pick] + b1[:, None] * e2[pick]
    n = np.cross(e1[pick], e2[pick])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return (pts.astype(np.float32), n.astype(np.float32),
            np.full(n_points, total_area / n_points, np.float32),
            tri_mat[idx][pick].astype(np.int64))


def compute_irradiance(scene, points, normals, seed: int = 0,
                       n_samples: int = IRRADIANCE_SAMPLES):
    """Direct irradiance at the points (dipolesubsurface.cpp:210-247;
    dipole.py:114-141): per sample a uniform light pick and ``sample_li``,
    |cos θ| at the point, an any-hit shadow ray from the point offset to
    the light's side by 1e-3. The uniforms are point i's key (root seed +
    31, index i, sample 0) folded with s·16 + LIGHT_SAMPLE, 3 each (one
    ``keyed_chain_uniforms`` launch on the card) → (N, S)."""
    from pbrt_torch.integrators.path import _shadow_unoccluded

    g, lt = scene.geometry, scene.lights
    dev = g.tri_v0.device
    p = torch.as_tensor(np.array(points, np.float32), device=dev)
    n = torch.as_tensor(np.array(normals, np.float32), device=dev)
    N, S = p.shape[0], scene.materials.kd.shape[-1]
    E = torch.zeros((N, S), dtype=torch.float32, device=dev)
    if lt.count == 0 or N == 0:
        return E
    u_all = rng.chain_uniforms(rng.root_key(seed + 31), torch.arange(N, device=dev), 0,
                               chain=[(rng.LIGHT_SAMPLE, n_samples)], n=3)
    n_lights = lt.count
    eps = torch.full((N,), 1e-3, dtype=torch.float32, device=dev)
    for s in range(n_samples):
        u = u_all[:, 3 * s:3 * s + 3]
        li = torch.clamp((u[:, 0] * n_lights).to(torch.int64), max=n_lights - 1)
        ls = lights_mod.sample_li(lt, g, li, p, u[:, 1], u[:, 2])
        cos_i = geom.dot(ls.wi, n).abs()
        vis = _shadow_unoccluded(g, p, geom.face_forward(n, ls.wi), ls.wi, ls.dist, eps)
        contrib = ls.L * (cos_i * vis / torch.clamp(ls.pdf, min=1e-12))[:, None]
        E = E + torch.where((ls.pdf > 0)[:, None], contrib, 0.0) * n_lights
    return E / n_samples


def prepare_subsurface(built, seed: int = 0, pointsfile: str | None = None):
    """The preprocess (dipolesubsurface.cpp:189; dipole.py:144-184) →
    ``SubsurfaceData`` or None. ``pointsfile``: points written by
    ``Renderer "surfacepoints"`` instead of sampling, each given material
    row 0 (the builder passes none, as the JAX package's does)."""
    dev = built.scene.geometry.tri_v0.device
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    if pointsfile and os.path.exists(pointsfile):
        from pbrt_torch.renderers.surface_points import read_points_file

        pts, normals, areas, _eps = read_points_file(pointsfile)
        if len(pts) == 0:
            return None
        mat = np.zeros(len(pts), np.int64)
    else:
        sampled = sample_surface_points(built, seed=seed)
        if sampled is None:
            return None
        pts, normals, areas, mat = sampled
    E = compute_irradiance(built.scene, pts, normals, seed=seed)
    return SubsurfaceData(points=t(pts), normals=t(normals), areas=t(areas), E=E,
                          material=t(mat, torch.int64))


def _lane_params(mt, mat_idx):
    """``rd_params`` of each lane's material row, (R, S) each."""
    mi = mat_idx.clamp(min=0)
    return rd_params(mt.ss_sigma_a[mi], mt.ss_sigma_s[mi], mt.eta[mi][:, None])


def _point_table(ss: SubsurfaceData):
    """The points and E·A padded to whole tiles (zero weight) → (q (Np, 3),
    |q|² (Np,), E·A (Np, S))."""
    N = ss.points.shape[0]
    pad = (-N) % TILE
    q = torch.nn.functional.pad(ss.points, (0, 0, 0, pad))
    ea = torch.nn.functional.pad(ss.E * ss.areas[:, None], (0, 0, 0, pad))
    q2 = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
    return q.contiguous(), q2.contiguous(), ea.contiguous()


def mo_gather_plain(ss: SubsurfaceData, mt, p, mat_idx, active=None, params=None,
                    table=None):
    """Mo(p) = Σᵢ Rd(|p − pᵢ|²)·Eᵢ·Aᵢ per lane (R, S), in the kernel's order
    (see the module docstring); 0 where ``active`` (R,) is False.
    ``params`` / ``table``: ``_lane_params`` / ``_point_table`` already
    computed."""
    prm = params if params is not None else _lane_params(mt, mat_idx)
    q, q2, ea = table if table is not None else _point_table(ss)
    R, S = p.shape[0], ea.shape[1]
    p2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]
    prm3 = [x[:, None, :] for x in prm]
    acc = torch.zeros((R, S), dtype=torch.float32, device=p.device)
    for t0 in range(0, q.shape[0], TILE):
        qt = q[t0:t0 + TILE]
        pq = p[:, 0:1] * qt[:, 0] + p[:, 1:2] * qt[:, 1] + p[:, 2:3] * qt[:, 2]
        d2 = torch.clamp(p2[:, None] - 2.0 * pq + q2[t0:t0 + TILE], min=0.0)
        x = (_rd(d2[:, :, None], prm3) * ea[t0:t0 + TILE]).view(R, -1, GROUP, S)
        while x.shape[2] > 1:
            x = x[:, :, 0::2] + x[:, :, 1::2]
        for g in range(x.shape[1]):
            acc = acc + x[:, g, 0]
    if active is not None:
        acc = torch.where(active[:, None], acc, 0.0)
    return acc


def mo_gather(ss: SubsurfaceData, mt, p, mat_idx, active=None):
    """Mo per lane; the kernel for lanes on the card, the plain version for
    lanes on the CPU (see ``mo_gather_plain``)."""
    if p.device.type == "cpu":
        return mo_gather_plain(ss, mt, p, mat_idx, active)
    if p.device.type != "cuda":
        raise ValueError(f"mo_gather: unsupported device {p.device}")
    R = p.shape[0]
    if active is None:
        active = torch.ones(R, dtype=torch.bool, device=p.device)
    prm = torch.stack([x.expand(R, -1) for x in _lane_params(mt, mat_idx)])
    return mo_gather_kernel(prm, p.contiguous(), active.to(torch.uint8), _point_table(ss))


def launch_with(lib, prm, p, active, table, checked=None):
    """``csrc/dipole.cu``'s two kernels launched from ``lib`` (a build of
    it: ``native.kernel_lib("dipole.cu", ...)``; None: the main one) on
    ``mo_gather_kernel``'s inputs → (R, S). Given ``checked``, a (1,) int64
    tensor on the card, the gather's counting instance adds to it the
    (active lane, 64-point tile) pairs whose terms took the checked sqrtf
    and divide (the rest took their unchecked fast paths); the main path
    runs the other. It counts no launch."""
    q, q2, ea = table
    R, S = p.shape[0], ea.shape[1]
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"mo_gather: unsupported device {dev}")
    if S > MAX_BINS:
        raise ValueError(f"mo_gather: {S} bins, the kernel takes at most {MAX_BINS}")
    if 7 * R * S >= 2**31 or q.shape[0] * S >= 2**31:
        raise ValueError(f"mo_gather: {R} lanes × {q.shape[0]} points over 32-bit indices")
    for name, x, dt, shape in (("prm", prm, torch.float32, (7, R, S)),
                               ("p", p, torch.float32, (R, 3)),
                               ("active", active, torch.uint8, (R,)),
                               ("q", q, torch.float32, (q.shape[0], 3)),
                               ("q2", q2, torch.float32, (q.shape[0],)),
                               ("ea", ea, torch.float32, (q.shape[0], S))):
        native.check_tensor(name, x, dt, shape, dev)
    out = torch.empty((R, S), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    if checked is not None:
        native.check_tensor("checked", checked, torch.int64, (1,), dev)
    lanes = torch.empty(R + 1, dtype=torch.int32, device=dev)
    lib = lib or native.kernel_lib("dipole.cu")
    native.check_launch(lib.pbrt_torch_mo_gather(
        prm.data_ptr(), p.data_ptr(), active.data_ptr(), q.data_ptr(), q2.data_ptr(),
        ea.data_ptr(), q.shape[0], R, S, lanes.data_ptr(), out.data_ptr(),
        None if checked is None else checked.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "mo_gather launch")
    return out


def mo_gather_kernel(prm, p, active, table):
    """``csrc/dipole.cu``'s kernels: ``prm`` (7, R, S) the stacked
    ``_lane_params``, p (R, 3), ``active`` (R,) uint8 and ``table``
    (``_point_table``) → (R, S). Two launches, counted: ``mo_gather_lanes_kernel``
    lists the active lanes on the card, ``mo_gather_kernel`` sums over them."""
    out = launch_with(None, prm, p, active, table)
    if p.shape[0]:
        launches["mo_gather"] += 2
    return out


def kernel_info(lib) -> dict:
    """The gather as ``lib`` built it (``INFO_FIELDS``): warps (one lane
    each) and threads a block, points a tile and a group, registers per thread,
    local and static shared bytes, resident blocks per SM (the CUDA
    occupancy calculator)."""
    import ctypes

    out = (ctypes.c_int * len(INFO_FIELDS))()
    native.check_launch(lib.pbrt_torch_mo_gather_info(out), "mo_gather info")
    return dict(zip(INFO_FIELDS, out))
