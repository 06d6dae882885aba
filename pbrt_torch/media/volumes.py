"""Participating media: the volume regions and the emission and
single-scattering volume integrators (port of ``pbrt_tpu/media/volumes.py``;
reference: src/volumes/ — homogeneous, exponential, volumegrid and the
fork's water volume, water.h:20, api.cpp:542-543 — over core/volume.{h,cpp},
and src/integrators/{emission,single}.cpp).

All regions live in one ``VolumeTable``. A region's density is 1
(homogeneous, water), ``a·e^(−b·h)`` with h the height above its lower
corner along ``updir`` (exponential), or the trilinear interpolation of its
grid (volumegrid), inside its box and 0 outside. The JAX package evaluates
every kind's branch for every region and selects one (volumes.py:55-98);
the port evaluates only each region's own kind, which the host knows
(``VolumeTable.kinds``): the values are the same.

A segment [t0, t1] is marched in ``TAU_STEPS`` = 32 equal steps at
``t0 + (k + u)·dt`` with one jitter u per lane (emission.cpp:49-66). The
coefficients at the 32 points are evaluated at once, on R·32 lanes, and
so are single scattering's light samples and their any-hit shadow rays
(one traversal launch per segment); τ, the transmittance and Lv are then
accumulated as 32 elementwise steps in the JAX package's order.

Kept as the JAX package has it (the port is held to it): single
scattering's phase function uses the mean of ``g`` over all regions
(volumes.py:199), and its light ray gets no transmittance; a water
region reads ``absorptionCurveFile`` and, where that fails, keeps the
default σa without a word, and parses ``phaseFunctionFile`` without using
it (volumes.py:262-272); a volumegrid whose ``density`` does not hold
nx·ny·nz values has no grid and reads the pool's last value, as the JAX
package's clipped index −1 does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import sampling as smp
from pbrt_torch.scene.paramset import load_spd

HOMOGENEOUS, EXPONENTIAL, VOLUMEGRID, WATER = range(4)
KIND_CODES = {"homogeneous": HOMOGENEOUS, "exponential": EXPONENTIAL,
              "volumegrid": VOLUMEGRID, "water": WATER}

#: fixed march steps per segment (volumes.py:26)
TAU_STEPS = 32


@dataclasses.dataclass
class VolumeTable:
    kinds: tuple  # (V,) host kind codes, one per region
    w2v: torch.Tensor  # (V, 4, 4) world → volume space
    lo: torch.Tensor  # (V, 3) volume-space bounds
    hi: torch.Tensor  # (V, 3)
    sigma_a: torch.Tensor  # (V, S)
    sigma_s: torch.Tensor  # (V, S)
    le: torch.Tensor  # (V, S) emission
    g: torch.Tensor  # (V,) Henyey–Greenstein asymmetry
    exp_a: torch.Tensor  # (V,)
    exp_b: torch.Tensor  # (V,)
    updir: torch.Tensor  # (V, 3)
    grid_offset: torch.Tensor  # (V,) int64, -1: no grid
    grid_n: torch.Tensor  # (V, 3) int64 nx, ny, nz
    pool: torch.Tensor  # (P,) grid densities

    @property
    def count(self) -> int:
        return len(self.kinds)


def density(vt: VolumeTable, v: int, p):
    """Region ``v``'s density at world points p (N, 3) → (N,)."""
    w2v, lo, hi = vt.w2v[v], vt.lo[v], vt.hi[v]
    q = [p[:, 0] * w2v[i, 0] + p[:, 1] * w2v[i, 1] + p[:, 2] * w2v[i, 2] + w2v[i, 3]
         for i in range(3)]
    inside = torch.ones_like(q[0], dtype=torch.bool)
    for i in range(3):
        inside = inside & (q[i] >= lo[i]) & (q[i] <= hi[i])
    kind = vt.kinds[v]
    if kind == EXPONENTIAL:
        up = vt.updir[v]
        h = (q[0] - lo[0]) * up[0] + (q[1] - lo[1]) * up[1] + (q[2] - lo[2]) * up[2]
        dens = vt.exp_a[v] * torch.exp(-vt.exp_b[v] * h)
    elif kind == VOLUMEGRID:
        n = vt.grid_n[v]
        off = torch.clamp(vt.grid_offset[v], min=0)
        ext = torch.clamp(hi - lo, min=1e-9)
        c = [(q[i] - lo[i]) / ext[i] * n[i].to(torch.float32) - 0.5 for i in range(3)]
        ci = [torch.floor(x).to(torch.int64) for x in c]
        d = [x - xi.to(torch.float32) for x, xi in zip(c, ci)]
        idx = [[torch.minimum(torch.clamp(ci[i] + k, min=0), n[i] - 1) for k in (0, 1)]
               for i in range(3)]
        dens = torch.zeros_like(q[0])
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    w = ((d[0] if dx else 1 - d[0]) * (d[1] if dy else 1 - d[1])
                         * (d[2] if dz else 1 - d[2]))
                    flat = off + (idx[2][dz] * n[1] + idx[1][dy]) * n[0] + idx[0][dx]
                    dens = dens + w * vt.pool[flat]
    else:  # homogeneous, water
        dens = torch.ones_like(q[0])
    return torch.where(inside, dens, 0.0)


def coefficients(vt: VolumeTable, p, need=("sigma_t", "sigma_s", "emission")):
    """Σ over regions of σt·density, σs·density and Le·density at world
    points p (N, 3), each (N, S), the density evaluated once per region
    (volumes.py:101-129) → a dict with the names in ``need``."""
    S = vt.sigma_a.shape[-1]
    out = {k: torch.zeros((p.shape[0], S), dtype=torch.float32, device=p.device) for k in need}
    for v in range(vt.count):
        dens = density(vt, v, p)[:, None]
        per = {"sigma_t": lambda: vt.sigma_a[v] + vt.sigma_s[v],
               "sigma_s": lambda: vt.sigma_s[v], "emission": lambda: vt.le[v]}
        for k in need:
            out[k] = out[k] + dens * per[k]()
    return out


def sigma_t(vt: VolumeTable, p):
    """σt at world points p (N, 3) → (N, S) (volumes.py:101-108)."""
    return coefficients(vt, p, ("sigma_t",))["sigma_t"]


def march_points(o, d, t0, t1, u_jitter):
    """The 32 march points of each segment → (points (R·32, 3) in lane-major
    order, dt (R,))."""
    dt = torch.clamp(t1 - t0, min=0.0) / TAU_STEPS
    k = torch.arange(TAU_STEPS, dtype=torch.float32, device=o.device)
    t = t0[:, None] + (k[None, :] + u_jitter[:, None]) * dt[:, None]
    p = o[:, None, :] + t[:, :, None] * d[:, None, :]
    return p.reshape(-1, 3), dt


def _steps(x, R):
    return x.reshape(R, TAU_STEPS, -1)


def tau(vt: VolumeTable, o, d, t0, t1, u_jitter):
    """Optical thickness along [t0, t1] of rays (o, d) → (R, S)
    (volumes.py:132-145)."""
    R = o.shape[0]
    p, dt = march_points(o, d, t0, t1, u_jitter)
    st = _steps(sigma_t(vt, p), R)
    total = torch.zeros((R, st.shape[-1]), dtype=torch.float32, device=o.device)
    for k in range(TAU_STEPS):
        total = total + st[:, k] * dt[:, None]
    return total


def transmittance(vt: VolumeTable, o, d, t0, t1, u_jitter):
    """e^(−τ) (EmissionIntegrator::Transmittance; volumes.py:148-154)."""
    if vt.count == 0:
        return torch.ones((o.shape[0], vt.sigma_a.shape[-1]), device=o.device)
    return torch.exp(-tau(vt, o, d, t0, t1, u_jitter))


def integrate_emission(vt: VolumeTable, o, d, t0, t1, u_jitter):
    """The emission-only volume integrator (emission.cpp:68-115;
    volumes.py:157-175) → (Lv (R, S), Tr (R, S))."""
    R, S = o.shape[0], vt.sigma_a.shape[-1]
    Lv = torch.zeros((R, S), dtype=torch.float32, device=o.device)
    tr = torch.ones((R, S), dtype=torch.float32, device=o.device)
    if vt.count == 0:
        return Lv, tr
    p, dt = march_points(o, d, t0, t1, u_jitter)
    c = coefficients(vt, p, ("sigma_t", "emission"))
    ext = _steps(torch.exp(-c["sigma_t"] * dt.repeat_interleave(TAU_STEPS)[:, None]), R)
    em = _steps(c["emission"], R)
    for k in range(TAU_STEPS):
        tr = tr * ext[:, k]
        Lv = Lv + tr * em[:, k] * dt[:, None]
    return Lv, tr


def integrate_single_scattering(vt: VolumeTable, scene, o, d, t0, t1, u_jitter, u_steps):
    """Emission plus in-scattered direct light with the HG phase function,
    one light sample and one shadow ray per step (single.cpp:70-160;
    volumes.py:178-230). ``u_steps`` (R, 32, 3): each step's light-select
    and light-sample uniforms → (Lv (R, S), Tr (R, S))."""
    from pbrt_torch.integrators.path import _shadow_unoccluded
    from pbrt_torch.lights import table as lights_mod

    R, S = o.shape[0], vt.sigma_a.shape[-1]
    Lv = torch.zeros((R, S), dtype=torch.float32, device=o.device)
    tr = torch.ones((R, S), dtype=torch.float32, device=o.device)
    if vt.count == 0:
        return Lv, tr
    lt = scene.lights
    n_lights = max(lt.count, 1)
    p, dt = march_points(o, d, t0, t1, u_jitter)
    c = coefficients(vt, p)
    dt_p = dt.repeat_interleave(TAU_STEPS)
    ext = _steps(torch.exp(-c["sigma_t"] * dt_p[:, None]), R)
    em, ss = _steps(c["emission"], R), _steps(c["sigma_s"], R)
    if lt.count > 0:
        us = u_steps.reshape(-1, 3)
        li = torch.clamp((us[:, 0] * n_lights).to(torch.int64), max=n_lights - 1)
        ls = lights_mod.sample_li(lt, scene.geometry, li, p, us[:, 1], us[:, 2])
        wo = -d.repeat_interleave(TAU_STEPS, 0)
        vis = _shadow_unoccluded(scene.geometry, p, wo, ls.wi, ls.dist,
                                 torch.full_like(dt_p, 1e-4))
        phase = smp.hg_pdf(geom.dot(wo, ls.wi), vt.g.mean())
        weight = _steps(phase * vis / torch.clamp(ls.pdf, min=1e-12), R)[..., 0]
        L = _steps(ls.L, R)
    for k in range(TAU_STEPS):
        tr = tr * ext[:, k]
        Lv = Lv + tr * em[:, k] * dt[:, None]
        if lt.count > 0:
            contrib = ss[:, k] * L[:, k] * tr * weight[:, k, None] * dt[:, None] * n_lights
            Lv = Lv + torch.where((ss[:, k] > 0).any(-1)[:, None], contrib, 0.0)
    return Lv, tr


def build_volume_table(volume_records, config, device) -> VolumeTable:
    """The scene's ``Volume`` records → the table (volumes.py:233-309;
    the Create*VolumeRegion factories)."""
    S = config.n_bins
    rows, pool = [], [np.zeros(1, np.float32)]
    for rec in volume_records:
        p = rec.params
        kind = KIND_CODES.get(rec.volume_type, HOMOGENEOUS)
        row = dict(
            kind=kind, w2v=np.linalg.inv(rec.volume_to_world),
            lo=p.find_one_point("p0", (0, 0, 0)), hi=p.find_one_point("p1", (1, 1, 1)),
            sigma_a=p.find_one_spectrum("sigma_a", 1.0),
            sigma_s=p.find_one_spectrum("sigma_s", 1.0), le=p.find_one_spectrum("Le", 0.0),
            g=p.find_one_float("g", 0.0), exp_a=p.find_one_float("a", 1.0),
            exp_b=p.find_one_float("b", 1.0), updir=p.find_one_vector("updir", (0, 1, 0)),
            grid_offset=-1, grid_n=(0, 0, 0))
        if kind == WATER:
            absf = p.find_one_filename("absorptionCurveFile", "")
            p.find_one_filename("phaseFunctionFile", "")  # parsed, never used
            if absf:
                try:
                    row["sigma_a"] = load_spd(absf, config)
                except Exception:  # the JAX package keeps the default, silently
                    pass
        if kind == VOLUMEGRID:
            dens = p.find_floats("density")
            n = tuple(p.find_one_int(k, 1) for k in ("nx", "ny", "nz"))
            if dens is not None and len(dens) == n[0] * n[1] * n[2]:
                row["grid_offset"] = sum(len(x) for x in pool)
                row["grid_n"] = n
                pool.append(np.asarray(dens, np.float32))
        rows.append(row)
    f32 = lambda k, shape: torch.as_tensor(
        np.asarray([r[k] for r in rows], np.float32).reshape((len(rows),) + shape), device=device)
    i64 = lambda k, shape: torch.as_tensor(
        np.asarray([r[k] for r in rows], np.int64).reshape((len(rows),) + shape), device=device)
    return VolumeTable(
        kinds=tuple(r["kind"] for r in rows), w2v=f32("w2v", (4, 4)), lo=f32("lo", (3,)),
        hi=f32("hi", (3,)), sigma_a=f32("sigma_a", (S,)), sigma_s=f32("sigma_s", (S,)),
        le=f32("le", (S,)), g=f32("g", ()), exp_a=f32("exp_a", ()), exp_b=f32("exp_b", ()),
        updir=f32("updir", (3,)), grid_offset=i64("grid_offset", ()), grid_n=i64("grid_n", (3,)),
        pool=torch.as_tensor(np.concatenate(pool), device=device))
