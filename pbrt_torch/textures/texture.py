"""Textures as rows of one table, evaluated lane-parallel.

Port of ``pbrt_tpu/textures/texture.py`` (reference: src/textures/ —
constant, scale, mix, bilerp, imagemap, uv, checkerboard, dots, fbm,
wrinkled, marble, windy — over the uv, spherical and planar mappings of
src/core/texture.cpp, with Perlin ``Noise`` / ``FBm`` / ``Turbulence``).

Every texture of a scene is a row of a ``TextureTable``. Image texels of
every mip level of every image live in one flat RGB pool; a row holds its
level offsets. The host side (Lanczos resample to powers of two, the 2×2
box pyramid, the table) is the JAX package's numpy code, so both packages
build the same pool bit for bit. The Perlin permutation is numpy's
``default_rng(1234).permutation(256)``, doubled, as there.

Evaluation follows the JAX package's ``_eval_base`` / ``eval_spectrum``:
one substitution pass for each of ``tex1`` and ``tex2`` references, then
the row itself, each lane taking its kind's value. It evaluates only the
kinds and mappings of the rows the caller's ids can hold (``rows``, known
on the host), and runs a reference pass only when such a row has that
reference: the lanes' values are the JAX package's, whose ``where`` chain
computes all 13 kinds three times. Filtered image lookups batch the EWA
probes' 8 taps and both mip levels into one gather, and the noise kinds
share one batched Perlin evaluation of every octave they need.

Refused when the table is built (``NotImplementedError``): cylindrical
mapping (the JAX package accepts it and evaluates it as planar) and
references nested deeper than one level (the JAX package reads the inner
reference as 0, so ``scale(scale(imagemap, 2), .5)`` renders black).
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
import zlib

import numpy as np
import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import spectrum as spec
from pbrt_torch.film.imageio import read_image

# texture kinds (texture.py:27-28)
(T_CONSTANT, T_SCALE, T_MIX, T_BILERP, T_IMAGEMAP, T_UV, T_CHECKER2D,
 T_CHECKER3D, T_DOTS, T_FBM, T_WRINKLED, T_MARBLE, T_WINDY) = range(13)
# 2D mappings (texture.py:31)
(M_UV, M_SPHERICAL, M_CYLINDRICAL, M_PLANAR) = range(4)

#: mip pyramid depth cap (covers 8192² level-0 images)
MAX_MIP_LEVELS = 14
#: Feline probes along the footprint's major axis, each a trilinear lookup
#: weighted by the truncated Gaussian e^{-αr²} − e^{-α} of the reference's
#: EWA weight table (mipmap.h:186-192, :288-372), after its eccentricity
#: clamp (mipmap.h:296-302)
EWA_TAPS = 8
MAX_ANISOTROPY = 8.0
EWA_ALPHA = 2.0
#: octaves of fbm, wrinkled (turbulence), marble and windy's second fbm;
#: windy's first fbm has 3
OCTAVES = 6
WINDY_OCTAVES = 3
#: kinds whose value reads the 3D texture-space point
_KINDS_3D = (T_CHECKER3D, T_FBM, T_WRINKLED, T_MARBLE, T_WINDY)
#: kinds with tex1 / tex2 references (texture.py:503-504)
_REF_CLASSES = ("scale", "mix", "checkerboard", "dots", "marble", "bilerp")
_KIND_OF = {
    "constant": T_CONSTANT, "scale": T_SCALE, "mix": T_MIX, "bilerp": T_BILERP,
    "imagemap": T_IMAGEMAP, "uv": T_UV, "checkerboard": T_CHECKER2D, "dots": T_DOTS,
    "fbm": T_FBM, "wrinkled": T_WRINKLED, "marble": T_MARBLE, "windy": T_WINDY,
}
_MAPPING_OF = {"uv": M_UV, "spherical": M_SPHERICAL, "cylindrical": M_CYLINDRICAL,
               "planar": M_PLANAR}
_F32 = ("uv_xform", "world_to_tex", "c1", "c2", "f1", "f2", "pool_rgb")
_I64 = ("kind", "mapping", "ref1", "ref2", "img_offset", "img_w", "img_h",
        "img_level_off", "img_n_levels", "perm")


@dataclasses.dataclass
class TextureTable:
    """(K, ...) SoA, as the JAX package's ``TextureTable``, plus each row's
    kind, mapping and references on the host."""

    kind: torch.Tensor  # (K,) i64
    mapping: torch.Tensor  # (K,) i64
    uv_xform: torch.Tensor  # (K, 4): su, sv, du, dv
    world_to_tex: torch.Tensor  # (K, 4, 4)
    c1: torch.Tensor  # (K, S) tex1 constant (the value of a constant)
    c2: torch.Tensor  # (K, S) tex2 constant
    f1: torch.Tensor  # (K,) amount / variation / imagemap scale
    f2: torch.Tensor  # (K,)
    ref1: torch.Tensor  # (K,) i64 row of tex1, -1 = use c1
    ref2: torch.Tensor  # (K,)
    img_offset: torch.Tensor  # (K,) first pool row, -1 = none
    img_w: torch.Tensor  # (K,) level-0 (power-of-two) width
    img_h: torch.Tensor  # (K,)
    img_level_off: torch.Tensor  # (K, MAX_MIP_LEVELS) pool offset per level
    img_n_levels: torch.Tensor  # (K,)
    pool_rgb: torch.Tensor  # (P, 3) linear RGB texels of every level (row 0 black)
    perm: torch.Tensor  # (512,) Perlin permutation, doubled
    kinds: tuple = ()  # host copies of kind, mapping, ref1, ref2
    mappings: tuple = ()
    refs1: tuple = ()
    refs2: tuple = ()

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def table_from_numpy(arrays: dict, device) -> TextureTable:
    """The table's fields as numpy arrays (the JAX package's names) → a
    ``TextureTable`` on ``device``. Refuses cylindrical mapping and
    references nested deeper than one level."""
    kind = np.asarray(arrays["kind"], np.int64)
    mapping = np.asarray(arrays["mapping"], np.int64)
    ref1 = np.asarray(arrays["ref1"], np.int64)
    ref2 = np.asarray(arrays["ref2"], np.int64)
    if (mapping == M_CYLINDRICAL).any():
        raise NotImplementedError("cylindrical texture mapping is not ported (the JAX "
                                  "package evaluates it as planar)")
    for r1, r2 in zip(ref1, ref2):
        for r in (r1, r2):
            if r >= 0 and (ref1[r] >= 0 or ref2[r] >= 0):
                raise NotImplementedError(
                    "texture references nested deeper than one level are not ported "
                    "(the JAX package reads the inner reference as 0)")
    t = {k: torch.as_tensor(np.array(arrays[k], np.float32), device=device) for k in _F32}
    t.update({k: torch.as_tensor(np.array(arrays[k], np.int64), device=device)
              for k in _I64})
    return TextureTable(**t, kinds=tuple(kind.tolist()), mappings=tuple(mapping.tolist()),
                        refs1=tuple(ref1.tolist()), refs2=tuple(ref2.tolist()))


# ---------------------------------------------------------------------------
# Perlin noise (texture.py:87-160); fbm and turbulence are ``_octave_sum``
# over the octaves ``_noise`` evaluates together
# ---------------------------------------------------------------------------


def _grad(h, x, y, z):
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where(h & 1 == 0, u, -u) + torch.where(h & 2 == 0, v, -v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin_noise(perm, p):
    """Classic 3D Perlin noise over (..., 3)."""
    fl = torch.floor(p)
    pi = fl.to(torch.int64) & 255
    pf = p - fl
    u, v, w = _fade(pf[..., 0]), _fade(pf[..., 1]), _fade(pf[..., 2])
    ix, iy, iz = pi[..., 0], pi[..., 1], pi[..., 2]
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]

    def P(i):
        return perm[i & 511]

    A = P(ix) + iy
    AA = P(A) + iz
    AB = P(A + 1) + iz
    B = P(ix + 1) + iy
    BA = P(B) + iz
    BB = P(B + 1) + iz

    def lerp(t, a, b):
        return a + t * (b - a)

    return lerp(
        w,
        lerp(v, lerp(u, _grad(P(AA), fx, fy, fz), _grad(P(BA), fx - 1, fy, fz)),
             lerp(u, _grad(P(AB), fx, fy - 1, fz), _grad(P(BB), fx - 1, fy - 1, fz))),
        lerp(v, lerp(u, _grad(P(AA + 1), fx, fy, fz - 1), _grad(P(BA + 1), fx - 1, fy, fz - 1)),
             lerp(u, _grad(P(AB + 1), fx, fy - 1, fz - 1),
                  _grad(P(BB + 1), fx - 1, fy - 1, fz - 1))),
    )


def _octave_scales(n):
    """The frequency of each octave: 1, 1.99, 1.99², ... (texture.py:136-139)."""
    lam, out = 1.0, []
    for _ in range(n):
        out.append(lam)
        lam *= 1.99
    return out


def _octave_sum(noise, absolute=False, omega=0.5):
    """Σ_k ω^k n_k over the trailing axis of octave noise values, in the
    JAX package's order: its ``fbm`` (or ``turbulence`` with
    ``absolute``, texture.py:129-160)."""
    total, o = None, 1.0
    for k in range(noise.shape[-1]):
        n = noise[..., k].abs() if absolute else noise[..., k]
        total = o * n if total is None else total + o * n
        o *= omega
    return total


# ---------------------------------------------------------------------------
# Lookups (texture.py:170-288)
# ---------------------------------------------------------------------------


def _select(code, values: dict, out=None):
    """values[c] where ``code`` == c, over the codes present in ``values``
    (in ascending order, as the JAX package's ``where`` chain); lanes of
    another code keep ``out`` (None: the first value, and then ``code`` is
    not read when ``values`` holds one code)."""
    items = sorted(values.items())
    if out is None:
        (_, out), items = items[0], items[1:]
    for c, val in items:
        m = code == c
        out = torch.where(m[..., None] if val.dim() > m.dim() else m, val, out)
    return out


def _texture_point(tt, tid, p):
    w2t = tt.world_to_tex[tid]
    return torch.einsum("rij,rj->ri", w2t[:, :3, :3], p) + w2t[:, :3, 3]


def _map_uv(tt, tid, uv, p_t, maps):
    """(u, v) per lane under each row's mapping (texture.py:170-190)."""
    xf = tt.uv_xform[tid]
    us, vs = {}, {}
    if M_UV in maps:
        us[M_UV] = uv[:, 0] * xf[:, 0] + xf[:, 2]
        vs[M_UV] = uv[:, 1] * xf[:, 1] + xf[:, 3]
    if M_SPHERICAL in maps:
        r = torch.clamp(torch.sqrt((p_t * p_t).sum(-1)), min=1e-9)
        theta = torch.acos(torch.clamp(p_t[:, 2] / r, -1.0, 1.0))
        phi = torch.atan2(p_t[:, 1], p_t[:, 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        us[M_SPHERICAL] = theta / np.pi * xf[:, 0] + xf[:, 2]
        vs[M_SPHERICAL] = phi / (2 * np.pi) * xf[:, 1] + xf[:, 3]
    if M_PLANAR in maps:
        us[M_PLANAR] = p_t[:, 0] * xf[:, 0] + xf[:, 2]
        vs[M_PLANAR] = p_t[:, 1] * xf[:, 1] + xf[:, 3]
    m = tt.mapping[tid] if len(maps) > 1 else None
    return _select(m, us), _select(m, vs)


def _bilinear_at_level(tt, tid, u, v, lvl):
    """Bilinear fetch at integer mip level ``lvl``, repeat wrap; ``tid``,
    ``u``, ``v`` and ``lvl`` broadcast together → (..., 3)."""
    w = torch.clamp(tt.img_w[tid] >> lvl, min=1)
    h = torch.clamp(tt.img_h[tid] >> lvl, min=1)
    off = torch.clamp(tt.img_level_off[tid, lvl], min=0)
    uu = (u % 1.0) * w.to(u.dtype) - 0.5
    vv = (v % 1.0) * h.to(v.dtype) - 0.5
    x0 = torch.floor(uu).to(torch.int64)
    y0 = torch.floor(vv).to(torch.int64)
    du = (uu - x0)[..., None]
    dv = (vv - y0)[..., None]

    def fetch(xi, yi):
        return tt.pool_rgb[off + (yi % h) * w + xi % w]

    return ((1 - du) * (1 - dv) * fetch(x0, y0) + du * (1 - dv) * fetch(x0 + 1, y0)
            + (1 - du) * dv * fetch(x0, y0 + 1) + du * dv * fetch(x0 + 1, y0 + 1))


def _trilinear(tt, tid, u, v, level_f):
    """Lerp of the bilinear fetches at the two bracketing levels, both in
    one gather (texture.py:235-247)."""
    n_lev = torch.clamp(tt.img_n_levels[tid], min=1)
    lf = torch.minimum(torch.clamp(level_f, min=0.0), (n_lev - 1).to(level_f.dtype))
    l0 = torch.floor(lf).to(torch.int64)
    l1 = torch.minimum(l0 + 1, n_lev - 1)
    frac = (lf - l0.to(lf.dtype))[..., None]
    c = _bilinear_at_level(tt, tid[..., None], u[..., None], v[..., None],
                           torch.stack([l0, l1], -1))
    return (1.0 - frac) * c[..., 0, :] + frac * c[..., 1, :]


def _image_lookup(tt, tid, u, v, uv_sigma=None, uv_major=None):
    """Filtered fetch → (R, 3) linear RGB (texture.py:250-288): level-0
    bilinear without a footprint, trilinear with ``uv_sigma`` alone, the
    Feline EWA with ``uv_major`` too."""
    if uv_sigma is None:
        return _bilinear_at_level(tt, tid, u, v, torch.zeros_like(tid))
    res = torch.clamp(torch.maximum(tt.img_w[tid], tt.img_h[tid]), min=1).to(torch.float32)
    if uv_major is None:
        width = torch.clamp(uv_sigma, min=1e-8)
        return _trilinear(tt, tid, u, v, torch.clamp(torch.log2(width * res), min=0.0))
    major_len = torch.clamp(geom.length(uv_major), min=1e-12)
    minor_len = torch.clamp(uv_sigma, min=1e-12)
    minor_len = torch.maximum(minor_len, major_len / MAX_ANISOTROPY)
    ecc = torch.clamp(major_len / minor_len, min=1.0)
    level_f = torch.clamp(torch.log2(minor_len * res), min=0.0)
    half = (ecc - 1.0) / ecc
    # probe k sits at f_k·major from (u, v), f_k in [−half, half]
    ck = torch.tensor([((k + 0.5) / EWA_TAPS - 0.5) * 2.0 for k in range(EWA_TAPS)],
                      dtype=u.dtype, device=u.device)
    f = ck * half[:, None]
    w = torch.clamp(torch.exp(-EWA_ALPHA * (f * f)) - np.exp(-EWA_ALPHA), min=0.0)
    tri = _trilinear(tt, tid[:, None].expand(-1, EWA_TAPS), u[:, None] + f * uv_major[:, None, 0],
                     v[:, None] + f * uv_major[:, None, 1],
                     level_f[:, None].expand(-1, EWA_TAPS))
    acc = w[:, 0, None] * tri[:, 0]
    wsum = w[:, 0]
    for k in range(1, EWA_TAPS):
        acc = acc + w[:, k, None] * tri[:, k]
        wsum = wsum + w[:, k]
    return acc / torch.clamp(wsum, min=1e-12)[:, None]


def _noise(tt, p_t, u, v, kinds):
    """The Perlin values the noise kinds need, in one batched call: {name:
    (R,)} of ``fbm`` and ``turb`` (6 octaves at p_t), ``windy`` (windy's
    3-octave fbm at p_t · 0.1) and ``dots`` ((R, 3): at the dot cell's
    point and its two offsets), with the cell (cu, cv)."""
    pts, out = [], {}
    lam = torch.tensor(_octave_scales(OCTAVES), dtype=u.dtype, device=u.device)
    if set(kinds) & {T_FBM, T_WRINKLED, T_MARBLE, T_WINDY}:
        pts.append(("octaves", p_t[:, None, :] * lam[:, None]))
    if T_WINDY in kinds:
        pts.append(("windy", (p_t * 0.1)[:, None, :] * lam[:WINDY_OCTAVES, None]))
    if T_DOTS in kinds:
        cu = torch.floor(u + 0.5)
        cv = torch.floor(v + 0.5)
        cell = torch.stack([cu + 0.5, cv + 0.5, torch.zeros_like(u)], -1)
        out["cell"] = (cu, cv)
        pts.append(("dots", torch.stack([cell, cell + 1.5, cell + 4.5], 1)))
    noise = perlin_noise(tt.perm, torch.cat([x for _, x in pts], 1))
    at = 0
    for name, x in pts:
        n = noise[:, at:at + x.shape[1]]
        at += x.shape[1]
        if name == "octaves":
            out["fbm"] = _octave_sum(n)
            out["turb"] = _octave_sum(n, absolute=True)
        elif name == "windy":
            out["windy"] = _octave_sum(n)
        else:
            out["dots"] = n
    return out


def _eval_base(tt, tid, uv, p, prev1, prev2, uv_sigma, uv_major, kinds, maps):
    """One substitution pass (texture.py:291-368): each lane's texture of
    row ``tid``, with ``prev1`` / ``prev2`` (R, S) as the values of its
    references (None: no row of the pass has one). Computes only
    ``kinds`` under ``maps``."""
    R = tid.shape[0]
    S = tt.c1.shape[-1]
    c1, c2 = tt.c1[tid], tt.c2[tid]
    v1 = c1 if prev1 is None else torch.where((tt.ref1[tid] >= 0)[:, None], prev1, c1)
    v2 = c2 if prev2 is None else torch.where((tt.ref2[tid] >= 0)[:, None], prev2, c2)
    need_p = bool(set(kinds) & set(_KINDS_3D)) or bool(set(maps) - {M_UV})
    p_t = _texture_point(tt, tid, p) if need_p else None
    u, v = _map_uv(tt, tid, uv, p_t, maps)
    vals = {}
    if T_SCALE in kinds:
        vals[T_SCALE] = v1 * v2
    if T_MIX in kinds:
        amt = tt.f1[tid][:, None]
        vals[T_MIX] = (1.0 - amt) * v1 + amt * v2
    if T_BILERP in kinds:
        vals[T_BILERP] = (1 - u[:, None]) * (1 - v[:, None]) * v1 + u[:, None] * v[:, None] * v2
    if T_IMAGEMAP in kinds:
        # the footprint follows the uv mapping's scale (uscale / vscale)
        xf = tt.uv_xform[tid]
        sig = None if uv_sigma is None else uv_sigma * torch.maximum(xf[:, 0].abs(),
                                                                     xf[:, 1].abs())
        maj = None if uv_major is None else uv_major * xf[:, 0:2]
        img = _image_lookup(tt, tid, u, v, sig, maj)
        vals[T_IMAGEMAP] = spec.rgb_to_spectrum(img) * tt.f1[tid][:, None]
    if T_UV in kinds:
        half = S // 2
        vals[T_UV] = torch.cat([(u % 1.0)[:, None].expand(R, half),
                                (v % 1.0)[:, None].expand(R, S - half)], 1)
    if T_CHECKER2D in kinds:
        even = (torch.floor(u) + torch.floor(v)) % 2.0 == 0
        vals[T_CHECKER2D] = torch.where(even[:, None], v1, v2)
    if T_CHECKER3D in kinds:
        fl = torch.floor(p_t)
        even = (fl[:, 0] + fl[:, 1] + fl[:, 2]) % 2.0 == 0
        vals[T_CHECKER3D] = torch.where(even[:, None], v1, v2)
    if set(kinds) & {T_DOTS, T_FBM, T_WRINKLED, T_MARBLE, T_WINDY}:
        nz = _noise(tt, p_t, u, v, kinds)
        if T_DOTS in kinds:
            cu, cv = nz["cell"]
            dn = nz["dots"]
            cx = cu + 0.35 * dn[:, 1]
            cy = cv + 0.35 * dn[:, 2]
            inside = ((u - cx) ** 2 + (v - cy) ** 2) < 0.35 * 0.35
            vals[T_DOTS] = torch.where(((dn[:, 0] > 0.0) & inside)[:, None], v1, v2)
        if T_FBM in kinds:
            vals[T_FBM] = nz["fbm"][:, None].expand(R, S)
        if T_WRINKLED in kinds:
            vals[T_WRINKLED] = nz["turb"][:, None].expand(R, S)
        if T_MARBLE in kinds:
            variation = torch.clamp(tt.f1[tid], min=1e-3)
            t = (0.5 + 0.5 * torch.sin(p_t[:, 1] * variation + 5.0 * nz["turb"]))[:, None]
            vals[T_MARBLE] = (1 - t) * v1 + t * v2
        if T_WINDY in kinds:
            vals[T_WINDY] = (nz["windy"].abs() * nz["fbm"])[:, None].expand(R, S)
    if len(kinds) == 1:
        return vals.get(next(iter(kinds)), v1)
    return _select(tt.kind[tid], vals, v1)


def eval_spectrum(tt: TextureTable, tex_id, uv, p, uv_sigma=None, uv_major=None, rows=None):
    """Spectrum textures of rows ``tex_id`` (R,) (-1 lanes get zeros) at
    (uv, p); ``uv_sigma`` / ``uv_major`` are the optional footprint (minor
    radius, major-axis vector) in uv units (texture.py:371-391). ``rows``:
    the rows ``tex_id`` may hold, known on the host (None: every row)."""
    rows = range(tt.count) if rows is None else rows
    if not rows:
        return torch.zeros(tex_id.shape[0], tt.c1.shape[-1], device=tex_id.device)
    tid = tex_id.clamp(min=0)
    prev = []
    for refs, col in ((tt.refs1, tt.ref1), (tt.refs2, tt.ref2)):
        sub = {refs[r] for r in rows if refs[r] >= 0}
        prev.append(None if not sub else _eval_base(
            tt, col[tid].clamp(min=0), uv, p, None, None, uv_sigma, uv_major,
            {tt.kinds[r] for r in sub}, {tt.mappings[r] for r in sub}))
    out = _eval_base(tt, tid, uv, p, prev[0], prev[1], uv_sigma, uv_major,
                     {tt.kinds[r] for r in rows}, {tt.mappings[r] for r in rows})
    return torch.where((tex_id >= 0)[:, None], out, 0.0)


def eval_float(tt: TextureTable, tex_id, uv, p, uv_sigma=None, uv_major=None, rows=None):
    """Float textures: the mean of the spectral value (texture.py:394-403)."""
    return eval_spectrum(tt, tex_id, uv, p, uv_sigma, uv_major, rows).mean(-1)


# ---------------------------------------------------------------------------
# Host-side construction (texture.py:406-584), the JAX package's numpy code
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _lanczos_weights(n_out: int, n_in: int, tau: float = 2.0):
    """Separable Lanczos-2 resample weights, 4 taps per output texel
    (mipmap.h:59-140)."""
    x_out = (np.arange(n_out) + 0.5) * n_in / n_out
    first = np.floor(x_out - 2.0 + 0.5).astype(np.int64)
    offs = first[:, None] + np.arange(4)[None, :]
    d = (offs + 0.5 - x_out[:, None]) / tau
    w = np.sinc(d) * np.sinc(d / tau) * (np.abs(d) < 1.0)
    s = w.sum(axis=1, keepdims=True)
    w = np.where(s != 0, w / np.maximum(s, 1e-9), 0.25)
    return np.clip(offs, 0, n_in - 1), w.astype(np.float32)


def _resample_pow2(img: np.ndarray) -> np.ndarray:
    """(H, W, C) up to the next power-of-two dims (Lanczos)."""
    H, W = img.shape[:2]
    H2, W2 = _next_pow2(H), _next_pow2(W)
    if H2 != H:
        offs, w = _lanczos_weights(H2, H)
        img = np.einsum("okwc,ok->owc", img[offs], w)
    if W2 != W:
        offs, w = _lanczos_weights(W2, W)
        img = np.einsum("hokc,ok->hoc", img[:, offs], w)
    return np.ascontiguousarray(img, dtype=np.float32)


def _build_pyramid(img: np.ndarray) -> list:
    """Power-of-two resample, then the 2×2 box mip chain down to 1×1."""
    img = _resample_pow2(img)
    levels = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        H, W = img.shape[:2]
        h2, w2 = max(H // 2, 1), max(W // 2, 1)
        if H > 1 and W > 1:
            img = img.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        elif H > 1:
            img = img.reshape(h2, 2, 1, -1).mean(axis=1)
        else:
            img = img.reshape(1, w2, 2, -1).mean(axis=2)
        levels.append(np.ascontiguousarray(img, np.float32))
    return levels[:MAX_MIP_LEVELS]


def perlin_permutation() -> np.ndarray:
    """(512,) the seeded permutation, doubled (texture.py:560-562)."""
    perm256 = np.random.default_rng(1234).permutation(256)
    return np.concatenate([perm256, perm256]).astype(np.int32)


def _empty_row(S):
    return dict(kind=T_CONSTANT, mapping=M_UV, uv_xform=[1, 1, 0, 0], world_to_tex=np.eye(4),
                c1=np.zeros(S, np.float32), c2=np.zeros(S, np.float32), f1=1.0, f2=0.5,
                ref1=-1, ref2=-1, img_offset=-1, img_w=0, img_h=0,
                img_level_off=[-1] * MAX_MIP_LEVELS, img_n_levels=0)


def _load_image_levels(fn, gamma):
    """The pyramid of an image file (1-channel maps repeated to RGB)."""
    img = np.asarray(read_image(fn), np.float32)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    img = img[..., :3]
    if gamma:
        img = img ** 2.2
    return _build_pyramid(img)


def build_texture_table(records: dict, config, device) -> tuple:
    """records {name: TextureRecord} → (TextureTable, index), where index
    maps (data_type, name) and ("any", name) to the row (texture.py:
    465-584). An imagemap whose file does not load is black, with a
    warning, as in the JAX package."""
    S = config.n_bins
    names = list(records.keys())
    index_by_name = {name: i for i, name in enumerate(names)}
    index, rows = {}, []
    pool = [np.zeros((1, 3), np.float32)]
    for name in names:
        rec = records[name]
        p = rec.params
        r = _empty_row(S)
        kind = _KIND_OF.get(rec.tex_class, T_CONSTANT)
        if rec.tex_class == "checkerboard" and p.find_one_int("dimension", 2) == 3:
            kind = T_CHECKER3D
        r.update(kind=kind, mapping=_MAPPING_OF.get(p.find_one_string("mapping", "uv"), M_UV),
                 uv_xform=[p.find_one_float("uscale", 1.0), p.find_one_float("vscale", 1.0),
                           p.find_one_float("udelta", 0.0), p.find_one_float("vdelta", 0.0)],
                 world_to_tex=np.linalg.inv(rec.tex_to_world))
        if rec.tex_class == "constant":
            r["c1"] = p.find_one_spectrum("value", 1.0)
        elif rec.tex_class in _REF_CLASSES:
            for slot, pname in (("1", "tex1"), ("2", "tex2")):
                tex_ref = p.find_texture(pname)
                if tex_ref is not None and tex_ref in index_by_name:
                    r[f"ref{slot}"] = index_by_name[tex_ref]
                else:
                    default = 1.0 if rec.tex_class == "scale" else (0.0 if slot == "2" else 1.0)
                    r[f"c{slot}"] = p.find_one_spectrum(pname, default)
            if rec.tex_class == "mix":
                r["f1"] = p.find_one_float("amount", 0.5)
            if rec.tex_class == "marble":
                r["f1"] = p.find_one_float("variation", 0.2)
        elif rec.tex_class == "imagemap":
            fn = p.find_one_filename("filename", "")
            r["f1"] = p.find_one_float("scale", 1.0)
            if fn:
                try:
                    levels = _load_image_levels(fn, p.find_one_bool("gamma", False))
                    offs = []
                    for lv in levels:
                        offs.append(sum(len(x) for x in pool))
                        pool.append(lv.reshape(-1, 3))
                    r.update(img_offset=offs[0], img_w=levels[0].shape[1],
                             img_h=levels[0].shape[0], img_n_levels=len(offs),
                             img_level_off=offs + [offs[-1]] * (MAX_MIP_LEVELS - len(offs)))
                except (OSError, ValueError, KeyError, IndexError, struct.error,
                        zlib.error) as e:
                    warnings.warn(f"imagemap {fn!r}: {e}; black texture")
        rows.append(r)
        index[(rec.data_type, name)] = len(rows) - 1
        index[("any", name)] = len(rows) - 1
    if not rows:
        rows = [_empty_row(S)]
    arrays = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    arrays["pool_rgb"] = np.concatenate(pool, axis=0)
    arrays["perm"] = perlin_permutation()
    return table_from_numpy(arrays, device), index
