"""Material table: per-material lobe lists, evaluated lane-parallel.

Port of ``pbrt_tpu/materials/table.py`` (reference: src/materials/*.cpp and
BSDF::f / Pdf / Sample_f, src/core/reflection.cpp:517-612). Each material
row lists up to ``MAX_LOBES`` lobe codes, as pbrt's GetBSDF adds BxDFs;
BSDF::f sums the lobes, Pdf averages them and Sample_f picks one uniformly.
A ``mix`` row names two other rows and an amount (materials/mix.cpp):
``gather_lane`` then returns a ``MixLane`` holding both sub-lanes.

All 14 lobe codes of the JAX package are here: Lambertian, Oren–Nayar,
Blinn microfacet with dielectric and conductor Fresnel, FresnelBlend
(substrate), the three specular reflections (dielectric, none,
conductor), specular transmission, Ward, the translucent material's
diffuse and glossy transmission, and the measured lobes (``.brdf`` and
MERL, ``bsdf/measured.py``).

Lobe codes are stored as they are (the JAX table stores indices into its
static ``active_lobes`` tuple; ``interop`` maps those back). Each call
evaluates every code the table holds once on every lane and picks, per
slot, the lane's own (masked evaluation, as the JAX package's
``lax.switch`` under ``vmap``).

Texture bindings: a row names the texture rows of its Kd, Ks, bump map
and normal map (``kd_tex`` ... ``normal_tex``, -1 for none;
``integrators/path.py:apply_textures`` evaluates them). As in the JAX
package, only these four take a texture (``sigma_tex`` is allocated and
never set); every other texture-bound parameter (Kr, Kt, roughness,
sigma, a mix's amount) takes its constant default, and a texture-bound Kd
or Ks switches on plastic's and uber's lobe even where the constant is 0.

Refused (``NotImplementedError``): a mix whose sub-material is itself a
mix (the JAX package renders such an inner mix as a black Lambertian, its
row's own placeholder lobe).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from pbrt_torch.bsdf import bxdf
from pbrt_torch.bsdf import measured as meas
from pbrt_torch.core import geometry as geom
from pbrt_torch.core import spectrum as spec

MAX_LOBES = 4

# material kinds (the JAX package's, materials/table.py:31-32)
(MATTE, PLASTIC, GLASS, MIRROR, METAL, SHINYMETAL, SUBSTRATE, UBER,
 TRANSLUCENT, ANISOWARD, MEASURED, SUBSURFACE, KDSUBSURFACE, MIXMAT) = range(14)

# lobe codes (materials/table.py:35-38)
(L_LAMBERT, L_ORENNAYAR, L_BLINN_DIEL, L_BLINN_COND, L_FRESNEL_BLEND,
 L_SPEC_REFL_DIEL, L_SPEC_REFL_NOOP, L_SPEC_REFL_COND, L_SPEC_TRANS,
 L_WARD, L_LAMBERT_TRANS, L_BLINN_DIEL_TRANS, L_IRREG_MEASURED,
 L_MERL_MEASURED) = range(14)
N_LOBE_TYPES = 14
DELTA_LOBES = (L_SPEC_REFL_DIEL, L_SPEC_REFL_NOOP, L_SPEC_REFL_COND, L_SPEC_TRANS)
#: lobes sampled from the cosine hemisphere (their pdf is cosine_pdf)
_COSINE_LOBES = (L_LAMBERT, L_ORENNAYAR, L_IRREG_MEASURED, L_MERL_MEASURED)
_BLINN_LOBES = (L_BLINN_DIEL, L_BLINN_COND)

# Jensen et al. 2001 measured media (σa, σ's RGB, mm⁻¹), as the JAX
# package's table (core/volume.cpp GetVolumeScatteringProperties)
_NAMED_MEDIA = {
    "Marble": ((0.0021, 0.0041, 0.0071), (2.19, 2.62, 3.00)),
    "Skin1": ((0.032, 0.17, 0.48), (0.74, 0.88, 1.01)),
    "Skin2": ((0.013, 0.070, 0.145), (1.09, 1.59, 1.79)),
    "Cream": ((0.0002, 0.0028, 0.0163), (7.38, 5.47, 3.15)),
    "Ketchup": ((0.061, 0.97, 1.45), (0.18, 0.07, 0.03)),
    "Wholemilk": ((0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77)),
    "Skimmilk": ((0.0014, 0.0025, 0.0142), (0.70, 1.22, 1.90)),
    "Spectralon": ((0.00001, 0.00001, 0.00001), (11.6, 20.4, 14.9)),
}
# metal's default eta / k: copper, as the JAX package approximates it
_COPPER_LAM = [400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0]
_COPPER_N = [1.18, 1.15, 1.12, 0.79, 0.37, 0.23, 0.21]
_COPPER_K = [2.21, 2.40, 2.60, 2.78, 3.27, 3.64, 4.05]

#: the material table's texture-id columns
TEXTURE_COLUMNS = ("kd_tex", "ks_tex", "sigma_tex", "bump_tex", "normal_tex")
#: the row fields each lobe code reads; a lane gathers those of the codes
#: its table holds (the rest stay None)
_LOBE_FIELDS = {
    L_LAMBERT: ("kd",), L_ORENNAYAR: ("kd", "sigma"),
    L_BLINN_DIEL: ("ks", "exp_u", "eta"), L_BLINN_COND: ("ks", "exp_u", "eta_spec", "k_spec"),
    L_FRESNEL_BLEND: ("kd", "ks", "exp_u", "exp_v"), L_SPEC_REFL_DIEL: ("kr", "eta"),
    L_SPEC_REFL_NOOP: ("kr",), L_SPEC_REFL_COND: ("kr", "eta_spec", "k_spec"),
    L_SPEC_TRANS: ("kt", "eta"), L_WARD: ("ks", "exp_u", "exp_v"), L_LAMBERT_TRANS: ("kt",),
    L_BLINN_DIEL_TRANS: ("kr", "exp_u", "eta"), L_IRREG_MEASURED: ("irreg_offset", "irreg_count"),
    L_MERL_MEASURED: ("merl_offset",),
}


@dataclasses.dataclass
class MaterialTable:
    """(M, ...) SoA; spectral fields are (M, n_bins)."""

    kind: torch.Tensor  # (M,) i64
    n_lobes: torch.Tensor  # (M,) i64
    lobe_type: torch.Tensor  # (M, MAX_LOBES) i64 full lobe codes, -1 pad
    kd: torch.Tensor  # diffuse
    ks: torch.Tensor  # glossy
    kr: torch.Tensor  # specular reflection (translucent: glossy transmission)
    kt: torch.Tensor  # specular transmission (translucent: diffuse transmission)
    sigma: torch.Tensor  # (M,) Oren–Nayar σ, degrees
    exp_u: torch.Tensor  # (M,) Blinn / anisotropic exponent (1/roughness) or Ward α
    exp_v: torch.Tensor  # (M,)
    eta: torch.Tensor  # (M,) dielectric index
    eta_spec: torch.Tensor  # (M, S) conductor η
    k_spec: torch.Tensor  # (M, S) conductor k
    irreg_offset: torch.Tensor  # (M,) i64 first row in the .brdf pool
    irreg_count: torch.Tensor  # (M,) i64
    merl_offset: torch.Tensor  # (M,) i64 first row in the MERL pool, -1 none
    irreg_points: torch.Tensor  # (P, 3) .brdf samples' lookup points (row 0 a pad)
    irreg_spectra: torch.Tensor  # (P, S)
    merl_rgb: torch.Tensor  # (Q, 3) MERL tables (row 0 a pad)
    ss_sigma_a: torch.Tensor  # (M, S) subsurface σa (integrators/dipole.py reads it)
    ss_sigma_s: torch.Tensor  # (M, S) reduced σs
    ss_scale: torch.Tensor  # (M,)
    mix_m1: torch.Tensor  # (M,) i64 row of namedmaterial1 (the row itself if not a mix)
    mix_m2: torch.Tensor  # (M,) i64
    mix_amt: torch.Tensor  # (M, S) amount (1 for rows that are not mixes)
    kd_tex: torch.Tensor  # (M,) i64 texture row of Kd, -1 = the constant
    ks_tex: torch.Tensor  # (M,) i64
    sigma_tex: torch.Tensor  # (M,) i64, always -1 (as the JAX package's)
    bump_tex: torch.Tensor  # (M,) i64 float texture of the bump map
    normal_tex: torch.Tensor  # (M,) i64 spectrum texture of the normal map
    #: host-side: the lobe codes present (only those are evaluated)
    active_lobes: tuple = (L_LAMBERT,)
    #: host-side: the most lobes any row uses (bounds the slot loops)
    max_lobes: int = 1
    #: host-side: the table has a mix row (gather_lane returns MixLane)
    has_mix: bool = False
    #: host-side, derived: {"kd_tex": rows, ...}, the texture rows each
    #: column names (the kinds a texture evaluation must compute)
    tex_rows: dict = dataclasses.field(init=False)

    def __post_init__(self):
        self.tex_rows = {k: tuple(sorted({int(i) for i in getattr(self, k).tolist() if i >= 0}))
                         for k in TEXTURE_COLUMNS}

    @property
    def has_bump(self) -> bool:
        return bool(self.tex_rows["bump_tex"])

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class LaneMaterial:
    """One row's parameters per lane: the fields the table's lobe codes
    read (``_LOBE_FIELDS``; the others None). ``pools`` are the table's
    measured pools (not gathered)."""

    n_lobes: torch.Tensor
    lobe_type: torch.Tensor  # (R, MAX_LOBES)
    pools: tuple  # (irreg_points, irreg_spectra, merl_rgb)
    active_lobes: tuple
    max_lobes: int
    n_bins: int
    kd: torch.Tensor = None
    ks: torch.Tensor = None
    kr: torch.Tensor = None
    kt: torch.Tensor = None
    sigma: torch.Tensor = None
    exp_u: torch.Tensor = None
    exp_v: torch.Tensor = None
    eta: torch.Tensor = None
    eta_spec: torch.Tensor = None
    k_spec: torch.Tensor = None
    irreg_offset: torch.Tensor = None
    irreg_count: torch.Tensor = None
    merl_offset: torch.Tensor = None

    def zeros_s(self):
        """(R, S) zeros."""
        return torch.zeros(self.n_lobes.shape[0], self.n_bins, device=self.n_lobes.device)


@dataclasses.dataclass
class MixLane:
    """A table with mix rows: both sub-materials' lanes and the amount. A
    lane that is not a mix has m1 == m2 == its row and amount 1, and every
    formula reduces to its plain lane's."""

    lm1: LaneMaterial
    lm2: LaneMaterial
    amt: torch.Tensor  # (R, S)
    m1: torch.Tensor  # (R,) i64 sub-rows
    m2: torch.Tensor


def _gather_plain(mt: MaterialTable, i) -> LaneMaterial:
    fields = {f for code in mt.active_lobes for f in _LOBE_FIELDS[code]}
    return LaneMaterial(n_lobes=mt.n_lobes[i], lobe_type=mt.lobe_type[i],
                        pools=(mt.irreg_points, mt.irreg_spectra, mt.merl_rgb),
                        active_lobes=mt.active_lobes, max_lobes=mt.max_lobes,
                        n_bins=mt.kd.shape[1], **{f: getattr(mt, f)[i] for f in sorted(fields)})


def gather_lane(mt: MaterialTable, idx):
    """Row ``idx`` (R,) of each lane (-1 → row 0): a ``LaneMaterial``, or a
    ``MixLane`` where the table has mix rows (materials/table.py:168)."""
    i = idx.clamp(min=0)
    if not mt.has_mix:
        return _gather_plain(mt, i)
    is_mix = mt.kind[i] == MIXMAT
    m1 = torch.where(is_mix, mt.mix_m1[i], i)
    m2 = torch.where(is_mix, mt.mix_m2[i], i)
    return MixLane(lm1=_gather_plain(mt, m1), lm2=_gather_plain(mt, m2),
                   amt=torch.where(is_mix[:, None], mt.mix_amt[i], 1.0), m1=m1, m2=m2)


def _select(lobe, values: dict, zero):
    """values[code] for each lane's code (codes absent → zero)."""
    out = zero
    for code, v in values.items():
        m = lobe == code
        out = torch.where(m[..., None] if v.dim() > m.dim() else m, v, out)
    return out


_FLIP_Z = (1.0, 1.0, -1.0)


def _flip_z(w):
    return w * torch.tensor(_FLIP_Z, dtype=w.dtype, device=w.device)


def _lobe_f_all(lm: LaneMaterial, wo, wi, refl_ok):
    """f of every present lobe code → {code: (R, S)}; delta lobes are 0
    outside sampling and left out. Reflection lobes apply where
    ``refl_ok``, transmission lobes elsewhere (BSDF::f's classification)."""
    refl = refl_ok[:, None]
    trans = ~refl
    out = {}
    for code in lm.active_lobes:
        if code == L_LAMBERT:
            out[code] = bxdf.lambertian_f(lm.kd) * refl
        elif code == L_ORENNAYAR:
            out[code] = bxdf.oren_nayar_f(lm.kd, lm.sigma, wo, wi) * refl
        elif code in _BLINN_LOBES:
            wh = geom.normalize(wo + wi)
            if code == L_BLINN_DIEL:
                fr = bxdf.fresnel_dielectric(geom.dot(wi, wh), 1.0, lm.eta)[:, None]
            else:
                fr = bxdf.fresnel_conductor(geom.dot(wi, wh), lm.eta_spec, lm.k_spec)
            out[code] = bxdf.microfacet_f(lm.ks, fr, lm.exp_u, wo, wi) * refl
        elif code == L_FRESNEL_BLEND:
            out[code] = bxdf.fresnel_blend_f(lm.kd, lm.ks, lm.exp_u, lm.exp_v, wo, wi) * refl
        elif code == L_WARD:
            out[code] = bxdf.ward_f(lm.ks, lm.exp_u, lm.exp_v, wo, wi) * refl
        elif code == L_LAMBERT_TRANS:
            out[code] = bxdf.lambertian_f(lm.kt) * trans
        elif code == L_BLINN_DIEL_TRANS:
            # translucent glossy transmission: evaluated with wi mirrored
            wif = _flip_z(wi)
            wh = geom.normalize(wo + wif)
            fr = bxdf.fresnel_dielectric(geom.dot(wif, wh), 1.0, lm.eta)[:, None]
            out[code] = bxdf.microfacet_f(lm.kr, fr, lm.exp_u, wo, wif) * trans
        elif code == L_IRREG_MEASURED:
            pts, spectra, _ = lm.pools
            f = meas.irreg_f(pts, spectra, lm.irreg_offset, lm.irreg_count, wo, wi)
            out[code] = torch.where(refl, f, 0.0)
        elif code == L_MERL_MEASURED:
            f = meas.merl_f(lm.pools[2], lm.merl_offset.clamp(min=0), wo, wi)
            out[code] = torch.where(refl, f, 0.0)
    return out


def _lobe_pdf_all(lm: LaneMaterial, wo, wi):
    out = {}
    shared = {}
    for code in lm.active_lobes:
        if code in _COSINE_LOBES:
            if "cos" not in shared:
                shared["cos"] = bxdf.cosine_pdf(wo, wi)
            out[code] = shared["cos"]
        elif code in _BLINN_LOBES:
            if "blinn" not in shared:
                shared["blinn"] = bxdf.blinn_pdf(lm.exp_u, wo, wi)
            out[code] = shared["blinn"]
        elif code == L_FRESNEL_BLEND:
            out[code] = 0.5 * (bxdf.cosine_pdf(wo, wi)
                               + bxdf.aniso_pdf(lm.exp_u, lm.exp_v, wo, wi))
        elif code == L_WARD:
            out[code] = bxdf.ward_pdf(lm.exp_u, lm.exp_v, wo, wi)
        elif code == L_LAMBERT_TRANS:
            out[code] = torch.where(~bxdf.same_hemisphere(wo, wi),
                                    bxdf.abs_cos_theta(wi) * bxdf.INV_PI, 0.0)
        elif code == L_BLINN_DIEL_TRANS:
            out[code] = torch.where(~bxdf.same_hemisphere(wo, wi),
                                    bxdf.blinn_pdf(lm.exp_u, wo, _flip_z(wi)), 0.0)
    return out


def _lobe_sample_all(lm: LaneMaterial, wo, u1, u2):
    """Sample every present code → {code: (wi, pdf, f_delta or None,
    is_delta)}. A delta lobe's f_delta is its whole weight spectrum
    F·k/|cos θ| with pdf 1 (reflection.h:298-343); a smooth lobe's f is
    evaluated again over all lobes by the caller."""
    out = {}
    shared = {}
    for code in lm.active_lobes:
        if code in _COSINE_LOBES:
            if "cos" not in shared:
                shared["cos"] = bxdf.cosine_sample(u1, u2, wo) + (None, False)
            out[code] = shared["cos"]
        elif code in _BLINN_LOBES:
            if "blinn" not in shared:
                shared["blinn"] = bxdf.blinn_sample_wh(lm.exp_u, wo, u1, u2) + (None, False)
            out[code] = shared["blinn"]
        elif code == L_FRESNEL_BLEND:
            use_diff = u1 < 0.5
            u1r = torch.where(use_diff, u1 * 2.0, (u1 - 0.5) * 2.0)
            wi_d, _ = bxdf.cosine_sample(u1r, u2, wo)
            wi_s, _ = bxdf.aniso_sample_wh(lm.exp_u, lm.exp_v, wo, u1r, u2)
            wi = torch.where(use_diff[:, None], wi_d, wi_s)
            pdf = 0.5 * (bxdf.cosine_pdf(wo, wi) + bxdf.aniso_pdf(lm.exp_u, lm.exp_v, wo, wi))
            out[code] = (wi, pdf, None, False)
        elif code == L_WARD:
            out[code] = bxdf.ward_sample(lm.exp_u, lm.exp_v, wo, u1, u2) + (None, False)
        elif code in (L_SPEC_REFL_DIEL, L_SPEC_REFL_NOOP, L_SPEC_REFL_COND):
            wi = bxdf.specular_reflect_dir(wo)
            ci = bxdf.cos_theta(wi)
            if code == L_SPEC_REFL_DIEL:
                F = bxdf.fresnel_dielectric(ci, 1.0, lm.eta)[:, None]
            elif code == L_SPEC_REFL_COND:
                F = bxdf.fresnel_conductor(ci, lm.eta_spec, lm.k_spec)
            else:
                F = 1.0
            f = lm.kr * F / torch.clamp(bxdf.abs_cos_theta(wi), min=1e-8)[:, None]
            out[code] = (wi, torch.ones_like(u1), f, True)
        elif code == L_SPEC_TRANS:
            wi, valid, eta_ratio = bxdf.specular_transmit_dir(wo, 1.0, lm.eta)
            F = bxdf.fresnel_dielectric(bxdf.cos_theta(wo), 1.0, lm.eta)[:, None]
            # radiance scaling (ηi/ηt)² of transmission (reflection.cpp:489)
            f = ((eta_ratio ** 2)[:, None] * lm.kt * (1.0 - F)
                 / torch.clamp(bxdf.abs_cos_theta(wi), min=1e-8)[:, None])
            f = torch.where(valid[:, None], f, 0.0)
            out[code] = (wi, torch.where(valid, 1.0, 0.0), f, True)
        elif code == L_LAMBERT_TRANS:
            wi, pdf = bxdf.cosine_sample(u1, u2, wo)
            out[code] = (_flip_z(wi), pdf, None, False)
        elif code == L_BLINN_DIEL_TRANS:
            wi, pdf = bxdf.blinn_sample_wh(lm.exp_u, wo, u1, u2)
            out[code] = (_flip_z(wi), pdf, None, False)
    return out


def _refl_ok(wo, wi, ng_loc):
    """BSDF::f's classification (reflection.cpp:517-529): reflection iff wo
    and wi lie on one side of the geometric normal (of the shading normal
    without ``ng_loc``)."""
    if ng_loc is None:
        return bxdf.same_hemisphere(wo, wi)
    return (geom.dot(wo, ng_loc) * geom.dot(wi, ng_loc)) > 0.0


def _slot_sum(lm: LaneMaterial, vals: dict, zero):
    out = zero
    for slot in range(min(MAX_LOBES, lm.max_lobes)):
        active = slot < lm.n_lobes
        lobe = lm.lobe_type[:, slot].clamp(min=0)
        sel = _select(lobe, vals, zero)
        out = out + torch.where(active[:, None] if sel.dim() == 2 else active, sel, 0.0)
    return out


def bsdf_f(lm, wo, wi, ng_loc=None):
    """Σ over the lane's lobes (R, S) (BSDF::f); a mix lane blends
    amount·f(m1) + (1 − amount)·f(m2) (materials/mix.cpp). ``ng_loc``: the
    geometric normal in the shading frame."""
    if isinstance(lm, MixLane):
        f1 = bsdf_f(lm.lm1, wo, wi, ng_loc)
        f2 = bsdf_f(lm.lm2, wo, wi, ng_loc)
        return lm.amt * f1 + (1.0 - lm.amt) * f2
    vals = _lobe_f_all(lm, wo, wi, _refl_ok(wo, wi, ng_loc))
    return _slot_sum(lm, vals, lm.zeros_s())


def bsdf_pdf(lm, wo, wi):
    """Mean of the lobe pdfs (BSDF::Pdf, reflection.cpp:602-612); a mix lane
    averages its two sub-lanes'."""
    if isinstance(lm, MixLane):
        same = (lm.m1 == lm.m2).to(wo.dtype)
        p1 = bsdf_pdf(lm.lm1, wo, wi)
        p2 = bsdf_pdf(lm.lm2, wo, wi)
        return same * p1 + (1.0 - same) * 0.5 * (p1 + p2)
    pdf = _slot_sum(lm, _lobe_pdf_all(lm, wo, wi), torch.zeros_like(wo[:, 0]))
    return pdf / torch.clamp(lm.n_lobes.to(wo.dtype), min=1.0)


def bsdf_sample(lm, wo, u_lobe, u1, u2, ng_loc=None):
    """BSDF::Sample_f (reflection.cpp:531-600): pick a lobe uniformly and
    sample it; a smooth lobe's f and pdf are then taken over all lobes.
    Returns (wi, f (R, S), pdf, is_delta).

    A mix lane picks a sub-material with probability ½ (a lane that is not
    a mix always takes m1), samples it, and blends: smooth f = amt·f1 +
    (1 − amt)·f2 and pdf = ½(pdf1 + pdf2); a delta lobe keeps the chosen
    lane's weight times its blend factor (materials/table.py:523-560)."""
    if isinstance(lm, MixLane):
        same = lm.m1 == lm.m2
        chose1 = same | (u_lobe < 0.5)
        u_re = torch.where(same, u_lobe, torch.where(chose1, u_lobe * 2.0, u_lobe * 2.0 - 1.0))
        wi1, f1s, p1s, d1 = bsdf_sample(lm.lm1, wo, u_re, u1, u2, ng_loc)
        wi2, f2s, p2s, d2 = bsdf_sample(lm.lm2, wo, u_re, u1, u2, ng_loc)
        wi = torch.where(chose1[:, None], wi1, wi2)
        is_delta = torch.where(chose1, d1, d2)
        f_sm = (lm.amt * bsdf_f(lm.lm1, wo, wi, ng_loc)
                + (1.0 - lm.amt) * bsdf_f(lm.lm2, wo, wi, ng_loc))
        p_sm_1 = bsdf_pdf(lm.lm1, wo, wi)
        p_sm_2 = bsdf_pdf(lm.lm2, wo, wi)
        p_sm = torch.where(same, p_sm_1, 0.5 * (p_sm_1 + p_sm_2))
        w_sel = torch.where(same[:, None], 1.0,
                            torch.where(chose1[:, None], lm.amt, 1.0 - lm.amt))
        f_d = w_sel * torch.where(chose1[:, None], f1s, f2s)
        p_d = torch.where(same, 1.0, 0.5) * torch.where(chose1, p1s, p2s)
        return (wi, torch.where(is_delta[:, None], f_d, f_sm),
                torch.where(is_delta, p_d, p_sm), is_delta)
    n = lm.n_lobes.clamp(min=1)
    slot = torch.minimum((u_lobe * n.to(u_lobe.dtype)).to(torch.int64), n - 1)
    lobe = lm.lobe_type.gather(1, slot[:, None])[:, 0].clamp(min=0)
    samples = _lobe_sample_all(lm, wo, u1, u2)
    zero_s = lm.zeros_s()
    wi = _select(lobe, {c: s[0] for c, s in samples.items()}, torch.zeros_like(wo))
    pdf_s = _select(lobe, {c: s[1] for c, s in samples.items()}, torch.zeros_like(u1))
    f_delta = _select(lobe, {c: s[2] for c, s in samples.items() if s[3]}, zero_s)
    is_delta = torch.zeros_like(u1, dtype=torch.bool)
    for code, s in samples.items():
        if s[3]:
            is_delta = is_delta | (lobe == code)
    f_smooth = bsdf_f(lm, wo, wi, ng_loc)
    pdf_smooth = bsdf_pdf(lm, wo, wi)
    f = torch.where(is_delta[:, None], f_delta, f_smooth)
    pdf = torch.where(is_delta, pdf_s / n.to(wo.dtype), pdf_smooth)
    return wi, f, pdf, is_delta


def has_delta_only(lm):
    """True where every active lobe is specular (NEE skips those lanes)."""
    if isinstance(lm, MixLane):
        return has_delta_only(lm.lm1) & has_delta_only(lm.lm2)
    all_delta = torch.ones_like(lm.n_lobes, dtype=torch.bool)
    for slot in range(MAX_LOBES):
        active = slot < lm.n_lobes
        lobe = lm.lobe_type[:, slot]
        is_d = torch.zeros_like(active)
        for code in DELTA_LOBES:
            if code in lm.active_lobes:
                is_d = is_d | (lobe == code)
        all_delta = all_delta & (is_d | ~active)
    return all_delta


# ---------------------------------------------------------------------------
# Host-side table construction (materials/table.py:615-888)
# ---------------------------------------------------------------------------


def _load_measured(fn, config):
    """(kind of pool, data) of a measured file: ("irreg", (points,
    spectra)) for ``.brdf``, ("merl", rgb) otherwise."""
    if fn.lower().endswith(".brdf"):
        return "irreg", meas.load_irreg_brdf(fn, config)
    return "merl", meas.load_merl(fn)


def build_material_table(records, config, device, mix_rows=None,
                         texture_index=None) -> MaterialTable:
    """Material records (scene/api.py) → table rows. ``mix_rows`` maps the
    row of each ``mix`` record to its (namedmaterial1, namedmaterial2) rows
    (the builder resolves them; ``scene/builder.py``); ``texture_index``
    maps (data type, name) to texture rows (``textures/texture.py``)."""
    S = config.n_bins
    M = max(len(records), 1)
    mix_rows = mix_rows or {}
    z = lambda: np.zeros((M, S), np.float32)
    kind = np.zeros(M, np.int64)
    n_lobes = np.zeros(M, np.int64)
    lobe_type = np.full((M, MAX_LOBES), -1, np.int64)
    kd, ks, kr, kt = z(), z(), z(), z()
    sigma = np.zeros(M, np.float32)
    exp_u = np.ones(M, np.float32)
    exp_v = np.ones(M, np.float32)
    eta = np.full(M, 1.5, np.float32)
    eta_spec = np.ones((M, S), np.float32)
    k_spec = np.zeros((M, S), np.float32)
    irreg_offset = np.zeros(M, np.int64)
    irreg_count = np.zeros(M, np.int64)
    merl_offset = np.full(M, -1, np.int64)
    ss_sigma_a, ss_sigma_s = z(), z()
    ss_scale = np.ones(M, np.float32)
    mix_m1 = np.arange(M, dtype=np.int64)
    mix_m2 = np.arange(M, dtype=np.int64)
    mix_amt = np.ones((M, S), np.float32)
    irreg_pts_pool = [np.zeros((1, 3), np.float32)]
    irreg_spec_pool = [np.zeros((1, S), np.float32)]
    merl_pool = [np.zeros((1, 3), np.float32)]
    tex = {k: np.full(M, -1, np.int64) for k in TEXTURE_COLUMNS}
    rough_exp = lambda r: 1.0 / max(r, 1e-4)

    def tex_id(p, pname, data_type="spectrum"):
        tname = p.find_texture(pname)
        if texture_index is None or tname is None:
            return -1
        return texture_index.get((data_type, tname), -1)

    for i, rec in enumerate(records):
        p = rec.params
        mt = rec.mat_type
        lobes = []
        # materials/table.py:663-667: only these four bind a texture
        tex["kd_tex"][i] = tex_id(p, "Kd")
        tex["ks_tex"][i] = tex_id(p, "Ks")
        tex["bump_tex"][i] = tex_id(p, "bumpmap", "float")
        tex["normal_tex"][i] = tex_id(p, "normalmap")
        kd_bound, ks_bound = tex["kd_tex"][i] >= 0, tex["ks_tex"][i] >= 0
        if mt == "matte":
            kind[i] = MATTE
            kd[i] = p.find_one_spectrum("Kd", 0.5)
            sigma[i] = p.find_one_float("sigma", 0.0)
            lobes.append(L_ORENNAYAR if sigma[i] != 0.0 else L_LAMBERT)
        elif mt == "plastic":
            kind[i] = PLASTIC
            kd[i] = p.find_one_spectrum("Kd", 0.25)
            ks[i] = p.find_one_spectrum("Ks", 0.25)
            exp_u[i] = exp_v[i] = rough_exp(p.find_one_float("roughness", 0.1))
            eta[i] = 1.5
            if kd[i].any() or kd_bound:
                lobes.append(L_LAMBERT)
            if ks[i].any() or ks_bound:
                lobes.append(L_BLINN_DIEL)
        elif mt == "glass":
            kind[i] = GLASS
            kr[i] = p.find_one_spectrum("Kr", 1.0)
            kt[i] = p.find_one_spectrum("Kt", 1.0)
            eta[i] = p.find_one_float("index", 1.5)
            if kr[i].any():
                lobes.append(L_SPEC_REFL_DIEL)
            if kt[i].any():
                lobes.append(L_SPEC_TRANS)
        elif mt == "mirror":
            kind[i] = MIRROR
            kr[i] = p.find_one_spectrum("Kr", 0.9)
            if kr[i].any():
                lobes.append(L_SPEC_REFL_NOOP)
        elif mt == "metal":
            kind[i] = METAL
            ks[i] = 1.0
            eta_spec[i] = p.find_one_spectrum(
                "eta", spec.from_sampled(_COPPER_LAM, _COPPER_N, config))
            k_spec[i] = p.find_one_spectrum(
                "k", spec.from_sampled(_COPPER_LAM, _COPPER_K, config))
            exp_u[i] = exp_v[i] = rough_exp(p.find_one_float("roughness", 0.01))
            lobes.append(L_BLINN_COND)
        elif mt == "shinymetal":
            kind[i] = SHINYMETAL
            ks_v = p.find_one_spectrum("Ks", 1.0)
            kr[i] = p.find_one_spectrum("Kr", 1.0)
            exp_u[i] = exp_v[i] = rough_exp(p.find_one_float("roughness", 0.1))
            # FresnelApproxEta: η = (1 + √R)/(1 − √R), k = 0 (reflection.h:70);
            # the Fresnel term carries the colour, Ks itself is 1
            sr = np.sqrt(np.clip(ks_v, 0.0, 0.999))
            eta_spec[i] = (1.0 + sr) / (1.0 - sr)
            k_spec[i] = 0.0
            ks[i] = 1.0
            if ks_v.any():
                lobes.append(L_BLINN_COND)
            if kr[i].any():
                lobes.append(L_SPEC_REFL_COND)
        elif mt == "substrate":
            kind[i] = SUBSTRATE
            kd[i] = p.find_one_spectrum("Kd", 0.5)
            ks[i] = p.find_one_spectrum("Ks", 0.5)
            exp_u[i] = rough_exp(p.find_one_float("uroughness", 0.1))
            exp_v[i] = rough_exp(p.find_one_float("vroughness", 0.1))
            lobes.append(L_FRESNEL_BLEND)
        elif mt == "uber":
            kind[i] = UBER
            kd[i] = p.find_one_spectrum("Kd", 0.25)
            ks[i] = p.find_one_spectrum("Ks", 0.25)
            kr[i] = p.find_one_spectrum("Kr", 0.0)
            kt[i] = p.find_one_spectrum("Kt", 0.0)
            exp_u[i] = exp_v[i] = rough_exp(p.find_one_float("roughness", 0.1))
            eta[i] = p.find_one_float("index", 1.5)
            for on, code in ((kd[i].any() or kd_bound, L_LAMBERT),
                             (ks[i].any() or ks_bound, L_BLINN_DIEL),
                             (kr[i].any(), L_SPEC_REFL_DIEL), (kt[i].any(), L_SPEC_TRANS)):
                if on:
                    lobes.append(code)
        elif mt == "translucent":
            kind[i] = TRANSLUCENT
            base_kd = p.find_one_spectrum("Kd", 0.25)
            base_ks = p.find_one_spectrum("Ks", 0.25)
            refl = p.find_one_spectrum("reflect", 0.5)
            trans = p.find_one_spectrum("transmit", 0.5)
            exp_u[i] = exp_v[i] = rough_exp(p.find_one_float("roughness", 0.1))
            kd[i] = base_kd * refl
            ks[i] = base_ks * refl
            kt[i] = base_kd * trans  # diffuse transmission
            kr[i] = base_ks * trans  # glossy transmission (L_BLINN_DIEL_TRANS)
            for field, code in ((kd, L_LAMBERT), (ks, L_BLINN_DIEL),
                                (kt, L_LAMBERT_TRANS), (kr, L_BLINN_DIEL_TRANS)):
                if field[i].any():
                    lobes.append(code)
        elif mt == "anisoward":
            kind[i] = ANISOWARD
            kd[i] = p.find_one_spectrum("Kd", 0.25)
            ks[i] = p.find_one_spectrum("Ks", 0.25)
            exp_u[i] = p.find_one_float("alphaU", 0.1)
            exp_v[i] = p.find_one_float("alphaV", 0.1)
            lobes += [L_LAMBERT, L_WARD]
        elif mt in ("subsurface", "kdsubsurface"):
            # the rows of materials/subsurface.cpp and kdsubsurface.cpp: the
            # medium's σ's (for the dipole integrator, integrators/dipole.py)
            # and the specular reflection lobe
            kind[i] = SUBSURFACE if mt == "subsurface" else KDSUBSURFACE
            eta[i] = p.find_one_float("index", 1.3)
            ss_scale[i] = p.find_one_float("scale", 1.0)
            sa_def, sps_def = _NAMED_MEDIA.get(p.find_one_string("name", ""),
                                               ((0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77)))
            if mt == "kdsubsurface":
                kd_v = p.find_one_spectrum("Kd", 0.5)
                sigt = 1.0 / max(p.find_one_float("meanfreepath", 1.0), 1e-6)
                ss_sigma_s[i] = np.clip(kd_v, 0.0, 0.999) * sigt
                ss_sigma_a[i] = sigt - ss_sigma_s[i]
            else:
                ss_sigma_a[i] = p.find_one_spectrum("sigma_a", np.asarray(sa_def))
                ss_sigma_s[i] = p.find_one_spectrum("sigma_prime_s", np.asarray(sps_def))
            # "scale" multiplies the σ coefficients (subsurface.cpp:64-65)
            ss_sigma_a[i] *= ss_scale[i]
            ss_sigma_s[i] *= ss_scale[i]
            kr[i] = p.find_one_spectrum("Kr", 1.0)
            if kr[i].any():
                lobes.append(L_SPEC_REFL_DIEL)
        elif mt == "measured":
            kind[i] = MEASURED
            fn = p.find_one_filename("filename", "")
            loaded = None
            if fn:
                try:
                    loaded = _load_measured(fn, config)
                except (OSError, ValueError, IndexError) as e:
                    warnings.warn(f"measured BRDF {fn!r}: {e}; matte fallback")
            if loaded is None:
                kd[i] = 0.5
                lobes.append(L_LAMBERT)
            elif loaded[0] == "irreg":
                pts, spectra = loaded[1]
                irreg_offset[i] = sum(len(x) for x in irreg_pts_pool)
                irreg_count[i] = len(pts)
                irreg_pts_pool.append(pts)
                irreg_spec_pool.append(spectra)
                lobes.append(L_IRREG_MEASURED)
            else:
                merl_offset[i] = sum(len(x) for x in merl_pool)
                merl_pool.append(loaded[1])
                lobes.append(L_MERL_MEASURED)
        elif mt == "mix":
            # materials/mix.cpp; the row's own lobe is a placeholder that
            # gather_lane never reads for a resolved mix
            kind[i] = MIXMAT
            mix_m1[i], mix_m2[i] = mix_rows.get(i, (i, i))
            mix_amt[i] = p.find_one_spectrum("amount", 0.5)
            lobes.append(L_LAMBERT)
        else:
            # unknown: matte 0.5, as pbrt warns and falls back (api.cpp:373)
            warnings.warn(f"material {mt!r} is not supported; matte is used")
            kind[i] = MATTE
            kd[i] = p.find_one_spectrum("Kd", 0.5)
            lobes.append(L_LAMBERT)
        if not lobes:
            lobes.append(L_LAMBERT)
        n_lobes[i] = len(lobes)
        lobe_type[i, : len(lobes)] = lobes

    active = tuple(sorted({int(c) for c in lobe_type.ravel() if c >= 0})) or (L_LAMBERT,)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    return MaterialTable(
        kind=t(kind), n_lobes=t(n_lobes), lobe_type=t(lobe_type), kd=t(kd), ks=t(ks),
        kr=t(kr), kt=t(kt), sigma=t(sigma), exp_u=t(exp_u), exp_v=t(exp_v), eta=t(eta),
        eta_spec=t(eta_spec), k_spec=t(k_spec), irreg_offset=t(irreg_offset),
        irreg_count=t(irreg_count), merl_offset=t(merl_offset),
        irreg_points=t(np.concatenate(irreg_pts_pool)),
        irreg_spectra=t(np.concatenate(irreg_spec_pool)),
        merl_rgb=t(np.concatenate(merl_pool)), ss_sigma_a=t(ss_sigma_a),
        ss_sigma_s=t(ss_sigma_s), ss_scale=t(ss_scale), mix_m1=t(mix_m1),
        mix_m2=t(mix_m2), mix_amt=t(mix_amt), **{k: t(v) for k, v in tex.items()},
        active_lobes=active,
        max_lobes=int(max(n_lobes.max(), 1)), has_mix=bool((kind == MIXMAT).any()),
    )
