"""BxDF lobes in the local shading frame (ns = +z), batched over lanes.

Port of ``pbrt_tpu/bsdf/bxdf.py`` (reference: src/core/reflection.{h,cpp}):
Lambertian (:345) and Oren–Nayar (:359), Torrance–Sparrow microfacet
(:389) with the Blinn (:414) and anisotropic Ashikhmin–Shirley (:430)
distributions, FresnelBlend (:453), the dielectric and conductor Fresnel
terms (:261-296), the fork's Ward BRDF (materials/AnisoWardBrdf.cpp), the
specular reflection and transmission directions, and the shading-frame
helpers. Each function follows the JAX package's operation order; integer
powers are written as its ``integer_pow`` multiplies them.
"""

from __future__ import annotations

import math

import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.core import sampling as smp

INV_PI = 1.0 / math.pi


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def sin_theta2(w):
    return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)


def _pow5(x):
    """x**5 as XLA's integer_pow forms it: x · ((x·x)·(x·x))."""
    x2 = x * x
    return x * (x2 * x2)


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def make_shading_frame(ns, dpdu):
    """Orthonormal (ss, ts) with ss seeded from dpdu (reflection.h:149-153)."""
    tang = dpdu - geom.dot(dpdu, ns)[..., None] * ns
    ss = geom.normalize(tang)
    degenerate = geom.length_sq(tang) < 1e-12
    alt_s, _ = geom.coordinate_system(ns)
    ss = torch.where(degenerate[..., None], alt_s, ss)
    return ss, geom.cross(ns, ss)


def world_to_local(w, ss, ts, ns):
    return torch.stack([geom.dot(w, ss), geom.dot(w, ts), geom.dot(w, ns)], -1)


def local_to_world(w, ss, ts, ns):
    return w[..., 0:1] * ss + w[..., 1:2] * ts + w[..., 2:3] * ns


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; cos_i signed (negative = exiting)."""
    cos_i = cos_i.clamp(-1.0, 1.0)
    entering = cos_i > 0.0
    eta_t = torch.as_tensor(eta_t, dtype=cos_i.dtype, device=cos_i.device)
    eta_i = torch.as_tensor(eta_i, dtype=cos_i.dtype, device=cos_i.device)
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = cos_i.abs()
    sin_t2 = (ei / et) ** 2 * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin_t2 >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    r_per = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel (reflection.cpp FrCond); eta, k (R, S), cos_i (R,)
    → (R, S)."""
    ci = cos_i.abs()[..., None]
    tmp = (eta * eta + k * k) * ci * ci
    r_par2 = (tmp - 2.0 * eta * ci + 1.0) / torch.clamp(tmp + 2.0 * eta * ci + 1.0, min=1e-12)
    tmp_f = eta * eta + k * k
    r_perp2 = (tmp_f - 2.0 * eta * ci + ci * ci) / torch.clamp(
        tmp_f + 2.0 * eta * ci + ci * ci, min=1e-12)
    return 0.5 * (r_par2 + r_perp2)


def schlick_fresnel(rs, cos_i):
    """(FresnelBlend::SchlickFresnel, reflection.h:462-466)."""
    c = torch.clamp(1.0 - cos_i, 0.0, 1.0)[..., None]
    return rs + _pow5(c) * (1.0 - rs)


def lambertian_f(kd):
    return kd * INV_PI


def oren_nayar_f(kd, sigma_deg, wo, wi):
    """(reflection.cpp OrenNayar::f); sigma in degrees, per lane."""
    sigma = sigma_deg * (math.pi / 180.0)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_ti = torch.sqrt(sin_theta2(wi))
    sin_to = torch.sqrt(sin_theta2(wo))
    # max(0, cos(φi − φo)) = cosφi·cosφo + sinφi·sinφo
    safe_i = torch.clamp(sin_ti, min=1e-6)
    safe_o = torch.clamp(sin_to, min=1e-6)
    cos_phi = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / (safe_i * safe_o)
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          torch.clamp(cos_phi, min=0.0), 0.0)
    aci = abs_cos_theta(wi)
    aco = abs_cos_theta(wo)
    sin_a = torch.where(aci > aco, sin_to, sin_ti)
    tan_b = torch.where(aci > aco, sin_ti / torch.clamp(aci, min=1e-6),
                        sin_to / torch.clamp(aco, min=1e-6))
    scale = A + B * max_cos * sin_a * tan_b
    return kd * INV_PI * scale[..., None]


def cosine_sample(u1, u2, wo):
    """Cosine hemisphere flipped to wo's side (reflection.cpp:39-49)."""
    wi = smp.cosine_sample_hemisphere(u1, u2)
    flip = torch.sign(wo[..., 2]) + (wo[..., 2] == 0.0).to(wo.dtype)
    wi = torch.cat([wi[..., :2], (wi[..., 2] * flip)[..., None]], -1)
    pdf = torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)
    return wi, pdf


def cosine_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


def blinn_d(exponent, wh):
    return (exponent + 2.0) * (0.5 * INV_PI) * torch.pow(
        torch.clamp(abs_cos_theta(wh), min=1e-8), exponent
    )


def _microfacet_g(wo, wi, wh):
    ndoth = abs_cos_theta(wh)
    ndoto = abs_cos_theta(wo)
    ndoti = abs_cos_theta(wi)
    wodoth = torch.clamp(geom.absdot(wo, wh), min=1e-8)
    return torch.clamp(torch.minimum(2.0 * ndoth * ndoto / wodoth,
                                     2.0 * ndoth * ndoti / wodoth), max=1.0)


def microfacet_f(ks, fresnel_val, exponent, wo, wi):
    """Torrance–Sparrow (Microfacet::f, reflection.cpp:318-333),
    hemisphere-agnostic like the reference."""
    wh = geom.normalize(wo + wi)
    coso = abs_cos_theta(wo)
    cosi = abs_cos_theta(wi)
    d = blinn_d(exponent, wh)
    g = _microfacet_g(wo, wi, wh)
    denom = torch.clamp(4.0 * coso * cosi, min=1e-8)
    f = ks * fresnel_val * (d * g / denom)[..., None]
    ok = (coso > 1e-8) & (cosi > 1e-8)
    return torch.where(ok[..., None], f, 0.0)


def blinn_sample_wh(exponent, wo, u1, u2):
    """Half vector ∝ D (Blinn::Sample_f, reflection.cpp:617-640)."""
    ct = torch.pow(u1, 1.0 / (exponent + 1.0))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = 2.0 * math.pi * u2
    wh = geom.spherical_direction(st, ct, phi)
    wh = torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)
    wi = -wo + 2.0 * geom.dot(wo, wh)[..., None] * wh
    wodoth = geom.dot(wo, wh)
    pdf = (exponent + 1.0) * torch.pow(
        torch.clamp(abs_cos_theta(wh), min=1e-8), exponent
    ) / (2.0 * math.pi * 4.0 * torch.clamp(wodoth, min=1e-8))
    return wi, torch.where(wodoth > 1e-8, pdf, 0.0)


def blinn_pdf(exponent, wo, wi):
    wh = geom.normalize(wo + wi)
    wodoth = geom.dot(wo, wh)
    pdf = (exponent + 1.0) * torch.pow(
        torch.clamp(abs_cos_theta(wh), min=1e-8), exponent
    ) / (2.0 * math.pi * 4.0 * torch.clamp(wodoth, min=1e-8))
    return torch.where(same_hemisphere(wo, wi) & (wodoth > 1e-8), pdf, 0.0)


def specular_reflect_dir(wo):
    """Local-frame mirror direction (-wo.x, -wo.y, wo.z)."""
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)


def specular_transmit_dir(wo, eta_i, eta_t):
    """Local-frame refraction (SpecularTransmission::Sample_f,
    reflection.cpp:464-500) → (wi, valid (False on total internal
    reflection), ηi/ηt)."""
    entering = cos_theta(wo) > 0.0
    eta_t = torch.as_tensor(eta_t, dtype=wo.dtype, device=wo.device)
    ei = torch.where(entering, torch.as_tensor(eta_i, dtype=wo.dtype, device=wo.device), eta_t)
    et = torch.where(entering, eta_t, torch.as_tensor(eta_i, dtype=wo.dtype, device=wo.device))
    sini2 = sin_theta2(wo)
    eta = ei / et
    sint2 = eta * eta * sini2
    cost = torch.sqrt(torch.clamp(1.0 - sint2, min=0.0))
    cost = torch.where(entering, -cost, cost)
    wi = torch.stack([eta * -wo[..., 0], eta * -wo[..., 1], cost], -1)
    return wi, sint2 < 1.0, eta


def _reflect_about(wo, wh):
    """wh flipped to wo's side, and wo mirrored about it."""
    wh = torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)
    return -wo + 2.0 * geom.dot(wo, wh)[..., None] * wh


def aniso_d(ex, ey, wh):
    """Ashikhmin–Shirley anisotropic distribution (reflection.h:430)."""
    costh = abs_cos_theta(wh)
    d = 1.0 - costh * costh
    safe_d = torch.clamp(d, min=1e-8)
    e = (ex * wh[..., 0] * wh[..., 0] + ey * wh[..., 1] * wh[..., 1]) / safe_d
    return torch.sqrt((ex + 2.0) * (ey + 2.0)) * (0.5 * INV_PI) * torch.pow(
        torch.clamp(costh, min=1e-8), e)


def aniso_sample_wh(ex, ey, wo, u1, u2):
    """(Anisotropic::Sample_f, reflection.cpp:645-700): first-quadrant
    sampling remapped to the quadrant u1 falls in → (wi, pdf)."""
    quad = torch.floor(u1 * 4.0).to(torch.int32)
    u1r = u1 * 4.0 - quad
    phi0 = torch.atan(torch.sqrt((ex + 1.0) / (ey + 1.0)) * torch.tan(0.5 * math.pi * u1r))
    phi = torch.where(quad == 0, phi0, torch.where(
        quad == 1, math.pi - phi0,
        torch.where(quad == 2, math.pi + phi0, 2.0 * math.pi - phi0)))
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    ct = torch.pow(u2, 1.0 / (ex * cphi * cphi + ey * sphi * sphi + 1.0))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wi = _reflect_about(wo, geom.spherical_direction(st, ct, phi))
    return wi, aniso_pdf(ex, ey, wo, wi)


def aniso_pdf(ex, ey, wo, wi):
    wh = geom.normalize(wo + wi)
    wodoth = geom.dot(wo, wh)
    pdf = aniso_d(ex, ey, wh) / torch.clamp(4.0 * wodoth, min=1e-8)
    return torch.where(same_hemisphere(wo, wi) & (wodoth > 1e-8), pdf, 0.0)


def fresnel_blend_f(rd, rs, ex, ey, wo, wi):
    """FresnelBlend::f (reflection.cpp:224-236), hemisphere-agnostic (the
    BSDF classifies against the geometric normal)."""
    aci = abs_cos_theta(wi)
    aco = abs_cos_theta(wo)
    diffuse = ((28.0 / (23.0 * math.pi)) * rd * (1.0 - rs)
               * ((1.0 - _pow5(1.0 - 0.5 * aci)) * (1.0 - _pow5(1.0 - 0.5 * aco)))[..., None])
    wh = wo + wi
    wh_len = geom.length(wh)
    wh_n = wh / torch.clamp(wh_len, min=1e-12)[..., None]
    d = aniso_d(ex, ey, wh_n)
    widotwh = geom.dot(wi, wh_n)
    spec = (d[..., None]
            / torch.clamp(4.0 * widotwh.abs() * torch.maximum(aci, aco), min=1e-8)[..., None]
            * schlick_fresnel(rs, widotwh))
    return torch.where((wh_len > 1e-9)[..., None], diffuse + spec, 0.0)


def _ward_expo(ax, ay, wh):
    hx, hy, hz = wh[..., 0], wh[..., 1], wh[..., 2]
    hz2 = torch.clamp(hz * hz, min=1e-10)
    return -((hx / ax) ** 2 + (hy / ay) ** 2) / hz2, hz, hz2


def ward_f(ks, ax, ay, wo, wi):
    """The fork's Ward BRDF (materials/AnisoWardBrdf.cpp)."""
    ci = cos_theta(wi)
    co = cos_theta(wo)
    expo, _, _ = _ward_expo(ax, ay, wo + wi)
    denom = 4.0 * math.pi * ax * ay * torch.sqrt(torch.clamp(ci * co, min=1e-8))
    f = ks * (torch.exp(expo) / denom)[..., None]
    return torch.where((ci * co > 1e-8)[..., None], f, 0.0)


def ward_sample(ax, ay, wo, u1, u2):
    """Ward half-vector sampling (Walter 2005) → (wi, pdf)."""
    phi = torch.atan2(ay * torch.sin(2.0 * math.pi * u2), ax * torch.cos(2.0 * math.pi * u2))
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    denom = (cphi / ax) ** 2 + (sphi / ay) ** 2
    tan2 = -torch.log(torch.clamp(u1, min=1e-10)) / torch.clamp(denom, min=1e-10)
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wi = _reflect_about(wo, geom.spherical_direction(st, ct, phi))
    return wi, ward_pdf(ax, ay, wo, wi)


def ward_pdf(ax, ay, wo, wi):
    wh = geom.normalize(wo + wi)
    expo, hz, hz2 = _ward_expo(ax, ay, wh)
    ph = torch.exp(expo) / (math.pi * ax * ay * hz2 * torch.clamp(hz, min=1e-8))
    wodoth = geom.dot(wo, wh)
    pdf = ph / torch.clamp(4.0 * wodoth, min=1e-8)
    return torch.where(same_hemisphere(wo, wi) & (wodoth > 1e-8), pdf, 0.0)
