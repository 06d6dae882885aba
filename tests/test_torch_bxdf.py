"""Parity of the port's lobe functions (``pbrt_torch/bsdf/bxdf.py``) with the
JAX package's (``pbrt_tpu/bsdf/bxdf.py``) on the same seeded inputs: both
hemispheres, grazing angles (|cos θ| down to 1e-4), total internal
reflection, and anisotropic exponents from 1 up to 1/1e-4.

Tolerances: f, pdf and Fresnel terms ``allclose`` rtol 1e-4, atol 1e-6;
directions atol 1e-6; masks equal. The JAX functions run eagerly, op by
op, so no multiply-add is contracted on its side; but XLA's sin, cos,
atan2, log and pow round differently from libm's in 5–17% of inputs (by
one ulp), and a sampled half vector carries that into the reflected
direction and, through e^{−tan²θ/α²} or cos^e θ, into its pdf. So for the
two half-vector samplers the tolerances hold on ≥ 99.5% of lanes and the
directions within 1e-5 on all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.bsdf import bxdf as jbx
from pbrt_torch.bsdf import bxdf as tbx

R = 4096
S = 8
F_TOL = dict(rtol=1e-4, atol=1e-6)
DIR_TOL = dict(rtol=0.0, atol=1e-6)


def _dirs(rng, n=R):
    """Unit directions over the sphere; an eighth of them grazing."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    g = rng.random(n) < 0.125
    z = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-4, -2, n)
    xy = w[:, :2] / np.linalg.norm(w[:, :2], axis=1, keepdims=True)
    w[g] = np.concatenate([xy * np.sqrt(1 - z * z)[:, None], z[:, None]], 1)[g]
    return w.astype(np.float32)


def _lanes_close(t, j, **tol):
    c = np.isclose(t, j, **tol)
    return c.all(-1) if c.ndim == 2 else c


def _assert_sample_close(wj, pj, wt, pt):
    """A half-vector sampler's (wi, pdf): the stated tolerances on ≥ 99.5%
    of lanes, directions within 1e-5 everywhere."""
    ok = _lanes_close(wt, wj, **DIR_TOL) & _lanes_close(pt, pj, **F_TOL)
    assert ok.mean() >= 0.995, np.nonzero(~ok)[0]
    np.testing.assert_allclose(wt, wj, rtol=0.0, atol=1e-5)


def _both(fn_j, fn_t, *args):
    """Call both packages' function on the same numpy arguments."""
    rj = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    rt = fn_t(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args))
    if not isinstance(rj, tuple):
        rj, rt = (rj,), (rt,)
    return [np.asarray(a) for a in rj], [b.numpy() for b in rt]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20)
    return dict(
        wo=_dirs(rng), wi=_dirs(rng),
        u1=rng.random(R, dtype=np.float32), u2=rng.random(R, dtype=np.float32),
        ex=(10.0 ** rng.uniform(0, 4, R)).astype(np.float32),
        ey=(10.0 ** rng.uniform(0, 4, R)).astype(np.float32),
        alpha_x=rng.uniform(0.02, 0.6, R).astype(np.float32),
        alpha_y=rng.uniform(0.02, 0.6, R).astype(np.float32),
        spec_a=rng.uniform(0, 1, (R, S)).astype(np.float32),
        spec_b=rng.uniform(0, 1, (R, S)).astype(np.float32),
        eta=rng.uniform(0.2, 3.0, (R, S)).astype(np.float32),
        k=rng.uniform(0.0, 5.0, (R, S)).astype(np.float32),
        sigma=rng.uniform(0, 60, R).astype(np.float32),
        ior=rng.uniform(1.05, 2.5, R).astype(np.float32),
        cos=rng.uniform(-1, 1, R).astype(np.float32),
    )


def test_sin_theta2_and_fresnel_terms_match_jax(inputs):
    a = inputs
    for fj, ft, args in (
            (jbx.sin_theta2, tbx.sin_theta2, (a["wo"],)),
            (jbx.fresnel_conductor, tbx.fresnel_conductor, (a["cos"], a["eta"], a["k"])),
            (jbx.schlick_fresnel, tbx.schlick_fresnel, (a["spec_a"], a["cos"]))):
        (j,), (t,) = _both(fj, ft, *args)
        np.testing.assert_allclose(t, j, **F_TOL, err_msg=fj.__name__)
    # conductor Fresnel lies in [0, 1] for these η, k
    (t,) = _both(jbx.fresnel_conductor, tbx.fresnel_conductor, a["cos"], a["eta"], a["k"])[1]
    assert (t >= 0).all() and (t <= 1 + 1e-6).all()


def test_oren_nayar_matches_jax(inputs):
    a = inputs
    (j,), (t,) = _both(jbx.oren_nayar_f, tbx.oren_nayar_f, a["spec_a"], a["sigma"],
                       a["wo"], a["wi"])
    np.testing.assert_allclose(t, j, **F_TOL)
    # σ = 0 is Lambertian
    (t0,) = _both(jbx.oren_nayar_f, tbx.oren_nayar_f, a["spec_a"],
                  np.zeros(R, np.float32), a["wo"], a["wi"])[1]
    np.testing.assert_allclose(t0, a["spec_a"] / np.pi, rtol=1e-6)


def test_anisotropic_distribution_matches_jax(inputs):
    """D, its pdf and its half-vector sampling at exponents 1 to 1e4."""
    a = inputs
    wh = (a["wo"] + a["wi"]) / np.linalg.norm(a["wo"] + a["wi"], axis=1, keepdims=True)
    (j,), (t,) = _both(jbx.aniso_d, tbx.aniso_d, a["ex"], a["ey"], wh.astype(np.float32))
    np.testing.assert_allclose(t, j, **F_TOL)
    (j,), (t,) = _both(jbx.aniso_pdf, tbx.aniso_pdf, a["ex"], a["ey"], a["wo"], a["wi"])
    np.testing.assert_allclose(t, j, **F_TOL)
    (wj, pj), (wt, pt) = _both(jbx.aniso_sample_wh, tbx.aniso_sample_wh, a["ex"], a["ey"],
                               a["wo"], a["u1"], a["u2"])
    _assert_sample_close(wj, pj, wt, pt)
    assert (pt > 0).mean() > 0.5


def test_fresnel_blend_matches_jax(inputs):
    a = inputs
    (j,), (t,) = _both(jbx.fresnel_blend_f, tbx.fresnel_blend_f, a["spec_a"], a["spec_b"],
                       a["ex"], a["ey"], a["wo"], a["wi"])
    np.testing.assert_allclose(t, j, **F_TOL)
    assert np.isfinite(t).all() and (t > 0).any()


def test_ward_matches_jax(inputs):
    a = inputs
    (j,), (t,) = _both(jbx.ward_f, tbx.ward_f, a["spec_a"], a["alpha_x"], a["alpha_y"],
                       a["wo"], a["wi"])
    np.testing.assert_allclose(t, j, **F_TOL)
    (j,), (t,) = _both(jbx.ward_pdf, tbx.ward_pdf, a["alpha_x"], a["alpha_y"],
                       a["wo"], a["wi"])
    np.testing.assert_allclose(t, j, **F_TOL)
    (wj, pj), (wt, pt) = _both(jbx.ward_sample, tbx.ward_sample, a["alpha_x"], a["alpha_y"],
                               a["wo"], a["u1"], a["u2"])
    _assert_sample_close(wj, pj, wt, pt)


def test_specular_transmission_matches_jax(inputs):
    """Refraction from both sides; from inside (cos θ < 0) past the
    critical angle the direction is invalid (total internal reflection),
    where the dielectric Fresnel term is 1."""
    a = inputs
    (wj, vj, ej), (wt, vt, et) = _both(jbx.specular_transmit_dir, tbx.specular_transmit_dir,
                                       a["wo"], 1.0, a["ior"])
    np.testing.assert_allclose(wt, wj, **DIR_TOL)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(et, ej, rtol=1e-6)
    tir = ~vt
    assert tir.sum() > 100 and (a["wo"][tir, 2] < 0).all()
    assert (np.sign(wt[vt, 2]) == -np.sign(a["wo"][vt, 2])).all()
    (fj,), (ft,) = _both(jbx.fresnel_dielectric, tbx.fresnel_dielectric,
                         a["wo"][:, 2].copy(), 1.0, a["ior"])
    np.testing.assert_allclose(ft, fj, **F_TOL)
    np.testing.assert_array_equal(ft[tir], 1.0)
