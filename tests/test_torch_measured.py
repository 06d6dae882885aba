"""Parity of the port's measured BRDFs (``pbrt_torch/bsdf/measured.py``)
with the JAX package's (``pbrt_tpu/bsdf/measured.py``), on a generated
``.brdf`` file of 2,000 scattered spectral samples (more than the 1,500
kept, so the even subsample is exercised) and a generated MERL table,
both written by ``chip_smoke.write_material_data`` into a temporary
directory.

The loaders give the same pools; the evaluations run on the JAX package's
pools, with lanes of no measured material (count 0) among them, the JAX
side eagerly (under ``jit`` its first call would build and cache its
spectral tables inside the trace).

Tolerances: lookup points rtol 1e-6, atol 1e-7 (the remap's atan2 in XLA
and in libm), spectra and MERL values equal; f ``allclose`` rtol 1e-4,
atol 1e-6 on ≥ 99.9% of lanes: a lane whose sample distance or half-angle
index sits within an ulp of a radius or a bin edge may take the
neighbouring one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.bsdf import measured as jms
from pbrt_tpu.config import DEFAULT_SPECTRAL as J_CFG
from pbrt_torch.bsdf import measured as tms
from pbrt_torch.config import DEFAULT_SPECTRAL as T_CFG

R = 4096
F_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("measured")
    chip_smoke.write_material_data(str(d))
    return str(d / "generated.brdf"), str(d / "generated.merl")


def _dirs(rng, n, upper=0.8):
    """Unit directions, a share ``upper`` of them above the surface."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    up = rng.random(n) < upper
    w[:, 2] = np.where(up, np.abs(w[:, 2]), w[:, 2])
    return w.astype(np.float32)


def test_loaders_match_jax(files):
    brdf, merl = files
    pj, sj = jms.load_irreg_brdf(brdf, J_CFG)
    pt, st = tms.load_irreg_brdf(brdf, T_CFG)
    assert pt.shape == (tms.MAX_IRREG_SAMPLES, 3) and st.shape == (tms.MAX_IRREG_SAMPLES, 32)
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(tms.load_merl(merl), jms.load_merl(merl))
    rng = np.random.default_rng(1)
    wo, wi = _dirs(rng, R), _dirs(rng, R)
    np.testing.assert_allclose(tms.brdf_remap(torch.as_tensor(wo), torch.as_tensor(wi)).numpy(),
                               np.asarray(jms.brdf_remap(jnp.asarray(wo), jnp.asarray(wi))),
                               rtol=1e-6, atol=1e-6)


def _lanes_close(t, j):
    return np.isclose(t, j, **F_TOL).all(-1)


def test_irregular_brdf_matches_jax(files):
    """A pool of a pad row and the file's samples; lanes on the file's rows
    and lanes with none."""
    pts, spectra = jms.load_irreg_brdf(files[0], J_CFG)
    pts = np.concatenate([np.zeros((1, 3), np.float32), pts])
    spectra = np.concatenate([np.zeros((1, 32), np.float32), spectra])
    rng = np.random.default_rng(2)
    wo, wi = _dirs(rng, R), _dirs(rng, R)
    has = rng.random(R) < 0.9
    off = np.where(has, 1, 0).astype(np.int32)
    cnt = np.where(has, len(pts) - 1, 0).astype(np.int32)
    fj = np.asarray(jax.vmap(jms.irreg_f_one, in_axes=(None, None, 0, 0, 0, 0))(
        jnp.asarray(pts), jnp.asarray(spectra), jnp.asarray(off), jnp.asarray(cnt),
        jnp.asarray(wo), jnp.asarray(wi)))
    ft = tms.irreg_f(torch.as_tensor(pts), torch.as_tensor(spectra), torch.as_tensor(off, dtype=torch.int64),
                     torch.as_tensor(cnt, dtype=torch.int64), torch.as_tensor(wo),
                     torch.as_tensor(wi)).numpy()
    assert _lanes_close(ft, fj).mean() >= 0.999
    assert (ft[~has] == 0).all() and (ft[has] > 0).any(-1).mean() > 0.9


def test_merl_brdf_matches_jax(files):
    table = np.concatenate([np.zeros((1, 3), np.float32), jms.load_merl(files[1])])
    rng = np.random.default_rng(3)
    wo, wi = _dirs(rng, R), _dirs(rng, R)
    off = np.ones(R, np.int32)
    fj = np.asarray(jax.vmap(jms.merl_f_one, in_axes=(None, 0, 0, 0, None))(
        jnp.asarray(table), jnp.asarray(off), jnp.asarray(wo), jnp.asarray(wi), None))
    ft = tms.merl_f(torch.as_tensor(table), torch.as_tensor(off, dtype=torch.int64),
                    torch.as_tensor(wo), torch.as_tensor(wi)).numpy()
    assert _lanes_close(ft, fj).mean() >= 0.999
    assert np.isfinite(ft).all() and ft.max() > 10 * np.median(ft)  # the θh peak
