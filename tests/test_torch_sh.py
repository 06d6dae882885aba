"""The port's spherical harmonics (``pbrt_torch/core/sh.py``) against the JAX
package's (``pbrt_tpu/core/sh.py``), on the same directions made from a
seed with numpy: poles, the equator and random unit vectors.

Tolerances: the basis and the reconstruction atol 2e-6 (values of order
1: XLA's CPU backend fuses the Legendre recurrence's products into FMAs,
a few ulps at l = 4); the projection rtol 1e-5, atol 1e-6 (a 2,000-term
dot product in float32, summed in each library's order); the terms, the
indices and the cosine lobe's factors exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import sh as jsh
from pbrt_torch.core import sh


def _directions(n=2000, seed=4):
    rs = np.random.default_rng(seed)
    v = rs.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    special = np.float32([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
                          [0.6, 0.8, 0], [0, 1e-5, 1]])
    special /= np.linalg.norm(special, axis=-1, keepdims=True)
    return np.concatenate([special, v]).astype(np.float32)


def test_terms_and_index_match_jax():
    for lmax in range(6):
        assert sh.sh_terms(lmax) == jsh.sh_terms(lmax)
        for l in range(lmax + 1):
            for m in range(-l, l + 1):
                assert sh.sh_index(l, m) == jsh.sh_index(l, m)
                assert sh._K(l, m) == jsh._K(l, m)


@pytest.mark.parametrize("lmax", [0, 1, 2, 4])
def test_sh_evaluate_matches_jax(lmax):
    w = _directions()
    b = sh.sh_evaluate(torch.as_tensor(w), lmax).numpy()
    bj = np.asarray(jsh.sh_evaluate(jnp.asarray(w), lmax))
    assert b.shape == (len(w), (lmax + 1) ** 2)
    np.testing.assert_allclose(b, bj, atol=2e-6)
    # Y_00 is the constant 1 / (2 √π)
    np.testing.assert_allclose(b[:, 0], 0.5 / np.sqrt(np.pi), rtol=1e-6)


def test_project_and_reconstruct_match_jax():
    w = _directions()
    rs = np.random.default_rng(5)
    vals = (np.maximum(w[:, 2:3], 0) * rs.random((1, 32)) + 0.1).astype(np.float32)
    c = sh.project_directions(torch.as_tensor(w), torch.as_tensor(vals), 4)
    cj = np.asarray(jsh.project_directions(jnp.asarray(w), jnp.asarray(vals), 4))
    assert c.shape == (25, 32)
    np.testing.assert_allclose(c.numpy(), cj, rtol=1e-5, atol=1e-6)
    q = _directions(64, seed=6)
    r = sh.reconstruct(torch.as_tensor(q), torch.as_tensor(cj), 4).numpy()
    rj = np.asarray(jsh.reconstruct(jnp.asarray(q), jnp.asarray(cj), 4))
    np.testing.assert_allclose(r, rj, atol=2e-6)


@pytest.mark.parametrize("lmax", [0, 1, 2, 3, 4])
def test_cosine_lobe_coeffs_match_jax(lmax):
    """Â_l for l ≤ 2, zero above."""
    a = sh.cosine_lobe_coeffs(lmax)
    np.testing.assert_array_equal(a, jsh.cosine_lobe_coeffs(lmax))
    n = sh.sh_terms(min(lmax, 2))
    assert np.all(a[:n] > 0) and np.all(a[n:] == 0)
