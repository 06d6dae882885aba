"""Real spherical harmonics (port of ``pbrt_tpu/core/sh.py``; reference:
src/core/sh.{h,cpp}: SHTerms, SHIndex, SHEvaluate).

``sh_evaluate`` gives all (lmax + 1)² basis functions at (..., 3) unit
directions: the associated Legendre P_l^m(z) by the standard recurrence
and cos(mφ), sin(mφ) by the Chebyshev recurrence on (x, y) / sin θ,
unrolled over (l, m) as the JAX package unrolls them, in the same order
of operations. XLA fuses the recurrence's products into FMAs on the CPU,
so the two packages' bases differ by a few ulps at l = 4
(tests/test_torch_sh.py states the tolerance).

``project_directions`` is the Monte Carlo projection 4π/N · Yᵀ V of N
sampled values and ``reconstruct`` its inverse, both a ``torch.matmul``;
``cosine_lobe_coeffs`` the clamped cosine's convolution factors Â_l
(l ≤ 2, zero above), as the probes' irradiance takes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sh_terms(lmax: int) -> int:
    """(lmax + 1)² (SHTerms, sh.h:37)."""
    return (lmax + 1) * (lmax + 1)


def sh_index(l: int, m: int) -> int:
    """The flat index of (l, m) (SHIndex, sh.h:40)."""
    return l * l + l + m


def _K(l: int, m: int) -> float:
    return math.sqrt((2.0 * l + 1.0) * math.factorial(l - abs(m))
                     / (4.0 * math.pi * math.factorial(l + abs(m))))


def sh_evaluate(w, lmax: int):
    """All real SH basis functions at unit directions w (..., 3) →
    (..., sh_terms(lmax)) (sh.py:33-78)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    P = {(0, 0): torch.ones_like(z)}
    if lmax >= 1:
        P[(1, 0)] = z
        P[(1, 1)] = -sin_theta
    for l in range(2, lmax + 1):
        for m in range(0, l - 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                         - (l - 1 + m) * P[(l - 2, m)]) / (l - m)
        P[(l, l - 1)] = (2 * l - 1) * z * P[(l - 1, l - 1)]
        P[(l, l)] = -(2 * l - 1) * sin_theta * P[(l - 1, l - 1)]
    pole = sin_theta < 1e-9
    safe = torch.where(pole, 1.0, sin_theta)
    cos_phi = torch.where(pole, 1.0, x / safe)
    sin_phi = torch.where(pole, 0.0, y / safe)
    cos_m = [torch.ones_like(z), cos_phi]
    sin_m = [torch.zeros_like(z), sin_phi]
    for m in range(2, lmax + 1):
        cos_m.append(2 * cos_phi * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cos_phi * sin_m[-1] - sin_m[-2])
    out = [None] * sh_terms(lmax)
    sqrt2 = math.sqrt(2.0)
    for l in range(lmax + 1):
        out[sh_index(l, 0)] = _K(l, 0) * P[(l, 0)]
        for m in range(1, l + 1):
            out[sh_index(l, m)] = sqrt2 * _K(l, m) * P[(l, m)] * cos_m[m]
            out[sh_index(l, -m)] = sqrt2 * _K(l, m) * P[(l, m)] * sin_m[m]
    return torch.stack(out, dim=-1)


def project_directions(w, values, lmax: int):
    """Monte Carlo projection of sampled values onto SH: w (N, 3)
    uniform-sphere directions, values (N, S) → coefficients (terms, S)."""
    basis = sh_evaluate(w, lmax)
    return basis.T @ values * (4.0 * math.pi / w.shape[0])


def reconstruct(w, coeffs, lmax: int):
    """The SH expansion at directions w: (..., terms) @ coeffs (terms, S)."""
    return sh_evaluate(w, lmax) @ coeffs


def cosine_lobe_coeffs(lmax: int) -> np.ndarray:
    """The clamped cosine's convolution factors per term, Â_l =
    √(4π / (2l + 1)) · A_l / π with A = (π, 2π/3, π/4) for l ≤ 2, zero
    above (sh.py:98-109)."""
    out = np.zeros(sh_terms(lmax))
    A = (math.pi, 2.0 * math.pi / 3.0, math.pi / 4.0)
    for l in range(min(lmax, 2) + 1):
        factor = math.sqrt(4.0 * math.pi / (2.0 * l + 1.0)) * A[l] / math.pi
        for m in range(-l, l + 1):
            out[sh_index(l, m)] = factor
    return out
