"""Monte Carlo sampling (port of ``pbrt_tpu/core/sampling.py``, the slices'
subset: Distribution1D/2D, the warps, MIS, the Henyey–Greenstein pdf, the
(0,2)-sequence, the radical inverse and the best-candidate table;
reference: src/core/montecarlo.{h,cpp}).

The (0,2)-sequence bit kernels work on int64 tensors holding uint32 values
(PyTorch has no full set of uint32 ops); every intermediate is masked back
to 32 bits, so the bits equal the reference's uint32 arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from pbrt_torch.core import geometry as geom

ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
UNIFORM_SPHERE_PDF = 1.0 / (4.0 * math.pi)
_M32 = 0xFFFFFFFF
_INV_2_32 = 2.3283064365386963e-10


def _cdf_host(f: np.ndarray):
    """(..., n) float32 values → (normalized (..., n+1) CDF, (...) integral),
    in float32 as the JAX package's ``Distribution1D.build``; an all-zero
    row gets the uniform CDF."""
    n = f.shape[-1]
    cdf = np.cumsum(f, axis=-1, dtype=np.float32) / np.float32(n)
    func_int = cdf[..., -1]
    zero = np.zeros_like(func_int)[..., None]
    safe = np.maximum(func_int, np.float32(1e-20))[..., None]
    cdf_n = np.concatenate([zero, cdf], -1) / safe
    uniform = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    return np.where(func_int[..., None] > 0.0, cdf_n, uniform), func_int


@dataclasses.dataclass
class Distribution1D:
    """Piecewise-constant 1D distribution over [0, 1) (montecarlo.h:46-92):
    ``func`` (n,), normalized ``cdf`` (n+1,), ``func_int``.

    Built once on the host in numpy (float32 sums in a fixed order), then
    moved to the device, so the card and the CPU search the same CDF bits."""

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @staticmethod
    def build(f, device="cpu") -> "Distribution1D":
        f = np.asarray(f, np.float32)
        cdf, func_int = _cdf_host(f)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return Distribution1D(func=t(f), cdf=t(cdf), func_int=t(func_int))

    def _offset(self, u):
        n = self.func.shape[-1]
        off = torch.searchsorted(self.cdf, u.contiguous(), right=True) - 1
        return off.clamp(0, n - 1)

    def sample_continuous(self, u):
        """u (R,) → (x in [0, 1), pdf, offset) (montecarlo.h:58-79)."""
        n = self.func.shape[-1]
        off = self._offset(u)
        c0, c1 = self.cdf[off], self.cdf[off + 1]
        du = (u - c0) / torch.clamp(c1 - c0, min=1e-20)
        fi = torch.clamp(self.func_int, min=1e-20)
        return (off + du) / n, self.func[off] / fi, off

    def sample_discrete(self, u):
        """u (...,) → (index, pmf) (montecarlo.h:81-92)."""
        off = self._offset(u)
        return off, self.discrete_pdf(off)

    def discrete_pdf(self, index):
        fi = torch.clamp(self.func_int, min=1e-20)
        return self.func[index] / (fi * self.func.shape[-1])


@dataclasses.dataclass
class Distribution2D:
    """Product distribution over the unit square (montecarlo.h:134-158):
    conditional CDFs over x per row, a marginal CDF over y; built on the
    host as ``Distribution1D``."""

    func: torch.Tensor  # (ny, nx)
    cond_cdf: torch.Tensor  # (ny, nx+1)
    cond_int: torch.Tensor  # (ny,)
    marg_func: torch.Tensor  # (ny,)
    marg_cdf: torch.Tensor  # (ny+1,)
    marg_int: torch.Tensor  # ()

    @staticmethod
    def build(f, device="cpu") -> "Distribution2D":
        f = np.asarray(f, np.float32)
        cond_cdf, cond_int = _cdf_host(f)
        marg_cdf, marg_int = _cdf_host(cond_int)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return Distribution2D(func=t(f), cond_cdf=t(cond_cdf), cond_int=t(cond_int),
                              marg_func=t(cond_int), marg_cdf=t(marg_cdf),
                              marg_int=t(marg_int))

    def sample_continuous(self, u0, u1):
        """(u0, u1) (R,) → ((u, v), pdf). The row's column is the count of
        its CDF entries ≤ u0, as the JAX package takes it."""
        ny, nx = self.func.shape
        oy = (torch.searchsorted(self.marg_cdf, u1.contiguous(), right=True) - 1).clamp(0, ny - 1)
        c0, c1 = self.marg_cdf[oy], self.marg_cdf[oy + 1]
        dv = (u1 - c0) / torch.clamp(c1 - c0, min=1e-20)
        v = (oy + dv) / ny
        pdf_y = self.marg_func[oy] / torch.clamp(self.marg_int, min=1e-20)
        row_cdf = self.cond_cdf[oy]
        ox = ((row_cdf <= u0[:, None]).sum(-1) - 1).clamp(0, nx - 1)
        r0 = row_cdf.gather(1, ox[:, None])[:, 0]
        r1 = row_cdf.gather(1, (ox + 1)[:, None])[:, 0]
        du = (u0 - r0) / torch.clamp(r1 - r0, min=1e-20)
        u = (ox + du) / nx
        pdf_x = self.func[oy, ox] / torch.clamp(self.cond_int[oy], min=1e-20)
        return (u, v), pdf_x * pdf_y

    def pdf(self, u, v):
        """(montecarlo.cpp Distribution2D::Pdf)."""
        ny, nx = self.func.shape
        iu = (u * nx).to(torch.int64).clamp(0, nx - 1)
        iv = (v * ny).to(torch.int64).clamp(0, ny - 1)
        return self.func[iv, iu] / torch.clamp(self.marg_int, min=1e-20)


def concentric_sample_disk(u1, u2):
    """Shirley–Chiu concentric map, branch-free (montecarlo.cpp:195-240)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    ax, ay = sx.abs(), sy.abs()
    xmaj = ax > ay
    r = torch.where(xmaj, sx, sy).abs()

    def safe(a, b):
        return a / torch.where(b.abs() < 1e-12, torch.ones_like(b), b)

    theta = torch.where(
        xmaj,
        torch.where(sx >= 0, safe(sy, sx), 4.0 + safe(sy, sx)),
        torch.where(sy >= 0, 2.0 - safe(sx, sy), 6.0 - safe(sx, sy)),
    )
    theta = theta * (math.pi / 4.0)
    zero = (sx == 0.0) & (sy == 0.0)
    dx = torch.where(zero, 0.0, r * torch.cos(theta))
    dy = torch.where(zero, 0.0, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2):
    x, y = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], -1)


def uniform_sample_hemisphere(u1, u2):
    z = u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def uniform_sample_triangle(u1, u2):
    """Barycentric (b0, b1) of a uniform point (montecarlo.cpp:242-247)."""
    su1 = torch.sqrt(u1)
    return 1.0 - su1, u2 * su1


def uniform_sample_cone(u1, u2, cos_theta_max):
    """(montecarlo.cpp:260-268)."""
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return geom.spherical_direction(sin_theta, cos_theta, 2.0 * math.pi * u2)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_theta_max, min=1e-9))


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """β=2 power heuristic (montecarlo.h:254-258)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def hg_pdf(cos_theta, g):
    """Henyey–Greenstein phase function value, its own pdf (montecarlo.h
    PhaseHG; sampling.py:235-238)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi * denom * torch.sqrt(torch.clamp(denom, min=1e-12)))


def reverse_bits32(n: torch.Tensor) -> torch.Tensor:
    """Bit reversal of uint32 values held in int64."""
    n = n & _M32
    n = ((n << 16) | (n >> 16)) & _M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    # uint32 → float32 rounds to nearest; 2**-32 is exact in float32, so the
    # product (with the Python scalar taken as float32) is exact
    return torch.clamp(bits.to(torch.float32) * _INV_2_32, max=ONE_MINUS_EPS)


def van_der_corput(n: torch.Tensor, scramble: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse with XOR scramble (montecarlo.h:201-210)."""
    return _bits_to_unit(reverse_bits32(n) ^ (scramble & _M32))


def sobol2(n: torch.Tensor, scramble: torch.Tensor) -> torch.Tensor:
    """Second Sobol' dimension (montecarlo.h:212-222), 32 unrolled steps."""
    n, result = torch.broadcast_tensors(n & _M32, scramble & _M32)
    result = result.clone()
    v = 1 << 31
    for i in range(32):
        take = ((n >> i) & 1).bool()
        result = torch.where(take, result ^ v, result)
        v = v ^ (v >> 1)
    return _bits_to_unit(result)


def sample02(n: torch.Tensor, scramble2: torch.Tensor) -> torch.Tensor:
    """(0,2)-sequence sample n with two scramble words (..., 2) → (..., 2)."""
    return torch.stack([van_der_corput(n, scramble2[..., 0]),
                        sobol2(n, scramble2[..., 1])], -1)


def camera_uniforms(sample_idx: int, scrambles: torch.Tensor) -> torch.Tensor:
    """(R, 5) lowdiscrepancy camera sample n of each pixel from its (R, 6)
    scramble words: image (0,2) pair, lens (0,2) pair, van der Corput time
    (pbrt_tpu/renderers/sampler.py:41-48)."""
    n = torch.full(scrambles.shape[:1], int(sample_idx), dtype=torch.int64,
                   device=scrambles.device)
    img = sample02(n, scrambles[:, 0:2])
    lens = sample02(n, scrambles[:, 2:4])
    tim = van_der_corput(n, scrambles[:, 4])
    return torch.cat([img, lens, tim[:, None]], -1)


#: the Halton sampler's bases: image (2, 3), lens (5, 7), time (11)
HALTON_BASES = (2, 3, 5, 7, 11)


def radical_inverse(n: int, base: int) -> np.float32:
    """Radical inverse of sample ``n`` (uint32) in ``base``, on the host in
    float32 step for step as the JAX package's (sampling.py:308-324): a
    fixed ⌈32 / log2(base)⌉ digits, each ``val + d · inv_bi`` rounded
    (XLA's CPU backend may fuse it into an FMA: the two can differ by an
    ulp), capped below 1."""
    n = int(n) & _M32
    f = np.float32
    inv_base = f(1.0 / base)
    val, inv_bi = f(0.0), inv_base
    for _ in range(max(1, int(math.ceil(32.0 / math.log2(base))))):
        val = f(val + f(n % base) * inv_bi)
        n //= base
        inv_bi = f(inv_bi * inv_base)
    return min(val, f(ONE_MINUS_EPS))


@functools.lru_cache(maxsize=16)
def best_candidate_table(n: int, seed: int = 0) -> np.ndarray:
    """(n, 2) float32 points of Mitchell's best-candidate dart throwing
    under the toroidal metric, numpy's ``default_rng(seed)``, cached per
    sample count: the JAX package's table bit for bit (sampling.py:340-360;
    reference: samplers/bestcandidate.cpp:40-120 reads a table made offline
    by tools/samplepat.cpp)."""
    rng = np.random.default_rng(seed)
    pts = np.empty((max(n, 1), 2))
    pts[0] = rng.uniform(0, 1, 2)
    for i in range(1, n):
        k = min(20 * i, 512)
        cands = rng.uniform(0, 1, (k, 2))
        d = np.abs(pts[None, :i, :] - cands[:, None, :])
        d = np.minimum(d, 1.0 - d)
        pts[i] = cands[np.argmax((d * d).sum(-1).min(1))]
    return pts.astype(np.float32)
