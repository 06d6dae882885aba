"""Vectors and rays as (..., 3) tensors (port of ``pbrt_tpu/core/geometry.py``).

A batch of rays is one dataclass of tensors (``Ray``); every helper works
on the trailing axis and broadcasts over leading ones (reference:
src/core/geometry.h).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def dot(a, b):
    return (a * b).sum(-1)


def absdot(a, b):
    return dot(a, b).abs()


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1
    )


def length_sq(v):
    return (v * v).sum(-1)


class _Sqrt0(torch.autograd.Function):
    """``torch.sqrt`` whose gradient at 0 is 0: autograd's is inf there, and
    a lane that a ``where`` or a clamp masks out then sends 0 · inf = NaN
    back (a zero footprint axis, a zero cross product)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0.0, g * 0.5 / y, 0.0)


def length(v):
    """|v| over the last axis; where it is 0 its gradient is 0, not NaN
    (the forward is ``torch.sqrt``'s, bit for bit)."""
    sq = length_sq(v)
    return _Sqrt0.apply(sq) if sq.requires_grad else torch.sqrt(sq)


def normalize(v, eps: float = 1e-20):
    """v/|v|; zero vectors stay zero."""
    return v / torch.clamp(length(v), min=eps)[..., None]


def face_forward(n, v):
    """Flip n into the hemisphere of v (reference: geometry.h:502)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v):
    """Orthonormal (t, b) around unit v, branch-free (Duff et al. 2017),
    as the JAX package builds it."""
    s = torch.where(v[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    t1 = torch.stack(
        [1.0 + s * v[..., 0] * v[..., 0] * a, s * b, -s * v[..., 0]], -1
    )
    t2 = torch.stack([b, s + v[..., 1] * v[..., 1] * a, -v[..., 1]], -1)
    return t1, t2


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], -1
    )


def spherical_direction_basis(sin_theta, cos_theta, phi, x, y, z):
    return ((sin_theta * torch.cos(phi))[..., None] * x
            + (sin_theta * torch.sin(phi))[..., None] * y
            + cos_theta[..., None] * z)


def phi_of(x, y):
    """atan2 mapped to [0, 2π)."""
    p = torch.atan2(y, x)
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


@dataclasses.dataclass
class Ray:
    """A batch of rays: origin/direction (R, 3); tmin/tmax/time (R,).

    ``wavelength`` (nm) is the fork's per-ray wavelength, 0 for a ray that
    carries the whole spectrum (geometry.h:317; the JAX package's
    ``Ray.wavelength``): an (R,) tensor where a lens camera sets it, else
    the number 0.0, which costs no launch on the card."""

    origin: torch.Tensor
    direction: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    time: torch.Tensor
    wavelength: torch.Tensor | float = 0.0

    @staticmethod
    def make(origin, direction, tmin=None, tmax=None, time=None,
             wavelength=None) -> "Ray":
        batch = origin.shape[:-1]

        def fill(x, default):
            if x is None:
                return torch.full(batch, default, dtype=origin.dtype,
                                  device=origin.device)
            return torch.as_tensor(x, dtype=origin.dtype,
                                   device=origin.device).expand(batch)

        return Ray(origin=origin, direction=direction.expand(origin.shape),
                   tmin=fill(tmin, 0.0), tmax=fill(tmax, math.inf),
                   time=fill(time, 0.0),
                   wavelength=0.0 if wavelength is None else fill(wavelength, 0.0))

    def at(self, t):
        return self.origin + t[..., None] * self.direction
