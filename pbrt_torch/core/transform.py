"""Transforms: host-side 4x4 constructors (float64 numpy) and their
application to device tensors. Port of ``pbrt_tpu/core/transform.py``
(reference: src/core/transform.{h,cpp}).

``AnimatedTransform`` (transform.h:291-319, transform.cpp:478-600): two
keyframes decomposed on the host into translation, rotation quaternion
and scale (``decompose``, numpy, in the JAX package's operation order),
interpolated per ray on the device (translation and scale lerped, the
rotation slerped along the shorter arc). A static pair returns its single
keyframe and runs no per-ray math.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(delta) -> np.ndarray:
    m = identity()
    m[:3, 3] = delta
    return m


def scale(sx, sy, sz) -> np.ndarray:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def rotate(deg, axis) -> np.ndarray:
    """Rotation about an arbitrary axis (reference: transform.cpp:180-210)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.deg2rad(deg))
    c = np.cos(np.deg2rad(deg))
    m = identity()
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return m


def look_at(eye, look, up) -> np.ndarray:
    """Camera-to-world (reference: transform.cpp:212-242)."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    nl = np.linalg.norm(left)
    if nl < 1e-12:
        # up parallel to the view direction: any orthogonal up (the
        # reference raises here, transform.cpp:230)
        alt = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        left = np.cross(alt, d)
        nl = np.linalg.norm(left)
    left /= nl
    new_up = np.cross(d, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def perspective(fov_deg, znear, zfar) -> np.ndarray:
    """Projective camera matrix (reference: transform.cpp:395-409)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return scale(inv_tan, inv_tan, 1.0) @ persp


def orthographic(znear, zfar) -> np.ndarray:
    """Orthographic camera matrix (orthographic.cpp Orthographic())."""
    return scale(1.0, 1.0, 1.0 / (zfar - znear)) @ translate((0.0, 0.0, -znear))


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m)


def swaps_handedness(m: np.ndarray) -> bool:
    """det of the upper 3x3 < 0 (reference: transform.h:241-249)."""
    return bool(np.linalg.det(np.asarray(m)[:3, :3]) < 0.0)


def apply_bbox(m: np.ndarray, lo, hi):
    """Transform an AABB by its 8 corners and rebound (host)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    pts = np.array([[x, y, z] for x in (lo[0], hi[0])
                    for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    tp = pts @ np.asarray(m)[:3, :3].T + np.asarray(m)[:3, 3]
    return tp.min(axis=0), tp.max(axis=0)


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4, 4) m, or per-point (..., 4, 4), on points (..., 3), with the
    homogeneous divide."""
    if m.dim() == 2:
        r = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
    else:
        r = torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]
        w = torch.einsum("...j,...j->...", m[..., 3, :3], p) + m[..., 3, 3]
    return r / w[..., None]


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if m.dim() == 2:
        return v @ m[:3, :3].T
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


# ---------------------------------------------------------------------------
# quaternions, (w, x, y, z) order
# ---------------------------------------------------------------------------


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (quaternion.cpp:63-107); host."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0.0:
        s = np.sqrt(tr + 1.0)
        w = s / 2.0
        s = 0.5 / s
        return np.array(
            [w, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s]
        )
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - (m[j, j] + m[k, k]) + 1.0, 0.0))
    q = np.zeros(4)
    q[1 + i] = s * 0.5
    if s != 0.0:
        s = 0.5 / s
    q[0] = (m[k, j] - m[j, k]) * s
    q[1 + j] = (m[j, i] + m[i, j]) * s
    q[1 + k] = (m[k, i] + m[i, k]) * s
    return q


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) → rotation matrices (..., 4, 4)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    m = torch.zeros(q.shape[:-1] + (4, 4), dtype=q.dtype, device=q.device)
    m[..., :3, :3] = r
    m[..., 3, 3] = 1.0
    return m


def slerp(t: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Spherical linear interpolation (quaternion.cpp:47-60) of (4,) q0, q1
    at weights t (R,) → (R, 4); normalized lerp where they nearly agree."""
    cos_theta = torch.sum(q0 * q1, -1)
    q1 = torch.where(cos_theta < 0.0, -q1, q1)  # the shorter arc
    cos_theta = cos_theta.abs()
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    safe_sin = torch.where(sin_theta < 1e-6, 1.0, sin_theta)
    w0 = torch.sin((1.0 - t) * theta) / safe_sin
    w1 = torch.sin(t * theta) / safe_sin
    q_slerp = w0[..., None] * q0 + w1[..., None] * q1
    q = q0 + t[..., None] * (q1 - q0)
    q_lerp = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(cos_theta > 0.9995, q_lerp, q_slerp)


def decompose(m: np.ndarray):
    """M → (T, R quaternion, S) by the polar decomposition's iteration
    (AnimatedTransform::Decompose, transform.cpp:496-538); host."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M3 = m[:3, :3].copy()
    R = M3.copy()
    for _ in range(100):
        Rnext = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(Rnext - R).max() < 1e-7:
            R = Rnext
            break
        R = Rnext
    S = np.linalg.inv(R) @ M3
    Rm = identity()
    Rm[:3, :3] = R
    return T, quat_from_matrix(Rm), S


@dataclasses.dataclass
class AnimatedTransform:
    """Two keyframes as translation (2, 3), rotation quaternions (2, 4)
    and scale matrices (2, 3, 3), float32, with their times and the full
    keyframe matrices. ``is_static``: identical keyframes, so
    ``interpolate`` returns ``m_start`` and runs no per-ray math."""

    T: np.ndarray
    R: np.ndarray
    S: np.ndarray
    times: np.ndarray  # (2,)
    m_start: np.ndarray  # (4, 4) f32
    m_end: np.ndarray
    is_static: bool

    @staticmethod
    def from_matrices(m0, m1, t0: float, t1: float) -> "AnimatedTransform":
        T0, R0, S0 = decompose(m0)
        T1, R1, S1 = decompose(m1)
        if np.dot(R0, R1) < 0.0:  # the shorter rotation arc (transform.cpp:489-493)
            R1 = -R1
        f32 = lambda a: np.asarray(a, np.float32)
        return AnimatedTransform(
            T=f32(np.stack([T0, T1])), R=f32(np.stack([R0, R1])), S=f32(np.stack([S0, S1])),
            times=f32([t0, t1]), m_start=f32(m0), m_end=f32(m1),
            is_static=bool(np.allclose(m0, m1, atol=1e-12)))

    def interpolate(self, time: torch.Tensor) -> torch.Tensor:
        """time (R,) → (R, 4, 4) on its device; a static transform gives
        its (4, 4) keyframe."""
        t = lambda a: torch.as_tensor(a, device=time.device)
        if self.is_static:
            return t(self.m_start)
        t0, t1 = float(self.times[0]), float(self.times[1])
        span = np.float32(max(np.float32(t1) - np.float32(t0), np.float32(1e-20)))
        dt = torch.clamp((time - t0) / float(span), 0.0, 1.0)
        Tk, Sk = t(self.T), t(self.S)
        trans = (1.0 - dt)[..., None] * Tk[0] + dt[..., None] * Tk[1]
        rot = slerp(dt, t(self.R[0]), t(self.R[1]))
        sc = (1.0 - dt)[..., None, None] * Sk[0] + dt[..., None, None] * Sk[1]
        m3 = quat_to_matrix(rot)[..., :3, :3] @ sc
        out = torch.zeros(dt.shape + (4, 4), dtype=m3.dtype, device=time.device)
        out[..., :3, :3] = m3
        out[..., :3, 3] = trans
        out[..., 3, 3] = 1.0
        return out
