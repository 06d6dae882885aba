"""Differentiable rendering: gradients of the traced radiance with respect
to the material spectra, the light emission and the texture table (port
of ``pbrt_tpu/integrators/grad.py``; the reference renderer has none).

The estimator is the JAX package's *detached sampling*: ``intersect``
detaches its ray (intersect.py:1346), so visibility, the traversal kernels
and every decision taken from a hit carry no gradient, and
``torch.autograd`` differentiates the integrand: shading, lights,
textures and the path's products. Fields the build derives from these
parameters stay as they were built, as in the JAX package: the light
table's ``power_dist`` (from ``emit``) and the preprocess products
(photons, VPLs, the dipole's irradiance, PRT transfer, probes). The
port's material table has no packed copy of its spectra, so
``replace_material_spectra`` is a ``dataclasses.replace``.

Every function takes the port's keyed arrays in place of keys,
``(scene, rays, uniforms, cfg, loss_fn=None, chunk=None, media=None,
draws=None)``: ``uniforms`` is ``trace_radiance``'s
(``renderers/sampler.py:wave_uniforms`` or ``key_uniforms``), ``media``
the media block of a scene with volumes (``media_uniforms``) and
``draws`` the integrator's (``integrator_draws``: ``igi``,
``irradiancecache``, the PRT kinds), drawn from the same keys as the JAX
functions' ``keys`` (grad.py:37-42). So every scene the forward pass
renders has its gradient. ``loss_fn`` maps the radiance (R, S) to a scalar
(default: its mean). ``chunk`` splits the R lanes into chunks of that many
and keeps one chunk's autograd graph at a time, exactly for any
``loss_fn``: pass 1 traces every chunk without a graph into the whole
radiance, the loss and its gradient ∂loss/∂L are taken on that, and pass
2 traces each chunk again with the parameters as leaves and pulls
∂loss/∂L's rows back through it (a vector-Jacobian product per chunk,
summed). Pass 2's radiance equals pass 1's bit for bit (the same
uniforms, kernels and ops). With one chunk (the default) it is one pass.
Each chunk takes its rows of ``uniforms``, ``media`` and ``draws``; the
irradiance cache's fill draws, one row per ``ic_stride`` lanes, are cut
by ``irradiance.draw_rows``, so under ``irradiancecache`` a chunk is a
multiple of the stride (each chunk is a cache of its own, as each wave
chunk is in a render).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pbrt_torch.core import geometry as geom
from pbrt_torch.integrators import irradiance
from pbrt_torch.integrators.path import IntegratorConfig, RenderScene, trace_radiance

#: the material table's spectra a gradient replaces; the table derives
#: none of its other fields from them (materials/table.py)
MATERIAL_SPECTRA = ("kd", "ks", "kr", "kt")


def replace_material_spectra(materials, **fields):
    """The material table with ``fields`` (of ``MATERIAL_SPECTRA``)
    replaced. Its ``tex_rows`` is derived from the texture columns only, and
    no other field from the spectra, so nothing goes stale."""
    bad = set(fields) - set(MATERIAL_SPECTRA)
    if bad:
        raise ValueError(f"replace_material_spectra: {sorted(bad)} are not spectra the "
                         f"material table lets a gradient replace ({MATERIAL_SPECTRA})")
    for name, value in fields.items():
        if value.shape != getattr(materials, name).shape:
            raise ValueError(f"replace_material_spectra: {name} has shape "
                             f"{tuple(value.shape)}, the table's is "
                             f"{tuple(getattr(materials, name).shape)}")
    return dataclasses.replace(materials, **fields)


def _with_params(scene: RenderScene, params: dict) -> RenderScene:
    """``scene`` with the leaves in ``params`` (material spectra, ``emit``,
    ``pool_rgb``, ``c1``) in place."""
    mats = {k: v for k, v in params.items() if k in MATERIAL_SPECTRA}
    tex = {k: v for k, v in params.items() if k in ("pool_rgb", "c1")}
    out = {}
    if mats:
        out["materials"] = replace_material_spectra(scene.materials, **mats)
    if "emit" in params:
        # power_dist stays as built from the original emit, as in the JAX package
        out["lights"] = dataclasses.replace(scene.lights, emit=params["emit"])
    if tex:
        out["textures"] = dataclasses.replace(scene.textures, **tex)
    return dataclasses.replace(scene, **out)


def _ray_rows(rays: geom.Ray, a: int, b: int) -> geom.Ray:
    wl = rays.wavelength
    return geom.Ray(rays.origin[a:b], rays.direction[a:b], rays.tmin[a:b], rays.tmax[a:b],
                    rays.time[a:b], wl[a:b] if torch.is_tensor(wl) else wl)


def _draw_rows(draws, cfg, R: int, a: int, b: int):
    """Lanes [a, b) of an R-lane wave's integrator draws."""
    if draws is None:
        return None
    if cfg.kind == "irradiancecache":
        return irradiance.draw_rows(draws, cfg, R, a, b)
    return {k: v[a:b] for k, v in draws.items()}


def _traced(scene, rays, uniforms, cfg, media, draws, a: int, b: int):
    """The radiance of lanes [a, b), each keyed array cut to them."""
    R = rays.origin.shape[0]
    return trace_radiance(scene, _ray_rows(rays, a, b), cfg, uniforms[a:b],
                          media=None if media is None else media[a:b],
                          draws=_draw_rows(draws, cfg, R, a, b))[0]


def _loss(L, loss_fn):
    return L.mean() if loss_fn is None else loss_fn(L)


def _value_and_grad(scene: RenderScene, rays, uniforms, cfg: IntegratorConfig,
                    params: dict, loss_fn=None, chunk=None, media=None, draws=None):
    """(loss, {name: ∂loss/∂param}) for the leaves ``params`` (name →
    the scene's current tensor), chunked as the module docstring says."""
    R = rays.origin.shape[0]
    chunk = R if chunk is None else max(1, int(chunk))
    spans = [(a, min(a + chunk, R)) for a in range(0, R, chunk)]
    names = list(params)

    def traced(a, b, leaves):
        s = _with_params(scene, dict(zip(names, leaves)))
        return _traced(s, rays, uniforms, cfg, media, draws, a, b)

    def leaves():
        return [params[k].detach().requires_grad_() for k in names]

    def as_dict(gs):
        return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, gs)}

    with torch.enable_grad():
        if len(spans) == 1:
            p = leaves()
            loss = _loss(traced(0, R, p), loss_fn)
            gs = torch.autograd.grad(loss, p, allow_unused=True)
            return loss.detach(), as_dict(gs)
        # pass 1: the whole radiance, no graph; the loss and ∂loss/∂L on it
        with torch.no_grad():
            L = torch.cat([traced(a, b, [params[k] for k in names]) for a, b in spans])
        L.requires_grad_()
        loss = _loss(L, loss_fn)
        (dL,) = torch.autograd.grad(loss, L)
        # pass 2: each chunk's graph alone, its rows of ∂loss/∂L pulled back
        total = [torch.zeros_like(params[k]) for k in names]
        for a, b in spans:
            p = leaves()
            gs = torch.autograd.grad(traced(a, b, p), p, grad_outputs=dL[a:b],
                                     allow_unused=True)
            for t, g in zip(total, gs):
                if g is not None:
                    t += g
    return loss.detach(), dict(zip(names, total))


def radiance_loss(scene: RenderScene, rays, uniforms, cfg: IntegratorConfig,
                  loss_fn: Callable = None, chunk=None, media=None, draws=None):
    """The scalar loss of the traced radiance (default: its mean), with
    autograd's graph where a scene tensor requires grad (every chunk's at
    once: the gradient functions below keep one)."""
    R = rays.origin.shape[0]
    chunk = R if chunk is None else max(1, int(chunk))
    L = torch.cat([_traced(scene, rays, uniforms, cfg, media, draws, a, min(a + chunk, R))
                   for a in range(0, R, chunk)])
    return _loss(L, loss_fn)


def grad_wrt_materials(scene: RenderScene, rays, uniforms, cfg, loss_fn=None, chunk=None,
                       media=None, draws=None):
    """∂loss/∂(kd, ks, kr, kt) of the material table: a dict of tensors
    shaped as the table's spectra."""
    m = scene.materials
    return _value_and_grad(scene, rays, uniforms, cfg, {k: getattr(m, k) for k in MATERIAL_SPECTRA},
                           loss_fn, chunk, media, draws)[1]


def grad_wrt_emission(scene: RenderScene, rays, uniforms, cfg, loss_fn=None, chunk=None,
                      media=None, draws=None):
    """∂loss/∂(the light table's ``emit``), (L, S); the light-selection
    ``power_dist`` stays as built."""
    return _value_and_grad(scene, rays, uniforms, cfg, {"emit": scene.lights.emit},
                           loss_fn, chunk, media, draws)[1]["emit"]


def grad_wrt_textures(scene: RenderScene, rays, uniforms, cfg, loss_fn=None, chunk=None,
                      media=None, draws=None):
    """∂loss/∂(the texture table): the image texels' RGB pool (every mip
    level's rows) and the constant spectra ``c1``, through the filtered
    lookups and the RGB-to-spectrum reconstruction."""
    tt = scene.textures
    return _value_and_grad(scene, rays, uniforms, cfg, {"pool_rgb": tt.pool_rgb, "c1": tt.c1},
                           loss_fn, chunk, media, draws)[1]


def value_and_grads(scene: RenderScene, rays, uniforms, cfg, loss_fn=None, chunk=None,
                    media=None, draws=None):
    """(loss, {"kd": ∂loss/∂kd, "emit": ∂loss/∂emit}) from one backward
    pass per chunk."""
    return _value_and_grad(scene, rays, uniforms, cfg,
                           {"kd": scene.materials.kd, "emit": scene.lights.emit}, loss_fn, chunk,
                           media, draws)
