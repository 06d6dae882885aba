"""Parity of the port's ``directlighting`` integrator with the JAX package,
ray by ray and through whole ``render(seed)`` calls.

``directlighting`` continues only along delta lobes, and shoots each
non-delta BSDF sample once as a gather-only lane that collects Le with MIS
on the next segment (EstimateDirect's BSDF half). On the tiny scene those
lanes reach the small light rarely, so the ray-by-ray test uses a variant
whose light has radius 2, and checks that the BSDF half adds light on at
least 10 of its 256 lanes against ``whitted`` (which has no such half).

Tolerances as test_torch_path.py: per-lane L allclose (rtol 1e-4, atol
1e-6) on ≥ 99% of lanes (float order may flip a grazing decision), per-bin
means within 1e-3 relative, first-hit t rtol 1e-5; the films of
``render(seed)`` likewise per pixel, weights and depths rtol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core.geometry import Ray as TRay
from pbrt_torch.integrators.path import IntegratorConfig
from pbrt_torch.integrators.path import trace_radiance as t_trace
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, tiny_scene_text

N = 16


def _direct_text(n, spp=2):
    return tiny_scene_text(n, n, spp).replace(
        'SurfaceIntegrator "path" "integer maxdepth" [4]', 'SurfaceIntegrator "directlighting"')


def _close(Lt, Lj):
    assert np.isfinite(Lt).all() and Lt.sum() > 0
    assert np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    mj, mt = Lj.mean((0, 1) if Lj.ndim == 3 else 0), Lt.mean((0, 1) if Lt.ndim == 3 else 0)
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()


def test_directlighting_matches_jax():
    text = _direct_text(N).replace('"float radius" [.6]', '"float radius" [2]')
    jb = jbuild(jload(text))
    assert jb.integrator.kind == "directlighting" and jb.integrator.max_depth == 5
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(6)
    u = rng.random((N * N, JPS.n_dims(5)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N), N)
    px, py = (xs + u[:, 0]).astype(np.float32), (ys + u[:, 1]).astype(np.float32)
    jr = jb.camera.generate_rays(*(jnp.asarray(a) for a in (px, py, u[:, 2], u[:, 3], u[:, 4])))
    tr = TRay.make(torch.as_tensor(np.asarray(jr.origin)),
                   torch.as_tensor(np.asarray(jr.direction)))
    Lj, fj = j_trace(jb.scene, jr, None, dataclasses.replace(jb.integrator, n_bins=32),
                     uniforms=jnp.asarray(u))
    cfg = tbuild(tload(text), device="cpu").integrator
    Lt, ft = t_trace(scene, tr, cfg, torch.as_tensor(u))
    _close(Lt.numpy(), np.asarray(Lj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
    # the BSDF half (gather lanes) adds light where whitted has none
    Lw, _ = t_trace(scene, tr, dataclasses.replace(cfg, kind="whitted"), torch.as_tensor(u))
    gained = int((Lt.sum(-1) > 1.0001 * Lw.sum(-1)).sum())
    assert gained >= 10, gained  # 11 of 256 lanes (radius .6: ~0.7% of lanes)


@pytest.fixture(scope="module")
def seeded():
    """The 8×8 tiny scene with ``directlighting`` rendered by both
    packages' ``render`` (2 spp, seed 0, 40-pixel chunks: the last chunk is
    padded)."""
    text = _direct_text(8)
    jf = j_render(jbuild(jload(text)), spp=2, seed=0, chunk_pixels=40, verbose=False)
    return jf, render(tbuild(tload(text), device="cpu"), spp=2, seed=0, chunk_pixels=40)


def test_render_seed_matches_jax(seeded):
    js, ts = seeded
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (8, 8, 32)
    _close(pt, pj)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)
    np.testing.assert_allclose(ts.depth.numpy(), np.asarray(js.depth), rtol=1e-5)
