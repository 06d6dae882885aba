"""Parity of the port's film and sample waves with the JAX package:
``add_samples`` (the one-tap sorted path and the general filter path),
the ``.dat`` writer and reader, the lowdiscrepancy camera sample, a
whole ``render_wave`` with an explicit primary-sample array against the
JAX pieces composed the same way (camera rays → ``trace_radiance(...,
uniforms=u)`` → NaN/negative clamp → ``add_samples``), and whole
``render(seed)`` calls of both packages, keyed by threefry from the seed."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import sampling as jsmp
from pbrt_tpu.core.filters import make_filter as j_make_filter
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators.path import PrimarySource as JPS
from pbrt_tpu.integrators.path import trace_radiance as j_trace
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild
from pbrt_torch.core.filters import make_filter as t_make_filter
from pbrt_torch.core.sampling import camera_uniforms
from pbrt_torch.film import film as tfilm
from pbrt_torch.interop import scene_from_numpy
from pbrt_torch.renderers.sampler import render, render_wave
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import jax_scene_arrays, tiny_scene_text

N = 16


def _samples(seed, R=600, W=N, H=N):
    rng = np.random.default_rng(seed)
    xi = np.sort(rng.integers(0, W * H, R))
    pix_y, pix_x = np.divmod(xi, W)
    px = (pix_x + rng.random(R)).astype(np.float32)
    py = (pix_y + rng.random(R)).astype(np.float32)
    L = rng.uniform(0, 2, (R, 32)).astype(np.float32)
    depth = rng.uniform(0, 10, R).astype(np.float32)
    scale = (rng.random(R) < 0.9).astype(np.float32)
    return pix_x.astype(np.int32), pix_y.astype(np.int32), px, py, L, depth, scale


@pytest.mark.parametrize("kind", ["box", "triangle", "gaussian"])
def test_add_samples_matches_jax(kind):
    """Pixels, weights and depth sums; rtol 1e-6 (a sample's taps are
    summed in the same order; only the scatter's association differs)."""
    pix_x, pix_y, px, py, L, depth, scale = _samples(1)
    jcfg = jfilm.FilmConfig(xres=N, yres=N, filter=j_make_filter(kind))
    tcfg = tfilm.FilmConfig(xres=N, yres=N, filter=t_make_filter(kind))
    table = jcfg.filter.table()
    np.testing.assert_array_equal(tcfg.filter.table(), table)
    js = jfilm.add_samples(jfilm.init_film(jcfg), jcfg, jnp.asarray(px), jnp.asarray(py),
                           jnp.asarray(L), jnp.asarray(depth), jnp.asarray(table),
                           sample_scale=jnp.asarray(scale), sorted_pixels=True,
                           pixel_ids=(jnp.asarray(pix_x), jnp.asarray(pix_y)))
    ts = tfilm.add_samples(tfilm.init_film(tcfg, "cpu"), tcfg, torch.as_tensor(px),
                           torch.as_tensor(py), torch.as_tensor(L),
                           torch.as_tensor(depth), torch.as_tensor(table),
                           sample_scale=torch.as_tensor(scale),
                           pixel_ids=(torch.as_tensor(pix_x), torch.as_tensor(pix_y)))
    for k in ("pixels", "weight", "depth"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert float(ts.weight.sum()) > 0


def test_dat_round_trip_across_packages(tmp_path):
    """A port .dat reads back in the JAX reader and vice versa, exactly."""
    pix_x, pix_y, px, py, L, depth, _ = _samples(2)
    cfg = tfilm.FilmConfig(xres=N, yres=12, fov=45.0)
    st = tfilm.init_film(cfg, "cpu")
    st = tfilm.add_samples(st, cfg, torch.as_tensor(px), torch.as_tensor(py % 12),
                           torch.as_tensor(L), torch.as_tensor(depth),
                           torch.ones(16, 16), pixel_ids=(torch.as_tensor(pix_x),
                                                          torch.as_tensor(pix_y % 12)))
    p = tfilm.write_dat(st, cfg, str(tmp_path / "port.dat"))
    data, hdr = jfilm.read_dat(p)
    np.testing.assert_array_equal(data, st.pixels.double().numpy())
    assert hdr["fov"] == 45.0
    jcfg = jfilm.FilmConfig(xres=N, yres=12, fov=45.0)
    js = jfilm.FilmState(pixels=jnp.asarray(st.pixels.numpy()),
                         weight=jnp.zeros((12, N)), splat=jnp.zeros((12, N, 32)),
                         depth=jnp.zeros((12, N)))
    q = jfilm.write_dat(js, jcfg, str(tmp_path / "jax.dat"))
    assert open(p, "rb").read() == open(q, "rb").read()
    back, _ = tfilm.read_dat(q)
    np.testing.assert_array_equal(back, data)


def test_camera_uniforms_match_sample02():
    """The port's camera sample n from six scramble words equals the JAX
    (0,2)-sequence calls of sampler.py:39-43 bit for bit."""
    scr = np.random.default_rng(3).integers(0, 1 << 32, (300, 6), dtype=np.uint64)
    for n in (0, 3, 17):
        out = camera_uniforms(n, torch.as_tensor(scr.astype(np.int64))).numpy()
        s32 = jnp.asarray(scr.astype(np.uint32))
        img = np.asarray(jsmp.sample02(np.uint32(n), s32[:, 0:2]))
        lens = np.asarray(jsmp.sample02(np.uint32(n), s32[:, 2:4]))
        tim = np.asarray(jsmp.van_der_corput(np.uint32(n), s32[:, 4]))
        ref = np.concatenate([img, lens, tim[:, None]], -1)
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    """One wave of the tiny scene (16×16, depth 4) in both packages from
    the same primary-sample array."""
    jb = jbuild(jload(tiny_scene_text(N, N)))
    scene, camera, film_cfg = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    rng = np.random.default_rng(4)
    u = rng.random((N * N, JPS.n_dims(4)), dtype=np.float32)
    ys, xs = np.divmod(np.arange(N * N, dtype=np.int32), N)
    # JAX pieces, composed as sampler.render_wave does
    px = jnp.asarray(xs, jnp.float32) + u[:, 0]
    py = jnp.asarray(ys, jnp.float32) + u[:, 1]
    rays = jb.camera.generate_rays(px, py, jnp.asarray(u[:, 2]), jnp.asarray(u[:, 3]),
                                   jnp.asarray(u[:, 4]))
    icfg = dataclasses.replace(jb.integrator, max_depth=4)
    L, first_t = j_trace(jb.scene, rays, None, icfg, uniforms=jnp.asarray(u))
    L = jnp.where(jnp.isnan(L) | (L < 0.0) | jnp.isinf(L), 0.0, L)
    js = jfilm.add_samples(jfilm.init_film(jb.film_config), jb.film_config, px, py, L,
                           first_t, jnp.asarray(jb.filter_table), sorted_pixels=True,
                           pixel_ids=(jnp.asarray(xs), jnp.asarray(ys)))
    # the port's wave
    from pbrt_torch.integrators.path import IntegratorConfig

    ts = tfilm.init_film(film_cfg, "cpu")
    render_wave(ts, scene, camera, torch.as_tensor(jb.filter_table),
                torch.as_tensor(xs), torch.as_tensor(ys), IntegratorConfig(max_depth=4),
                film_cfg, torch.as_tensor(u))
    d = tmp_path_factory.mktemp("dat")
    pj = jfilm.write_dat(js, jb.film_config, str(d / "jax.dat"))
    pt = tfilm.write_dat(ts, dataclasses.replace(
        film_cfg, focal_length=jb.film_config.focal_length, f_stop=jb.film_config.f_stop,
        fov=jb.film_config.fov), str(d / "port.dat"))
    return js, ts, pj, pt


def test_render_wave_matches_jax(waves):
    """Film pixels allclose (rtol 1e-4, atol 1e-6) on ≥ 99% of pixels,
    per-bin film sums within 1e-3 relative; weights and depths rtol 1e-5."""
    js, ts, _, _ = waves
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (N, N, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)
    np.testing.assert_allclose(ts.depth.numpy(), np.asarray(js.depth), rtol=1e-5)


def test_render_wave_dat_files_match(waves):
    """The two .dat files: identical headers, float planes as above."""
    _, _, pj, pt = waves
    a, b = open(pj, "rb").read(), open(pt, "rb").read()
    assert a.split(b"\n", 2)[:2] == b.split(b"\n", 2)[:2]
    dj, _ = jfilm.read_dat(pj)
    dt, _ = tfilm.read_dat(pt)
    assert np.isclose(dt, dj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99


def test_render_end_to_end_cpu():
    """The port's render() on its own build: finite, non-empty, repeatable
    for a seed, different for another seed."""
    b = tbuild(tload(tiny_scene_text(8, 8)), device="cpu")
    f0 = render(b, spp=2, seed=0, chunk_pixels=40)
    f1 = render(b, spp=2, seed=0, chunk_pixels=40)
    f2 = render(b, spp=2, seed=1, chunk_pixels=40)
    assert torch.isfinite(f0.pixels).all() and float(f0.pixels.sum()) > 0
    assert torch.equal(f0.pixels, f1.pixels)
    assert not torch.equal(f0.pixels, f2.pixels)
    np.testing.assert_allclose(f0.weight.numpy(), 2.0)  # box filter, 2 spp
    assert os.path.basename(b.film_config.filename) == "pbrt.dat"


@pytest.fixture(scope="module")
def seeded():
    """The 8×8 tiny scene rendered by both packages' ``render`` (2 spp,
    seed 0, 40-pixel chunks: the last chunk is padded) and by the port at
    64-pixel chunks (one chunk)."""
    text = tiny_scene_text(8, 8)
    jf = j_render(jbuild(jload(text)), spp=2, seed=0, chunk_pixels=40, verbose=False)
    b = tbuild(tload(text), device="cpu")
    return (jf, render(b, spp=2, seed=0, chunk_pixels=40),
            render(b, spp=2, seed=0, chunk_pixels=64))


def test_render_seed_matches_jax(seeded):
    """The same seed gives the JAX package's image: film pixels allclose
    (rtol 1e-4, atol 1e-6) on ≥ 99% of pixels, per-bin film sums within
    1e-3 relative, weights and depths rtol 1e-5 (the tolerance of
    test_render_wave_matches_jax)."""
    js, ts, _ = seeded
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert pt.shape == (8, 8, 32) and np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)
    np.testing.assert_allclose(ts.depth.numpy(), np.asarray(js.depth), rtol=1e-5)


def test_render_independent_of_chunking(seeded):
    """Keys come from (pixel, sample), not from a lane's place in a chunk."""
    _, t40, t64 = seeded
    for k in ("pixels", "weight", "depth"):
        assert torch.equal(getattr(t40, k), getattr(t64, k)), k
