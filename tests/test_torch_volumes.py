"""The port's participating media (``pbrt_torch/media/volumes.py``) against
the JAX package's (``pbrt_tpu/media/volumes.py``), and the closed forms of
``tests/test_volumes.py`` on the port.

Both packages build the same scene; the volume tables are compared field
by field, then ``sigma_t`` per kind (one region each: homogeneous,
exponential, volumegrid, water) and ``tau``, ``transmittance``,
``integrate_emission`` and ``integrate_single_scattering`` on a table of
all four kinds, on 1,024 rays. The JAX march functions run as written,
their 32 steps eagerly, with the pieces each step calls (``sigma_t``,
``sigma_s_at``, ``emission_at``, ``sample_li``, the shadow traversal)
compiled once each: compiled whole, the 32 unrolled steps of four regions
take XLA minutes. The port's media block feeds its jitters and step
uniforms (``rng.volume_uniforms_plain``); the JAX side derives them from
the same keys. Then ``render(seed)`` of a fog scene under the emission
integrator, compiled whole.

Tolerances: tables exact (float32 from the same float64 parse; the
inverse transform within 1e-6); σt rtol 1e-5 (the world-to-volume
transform and the exponential's height are summed in another order, and
XLA may fuse them into FMAs: a point an ulp from a face or a grid cell
boundary can land on the other side, so up to 0.2% of points may differ
more); τ, Tr and Lv rtol 1e-4, atol 1e-6 on ≥ 99.5% of rays (the same
points, summed over 32 steps); the render as ``tests/test_torch_film.py``'s
(pixels rtol 1e-4, atol 1e-6 on ≥ 99%, per-bin sums within 1e-3).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.integrators.path as jpath
import pbrt_tpu.lights.table as jlights

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.media import volumes as jvol
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild

from pbrt_torch.core import rng as trng
from pbrt_torch.interop import integrator_from_numpy, scene_from_numpy, volumes_from_numpy
from pbrt_torch.media import volumes as tvol
from pbrt_torch.renderers.sampler import render
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import (fog_scene_text, jax_integrator_pieces, jax_scene_arrays,
                               write_absorption_curve)

N_RAYS = 1024
KINDS = ("homogeneous", "exponential", "volumegrid", "water")


def region(kind, curve=""):
    """One region of ``kind``, each placed by its own transform."""
    if kind == "homogeneous":
        return ('AttributeBegin Rotate 30 0 1 1 Volume "homogeneous" "point p0" [-2 -2 -2] '
                '"point p1" [2 2 2] "spectrum sigma_a" [395 .3 715 .2] '
                '"spectrum sigma_s" [395 .2 715 .4] "spectrum Le" [395 .1 715 .05] '
                '"float g" [.3] AttributeEnd')
    if kind == "exponential":
        return ('Volume "exponential" "point p0" [-3 -1 -3] "point p1" [3 3 3] "float a" [.8] '
                '"float b" [.5] "vector updir" [0.2 1 0] "spectrum sigma_a" [395 .4 715 .4] '
                '"spectrum sigma_s" [395 .1 715 .3] "spectrum Le" [395 .02 715 .08] '
                '"float g" [-.2]')
    if kind == "volumegrid":
        dens = " ".join(f"{v:.4f}" for v in np.random.default_rng(3).random(12) * 2)
        return ('AttributeBegin Translate .3 -.2 .1 Volume "volumegrid" "point p0" [-1 -1 -1] '
                '"point p1" [1.5 1 1] "integer nx" [3] "integer ny" [2] "integer nz" [2] '
                f'"float density" [{dens}] "spectrum sigma_a" [395 .5 715 .5] '
                '"spectrum sigma_s" [395 .5 715 .2] "spectrum Le" [395 .3 715 .1] AttributeEnd')
    return (f'Volume "water" "point p0" [-4 -4 -4] "point p1" [4 4 4] '
            f'"string absorptionCurveFile" ["{curve}"] "string phaseFunctionFile" ["vsf.txt"] '
            '"spectrum sigma_s" [395 .05 715 .02] "float g" [.1]')


def scene_text(regions):
    return f"""
LookAt 0 0 -8  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [4] "integer yresolution" [4]
VolumeIntegrator "single"
WorldBegin
LightSource "point" "rgb I" [20 20 20] "point from" [1 3 -2]
AttributeBegin Translate 0 0 0.5 LightSource "distant" "rgb L" [.5 .5 .5] "point from" [0 5 0] "point to" [0 0 0] AttributeEnd
{chr(10).join(regions)}
Material "matte" "spectrum Kd" [395 .6 715 .6]
Shape "trianglemesh" "point P" [-6 -6 3  6 -6 3  6 6 3  -6 6 3] "integer indices" [0 1 2 2 3 0]
Shape "sphere" "float radius" [.5]
WorldEnd
"""


@pytest.fixture(scope="module")
def curve(tmp_path_factory):
    return write_absorption_curve(tmp_path_factory.mktemp("water") / "abs.txt")


def built_pair(text):
    return jbuild(jload(text)), tbuild(tload(text), device="cpu")


def rays(seed=0):
    """1,024 segments from inside the boxes, some ending at 1e4 (an infinite
    light's) → numpy (o, d, t0, t1, u)."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3.5, 3.5, (N_RAYS, 3)).astype(np.float32)
    d = rs.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t0 = np.where(rs.random(N_RAYS) < 0.2, rs.uniform(0, 1, N_RAYS), 0).astype(np.float32)
    t1 = (t0 + rs.uniform(0.2, 7.0, N_RAYS)).astype(np.float32)
    t1[::16] = 1e4
    return o, d, t0, t1, rs.random(N_RAYS, dtype=np.float32)


def close_share(a, b, rtol, atol=1e-6):
    return float(np.isclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol).all(-1).mean())


@pytest.mark.parametrize("kind", KINDS)
def test_table_and_sigma_t_match_jax(kind, curve):
    """One region of each kind: the table field by field, then σt at
    points in and around its box."""
    jb, tb = built_pair(scene_text([region(kind, curve)]))
    jt, tt = jb.scene.volumes, tb.scene.volumes
    assert tb.scene.has_volumes and tt.kinds == (int(jt.kind[0]),)
    for f in ("lo", "hi", "sigma_a", "sigma_s", "le", "g", "exp_a", "exp_b", "updir", "pool"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    for f in ("grid_offset", "grid_n"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    np.testing.assert_allclose(tt.w2v.numpy(), np.asarray(jt.w2v), atol=1e-6)
    # points in and around the box: volume space widened by a quarter of
    # its extent on each side, taken to the world
    lo, hi = np.asarray(jt.lo[0], np.float64), np.asarray(jt.hi[0], np.float64)
    q = np.random.default_rng(1).uniform(lo - (hi - lo) / 4, hi + (hi - lo) / 4, (8192, 3))
    v2w = np.linalg.inv(np.asarray(jt.w2v[0], np.float64))
    p = (q @ v2w[:3, :3].T + v2w[:3, 3]).astype(np.float32)
    ref = np.asarray(jax.jit(jvol.sigma_t)(jt, jnp.asarray(p)))
    out = tvol.sigma_t(tt, torch.as_tensor(p)).numpy()
    assert (ref > 0).any(-1).mean() > 0.2 and (ref == 0).all(-1).mean() > 0.5
    assert close_share(out, ref, 1e-5) >= 0.998
    # the port's table and volume integrator from the JAX package's arrays
    arrays = jax_scene_arrays(jb)
    back = volumes_from_numpy(arrays, "cpu")
    for f in ("w2v", "sigma_a", "pool", "grid_n"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(jt, f)))
    icfg = integrator_from_numpy(arrays)
    assert icfg == tb.integrator and icfg.volume_kind == jb.integrator.volume_kind == "single"


@pytest.fixture(scope="module")
def four(curve):
    """The four kinds in one table, both packages; the port's scene from the
    JAX package's arrays (so the geometry and lights are the same)."""
    jb, tb = built_pair(scene_text([region(k, curve) for k in KINDS]))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    return jb, scene


@contextlib.contextmanager
def jax_pieces_compiled():
    """The JAX package's per-step pieces compiled once each (see the module
    docstring)."""
    with mock.patch.object(jvol, "sigma_t", jax.jit(jvol.sigma_t)), \
            mock.patch.object(jvol, "sigma_s_at", jax.jit(jvol.sigma_s_at)), \
            mock.patch.object(jvol, "emission_at", jax.jit(jvol.emission_at)), \
            mock.patch.object(jlights, "sample_li", jax.jit(jlights.sample_li)), \
            mock.patch.object(jpath, "_shadow_unoccluded", jax.jit(jpath._shadow_unoccluded)):
        yield


def test_transmittance_and_tau_match_jax(four):
    jb, scene = four
    o, d, t0, t1, u = rays(2)
    jt = jb.scene.volumes
    J = lambda a: jnp.asarray(a)
    with jax_pieces_compiled():
        ref = np.asarray(jvol.transmittance(jt, J(o), J(d), J(t0), J(t1), J(u)))
        tau_ref = np.asarray(jvol.tau(jt, J(o), J(d), J(t0), J(t1), J(u)))
    T = lambda a: torch.as_tensor(a)
    out = tvol.transmittance(scene.volumes, T(o), T(d), T(t0), T(t1), T(u)).numpy()
    assert ref.min() < 0.5 and ref.max() <= 1.0
    assert close_share(out, ref, 1e-4) >= 0.995
    tau_out = tvol.tau(scene.volumes, T(o), T(d), T(t0), T(t1), T(u)).numpy()
    assert close_share(tau_out, tau_ref, 1e-4) >= 0.995
    assert np.isfinite(out).all() and np.isfinite(tau_out).all()


def test_integrate_emission_matches_jax(four):
    jb, scene = four
    o, d, t0, t1, u = rays(3)
    J, T = jnp.asarray, torch.as_tensor
    with jax_pieces_compiled():
        Lv_j, tr_j = jvol.integrate_emission(jb.scene.volumes, J(o), J(d), J(t0), J(t1), J(u))
    Lv, tr = tvol.integrate_emission(scene.volumes, T(o), T(d), T(t0), T(t1), T(u))
    assert np.asarray(Lv_j).max() > 0.05
    assert close_share(Lv.numpy(), Lv_j, 1e-4) >= 0.995
    assert close_share(tr.numpy(), tr_j, 1e-4) >= 0.995


def test_integrate_single_scattering_matches_jax(four):
    """The port's media block (jitter and step uniforms of the rays' (pixel,
    sample) keys) against the JAX package's own draws from those keys."""
    jb, scene = four
    o, d, t0, t1, _ = rays(4)
    pix = np.arange(N_RAYS, dtype=np.int64) * 5 + 11
    keys = jrng.pixel_sample_key(jrng.root_key(6), jnp.asarray(pix.astype(np.uint32)),
                                 jnp.uint32(3))
    J, T = jnp.asarray, torch.as_tensor
    with jax_pieces_compiled():
        Lv_j, tr_j = jvol.integrate_single_scattering(jb.scene.volumes, jb.scene, J(o), J(d),
                                                      J(t0), J(t1), keys, 0)
    media = trng.volume_uniforms_plain(trng.root_key(6), T(pix), 3, 1, True)
    Lv, tr = tvol.integrate_single_scattering(
        scene.volumes, scene, T(o), T(d), T(t0), T(t1), media[:, 0],
        media[:, 1:].reshape(N_RAYS, tvol.TAU_STEPS, 3))
    assert np.asarray(Lv_j).max() > 0.05 and np.isfinite(Lv.numpy()).all()
    assert close_share(Lv.numpy(), Lv_j, 1e-4) >= 0.99
    assert close_share(tr.numpy(), tr_j, 1e-4) >= 0.995


@pytest.mark.parametrize("sample", [0, 3, 2**31 + 1])
def test_media_block_matches_jax_keys(sample):
    """The media block against the JAX package's draws: bounce b's
    ``uniform_per(bounce_key(keys, b, VOLUME), 1)`` (path.py:230-231), and
    per march step k ``uniform_per(bounce_key(k_v, k, LIGHT_SAMPLE), 3)``
    (volumes.py:205-206), bit for bit; and the jitter identity: single
    scattering's ``uniform_per(k_v, 3)[:, 0]`` (volumes.py:192-194) and
    the camera segment's ``uniform_per(k_v, 1)[:, 0]`` (path.py:754-755)
    are column 0. On CPU tensors the wrapper is the plain version."""
    pix = np.concatenate([np.arange(500, dtype=np.int64), [2**31, 2**32 - 1]])
    keys = jrng.pixel_sample_key(jrng.root_key(9), jnp.asarray(pix.astype(np.uint32)),
                                 jnp.uint32(sample))
    k_v = jrng.bounce_key(keys, 0, jrng.VOLUME)
    jit3 = np.asarray(jrng.uniform_per(k_v, 3))[:, 0]
    np.testing.assert_array_equal(jit3, np.asarray(jrng.uniform_per(k_v, 1))[:, 0])
    ref = [np.asarray(jrng.uniform_per(jrng.bounce_key(keys, b, jrng.VOLUME), 1))
           for b in range(4)]
    ref += [np.asarray(jrng.uniform_per(jrng.bounce_key(k_v, k, jrng.LIGHT_SAMPLE), 3))
            for k in range(jvol.TAU_STEPS)]
    ref = np.concatenate(ref, -1)
    before = dict(trng.launches)
    for fn in (trng.volume_uniforms_plain, trng.volume_uniforms):
        out = fn(trng.root_key(9), torch.as_tensor(pix), sample, 4, True).numpy()
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
        np.testing.assert_array_equal(out[:, 0], jit3)
    emission_only = trng.volume_uniforms_plain(trng.root_key(9), torch.as_tensor(pix), sample,
                                               4, False)
    np.testing.assert_array_equal(emission_only.numpy(), ref[:, :4])
    assert trng.launches == before


def test_water_curve_and_silent_fallback(curve, tmp_path):
    """A water region's σa is its absorption curve binned; a missing curve
    keeps the default σa of 1 without a word, as in the JAX package;
    ``phaseFunctionFile`` is read and not used."""
    texts = [scene_text([region("water", curve)]),
             scene_text([region("water", str(tmp_path / "missing.txt"))])]
    for text, ok in zip(texts, (True, False)):
        jb, tb = built_pair(text)
        sa = tb.scene.volumes.sigma_a.numpy()[0]
        np.testing.assert_array_equal(sa, np.asarray(jb.scene.volumes.sigma_a)[0])
        if ok:
            assert 0.0 < sa.min() < 0.1 < sa.max() < 0.4
        else:
            np.testing.assert_array_equal(sa, np.ones_like(sa))
        assert tb.scene.volumes.kinds == (tvol.WATER,)


def test_beer_lambert_closed_form():
    """Tr through a homogeneous slab = e^(−σt·L) (test_volumes.py, on the
    port)."""
    tb = tbuild(tload("""WorldBegin
        Volume "homogeneous" "point p0" [0 0 0] "point p1" [1 1 2]
          "spectrum sigma_a" [395 .5 715 .5] "spectrum sigma_s" [395 0 715 0]
        Shape "sphere" "float radius" [.01]
        WorldEnd"""), device="cpu")
    vt = tb.scene.volumes
    assert vt.count == 1
    tr = tvol.transmittance(vt, torch.tensor([[0.5, 0.5, -1.0]]), torch.tensor([[0.0, 0.0, 1.0]]),
                            torch.zeros(1), torch.full((1,), 4.0), torch.full((1,), 0.5))
    np.testing.assert_allclose(tr.numpy()[0], np.exp(-1.0), rtol=0.05)


def test_emission_closed_form():
    """Lv = Le/σt·(1 − e^(−σt·L)) for an emissive slab (test_volumes.py:
    ~10% at 32 steps, the march quantizes the slab's faces)."""
    tb = tbuild(tload("""WorldBegin
        Volume "homogeneous" "point p0" [0 0 0] "point p1" [1 1 1]
          "spectrum sigma_a" [395 1 715 1] "spectrum sigma_s" [395 0 715 0]
          "spectrum Le" [395 2 715 2]
        Shape "sphere" "float radius" [.01]
        WorldEnd"""), device="cpu")
    Lv, tr = tvol.integrate_emission(tb.scene.volumes, torch.tensor([[0.5, 0.5, -1.0]]),
                                     torch.tensor([[0.0, 0.0, 1.0]]), torch.zeros(1),
                                     torch.full((1,), 3.0), torch.full((1,), 0.5))
    np.testing.assert_allclose(Lv.numpy()[0], 2 * (1 - np.exp(-1)), rtol=0.12)
    np.testing.assert_allclose(tr.numpy()[0], np.exp(-1.0), rtol=0.12)


def test_exponential_and_grid_shapes():
    """The exponential density falls with height; the grid interpolates
    between its cells (test_volumes.py's checks, on the port)."""
    tb = tbuild(tload("""WorldBegin
        Volume "exponential" "point p0" [0 0 0] "point p1" [10 10 10]
          "float a" [1] "float b" [1] "vector updir" [0 1 0] "spectrum sigma_a" [395 1 715 1]
        Volume "volumegrid" "point p0" [20 0 0] "point p1" [21 1 1]
          "integer nx" [2] "integer ny" [1] "integer nz" [1] "float density" [0 1]
          "spectrum sigma_a" [395 1 715 1]
        Shape "sphere" "float radius" [.01]
        WorldEnd"""), device="cpu")
    st = tvol.sigma_t(tb.scene.volumes, torch.tensor(
        [[5.0, 0.5, 5.0], [5.0, 8.0, 5.0], [20.25, 0.5, 0.5], [20.75, 0.5, 0.5]])).mean(-1)
    assert float(st[0]) > 5.0 * float(st[1]) and float(st[3]) > float(st[2])


def test_far_points_add_nothing():
    """Segments to 1e4 (an infinite light's) march far outside every box:
    finite, and the same as the segment that ends at the box."""
    tb = tbuild(tload(fog_scene_text()), device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.6, 0.0, 0.8]])
    u = torch.full((4,), 0.5)
    tr = tvol.transmittance(tb.scene.volumes, o, d, torch.zeros(4), torch.full((4,), 1e4), u)
    Lv, tr2 = tvol.integrate_emission(tb.scene.volumes, o, d, torch.zeros(4),
                                      torch.full((4,), 1e4), u)
    assert torch.isfinite(tr).all() and torch.isfinite(Lv).all() and torch.isfinite(tr2).all()


def test_fog_render_seed_matches_jax():
    """``render(seed)`` of the 8×8 fog scene (directlighting depth 1, 1 spp,
    emission), both packages: the camera segment's T·L + Lv and NEE's
    shadow transmittance."""
    text = fog_scene_text("emission")
    with jax_integrator_pieces(), jax_pieces_compiled():
        js = j_render(jbuild(jload(text)), spp=1, seed=5, chunk_pixels=40, verbose=False)
    tb = tbuild(tload(text), device="cpu")
    assert tb.integrator.volume_kind == "emission" and tb.scene.has_volumes
    ts = render(tb, spp=1, seed=5, chunk_pixels=40)
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert close_share(pt, pj, 1e-4) >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)


def _single_pair(text, o, d, t1):
    """Single scattering of the segments [0, t1] in both packages' tables
    of ``text`` → (JAX's Lv, the port's Lv), keyed alike."""
    jb = jbuild(jload(text))
    scene, _, _ = scene_from_numpy(jax_scene_arrays(jb), "cpu")
    n = o.shape[0]
    pix = np.arange(n, dtype=np.int64)
    keys = jrng.pixel_sample_key(jrng.root_key(1), jnp.asarray(pix.astype(np.uint32)),
                                 jnp.uint32(0))
    J, T = jnp.asarray, torch.as_tensor
    z = np.zeros(n, np.float32)
    with jax_pieces_compiled():
        Lv_j, _ = jvol.integrate_single_scattering(jb.scene.volumes, jb.scene, J(o), J(d), J(z),
                                                   J(t1), keys, 0)
    media = trng.volume_uniforms_plain(trng.root_key(1), T(pix), 0, 1, True)
    Lv, _ = tvol.integrate_single_scattering(scene.volumes, scene, T(o), T(d), T(z), T(t1),
                                             media[:, 0], media[:, 1:].reshape(n, 32, 3))
    return np.asarray(Lv_j), Lv.numpy()


def _facts_scene(second):
    return f"""WorldBegin
LightSource "point" "rgb I" [20 20 20] "point from" [0 4 0]
Volume "homogeneous" "point p0" [-2 -1 -2] "point p1" [2 1 2]
  "spectrum sigma_a" [395 .1 715 .1] "spectrum sigma_s" [395 .3 715 .3] "float g" [.5]
{second}
Shape "sphere" "float radius" [.01]
WorldEnd"""


def test_facts_mean_g_and_unattenuated_light_ray():
    """Two facts of the JAX package, copied by the port (ROADMAP Queue 3):
    single scattering's phase function takes the mean g of all regions
    (volumes.py:199), so a far region's g changes the light scattered in a
    region it never touches; and the light sample's ray gets no
    transmittance (volumes.py:211-223), so an absorbing slab between the
    light and the segment changes nothing."""
    rs = np.random.default_rng(8)
    n = 256
    o = np.stack([rs.uniform(-1.5, 1.5, n), rs.uniform(-.5, .5, n), np.full(n, -1.9)],
                 -1).astype(np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
    t1 = np.full(n, 3.8, np.float32)
    far = 'Volume "homogeneous" "point p0" [50 50 50] "point p1" [51 51 51] "float g" [{}]'
    slab = ('Volume "homogeneous" "point p0" [-5 2 -5] "point p1" [5 3 5] '
            '"spectrum sigma_a" [395 50 715 50] "spectrum sigma_s" [395 0 715 0] "float g" [.5]')
    runs = {k: _single_pair(_facts_scene(v), o, d, t1) for k, v in (
        ("g_plus", far.format(.9)), ("g_minus", far.format(-.9)), ("g_same", far.format(.5)),
        ("slab", slab))}
    for k, (lj, lt) in runs.items():
        assert close_share(lt, lj, 1e-4) >= 0.99, k
        assert lj.max() > 0.0
    # the far regions hold no density along the segments: only their g acts
    assert not np.allclose(runs["g_plus"][0], runs["g_minus"][0], rtol=1e-3)
    assert not np.allclose(runs["g_plus"][1], runs["g_minus"][1], rtol=1e-3)
    # the slab (g .5, mean unchanged) shadows the light for pbrt, not here
    np.testing.assert_allclose(runs["slab"][0], runs["g_same"][0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(runs["slab"][1], runs["g_same"][1], rtol=1e-5, atol=1e-7)


def test_fact_any_volume_integrator_but_single_is_emission():
    """builder.py:732-733: a ``VolumeIntegrator`` other than ``single``
    (here a misspelt one) renders as ``emission``, in both packages."""
    text = fog_scene_text("singel")
    assert jbuild(jload(text)).integrator.volume_kind == "emission"
    assert tbuild(tload(text), device="cpu").integrator.volume_kind == "emission"
    assert tbuild(tload(fog_scene_text("single")), device="cpu").integrator.volume_kind == "single"
