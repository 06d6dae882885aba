"""The port's samplers against the JAX package's: each sampler's camera
columns (``core/rng.py:camera_columns_plain`` and the wrappers, on the
CPU their plain versions) against ``_sampler_uniforms`` jitted as the JAX
renderer runs it, the scramble-word identities the keyed kernels rely on,
the best-candidate table, ``render(seed)`` with the random and halton
samplers, and the adaptive sampler's two passes.

Tolerances: random, stratified, bestcandidate and lowdiscrepancy bit for
bit; halton within 1 ulp (its radical inverse is the host's float32 sum,
XLA's CPU backend may fuse ``val + d · inv_bi`` into an FMA). Renders: as
``tests/test_torch_film.py``'s, pixels within rtol 1e-4, atol 1e-6 on ≥ 99%,
per-bin sums within 1e-3 of the largest, weights and depths rtol 1e-5.
The adaptive films: weights equal but for pixels whose contrast test sits
within 1e-5 of its threshold (none on this scene), pixels as above.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import sampling as jsmp
from pbrt_tpu.renderers.sampler import _sampler_uniforms
from pbrt_tpu.renderers.sampler import render as j_render
from pbrt_tpu.scene.api import load_scene_string as jload
from pbrt_tpu.scene.builder import build as jbuild

from pbrt_torch.core import rng as trng
from pbrt_torch.core import sampling as tsmp
from pbrt_torch.renderers import sampler as tsampler
from pbrt_torch.scene.api import load_scene_string as tload
from pbrt_torch.scene.builder import build as tbuild
from torch_parity_util import tiny_scene_text

#: pixel indices: 4,096 consecutive ones and some at and above 2**31
PIXELS = np.concatenate([np.arange(4096, dtype=np.int64),
                         np.array([2**31 - 1, 2**31, 2**31 + 3, 2**32 - 1], np.int64)])
SAMPLES = (0, 1, 7, 2**31 + 1)
SAMPLERS = ("lowdiscrepancy", "halton", "bestcandidate", "random", "stratified", "adaptive")


def _ulps(a, b):
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(ia - ib)


@functools.lru_cache(maxsize=None)
def _jax_columns_fn(sampler, spp):
    """``_sampler_uniforms`` under jit, keyed as the JAX renderer keys it
    (sampler.py:119-128): random and stratified by sample n's key, the
    others by sample 0's."""

    def fn(root, pix, n):
        keys = jrng.pixel_sample_key(root, pix, n)
        pixel_keys = jrng.pixel_sample_key(root, pix, jnp.zeros_like(pix))
        cols = _sampler_uniforms(sampler, pix, n,
                                 keys if sampler in ("random", "stratified") else pixel_keys,
                                 spp)
        return jnp.stack(cols, -1)

    return jax.jit(fn)


@pytest.mark.parametrize("spp", [1, 4, 9])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_camera_columns_match_jax(sampler, spp):
    """Each sampler's five camera columns on 4,100 pixels for samples 0, 1,
    7 and 2**31 + 1, at spp 1, 4 and 9 (stratified's ⌊√spp⌋ grid: 1, 2, 3),
    from the plain version and both wrappers (on the CPU: the plain
    version, no launch)."""
    root_j, root_t = jrng.root_key(21), trng.root_key(21)
    pix_t = torch.as_tensor(PIXELS)
    scr = trng.pixel_scrambles_plain(root_t, pix_t)
    fn = _jax_columns_fn(sampler, spp)
    before = dict(trng.launches)
    for n in SAMPLES:
        ref = np.asarray(fn(root_j, jnp.asarray(PIXELS.astype(np.uint32)), jnp.uint32(n)))
        code, consts = trng.sampler_constants(sampler, n, spp)
        outs = [trng.camera_columns_plain(root_t, pix_t, scr, n, code, consts),
                trng.primary_uniforms(root_t, pix_t, scr, n, 2, sampler, spp)[:, :5],
                trng.ao_uniforms(root_t, pix_t, scr, n, 3, sampler, spp)[:, :5]]
        for out in outs:
            out = out.numpy()
            assert out.shape == ref.shape and out.min() >= 0.0 and out.max() < 1.0
            if sampler == "halton":
                assert _ulps(out, ref).max() <= 1, (n, _ulps(out, ref).max())
            else:
                np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert trng.launches == before


def test_sampler_constants():
    """The host's per-wave constants: halton's radical inverses of n
    within 1 ulp of the JAX package's (sampling.py:308-324, jitted), the
    bestcandidate row clamped at T − 1, stratified's floor grid, an unknown
    name random's."""
    ri = jax.jit(jsmp.radical_inverse, static_argnums=1)
    for n in (0, 1, 2, 3, 7, 12345, 2**31 + 1, 2**32 - 1):
        code, c = trng.sampler_constants("halton", n, 1)
        assert code == trng.HALTON
        ref = np.array([ri(jnp.uint32(n), b) for b in tsmp.HALTON_BASES], np.float32)
        assert _ulps(np.array(c, np.float32), ref).max() <= 1
    table = tsmp.best_candidate_table(4)
    assert trng.sampler_constants("bestcandidate", 9, 4)[1][:2] == tuple(
        float(v) for v in table[3])
    third = float(np.float32(1 / 3))
    assert trng.sampler_constants("stratified", 7, 9)[1] == (1.0, 2.0, third, 0.0, 0.0)
    assert trng.sampler_constants("stratified", 7, 8)[1][2] == 0.5  # ⌊√8⌋, not ⌈√8⌉
    assert trng.sampler_constants("adaptive", 3, 8)[0] == trng.LOWDISCREPANCY
    # a name the JAX package does not know samples as random (sampler.py:84-87)
    assert trng.sampler_constants("sobol", 5, 4) == trng.sampler_constants("random", 5, 4)
    assert trng.sampler_constants("sobol", 0, 1)[0] == trng.RANDOM


def test_scramble_word_identities():
    """The per-pixel draws of halton and bestcandidate are words of
    lowdiscrepancy's ``bits(k, (6,))``: halton's ``uniform(k, (5,))`` the
    unit floats of words 0-4, bestcandidate's ``bits(k, (3,))`` words 0-2
    and its ``uniform(k, (2,))`` the unit floats of words 0 and 1, so the
    keyed kernels take them from the scramble words."""
    keys = jrng.pixel_sample_key(jrng.root_key(4), jnp.arange(2048, dtype=jnp.uint32), 0)
    k = jrng.bounce_key(keys, 0, jrng.CAMERA)
    per = lambda f: np.asarray(jax.vmap(f)(k))
    six = per(lambda kk: jax.random.bits(kk, (6,), jnp.uint32))
    unit = trng._to_uniform(torch.as_tensor(six.astype(np.int64))).numpy()
    np.testing.assert_array_equal(per(lambda kk: jax.random.uniform(kk, (5,))), unit[:, :5])
    np.testing.assert_array_equal(per(lambda kk: jax.random.bits(kk, (3,), jnp.uint32)),
                                  six[:, :3])
    np.testing.assert_array_equal(per(lambda kk: jax.random.uniform(kk, (2,))), unit[:, :2])


@pytest.mark.parametrize("n", [1, 2, 4, 9, 16, 64])
def test_best_candidate_table_matches_jax(n):
    np.testing.assert_array_equal(tsmp.best_candidate_table(n).view(np.int32),
                                  jsmp.best_candidate_table(n).view(np.int32))


def test_radical_inverse_values():
    """Base 2 of 1 is 1/2, base 3 of 5 (12 in base 3) is 2/3 + 1/9."""
    assert tsmp.radical_inverse(1, 2) == np.float32(0.5)
    assert abs(float(tsmp.radical_inverse(5, 3)) - (1 / 3 * 2 + 1 / 9)) < 1e-7
    assert tsmp.radical_inverse(2**32 - 1, 2) == np.float32(tsmp.ONE_MINUS_EPS)


def _films_close(js, ts):
    pj, pt = np.asarray(js.pixels), ts.pixels.numpy()
    assert np.isfinite(pt).all() and pt.sum() > 0
    assert np.isclose(pt, pj, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    sj, st = pj.sum((0, 1)), pt.sum((0, 1))
    assert np.abs(st - sj).max() <= 1e-3 * np.abs(sj).max()
    np.testing.assert_allclose(ts.depth.numpy(), np.asarray(js.depth), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sampler", ["random", "halton"])
def test_render_seed_matches_jax(sampler):
    """``render(seed)`` of the 8×8 tiny scene (path, depth 1, 2 spp,
    40-pixel chunks: the last is padded) with the sampler, both packages."""
    text = tiny_scene_text(8, 8, max_depth=1).replace(
        'Sampler "lowdiscrepancy"', f'Sampler "{sampler}"')
    assert f'Sampler "{sampler}"' in text
    js = j_render(jbuild(jload(text)), spp=2, seed=3, chunk_pixels=40, verbose=False)
    ts = tsampler.render(tbuild(tload(text), device="cpu"), spp=2, seed=3, chunk_pixels=40)
    _films_close(js, ts)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5)


ADAPTIVE = """
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Sampler "adaptive" "integer minsamples" [2] "integer maxsamples" [8]
  "string method" ["%s"]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "point" "rgb I" [40 40 40] "point from" [0 0 -3]
Material "matte" "color Kd" [.7 .7 .7]
Shape "trianglemesh" "point P" [-.4 -.4 0  .4 -.4 0  .4 .4 0  -.4 .4 0]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


@pytest.fixture(scope="module")
def adaptive_films(monkeypatch_module):
    """tests/test_adaptive.py's scene under both methods, both packages
    (the JAX side with its bounce loop rolled: the same program, compiled
    in less time)."""
    monkeypatch_module.setenv("PBRT_TPU_UNROLL_BOUNCES", "0")
    out = {}
    for method in ("shapeid", "contrast"):
        text = ADAPTIVE % method
        jb, tb = jbuild(jload(text)), tbuild(tload(text), device="cpu")
        out[method] = (j_render(jb, seed=0, verbose=False), tsampler.render(tb, seed=0), tb)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("method", ["shapeid", "contrast"])
def test_adaptive_matches_jax(adaptive_films, method):
    """The adaptive film: weights equal, pixels as the sampler's; pixels
    supersampled where test_adaptive.py expects them (the silhouette under
    shapeid), and the port's counts."""
    js, ts, tb = adaptive_films[method]
    jw, tw = np.asarray(js.weight), ts.weight.numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-5)
    _films_close(js, ts)
    assert tw.min() >= 2.0 - 1e-4 and tw.max() > tw.min() + 1.0
    assert ts.adaptive["pixels"] == 144 and 0 < ts.adaptive["need"] < 144
    assert ts.adaptive["waves"] == 8
    supersampled = tw > 2.5
    assert int(supersampled.sum()) == ts.adaptive["need"]


def test_adaptive_need_rule():
    """``need_supersampling`` on hand-made statistics: contrast triggers
    where max |lum − mean| > mean / 2 and the mean is positive, shapeid
    where the first hits' ids differ; a dev / avg of exactly 0.5 does not
    trigger."""
    lum_sum = torch.tensor([2.0, 2.0, 0.0, 3.0])
    lum_min = torch.tensor([1.0, 0.4, 0.0, 0.75])
    lum_max = torch.tensor([1.0, 1.6, 0.0, 2.25])
    ids = torch.tensor([0, 0, 1, 2]), torch.tensor([0, 3, 1, 2])
    need = tsampler.need_supersampling("contrast", lum_sum, lum_min, lum_max, *ids, 2)
    assert need.tolist() == [False, True, False, False]
    need = tsampler.need_supersampling("shapeid", lum_sum, lum_min, lum_max, *ids, 2)
    assert need.tolist() == [False, True, False, False]


def test_adaptive_quick_renders_one_wave():
    """``quick``: minsamples and maxsamples 1, one wave (sampler.py:382-383)."""
    tb = tbuild(tload(ADAPTIVE % "contrast"), device="cpu")
    ts = tsampler.render(tb, seed=0, quick=True)
    assert ts.adaptive == {"need": 0, "pixels": 144, "waves": 1}
    assert float(ts.weight.max()) <= 1.0 + 1e-5
