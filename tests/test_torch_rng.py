"""Parity of the port's threefry keys (``pbrt_torch/core/rng.py``) with
``jax.random`` and with the JAX package's keyed sampler arrays, bit for bit:
root keys, ``fold_in``, ``bits``, ``uniform``, the per-path and per-bounce
keys, the lowdiscrepancy scramble words and ``BatchedKeySource``'s bounce
block as the port's 7-per-bounce ``PrimarySource`` columns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.integrators.path import BatchedKeySource
from pbrt_torch.core import rng as trng
from pbrt_torch.interop import key_from_numpy

#: pixel indices, including ones at and above 2**31 (uint32 wraparound)
PIXELS = np.array([0, 1, 5, 63, 4095, 262143, 2**31 - 1, 2**31, 2**31 + 3,
                   2**32 - 1], np.int64)


def _jax_keys(n, seed):
    words = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64)
    words = words.astype(np.uint32)
    return jax.random.wrap_key_data(jnp.asarray(words)), key_from_numpy(words)


def _data(n, seed):
    d = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    d[:3] = [0, 2**31, 2**32 - 1]
    return d.astype(np.uint32)


def _words(jkeys):
    return np.asarray(jax.random.key_data(jkeys)).astype(np.int64)


def _same_floats(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, 2**31 + 7, 2**40 + 5, -3])
def test_root_key_matches_jax(seed):
    """With 64-bit types off (as the JAX package runs), jax wraps the seed
    to 32 bits: the key is [0, seed mod 2**32]."""
    ref = np.asarray(jax.random.key_data(jrng.root_key(seed))).astype(np.int64)
    np.testing.assert_array_equal(trng.root_key(seed).numpy(), ref)


def test_fold_in_matches_jax():
    jk, tk = _jax_keys(64, 1)
    data = _data(64, 2)
    ref = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data))
    out = trng.fold_in(tk, torch.as_tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(out.numpy(), _words(ref))


@pytest.mark.parametrize("n", [1, 6, 13])
def test_bits_matches_jax(n):
    jk, tk = _jax_keys(40, 3)
    ref = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk))
    np.testing.assert_array_equal(trng.bits(tk, n).numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("n", [1, 5, 40])
def test_uniform_per_matches_jax(n):
    jk, tk = _jax_keys(40, 4)
    _same_floats(trng.uniform_per(tk, n).numpy(), jrng.uniform_per(jk, n))


@pytest.mark.parametrize("sample", [0, 3, 2**31 + 1])
def test_pixel_sample_key_matches_jax(sample):
    root_j, root_t = jrng.root_key(7), trng.root_key(7)
    ref = jrng.pixel_sample_key(root_j, jnp.asarray(PIXELS.astype(np.uint32)),
                                np.uint32(sample))
    out = trng.pixel_sample_key(root_t, torch.as_tensor(PIXELS), sample)
    np.testing.assert_array_equal(out.numpy(), _words(ref))


@pytest.mark.parametrize("bounce,purpose", [(0, jrng.CAMERA), (0, 15),
                                            (2, jrng.BSDF_SAMPLE), (4, jrng.ROULETTE)])
def test_bounce_key_matches_jax(bounce, purpose):
    jk, tk = _jax_keys(32, 5)
    ref = jrng.bounce_key(jk, bounce, purpose)
    np.testing.assert_array_equal(trng.bounce_key(tk, bounce, purpose).numpy(), _words(ref))


def test_purposes_match_jax():
    for name in ("CAMERA", "LIGHT_SELECT", "LIGHT_SAMPLE", "BSDF_SAMPLE", "ROULETTE",
                 "LENS", "TIME", "DIFFRACTION", "VOLUME", "PHOTON", "MUTATION"):
        assert getattr(trng, name) == getattr(jrng, name)


def test_scrambles_match_jax_sampler():
    """The six scramble words of pbrt_tpu/renderers/sampler.py:122-127 and
    :43-44 (sample 0's pixel key, bounce 0, CAMERA)."""
    root = jrng.root_key(11)
    keys = jrng.pixel_sample_key(root, jnp.asarray(PIXELS.astype(np.uint32)), 0)
    k_img = jrng.bounce_key(keys, 0, jrng.CAMERA)
    ref = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (6,), jnp.uint32))(k_img))
    for fn in (trng.pixel_scrambles, trng.pixel_scrambles_plain):
        out = fn(trng.root_key(11), torch.as_tensor(PIXELS))
        np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("depth,sample", [(1, 0), (5, 0), (5, 3), (4, 17)])
def test_bounce_block_matches_batched_key_source(depth, sample):
    """``BatchedKeySource``'s (R, D, 8) uniforms (path.py:115-120) without
    the spare column equal the port's (R, 7·D) bounce block."""
    keys = jrng.pixel_sample_key(jrng.root_key(2), jnp.asarray(PIXELS.astype(np.uint32)),
                                 sample)
    ref = np.asarray(BatchedKeySource(keys, depth).u)[:, :, :7].reshape(len(PIXELS), -1)
    before = dict(trng.launches)
    out = trng.bounce_uniforms(trng.root_key(2), torch.as_tensor(PIXELS), sample, depth)
    assert trng.launches == before  # CPU tensors take the plain version
    assert out.shape == (len(PIXELS), 7 * depth) and out.dtype == torch.float32
    _same_floats(out.numpy(), ref)


def test_key_from_numpy():
    words = np.array([[1, 2], [2**32 - 1, 0]], np.uint32)
    np.testing.assert_array_equal(key_from_numpy(words).numpy(), words.astype(np.int64))
    with pytest.raises(ValueError):
        key_from_numpy(words.astype(np.int64))
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(3, np.uint32))
