"""Parity of the port's threefry keys (``pbrt_torch/core/rng.py``) with
``jax.random`` and with the JAX package's keyed sampler arrays, bit for bit:
root keys, ``fold_in``, ``bits``, ``uniform``, the per-path and per-bounce
keys, the lowdiscrepancy scramble words, the wave's primary-sample array
(the lowdiscrepancy camera columns, then ``BatchedKeySource``'s bounce
block as the port's 7-per-bounce ``PrimarySource`` columns), and ambient
occlusion's array (the camera columns, then the two uniforms per AO sample
that ``_ao_li`` draws). The CUDA
kernels (``csrc/rng.cu``) cannot run here: their constants are read from
the source as text, and their camera-column formulation is held to the
plain version's."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.integrators.path import BatchedKeySource
from pbrt_tpu.renderers.sampler import _sampler_uniforms
from pbrt_torch.core import rng as trng
from pbrt_torch.core import sampling as tsmp
from pbrt_torch.interop import key_from_numpy

SOURCE = pathlib.Path(trng.__file__).resolve().parent.parent / "csrc" / "rng.cu"

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
    the spare column equal the bounce block of the port's primary-sample
    array (its columns after the 5 camera columns)."""
    keys = jrng.pixel_sample_key(jrng.root_key(2), jnp.asarray(PIXELS.astype(np.uint32)),
                                 sample)
    ref = np.asarray(BatchedKeySource(keys, depth).u)[:, :, :7].reshape(len(PIXELS), -1)
    pix = torch.as_tensor(PIXELS)
    before = dict(trng.launches)
    scr = trng.pixel_scrambles(trng.root_key(2), pix)
    out = trng.primary_uniforms(trng.root_key(2), pix, scr, sample, depth)
    assert trng.launches == before  # CPU tensors take the plain versions
    assert out.shape == (len(PIXELS), 5 + 7 * depth) and out.dtype == torch.float32
    _same_floats(out[:, 5:].numpy(), ref)
    _same_floats(trng.bounce_uniforms_plain(trng.root_key(2), pix, sample, depth).numpy(), ref)


def test_key_from_numpy():
    words = np.array([[1, 2], [2**32 - 1, 0]], np.uint32)
    np.testing.assert_array_equal(key_from_numpy(words).numpy(), words.astype(np.int64))
    with pytest.raises(ValueError):
        key_from_numpy(words.astype(np.int64))
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(3, np.uint32))


@pytest.mark.parametrize("depth", [1, 4, 5])
@pytest.mark.parametrize("sample", [0, 3, 2**31 + 1])
def test_primary_array_matches_jax_sampler(sample, depth):
    """The port's (R, 5 + 7·D) primary-sample array equals the JAX
    package's lowdiscrepancy camera columns (sampler.py:30-48, keys as
    :120-129) beside ``BatchedKeySource(keys, D).u[..., :7]``, pixel
    indices at and above 2**31 included."""
    root_j = jrng.root_key(13)
    pix_j = jnp.asarray(PIXELS.astype(np.uint32))
    pixel_keys = jrng.pixel_sample_key(root_j, pix_j, jnp.zeros_like(pix_j))
    cam = _sampler_uniforms("lowdiscrepancy", pix_j, np.uint32(sample), pixel_keys, 1)
    keys = jrng.pixel_sample_key(root_j, pix_j, np.uint32(sample))
    bounce = np.asarray(BatchedKeySource(keys, depth).u)[:, :, :7].reshape(len(PIXELS), -1)
    ref = np.concatenate([np.stack([np.asarray(c) for c in cam], -1), bounce], -1)
    root, pix = trng.root_key(13), torch.as_tensor(PIXELS)
    out = trng.primary_uniforms_plain(root, pix, trng.pixel_scrambles_plain(root, pix),
                                      sample, depth)
    assert out.shape == (len(PIXELS), 5 + 7 * depth)
    _same_floats(out.numpy(), ref)


@pytest.mark.parametrize("sample", [0, 1, 3, 17, 2**31 + 1, 2**32 - 1])
def test_camera_columns_as_the_kernel_forms_them(sample):
    """The kernel's camera columns: van der Corput is ``brev(n) ^ s`` and
    Sobol's second dimension ``S(n) ^ s``, with S(n) the xor of the
    direction words over the set bits of n, both then ``_bits_to_unit``."""
    scr = np.random.default_rng(sample % 1000).integers(0, 2**32, (64, 6), dtype=np.uint64)
    scr = torch.as_tensor(scr.astype(np.int64))
    n = sample & 0xFFFFFFFF
    brev = int(f"{n:032b}"[::-1], 2)
    sob, v = 0, 1 << 31
    for i in range(32):
        sob ^= v if (n >> i) & 1 else 0
        v ^= v >> 1
    words = torch.stack([scr[:, 0] ^ brev, scr[:, 1] ^ sob, scr[:, 2] ^ brev,
                         scr[:, 3] ^ sob, scr[:, 4] ^ brev], -1)
    _same_floats(tsmp.camera_uniforms(sample, scr).numpy(),
                 tsmp._bits_to_unit(words).numpy())


@pytest.mark.parametrize("n_ao", [1, 4, 9])
@pytest.mark.parametrize("sample", [0, 3, 2**31 + 1])
def test_ao_array_matches_jax(sample, n_ao):
    """``ao_uniforms_plain``: the lowdiscrepancy camera columns, then for AO
    sample j ``uniform_per(bounce_key(keys, j, BSDF_SAMPLE), 2)`` of the lane
    key, as ``_ao_li`` draws them (path.py:783-784); pixel indices at and
    above 2**31 included. On CPU tensors the wrapper is the plain version."""
    root_j = jrng.root_key(17)
    pix_j = jnp.asarray(PIXELS.astype(np.uint32))
    pixel_keys = jrng.pixel_sample_key(root_j, pix_j, jnp.zeros_like(pix_j))
    cam = _sampler_uniforms("lowdiscrepancy", pix_j, np.uint32(sample), pixel_keys, 1)
    keys = jrng.pixel_sample_key(root_j, pix_j, np.uint32(sample))
    per = [np.asarray(jrng.uniform_per(jrng.bounce_key(keys, j, jrng.BSDF_SAMPLE), 2))
           for j in range(n_ao)]
    ref = np.concatenate([np.stack([np.asarray(c) for c in cam], -1)] + per, -1)
    root, pix = trng.root_key(17), torch.as_tensor(PIXELS)
    scr = trng.pixel_scrambles_plain(root, pix)
    before = dict(trng.launches)
    for out in (trng.ao_uniforms_plain(root, pix, scr, sample, n_ao),
                trng.ao_uniforms(root, pix, scr, sample, n_ao)):
        assert out.shape == (len(PIXELS), 5 + 2 * n_ao) and out.dtype == torch.float32
        _same_floats(out.numpy(), ref)
    assert trng.launches == before


def _cu_int(name):
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(0x[0-9A-Fa-f]+|\d+)u?;", SOURCE.read_text())
    assert m, f"{name} not found in rng.cu"
    return int(m.group(1), 0)


def test_kernel_constants_are_the_plain_versions():
    """rng.cu's rotation schedule, key-schedule constant, tags, camera and
    per-bounce layout and float clamp, read from the source as text, are
    ``core/rng.py``'s and ``core/sampling.py``'s."""
    text = SOURCE.read_text()
    body = re.search(r"void threefry2x32\(.*?\n}\n", text, re.S).group(0)
    rots = [int(r) for r in re.findall(r"mix\(x0, x1, (\d+)\)", body)]
    assert rots == [r for g in range(5) for r in trng._ROT[g % 2]]
    assert "0x1BD11BDAu" in body
    injections = re.findall(r"x0 \+= (k\d); x1 \+= (k\d) \+ (\d)u;", body)
    assert injections == [(f"k{(g + 1) % 3}", f"k{(g + 2) % 3}", str(g + 1)) for g in range(5)]
    assert _cu_int("kBatchedTag") == 0 * 16 + trng.BATCHED == 15
    assert _cu_int("kCameraTag") == 0 * 16 + trng.CAMERA == 0
    assert _cu_int("kDrawn") == trng.PER_BOUNCE_DRAWN == 8
    assert _cu_int("kUsed") == trng.PER_BOUNCE_USED == 7
    assert _cu_int("kScrambles") == trng.N_SCRAMBLES
    assert _cu_int("kCameraCols") == trng.CAMERA_DIMS
    one_minus_eps = np.float32(tsmp.ONE_MINUS_EPS).view(np.uint32)
    assert _cu_int("kOneMinusEps") == int(one_minus_eps)
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+keyed_uniforms_kernel\(", text)
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+keyed_scrambles_kernel\(", text)


def test_ao_kernel_constants_are_the_plain_versions():
    """keyed_ao_uniforms folds AO sample s into the lane key as s·16 +
    BSDF_SAMPLE and writes 2 uniforms per sample after the camera columns,
    from counters 0 and 1, as ``ao_uniforms_plain``."""
    text = SOURCE.read_text()
    assert _cu_int("kAoPurpose") == trng.BSDF_SAMPLE == 3
    assert _cu_int("kAoPerSample") == 2
    body = re.search(r"keyed_ao_uniforms_kernel\(.*?\n}\n", text, re.S).group(0)
    assert "* 16u + kAoPurpose" in body
    assert "bits_at(sa, sc, 0u)" in body and "bits_at(sa, sc, 1u)" in body
    assert "kBatchedTag" not in body  # the lane key carries no purpose tag
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+keyed_ao_uniforms_kernel\(", text)


def _ulps(a, b):
    """|a - b| in float32 units in the last place (ordered bit patterns)."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(2**31) - i, i) for i in (ia, ib))
    return np.abs(ia - ib)


@pytest.mark.parametrize("tag0,n_tags", [(trng.REALISTIC_NOISE_TAG, 11),
                                         (trng.IDEAL_NOISE_TAG, 1), (7, 3)])
@pytest.mark.parametrize("sample", [0, 5, 2**31 + 1])
def test_camera_normals_match_jax(sample, tag0, n_tags):
    """``camera_normals_plain`` against ``jax.random.normal(fold_in(key,
    tag), (2,))`` on the sampler's (pixel, sample) keys, as the lens
    cameras draw them (realistic.py:248-252, :402-404): the uniforms'
    bits equal, the normals within 3 ulps (XLA fuses erf_inv's Horner
    steps into FMAs and has its own log1p); the wrapper on CPU tensors is
    the plain version and counts no launch."""
    pix = np.concatenate([PIXELS, np.arange(3000, dtype=np.int64) * 7 + 1])
    root = trng.root_key(17)
    keys = jrng.pixel_sample_key(jrng.root_key(17), jnp.asarray(pix, jnp.uint32),
                                 jnp.uint32(sample & 0xFFFFFFFF))
    tags = [jnp.uint32(tag0 + t) for t in range(n_tags)]
    lo = np.nextafter(np.float32(-1), np.float32(0))
    per_key = lambda fn: jax.jit(jax.vmap(lambda k: jnp.stack([fn(jax.random.fold_in(k, t))
                                                               for t in tags])))(keys)
    jn = np.asarray(per_key(lambda k: jax.random.normal(k, (2,))))
    ju = np.asarray(per_key(lambda k: jax.random.uniform(k, (2,), minval=lo, maxval=1.0)))
    tpix = torch.as_tensor(pix)
    tkeys = trng.fold_in(trng.pixel_sample_key(root, tpix, sample)[:, None, :],
                         torch.arange(tag0, tag0 + n_tags))
    tu = torch.clamp(trng._to_uniform(trng.bits(tkeys, 2)) * 2.0 + trng.NORMAL_LO,
                     min=trng.NORMAL_LO)
    _same_floats(tu.numpy(), ju)
    before = dict(trng.launches)
    for out in (trng.camera_normals_plain(root, tpix, sample, tag0, n_tags),
                trng.camera_normals(root, tpix, sample, tag0, n_tags)):
        assert out.shape == (len(pix), n_tags, 2) and out.dtype == torch.float32
        assert _ulps(out.numpy(), jn).max() <= 3
    assert trng.launches == before


def test_normals_cover_both_erfinv_branches():
    """Words whose uniforms reach |u| near 1 (w = -log1p(-u²) ≥ 5) take
    the far branch: against ``jax.random.normal``'s transform of the same
    words, within 3 ulps, and finite at the ends of the range."""
    words = np.concatenate([np.array([0, 1, 2**31, 2**32 - 1, 2**32 - 512, 511], np.uint64),
                            np.random.default_rng(4).integers(0, 2**32, 20000, np.uint64)])
    lo = np.nextafter(np.float32(-1), np.float32(0))
    f = ((words.astype(np.uint32) >> 9) | 0x3F800000).view(np.float32) - np.float32(1)
    u = jnp.maximum(lo, jnp.asarray(f) * (jnp.float32(1.0) - lo) + lo)
    ref = np.asarray(jax.jit(lambda x: jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(x))(u))
    out = trng.normals_from_bits(torch.as_tensor(words.astype(np.int64))).numpy()
    assert np.isfinite(out).all() and _ulps(out, ref).max() <= 3
    w = -np.log1p(-np.asarray(u, np.float64) ** 2)
    assert (w >= 5).sum() >= 2 and (w < 5).sum() > 10000


def test_camera_normals_kernel_constants_are_the_plain_versions():
    """rng.cu's erf_inv coefficients, √2 and the uniform's minval, read as
    text, are ``core/rng.py``'s float32 values; both normals kernels (a
    band's (row, tag) items; the one tag's rows) fold tag0 + t into the
    (pixel, sample) lane key, not a bounce tag, and draw counters 0 and 1
    through ``normal_from_bits``."""
    text = SOURCE.read_text()
    for name, ref in (("kErfInvSmall", trng.ERFINV_SMALL), ("kErfInvLarge", trng.ERFINV_LARGE)):
        body = re.search(rf"{name}\[9\] = \{{(.*?)\}};", text, re.S).group(1)
        vals = [np.float32(v.strip().rstrip("f")) for v in body.split(",")]
        assert vals == [np.float32(c) for c in ref]
    assert np.float32(re.search(r"const float lo = ([-0-9.]+)f;", text).group(1)) == \
        np.float32(trng.NORMAL_LO) == np.nextafter(np.float32(-1), np.float32(0))
    assert np.float32(re.search(r"\(p \* u\) \* ([0-9.]+)f;", text).group(1)) == \
        np.float32(trng.SQRT2_F32) == np.float32(np.sqrt(2))
    assert _cu_int("kNormalsPerTag") == 2
    body = re.search(r"keyed_camera_normals_kernel\(.*?\n}\n", text, re.S).group(0)
    assert "fold_in(k[i].x, k[i].y, tag0 + (next ? ta + i - n : ta + i));" in body
    assert "kBatchedTag" not in body and "kTagStep" not in body  # the tag steps by 1
    assert "bits_at(k[i].x, k[i].y, 0u)" in body and "bits_at(k[i].x, k[i].y, 1u)" in body
    assert body.count("normal_from_bits(w[") == 6
    rows = re.search(r"keyed_camera_normals_rows_kernel\(.*?\n}\n", text, re.S).group(0)
    assert "fold_in(a, c, sample);\n  fold_in(a, c, tag0);" in rows and "kBatchedTag" not in rows
    assert "bits_at(a, c, 0u), b1 = bits_at(a, c, 1u);" in rows
    assert "make_float2(normal_from_bits(b0), normal_from_bits(b1))" in rows


def test_sampler_and_volume_kernel_constants_are_the_plain_versions():
    """rng.cu's sampler codes, the media block's purpose tags, its march
    steps and uniforms per step, read as text, are ``core/rng.py``'s; the
    volume kernel's map folds g·16 + VOLUME into the lane key for jitter g
    (one column, counter 0) and k·16 + LIGHT_SAMPLE into bounce 0's VOLUME
    key (the lane key folded with VOLUME) for step k (3 columns, counters
    0-2), and its entry sizes the block J + 32·3."""
    text = SOURCE.read_text()
    enum = re.search(r"enum : int \{(.*?)\};", text, re.S).group(1)
    codes = dict((k, int(v)) for k, v in re.findall(r"k(\w+) = (\d+)", enum))
    assert codes == {"LowDiscrepancy": trng.LOWDISCREPANCY, "Halton": trng.HALTON,
                     "BestCandidate": trng.BESTCANDIDATE, "Random": trng.RANDOM,
                     "Stratified": trng.STRATIFIED}
    assert _cu_int("kVolumePurpose") == trng.VOLUME == 8
    assert _cu_int("kLightSamplePurpose") == trng.LIGHT_SAMPLE == 2
    assert _cu_int("kVolumeSteps") == trng.VOLUME_STEPS == 32
    assert _cu_int("kPerStep") == trng.PER_VOLUME_STEP == 3
    assert _cu_int("kTagStep") == 16
    body = re.search(r"struct VolumeMap \{.*?\n\};\n", text, re.S).group(0)
    assert "g * kTagStep + kVolumePurpose" in body and "if (o) fold_in(a, c, kVolumePurpose)" in body
    assert "(g - jitters) * kTagStep + kLightSamplePurpose" in body
    assert "jitters + (col - jitters) / kPerStep" in body and "kBatchedTag" not in body
    assert "col = g < jitters ? g : jitters + (g - jitters) * kPerStep;" in body
    assert "return g < jitters ? 1u : static_cast<unsigned>(kPerStep);" in body
    assert "unsigned counter(unsigned, unsigned i) const { return i; }" in body
    entry = re.search(r"int pbrt_torch_keyed_volume_uniforms\(.*?\n}\n", text, re.S).group(0)
    assert "steps = single ? kVolumeSteps : 0" in entry
    assert "width = n_jitter + steps * kPerStep" in entry
    assert re.search(r"__global__ void __launch_bounds__\(kMaxTileThreads\)\s+"
                     r"keyed_volume_uniforms_kernel\(", text)
    assert re.search(r"keyed_volume_uniforms_kernel\(.*?\{\s+keyed_tiles\(mp, tl,", text, re.S)
    assert re.search(r"__global__ void __launch_bounds__\(kRowMaxThreads\)\s+"
                     r"keyed_volume_rows_kernel\(.*?\{\s+keyed_rows\(mp, tl,", text, re.S)


@pytest.mark.parametrize("sampler", ["halton", "bestcandidate", "random", "stratified"])
def test_primary_array_keeps_its_bounce_block(sampler):
    """Another sampler changes only the five camera columns: the bounce
    block is lowdiscrepancy's, bit for bit, and a lowdiscrepancy array is
    today's (the default arguments)."""
    root, pix = trng.root_key(3), torch.as_tensor(PIXELS)
    scr = trng.pixel_scrambles_plain(root, pix)
    base = trng.primary_uniforms_plain(root, pix, scr, 5, 3)
    np.testing.assert_array_equal(
        base.numpy(), trng.primary_uniforms_plain(root, pix, scr, 5, 3, "lowdiscrepancy", 9).numpy())
    other = trng.primary_uniforms_plain(root, pix, scr, 5, 3, sampler, 4)
    np.testing.assert_array_equal(other[:, 5:].numpy(), base[:, 5:].numpy())
    assert not torch.equal(other[:, :5], base[:, :5])


def _jax_chain(keys, tags):
    """The JAX package's key chain: ``bounce_key(keys, tag // 16, tag % 16)``
    per tag, as its integrators fold them."""
    for tag in tags:
        keys = jrng.bounce_key(keys, tag // 16, tag % 16)
    return keys


@pytest.mark.parametrize("sample", [0, 5, 2**31 + 1])
def test_chain_draws_match_jax(sample):
    """Each chain the preprocess integrators draw, from ``chain_uniforms``
    (its plain version on CPU tensors) against the JAX package's own
    derivation from the same keys, bit for bit: the dipole's irradiance
    (root seed + 31, s·16 + LIGHT_SAMPLE, 3 uniforms; dipole.py:128-133),
    photon and VPL paths (5 uniforms, then b·16 + PHOTON, 3 each;
    photonmap.py:53-57, :96-97, igi.py:45-49, :76-77), IGI's picks
    (b·16 + PHOTON then k·16 + PHOTON, 1 each; path.py:611, igi.py:111-112),
    the cache's gather directions ((salt + k)·16 + BSDF_SAMPLE, 2) and its
    nested traces' BatchedKeySource blocks (irradiance.py:74,
    path.py:115-120)."""
    idx = PIXELS
    keys = jrng.pixel_sample_key(jrng.root_key(7), jnp.asarray(idx.astype(np.uint32)),
                                 jnp.uint32(sample))
    t = lambda **kw: trng.chain_uniforms(trng.root_key(7), torch.as_tensor(idx), sample,
                                         **kw).numpy()
    same = lambda a, b: np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                                      np.asarray(b).view(np.int32))
    same(t(n=5), jrng.uniform_per(keys, 5))
    for count, purpose, n in ((4, trng.LIGHT_SAMPLE, 3), (5, trng.PHOTON, 3)):
        ref = np.concatenate([jrng.uniform_per(_jax_chain(keys, [s * 16 + purpose]), n)
                              for s in range(count)], -1)
        same(t(chain=[(purpose, count)], n=n), ref)
    ref = np.concatenate([jrng.uniform_per(jrng.bounce_key(jrng.bounce_key(keys, b, jrng.PHOTON),
                                                            k, jrng.PHOTON), 1)
                          for b in range(3) for k in range(8)], -1)
    same(t(chain=[(trng.PHOTON, 3), (trng.PHOTON, 8)]), ref)
    for salt in (100, 300):
        ref = np.concatenate([jrng.uniform_per(jrng.bounce_key(keys, salt + k, jrng.BSDF_SAMPLE),
                                               2) for k in range(4)], -1)
        same(t(chain=[(salt * 16 + trng.BSDF_SAMPLE, 4)], n=2), ref)
        depth = 3
        blocks = t(chain=[((salt + 100) * 16 + trng.CAMERA, 4), trng.BATCHED],
                   n=7 * depth, used=7, drawn=8, lead=5)
        assert blocks.shape == (len(idx), 5 + 4 * 7 * depth) and not blocks[:, :5].any()
        for k in range(4):
            src = BatchedKeySource(jrng.bounce_key(keys, salt + 100 + k, jrng.CAMERA), depth)
            ref = np.asarray(src.u)[..., :7].reshape(len(idx), -1)
            same(blocks[:, 5 + 7 * depth * k:5 + 7 * depth * (k + 1)], ref)


def test_chain_draws_layout_and_checks():
    """Row-major groups (the first tag outermost), ``lead`` zero columns,
    the 7-of-8 counters, and the wrapper's refusals; CPU tensors take the
    plain version and launch nothing."""
    idx = torch.arange(9, dtype=torch.int64)
    root = trng.root_key(2)
    before = dict(trng.launches)
    full = trng.chain_uniforms(root, idx, 0, chain=[(3, 2), 7, (9, 3)], n=2, lead=1)
    assert full.shape == (9, 1 + 2 * 3 * 2) and not full[:, 0].any()
    for a in range(2):
        for c in range(3):
            one = trng.chain_uniforms(root, idx, 0, chain=[3 + 16 * a, 7, 9 + 16 * c], n=2)
            g = 1 + 2 * (3 * a + c)
            assert torch.equal(full[:, g:g + 2], one)
    every = trng.chain_uniforms(root, idx, 0, chain=[15], n=16)
    used = trng.chain_uniforms(root, idx, 0, chain=[15], n=14, used=7, drawn=8)
    assert torch.equal(used, every.view(9, 2, 8)[:, :, :7].reshape(9, 14))
    assert trng.launches == before
    with pytest.raises(ValueError):
        trng.chain_uniforms(root, idx, 0, chain=[1, 2, 3, 4, 5])
    with pytest.raises(ValueError):
        trng.chain_uniforms(root, idx, 0, n=4, used=3, drawn=2)


def test_chain_kernel_constants_are_the_plain_versions():
    """rng.cu's chain kernel takes at most ``MAX_CHAIN`` tags (the outer
    ones and the last) and steps a varying tag by 16 (bounce_key's index ·
    16 + purpose), draws counter (i / used)·drawn + i mod used of a group's
    column i, and the wrapper's map and tiling are the words its structs
    hold, read as text."""
    text = SOURCE.read_text()
    assert _cu_int("kMaxChain") == trng.MAX_CHAIN == 4
    assert re.search(r"constexpr uint32_t kTagStep = 16u;", text)
    assert _cu_int("kMaxTileThreads") == trng.TILE_MAX_THREADS
    assert _cu_int("kMaxTileCols") == trng.TILE_MAX_COLS
    assert re.search(r"constexpr unsigned kMaxTileBytes = 48u \* 1024u;", text)
    assert trng.TILE_MAX_BYTES == 48 * 1024
    body = re.search(r"struct ChainMap \{.*?\n\};\n", text, re.S).group(0)
    assert "uint32_t base[kMaxChain - 1];" in body and "Div count[kMaxChain - 1];" in body
    assert "fold_in(a, c, base[i] + kTagStep * idx[i])" in body
    assert "fold_in(a, c, last_base + kTagStep * (g - outer_of(g) * last.d))" in body
    assert "ctr = counter(g, j - g * n.d);" in body
    assert "const unsigned b = div_by(i, used);" in body
    assert "return b * drawn + (i - b * used.d);" in body
    # the structs' words, in the order the wrapper packs them
    def words(name):
        body = re.search(rf"struct {name} \{{(.*?)\n}};", text, re.S).group(1)
        decls = re.findall(r"^\s*(uint32_t|Div) ([^;(]+);", body.split("__device__")[0], re.M)
        return sum((3 if kind == "Div" else 1) * (MAX_CHAIN_OUTER if "[kMaxChain - 1]" in v
                                                  else 1)
                   for kind, names in decls for v in names.split(","))
    assert words("Tiling") == 14 == trng.volume_tiling(7, 5, True).size
    assert words("ChainMap") == 26 == trng.chain_map(((3, 2),), 1, 1, 1, 0).size
    assert re.search(r"__global__ void __launch_bounds__\(kMaxTileThreads\)\s+"
                     r"keyed_chain_uniforms_kernel\(", text)
    assert re.search(r"__global__ void __launch_bounds__\(kRowMaxThreads\)\s+"
                     r"keyed_chain_rows_kernel\(.*?\{\s+keyed_rows\(mp, tl,", text, re.S)


MAX_CHAIN_OUTER = trng.MAX_CHAIN - 1


def div_by(x, div):
    """x // d by the kernel's multiply and shift, x a uint64 numpy array
    (or int) below 2**31."""
    _, m, s = div
    return (np.asarray(x, np.uint64) * np.uint64(m)) >> np.uint64(s)


def tile_plan(tiling, kind: str, mp):
    """``csrc/rng.cu``'s tiled kernels' arithmetic on a launch's constants,
    in numpy: ``kind`` "chain" (``mp`` the ``chain_map`` words) or "volume"
    (``mp`` (J, single)). Per column of the row (the same for every band
    of rows): ``zero`` (a lead column), ``ctr`` (the uniform's counter),
    ``tags`` ((width, k) int64: the tags its key folds into the lane key,
    in order; −1 pads a chain's shorter ones); ``slots_ok``: every tile's
    group and outer keys inside the tile row's slots; ``covers_once``: the
    block's threads, stepping as the kernel steps them, store each element
    of the first tile once; ``tiling``, the words as ints."""
    t = [int(w) for w in tiling]
    width, rows, col_tiles, threads, pass_rows = t[0:5]
    cols, outer_div, groups_div = tuple(t[5:8]), tuple(t[8:11]), tuple(t[11:14])
    col = np.arange(width, dtype=np.uint64)
    if kind == "volume":
        J, single = int(mp[0]), bool(mp[1])
        step = (col.astype(np.int64) - J) // trng.PER_VOLUME_STEP
        g = np.where(col < J, col.astype(np.int64), J + step)
        zero = np.zeros(width, bool)
        ctr = np.where(col < J, 0, col.astype(np.int64) - J - step * trng.PER_VOLUME_STEP)
        outer_of = lambda gg: (np.asarray(gg) >= J).astype(np.int64)
        tags = np.stack([np.where(col < J, col.astype(np.int64) * 16 + trng.VOLUME, trng.VOLUME),
                         np.where(col < J, -1, step * 16 + trng.LIGHT_SAMPLE)], -1)
    else:
        w = [int(x) for x in mp]
        n_outer, has_last, lead, drawn = w[0:4]
        base = w[4:4 + trng.MAX_CHAIN - 1]
        counts = [tuple(w[7 + 3 * i:10 + 3 * i]) for i in range(trng.MAX_CHAIN - 1)]
        last_base, last, n, used = w[16], tuple(w[17:20]), tuple(w[20:23]), tuple(w[23:26])
        zero = col < lead
        j = np.where(zero, 0, col - np.uint64(lead)).astype(np.uint64)
        g = div_by(j, n) if n[0] else np.zeros(width, np.uint64)
        i = j - g * np.uint64(n[0])
        b = div_by(i, used)
        ctr = (b * np.uint64(drawn) + (i - b * np.uint64(used[0]))).astype(np.int64)
        outer_of = lambda gg: div_by(gg, last).astype(np.int64)
        o = div_by(g, last)
        digits = []
        for k in range(n_outer - 1, -1, -1):
            q = div_by(o, counts[k])
            digits.insert(0, o - q * np.uint64(counts[k][0]))
            o = q
        cols_tags = [np.int64(base[k]) + 16 * digits[k].astype(np.int64) for k in range(n_outer)]
        if has_last:
            cols_tags.append(last_base + 16 * (g - div_by(g, last) * np.uint64(last[0]))
                             .astype(np.int64))
        tags = (np.stack(cols_tags, -1) if cols_tags else np.zeros((width, 0), np.int64))
        tags = np.where(zero[:, None], -1, tags)
        g = g.astype(np.int64)
    ok = True
    for tile in range(col_tiles):
        c0, c1 = tile * cols[0], min((tile + 1) * cols[0], width)
        live = ~zero[c0:c1]
        if live.any():
            gg = g[c0:c1][live]
            g0, g1 = int(gg.min()), int(gg.max()) + 1
            o0 = int(outer_of(g0))
            ok &= not pass_rows or g1 - g0 <= groups_div[0]  # keyed_rows stages no key
            ok &= int(outer_of(g1 - 1)) + 1 - o0 <= outer_div[0]
    # each thread's (row, column) elements of a full tile, as the kernel
    # steps them: every element of the tile once
    hits = np.zeros((rows, cols[0]), np.int64)
    small = kind == "volume" or n[0] == 1  # a group's key and its uniforms one thread's
    if pass_rows and small:  # a thread a (row, group): the group's columns in the tile
        live = ~zero[:cols[0]]
        hits[:, ~live] += 1  # the lead's zeros, a thread a (row, column)
        for gg in np.unique(g[:cols[0]][live]):
            hits[:, (g[:cols[0]] == gg) & live] += 1
    for th in range(threads * (not (pass_rows and small))):
        if not pass_rows:  # keyed_rows: its row's groups s, s + slots, …; s 0 the zeros
            rr, s_ = divmod(th, groups_div[0])
            if rr < rows:
                hits[rr, np.where(zero, s_ == 0, g % groups_div[0] == s_)] += 1
            continue
        if cols[0] > threads:
            r_first, step, qs = 0, 1, range(th, cols[0], threads)
        else:
            r_first, step = int(div_by(th, cols)), pass_rows
            qs = [th - r_first * cols[0]] if r_first < step else []
        for q in qs:
            hits[r_first::step, q] += 1
    return dict(tiling=t, zero=zero, ctr=ctr, tags=tags, slots_ok=bool(ok),
                covers_once=bool((hits == 1).all()))


#: every shape the integrators call (name → chain_uniforms keywords, or the
#: volume block's (J, single)), shortest to widest, and ragged ones
TILE_SHAPES = {
    "volume emission": (5, False),
    "cache directions": dict(chain=[(100 * 16 + trng.BSDF_SAMPLE, 4)], n=2),
    "AO directions": dict(chain=[(trng.BSDF_SAMPLE, 4)], n=2, lead=trng.CAMERA_DIMS),
    "cache jitters": dict(chain=[(416 * 16 + trng.CAMERA, 4), (trng.VOLUME, 5)]),
    "VPL picks": dict(chain=[(trng.PHOTON, 5), (trng.PHOTON, 8)]),
    "bounce block": dict(chain=[trng.BATCHED], n=35, used=7, drawn=8, lead=trng.CAMERA_DIMS),
    "volume single": (5, True),
    "nested blocks": dict(chain=[(416 * 16 + trng.CAMERA, 4), trng.BATCHED], n=35, used=7,
                          drawn=8, lead=5),
    "glossyprt": dict(chain=[(trng.BSDF_SAMPLE, 64)], n=3),
    "cache steps": dict(chain=[(416 * 16 + trng.CAMERA, 4), trng.VOLUME,
                               (trng.LIGHT_SAMPLE, 32)], n=3),
    "volume jitters only, wide": (1500, False),
    "volume single, 1 jitter": (1, True),
    "volume steps only": (0, True),
    "no tag": dict(n=5),
    "ragged": dict(chain=[3, (7, 3), 11, (2**32 - 33, 3)], n=9, used=4, drawn=6, lead=2),
    "lead only": dict(chain=[(5, 2)], n=0, used=1, lead=3),
    "one column a group, wide": dict(chain=[(trng.PHOTON, 1300)]),
    "two varying, 7 of 8": dict(chain=[(9, 5), (12, 6)], n=23, used=7, drawn=8, lead=1),
    "a row a thread": dict(chain=[(9, 6)], lead=2),
    "a row a thread, 2 a group, 1 of 5": dict(chain=[(9, 3)], n=2, used=1, drawn=5, lead=1),
}


def _plan(name, R, max_cols=None, monkeypatch=None):
    """(tile_plan of the shape's launch on R rows, the plain layout: per
    column the tags its key folds and its counter, −1 padding)."""
    if max_cols is not None:
        monkeypatch.setattr(trng, "TILE_MAX_COLS", max_cols)
    spec = TILE_SHAPES[name]
    if isinstance(spec, tuple):
        J, single = spec
        plan = tile_plan(trng.volume_tiling(R, J, single), "volume", spec)
        tags = [[16 * b + trng.VOLUME, -1] for b in range(J)]
        tags += [[trng.VOLUME, 16 * k + trng.LIGHT_SAMPLE] for k in range(32 * single)
                 for _ in range(3)]
        ctr = [0] * J + [c for _ in range(32 * single) for c in range(3)]
        return plan, np.array(tags, np.int64).reshape(-1, 2), np.array(ctr)
    kw = dict(spec)
    tags = trng._chain_tags(kw.pop("chain", ()))
    n, lead = kw.get("n", 1), kw.get("lead", 0)
    used, drawn = trng._chain_counters(n, kw.get("used"), kw.get("drawn"))
    plan = tile_plan(trng.chain_tiling(R, tags, n, lead), "chain",
                          trng.chain_map(tags, n, used, drawn, lead))
    counts = [c for _, c in tags]
    G = int(np.prod(counts)) if tags else 1
    ref_tags = np.full((lead + G * n, len(tags)), -1, np.int64)
    ref_ctr = np.zeros(lead + G * n, np.int64)
    for col in range(lead, lead + G * n):
        g, j = divmod(col - lead, n)
        digits = np.unravel_index(g, counts) if tags else ()
        ref_tags[col] = [b + 16 * int(i) for (b, _), i in zip(tags, digits)]
        ref_ctr[col] = j // used * drawn + j % used
    return plan, ref_tags, ref_ctr


@pytest.mark.parametrize("max_cols", [None, 7, 64])
@pytest.mark.parametrize("name", list(TILE_SHAPES))
def test_tile_map_is_the_plain_layout(name, max_cols, monkeypatch):
    """The host's constants (``volume_tiling``, ``chain_map``,
    ``chain_tiling``) under the kernels' multiply-shift arithmetic
    (``tile_plan``) give every column the plain version's key (its tags,
    the groups in row-major order) and counter ((j // used)·drawn + j mod
    used), lead columns zero, on every shape the integrators call and
    ragged ones, a row in one tile and cut into tiles of 7 and 64 columns;
    every tile's groups and outer keys fit its slots, and the block's
    threads store each element of a tile once."""
    for R in (32768, 4093, 7, 1):
        plan, tags, ctr = _plan(name, R, max_cols, monkeypatch)
        live = ~plan["zero"]
        assert plan["tags"].shape == tags.shape
        np.testing.assert_array_equal(plan["tags"][live], tags[live])
        np.testing.assert_array_equal(plan["ctr"][live], ctr[live])
        assert not plan["zero"][TILE_SHAPES[name].get("lead", 0):].any() \
            if isinstance(TILE_SHAPES[name], dict) else not plan["zero"].any()
        assert plan["slots_ok"] and plan["covers_once"]
        # the entry's checks of the tiling (csrc/rng.cu tiling_ok)
        tl = plan["tiling"]
        width, rows, col_tiles, threads, k, cols = tl[:6]
        assert 32 <= threads <= trng.TILE_MAX_THREADS and threads % 32 == 0
        if k == 0:  # keyed_rows: a few uniforms in narrow groups, outer key the lane key
            assert col_tiles == 1 and (plan["tags"] >= 0).sum(1).max() <= 1
            assert threads <= trng.ROW_MAX_THREADS == _cu_int("kRowMaxThreads")
            assert live.sum() <= trng.ROW_UNIFORMS == _cu_int("kRowUniforms")
            _, per_group = np.unique(plan["tags"][live], axis=0, return_counts=True)
            assert per_group.max() <= trng.ROW_COLS == _cu_int("kRowCols")
            # a thread a row where a group is one uniform, else a thread a group
            slots = tl[11]
            assert slots == (1 if per_group.max() == 1 else per_group.size)
            assert rows * slots <= threads < rows * slots + 32
        else:
            assert (k == 1) if cols > threads else k * cols <= threads
        assert col_tiles == -(-width // cols) and 1 <= cols <= width
        assert cols == width or cols <= trng.TILE_MAX_COLS
        assert rows >= 1 and 8 * rows * (1 + tl[8] + tl[11]) * (k > 0) <= trng.TILE_MAX_BYTES


@pytest.mark.parametrize("name", ["AO directions", "a row a thread, 2 a group, 1 of 5",
                                  "cache jitters", "VPL picks",
                                  "bounce block", "nested blocks", "ragged", "volume single",
                                  "volume steps only"])
def test_tile_map_draws_the_plain_bits(name):
    """The uniforms the kernels' map draws (each column's tags folded into
    the (index, sample) lane key in order, then its counter) equal the
    plain version's bit for bit, indices at and above 2**31 included."""
    root, idx = trng.root_key(7), torch.as_tensor(PIXELS)
    plan, _, _ = _plan(name, len(PIXELS))
    keys = trng.pixel_sample_key(root, idx, 2**31 + 1)[:, None, :].expand(-1, plan["ctr"].size,
                                                                          -1)
    for k in range(plan["tags"].shape[1]):
        tag = torch.as_tensor(plan["tags"][:, k])
        keys = torch.where((tag >= 0)[None, :, None], trng.fold_in(keys, tag.clamp(min=0)), keys)
    k0, k1 = keys[..., 0], keys[..., 1]
    c = torch.as_tensor(plan["ctr"]).expand_as(k0)
    y0, y1 = trng.threefry2x32(k0, k1, torch.zeros_like(c), c)
    out = torch.where(torch.as_tensor(plan["zero"])[None], 0.0, trng._to_uniform(y0 ^ y1))
    spec = TILE_SHAPES[name]
    ref = (trng.volume_uniforms_plain(root, idx, 2**31 + 1, *spec) if isinstance(spec, tuple)
           else trng.chain_uniforms_plain(root, idx, 2**31 + 1, **spec))
    _same_floats(out.numpy(), ref.numpy())


def normals_cover(words, R: int, T: int) -> dict:
    """``csrc/rng.cu:keyed_camera_normals_kernel``'s arithmetic on a
    ``normals_launch``, in numpy: block b's band of rows r0 = b·band …, its
    lane keys (thread t: rows 2t and min(2t + 1, rows − 1), stepping by two
    a thread), then thread t's items p = items·t, stepping by
    items·threads: row p / T by the launch's divisor, tag p − row·T, and
    for a second item past the row's end the next row's tag 0, stored as
    pair r0·T + p + i (the second only where p + 1 < the band's items). →
    the times each (row, tag) pair is stored (``hits``), the row and tag
    each pair's key folds (``row``, ``tag``), the times each lane key is
    staged (``keys``), and whether every 16-byte store is aligned."""
    band, threads, items, d, m, s = (int(x) for x in words)
    hits = np.zeros(R * T, np.int64)
    row = np.full(R * T, -1, np.int64)
    tag = np.full(R * T, -1, np.int64)
    keys = np.zeros(R, np.int64)
    aligned = True
    for r0 in range(0, R, band):
        rows = min(band, R - r0)
        k = np.arange(0, rows, 2)
        keys[r0 + k] += 1
        keys[r0 + np.minimum(k + 1, rows - 1)] += k + 1 < rows  # rows − 1 twice: one store
        p = np.arange(0, rows * T, items, dtype=np.uint64)
        assert ((p // np.uint64(items)) % np.uint64(threads) < threads).all()
        r = div_by(p, (d, m, s)).astype(np.int64)
        ta = p.astype(np.int64) - r * T
        for i in range(items):
            live = p.astype(np.int64) + i < rows * T if i else np.ones(p.size, bool)
            nxt = ta + i >= T
            q = r0 * T + p.astype(np.int64)[live] + i
            np.add.at(hits, q, 1)
            row[q] = r0 + np.minimum(np.where(nxt, r + 1, r), rows - 1)[live]
            tag[q] = np.where(nxt, ta + i - T, ta + i)[live]
        aligned &= items == 1 or (2 * r0 * T) % 4 == 0
    return dict(hits=hits, row=row, tag=tag, keys=keys, aligned=aligned)


@pytest.mark.parametrize("n_tags", [1, 11, 17, 33])
def test_normals_launch_covers_the_plain_layout(n_tags):
    """``normals_launch``'s words under the band kernel's arithmetic
    (``normals_cover``): every (row, tag) pair of (R, T, 2) is stored once,
    its key folds tag0 + t into its own row's lane key, each row's lane key
    is staged once, 16-byte stores land aligned, blocks stay within
    ``NORMAL_THREADS``, on ragged lane counts and at one and two items a
    thread; the pairs' keys and counters 0 and 1 hashed through
    ``normals_from_bits`` equal ``camera_normals_plain`` bit for bit."""
    for R in (32768, 4096, 4093, 7, 1):
        words = trng.normals_launch(R, n_tags)
        band, threads, items = (int(w) for w in words[:3])
        assert band % 2 == 0 and 32 <= threads <= trng.NORMAL_THREADS and threads % 32 == 0
        assert items == (2 if R * n_tags >= trng.NORMAL_PAIR_MIN_ITEMS * 132 else 1)
        assert tuple(int(w) for w in words[3:]) == trng.divisor(n_tags)
        cover = normals_cover(words, R, n_tags)
        assert (cover["hits"] == 1).all() and (cover["keys"] == 1).all() and cover["aligned"]
        np.testing.assert_array_equal(cover["row"], np.repeat(np.arange(R), n_tags))
        np.testing.assert_array_equal(cover["tag"], np.tile(np.arange(n_tags), R))
    tag0 = trng.IDEAL_NOISE_TAG if n_tags == 1 else trng.REALISTIC_NOISE_TAG
    root, idx = trng.root_key(7), torch.as_tensor(PIXELS)
    cover = normals_cover(trng.normals_launch(len(PIXELS), n_tags), len(PIXELS), n_tags)
    lane = trng.pixel_sample_key(root, idx, 2**31 + 1)[torch.as_tensor(cover["row"])]
    keys = trng.fold_in(lane, torch.as_tensor(tag0 + cover["tag"]))
    c = torch.tensor([0, 1]).expand(keys.shape[0], 2)
    y0, y1 = trng.threefry2x32(keys[:, None, 0], keys[:, None, 1], torch.zeros_like(c), c)
    ref = trng.camera_normals_plain(root, idx, 2**31 + 1, tag0, n_tags)
    _same_floats(trng.normals_from_bits(y0 ^ y1).numpy(), ref.reshape(-1, 2).numpy())


def mutate_cover(plan, N: int, D: int) -> dict:
    """``csrc/rng.cu:mlt_mutate_kernel``'s arithmetic on a ``mutate_plan``,
    in numpy: block b's band of chains r0 = b·band …; its flag threads (t <
    rows hashes chain r0 + t's U(k4); from the next whole warp a0 on, t − a0
    its U(ka)); its
    warps' tasks j (a whole tile of chain j / full, then the tails of
    ``pack`` chains each, the lane split by the tail's divisor), as the
    warps step them until a pack's first chain passes the band. → the
    times each element is written (``hits``), each chain's flags and
    accept uniforms hashed, and whether every element's counter r·D + col
    lies in its chain's row."""
    w = [int(x) for x in plan]
    band, full, tail, pack = w[:4]
    tiles, tails = tuple(w[4:7]), tuple(w[7:10])
    blocks = -(-N // band)
    r0 = np.arange(blocks, dtype=np.int64) * band
    rows = np.minimum(band, N - r0)
    t = np.arange(trng.MUTATE_THREADS)
    acc0 = -(-rows // 32) * 32  # the accept uniforms from the next whole warp on
    assert (acc0 + rows <= trng.MUTATE_THREADS).all()
    flags = np.bincount((r0[:, None] + t)[t < rows[:, None]], minlength=N)
    accs = np.bincount((r0[:, None] + t - acc0[:, None])[(t >= acc0[:, None])
                                                          & (t < (acc0 + rows)[:, None])],
                       minlength=N)
    lanes = np.arange(trng.MUTATE_TILE, dtype=np.int64)
    chains, cols = [], []
    if full:  # task j < rows·full: chain j / full, its tile j mod full, a lane a column
        j = np.arange(band * full, dtype=np.int64)
        r = div_by(j, tiles).astype(np.int64)
        col = (j - r * full)[:, None] * trng.MUTATE_TILE + lanes
        ok = (j < (rows * full)[:, None])[..., None] & np.ones_like(col, bool)
        chains.append(np.broadcast_to((r0[:, None] + r)[..., None], ok.shape)[ok])
        cols.append(np.broadcast_to(col, ok.shape)[ok])
    if tail:  # then a warp a pack: lane → (chain sub of the pack, column tc)
        sub = div_by(lanes, tails).astype(np.int64)
        tc = lanes - sub * tail
        first = np.arange(-(-band // pack), dtype=np.int64) * pack
        r = first[:, None] + sub
        ok = (first[None, :, None] < rows[:, None, None]) & (sub < pack) \
            & (r[None] < rows[:, None, None])
        chains.append(np.broadcast_to(r0[:, None, None] + r, ok.shape)[ok])
        cols.append(np.broadcast_to(full * trng.MUTATE_TILE + tc, ok.shape)[ok])
    chain, col = np.concatenate(chains), np.concatenate(cols)
    e = chain * D + col
    return dict(hits=np.bincount(e, minlength=N * D), flags=flags, accs=accs,
                in_row=bool(((col >= 0) & (col < D)).all() and (e < N * D).all()))


@pytest.mark.parametrize("D", [1, 30, 32, 40, 60, 61, 64, 65])
def test_mutate_plan_covers_each_element_once(D):
    """``mutate_plan``'s words under the mutation kernel's arithmetic
    (``mutate_cover``): every element of (N, D) written once, in its own
    chain's row, each chain's flag and accept uniform hashed once, the band
    within the block's flag threads, whole packs, and as many bands as an
    H100 holds blocks (132 SMs × 8), on ragged chain counts and one past the
    band's cap."""
    for N in (16384, 4093, 7, 1, 140001):
        plan = trng.mutate_plan(N, D)
        band, full, tail, pack = (int(x) for x in plan[:4])
        assert (full, tail) == divmod(D, 32) and pack == (32 // tail if tail else 0)
        assert 1 <= band <= trng.MUTATE_MAX_BAND and 2 * band <= trng.MUTATE_THREADS
        assert not pack or band % pack == 0
        assert -(-N // band) <= 132 * trng.MUTATE_BLOCKS_PER_SM or band > 128 - (pack or 1)
        cover = mutate_cover(plan, N, D)
        assert cover["in_row"] and (cover["hits"] == 1).all()
        assert (cover["flags"] == 1).all() and (cover["accs"] == 1).all()


def wrap_select(x):
    """``csrc/rng.cu:wrap_remainder`` in float32 numpy: for x in (−1, 2) x −
    1 where x ≥ 1, x + 1 where x < 0, else x; elsewhere fmodf(x, 1), plus 1
    where below 0."""
    x = np.asarray(x, np.float32)
    one = np.float32(1)
    sel = np.where(x >= one, x - one, np.where(x < 0, x + one, x))
    m = np.fmod(x, one)
    return np.where((x > -one) & (x < np.float32(2)), sel, np.where(m < 0, m + one, m))


def test_mutation_wrap_is_torch_remainder():
    """The kernel's wrap (``wrap_select``) equals ``torch.remainder(x, 1.0)``,
    the plain version's, bit for bit: on a dense u × eps × sign grid of the
    small step (x = u + sign·s2·exp(−log(s2/s1)·eps) in float32), at u = 0
    and 1 − ulp, where u ± delta lands on 0, on 1 or just below 0 (→ 1.0),
    at ±0.0, and outside (−1, 2) where fmodf takes over."""
    gen = np.random.default_rng(22)
    u = np.concatenate([np.linspace(0, 1, 1025, dtype=np.float32)[:-1],
                        gen.random(1024, dtype=np.float32),
                        [0.0, np.nextafter(np.float32(1), np.float32(0)), 2**-24, 1 / 16,
                         1 - 1 / 16, 1 / 1024, 1 - 1 / 1024]]).astype(np.float32)
    eps = np.concatenate([np.arange(0, 2**23, 2**14, dtype=np.int64) * 2.0**-23,
                          [1 - 2.0**-23]]).astype(np.float32)
    delta = (np.float32(trng.MUTATE_S2)
             * torch.exp(trng.neg_log_ratio(trng.MUTATE_S1, trng.MUTATE_S2)
                         * torch.as_tensor(eps)).numpy()).astype(np.float32)
    edges = np.concatenate([delta, np.float32(1) - delta,  # u - delta on 0, u + delta on 1
                            np.nextafter(delta, np.float32(0)),  # u - delta just below 0
                            np.nextafter(np.float32(1) - delta, np.float32(2))])
    u = np.concatenate([u, edges]).astype(np.float32)
    x = [u[:, None] + s * delta[None, :] for s in (np.float32(-1), np.float32(1))]
    x = np.concatenate([v.ravel() for v in x] + [np.array(
        [0.0, -0.0, -1e-10, -2**-149, 2**-149, 1.0, 1 - 2**-24, -1 + 2**-24, 2 - 2**-23,
         -1.0, 2.0, 1.5, -0.5, 3.25, -3.25, -1.0 - 2**-23, 17.75, -1e6], np.float32)])
    x = x.astype(np.float32)
    want = torch.remainder(torch.as_tensor(x), 1.0).numpy()
    _same_floats(wrap_select(x), want)
    assert (x == 0).sum() >= 2 and (want == 1).any() and ((x < 0) & (x > -1)).sum() > 1000


def test_launch_words_are_memoised():
    """The wrappers' per-launch words (``volume_words``, ``chain_words``,
    ``mutate_words``) are computed once per launch shape: a second call
    returns the same tuple, whose (address, size) pairs are those of
    read-only arrays equal to ``volume_tiling``'s, ``chain_map``'s and
    ``chain_tiling``'s and ``mutate_plan``'s words computed afresh;
    ``normals_words`` is ``normals_launch``'s words as ints, once."""
    tags = trng._chain_tags([(trng.BSDF_SAMPLE, 4)])
    for memo, args, fresh in (
            (trng.volume_words, (32768, 5, False, 132), [trng.volume_tiling(32768, 5, False, 132)]),
            (trng.mutate_words, (16384, 60, 132), [trng.mutate_plan(16384, 60, 132)]),
            (trng.chain_words, (32768, tags, 2, 2, 2, 5, 132),
             [trng.chain_map(tags, 2, 2, 2, 5), trng.chain_tiling(32768, tags, 2, 5, 132)])):
        words, arrays = memo(*args)
        assert memo(*args) is memo(*args)
        assert words == tuple(v for a in arrays for v in (a.ctypes.data, a.size))
        for a, b in zip(arrays, fresh, strict=True):
            np.testing.assert_array_equal(a, b)
            with pytest.raises(ValueError):
                a[0] = 1
    words = trng.normals_words(32768, 11, 132)
    assert trng.normals_words(32768, 11, 132) is words
    assert words == tuple(int(w) for w in trng.normals_launch(32768, 11, 132))


def test_divisor_is_exact():
    """``divisor``'s multiply and shift is x // d for every x < 2**31: d
    from 1 to 1,100, near powers of two up to 2**31 − 1, against x at 0,
    d·k ± 1 and 2**31 − 1 and 20,000 random x; it refuses d ≥ 2**31."""
    rng_ = np.random.default_rng(5)
    ds = list(range(1, 1101)) + [2**k + e for k in range(11, 31) for e in (-1, 0, 1)]
    ds += [2**31 - 1] + rng_.integers(1, 2**31, 200).tolist()
    xs = np.concatenate([rng_.integers(0, 2**31, 20000), [0, 1, 2**31 - 1, 2**30]])
    for d in ds:
        dv = trng.divisor(d)
        assert dv[1] < 2**32 and 31 <= dv[2] <= 62
        near = np.clip(np.array([d - 1, d, d + 1, 3 * d - 1, 3 * d, 2**31 - 1 - d]), 0,
                       2**31 - 1)
        x = np.concatenate([xs, near]).astype(np.uint64)
        np.testing.assert_array_equal(div_by(x, dv), x // np.uint64(d))
    assert trng.divisor(0) == (0, 0, 0)
    with pytest.raises(ValueError):
        trng.divisor(2**31)
