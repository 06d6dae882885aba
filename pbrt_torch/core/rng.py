"""Counter-based random numbers keyed by what they are for (port of
``pbrt_tpu/core/rng.py``; reference: core/rng.{h,cpp}, which seeds one
Mersenne Twister per task instead).

Every number is a pure function of (seed, pixel, sample, bounce, purpose)
through threefry-2x32 keys, so a seed gives the same bits on the CPU and on
the card, whatever the chunking, and the same bits as the JAX package.
The functions are bit-exact to ``jax.random`` as the JAX package runs it
(jax 0.9.0, ``jax_threefry_partitionable`` on, 64-bit types off):

- a key is two 32-bit words; ``root_key(seed)`` is ``jax.random.key(seed)``'s
  key data, ``[0, seed mod 2**32]`` (with 64-bit types off, jax wraps a
  Python int seed to 32 bits before it splits it into hi / lo words);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))`` (prng.py
  ``_threefry_fold_in``: the data seeds a key ``[0, d]`` that is hashed);
- ``bits(key, n)[i]`` is ``y0 ^ y1`` of ``threefry2x32(key, (0, i))``
  (prng.py ``_threefry_random_bits_partitionable``, 32-bit output);
- a uniform is ``((bits >> 9) | 0x3F800000)`` read as float32, minus 1.

Words are held in int64 tensors masked to 32 bits: PyTorch has no uint32
arithmetic on the CPU. Shifts stay below 2**63 (a word shifted by at most
31 bits) and every sum is masked back.

The render's arrays of keyed numbers come from CUDA kernels
(``csrc/rng.cu``) when the pixel indices lie on the card, and from the
plain versions here when they lie on the CPU; both give the same bits:

- ``primary_uniforms`` — a wave's (R, 5 + 7·D) primary-sample array for
  sample s: the lowdiscrepancy camera columns from the pixels' scramble
  words (``sampling.camera_uniforms``, sampler.py:41-48), then the
  (R, 7·D) bounce block from ``bounce_key(pixel_sample_key(root, pixel,
  s), 0, BATCHED)`` as ``BatchedKeySource`` draws it (path.py:115-120):
  8·D uniforms read as (D, 8) blocks [light_sel, light_u1, light_u2,
  bsdf_lobe, bsdf_u1, bsdf_u2, rr, spare], with ``spare`` dropped;
- ``ao_uniforms`` — ambient occlusion's (R, 5 + 2·n) array for sample s:
  the camera columns, then for each AO sample j the two uniforms
  ``uniform_per(bounce_key(pixel_sample_key(root, pixel, s), j,
  BSDF_SAMPLE), 2)`` that ``_ao_li`` draws (path.py:783-784);
- the camera columns of both arrays follow the scene's sampler
  (``camera_columns_plain``, sampler.py:31-88): lowdiscrepancy's (0,2)
  pairs and van der Corput time (``adaptive`` takes them too); halton's
  radical inverses of n in bases 2, 3, 5, 7, 11, each shifted by the
  unit float of a scramble word mod 1 (``uniform(k, (5,))`` draws the
  first five of the six words); bestcandidate's table row shifted by the
  unit floats of words 0 and 1, its lens the (0,2) pair of the same two
  words and its time van der Corput of word 2; random's five uniforms of
  the lane's (pixel, sample) key folded with tag 0 (CAMERA); stratified's
  the same, the image pair moved into cell (n mod g, ⌊n / g⌋ mod g) of a
  g = ⌊√spp⌋ grid, ``(cell + u) · float32(1 / g)``: XLA compiles the JAX
  package's division by the constant g into that product. What is the same for every lane of a wave (the
  radical inverses, the table row, the cell) is computed on the host once
  per wave (``sampler_constants``) and given to kernel and plain version
  alike;
- ``volume_uniforms`` — a scene with volumes adds the (R, J [+ 96])
  media block for sample s: for bounce b < J the transmittance jitter at
  counter 0 of the lane key folded with b·16 + 8 (VOLUME; path.py:228-231;
  column 0 is also the camera segment's jitter, path.py:754-755, and single
  scattering's, volumes.py:192-194: under partitionable threefry the first
  of n uniforms does not depend on n); under ``single`` then, for march
  step k < 32, counters 0–2 of bounce 0's VOLUME key folded with k·16 + 2
  (LIGHT_SAMPLE; volumes.py:205-206) at columns J + 3k … J + 3k + 2;
- ``pixel_scrambles`` — the (R, 6) scramble words of the lowdiscrepancy
  camera sample, from sample 0's pixel key (sampler.py:122-127, :43-44);
- ``camera_normals`` — the lens cameras' Gaussian noise for sample s,
  (R, T, 2): ``jax.random.normal(fold_in(pixel_sample_key(root, pixel,
  s), tag0 + t), (2,))`` for t < T (realistic.py:248-252: one tag per
  lens element from 1000; :402-404: the ideal camera's tag 2000). A
  normal is ``uniform(minval=nextafter(-1, 0), maxval=1)`` of the key's
  bits, times √2 erf_inv, which XLA computes by Giles' single-precision
  polynomial (``normals_from_bits``). The uniforms' bits are jax's; the
  normals differ from jax's by at most 3 ulps on the CPU, where XLA fuses
  the polynomial's steps into FMAs and has a log1p of its own. The kernel
  and the plain version agree bit for bit on the card;
- ``chain_uniforms`` — the preprocess integrators' draws, (R, lead +
  G·n): each lane's key ``pixel_sample_key(root, index, sample)`` folded
  with a chain of tags, each tag ``base + 16·i`` for i < its count (a
  fixed tag has count 1: the JAX package's ``bounce_key(·, b, purpose)``
  is tag b·16 + purpose), the G = Π counts keys taken in row-major order
  (the first tag outermost); then n uniforms per key at counters
  ``(j // used)·drawn + j mod used`` (``used = drawn = n`` by default:
  ``uniform_per(key, n)``; 7 of every 8 for a ``BatchedKeySource`` block);
  ``lead`` zero columns come first. The dipole's irradiance, photon and
  VPL paths, IGI's VPL picks, the irradiance cache's gather directions
  and its nested traces' bounce blocks are all such chains
  (``integrators/{dipole,photonmap,igi,irradiance}.py``);
- ``flat_uniforms`` — ``jax.random.uniform(key, (n, d))``: under
  partitionable threefry the flat ``bits(key, (n·d,))`` mapped to [0, 1)
  (the Metropolis bootstrap's primary samples, the PRT projection's and
  the probes' directions);
- ``mutate`` — the Metropolis renderer's Kelemen mutation of every
  chain (metropolis.py:73-83) and its accept uniforms (:169), from the
  five keys of ``mutate_keys``: ``split(key, 4)`` is ``fold_in(key,
  arange(4))`` and the accept key ``fold_in(key, 99)``, derived on the
  host per iteration.

There is no Pallas original: XLA computes threefry for the JAX package.
Threefry's 20 rounds in torch ops are about a hundred small launches per
call, and the camera columns about 430 more; each kernel is one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pbrt_torch.core import sampling as smp
from pbrt_torch.utils import native

# Purpose constants (pbrt_tpu/core/rng.py:19-29)
CAMERA = 0
LIGHT_SELECT = 1
LIGHT_SAMPLE = 2
BSDF_SAMPLE = 3
ROULETTE = 4
LENS = 5
TIME = 6
DIFFRACTION = 7
VOLUME = 8
PHOTON = 9
MUTATION = 10
#: the reserved tag ``BatchedKeySource`` folds in for all bounce uniforms
BATCHED = 15

#: uniforms drawn per bounce, and the ones the path integrator reads
PER_BOUNCE_DRAWN = 8
PER_BOUNCE_USED = 7
N_SCRAMBLES = 6
#: camera columns that lead the primary-sample array
CAMERA_DIMS = 5

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

#: the fold-in tags of the lens cameras' noise: the realistic camera's
#: element i draws under 1000 + i, the ideal camera under 2000
REALISTIC_NOISE_TAG = 1000
IDEAL_NOISE_TAG = 2000

#: Giles' erf_inv coefficients as XLA expands erf_inv in float32, highest
#: degree first: for w = -log1p(-u²) < 5 (in w - 2.5), then for w ≥ 5 (in
#: √w - 3)
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
#: float32 nextafter(-1, 0), the normal's uniform's minval, and √2
NORMAL_LO = -0.99999994039535522
SQRT2_F32 = 1.41421353816986084

#: the keyed kernels' sampler codes (``adaptive`` samples as lowdiscrepancy)
LOWDISCREPANCY, HALTON, BESTCANDIDATE, RANDOM, STRATIFIED = range(5)
SAMPLER_CODES = {"lowdiscrepancy": LOWDISCREPANCY, "adaptive": LOWDISCREPANCY,
                 "halton": HALTON, "bestcandidate": BESTCANDIDATE, "random": RANDOM,
                 "stratified": STRATIFIED}
#: march steps per volume segment (volumes.py TAU_STEPS) and the uniforms
#: single scattering draws per step
VOLUME_STEPS = 32
PER_VOLUME_STEP = 3

#: kernel launches per wrapper (the plain versions count nothing)
launches = {"keyed_uniforms": 0, "keyed_scrambles": 0, "keyed_ao_uniforms": 0,
            "keyed_camera_normals": 0, "keyed_volume_uniforms": 0, "keyed_chain_uniforms": 0,
            "mlt_mutate": 0}
#: the most tags a chain may have (``csrc/rng.cu`` kMaxChain)
MAX_CHAIN = 4
#: the tiled keyed kernels (``keyed_volume_uniforms``, ``keyed_chain_uniforms``):
#: the most threads a block (``csrc/rng.cu`` kMaxTileThreads) and the fewest
#: a pass of whole tile rows should keep busy, the threads an SM holds, the
#: most elements and rows a tile takes, the widest row one tile takes
#: (kMaxTileCols) and the most bytes of a tile's staged keys (kMaxTileBytes)
TILE_MAX_THREADS = 512
TILE_MIN_PASS = 256
SM_THREADS = 2048
TILE_MAX_ELEMS = 16384
TILE_MAX_ROWS = 512
TILE_MAX_COLS = 1024
TILE_MAX_BYTES = 48 * 1024
#: a row of at most ``ROW_UNIFORMS`` uniforms in groups of at most
#: ``ROW_COLS`` whose outer key is the lane key goes to ``keyed_rows``
#: (``csrc/rng.cu`` kRowUniforms, kRowCols; kernels of its own): one
#: thread a row, or one a group, in blocks of at most ``ROW_MAX_THREADS``
#: (kRowMaxThreads), a launch at least 4 blocks an SM
ROW_UNIFORMS = 8
ROW_COLS = 2
ROW_MAX_THREADS = 256
#: the Kelemen mutation's step sizes (metropolis.py:73)
MUTATE_S1 = 1.0 / 1024.0
MUTATE_S2 = 1.0 / 16.0
#: the fold-in of the accept uniforms' key (metropolis.py:169)
ACCEPT_TAG = 99
#: ``mlt_mutate``'s blocks (``csrc/rng.cu`` kMutateThreads), the blocks an SM
#: holds (kMutateBlocks), the most chains a block's band takes (kMaxBand)
#: and the columns a warp takes of one chain; the large-only mode's
#: counters a thread (4 where that leaves a full wave of threads, else 1)
MUTATE_THREADS = 256
MUTATE_BLOCKS_PER_SM = 8
MUTATE_MAX_BAND = 128
MUTATE_TILE = 32
FLAT_PER_THREAD = (4, 1)
#: the most threads of a normals block (``csrc/rng.cu`` kNormalThreads), and
#: the (row, tag) items an SM's share of a launch must reach for two a thread
NORMAL_THREADS = 256
NORMAL_PAIR_MIN_ITEMS = SM_THREADS
#: the threads of a block of the ideal camera's one tag, a row a thread
#: (``keyed_camera_normals_rows_kernel``)
NORMAL_ROW_THREADS = 256


def reset_launches():
    for k in launches:
        launches[k] = 0


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (prng.py ``_threefry2x32_lowering``) on
    int64 tensors holding uint32 words; arguments broadcast. → (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def root_key(seed: int = 0) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data as a (2,) int64 CPU tensor."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def _words(data, device):
    return torch.as_tensor(data, dtype=torch.int64, device=device) & _M32


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """keys (..., 2) and data broadcasting against (...) → keys (..., 2)."""
    d = _words(data, keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def pixel_sample_key(root: torch.Tensor, pixel_index, sample_index):
    """Per-path keys (R, 2): the pixel index, then the sample index, folded
    into the root key (pbrt_tpu/core/rng.py:36-47)."""
    pix = _words(pixel_index, root.device)
    return fold_in(fold_in(root, pix), _words(sample_index, root.device))


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``'s key data: ``fold_in(key, i)`` for
    i < n (partitionable threefry) → (..., n, 2)."""
    return fold_in(key[..., None, :], torch.arange(n, dtype=torch.int64, device=key.device))


def bounce_key(keys: torch.Tensor, bounce, purpose: int) -> torch.Tensor:
    """Per-(path, bounce, purpose) key: fold in bounce·16 + purpose."""
    tag = _words(bounce, keys.device) * 16 + purpose
    return fold_in(keys, tag)


def _bits_at(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """keys (..., 2), counters (n,) → (..., n) 32-bit words."""
    k0, k1 = keys[..., 0, None], keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(counters), counters)
    return y0 ^ y1


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key → (..., n) int64."""
    return _bits_at(keys, torch.arange(n, dtype=torch.int64, device=keys.device))


def _to_uniform(b: torch.Tensor) -> torch.Tensor:
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_per(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` per key → (..., n) float32."""
    return _to_uniform(bits(keys, n))


def normals_from_bits(b: torch.Tensor) -> torch.Tensor:
    """32-bit words → ``jax.random.normal``'s float32s: the uniform on
    [nextafter(-1, 0), 1) (``maxval - minval`` rounds to 2 in float32),
    then √2 erf_inv by Giles' polynomial, step for step as
    ``csrc/rng.cu:normal_from_bits``. |u| < 1, so erf_inv's ±1 edge case
    never arises."""
    u = torch.clamp(_to_uniform(b) * 2.0 + NORMAL_LO, min=NORMAL_LO)
    w = -torch.log1p(-(u * u))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERFINV_SMALL[0], ERFINV_LARGE[0])
    for cs, cl in zip(ERFINV_SMALL[1:], ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return (p * u) * SQRT2_F32


# ---------------------------------------------------------------------------
# the render's keyed arrays: plain versions
# ---------------------------------------------------------------------------


def bounce_uniforms_plain(root, pixel_index, sample: int, max_depth: int):
    """(R,) pixel indices → the (R, 7·max_depth) bounce block of sample
    ``sample`` (see the module docstring)."""
    dev = pixel_index.device
    keys = bounce_key(pixel_sample_key(root.to(dev), pixel_index, sample), 0, BATCHED)
    cols = torch.arange(max_depth * PER_BOUNCE_DRAWN, dtype=torch.int64, device=dev)
    cols = cols.view(max_depth, PER_BOUNCE_DRAWN)[:, :PER_BOUNCE_USED].reshape(-1)
    return _to_uniform(_bits_at(keys, cols))


def sampler_constants(sampler: str, sample: int, spp: int):
    """(code, five float32 constants) of the camera columns of sample
    ``sample`` under ``sampler`` (sampler.py:49-83): halton's radical
    inverses of n; bestcandidate's row min(n, T − 1) of the spp-point table;
    stratified's cell (n mod g, ⌊n / g⌋ mod g) and 1 / g, g = ⌊√spp⌋; zeros
    otherwise. A sampler name the JAX package does not know samples as
    ``random`` (sampler.py:84-87)."""
    code, n = SAMPLER_CODES.get(sampler, RANDOM), int(sample) & _M32
    c = np.zeros(5, np.float32)
    if code == HALTON:
        c[:] = [smp.radical_inverse(n, b) for b in smp.HALTON_BASES]
    elif code == BESTCANDIDATE:
        table = smp.best_candidate_table(max(spp, 1))
        c[:2] = table[min(n, table.shape[0] - 1)]
    elif code == STRATIFIED:
        g = max(1, int(np.sqrt(spp)))
        c[:3] = [n % g, n // g % g, np.float32(1.0 / g)]
    return code, tuple(float(v) for v in c)


def camera_columns_plain(root, pixel_index, scrambles, sample: int, code: int = LOWDISCREPANCY,
                         consts=(0.0,) * 5):
    """(R,) pixel indices and their (R, 6) scramble words → the (R, 5)
    camera columns of sample ``sample`` under sampler ``code`` with the
    wave's ``consts`` (``sampler_constants``; see the module docstring)."""
    if code == LOWDISCREPANCY:
        return smp.camera_uniforms(sample, scrambles)
    wrap = lambda c, s: torch.clamp(torch.remainder(s + c, 1.0), max=smp.ONE_MINUS_EPS)
    if code in (HALTON, BESTCANDIDATE):
        shift = _to_uniform(scrambles[:, :5])
        if code == HALTON:
            return torch.stack([wrap(c, shift[:, j]) for j, c in enumerate(consts)], -1)
        n = torch.full(scrambles.shape[:1], int(sample), dtype=torch.int64,
                       device=scrambles.device)
        lens = smp.sample02(n, scrambles[:, 0:2])
        return torch.stack([wrap(consts[0], shift[:, 0]), wrap(consts[1], shift[:, 1]),
                            lens[:, 0], lens[:, 1],
                            smp.van_der_corput(n, scrambles[:, 2])], -1)
    dev = pixel_index.device
    u = uniform_per(bounce_key(pixel_sample_key(root.to(dev), pixel_index, sample), 0,
                               CAMERA), CAMERA_DIMS)
    if code == STRATIFIED:
        u = torch.cat([((u[:, 0] + consts[0]) * consts[2])[:, None],
                       ((u[:, 1] + consts[1]) * consts[2])[:, None], u[:, 2:]], -1)
    return u


def primary_uniforms_plain(root, pixel_index, scrambles, sample: int, max_depth: int,
                           sampler: str = "lowdiscrepancy", spp: int = 1):
    """(R,) pixel indices and their (R, 6) scramble words → the wave's
    (R, 5 + 7·max_depth) primary-sample array of sample ``sample``, its
    camera columns ``sampler``'s at ``spp`` samples per pixel."""
    code, consts = sampler_constants(sampler, sample, spp)
    return torch.cat([camera_columns_plain(root, pixel_index, scrambles, sample, code, consts),
                      bounce_uniforms_plain(root, pixel_index, sample, max_depth)], -1)


def ao_uniforms_plain(root, pixel_index, scrambles, sample: int, n_ao: int,
                      sampler: str = "lowdiscrepancy", spp: int = 1):
    """(R,) pixel indices and their (R, 6) scramble words → ambient
    occlusion's (R, 5 + 2·n_ao) array of sample ``sample``: the camera
    columns, then AO sample j's two uniforms at columns 5 + 2j, 6 + 2j."""
    dev = pixel_index.device
    keys = pixel_sample_key(root.to(dev), pixel_index, sample)
    j = torch.arange(n_ao, dtype=torch.int64, device=dev)
    per = uniform_per(bounce_key(keys[:, None, :], j, BSDF_SAMPLE), 2)  # (R, n, 2)
    code, consts = sampler_constants(sampler, sample, spp)
    return torch.cat([camera_columns_plain(root, pixel_index, scrambles, sample, code, consts),
                      per.reshape(pixel_index.shape[0], 2 * n_ao)], -1)


def volume_uniforms_plain(root, pixel_index, sample: int, n_jitter: int, single: bool):
    """(R,) pixel indices → the (R, n_jitter [+ 96]) media block of sample
    ``sample`` (see the module docstring)."""
    dev = pixel_index.device
    keys = pixel_sample_key(root.to(dev), pixel_index, sample)
    b = torch.arange(n_jitter, dtype=torch.int64, device=dev)
    cols = [uniform_per(bounce_key(keys[:, None, :], b, VOLUME), 1)[..., 0]]
    if single:
        k = torch.arange(VOLUME_STEPS, dtype=torch.int64, device=dev)
        k_v = bounce_key(keys, 0, VOLUME)
        steps = uniform_per(bounce_key(k_v[:, None, :], k, LIGHT_SAMPLE), PER_VOLUME_STEP)
        cols.append(steps.reshape(pixel_index.shape[0], VOLUME_STEPS * PER_VOLUME_STEP))
    return torch.cat(cols, -1)


def pixel_scrambles_plain(root, pixel_index):
    """(R,) pixel indices → (R, 6) int64 scramble words (sample 0's key)."""
    keys = pixel_sample_key(root.to(pixel_index.device), pixel_index, 0)
    return bits(bounce_key(keys, 0, CAMERA), N_SCRAMBLES)


def camera_normals_plain(root, pixel_index, sample: int, tag0: int, n_tags: int):
    """(R,) pixel indices → the (R, n_tags, 2) float32 normals of sample
    ``sample`` under fold-in tags ``tag0`` … ``tag0 + n_tags - 1``."""
    dev = pixel_index.device
    keys = pixel_sample_key(root.to(dev), pixel_index, sample)
    tags = torch.arange(tag0, tag0 + n_tags, dtype=torch.int64, device=dev)
    return normals_from_bits(bits(fold_in(keys[:, None, :], tags), 2))


def _chain_tags(chain):
    """A chain's tags as (base, count) pairs; a bare int is (tag, 1)."""
    tags = tuple((int(t), 1) if isinstance(t, (int, np.integer)) else (int(t[0]), int(t[1]))
                 for t in chain)
    if len(tags) > MAX_CHAIN or any(c < 1 for _, c in tags):
        raise ValueError(f"chain {chain}: at most {MAX_CHAIN} tags, each counted >= 1")
    return tags


def _chain_counters(n: int, used, drawn):
    used = n if used is None else int(used)
    drawn = used if drawn is None else int(drawn)
    if n < 0 or used < 1 or drawn < used:
        raise ValueError(f"chain draws: n {n}, used {used}, drawn {drawn}")
    return used, drawn


def chain_uniforms_plain(root, index, sample: int, chain=(), n: int = 1, lead: int = 0,
                         used=None, drawn=None):
    """(R,) indices → the (R, lead + G·n) chain draws of sample ``sample``
    (see the module docstring)."""
    tags = _chain_tags(chain)
    used, drawn = _chain_counters(n, used, drawn)
    dev = index.device
    keys = pixel_sample_key(root.to(dev), index, sample)
    for base, count in tags:
        t = base + 16 * torch.arange(count, dtype=torch.int64, device=dev)
        keys = fold_in(keys.unsqueeze(-2), t)  # (R, ..., count, 2)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    u = _to_uniform(_bits_at(keys, j // used * drawn + j % used))
    R = index.shape[0]
    return torch.cat([torch.zeros((R, lead), dtype=torch.float32, device=dev),
                      u.reshape(R, -1)], -1)


def flat_uniforms_plain(key, n: int, d: int, device="cpu"):
    """``jax.random.uniform(key, (n, d))`` for a (2,) key → (n, d) float32
    on ``device``."""
    c = torch.arange(n * d, dtype=torch.int64, device=device)
    return _to_uniform(_bits_at(key.to(device), c)).view(n, d)


def neg_log_ratio(s1: float, s2: float) -> float:
    """The exponent's constant -float32(log(s2 / s1)), as the JAX package's
    ``-jnp.log(s2 / s1)`` rounds it (-4.158883 at the default sizes)."""
    return float(-np.log(np.float32(s2 / s1)).astype(np.float32))


def mutate_keys(key: torch.Tensor) -> torch.Tensor:
    """A mutation's five keys from the iteration's key: ``split(key, 4)``
    (large, eps, sign, is_large), then the accept key ``fold_in(key, 99)``
    → (5, 2)."""
    return torch.cat([split(key, 4), fold_in(key, ACCEPT_TAG)[None]])


def mutate_plain(u, keys, p_large: float, s1: float = MUTATE_S1, s2: float = MUTATE_S2):
    """The Kelemen mutation of (N, D) primary samples ``u`` under the five
    ``mutate_keys`` → (u' (N, D), is_large (N,) bool, accept uniforms (N,)),
    in the kernel's order: per element (r, d) at counter r·D + d the large
    step U(k1), eps U(k2) and the sign U(k3) < 0.5; delta = s2·exp(-log(s2
    / s1)·eps) with log(s2 / s1) rounded to float32 once; u_small = (u +
    sign·delta) mod 1; per chain r, U(k4) < p_large and the accept U(ka)."""
    N, D = u.shape
    dev = u.device
    keys = keys.to(dev)
    c = torch.arange(N * D, dtype=torch.int64, device=dev)
    u_large = _to_uniform(_bits_at(keys[0], c)).view(N, D)
    eps = _to_uniform(_bits_at(keys[1], c)).view(N, D)
    sign = torch.where(_to_uniform(_bits_at(keys[2], c)).view(N, D) < 0.5, -1.0, 1.0)
    delta = s2 * torch.exp(neg_log_ratio(s1, s2) * eps)
    u_small = torch.remainder(u + sign * delta, 1.0)
    r = torch.arange(N, dtype=torch.int64, device=dev)
    is_large = _to_uniform(_bits_at(keys[3], r)) < p_large
    u_acc = _to_uniform(_bits_at(keys[4], r))
    return torch.where(is_large[:, None], u_large, u_small), is_large, u_acc


# ---------------------------------------------------------------------------
# the tiled kernels' per-launch constants, and their arithmetic in numpy
# ---------------------------------------------------------------------------


def divisor(d: int) -> tuple:
    """``csrc/rng.cu``'s ``Div`` of ``d``: (d, m, s) with x // d == (x·m) >>
    s for every 0 <= x < 2**31 (Granlund and Montgomery's round-up method:
    s = 31 + ceil(log2 d), m = ceil(2**s / d) < 2**32); (0, 0, 0) for d = 0."""
    d = int(d)
    if d == 0:
        return (0, 0, 0)
    if not 0 < d < 2**31:
        raise ValueError(f"divisor {d}: outside [1, 2**31)")
    s = 31 + (d - 1).bit_length()
    return (d, -(-(1 << s) // d), s)


def tile_block(cols: int) -> tuple:
    """(threads, pass rows) of a tile of ``cols`` columns: a tile wider
    than ``TILE_MAX_THREADS`` takes ceil(cols / passes) columns a pass,
    rounded up to a warp, one row; a narrower one k whole rows a pass, the
    fewest k whose k·cols threads keep ≥ 95% of their warps' lanes busy and
    are at least ``TILE_MIN_PASS``, else the k that keeps the most busy."""
    if cols > TILE_MAX_THREADS:
        per_pass = -(-cols // -(-cols // TILE_MAX_THREADS))
        return -(-per_pass // 32) * 32, 1
    best = None
    for k in range(1, TILE_MAX_THREADS // cols + 1):
        threads = -(-k * cols // 32) * 32
        if threads > TILE_MAX_THREADS:
            break
        busy = k * cols / threads
        if k * cols >= TILE_MIN_PASS and busy >= 0.95:
            return threads, k
        if best is None or busy > best[0] + 1e-12:
            best = (busy, threads, k)
    return best[1], best[2]


def keyed_tiling(R: int, width: int, slots, sms: int = 132, row_slots: int = 0) -> np.ndarray:
    """The ``Tiling`` words (``csrc/rng.cu``) of a launch of R rows ×
    ``width`` columns on a card of ``sms`` SMs: a tile is the whole row
    (``TILE_MAX_COLS`` columns of it where wider) × a band of rows, its
    block ``tile_block``'s; as many bands as the card holds blocks at once
    (``SM_THREADS`` an SM), or a whole multiple of that where a tile would
    pass ``TILE_MAX_ELEMS`` elements, so that the last wave of blocks is a
    full one; the band a whole number of passes, at most ``TILE_MAX_ROWS``
    rows, and fewer where a tile's staged keys (8 bytes each: a lane key,
    then the (outer, group) key slots that ``slots(cols)`` gives a tile row
    of ``cols`` columns) would keep the SM from holding its blocks, or pass
    ``TILE_MAX_BYTES``. Under ``row_slots`` (a row of a few uniforms in
    narrow groups, the caller's call) the row's groups are dealt to
    ``row_slots`` threads (1, or one a group; the ``groups`` word): pass
    rows 0, a block at most ``ROW_MAX_THREADS`` threads, a warp's multiple,
    fewer so that a launch is at least 4 blocks an SM, and the rows they
    take."""
    cols = min(width, TILE_MAX_COLS)
    col_tiles = -(-width // cols)
    outer, groups = (max(int(v), 1) for v in slots(cols))
    if row_slots:
        threads = min(ROW_MAX_THREADS, max(32, -(-(R * row_slots) // (4 * sms * 32)) * 32))
        rows = threads // row_slots
        return np.array([width, rows, 1, threads, 0, *divisor(cols), *divisor(outer),
                         *divisor(row_slots)], np.uint32)
    threads, k = tile_block(cols)
    per_sm = min(32, SM_THREADS // threads)
    capacity = sms * per_sm
    waves = max(1, -(-(R * width) // (capacity * TILE_MAX_ELEMS)))
    rows = -(-(R * col_tiles) // (waves * capacity))
    rows = -(-rows // k) * k
    smem = min(TILE_MAX_BYTES, 228 * 1024 // per_sm - 1024)
    cap = min(TILE_MAX_ROWS, max(TILE_MAX_ELEMS // cols, k), smem // (8 * (1 + outer + groups)))
    if rows > cap:
        rows = max(cap // k * k, min(cap, k))
    rows = max(1, rows)
    return np.array([width, rows, col_tiles, threads, k, *divisor(cols), *divisor(outer),
                     *divisor(groups)], np.uint32)


def volume_tiling(R: int, n_jitter: int, single: bool, sms: int = 132) -> np.ndarray:
    """``keyed_volume_uniforms``' tiling: J jitter groups of 1 column, then
    (under ``single``) 32 step groups of 3; a tile narrower than the row
    meets at most its columns + 1 groups, and the lane key and bounce 0's
    VOLUME key are its outer keys. At most ``ROW_UNIFORMS`` jitters alone
    (the block under emission) go a thread a row."""
    steps = VOLUME_STEPS if single else 0
    width, G = n_jitter + PER_VOLUME_STEP * steps, n_jitter + steps
    return keyed_tiling(R, width, lambda c: ((n_jitter > 0) + (steps > 0),
                                            G if c >= width else min(G, c + 1)), sms,
                        row_slots=int(not steps and 0 < n_jitter <= ROW_UNIFORMS))


def chain_map(tags, n: int, used: int, drawn: int, lead: int) -> np.ndarray:
    """The ``ChainMap`` words (``csrc/rng.cu``) of a chain (``_chain_tags``):
    the outer tags (all but the last) with their counts' divisors, the last
    tag and its count's, n's and used's, lead and drawn. A chain of no tag
    has one group, its key the lane key."""
    outer, (last_base, last) = tags[:-1], (tags[-1] if tags else (0, 1))
    words = [len(outer), int(bool(tags)), lead, drawn]
    words += [b & _M32 for b, _ in outer] + [0] * (MAX_CHAIN - 1 - len(outer))
    for i in range(MAX_CHAIN - 1):
        words += divisor(outer[i][1]) if i < len(outer) else (0, 0, 0)
    words += [last_base & _M32, *divisor(last), *divisor(n), *divisor(used)]
    return np.array(words, np.uint32)


def chain_tiling(R: int, tags, n: int, lead: int, sms: int = 132) -> np.ndarray:
    """``keyed_chain_uniforms``' tiling: G groups of n columns after lead;
    a tile narrower than the row meets at most (cols − 1) // n + 2 groups,
    and those at most (met − 1) // count_last + 2 outer keys. A chain of at
    most one tag and ``ROW_UNIFORMS`` uniforms in groups of at most
    ``ROW_COLS`` goes to ``keyed_rows``: a thread a row where a group is one
    uniform, else a thread a group (ambient occlusion's keyed directions,
    the cache's gather directions)."""
    G = int(np.prod([c for _, c in tags])) if tags else 1
    last = tags[-1][1] if tags else 1
    width = lead + G * n

    def slots(cols):
        if n == 0:
            return 0, 0
        met = G if cols >= width else min(G, (cols - 1) // n + 2)
        return min(G // last, (met - 1) // last + 2), met
    rows = (1 <= n <= ROW_COLS and len(tags) <= 1 and G * n <= ROW_UNIFORMS
            and width <= TILE_MAX_COLS)
    return keyed_tiling(R, width, slots, sms, row_slots=rows * (1 if n == 1 else G))


def normals_launch(R: int, n_tags: int, sms: int = 132) -> np.ndarray:
    """``keyed_camera_normals``' launch words: its band of rows (even: the
    block's first element 16-byte aligned), threads, the (row, tag) items a
    thread takes and T's divisor. Two items a thread where the launch's
    items would fill every SM with threads at one each
    (``NORMAL_PAIR_MIN_ITEMS`` an SM), else one; a block about an item
    (or pair) a thread; its threads halve from ``NORMAL_THREADS`` (to 32)
    until the launch has two blocks an SM."""
    items = 2 if R * n_tags >= NORMAL_PAIR_MIN_ITEMS * sms else 1
    units = -(-R * n_tags // items)
    threads = NORMAL_THREADS
    while threads > 32 and -(-units // threads) < 2 * sms:
        threads //= 2
    band = max(2, items * threads // n_tags // 2 * 2)
    return np.array([band, threads, items, *divisor(n_tags)], np.uint32)


def mutate_plan(N: int, D: int, sms: int = 132) -> np.ndarray:
    """``mlt_mutate``'s ``MutatePlan`` words (``csrc/rng.cu``): a block's band
    of chains (as many bands as the card holds blocks at once, so the last
    wave is a full one, at most ``MUTATE_MAX_BAND``, a whole number of
    packs), the whole 32-column tiles of a chain, its tail D mod 32, the
    chains whose tails share a warp (32 // tail) and the divisors of the
    whole tiles and of the tail."""
    full, tail = divmod(int(D), MUTATE_TILE)
    pack = MUTATE_TILE // tail if tail else 0
    band = max(1, -(-int(N) // (sms * MUTATE_BLOCKS_PER_SM)))
    if pack:
        band = -(-band // pack) * pack
    band = min(band, MUTATE_MAX_BAND // max(pack, 1) * max(pack, 1))
    return np.array([band, full, tail, pack, *divisor(full), *divisor(tail)], np.uint32)


def flat_per_thread(total: int, sms: int = 132) -> int:
    """The large-only mode's counters a thread: the most of
    ``FLAT_PER_THREAD`` that still give every SM a full complement of
    threads (``SM_THREADS``), else 1."""
    return next((k for k in FLAT_PER_THREAD if total >= k * sms * SM_THREADS), 1)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's SMs (the tiled kernels' tiling spreads a launch over them)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _frozen_words(*arrays) -> tuple:
    """(the arrays' (address, size) pairs flattened, the arrays made
    read-only): a launch's words as the C entry takes them, computed once
    and kept alive by the memo that holds them."""
    for a in arrays:
        a.setflags(write=False)
    return tuple(v for a in arrays for v in (a.ctypes.data, a.size)), arrays


@functools.lru_cache(maxsize=512)
def volume_words(R: int, n_jitter: int, single: bool, sms: int) -> tuple:
    """``volume_uniforms``' per-launch words (``volume_tiling``), memoised
    per launch shape and SM count: the wrapper's enqueue pays a lookup, not
    the tiling's arithmetic and numpy's pointer."""
    return _frozen_words(volume_tiling(R, n_jitter, single, sms))


@functools.lru_cache(maxsize=512)
def normals_words(R: int, n_tags: int, sms: int) -> tuple:
    """``normals_launch``'s words as ints, memoised per launch shape."""
    return tuple(int(w) for w in normals_launch(R, n_tags, sms))


@functools.lru_cache(maxsize=512)
def mutate_words(N: int, D: int, sms: int) -> tuple:
    """``mutate``'s per-launch words (``mutate_plan``), memoised as
    ``volume_words``."""
    return _frozen_words(mutate_plan(N, D, sms))


@functools.lru_cache(maxsize=512)
def chain_words(R: int, tags: tuple, n: int, used: int, drawn: int, lead: int,
                sms: int) -> tuple:
    """``chain_uniforms``' per-launch words (``chain_map``, then
    ``chain_tiling``), memoised as ``volume_words``."""
    return _frozen_words(chain_map(tags, n, used, drawn, lead),
                         chain_tiling(R, tags, n, lead, sms))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch_args(root, pixel_index, row_width: int):
    """Checks the inputs of a keyed kernel that writes ``row_width`` values
    per lane → (k0, k1, R, library, stream). The kernels index in 32 bits,
    and both touch the 6 scramble words of each lane."""
    if tuple(root.shape) != (2,):
        raise ValueError(f"root: shape {tuple(root.shape)}, expected (2,)")
    R = pixel_index.shape[0]
    native.check_tensor("pixel_index", pixel_index, torch.int64, (R,), pixel_index.device)
    if R * max(row_width, N_SCRAMBLES) >= 2**31:
        raise ValueError(f"{R} lanes of {row_width} values: over the kernels' 32-bit index")
    k0, k1 = (int(v) & _M32 for v in root.tolist())
    stream = torch.cuda.current_stream(pixel_index.device).cuda_stream
    return k0, k1, R, native.kernel_lib("rng.cu"), stream


def _keyed_rows(entry: str, name: str, root, pixel_index, scrambles, sample: int,
                count: int, per_count: int, sampler: str, spp: int):
    """Launches a keyed kernel that writes CAMERA_DIMS + per_count·count
    floats per lane (``count`` bounces or AO samples), its camera columns
    ``sampler``'s → the (R, width) array."""
    if count < 0:
        raise ValueError(f"{name}: count {count}, expected >= 0")
    code, consts = sampler_constants(sampler, sample, spp)
    width = CAMERA_DIMS + per_count * count
    k0, k1, R, lib, stream = _launch_args(root, pixel_index, width)
    native.check_tensor("scrambles", scrambles, torch.int64, (R, N_SCRAMBLES),
                        pixel_index.device)
    out = torch.empty((R, width), dtype=torch.float32, device=pixel_index.device)
    if R == 0:
        return out
    native.check_launch(getattr(lib, entry)(
        k0, k1, pixel_index.data_ptr(), scrambles.data_ptr(), R, int(sample) & _M32,
        count, code, *consts, out.data_ptr(), stream), f"{name} launch")
    launches[name] += 1
    return out


def primary_uniforms(root, pixel_index, scrambles, sample: int, max_depth: int,
                     sampler: str = "lowdiscrepancy", spp: int = 1):
    """The primary-sample array; see ``primary_uniforms_plain`` for the
    contract."""
    if pixel_index.device.type == "cpu":
        return primary_uniforms_plain(root, pixel_index, scrambles, sample, max_depth,
                                      sampler, spp)
    if pixel_index.device.type != "cuda":
        raise ValueError(f"primary_uniforms: unsupported device {pixel_index.device}")
    return _keyed_rows("pbrt_torch_keyed_uniforms", "keyed_uniforms", root, pixel_index,
                       scrambles, sample, int(max_depth), PER_BOUNCE_USED, sampler, spp)


def ao_uniforms(root, pixel_index, scrambles, sample: int, n_ao: int,
                sampler: str = "lowdiscrepancy", spp: int = 1):
    """Ambient occlusion's array; see ``ao_uniforms_plain`` for the
    contract."""
    if pixel_index.device.type == "cpu":
        return ao_uniforms_plain(root, pixel_index, scrambles, sample, n_ao, sampler, spp)
    if pixel_index.device.type != "cuda":
        raise ValueError(f"ao_uniforms: unsupported device {pixel_index.device}")
    return _keyed_rows("pbrt_torch_keyed_ao_uniforms", "keyed_ao_uniforms", root,
                       pixel_index, scrambles, sample, int(n_ao), 2, sampler, spp)


def volume_uniforms(root, pixel_index, sample: int, n_jitter: int, single: bool):
    """The media block; see ``volume_uniforms_plain`` for the contract."""
    if pixel_index.device.type == "cpu":
        return volume_uniforms_plain(root, pixel_index, sample, n_jitter, single)
    if pixel_index.device.type != "cuda":
        raise ValueError(f"volume_uniforms: unsupported device {pixel_index.device}")
    if n_jitter < 0:
        raise ValueError(f"volume_uniforms: {n_jitter} jitters, expected >= 0")
    width = n_jitter + (VOLUME_STEPS * PER_VOLUME_STEP if single else 0)
    k0, k1, R, lib, stream = _launch_args(root, pixel_index, width)
    out = torch.empty((R, width), dtype=torch.float32, device=pixel_index.device)
    if R == 0 or width == 0:
        return out
    words, _ = volume_words(R, int(n_jitter), bool(single), sm_count(pixel_index.device))
    native.check_launch(lib.pbrt_torch_keyed_volume_uniforms(
        k0, k1, pixel_index.data_ptr(), R, int(sample) & _M32, int(n_jitter), int(bool(single)),
        *words, out.data_ptr(), stream), "keyed_volume_uniforms launch")
    launches["keyed_volume_uniforms"] += 1
    return out


def camera_normals(root, pixel_index, sample: int, tag0: int, n_tags: int):
    """The lens cameras' noise; see ``camera_normals_plain`` for the
    contract."""
    if pixel_index.device.type == "cpu":
        return camera_normals_plain(root, pixel_index, sample, tag0, n_tags)
    if pixel_index.device.type != "cuda":
        raise ValueError(f"camera_normals: unsupported device {pixel_index.device}")
    if n_tags < 0 or not 0 <= tag0 <= tag0 + n_tags <= 2**32:
        raise ValueError(f"camera_normals: tags {tag0} + [0, {n_tags}) outside uint32")
    tag0, n_tags = int(tag0), int(n_tags)
    k0, k1, R, lib, stream = _launch_args(root, pixel_index, 2 * n_tags)
    out = torch.empty((R, n_tags, 2), dtype=torch.float32, device=pixel_index.device)
    if R == 0 or n_tags == 0:
        return out
    if n_tags == 1:
        native.check_launch(lib.pbrt_torch_keyed_camera_normals_rows(
            k0, k1, pixel_index.data_ptr(), R, int(sample) & _M32, tag0, NORMAL_ROW_THREADS,
            out.data_ptr(), stream), "keyed_camera_normals launch")
    else:
        words = normals_words(R, n_tags, sm_count(pixel_index.device))
        native.check_launch(lib.pbrt_torch_keyed_camera_normals(
            k0, k1, pixel_index.data_ptr(), R, int(sample) & _M32, tag0, n_tags, *words,
            out.data_ptr(), stream), "keyed_camera_normals launch")
    launches["keyed_camera_normals"] += 1
    return out


def pixel_scrambles(root, pixel_index):
    """The scramble words; see ``pixel_scrambles_plain`` for the contract."""
    if pixel_index.device.type == "cpu":
        return pixel_scrambles_plain(root, pixel_index)
    if pixel_index.device.type != "cuda":
        raise ValueError(f"pixel_scrambles: unsupported device {pixel_index.device}")
    k0, k1, R, lib, stream = _launch_args(root, pixel_index, N_SCRAMBLES)
    out = torch.empty((R, N_SCRAMBLES), dtype=torch.int64, device=pixel_index.device)
    if R == 0:
        return out
    native.check_launch(lib.pbrt_torch_keyed_scrambles(
        k0, k1, pixel_index.data_ptr(), R, out.data_ptr(), stream),
        "keyed_scrambles launch")
    launches["keyed_scrambles"] += 1
    return out


def chain_uniforms(root, index, sample: int, chain=(), n: int = 1, lead: int = 0,
                   used=None, drawn=None):
    """The chain draws; see ``chain_uniforms_plain`` for the contract."""
    if index.device.type == "cpu":
        return chain_uniforms_plain(root, index, sample, chain, n, lead, used, drawn)
    if index.device.type != "cuda":
        raise ValueError(f"chain_uniforms: unsupported device {index.device}")
    tags = _chain_tags(chain)
    used, drawn = _chain_counters(n, used, drawn)
    groups = int(np.prod([c for _, c in tags])) if tags else 1
    width = lead + groups * n
    if lead < 0 or any(not 0 <= b + 16 * (c - 1) < 2**32 for b, c in tags):
        raise ValueError(f"chain_uniforms: lead {lead}, tags {tags} outside uint32")
    k0, k1, R, lib, stream = _launch_args(root, index, width)
    out = torch.empty((R, width), dtype=torch.float32, device=index.device)
    if R == 0 or width == 0:
        return out
    words, _ = chain_words(R, tags, int(n), used, drawn, int(lead), sm_count(index.device))
    native.check_launch(lib.pbrt_torch_keyed_chain_uniforms(
        k0, k1, index.data_ptr(), R, int(sample) & _M32, *words, out.data_ptr(), stream),
        "keyed_chain_uniforms launch")
    launches["keyed_chain_uniforms"] += 1
    return out


def _check_size(N: int, D: int):
    if N < 0 or D < 1 or N * D >= 2**31:
        raise ValueError(f"{N} chains of {D} dimensions: over the kernel's 32-bit counter")


def flat_uniforms(key, n: int, d: int, device="cpu"):
    """``jax.random.uniform(key, (n, d))`` on ``device``: the mutation
    kernel's large-only mode on the card, ``flat_uniforms_plain`` on the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return flat_uniforms_plain(key, n, d, device)
    if device.type != "cuda":
        raise ValueError(f"flat_uniforms: unsupported device {device}")
    if key.numel() != 2:
        raise ValueError(f"flat_uniforms: key shape {tuple(key.shape)}, expected 2 words")
    n, d = int(n), int(d)
    _check_size(n, d)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    if n == 0:
        return out
    k0, k1 = (int(v) & _M32 for v in key.reshape(2).tolist())
    total = n * d
    native.check_launch(native.kernel_lib("rng.cu").pbrt_torch_flat_uniforms(
        k0, k1, total, flat_per_thread(total, sm_count(device)), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), "mlt_mutate launch")
    launches["mlt_mutate"] += 1
    return out


def mutate(u, keys, p_large: float, s1: float = MUTATE_S1, s2: float = MUTATE_S2):
    """The mutation; see ``mutate_plain`` for the contract."""
    if u.device.type == "cpu":
        return mutate_plain(u, keys, p_large, s1, s2)
    if u.device.type != "cuda":
        raise ValueError(f"mutate: unsupported device {u.device}")
    N, D = u.shape
    if tuple(keys.shape) != (5, 2):
        raise ValueError(f"mutation keys: shape {tuple(keys.shape)}, expected (5, 2)")
    words = [int(w) & _M32 for key in keys.cpu().tolist() for w in key]  # a0, c0, a1, …
    _check_size(N, D)
    device = u.device
    native.check_tensor("u", u, torch.float32, (N, D), device)
    out = torch.empty((N, D), dtype=torch.float32, device=device)
    large = torch.empty(N, dtype=torch.bool, device=device)
    acc = torch.empty(N, dtype=torch.float32, device=device)
    if N == 0:
        return out, large, acc
    plan, _ = mutate_words(N, D, sm_count(device))
    native.check_launch(native.kernel_lib("rng.cu").pbrt_torch_mlt_mutate(
        *words, u.data_ptr(), N, D, float(p_large), neg_log_ratio(s1, s2), float(s2), *plan,
        out.data_ptr(), large.data_ptr(), acc.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream), "mlt_mutate launch")
    launches["mlt_mutate"] += 1
    return out, large, acc
