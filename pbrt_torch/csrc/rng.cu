// Keyed numbers on Hopper: threefry-2x32 keys from (pixel, sample, purpose)
// and the render's arrays of keyed numbers, bit-exact to jax.random and to
// the JAX package's samplers.
//
// Replaces: no Pallas kernel. XLA computes these for the JAX package:
//   keyed_uniforms  — a wave's (R, 5 + 7·D) primary-sample array: the
//                     camera sample of the scene's sampler
//                     (pbrt_tpu/renderers/sampler.py:31-88; below), then
//                     BatchedKeySource's bounce uniforms
//                     (pbrt_tpu/integrators/path.py:115-120: key (pixel,
//                     sample, tag 15), 8 per bounce, the 8th, "spare",
//                     never read);
//   keyed_ao_uniforms — ambient occlusion's (R, 5 + 2·n) array: the same
//                     camera columns, then per AO sample s the uniforms at
//                     counters 0 and 1 of the lane key (pixel, sample)
//                     folded with s·16 + 3 (BSDF_SAMPLE), as _ao_li draws
//                     them (pbrt_tpu/integrators/path.py:783-784);
//   keyed_scrambles — the 6 scramble words per pixel from sample 0's key,
//                     tag 0 (CAMERA) (pbrt_tpu/renderers/sampler.py:43-44,
//                     :122-127), written as int64 (the port's uint32 holder);
//   keyed_camera_normals — the lens cameras' Gaussian noise, (R, T, 2): for
//                     fold-in tag t0 + t, jax.random.normal(fold_in(key, t0 +
//                     t), (2,)) with key the lane's (pixel, sample) key
//                     (pbrt_tpu/cameras/realistic.py:248-252, T elements
//                     under tags 1000 + i; :402-404, one under tag 2000).
//   keyed_volume_uniforms — a scene with volumes' (R, J [+ 96]) media
//                     block: for bounce b < J the transmittance jitter at
//                     counter 0 of the lane key folded with b·16 + 8
//                     (VOLUME; pbrt_tpu/integrators/path.py:228-231, column
//                     0 also the camera segment's, :754-755); under single
//                     scattering then, per march step k < 32, counters 0-2
//                     of bounce 0's VOLUME key folded with k·16 + 2
//                     (pbrt_tpu/media/volumes.py:190-209);
//   keyed_chain_uniforms — the preprocess integrators' draws, (R, lead +
//                     G·n): the lane key (index, sample) folded with a
//                     chain of up to 4 tags, tag i running base_i + 16·k for
//                     k < count_i (a fixed tag has count 1), the G = Π count_i
//                     keys in row-major order; n uniforms per key at counters
//                     (j / used)·drawn + j % used; lead zero columns first.
//                     The dipole's irradiance samples
//                     (pbrt_tpu/integrators/dipole.py:128-133), photon and
//                     VPL paths (photonmap.py:53-57, :96-97; igi.py:45-49,
//                     :76-77), IGI's VPL picks (path.py:611, igi.py:111-112),
//                     the irradiance cache's gather directions and the
//                     BatchedKeySource blocks of its nested traces
//                     (irradiance.py:69-74, path.py:115-120);
//   mlt_mutate      — the Metropolis renderer's mutation of every chain's
//                     primary-sample vector (pbrt_tpu/renderers/
//                     metropolis.py:73-83, _mutate): with k1..k4 =
//                     split(key, 4) = fold_in(key, 0..3) and ka =
//                     fold_in(key, 99), element (r, d) at counter r·D + d
//                     takes u_large = U(k1), eps = U(k2), sign = U(k3) <
//                     0.5 ? -1 : 1, delta = s2·exp(-log(s2/s1)·eps) and
//                     u_small = (u + sign·delta) mod 1 (jnp.remainder: the
//                     sign follows the divisor); chain r is large where
//                     U(k4) at counter r < p_large, and its accept
//                     uniform is U(ka) at counter r (:169). Its large-only
//                     mode writes jax.random.uniform(k1, (N, D)) (the
//                     bootstrap's primary samples, :119-120; the PRT
//                     projection's and the probes' directions).
// The camera columns by sampler code (core/rng.py:camera_columns_plain;
// the per-launch constants c[] are computed once per wave on the host, by
// core/rng.py:sampler_constants):
//   lowdiscrepancy (and adaptive) — (0,2) image and lens pairs and van der
//                     Corput time from scramble words 0-4;
//   halton          — min((c[j] + unit(scr[j])) mod 1, 1 - ulp), c[j] the
//                     radical inverse of n in base 2, 3, 5, 7, 11;
//   bestcandidate   — the table row (c[0], c[1]) shifted by unit(scr[0]),
//                     unit(scr[1]) mod 1; lens the (0,2) pair of scr[0..1],
//                     time van der Corput of scr[2];
//   random          — 5 uniforms at counters 0-4 of the lane key (pixel, n)
//                     folded with tag 0 (CAMERA);
//   stratified      — the same, the image pair ((c[0] + u0) · c[2],
//                     (c[1] + u1) · c[2]): the cell and float32(1 / g), g =
//                     floor(sqrt(spp)) (XLA compiles the JAX package's
//                     division by the constant g into this product).
//                     jax.random.normal is uniform(minval = nextafter(-1, 0),
//                     maxval = 1) of the same bits, then sqrt(2)·erf_inv; XLA
//                     expands erf_inv into Giles' single-precision
//                     polynomial on w = -log1p(-u²), two branches split at
//                     w = 5, which is written out here and in
//                     core/rng.py:normals_from_bits in the same order, with
//                     the same log1pf (XLA's CPU backend fuses its Horner
//                     steps into FMAs and has its own log1p: its normals
//                     differ from these by at most 3 ulps).
// The port's plain versions are pbrt_torch/core/rng.py and
// core/sampling.py:camera_uniforms; rng.py's docstring gives the jax
// semantics each step follows (fold_in = threefry(key, (0, data)); bits[i]
// = y0 ^ y1 of threefry(key, (0, i)); uniform = ((bits >> 9) | 0x3F800000)
// as float, minus 1).
//
// What bounds it on this card: integer operations. One hash is 20 rounds of
// add, rotate, xor plus 11 key-injection adds, about 72 SASS instructions
// (20 SHF, 20 LOP3, the adds mostly IMAD.IADD on the FMA pipe); a lane of
// keyed_uniforms needs 38 at depth 5 (3 for its key, 35 uniforms), a lane
// of keyed_scrambles 9. Bytes are few (8 + 48 in, 4·(5 + 7·D) out; 8 in,
// 48 out). A 32,768-lane launch is 1,024 warps, 2 per scheduler: besides
// the hashes, the load and 3-hash key chain at its start and the copy-out at
// its end are latency that no other warp hides.
//
// What the design does about it:
//   keyed_uniforms  — one thread per lane (row) derives the lane's key once
//                     and hashes its row's 7·D uniforms, a bounce's 7 hashes
//                     unrolled so that several are in flight; the camera
//                     columns are 5 xors with per-launch words (brev(n), the
//                     Sobol' word of n). A warp writes its 32 rows into a
//                     shared tile laid out as their block of out (row-major,
//                     unpadded) and copies it out with 16-byte stores. Rows
//                     wider than one tile (D > 8) go in passes of 8 bounces,
//                     copied row by row. 32-bit index arithmetic; the
//                     wrapper checks R·(5 + 7·D) < 2^31.
//   keyed_ao_uniforms — keyed_uniforms' design: one thread per lane, the
//                     lane key once, then per AO sample its fold-in and two
//                     hashes; the same camera columns, warp tile and
//                     copy-out, in passes of 16 samples.
//   keyed_scrambles — one thread per lane, 6 independent hashes after the
//                     key; the block's words are staged in shared memory and
//                     written out by consecutive threads as consecutive
//                     16-byte pieces (two int64 words each).
//   the sampler codes — the camera columns of keyed_uniforms and
//                     keyed_ao_uniforms take a code and 5 floats per launch;
//                     random and stratified derive the lane's camera key (1
//                     more hash) and hash 5 counters, the others read the
//                     scramble words as before. Same tile and copy-out.
//   keyed_volume_uniforms, keyed_chain_uniforms — tiles of rows: a block
//                     (its threads sized by the host so that a pass covers
//                     whole rows, at most 512) takes a band of rows (as
//                     many bands as the card holds blocks at once, so the
//                     last wave is a full one) and, tile by tile (the whole
//                     row, or 1,024 columns of a wider one), derives each
//                     row's lane key once (2 hashes) and each outer key
//                     once (the chain's tags but the last, shared by
//                     count_last consecutive groups; the volume block's
//                     bounce-0 VOLUME key), a thread a (row, key), staged
//                     in shared memory. Then each group key once: where
//                     the groups are narrow (the volume block's jitters
//                     and 3-column steps; a chain of one uniform a group,
//                     IGI's picks and the cache's jitters) a thread a
//                     (row, group) hashes the group's uniforms beside it;
//                     else the group keys are staged too and a thread
//                     keeps one column, stepping through the rows (one
//                     uniform an iteration, 81 SASS instructions), each
//                     pass one contiguous run of out. A row of at most 8
//                     uniforms in groups of at most 2 under its lane key
//                     (the volume block under emission) is one thread's,
//                     the groups unrolled; where its groups are of 2
//                     (ambient occlusion's keyed directions, the cache's
//                     gather directions) a thread takes a group and derives
//                     the lane key itself (4× the warps); in kernels of
//                     their own (keyed_*_rows_kernel), no barrier. Each key of the chain's prefix
//                     tree once (the VPL picks' 5 + 40 fold-ins, not 2 a
//                     column). Column → (group, counter) and every index
//                     split are multiply-shift divisions by per-launch
//                     constants (Div: the wrapper's core/rng.py:divisor,
//                     checked by the entry), no divide at run time.
//   keyed_camera_normals — a block takes a band of rows (about an item a
//                     thread), each row's lane key once (a thread two
//                     rows, 2 hashes each, in flight together) in shared
//                     memory, one barrier; then a thread takes one or two
//                     consecutive (row, tag) items (two where the launch
//                     fills every SM at one): their fold-ins, words 0 and 1
//                     and normals together, stored as one 8- or 16-byte
//                     piece at row·T + t, so consecutive threads store
//                     consecutive pieces (no tile). A lane of the realistic
//                     camera's 11-row stack is 35 hashes and 22 normals (a
//                     log1pf, a sqrtf on the far branch, 9 Horner steps
//                     each), bound by operations. The ideal camera's one
//                     tag goes a row a thread (keyed_camera_normals_rows_
//                     kernel: the lane key, the tag, both words, one
//                     8-byte store, no barrier).
//   mlt_mutate      — a block takes a band of chains (as many bands as the
//                     card holds blocks, so the last wave is a full one):
//                     a thread a chain hashes its flag U(k4) into shared
//                     memory and writes is_large, another its accept
//                     uniform U(ka), one barrier. Then a warp takes a
//                     32-column tile of one chain (no divide: column =
//                     tile·32 + lane), so large or small is the warp's,
//                     and hashes only what the chain needs: U(k1), or U(k2)
//                     and U(k3) together (the plain version draws all
//                     three; the bits are the same); the tails of 32 / (D
//                     mod 32) chains share a warp (D = 40: four 8-column
//                     tails). The wrap is a select where fmodf is exact
//                     (wrap_remainder); expf as torch.exp on the card;
//                     stores coalesced per tile. The large-only mode
//                     (mlt_flat_uniforms_kernel) is a thread 1 or 4
//                     consecutive counters, their hashes in flight
//                     together, one 4- or 16-byte store. Multiply-shift
//                     index splits (MutatePlan: the wrapper's
//                     core/rng.py:mutate_plan, checked by the entry);
//                     32-bit counters, the wrapper checks N·D < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kDrawn = 8;     // uniforms drawn per bounce (BatchedKeySource)
constexpr int kUsed = 7;      // the ones the path integrator reads
constexpr int kCameraCols = 5;
constexpr int kScrambles = 6;
constexpr int kPassBounces = 8;            // bounces per tile pass
constexpr int kAoPerSample = 2;  // uniforms per AO sample
constexpr int kPassSamples = 16;           // AO samples per tile pass
constexpr int kNormalsPerTag = 2;          // jax.random.normal(key, (2,))

constexpr uint32_t kBatchedTag = 15u;  // bounce 0 * 16 + reserved purpose 15
constexpr uint32_t kCameraTag = 0u;    // bounce 0 * 16 + CAMERA
constexpr uint32_t kAoPurpose = 3u;    // BSDF_SAMPLE: AO sample s folds in s * 16 + 3
constexpr uint32_t kOneMinusEps = 0x3F7FFFFFu;  // largest float below 1
constexpr uint32_t kVolumePurpose = 8u;  // VOLUME: bounce b folds in b * 16 + 8
constexpr uint32_t kLightSamplePurpose = 2u;  // LIGHT_SAMPLE: step k folds in k * 16 + 2
constexpr int kVolumeSteps = 32;  // march steps per segment (volumes.py TAU_STEPS)
constexpr int kPerStep = 3;       // uniforms single scattering draws per step
constexpr int kMaxChain = 4;         // tags of a keyed_chain_uniforms chain
constexpr uint32_t kTagStep = 16u;   // bounce_key: tag = index * 16 + purpose

constexpr int kMaxTileThreads = 512;  // threads of a keyed_volume / keyed_chain block, at most
constexpr int kMaxTileCols = 1024;   // a wider row is cut into column tiles
constexpr int kRowUniforms = 8;      // the most uniforms of a row keyed_rows takes,
constexpr int kRowCols = 2;          // in groups of at most this many
constexpr int kRowMaxThreads = 256;  // threads of a row kernel's block, at most
constexpr unsigned kMaxTileBytes = 48u * 1024u;  // a tile's staged keys

// the sampler codes (core/rng.py)
enum : int { kLowDiscrepancy = 0, kHalton = 1, kBestCandidate = 2, kRandom = 3,
             kStratified = 4 };

// a wave's camera sampler: its code and per-launch constants
struct CameraSampler {
  int code;
  float c[5];
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry-2x32, 20 rounds, as jax's _threefry2x32_lowering (unrolled)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
}

// jax.random.fold_in: the key hashes the counter pair (0, data)
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// 32 random bits of counter i (jax's partitionable random_bits)
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform's float from 32 bits
__device__ __forceinline__ float uniform_from_bits(uint32_t r) {
  return __uint_as_float((r >> 9) | 0x3F800000u) - 1.0f;
}

// sampling._bits_to_unit: round to nearest, times 2^-32 (exact), below 1
__device__ __forceinline__ float unit_from_bits(uint32_t b) {
  return fminf(__uint2float_rn(b) * 0x1p-32f, __uint_as_float(kOneMinusEps));
}

// sampling.sobol2 without its scramble: the xor of the direction words
// v_0 = 2^31, v_{i+1} = v_i ^ (v_i >> 1) over the set bits of n (the words
// fold to constants; n is the same for the whole launch)
__device__ __forceinline__ uint32_t sobol2_word(uint32_t n) {
  uint32_t s = 0u, v = 1u << 31;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((n >> i) & 1u) s ^= v;
    v ^= v >> 1;
  }
  return s;
}

// a warp tile's columns: the widest pass's (the first)
__host__ __device__ constexpr unsigned tile_cols(int D) {
  return kCameraCols + kUsed * (D < kPassBounces ? D : kPassBounces);
}

__host__ __device__ constexpr unsigned ao_tile_cols(int n) {
  return kCameraCols + kAoPerSample * (n < kPassSamples ? n : kPassSamples);
}

// Giles' erf_inv coefficients as XLA writes them (w < 5, then w >= 5),
// highest degree first
__constant__ float kErfInvSmall[9] = {
    2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
    0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f, 1.50140941f};
__constant__ float kErfInvLarge[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
    0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f, 2.83297682f};

// jax.random.normal's float32 from 32 bits: the uniform on
// [nextafter(-1, 0), 1) (maxval - minval rounds to 2 in float32), then
// sqrt(2) * erf_inv. |u| < 1 always, so erf_inv's ±1 edge case never arises.
__device__ __forceinline__ float normal_from_bits(uint32_t r) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(lo, uniform_from_bits(r) * 2.0f + lo);
  float w = -log1pf(-(u * u));
  const bool small = w < 5.0f;
  w = small ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = small ? kErfInvSmall[0] : kErfInvLarge[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (small ? kErfInvSmall[i] : kErfInvLarge[i]) + p * w;
  return (p * u) * 1.41421354f;  // float32(sqrt(2))
}

// (c + s) mod 1, capped below 1: exact for c + s in [0, 2)
__device__ __forceinline__ float wrap_unit(float c, float s) {
  return fminf(fmodf(s + c, 1.0f), __uint_as_float(kOneMinusEps));
}

// the camera columns of sample n under sampler kCode; (a, c) is the lane
// key (pixel, sample) before any purpose tag
template <int kCode>
__device__ __forceinline__ void camera_cols(float* dst, uint32_t sample,
                                            const uint32_t* scr, uint32_t a,
                                            uint32_t c, const CameraSampler& cs) {
  if (kCode == kRandom || kCode == kStratified) {
    fold_in(a, c, kCameraTag);
#pragma unroll
    for (int j = 0; j < kCameraCols; ++j) dst[j] = uniform_from_bits(bits_at(a, c, j));
    if (kCode == kStratified) {
      dst[0] = (dst[0] + cs.c[0]) * cs.c[2];
      dst[1] = (dst[1] + cs.c[1]) * cs.c[2];
    }
    return;
  }
  if (kCode == kHalton) {
#pragma unroll
    for (int j = 0; j < kCameraCols; ++j) dst[j] = wrap_unit(cs.c[j], uniform_from_bits(scr[j]));
    return;
  }
  const uint32_t vdc = __brev(sample), sob = sobol2_word(sample);
  if (kCode == kBestCandidate) {
    dst[0] = wrap_unit(cs.c[0], uniform_from_bits(scr[0]));
    dst[1] = wrap_unit(cs.c[1], uniform_from_bits(scr[1]));
    dst[2] = unit_from_bits(vdc ^ scr[0]);
    dst[3] = unit_from_bits(sob ^ scr[1]);
    dst[4] = unit_from_bits(vdc ^ scr[2]);
    return;
  }
  dst[0] = unit_from_bits(vdc ^ scr[0]);
  dst[1] = unit_from_bits(sob ^ scr[1]);
  dst[2] = unit_from_bits(vdc ^ scr[2]);
  dst[3] = unit_from_bits(sob ^ scr[3]);
  dst[4] = unit_from_bits(vdc ^ scr[4]);
}

// the lane's scramble words, where sampler kCode reads them
template <int kCode>
__device__ __forceinline__ void load_scrambles(uint32_t* scr, const long long* scrambles,
                                               unsigned row) {
  if (kCode == kRandom || kCode == kStratified) return;
#pragma unroll
  for (int j = 0; j < kCameraCols; ++j)
    scr[j] = static_cast<uint32_t>(scrambles[row * kScrambles + j]);
}

// A warp's tile of ``rows`` rows × ``cols`` columns (row-major, unpadded)
// into columns [col0, col0 + cols) of rows [base, base + rows) of out, whose
// rows are ``width`` floats. One pass over the whole row is the rows' block
// of out, copied with 16-byte stores; a part of a row is copied row by row.
__device__ __forceinline__ void copy_tile_out(const float* tile, float* out,
                                              unsigned base, unsigned rows,
                                              unsigned cols, unsigned width,
                                              unsigned col0, unsigned lane) {
  if (cols == width) {
    const unsigned n = rows * cols;
    float* dst = out + base * width;  // 16-byte aligned: base is a multiple of 32
    for (unsigned i = lane; i < n / 4; i += kWarp)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(tile)[i];
    for (unsigned i = n / 4 * 4 + lane; i < n; i += kWarp) dst[i] = tile[i];
  } else {
    for (unsigned r = 0; r < rows; ++r)
      for (unsigned q = lane; q < cols; q += kWarp)
        out[(base + r) * width + col0 + q] = tile[r * cols + q];
  }
}

template <int kCode>
__global__ void __launch_bounds__(kThreads)
keyed_uniforms_kernel(uint32_t k0, uint32_t k1,
                      const long long* __restrict__ pixel,
                      const long long* __restrict__ scrambles, int R,
                      uint32_t sample, int D, CameraSampler cs,
                      float* __restrict__ out) {
  extern __shared__ float4 tiles[];  // kWarps tiles of kWarp × tile_cols(D) floats
  const unsigned lane = threadIdx.x % kWarp;
  const unsigned warp = threadIdx.x / kWarp;
  const unsigned base = (blockIdx.x * kWarps + warp) * kWarp;  // warp's first row
  if (base >= static_cast<unsigned>(R)) return;  // the whole warp
  const unsigned rows = min(static_cast<unsigned>(R) - base, static_cast<unsigned>(kWarp));
  const unsigned row = base + lane;
  const bool live = lane < rows;
  const unsigned width = kCameraCols + kUsed * D;
  float* tile = reinterpret_cast<float*>(tiles) + warp * kWarp * tile_cols(D);

  uint32_t a = k0, c = k1, la = 0u, lc = 0u;  // (a, c): the bounce key; (la, lc): the lane key
  uint32_t scr[kCameraCols];
  if (live) {
    load_scrambles<kCode>(scr, scrambles, row);
    fold_in(a, c, static_cast<uint32_t>(pixel[row]));
    fold_in(a, c, sample);
    la = a;
    lc = c;
    fold_in(a, c, kBatchedTag);
  }

  const int passes = D > 0 ? (D + kPassBounces - 1) / kPassBounces : 1;
  for (int p = 0; p < passes; ++p) {
    const int b0 = p * kPassBounces;
    const int nb = min(D - b0, kPassBounces);
    const unsigned cam = p == 0 ? kCameraCols : 0;
    const unsigned cols = cam + kUsed * nb;          // this pass's columns
    const unsigned col0 = p == 0 ? 0 : kCameraCols + kUsed * b0;
    float* mine = tile + lane * cols;  // the tile is the rows' block, row-major
    if (live) {
      if (cam) camera_cols<kCode>(mine, sample, scr, la, lc, cs);
      for (int b = 0; b < nb; ++b) {
        const uint32_t ctr = static_cast<uint32_t>((b0 + b) * kDrawn);
        float* dst = mine + cam + b * kUsed;
#pragma unroll
        for (int j = 0; j < kUsed; ++j)
          dst[j] = uniform_from_bits(bits_at(a, c, ctr + j));
      }
    }
    __syncwarp();
    copy_tile_out(tile, out, base, rows, cols, width, col0, lane);
    __syncwarp();
  }
}

template <int kCode>
__global__ void __launch_bounds__(kThreads)
keyed_ao_uniforms_kernel(uint32_t k0, uint32_t k1,
                         const long long* __restrict__ pixel,
                         const long long* __restrict__ scrambles, int R,
                         uint32_t sample, int n, CameraSampler cs,
                         float* __restrict__ out) {
  extern __shared__ float4 tiles[];  // kWarps tiles of kWarp × ao_tile_cols(n) floats
  const unsigned lane = threadIdx.x % kWarp;
  const unsigned warp = threadIdx.x / kWarp;
  const unsigned base = (blockIdx.x * kWarps + warp) * kWarp;  // warp's first row
  if (base >= static_cast<unsigned>(R)) return;  // the whole warp
  const unsigned rows = min(static_cast<unsigned>(R) - base, static_cast<unsigned>(kWarp));
  const unsigned row = base + lane;
  const bool live = lane < rows;
  const unsigned width = kCameraCols + kAoPerSample * n;
  float* tile = reinterpret_cast<float*>(tiles) + warp * kWarp * ao_tile_cols(n);

  uint32_t a = k0, c = k1;  // the lane key: (pixel, sample), no purpose tag
  uint32_t scr[kCameraCols];
  if (live) {
    load_scrambles<kCode>(scr, scrambles, row);
    fold_in(a, c, static_cast<uint32_t>(pixel[row]));
    fold_in(a, c, sample);
  }

  const int passes = n > 0 ? (n + kPassSamples - 1) / kPassSamples : 1;
  for (int p = 0; p < passes; ++p) {
    const int s0 = p * kPassSamples;
    const int ns = min(n - s0, kPassSamples);
    const unsigned cam = p == 0 ? kCameraCols : 0;
    const unsigned cols = cam + kAoPerSample * ns;   // this pass's columns
    const unsigned col0 = p == 0 ? 0 : kCameraCols + kAoPerSample * s0;
    float* mine = tile + lane * cols;
    if (live) {
      if (cam) camera_cols<kCode>(mine, sample, scr, a, c, cs);
      for (int s = 0; s < ns; ++s) {
        uint32_t sa = a, sc = c;
        fold_in(sa, sc, static_cast<uint32_t>(s0 + s) * 16u + kAoPurpose);
        float* dst = mine + cam + s * kAoPerSample;
        dst[0] = uniform_from_bits(bits_at(sa, sc, 0u));
        dst[1] = uniform_from_bits(bits_at(sa, sc, 1u));
      }
    }
    __syncwarp();
    copy_tile_out(tile, out, base, rows, cols, width, col0, lane);
    __syncwarp();
  }
}

// x / d as a multiply and a shift, exact for every x < 2^31: m = ceil(2^s / d),
// s = 31 + ceil(log2 d) (Granlund and Montgomery's round-up method, m <
// 2^32), computed by the wrapper (core/rng.py:divisor) and checked by the
// entry (divisor_ok). d = 0 (no group) carries m = s = 0 and is never divided by.
struct Div {
  uint32_t d, m, s;
};

__device__ __forceinline__ unsigned div_by(unsigned x, const Div& v) {
  return static_cast<unsigned>((static_cast<unsigned long long>(x) * v.m) >> v.s);
}

// A keyed block's tiles: `rows` rows × cols.d columns of the (R, width)
// block (cols.d = width unless the row is wider than kMaxTileCols), its
// threads (a multiple of 32) and the tile rows a pass of them covers (at
// most threads / cols.d, or 1 in a tile wider than the block), and the outer
// and group key slots a tile row holds in shared memory (enough for the
// groups any tile's columns meet). In a launch of keyed_rows (pass_rows 0)
// `groups` is instead the threads a row's groups are dealt to: 1 (a thread
// takes them all) or one a group. Computed per launch by the wrapper
// (core/rng.py:keyed_tiling).
struct Tiling {
  uint32_t width, rows, col_tiles, threads, pass_rows;
  Div cols, outer, groups;
};

// keyed_chain_uniforms' columns and keys: lead zero columns, then group g's
// n uniforms at counters (i / used)·drawn + i mod used. Group g's key is the
// lane key folded with the chain's tags; the outer key (all tags but the
// last) is shared by count_last consecutive groups, g / count_last being
// its index and the tags' digits those of the mixed-radix index (the last
// tag varying fastest), each tag base + kTagStep·digit.
struct ChainMap {
  uint32_t n_outer, has_last, lead, drawn;
  uint32_t base[kMaxChain - 1];  // the outer tags
  Div count[kMaxChain - 1];
  uint32_t last_base;
  Div last, n, used;

  // [g0, g1): the groups whose columns meet [c0, c1)
  __device__ __forceinline__ void groups(unsigned c0, unsigned c1, unsigned& g0,
                                         unsigned& g1) const {
    if (n.d == 0 || c1 <= lead) {
      g0 = g1 = 0;
      return;
    }
    g0 = div_by(max(c0, lead) - lead, n);
    g1 = div_by(c1 - 1 - lead, n) + 1;
  }
  __device__ __forceinline__ unsigned outer_of(unsigned g) const { return div_by(g, last); }
  // whether the outer keys are the lane key, and every group one column
  // (its key and uniform one thread's); group g's first column and its
  // columns; the counter of a group's column i: (i / used)·drawn + i mod used
  static constexpr unsigned kFuseCols = 1;
  static constexpr bool kColumnPass = true;
  __device__ __forceinline__ bool outer_is_lane(unsigned, unsigned) const { return !n_outer; }
  __device__ __forceinline__ bool small_groups(unsigned, unsigned) const { return n.d == 1; }
  __device__ __forceinline__ unsigned group_columns(unsigned g, unsigned& col) const {
    col = lead + g * n.d;
    return n.d;
  }
  __device__ __forceinline__ unsigned counter(unsigned, unsigned i) const {
    const unsigned b = div_by(i, used);
    return b * drawn + (i - b * used.d);
  }
  __device__ __forceinline__ unsigned zero_columns(unsigned c0, unsigned cols) const {
    return c0 < lead ? min(lead - c0, cols) : 0u;
  }
  __device__ __forceinline__ void outer_key(unsigned o, uint32_t& a, uint32_t& c) const {
    unsigned idx[kMaxChain - 1];
#pragma unroll
    for (int i = kMaxChain - 2; i >= 0; --i) {
      if (i < static_cast<int>(n_outer)) {
        const unsigned q = div_by(o, count[i]);
        idx[i] = o - q * count[i].d;
        o = q;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxChain - 1; ++i)
      if (i < static_cast<int>(n_outer)) fold_in(a, c, base[i] + kTagStep * idx[i]);
  }
  __device__ __forceinline__ void group_key(unsigned g, uint32_t& a, uint32_t& c) const {
    if (has_last) fold_in(a, c, last_base + kTagStep * (g - outer_of(g) * last.d));
  }
  // false for a lead column (zero)
  __device__ __forceinline__ bool column(unsigned col, unsigned& g, unsigned& ctr) const {
    if (col < lead) return false;
    const unsigned j = col - lead;
    g = div_by(j, n);
    ctr = counter(g, j - g * n.d);
    return true;
  }
};

// keyed_volume_uniforms' columns and keys: group g < J is jitter g (its key
// the lane key folded with g·16 + VOLUME, counter 0), group J + k march step
// k (bounce 0's VOLUME key folded with k·16 + LIGHT_SAMPLE, counters 0-2).
// Outer key 0 is the lane key, outer key 1 bounce 0's VOLUME key.
struct VolumeMap {
  uint32_t jitters;

  __device__ __forceinline__ unsigned group_of(unsigned col) const {
    return col < jitters ? col : jitters + (col - jitters) / kPerStep;
  }
  __device__ __forceinline__ void groups(unsigned c0, unsigned c1, unsigned& g0,
                                         unsigned& g1) const {
    g0 = group_of(c0);
    g1 = group_of(c1 - 1) + 1;
  }
  __device__ __forceinline__ unsigned outer_of(unsigned g) const { return g < jitters ? 0u : 1u; }
  // a jitter is one column, a step three: a group's key and uniforms are
  // always one thread's (no column pass)
  static constexpr unsigned kFuseCols = kPerStep;
  static constexpr bool kColumnPass = false;
  __device__ __forceinline__ bool outer_is_lane(unsigned, unsigned o1) const { return o1 <= 1; }
  __device__ __forceinline__ bool small_groups(unsigned, unsigned) const { return true; }
  __device__ __forceinline__ unsigned group_columns(unsigned g, unsigned& col) const {
    col = g < jitters ? g : jitters + (g - jitters) * kPerStep;
    return g < jitters ? 1u : static_cast<unsigned>(kPerStep);
  }
  __device__ __forceinline__ unsigned counter(unsigned, unsigned i) const { return i; }
  __device__ __forceinline__ unsigned zero_columns(unsigned, unsigned) const { return 0u; }
  __device__ __forceinline__ void outer_key(unsigned o, uint32_t& a, uint32_t& c) const {
    if (o) fold_in(a, c, kVolumePurpose);
  }
  __device__ __forceinline__ void group_key(unsigned g, uint32_t& a, uint32_t& c) const {
    fold_in(a, c, g < jitters ? g * kTagStep + kVolumePurpose
                              : (g - jitters) * kTagStep + kLightSamplePurpose);
  }
};

// group g's key (from the lane key a, c) and its uniforms, into the row at dst
template <class Map>
__device__ __forceinline__ void row_group(const Map& mp, unsigned g, uint32_t a, uint32_t c,
                                          float* __restrict__ dst) {
  unsigned col;
  mp.group_key(g, a, c);
  const unsigned n_cols = mp.group_columns(g, col);
#pragma unroll
  for (unsigned j = 0; j < kRowCols; ++j)
    if (j < n_cols) dst[col + j] = uniform_from_bits(bits_at(a, c, mp.counter(g, j)));
}

// A row of at most kRowUniforms uniforms in groups of at most kRowCols
// whose outer key is the lane key, dealt to tl.groups.d threads (tl.pass_rows
// 0, a block tl.rows rows): one thread takes every group of the row where
// the groups are one uniform (the volume block under emission), the groups
// unrolled so that their hashes are in flight together; else a thread a
// group (ambient occlusion's keyed directions, the cache's gather
// directions: 2 uniforms a group), each deriving the lane key itself, so
// that the short launch has 4-8 times the warps. Each thread: the lane key,
// then its groups' keys and uniforms; no shared memory, no barrier. Its own
// kernels (keyed_*_rows_kernel), so that its registers are not the tiles'.
template <class Map>
__device__ __forceinline__ void keyed_rows(const Map& mp, const Tiling& tl, uint32_t k0,
                                           uint32_t k1, const long long* __restrict__ index,
                                           unsigned R, uint32_t sample,
                                           float* __restrict__ out) {
  // this thread's row of the block and its group s, or every group of the
  // row (tl.groups.d 1)
  const unsigned rr = div_by(threadIdx.x, tl.groups), s = threadIdx.x - rr * tl.groups.d;
  const unsigned r = blockIdx.x * tl.rows + rr;
  if (rr >= tl.rows || r >= R) return;
  uint32_t a = k0, c = k1;
  fold_in(a, c, static_cast<uint32_t>(index[r]));
  fold_in(a, c, sample);
  float* dst = out + r * tl.width;
  unsigned g0, g1;
  mp.groups(0, tl.width, g0, g1);
  if (s == 0)
    for (unsigned q = 0; q < mp.zero_columns(0, tl.width); ++q) dst[q] = 0.0f;
  if (tl.groups.d > 1) {  // tl.groups.d = g1 - g0 (the entry's check)
    row_group(mp, g0 + s, a, c, dst);
    return;
  }
#pragma unroll
  for (unsigned i = 0; i < kRowUniforms; ++i)
    if (g0 + i < g1) row_group(mp, g0 + i, a, c, dst);
}

// One block's band of `tl.rows` rows, tile by tile: the lane keys (one
// thread a row), then each tile's outer keys (none where they are the lane
// keys), staged in shared memory; then, where every group is narrow (the
// volume block's jitters and steps, Map::kFuseCols = 3; a chain of one
// uniform a group: IGI's picks, the cache's jitters), a thread a (row,
// group) derives the group's key and hashes its uniforms together; else the
// group keys are staged too (a thread a (row, group)) and a thread keeps
// one column and steps through the rows, pass_rows at a time (a pass is
// pass_rows whole tile rows over the block's threads, so each pass stores
// one contiguous run of out), or, in a tile wider than the block, keeps
// every blockDim-th column through all rows.
template <class Map>
__device__ __forceinline__ void keyed_tiles(const Map& mp, const Tiling& tl, uint32_t k0,
                                            uint32_t k1, const long long* __restrict__ index,
                                            unsigned R, uint32_t sample,
                                            float* __restrict__ out) {
  extern __shared__ uint2 keys[];  // lane keys, outer keys, group keys
  const unsigned nt = blockDim.x, t = threadIdx.x;
  const unsigned r0 = blockIdx.x * tl.rows;
  const unsigned rows = min(R - r0, tl.rows);
  uint2* lane = keys;
  uint2* outer = lane + tl.rows;
  uint2* group = outer + tl.rows * tl.outer.d;
  for (unsigned r = t; r < rows; r += nt) {
    uint32_t a = k0, c = k1;
    fold_in(a, c, static_cast<uint32_t>(index[r0 + r]));
    fold_in(a, c, sample);
    lane[r] = make_uint2(a, c);
  }
  for (unsigned tile = blockIdx.y; tile < tl.col_tiles; tile += gridDim.y) {
    const unsigned c0 = tile * tl.cols.d, cols = min(tl.cols.d, tl.width - c0);
    unsigned g0, g1;
    mp.groups(c0, c0 + cols, g0, g1);
    const unsigned o0 = g1 > g0 ? mp.outer_of(g0) : 0u;
    const unsigned o1 = g1 > g0 ? mp.outer_of(g1 - 1) + 1 : 0u;
    __syncthreads();  // the lane keys written; the last tile's keys read
    // the outer keys: the lane keys themselves where no outer tag is folded
    const bool lane_outer = mp.outer_is_lane(o0, o1);
    const uint2* okeys = lane_outer ? lane : outer;
    const unsigned ostride = lane_outer ? 1u : tl.outer.d;
    if (!lane_outer) {
      for (unsigned p = t; p < rows * tl.outer.d; p += nt) {
        const unsigned r = div_by(p, tl.outer), o = o0 + (p - r * tl.outer.d);
        if (o < o1) {
          uint2 k = lane[r];
          mp.outer_key(o, k.x, k.y);
          outer[p] = k;
        }
      }
      __syncthreads();
    }
    if (mp.small_groups(g0, g1)) {  // a group's key and its few uniforms together
      const unsigned zc = mp.zero_columns(c0, cols);
      for (unsigned p = t; p < rows * zc; p += nt)
        out[(r0 + p / zc) * tl.width + c0 + p % zc] = 0.0f;
      for (unsigned p = t; p < rows * tl.groups.d; p += nt) {
        const unsigned r = div_by(p, tl.groups), g = g0 + (p - r * tl.groups.d);
        if (g < g1) {
          uint2 k = okeys[r * ostride + mp.outer_of(g) - o0];
          mp.group_key(g, k.x, k.y);
          unsigned col;
          const unsigned n_cols = mp.group_columns(g, col);
          float* dst = out + (r0 + r) * tl.width;
#pragma unroll
          for (unsigned i = 0; i < Map::kFuseCols; ++i) {
            if (i < n_cols && col + i >= c0 && col + i < c0 + cols)
              dst[col + i] = uniform_from_bits(bits_at(k.x, k.y, mp.counter(g, i)));
          }
        }
      }
      continue;
    }
    if constexpr (Map::kColumnPass) {  // the group keys staged, then a thread a column
      for (unsigned p = t; p < rows * tl.groups.d; p += nt) {
        const unsigned r = div_by(p, tl.groups), g = g0 + (p - r * tl.groups.d);
        if (g < g1) {
          uint2 k = okeys[r * ostride + mp.outer_of(g) - o0];
          mp.group_key(g, k.x, k.y);
          group[p] = k;
        }
      }
      __syncthreads();
      // this thread's first row and column, and the rows a pass steps
      const bool full = cols == tl.cols.d;
      const unsigned step = cols > nt ? 1u : full ? tl.pass_rows : nt / cols;
      const unsigned r_first = cols > nt ? 0u : full ? div_by(t, tl.cols) : t / cols;
      if (r_first >= step) continue;  // past the last whole tile row of a pass
      for (unsigned q = t - r_first * cols; q < cols; q += nt) {
        unsigned g, ctr;
        float* dst = out + (r0 + r_first) * tl.width + c0 + q;
        const size_t dst_step = static_cast<size_t>(step) * tl.width;
        if (mp.column(c0 + q, g, ctr)) {
          const uint2* key = group + r_first * tl.groups.d + (g - g0);
          const unsigned key_step = step * tl.groups.d;
          for (unsigned r = r_first; r < rows; r += step, key += key_step, dst += dst_step) {
            const uint2 k = *key;
            *dst = uniform_from_bits(bits_at(k.x, k.y, ctr));
          }
        } else {
          for (unsigned r = r_first; r < rows; r += step, dst += dst_step) *dst = 0.0f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxTileThreads)
keyed_volume_uniforms_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ pixel,
                             int R, uint32_t sample, VolumeMap mp, Tiling tl,
                             float* __restrict__ out) {
  keyed_tiles(mp, tl, k0, k1, pixel, static_cast<unsigned>(R), sample, out);
}

__global__ void __launch_bounds__(kRowMaxThreads)
keyed_volume_rows_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ pixel, int R,
                         uint32_t sample, VolumeMap mp, Tiling tl, float* __restrict__ out) {
  keyed_rows(mp, tl, k0, k1, pixel, static_cast<unsigned>(R), sample, out);
}

__global__ void __launch_bounds__(kMaxTileThreads)
keyed_chain_uniforms_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ index,
                            int R, uint32_t sample, ChainMap mp, Tiling tl,
                            float* __restrict__ out) {
  keyed_tiles(mp, tl, k0, k1, index, static_cast<unsigned>(R), sample, out);
}

__global__ void __launch_bounds__(kRowMaxThreads)
keyed_chain_rows_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ index, int R,
                        uint32_t sample, ChainMap mp, Tiling tl, float* __restrict__ out) {
  keyed_rows(mp, tl, k0, k1, index, static_cast<unsigned>(R), sample, out);
}

__global__ void __launch_bounds__(kThreads)
keyed_scrambles_kernel(uint32_t k0, uint32_t k1,
                       const long long* __restrict__ pixel, int R,
                       long long* __restrict__ out) {
  __shared__ __align__(16) uint32_t words[kThreads * kScrambles];
  const unsigned first = blockIdx.x * kThreads;
  const unsigned rows = min(static_cast<unsigned>(R) - first, static_cast<unsigned>(kThreads));
  if (threadIdx.x < rows) {
    uint32_t a = k0, c = k1;
    fold_in(a, c, static_cast<uint32_t>(pixel[first + threadIdx.x]));
    fold_in(a, c, 0u);  // sample 0: scrambles are per pixel
    fold_in(a, c, kCameraTag);
#pragma unroll
    for (int j = 0; j < kScrambles; ++j)
      words[threadIdx.x * kScrambles + j] = bits_at(a, c, static_cast<uint32_t>(j));
  }
  __syncthreads();
  // the block's rows × 6 words, contiguous in out: piece p holds words 2p
  // and 2p + 1, each widened to int64 (high word 0)
  const uint2* pairs = reinterpret_cast<const uint2*>(words);
  uint4* dst = reinterpret_cast<uint4*>(out + first * kScrambles);
  for (unsigned p = threadIdx.x; p < rows * (kScrambles / 2); p += kThreads) {
    const uint2 w = pairs[p];
    dst[p] = make_uint4(w.x, 0u, w.y, 0u);
  }
}

constexpr int kNormalThreads = 256;  // threads of a normals block, at most

// The lens cameras' normals, (R, T, 2): a block takes a band of `band` rows
// (even, so that its first element is 16-byte aligned), derives each row's
// lane key once (a thread two rows, their hashes in flight together) into
// shared memory; then a thread takes kItems consecutive (row, tag) items of
// the band in flat order, the second perhaps the next row's tag 0: their
// fold-ins, words and normals together, one 8- or 16-byte store (8 for a
// band's odd last item). `tags` divides an item index by T.
template <int kItems>
__global__ void __launch_bounds__(kNormalThreads)
keyed_camera_normals_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ pixel, int R,
                            uint32_t sample, uint32_t tag0, int T, Div tags, unsigned band,
                            float* __restrict__ out) {
  extern __shared__ uint2 lane_keys[];
  const unsigned t = threadIdx.x, nt = blockDim.x;
  const unsigned r0 = blockIdx.x * band, rows = min(band, static_cast<unsigned>(R) - r0);
  for (unsigned r = 2 * t; r < rows; r += 2 * nt) {
    const unsigned r1 = min(r + 1, rows - 1);
    uint32_t a = k0, c = k1, a1 = k0, c1 = k1;
    fold_in(a, c, static_cast<uint32_t>(pixel[r0 + r]));
    fold_in(a1, c1, static_cast<uint32_t>(pixel[r0 + r1]));
    fold_in(a, c, sample);
    fold_in(a1, c1, sample);
    lane_keys[r] = make_uint2(a, c);
    lane_keys[r1] = make_uint2(a1, c1);
  }
  __syncthreads();
  const unsigned n = static_cast<unsigned>(T), items = rows * n;
  float* base = out + 2 * r0 * n;
  for (unsigned p = kItems * t; p < items; p += kItems * nt) {
    const unsigned r = div_by(p, tags), ta = p - r * n;
    uint2 k[kItems];
    uint32_t w[kItems][kNormalsPerTag];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {  // past the row's end: the next row's tag 0
      const bool next = ta + i >= n;
      k[i] = lane_keys[min(next ? r + 1 : r, rows - 1)];
      fold_in(k[i].x, k[i].y, tag0 + (next ? ta + i - n : ta + i));
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      w[i][0] = bits_at(k[i].x, k[i].y, 0u);
      w[i][1] = bits_at(k[i].x, k[i].y, 1u);
    }
    if (kItems == 2 && p + 1 < items)
      reinterpret_cast<float4*>(base)[p / 2] =
          make_float4(normal_from_bits(w[0][0]), normal_from_bits(w[0][1]),
                      normal_from_bits(w[kItems - 1][0]), normal_from_bits(w[kItems - 1][1]));
    else
      reinterpret_cast<float2*>(base)[p] =
          make_float2(normal_from_bits(w[0][0]), normal_from_bits(w[0][1]));
  }
}

// The ideal camera's one tag: a thread a row, the lane key, the tag's key,
// both words in flight together and one 8-byte store; no shared memory, no
// barrier.
__global__ void __launch_bounds__(kNormalThreads)
keyed_camera_normals_rows_kernel(uint32_t k0, uint32_t k1, const long long* __restrict__ pixel,
                                 int R, uint32_t sample, uint32_t tag0, float* __restrict__ out) {
  const unsigned r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= static_cast<unsigned>(R)) return;
  uint32_t a = k0, c = k1;
  fold_in(a, c, static_cast<uint32_t>(pixel[r]));
  fold_in(a, c, sample);
  fold_in(a, c, tag0);
  const uint32_t b0 = bits_at(a, c, 0u), b1 = bits_at(a, c, 1u);
  reinterpret_cast<float2*>(out)[r] = make_float2(normal_from_bits(b0), normal_from_bits(b1));
}

// the five keys of a mutation: large, eps, sign, is_large, accept
struct MutateKeys {
  uint32_t a[5], c[5];
};

constexpr int kMutateThreads = 256;
constexpr int kMutateWarps = kMutateThreads / kWarp;
constexpr int kMutateBlocks = 8;  // blocks an SM: at most 32 registers a thread
constexpr unsigned kMaxBand = kMutateThreads / 2;  // a thread a chain's flag, one its accept

// mlt_mutate's launch plan, computed by the wrapper (core/rng.py:mutate_plan)
// and checked by the entry: a block takes a band of `band` chains; a chain's
// D columns are `full` whole 32-column tiles, a warp each, then a tail of
// `tail` = D mod 32 columns, the tails of `pack` = 32 / tail consecutive
// chains sharing one warp (lane → (chain of the pack, column): `tails`).
// `tiles` splits a whole-tile task into (chain, tile).
struct MutatePlan {
  uint32_t band, full, tail, pack;
  Div tiles, tails;  // d = full, d = tail
};

// x mod 1 with the divisor's sign, as torch.remainder: fmodf(x, 1), plus 1
// where that is below 0. For x in (-1, 2) (every u in [0, 1) moved by at
// most s2 = 1/16) fmodf(x, 1) is x - 1 for x >= 1 (exact: Sterbenz) and x
// else, so a select gives the same bits, -0.0 kept; other x take fmodf.
__device__ __forceinline__ float wrap_remainder(float x) {
  if (x > -1.0f && x < 2.0f) return x >= 1.0f ? x - 1.0f : x < 0.0f ? x + 1.0f : x;
  const float m = fmodf(x, 1.0f);
  return m < 0.0f ? m + 1.0f : m;
}

// task j of a band's warps for this lane: 2 with its element's chain r (of
// the band) and column, 1 where the warp has the task but this lane none,
// 0 past the band's last task. Whole tiles first (a tile of one chain, so
// large or small is the warp's), then the tails of `pack` chains a warp
// (this lane: column tc of the pack's chain `sub`).
__device__ __forceinline__ int mutate_task(const MutatePlan& mp, unsigned j, unsigned rows,
                                           unsigned lane, unsigned sub, unsigned tc,
                                           unsigned& r, unsigned& col) {
  const unsigned full_tasks = rows * mp.full;
  if (j < full_tasks) {
    r = div_by(j, mp.tiles);
    col = (j - r * mp.full) * kWarp + lane;
    return 2;
  }
  const unsigned first = (j - full_tasks) * mp.pack;  // the pack's first chain
  if (!mp.tail || first >= rows) return 0;
  r = min(first + sub, rows - 1);
  col = mp.full * kWarp + tc;
  return sub < mp.pack && first + sub < rows ? 2 : 1;
}

// the small step of element e: eps = U(k2), sign = U(k3) < 0.5 from the
// two words, then (u + sign·s2·exp(-log(s2/s1)·eps)) mod 1
__device__ __forceinline__ float small_step(float x, uint32_t eps_bits, uint32_t sign_bits,
                                            float neg_log_ratio, float s2) {
  const float eps = uniform_from_bits(eps_bits);
  const float sign = uniform_from_bits(sign_bits) < 0.5f ? -1.0f : 1.0f;
  return wrap_remainder(x + sign * (s2 * expf(neg_log_ratio * eps)));
}

__global__ void __launch_bounds__(kMutateThreads, kMutateBlocks)
mlt_mutate_kernel(MutateKeys ks, const float* __restrict__ u, int N, int D, MutatePlan mp,
                  float p_large, float neg_log_ratio, float s2, float* __restrict__ out,
                  unsigned char* __restrict__ is_large, float* __restrict__ u_acc) {
  __shared__ unsigned char large[kMaxBand];
  const unsigned t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const unsigned r0 = blockIdx.x * mp.band;
  const unsigned rows = min(mp.band, static_cast<unsigned>(N) - r0);
  // the band's chains: a thread a chain hashes U(k4) (its flag); the accept
  // uniforms U(ka) from the next warp on, so that both run at once
  const unsigned acc0 = (rows + kWarp - 1) / kWarp * kWarp;
  if (t < rows) {
    const bool lg = uniform_from_bits(bits_at(ks.a[3], ks.c[3], r0 + t)) < p_large;
    large[t] = lg;
    is_large[r0 + t] = lg;
  } else if (t >= acc0 && t < acc0 + rows) {
    u_acc[r0 + t - acc0] = uniform_from_bits(bits_at(ks.a[4], ks.c[4], r0 + t - acc0));
  }
  __syncthreads();
  const unsigned d = static_cast<unsigned>(D);
  const unsigned sub = mp.tail ? div_by(lane, mp.tails) : 0u;
  const unsigned tc = lane - sub * mp.tail;
  for (unsigned j = warp;; j += kMutateWarps) {
    unsigned r, col;
    const int st = mutate_task(mp, j, rows, lane, sub, tc, r, col);
    if (!st) break;
    if (st == 1) continue;
    const unsigned e = (r0 + r) * d + col;
    if (large[r]) {
      out[e] = uniform_from_bits(bits_at(ks.a[0], ks.c[0], e));
    } else {
      const float x = u[e];
      const uint32_t pe = bits_at(ks.a[1], ks.c[1], e), qe = bits_at(ks.a[2], ks.c[2], e);
      out[e] = small_step(x, pe, qe, neg_log_ratio, s2);
    }
  }
}

// the large-only mode, jax.random.uniform(key, (n, d)): a thread kPer
// consecutive counters (independent hashes in flight together), one
// kPer·4-byte store
template <int kPer>
__global__ void __launch_bounds__(kMutateThreads)
mlt_flat_uniforms_kernel(uint32_t k0, uint32_t k1, unsigned total, float* __restrict__ out) {
  const unsigned e = (blockIdx.x * kMutateThreads + threadIdx.x) * kPer;
  if (e >= total) return;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = uniform_from_bits(bits_at(k0, k1, e + j));
  if (e + kPer <= total) {
    if constexpr (kPer == 4)
      *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
    else
      out[e] = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (e + j < total) out[e + j] = v[j];
  }
}

// the kernel instance of the sampler code (each its own camera columns, so
// lowdiscrepancy's instance is the kernel without the other codes)
template <template <int> class Launch, typename... Args>
int by_code(int code, Args... args) {
  switch (code) {
    case kLowDiscrepancy: return Launch<kLowDiscrepancy>::run(args...);
    case kHalton: return Launch<kHalton>::run(args...);
    case kBestCandidate: return Launch<kBestCandidate>::run(args...);
    case kRandom: return Launch<kRandom>::run(args...);
    case kStratified: return Launch<kStratified>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kCode>
struct LaunchUniforms {
  static int run(uint32_t k0, uint32_t k1, const long long* pixel, const long long* scrambles,
                 int R, uint32_t sample, int max_depth, CameraSampler cs, float* out,
                 cudaStream_t stream) {
    if (R > 0)
      keyed_uniforms_kernel<kCode><<<(R - 1) / kThreads + 1, kThreads,
                                     kThreads * tile_cols(max_depth) * sizeof(float), stream>>>(
          k0, k1, pixel, scrambles, R, sample, max_depth, cs, out);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int kCode>
struct LaunchAoUniforms {
  static int run(uint32_t k0, uint32_t k1, const long long* pixel, const long long* scrambles,
                 int R, uint32_t sample, int n_ao, CameraSampler cs, float* out,
                 cudaStream_t stream) {
    if (R > 0)
      keyed_ao_uniforms_kernel<kCode><<<(R - 1) / kThreads + 1, kThreads,
                                        kThreads * ao_tile_cols(n_ao) * sizeof(float), stream>>>(
          k0, k1, pixel, scrambles, R, sample, n_ao, cs, out);
    return static_cast<int>(cudaGetLastError());
  }
};

// the entry's checks of a wrapper's divisor: d = 0 with m = s = 0, or
// d < 2^31 with Granlund and Montgomery's m and s
bool divisor_ok(const Div& v) {
  if (v.d == 0) return v.m == 0 && v.s == 0;
  if (v.d >= (1u << 31)) return false;
  uint32_t l = 0;
  while ((1ull << l) < v.d) ++l;
  return v.s == 31 + l && v.m == ((1ull << v.s) + v.d - 1) / v.d;
}

// a launch's grid (a block a band of rows; column tiles along y) and its
// staged keys' bytes
dim3 tile_grid(int R, const Tiling& tl) {
  return dim3((R - 1) / tl.rows + 1, std::min(tl.col_tiles, 65535u));
}

size_t tile_bytes(const Tiling& tl) {
  return tl.pass_rows ? 8ull * tl.rows * (1ull + tl.outer.d + tl.groups.d) : 0;
}

// the checks of a launch's tiling: its divisors, tiles that cover the row,
// key slots for the most groups (and outer keys) any tile's columns meet,
// staged keys within kMaxTileBytes and 32-bit indices
bool tiling_ok(const Tiling& tl, long long width, long long groups, long long outers) {
  if (!divisor_ok(tl.cols) || !divisor_ok(tl.outer) || !divisor_ok(tl.groups)) return false;
  const long long cols = tl.cols.d, rows = tl.rows;
  if (tl.width != width || cols < 1 || cols > width || (cols < width && cols > kMaxTileCols)
      || tl.col_tiles != (width + cols - 1) / cols || rows < 1 || tl.outer.d < 1
      || tl.groups.d < 1)
    return false;
  if ((tl.pass_rows && tl.groups.d < groups) || tl.outer.d < outers) return false;
  if (tl.threads < 32 || tl.threads > kMaxTileThreads || tl.threads % 32
      || (cols > tl.threads ? tl.pass_rows != 1 : tl.pass_rows * cols > tl.threads))
    return false;
  // keyed_rows (pass_rows 0): the whole row, its groups dealt to one thread
  // or to one thread each, the block's rows times those within its threads
  if (!tl.pass_rows && (tl.col_tiles != 1 || (tl.groups.d != 1 && tl.groups.d != groups)
                        || rows * tl.groups.d > tl.threads || tl.threads > kRowMaxThreads))
    return false;
  return tile_bytes(tl) <= kMaxTileBytes && rows * cols < (1ll << 31);
}

}  // namespace

extern "C" {

int pbrt_torch_keyed_uniforms(uint32_t k0, uint32_t k1, const long long* pixel,
                              const long long* scrambles, int R, uint32_t sample,
                              int max_depth, int code, float c0, float c1, float c2,
                              float c3, float c4, float* out, cudaStream_t stream) {
  const CameraSampler cs{code, {c0, c1, c2, c3, c4}};
  return by_code<LaunchUniforms>(code, k0, k1, pixel, scrambles, R, sample, max_depth, cs, out,
                                 stream);
}

int pbrt_torch_keyed_ao_uniforms(uint32_t k0, uint32_t k1, const long long* pixel,
                                 const long long* scrambles, int R, uint32_t sample,
                                 int n_ao, int code, float c0, float c1, float c2,
                                 float c3, float c4, float* out, cudaStream_t stream) {
  const CameraSampler cs{code, {c0, c1, c2, c3, c4}};
  return by_code<LaunchAoUniforms>(code, k0, k1, pixel, scrambles, R, sample, n_ao, cs, out,
                                   stream);
}

int pbrt_torch_keyed_volume_uniforms(uint32_t k0, uint32_t k1, const long long* pixel,
                                     int R, uint32_t sample, int n_jitter, int single,
                                     const uint32_t* tiling, int tiling_words, float* out,
                                     cudaStream_t stream) {
  Tiling tl;
  if (n_jitter < 0 || tiling_words * 4 != static_cast<int>(sizeof(Tiling)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&tl, tiling, sizeof(Tiling));
  const long long steps = single ? kVolumeSteps : 0;
  const long long width = n_jitter + steps * kPerStep, groups = n_jitter + steps;
  // a tile of c < width columns meets at most c + 1 groups (jitters, then steps of 3)
  const long long met = tl.cols.d < width ? std::min(groups, tl.cols.d + 1ll) : groups;
  if (static_cast<long long>(R) * width >= (1ll << 31)
      || !tiling_ok(tl, width, met, (n_jitter > 0) + (steps > 0))
      || (!tl.pass_rows && (steps || n_jitter > kRowUniforms)))
    return static_cast<int>(cudaErrorInvalidValue);
  const VolumeMap mp{static_cast<uint32_t>(n_jitter)};
  if (R > 0 && tl.pass_rows)
    keyed_volume_uniforms_kernel<<<tile_grid(R, tl), tl.threads, tile_bytes(tl), stream>>>(
        k0, k1, pixel, R, sample, mp, tl, out);
  else if (R > 0)
    keyed_volume_rows_kernel<<<tile_grid(R, tl), tl.threads, 0, stream>>>(k0, k1, pixel, R,
                                                                          sample, mp, tl, out);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_keyed_chain_uniforms(uint32_t k0, uint32_t k1, const long long* index, int R,
                                    uint32_t sample, const uint32_t* map, int map_words,
                                    const uint32_t* tiling, int tiling_words, float* out,
                                    cudaStream_t stream) {
  ChainMap mp;
  Tiling tl;
  if (map_words * 4 != static_cast<int>(sizeof(ChainMap))
      || tiling_words * 4 != static_cast<int>(sizeof(Tiling)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&mp, map, sizeof(ChainMap));
  std::memcpy(&tl, tiling, sizeof(Tiling));
  if (mp.n_outer > kMaxChain - 1 || mp.has_last > 1 || (mp.n_outer && !mp.has_last)
      || !divisor_ok(mp.last) || mp.last.d < 1 || !divisor_ok(mp.n) || !divisor_ok(mp.used)
      || mp.used.d < 1 || mp.drawn < mp.used.d)
    return static_cast<int>(cudaErrorInvalidValue);
  long long groups = mp.last.d;
  for (uint32_t i = 0; i < mp.n_outer; ++i) {
    if (!divisor_ok(mp.count[i]) || mp.count[i].d < 1) return static_cast<int>(cudaErrorInvalidValue);
    groups *= mp.count[i].d;
    if (groups >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = mp.lead + groups * mp.n.d;
  // a tile of c < width columns meets at most (c - 1) / n + 2 groups
  const long long met = mp.n.d == 0 ? 0
                        : tl.cols.d < width ? std::min(groups, (tl.cols.d - 1ll) / mp.n.d + 2)
                                            : groups;
  const long long outers = met ? std::min(groups / mp.last.d, (met - 1) / mp.last.d + 2) : 0;
  if (width >= (1ll << 31) || static_cast<long long>(R) * width >= (1ll << 31)
      || !tiling_ok(tl, width, met, outers)
      || (!tl.pass_rows && (mp.n_outer || mp.n.d < 1 || mp.n.d > kRowCols
                            || groups * mp.n.d > kRowUniforms)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0 && tl.pass_rows)
    keyed_chain_uniforms_kernel<<<tile_grid(R, tl), tl.threads, tile_bytes(tl), stream>>>(
        k0, k1, index, R, sample, mp, tl, out);
  else if (R > 0)
    keyed_chain_rows_kernel<<<tile_grid(R, tl), tl.threads, 0, stream>>>(k0, k1, index, R,
                                                                         sample, mp, tl, out);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_keyed_scrambles(uint32_t k0, uint32_t k1, const long long* pixel,
                               int R, long long* out, cudaStream_t stream) {
  if (R > 0)
    keyed_scrambles_kernel<<<(R - 1) / kThreads + 1, kThreads, 0, stream>>>(
        k0, k1, pixel, R, out);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_keyed_camera_normals(uint32_t k0, uint32_t k1, const long long* pixel,
                                    int R, uint32_t sample, uint32_t tag0, int n_tags,
                                    uint32_t band, uint32_t threads, uint32_t items, uint32_t d,
                                    uint32_t m, uint32_t s, float* out, cudaStream_t stream) {
  const Div tags{d, m, s};
  if (n_tags < 1 || static_cast<long long>(R) * 2 * n_tags >= (1ll << 31) || band < 2
      || band % 2 || band > 2 * kNormalThreads || threads < 32 || threads > kNormalThreads
      || threads % 32 || (items != 1 && items != 2) || !divisor_ok(tags)
      || tags.d != static_cast<uint32_t>(n_tags) || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = R > 0 ? (R - 1) / band + 1 : 0;
  if (R > 0 && items == 2)
    keyed_camera_normals_kernel<2><<<blocks, threads, 8 * band, stream>>>(
        k0, k1, pixel, R, sample, tag0, n_tags, tags, band, out);
  else if (R > 0)
    keyed_camera_normals_kernel<1><<<blocks, threads, 8 * band, stream>>>(
        k0, k1, pixel, R, sample, tag0, n_tags, tags, band, out);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_keyed_camera_normals_rows(uint32_t k0, uint32_t k1, const long long* pixel,
                                         int R, uint32_t sample, uint32_t tag0, int threads,
                                         float* out, cudaStream_t stream) {
  if (R < 0 || static_cast<long long>(R) * kNormalsPerTag >= (1ll << 31) || threads < 32
      || threads > kNormalThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0)
    keyed_camera_normals_rows_kernel<<<(R - 1) / threads + 1, threads, 0, stream>>>(
        k0, k1, pixel, R, sample, tag0, out);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_mlt_mutate(uint32_t a0, uint32_t c0, uint32_t a1, uint32_t c1, uint32_t a2,
                          uint32_t c2, uint32_t a3, uint32_t c3, uint32_t a4, uint32_t c4,
                          const float* u, int N, int D, float p_large, float neg_log_ratio,
                          float s2, const uint32_t* plan, int plan_words, float* out,
                          unsigned char* is_large, float* u_acc, cudaStream_t stream) {
  MutatePlan mp;
  if (N < 0 || D < 1 || static_cast<long long>(N) * D >= (1ll << 31)
      || plan_words * 4 != static_cast<int>(sizeof(MutatePlan)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&mp, plan, sizeof(MutatePlan));
  const uint32_t tail = static_cast<uint32_t>(D) % kWarp;
  if (mp.band < 1 || mp.band > kMaxBand || mp.full != static_cast<uint32_t>(D) / kWarp
      || mp.tail != tail || mp.pack != (tail ? kWarp / tail : 0u) || !divisor_ok(mp.tiles)
      || mp.tiles.d != mp.full || !divisor_ok(mp.tails) || mp.tails.d != tail)
    return static_cast<int>(cudaErrorInvalidValue);
  const MutateKeys ks{{a0, a1, a2, a3, a4}, {c0, c1, c2, c3, c4}};
  if (N > 0)
    mlt_mutate_kernel<<<(N - 1) / mp.band + 1, kMutateThreads, 0, stream>>>(
        ks, u, N, D, mp, p_large, neg_log_ratio, s2, out, is_large, u_acc);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_flat_uniforms(uint32_t k0, uint32_t k1, int total, int per_thread, float* out,
                             cudaStream_t stream) {
  if (total < 0 || (per_thread != 1 && per_thread != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (static_cast<unsigned>(total) + kMutateThreads * per_thread - 1)
                          / (kMutateThreads * per_thread);
  const unsigned n = static_cast<unsigned>(total);
  if (total > 0 && per_thread == 4)
    mlt_flat_uniforms_kernel<4><<<blocks, kMutateThreads, 0, stream>>>(k0, k1, n, out);
  else if (total > 0)
    mlt_flat_uniforms_kernel<1><<<blocks, kMutateThreads, 0, stream>>>(k0, k1, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
