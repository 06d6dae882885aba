// Keyed uniforms on Hopper: threefry-2x32 keys from (pixel, sample, purpose)
// and the render's two arrays of keyed numbers, bit-exact to jax.random.
//
// Replaces: no Pallas kernel. XLA computes threefry for the JAX package,
// in BatchedKeySource (pbrt_tpu/integrators/path.py:115-120: one key per
// path, 8 uniforms per bounce) and in the lowdiscrepancy sampler's
// scrambles (pbrt_tpu/renderers/sampler.py:43-44, :122-127). The port's
// plain version is pbrt_torch/core/rng.py; its docstring gives the jax
// semantics each step follows (fold_in = threefry(key, (0, data)); bits[i]
// = y0 ^ y1 of threefry(key, (0, i)); uniform = ((bits >> 9) | 0x3F800000)
// as float, minus 1).
//
// Two entry points:
//   keyed_uniforms  — one thread per (lane, bounce): three fold_ins give the
//                     path's batched key (pixel, sample, tag 15), then 7 of
//                     the bounce's 8 counters (the 8th, "spare", is never
//                     read) give 7 floats of the (R, 7*D) bounce block;
//   keyed_scrambles — one thread per lane: sample 0's key, tag 0 (CAMERA),
//                     6 words written as int64 (the port's uint32 holder).
//
// What bounds it on this card: integer operations, at least 71 per threefry
// hash (20 add/rotate/xor rounds, 11 key-injection adds), 10 hashes per
// thread; the bytes (8 in, 28 out per thread) are few. Rotations are one
// funnel shift each. Nothing is staged: each thread recomputes its path's
// key (3 of its 10 hashes), which costs less than a second pass through
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDrawn = 8;     // uniforms drawn per bounce (BatchedKeySource)
constexpr int kUsed = 7;      // the ones the path integrator reads
constexpr int kScrambles = 6;
constexpr uint32_t kBatchedTag = 15u;  // bounce 0 * 16 + reserved purpose 15
constexpr uint32_t kCameraTag = 0u;    // bounce 0 * 16 + CAMERA

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

__global__ void keyed_uniforms_kernel(uint32_t k0, uint32_t k1,
                                      const long long* __restrict__ pixel,
                                      int R, uint32_t sample, int D,
                                      float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(R) * D) return;
  const int i = static_cast<int>(t / D);
  const int b = static_cast<int>(t % D);
  uint32_t a = k0, c = k1;
  fold_in(a, c, static_cast<uint32_t>(pixel[i]));
  fold_in(a, c, sample);
  fold_in(a, c, kBatchedTag);
  float* dst = out + static_cast<size_t>(i) * (kUsed * D) + b * kUsed;
#pragma unroll
  for (int j = 0; j < kUsed; ++j) {
    const uint32_t r = bits_at(a, c, static_cast<uint32_t>(b * kDrawn + j));
    dst[j] = __uint_as_float((r >> 9) | 0x3F800000u) - 1.0f;
  }
}

__global__ void keyed_scrambles_kernel(uint32_t k0, uint32_t k1,
                                       const long long* __restrict__ pixel,
                                       int R, long long* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  uint32_t a = k0, c = k1;
  fold_in(a, c, static_cast<uint32_t>(pixel[i]));
  fold_in(a, c, 0u);  // sample 0: scrambles are per pixel
  fold_in(a, c, kCameraTag);
#pragma unroll
  for (int j = 0; j < kScrambles; ++j)
    out[static_cast<size_t>(i) * kScrambles + j] =
        static_cast<long long>(bits_at(a, c, static_cast<uint32_t>(j)));
}

}  // namespace

extern "C" {

int pbrt_torch_keyed_uniforms(uint32_t k0, uint32_t k1, const long long* pixel,
                              int R, uint32_t sample, int max_depth,
                              float* out, cudaStream_t stream) {
  const long long n = static_cast<long long>(R) * max_depth;
  if (n > 0)
    keyed_uniforms_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(k0, k1, pixel, R, sample,
                                                   max_depth, out);
  return static_cast<int>(cudaGetLastError());
}

int pbrt_torch_keyed_scrambles(uint32_t k0, uint32_t k1, const long long* pixel,
                               int R, long long* out, cudaStream_t stream) {
  if (R > 0)
    keyed_scrambles_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(k0, k1, pixel, R, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
