// The gather lab on Hopper: 8 rounds of per-lane row gathers from a wide-row
// table plus the 8-slot slab test, summed per lane.
//
// Replaces: scripts/pallas_gather_lab.py:78 pallas_loop_kernel (launched by
// make_pallas_loop, :108), a lab probe that asked whether a VMEM-resident
// BVH table beats XLA's HBM gather on the TPU. Here it measures what per-lane
// row gathers from L2 cost on their own, apart from the traversal's
// dependent walk (csrc/traverse.cu). The plain version is
// pbrt_torch/scripts/gather_lab.py:gather_lab_plain.
//
// Per lane: acc = 0, cur = idx; 8 times: the 48 slab floats of tab[cur]
// (columns 0:48; the TPU kernel copies all 80 into scratch but reads only
// these); per slot k the six plane distances (lo - o) * inv, tn = max of the
// per-axis minima, tf = min of the per-axis maxima, v_k = tn if tn <= tf
// else 0; acc += ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7)), the
// order XLA's CPU backend sums the 8 slots in (the JAX script's xla_step
// and the Pallas body in interpret mode both give exactly these bits);
// then cur = (cur * 1103515245 + 12345) floor-mod N in int32 with
// wraparound. A lane whose idx lies outside [0, N) gets NaN, as in the
// plain version. Built with -fmad=false; the inputs are finite (the lab
// draws inv = 1 / (u + 0.1)), so fminf / fmaxf agree with torch.minimum /
// maximum, and the kernel equals its plain version bit for bit.
//
// What bounds it on this card: the table (16,384 rows x 80 floats, 5 MiB)
// cannot sit in one block's shared memory (227 KB) but stays in the 50 MB
// L2, so each round is 12 scattered 16-byte L2 reads per lane. The design
// uses what sets the lab apart from the traversal: the row indices depend
// only on idx (the LCG), never on loaded data, so a thread computes all 8
// indices first and the source issues each row's float4 loads kDepth rows
// ahead of the math that reads them. In the traversal each row index comes
// out of the previous row's math, so there every step waits a full L2
// round trip. One thread per lane, no shared memory. ptxas schedules the
// loads itself (78 registers, no spills: it does not hold all kDepth rows
// at once); PERF.md has the measured time.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 80;    // floats per table row
constexpr int kSlab = 48;   // slab columns read per row
constexpr int kIters = 8;   // gather rounds per lane
constexpr int kDepth = 4;   // rows in flight per thread
constexpr int kThreads = 128;

__device__ __forceinline__ void load_slab(const float* __restrict__ src,
                                          float* r) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < kSlab / 4; ++q) {
    const float4 v = __ldg(s4 + q);
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ float slab_sum(const float* r, float ox, float oy,
                                          float oz, float ix, float iy,
                                          float iz) {
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t0x = (r[k] - ox) * ix;
    const float t1x = (r[8 + k] - ox) * ix;
    const float t0y = (r[16 + k] - oy) * iy;
    const float t1y = (r[24 + k] - oy) * iy;
    const float t0z = (r[32 + k] - oz) * iz;
    const float t1z = (r[40 + k] - oz) * iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    v[k] = (tn <= tf) ? tn : 0.f;
  }
  return ((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7]));
}

// (cur * 1103515245 + 12345) in int32 with wraparound, then floor-mod n
__device__ __forceinline__ int lcg_next(int cur, int n) {
  const int v = static_cast<int>(static_cast<unsigned>(cur) * 1103515245u + 12345u);
  const int m = v % n;
  return m < 0 ? m + n : m;
}

__global__ void gather_lab_kernel(const float* __restrict__ tab,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ o,
                                  const float* __restrict__ inv,
                                  float* __restrict__ out, int N, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  int row[kIters];
  row[0] = idx[i];
  if (row[0] < 0 || row[0] >= N) {
    out[i] = __int_as_float(0x7fc00000);  // torch's float("nan"), bit for bit
    return;
  }
#pragma unroll
  for (int it = 1; it < kIters; ++it) row[it] = lcg_next(row[it - 1], N);
  float buf[kDepth][kSlab];
#pragma unroll
  for (int it = 0; it < kDepth; ++it)
    load_slab(tab + static_cast<size_t>(row[it]) * kRow, buf[it]);
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float ix = inv[3 * i], iy = inv[3 * i + 1], iz = inv[3 * i + 2];
  float acc = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    acc = acc + slab_sum(buf[it % kDepth], ox, oy, oz, ix, iy, iz);
    if (it + kDepth < kIters)
      load_slab(tab + static_cast<size_t>(row[it + kDepth]) * kRow,
                buf[it % kDepth]);
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

int pbrt_torch_gather_lab(const float* tab, const int* idx, const float* o,
                          const float* inv, float* out, int N, int R,
                          cudaStream_t stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0)
    gather_lab_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        tab, idx, o, inv, out, N, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
