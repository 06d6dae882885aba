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
// stays in the 50 MB L2, so a launch moves 32,768 lanes x 8 rounds x 192 B
// = 50.3 MB of slab columns from L2 to the SMs. One thread per lane reading
// its own row (the first port) splits every 16-byte load of a warp over 32
// unrelated rows, 32 L1 wavefronts per instruction: that request rate, not
// L2, set its time. The row indices depend only on idx (the LCG), never on
// loaded data, so here a warp fetches its 32 rows of a round together:
// chunk c = lane + 32 j (j < 12) of the round's 384 16-byte chunks belongs
// to row c / 12, whose index is shuffled from lane c / 12, so 12 neighbouring
// lanes load one row's 192 contiguous bytes (6 sectors; the 320-byte row
// stride keeps rows sector-aligned). The loads are ld.global.cg (L2 only: a
// row is rarely reused inside an SM) into registers, kAhead rounds ahead of
// the math. A round's chunks go through a warp-private tile in shared memory
// (row stride 52 floats, 13 chunks, odd, so the 8 lanes of a quarter-warp
// read 8 distinct bank groups) from which each lane reads its own row with
// 12 16-byte loads; __syncwarp orders the tile, no block-wide barrier. Lanes
// without a row (idx outside [0, N), or past R in the last warp) stay in the
// warp through every shuffle and load and walk from row 0; only a warp
// wholly past R leaves. The tile is small on purpose (6.5 KiB per warp, 26
// KiB per block, static): the loads in flight are staged in the SM's L1,
// which shares its 256 KB with shared memory, and a ring that takes most of
// it starves them. An asynchronous ring (cp.async or the TMA's bulk copy into
// 4 rounds of shared memory) measured slower at every depth; PERF.md has the
// measured times, the L2 read ceiling (l2_read_kernel below) and the
// variants tried.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 80;    // floats per table row
constexpr int kSlab = 48;   // slab columns read per row
constexpr int kIters = 8;   // gather rounds per lane
constexpr int kChunks = kSlab / 4;  // 16-byte chunks of a row's slab columns
constexpr int kStride = kSlab + 4;  // tile row stride in floats (13 chunks)
constexpr int kAhead = 2;   // rounds loaded into registers ahead of the math
constexpr int kWarps = 4;   // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// One round's loads of the warp's 32 rows: chunk c = lane + 32 j of row
// c / 12 (my_row is this lane's row)
__device__ __forceinline__ void load_round(float4 (&v)[kChunks], const float* __restrict__ tab,
                                           int my_row, int lane) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + 32 * j;
    const int r = c / kChunks, q = c - kChunks * r;
    const int src_row = __shfl_sync(kFull, my_row, r);
    v[j] = __ldcg(reinterpret_cast<const float4*>(tab + static_cast<size_t>(src_row) * kRow) + q);
  }
}

// The same chunks into the warp's tile, row r at r * kStride
__device__ __forceinline__ void store_round(float4* tile, const float4 (&v)[kChunks], int lane) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + 32 * j;
    const int r = c / kChunks, q = c - kChunks * r;
    tile[r * (kStride / 4) + q] = v[j];
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

__global__ void __launch_bounds__(kThreads)
gather_lab_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                  const float* __restrict__ o, const float* __restrict__ inv,
                  float* __restrict__ out, int N, int R) {
  __shared__ float4 tiles[kWarps][32 * kStride / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarps + warp) * 32;
  if (first >= R) return;  // the whole warp: nothing outside it waits on it
  const int i = first + lane;
  const bool live = i < R;
  const int start = live ? idx[i] : 0;
  const bool ok = start >= 0 && start < N;
  int row[kIters];
  row[0] = ok ? start : 0;
#pragma unroll
  for (int it = 1; it < kIters; ++it) row[it] = lcg_next(row[it - 1], N);
  float4 v[kAhead][kChunks];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load_round(v[a], tab, row[a], lane);
  const float ox = live ? o[3 * i] : 0.f, oy = live ? o[3 * i + 1] : 0.f;
  const float oz = live ? o[3 * i + 2] : 0.f;
  const float ix = live ? inv[3 * i] : 0.f, iy = live ? inv[3 * i + 1] : 0.f;
  const float iz = live ? inv[3 * i + 2] : 0.f;
  float4* tile = tiles[warp];
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kIters; ++t) {
    store_round(tile, v[t % kAhead], lane);
    __syncwarp();  // the round is in the tile
    if (t + kAhead < kIters) load_round(v[t % kAhead], tab, row[t + kAhead], lane);
    const float4* mine = tile + lane * (kStride / 4);
    float r[kSlab];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const float4 w = mine[q];
      r[4 * q] = w.x;
      r[4 * q + 1] = w.y;
      r[4 * q + 2] = w.z;
      r[4 * q + 3] = w.w;
    }
    acc = acc + slab_sum(r, ox, oy, oz, ix, iy, iz);
    __syncwarp();  // every lane has read the tile before the next round's stores
  }
  if (live) out[i] = ok ? acc : __int_as_float(0x7fc00000);  // torch's float("nan")
}

// The L2 read ceiling the lab is held against: thread g of G reads the
// 16-byte words (g + k G) mod n16, k < reads, of an L2-resident buffer with
// ld.global.cg (coalesced, L2 only) and writes the xor of all their 32-bit
// words, so no read can be dropped.
__global__ void __launch_bounds__(256)
l2_read_kernel(const uint4* __restrict__ src, int n16, int reads,
               unsigned* __restrict__ out, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int step = G % n16;
  int j = g % n16;
  unsigned x = 0;
#pragma unroll 8
  for (int k = 0; k < reads; ++k) {
    const uint4 v = __ldcg(src + j);
    x ^= v.x ^ v.y ^ v.z ^ v.w;
    j += step;
    if (j >= n16) j -= n16;
  }
  out[g] = x;
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

int pbrt_torch_l2_read(const void* src, int n16, int reads, unsigned* out, int G,
                       cudaStream_t stream) {
  if (n16 <= 0 || reads < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (G > 0)
    l2_read_kernel<<<(G + 255) / 256, 256, 0, stream>>>(static_cast<const uint4*>(src),
                                                        n16, reads, out, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
