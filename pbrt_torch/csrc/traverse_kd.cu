// kd-tree and uniform-grid traversal on Hopper, a group of G lanes per ray:
// traverse_kd_{closest,any}[_motion]_kernel and
// traverse_grid_{closest,any}[_motion]_kernel.
//
// Replaces: pbrt_tpu/accel/intersect.py:1149 _traverse_kd_one and :1249
// _traverse_grid_one, XLA while_loops vmapped over rays (no Pallas kernel
// stands there), with their leaf loop _leaf_chunk_loop (:1122) and
// _make_test_prim (:437). On the TPU every lane of a batch runs every
// while_loop pass until the last ray ends, masked; here each group of G
// threads walks its own ray to its end.
//
// What each computes, as accel/traverse_kd.py's plain versions do:
//   kd:   clip the ray to the world box; a (node, t0, t1) todo stack of
//         kMaxStack entries; an interior node sends the ray to the near
//         child (below_first, with the o == split && d <= 0 tie) and pushes
//         the far one when the plane splits the segment (the reference's
//         ordered only-first / only-second tests, kdtreeaccel.cpp:419-424);
//         a leaf tests its CSR prims against the running best, keeping the
//         first of the nearest; after a leaf the walk pops, and pops again
//         while the best hit precedes the popped segment's t0.
//   grid: a 3D-DDA from the entry voxel (clipped to dims - 1), next_t and
//         delta_t with 1e30 on axes the ray does not move along, each
//         voxel's CSR prims tested (a prim spanning voxels in each), a step
//         along the first minimum of next_t; it stops on a hit that
//         precedes the voxel's exit, out of the grid, or when the exit lies
//         past the best hit.
//   prims: global ids, [0, T) packed triangles [v0, e1, e2] (lerped
//         row + tw * delta under motion, the product rounded, then added),
//         Moller-Trumbore as the wide leaf step writes it; [T, T + Q)
//         quadrics, the ray moved into object space as
//         ((x m0 + y m1) + z m2) + m3, then the type's roots and clip tests
//         (accel/prims.py:quadric_hits) with atan2f for phi.
//   Any-hit ends after the leaf or voxel of its first hit (the reference's
//   loop condition), so its hit is that leaf's nearest.
// Built with -fmad=false and without fast math, every sum in the plain
// version's order, so the results equal the plain PyTorch versions bit for
// bit. min / max that meet a NaN return it (torch.minimum / maximum do).
//
// Why groups: with one thread per ray, a leaf's or voxel's prims were
// tested one after another, each test 9 scalar loads of a 36-byte row
// while the warp's other lanes read other rows; the grid gives a ray
// ~3,000 triangle tests, the motion kd-tree ~6,000, and a warp lasted as
// long as its longest ray.
//
// This design: a group of G consecutive lanes owns one ray, G a template
// parameter of the walks, kWidth = 32 for every kernel (one ray a warp).
// - The walk is uniform across the group. Every lane holds the ray and
//   computes the same kd interior steps or 3D-DDA steps from the same
//   loads (one broadcast load for the group), so no branch of the walk
//   diverges inside a group.
// - A leaf's or voxel's cnt prims are tested in chunks of G: lane k tests
//   entry c0 + k (coalesced id loads, its own row's 9 floats) against the
//   best hit as it stood at the chunk's start. A ballot finds the lanes
//   that hit; where more than one did, a butterfly of __shfl_xor_sync finds
//   the lexicographic minimum of (t, position); the winner replaces the
//   best where its t is strictly smaller, and its prim, b1 and b2 are
//   broadcast from its lane. That is the plain _leaf_tests rule, the first
//   of the nearest, and it equals the sequential order: tested against a
//   smaller running tmax, a prim either hits at the same t or misses (a
//   triangle's t does not depend on tmax; a quadric whose nearer root
//   fails the smaller tmax has its farther root beyond it too), and it
//   misses exactly where that t lies at or beyond the running best, which
//   an earlier prim of the chunk set. Such a prim loses the reduction to
//   that earlier one, on the t or, at equal t, on the position, as the
//   strict '<' of the sequential loop keeps the earlier.
// - The kd stack lives in shared memory, one kMaxStack-entry (node, t0,
//   t1) stack per group (768 bytes a ray), written by lane 0 between two
//   __syncwarps and read by the whole group (a broadcast).
// - Each lane reads its own prim's row. Staging a chunk's G rows through
//   shared memory (the group loading contiguous floats) was measured and
//   dropped: slower on every set timed (an H100, PERF.md section 6), as a
//   chunk's rows come from L2 either way while staging adds 9 shuffles, 9
//   shared stores and loads and two __syncwarps to each chunk.
// One build exists only to be timed beside these kernels (chip_smoke.py,
// scripts/kd_grid_lab.py): -DPBRT_KD_OTHER_WIDTH, every kernel at G = 8
// (4 rays a warp), slower on every set timed, as a warp of 4 rays waits
// for the longest. pbrt_torch_traverse_kd_info reports each kernel's G,
// registers and blocks per SM.
//
// What bounds it on this card: on the grid and under motion, the
// instruction stream (11-16x the operation bound on an H100): each lane
// of a chunk runs a whole Moller-Trumbore with its IEEE reciprocal, then
// the ballot and, where several lanes hit, the butterfly, and a voxel's
// last chunk leaves lanes idle. The static kd walk (~75x its byte bound)
// has ~10 tests a ray: its time is the longest ray's chain of dependent
// node loads (159 passes against a mean of 16.8 on killeroo's bounce
// rays).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstring>

namespace {

// 4 rays a block; at 48-63 registers a thread (ptxas) 8-10 blocks, 1,024-
// 1,280 threads, fit an SM (pbrt_torch_traverse_kd_info)
constexpr int kThreads = 128;
constexpr int kMaxStack = 64;  // traverse_kd.MAX_STACK
constexpr int kLeaf = 3;       // kdtree.KD_LEAF
constexpr int kRowFloats = 9;  // a packed triangle [v0, e1, e2]

#ifdef PBRT_KD_OTHER_WIDTH
constexpr bool kOtherWidth = true;
#else
constexpr bool kOtherWidth = false;
#endif
// lanes per ray, one warp: measured faster than 8 for every kernel, the
// static kd walk too (~10 triangle tests a ray), where a warp of 4 rays
// waits for the longest of them
constexpr int kWidth = kOtherWidth ? 8 : 32;

__device__ __forceinline__ float vmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float vmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// torch.clamp(x, min=m) as ATen's CUDA kernel writes it: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float m) {
  return isnan(x) ? x : fmaxf(x, m);
}

struct Prims {
  const float* tri;         // (T, 9) packed [v0, e1, e2]
  const float* tri_motion;  // (T, 9) shutter-end deltas, null when static
  int T;
  const int* qtype;   // (Q,)
  const float* w2o;   // (Q, 4, 4)
  const float* qprm;  // (Q, 8)
  int Q;
};

struct Rays {
  const float *o, *d, *inv, *tmin, *tmax, *tw;
};

struct Hits {
  float* t;
  int* prim;
  float* b1;
  float* b2;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax, tw;
};

struct Best {
  float t, b1, b2;
  int prim;
};

__device__ __forceinline__ Ray load_ray(const Rays& y, int i, bool motion) {
  Ray r;
  r.ox = y.o[3 * i];
  r.oy = y.o[3 * i + 1];
  r.oz = y.o[3 * i + 2];
  r.dx = y.d[3 * i];
  r.dy = y.d[3 * i + 1];
  r.dz = y.d[3 * i + 2];
  r.ix = y.inv[3 * i];
  r.iy = y.inv[3 * i + 1];
  r.iz = y.inv[3 * i + 2];
  r.tmin = y.tmin[i];
  r.tmax = y.tmax[i];
  r.tw = motion ? y.tw[i] : 0.0f;
  return r;
}

// atan2 mapped to [0, 2pi) (core/geometry.phi_of); 2pi as its float32
__device__ __forceinline__ float phi_of(float x, float y) {
  const float p = atan2f(y, x);
  return p < 0.0f ? p + 6.28318530717958647692f : p;
}

// Moller-Trumbore against a packed row (prims.tri_test)
__device__ __forceinline__ bool tri_test(const float* row, const Ray& r,
                                         float tmax, float& t, float& b1,
                                         float& b2) {
  const float v0x = row[0], v0y = row[1], v0z = row[2];
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool small = fabsf(det) < 1e-12f;
  const float inv_det = small ? 0.0f : 1.0f / det;
  const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  b2 = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return !small && b1 >= 0.0f && b2 >= 0.0f && b1 + b2 <= 1.0f &&
         t > r.tmin && t < tmax;
}

// The stable quadratic (prims._quadratic): ok, t0 <= t1
__device__ __forceinline__ bool quadratic(float a, float b, float c,
                                          float& t0, float& t1) {
  const float disc = b * b - 4.0f * a * c;
  const float root = sqrtf(clamp_min(disc, 0.0f));
  const float q = b < 0.0f ? -0.5f * (b - root) : -0.5f * (b + root);
  const float ta = q / (fabsf(a) < 1e-20f ? 1e-20f : a);
  const float tb = c / (fabsf(q) < 1e-20f ? 1e-20f : q);
  t0 = vmin(ta, tb);
  t1 = vmax(ta, tb);
  return disc >= 0.0f;
}

struct Obj {
  float ox, oy, oz, dx, dy, dz;
};

// the z range and phi clip of a root t
__device__ __forceinline__ bool z_phi_in(const Obj& s, float t, float lo,
                                         float hi, float phimax) {
  const float px = s.ox + t * s.dx, py = s.oy + t * s.dy, pz = s.oz + t * s.dz;
  return pz >= lo && pz <= hi && phi_of(px, py) <= phimax + 1e-6f;
}

// the nearer root in (tmin, tmax) that passes the clip; t = inf on a miss
__device__ __forceinline__ bool roots(float a, float b, float c, const Obj& s,
                                      float tmin, float tmax, float lo,
                                      float hi, float phimax, float& t) {
  float t0, t1;
  const bool ok = quadratic(a, b, c, t0, t1);
  const bool v0 = ok && t0 > tmin && t0 < tmax && z_phi_in(s, t0, lo, hi, phimax);
  const bool v1 = ok && t1 > tmin && t1 < tmax && z_phi_in(s, t1, lo, hi, phimax);
  t = v0 ? t0 : (v1 ? t1 : CUDART_INF_F);
  return v0 || v1;
}

// one quadric (prims.quadric_hits for one element)
__device__ bool quad_test(const Prims& P, int q, const Ray& r, float tmax,
                          float& t, float& u, float& v) {
  const float* m = P.w2o + 16 * q;
  const float* prm = P.qprm + 8 * q;
  Obj s;
  s.ox = r.ox * __ldg(m + 0) + r.oy * __ldg(m + 1) + r.oz * __ldg(m + 2) + __ldg(m + 3);
  s.oy = r.ox * __ldg(m + 4) + r.oy * __ldg(m + 5) + r.oz * __ldg(m + 6) + __ldg(m + 7);
  s.oz = r.ox * __ldg(m + 8) + r.oy * __ldg(m + 9) + r.oz * __ldg(m + 10) + __ldg(m + 11);
  s.dx = r.dx * __ldg(m + 0) + r.dy * __ldg(m + 1) + r.dz * __ldg(m + 2);
  s.dy = r.dx * __ldg(m + 4) + r.dy * __ldg(m + 5) + r.dz * __ldg(m + 6);
  s.dz = r.dx * __ldg(m + 8) + r.dy * __ldg(m + 9) + r.dz * __ldg(m + 10);
  const float radius = __ldg(prm + 0), zmin = __ldg(prm + 1), zmax = __ldg(prm + 2);
  const float phimax = __ldg(prm + 3), height = __ldg(prm + 4), inner = __ldg(prm + 5);
  const float ah = __ldg(prm + 6), ch = __ldg(prm + 7);
  const float ox = s.ox, oy = s.oy, oz = s.oz, dx = s.dx, dy = s.dy, dz = s.dz;
  const float tmin = r.tmin;
  bool hit = false;
  switch (__ldg(P.qtype + q)) {
    case 0: {  // sphere
      const float a = dx * dx + dy * dy + dz * dz;
      const float b = 2.0f * (dx * ox + dy * oy + dz * oz);
      const float c = ox * ox + oy * oy + oz * oz - radius * radius;
      hit = roots(a, b, c, s, tmin, tmax, zmin - 1e-5f, zmax + 1e-5f, phimax, t);
      break;
    }
    case 1: {  // cylinder
      const float a = dx * dx + dy * dy;
      const float b = 2.0f * (dx * ox + dy * oy);
      const float c = ox * ox + oy * oy - radius * radius;
      hit = roots(a, b, c, s, tmin, tmax, zmin, zmax, phimax, t);
      break;
    }
    case 2: {  // disk
      const float td = fabsf(dz) < 1e-9f ? CUDART_INF_F : (height - oz) / dz;
      const float px = ox + td * dx, py = oy + td * dy;
      const float r2 = px * px + py * py;
      hit = td > tmin && td < tmax && isfinite(td) && r2 <= radius * radius &&
            r2 >= inner * inner && phi_of(px, py) <= phimax + 1e-6f;
      t = hit ? td : CUDART_INF_F;
      break;
    }
    case 3: {  // cone: apex at z = height, base radius at z = 0
      const float kr = radius / height;
      const float k = kr * kr;
      const float a = dx * dx + dy * dy - k * dz * dz;
      const float b = 2.0f * (dx * ox + dy * oy - k * dz * (oz - height));
      const float c = ox * ox + oy * oy - k * (oz - height) * (oz - height);
      hit = roots(a, b, c, s, tmin, tmax, 0.0f, height, phimax, t);
      break;
    }
    case 4: {  // paraboloid: z = height (x^2 + y^2) / radius^2
      const float k = height / (radius * radius);
      const float a = k * (dx * dx + dy * dy);
      const float b = 2.0f * k * (dx * ox + dy * oy) - dz;
      const float c = k * (ox * ox + oy * oy) - oz;
      hit = roots(a, b, c, s, tmin, tmax, zmin, zmax, phimax, t);
      break;
    }
    default: {  // hyperboloid: ah (x^2 + y^2) - ch z^2 = 1
      const float a = ah * (dx * dx + dy * dy) - ch * dz * dz;
      const float b = 2.0f * (ah * (dx * ox + dy * oy) - ch * dz * oz);
      const float c = ah * (ox * ox + oy * oy) - ch * oz * oz - 1.0f;
      hit = roots(a, b, c, s, tmin, tmax, zmin, zmax, phimax, t);
      break;
    }
  }
  if (hit) {
    const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
    u = phi_of(px, py) / clamp_min(phimax, 1e-9f);
    v = (pz - zmin) / clamp_min(zmax - zmin, 1e-9f);
  }
  return hit;
}

// This thread's place in its group of G: lane k, the group's slot in the
// block, and the group's lanes in the warp (the mask of its shuffles).
template <int G>
struct Lane {
  int k, slot;
  unsigned base, mask;
  __device__ __forceinline__ Lane()
      : k(threadIdx.x & (G - 1)),
        slot(threadIdx.x / G),
        base(threadIdx.x & 31 & ~(G - 1)) {
    if constexpr (G == 32) {
      mask = 0xffffffffu;
    } else {
      mask = ((1u << G) - 1u) << base;
    }
  }
  // the group's bits of a warp-wide ballot, lane k's at bit k
  __device__ __forceinline__ unsigned bits(unsigned ballot) const {
    return (ballot & mask) >> base;
  }
};

// A leaf's (or voxel's) cnt prims from ids[off] on, in chunks of G: lane k
// tests entry c0 + k against the best as it stood at the chunk's start, and
// the chunk's first nearest hit replaces the best where it is strictly
// nearer (the header's argument: the same hit as testing the prims in
// order). Every lane of the group returns the same best.
template <int G, bool kMotion>
__device__ __forceinline__ void test_leaf(const Prims& P, const int* ids,
                                          int off, int cnt, const Ray& r,
                                          Best& best, const Lane<G>& L) {
  for (int c0 = 0; c0 < cnt; c0 += G) {
    const int c = c0 + L.k;
    const int p = c < cnt ? __ldg(ids + off + c) : -1;
    const bool tri = p >= 0 && p < P.T;
    float t = 0.0f, u = 0.0f, v = 0.0f;
    bool hit = false;
    if (tri) {
      // this lane's own row (and its shutter-end delta under motion)
      float row[kRowFloats];
      const float* src = P.tri + kRowFloats * p;
#pragma unroll
      for (int e = 0; e < kRowFloats; ++e) row[e] = __ldg(src + e);
      if (kMotion) {
        const float* dm = P.tri_motion + kRowFloats * p;
#pragma unroll
        for (int e = 0; e < kRowFloats; ++e) row[e] = row[e] + r.tw * __ldg(dm + e);
      }
      hit = tri_test(row, r, best.t, t, u, v);
    } else if (p >= 0) {
      hit = quad_test(P, p - P.T, r, best.t, t, u, v);
    }
    const unsigned hits = L.bits(__ballot_sync(L.mask, hit));
    if (hits == 0u) continue;
    // the winner: the one lane that hit, or the (t, position) minimum
    int w = __ffs(static_cast<int>(hits)) - 1;
    float tw = __shfl_sync(L.mask, t, w, G);
    if (hits & (hits - 1u)) {
      tw = hit ? t : CUDART_INF_F;
      w = hit ? L.k : G;
#pragma unroll
      for (int m = G / 2; m > 0; m >>= 1) {
        const float to = __shfl_xor_sync(L.mask, tw, m, G);
        const int wo = __shfl_xor_sync(L.mask, w, m, G);
        if (to < tw || (to == tw && wo < w)) {
          tw = to;
          w = wo;
        }
      }
    }
    if (tw < best.t) {
      best.t = tw;
      best.prim = __shfl_sync(L.mask, p, w, G);
      best.b1 = __shfl_sync(L.mask, u, w, G);
      best.b2 = __shfl_sync(L.mask, v, w, G);
    }
  }
}

// the world box's entry and exit along the ray (no tmin / tmax)
__device__ __forceinline__ void world_box(const float* lo, const float* hi,
                                          const Ray& r, float& enter,
                                          float& exit_) {
  const float t0x = (__ldg(lo + 0) - r.ox) * r.ix, t1x = (__ldg(hi + 0) - r.ox) * r.ix;
  const float t0y = (__ldg(lo + 1) - r.oy) * r.iy, t1y = (__ldg(hi + 1) - r.oy) * r.iy;
  const float t0z = (__ldg(lo + 2) - r.oz) * r.iz, t1z = (__ldg(hi + 2) - r.oz) * r.iz;
  enter = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmin(t0z, t1z));
  exit_ = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmax(t0z, t1z));
}

struct Kd {
  const float* split;
  const int *axis, *above, *off, *cnt, *ids;
  const float *lo, *hi;
};

template <int G, bool kAny, bool kMotion>
__device__ __forceinline__ void kd_walk(const Kd& K, const Prims& P,
                                        const Rays& Y, const Hits& H, int R) {
  constexpr int kRays = kThreads / G;
  __shared__ int st_n[kRays][kMaxStack + 1];
  __shared__ float st_t0[kRays][kMaxStack + 1];
  __shared__ float st_t1[kRays][kMaxStack + 1];
  const Lane<G> L;
  const int i = blockIdx.x * kRays + L.slot;
  if (i >= R) return;  // the whole group
  int* const sn = st_n[L.slot];
  float* const s0 = st_t0[L.slot];
  float* const s1 = st_t1[L.slot];
  const Ray r = load_ray(Y, i, kMotion);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  float enter, exit_;
  world_box(K.lo, K.hi, r, enter, exit_);
  bool alive = vmax(enter, r.tmin) <= vmin(exit_, r.tmax);
  float t0n = vmax(r.tmin, enter), t1n = vmin(r.tmax, exit_);
  int node = 0, sp = 0;
  while (alive && (!kAny || best.prim < 0)) {
    const bool pop_mode = node < 0;
    const int nc = pop_mode ? 0 : node;
    const int axis = __ldg(K.axis + nc);
    const bool is_leaf = !pop_mode && axis == kLeaf;
    if (is_leaf)
      test_leaf<G, kMotion>(P, K.ids, __ldg(K.off + nc), __ldg(K.cnt + nc), r,
                            best, L);
    if (!pop_mode && !is_leaf) {
      // interior: the near child next, the far one pushed
      const float oa = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
      const float da = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
      const float ia = axis == 0 ? r.ix : (axis == 1 ? r.iy : r.iz);
      const float split = __ldg(K.split + nc);
      const float tplane = (split - oa) * ia;
      const bool below_first = oa < split || (oa == split && da <= 0.0f);
      const int above = __ldg(K.above + nc);
      const int first = below_first ? nc + 1 : above;
      const int second = below_first ? above : nc + 1;
      const bool only_first = tplane > t1n || tplane <= 0.0f;
      const bool only_second = tplane < t0n && !only_first;
      if (!only_first && !only_second) {
        if (sp < kMaxStack) {
          __syncwarp(L.mask);  // every lane has popped the entry it replaces
          if (L.k == 0) {
            sn[sp] = second;
            s0[sp] = tplane;
            s1[sp] = t1n;
          }
          __syncwarp(L.mask);  // the entry is seen by the group's pops
        }
        ++sp;
        t1n = tplane;
      }
      node = only_second ? second : first;
    } else if (sp > 0) {
      // pop, after a leaf or again while the best hit precedes the popped
      // segment (a pop that reads past the stack reads its last entry)
      --sp;
      const int rd = sp < kMaxStack ? sp : kMaxStack - 1;
      t0n = s0[rd];
      t1n = s1[rd];
      node = best.t < t0n ? -1 : sn[rd];
    } else {
      alive = false;
    }
  }
  if (L.k == 0) {
    H.t[i] = best.t;
    H.prim[i] = best.prim;
    H.b1[i] = best.b1;
    H.b2[i] = best.b2;
  }
}

struct Grid {
  const int *off, *cnt, *ids;
  const float *lo, *hi, *width;
  int nx, ny, nz;
};

template <int G, bool kAny, bool kMotion>
__device__ __forceinline__ void grid_walk(const Grid& Gr, const Prims& P,
                                          const Rays& Y, const Hits& H, int R) {
  constexpr int kRays = kThreads / G;
  const Lane<G> L;
  const int i = blockIdx.x * kRays + L.slot;
  if (i >= R) return;  // the whole group
  const Ray r = load_ray(Y, i, kMotion);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  float enter, exit_;
  const float lo[3] = {__ldg(Gr.lo + 0), __ldg(Gr.lo + 1), __ldg(Gr.lo + 2)};
  const float w[3] = {__ldg(Gr.width + 0), __ldg(Gr.width + 1), __ldg(Gr.width + 2)};
  world_box(Gr.lo, Gr.hi, r, enter, exit_);
  const float t_enter = vmax(enter, r.tmin);
  bool alive = enter <= exit_ && exit_ >= r.tmin && t_enter <= r.tmax;
  const int dims[3] = {Gr.nx, Gr.ny, Gr.nz};
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  const float inv[3] = {r.ix, r.iy, r.iz};
  int vox[3], step[3];
  float next_t[3], delta_t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p_in = o[a] + t_enter * d[a];
    // the entry cell, truncated toward zero and clamped into the grid
    const float cell = vmax(vmin((p_in - lo[a]) / w[a], static_cast<float>(dims[a])), -1.0f);
    const int c = static_cast<int>(cell);
    vox[a] = min(max(c, 0), dims[a] - 1);
    step[a] = d[a] >= 0.0f ? 1 : -1;
    const float next_edge = lo[a] + static_cast<float>(vox[a] + (step[a] > 0)) * w[a];
    next_t[a] = d[a] != 0.0f ? (next_edge - o[a]) * inv[a] : 1e30f;
    delta_t[a] = d[a] != 0.0f ? w[a] * fabsf(inv[a]) : 1e30f;
  }
  const int V = Gr.nx * Gr.ny * Gr.nz;
  while (alive && (!kAny || best.prim < 0)) {
    const int vid = min(max(vox[2] + Gr.nz * (vox[1] + Gr.ny * vox[0]), 0), V - 1);
    test_leaf<G, kMotion>(P, Gr.ids, __ldg(Gr.off + vid), __ldg(Gr.cnt + vid), r,
                          best, L);
    int ax = 0;
    if (next_t[1] < next_t[ax]) ax = 1;
    if (next_t[2] < next_t[ax]) ax = 2;
    const float t_exit = next_t[ax];
    const bool done_hit = best.prim >= 0 && best.t <= t_exit;
    vox[ax] += step[ax];
    const bool out = vox[ax] < 0 || vox[ax] >= dims[ax];
    next_t[ax] = t_exit + delta_t[ax];
    alive = !done_hit && !out && t_exit <= best.t;
  }
  if (L.k == 0) {
    H.t[i] = best.t;
    H.prim[i] = best.prim;
    H.b1[i] = best.b1;
    H.b2[i] = best.b2;
  }
}

// Named kernels (not one template) so a profile tells them apart.
#define PBRT_KD_KERNEL(NAME, ANY, MOTION)                                    \
  __global__ void __launch_bounds__(kThreads)                               \
      NAME(Kd K, Prims P, Rays Y, Hits H, int R) {                          \
    kd_walk<kWidth, ANY, MOTION>(K, P, Y, H, R);                            \
  }
#define PBRT_GRID_KERNEL(NAME, ANY, MOTION)                                  \
  __global__ void __launch_bounds__(kThreads)                               \
      NAME(Grid Gr, Prims P, Rays Y, Hits H, int R) {                       \
    grid_walk<kWidth, ANY, MOTION>(Gr, P, Y, H, R);                         \
  }

PBRT_KD_KERNEL(traverse_kd_closest_kernel, false, false)
PBRT_KD_KERNEL(traverse_kd_any_kernel, true, false)
PBRT_KD_KERNEL(traverse_kd_closest_motion_kernel, false, true)
PBRT_KD_KERNEL(traverse_kd_any_motion_kernel, true, true)
PBRT_GRID_KERNEL(traverse_grid_closest_kernel, false, false)
PBRT_GRID_KERNEL(traverse_grid_any_kernel, true, false)
PBRT_GRID_KERNEL(traverse_grid_closest_motion_kernel, false, true)
PBRT_GRID_KERNEL(traverse_grid_any_motion_kernel, true, true)

#undef PBRT_KD_KERNEL
#undef PBRT_GRID_KERNEL

// blocks for R rays at kWidth lanes each
inline int blocks_for(int R) {
  constexpr int rays = kThreads / kWidth;
  return (R + rays - 1) / rays;
}

struct KernelInfo {
  const char* name;
  const void* fn;
};

const KernelInfo kKernels[] = {
#define PBRT_INFO(KEY) {#KEY, reinterpret_cast<const void*>(KEY##_kernel)}
    PBRT_INFO(traverse_kd_closest),   PBRT_INFO(traverse_kd_any),
    PBRT_INFO(traverse_kd_closest_motion), PBRT_INFO(traverse_kd_any_motion),
    PBRT_INFO(traverse_grid_closest), PBRT_INFO(traverse_grid_any),
    PBRT_INFO(traverse_grid_closest_motion), PBRT_INFO(traverse_grid_any_motion),
#undef PBRT_INFO
};

}  // namespace

extern "C" {

// Each entry packs its tables and launches on the caller's stream; it
// returns cudaGetLastError(). The static entries get a null tri_motion and
// tw, which their kernels never read.
#define PBRT_PRIMS_RAYS_PARAMS                                                 \
  const float *tri, const float *tri_motion, int T, const int *qtype,         \
      const float *w2o, const float *qprm, int Q, const float *o,             \
      const float *d, const float *inv, const float *tmin,                    \
      const float *tmax, const float *tw, float *t, int *prim, float *b1,     \
      float *b2, int R, cudaStream_t stream
#define PBRT_PACK                                                              \
  const Prims P{tri, tri_motion, T, qtype, w2o, qprm, Q};                     \
  const Rays Y{o, d, inv, tmin, tmax, tw};                                    \
  const Hits H{t, prim, b1, b2};

#define PBRT_KD_ENTRY(NAME, KERNEL)                                            \
  int NAME(const float* split, const int* axis, const int* above,             \
           const int* off, const int* cnt, const int* ids, const float* lo,   \
           const float* hi, PBRT_PRIMS_RAYS_PARAMS) {                         \
    const Kd K{split, axis, above, off, cnt, ids, lo, hi};                    \
    PBRT_PACK                                                                 \
    if (R > 0) KERNEL<<<blocks_for(R), kThreads, 0, stream>>>(K, P, Y, H, R);   \
    return static_cast<int>(cudaGetLastError());                              \
  }
#define PBRT_GRID_ENTRY(NAME, KERNEL)                                          \
  int NAME(const int* off, const int* cnt, const int* ids, const float* lo,   \
           const float* hi, const float* width, int nx, int ny, int nz,       \
           PBRT_PRIMS_RAYS_PARAMS) {                                          \
    const Grid Gr{off, cnt, ids, lo, hi, width, nx, ny, nz};                  \
    PBRT_PACK                                                                 \
    if (R > 0) KERNEL<<<blocks_for(R), kThreads, 0, stream>>>(Gr, P, Y, H, R);  \
    return static_cast<int>(cudaGetLastError());                              \
  }

PBRT_KD_ENTRY(pbrt_torch_traverse_kd_closest, traverse_kd_closest_kernel)
PBRT_KD_ENTRY(pbrt_torch_traverse_kd_any, traverse_kd_any_kernel)
PBRT_KD_ENTRY(pbrt_torch_traverse_kd_closest_motion,
              traverse_kd_closest_motion_kernel)
PBRT_KD_ENTRY(pbrt_torch_traverse_kd_any_motion, traverse_kd_any_motion_kernel)
PBRT_GRID_ENTRY(pbrt_torch_traverse_grid_closest, traverse_grid_closest_kernel)
PBRT_GRID_ENTRY(pbrt_torch_traverse_grid_any, traverse_grid_any_kernel)
PBRT_GRID_ENTRY(pbrt_torch_traverse_grid_closest_motion,
                traverse_grid_closest_motion_kernel)
PBRT_GRID_ENTRY(pbrt_torch_traverse_grid_any_motion,
                traverse_grid_any_motion_kernel)

#undef PBRT_KD_ENTRY
#undef PBRT_GRID_ENTRY
#undef PBRT_PACK
#undef PBRT_PRIMS_RAYS_PARAMS

// The kernel `name` (a key of traverse_kd.KERNEL_NAMES) as built: out[0] G,
// out[1] registers per thread, out[2] local bytes per thread, out[3]
// static shared bytes per block, out[4] blocks per SM at kThreads
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] kThreads. Returns a CUDA error code (cudaErrorInvalidValue for an
// unknown name).
int pbrt_torch_traverse_kd_info(const char* name, int* out) {
  for (const KernelInfo& e : kKernels) {
    if (std::strcmp(e.name, name) != 0) continue;
    cudaFuncAttributes a;
    cudaError_t rc = cudaFuncGetAttributes(&a, e.fn);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    int blocks = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    out[0] = kWidth;
    out[1] = a.numRegs;
    out[2] = static_cast<int>(a.localSizeBytes);
    out[3] = static_cast<int>(a.sharedSizeBytes);
    out[4] = blocks;
    out[5] = kThreads;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
