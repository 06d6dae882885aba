// kd-tree and uniform-grid traversal on Hopper, one thread per ray:
// traverse_kd_{closest,any}[_motion]_kernel and
// traverse_grid_{closest,any}[_motion]_kernel.
//
// Replaces: pbrt_tpu/accel/intersect.py:1149 _traverse_kd_one and :1249
// _traverse_grid_one, XLA while_loops vmapped over rays (no Pallas kernel
// stands there), with their leaf loop _leaf_chunk_loop (:1122) and
// _make_test_prim (:437). On the TPU every lane of a batch runs every
// while_loop pass until the last ray ends, masked; here each thread walks
// its own ray to its end.
//
// What each computes, as accel/traverse_kd.py's plain versions do:
//   kd:   clip the ray to the world box; a (node, t0, t1) todo stack of
//         kMaxStack entries; an interior node sends the ray to the near
//         child (below_first, with the o == split && d <= 0 tie) and pushes
//         the far one when the plane splits the segment (the reference's
//         ordered only-first / only-second tests, kdtreeaccel.cpp:419-424);
//         a leaf tests its CSR prims in order against the running best;
//         after a leaf the walk pops, and pops again while the best hit
//         precedes the popped segment's t0.
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
// What bounds it on this card: not bytes and not operations but each ray's
// dependent chain: a node's row index comes out of the previous node's
// plane test, a leaf's prims are tested one after another, and a warp
// lasts as long as its longest ray (the DDA of a grazing ray crosses up to
// 3 x 64 voxels, testing a spanning prim again in each). This first kernel
// is the simple one the port needs to be right: the stack is per thread in
// local memory (64 x 12 bytes, L1-resident), the tables are read through
// the read-only path. Making it fast (rays grouped per warp, a mailbox,
// shared-memory stacks) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;  // traverse_kd.MAX_STACK
constexpr int kLeaf = 3;       // kdtree.KD_LEAF

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

// A leaf's (or voxel's) cnt prims from ids[off] on, in order, each against
// the running best (_leaf_chunk_loop).
template <bool kMotion>
__device__ __forceinline__ void test_leaf(const Prims& P, const int* ids,
                                          int off, int cnt, const Ray& r,
                                          Best& best) {
  for (int c = 0; c < cnt; ++c) {
    const int p = __ldg(ids + off + c);
    float t = 0.0f, u = 0.0f, v = 0.0f;
    bool hit;
    if (p < P.T) {
      float row[9];
      const float* src = P.tri + 9 * p;
#pragma unroll
      for (int k = 0; k < 9; ++k) row[k] = __ldg(src + k);
      if (kMotion) {
        const float* dm = P.tri_motion + 9 * p;
#pragma unroll
        for (int k = 0; k < 9; ++k) row[k] = row[k] + r.tw * __ldg(dm + k);
      }
      hit = tri_test(row, r, best.t, t, u, v);
    } else {
      hit = quad_test(P, p - P.T, r, best.t, t, u, v);
    }
    if (hit && t < best.t) {
      best.t = t;
      best.prim = p;
      best.b1 = u;
      best.b2 = v;
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

template <bool kAny, bool kMotion>
__device__ __forceinline__ void kd_walk(const Kd& K, const Prims& P,
                                        const Rays& Y, const Hits& H, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(Y, i, kMotion);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  float enter, exit_;
  world_box(K.lo, K.hi, r, enter, exit_);
  bool alive = vmax(enter, r.tmin) <= vmin(exit_, r.tmax);
  float t0n = vmax(r.tmin, enter), t1n = vmin(r.tmax, exit_);
  int node = 0, sp = 0;
  int st_n[kMaxStack];
  float st_t0[kMaxStack], st_t1[kMaxStack];
  while (alive && (!kAny || best.prim < 0)) {
    const bool pop_mode = node < 0;
    const int nc = pop_mode ? 0 : node;
    const int axis = __ldg(K.axis + nc);
    const bool is_leaf = !pop_mode && axis == kLeaf;
    if (is_leaf)
      test_leaf<kMotion>(P, K.ids, __ldg(K.off + nc), __ldg(K.cnt + nc), r, best);
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
          st_n[sp] = second;
          st_t0[sp] = tplane;
          st_t1[sp] = t1n;
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
      t0n = st_t0[rd];
      t1n = st_t1[rd];
      node = best.t < t0n ? -1 : st_n[rd];
    } else {
      alive = false;
    }
  }
  H.t[i] = best.t;
  H.prim[i] = best.prim;
  H.b1[i] = best.b1;
  H.b2[i] = best.b2;
}

struct Grid {
  const int *off, *cnt, *ids;
  const float *lo, *hi, *width;
  int nx, ny, nz;
};

template <bool kAny, bool kMotion>
__device__ __forceinline__ void grid_walk(const Grid& G, const Prims& P,
                                          const Rays& Y, const Hits& H, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(Y, i, kMotion);
  Best best{r.tmax, 0.0f, 0.0f, -1};
  float enter, exit_;
  const float lo[3] = {__ldg(G.lo + 0), __ldg(G.lo + 1), __ldg(G.lo + 2)};
  const float w[3] = {__ldg(G.width + 0), __ldg(G.width + 1), __ldg(G.width + 2)};
  world_box(G.lo, G.hi, r, enter, exit_);
  const float t_enter = vmax(enter, r.tmin);
  bool alive = enter <= exit_ && exit_ >= r.tmin && t_enter <= r.tmax;
  const int dims[3] = {G.nx, G.ny, G.nz};
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
  const int V = G.nx * G.ny * G.nz;
  while (alive && (!kAny || best.prim < 0)) {
    const int vid = min(max(vox[2] + G.nz * (vox[1] + G.ny * vox[0]), 0), V - 1);
    test_leaf<kMotion>(P, G.ids, __ldg(G.off + vid), __ldg(G.cnt + vid), r, best);
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
  H.t[i] = best.t;
  H.prim[i] = best.prim;
  H.b1[i] = best.b1;
  H.b2[i] = best.b2;
}

// Named kernels (not one template) so a profile tells them apart.
#define PBRT_KD_KERNEL(NAME, ANY, MOTION)                                    \
  __global__ void __launch_bounds__(kThreads)                               \
      NAME(Kd K, Prims P, Rays Y, Hits H, int R) {                          \
    kd_walk<ANY, MOTION>(K, P, Y, H, R);                                    \
  }
#define PBRT_GRID_KERNEL(NAME, ANY, MOTION)                                  \
  __global__ void __launch_bounds__(kThreads)                               \
      NAME(Grid G, Prims P, Rays Y, Hits H, int R) {                        \
    grid_walk<ANY, MOTION>(G, P, Y, H, R);                                  \
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

inline int blocks_for(int R) { return (R + kThreads - 1) / kThreads; }

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
    if (R > 0) KERNEL<<<blocks_for(R), kThreads, 0, stream>>>(K, P, Y, H, R); \
    return static_cast<int>(cudaGetLastError());                              \
  }
#define PBRT_GRID_ENTRY(NAME, KERNEL)                                          \
  int NAME(const int* off, const int* cnt, const int* ids, const float* lo,   \
           const float* hi, const float* width, int nx, int ny, int nz,       \
           PBRT_PRIMS_RAYS_PARAMS) {                                          \
    const Grid G{off, cnt, ids, lo, hi, width, nx, ny, nz};                   \
    PBRT_PACK                                                                 \
    if (R > 0) KERNEL<<<blocks_for(R), kThreads, 0, stream>>>(G, P, Y, H, R); \
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

}  // extern "C"
