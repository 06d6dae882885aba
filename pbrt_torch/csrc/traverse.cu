// Wide-BVH traversal on Hopper, eight lanes per ray: the interpret step as
// group __device__ functions, a standalone launch of that step, and
// closest-hit / any-hit kernels that walk each ray to completion.
//
// Replaces: pbrt_tpu/accel/pallas_step.py:_step_kernel (the Pallas TPU
// kernel for one traversal step's interpret phase) and the XLA step it
// stands for, pbrt_tpu/accel/intersect.py:897-979, together with the
// traversal control around it (_step_control, intersect.py:747-777, and the
// warm / straggler loops of _traverse_wide_batch, :981-1055). On the TPU
// every lane of a 32k-lane batch runs the same step in lockstep, so the JAX
// package compacts stragglers by hand; here each group of 8 threads owns
// one ray and stops stepping when its own stack empties.
//
// The step computes what the TPU kernel computes, operation for operation
// as the default XLA step writes it:
//   node row: 8 slab tests -> entry t; sort (entry, child ref) ascending with
//             intersect._SORT8 (19 compare-exchanges, strict '>' swap; the
//             Pallas kernel's own list orders equal keys differently);
//             n_hit = number of boxes hit.  Empty slots are inverted boxes.
//   leaf row: 8 Moller-Trumbore tests (1/det behind |det| < 1e-12) -> the
//             nearest (t, prim, b1, b2), first slot on ties.
// Built with -fmad=false and without fast math, so the float results equal
// the plain PyTorch version (accel/traverse_cuda.py) bit for bit.
//
// What bounds it on this card: not bytes. A ray's steps form a dependent
// chain (each row index comes out of the previous row's math), and a launch
// lasts as long as its longest ray: per step one L2 round trip for the row
// (the killeroo-scale table, a few MiB, stays in the 50 MB L2) plus the
// step's instruction stream, which the warps of an SM share the issue slots
// for. With one thread per ray that stream was long and serial (8 slab
// tests, 19 compare-exchanges, a push loop onto a stack in local memory, 8
// Moller-Trumbore tests), and most lanes of a warp waited for its longest
// ray.
//
// What this design does about it: a group of 8 consecutive lanes walks one
// ray, lane k owning child (or triangle) slot k of the row, so a step is one
// slab test or one triangle test per lane; the rows are slot-major (field f
// of slot k at column 8f + k), so each field is one 32-byte sector per
// group, read at a constant offset from one pointer per lane. The sort runs
// as its 6 layers of disjoint pairs, one shuffle pair per layer
// (kSort8Layers), n_hit is a ballot, the leaf's nearest slot is a 3-round
// (t, slot) butterfly, and the stack lives in shared memory, sized by the
// table's exact wide_stack. A 32,768-ray launch runs 8x the threads, 4 rays
// per warp.
//
// The 4 groups of a warp step together: each pass of the loop runs the node
// step if any group of the warp is at a node row and then the leaf step if
// any is at a leaf row, each group masked to its own state (a group may take
// both in one pass; its sequence of steps is the serial one). Every branch
// around a shuffle or ballot is therefore uniform across the warp, so they
// all name the full warp, and the compiler emits them without the
// convergence checks that a per-group mask in divergent code costs.
//
// Two more uses of the same step, each its own kernel:
// - Motion blur (traverse_{closest,any}_motion_kernel, the kMotion flag of
//   one template, so the static kernels compile as before). The JAX package
//   lerps each gathered row by the ray's shutter weight before the step,
//   row + tw * wide_motion[row] (intersect.py:873-874). Here lane k forms
//   that sum for the fields of its own slot as it loads them: the product
//   rounded, then added (-fmad=false), as the plain version does. Node rows
//   are lerped too, although their deltas are zero: a box corner of -0
//   becomes +0 there, and lerping keeps every bit of the plain version's
//   without an argument about which signed zero reaches a key. The child
//   refs and triangle ids are not lerped: their deltas are zero, tw lies in
//   [0, 1] (motion_weight clamps it), so ref + tw * 0 == ref, and they are
//   integers, never -0.
//   Those union boxes cover each child's whole shutter sweep, so on a scene
//   whose geometry moves farther than its size a ray walks every subtree
//   its sweep crosses (anim-killeroos: 149.8 steps a lane, its longest ray
//   4,717, and a launch lasts as long as that chain). So each lane also
//   tests its child's box at the ray's own weight (the port's time-box
//   table, wide.time_boxes: each node row's child boxes at shutter start and
//   their deltas, slot-major as the rows, lerped as the rows are) against
//   [tmin, inf), and a valid child that test misses is culled: its bit
//   rides the sort in the ref's low bit, and after the sort the survivors
//   (sorted positions < n_hit, not culled) are found by a ballot and a
//   prefix popcount; the walk descends to the first and pushes the rest,
//   nearest on top, in their sorted order, or pops. The union test still
//   gives the keys and the order, so the serial order stands; a culled
//   subtree holds no triangle the walk would accept (the time box holds
//   every lerped triangle, wide.time_boxes), so dropping it changes neither
//   (t, prim, b1, b2) nor the stack the walk returns to: the union walk's
//   result bit for bit. Bound: a step's row and deltas as before, plus, on
//   a node step, the time box and its delta (12 fields of 8 floats) and
//   its lerp and slab test.
// - Memory-shared instancing (traverse_instances_{closest,any}_kernel):
//   the JAX package's third phase (intersect.py:1060-1111), one launch for
//   every instance, seeded with the world walk's (t, prim, b1, b2). The
//   serial phase visits instances 0 .. I-1 in order: it prunes instance n by
//   its world box against the world ray and the current t_best (any-hit
//   also once it has a hit), moves the ray into the instance's space (o M^T
//   + t and d M^T by inst_w2o, the direction unnormalized so t is
//   unchanged), walks the object's table from its root row, and records
//   the instance wherever t or prim changed. Here each group takes that
//   sequence on its own (InstancePhase): its 8 lanes box-test 8 instances
//   at once against its current t_best (a ballot gives the round's
//   candidates), and before each walk it re-tests the candidates left at
//   the t_best of that moment, so it walks exactly the serial loop's
//   instances in the serial order, whatever the other groups do. The walk
//   loop takes a third pass for it (walk's kInst, compiled only into these
//   kernels): a group whose walk is over moves to its next candidate while
//   the others step, and a warp leaves when none of its groups walks or has
//   a candidate left. Bound: as the serial phase's, one box test per lane
//   and instance; what costs is a launch's longest warp, the longest chain
//   of steps of one of its rays over all that ray's walks, so the blocks
//   are one warp each (kInstThreads): the next warp starts as soon as any
//   one ends. The instance table (w2o, box, root; a few KiB) is read behind
//   __ldg, L1 hits after a warp's first round.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRow = 80;                         // floats per wide row
constexpr int kTboxRow = 96;  // floats per time-box row (wide.W_TBOX)
constexpr int kGroup = 8;                        // lanes per ray (one per slot)
constexpr int kThreads = 128;
constexpr int kRaysPerBlock = kThreads / kGroup; // 16
constexpr int kMaxStack = 1024;  // cap on g.wide_stack (the exact build-time
                                 // need): 16 rays x 1024 x 4 B = 64 KiB
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kWarp = 0xffffffffu;

// intersect._SORT8 as its 6 layers of disjoint compare-exchange pairs
// (i, j), i < j, in the serial network's order; {-1, -1} pads a layer.
// tests/test_torch_traverse_groups.py reads this table as text and holds it
// to traverse_cuda.SORT8_LAYERS.
constexpr int kSort8Layers[6][4][2] = {
    {{0, 1}, {2, 3}, {4, 5}, {6, 7}},
    {{0, 2}, {1, 3}, {4, 6}, {5, 7}},
    {{1, 2}, {5, 6}, {-1, -1}, {-1, -1}},
    {{0, 4}, {1, 5}, {2, 6}, {3, 7}},
    {{2, 4}, {3, 5}, {-1, -1}, {-1, -1}},
    {{1, 2}, {3, 4}, {5, 6}, {-1, -1}},
};

// Layer L's partner of every lane, 4 bits per lane (a lane in no pair is
// its own partner); evaluated at compile time.
__host__ __device__ constexpr unsigned partner_word(int L) {
  unsigned w = 0x76543210u;
  for (int p = 0; p < 4; ++p) {
    const int i = kSort8Layers[L][p][0], j = kSort8Layers[L][p][1];
    if (i >= 0) {
      w = (w & ~(0xFu << (4 * i))) | (static_cast<unsigned>(j) << (4 * i));
      w = (w & ~(0xFu << (4 * j))) | (static_cast<unsigned>(i) << (4 * j));
    }
  }
  return w;
}

// NaN-propagating min/max, one instruction each (PTX min.NaN / max.NaN,
// sm_80 and later). They return the canonical NaN where torch.minimum /
// maximum return the NaN operand, but no NaN reaches an output: a NaN
// entry or exit makes enter <= exit false, so the slot's key is inf and
// its hit false, the same in either form.
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

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

// A row field of lane k's slot, lerped by tw with its delta (mk, the same
// offset in the motion table) in the motion kernels: the product rounded,
// then added.
template <bool kMotion>
__device__ __forceinline__ float field(const float* __restrict__ rk,
                                       const float* __restrict__ mk, float tw,
                                       int f) {
  const float v = __ldg(rk + f);
  if constexpr (kMotion) {
    return v + tw * __ldg(mk + f);
  } else {
    return v;
  }
}

// The bits of this thread's group in a warp-wide ballot: lanes 8q .. 8q+7.
__device__ __forceinline__ unsigned group_bits() {
  return 0xFFu << (threadIdx.x & 24);
}

// One layer of the network: the lanes of a pair (i, j) swap their
// (key, ref) iff key_i > key_j, both lanes evaluating that same strict
// comparison, so lane i keeps the smaller side and ties stay in place.
template <unsigned kPartners>
__device__ __forceinline__ void sort_layer(int k, float& key, int& ref) {
  const int p = (kPartners >> (4 * k)) & 7;
  const float ko = __shfl_sync(kWarp, key, p, kGroup);
  const int ro = __shfl_sync(kWarp, ref, p, kGroup);
  const bool low = k < p;
  const float ki = low ? key : ko, kj = low ? ko : key;
  const bool swap = ki > kj;
  key = swap ? ko : key;
  ref = swap ? ro : ref;
}

// Node interpretation by lane k of a group, rk pointing at slot k of the
// row (field f at rk[8f]; mk at its deltas and tk at its time box when
// kMotion): the slab test of child slot k, then the group's sort. Returns
// n_hit; ref is the k-th child ref in sorted order, and with kMotion cull
// says whether that child's time box was missed.
// All 32 lanes of the warp call it together.
template <bool kMotion>
__device__ __forceinline__ int group_node(const float* __restrict__ rk,
                                          const float* __restrict__ mk,
                                          const float* __restrict__ tk,
                                          float tw, const Ray& ray,
                                          float t_best, bool act, int k,
                                          int& ref, bool& cull) {
  const float lox = field<kMotion>(rk, mk, tw, 0);
  const float hix = field<kMotion>(rk, mk, tw, 8);
  const float loy = field<kMotion>(rk, mk, tw, 16);
  const float hiy = field<kMotion>(rk, mk, tw, 24);
  const float loz = field<kMotion>(rk, mk, tw, 32);
  const float hiz = field<kMotion>(rk, mk, tw, 40);
  ref = static_cast<int>(__ldg(rk + 48));
  const float t0x = (lox - ray.ox) * ray.ix;
  const float t1x = (hix - ray.ox) * ray.ix;
  const float t0y = (loy - ray.oy) * ray.iy;
  const float t1y = (hiy - ray.oy) * ray.iy;
  const float t0z = (loz - ray.oz) * ray.iz;
  const float t1z = (hiz - ray.oz) * ray.iz;
  const float tn = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmin(t0z, t1z));
  const float tf = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmax(t0z, t1z));
  const float enter = vmax(tn, ray.tmin);
  const float exit_ = vmin(tf, t_best);
  const bool hit = (enter <= exit_) && (lox <= hix) && act;
  float key = hit ? enter : CUDART_INF_F;
  const int n_hit = __popc(__ballot_sync(kWarp, hit) & group_bits());
  if constexpr (kMotion) {
    // the child's time box at tw against [tmin, inf) (t_best left out: the
    // cull rests on containment alone); a valid slot that misses is culled,
    // the bit carried in the ref's low bit (ref * 2 + bit, |ref| < 2^24).
    // Its 12 loads are issued with the row's, independent of the union
    // test: loading only where that test hit cost 3.5-4.6% (PERF.md §6)
    const float u0x = (field<true>(tk, tk + 48, tw, 0) - ray.ox) * ray.ix;
    const float u1x = (field<true>(tk, tk + 48, tw, 8) - ray.ox) * ray.ix;
    const float u0y = (field<true>(tk, tk + 48, tw, 16) - ray.oy) * ray.iy;
    const float u1y = (field<true>(tk, tk + 48, tw, 24) - ray.oy) * ray.iy;
    const float u0z = (field<true>(tk, tk + 48, tw, 32) - ray.oz) * ray.iz;
    const float u1z = (field<true>(tk, tk + 48, tw, 40) - ray.oz) * ray.iz;
    const float un = vmax(vmax(vmin(u0x, u1x), vmin(u0y, u1y)), vmin(u0z, u1z));
    const float uf = vmin(vmin(vmax(u0x, u1x), vmax(u0y, u1y)), vmax(u0z, u1z));
    const bool thit = vmax(un, ray.tmin) <= uf;
    ref = ref * 2 + ((lox <= hix) && !thit ? 1 : 0);
  }
  sort_layer<partner_word(0)>(k, key, ref);
  sort_layer<partner_word(1)>(k, key, ref);
  sort_layer<partner_word(2)>(k, key, ref);
  sort_layer<partner_word(3)>(k, key, ref);
  sort_layer<partner_word(4)>(k, key, ref);
  sort_layer<partner_word(5)>(k, key, ref);
  if constexpr (kMotion) {
    cull = (ref & 1) != 0;
    ref >>= 1;  // arithmetic: a leaf's negative ref comes back whole
  }
  return n_hit;
}

struct LeafHit {
  float t;
  int prim;
  float b1, b2;
};

// Leaf interpretation by lane k of a group, rk pointing at slot k of the
// row: the Moller-Trumbore test of triangle slot k, then the nearest
// accepted slot, first slot on ties. The 3 butterfly rounds take the other
// lane's (tc, slot) iff it is smaller in (tc, slot) order: the serial
// first-minimum scan. tc is never NaN (t only when t > tmin && t < t_best),
// and with no accepted slot every tc is inf and slot 0 wins, as the argmin
// of an all-inf vector in the JAX step. Every lane of the group returns the
// same hit. All 32 lanes of the warp call it together.
template <bool kMotion>
__device__ __forceinline__ LeafHit group_leaf(const float* __restrict__ rk,
                                              const float* __restrict__ mk,
                                              float tw, const Ray& ray,
                                              float t_best, bool act, int k) {
  const float v0x = field<kMotion>(rk, mk, tw, 0);
  const float v0y = field<kMotion>(rk, mk, tw, 8);
  const float v0z = field<kMotion>(rk, mk, tw, 16);
  const float e1x = field<kMotion>(rk, mk, tw, 24);
  const float e1y = field<kMotion>(rk, mk, tw, 32);
  const float e1z = field<kMotion>(rk, mk, tw, 40);
  const float e2x = field<kMotion>(rk, mk, tw, 48);
  const float e2y = field<kMotion>(rk, mk, tw, 56);
  const float e2z = field<kMotion>(rk, mk, tw, 64);
  const int pid = static_cast<int>(__ldg(rk + 72));
  const float pvx = ray.dy * e2z - ray.dz * e2y;
  const float pvy = ray.dz * e2x - ray.dx * e2z;
  const float pvz = ray.dx * e2y - ray.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool small = fabsf(det) < 1e-12f;
  // compiles to rcp.rn.f32, the correctly rounded reciprocal (__frcp_rn)
  const float inv_det = small ? 0.f : 1.0f / det;
  const float tvx = ray.ox - v0x, tvy = ray.oy - v0y, tvz = ray.oz - v0z;
  const float b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float b2 = (ray.dx * qvx + ray.dy * qvy + ray.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  const bool ok = act && (pid >= 0) && !small && (b1 >= 0.f) &&
                  (b2 >= 0.f) && (b1 + b2 <= 1.f) && (t > ray.tmin) &&
                  (t < t_best);
  float tc = ok ? t : CUDART_INF_F;
  int slot = k;
#pragma unroll
  for (int m = 1; m < kGroup; m <<= 1) {
    const float to = __shfl_xor_sync(kWarp, tc, m, kGroup);
    const int so = __shfl_xor_sync(kWarp, slot, m, kGroup);
    const bool take = (to < tc) || (to == tc && so < slot);
    tc = take ? to : tc;
    slot = take ? so : slot;
  }
  LeafHit h;
  h.t = tc;
  h.prim = __shfl_sync(kWarp, pid, slot, kGroup);
  h.b1 = __shfl_sync(kWarp, b1, slot, kGroup);
  h.b2 = __shfl_sync(kWarp, b2, slot, kGroup);
  return h;
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* inv, const float* tmin,
                                        int i) {
  Ray ray;
  ray.ox = o[3 * i];
  ray.oy = o[3 * i + 1];
  ray.oz = o[3 * i + 2];
  ray.dx = d[3 * i];
  ray.dy = d[3 * i + 1];
  ray.dz = d[3 * i + 2];
  ray.ix = inv[3 * i];
  ray.iy = inv[3 * i + 1];
  ray.iz = inv[3 * i + 2];
  ray.tmin = tmin[i];
  return ray;
}

// This thread's lane k, group index in the block, and ray. Returns false
// when the warp's groups all lie past R (the warp leaves at once); a warp
// with some groups past R keeps their lanes (live false, reading ray R - 1)
// so every shuffle sees the full warp.
struct GroupIndex {
  int k, g, i;
  bool live;
};

template <int kRays = kRaysPerBlock>
__device__ __forceinline__ bool group_index(int R, GroupIndex& gi) {
  gi.k = threadIdx.x & (kGroup - 1);
  gi.g = threadIdx.x / kGroup;
  gi.i = blockIdx.x * kRays + gi.g;
  gi.live = gi.i < R;
  return blockIdx.x * kRays + (threadIdx.x & ~31) / kGroup < R;
}

// step_interpret's contract: one gathered row per lane i, both
// interpretations computed for every lane and masked as the JAX step masks;
// group i of 8 threads serves lane i, with the traversal's device functions.
__global__ void __launch_bounds__(kThreads) wide_step_kernel(
    const float* __restrict__ row, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ t_best,
    const bool* __restrict__ is_node, const bool* __restrict__ act,
    int* __restrict__ refs, int* __restrict__ n_hit,
    float* __restrict__ tsel, int* __restrict__ psel,
    float* __restrict__ b1, float* __restrict__ b2, int R) {
  GroupIndex gi;
  if (!group_index(R, gi)) return;
  const int i = gi.live ? gi.i : R - 1;
  const float* rk = row + static_cast<size_t>(i) * kRow + gi.k;
  const Ray ray = load_ray(o, d, inv, tmin, i);
  const float tb = t_best[i];
  const bool node = is_node[i];
  const bool a = act[i];
  int ref;
  bool cull;
  const int nh = group_node<false>(rk, nullptr, nullptr, 0.f, ray, tb, node && a, gi.k, ref,
                                   cull);
  const LeafHit h = group_leaf<false>(rk, nullptr, 0.f, ray, tb, !node && a, gi.k);
  if (!gi.live) return;
  refs[static_cast<size_t>(gi.k) * R + i] = ref;
  if (gi.k == 0) {
    n_hit[i] = nh;
    tsel[i] = h.t;
    psel[i] = h.prim;
    b1[i] = h.b1;
    b2[i] = h.b2;
  }
}

// make_inv_dir's rule (intersect.py:395): 1/d, or +-1e20 by the sign of
// d + 1e-30 where |d| < 1e-20 (0 where that sum is 0).
__device__ __forceinline__ float inv_dir(float v) {
  const float s = v + 1e-30f;
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
  return fabsf(v) < 1e-20f ? 1e20f * sg : 1.0f / v;
}

// The instance table: inst_w2o (I, 4, 4) row-major (rows 0-2 used), the
// world boxes lo / hi (I, 3) and each instance's root row, read behind
// __ldg (a few KiB: after a warp's first round they are L1 hits).
struct InstanceTable {
  const float* __restrict__ w2o;
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  const int* __restrict__ root;
  int I;
};

// Instance n's world box against the world ray, as the serial phase's
// prune computes it (intersect.py:1078-1082): enter = max(tn, tmin) and the
// box's exit tf; the prune at t_best is enter <= min(tf, t_best).
__device__ __forceinline__ void instance_box(const InstanceTable& tab, int n,
                                             const Ray& ray, float& enter,
                                             float& tf) {
  const float* bl = tab.lo + 3 * n;
  const float* bh = tab.hi + 3 * n;
  const float t0x = (__ldg(bl) - ray.ox) * ray.ix;
  const float t1x = (__ldg(bh) - ray.ox) * ray.ix;
  const float t0y = (__ldg(bl + 1) - ray.oy) * ray.iy;
  const float t1y = (__ldg(bh + 1) - ray.oy) * ray.iy;
  const float t0z = (__ldg(bl + 2) - ray.oz) * ray.iz;
  const float t1z = (__ldg(bh + 2) - ray.oz) * ray.iz;
  const float tn = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmin(t0z, t1z));
  tf = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmax(t0z, t1z));
  enter = vmax(tn, ray.tmin);
}

// The world ray in instance n's space: o M^T + t and d M^T, in the plain
// version's order ((x m0 + y m1) + z m2) + m3, and 1/d by make_inv_dir.
__device__ __forceinline__ Ray instance_ray(const InstanceTable& tab, int n,
                                            const Ray& ray) {
  const float* m = tab.w2o + 16 * n;
  Ray r2;
  r2.ox = ray.ox * __ldg(m) + ray.oy * __ldg(m + 1) + ray.oz * __ldg(m + 2) + __ldg(m + 3);
  r2.oy = ray.ox * __ldg(m + 4) + ray.oy * __ldg(m + 5) + ray.oz * __ldg(m + 6) + __ldg(m + 7);
  r2.oz = ray.ox * __ldg(m + 8) + ray.oy * __ldg(m + 9) + ray.oz * __ldg(m + 10) + __ldg(m + 11);
  r2.dx = ray.dx * __ldg(m) + ray.dy * __ldg(m + 1) + ray.dz * __ldg(m + 2);
  r2.dy = ray.dx * __ldg(m + 4) + ray.dy * __ldg(m + 5) + ray.dz * __ldg(m + 6);
  r2.dz = ray.dx * __ldg(m + 8) + ray.dy * __ldg(m + 9) + ray.dz * __ldg(m + 10);
  r2.ix = inv_dir(r2.dx);
  r2.iy = inv_dir(r2.dy);
  r2.iz = inv_dir(r2.dz);
  r2.tmin = ray.tmin;
  return r2;
}

// The instance kernels' blocks: one warp, 4 rays. A block's resources
// are freed when its last warp ends, and a launch lasts as long as its
// longest warp's chain of steps (a ray over all its walks, tens of steps
// against a mean of a few): one-warp blocks let the next warp start as soon
// as any one ends, at the occupancy of 8 blocks of 128 threads (32 warps
// an SM at 64 registers). 128- and 64-thread blocks and a floor of 10
// blocks of 128 (48 registers) were slower (PERF.md §6).
constexpr int kInstThreads = 32;
constexpr int kInstRays = kInstThreads / kGroup;

// A group's place in the serial order of instances. The group box-tests
// kInstanceRound instances at once, lane k instance base + k, against its
// current t_best; mask holds the round's candidates not yet walked (bit b:
// instance base + b). Before each walk the group re-tests the candidates
// left at the t_best of that moment (each lane its own stored enter and
// exit), so the lowest bit left is the instance the serial loop walks next:
// t_best only falls, so a round's mask holds every instance the serial loop
// walks and the re-test drops exactly those it prunes. mask, base, n, more,
// inst, t_was and p_was are the same on the group's 8 lanes; enter and tf
// lane k's, of instance base + k.
constexpr int kInstanceRound = 8;  // instances a round (one a lane);
                                   // traverse_cuda.INSTANCE_ROUND
static_assert(kInstanceRound == kGroup, "a round is one box test a lane");

struct InstancePhase {
  InstanceTable tab;
  Ray world;   // the world ray
  Ray r2;      // the ray in the space of the instance being walked
  unsigned mask;
  int base;    // the round's first instance; -kInstanceRound before the first
  int n;       // the instance walked last, -1 before the first walk
  int inst;    // the last instance whose walk changed t or prim, else -1
  bool more;   // candidates left: bits in mask, or rounds not tested
  float t_was;
  int p_was;
  float enter, tf;  // lane k's box test of instance base + k

  __device__ __forceinline__ void start(bool go) {
    enter = tf = 0.f;
    mask = 0u;
    base = -kInstanceRound;
    n = -1;
    inst = -1;
    more = go && tab.I > 0;
  }

  // The walk of instance n is over: record it where it changed t or prim
  // (a walk only lowers t, and changes prim only with t).
  __device__ __forceinline__ void close(float t_best, int prim) {
    if (n >= 0 && (t_best != t_was || prim != p_was)) inst = n;
  }

  // The third pass of the walk: each group that wants (its walk is over and
  // it has candidates left) records the walk, finds its next candidate, the
  // lowest one left that the re-test keeps, testing rounds until one has
  // one, and moves r2 into that instance's space. All 32 lanes call it
  // together; returns true on the lanes of a group that starts a walk
  // (from row root[n]).
  template <bool kAnyHit>
  __device__ __forceinline__ bool next(int k, bool want, float t_best,
                                       int prim, int& cur) {
    if (want) {
      close(t_best, prim);
      if (kAnyHit && prim >= 0) more = false;  // no instance can change it
    }
    const bool need = want && more;
    const bool keep = need && ((mask >> k) & 1u) && enter <= vmin(tf, t_best);
    const unsigned kept = (__ballot_sync(kWarp, keep) >> (threadIdx.x & 24)) & 0xFFu;
    if (need) mask = kept;
    bool test = need && mask == 0u && base + kInstanceRound < tab.I;
    while (__any_sync(kWarp, test)) {
      bool hit = false;
      if (test) {
        base += kInstanceRound;
        if (base + k < tab.I) {
          instance_box(tab, base + k, world, enter, tf);
          hit = enter <= vmin(tf, t_best);
        }
      }
      const unsigned got = (__ballot_sync(kWarp, hit) >> (threadIdx.x & 24)) & 0xFFu;
      if (test) mask = got;
      test = test && mask == 0u && base + kInstanceRound < tab.I;
    }
    if (!need) return false;
    more = false;
    if (mask == 0u) return false;
    n = base + __ffs(mask) - 1;
    mask &= mask - 1u;
    more = mask != 0u || base + kInstanceRound < tab.I;
    r2 = instance_ray(tab, n, world);
    cur = __ldg(tab.root + n);
    t_was = t_best;
    p_was = prim;
    return true;
  }
};

// One group walks one ray from row cur to completion (_step_control
// semantics): descend to refs[0] when n_hit > 0 and push refs[1..n_hit-1]
// with the nearest on top; pop otherwise; finish on a pop from an empty
// stack. (t_best, prim, bb1, bb2) hold the best hit so far; any-hit leaves
// at the first prim >= 0. cur, sp, t_best, prim and run are the same on all
// 8 lanes of a group; the loop runs while any group of the warp runs (a
// group that is done, or past R, steps masked). rows_k, motion_k and tbox_k
// point at slot k of row 0 of the table, of its deltas and of its time
// boxes. kMotion: the refs of sorted positions < n_hit that were not culled
// (the survivors) stand for refs[0..n_hit-1].
// kInst (the instance kernels only): a group walks one instance after
// another, ph choosing each (InstancePhase::next, a third pass run when a
// group's walk is over and it has candidates left); ray is ph->r2, which
// that pass moves into each instance's space; the loop runs while any
// group of the warp walks or has candidates left.
template <bool kAnyHit, bool kMotion, bool kInst = false>
__device__ __forceinline__ void walk(const float* __restrict__ rows_k,
                                     const float* __restrict__ motion_k,
                                     const float* __restrict__ tbox_k,
                                     float tw, const Ray& ray, int* stack,
                                     int k, bool run, int cur, float& t_best,
                                     int& prim, float& bb1, float& bb2,
                                     InstancePhase* ph = nullptr) {
  int sp = 0;
  while (__any_sync(kWarp, run || (kInst && ph->more))) {
    if constexpr (kInst) {
      const bool want = !run && ph->more;
      if (__any_sync(kWarp, want) &&
          ph->template next<kAnyHit>(k, want, t_best, prim, cur)) {
        run = true;
        sp = 0;
      }
    }
    const bool node = run && cur >= 0;
    if (__any_sync(kWarp, node)) {
      const size_t row = static_cast<size_t>(node ? cur : 0);
      const size_t off = row * kRow;
      int ref;
      bool cull;
      const int n_hit = group_node<kMotion>(
          rows_k + off, kMotion ? motion_k + off : nullptr,
          kMotion ? tbox_k + row * kTboxRow : nullptr, tw, ray, t_best, node,
          k, ref, cull);
      if constexpr (kMotion) {
        // the survivors by ballot, each lane's rank among them by a prefix
        // popcount; pushed in the serial order, nearest on top
        const bool surv = node && k < n_hit && !cull;
        const unsigned sb =
            (__ballot_sync(kWarp, surv) >> (threadIdx.x & 24)) & 0xFFu;
        const int n_surv = __popc(sb);
        const int nearest = __shfl_sync(kWarp, ref, sb ? __ffs(sb) - 1 : 0, kGroup);
        const int rank = __popc(sb & ((1u << k) - 1u));
        if (surv && rank >= 1) stack[sp + n_surv - 1 - rank] = ref;
        __syncwarp();  // the pushes are visible to the pops below
        if (node && n_surv > 0) {
          sp += n_surv - 1;
          cur = nearest;
        } else if (node) {
          if (sp == 0) run = false;
          else cur = stack[--sp];
        }
      } else {
        const int nearest = __shfl_sync(kWarp, ref, 0, kGroup);
        const bool descend = node && n_hit > 0;
        // the serial push order: ref_j at sp + n_hit - 1 - j, nearest on top
        if (descend && k >= 1 && k < n_hit) stack[sp + n_hit - 1 - k] = ref;
        __syncwarp();  // the pushes are visible to the pops below
        if (descend) {
          sp += n_hit - 1;
          cur = nearest;
        } else if (node) {
          if (sp == 0) run = false;
          else cur = stack[--sp];  // one address for the group: a broadcast
        }
      }
    }
    const bool leaf = run && cur < 0;
    if (__any_sync(kWarp, leaf)) {
      const size_t off = static_cast<size_t>(leaf ? -cur - 1 : 0) * kRow;
      const LeafHit h = group_leaf<kMotion>(
          rows_k + off, kMotion ? motion_k + off : nullptr, tw, ray, t_best,
          leaf, k);
      if (leaf) {
        if (h.t < t_best) {
          t_best = h.t;
          prim = h.prim;
          bb1 = h.b1;
          bb2 = h.b2;
        }
        if ((kAnyHit && prim >= 0) || sp == 0) run = false;
        else cur = stack[--sp];
      }
    }
  }
}

// The world walk: one group per ray from row 0 (always a node row). The
// quadric result seeds (t, prim, b1, b2); any-hit lanes that already have a
// hit and lanes with tmax == 0 leave at once. kMotion: each row lerped by
// the ray's tw (motion_weight) with its deltas, the children culled by
// their time boxes (tbox).
template <bool kAnyHit, bool kMotion>
__device__ __forceinline__ void traverse_group(
    const float* __restrict__ rows, const float* __restrict__ motion,
    const float* __restrict__ tbox,
    const float* __restrict__ tw_in, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ t_in, const int* __restrict__ p_in,
    const float* __restrict__ b1_in, const float* __restrict__ b2_in,
    float* __restrict__ t_out, int* __restrict__ p_out,
    float* __restrict__ b1_out, float* __restrict__ b2_out, int R,
    int wide_stack) {
  extern __shared__ int smem[];
  GroupIndex gi;
  if (!group_index(R, gi)) return;
  const int k = gi.k;
  const int i = gi.live ? gi.i : R - 1;
  const Ray ray = load_ray(o, d, inv, tmin, i);
  float t_best = t_in[i];
  int prim = p_in[i];
  float bb1 = b1_in[i], bb2 = b2_in[i];
  const bool run = gi.live && tmax[i] != 0.f && !(kAnyHit && prim >= 0);
  const float tw = kMotion ? tw_in[i] : 0.f;
  walk<kAnyHit, kMotion>(rows + k, kMotion ? motion + k : nullptr,
                         kMotion ? tbox + k : nullptr, tw, ray,
                         smem + gi.g * wide_stack, k, run, 0, t_best, prim,
                         bb1, bb2);
  if (gi.live && k == 0) {
    t_out[i] = t_best;
    p_out[i] = prim;
    b1_out[i] = bb1;
    b2_out[i] = bb2;
  }
}

// The instance phase: after the world walk, seeded with its result, each
// group walks the instances its ray reaches in the serial order, choosing
// each by InstancePhase (a round of 8 box tests at once, the exact prune
// before each walk), inside one walk loop: a group starts its next
// instance as soon as its last walk is over, and a warp leaves when none
// of its groups walks or has candidates left. w2o is (I, 4, 4) row-major,
// lo / hi (I, 3), root (I,). inst_out gets the last instance whose walk
// changed t or prim, else -1.
template <bool kAnyHit>
__device__ __forceinline__ void instances_group(
    const float* __restrict__ rows, const float* __restrict__ w2o,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const int* __restrict__ root, int I, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ t_in, const int* __restrict__ p_in,
    const float* __restrict__ b1_in, const float* __restrict__ b2_in,
    float* __restrict__ t_out, int* __restrict__ p_out,
    float* __restrict__ b1_out, float* __restrict__ b2_out,
    int* __restrict__ inst_out, int R, int stack_size) {
  extern __shared__ int smem[];
  GroupIndex gi;
  if (!group_index<kInstRays>(R, gi)) return;
  const int k = gi.k;
  const int i = gi.live ? gi.i : R - 1;
  InstancePhase ph;
  ph.tab = InstanceTable{w2o, lo, hi, root, I};
  ph.world = load_ray(o, d, inv, tmin, i);
  ph.r2 = ph.world;
  float t_best = t_in[i];
  int prim = p_in[i];
  float bb1 = b1_in[i], bb2 = b2_in[i];
  ph.start(gi.live && tmax[i] != 0.f && !(kAnyHit && prim >= 0));
  // ray is ph.r2, which the walk's third pass moves from instance to instance
  walk<kAnyHit, false, true>(rows + k, nullptr, nullptr, 0.f, ph.r2,
                             smem + gi.g * stack_size, k, false, 0, t_best,
                             prim, bb1, bb2, &ph);
  ph.close(t_best, prim);
  if (gi.live && k == 0) {
    t_out[i] = t_best;
    p_out[i] = prim;
    b1_out[i] = bb1;
    b2_out[i] = bb2;
    inst_out[i] = ph.inst;
  }
}

// Named kernels (not one template) so a profile tells them apart. The
// static kernels keep their parameter list (motion and tw come as null);
// the motion kernels take the time boxes after the deltas.
#define PBRT_TRAVERSE_PARAMS_false                                             \
  const float *__restrict__ rows, const float *__restrict__ motion,           \
      const float *__restrict__ tw
#define PBRT_TRAVERSE_PARAMS_true                                              \
  const float *__restrict__ rows, const float *__restrict__ motion,           \
      const float *__restrict__ tbox, const float *__restrict__ tw
#define PBRT_TRAVERSE_TABLES_false rows, motion, nullptr, tw
#define PBRT_TRAVERSE_TABLES_true rows, motion, tbox, tw
#define PBRT_TRAVERSE_KERNEL(NAME, ANY, MOTION)                                \
  __global__ void __launch_bounds__(kThreads) NAME(                           \
      PBRT_TRAVERSE_PARAMS_##MOTION, const float* __restrict__ o,             \
      const float* __restrict__ d, const float* __restrict__ inv,             \
      const float* __restrict__ tmin, const float* __restrict__ tmax,         \
      const float* __restrict__ t_in, const int* __restrict__ p_in,           \
      const float* __restrict__ b1_in, const float* __restrict__ b2_in,       \
      float* __restrict__ t_out, int* __restrict__ p_out,                     \
      float* __restrict__ b1_out, float* __restrict__ b2_out, int R,          \
      int wide_stack) {                                                       \
    traverse_group<ANY, MOTION>(PBRT_TRAVERSE_TABLES_##MOTION, o, d, inv,     \
                                tmin, tmax, t_in, p_in, b1_in, b2_in, t_out,  \
                                p_out, b1_out, b2_out, R, wide_stack);        \
  }

PBRT_TRAVERSE_KERNEL(traverse_closest_kernel, false, false)
PBRT_TRAVERSE_KERNEL(traverse_any_kernel, true, false)
PBRT_TRAVERSE_KERNEL(traverse_closest_motion_kernel, false, true)
PBRT_TRAVERSE_KERNEL(traverse_any_motion_kernel, true, true)

#undef PBRT_TRAVERSE_KERNEL
#undef PBRT_TRAVERSE_PARAMS_false
#undef PBRT_TRAVERSE_PARAMS_true
#undef PBRT_TRAVERSE_TABLES_false
#undef PBRT_TRAVERSE_TABLES_true

// The instance phase's two kernels, written out (a profile tells them
// apart by name).
#define PBRT_INSTANCES_PARAMS                                                  \
  const float *__restrict__ rows, const float *__restrict__ w2o,              \
      const float *__restrict__ lo, const float *__restrict__ hi,             \
      const int *__restrict__ root, int I, const float *__restrict__ o,       \
      const float *__restrict__ d, const float *__restrict__ inv,             \
      const float *__restrict__ tmin, const float *__restrict__ tmax,         \
      const float *__restrict__ t_in, const int *__restrict__ p_in,           \
      const float *__restrict__ b1_in, const float *__restrict__ b2_in,       \
      float *__restrict__ t_out, int *__restrict__ p_out,                     \
      float *__restrict__ b1_out, float *__restrict__ b2_out,                 \
      int *__restrict__ inst_out, int R, int stack_size
#define PBRT_INSTANCES_ARGS                                                    \
  rows, w2o, lo, hi, root, I, o, d, inv, tmin, tmax, t_in, p_in, b1_in, b2_in, \
      t_out, p_out, b1_out, b2_out, inst_out, R, stack_size

__global__ void __launch_bounds__(kInstThreads) traverse_instances_closest_kernel(
    PBRT_INSTANCES_PARAMS) {
  instances_group<false>(PBRT_INSTANCES_ARGS);
}

__global__ void __launch_bounds__(kInstThreads) traverse_instances_any_kernel(
    PBRT_INSTANCES_PARAMS) {
  instances_group<true>(PBRT_INSTANCES_ARGS);
}

#undef PBRT_INSTANCES_PARAMS
#undef PBRT_INSTANCES_ARGS

// Sizes a launch's stacks (16 rays x stack ints of dynamic shared memory):
// refuses a size the device cannot give a block, and raises the kernel's
// limit only past the 48 KiB every kernel may use. -> bytes, or -1 with
// the error in *err.
template <typename Kernel>
int stack_smem(Kernel kernel, int stack, cudaError_t* err, int rays = kRaysPerBlock) {
  *err = cudaSuccess;
  if (stack > kMaxStack) {
    *err = cudaErrorInvalidValue;
    return -1;
  }
  const int smem = rays * (stack < 1 ? 1 : stack) * 4;
  if (smem > kDefaultSmem) {
    int dev = 0, optin = 0;
    *err = cudaGetDevice(&dev);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (*err == cudaSuccess && smem > optin) *err = cudaErrorInvalidValue;
    if (*err == cudaSuccess)
      *err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err != cudaSuccess) return -1;
  }
  return smem;
}

inline int blocks_for(int R, int rays = kRaysPerBlock) { return (R + rays - 1) / rays; }

}  // namespace

extern "C" {

int pbrt_torch_max_stack() { return kMaxStack; }

int pbrt_torch_wide_step(const float* row, const float* o, const float* d,
                         const float* inv, const float* tmin,
                         const float* t_best, const bool* is_node,
                         const bool* act, int* refs, int* n_hit, float* tsel,
                         int* psel, float* b1, float* b2, int R,
                         cudaStream_t stream) {
  if (R > 0)
    wide_step_kernel<<<blocks_for(R), kThreads, 0, stream>>>(
        row, o, d, inv, tmin, t_best, is_node, act, refs, n_hit, tsel, psel,
        b1, b2, R);
  return static_cast<int>(cudaGetLastError());
}

// Each traversal entry sizes its launch's stacks (stack_smem) and launches;
// a size the device cannot give returns the error without a launch. The
// static entries take no motion table (the kernels get null pointers).
#define PBRT_TRAVERSE_ENTRY(NAME, KERNEL, MOTION_ARGS, MOTION_PTRS)           \
  int NAME(const float* rows, MOTION_ARGS const float* o, const float* d,     \
           const float* inv, const float* tmin, const float* tmax,            \
           const float* t_in, const int* p_in, const float* b1_in,            \
           const float* b2_in, float* t_out, int* p_out, float* b1_out,       \
           float* b2_out, int R, int wide_stack, cudaStream_t stream) {       \
    cudaError_t e;                                                            \
    const int smem = stack_smem(KERNEL, wide_stack, &e);                      \
    if (smem < 0) return static_cast<int>(e);                                 \
    if (wide_stack < 1) wide_stack = 1;                                       \
    if (R > 0)                                                                \
      KERNEL<<<blocks_for(R), kThreads, smem, stream>>>(                      \
          rows, MOTION_PTRS, o, d, inv, tmin, tmax, t_in, p_in, b1_in, b2_in, \
          t_out, p_out, b1_out, b2_out, R, wide_stack);                       \
    return static_cast<int>(cudaGetLastError());                              \
  }

#define PBRT_NO_MOTION_ARGS
#define PBRT_NO_MOTION_PTRS nullptr, nullptr
#define PBRT_MOTION_ARGS const float *motion, const float *tbox, const float *tw,
#define PBRT_MOTION_PTRS motion, tbox, tw

PBRT_TRAVERSE_ENTRY(pbrt_torch_traverse_closest, traverse_closest_kernel,
                    PBRT_NO_MOTION_ARGS, PBRT_NO_MOTION_PTRS)
PBRT_TRAVERSE_ENTRY(pbrt_torch_traverse_any, traverse_any_kernel,
                    PBRT_NO_MOTION_ARGS, PBRT_NO_MOTION_PTRS)
PBRT_TRAVERSE_ENTRY(pbrt_torch_traverse_closest_motion,
                    traverse_closest_motion_kernel, PBRT_MOTION_ARGS,
                    PBRT_MOTION_PTRS)
PBRT_TRAVERSE_ENTRY(pbrt_torch_traverse_any_motion, traverse_any_motion_kernel,
                    PBRT_MOTION_ARGS, PBRT_MOTION_PTRS)

#undef PBRT_TRAVERSE_ENTRY

#define PBRT_INSTANCES_ENTRY(NAME, KERNEL)                                     \
  int NAME(const float* rows, const float* w2o, const float* lo,              \
           const float* hi, const int* root, int I, const float* o,           \
           const float* d, const float* inv, const float* tmin,               \
           const float* tmax, const float* t_in, const int* p_in,             \
           const float* b1_in, const float* b2_in, float* t_out, int* p_out,  \
           float* b1_out, float* b2_out, int* inst_out, int R, int stack,     \
           cudaStream_t stream) {                                             \
    cudaError_t e;                                                            \
    const int smem = stack_smem(KERNEL, stack, &e, kInstRays);                \
    if (smem < 0) return static_cast<int>(e);                                 \
    if (stack < 1) stack = 1;                                                 \
    if (R > 0)                                                                \
      KERNEL<<<blocks_for(R, kInstRays), kInstThreads, smem, stream>>>(       \
          rows, w2o, lo, hi, root, I, o, d, inv, tmin, tmax, t_in, p_in,      \
          b1_in, b2_in, t_out, p_out, b1_out, b2_out, inst_out, R, stack);    \
    return static_cast<int>(cudaGetLastError());                              \
  }

PBRT_INSTANCES_ENTRY(pbrt_torch_traverse_instances_closest,
                     traverse_instances_closest_kernel)
PBRT_INSTANCES_ENTRY(pbrt_torch_traverse_instances_any,
                     traverse_instances_any_kernel)

#undef PBRT_INSTANCES_ENTRY

}  // extern "C"
