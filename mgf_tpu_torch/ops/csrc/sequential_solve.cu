// Sequential Gauss-Seidel contact solve (the reference's solver order) for
// Hopper (sm_90a): kernel K4, run level by level over the points'
// body-dependency graph.
//
// Replaces mgf_tpu/solver.py:192 solve_sequential, which has no Pallas
// twin: it is a lax.scan over every contact point inside a lax.scan over the
// sweeps, which XLA compiles into one loop on the device.  Per sweep and per
// valid point i, in point order (solver.rs:72-78, 196-244):
//   dv = vb + wb x rb - va - wa x ra;
//   friction on both tangents from that one dv, textbook-clamped to
//   +-friction * acc_n, or the reference's raw lambda (mgf = 1);
//   apply it to a and b; dv again; the projected normal impulse
//   max(acc_n + nm * (bias - dv.n), 0) - acc_n; apply it.
// Accumulators start at 0 on every call (no warm start on this path);
// invalid points change nothing, so only the valid ones are visited.
//
// Why levels are exact.  An update reads and writes only its own
// accumulators and the velocities of its two bodies, so two updates that
// share no body commute exactly.  A static row (inverse mass and all nine
// inverse-inertia entries 0, the terrain's) gains imp * 0 and I (r x imp)
// = 0 in every update: for finite impulses its value never changes (a +0
// velocity stays +0), so no update waits for it and none writes it.  Give
// each valid point, in list order, the level L = 1 + max(last[a], last[b]),
// where last[] is the level of the previous point on that DYNAMIC body
// (0 for a static one), and make L the new last[] of its dynamic bodies.
// Then each dynamic body's updates keep their list order across levels,
// two points of one level share no dynamic body, and running the levels
// in turn does the serial sweep's float operations on every value in the
// same order: the result is the serial one bit for bit.
//
// What bounds it: neither bytes nor operations (the demo's list moves ~3
// MB and does ~5 MFLOP: a few microseconds at the card's rates) but the
// graph's depth.  Each level costs one update's chain of dependent float32
// operations (~37 at ~4 cycles each) plus the loads of the two bodies and
// a block barrier, and the levels run one after the other: the demo's list
// (~1,100 valid points over ~1,300 bodies, the terrain row static) is 9-10
// levels a sweep, 180-200 over the 20 sweeps, where the design it replaces
// walked 20 x ~1,100 dependent updates on one thread.  (With the sweeps
// overlapped, as far as each body's order allows, the depth would be ~47.)
// Within a level the shared-memory traffic of the updates (~300 bytes
// each, the bodies' at random banks) adds to the chain.
//
// One block of 512 threads, launched once per solve, with no host sync:
//   1. compaction: each thread counts the valid flags of one contiguous
//      segment (16-byte loads), and a block scan gives each segment its
//      base; the thread then writes its valid slots in order (order[]);
//      each valid point's bodies go to sa[] / sb[], as ~index when static;
//   2. the schedule, in rounds: in round r each point not yet placed offers
//      its index to an atomicMin on each of its dynamic bodies; a point
//      that holds the minimum on all of them has every earlier point of
//      its bodies placed, so its level is exactly r (the rule above).  The
//      round's points go to perm[] in list order (a block scan), the others
//      to the next round's list, in list order; off[r] is the end of level
//      r.  Rounds = depth, each a pass over the points left;
//   3. staging: the body table (16 floats a body: v, w, inv_mass, the
//      row-major inverse inertia) goes to shared memory by cp.async while
//      the schedule is built, in rows of 17 floats (an odd stride, so that
//      the bodies a warp touches fall into banks at random, and every
//      field is an immediate offset); after the schedule, the points'
//      rows (20 floats) and bodies follow in level order, so that a level's
//      threads read consecutive entries;
//   4. the sweeps: for each sweep and level, thread t takes the level's
//      points t, t + 512, ... and runs the point update, then a barrier.
//      A thread fetches its next point's row, bodies' indices and
//      accumulators before the barrier (they are read-only or its own), so
//      after the barrier it waits only on the two bodies.  Static rows are
//      read, never written.
// Where the data lives: everything in shared memory when it fits in the
// 227 KB a block may opt into (the body table | one room for the round
// keys, order, sa, sb and perm, which then takes the rows | sa, sb in
// level order | off | the accumulators, whose room holds the round lists
// and then the rows' sources first): up to ~1,350 valid points over the
// demo's 1,333 bodies.  Otherwise everything works from global memory (the
// wrapper's scratch, body_out), which the block barriers order the same
// way.  Each case is its own instantiation of solve(), so the compiler
// addresses shared memory as such.
// Every product, sum and difference is an __fmul_rn / __fadd_rn /
// __fsub_rn, which the compiler never contracts into a multiply-add, so
// each value rounds as the plain PyTorch versions' separate ops round it,
// in particular those that decide a branch (the max(acc_n + lambda, 0)
// projection and the friction clamp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPointFloats = 20;   // ra rb n t1 t2 (3 each), friction,
                                   // bias, normal mass, tangent masses
constexpr int kBodyFloats = 16;    // v w (3 each), inv_mass, inertia (9)
// the body table's row stride in shared memory: odd, so that the bodies a
// warp touches fall into banks at random (consecutive bodies into distinct
// ones) and every field is an immediate offset from the row
constexpr int kSmemBody = 17;
typedef unsigned long long u64;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)),
          sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}

// row-major 3x3 times a vector, as math3d.mat_vec
__device__ __forceinline__ V3 matvec(const float* m, V3 v) {
  return {add(add(mul(m[0], v.x), mul(m[1], v.y)), mul(m[2], v.z)),
          add(add(mul(m[3], v.x), mul(m[4], v.y)), mul(m[5], v.z)),
          add(add(mul(m[6], v.x), mul(m[7], v.y)), mul(m[8], v.z))};
}
__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

// relative velocity of the contact point: (vb + wb x rb) - va - wa x ra
__device__ __forceinline__ V3 rel_vel(V3 va, V3 wa, V3 vb, V3 wb, V3 ra,
                                      V3 rb) {
  return vsub(vsub(vadd(vb, vcross(wb, rb)), va), vcross(wa, ra));
}

// a point's row and accumulators, held in registers across a barrier
struct Item {
  V3 ra, rb, n, t1, t2;
  float friction, bias, nm, tm1, tm2;
  float acc_n, acc_t1, acc_t2;
  int p, ea, eb;   // position in level order; bodies, ~index when static
};

// one point update of solve_sequential's scan body; a static body is read
// and never written
__device__ __forceinline__ void point_update(Item& p, float* A, float* B,
                                             int mgf) {
  V3 va = load3(A), wa = load3(A + 3), vb = load3(B), wb = load3(B + 3);
  const float ima = A[6], imb = B[6];
  const float acc_n = p.acc_n, acc_t1 = p.acc_t1, acc_t2 = p.acc_t2;

  // friction on both tangents from one dv (solver.rs:220-232)
  V3 dv = rel_vel(va, wa, vb, wb, p.ra, p.rb);
  const float lam1 = mul(-vdot(dv, p.t1), p.tm1);
  const float lam2 = mul(-vdot(dv, p.t2), p.tm2);
  float f1, f2, new1, new2;
  if (mgf) {
    // the reference applies the raw lambda every sweep (broken clamp)
    f1 = lam1;
    f2 = lam2;
    new1 = add(acc_t1, lam1);
    new2 = add(acc_t2, lam2);
  } else {
    const float max_l = mul(p.friction, acc_n);
    new1 = fminf(fmaxf(add(acc_t1, lam1), -max_l), max_l);
    new2 = fminf(fmaxf(add(acc_t2, lam2), -max_l), max_l);
    f1 = sub(new1, acc_t1);
    f2 = sub(new2, acc_t2);
  }
  V3 imp = vadd(vscale(p.t1, f1), vscale(p.t2, f2));
  va = vsub(va, vscale(imp, ima));
  wa = vsub(wa, matvec(A + 7, vcross(p.ra, imp)));
  vb = vadd(vb, vscale(imp, imb));
  wb = vadd(wb, matvec(B + 7, vcross(p.rb, imp)));

  // projected normal impulse (solver.rs:236-240)
  dv = rel_vel(va, wa, vb, wb, p.ra, p.rb);
  const float lam = mul(p.nm, add(-vdot(dv, p.n), p.bias));
  const float new_n = fmaxf(add(acc_n, lam), 0.f);
  imp = vscale(p.n, sub(new_n, acc_n));
  va = vsub(va, vscale(imp, ima));
  wa = vsub(wa, matvec(A + 7, vcross(p.ra, imp)));
  vb = vadd(vb, vscale(imp, imb));
  wb = vadd(wb, matvec(B + 7, vcross(p.rb, imp)));

  // body a first, then b, as the scan's two sets
  if (p.ea >= 0) {
    store3(A, va);
    store3(A + 3, wa);
  }
  if (p.eb >= 0) {
    store3(B, vb);
    store3(B + 3, wb);
  }
  p.acc_n = new_n;
  p.acc_t1 = new1;
  p.acc_t2 = new2;
}

// a static body: inverse mass and all nine inverse-inertia entries 0 (read
// through the read-only cache, all ten at once)
__device__ __forceinline__ bool body_static(const float* b) {
  bool zero = true;
#pragma unroll
  for (int j = 6; j < kBodyFloats; ++j) zero &= __ldg(b + j) == 0.f;
  return zero;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Exclusive prefix sum of x over the block in thread order; *total gets
// the block's sum.  Every thread of the block must call it, with the same
// `phase`, which it flips: the two halves of warp_sums take turns, so a
// call needs no barrier at its end.
__device__ int block_scan(int x, int (*warp_sums)[kWarps], int& phase,
                          int* total) {
  int* ws = warp_sums[phase];
  phase ^= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    if (lane < kWarps) ws[lane] = s;   // inclusive prefix
  }
  __syncthreads();
  *total = ws[kWarps - 1];
  return v - x + (warp ? ws[warp - 1] : 0);
}

// number of nonzero bytes among the 16 of w
__device__ __forceinline__ int count16(uint4 w) {
  return (__popc(__vcmpne4(w.x, 0u)) + __popc(__vcmpne4(w.y, 0u)) +
          __popc(__vcmpne4(w.z, 0u)) + __popc(__vcmpne4(w.w, 0u))) >> 3;
}

// The valid flags thread t owns: the 16-aligned slots [t * seg, t * seg +
// seg), read 16 at a time where the flags are 16-byte aligned.
struct Segment {
  int lo, hi;
  bool vec;
};

__device__ Segment my_segment(const uint8_t* valid, int C) {
  const int seg = ((C + kThreads - 1) / kThreads + 15) & ~15;
  const int lo = min(static_cast<int>(threadIdx.x) * seg, C);
  return {lo, min(lo + seg, C),
          (reinterpret_cast<uintptr_t>(valid) & 15) == 0};
}

__device__ int count_valid(const uint8_t* __restrict__ valid, Segment s) {
  int cnt = 0;
  for (int j = s.lo; j < s.hi;) {
    if (s.vec && j + 16 <= s.hi) {
      cnt += count16(*reinterpret_cast<const uint4*>(valid + j));
      j += 16;
    } else {
      cnt += valid[j] != 0;
      ++j;
    }
  }
  return cnt;
}

// f(k, i) for each valid slot i of the segment, in order, k counting from
// `pos` (the valid points before the segment)
template <class F>
__device__ __forceinline__ void for_each_valid(
    const uint8_t* __restrict__ valid, Segment s, int pos, F f) {
  for (int j = s.lo; j < s.hi;) {
    if (s.vec && j + 16 <= s.hi) {
      const uint4 w = *reinterpret_cast<const uint4*>(valid + j);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if ((ws[q >> 2] >> (8 * (q & 3))) & 0xffu) f(pos++, j + q);
      j += 16;
    } else {
      if (valid[j]) f(pos++, j);
      ++j;
    }
  }
}

__device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// The shared-memory layout for nv valid points over M bodies, as byte
// offsets: the body table | a room R that holds the schedule's arrays
// (round keys, order, sa, sb, perm) while it is built and the rows, in
// level order, after | sa and sb in level order | off | the accumulators,
// whose room holds the round buffers and then the rows' sources first.
struct Layout {
  size_t room, sched_lists, spa, spb, off, acc, total;
};

__device__ __forceinline__ Layout layout(int nv, int M) {
  const size_t n = nv, list = align16(4 * n);
  const size_t keys = 2 * align16(4 * static_cast<size_t>(M));
  const size_t rows = align16(4 * kPointFloats * n);
  const size_t sched = keys + 4 * list;
  Layout L;
  L.room = align16(4 * static_cast<size_t>(kSmemBody) * M);
  L.sched_lists = L.room + keys;
  L.spa = L.room + (rows > sched ? rows : sched);
  L.spb = L.spa + list;
  L.off = L.spb + list;
  L.acc = L.off + align16(4 * (n + 1));
  L.total = L.acc + align16(12 * n);
  return L;
}

struct Args {
  const float* pts;
  const int *body_a, *body_b;
  const uint8_t* valid;
  const float* body_in;
  float* body_out;
  int* iscr;
  float* fscr;
  int C, M, iters, mgf;
};

// Everything after the count of valid points.  kShared: every array in
// shared memory, each pointer taken from `smem` itself so that the
// compiler addresses it as shared (LDS/STS/ATOMS); else every array in the
// global scratch and the (M, 16) rows of body_out.
template <bool kShared>
__device__ __forceinline__ void solve(const Args& g, int nv, int pos,
                                      Segment seg,
                                      int (*warp_sums)[kWarps], int& phase,
                                      unsigned char* smem) {
  const int tid = threadIdx.x, C = g.C, M = g.M;
  float *work, *rows, *acc;
  unsigned *keys0, *keys1;
  int *order, *sa, *sb, *perm, *off, *spa, *spb, *rem0, *rem1, *src;
  if constexpr (kShared) {
    const Layout L = layout(nv, M);
    const size_t list = align16(4 * static_cast<size_t>(nv));
    work = reinterpret_cast<float*>(smem);
    keys0 = reinterpret_cast<unsigned*>(smem + L.room);
    keys1 = reinterpret_cast<unsigned*>(smem + L.room +
                                        align16(4 * static_cast<size_t>(M)));
    order = reinterpret_cast<int*>(smem + L.sched_lists);
    sa = reinterpret_cast<int*>(smem + L.sched_lists + list);
    sb = reinterpret_cast<int*>(smem + L.sched_lists + 2 * list);
    perm = reinterpret_cast<int*>(smem + L.sched_lists + 3 * list);
    rows = reinterpret_cast<float*>(smem + L.room);
    spa = reinterpret_cast<int*>(smem + L.spa);
    spb = reinterpret_cast<int*>(smem + L.spb);
    off = reinterpret_cast<int*>(smem + L.off);
    acc = reinterpret_cast<float*>(smem + L.acc);
    rem0 = reinterpret_cast<int*>(smem + L.acc);
    rem1 = rem0 + nv;
    src = rem0;
  } else {
    order = g.iscr;
    int* s = g.iscr + C;
    sa = s;
    sb = s + C;
    perm = s + 2 * C;
    off = s + 3 * C;   // C + 1 entries
    spa = s + 4 * C + 1;
    spb = s + 5 * C + 1;
    rem0 = s + 6 * C + 1;
    rem1 = s + 7 * C + 1;
    src = s + 8 * C + 1;
    keys0 = reinterpret_cast<unsigned*>(s + 9 * C + 1);
    keys1 = keys0 + M;
    work = g.body_out;
    acc = g.fscr;
    rows = g.fscr + 3 * static_cast<size_t>(C);
  }

  // keys0[x]: 0 for a static body, else "no key yet"
#pragma unroll 4
  for (int x = tid; x < M; x += kThreads)
    keys0[x] =
        body_static(g.body_in + static_cast<size_t>(x) * kBodyFloats) ? 0u
                                                                      : ~0u;
  // the body table, in flight while the schedule is built: rows of 17
  // floats in shared memory, else a copy of the input rows in body_out
  for (int j = tid; j < kBodyFloats * M; j += kThreads) {
    if constexpr (kShared) {
      const int a = j / kBodyFloats, f = j - kBodyFloats * a;
      cp_async4(work + static_cast<size_t>(kSmemBody) * a + f,
                g.body_in + j);
    } else {
      g.body_out[j] = g.body_in[j];
    }
  }
  // the valid points' slots in order
  for_each_valid(g.valid, seg, pos, [&](int k, int i) { order[k] = i; });
  if (tid == 0) off[0] = 0;
  __syncthreads();
  // and their bodies (~index when static)
  for (int k = tid; k < nv; k += kThreads) {
    const int i = order[k];
    const int a = __ldg(g.body_a + i), b = __ldg(g.body_b + i);
    sa[k] = keys0[a] ? a : ~a;
    sb[k] = keys0[b] ? b : ~b;
  }
  __syncthreads();

  // the schedule, in rounds.  In round r each point left offers its index
  // to an atomicMin on its dynamic bodies; it is ready, and its level is r,
  // when it holds the minimum on all of them.  The ready points go to
  // perm[] in list order (a block scan), the others to the next round's
  // list, in list order; off[r] is the end of level r.  The two key tables
  // take turns: a round's second pass empties the next round's entries of
  // its points' bodies.
  int depth = 0, n_done = 0, n_rem = nv;
  const int* cur = nullptr;   // round 1 takes every point, in order
  while (n_rem > 0) {
    ++depth;
    unsigned* kc = (depth & 1) ? keys0 : keys1;
    unsigned* kn = (depth & 1) ? keys1 : keys0;
    int* nxt = (depth & 1) ? rem0 : rem1;
    for (int j = tid; j < n_rem; j += kThreads) {
      const int k = cur ? cur[j] : j, ea = sa[k], eb = sb[k];
      if (ea >= 0) atomicMin(&kc[ea], static_cast<unsigned>(k));
      if (eb >= 0 && eb != ea) atomicMin(&kc[eb], static_cast<unsigned>(k));
    }
    __syncthreads();
    int n_ready = 0, n_wait = 0;
    for (int start = 0; start < n_rem; start += kThreads) {
      const int j = start + tid;
      int k = 0;
      bool ready = false;
      if (j < n_rem) {
        k = cur ? cur[j] : j;
        const int ea = sa[k], eb = sb[k];
        const unsigned key = static_cast<unsigned>(k);
        ready = (ea < 0 || kc[ea] == key) && (eb < 0 || kc[eb] == key);
        if (ea >= 0) kn[ea] = ~0u;
        if (eb >= 0) kn[eb] = ~0u;
      }
      int total;
      const int r = block_scan(ready ? 1 : 0, warp_sums, phase, &total);
      if (ready)
        perm[n_done + n_ready + r] = k;
      else if (j < n_rem)
        nxt[n_wait + (j - start) - r] = k;
      n_ready += total;
      n_wait += min(kThreads, n_rem - start) - total;
    }
    // the first point left is always ready; a round that places nothing
    // is a fault, and the kernel stops instead of looping
    if (n_ready == 0) __trap();
    n_done += n_ready;
    n_rem = n_wait;
    if (tid == 0) off[depth] = n_done;
    cur = nxt;
    __syncthreads();
  }

  // level order for what the sweeps read: the bodies, then the rows (the
  // schedule's room takes them, so their sources go first to the
  // accumulators' room); then the accumulators start at 0
  for (int p = tid; p < nv; p += kThreads) {
    const int k = perm[p];
    spa[p] = sa[k];
    spb[p] = sb[k];
    src[p] = order[k];
  }
  __syncthreads();
  const bool vec = (reinterpret_cast<uintptr_t>(g.pts) & 15) == 0;
  for (int j = tid; j < 5 * nv; j += kThreads) {
    const int p = j / 5, q = j - 5 * p;
    const float* from =
        g.pts + static_cast<size_t>(src[p]) * kPointFloats + 4 * q;
    float* to = rows + static_cast<size_t>(kPointFloats) * p + 4 * q;
    if constexpr (kShared) {
      if (vec) {
        cp_async16(to, from);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(to + e, from + e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) to[e] = from[e];
    }
  }
  if constexpr (kShared) cp_async_wait_all();
  __syncthreads();
  for (int j = tid; j < 3 * nv; j += kThreads) acc[j] = 0.f;
  __syncthreads();

  // the sweeps, level by level
  auto fetch = [&](int p, Item& it) {
    it.p = p;
    it.ea = spa[p];
    it.eb = spb[p];
    float r[kPointFloats];
    const float* src = rows + static_cast<size_t>(kPointFloats) * p;
    if constexpr (kShared) {
      const float4* r4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int q = 0; q < kPointFloats / 4; ++q) {
        const float4 x = r4[q];
        r[4 * q] = x.x;
        r[4 * q + 1] = x.y;
        r[4 * q + 2] = x.z;
        r[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kPointFloats; ++q) r[q] = src[q];
    }
    it.ra = load3(r);
    it.rb = load3(r + 3);
    it.n = load3(r + 6);
    it.t1 = load3(r + 9);
    it.t2 = load3(r + 12);
    it.friction = r[15];
    it.bias = r[16];
    it.nm = r[17];
    it.tm1 = r[18];
    it.tm2 = r[19];
    it.acc_n = acc[3 * p];
    it.acc_t1 = acc[3 * p + 1];
    it.acc_t2 = acc[3 * p + 2];
  };
  constexpr int kStride = kShared ? kSmemBody : kBodyFloats;
  auto run = [&](Item& it) {
    float* A = work + (it.ea < 0 ? ~it.ea : it.ea) * kStride;
    float* B = work + (it.eb < 0 ? ~it.eb : it.eb) * kStride;
    point_update(it, A, B, g.mgf);
    acc[3 * it.p] = it.acc_n;
    acc[3 * it.p + 1] = it.acc_t1;
    acc[3 * it.p + 2] = it.acc_t2;
  };
  const int n_steps = g.iters * depth;
  int lv = 1, lo = 0, hi = depth > 0 ? off[1] : 0;
  Item item;
  if (tid < hi) fetch(tid, item);
  for (int s = 0; s < n_steps; ++s) {
    // the next step's level: the next one, or the first after the last
    const int nlv = lv == depth ? 1 : lv + 1;
    const int nlo = nlv == 1 ? 0 : hi, nhi = off[nlv];
    const int p = lo + tid;
    if (p < hi) run(item);
    for (int q = p + kThreads; q < hi; q += kThreads) {   // a wide level
      Item extra;
      fetch(q, extra);
      run(extra);
    }
    // this thread's first point of the next level: its row and
    // accumulators are read-only or this thread's own, so only the bodies
    // must wait for the barrier
    if (nlo + tid < nhi) fetch(nlo + tid, item);
    __syncthreads();
    lv = nlv;
    lo = nlo;
    hi = nhi;
  }

  if constexpr (kShared)
    for (int j = tid; j < kBodyFloats * M; j += kThreads) {
      const int a = j / kBodyFloats, f = j - kBodyFloats * a;
      g.body_out[j] = work[kSmemBody * a + f];
    }
}

__global__ void __launch_bounds__(kThreads, 1) sequential_solve_kernel(
    Args g, int bodies_in_smem, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[2][kWarps];
  int phase = 0, nv;
  // 1. compaction: count, then a block scan gives each segment its base
  const Segment seg = my_segment(g.valid, g.C);
  const int pos = block_scan(count_valid(g.valid, seg), warp_sums, phase,
                             &nv);
  if (bodies_in_smem &&
      layout(nv, g.M).total <= static_cast<size_t>(smem_bytes))
    solve<true>(g, nv, pos, seg, warp_sums, phase, smem);
  else
    solve<false>(g, nv, pos, seg, warp_sums, phase, smem);
}

}  // namespace

// Plain C entry point (bound with ctypes).  pts: (C, 20) float32; body_a,
// body_b: (C,) int32 in [0, M); valid: (C,) bool (one byte each); body_in,
// body_out: (M, 16) float32; iscratch: an int32 scratch of 10 C + 2 M + 1
// entries; fscratch: a float32 scratch of 23 C.  bodies_in_smem: 1 puts
// every array in shared memory when they all fit in smem_bytes (at most
// 227 KB less the kernel's static bytes), as they do up to ~1,350 valid
// points over the demo's 1,333 bodies; else, or with 0, every array stays
// in global memory (the scratch and body_out).  All contiguous.  Launches
// one block on `stream` and returns the cudaError_t of the attribute call
// or of the launch (0 on success); it does not synchronise.
extern "C" int mgf_sequential_solve(const void* pts, const void* body_a,
                                    const void* body_b, const void* valid,
                                    const void* body_in, void* body_out,
                                    void* iscratch, void* fscratch,
                                    int n_points, int n_bodies, int iters,
                                    int mgf, int bodies_in_smem,
                                    int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sequential_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args g{static_cast<const float*>(pts),
               static_cast<const int*>(body_a),
               static_cast<const int*>(body_b),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(body_in),
               static_cast<float*>(body_out),
               static_cast<int*>(iscratch),
               static_cast<float*>(fscratch),
               n_points,
               n_bodies,
               iters,
               mgf};
  sequential_solve_kernel<<<1, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      g, bodies_in_smem, smem_bytes);
  return static_cast<int>(cudaGetLastError());
}
