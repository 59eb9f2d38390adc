// Sequential Gauss-Seidel contact solve (the reference's solver order) for
// Hopper (sm_90a): kernel K4.
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
// What bounds it: neither bytes nor operations but the chain of dependent
// point updates.  A point reads the velocities the previous point wrote, so
// the sweeps are one serial chain of iters * n_valid updates of ~225 flops
// each (the demo: 20 x ~1,100).  Its inputs (~3 MB at the demo's ~35,000
// slots) are read in ~1 us at 3.35 TB/s; the chain takes milliseconds.
// The design keeps the chain's latency short and does nothing else:
//   1. one block; its threads compact the indices of the valid points, in
//      order, with a block-wide prefix sum (warp ballots, then a scan of the
//      warp totals), so the chain never visits an invalid slot and the host
//      never syncs or calls nonzero;
//   2. the body table (16 floats a body: v, w, inv_mass, the row-major
//      inverse inertia) is staged in shared memory when it fits (85 KB for
//      the demo's 1,334 rows; the block opts into up to 227 KB), else the
//      chain works on the output table in global memory;
//   3. the accumulators of the valid points sit in shared memory after the
//      bodies when they fit, else in a global scratch the wrapper provides;
//   4. one thread runs the sweeps over the compacted list; the others wait,
//      then copy the bodies out.
// Every product, sum and difference is an __fmul_rn / __fadd_rn /
// __fsub_rn, which the compiler never contracts into a multiply-add, so
// each value rounds as the plain PyTorch version's separate ops round it,
// in particular those that decide a branch (the max(acc_n + lambda, 0)
// projection and the friction clamp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointFloats = 20;   // ra rb n t1 t2 (3 each), friction,
                                   // bias, normal mass, tangent masses
constexpr int kBodyFloats = 16;    // v w (3 each), inv_mass, inertia (9)

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
// row-major 3x3 times a vector, as math3d.mat_vec
__device__ __forceinline__ V3 matvec(const float* m, V3 v) {
  return {add(add(mul(m[0], v.x), mul(m[1], v.y)), mul(m[2], v.z)),
          add(add(mul(m[3], v.x), mul(m[4], v.y)), mul(m[5], v.z)),
          add(add(mul(m[6], v.x), mul(m[7], v.y)), mul(m[8], v.z))};
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
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

// one point update of solve_sequential's scan body
__device__ __forceinline__ void point_update(const float* __restrict__ p,
                                             float* A, float* B, float* acc,
                                             int mgf) {
  const V3 ra = load3(p), rb = load3(p + 3), n = load3(p + 6);
  const V3 t1 = load3(p + 9), t2 = load3(p + 12);
  const float friction = p[15], bias = p[16], nm = p[17];
  const float tm1 = p[18], tm2 = p[19];
  V3 va = load3(A), wa = load3(A + 3), vb = load3(B), wb = load3(B + 3);
  const float ima = A[6], imb = B[6];
  const float acc_n = acc[0], acc_t1 = acc[1], acc_t2 = acc[2];

  // friction on both tangents from one dv (solver.rs:220-232)
  V3 dv = rel_vel(va, wa, vb, wb, ra, rb);
  const float lam1 = mul(-vdot(dv, t1), tm1);
  const float lam2 = mul(-vdot(dv, t2), tm2);
  float f1, f2, new1, new2;
  if (mgf) {
    // the reference applies the raw lambda every sweep (broken clamp)
    f1 = lam1;
    f2 = lam2;
    new1 = add(acc_t1, lam1);
    new2 = add(acc_t2, lam2);
  } else {
    const float max_l = mul(friction, acc_n);
    new1 = fminf(fmaxf(add(acc_t1, lam1), -max_l), max_l);
    new2 = fminf(fmaxf(add(acc_t2, lam2), -max_l), max_l);
    f1 = sub(new1, acc_t1);
    f2 = sub(new2, acc_t2);
  }
  V3 imp = vadd(vscale(t1, f1), vscale(t2, f2));
  va = vsub(va, vscale(imp, ima));
  wa = vsub(wa, matvec(A + 7, vcross(ra, imp)));
  vb = vadd(vb, vscale(imp, imb));
  wb = vadd(wb, matvec(B + 7, vcross(rb, imp)));

  // projected normal impulse (solver.rs:236-240)
  dv = rel_vel(va, wa, vb, wb, ra, rb);
  const float lam = mul(nm, add(-vdot(dv, n), bias));
  const float new_n = fmaxf(add(acc_n, lam), 0.f);
  imp = vscale(n, sub(new_n, acc_n));
  va = vsub(va, vscale(imp, ima));
  wa = vsub(wa, matvec(A + 7, vcross(ra, imp)));
  vb = vadd(vb, vscale(imp, imb));
  wb = vadd(wb, matvec(B + 7, vcross(rb, imp)));

  // body a first, then b, as the scan's two sets
  store3(A, va);
  store3(A + 3, wa);
  store3(B, vb);
  store3(B + 3, wb);
  acc[0] = new_n;
  acc[1] = new1;
  acc[2] = new2;
}

__global__ void __launch_bounds__(kThreads) sequential_solve_kernel(
    const float* __restrict__ pts, const int* __restrict__ body_a,
    const int* __restrict__ body_b, const uint8_t* __restrict__ valid,
    const float* __restrict__ body_in, float* __restrict__ body_out,
    int* __restrict__ order, float* __restrict__ acc_global, int n_points,
    int n_bodies, int iters, int mgf, int bodies_in_smem, int smem_floats) {
  extern __shared__ float smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. compact the valid points' indices, in order
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int start = 0; start < n_points; start += kThreads) {
    const int i = start + tid;
    const bool flag = i < n_points && valid[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int s = lane < kWarps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
      }
      if (lane < kWarps) warp_sums[lane] = s;   // inclusive prefix
    }
    __syncthreads();
    if (flag) order[s_base + (warp ? warp_sums[warp - 1] : 0) + rank] = i;
    __syncthreads();
    if (tid == 0) s_base += warp_sums[kWarps - 1];
    __syncthreads();
  }
  const int n_valid = s_base;

  // 2. the body table and the accumulators
  const int body_floats = n_bodies * kBodyFloats;
  float* work = bodies_in_smem ? smem : body_out;
  for (int j = tid; j < body_floats; j += kThreads) work[j] = body_in[j];
  const int acc_off = bodies_in_smem ? body_floats : 0;
  float* acc = 3 * n_valid <= smem_floats - acc_off ? smem + acc_off
                                                    : acc_global;
  for (int j = tid; j < 3 * n_valid; j += kThreads) acc[j] = 0.f;
  __syncthreads();

  // 3. the serial chain
  if (tid == 0) {
    for (int it = 0; it < iters; ++it) {
      for (int k = 0; k < n_valid; ++k) {
        const int i = order[k];
        point_update(pts + static_cast<size_t>(i) * kPointFloats,
                     work + static_cast<size_t>(body_a[i]) * kBodyFloats,
                     work + static_cast<size_t>(body_b[i]) * kBodyFloats,
                     acc + 3 * k, mgf);
      }
    }
  }
  __syncthreads();
  if (bodies_in_smem)
    for (int j = tid; j < body_floats; j += kThreads) body_out[j] = smem[j];
}

}  // namespace

// Plain C entry point (bound with ctypes).  pts: (C, 20) float32; body_a,
// body_b: (C,) int32 in [0, M); valid: (C,) bool (one byte each); body_in,
// body_out: (M, 16) float32; order: (C,) int32 scratch; acc: a (3C,) float32
// scratch, or null when 3C floats fit in the shared memory after the
// bodies.  smem_bytes is the dynamic shared memory to launch with
// (bodies_in_smem: 64 M bytes of it hold the bodies).  All contiguous.
// Launches one block on `stream` and returns the cudaError_t of the
// attribute call or of the launch (0 on success); it does not synchronise.
extern "C" int mgf_sequential_solve(const void* pts, const void* body_a,
                                    const void* body_b, const void* valid,
                                    const void* body_in, void* body_out,
                                    void* order, void* acc, int n_points,
                                    int n_bodies, int iters, int mgf,
                                    int bodies_in_smem, int smem_bytes,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sequential_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sequential_solve_kernel<<<1, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(body_a),
      static_cast<const int*>(body_b), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(body_in), static_cast<float*>(body_out),
      static_cast<int*>(order), static_cast<float*>(acc), n_points,
      n_bodies, iters, mgf, bodies_in_smem,
      smem_bytes / static_cast<int>(sizeof(float)));
  return static_cast<int>(cudaGetLastError());
}
