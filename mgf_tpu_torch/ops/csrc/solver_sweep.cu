// Fused block-Jacobi inner sweeps of the row solver, for Hopper (sm_90a).
//
// Replaces mgf_tpu/ops/solver_sweep.py::inner_sweeps, the Pallas TPU kernel
// (body _kernel), together with the partner-state gather that
// mgf_tpu/solver.py::solve_rows runs before each call (partner_term), and
// the block-major variant scripts/micro_sweep.py::run_blockmajor.  Within
// one OUTER solver iteration the partner velocity term is frozen, so every
// body column is independent.
//
// What bounds it: memory.  The work needs each input read once and each
// output written once: 4 * (18 N + 27 R N) bytes in term mode, 0.041 ms at
// R = 12, N = 100,000 on the H100's 3.35 TB/s, against ~80 R N flops per
// sweep.  A body's R rows hold 18 constraint channels, 3 partner terms and
// 3 accumulators each (288 floats at R = 12): more than one thread's 255
// registers, so the rows are spread over threads.
//
// Mapping: a CUDA block is 32 body columns x R rows (blockDim (32, R),
// R <= 32).  Each warp is one row of 32 consecutive columns, so every
// channel load is one coalesced 128-byte line.  Each thread loads its
// row's channels, accumulators and partner term ONCE and keeps them in
// registers across all `inner_iters` sweeps; only the row reduction goes
// through shared memory.  Per sweep every thread reads the column's six
// start-of-sweep velocities from shared memory, computes its row's
// impulse and writes six partial sums to part[R][6][32]; after a barrier
// the thread of row k < 6 (rows k, k + R, ... when R < 6) sums component k
// over r = 0..R-1 in order and updates vel[k][32]; a second barrier ends
// the sweep.  Warps read and write 32 consecutive floats, so no bank
// conflicts.
//
// Gather mode: the partner term vb + wb x rb is formed in the kernel.  A
// thread of row r < K reads the row partner once, clamps it into [0, M)
// (invalid pair rows carry partner = N), reads the partner's six velocity
// floats from the INPUT state and holds the term in registers; rows r >= K
// have a static partner and term 0.  The state is the full (8, M) array
// (statics past N); its columns >= N are copied to the output.  Input and
// output are distinct buffers, so the term is the start-of-iteration one.
//
// Layout (term mode): columns come in blocks of `block`; column j of block
// b reads channel c, row r at ((b * C + c) * R + r) * block + j (C = 18
// channels, 3 term components, 3 accumulators, 8 state rows, 2 self
// parameters; the state and self parameters have no R).  The (C, R, N)
// layout is the case block = N; block < N (a multiple of 32, so a tile of
// 32 columns never crosses a block) is the block-major (nb, C, R, block)
// layout.  Gather mode takes the (C, R, N) layout only.
//
// Semantics match _kernel line for line: dv = term - (va + wa x ra) from
// the start-of-sweep velocities for all rows; friction lambdas clamped to
// +-friction * acc_n; projected normal impulse; the row impulse masked by
// `valid` and its negated sum over rows applied after all rows (Jacobi
// within a body).  Accumulators update only where valid > 0.  Rows 6-7 of
// the packed state pass through.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;      // body columns per CUDA block (one warp)
constexpr int kMaxRows = 32;   // rows per body: blockDim.y <= 32
// the flagship's R = 12 (9 pair rows + 3 terrain rows) has its own
// instance: R known at compile time, at most 56 registers a thread, so
// three blocks of 384 threads share an SM
constexpr int kFlagshipRows = 12;
constexpr int kFlagshipBlocksPerSM = 3;

// kRows > 0: R = kRows = blockDim.y; kRows = 0: R = blockDim.y <= 32
template <bool kGather, int kRows>
__global__ void __launch_bounds__(kCols * (kRows > 0 ? kRows : kMaxRows),
                                  kRows > 0 ? kFlagshipBlocksPerSM : 1)
solver_sweep_kernel(const float* __restrict__ s_in,
                    const float* __restrict__ fields,
                    const float* __restrict__ term,  // gather mode: rb
                    const int* __restrict__ partner,
                    const float* __restrict__ self_p,
                    const float* __restrict__ acc_in,
                    float* __restrict__ s_out,
                    float* __restrict__ acc_out,
                    int n_cols, int inner_iters, int block, int s_cols,
                    int n_gather) {
  extern __shared__ float sh[];
  const int R = kRows > 0 ? kRows : blockDim.y;
  const int lane = threadIdx.x;
  const int r = threadIdx.y;
  float* part = sh;                   // [R][6][kCols] row partial sums
  float* vel = sh + R * 6 * kCols;    // [6][kCols] the column's velocity

  if (kGather) {
    // state columns past N (statics) pass through: grid-stride copy
    const long tail = static_cast<long>(s_cols) - n_cols;
    const long nthr = static_cast<long>(kCols) * R;
    for (long e = blockIdx.x * nthr + r * kCols + lane; e < 8 * tail;
         e += static_cast<long>(gridDim.x) * nthr) {
      const long o = (e / tail) * s_cols + n_cols + e % tail;
      s_out[o] = s_in[o];
    }
  }
  if (blockIdx.x * kCols >= n_cols) return;   // whole block: no barrier

  const int col = blockIdx.x * kCols + lane;
  const bool live = col < n_cols;
  // the ragged edge computes on the last column and stores nothing
  const int c = live ? col : n_cols - 1;
  // column n of block b; N below is the stride between rows (the block
  // width), RN the stride between channels, LS between state rows
  const size_t b = static_cast<size_t>(c / block);
  const size_t n = static_cast<size_t>(c % block);
  const size_t N = static_cast<size_t>(block);
  const size_t RN = static_cast<size_t>(R) * N;
  const size_t LS = kGather ? static_cast<size_t>(s_cols) : N;
  s_in += b * 8 * LS;
  s_out += b * 8 * LS;
  self_p += b * 2 * N;
  fields += b * 18 * RN;
  acc_in += b * 3 * RN;
  acc_out += b * 3 * RN;
  const size_t o = static_cast<size_t>(r) * N + n;

  // this row's channels, accumulators and partner term: read once
  const float* f = fields + o;
  const float nx = f[0 * RN], ny = f[1 * RN], nz = f[2 * RN];
  const float t1x = f[3 * RN], t1y = f[4 * RN], t1z = f[5 * RN];
  const float t2x = f[6 * RN], t2y = f[7 * RN], t2z = f[8 * RN];
  const float rax = f[9 * RN], ray = f[10 * RN], raz = f[11 * RN];
  const float fric = f[12 * RN], bias = f[13 * RN], nm = f[14 * RN];
  const float tm1 = f[15 * RN], tm2 = f[16 * RN], valid = f[17 * RN];
  float acc_n = acc_in[o];
  float acc_t1 = acc_in[RN + o];
  float acc_t2 = acc_in[2 * RN + o];
  float tx = 0.f, ty = 0.f, tz = 0.f;
  if (!kGather) {
    term += b * 3 * RN;
    tx = term[o];
    ty = term[RN + o];
    tz = term[2 * RN + o];
  } else if (r < n_gather) {
    const int p = min(max(partner[o], 0), s_cols - 1);
    const float* sb = s_in + p;
    const float vbx = sb[0 * LS], vby = sb[1 * LS], vbz = sb[2 * LS];
    const float obx = sb[3 * LS], oby = sb[4 * LS], obz = sb[5 * LS];
    const size_t KN = static_cast<size_t>(n_gather) * N;
    const float rbx = term[o], rby = term[KN + o], rbz = term[2 * KN + o];
    // vb + wb x rb
    tx = vbx + (oby * rbz - obz * rby);
    ty = vby + (obz * rbx - obx * rbz);
    tz = vbz + (obx * rby - oby * rbx);
  }
  // the threads of rows k < 6 own velocity component k of the column; the
  // body is side a: it receives -impulse
  const float neg_ima = r < 6 ? -self_p[n] : 0.f;
  const float neg_ia = r < 6 ? -self_p[N + n] : 0.f;
  for (int k = r; k < 6; k += R) vel[k * kCols + lane] = s_in[k * LS + n];
  __syncthreads();

  float* mine = part + r * 6 * kCols + lane;
  for (int it = 0; it < inner_iters; ++it) {
    const float vax = vel[0 * kCols + lane], vay = vel[1 * kCols + lane];
    const float vaz = vel[2 * kCols + lane], oax = vel[3 * kCols + lane];
    const float oay = vel[4 * kCols + lane], oaz = vel[5 * kCols + lane];
    // dv = frozen partner term - (va + wa x ra)
    const float dvx = tx - (vax + oay * raz - oaz * ray);
    const float dvy = ty - (vay + oaz * rax - oax * raz);
    const float dvz = tz - (vaz + oax * ray - oay * rax);
    // friction first (single-phase: both from the same dv)
    const float lam1 = -(dvx * t1x + dvy * t1y + dvz * t1z) * tm1;
    const float lam2 = -(dvx * t2x + dvy * t2y + dvz * t2z) * tm2;
    const float max_l = fric * acc_n;
    const float new1 = fminf(fmaxf(acc_t1 + lam1, -max_l), max_l);
    const float new2 = fminf(fmaxf(acc_t2 + lam2, -max_l), max_l);
    const float f1 = new1 - acc_t1;
    const float f2 = new2 - acc_t2;
    // projected normal impulse from the same dv
    const float vn = dvx * nx + dvy * ny + dvz * nz;
    const float lam = nm * (bias - vn);
    const float new_n = fmaxf(acc_n + lam, 0.f);
    const float fn = new_n - acc_n;
    // composite impulse, masked by row validity
    const float ix = (t1x * f1 + t2x * f2 + nx * fn) * valid;
    const float iy = (t1y * f1 + t2y * f2 + ny * fn) * valid;
    const float iz = (t1z * f1 + t2z * f2 + nz * fn) * valid;
    mine[0 * kCols] = ix;
    mine[1 * kCols] = iy;
    mine[2 * kCols] = iz;
    mine[3 * kCols] = ray * iz - raz * iy;
    mine[4 * kCols] = raz * ix - rax * iz;
    mine[5 * kCols] = rax * iy - ray * ix;
    if (valid > 0.f) {
      acc_n = new_n;
      acc_t1 = new1;
      acc_t2 = new2;
    }
    __syncthreads();
    // sum over rows in order, then update the column's velocity
    for (int k = r; k < 6; k += R) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < R; ++q) s += part[(q * 6 + k) * kCols + lane];
      vel[k * kCols + lane] += s * (k < 3 ? neg_ima : neg_ia);
    }
    __syncthreads();
  }

  if (!live) return;
  acc_out[o] = acc_n;
  acc_out[RN + o] = acc_t1;
  acc_out[2 * RN + o] = acc_t2;
  for (int k = r; k < 6; k += R) s_out[k * LS + n] = vel[k * kCols + lane];
  if (r == 0) {
    s_out[6 * LS + n] = s_in[6 * LS + n];
    s_out[7 * LS + n] = s_in[7 * LS + n];
  }
}

int launch(bool gather, const void* s_in, const void* fields,
           const void* term, const void* partner, const void* self_p,
           const void* acc_in, void* s_out, void* acc_out, int n_cols,
           int n_rows, int inner_iters, int block, int s_cols, int n_gather,
           void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows || block <= 0 || n_cols < 0 ||
      (n_cols > 0 && (n_cols % block != 0 ||
                      (block != n_cols && block % kCols != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n_cols + kCols - 1) / kCols;
  // gather mode launches one block even for N = 0, to copy the statics
  const int grid = gather ? (tiles > 0 ? tiles : 1) : tiles;
  if (grid == 0) return 0;
  const dim3 threads(kCols, n_rows);
  const size_t smem = sizeof(float) * (n_rows + 1) * 6 * kCols;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool flagship = n_rows == kFlagshipRows;
  const auto kernel =
      gather ? (flagship ? solver_sweep_kernel<true, kFlagshipRows>
                         : solver_sweep_kernel<true, 0>)
             : (flagship ? solver_sweep_kernel<false, kFlagshipRows>
                         : solver_sweep_kernel<false, 0>);
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const float*>(s_in), static_cast<const float*>(fields),
      static_cast<const float*>(term), static_cast<const int*>(partner),
      static_cast<const float*>(self_p), static_cast<const float*>(acc_in),
      static_cast<float*>(s_out), static_cast<float*>(acc_out), n_cols,
      inner_iters, block, s_cols, n_gather);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  All tensors float32 (partner
// int32), contiguous.  Each launches on `stream` and returns the launch's
// cudaError_t (0 on success); neither synchronises.
//
// Term mode, in blocks of `block` columns (n_cols = nb * block, block a
// multiple of 32 unless block = n_cols): s (nb, 8, block), fields
// (nb, 18, R, block), term (nb, 3, R, block), self_p (nb, 2, block), acc
// (nb, 3, R, block); block = n_cols is the (C, R, N) layout.
extern "C" int mgf_solver_sweep(const void* s_in, const void* fields,
                                const void* term, const void* self_p,
                                const void* acc_in, void* s_out,
                                void* acc_out, int n_cols, int n_rows,
                                int inner_iters, int block, void* stream) {
  return launch(false, s_in, fields, term, nullptr, self_p, acc_in, s_out,
                acc_out, n_cols, n_rows, inner_iters, block, block, 0,
                stream);
}

// Gather mode, (C, R, N) layout: s (8, M) with M = s_cols >= N = n_cols,
// fields (18, R, N), partner (R, N) (rows >= n_gather unread), rb
// (3, n_gather, N), self_p (2, N), acc (3, R, N); s_out (8, M).
extern "C" int mgf_solver_sweep_gather(const void* s_in, const void* fields,
                                       const void* partner, const void* rb,
                                       const void* self_p,
                                       const void* acc_in, void* s_out,
                                       void* acc_out, int n_cols,
                                       int n_rows, int inner_iters,
                                       int s_cols, int n_gather,
                                       void* stream) {
  if (s_cols < n_cols || s_cols < 1 || n_gather < 0 || n_gather > n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(true, s_in, fields, rb, partner, self_p, acc_in, s_out,
                acc_out, n_cols, n_rows, inner_iters, n_cols > 0 ? n_cols : 1,
                s_cols, n_gather, stream);
}
