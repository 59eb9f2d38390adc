// Fused block-Jacobi inner sweeps of the row solver, for Hopper (sm_90a).
//
// Replaces mgf_tpu/ops/solver_sweep.py::inner_sweeps, the Pallas TPU kernel
// (body _kernel), and its block-major variant
// scripts/micro_sweep.py::run_blockmajor.  Within one OUTER solver
// iteration the partner velocity term is frozen, so every body column is
// independent: one thread owns one column and runs all `inner_iters`
// sweeps over its R constraint rows.
//
// Layout: columns come in blocks of `block`; column j of block b reads
// channel c, row r at ((b * C + c) * R + r) * block + j (C = 18 channels,
// 3 partner-term components, 3 accumulators, 8 state rows, 2 self
// parameters; the state and self parameters have no R).  The (C, R, N)
// layout of inner_sweeps is the case block = N; block < N is the
// block-major (nb, C, R, block) layout.  Either way a warp reads 32
// consecutive floats per channel.
//
// What bounds it: memory.  Each sweep a thread re-reads its 18 constraint
// channels, 3 frozen partner terms and 3 accumulators per row and writes
// back up to 3 accumulators: (18 + 3 + 3) * 4 = 96 * R bytes read and
// 12 * R bytes written per column per sweep, against ~80 * R flops.  The
// algorithm itself needs each input read once and each output written
// once: 4 * (18 N + 27 R N) bytes, 0.041 ms at R = 12, N = 100,000 on the
// H100's 3.35 TB/s.  The design keeps the body's own velocity (va, wa) and
// the per-sweep impulse sums in registers, masks the ragged edge of N
// itself, and allocates nothing.  Keeping the channels resident across
// sweeps (shared memory or registers, R templated) and fusing the partner
// gather are later work.
//
// Semantics match _kernel line for line: dv = term - (va + wa x ra) from
// the start-of-sweep velocities for all rows; friction lambdas clamped to
// +-friction * acc_n; projected normal impulse; the row impulse masked by
// `valid` and its negated sum over rows applied after all rows (Jacobi
// within a body).  Accumulators update only where valid > 0.  Rows 6-7 of
// the packed state pass through.

#include <cuda_runtime.h>

namespace {

__global__ void solver_sweep_kernel(const float* __restrict__ s_in,
                                    const float* __restrict__ fields,
                                    const float* __restrict__ term,
                                    const float* __restrict__ self_p,
                                    const float* __restrict__ acc_in,
                                    float* __restrict__ s_out,
                                    float* __restrict__ acc_out,
                                    int n_cols, int n_rows, int inner_iters,
                                    int block) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  // column j of block b; N below is the stride between rows (the block
  // width) and RN the stride between channels of one block
  const size_t b = static_cast<size_t>(col / block);
  const size_t n = static_cast<size_t>(col % block);
  const size_t N = static_cast<size_t>(block);
  const size_t RN = static_cast<size_t>(n_rows) * N;
  s_in += b * 8 * N;
  s_out += b * 8 * N;
  self_p += b * 2 * N;
  fields += b * 18 * RN;
  term += b * 3 * RN;
  acc_in += b * 3 * RN;
  acc_out += b * 3 * RN;

  float vax = s_in[0 * N + n], vay = s_in[1 * N + n], vaz = s_in[2 * N + n];
  float oax = s_in[3 * N + n], oay = s_in[4 * N + n], oaz = s_in[5 * N + n];
  const float ima = self_p[n];
  const float ia = self_p[N + n];

  for (int r = 0; r < n_rows; ++r) {
    const size_t o = static_cast<size_t>(r) * N + n;
    acc_out[o] = acc_in[o];
    acc_out[RN + o] = acc_in[RN + o];
    acc_out[2 * RN + o] = acc_in[2 * RN + o];
  }

  for (int it = 0; it < inner_iters; ++it) {
    float sx = 0.f, sy = 0.f, sz = 0.f;   // sum of row impulses
    float qx = 0.f, qy = 0.f, qz = 0.f;   // sum of ra x impulse
    for (int r = 0; r < n_rows; ++r) {
      const size_t o = static_cast<size_t>(r) * N + n;
      const float* f = fields + o;
      const float nx = f[0 * RN], ny = f[1 * RN], nz = f[2 * RN];
      const float t1x = f[3 * RN], t1y = f[4 * RN], t1z = f[5 * RN];
      const float t2x = f[6 * RN], t2y = f[7 * RN], t2z = f[8 * RN];
      const float rax = f[9 * RN], ray = f[10 * RN], raz = f[11 * RN];
      const float fric = f[12 * RN], bias = f[13 * RN], nm = f[14 * RN];
      const float tm1 = f[15 * RN], tm2 = f[16 * RN], valid = f[17 * RN];
      const float acc_n = acc_out[o];
      const float acc_t1 = acc_out[RN + o];
      const float acc_t2 = acc_out[2 * RN + o];

      // dv = frozen partner term - (va + wa x ra)
      const float dvx = term[o] - (vax + oay * raz - oaz * ray);
      const float dvy = term[RN + o] - (vay + oaz * rax - oax * raz);
      const float dvz = term[2 * RN + o] - (vaz + oax * ray - oay * rax);
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
      sx += ix;
      sy += iy;
      sz += iz;
      qx += ray * iz - raz * iy;
      qy += raz * ix - rax * iz;
      qz += rax * iy - ray * ix;
      if (valid > 0.f) {
        acc_out[o] = new_n;
        acc_out[RN + o] = new1;
        acc_out[2 * RN + o] = new2;
      }
    }
    // the body is side a: it receives -impulse
    vax += -sx * ima;
    vay += -sy * ima;
    vaz += -sz * ima;
    oax += -qx * ia;
    oay += -qy * ia;
    oaz += -qz * ia;
  }

  s_out[0 * N + n] = vax;
  s_out[1 * N + n] = vay;
  s_out[2 * N + n] = vaz;
  s_out[3 * N + n] = oax;
  s_out[4 * N + n] = oay;
  s_out[5 * N + n] = oaz;
  s_out[6 * N + n] = s_in[6 * N + n];
  s_out[7 * N + n] = s_in[7 * N + n];
}

}  // namespace

// Plain C entry point (bound with ctypes).  All tensors float32,
// contiguous, in blocks of `block` columns (n_cols = nb * block):
// s (nb, 8, block), fields (nb, 18, R, block), term (nb, 3, R, block),
// self_p (nb, 2, block), acc (nb, 3, R, block); block = n_cols is the
// (C, R, N) layout.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int mgf_solver_sweep(const void* s_in, const void* fields,
                                const void* term, const void* self_p,
                                const void* acc_in, void* s_out,
                                void* acc_out, int n_cols, int n_rows,
                                int inner_iters, int block, void* stream) {
  if (n_cols <= 0) return 0;
  if (block <= 0 || n_cols % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n_cols + threads - 1) / threads;
  solver_sweep_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s_in), static_cast<const float*>(fields),
      static_cast<const float*>(term), static_cast<const float*>(self_p),
      static_cast<const float*>(acc_in), static_cast<float*>(s_out),
      static_cast<float*>(acc_out), n_cols, n_rows, inner_iters, block);
  return static_cast<int>(cudaGetLastError());
}
