// Continuous sphere x moving-sphere contact for a batch of pairs, for
// Hopper (sm_90a).
//
// Replaces mgf_tpu/ops/narrowphase.py::sphere_contact_pairs, the Pallas TPU
// kernel (body _kernel): the math of contact_sphere_moving_sphere with the
// relative-velocity reduction and the va * t advection of
// contact_moving_moving (collision.rs:1089-1141 + 1387-1401).
//
// What bounds it: memory.  Every pair reads seven floats of each of two
// 8-float columns [x y z dx dy dz r _] (row 7 is not read) and writes
// [ca cb t valid] (8 floats) and n (3 floats): 100 bytes per pair against
// ~170 flops.  At the cold 100k pile's 900,000 pairs that is 90 MB, about
// 0.027 ms at the H100's 3.35 TB/s.  The design: one thread per pair, every
// operand in registers, component k of pair i at k * P + i so that
// neighbouring threads touch neighbouring addresses (each of the 25 loads
// and stores of a warp is one coalesced 128-byte line); the ragged edge is
// masked here, so callers need none of the TPU path's padding to 4096.
//
// Semantics match _kernel op for op, float masks included:
// sel(m, t, f) = m * t + (1 - m) * f turns an inf in the branch not taken
// into NaN, so the clamps that keep both branches finite stay
// (max(len2, 1e-30), max(v2, 1e-30), max(a_q, 1e-30), max(e2, 1e-30)).
// Every product that decides `valid` (len2, r * r, v2, b_q, disc) is an
// __fmul_rn, which the compiler never contracts into a multiply-add, so
// those quantities and t round as the plain PyTorch version rounds them
// and `valid` agrees exactly.  The rest may contract, and rsqrtf is
// approximate (as XLA's rsqrt is); they touch only the normals and the
// witness points.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sel(float m, float t, float f) {
  return m * t + (1.f - m) * f;
}

__device__ __forceinline__ float mask(bool c) { return c ? 1.f : 0.f; }

// a.b with round-to-nearest products that are never contracted
__device__ __forceinline__ float dot_rn(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  return __fmul_rn(ax, bx) + __fmul_rn(ay, by) + __fmul_rn(az, bz);
}

__global__ void sphere_contact_kernel(const float* __restrict__ ga,
                                      const float* __restrict__ gb,
                                      float* __restrict__ o1,
                                      float* __restrict__ o2, int n_pairs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const size_t P = static_cast<size_t>(n_pairs);

  const float ax = ga[0 * P + i], ay = ga[1 * P + i], az = ga[2 * P + i];
  const float vax = ga[3 * P + i], vay = ga[4 * P + i], vaz = ga[5 * P + i];
  const float r1 = ga[6 * P + i];
  const float bx = gb[0 * P + i], by = gb[1 * P + i], bz = gb[2 * P + i];
  const float r2 = gb[6 * P + i];
  const float vx = gb[3 * P + i] - vax;
  const float vy = gb[4 * P + i] - vay;
  const float vz = gb[5 * P + i] - vaz;

  const float r = r1 + r2;
  const float dx = bx - ax, dy = by - ay, dz = bz - az;
  const float len2 = dot_rn(dx, dy, dz, dx, dy, dz);
  const float v2 = dot_rn(vx, vy, vz, vx, vy, vz);
  const float rr = __fmul_rn(r, r);
  const float m_over = mask(len2 <= rr);
  const float m_len0 = mask(len2 == 0.f);
  const float m_vok = mask(v2 != 0.f);

  const float inv_len = rsqrtf(fmaxf(len2, 1e-30f));
  const float inv_v = rsqrtf(fmaxf(v2, 1e-30f));
  // overlap normal: d/|d|, or -v/|v| when coincident
  const float nox = sel(m_len0, -vx * inv_v, dx * inv_len);
  const float noy = sel(m_len0, -vy * inv_v, dy * inv_len);
  const float noz = sel(m_len0, -vz * inv_v, dz * inv_len);
  const float oax = ax + nox * r1, oay = ay + noy * r1, oaz = az + noz * r1;
  const float obx = bx - nox * r2, oby = by - noy * r2, obz = bz - noz * r2;
  const float over_valid = sel(m_len0, m_vok, 1.f);

  // sweep: ray from a along -v vs sphere(b, r) (intersect_sphere)
  const float mx = ax - bx, my = ay - by, mz = az - bz;
  const float a_q = v2;
  const float b_q = -dot_rn(mx, my, mz, vx, vy, vz);
  const float c_q = len2 - rr;
  const float disc = __fmul_rn(b_q, b_q) - __fmul_rn(a_q, c_q);
  const float sdisc = sqrtf(fmaxf(disc, 0.f));
  const float t = fmaxf((-b_q - sdisc) / fmaxf(a_q, 1e-30f), 0.f);
  const float hit = mask(disc >= 0.f) * mask(a_q > 0.f) * mask(t <= 1.f) *
                    (1.f - mask(c_q > 0.f) * mask(b_q > 0.f));
  const float ex = bx + vx * t - ax;
  const float ey = by + vy * t - ay;
  const float ez = bz + vz * t - az;
  const float e2 = ex * ex + ey * ey + ez * ez;
  const float inv_e = rsqrtf(fmaxf(e2, 1e-30f));
  const float nsx = ex * inv_e, nsy = ey * inv_e, nsz = ez * inv_e;
  const float sax = ax + nsx * r1, say = ay + nsy * r1, saz = az + nsz * r1;

  // select overlap vs sweep, then advect by va * t
  const float t_out = sel(m_over, 0.f, t);
  const float valid = sel(m_over, over_valid, m_vok * hit);
  o1[0 * P + i] = sel(m_over, oax, sax) + vax * t_out;
  o1[1 * P + i] = sel(m_over, oay, say) + vay * t_out;
  o1[2 * P + i] = sel(m_over, oaz, saz) + vaz * t_out;
  o1[3 * P + i] = sel(m_over, obx, sax) + vax * t_out;
  o1[4 * P + i] = sel(m_over, oby, say) + vay * t_out;
  o1[5 * P + i] = sel(m_over, obz, saz) + vaz * t_out;
  o1[6 * P + i] = t_out;
  o1[7 * P + i] = valid;
  o2[0 * P + i] = sel(m_over, nox, nsx);
  o2[1 * P + i] = sel(m_over, noy, nsy);
  o2[2 * P + i] = sel(m_over, noz, nsz);
}

}  // namespace

// Plain C entry point (bound with ctypes).  ga, gb: (8, P) float32,
// contiguous; o1: (8, P) and o2: (3, P) float32 outputs.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success); it does not
// synchronise.
extern "C" int mgf_sphere_contact(const void* ga, const void* gb, void* o1,
                                  void* o2, int n_pairs, void* stream) {
  if (n_pairs <= 0) return 0;
  const int threads = 256;
  const int blocks = (n_pairs + threads - 1) / threads;
  sphere_contact_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ga), static_cast<const float*>(gb),
      static_cast<float*>(o1), static_cast<float*>(o2), n_pairs);
  return static_cast<int>(cudaGetLastError());
}
