// The sphere step's "near" terrain stage in one pass per body, for Hopper
// (sm_90a): kernel K5.
//
// Replaces no TPU kernel.  mgf_tpu runs this stage as XLA fusions
// (mgf_tpu/world.py: the "near" cull, contact_triangle_moving_sphere,
// contact_neg and manifold.prune); its plain PyTorch version is ~1,200
// small operations a step.  For every body it does what
// ops/terrain.py::sphere_terrain_near_reference does:
//   1. the near cull: the squared distance from the body's centre to each
//      face's AABB, reach r + half_h + |delta| + 0.1, and the `cand`
//      nearest faces within reach (a stable descending sort of -d2 keeps
//      the lower face id on a tie, as lax.top_k does: both triangles of a
//      box face share one AABB);
//   2. with `stable`, the kept ids ascending, invalid slots last with id 0;
//   3. contact_triangle_moving_sphere (the plane test, the containment
//      test and three edge intersect_capsule sweeps), then contact_neg;
//   4. the local contact and prune at one slot and one kept contact,
//      compute_basis included, and the body's deepest penetration.
//
// What bounds it: memory.  A body reads 8 floats (32 B) and writes 16
// manifold floats, a valid byte and a face id per candidate, and one
// float: 3 * 69 + 4 = 211 B at the flagship's 3 candidates, 24.3 MB at
// 100k bodies, ~7.3 us at 3.35 TB/s; ~1,500 float operations a body at
// 10 faces (an FMA as two; chip_smoke.py's k5_bound counts them) are
// ~2.3 us at 67 TFLOP/s.  The design: one thread per body, every
// intermediate in registers, the running top-k in registers (compile-time
// indices only), the faces and everything that depends on a face alone
// (AABB, plane, the containment test's dot products, each edge's vector,
// end and squared length) computed once a block into shared memory; field
// f of slot s of body i is written at (f * cand + s) * N + i, so that
// neighbouring threads write neighbouring addresses.
//
// Rounding: the source is built with --fmad=false (ops/_build.py), so no
// multiply is contracted into an add unless written as __fmaf_rn, which
// stands exactly where the plain version calls collision._fma / _dot_fma
// (a float64 sum of float32 products there, which emulates that single
// rounding).  Division and sqrtf are IEEE (nvcc's default -prec-div and
// -prec-sqrt).  The comparisons keep torch's NaN semantics: min, max and
// clamp propagate NaN.  Everything is float32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

#define kInf __int_as_float(0x7f800000)

constexpr int kMaxFaces = 64;
constexpr int kMaxCand = 8;
constexpr float kEps = 1e-6f;          // math3d.COLLISION_EPSILON
constexpr int kInvalid = 1 << 28;      // world.py's sort key of an empty slot

// per-face record in shared memory
constexpr int kA = 0;                  // vertices a, b, c
constexpr int kLo = 9, kHi = 12;       // AABB
constexpr int kN = 15, kPd = 18;       // plane n, d
constexpr int kAb = 19, kAc = 22;      // b - a, c - a
constexpr int kD1 = 25, kD2 = 26, kD4 = 27, kDen = 28;  // containment dots
constexpr int kEdge = 29;              // 3 edges x [e(3) end(3) dd ee]
constexpr int kStride = kEdge + 3 * 8; // 53 floats

__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;              // NaN stays NaN
}
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}
__device__ __forceinline__ float safe_div(float num, float den) {
  return den != 0.f ? num / den : 0.f;
}
__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(clamp_min(x, 0.f));
}
// math3d.dot: (ax bx + ay by) + az bz, every operation rounded
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}
// collision._dot_fma: fma(az, bz, fma(ax, bx, ay * by))
__device__ __forceinline__ float dot_fma(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ax, bx, ay * by));
}

// the face record of vertices a, b, c (geom.plane_from_points,
// contains_triangle_pt's dots, each edge capsule's d = v2 - v1)
__device__ void stage_face(const float* tri, int T, int f, float* F) {
  float v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = tri[k * T + f];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[kA + k] = v[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    F[kLo + k] = tmin(tmin(v[k], v[3 + k]), v[6 + k]);
    F[kHi + k] = tmax(tmax(v[k], v[3 + k]), v[6 + k]);
  }
  const float abx = v[3] - v[0], aby = v[4] - v[1], abz = v[5] - v[2];
  const float acx = v[6] - v[0], acy = v[7] - v[1], acz = v[8] - v[2];
  const float cx = aby * acz - abz * acy;
  const float cy = abz * acx - abx * acz;
  const float cz = abx * acy - aby * acx;
  const float inv = 1.f / sqrtf(dot3(cx, cy, cz, cx, cy, cz));
  const float nx = cx * inv, ny = cy * inv, nz = cz * inv;
  F[kN] = nx;
  F[kN + 1] = ny;
  F[kN + 2] = nz;
  F[kPd] = dot3(nx, ny, nz, v[0], v[1], v[2]);
  F[kAb] = abx;
  F[kAb + 1] = aby;
  F[kAb + 2] = abz;
  F[kAc] = acx;
  F[kAc + 1] = acy;
  F[kAc + 2] = acz;
  const float d1 = dot3(acx, acy, acz, acx, acy, acz);
  const float d2 = dot3(acx, acy, acz, abx, aby, abz);
  const float d4 = dot3(abx, aby, abz, abx, aby, abz);
  F[kD1] = d1;
  F[kD2] = d2;
  F[kD4] = d4;
  F[kDen] = d1 * d4 - d2 * d2;
  // TRIANGLE_EDGES: (a, b), (b, c), (c, a)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* v1 = v + 3 * k;
    const float* v2 = v + 3 * ((k + 1) % 3);
    float* E = F + kEdge + 8 * k;
    const float ex = v2[0] - v1[0], ey = v2[1] - v1[1], ez = v2[2] - v1[2];
    E[0] = ex;
    E[1] = ey;
    E[2] = ez;
    E[3] = v1[0] + ex;
    E[4] = v1[1] + ey;
    E[5] = v1[2] + ez;
    E[6] = dot_fma(ex, ey, ez, ex, ey, ez);
    E[7] = dot3(ex, ey, ez, ex, ey, ez);
  }
}

struct Quad {
  float t;
  bool ok;
};

// intersect_capsule's sphere_quad
__device__ __forceinline__ Quad sphere_quad(float b, float c, float nn) {
  const float discr = __fmaf_rn(b, b, -(nn * c));
  Quad q;
  q.t = clamp_min(safe_div(-b - safe_sqrt(discr), nn), 0.f);
  q.ok = !((c > 0.f) && (b > 0.f)) && (discr >= 0.f) && (nn > 0.f);
  return q;
}

struct Hit {
  float px, py, pz, t;
  bool hit;
};

// collision.intersect_capsule(pos = p, d = v, dt = inf, Capsule(v1, e, r))
__device__ Hit intersect_capsule(float px, float py, float pz, float vx,
                                 float vy, float vz, float nn, float r,
                                 const float* v1, const float* E) {
  const float ex = E[0], ey = E[1], ez = E[2], dd = E[6];
  const float mx = px - v1[0], my = py - v1[1], mz = pz - v1[2];
  const float md = dot_fma(mx, my, mz, ex, ey, ez);
  const float nd = dot_fma(vx, vy, vz, ex, ey, ez);
  const float mn = dot_fma(mx, my, mz, vx, vy, vz);
  const float a = __fmaf_rn(dd, nn, -(nd * nd));
  const float k = __fmaf_rn(-r, r, dot_fma(mx, my, mz, mx, my, mz));

  // parallel path
  const float m2x = px - E[3], m2y = py - E[4], m2z = pz - E[5];
  const float k2 = __fmaf_rn(-r, r, dot_fma(m2x, m2y, m2z, m2x, m2y, m2z));
  const float b_m2 = dot_fma(m2x, m2y, m2z, vx, vy, vz);
  const float par_b = md < 0.f ? mn : b_m2;
  const float par_c = md < 0.f ? k : k2;
  const bool par_inside = (md >= 0.f) && (md <= dd);
  const Quad par = sphere_quad(par_b, par_c, nn);
  const bool par_ok = par.ok && !par_inside && (par.t <= kInf);

  // general path
  const float c_cyl = __fmaf_rn(dd, k, -(md * md));
  const float b_cyl = __fmaf_rn(dd, mn, -(nd * md));
  const float discr = __fmaf_rn(b_cyl, b_cyl, -(a * c_cyl));
  const float t_cyl = safe_div(-b_cyl - safe_sqrt(discr), a);
  const bool gen_ok = (discr >= 0.f) && (t_cyl >= 0.f);
  const float axial = __fmaf_rn(t_cyl, nd, md);
  Quad lo = sphere_quad(mn, k, nn);
  lo.ok = lo.ok && !((mn > 0.f) && (k > 0.f));
  const Quad hi = sphere_quad(b_m2, k2, nn);
  const float t_gen = axial < 0.f ? lo.t : (axial > dd ? hi.t : t_cyl);
  const bool ok_gen = gen_ok &&
                      (axial < 0.f ? lo.ok : (axial > dd ? hi.ok : true)) &&
                      (t_gen <= kInf);

  const bool parallel = fabsf(a) < kEps;
  Hit h;
  h.t = parallel ? par.t : t_gen;
  h.hit = parallel ? par_ok : ok_gen;
  h.px = __fmaf_rn(vx, h.t, px);
  h.py = __fmaf_rn(vy, h.t, py);
  h.pz = __fmaf_rn(vz, h.t, pz);
  return h;
}

struct TriContact {
  float ax, ay, az, bx, by, bz, t;   // normal: the face's plane normal
  bool valid;
};

// collision.contact_triangle_moving_sphere(face F, Sphere(p, r), v)
__device__ TriContact triangle_contact(const float* F, float px, float py,
                                       float pz, float vx, float vy,
                                       float vz, float r, float v2,
                                       float nn) {
  const float nx = F[kN], ny = F[kN + 1], nz = F[kN + 2], pd = F[kPd];
  // contact_plane_moving_sphere
  const float dist = dot3(nx, ny, nz, px, py, pz) - pd;
  const bool over = fabsf(dist) <= r;
  const float denom = dot3(nx, ny, nz, vx, vy, vz);
  const bool toward = denom * dist < 0.f;
  const float rs = dist > 0.f ? r : -r;
  const float ts = safe_div(rs - dist, denom);
  const float qx = (px + vx * ts) - nx * rs;
  const float qy = (py + vy * ts) - ny * rs;
  const float qz = (pz + vz * ts) - nz * rs;
  TriContact pc;
  pc.ax = over ? px - nx * dist : qx;
  pc.ay = over ? py - ny * dist : qy;
  pc.az = over ? pz - nz * dist : qz;
  pc.bx = over ? px - nx * r : qx;
  pc.by = over ? py - ny * r : qy;
  pc.bz = over ? pz - nz * r : qz;
  pc.t = over ? 0.f : ts;
  pc.valid = over || (toward && (ts <= 1.f));

  // contains_triangle_pt(face, pc.a)
  const float wx = pc.ax - F[kA], wy = pc.ay - F[kA + 1],
              wz = pc.az - F[kA + 2];
  const float d3 = dot3(F[kAc], F[kAc + 1], F[kAc + 2], wx, wy, wz);
  const float d5 = dot3(F[kAb], F[kAb + 1], F[kAb + 2], wx, wy, wz);
  const float d1 = F[kD1], d2 = F[kD2], d4 = F[kD4], den = F[kDen];
  const float u = safe_div(d4 * d3 - d2 * d5, den);
  const float w = safe_div(d1 * d5 - d2 * d3, den);
  const bool on_face = pc.valid && (u >= 0.f) && (w >= 0.f) && (u + w < 1.f);

  // the earliest edge hit
  const bool moving = v2 != 0.f;
  float first_t = kInf, tpx = 0.f, tpy = 0.f, tpz = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* v1 = F + kA + 3 * k;
    const float* E = F + kEdge + 8 * k;
    const Hit h = intersect_capsule(px, py, pz, vx, vy, vz, nn, r, v1, E);
    const bool better = h.hit && (h.t <= 1.f) && (h.t < first_t);
    // closest_pt_segment(Segment(v1, v2), h.p)
    const float tt = dot3(E[0], E[1], E[2], h.px - v1[0], h.py - v1[1],
                          h.pz - v1[2]);
    const float frac = clamp01(safe_div(tt, E[7]));
    if (better) {
      tpx = v1[0] + E[0] * frac;
      tpy = v1[1] + E[1] * frac;
      tpz = v1[2] + E[2] * frac;
      first_t = h.t;
    }
  }
  if (on_face) return pc;
  TriContact ce;
  ce.ax = ce.bx = tpx;
  ce.ay = ce.by = tpy;
  ce.az = ce.bz = tpz;
  ce.t = first_t;
  ce.valid = pc.valid && moving && (first_t < kInf);
  return ce;
}

__global__ void __launch_bounds__(128)
sphere_terrain_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ z, const float* __restrict__ dx,
                      const float* __restrict__ dy, const float* __restrict__ dz,
                      const float* __restrict__ rad,
                      const float* __restrict__ half_h,
                      const float* __restrict__ tri, int T, int cand,
                      int stable, int n, float* __restrict__ man,
                      unsigned char* __restrict__ valid_out,
                      int* __restrict__ tris_out, float* __restrict__ deep) {
  __shared__ float faces[kMaxFaces * kStride];
  for (int f = threadIdx.x; f < T; f += blockDim.x)
    stage_face(tri, T, f, faces + f * kStride);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = x[i], py = y[i], pz = z[i];
  const float vx = dx[i], vy = dy[i], vz = dz[i];
  const float r = rad[i];
  const float v2 = dot3(vx, vy, vz, vx, vy, vz);
  const float nn = dot_fma(vx, vy, vz, vx, vy, vz);
  const float reach = r + half_h[i] + sqrtf(v2) + 0.1f;
  const float reach2 = reach * reach;

  // 1. the near cull: the running top-`cand` by (d2, face id); d2 is
  // finite where it is kept (an infinite -d2 reads as no face)
  float kd[kMaxCand];
  int kid[kMaxCand];
#pragma unroll
  for (int j = 0; j < kMaxCand; ++j) {
    kd[j] = kInf;
    kid[j] = kInvalid;
  }
  for (int f = 0; f < T; ++f) {
    const float* F = faces + f * kStride;
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float p = k == 0 ? px : (k == 1 ? py : pz);
      const float d_ax = clamp_min(tmax(F[kLo + k] - p, p - F[kHi + k]), 0.f);
      d2 = d2 + d_ax * d_ax;
    }
    if (!(d2 <= reach2) || !(d2 < kInf)) continue;
    float cd = d2;
    int ci = f;
#pragma unroll
    for (int j = 0; j < kMaxCand; ++j) {
      // strictly nearer moves in; an equal distance keeps the lower id
      const bool take = j < cand && cd < kd[j];
      const float od = kd[j];
      const int oi = kid[j];
      kd[j] = take ? cd : od;
      kid[j] = take ? ci : oi;
      cd = take ? od : cd;
      ci = take ? oi : ci;
    }
  }
  // 2. stable_pairs: ids ascending, empty slots (kInvalid) last; the cull
  // keeps distinct faces, so world.py's duplicate drop removes nothing
  if (stable) {
#pragma unroll
    for (int p = 0; p < kMaxCand; ++p) {
#pragma unroll
      for (int j = (p & 1); j + 1 < kMaxCand; j += 2) {
        const int lo = min(kid[j], kid[j + 1]), hi = max(kid[j], kid[j + 1]);
        kid[j] = lo;
        kid[j + 1] = hi;
      }
    }
  }

  // 3-4. each slot's contact, local contact and one-slot manifold
  const size_t N = static_cast<size_t>(n);
  const size_t W = static_cast<size_t>(cand);
  float deepest = 0.f;
#pragma unroll 1
  for (int s = 0; s < cand; ++s) {
    int f = kInvalid;
#pragma unroll
    for (int j = 0; j < kMaxCand; ++j)
      if (j == s) f = kid[j];
    const bool ok = f != kInvalid;
    TriContact c;
    c.valid = false;
    c.t = 0.f;
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (ok) {
      const float* F = faces + f * kStride;
      c = triangle_contact(F, px, py, pz, vx, vy, vz, r, v2, nn);
      nx = F[kN];
      ny = F[kN + 1];
      nz = F[kN + 2];
    }
    // contact_neg: the body's point is the triangle contact's b, the
    // normal -n.  prune keeps it where valid (zeros elsewhere); the
    // averaged normal is (0 + n) * (1 / count)
    const bool v = c.valid;
    const float t = (v && isfinite(c.t)) ? c.t : 0.f;
    const float ax = v ? 0.f + -nx : 0.f;
    const float ay = v ? 0.f + -ny : 0.f;
    const float az = v ? 0.f + -nz : 0.f;
    float la[3] = {0.f, 0.f, 0.f}, lb[3] = {0.f, 0.f, 0.f};
    if (v) {
      la[0] = c.bx - (px + vx * c.t);
      la[1] = c.by - (py + vy * c.t);
      la[2] = c.bz - (pz + vz * c.t);
      lb[0] = c.ax - tri[9 * T + 0];
      lb[1] = c.ay - tri[9 * T + 1];
      lb[2] = c.az - tri[9 * T + 2];
      // deepest: dot(b - a, n) of the negated contact
      const float pen = dot3(c.ax - c.bx, c.ay - c.by, c.az - c.bz, -nx,
                             -ny, -nz);
      const float d = clamp_min(-pen, 0.f);
      if (!(deepest != deepest) && (d != d || d > deepest)) deepest = d;
    }
    // geom.compute_basis(avg normal)
    const bool use_x = fabsf(ax) >= 0.57735f;
    const float bx = use_x ? ay : 0.f;
    const float by = use_x ? -ax : az;
    const float bz = use_x ? 0.f : -ay;
    const float m2 = dot3(bx, by, bz, bx, by, bz);
    const float inv = m2 > 0.f ? 1.f / sqrtf(m2) : 0.f;
    const float t1x = bx * inv, t1y = by * inv, t1z = bz * inv;
    const float t2x = ay * t1z - az * t1y;
    const float t2y = az * t1x - ax * t1z;
    const float t2z = ax * t1y - ay * t1x;

    const float fields[16] = {t,   ax,  ay,  az,    t1x,   t1y,   t1z,   t2x,
                              t2y, t2z, la[0], la[1], la[2], lb[0], lb[1], lb[2]};
#pragma unroll
    for (int k = 0; k < 16; ++k) man[(k * W + s) * N + i] = fields[k];
    valid_out[s * N + i] = v ? 1 : 0;
    tris_out[s * N + i] = ok ? f : 0;
  }
  if (deep != nullptr) deep[i] = deepest;
}

}  // namespace

// Plain C entry point (bound with ctypes).  x, y, z, dx, dy, dz, r, half_h:
// (n,) float32; tri: the 9 * T components a.x a.y a.z b.x ... c.z (each
// (T,)) and the terrain centre's 3; outputs man (16, cand, n) float32
// [time normal t1 t2 local_a local_b], valid (cand, n) bytes (0 / 1),
// tris (cand, n) int32 and, unless null, deep (n,) float32.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
extern "C" int mgf_sphere_terrain(const void* x, const void* y, const void* z,
                                  const void* dx, const void* dy,
                                  const void* dz, const void* r,
                                  const void* half_h, const void* tri, int T,
                                  int cand, int stable, int n, void* man,
                                  void* valid, void* tris, void* deep,
                                  void* stream) {
  if (T < 1 || T > kMaxFaces || cand < 1 || cand > kMaxCand || cand > T)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  sphere_terrain_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<const float*>(dz),
      static_cast<const float*>(r), static_cast<const float*>(half_h),
      static_cast<const float*>(tri), T, cand, stable, n,
      static_cast<float*>(man), static_cast<unsigned char*>(valid),
      static_cast<int*>(tris), static_cast<float*>(deep));
  return static_cast<int>(cudaGetLastError());
}
