// Fused 3D projection-step kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels carry the 3D lid-driven cavity step of the PyTorch port
// (navierstokessolver_tpu_torch/ops/fused3d.py binds them with ctypes):
//
//   nss_predictor_rhs_3d  replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                         _fused_pred_kernel (Euler form, WALL and PERIODIC
//                         faces, no obstacle, no forcing): u* for all three
//                         components, the BC values on the boundary faces, and
//                         the Poisson RHS (rho/dt) div u*, in one pass.
//   nss_correct_diag_3d   replaces pallas_kernels.py _fused_corr_kernel:
//                         u = u* - scale grad p on interior faces, boundary
//                         faces copied from u*, plus max|div u| and
//                         max_a max|u_a|/h_a.
//   nss_residual_3d       replaces pallas_kernels.py _residual3d_kernel:
//                         r = (b - A p) * fluid, A decoded from the uint8
//                         stencil code (bits 0-5 neighbor couplings, bit 6
//                         fluid) and w_a = 1/h_a^2.
//
// Periodic axes: every kernel is a template on PER, bit a set when axis a is
// periodic (both faces PERIODIC, an even extent); the entry points pick the
// instantiation of the mask they are given, so the all-wall kernels (PER = 0)
// carry none of the wrap branches. Along such an axis a component's own
// faces 0..n-1 are distinct unknowns updated with wrap neighbors, face n
// repeats face 0 (the kernels read face 0 where they would read face n), the
// tangential ghosts are the opposite edge, and the corrector's and the
// residual's neighbors wrap; the TPU kernel's halo slots and post-kernel
// fixups for the wrap have no counterpart here.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32.
// u0 is (n0+1, n1, n2), u1 (n0, n1+1, n2), u2 (n0, n1, n2+1); cell fields are
// (n0, n1, n2). None of the TPU kernel's 128-lane padding, stripe windows or
// lane-elided faces carries over.
//
// Halo mode (the slab-sharded step, parallel/fused_sharded.py; the TPU
// kernels' halo=True): the predictor and the corrector are also templates on
// HALO, bit 0 set when the low side of axis 0 borders another slab, bit 1 the
// high side. The slab's n0 = b rows come with ghost rows at the same strides:
// the pointers are those of data row 0, row -1 is the low ghost and rows b,
// b+1 the high ones (u0's row b is the face shared with the next slab). On a
// halo side the kernels read the ghost rows where they would otherwise take
// a wall value: the tangential neighbours and the cell-pair averages across
// the side, u0's own-axis neighbours, u0 at face 0 or b as an interior face
// (u* recomputed in registers, p's ghost row in the correction), and they
// write nothing there: the shared face's u* and u belong to the next slab
// (its face 0), which also counts them in its diagnostics. A side that is a
// domain wall (the first or last slab of a bounded axis) is treated exactly
// as in the unsharded kernels; a ring's sharded axis is never periodic in
// PER, both its sides are halo sides. HALO = 0 is the unsharded instantiation.
//
// What bounds them on this card: all three are memory-bound stencils. Per
// cell the predictor must read 3 and write 4 float32 values (28 B), the
// corrector read 4 and write 3 (28 B), the residual read 3 float32 and one
// byte and write one float32 (17 B); at 256^3 that is about 0.47, 0.47 and
// 0.29 GB per call against the H100's 3.35 TB/s. The design answers that
// only with coalescing and caching: one thread per cell, consecutive threads
// on consecutive cells of the fastest axis, and every neighbor value re-read
// through L1/L2 rather than staged by hand. The predictor recomputes in
// registers the u* of each cell's three high faces (the overlap-recompute the
// TPU kernel does per stripe), so u* never makes a round trip through device
// memory before the divergence. Shared-memory tiling, TMA and fewer
// divisions are work for later changes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::abs_bits;
using nss::block_max_to;
using nss::blocks_for;
using nss::Grid3;
using nss::kThreads;
using nss::lin;
using nss::unflatten;

__host__ __device__ constexpr bool periodic(int per, int axis) {
  return (per >> axis) & 1;
}

// the low / high side of `axis` borders another slab (only axis 0 does)
__host__ __device__ constexpr bool halo_lo(int halo, int axis) {
  return axis == 0 && (halo & 1);
}
__host__ __device__ constexpr bool halo_hi(int halo, int axis) {
  return axis == 0 && (halo & 2);
}

// the instantiations of a kernel template for every periodic mask 0..7
#define NSS_PER_TABLE(k) {k<0>, k<1>, k<2>, k<3>, k<4>, k<5>, k<6>, k<7>}
// ... with no halo side (the unsharded kernels) ...
#define NSS_UNSHARDED_TABLE(k) \
  {k<0, 0>, k<0, 1>, k<0, 2>, k<0, 3>, k<0, 4>, k<0, 5>, k<0, 6>, k<0, 7>}
// ... and for halo masks 1..3 with the periodic masks that leave axis 0
// bounded (0, 2, 4, 6: a halo side is never on a periodic axis 0),
// indexed [halo - 1][per >> 1]
#define NSS_HALO_ROW(k, h) {k<h, 0>, k<h, 2>, k<h, 4>, k<h, 6>}
#define NSS_HALO_TABLE(k) \
  {NSS_HALO_ROW(k, 1), NSS_HALO_ROW(k, 2), NSS_HALO_ROW(k, 3)}

struct PredParams {
  const float* u[3];
  const float* bc;  // wall value [(axis*2 + side)*3 + comp]
  Grid3 g;
  float h[3];       // h_a
  float two_h[3];   // 2 h_a
  float hh[3];      // h_a^2
  float dt, nu, gamma, one_minus_gamma;
};

// u* of component A at its interior face x (1 <= x[A] <= n_A - 1; every
// face 0..n_A-1 on a periodic A), in the arithmetic order of
// ops/stencils.predictor: advective-form central differences blended with
// donor-cell upwinding, plus the viscous Laplacian, one explicit Euler step.
// Tangential neighbors beyond a wall are the reflection ghosts
// 2*u_wall - edge, across a periodic axis the opposite edge; along A every
// neighbor is in the array, or wraps on a periodic A. Across a halo side
// every neighbor is in the ghost rows.
template <int A, int PER, int HALO>
__device__ __forceinline__ float ustar_face(const PredParams& P, const int x[3]) {
  const Grid3& g = P.g;
  const float* ua = P.u[A];
  const float c = ua[lin(g, A, x[0], x[1], x[2])];
  float adv = 0.f;
  float lap = 0.f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    int xm[3] = {x[0], x[1], x[2]};
    int xp[3] = {x[0], x[1], x[2]};
    const bool wrap = periodic(PER, ax);
    xm[ax] -= 1;
    xp[ax] += 1;
    // the wrap neighbors of a periodic axis (along A: face n repeats face 0)
    if (wrap && xm[ax] < 0) xm[ax] = g.n[ax] - 1;
    if (wrap && xp[ax] == g.n[ax]) xp[ax] = 0;
    float um, up, vel;
    if (ax == A) {
      um = ua[lin(g, A, xm[0], xm[1], xm[2])];
      up = ua[lin(g, A, xp[0], xp[1], xp[2])];
      vel = c;
    } else {
      um = (x[ax] == 0 && !wrap && !halo_lo(HALO, ax))
               ? 2.f * P.bc[(ax * 2 + 0) * 3 + A] - c
               : ua[lin(g, A, xm[0], xm[1], xm[2])];
      up = (x[ax] == g.n[ax] - 1 && !wrap && !halo_hi(HALO, ax))
               ? 2.f * P.bc[(ax * 2 + 1) * 3 + A] - c
               : ua[lin(g, A, xp[0], xp[1], xp[2])];
      // component ax averaged onto this face: cell pair (x[A]-1, x[A])
      // along A (wrapping at face 0 of a periodic A), then face pair
      // (x[ax], x[ax]+1) along ax
      const float* ut = P.u[ax];
      int q[3] = {x[0], x[1], x[2]};
      q[A] = (periodic(PER, A) && x[A] == 0) ? g.n[A] - 1 : x[A] - 1;
      const float a00 = ut[lin(g, ax, q[0], q[1], q[2])];
      q[ax] += 1;
      const float a01 = ut[lin(g, ax, q[0], q[1], q[2])];
      q[A] = x[A];
      const float a11 = ut[lin(g, ax, q[0], q[1], q[2])];
      q[ax] -= 1;
      const float a10 = ut[lin(g, ax, q[0], q[1], q[2])];
      const float m0 = 0.5f * (a00 + a10);
      const float m1 = 0.5f * (a01 + a11);
      vel = 0.5f * (m0 + m1);
    }
    const float central = (up - um) / P.two_h[ax];
    float d;
    if (P.gamma > 0.f) {
      const float fwd = (up - c) / P.h[ax];
      const float bwd = (c - um) / P.h[ax];
      // zero velocity takes fwd, as jnp.where(vel > 0, bwd, fwd) does
      const float upw = (vel > 0.f) ? bwd : fwd;
      d = P.gamma * upw + P.one_minus_gamma * central;
    } else {
      d = central;
    }
    adv = adv + vel * d;
    lap = lap + (up - 2.f * c + um) / P.hh[ax];
  }
  const float rhs = -adv + P.nu * lap;
  return c + P.dt * rhs;
}

// u* at the face of component A with face index f along A (the cell's low
// face for f = x[A], high face for f = x[A] + 1): the wall value on a
// boundary face, the predictor elsewhere; on a periodic A face n is face 0;
// faces 0 and n on a halo side are interior faces.
template <int A, int PER, int HALO>
__device__ __forceinline__ float ustar_at(const PredParams& P, const int x[3],
                                          int f) {
  if (periodic(PER, A)) {
    if (f == P.g.n[A]) f = 0;
  } else {
    if (f == 0 && !halo_lo(HALO, A)) return P.bc[(A * 2 + 0) * 3 + A];
    if (f == P.g.n[A] && !halo_hi(HALO, A)) return P.bc[(A * 2 + 1) * 3 + A];
  }
  int y[3] = {x[0], x[1], x[2]};
  y[A] = f;
  return ustar_face<A, PER, HALO>(P, y);
}

template <int HALO, int PER>
__global__ void __launch_bounds__(kThreads)
predictor_rhs_kernel(PredParams P, float* __restrict__ o0,
                     float* __restrict__ o1, float* __restrict__ o2,
                     float* __restrict__ rhs, float rho_over_dt) {
  const Grid3& g = P.g;
  const long long ncell = (long long)g.n[0] * g.n[1] * g.n[2];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  int x[3];
  unflatten(g, idx, x);
  const float lo0 = ustar_at<0, PER, HALO>(P, x, x[0]);
  const float hi0 = ustar_at<0, PER, HALO>(P, x, x[0] + 1);
  const float lo1 = ustar_at<1, PER, HALO>(P, x, x[1]);
  const float hi1 = ustar_at<1, PER, HALO>(P, x, x[1] + 1);
  const float lo2 = ustar_at<2, PER, HALO>(P, x, x[2]);
  const float hi2 = ustar_at<2, PER, HALO>(P, x, x[2] + 1);
  // each cell owns its three low faces; the last cell along an axis also
  // writes the high boundary face (not the face shared with the next slab)
  o0[lin(g, 0, x[0], x[1], x[2])] = lo0;
  o1[lin(g, 1, x[0], x[1], x[2])] = lo1;
  o2[lin(g, 2, x[0], x[1], x[2])] = lo2;
  if (x[0] == g.n[0] - 1 && !halo_hi(HALO, 0)) o0[lin(g, 0, x[0] + 1, x[1], x[2])] = hi0;
  if (x[1] == g.n[1] - 1) o1[lin(g, 1, x[0], x[1] + 1, x[2])] = hi1;
  if (x[2] == g.n[2] - 1) o2[lin(g, 2, x[0], x[1], x[2] + 1)] = hi2;
  const float div =
      (hi0 - lo0) / P.h[0] + (hi1 - lo1) / P.h[1] + (hi2 - lo2) / P.h[2];
  rhs[idx] = div * rho_over_dt;
}

struct CorrParams {
  const float* us[3];
  const float* p;
  Grid3 g;
  float h[3];
  float scale;  // dt / rho
};

// Corrected velocity of component A at face index f along A for the cell x:
// boundary faces keep u*, interior faces take u* - scale * dp/dx_A. On a
// periodic A every face is corrected, face 0 with the wrap gradient
// p[0] - p[n-1], and face n repeats face 0. On a halo side faces 0 and n
// are interior, their outer p in the ghost row.
template <int A, int PER, int HALO>
__device__ __forceinline__ float corrected_at(const CorrParams& C,
                                              const int x[3], int f) {
  const Grid3& g = C.g;
  constexpr bool wrap = periodic(PER, A);
  if (wrap && f == g.n[A]) f = 0;
  int y[3] = {x[0], x[1], x[2]};
  y[A] = f;
  const float s = C.us[A][lin(g, A, y[0], y[1], y[2])];
  if (!wrap && ((f == 0 && !halo_lo(HALO, A)) ||
                (f == g.n[A] && !halo_hi(HALO, A)))) {
    return s;
  }
  const float p_hi = C.p[lin(g, 3, y[0], y[1], y[2])];
  y[A] = (wrap && f == 0) ? g.n[A] - 1 : f - 1;
  const float p_lo = C.p[lin(g, 3, y[0], y[1], y[2])];
  const float grad = (p_hi - p_lo) / C.h[A];
  return s + (-C.scale) * grad;
}

template <int HALO, int PER>
__global__ void __launch_bounds__(kThreads)
correct_diag_kernel(CorrParams C, float* __restrict__ o0,
                    float* __restrict__ o1, float* __restrict__ o2,
                    int* __restrict__ maxes) {
  const Grid3& g = C.g;
  const long long ncell = (long long)g.n[0] * g.n[1] * g.n[2];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int div_bits = 0;
  int vel_bits = 0;
  if (idx < ncell) {
    int x[3];
    unflatten(g, idx, x);
    const float lo0 = corrected_at<0, PER, HALO>(C, x, x[0]);
    const float hi0 = corrected_at<0, PER, HALO>(C, x, x[0] + 1);
    const float lo1 = corrected_at<1, PER, HALO>(C, x, x[1]);
    const float hi1 = corrected_at<1, PER, HALO>(C, x, x[1] + 1);
    const float lo2 = corrected_at<2, PER, HALO>(C, x, x[2]);
    const float hi2 = corrected_at<2, PER, HALO>(C, x, x[2] + 1);
    o0[lin(g, 0, x[0], x[1], x[2])] = lo0;
    o1[lin(g, 1, x[0], x[1], x[2])] = lo1;
    o2[lin(g, 2, x[0], x[1], x[2])] = lo2;
    vel_bits = max(abs_bits(lo0 / C.h[0]),
                   max(abs_bits(lo1 / C.h[1]), abs_bits(lo2 / C.h[2])));
    if (x[0] == g.n[0] - 1 && !halo_hi(HALO, 0)) {
      o0[lin(g, 0, x[0] + 1, x[1], x[2])] = hi0;
      vel_bits = max(vel_bits, abs_bits(hi0 / C.h[0]));
    }
    if (x[1] == g.n[1] - 1) {
      o1[lin(g, 1, x[0], x[1] + 1, x[2])] = hi1;
      vel_bits = max(vel_bits, abs_bits(hi1 / C.h[1]));
    }
    if (x[2] == g.n[2] - 1) {
      o2[lin(g, 2, x[0], x[1], x[2] + 1)] = hi2;
      vel_bits = max(vel_bits, abs_bits(hi2 / C.h[2]));
    }
    // every cell of the ported slice is fluid (no obstacle masks yet)
    const float div =
        (hi0 - lo0) / C.h[0] + (hi1 - lo1) / C.h[1] + (hi2 - lo2) / C.h[2];
    div_bits = abs_bits(div);
  }
  block_max_to(div_bits, maxes + 0);
  block_max_to(vel_bits, maxes + 1);
}

// p at the neighbor of cell idx (coordinate xa along an axis of extent n and
// stride s) on side `hi`, when the stencil code has its coupling: in the
// array, or across a periodic axis the opposite edge; 0 otherwise. The
// index test keeps a malformed code from reading outside the array.
__device__ __forceinline__ float neighbor(const float* __restrict__ p,
                                          long long idx, bool coupled,
                                          int xa, int n, long long s, bool hi,
                                          bool wrap) {
  if (!coupled) return 0.f;
  if (hi) {
    if (xa < n - 1) return p[idx + s];
    return wrap ? p[idx - (long long)(n - 1) * s] : 0.f;
  }
  if (xa > 0) return p[idx - s];
  return wrap ? p[idx + (long long)(n - 1) * s] : 0.f;
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ p, const float* __restrict__ b,
                const float* __restrict__ diag,
                const uint8_t* __restrict__ code, float* __restrict__ out,
                Grid3 g, float w0, float w1, float w2) {
  const long long ncell = (long long)g.n[0] * g.n[1] * g.n[2];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  int x[3];
  unflatten(g, idx, x);
  const long long s0 = (long long)g.n[1] * g.n[2];
  const long long s1 = g.n[2];
  const int c = code[idx];
  // a neighbor counts only where its presence bit is set; the bit is clear
  // beyond every wall and set across a periodic axis
  constexpr bool p0 = periodic(PER, 0), p1 = periodic(PER, 1),
                 p2 = periodic(PER, 2);
  const float l0 = neighbor(p, idx, c & 1, x[0], g.n[0], s0, false, p0);
  const float r0 = neighbor(p, idx, c & 2, x[0], g.n[0], s0, true, p0);
  const float l1 = neighbor(p, idx, c & 4, x[1], g.n[1], s1, false, p1);
  const float r1 = neighbor(p, idx, c & 8, x[1], g.n[1], s1, true, p1);
  const float l2 = neighbor(p, idx, c & 16, x[2], g.n[2], 1, false, p2);
  const float r2 = neighbor(p, idx, c & 32, x[2], g.n[2], 1, true, p2);
  const float nb = w0 * (l0 + r0) + w1 * (l1 + r1) + w2 * (l2 + r2);
  const float ap = diag[idx] * p[idx] + nb;
  const float fluid = (float)((c >> 6) & 1);
  out[idx] = (b[idx] - ap) * fluid;
}

using PredKernel = void (*)(PredParams, float*, float*, float*, float*,
                            float);
using CorrKernel = void (*)(CorrParams, float*, float*, float*, int*);
using ResidKernel = void (*)(const float*, const float*, const float*,
                             const uint8_t*, float*, Grid3, float, float,
                             float);
const PredKernel kPredictor[8] = NSS_UNSHARDED_TABLE(predictor_rhs_kernel);
const PredKernel kPredictorHalo[3][4] = NSS_HALO_TABLE(predictor_rhs_kernel);
const CorrKernel kCorrector[8] = NSS_UNSHARDED_TABLE(correct_diag_kernel);
const CorrKernel kCorrectorHalo[3][4] = NSS_HALO_TABLE(correct_diag_kernel);
const ResidKernel kResidual[8] = NSS_PER_TABLE(residual_kernel);

bool valid_masks(int per, int halo) {
  return per >= 0 && per <= 7 && halo >= 0 && halo <= 3 &&
         !(halo != 0 && periodic(per, 0));
}

// the instantiation for (halo, per), which valid_masks has accepted
template <typename K>
K pick(const K (&unsharded)[8], const K (&halo_tab)[3][4], int halo, int per) {
  return halo == 0 ? unsharded[per] : halo_tab[halo - 1][per >> 1];
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// periodic mask outside 0..7, a halo mask outside 0..3, or a halo side on a
// periodic axis 0.

int nss_predictor_rhs_3d(const float* u0, const float* u1, const float* u2,
                         float* o0, float* o1, float* o2, float* rhs,
                         const float* bc, int n0, int n1, int n2, float h0,
                         float h1, float h2, float two_h0, float two_h1,
                         float two_h2, float hh0, float hh1, float hh2,
                         float dt, float nu, float gamma,
                         float one_minus_gamma, float rho_over_dt, int per,
                         int halo, void* stream) {
  PredParams P;
  P.u[0] = u0;
  P.u[1] = u1;
  P.u[2] = u2;
  P.bc = bc;
  P.g.n[0] = n0;
  P.g.n[1] = n1;
  P.g.n[2] = n2;
  P.h[0] = h0;
  P.h[1] = h1;
  P.h[2] = h2;
  P.two_h[0] = two_h0;
  P.two_h[1] = two_h1;
  P.two_h[2] = two_h2;
  P.hh[0] = hh0;
  P.hh[1] = hh1;
  P.hh[2] = hh2;
  P.dt = dt;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  if (!valid_masks(per, halo)) return (int)cudaErrorInvalidValue;
  const long long ncell = (long long)n0 * n1 * n2;
  const PredKernel k = pick(kPredictor, kPredictorHalo, halo, per);
  k<<<blocks_for(ncell), kThreads, 0, (cudaStream_t)stream>>>(
      P, o0, o1, o2, rhs, rho_over_dt);
  return (int)cudaGetLastError();
}

int nss_correct_diag_3d(const float* s0, const float* s1, const float* s2,
                        const float* p, float* o0, float* o1, float* o2,
                        int* maxes, int n0, int n1, int n2, float h0, float h1,
                        float h2, float scale, int per, int halo,
                        void* stream) {
  CorrParams C;
  C.us[0] = s0;
  C.us[1] = s1;
  C.us[2] = s2;
  C.p = p;
  C.g.n[0] = n0;
  C.g.n[1] = n1;
  C.g.n[2] = n2;
  C.h[0] = h0;
  C.h[1] = h1;
  C.h[2] = h2;
  C.scale = scale;
  if (!valid_masks(per, halo)) return (int)cudaErrorInvalidValue;
  const long long ncell = (long long)n0 * n1 * n2;
  const CorrKernel k = pick(kCorrector, kCorrectorHalo, halo, per);
  k<<<blocks_for(ncell), kThreads, 0, (cudaStream_t)stream>>>(
      C, o0, o1, o2, maxes);
  return (int)cudaGetLastError();
}

int nss_residual_3d(const float* p, const float* b, const float* diag,
                    const uint8_t* code, float* out, int n0, int n1, int n2,
                    float w0, float w1, float w2, int per, void* stream) {
  Grid3 g;
  g.n[0] = n0;
  g.n[1] = n1;
  g.n[2] = n2;
  if (per < 0 || per > 7) return (int)cudaErrorInvalidValue;
  const long long ncell = (long long)n0 * n1 * n2;
  kResidual[per]<<<blocks_for(ncell), kThreads, 0, (cudaStream_t)stream>>>(
      p, b, diag, code, out, g, w0, w1, w2);
  return (int)cudaGetLastError();
}

}  // extern "C"
