// Fused 2D projection-step kernels for Hopper (sm_90a), plain C interface.
//
// Two kernels carry the 2D lid-driven cavity step of the PyTorch port
// (navierstokessolver_tpu_torch/ops/fused2d.py binds them with ctypes):
//
//   nss_predictor_rhs_2d  replaces navierstokessolver_tpu/ops/pallas_2d.py
//                         _pred2d_kernel (Euler form, WALL faces, no
//                         obstacle, no forcing, no buoyancy): u* and v*, the
//                         BC values on the boundary faces, and the Poisson
//                         RHS (rho/dt) div u*, in one pass.
//   nss_correct_diag_2d   replaces pallas_2d.py _corr2d_kernel:
//                         u = u* - scale grad p on interior faces, boundary
//                         faces copied from u*, plus max|div u| and
//                         max_a max|u_a|/h_a.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32:
// u is (n0+1, n1), v is (n0, n1+1), cell fields are (n0, n1). None of the
// TPU kernel's row padding to (G+1) T, 128-lane padding or elided v face
// carries over: v's face n1 is read from the array (it holds its BC value,
// which the predictor writes) where the TPU kernel rebuilt it.
//
// Arithmetic follows the Pallas kernel's order, not ops/stencils': the
// spacings enter as multiplies by 1/h, 1/(2h) and 1/h^2 rounded to float32
// (the wrapper passes them), the transverse velocity is
// 0.25 (((a + b) + c) + d) over the four faces around the face, and the
// update is u + dt (nu lap - (u d0 + vbar d1)). jnp.where(vel > 0, bwd, fwd)
// is kept exactly: zero velocity takes fwd.
//
// What bounds them on this card: both are memory-bound stencils. Per cell
// the predictor must read 2 and write 3 float32 values (20 B), the
// corrector read 3 and write 2 (20 B); at 2048^2 that is 84 MB per call, 25
// us at the H100's 3.35 TB/s. The design answers that only with coalescing
// and caching: one thread per cell, consecutive threads on consecutive cells
// of axis 1, every neighbor value re-read through L1/L2 rather than staged
// by hand. The predictor recomputes in registers the u* of each cell's two
// high faces, so u* never makes a round trip through device memory before
// the divergence. Shared-memory tiles and TMA are work for later changes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::abs_bits;
using nss::block_max_to;
using nss::blocks_for;
using nss::kThreads;

// wall value of component c on face (axis a, side s) in the bc buffer
__host__ __device__ constexpr int bc_at(int a, int s, int c) {
  return (a * 2 + s) * 2 + c;
}

struct Pred2 {
  const float* u;   // (n0+1, n1)
  const float* v;   // (n0, n1+1)
  const float* bc;  // wall values, bc_at(axis, side, comp)
  int n0, n1;
  float inv_h[2];   // 1/h_a
  float inv_2h[2];  // 1/(2 h_a)
  float inv_hh[2];  // 1/h_a^2
  float dt, nu, gamma, one_minus_gamma;
};

__device__ __forceinline__ float ld_u(const Pred2& P, int i, int j) {
  return P.u[(long long)i * P.n1 + j];
}

__device__ __forceinline__ float ld_v(const Pred2& P, int i, int j) {
  return P.v[(long long)i * (P.n1 + 1) + j];
}

// u* at the interior u face (i, j), 1 <= i <= n0-1. Across an axis-1 wall
// the tangential ghost is -edge + 2 u_wall.
__device__ __forceinline__ float ustar(const Pred2& P, int i, int j) {
  const float uc = ld_u(P, i, j);
  const float u_e = ld_u(P, i + 1, j);
  const float u_w = ld_u(P, i - 1, j);
  const float u_n = (j == P.n1 - 1) ? -uc + 2.f * P.bc[bc_at(1, 1, 0)]
                                    : ld_u(P, i, j + 1);
  const float u_s = (j == 0) ? -uc + 2.f * P.bc[bc_at(1, 0, 0)]
                             : ld_u(P, i, j - 1);
  // v on the four faces around this u face (cells i-1, i; faces j, j+1)
  const float vbar = 0.25f * (((ld_v(P, i, j) + ld_v(P, i - 1, j)) +
                               ld_v(P, i, j + 1)) +
                              ld_v(P, i - 1, j + 1));
  const float d0c = (u_e - u_w) * P.inv_2h[0];
  const float d1c = (u_n - u_s) * P.inv_2h[1];
  float d0 = d0c;
  float d1 = d1c;
  if (P.gamma > 0.f) {
    const float d0u = (uc > 0.f) ? (uc - u_w) * P.inv_h[0]
                                 : (u_e - uc) * P.inv_h[0];
    const float d1u = (vbar > 0.f) ? (uc - u_s) * P.inv_h[1]
                                   : (u_n - uc) * P.inv_h[1];
    d0 = P.gamma * d0u + P.one_minus_gamma * d0c;
    d1 = P.gamma * d1u + P.one_minus_gamma * d1c;
  }
  const float lap = (u_e - 2.f * uc + u_w) * P.inv_hh[0] +
                    (u_n - 2.f * uc + u_s) * P.inv_hh[1];
  const float rhs = P.nu * lap - (uc * d0 + vbar * d1);
  return uc + P.dt * rhs;
}

// v* at the interior v face (i, j), 1 <= j <= n1-1. Across an axis-0 wall
// the tangential ghost is -edge + 2 v_wall; face j+1 = n1 is read from the
// array (its BC value).
__device__ __forceinline__ float vstar(const Pred2& P, int i, int j) {
  const float vc = ld_v(P, i, j);
  const float v_e = (i == P.n0 - 1) ? -vc + 2.f * P.bc[bc_at(0, 1, 1)]
                                    : ld_v(P, i + 1, j);
  const float v_w = (i == 0) ? -vc + 2.f * P.bc[bc_at(0, 0, 1)]
                             : ld_v(P, i - 1, j);
  const float v_n = ld_v(P, i, j + 1);
  const float v_s = ld_v(P, i, j - 1);
  // u on the four faces around this v face (faces i, i+1; cells j, j-1)
  const float ubar = 0.25f * (((ld_u(P, i, j) + ld_u(P, i + 1, j)) +
                               ld_u(P, i, j - 1)) +
                              ld_u(P, i + 1, j - 1));
  const float e0c = (v_e - v_w) * P.inv_2h[0];
  const float e1c = (v_n - v_s) * P.inv_2h[1];
  float e0 = e0c;
  float e1 = e1c;
  if (P.gamma > 0.f) {
    const float e0u = (ubar > 0.f) ? (vc - v_w) * P.inv_h[0]
                                   : (v_e - vc) * P.inv_h[0];
    const float e1u = (vc > 0.f) ? (vc - v_s) * P.inv_h[1]
                                 : (v_n - vc) * P.inv_h[1];
    e0 = P.gamma * e0u + P.one_minus_gamma * e0c;
    e1 = P.gamma * e1u + P.one_minus_gamma * e1c;
  }
  const float lav = (v_e - 2.f * vc + v_w) * P.inv_hh[0] +
                    (v_n - 2.f * vc + v_s) * P.inv_hh[1];
  const float rhs = P.nu * lav - (ubar * e0 + vc * e1);
  return vc + P.dt * rhs;
}

__global__ void __launch_bounds__(kThreads)
predictor_rhs_2d_kernel(Pred2 P, float* __restrict__ uo,
                        float* __restrict__ vo, float* __restrict__ rhs,
                        float rho_over_dt) {
  const long long ncell = (long long)P.n0 * P.n1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const int i = (int)(idx / P.n1);
  const int j = (int)(idx % P.n1);
  // own-axis boundary faces take their BC values
  const float u_lo = (i == 0) ? P.bc[bc_at(0, 0, 0)] : ustar(P, i, j);
  const float u_hi = (i == P.n0 - 1) ? P.bc[bc_at(0, 1, 0)]
                                     : ustar(P, i + 1, j);
  const float v_lo = (j == 0) ? P.bc[bc_at(1, 0, 1)] : vstar(P, i, j);
  const float v_hi = (j == P.n1 - 1) ? P.bc[bc_at(1, 1, 1)]
                                     : vstar(P, i, j + 1);
  // each cell owns its low faces; the last row / column also writes the
  // high boundary face
  uo[(long long)i * P.n1 + j] = u_lo;
  vo[(long long)i * (P.n1 + 1) + j] = v_lo;
  if (i == P.n0 - 1) uo[(long long)(i + 1) * P.n1 + j] = u_hi;
  if (j == P.n1 - 1) vo[(long long)i * (P.n1 + 1) + j + 1] = v_hi;
  const float div = (u_hi - u_lo) * P.inv_h[0] + (v_hi - v_lo) * P.inv_h[1];
  rhs[idx] = div * rho_over_dt;
}

struct Corr2 {
  const float* us;  // u* (n0+1, n1)
  const float* vs;  // v* (n0, n1+1)
  const float* p;   // (n0, n1)
  int n0, n1;
  float inv_h[2];
  float scale;      // dt / rho
};

__global__ void __launch_bounds__(kThreads)
correct_diag_2d_kernel(Corr2 C, float* __restrict__ uo,
                       float* __restrict__ vo, int* __restrict__ maxes) {
  const long long ncell = (long long)C.n0 * C.n1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int div_bits = 0;
  int vel_bits = 0;
  if (idx < ncell) {
    const int i = (int)(idx / C.n1);
    const int j = (int)(idx % C.n1);
    const int n1 = C.n1;
    const long long iu = (long long)i * n1 + j;        // u face (i, j)
    const long long iv = (long long)i * (n1 + 1) + j;  // v face (i, j)
    const float pc = C.p[idx];
    // boundary faces keep u*; interior faces take u* - scale dp/dx_a
    float u_lo = C.us[iu];
    if (i > 0) u_lo = u_lo - C.scale * ((pc - C.p[idx - n1]) * C.inv_h[0]);
    float u_hi = C.us[iu + n1];
    if (i < C.n0 - 1) {
      u_hi = u_hi - C.scale * ((C.p[idx + n1] - pc) * C.inv_h[0]);
    }
    float v_lo = C.vs[iv];
    if (j > 0) v_lo = v_lo - C.scale * ((pc - C.p[idx - 1]) * C.inv_h[1]);
    float v_hi = C.vs[iv + 1];
    if (j < n1 - 1) v_hi = v_hi - C.scale * ((C.p[idx + 1] - pc) * C.inv_h[1]);
    uo[iu] = u_lo;
    vo[iv] = v_lo;
    vel_bits = max(abs_bits(u_lo * C.inv_h[0]), abs_bits(v_lo * C.inv_h[1]));
    if (i == C.n0 - 1) {
      uo[iu + n1] = u_hi;
      vel_bits = max(vel_bits, abs_bits(u_hi * C.inv_h[0]));
    }
    if (j == n1 - 1) {
      vo[iv + 1] = v_hi;
      vel_bits = max(vel_bits, abs_bits(v_hi * C.inv_h[1]));
    }
    // every cell of the ported slice is fluid (no obstacle masks yet)
    div_bits = abs_bits((u_hi - u_lo) * C.inv_h[0] +
                        (v_hi - v_lo) * C.inv_h[1]);
  }
  block_max_to(div_bits, maxes + 0);
  block_max_to(vel_bits, maxes + 1);
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).

int nss_predictor_rhs_2d(const float* u, const float* v, float* uo, float* vo,
                         float* rhs, const float* bc, int n0, int n1,
                         float inv_h0, float inv_h1, float inv_2h0,
                         float inv_2h1, float inv_hh0, float inv_hh1,
                         float dt, float nu, float gamma,
                         float one_minus_gamma, float rho_over_dt,
                         void* stream) {
  Pred2 P;
  P.u = u;
  P.v = v;
  P.bc = bc;
  P.n0 = n0;
  P.n1 = n1;
  P.inv_h[0] = inv_h0;
  P.inv_h[1] = inv_h1;
  P.inv_2h[0] = inv_2h0;
  P.inv_2h[1] = inv_2h1;
  P.inv_hh[0] = inv_hh0;
  P.inv_hh[1] = inv_hh1;
  P.dt = dt;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  predictor_rhs_2d_kernel<<<blocks_for((long long)n0 * n1), kThreads, 0,
                            (cudaStream_t)stream>>>(P, uo, vo, rhs,
                                                    rho_over_dt);
  return (int)cudaGetLastError();
}

int nss_correct_diag_2d(const float* us, const float* vs, const float* p,
                        float* uo, float* vo, int* maxes, int n0, int n1,
                        float inv_h0, float inv_h1, float scale,
                        void* stream) {
  Corr2 C;
  C.us = us;
  C.vs = vs;
  C.p = p;
  C.n0 = n0;
  C.n1 = n1;
  C.inv_h[0] = inv_h0;
  C.inv_h[1] = inv_h1;
  C.scale = scale;
  correct_diag_2d_kernel<<<blocks_for((long long)n0 * n1), kThreads, 0,
                           (cudaStream_t)stream>>>(C, uo, vo, maxes);
  return (int)cudaGetLastError();
}

}  // extern "C"
