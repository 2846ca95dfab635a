// Fused 3D projection-step kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels carry the 3D lid-driven cavity step of the PyTorch port
// (navierstokessolver_tpu_torch/ops/fused3d.py binds them with ctypes):
//
//   nss_predictor_rhs_3d  replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                         _fused_pred_kernel (Euler form, WALL faces, no
//                         obstacle, no forcing): u* for all three components,
//                         the BC values on the boundary faces, and the Poisson
//                         RHS (rho/dt) div u*, in one pass.
//   nss_correct_diag_3d   replaces pallas_kernels.py _fused_corr_kernel:
//                         u = u* - scale grad p on interior faces, boundary
//                         faces copied from u*, plus max|div u| and
//                         max_a max|u_a|/h_a.
//   nss_residual_3d       replaces pallas_kernels.py _residual3d_kernel:
//                         r = (b - A p) * fluid, A decoded from the uint8
//                         stencil code (bits 0-5 neighbor couplings, bit 6
//                         fluid) and w_a = 1/h_a^2.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32.
// u0 is (n0+1, n1, n2), u1 (n0, n1+1, n2), u2 (n0, n1, n2+1); cell fields are
// (n0, n1, n2). None of the TPU kernel's 128-lane padding, stripe windows or
// lane-elided faces carries over.
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

namespace {

constexpr int kThreads = 256;

struct Grid3 {
  int n[3];
};

// Linear index of face/cell (x0, x1, x2) in the array of component `a`
// (a = 3: a cell-centered field).
__device__ __forceinline__ long long lin(const Grid3& g, int a, int x0, int x1,
                                         int x2) {
  const long long d1 = g.n[1] + (a == 1);
  const long long d2 = g.n[2] + (a == 2);
  return ((long long)x0 * d1 + x1) * d2 + x2;
}

__device__ __forceinline__ void unflatten(const Grid3& g, long long idx,
                                          int x[3]) {
  x[2] = (int)(idx % g.n[2]);
  const long long t = idx / g.n[2];
  x[1] = (int)(t % g.n[1]);
  x[0] = (int)(t / g.n[1]);
}

struct PredParams {
  const float* u[3];
  const float* bc;  // wall value [(axis*2 + side)*3 + comp]
  Grid3 g;
  float h[3];       // h_a
  float two_h[3];   // 2 h_a
  float hh[3];      // h_a^2
  float dt, nu, gamma, one_minus_gamma;
};

// u* of component A at its interior face x (1 <= x[A] <= n_A - 1), in the
// arithmetic order of ops/stencils.predictor: advective-form central
// differences blended with donor-cell upwinding, plus the viscous Laplacian,
// one explicit Euler step. Tangential neighbors beyond a wall are the
// reflection ghosts 2*u_wall - edge; along A every neighbor is in the array.
template <int A>
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
    xm[ax] -= 1;
    xp[ax] += 1;
    float um, up, vel;
    if (ax == A) {
      um = ua[lin(g, A, xm[0], xm[1], xm[2])];
      up = ua[lin(g, A, xp[0], xp[1], xp[2])];
      vel = c;
    } else {
      um = (x[ax] == 0) ? 2.f * P.bc[(ax * 2 + 0) * 3 + A] - c
                        : ua[lin(g, A, xm[0], xm[1], xm[2])];
      up = (x[ax] == g.n[ax] - 1) ? 2.f * P.bc[(ax * 2 + 1) * 3 + A] - c
                                  : ua[lin(g, A, xp[0], xp[1], xp[2])];
      // component ax averaged onto this face: cell pair (x[A]-1, x[A])
      // along A, then face pair (x[ax], x[ax]+1) along ax
      const float* ut = P.u[ax];
      int q[3] = {x[0], x[1], x[2]};
      q[A] -= 1;
      const float a00 = ut[lin(g, ax, q[0], q[1], q[2])];
      q[ax] += 1;
      const float a01 = ut[lin(g, ax, q[0], q[1], q[2])];
      q[A] += 1;
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
// boundary face, the predictor elsewhere.
template <int A>
__device__ __forceinline__ float ustar_at(const PredParams& P, const int x[3],
                                          int f) {
  if (f == 0) return P.bc[(A * 2 + 0) * 3 + A];
  if (f == P.g.n[A]) return P.bc[(A * 2 + 1) * 3 + A];
  int y[3] = {x[0], x[1], x[2]};
  y[A] = f;
  return ustar_face<A>(P, y);
}

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
  const float lo0 = ustar_at<0>(P, x, x[0]);
  const float hi0 = ustar_at<0>(P, x, x[0] + 1);
  const float lo1 = ustar_at<1>(P, x, x[1]);
  const float hi1 = ustar_at<1>(P, x, x[1] + 1);
  const float lo2 = ustar_at<2>(P, x, x[2]);
  const float hi2 = ustar_at<2>(P, x, x[2] + 1);
  // each cell owns its three low faces; the last cell along an axis also
  // writes the high boundary face
  o0[lin(g, 0, x[0], x[1], x[2])] = lo0;
  o1[lin(g, 1, x[0], x[1], x[2])] = lo1;
  o2[lin(g, 2, x[0], x[1], x[2])] = lo2;
  if (x[0] == g.n[0] - 1) o0[lin(g, 0, x[0] + 1, x[1], x[2])] = hi0;
  if (x[1] == g.n[1] - 1) o1[lin(g, 1, x[0], x[1] + 1, x[2])] = hi1;
  if (x[2] == g.n[2] - 1) o2[lin(g, 2, x[0], x[1], x[2] + 1)] = hi2;
  const float div =
      (hi0 - lo0) / P.h[0] + (hi1 - lo1) / P.h[1] + (hi2 - lo2) / P.h[2];
  rhs[idx] = div * rho_over_dt;
}

// Max over the block of non-negative floats (and NaNs), carried as their
// int bit patterns. For x >= 0 the bit pattern orders as the value does, and
// every NaN with its sign bit cleared (the callers take fabsf last) has a
// pattern above +inf's 0x7f800000, so a NaN anywhere wins the max and shows
// up in the diagnostic, as jnp.max and torch.max propagate it. fmaxf would
// drop it. The cross-block step is an atomicMax on the same patterns into a
// buffer the wrapper zeroes (0 is the pattern of +0.0f).
__device__ __forceinline__ void block_max_to(int v, int* out) {
  __shared__ int warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? warp_max[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = max(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) atomicMax(out, v);
  }
  __syncthreads();
}

__device__ __forceinline__ int abs_bits(float x) {
  return __float_as_int(fabsf(x));
}

struct CorrParams {
  const float* us[3];
  const float* p;
  Grid3 g;
  float h[3];
  float scale;  // dt / rho
};

// Corrected velocity of component A at face index f along A for the cell x:
// boundary faces keep u*, interior faces take u* - scale * dp/dx_A.
template <int A>
__device__ __forceinline__ float corrected_at(const CorrParams& C,
                                              const int x[3], int f) {
  const Grid3& g = C.g;
  int y[3] = {x[0], x[1], x[2]};
  y[A] = f;
  const float s = C.us[A][lin(g, A, y[0], y[1], y[2])];
  if (f == 0 || f == g.n[A]) return s;
  const float p_hi = C.p[lin(g, 3, y[0], y[1], y[2])];
  y[A] = f - 1;
  const float p_lo = C.p[lin(g, 3, y[0], y[1], y[2])];
  const float grad = (p_hi - p_lo) / C.h[A];
  return s + (-C.scale) * grad;
}

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
    const float lo0 = corrected_at<0>(C, x, x[0]);
    const float hi0 = corrected_at<0>(C, x, x[0] + 1);
    const float lo1 = corrected_at<1>(C, x, x[1]);
    const float hi1 = corrected_at<1>(C, x, x[1] + 1);
    const float lo2 = corrected_at<2>(C, x, x[2]);
    const float hi2 = corrected_at<2>(C, x, x[2] + 1);
    o0[lin(g, 0, x[0], x[1], x[2])] = lo0;
    o1[lin(g, 1, x[0], x[1], x[2])] = lo1;
    o2[lin(g, 2, x[0], x[1], x[2])] = lo2;
    vel_bits = max(abs_bits(lo0 / C.h[0]),
                   max(abs_bits(lo1 / C.h[1]), abs_bits(lo2 / C.h[2])));
    if (x[0] == g.n[0] - 1) {
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
  // beyond every wall, and the index test keeps a malformed code from
  // reading outside the array
  const float l0 = ((c & 1) && x[0] > 0) ? p[idx - s0] : 0.f;
  const float r0 = ((c & 2) && x[0] < g.n[0] - 1) ? p[idx + s0] : 0.f;
  const float l1 = ((c & 4) && x[1] > 0) ? p[idx - s1] : 0.f;
  const float r1 = ((c & 8) && x[1] < g.n[1] - 1) ? p[idx + s1] : 0.f;
  const float l2 = ((c & 16) && x[2] > 0) ? p[idx - 1] : 0.f;
  const float r2 = ((c & 32) && x[2] < g.n[2] - 1) ? p[idx + 1] : 0.f;
  const float nb = w0 * (l0 + r0) + w1 * (l1 + r1) + w2 * (l2 + r2);
  const float ap = diag[idx] * p[idx] + nb;
  const float fluid = (float)((c >> 6) & 1);
  out[idx] = (b[idx] - ap) * fluid;
}

unsigned int blocks_for(long long ncell) {
  return (unsigned int)((ncell + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).

int nss_predictor_rhs_3d(const float* u0, const float* u1, const float* u2,
                         float* o0, float* o1, float* o2, float* rhs,
                         const float* bc, int n0, int n1, int n2, float h0,
                         float h1, float h2, float two_h0, float two_h1,
                         float two_h2, float hh0, float hh1, float hh2,
                         float dt, float nu, float gamma,
                         float one_minus_gamma, float rho_over_dt,
                         void* stream) {
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
  const long long ncell = (long long)n0 * n1 * n2;
  predictor_rhs_kernel<<<blocks_for(ncell), kThreads, 0,
                         (cudaStream_t)stream>>>(P, o0, o1, o2, rhs,
                                                 rho_over_dt);
  return (int)cudaGetLastError();
}

int nss_correct_diag_3d(const float* s0, const float* s1, const float* s2,
                        const float* p, float* o0, float* o1, float* o2,
                        int* maxes, int n0, int n1, int n2, float h0, float h1,
                        float h2, float scale, void* stream) {
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
  const long long ncell = (long long)n0 * n1 * n2;
  correct_diag_kernel<<<blocks_for(ncell), kThreads, 0,
                        (cudaStream_t)stream>>>(C, o0, o1, o2, maxes);
  return (int)cudaGetLastError();
}

int nss_residual_3d(const float* p, const float* b, const float* diag,
                    const uint8_t* code, float* out, int n0, int n1, int n2,
                    float w0, float w1, float w2, void* stream) {
  Grid3 g;
  g.n[0] = n0;
  g.n[1] = n1;
  g.n[2] = n2;
  const long long ncell = (long long)n0 * n1 * n2;
  residual_kernel<<<blocks_for(ncell), kThreads, 0, (cudaStream_t)stream>>>(
      p, b, diag, code, out, g, w0, w1, w2);
  return (int)cudaGetLastError();
}

}  // extern "C"
