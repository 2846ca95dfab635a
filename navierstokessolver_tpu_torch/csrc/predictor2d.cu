// 2D per-component predictor for Hopper (sm_90a), plain C interface.
//
//   nss_predictor_2d  replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                     _predictor_component_kernel (launched through
//                     _component_call by predictor_2d, once per velocity
//                     component): the explicit advection-diffusion update
//                     u* = u + dt (nu lap u - (u . grad) u) of both
//                     components of a 2D field, advective-form central
//                     differences blended with donor-cell upwinding by
//                     gamma, on every face that is not a boundary face of
//                     its own axis. navierstokessolver_tpu_torch/ops/
//                     predictor2d.py binds it with ctypes.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32:
// u is (n0+1, n1), v is (n0, n1+1). The TPU kernel's 128-row stripes with
// 8-row DMA overshoot, its 128-lane padded width and the host-side
// pad_transverse / _edge_pad / _pad_to copies before each call do not carry
// over. The ghosts across the transverse domain faces are synthesised in
// the kernel as alpha * edge + beta from a per-face table the wrapper builds
// once per simulation from the BC kinds: (-1, 2 u_bc) across WALL and
// INFLOW faces, (1, 0) across SLIP and OUTFLOW faces. Along a component's
// own axis no ghost is needed: the boundary faces are not updated here
// (the kernel writes their input value, which the caller's BC pass then
// overwrites), and every interior face's neighbours lie in the array.
//
// Arithmetic follows the Pallas kernel: the spacings enter as multiplies by
// 1/h, 1/(2h) and 1/h^2 rounded to float32 (the wrapper passes them), the
// transverse velocity is 0.25 (((a + b) + c) + d) over the four faces
// around the face in the Pallas operand order, the upwind blend
// gamma d_u + (1 - gamma) d_c is formed only when gamma > 0, and the update
// is c + dt (nu lap - adv). jnp.where(vel > 0, bwd, fwd) is kept exactly:
// zero velocity takes fwd.
//
// What bounds it on this card: a memory-bound stencil. It must read u and v
// and write u* and v*: 16 B per face, 33.6 MB at 2048x1024, 10 us at the
// H100's 3.35 TB/s, against ~36 float32 operations per face (2.3 us at 67
// TFLOP/s). The design answers that with coalescing and caching only: one
// thread per output face, u faces first and then v faces in one launch,
// consecutive threads on consecutive faces of axis 1, the neighbour and
// 4-point-average reads served by L1/L2 rather than staged by hand.
// Shared-memory tiles are work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::blocks_for;
using nss::kThreads;

struct Pred2c {
  const float* u;   // (n0+1, n1)
  const float* v;   // (n0, n1+1)
  int n0, n1;
  float inv_h[2];   // 1/h_a
  float inv_2h[2];  // 1/(2 h_a)
  float inv_hh[2];  // 1/h_a^2
  float dt, nu, gamma, one_minus_gamma;
  // ghost = alpha * edge + beta: [0, 1] u across the axis-1 low / high
  // faces, [2, 3] v across the axis-0 low / high faces
  float alpha[4], beta[4];
};

__device__ __forceinline__ float ld_u(const Pred2c& P, int i, int j) {
  return P.u[(long long)i * P.n1 + j];
}

__device__ __forceinline__ float ld_v(const Pred2c& P, int i, int j) {
  return P.v[(long long)i * (P.n1 + 1) + j];
}

// One face's update from its centre c, its neighbours along axis 0 (e: +1,
// w: -1) and axis 1 (n: +1, s: -1), and the transport velocities along the
// two axes.
__device__ __forceinline__ float update(const Pred2c& P, float c, float e,
                                        float w, float n, float s,
                                        float vel0, float vel1) {
  const float d0c = (e - w) * P.inv_2h[0];
  const float d1c = (n - s) * P.inv_2h[1];
  float d0 = d0c;
  float d1 = d1c;
  if (P.gamma > 0.f) {
    const float d0u = (vel0 > 0.f) ? (c - w) * P.inv_h[0]
                                   : (e - c) * P.inv_h[0];
    const float d1u = (vel1 > 0.f) ? (c - s) * P.inv_h[1]
                                   : (n - c) * P.inv_h[1];
    d0 = P.gamma * d0u + P.one_minus_gamma * d0c;
    d1 = P.gamma * d1u + P.one_minus_gamma * d1c;
  }
  const float adv = vel0 * d0 + vel1 * d1;
  const float lap = (e - 2.f * c + w) * P.inv_hh[0] +
                    (n - 2.f * c + s) * P.inv_hh[1];
  return c + P.dt * (P.nu * lap - adv);
}

__global__ void __launch_bounds__(kThreads)
predictor_2d_kernel(Pred2c P, float* __restrict__ uo,
                    float* __restrict__ vo) {
  const long long n_u = (long long)(P.n0 + 1) * P.n1;
  const long long n_v = (long long)P.n0 * (P.n1 + 1);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_u) {
    const int i = (int)(idx / P.n1);
    const int j = (int)(idx % P.n1);
    const float c = ld_u(P, i, j);
    if (i == 0 || i == P.n0) {  // own-axis boundary face: left to the BCs
      uo[idx] = c;
      return;
    }
    const float n = (j == P.n1 - 1) ? P.alpha[1] * c + P.beta[1]
                                    : ld_u(P, i, j + 1);
    const float s = (j == 0) ? P.alpha[0] * c + P.beta[0]
                             : ld_u(P, i, j - 1);
    // v on the four faces around u face (i, j): cells i-1, i; faces j, j+1
    const float vbar = 0.25f * (((ld_v(P, i - 1, j) + ld_v(P, i, j)) +
                                 ld_v(P, i - 1, j + 1)) +
                                ld_v(P, i, j + 1));
    uo[idx] = update(P, c, ld_u(P, i + 1, j), ld_u(P, i - 1, j), n, s, c,
                     vbar);
  } else if (idx < n_u + n_v) {
    const long long k = idx - n_u;
    const int i = (int)(k / (P.n1 + 1));
    const int j = (int)(k % (P.n1 + 1));
    const float c = ld_v(P, i, j);
    if (j == 0 || j == P.n1) {
      vo[k] = c;
      return;
    }
    const float e = (i == P.n0 - 1) ? P.alpha[3] * c + P.beta[3]
                                    : ld_v(P, i + 1, j);
    const float w = (i == 0) ? P.alpha[2] * c + P.beta[2]
                             : ld_v(P, i - 1, j);
    // u on the four faces around v face (i, j): faces i, i+1; cells j-1, j
    const float ubar = 0.25f * (((ld_u(P, i, j - 1) + ld_u(P, i + 1, j - 1)) +
                                 ld_u(P, i, j)) +
                                ld_u(P, i + 1, j));
    vo[k] = update(P, c, e, w, ld_v(P, i, j + 1), ld_v(P, i, j - 1), ubar, c);
  }
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns cudaGetLastError()
// (0 = launched). `ghosts` holds alpha[0..3] then beta[0..3].
int nss_predictor_2d(const float* u, const float* v, float* uo, float* vo,
                     int n0, int n1, float inv_h0, float inv_h1,
                     float inv_2h0, float inv_2h1, float inv_hh0,
                     float inv_hh1, float dt, float nu, float gamma,
                     float one_minus_gamma, float a0, float a1, float a2,
                     float a3, float b0, float b1, float b2, float b3,
                     void* stream) {
  Pred2c P;
  P.u = u;
  P.v = v;
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
  P.alpha[0] = a0;
  P.alpha[1] = a1;
  P.alpha[2] = a2;
  P.alpha[3] = a3;
  P.beta[0] = b0;
  P.beta[1] = b1;
  P.beta[2] = b2;
  P.beta[3] = b3;
  const long long faces = (long long)(n0 + 1) * n1 + (long long)n0 * (n1 + 1);
  predictor_2d_kernel<<<blocks_for(faces), kThreads, 0,
                        (cudaStream_t)stream>>>(P, uo, vo);
  return (int)cudaGetLastError();
}

}  // extern "C"
