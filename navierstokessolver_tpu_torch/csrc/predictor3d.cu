// Per-component 3D predictor and Smagorinsky eddy-viscosity kernels for
// Hopper (sm_90a), plain C interface. They carry the 3D LES step of the
// PyTorch port (navierstokessolver_tpu_torch/ops/predictor3d.py binds them
// with ctypes):
//
//   nss_nu_t_3d        replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                      _nu_t3d_kernel: nu_t = scale * sqrt(2 S_ij S_ij) at
//                      cell centres, scale = cs^2 Delta^2.
//   nss_predictor_3d   replaces pallas_kernels.py _predictor3d_kernel: u* of
//                      every component (advection with the central/upwind
//                      blend, diffusion, one explicit Euler step) and, when
//                      nu_t is given, the subgrid-stress divergence
//                      d/dx_b (2 nu_t S_ab). Unlike the TPU kernel, which
//                      leaves the boundary faces for a BC pass, it writes
//                      the WALL value on each component's own-axis
//                      boundary faces.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32.
// u0 is (n0+1, n1, n2), u1 (n0, n1+1, n2), u2 (n0, n1, n2+1); nu_t and the
// other cell fields are (n0, n1, n2). The TPU kernels' canonical operands
// (128-lane padding, u2's elided face n2, aprons on axes 0/1 and lane-roll
// fixes on axis 2) do not carry over: ghosts are made here from the
// 18-float wall buffer bc[(axis*2 + side)*3 + comp]. A velocity read beyond
// a wall along a transverse axis takes the reflection 2*v_bc - edge (the
// TPU kernels' bc_ghost_slab_3d aprons and tangential lane fixes); a nu_t
// read beyond a wall clamps each index, the edge-replicate ghost of
// les._pad_cells and nt_canon_3d. u2's face n2 is read from the array,
// where the state invariant keeps its BC value.
//
// Arithmetic follows the Pallas kernels: multiplies by float32 reciprocals
// 1/h, 1/(2h) = 0.5/h, 1/h^2, the four-point transverse average
// 0.25*(((a+b)+c)+d), zero velocity taking the forward difference.
//
// What bounds them on this card: both are memory-bound stencils. nu_t must
// read three face fields and write one cell field (16 B per cell); the LES
// predictor reads four fields and writes three (28 B per cell): at 256^3
// about 0.27 and 0.47 GB per call against the H100's 3.35 TB/s. The design
// answers that only with coalescing and caching: one thread per output
// point, consecutive threads on consecutive points of the fastest axis, and
// every neighbour re-read through L1/L2 rather than staged by hand. The
// predictor is one launch for all three components (blockIdx.y picks the
// component, so a warp never diverges on it). Shared-memory tiling is work
// for later changes.

#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

using nss::blocks_for;
using nss::Grid3;
using nss::kThreads;
using nss::lin;
using nss::unflatten;

// Component c's value at y (y[c] a face index, the other entries cell
// indices). A transverse index one step beyond a wall reflects through the
// wall value, axis by axis in increasing order, as bcs.pad_transverse pads.
__device__ __forceinline__ float vel_at(const float* __restrict__ uc, int c,
                                        const float* __restrict__ bc,
                                        const Grid3& g, const int y[3]) {
  int z[3] = {y[0], y[1], y[2]};
  int side[3] = {-1, -1, -1};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == c) continue;
    if (z[t] < 0) {
      z[t] = 0;
      side[t] = 0;
    } else if (z[t] >= g.n[t]) {
      z[t] = g.n[t] - 1;
      side[t] = 1;
    }
  }
  float v = uc[lin(g, c, z[0], z[1], z[2])];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (side[t] >= 0) v = 2.f * bc[(t * 2 + side[t]) * 3 + c] - v;
  }
  return v;
}

// nu_t at cell y, every index clamped into the domain (edge-replicate).
__device__ __forceinline__ float nt_at(const float* __restrict__ nt,
                                       const Grid3& g, int y0, int y1,
                                       int y2) {
  y0 = min(max(y0, 0), g.n[0] - 1);
  y1 = min(max(y1, 0), g.n[1] - 1);
  y2 = min(max(y2, 0), g.n[2] - 1);
  return nt[lin(g, 3, y0, y1, y2)];
}

// -- eddy viscosity (replaces _nu_t3d_kernel) ---------------------------------

struct NutParams {
  const float* u[3];
  const float* bc;
  Grid3 g;
  float inv_h[3];  // float32(1/h_a)
  float scale;     // float32(cs^2 Delta^2)
};

// u_a at (face x_a + fa along a, cell x_b + db along b), cell x elsewhere.
__device__ __forceinline__ float ua_at(const NutParams& P, int a, int b,
                                       const int x[3], int fa, int db) {
  int y[3] = {x[0], x[1], x[2]};
  y[a] += fa;
  y[b] += db;
  return vel_at(P.u[a], a, P.bc, P.g, y);
}

// The 4-edge average of du_a/dx_b at the cell centre, telescoped into
// central differences over the low (fa = 0) and high (fa = 1) faces of a.
__device__ __forceinline__ float d_center(const NutParams& P, int a, int b,
                                          const int x[3]) {
  return (0.25f * P.inv_h[b]) *
         ((ua_at(P, a, b, x, 0, 1) - ua_at(P, a, b, x, 0, -1)) +
          (ua_at(P, a, b, x, 1, 1) - ua_at(P, a, b, x, 1, -1)));
}

__global__ void __launch_bounds__(kThreads)
nu_t_3d_kernel(NutParams P, float* __restrict__ out) {
  const Grid3& g = P.g;
  const long long ncell = (long long)g.n[0] * g.n[1] * g.n[2];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  int x[3];
  unflatten(g, idx, x);
  float s2 = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* ua = P.u[a];
    int y[3] = {x[0], x[1], x[2]};
    const float lo = ua[lin(g, a, y[0], y[1], y[2])];
    y[a] += 1;
    const float hi = ua[lin(g, a, y[0], y[1], y[2])];
    const float saa = (hi - lo) * P.inv_h[a];
    s2 = (a == 0) ? saa * saa : s2 + saa * saa;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = a + 1; b < 3; ++b) {
      const float s_ab = 0.5f * (d_center(P, a, b, x) + d_center(P, b, a, x));
      s2 = s2 + 2.f * (s_ab * s_ab);
    }
  }
  out[idx] = P.scale * sqrtf(2.f * s2);
}

// -- per-component predictor (replaces _predictor3d_kernel) ------------------

struct PredParams {
  const float* u[3];
  const float* nu_t;  // (n0, n1, n2), or null: no LES term
  const float* bc;
  Grid3 g;
  float inv_h[3];   // float32(1/h_a)
  float inv_hh[3];  // float32(1/h_a^2)
  float dt, nu, gamma, one_minus_gamma;
};

// u* of component C at its face x (BC value on the own-axis boundary faces).
template <int C, bool LES>
__device__ __forceinline__ float predict_face(const PredParams& P,
                                              const int x[3]) {
  const Grid3& g = P.g;
  if (x[C] == 0) return P.bc[(C * 2 + 0) * 3 + C];
  if (x[C] == g.n[C]) return P.bc[(C * 2 + 1) * 3 + C];
  const float* uc = P.u[C];
  const float c0 = uc[lin(g, C, x[0], x[1], x[2])];
  float um[3], up[3], vel[3];
  // q[t][dc][df]: component t at cell x_C - 1 + dc along C and face
  // x_t + df along t; their mean is t's velocity at this face, and their
  // differences along C are du_t/dx_C at the (C, t) edges
  float q[3][2][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    int y[3] = {x[0], x[1], x[2]};
    y[ax] = x[ax] - 1;
    um[ax] = vel_at(uc, C, P.bc, g, y);
    y[ax] = x[ax] + 1;
    up[ax] = vel_at(uc, C, P.bc, g, y);
    if (ax == C) {
      vel[ax] = c0;
      continue;
    }
    const float* ut = P.u[ax];
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
#pragma unroll
      for (int df = 0; df < 2; ++df) {
        int z[3] = {x[0], x[1], x[2]};
        z[C] = x[C] - 1 + dc;
        z[ax] = x[ax] + df;
        q[ax][dc][df] = ut[lin(g, ax, z[0], z[1], z[2])];
      }
    }
    vel[ax] = 0.25f * (((q[ax][0][0] + q[ax][0][1]) + q[ax][1][0]) +
                       q[ax][1][1]);
  }
  float adv = 0.f, lap = 0.f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float m = um[ax], p = up[ax];
    const float d_c = (p - m) * (0.5f * P.inv_h[ax]);
    float d;
    if (P.gamma > 0.f) {
      // zero velocity takes the forward difference, as
      // jnp.where(vel > 0, bwd, fwd) does
      const float d_u = (vel[ax] > 0.f) ? (c0 - m) * P.inv_h[ax]
                                        : (p - c0) * P.inv_h[ax];
      d = P.gamma * d_u + P.one_minus_gamma * d_c;
    } else {
      d = d_c;
    }
    const float term = vel[ax] * d;
    const float lp = (p - 2.f * c0 + m) * P.inv_hh[ax];
    adv = (ax == 0) ? term : adv + term;
    lap = (ax == 0) ? lp : lap + lp;
  }
  float rhs = P.nu * lap - adv;
  if (LES) {
    const float* nt = P.nu_t;
    const float two_inv_c = 2.f * P.inv_h[C];
    // own axis: (tau_CC(cell x_C) - tau_CC(cell x_C - 1)) / h_C with
    // tau_CC = 2 nu_t S_CC
    int y[3] = {x[0], x[1], x[2]};
    float f = (two_inv_c * nt_at(nt, g, y[0], y[1], y[2])) *
              ((up[C] - c0) * P.inv_h[C]);
    y[C] -= 1;
    f = f + (-two_inv_c * nt_at(nt, g, y[0], y[1], y[2])) *
                ((c0 - um[C]) * P.inv_h[C]);
    // transverse: (tau_Ct(edge x_t + 1) - tau_Ct(edge x_t)) / h_t, nu_t
    // averaged onto each (C, t) edge from its four cells
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (t == C) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 1 - e;  // edge x_t + 1 first, then x_t
        const float du_c = (d == 1) ? (up[t] - c0) * P.inv_h[t]
                                    : (c0 - um[t]) * P.inv_h[t];
        const float du_t = (q[t][1][d] - q[t][0][d]) * P.inv_h[C];
        const float s_ct = 0.5f * (du_c + du_t);
        int z[3] = {x[0], x[1], x[2]};
        z[C] = x[C] - 1;
        z[t] = x[t] + d - 1;
        const float n00 = nt_at(nt, g, z[0], z[1], z[2]);
        z[C] = x[C];
        const float n10 = nt_at(nt, g, z[0], z[1], z[2]);
        z[C] = x[C] - 1;
        z[t] = x[t] + d;
        const float n01 = nt_at(nt, g, z[0], z[1], z[2]);
        z[C] = x[C];
        const float n11 = nt_at(nt, g, z[0], z[1], z[2]);
        const float nt_e = 0.25f * (((n00 + n10) + n01) + n11);
        const float k = (d == 1) ? 2.f * P.inv_h[t] : -2.f * P.inv_h[t];
        f = f + (k * nt_e) * s_ct;
      }
    }
    rhs = rhs + f;
  }
  return c0 + P.dt * rhs;
}

template <int C, bool LES>
__device__ __forceinline__ void predict_component(const PredParams& P,
                                                  float* __restrict__ out) {
  Grid3 fg = P.g;  // the face grid of component C
  fg.n[C] += 1;
  const long long n = (long long)fg.n[0] * fg.n[1] * fg.n[2];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int x[3];
  unflatten(fg, idx, x);
  out[idx] = predict_face<C, LES>(P, x);
}

template <bool LES>
__global__ void __launch_bounds__(kThreads)
predictor_3d_kernel(PredParams P, float* __restrict__ o0,
                    float* __restrict__ o1, float* __restrict__ o2) {
  switch (blockIdx.y) {
    case 0:
      predict_component<0, LES>(P, o0);
      break;
    case 1:
      predict_component<1, LES>(P, o1);
      break;
    default:
      predict_component<2, LES>(P, o2);
  }
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).

int nss_nu_t_3d(const float* u0, const float* u1, const float* u2,
                const float* bc, float* out, int n0, int n1, int n2,
                float inv_h0, float inv_h1, float inv_h2, float scale,
                void* stream) {
  NutParams P;
  P.u[0] = u0;
  P.u[1] = u1;
  P.u[2] = u2;
  P.bc = bc;
  P.g.n[0] = n0;
  P.g.n[1] = n1;
  P.g.n[2] = n2;
  P.inv_h[0] = inv_h0;
  P.inv_h[1] = inv_h1;
  P.inv_h[2] = inv_h2;
  P.scale = scale;
  const long long ncell = (long long)n0 * n1 * n2;
  nu_t_3d_kernel<<<blocks_for(ncell), kThreads, 0, (cudaStream_t)stream>>>(
      P, out);
  return (int)cudaGetLastError();
}

// nu_t may be null: the plain advection-diffusion update.
int nss_predictor_3d(const float* u0, const float* u1, const float* u2,
                     const float* nu_t, float* o0, float* o1, float* o2,
                     const float* bc, int n0, int n1, int n2, float inv_h0,
                     float inv_h1, float inv_h2, float inv_hh0, float inv_hh1,
                     float inv_hh2, float dt, float nu, float gamma,
                     float one_minus_gamma, void* stream) {
  PredParams P;
  P.u[0] = u0;
  P.u[1] = u1;
  P.u[2] = u2;
  P.nu_t = nu_t;
  P.bc = bc;
  P.g.n[0] = n0;
  P.g.n[1] = n1;
  P.g.n[2] = n2;
  P.inv_h[0] = inv_h0;
  P.inv_h[1] = inv_h1;
  P.inv_h[2] = inv_h2;
  P.inv_hh[0] = inv_hh0;
  P.inv_hh[1] = inv_hh1;
  P.inv_hh[2] = inv_hh2;
  P.dt = dt;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  // the largest face count of the three components
  const long long cells = (long long)n0 * n1 * n2;
  const long long faces =
      cells + std::max({(long long)n1 * n2, (long long)n0 * n2,
                        (long long)n0 * n1});
  const dim3 grid(blocks_for(faces), 3);
  if (nu_t != nullptr) {
    predictor_3d_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        P, o0, o1, o2);
  } else {
    predictor_3d_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        P, o0, o1, o2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
