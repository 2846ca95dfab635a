// Fused 2D projection-step kernels for Hopper (sm_90a), plain C interface.
//
// Two kernels carry the 2D lid-driven cavity step of the PyTorch port
// (navierstokessolver_tpu_torch/ops/fused2d.py binds them with ctypes):
//
//   nss_predictor_rhs_2d  replaces navierstokessolver_tpu/ops/pallas_2d.py
//                         _pred2d_kernel (Euler form and rk2's based stage
//                         2, WALL faces, no obstacle, no forcing, no
//                         buoyancy): u* and v*, the BC values on the
//                         boundary faces, and the Poisson RHS
//                         (rho/dt) div u*, in one pass.
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
// The step size: dt and rho/dt (the predictor) and dt/rho (the corrector's
// scale) are read from a float32 device buffer once by every thread
// (ops/step_size.py), so a dt the device computed (the CFL-adaptive step)
// costs no host read. Based mode (rk2's stage 2, the TPU kernel's
// ``base``): the predictor is a template on BASE; the march reads the
// midpoint field as in the Euler form and anchors each face's update at the
// step-start velocity, u* = base + dt*RHS(u_mid), base read once at the
// face from device memory. A template rather than a null pointer, so that
// the Euler instantiations carry no trace of it.
//
// What bounds them on this card: both are memory-bound stencils. Per cell
// the predictor must read 2 and write 3 float32 values (20 B), the
// corrector read 3 and write 2 (20 B); at 2048^2 that is 84 MB a call, 25
// us at the H100's 3.35 TB/s.
//
// The corrector keeps its first design: one thread a cell, consecutive
// threads on consecutive cells of axis 1, every neighbour read through
// L1/L2. Its device time at 2048^2 was already 52% of that bound.
//
// The predictor's instructions a cell come close behind its bytes (~130:
// two face updates and their stencils), so its design moves each value
// once and computes each face once:
//
//   * Each warp marches a strip of columns of axis 1 down a run of rows of
//     axis 0 on its own (no shared memory, no barrier). Lane l holds column
//     c0 + l - 1 of u and v; lanes 1..29 own cells, the others are the
//     strip's halo: lane 0 the column before, lanes 30 and 31 the columns
//     after, which the last cell's high v face needs. Neighbours along axis
//     1 come from warp shuffles.
//   * Each lane keeps the rows of its column that the stencil spans in
//     registers, a group of kGroup rows at a time, and loads the next
//     group's rows while it computes this one: kGroup loads a field in
//     flight a lane, and no register is copied before its load is due.
//   * Each u face's u* is computed once, as the high face of the row below
//     it, and carried to the next row as that row's low face (one extra
//     face a run, where the run starts); each v face's v* once, by the lane
//     of its column, and handed to the cell below it in axis 1 by a
//     shuffle. The RHS is formed in registers.
//   * Index arithmetic is 32-bit (arrays of < 2^31 elements) and rows are
//     clamped to the array, so no load is guarded; boundary faces are
//     computed on clamped neighbours and then replaced by their wall value
//     (a select), so no lane branches.
//   * Runs of 32-64 rows, as many as one wave of resident blocks holds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::abs_bits;
using nss::block_max_to;
using nss::blocks_for;
using nss::kThreads;

constexpr int kWarps = 4;               // warps a block, each on its own
constexpr int kBlock = 32 * kWarps;     // threads a block
constexpr int kPredCols = 29;           // cells a predictor warp owns
constexpr int kGroup = 4;               // rows loaded ahead, per field
constexpr int kMinRun = 32;             // rows of axis 0 a warp marches, at
constexpr int kMaxRun = 64;             // least and at most
constexpr int kBlocksPerSM = 6;         // the predictor's launch bound
constexpr unsigned kFull = 0xffffffffu;

// wall value of component c on face (axis a, side s) in the bc buffer
__host__ __device__ constexpr int bc_at(int a, int s, int c) {
  return (a * 2 + s) * 2 + c;
}

struct Pred2 {
  const float* u;   // (n0+1, n1)
  const float* v;   // (n0, n1+1)
  const float* bu;  // the step-start u and v (read by BASE only)
  const float* bv;
  const float* bc;  // wall values, bc_at(axis, side, comp)
  const float* dts; // the step size: dt, rho/dt (ops/step_size.py)
  int n0, n1;
  float inv_h[2];   // 1/h_a
  float inv_2h[2];  // 1/(2 h_a)
  float inv_hh[2];  // 1/h_a^2
  float nu, gamma, one_minus_gamma;
};

// u* on an interior u face: the face uc, its axis-0 neighbours uw, ue, its
// axis-1 neighbours (or wall ghosts) us, un, and the four v faces around
// it, summed ((va + vb) + vc) + vd (the cell above the face first); one
// step of dt from `anchor` (uc, or rk2's base).
template <bool UPWIND>
__device__ __forceinline__ float u_update(const Pred2& P, float dt,
                                          float anchor, float uc, float uw,
                                          float ue, float us, float un,
                                          float va, float vb, float vc,
                                          float vd) {
  const float vbar = 0.25f * (((va + vb) + vc) + vd);
  const float d0c = (ue - uw) * P.inv_2h[0];
  const float d1c = (un - us) * P.inv_2h[1];
  float d0 = d0c;
  float d1 = d1c;
  if (UPWIND) {
    const float d0u = (uc > 0.f) ? (uc - uw) * P.inv_h[0]
                                 : (ue - uc) * P.inv_h[0];
    const float d1u = (vbar > 0.f) ? (uc - us) * P.inv_h[1]
                                   : (un - uc) * P.inv_h[1];
    d0 = P.gamma * d0u + P.one_minus_gamma * d0c;
    d1 = P.gamma * d1u + P.one_minus_gamma * d1c;
  }
  const float lap = (ue - 2.f * uc + uw) * P.inv_hh[0] +
                    (un - 2.f * uc + us) * P.inv_hh[1];
  const float rhs = P.nu * lap - (uc * d0 + vbar * d1);
  return anchor + dt * rhs;
}

// v* on an interior v face: the face vc, its axis-0 neighbours (or wall
// ghosts) vw, ve, its axis-1 neighbours vs, vn, and the four u faces around
// it, summed ((ua + ub) + uc) + ud (this column first); one step of dt
// from `anchor` (vc, or rk2's base).
template <bool UPWIND>
__device__ __forceinline__ float v_update(const Pred2& P, float dt,
                                          float anchor, float vc, float vw,
                                          float ve, float vs, float vn,
                                          float ua, float ub, float uc,
                                          float ud) {
  const float ubar = 0.25f * (((ua + ub) + uc) + ud);
  const float e0c = (ve - vw) * P.inv_2h[0];
  const float e1c = (vn - vs) * P.inv_2h[1];
  float e0 = e0c;
  float e1 = e1c;
  if (UPWIND) {
    const float e0u = (ubar > 0.f) ? (vc - vw) * P.inv_h[0]
                                   : (ve - vc) * P.inv_h[0];
    const float e1u = (vc > 0.f) ? (vc - vs) * P.inv_h[1]
                                 : (vn - vc) * P.inv_h[1];
    e0 = P.gamma * e0u + P.one_minus_gamma * e0c;
    e1 = P.gamma * e1u + P.one_minus_gamma * e1c;
  }
  const float lav = (ve - 2.f * vc + vw) * P.inv_hh[0] +
                    (vn - 2.f * vc + vs) * P.inv_hh[1];
  const float rhs = P.nu * lav - (ubar * e0 + vc * e1);
  return anchor + dt * rhs;
}

// Rows of axis 0 a warp marches: kMinRun..kMaxRun, and as many runs as the
// card's resident blocks (kBlocksPerSM an SM) hold in one wave.
inline int run_for(int n0, int blocks_x) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int runs = max(1, sms * kBlocksPerSM / blocks_x);
  return min(max((n0 + runs - 1) / runs, kMinRun), kMaxRun);
}

// Blocks along axis 1 for warps that own `cols` cells each.
inline int blocks_x_for(int n1, int cols) {
  const int strips = (n1 + cols - 1) / cols;
  return (strips + kWarps - 1) / kWarps;
}

// One block: kWarps warps, each on its own strip of kPredCols cells of axis
// 1 and the run of rows [i0, i1). At a row r the lane of column c computes
// u*(r+1, c), the cell's high u face, and v*(r, c), its low v face, and the
// cells' RHS from those, the carried u*(r, c) and the next lane's v*.
// BASE: rk2's stage 2, each face anchored at the step-start field.
template <bool UPWIND, bool BASE>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
predictor_rhs_2d_kernel(Pred2 P, float* __restrict__ uo,
                        float* __restrict__ vo, float* __restrict__ rhs,
                        int run) {
  const int n0 = P.n0, n1 = P.n1, pv = n1 + 1;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPredCols;
  if (c0 >= n1) return;  // a warp past the last strip (no barrier follows)
  const float dt = __ldg(P.dts), rho_over_dt = __ldg(P.dts + 1);
  const int c = c0 + lane - 1;
  const bool cell = lane >= 1 && lane <= kPredCols && c < n1;
  const int cu = min(max(c, 0), n1 - 1);  // the u and cell column it reads
  const int cv = min(max(c, 0), n1);      // the v column
  const int i0 = blockIdx.y * run;
  const int i1 = min(i0 + run, n0);
  const int u_last = min(i1 + 1, n0);     // the last u and v rows read
  const int v_last = min(i1, n0 - 1);
  const float* __restrict__ u = P.u + cu;
  const float* __restrict__ v = P.v + cv;
  auto ldu = [&](int r) { return u[min(r, u_last) * n1]; };
  auto ldv = [&](int r) { return v[max(min(r, v_last), 0) * pv]; };
  // the anchor of the u face at row r and of the v face at row r of this
  // lane's column: the step-start field's, or (Euler) the face's own value
  auto anchor_u = [&](int r, float uc) {
    return BASE ? __ldg(P.bu + r * n1 + cu) : uc;
  };
  auto anchor_v = [&](int r, float vc) {
    return BASE ? __ldg(P.bv + r * pv + cv) : vc;
  };

  // the wall values; the tangential ghosts across a wall are
  // 2 wall - edge
  const float u_lo_wall = P.bc[bc_at(0, 0, 0)];
  const float u_hi_wall = P.bc[bc_at(0, 1, 0)];
  const float v_lo_wall = P.bc[bc_at(1, 0, 1)];
  const float v_hi_wall = P.bc[bc_at(1, 1, 1)];
  const float u_s_wall = 2.f * P.bc[bc_at(1, 0, 0)];
  const float u_n_wall = 2.f * P.bc[bc_at(1, 1, 0)];
  const float v_w_wall = 2.f * P.bc[bc_at(0, 0, 1)];
  const float v_e_wall = 2.f * P.bc[bc_at(0, 1, 1)];
  const bool south = c == 0, north = c == n1 - 1;

  // U[k] = u row i + k, V[k] = v row i - 1 + k for the group of rows
  // [i, i + kGroup); UN, VN the next group's new rows, in flight
  float U[kGroup + 2], V[kGroup + 2], UN[kGroup], VN[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup + 2; ++k) {
    U[k] = ldu(i0 + k);
    V[k] = ldv(i0 - 1 + k);
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    UN[k] = ldu(i0 + kGroup + 2 + k);
    VN[k] = ldv(i0 + kGroup + 1 + k);
  }

  // the carried low u face of row i0: its wall value, or u* recomputed (the
  // run above computes it too)
  float us_lo = u_lo_wall;
  float u0s = __shfl_up_sync(kFull, U[0], 1);     // u(i, c-1)
  float v0n = __shfl_down_sync(kFull, V[1], 1);   // v(i, c+1)
  if (i0 > 0) {
    const float um = u[(i0 - 1) * n1];
    const float u0n = __shfl_down_sync(kFull, U[0], 1);
    const float vmn = __shfl_down_sync(kFull, V[0], 1);
    const float un = north ? u_n_wall - U[0] : u0n;
    const float us = south ? u_s_wall - U[0] : u0s;
    us_lo = u_update<UPWIND>(P, dt, anchor_u(i0, U[0]), U[0], um, U[1], us,
                             un, V[1], V[0], v0n, vmn);
  }
  if (cell && i0 == 0) uo[cu] = us_lo;

  float* uo_row = uo + (i0 + 1) * n1 + cu;  // u* face i + 1
  float* vo_row = vo + i0 * pv + cu;        // v* row i
  float* rhs_row = rhs + i0 * n1 + cu;
  for (int i = i0; i < i1; i += kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int r = i + k;
      if (r < i1) {
        const float uw = U[k], uc = U[k + 1], ue = U[k + 2];
        const float vm = V[k], vc = V[k + 1], vp = V[k + 2];
        const float u1s = __shfl_up_sync(kFull, uc, 1);    // u(r+1, c-1)
        const float u1n = __shfl_down_sync(kFull, uc, 1);  // u(r+1, c+1)
        const float v0s = __shfl_up_sync(kFull, vc, 1);    // v(r, c-1)
        const float v1n = __shfl_down_sync(kFull, vp, 1);  // v(r+1, c+1)
        // u* on the high u face (r+1, c)
        const float un = north ? u_n_wall - uc : u1n;
        const float us = south ? u_s_wall - uc : u1s;
        float us_hi = u_update<UPWIND>(P, dt, anchor_u(r + 1, uc), uc, uw, ue,
                                       us, un, vp, vc, v1n, v0n);
        us_hi = (r + 1 == n0) ? u_hi_wall : us_hi;
        // v* on the low v face (r, c)
        const float ve = (r == n0 - 1) ? v_e_wall - vc : vp;
        const float vw = (r == 0) ? v_w_wall - vc : vm;
        float vs_lo = v_update<UPWIND>(P, dt, anchor_v(r, vc), vc, vw, ve, v0s,
                                       v0n, uw, uc, u0s, u1s);
        vs_lo = (c == 0) ? v_lo_wall : (c == n1 ? v_hi_wall : vs_lo);
        const float vs_hi = __shfl_down_sync(kFull, vs_lo, 1);
        if (cell) {
          *uo_row = us_hi;
          *vo_row = vs_lo;
          if (north) vo_row[1] = vs_hi;
          const float div = (us_hi - us_lo) * P.inv_h[0] +
                            (vs_hi - vs_lo) * P.inv_h[1];
          *rhs_row = div * rho_over_dt;
        }
        uo_row += n1;
        vo_row += pv;
        rhs_row += n1;
        us_lo = us_hi;
        u0s = u1s;
        v0n = v1n;
      }
    }
    // the next group: its rows were loaded one group ago
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      U[k] = U[kGroup + k];
      V[k] = V[kGroup + k];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      U[k + 2] = UN[k];
      V[k + 2] = VN[k];
      UN[k] = ldu(i + 2 * kGroup + 2 + k);
      VN[k] = ldv(i + 2 * kGroup + 1 + k);
    }
  }
}

struct Corr2 {
  const float* us;  // u* (n0+1, n1)
  const float* vs;  // v* (n0, n1+1)
  const float* p;   // (n0, n1)
  const float* scale;  // dt / rho, on the device (ops/step_size.py)
  int n0, n1;
  float inv_h[2];
};

__global__ void __launch_bounds__(kThreads)
correct_diag_2d_kernel(Corr2 C, float* __restrict__ uo,
                       float* __restrict__ vo, int* __restrict__ maxes) {
  const long long ncell = (long long)C.n0 * C.n1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float scale = __ldg(C.scale);
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
    if (i > 0) u_lo = u_lo - scale * ((pc - C.p[idx - n1]) * C.inv_h[0]);
    float u_hi = C.us[iu + n1];
    if (i < C.n0 - 1) {
      u_hi = u_hi - scale * ((C.p[idx + n1] - pc) * C.inv_h[0]);
    }
    float v_lo = C.vs[iv];
    if (j > 0) v_lo = v_lo - scale * ((pc - C.p[idx - 1]) * C.inv_h[1]);
    float v_hi = C.vs[iv + 1];
    if (j < n1 - 1) v_hi = v_hi - scale * ((C.p[idx + 1] - pc) * C.inv_h[1]);
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

// the predictor indexes the arrays' elements in 32 bits
bool fits_int32(int n0, int n1) {
  return (long long)(n0 + 1) * (n1 + 1) < (1ll << 31);
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched); the predictor returns
// cudaErrorInvalidValue for a grid whose arrays hold 2^31 elements or more,
// or for one of bu, bv given without the other. The predictor reads dt and
// rho/dt from `dts`, the corrector dt/rho from `scale`, both device
// pointers; bu, bv null: the Euler form, both given: rk2's based stage 2.

int nss_predictor_rhs_2d(const float* u, const float* v, float* uo, float* vo,
                         float* rhs, const float* bc, const float* bu,
                         const float* bv, const float* dts, int n0, int n1,
                         float inv_h0, float inv_h1, float inv_2h0,
                         float inv_2h1, float inv_hh0, float inv_hh1,
                         float nu, float gamma, float one_minus_gamma,
                         void* stream) {
  if (!fits_int32(n0, n1)) return (int)cudaErrorInvalidValue;
  const bool based = bu != nullptr;
  if ((bv != nullptr) != based) return (int)cudaErrorInvalidValue;
  Pred2 P;
  P.u = u;
  P.v = v;
  P.bu = bu;
  P.bv = bv;
  P.bc = bc;
  P.dts = dts;
  P.n0 = n0;
  P.n1 = n1;
  P.inv_h[0] = inv_h0;
  P.inv_h[1] = inv_h1;
  P.inv_2h[0] = inv_2h0;
  P.inv_2h[1] = inv_2h1;
  P.inv_hh[0] = inv_hh0;
  P.inv_hh[1] = inv_hh1;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  const int bx = blocks_x_for(n1, kPredCols);
  const int run = run_for(n0, bx);
  const dim3 grid(bx, (n0 + run - 1) / run);
  // [base][upwind]
  using Kernel = void (*)(Pred2, float*, float*, float*, int);
  const Kernel kernels[2][2] = {
      {predictor_rhs_2d_kernel<false, false>,
       predictor_rhs_2d_kernel<true, false>},
      {predictor_rhs_2d_kernel<false, true>,
       predictor_rhs_2d_kernel<true, true>}};
  kernels[based][gamma > 0.f]<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      P, uo, vo, rhs, run);
  return (int)cudaGetLastError();
}

int nss_correct_diag_2d(const float* us, const float* vs, const float* p,
                        float* uo, float* vo, int* maxes, const float* scale,
                        int n0, int n1, float inv_h0, float inv_h1,
                        void* stream) {
  Corr2 C;
  C.us = us;
  C.vs = vs;
  C.p = p;
  C.scale = scale;
  C.n0 = n0;
  C.n1 = n1;
  C.inv_h[0] = inv_h0;
  C.inv_h[1] = inv_h1;
  correct_diag_2d_kernel<<<blocks_for((long long)n0 * n1), kThreads, 0,
                           (cudaStream_t)stream>>>(C, uo, vo, maxes);
  return (int)cudaGetLastError();
}

}  // extern "C"
