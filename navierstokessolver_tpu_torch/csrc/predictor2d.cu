// 2D per-component predictor for Hopper (sm_90a), plain C interface.
//
//   nss_predictor_2d  replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                     _predictor_component_kernel (launched through
//                     _component_call by predictor_2d, once per velocity
//                     component): the explicit advection-diffusion update
//                     u* = u + dt (nu lap u - (u . grad) u) of both
//                     components of a 2D field, advective-form central
//                     differences blended with donor-cell upwinding by
//                     gamma, plus (FORCE) a body force, on every face that
//                     is not a boundary face of its own axis.
//                     navierstokessolver_tpu_torch/ops/predictor2d.py binds
//                     it with ctypes.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32:
// u is (n0+1, n1), v is (n0, n1+1). The TPU kernel's 128-row stripes with
// 8-row DMA overshoot, its 128-lane padded width and the host-side
// pad_transverse / _edge_pad / _pad_to copies before each call do not carry
// over. The ghosts across the transverse domain faces are synthesised in
// the kernel as alpha * edge + beta[pos] from a ghost table in device
// memory that the wrapper builds once per simulation (ops/predictor2d.py
// ghost_table): alpha[4] (u across the axis-1 low / high faces, v across
// the axis-0 low / high faces), then the four beta vectors in that order,
// indexed by u row (n0 + 1 values) and by v column (n1 + 1): (-1, 2 u_bc)
// across WALL and INFLOW faces, a constant or a profile, and (1, 0) across
// SLIP and OUTFLOW faces. Along a component's own axis no ghost is needed:
// the boundary faces are not updated here (the kernel writes their input
// value, which the caller's BC pass then overwrites), and every interior
// face's neighbours lie in the array.
//
// Arithmetic follows the Pallas kernel: the spacings enter as multiplies by
// 1/h, 1/(2h) and 1/h^2 rounded to float32 (the wrapper passes them), the
// transverse velocity is 0.25 (((a + b) + c) + d) over the four faces
// around the face in the Pallas operand order, the upwind blend
// gamma d_u + (1 - gamma) d_c is formed only when gamma > 0, and the update
// is c + dt (nu lap - adv). jnp.where(vel > 0, bwd, fwd) is kept exactly:
// zero velocity takes fwd. dt is read from a float32 device buffer once by
// every thread (ops/step_size.py), so a dt the device computed (the
// CFL-adaptive step) costs no host read.
//
// The body force (the FORCE template argument; the JAX step's jnp predictor
// with ``forcing``, which its kernel route does not take): one forcing
// volume a component, in the layout of the plain predictor's forcing (the
// interior faces of the component's own axis: u (n0 - 1, n1), face r at
// row r - 1, and v (n0, n1 - 1)), added to the RHS before the multiply by
// dt, c + dt ((nu lap - adv) + f): the static force as a constant volume,
// Boussinesq buoyancy as the volume the step forms from theta. A component
// without a force has a null volume (a uniform branch); the instantiations
// without FORCE carry no trace of it.
//
// What bounds it on this card: a memory-bound stencil. It must read u and v
// and write u* and v*: 16 B per cell, 33.6 MB at 2048x1024, 10 us at the
// H100's 3.35 TB/s, against ~72 float32 operations per cell (2.2 us at 67
// TFLOP/s). So the design moves each value once and computes each face
// once, as kernel 4's march (csrc/fused2d.cu) does for the fused step:
//
//   * Each warp marches a strip of columns of axis 1 down a run of rows of
//     axis 0 on its own (no shared memory, no barrier). Lane l holds column
//     c0 + l - 1 of u and v; lanes 1..30 own cells, lane 0 (the column
//     before) and lane 31 (the column after) are the strip's halo. With no
//     divergence to form, the last cell's high v face is the next strip's,
//     so a strip owns 30 columns (kernel 4's owns 29). Neighbours along
//     axis 1 come from warp shuffles.
//   * Each lane keeps the rows of its column that the stencil spans in
//     registers, a group of kGroup rows at a time, and loads the next
//     group's rows while it computes this one.
//   * At row r the lane of column c computes u*(r+1, c), the cell's high u
//     face, and v*(r, c), its low v face; each face once, in one pass over
//     both fields, so u* and v* share every load.
//   * The transverse ghosts of u cost the cells nothing: the halo lane of
//     column -1 (and of column n1) reads the edge column (its column is
//     clamped into the array) and turns each row into the ghost
//     alpha * edge + beta[row] as the row arrives, so the shuffle that
//     brings a neighbour brings the ghost. Only those lanes load beta. The
//     ghosts of v, on the first and last rows, are selects with the beta of
//     the lane's column, loaded once a run by the runs at the domain edge.
//   * Index arithmetic is 32-bit (arrays of < 2^31 elements) and rows are
//     clamped to the array, so no load is guarded; own-axis boundary faces
//     are computed on clamped neighbours and then replaced by their input
//     value (a select), so no lane branches.
//   * Runs of 16-64 rows, as many as one wave of resident blocks holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;               // warps a block, each on its own
constexpr int kBlock = 32 * kWarps;     // threads a block
constexpr int kCols = 30;               // cells a warp owns
constexpr int kGroup = 4;               // rows loaded ahead, per field
constexpr int kMinRun = 16;             // rows of axis 0 a warp marches, at
constexpr int kMaxRun = 64;             // least and at most
constexpr int kBlocksPerSM = 6;         // the launch bound
constexpr unsigned kFull = 0xffffffffu;

struct Pred2c {
  const float* u;      // (n0+1, n1)
  const float* v;      // (n0, n1+1)
  const float* ghost;  // alpha[4], beta u lo / hi (n0+1), v lo / hi (n1+1)
  int n0, n1;
  float inv_h[2];      // 1/h_a
  float inv_2h[2];     // 1/(2 h_a)
  float inv_hh[2];     // 1/h_a^2
  const float* dt;     // the step size, on the device (ops/step_size.py)
  const float* fu;     // FORCE: the forcing volumes of u and v, or null
  const float* fv;
  float nu, gamma, one_minus_gamma;
};

// One face's update from its centre c, its neighbours along axis 0 (e: +1,
// w: -1) and axis 1 (n: +1, s: -1), and the transport velocities along the
// two axes; FORCE: the force f added to the RHS.
template <bool UPWIND, bool FORCE>
__device__ __forceinline__ float update(const Pred2c& P, float dt, float c,
                                        float e, float w, float n, float s,
                                        float vel0, float vel1, float f) {
  const float d0c = (e - w) * P.inv_2h[0];
  const float d1c = (n - s) * P.inv_2h[1];
  float d0 = d0c;
  float d1 = d1c;
  if (UPWIND) {
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
  float rhs = P.nu * lap - adv;
  if (FORCE) rhs = rhs + f;
  return c + dt * rhs;
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

// Blocks along axis 1: kWarps strips of kCols cells each.
inline int blocks_x_for(int n1) {
  const int strips = (n1 + kCols - 1) / kCols;
  return (strips + kWarps - 1) / kWarps;
}

// One block: kWarps warps, each on its own strip of kCols cells of axis 1
// and the run of rows [i0, i1). FORCE: the forcing volumes.
template <bool UPWIND, bool FORCE>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
predictor_2d_kernel(Pred2c P, float* __restrict__ uo,
                    float* __restrict__ vo, int run) {
  const int n0 = P.n0, n1 = P.n1, pv = n1 + 1;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kCols;
  if (c0 >= n1) return;  // a warp past the last strip (no barrier follows)
  const float dt = __ldg(P.dt);
  const int c = c0 + lane - 1;
  const bool cell = lane >= 1 && lane <= kCols && c < n1;
  const int cu = min(max(c, 0), n1 - 1);  // the u column it reads
  const int cv = min(max(c, 0), n1);      // the v column
  const int i0 = blockIdx.y * run;
  const int i1 = min(i0 + run, n0);
  const int u_last = min(i1 + 1, n0);     // the last u and v rows read
  const int v_last = min(i1, n0 - 1);
  const float* __restrict__ u = P.u + cu;
  const float* __restrict__ v = P.v + cv;
  auto ldu = [&](int r) { return u[min(r, u_last) * n1]; };
  auto ldv = [&](int r) { return v[max(min(r, v_last), 0) * pv]; };
  // FORCE: the force of the u face (r + 1, c) and of the v face (r, c),
  // from the volumes (clamped: a boundary face or a halo lane reads a face
  // it does not use); 0 for a component without one
  const int fcol = min(max(c - 1, 0), n1 - 2);
  auto force_u = [&](int r) {
    return (FORCE && P.fu != nullptr)
               ? __ldg(P.fu + min(r, n0 - 2) * n1 + cu) : 0.f;
  };
  auto force_v = [&](int r) {
    return (FORCE && P.fv != nullptr)
               ? __ldg(P.fv + r * (n1 - 1) + fcol) : 0.f;
  };

  // the u ghost lanes: column -1 reflects through the axis-1 low face,
  // column n1 through the high face
  const float* __restrict__ beta_u = P.ghost + 4;
  const bool ghost = c == -1 || c == n1;
  const float alpha_u = (c == -1) ? P.ghost[0] : P.ghost[1];
  if (c == n1) beta_u += n0 + 1;
  auto ldb = [&](int r) { return ghost ? beta_u[min(r, u_last)] : 0.f; };
  auto as_ghost = [&](float x, float b) {
    return ghost ? alpha_u * x + b : x;
  };
  // the v ghosts on rows 0 and n0 - 1, beta by column
  const float* __restrict__ beta_v = P.ghost + 4 + 2 * (n0 + 1);
  const float alpha_w = P.ghost[2], alpha_e = P.ghost[3];
  const float beta_w = (i0 == 0) ? beta_v[cv] : 0.f;
  const float beta_e = (i1 == n0) ? beta_v[pv + cv] : 0.f;

  // U[k] = u row i + k, V[k] = v row i - 1 + k for the group of rows
  // [i, i + kGroup); UN, VN, BN the next group's new rows, in flight
  float U[kGroup + 2], V[kGroup + 2], UN[kGroup], VN[kGroup], BN[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup + 2; ++k) {
    U[k] = ldu(i0 + k);
    V[k] = ldv(i0 - 1 + k);
  }
#pragma unroll
  for (int k = 0; k < kGroup + 2; ++k) U[k] = as_ghost(U[k], ldb(i0 + k));
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    UN[k] = ldu(i0 + kGroup + 2 + k);
    VN[k] = ldv(i0 + kGroup + 1 + k);
    BN[k] = ldb(i0 + kGroup + 2 + k);
  }

  // u row 0 keeps its input
  if (cell && i0 == 0) uo[cu] = U[0];
  float u0s = __shfl_up_sync(kFull, U[0], 1);     // u(i, c-1)
  float v0n = __shfl_down_sync(kFull, V[1], 1);   // v(i, c+1)

  float* uo_row = uo + (i0 + 1) * n1 + cu;  // u* face i + 1
  float* vo_row = vo + i0 * pv + cu;        // v* row i
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
        // u* on the high u face (r+1, c); the v faces around it in the
        // Pallas order: cells r, r+1 on face c, then on face c+1
        const float vbar = 0.25f * (((vc + vp) + v0n) + v1n);
        float us = update<UPWIND, FORCE>(P, dt, uc, ue, uw, u1n, u1s, uc,
                                         vbar, force_u(r));
        us = (r + 1 == n0) ? uc : us;
        // v* on the low v face (r, c); the u faces around it: faces r,
        // r+1 of cell c-1, then of cell c
        const float ve = (r == n0 - 1) ? alpha_e * vc + beta_e : vp;
        const float vw = (r == 0) ? alpha_w * vc + beta_w : vm;
        const float ubar = 0.25f * (((u0s + u1s) + uw) + uc);
        float vs = update<UPWIND, FORCE>(P, dt, vc, ve, vw, v0n, v0s, ubar,
                                         vc, force_v(r));
        vs = (c == 0 || c == n1) ? vc : vs;
        const float vs_hi = __shfl_down_sync(kFull, vs, 1);
        if (cell) {
          *uo_row = us;
          *vo_row = vs;
          if (c == n1 - 1) vo_row[1] = vs_hi;  // v column n1: its input
        }
        uo_row += n1;
        vo_row += pv;
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
      U[k + 2] = as_ghost(UN[k], BN[k]);
      V[k + 2] = VN[k];
      UN[k] = ldu(i + 2 * kGroup + 2 + k);
      VN[k] = ldv(i + 2 * kGroup + 1 + k);
      BN[k] = ldb(i + 2 * kGroup + 2 + k);
    }
  }
}

// the kernel indexes the arrays' elements in 32 bits
bool fits_int32(int n0, int n1) {
  return (long long)(n0 + 1) * (n1 + 1) < (1ll << 31);
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a grid whose arrays hold
// 2^31 elements or more. `ghost` is the table described at the top, `dt`
// a device pointer to the step size; fu, fv the forcing volumes (either
// may be null; both null: the instantiation without FORCE).
int nss_predictor_2d(const float* u, const float* v, float* uo, float* vo,
                     const float* ghost, const float* dt, const float* fu,
                     const float* fv, int n0, int n1,
                     float inv_h0, float inv_h1, float inv_2h0,
                     float inv_2h1, float inv_hh0, float inv_hh1, float nu,
                     float gamma, float one_minus_gamma, void* stream) {
  if (!fits_int32(n0, n1)) return (int)cudaErrorInvalidValue;
  Pred2c P;
  P.u = u;
  P.v = v;
  P.ghost = ghost;
  P.n0 = n0;
  P.n1 = n1;
  P.inv_h[0] = inv_h0;
  P.inv_h[1] = inv_h1;
  P.inv_2h[0] = inv_2h0;
  P.inv_2h[1] = inv_2h1;
  P.inv_hh[0] = inv_hh0;
  P.inv_hh[1] = inv_hh1;
  P.dt = dt;
  P.fu = fu;
  P.fv = fv;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  const int bx = blocks_x_for(n1);
  const int run = run_for(n0, bx);
  const dim3 grid(bx, (n0 + run - 1) / run);
  cudaStream_t s = (cudaStream_t)stream;
  using Kernel = void (*)(Pred2c, float*, float*, int);
  // [force][upwind]
  const Kernel kernels[2][2] = {
      {predictor_2d_kernel<false, false>, predictor_2d_kernel<true, false>},
      {predictor_2d_kernel<false, true>, predictor_2d_kernel<true, true>}};
  const bool force = fu != nullptr || fv != nullptr;
  kernels[force][gamma > 0.f]<<<grid, kBlock, 0, s>>>(P, uo, vo, run);
  return (int)cudaGetLastError();
}

}  // extern "C"
