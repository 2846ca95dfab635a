// The 3D LES step's predictor and Smagorinsky eddy-viscosity kernels for
// Hopper (sm_90a), plain C interface (navierstokessolver_tpu_torch/ops/
// predictor3d.py binds them with ctypes):
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
//                      the BC value on each component's own-axis boundary
//                      faces (an OUTFLOW face: the inner face's u*) and,
//                      with an obstacle, zeroes the blocked faces.
//
// Layout: the exact MAC layout of the port's State, C-contiguous float32.
// u0 is (n0+1, n1, n2), u1 (n0, n1+1, n2), u2 (n0, n1, n2+1); nu_t is
// (n0, n1, n2). The TPU kernels' canonical operands (128-lane padding, u2's
// elided face n2, aprons on axes 0/1 and lane-roll fixes on axis 2) do not
// carry over. Ghosts come from kernel 1's buffer (march.cuh ghost_of: the
// wall values bc[(axis*2 + side)*3 + comp] and their ghost maps): a
// velocity beyond a wall along a transverse axis is the reflection 2*v_bc
// - edge (the TPU kernels' bc_ghost_slab_3d aprons and
// tangential lane fixes); nu_t beyond a wall is the edge value along each
// axis (les._pad_cells, nt_canon_3d).
//
// Periodic axes (PER, bit a set when axis a is periodic; the LES
// instantiations, every mask 1..7): the march's staging wraps (march.cuh),
// a component's own faces 0..n-1 are all updated, nu_t's ghosts wrap, and
// the thread that writes face 0 of a periodic own axis also writes face n,
// the same value (face n repeats face 0, as the plain predictor's
// _with_duplicate makes it).
// Forced mode (kernels of their own, predictor_3d_forced_kernel<PER,
// UPWIND>, LES on walls and periodic axes: the JAX step's jnp predictor
// with the subgrid stress merged into the force, `forcing + sgs`, which
// the TPU kernel route does not take): each face adds to its subgrid
// stress, before the RHS, a force read as kernel 1's FORCE mode reads it
// (fused3d.cu), so that one set of the simulation's buffers serves both
// kernels: the static force of component a, entry 18 + a of the bc buffer
// (refilled by the step where it depends on time), or the component's
// forcing volume (the plain predictor's forcing layout: the interior faces
// of a bounded own axis, all n of a periodic one), plus the Boussinesq
// force g_a beta (0.5 ((theta_m - theta_ref) + (theta_c - theta_ref))) of
// the face's two cells where theta is given and the axis's buoyancy (the
// scalar's thermal buffer) is not zero. The force is read where a face
// needs it, from device memory through L1 at the thread's own offsets (no
// staging: one float a face, theta's two cells mostly the tile's own); the
// existing instantiations carry no trace of it (a template argument of the
// march, and the force's pointers in an argument of the forced kernels
// alone, so that the params struct of the others is unchanged).
// Open modes (kernels of their own, nu_t_3d_open_kernel and
// predictor_3d_open_kernel<UPWIND, OPEN>, LES only, no periodic axis): the
// faces' kinds come from the bc buffer's ghost maps (march.cuh KINDS: WALL
// and INFLOW reflect 2 v_bc - edge, SLIP, OUTFLOW and CONVECTIVE copy the
// edge; the TPU kernels' _lane_fixes and bc_ghost_slab_3d), nu_t's ghosts
// replicate the edge. The predictor writes a WALL, INFLOW or SLIP own
// face's bc value, on an OUTFLOW face (bit 2 axis + side of `copy`) the
// inner face's u* (face n - 1's at a high side, face 1's at a low side,
// handed over by its thread: a warp shuffle on axis 2, shared memory on
// axis 1; OUTFLOW at (0, 0) is refused, as by kernels 1-2), and on a
// CONVECTIVE face at (0, 1) its carried value, which the step then
// transports (the TPU kernel refuses that face; JAX's jnp predictor leaves
// it so). OPEN 2 adds an
// obstacle's masks: each cell's stencil code (ops/poisson.py, one byte a
// cell, loaded a step ahead) gates its thread's faces after the stencil and
// the copies, as bcs.apply_velocity_bcs applies the face masks after the
// BC values (a face is open when both its cells are fluid, a boundary face
// when its one cell is); the stencil reads the input as it is. nu_t is
// computed on every cell, solid ones too, as in the JAX package. Existing
// instantiations keep their code: the open modes' march is the same body
// with OPEN > 0, instantiated only by their own kernels.
//
// What bounds them on this card: both are memory-bound stencils by their
// bytes. nu_t must read three face fields and write one cell field (16 B a
// cell), the LES predictor read four fields and write three (28 B a cell):
// at 256^3 0.27 and 0.47 GB a call against the H100's 3.35 TB/s (0.080 and
// 0.141 ms). Both are the tiled axis-0 march of kernels 1-2 (march.cuh):
//   - a block of 256 threads owns a tile of 8 rows of axis 1 by 32 cells of
//     axis 2, one thread a cell, and walks a run of axis-0 cell planes
//     (run_for); partial runs and edge tiles are masked;
//   - every input field's planes pass through a ring of plane slots in
//     shared memory with a one-cell halo (u0 face planes, u1, u2 and nu_t
//     cell planes), filled by 4-byte cp.async two planes ahead; the wall
//     ghosts are made once, where an element is staged, so the arithmetic
//     reads the rings with no case analysis; offsets are 32-bit inside a
//     plane plus one 64-bit plane base;
//   - nu_t: the TPU kernel's telescoping of the 4-edge average of each
//     off-diagonal gradient, <du_a/dx_b> = (P_a(b+1) - P_a(b-1)) / (4 h_b)
//     with P_a the sum of u_a's two own-axis faces of a cell;
//   - the predictor: each face's u* once, all three components in one block
//     (u*_0 at the plane's low face, u*_1 and u*_2 of the plane; the high
//     boundary faces take their wall values); the advection and diffusion
//     in the Pallas kernel's arithmetic (reciprocals 1/h, 1/(2h) = 0.5/h,
//     1/h^2 formed by the caller as the JAX kernel forms them, the
//     four-point transverse average 0.25*(((a+b)+c)+d), zero velocity
//     taking the forward difference); the subgrid stress tau_Ct = 2 nu_t,e
//     S_Ct of each (C, t) edge computed once a plane into shared memory
//     (nu_t averaged onto the edge from its four cells) and differenced by
//     the faces of both C and t, as les.sgs_forcing differences it;
//   - the predictor is a template on gamma > 0, picked once by the host,
//     so that at gamma = 0 no upwind difference is formed, and on LES, so
//     the plain advection-diffusion update stages no nu_t; its shared
//     memory (50.5 KB with LES) is dynamic;
//   - launch bounds hold 3 predictor blocks (<= 80 registers) and 4 nu_t
//     blocks (<= 64) on an SM with no spill;
//   - the predictor reads dt from a float32 device buffer once a thread
//     (ops/step_size.py), so a dt the device computed costs no host read.
// Both are bound by instruction issue and the march's own work (the 4-byte
// copies of the halos, the ghost fixes, a barrier a plane) rather than by
// bytes; PERF.md has their shares of the bounds.

#include <cuda_runtime.h>

#include "common.cuh"
#include "march.cuh"

namespace {

using namespace nss::march;
using nss::Grid3;
using nss::kThreads;

// -- kernel 7: eddy viscosity (replaces _nu_t3d_kernel) ----------------------

struct NutParams {
  const float* u[3];
  const float* bc;  // wall value [(axis*2 + side)*3 + comp]
  Grid3 g;
  float inv_h[3];   // float32(1/h_a)
  float scale;      // float32(cs^2 Delta^2)
  int run;          // axis-0 planes a block marches
};

// kernel 7's shared memory: a ring of each velocity component's planes
struct NutShared {
  float s0[kSlots][R0::kSize];  // u0 faces x, x + 1
  float s1[kSlots][R1::kSize];  // u1 cells x - 1..x + 1
  float s2[kSlots][R2::kSize];  // u2 cells x - 1..x + 1
};

// The march of one block of kernel 7; KINDS: the faces' kinds from the bc
// buffer (the open modes)
template <int PER, bool KINDS>
__device__ __forceinline__ void nu_t_march(NutShared& S, const NutParams& P,
                                           float* __restrict__ out) {
  const int n0 = P.g.n[0], n1 = P.g.n[1], n2 = P.g.n[2];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int z0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int xs = blockIdx.z * P.run, xe = min(xs + P.run, n0);
  const int y = y0 + ty, z = z0 + tx;
  const bool valid = y < n1 && z < n2;
  const long long st0 = (long long)n1 * n2;  // plane strides
  const long long st1 = (long long)(n1 + 1) * n2;
  const long long st2 = (long long)n1 * (n2 + 1);
  const float* bc = P.bc;

  Stager<R0, 0, PER, true, KINDS> L0;
  Stager<R1, 1, PER, true, KINDS> L1;
  Stager<R2, 2, PER, true, KINDS> L2;
  L0.init(S.s0, n1, n2, y0, z0, bc);
  L1.init(S.s1, n1, n2, y0, z0, bc);
  L2.init(S.s2, n1, n2, y0, z0, bc);

  float a, b;
  auto issue0 = [&](int p) {
    L0.issue(p & (kSlots - 1),
             P.u[0] + row_of<0, PER, 0, true, KINDS>(p, n0, bc, a, b) * st0);
  };
  auto issue12 = [&](int p) {
    L1.issue(p & (kSlots - 1),
             P.u[1] + row_of<1, PER, 0, true, KINDS>(p, n0, bc, a, b) * st1);
    L2.issue(p & (kSlots - 1),
             P.u[2] + row_of<2, PER, 0, true, KINDS>(p, n0, bc, a, b) * st2);
  };
  auto fix0 = [&](int p) {
    row_of<0, PER, 0, true, KINDS>(p, n0, bc, a, b);
    L0.fix(S.s0[p & (kSlots - 1)], a, b);
  };
  auto fix12 = [&](int p) {
    row_of<1, PER, 0, true, KINDS>(p, n0, bc, a, b);
    L1.fix(S.s1[p & (kSlots - 1)], a, b);
    row_of<2, PER, 0, true, KINDS>(p, n0, bc, a, b);
    L2.fix(S.s2[p & (kSlots - 1)], a, b);
  };
  // stage k of the march: plane k + 1 of every field, what step k reads
  // beyond step k - 1
  auto issue_stage = [&](int k) {
    if (k < xe) {
      issue0(k + 1);
      issue12(k + 1);
    }
    cp_commit();
  };
  auto fix_stage = [&](int k) {
    if (k < xe) {
      fix0(k + 1);
      fix12(k + 1);
    }
  };

  // step xs reads u0 faces xs, xs + 1 and u1, u2 cells xs - 1..xs + 1
  issue0(xs);
  issue12(xs - 1);
  issue12(xs);
  cp_commit();
#pragma unroll
  for (int k = 0; k < kAhead; ++k) issue_stage(xs + k);
  cp_wait<kAhead - 1>();
  fix0(xs);
  fix12(xs - 1);
  fix12(xs);
  fix_stage(xs);
  __syncthreads();

  auto at0 = [&](int p, int r, int q) {
    return S.s0[p & (kSlots - 1)][r * R0::kCols + q];
  };
  auto at1 = [&](int p, int r, int q) {
    return S.s1[p & (kSlots - 1)][r * R1::kCols + q];
  };
  auto at2 = [&](int p, int r, int q) {
    return S.s2[p & (kSlots - 1)][r * R2::kCols + q];
  };
  const float ih0 = P.inv_h[0], ih1 = P.inv_h[1], ih2 = P.inv_h[2];
  // the cell's staged row and column (u1's row r is its face y, u2's
  // column q its face z)
  const int r = ty + 1, q = tx + 1;

  for (int x = xs; x < xe; ++x) {
    issue_stage(x + kAhead);
    const float s00 = (at0(x + 1, r, q) - at0(x, r, q)) * ih0;
    const float s11 = (at1(x, r + 1, q) - at1(x, r, q)) * ih1;
    const float s22 = (at2(x, r, q + 1) - at2(x, r, q)) * ih2;
    float s2 = s00 * s00;
    s2 = s2 + s11 * s11;
    s2 = s2 + s22 * s22;
    // P_a at a staged cell: the sum of u_a's two faces along a
    auto p0 = [&](int rr, int qq) {
      return at0(x, rr, qq) + at0(x + 1, rr, qq);
    };
    auto p1 = [&](int p, int qq) { return at1(p, r, qq) + at1(p, r + 1, qq); };
    auto p2 = [&](int p, int rr) { return at2(p, rr, q) + at2(p, rr, q + 1); };
    // <du_a/dx_b> at the centre, the 4-edge average telescoped
    const float d01 = (0.25f * ih1) * (p0(r + 1, q) - p0(r - 1, q));
    const float d02 = (0.25f * ih2) * (p0(r, q + 1) - p0(r, q - 1));
    const float d10 = (0.25f * ih0) * (p1(x + 1, q) - p1(x - 1, q));
    const float d12 = (0.25f * ih2) * (p1(x, q + 1) - p1(x, q - 1));
    const float d20 = (0.25f * ih0) * (p2(x + 1, r) - p2(x - 1, r));
    const float d21 = (0.25f * ih1) * (p2(x, r + 1) - p2(x, r - 1));
    const float s01 = 0.5f * (d01 + d10);
    const float s02 = 0.5f * (d02 + d20);
    const float s12 = 0.5f * (d12 + d21);
    s2 = s2 + 2.f * (s01 * s01);
    s2 = s2 + 2.f * (s02 * s02);
    s2 = s2 + 2.f * (s12 * s12);
    if (valid) out[x * st0 + y * n2 + z] = P.scale * sqrtf(2.f * s2);
    cp_wait<kAhead - 1>();
    fix_stage(x + 1);
    __syncthreads();
  }
  cp_wait<0>();
}

// kernel 7 on walls and periodic axes
template <int PER>
__global__ void __launch_bounds__(kThreads, 4)
nu_t_3d_kernel(NutParams P, float* __restrict__ out) {
  __shared__ NutShared S;
  nu_t_march<PER, false>(S, P, out);
}

// kernel 7's open mode: INFLOW, OUTFLOW and SLIP faces, no periodic axis
__global__ void __launch_bounds__(kThreads, 4)
nu_t_3d_open_kernel(NutParams P, float* __restrict__ out) {
  __shared__ NutShared S;
  nu_t_march<0, true>(S, P, out);
}

// -- kernel 6: the per-component predictor (replaces _predictor3d_kernel) ----

struct PredParams {
  const float* u[3];
  const float* nu_t;  // (n0, n1, n2); read only by the LES instantiations
  const float* bc;    // wall value [(axis*2 + side)*3 + comp]
  Grid3 g;
  float inv_h[3];     // float32(1/h_a)
  float inv2h[3];     // 0.5 * float32(1/h_a) = float32(1/(2 h_a))
  float inv_hh[3];    // float32(1/h_a^2)
  const float* dt;    // the step size, on the device (ops/step_size.py)
  float nu, gamma, one_minus_gamma;
  int run;            // axis-0 planes a block marches
};

// tau_Ct of a plane's (C, t) edges on the tile: tau_01 at faces y0..y0+8 of
// axis 1 and cells z0..z0+31, tau_02 at cells y0..y0+7 and faces
// z0..z0+32, tau_12 at faces y0..y0+8 and z0..z0+32, row-major
constexpr int kE01 = (kTY + 1) * kTX;
constexpr int kE02 = kTY * (kTX + 1);
constexpr int kE12 = (kTY + 1) * (kTX + 1);

struct VelRings {
  float s0[kSlots][R0::kSize];  // u0 faces x - 1..x + 1
  float s1[kSlots][R1::kSize];  // u1 cells x - 1..x + 1
  float s2[kSlots][R2::kSize];  // u2 cells x - 1..x + 1
};
struct LesShared {
  float nt[kSlots][RP::kSize];  // nu_t cells x - 1..x + 1
  float t01[2][kE01];           // tau_01 on face planes x, x + 1 (slot f & 1)
  float t02[2][kE02];           // tau_02 likewise
  float t12[kE12];              // tau_12 on cell plane x
};
// kernel 6's shared memory, dynamic (above 48 KB with LES); an
// instantiation without LES is given the bytes of `v` alone
struct PredShared {
  VelRings v;
  LesShared les;
};

// 0.25*(((a+b)+c)+d), the Pallas kernel's four-point average
__device__ __forceinline__ float avg4(float a, float b, float c, float d) {
  return 0.25f * (((a + b) + c) + d);
}

// nu * lap - adv at a face from its centre value c, its -1 / +1 neighbours
// along each axis and the velocity advecting it along each axis, in the
// arithmetic of the Pallas kernel: central differences blended with
// donor-cell upwinding (UPWIND: gamma > 0), plus the viscous Laplacian
template <bool UPWIND>
__device__ __forceinline__ float advect_diffuse(const PredParams& P, float c,
                                                const float (&um)[3],
                                                const float (&up)[3],
                                                const float (&vel)[3]) {
  float adv = 0.f, lap = 0.f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float m = um[ax], p = up[ax];
    const float d_c = (p - m) * P.inv2h[ax];
    float d = d_c;
    if (UPWIND) {
      // zero velocity takes the forward difference, as
      // jnp.where(vel > 0, bwd, fwd) does
      const float d_u = (vel[ax] > 0.f) ? (c - m) * P.inv_h[ax]
                                        : (p - c) * P.inv_h[ax];
      d = P.gamma * d_u + P.one_minus_gamma * d_c;
    }
    adv = adv + vel[ax] * d;
    lap = lap + (p - 2.f * c + m) * P.inv_hh[ax];
  }
  return P.nu * lap - adv;
}

// (tau_CC(hi) - tau_CC(lo)) / h_C, tau_CC = 2 nu_t S_CC at the cells on
// either side of a face of C (S_CC from the face's own-axis neighbours)
__device__ __forceinline__ float own_axis_stress(float n_lo, float n_hi,
                                                 float m, float c, float p,
                                                 float ih) {
  const float t_hi = (2.f * n_hi) * ((p - c) * ih);
  const float t_lo = (2.f * n_lo) * ((c - m) * ih);
  return (t_hi - t_lo) * ih;
}

// tau_Ct = 2 nu_t,e S_Ct, S_Ct = (du_C/dx_t + du_t/dx_C) / 2 at an edge,
// nu_t averaged from the edge's four cells
__device__ __forceinline__ float edge_stress(float du_c, float du_t,
                                             float n00, float n10, float n01,
                                             float n11) {
  const float nt_e = avg4(n00, n10, n01, n11);
  return 2.f * nt_e * (0.5f * (du_c + du_t));
}

// Element e of a plane's edge array of `size` (256 < size <= 512): thread
// tid takes e = tid and the threads from `first` on (mod 256) the rest, so
// the extra work of the arrays falls on different warps.
template <class F>
__device__ __forceinline__ void each_edge(int size, int first, F&& fn) {
  fn((int)threadIdx.x);
  const int k = ((int)threadIdx.x - first) & (kThreads - 1);
  if (k < size - kThreads) fn(kThreads + k);
}

// the open mask's bit of a CONVECTIVE face at (0, 1) (ops/fused3d.py
// OPEN_CONV)
constexpr int kOpenConv = 128;

// What the open modes add to kernel 6's arguments: the stencil code (OPEN
// 2), the OUTFLOW faces (bit 2 axis + side) and the CONVECTIVE face
// (kOpenConv), and a row of shared memory that hands face 1's u*_1 to the
// threads of face 0 (an OUTFLOW face at (1, 0))
struct OpenArgs {
  const uint8_t* code;
  int copy;
  float* row;
};

// What the forced mode adds to kernel 6's arguments: theta and the
// scalar's thermal buffer (both null without buoyancy), the forcing volume
// of each component (null: its static force from the bc buffer) and the
// volumes' plane strides (elements of an axis-0 plane)
struct ForceArgs {
  const float* th;
  const float* tt;
  const float* fv[3];
  int fpl[3];
};

// the thermal buffer's buoyancy of axis a at kTBuoy + a and theta_ref
// (scalar.thermal_table, as fused3d.cu reads it); the static force of
// component a in the bc buffer
constexpr int kTBuoy = 12, kTRef = 15;
constexpr int kForceAt = 18;

// The index along an axis of n cells of a forcing volume's face i of a
// thread's cell (i < n, or a thread outside the grid): i - 1 clamped into
// the n - 1 interior faces of a bounded axis (face 0 takes its wall value),
// i clamped into the n faces of a periodic one
__device__ __forceinline__ int force_face(int i, int n, bool per) {
  return per ? min(i, n - 1) : min(max(i - 1, 0), n - 2);
}

// The march of one block of kernel 6. OPEN (the open modes' own kernel): 1
// the faces' kinds from the bc buffer and the OUTFLOW copies, 2 also an
// obstacle's masks from the stencil code; 0 in the walls and periodic
// instantiations, which read nothing of `O`. FORCE (the forced kernel,
// LES on walls and periodic axes): the force of `F` added to the subgrid
// stress; the others read nothing of `F`.
template <int PER, bool LES, bool UPWIND, int OPEN, bool FORCE = false>
__device__ __forceinline__ void predictor_march(
    const PredParams& P, OpenArgs O, const ForceArgs& F,
    float* __restrict__ o0, float* __restrict__ o1,
    float* __restrict__ o2) {
  static_assert(OPEN == 0 || (PER == 0 && LES),
                "the open modes are LES instantiations on bounded grids");
  static_assert(!FORCE || (OPEN == 0 && LES),
                "the forced mode is an LES mode on walls and periodic axes");
  constexpr bool KINDS = OPEN > 0, MASKED = OPEN == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  PredShared& S = *reinterpret_cast<PredShared*>(smem);
  auto& s0 = S.v.s0;
  auto& s1 = S.v.s1;
  auto& s2 = S.v.s2;

  const int n0 = P.g.n[0], n1 = P.g.n[1], n2 = P.g.n[2];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int z0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int xs = blockIdx.z * P.run, xe = min(xs + P.run, n0);
  const float dt = __ldg(P.dt);
  const int y = y0 + ty, z = z0 + tx;
  const bool valid = y < n1 && z < n2;
  const long long st0 = (long long)n1 * n2;  // plane strides (u0, nu_t)
  const long long st1 = (long long)(n1 + 1) * n2;
  const long long st2 = (long long)n1 * (n2 + 1);
  const float* bc = P.bc;
  // the normal velocity on the walls, u_a on the faces of axis a's sides,
  // wall[2a + side]: read from shared memory where a face takes it (held
  // in registers, the six values spilled the LES march at gamma = 0)
  __shared__ float wall[6];
  if (threadIdx.x < 6) {
    wall[threadIdx.x] = bc[threadIdx.x * 3 + threadIdx.x / 2];
  }

  Stager<R0, 0, PER, true, KINDS> L0;
  Stager<R1, 1, PER, true, KINDS> L1;
  Stager<R2, 2, PER, true, KINDS> L2;
  Stager<RP, 3, PER, false> LN;
  L0.init(s0, n1, n2, y0, z0, bc);
  L1.init(s1, n1, n2, y0, z0, bc);
  L2.init(s2, n1, n2, y0, z0, bc);
  if constexpr (LES) LN.init(S.les.nt, n1, n2, y0, z0, nullptr);

  float a, b;
  // start copying plane p of every field
  auto issue = [&](int p) {
    const int slot = p & (kSlots - 1);
    L0.issue(slot,
             P.u[0] + row_of<0, PER, 0, true, KINDS>(p, n0, bc, a, b) * st0);
    L1.issue(slot,
             P.u[1] + row_of<1, PER, 0, true, KINDS>(p, n0, bc, a, b) * st1);
    L2.issue(slot,
             P.u[2] + row_of<2, PER, 0, true, KINDS>(p, n0, bc, a, b) * st2);
    if constexpr (LES) {
      LN.issue(slot,
               P.nu_t + row_of<3, PER, 0, false>(p, n0, nullptr, a, b) * st0);
    }
  };
  // once plane p has landed: its wall ghosts (nu_t has none to make)
  auto fix = [&](int p) {
    const int slot = p & (kSlots - 1);
    row_of<0, PER, 0, true, KINDS>(p, n0, bc, a, b);
    L0.fix(s0[slot], a, b);
    row_of<1, PER, 0, true, KINDS>(p, n0, bc, a, b);
    L1.fix(s1[slot], a, b);
    row_of<2, PER, 0, true, KINDS>(p, n0, bc, a, b);
    L2.fix(s2[slot], a, b);
  };
  // stage k of the march: plane k + 1, what step k reads beyond step k - 1
  auto issue_stage = [&](int k) {
    if (k < xe) issue(k + 1);
    cp_commit();
  };
  auto fix_stage = [&](int k) {
    if (k < xe) fix(k + 1);
  };

  // step xs reads planes xs - 1..xs + 1
  issue(xs - 1);
  issue(xs);
  cp_commit();
#pragma unroll
  for (int k = 0; k < kAhead; ++k) issue_stage(xs + k);
  cp_wait<kAhead - 1>();
  fix(xs - 1);
  fix(xs);
  fix_stage(xs);
  __syncthreads();

  auto at0 = [&](int p, int r, int q) {
    return s0[p & (kSlots - 1)][r * R0::kCols + q];
  };
  auto at1 = [&](int p, int r, int q) {
    return s1[p & (kSlots - 1)][r * R1::kCols + q];
  };
  auto at2 = [&](int p, int r, int q) {
    return s2[p & (kSlots - 1)][r * R2::kCols + q];
  };
  auto atn = [&](int p, int r, int q) {
    return S.les.nt[p & (kSlots - 1)][r * RP::kCols + q];
  };
  const float ih0 = P.inv_h[0], ih1 = P.inv_h[1], ih2 = P.inv_h[2];

  // The edge stresses of face plane f (tau_01, tau_02) and of cell plane
  // x (tau_12), element e of each array. Staged rows and columns: a cell
  // y0 + j of axis 1 is row j + 1 of u0, u2 and nu_t, a face y0 + j row
  // j + 1 of u1; columns likewise on axis 2 (u2's are faces).
  auto tau01 = [&](int f, int e) {
    const int j = e / kTX, q = e % kTX + 1;
    const float du0 = (at0(f, j + 1, q) - at0(f, j, q)) * ih1;
    const float du1 = (at1(f, j + 1, q) - at1(f - 1, j + 1, q)) * ih0;
    S.les.t01[f & 1][e] = edge_stress(du0, du1, atn(f - 1, j, q),
                                      atn(f, j, q), atn(f - 1, j + 1, q),
                                      atn(f, j + 1, q));
  };
  auto tau02 = [&](int f, int e) {
    const int r = e / (kTX + 1) + 1, i = e % (kTX + 1);
    const float du0 = (at0(f, r, i + 1) - at0(f, r, i)) * ih2;
    const float du2 = (at2(f, r, i + 1) - at2(f - 1, r, i + 1)) * ih0;
    S.les.t02[f & 1][e] = edge_stress(du0, du2, atn(f - 1, r, i),
                                      atn(f, r, i), atn(f - 1, r, i + 1),
                                      atn(f, r, i + 1));
  };
  auto tau12 = [&](int x, int e) {
    const int j = e / (kTX + 1), i = e % (kTX + 1);
    const float du1 = (at1(x, j + 1, i + 1) - at1(x, j + 1, i)) * ih2;
    const float du2 = (at2(x, j + 1, i + 1) - at2(x, j, i + 1)) * ih1;
    S.les.t12[e] = edge_stress(du1, du2, atn(x, j, i), atn(x, j + 1, i),
                               atn(x, j, i + 1), atn(x, j + 1, i + 1));
  };
  auto face_plane_stress = [&](int f) {
    each_edge(kE01, 0, [&](int e) { tau01(f, e); });
    each_edge(kE02, kTX, [&](int e) { tau02(f, e); });
  };
  if constexpr (LES) face_plane_stress(xs);

  // the cell's staged row and column: u0's, u2's and nu_t's row r is its
  // cell y, u1's its face y; column q its cell z (u2's its face z)
  const int r = ty + 1, q = tx + 1;
  const int e01 = ty * kTX + tx, e02 = ty * (kTX + 1) + tx, e12 = e02;
  // MASKED: the stencil code of this thread's cell in plane x, loaded a
  // step ahead (clamped in the plane: a thread outside the grid writes
  // nothing)
  const int offc = min(y, n1 - 1) * n2 + min(z, n2 - 1);
  // FORCE: the force on the face of axis a of this thread's cell in plane
  // xc, whose volume index is `off` in the volume's plane fx (its static
  // force without a volume) and whose other cell is (xm, ym, zm): the
  // volume or static force plus the buoyancy, in the plain version's order
  // (theta's reads clamped to the grid: a clamped read feeds only a wall
  // face or a thread outside the grid)
  auto force_at = [&](int a, int fx, int off, int xc, int xm, int ym,
                      int zm) {
    const float fs = F.fv[a] == nullptr
                         ? __ldg(P.bc + kForceAt + a)
                         : __ldg(F.fv[a] + (fx * F.fpl[a] + off));
    float fb = 0.f;
    if (F.th != nullptr) {
      const float b = __ldg(F.tt + kTBuoy + a);
      if (b != 0.f) {
        const float tref = __ldg(F.tt + kTRef);
        const float tm = __ldg(F.th + max(xm, 0) * st0 +
                               (min(max(ym, 0), n1 - 1) * n2 +
                                min(max(zm, 0), n2 - 1)));
        const float tc = __ldg(F.th + xc * st0 + offc);
        fb = b * (0.5f * ((tm - tref) + (tc - tref)));
      }
    }
    return fs + fb;
  };
  int code = 0, code_next = 0;
  if constexpr (MASKED) code = __ldg(O.code + xs * st0 + offc);

  for (int x = xs; x < xe; ++x) {
    issue_stage(x + kAhead);
    if (MASKED && x + 1 < xe) {
      code_next = __ldg(O.code + (x + 1) * st0 + offc);
    }
    if constexpr (LES) {
      face_plane_stress(x + 1);
      each_edge(kE12, 2 * kTX, [&](int e) { tau12(x, e); });
      __syncthreads();
    }
    const int sl = x & 1, sh = (x + 1) & 1;  // face planes x, x + 1
    // u*_0 at face x: u1 and u2 advect it from cells x - 1, x
    float v0;
    {
      const float c = at0(x, r, q);
      const float um[3] = {at0(x - 1, r, q), at0(x, r - 1, q),
                           at0(x, r, q - 1)};
      const float up[3] = {at0(x + 1, r, q), at0(x, r + 1, q),
                           at0(x, r, q + 1)};
      const float vel[3] = {
          c, avg4(at1(x - 1, r, q), at1(x - 1, r + 1, q), at1(x, r, q),
                  at1(x, r + 1, q)),
          avg4(at2(x - 1, r, q), at2(x - 1, r, q + 1), at2(x, r, q),
               at2(x, r, q + 1))};
      float rhs = advect_diffuse<UPWIND>(P, c, um, up, vel);
      if constexpr (LES) {
        float f = own_axis_stress(atn(x - 1, r, q), atn(x, r, q), um[0], c,
                                  up[0], ih0);
        const float* t01 = S.les.t01[sl];
        const float* t02 = S.les.t02[sl];
        f = f + (t01[e01 + kTX] - t01[e01]) * ih1;
        f = f + (t02[e02 + 1] - t02[e02]) * ih2;
        if constexpr (FORCE) {
          // JAX's forcing + sgs
          f = force_at(0, force_face(x, n0, periodic(PER, 0)), offc, x,
                       x - 1, y, z) + f;
        }
        rhs = rhs + f;
      }
      v0 = c + dt * rhs;
      if (!periodic(PER, 0) && x == 0) v0 = wall[0];
    }
    // u*_1 at face y of plane x: u0 (faces x, x + 1) and u2 advect it from
    // cells y - 1, y
    float v1;
    {
      const float c = at1(x, r, q);
      const float um[3] = {at1(x - 1, r, q), at1(x, r - 1, q),
                           at1(x, r, q - 1)};
      const float up[3] = {at1(x + 1, r, q), at1(x, r + 1, q),
                           at1(x, r, q + 1)};
      const float vel[3] = {
          avg4(at0(x, r - 1, q), at0(x + 1, r - 1, q), at0(x, r, q),
               at0(x + 1, r, q)),
          c,
          avg4(at2(x, r - 1, q), at2(x, r - 1, q + 1), at2(x, r, q),
               at2(x, r, q + 1))};
      float rhs = advect_diffuse<UPWIND>(P, c, um, up, vel);
      if constexpr (LES) {
        float f = own_axis_stress(atn(x, r - 1, q), atn(x, r, q), um[1], c,
                                  up[1], ih1);
        f = f + (S.les.t01[sh][e01] - S.les.t01[sl][e01]) * ih0;
        f = f + (S.les.t12[e12 + 1] - S.les.t12[e12]) * ih2;
        if constexpr (FORCE) {
          f = force_at(1, x,
                       force_face(y, n1, periodic(PER, 1)) * n2 +
                           min(z, n2 - 1),
                       x, x, y - 1, z) + f;
        }
        rhs = rhs + f;
      }
      v1 = c + dt * rhs;
      if (!periodic(PER, 1) && y == 0) v1 = wall[2];
    }
    // u*_2 at face z of plane x: u0 (faces x, x + 1) and u1 (faces y,
    // y + 1) advect it from cells z - 1, z
    float v2;
    {
      const float c = at2(x, r, q);
      const float um[3] = {at2(x - 1, r, q), at2(x, r - 1, q),
                           at2(x, r, q - 1)};
      const float up[3] = {at2(x + 1, r, q), at2(x, r + 1, q),
                           at2(x, r, q + 1)};
      const float vel[3] = {
          avg4(at0(x, r, q - 1), at0(x + 1, r, q - 1), at0(x, r, q),
               at0(x + 1, r, q)),
          avg4(at1(x, r, q - 1), at1(x, r + 1, q - 1), at1(x, r, q),
               at1(x, r + 1, q)),
          c};
      float rhs = advect_diffuse<UPWIND>(P, c, um, up, vel);
      if constexpr (LES) {
        float f = own_axis_stress(atn(x, r, q - 1), atn(x, r, q), um[2], c,
                                  up[2], ih2);
        f = f + (S.les.t02[sh][e02] - S.les.t02[sl][e02]) * ih0;
        f = f + (S.les.t12[e12 + kTX + 1] - S.les.t12[e12]) * ih1;
        if constexpr (FORCE) {
          f = force_at(2, x,
                       min(y, n1 - 1) * (periodic(PER, 2) ? n2 : n2 - 1) +
                           force_face(z, n2, periodic(PER, 2)),
                       x, x, y, z - 1) + f;
        }
        rhs = rhs + f;
      }
      v2 = c + dt * rhs;
      if (!periodic(PER, 2) && z == 0) v2 = wall[4];
    }
    if constexpr (OPEN > 0) {
      // the OUTFLOW faces copy the inner face's u*, before the masks (the
      // BC pass's order); at a low side of axis 2 or 1 the inner face is
      // the next column's or row's (a shuffle; the row through shared
      // memory, block-uniform branches)
      const int copy = O.copy;
      float in2 = 0.f, in1 = 0.f;
      if (copy & 16) in2 = __shfl_down_sync(0xffffffffu, v2, 1);
      if ((copy & 4) && y0 == 0) {
        if (ty == 1) O.row[tx] = v1;
        __syncthreads();
        in1 = O.row[tx];
      }
      if (valid) {
        float l0 = v0, l1 = v1, l2 = v2;
        float h0 = wall[1], h1 = wall[3], h2 = wall[5];
        if ((copy & 4) && y == 0) l1 = in1;
        if ((copy & 16) && z == 0) l2 = in2;
        if (copy & 2) h0 = v0;
        // a CONVECTIVE face at (0, 1) keeps its carried value (the step
        // transports it after the predictor, bcs.apply_convective_outlets)
        if (copy & kOpenConv) h0 = at0(x + 1, r, q);
        if (copy & 8) h1 = v1;
        if (copy & 32) h2 = v2;
        if constexpr (MASKED) {
          // the faces' open bits (a boundary face: the cell's fluid bit)
          const bool fluid = code & 64;
          if (!(x == 0 ? fluid : (code & 1))) l0 = 0.f;
          if (!(y == 0 ? fluid : (code & 4))) l1 = 0.f;
          if (!(z == 0 ? fluid : (code & 16))) l2 = 0.f;
          if (!fluid) h0 = h1 = h2 = 0.f;
        }
        const int c0 = y * n2 + z;
        const int c2 = y * (n2 + 1) + z;
        o0[x * st0 + c0] = l0;
        if (x == n0 - 1) o0[(x + 1) * st0 + c0] = h0;
        o1[x * st1 + c0] = l1;
        if (y == n1 - 1) o1[x * st1 + c0 + n2] = h1;
        o2[x * st2 + c2] = l2;
        if (z == n2 - 1) o2[x * st2 + c2 + 1] = h2;
      }
      code = code_next;
    } else if (valid) {
      // each cell writes its three low faces; the last cell along an axis
      // also the high boundary face, its wall value; along a periodic axis
      // the first cell also face n, which repeats face 0
      const int c0 = y * n2 + z;
      const int c2 = y * (n2 + 1) + z;
      o0[x * st0 + c0] = v0;
      if (periodic(PER, 0) && x == 0) o0[n0 * st0 + c0] = v0;
      if (!periodic(PER, 0) && x == n0 - 1) o0[(x + 1) * st0 + c0] = wall[1];
      o1[x * st1 + c0] = v1;
      if (periodic(PER, 1) && y == 0) o1[x * st1 + c0 + n1 * n2] = v1;
      if (!periodic(PER, 1) && y == n1 - 1) o1[x * st1 + c0 + n2] = wall[3];
      o2[x * st2 + c2] = v2;
      if (periodic(PER, 2) && z == 0) o2[x * st2 + c2 + n2] = v2;
      if (!periodic(PER, 2) && z == n2 - 1) o2[x * st2 + c2 + 1] = wall[5];
    }
    cp_wait<kAhead - 1>();
    fix_stage(x + 1);
    __syncthreads();
  }
  cp_wait<0>();
}

// kernel 6 on walls and periodic axes
template <int PER, bool LES, bool UPWIND>
__global__ void __launch_bounds__(kThreads, 3)
predictor_3d_kernel(PredParams P, float* __restrict__ o0,
                    float* __restrict__ o1, float* __restrict__ o2) {
  predictor_march<PER, LES, UPWIND, 0>(P, OpenArgs{nullptr, 0, nullptr},
                                       ForceArgs{}, o0, o1, o2);
}

// kernel 6's forced mode: LES with a force on walls and periodic axes
template <int PER, bool UPWIND>
__global__ void __launch_bounds__(kThreads, 3)
predictor_3d_forced_kernel(PredParams P, ForceArgs F, float* __restrict__ o0,
                           float* __restrict__ o1, float* __restrict__ o2) {
  predictor_march<PER, true, UPWIND, 0, true>(
      P, OpenArgs{nullptr, 0, nullptr}, F, o0, o1, o2);
}

// kernel 6's open modes (OPEN 1: INFLOW, OUTFLOW and SLIP faces; 2: and an
// obstacle's masks), LES only, no periodic axis
template <bool UPWIND, int OPEN>
__global__ void __launch_bounds__(kThreads, 3)
predictor_3d_open_kernel(PredParams P, const uint8_t* __restrict__ code,
                         int copy, float* __restrict__ o0,
                         float* __restrict__ o1, float* __restrict__ o2) {
  __shared__ float row[kTX];
  predictor_march<0, true, UPWIND, OPEN>(P, OpenArgs{code, copy, row},
                                         ForceArgs{}, o0, o1, o2);
}

using PredKernel = void (*)(PredParams, float*, float*, float*);
// the advection-diffusion update without LES, walls only [UPWIND]
const PredKernel kPredictorNoLes[2] = {predictor_3d_kernel<0, false, false>,
                                       predictor_3d_kernel<0, false, true>};
// the LES instantiations [periodic mask][UPWIND]
#define NSS_LES_PER(p) \
  {predictor_3d_kernel<p, true, false>, predictor_3d_kernel<p, true, true>}
const PredKernel kPredictorLes[8][2] = {
    NSS_LES_PER(0), NSS_LES_PER(1), NSS_LES_PER(2), NSS_LES_PER(3),
    NSS_LES_PER(4), NSS_LES_PER(5), NSS_LES_PER(6), NSS_LES_PER(7)};
#undef NSS_LES_PER
using ForcedKernel = void (*)(PredParams, ForceArgs, float*, float*, float*);
// the forced LES instantiations [periodic mask][UPWIND]
#define NSS_FORCED_PER(p)                   \
  {predictor_3d_forced_kernel<p, false>,    \
   predictor_3d_forced_kernel<p, true>}
const ForcedKernel kPredictorForced[8][2] = {
    NSS_FORCED_PER(0), NSS_FORCED_PER(1), NSS_FORCED_PER(2),
    NSS_FORCED_PER(3), NSS_FORCED_PER(4), NSS_FORCED_PER(5),
    NSS_FORCED_PER(6), NSS_FORCED_PER(7)};
#undef NSS_FORCED_PER
using OpenKernel = void (*)(PredParams, const uint8_t*, int, float*, float*,
                            float*);
// [OPEN - 1][UPWIND]
const OpenKernel kPredictorOpen[2][2] = {
    {predictor_3d_open_kernel<false, 1>, predictor_3d_open_kernel<true, 1>},
    {predictor_3d_open_kernel<false, 2>, predictor_3d_open_kernel<true, 2>}};
// [LES]: the dynamic shared memory of a launch
const int kPredSmem[2] = {(int)sizeof(VelRings), (int)sizeof(PredShared)};

using NutKernel = void (*)(NutParams, float*);
const NutKernel kNuT[8] = {nu_t_3d_kernel<0>, nu_t_3d_kernel<1>,
                           nu_t_3d_kernel<2>, nu_t_3d_kernel<3>,
                           nu_t_3d_kernel<4>, nu_t_3d_kernel<5>,
                           nu_t_3d_kernel<6>, nu_t_3d_kernel<7>};

// the open mask's bit that selects the open modes (ops/fused3d.py
// OPEN_KINDS); its low six bits are the OUTFLOW faces
constexpr int kOpenKinds = 64;

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched). `per`: the periodic mask (bit a for a
// periodic axis); `open`: ops/fused3d.open_mask (0 on walls and periodic
// axes; with kOpenKinds the open modes, its low bits the OUTFLOW faces).

int nss_nu_t_3d(const float* u0, const float* u1, const float* u2,
                const float* bc, float* out, int n0, int n1, int n2,
                float inv_h0, float inv_h1, float inv_h2, float scale,
                int per, int open, void* stream) {
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
  P.run = run_for(P.g);
  const NutKernel k =
      (open & kOpenKinds) ? &nu_t_3d_open_kernel : kNuT[per & 7];
  k<<<march_grid(P.g, P.run), kThreads, 0, (cudaStream_t)stream>>>(P, out);
  return (int)cudaGetLastError();
}

// nu_t may be null (walls only): the plain advection-diffusion update. dt:
// a device pointer to the step size. code: an obstacle's stencil code (the
// open modes only), or null. force nonzero: the forced mode (LES, no open
// face), the static force of bc[18..20], the forcing volumes f0..f2 (any
// may be null) and with th and tt (theta and the scalar's thermal buffer,
// both or neither) the buoyancy; a volume holds fewer than 2^31 values.
int nss_predictor_3d(const float* u0, const float* u1, const float* u2,
                     const float* nu_t, float* o0, float* o1, float* o2,
                     const float* bc, const float* dt, const uint8_t* code,
                     const float* th, const float* tt, const float* f0,
                     const float* f1, const float* f2,
                     int n0, int n1, int n2, float inv_h0, float inv_h1,
                     float inv_h2, float inv_hh0, float inv_hh1,
                     float inv_hh2, float nu, float gamma,
                     float one_minus_gamma, int per, int open, int force,
                     void* stream) {
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
  for (int a = 0; a < 3; ++a) P.inv2h[a] = 0.5f * P.inv_h[a];
  P.inv_hh[0] = inv_hh0;
  P.inv_hh[1] = inv_hh1;
  P.inv_hh[2] = inv_hh2;
  P.dt = dt;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  P.run = run_for(P.g);
  const int les = nu_t != nullptr;
  const int upwind = gamma > 0.f;
  if ((per || open) && !les) return (int)cudaErrorInvalidValue;
  const bool vols = f0 != nullptr || f1 != nullptr || f2 != nullptr;
  if ((th != nullptr) != (tt != nullptr) ||
      ((vols || th != nullptr) && !force)) {
    return (int)cudaErrorInvalidValue;
  }
  if (force && (!les || open || (long long)n0 * n1 * n2 >= (1ll << 31))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid = march_grid(P.g, P.run);
  cudaStream_t s = (cudaStream_t)stream;
  if (force) {
    ForceArgs F;
    F.th = th;
    F.tt = tt;
    F.fv[0] = f0;
    F.fv[1] = f1;
    F.fv[2] = f2;
    F.fpl[0] = n1 * n2;
    F.fpl[1] = (periodic(per, 1) ? n1 : n1 - 1) * n2;
    F.fpl[2] = n1 * (periodic(per, 2) ? n2 : n2 - 1);
    const ForcedKernel k = kPredictorForced[per & 7][upwind];
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPredSmem[1]);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, kPredSmem[1], s>>>(P, F, o0, o1, o2);
    return (int)cudaGetLastError();
  }
  if (open & kOpenKinds) {
    const OpenKernel k = kPredictorOpen[code != nullptr][upwind];
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPredSmem[1]);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, kPredSmem[1], s>>>(P, code, open & ~kOpenKinds, o0,
                                           o1, o2);
    return (int)cudaGetLastError();
  }
  const PredKernel k =
      les ? kPredictorLes[per & 7][upwind] : kPredictorNoLes[upwind];
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPredSmem[les]);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, kThreads, kPredSmem[les], s>>>(P, o0, o1, o2);
  return (int)cudaGetLastError();
}

}  // extern "C"
