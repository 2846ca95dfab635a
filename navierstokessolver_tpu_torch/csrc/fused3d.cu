// Fused 3D projection-step kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels carry the 3D lid-driven cavity step of the PyTorch port
// (navierstokessolver_tpu_torch/ops/fused3d.py binds them with ctypes):
//
//   nss_predictor_rhs_3d  replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                         _fused_pred_kernel (Euler form and rk2's based
//                         stage 2, WALL, INFLOW, OUTFLOW, SLIP and PERIODIC
//                         faces, a static force, forcing volumes and
//                         Boussinesq buoyancy, an obstacle's masks): u* for
//                         all three components, the BC values on the
//                         boundary faces, and the Poisson RHS (rho/dt) div
//                         u*, in one pass.
//   nss_correct_diag_3d   replaces pallas_kernels.py _fused_corr_kernel:
//                         u = u* - scale grad p on interior faces, boundary
//                         faces copied from u* (an OUTFLOW face: the
//                         corrected inner face), plus max|div u| and
//                         max_a max|u_a|/h_a; in thermal mode also the
//                         scalar's flux-form update.
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
// The step size: dt and rho/dt (the predictor) and dt/rho (the corrector's
// scale) are read from a float32 device buffer once by every thread, as the
// TPU kernels read theirs from scalar memory, so a dt that the device
// computed (the CFL-adaptive step) reaches them with no host read; the
// loop-invariant floats (1/h, nu, gamma) stay kernel arguments.
//
// Based mode (rk2's stage 2, the TPU kernel's ``base``): the predictor is
// also a template on BASE; the stencils read the staged midpoint field as
// in the Euler form, and each face's u* is anchored at the step-start
// velocity, u* = base + dt*RHS(u_mid), base read once at the face from
// device memory (no halo, no staging). A template rather than a null
// pointer, so that the Euler instantiations carry no trace of it.
//
// Forced mode (the TPU kernel's ``forcing``, ``forcing_fields`` and
// ``theta``; the FORCE template argument of kernel 1, unsharded only):
// kernel 1 adds a force f_a to the RHS of component a before the multiply
// by dt (a boundary face takes its wall value after), f_a the sum, in the
// plain version's order, of
//   * the static force, entry 18 + a of the bc buffer: a time-dependent
//     force is the same mode with the entry refilled by the step, on the
//     device, before the launch;
//   * or, where component a has one, its forcing volume: one float a face
//     in the layout of the plain predictor's forcing, the interior faces of
//     a bounded own axis (n - 1 of them, face k at index k - 1), all n
//     faces of a periodic one, face n read as face 0 (the JAX
//     forcing_to_internal_3d's convention), read once a face from device
//     memory at the thread's own offsets; a null pointer (a uniform branch)
//     reads none;
//   * the Boussinesq force g_a beta (0.5 ((theta_m - theta_ref) + (theta_c
//     - theta_ref))) of the two cells around the face, where theta is given
//     (the thermal modes below) and the axis's buoyancy is not zero.
// Thermal modes (the transported scalar; the TPU kernels' ``theta``;
// kernel 1's FORCE with theta, kernel 2's THERMAL, unsharded only). The
// scalar's constants come from one float buffer (scalar.thermal_table):
// the ghost map of each face, ghost = alpha*edge + beta, the buoyancy
// g_a beta, theta_ref, alpha, gamma and 1 - gamma; a wrap axis of the
// scalar is a bit mask. Every ghost is formed in the kernel from its edge
// cell, so the thermal step adds no launch and no copy (the TPU wrapper
// refreshes theta's axis-0 ghost rows in a pass of its own).
//   * Kernel 1 reads theta from device memory through L1 where a face
//     needs it (the tiles' own cells, so most reads hit), for the axes
//     whose buoyancy is not zero.
//   * Kernel 2 advances theta in each cell of its tile: theta + dt (alpha
//     lap(theta) - div(u theta_face)), with the cell's six corrected faces
//     and its six neighbours (or ghosts). The march already computes the
//     corrected faces on the tile's high edges (face y0 + 8 of axis 1 and
//     z0 + 32 of axis 2, which the next tiles compute again as their low
//     faces) and hands them through shared memory for the divergence; the
//     update reads the same values. theta of the planes x and x + 1 is
//     carried in registers along the march, the in-plane neighbours are
//     read through L1. Its thermal instantiations have a launch bound of 4
//     blocks an SM (64 registers) where the others keep 6 (40).
//
// Open modes (the OPEN template argument of kernels 1-2, unsharded and with
// no periodic axis only; kernel 1 without FORCE, kernel 2 without THERMAL).
// OPEN 0 is every other instantiation: walls and periodic axes, the ghosts
// the reflection 2 u_wall - edge, no copy (their code is that of the
// kernels before the open modes). OPEN 1, faces of any kind but CONVECTIVE
// (the TPU kernels' _tangential_ghost and _own_face_spec): the kind of each
// face comes from the bc buffer, not from a template argument. A
// tangential ghost is alpha edge + (1 - alpha) u_face (march.cuh ghost_of):
// WALL and INFLOW reflect (alpha = -1), SLIP and OUTFLOW copy the edge
// (alpha = 1); an INFLOW value that depends on time is the buffer's entry
// refilled, as a wall's. A face's own component is Dirichlet on WALL,
// INFLOW and SLIP; on an OUTFLOW face it copies the inner face (bits 2
// axis + side of the kernels' `open` argument, which the wrappers derive
// from the same kinds): the predictor writes face 0 (n) of u*_a as u*_a at
// face 1 (n - 1), the corrector the corrected inner face, and the
// divergence of the boundary cell reads the copy. The axis-0 march does
// this inside the kernel at face n0 (the TPU kernels patch that plane
// after the launch, since a stripe cannot reach the previous stripe's
// row); an OUTFLOW face at (0, 0) is refused, as JAX's gate refuses it.
// (Tested at every face of the walls instantiations, the copies cost them
// 3-5% of their time: hence the separate mode.)
//
// OPEN 2 (an obstacle; the TPU kernels' face codes) adds the masks: both
// kernels read the Poisson operator's stencil code of each cell
// (ops/poisson.py: bit 6 fluid, bits 2a / 2a + 1 the fluid neighbour of a
// fluid cell below / above along axis a), one byte a cell, a step ahead of
// its use, in place of the TPU kernels' three face-code volumes. A face is
// open when both its cells are fluid (an interior face: the neighbour bit)
// or its one cell is (a boundary face), exactly as bcs.face_masks_from_solid
// defines it; an interior face is corrected where it is open
// (bcs.correction_face_masks). Each cell's thread gates its six faces with
// its own byte (the two cells of a face agree on it), so the values the
// march hands between threads stay ungated:
//   * kernel 1 writes u* zero on a closed face, after the boundary values
//     (an OUTFLOW face copies the inner face's ungated u*, then takes its
//     own mask: bcs.apply_velocity_bcs's order), and the RHS zero in a
//     solid cell;
//   * kernel 2 corrects only open interior faces, keeps u* elsewhere, zeroes
//     closed faces, copies the gated inner face onto an OUTFLOW face, and
//     takes max|div u| over fluid cells only (the CFL maximum over every
//     face).
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
// byte and write one float32 (17 B); at 256^3 that is 471, 471 and 285 MB a
// call against the H100's 3.35 TB/s (0.141, 0.141 and 0.085 ms).
//
// The predictor and the corrector are a tiled stencil that marches along
// axis 0 (the TPU kernels march the same axis in stripes of T rows):
//   - a block of 256 threads owns a tile of 8 rows of axis 1 by 32 cells of
//     the contiguous axis 2, one thread a cell, and walks a run of up to 32
//     axis-0 planes (fewer where the grid would give under 8 blocks an SM;
//     a partial last run and partial edge tiles are masked);
//   - each input field's planes pass through a ring of 8 plane slots in
//     shared memory, the tile plus a one-cell halo (the predictor: u0 planes
//     x..x+2, u1 and u2 planes x-1..x+1; the corrector: p planes x, x+1),
//     filled by 4-byte cp.async (u2's rows are (n2+1)*4 bytes apart, never
//     16-byte aligned, so no TMA map and no 16-byte copy can describe them)
//     two planes ahead of the one computed; the copies of a plane land while
//     the block computes the planes before it;
//   - the wall and wrap case analysis happens once, where an element is
//     staged: a ghost beyond a wall becomes 2*u_wall - edge in the slot
//     (each thread fixes the elements it copied after they land), a
//     periodic neighbour is copied from the opposite edge, a halo side's
//     neighbour from the ghost row; the computation then reads the ring with
//     no branch: every face is updated (a boundary face on clamped copies)
//     and a boundary face then selects its wall value;
//   - every face's u* is computed once: u*_1 and u*_2 of the plane (with one
//     more row / column on the tile's high edge) into shared memory, u*_0 of
//     the plane's high face in a register that is the next plane's low face
//     (one extra u*_0 plane a run, at its start, is the overlap the TPU
//     kernel recomputes per stripe); the divergence reads those values;
//   - the transverse MAC averages are factored through the cell-centred
//     pair averages M_t = (u_t[lo] + u_t[hi]) / 2, as the TPU kernel does;
//   - the arithmetic multiplies by the reciprocals 1/(2h), 1/h and 1/h^2,
//     formed by the wrapper as the JAX kernels form them (Python double,
//     then float32): no division in either kernel. Offsets are 32-bit inside
//     a plane plus one 64-bit plane base; no 64-bit division anywhere;
//   - the predictor branches once on gamma: at gamma = 0 its march forms no
//     upwind difference (a runtime test at every face was if-converted into
//     both);
//   - the corrector folds both maxima over its whole run in registers and
//     reduces them once a block (two atomicMax per block, not per 256 cells);
//   - launch bounds hold 3 predictor blocks (<= 80 registers) and 6
//     corrector blocks (<= 40; OPEN 2: 5, <= 51) on an SM,
//     whatever registers the periodic and halo masks would otherwise take.
// The march's staging code (the rings, Stager, row_of, in_plane, run_for)
// is in march.cuh, shared with kernels 6-7 (predictor3d.cu).
// With the memory traffic at its minimum plus the halos, the predictor is
// bound by instruction issue (much of it address arithmetic) and the
// corrector by memory latency; PERF.md has their shares of the bound.
// The residual keeps the one-thread-a-cell design on purpose: its five-point
// neighbours along each axis reach 67% of its bound without staging.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "march.cuh"

namespace {

using namespace nss::march;
using nss::abs_bits;
using nss::block_max_to;
using nss::blocks_for;
using nss::Grid3;
using nss::kThreads;
using nss::lin;
using nss::unflatten;

// the instantiations of a kernel template for every periodic mask 0..7
#define NSS_PER_TABLE(k) {k<0>, k<1>, k<2>, k<3>, k<4>, k<5>, k<6>, k<7>}
// ... of a kernel <HALO, PER, ...> (the trailing arguments: the predictor's
// BASE and FORCE, the corrector's THERMAL) with no halo side (the
// unsharded kernels) ...
#define NSS_UNSHARDED_TABLE(k, ...)                                    \
  {k<0, 0, __VA_ARGS__>, k<0, 1, __VA_ARGS__>, k<0, 2, __VA_ARGS__>,   \
   k<0, 3, __VA_ARGS__>, k<0, 4, __VA_ARGS__>, k<0, 5, __VA_ARGS__>,   \
   k<0, 6, __VA_ARGS__>, k<0, 7, __VA_ARGS__>}
// ... and for halo masks 1..3 with the periodic masks that leave axis 0
// bounded (0, 2, 4, 6: a halo side is never on a periodic axis 0),
// indexed [halo - 1][per >> 1]
#define NSS_HALO_ROW(k, h, ...)                                          \
  {k<h, 0, __VA_ARGS__>, k<h, 2, __VA_ARGS__>, k<h, 4, __VA_ARGS__>,     \
   k<h, 6, __VA_ARGS__>}
#define NSS_HALO_TABLE(k, ...)                                           \
  {NSS_HALO_ROW(k, 1, __VA_ARGS__), NSS_HALO_ROW(k, 2, __VA_ARGS__),     \
   NSS_HALO_ROW(k, 3, __VA_ARGS__)}

// -- kernel 1: predictor + BCs + Poisson RHS -----------------------------------

// The thermal buffer's entries (scalar.thermal_table, 3D): the ghost map
// (alpha, beta) of face (axis a, side s) at 2 (2a + s), then the buoyancy
// of each axis, theta_ref, alpha, gamma and 1 - gamma.
constexpr int kTBuoy = 12, kTRef = 15, kTAlpha = 16, kTGamma = 17,
              kTOneMinusGamma = 18;
// the static force of component a in the bc buffer (after the wall values)
constexpr int kForceAt = 18;

// g_a beta (0.5 ((tm - tref) + (tc - tref))): the Boussinesq force on a
// face between the cells tm and tc, in the plain version's order
__device__ __forceinline__ float buoyancy(float b, float tref, float tm,
                                          float tc) {
  return b * (0.5f * ((tm - tref) + (tc - tref)));
}

struct PredParams {
  const float* u[3];
  const uint8_t* code;  // OPEN 2: the stencil code of each cell (n0, n1, n2)
  const float* base[3];  // the step-start velocity (read by BASE only)
  const float* bc;  // wall value [(axis*2 + side)*3 + comp]
  const float* dts; // the step size: dt, rho/dt (ops/step_size.py)
  const float* th;  // FORCE: theta (n0, n1, n2) and the thermal buffer,
  const float* tt;  // null without the thermal mode
  Grid3 g;
  float inv2h[3];   // 1/(2 h_a)
  float invh[3];    // 1/h_a
  float invh2[3];   // 1/h_a^2
  float nu, gamma, one_minus_gamma;
  int run;          // axis-0 planes a block marches
  int copy;         // bit 2 axis + side: an OUTFLOW face
  const float* fv[3];  // FORCE: the forcing volume of each component, or null
  int fpl[3];       // the volumes' plane strides (elements of an axis-0 plane)
};

// u* of a face from its centre value c, its -1 / +1 neighbours along each
// axis and the velocity advecting it along each axis, in the arithmetic
// order of ops/stencils.predictor: advective-form central differences
// blended with donor-cell upwinding (UPWIND: gamma > 0), plus the viscous
// Laplacian and (FORCE) the force f, one explicit Euler step from `anchor`
// (c, or rk2's base).
template <bool UPWIND, bool FORCE>
__device__ __forceinline__ float advance(const PredParams& P, float dt,
                                         float c, float anchor,
                                         const float (&um)[3],
                                         const float (&up)[3],
                                         const float (&vel)[3], float f) {
  float adv = 0.f;
  float lap = 0.f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float central = (up[ax] - um[ax]) * P.inv2h[ax];
    float d;
    if (UPWIND) {
      const float fwd = (up[ax] - c) * P.invh[ax];
      const float bwd = (c - um[ax]) * P.invh[ax];
      // zero velocity takes fwd, as jnp.where(vel > 0, bwd, fwd) does
      const float upw = (vel[ax] > 0.f) ? bwd : fwd;
      d = P.gamma * upw + P.one_minus_gamma * central;
    } else {
      d = central;
    }
    adv = adv + vel[ax] * d;
    lap = lap + (up[ax] - 2.f * c + um[ax]) * P.invh2[ax];
  }
  float rhs = -adv + P.nu * lap;
  if (FORCE) rhs = rhs + f;
  return anchor + dt * rhs;
}

// the index along an axis of n cells of a base face read at face i >= 0:
// clamped into the array, face n of a periodic axis read as face 0 (it
// repeats it)
__device__ __forceinline__ int base_face(int i, int n, bool per) {
  const int k = min(i, n);
  return per && k == n ? 0 : k;
}

// The OUTFLOW faces among a cell's six (bit 2 axis + side of `copy`; x1:
// the cell is the last along axis 0, y0 / y1 the first / last along axis
// 1, z0 / z1 along axis 2): the boundary face takes the inner face's
// value. Only the open instantiations (OPEN > 0: unsharded, no periodic
// axis) call it; the walls and periodic ones hold no copy.
__device__ __forceinline__ void outflow_copies(int copy, bool x1, bool y0,
                                               bool y1, bool z0, bool z1,
                                               float& l0, float& h0,
                                               float& l1, float& h1,
                                               float& l2, float& h2) {
  if ((copy & 4) && y0) l1 = h1;
  if ((copy & 16) && z0) l2 = h2;
  if ((copy & 2) && x1) h0 = l0;
  if ((copy & 8) && y1) h1 = l1;
  if ((copy & 32) && z1) h2 = l2;
}

// kernel 1's shared memory: a ring of each velocity component's planes,
// and u*_1 and u*_2 of the plane's faces (two planes, alternating)
struct PredShared {
  float s0[kSlots][R0::kSize];
  float s1[kSlots][R1::kSize];
  float s2[kSlots][R2::kSize];
  float f1[2][(kTY + 1) * kTX];  // u*_1, faces y0..y0+8
  float f2[2][kTY * (kTX + 1)];  // u*_2, faces z0..z0+32
};

// kernel 1's shared memory with, in the forced mode, each thread's
// forcing-volume offsets (entry k * kThreads + thread; see predictor_march)
// and the buoyancy of each axis and theta_ref (zero without theta)
template <bool FORCE>
struct PredSharedF : PredShared {
  int fo[4 * kThreads];
  float tb[4];
};
template <>
struct PredSharedF<false> : PredShared {};

// The index along an axis of n cells of a forcing volume's face i in
// [0, n]: i - 1 clamped into the n - 1 interior faces of a bounded axis
// (faces 0 and n take their wall values), face n of a periodic axis read
// as face 0
__device__ __forceinline__ int force_face(int i, int n, bool per) {
  return per ? (i >= n ? i - n : i) : min(max(i - 1, 0), n - 2);
}

// The march of one block of kernel 1; UPWIND is gamma > 0, a branch of the
// kernel rather than a runtime test at every face, so that at gamma = 0 no
// upwind difference is formed. BASE: rk2's stage 2. FORCE: the static
// force, the forcing volumes and the Boussinesq force of theta. OPEN: the
// faces' kinds from the bc buffer and the OUTFLOW copies (1), and an
// obstacle's masks from the stencil code (2).
template <int HALO, int PER, bool UPWIND, bool BASE, bool FORCE, int OPEN>
__device__ __forceinline__ void predictor_march(
    PredSharedF<FORCE>& S, const PredParams& P, float dt, float rho_over_dt,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
    float* __restrict__ rhs) {
  auto& s0 = S.s0;
  auto& s1 = S.s1;
  auto& s2 = S.s2;
  auto& f1 = S.f1;
  auto& f2 = S.f2;

  const int n0 = P.g.n[0], n1 = P.g.n[1], n2 = P.g.n[2];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int z0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int xs = blockIdx.z * P.run, xe = min(xs + P.run, n0);
  const int y = y0 + ty, z = z0 + tx;
  const bool valid = y < n1 && z < n2;
  const long long st0 = (long long)n1 * n2;        // plane strides
  const long long st1 = (long long)(n1 + 1) * n2;
  const long long st2 = (long long)n1 * (n2 + 1);
  const float* bc = P.bc;
  // the normal velocity on the walls: u_a on the faces of axis a's sides
  const float w0l = bc[0], w0h = bc[3], w1l = bc[7], w1h = bc[10],
              w2l = bc[14], w2h = bc[17];
  // FORCE: theta at a cell (clamped to the grid: a clamped read feeds
  // only a boundary face, which takes its wall value, or a thread outside
  // the grid)
  auto theta_at = [&](int xx, int yy, int zz) {
    xx = min(max(xx, 0), n0 - 1);
    yy = min(max(yy, 0), n1 - 1);
    zz = min(max(zz, 0), n2 - 1);
    return __ldg(P.th + xx * st0 + (yy * n2 + zz));
  };
  // the Boussinesq force on a face of axis a between the cells (xm, ym,
  // zm) and (xc, yc, zc): zero on an axis without buoyancy (no read); the
  // buoyancy and theta_ref come from shared memory (S.tb), where registers
  // for them spilled a based forced instantiation at its 80-register bound
  auto force_at = [&](int a, int xm, int ym, int zm, int xc, int yc,
                      int zc) {
    if constexpr (FORCE) {
      const float b = S.tb[a];
      if (b == 0.f) return 0.f;
      return buoyancy(b, S.tb[3], theta_at(xm, ym, zm), theta_at(xc, yc, zc));
    } else {
      return 0.f;
    }
  };
  // FORCE: the volumes' in-plane offsets of this thread's faces (entry
  // k * kThreads + thread; k = 0: the u0 face of its cell, 1 and 2: its
  // low u1 and u2 faces, 3: for 40 threads a face on the tile's high
  // edge); the arrays are clamped (a thread outside the grid reads a face
  // it does not write). Each thread keeps its own in shared memory, read
  // where a face needs one: held in registers, they spilled the based
  // instantiation with axes 0 and 1 periodic at its 80-register bound.
  if constexpr (FORCE) {
    int* fo = S.fo;
    const bool p1 = periodic(PER, 1), p2 = periodic(PER, 2);
    const int n2v = p2 ? n2 : n2 - 1;
    fo[threadIdx.x] = min(y, n1 - 1) * n2 + min(z, n2 - 1);
    fo[kThreads + threadIdx.x] = force_face(y, n1, p1) * n2 +
                                 min(z, n2 - 1);
    fo[2 * kThreads + threadIdx.x] =
        min(y, n1 - 1) * n2v + force_face(z, n2, p2);
    int edge = 0;
    if (threadIdx.x < kTX) {
      edge = force_face(y0 + kTY, n1, p1) * n2 +
             min(z0 + (int)threadIdx.x, n2 - 1);
    } else if (threadIdx.x < kTX + kTY) {
      edge = min(y0 + (int)threadIdx.x - kTX, n1 - 1) * n2v +
             force_face(z0 + kTX, n2, p2);
    }
    fo[3 * kThreads + threadIdx.x] = edge;
    if (threadIdx.x < 4) {
      S.tb[threadIdx.x] =
          P.th == nullptr ? 0.f
                          : __ldg(P.tt + (threadIdx.x < 3
                                              ? kTBuoy + (int)threadIdx.x
                                              : kTRef));
    }
  }
  // FORCE: the static or volume force of component a at the face whose
  // in-plane offset is entry k of this thread's offsets, in the volume's
  // plane x: the volume's value where it has one, else the bc buffer's
  // entry; added before the buoyancy f, as the plain version adds the
  // force and the buoyancy
  auto with_force = [&](int a, int x, int k, float f) {
    if constexpr (FORCE) {
      // 32-bit indices: a volume holds fewer than 2^31 values (checked
      // by the entry point); 64-bit ones spilled a based instantiation
      const float fs =
          P.fv[a] == nullptr
              ? __ldg(P.bc + kForceAt + a)
              : __ldg(P.fv[a] + (x * P.fpl[a] +
                                 S.fo[k * kThreads + threadIdx.x]));
      return fs + f;
    } else {
      return f;
    }
  };

  constexpr bool KINDS = OPEN > 0;
  Stager<R0, 0, PER, true, KINDS> L0;
  Stager<R1, 1, PER, true, KINDS> L1;
  Stager<R2, 2, PER, true, KINDS> L2;
  L0.init(s0, n1, n2, y0, z0, bc);
  L1.init(s1, n1, n2, y0, z0, bc);
  L2.init(s2, n1, n2, y0, z0, bc);

  float a, b;
  auto issue0 = [&](int p) {
    L0.issue(p & (kSlots - 1),
             P.u[0] + row_of<0, PER, HALO, true, KINDS>(p, n0, bc, a, b) * st0);
  };
  auto issue12 = [&](int p) {
    L1.issue(p & (kSlots - 1),
             P.u[1] + row_of<1, PER, HALO, true, KINDS>(p, n0, bc, a, b) * st1);
    L2.issue(p & (kSlots - 1),
             P.u[2] + row_of<2, PER, HALO, true, KINDS>(p, n0, bc, a, b) * st2);
  };
  auto fix0 = [&](int p) {
    row_of<0, PER, HALO, true, KINDS>(p, n0, bc, a, b);
    L0.fix(s0[p & (kSlots - 1)], a, b);
  };
  auto fix12 = [&](int p) {
    row_of<1, PER, HALO, true, KINDS>(p, n0, bc, a, b);
    L1.fix(s1[p & (kSlots - 1)], a, b);
    row_of<2, PER, HALO, true, KINDS>(p, n0, bc, a, b);
    L2.fix(s2[p & (kSlots - 1)], a, b);
  };
  // stage k of the march: what step k reads beyond step k - 1
  auto issue_stage = [&](int k) {
    if (k < xe) {
      issue0(k + 2);
      issue12(k + 1);
    }
    cp_commit();
  };
  auto fix_stage = [&](int k) {
    if (k < xe) {
      fix0(k + 2);
      fix12(k + 1);
    }
  };

  // step xs - 1 computes u*_0 at face xs only; it reads u0 planes xs-1..xs+1
  // and u1, u2 planes xs-1, xs
  issue0(xs - 1);
  issue0(xs);
  issue12(xs - 1);
  cp_commit();
#pragma unroll
  for (int k = 0; k < kAhead; ++k) issue_stage(xs - 1 + k);
  cp_wait<kAhead - 1>();
  fix0(xs - 1);
  fix0(xs);
  fix12(xs - 1);
  fix_stage(xs - 1);
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
  // u*_1 at face y0 + j of axis 1, cell z0 + i of axis 2, plane x; the
  // update runs on every face (a boundary face's staged neighbours are
  // clamped copies) and a boundary face then takes the wall value, so the
  // code has no branch
  auto ustar1 = [&](int x, int j, int i, float base) {
    const int yf = y0 + j;
    const int r = j + 1, q = i + 1;
    const float c = at1(x, r, q);
    const float um[3] = {at1(x - 1, r, q), at1(x, r - 1, q), at1(x, r, q - 1)};
    const float up[3] = {at1(x + 1, r, q), at1(x, r + 1, q), at1(x, r, q + 1)};
    // M_0 and M_2 at cells yf - 1 (row j) and yf (row j + 1)
    const float m0l = 0.5f * (at0(x, j, q) + at0(x + 1, j, q));
    const float m0h = 0.5f * (at0(x, j + 1, q) + at0(x + 1, j + 1, q));
    const float m2l = 0.5f * (at2(x, j, q) + at2(x, j, q + 1));
    const float m2h = 0.5f * (at2(x, j + 1, q) + at2(x, j + 1, q + 1));
    const float vel[3] = {0.5f * (m0l + m0h), c, 0.5f * (m2l + m2h)};
    const float f = with_force(1, x, j == kTY ? 3 : 1,
                               force_at(1, x, yf - 1, z0 + i, x, yf, z0 + i));
    const float v =
        advance<UPWIND, FORCE>(P, dt, c, BASE ? base : c, um, up, vel, f);
    if (periodic(PER, 1)) return v;
    return yf == 0 ? w1l : (yf == n1 ? w1h : v);
  };
  // u*_2 at cell y0 + j of axis 1, face z0 + i of axis 2, plane x
  auto ustar2 = [&](int x, int j, int i, float base) {
    const int zf = z0 + i;
    const int r = j + 1, q = i + 1;
    const float c = at2(x, r, q);
    const float um[3] = {at2(x - 1, r, q), at2(x, r - 1, q), at2(x, r, q - 1)};
    const float up[3] = {at2(x + 1, r, q), at2(x, r + 1, q), at2(x, r, q + 1)};
    // M_0 and M_1 at cells zf - 1 (column i) and zf (column i + 1)
    const float m0l = 0.5f * (at0(x, r, i) + at0(x + 1, r, i));
    const float m0h = 0.5f * (at0(x, r, i + 1) + at0(x + 1, r, i + 1));
    const float m1l = 0.5f * (at1(x, r, i) + at1(x, r + 1, i));
    const float m1h = 0.5f * (at1(x, r, i + 1) + at1(x, r + 1, i + 1));
    const float vel[3] = {0.5f * (m0l + m0h), 0.5f * (m1l + m1h), c};
    const float f = with_force(2, x, i == kTX ? 3 : 2,
                               force_at(2, x, y0 + j, zf - 1, x, y0 + j, zf));
    const float v =
        advance<UPWIND, FORCE>(P, dt, c, BASE ? base : c, um, up, vel, f);
    if (periodic(PER, 2)) return v;
    return zf == 0 ? w2l : (zf == n2 ? w2h : v);
  };

  // BASE: the step-start field at this thread's faces of step x, loaded
  // from device memory a step ahead of its use (the u0 face x + 1; from
  // step xs on the u1 and u2 faces of plane x and, for 40 threads, a face
  // on the tile's high edge), so that its latency hides behind a step as
  // the staged planes' does. In-plane offsets: the faces' arrays are
  // clamped (a thread outside the grid reads a face it does not write)
  // and face n of a periodic axis is read as face 0.
  int bo0 = 0, bo1 = 0, bo2 = 0, boe = 0;
  if (BASE) {
    bo0 = min(y, n1 - 1) * n2 + min(z, n2 - 1);
    bo1 = base_face(y, n1, periodic(PER, 1)) * n2 + min(z, n2 - 1);
    bo2 = min(y, n1 - 1) * (n2 + 1) + base_face(z, n2, periodic(PER, 2));
    if (threadIdx.x < kTX) {
      boe = base_face(y0 + kTY, n1, periodic(PER, 1)) * n2 +
            min(z0 + (int)threadIdx.x, n2 - 1);
    } else if (threadIdx.x < kTX + kTY) {
      boe = min(y0 + (int)threadIdx.x - kTX, n1 - 1) * (n2 + 1) +
            base_face(z0 + kTX, n2, periodic(PER, 2));
    }
  }
  auto load_base = [&](int x, float (&v)[4]) {
    v[0] = __ldg(P.base[0] + base_face(x + 1, n0, periodic(PER, 0)) * st0 +
                 bo0);
    if (x >= xs) {
      v[1] = __ldg(P.base[1] + x * st1 + bo1);
      v[2] = __ldg(P.base[2] + x * st2 + bo2);
      v[3] = threadIdx.x < kTX ? __ldg(P.base[1] + x * st1 + boe)
             : threadIdx.x < kTX + kTY ? __ldg(P.base[2] + x * st2 + boe)
                                       : 0.f;
    }
  };
  float base[4] = {0.f, 0.f, 0.f, 0.f};
  float base_next[4] = {0.f, 0.f, 0.f, 0.f};
  if (BASE) load_base(xs - 1, base);
  // OPEN 2: the stencil code of this thread's cell in plane x, loaded a
  // step ahead (clamped in the plane: a thread outside the grid writes
  // nothing)
  const int offc = min(y, n1 - 1) * n2 + min(z, n2 - 1);
  int code = 0, code_next = 0;

  float lo0 = 0.f;  // u*_0 at the plane's low face
  for (int x = xs - 1; x < xe; ++x) {
    issue_stage(x + kAhead);
    if (BASE && x + 1 < xe) load_base(x + 1, base_next);
    if (OPEN == 2 && x + 1 < xe) {
      code_next = __ldg(P.code + (x + 1) * st0 + offc);
    }
    // u*_0 at face f = x + 1: the wall value on a boundary face
    const int f = x + 1;
    float hi0;
    {
      const int r = ty + 1, q = tx + 1;
      const float c = at0(f, r, q);
      const float um[3] = {at0(x, r, q), at0(f, r - 1, q), at0(f, r, q - 1)};
      const float up[3] = {at0(x + 2, r, q), at0(f, r + 1, q),
                           at0(f, r, q + 1)};
      // M_1 and M_2 at cells x and x + 1
      const float m1l = 0.5f * (at1(x, r, q) + at1(x, r + 1, q));
      const float m1h = 0.5f * (at1(f, r, q) + at1(f, r + 1, q));
      const float m2l = 0.5f * (at2(x, r, q) + at2(x, r, q + 1));
      const float m2h = 0.5f * (at2(f, r, q) + at2(f, r, q + 1));
      const float vel[3] = {c, 0.5f * (m1l + m1h), 0.5f * (m2l + m2h)};
      const float f0 = with_force(0, force_face(f, n0, periodic(PER, 0)), 0,
                                  force_at(0, x, y, z, f, y, z));
      hi0 = advance<UPWIND, FORCE>(P, dt, c, BASE ? base[0] : c, um, up,
                                   vel, f0);
      if (!periodic(PER, 0) && !halo_lo(HALO, 0) && f == 0) hi0 = w0l;
      if (!periodic(PER, 0) && !halo_hi(HALO, 0) && f == n0) hi0 = w0h;
    }
    const int buf = x & 1;
    float lo1 = 0.f, lo2 = 0.f;
    if (x >= xs) {
      lo1 = ustar1(x, ty, tx, base[1]);
      lo2 = ustar2(x, ty, tx, base[2]);
      f1[buf][ty * kTX + tx] = lo1;
      f2[buf][ty * (kTX + 1) + tx] = lo2;
      // the faces on the tile's high edges
      if (threadIdx.x < kTX) {
        f1[buf][kTY * kTX + threadIdx.x] =
            ustar1(x, kTY, threadIdx.x, base[3]);
      } else if (threadIdx.x < kTX + kTY) {
        const int j = threadIdx.x - kTX;
        f2[buf][j * (kTX + 1) + kTX] = ustar2(x, j, kTX, base[3]);
      }
    }
    if (BASE) {
#pragma unroll
      for (int k = 0; k < 4; ++k) base[k] = base_next[k];
    }
    cp_wait<kAhead - 1>();
    fix_stage(x + 1);
    __syncthreads();
    if (x >= xs && valid) {
      float l0 = lo0, h0 = hi0, l1 = lo1, l2 = lo2;
      float h1 = f1[buf][(ty + 1) * kTX + tx];
      float h2 = f2[buf][ty * (kTX + 1) + tx + 1];
      // OUTFLOW faces: the inner face's u* (before the masks, as the BC
      // pass copies them)
      if (OPEN > 0) {
        outflow_copies(P.copy, x == n0 - 1, y == 0, y == n1 - 1, z == 0,
                       z == n2 - 1, l0, h0, l1, h1, l2, h2);
      }
      bool fluid = true;
      if (OPEN == 2) {
        // the six faces' open bits (a boundary face: the cell's fluid bit)
        fluid = code & 64;
        if (!(x == 0 ? fluid : (code & 1))) l0 = 0.f;
        if (!(x == n0 - 1 ? fluid : (code & 2))) h0 = 0.f;
        if (!(y == 0 ? fluid : (code & 4))) l1 = 0.f;
        if (!(y == n1 - 1 ? fluid : (code & 8))) h1 = 0.f;
        if (!(z == 0 ? fluid : (code & 16))) l2 = 0.f;
        if (!(z == n2 - 1 ? fluid : (code & 32))) h2 = 0.f;
      }
      // each cell writes its three low faces; the last cell along an axis
      // also the high boundary face (not the face shared with the next slab)
      const int c0 = y * n2 + z;
      const int c2 = y * (n2 + 1) + z;
      o0[x * st0 + c0] = l0;
      if (x == n0 - 1 && !halo_hi(HALO, 0)) o0[(x + 1) * st0 + c0] = h0;
      o1[x * st1 + c0] = l1;
      if (y == n1 - 1) o1[x * st1 + c0 + n2] = h1;
      o2[x * st2 + c2] = l2;
      if (z == n2 - 1) o2[x * st2 + c2 + 1] = h2;
      const float div = (h0 - l0) * P.invh[0] + (h1 - l1) * P.invh[1] +
                        (h2 - l2) * P.invh[2];
      rhs[x * st0 + c0] = fluid ? div * rho_over_dt : 0.f;
    }
    if (OPEN == 2) code = code_next;
    lo0 = hi0;
  }
  cp_wait<0>();
}

template <int HALO, int PER, bool BASE, bool FORCE, int OPEN = 0>
__global__ void __launch_bounds__(kThreads, 3)
predictor_rhs_kernel(PredParams P, float* __restrict__ o0,
                     float* __restrict__ o1, float* __restrict__ o2,
                     float* __restrict__ rhs) {
  __shared__ PredSharedF<FORCE> S;
  const float dt = __ldg(P.dts), rho_over_dt = __ldg(P.dts + 1);
  if (P.gamma > 0.f) {
    predictor_march<HALO, PER, true, BASE, FORCE, OPEN>(S, P, dt, rho_over_dt,
                                                        o0, o1, o2, rhs);
  } else {
    predictor_march<HALO, PER, false, BASE, FORCE, OPEN>(
        S, P, dt, rho_over_dt, o0, o1, o2, rhs);
  }
}

// -- kernel 2: corrector + diagnostics -----------------------------------------

struct CorrParams {
  const float* us[3];
  const float* p;
  const uint8_t* code;  // OPEN 2: the stencil code of each cell
  const float* scale;  // dt / rho, on the device (ops/step_size.py)
  const float* th;  // THERMAL: theta, the thermal buffer and dt (device)
  const float* tt;
  const float* dt;
  float* tho;       // THERMAL: the new theta
  Grid3 g;
  float invh[3];    // 1/h_a
  float invhh[3];   // THERMAL: 1/h_a^2
  int twrap;        // THERMAL: bit a set where the scalar wraps on axis a
  int run;          // axis-0 planes a block marches
  int copy;         // bit 2 axis + side: an OUTFLOW face
};

// The scalar's advective flux through a face of velocity uf between the
// cells tm (below) and tp (above): uf theta_face, theta_face the two-cell
// average blended with the donor cell by gamma (UPWIND: gamma > 0)
template <bool UPWIND>
__device__ __forceinline__ float theta_flux(float uf, float tm, float tp,
                                            float gamma,
                                            float one_minus_gamma) {
  float tf = 0.5f * (tm + tp);
  if (UPWIND) tf = gamma * (uf > 0.f ? tm : tp) + one_minus_gamma * tf;
  return uf * tf;
}

// theta + dt (alpha lap(theta) - div(u theta_face)) in a cell from its
// six corrected faces (lo, hi along each axis) and its six neighbours
// (m, p along each axis)
template <bool UPWIND>
__device__ __forceinline__ float theta_update(
    const CorrParams& C, float dt, float alpha, float gamma, float omg,
    float tc, const float (&tm)[3], const float (&tp)[3],
    const float (&lo)[3], const float (&hi)[3]) {
  float adv = 0.f, lap = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    adv = adv + (theta_flux<UPWIND>(hi[a], tc, tp[a], gamma, omg) -
                 theta_flux<UPWIND>(lo[a], tm[a], tc, gamma, omg)) *
                    C.invh[a];
    lap = lap + (tm[a] - 2.f * tc + tp[a]) * C.invhh[a];
  }
  return tc + dt * (alpha * lap - adv);
}

// Boundary faces keep u* (an OUTFLOW face copies the corrected inner
// face), interior faces take u* - scale * dp/dx_A. On a
// periodic A every face is corrected, face 0 with the wrap gradient
// p[0] - p[n-1], and face n repeats face 0. On a halo side faces 0 and n
// are interior, their outer p in the ghost row. THERMAL: theta advanced
// in each cell with its corrected faces. OPEN: the OUTFLOW copies (1) and
// an obstacle's masks (2).
template <int HALO, int PER, bool THERMAL, int OPEN = 0>
__global__ void __launch_bounds__(kThreads,
                                  THERMAL ? 4 : OPEN == 2 ? 5 : 6)
correct_diag_kernel(CorrParams C, float* __restrict__ o0,
                    float* __restrict__ o1, float* __restrict__ o2,
                    int* __restrict__ maxes) {
  __shared__ float sp[kSlots][RP::kSize];
  __shared__ float f1[2][(kTY + 1) * kTX];  // u_1, faces y0..y0+8
  __shared__ float f2[2][kTY * (kTX + 1)];  // u_2, faces z0..z0+32
  // -dt/rho, loaded once a block: held in shared memory rather than in a
  // register for the whole march, which the 40-register bound of 6 blocks
  // an SM has no room for
  __shared__ float neg_scale;

  const int n0 = C.g.n[0], n1 = C.g.n[1], n2 = C.g.n[2];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int z0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int xs = blockIdx.z * C.run, xe = min(xs + C.run, n0);
  const int y = y0 + ty, z = z0 + tx;
  const bool valid = y < n1 && z < n2;
  const long long st0 = (long long)n1 * n2;
  const long long st1 = (long long)(n1 + 1) * n2;
  const long long st2 = (long long)n1 * (n2 + 1);
  if (threadIdx.x == 0) neg_scale = -__ldg(C.scale);

  Stager<RP, 3, PER, false> LP;
  LP.init(sp, n1, n2, y0, z0, nullptr);
  float a, b;
  auto issue_p = [&](int p) {
    LP.issue(p & (kSlots - 1),
             C.p + row_of<3, PER, HALO, false>(p, n0, nullptr, a, b) * st0);
  };
  // stage k: p plane k + 1, what step k reads beyond step k - 1
  auto issue_stage = [&](int k) {
    if (k < xe) issue_p(k + 1);
    cp_commit();
  };
  auto atp = [&](int p, int r, int q) {
    return sp[p & (kSlots - 1)][r * RP::kCols + q];
  };

  // in-plane offsets of the u* faces this thread corrects: its own low
  // faces and, for 40 threads, a face on the tile's high edge
  const int i1 = threadIdx.x < kTX ? (int)threadIdx.x : tx;
  const int j1 = threadIdx.x < kTX ? kTY : ty;
  const int j2 = threadIdx.x - kTX;  // the column-edge face's row (0..7)
  const bool edge1 = threadIdx.x < kTX;
  const bool edge2 = !edge1 && threadIdx.x < kTX + kTY;
  const int off0 = min(y, n1 - 1) * n2 + min(z, n2 - 1);
  int off1, off1e, off2, off2e;
  {
    float ga = 1.f, gb = 0.f;
    auto o1_at = [&](int j, int i) {
      return in_plane<1, 1, PER, false>(y0 + j, n1, nullptr, ga, gb) * n2 +
             in_plane<1, 2, PER, false>(z0 + i, n2, nullptr, ga, gb);
    };
    auto o2_at = [&](int j, int i) {
      return in_plane<2, 1, PER, false>(y0 + j, n1, nullptr, ga, gb) *
                 (n2 + 1) +
             in_plane<2, 2, PER, false>(z0 + i, n2, nullptr, ga, gb);
    };
    off1 = o1_at(ty, tx);
    off1e = o1_at(j1, i1);
    off2 = o2_at(ty, tx);
    off2e = o2_at(edge2 ? j2 : ty, kTX);
  }

  issue_p(xs - 1);
  cp_commit();
#pragma unroll
  for (int k = 0; k < kAhead; ++k) issue_stage(xs - 1 + k);
  cp_wait<kAhead - 1>();
  __syncthreads();

  // u_1 at face y0 + j, u_2 at face z0 + i: p rows j (cell y0 + j - 1) and
  // j + 1, columns i and i + 1 of the staged region
  // (boundary faces keep s; the correction runs on them too, on clamped
  // copies of p, and is dropped, so the code has no branch)
  auto corr1 = [&](int x, int j, int i, float s) {
    const int yf = y0 + j;
    const float grad = (atp(x, j + 1, i + 1) - atp(x, j, i + 1)) * C.invh[1];
    const float v = s + neg_scale * grad;
    return (!periodic(PER, 1) && (yf == 0 || yf == n1)) ? s : v;
  };
  auto corr2 = [&](int x, int j, int i, float s) {
    const int zf = z0 + i;
    const float grad = (atp(x, j + 1, i + 1) - atp(x, j + 1, i)) * C.invh[2];
    const float v = s + neg_scale * grad;
    return (!periodic(PER, 2) && (zf == 0 || zf == n2)) ? s : v;
  };

  // the u* values step x corrects, loaded a step ahead: u_0 at face x + 1;
  // from step xs on u_1 and u_2 at the thread's faces of plane x
  auto load_us = [&](int x, float (&v)[5]) {
    const int row = row_of<0, PER, HALO, false>(x + 1, n0, nullptr, a, b);
    v[0] = C.us[0][row * st0 + off0];
    if (x >= xs) {
      const float* us1 = C.us[1] + x * st1;
      const float* us2 = C.us[2] + x * st2;
      v[1] = us1[off1];
      v[2] = us2[off2];
      v[3] = edge1 ? us1[off1e] : 0.f;
      v[4] = edge2 ? us2[off2e] : 0.f;
    }
  };
  float cur[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float nxt[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  load_us(xs - 1, cur);
  // OPEN 2: the stencil code of this thread's cell in plane x, a step
  // ahead
  int code = 0, code_next = 0;

  // THERMAL: theta of this thread's cell column at planes x - 1 and x
  // (the low neighbour across axis 0 a wrap or a ghost at plane 0), and
  // of a neighbour across a boundary face fc = 2 axis + side of the cell
  // with value tc
  auto ghost = [&](int fc, float tc) {
    return __ldg(C.tt + 2 * fc) * tc + __ldg(C.tt + 2 * fc + 1);
  };
  float t_m = 0.f, t_c = 0.f;
  if (THERMAL) {
    t_c = __ldg(C.th + xs * st0 + off0);
    t_m = xs > 0 ? __ldg(C.th + (xs - 1) * st0 + off0)
          : (C.twrap & 1) ? __ldg(C.th + (n0 - 1) * st0 + off0)
                          : ghost(0, t_c);
  }

  int div_bits = 0;
  int vel_bits = 0;
  float lo0 = 0.f;  // u_0 at the plane's low face
  for (int x = xs - 1; x < xe; ++x) {
    issue_stage(x + kAhead);
    if (x + 1 < xe) load_us(x + 1, nxt);
    if (OPEN == 2 && x + 1 < xe) {
      code_next = __ldg(C.code + (x + 1) * st0 + off0);
    }
    // THERMAL: theta at plane x + 1 of this column, read ahead of its use
    float t_p = 0.f;
    if (THERMAL && x >= xs) {
      t_p = x + 1 < n0 ? __ldg(C.th + (x + 1) * st0 + off0)
            : (C.twrap & 1) ? __ldg(C.th + off0)
                            : ghost(1, t_c);
    }
    const int f = x + 1;
    const float grad0 =
        (atp(f, ty + 1, tx + 1) - atp(x, ty + 1, tx + 1)) * C.invh[0];
    const bool wall0 = !periodic(PER, 0) && ((f == 0 && !halo_lo(HALO, 0)) ||
                                             (f == n0 && !halo_hi(HALO, 0)));
    const float hi0 = wall0 ? cur[0] : cur[0] + neg_scale * grad0;
    const int buf = x & 1;
    float lo1 = 0.f, lo2 = 0.f;
    if (x >= xs) {
      lo1 = corr1(x, ty, tx, cur[1]);
      lo2 = corr2(x, ty, tx, cur[2]);
      f1[buf][ty * kTX + tx] = lo1;
      f2[buf][ty * (kTX + 1) + tx] = lo2;
      if (edge1) {
        f1[buf][kTY * kTX + i1] = corr1(x, kTY, i1, cur[3]);
      } else if (edge2) {
        f2[buf][j2 * (kTX + 1) + kTX] = corr2(x, j2, kTX, cur[4]);
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) cur[i] = nxt[i];
    cp_wait<kAhead - 1>();
    __syncthreads();
    if (x >= xs && valid) {
      float l0 = lo0, h0 = hi0, l1 = lo1, l2 = lo2;
      float h1 = f1[buf][(ty + 1) * kTX + tx];
      float h2 = f2[buf][ty * (kTX + 1) + tx + 1];
      bool fluid = true;
      if (OPEN == 2) {
        // an interior face corrected where open, a boundary face (u*)
        // zeroed where its cell is solid
        fluid = code & 64;
        if (!(x == 0 ? fluid : (code & 1))) l0 = 0.f;
        if (!(x == n0 - 1 ? fluid : (code & 2))) h0 = 0.f;
        if (!(y == 0 ? fluid : (code & 4))) l1 = 0.f;
        if (!(y == n1 - 1 ? fluid : (code & 8))) h1 = 0.f;
        if (!(z == 0 ? fluid : (code & 16))) l2 = 0.f;
        if (!(z == n2 - 1 ? fluid : (code & 32))) h2 = 0.f;
      }
      // OUTFLOW faces: the corrected inner face (after the masks: zero
      // where that face is closed, and then so is the boundary face's cell
      // or its neighbour)
      if (OPEN > 0) {
        outflow_copies(C.copy, x == n0 - 1, y == 0, y == n1 - 1, z == 0,
                       z == n2 - 1, l0, h0, l1, h1, l2, h2);
      }
      const int c0 = y * n2 + z;
      const int c2 = y * (n2 + 1) + z;
      o0[x * st0 + c0] = l0;
      o1[x * st1 + c0] = l1;
      o2[x * st2 + c2] = l2;
      vel_bits = max(vel_bits, max(abs_bits(l0 * C.invh[0]),
                                   max(abs_bits(l1 * C.invh[1]),
                                       abs_bits(l2 * C.invh[2]))));
      if (x == n0 - 1 && !halo_hi(HALO, 0)) {
        o0[(x + 1) * st0 + c0] = h0;
        vel_bits = max(vel_bits, abs_bits(h0 * C.invh[0]));
      }
      if (y == n1 - 1) {
        o1[x * st1 + c0 + n2] = h1;
        vel_bits = max(vel_bits, abs_bits(h1 * C.invh[1]));
      }
      if (z == n2 - 1) {
        o2[x * st2 + c2 + 1] = h2;
        vel_bits = max(vel_bits, abs_bits(h2 * C.invh[2]));
      }
      // the divergence of fluid cells only (OPEN 2)
      const float div = (h0 - l0) * C.invh[0] + (h1 - l1) * C.invh[1] +
                        (h2 - l2) * C.invh[2];
      if (fluid) div_bits = max(div_bits, abs_bits(div));
      if (THERMAL) {
        // the in-plane neighbours: in the array, wrapped, or ghosts
        const float* __restrict__ thx = C.th + x * st0 + c0;
        const bool tw1 = C.twrap & 2, tw2 = C.twrap & 4;
        const float tm[3] = {
            t_m,
            y > 0 ? thx[-n2] : tw1 ? thx[(n1 - 1) * n2] : ghost(2, t_c),
            z > 0 ? thx[-1] : tw2 ? thx[n2 - 1] : ghost(4, t_c)};
        const float tp[3] = {
            t_p,
            y < n1 - 1 ? thx[n2] : tw1 ? thx[-(n1 - 1) * n2] : ghost(3, t_c),
            z < n2 - 1 ? thx[1] : tw2 ? thx[-(n2 - 1)] : ghost(5, t_c)};
        const float lo[3] = {l0, l1, l2}, hi[3] = {h0, h1, h2};
        const float dt = __ldg(C.dt), alpha = __ldg(C.tt + kTAlpha);
        const float gamma = __ldg(C.tt + kTGamma);
        const float omg = __ldg(C.tt + kTOneMinusGamma);
        C.tho[x * st0 + c0] =
            gamma > 0.f
                ? theta_update<true>(C, dt, alpha, gamma, omg, t_c, tm, tp,
                                     lo, hi)
                : theta_update<false>(C, dt, alpha, gamma, omg, t_c, tm, tp,
                                      lo, hi);
      }
    }
    if (THERMAL && x >= xs) {
      t_m = t_c;
      t_c = t_p;
    }
    if (OPEN == 2) code = code_next;
    lo0 = hi0;
  }
  cp_wait<0>();
  block_max_to(div_bits, maxes + 0);
  block_max_to(vel_bits, maxes + 1);
}

// -- kernel 3: residual ------------------------------------------------------------

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

using PredKernel = void (*)(PredParams, float*, float*, float*, float*);
using CorrKernel = void (*)(CorrParams, float*, float*, float*, int*);
using ResidKernel = void (*)(const float*, const float*, const float*,
                             const uint8_t*, float*, Grid3, float, float,
                             float);
// [force][base]: the Euler form, rk2's based stage 2; the halo mode has
// no forced instantiation (thermal and forced slabs are not ported)
const PredKernel kPredictor[2][2][8] = {
    {NSS_UNSHARDED_TABLE(predictor_rhs_kernel, false, false),
     NSS_UNSHARDED_TABLE(predictor_rhs_kernel, true, false)},
    {NSS_UNSHARDED_TABLE(predictor_rhs_kernel, false, true),
     NSS_UNSHARDED_TABLE(predictor_rhs_kernel, true, true)}};
const PredKernel kPredictorHalo[2][3][4] = {
    NSS_HALO_TABLE(predictor_rhs_kernel, false, false),
    NSS_HALO_TABLE(predictor_rhs_kernel, true, false)};
// [open - 1][base]: the open modes (unsharded, bounded, unforced): the
// faces' kinds and OUTFLOW copies (OPEN 1), and an obstacle's masks (2)
const PredKernel kPredictorOpen[2][2] = {
    {predictor_rhs_kernel<0, 0, false, false, 1>,
     predictor_rhs_kernel<0, 0, true, false, 1>},
    {predictor_rhs_kernel<0, 0, false, false, 2>,
     predictor_rhs_kernel<0, 0, true, false, 2>}};
// [thermal]
const CorrKernel kCorrector[2][8] = {
    NSS_UNSHARDED_TABLE(correct_diag_kernel, false),
    NSS_UNSHARDED_TABLE(correct_diag_kernel, true)};
const CorrKernel kCorrectorHalo[3][4] =
    NSS_HALO_TABLE(correct_diag_kernel, false);
const CorrKernel kCorrectorOpen[2] = {correct_diag_kernel<0, 0, false, 1>,
                                      correct_diag_kernel<0, 0, false, 2>};
const ResidKernel kResidual[8] = NSS_PER_TABLE(residual_kernel);

bool valid_masks(int per, int halo) {
  return per >= 0 && per <= 7 && halo >= 0 && halo <= 3 &&
         !(halo != 0 && periodic(per, 0));
}

// the open mask (bits 2 axis + side: the OUTFLOW faces, none at (0, 0);
// kOpenKinds: a face that is neither a WALL nor PERIODIC) and a stencil
// code: the open modes only unsharded and with no periodic axis. Returns
// the mode (OPEN: 0, 1 or 2), or -1.
constexpr int kOpenKinds = 64;
int open_mode(int per, int halo, int open, const uint8_t* code) {
  if (open < 0 || open > 127 || (open & 1)) return -1;
  if ((open & 63) && !(open & kOpenKinds)) return -1;
  const int mode = code != nullptr ? 2 : open != 0 ? 1 : 0;
  if (mode != 0 && (per != 0 || halo != 0)) return -1;
  return mode;
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// periodic mask outside 0..7, a halo mask outside 0..3, a halo side on a
// periodic axis 0, (the predictor and the corrector) an open mask `open`
// (bits 2 axis + side: the OUTFLOW faces; bit 6: a face that is neither a
// WALL nor PERIODIC) with an OUTFLOW face at (0, 0) or without bit 6, an
// open mask or a stencil code `code` (the masked mode) with a periodic or
// halo mask, or with the forced or thermal mode, (the predictor) a base
// given for some components only,
// or (the predictor and the corrector) a thermal mode with a halo mask or
// with some of its pointers missing, or (the predictor) a forced mode with
// a halo mask. The predictor and the corrector take
// the reciprocal spacings as float32 (1/(2h), 1/h, 1/h^2 per axis), formed
// by the caller; the predictor reads dt and rho/dt from `dts`, the
// corrector dt/rho from `scale`, both device pointers. b0..b2 null: the
// Euler form; all three given: rk2's based stage 2. `force` nonzero: the
// forced mode, the static force of bc[18..20] and the forcing volumes
// f0..f2 that are not null (interior-face layout, see above; fewer than
// 2^31 cells); the bc buffer holds 39 floats (the face values, the force,
// the ghost maps from kAlphaAt); th and tt (theta and the thermal buffer)
// given: the thermal mode, forced with the buoyancy; the corrector then
// also takes tho (the new theta), dt (its step size, a device pointer),
// invhh0..2 (1/h^2) and twrap (bit a set where the scalar wraps on axis
// a). `code` (uint8, the grid's shape) given: OPEN 2, else `open` nonzero:
// OPEN 1.

int nss_predictor_rhs_3d(const float* u0, const float* u1, const float* u2,
                         float* o0, float* o1, float* o2, float* rhs,
                         const float* bc, const float* b0, const float* b1,
                         const float* b2, const float* dts, const float* th,
                         const float* tt, const float* f0, const float* f1,
                         const float* f2, const uint8_t* code, int n0,
                         int n1, int n2,
                         float inv2h0, float inv2h1, float inv2h2,
                         float invh0, float invh1, float invh2,
                         float invhh0, float invhh1, float invhh2,
                         float nu, float gamma, float one_minus_gamma,
                         int per, int halo, int force, int open,
                         void* stream) {
  PredParams P;
  P.u[0] = u0;
  P.u[1] = u1;
  P.u[2] = u2;
  P.base[0] = b0;
  P.base[1] = b1;
  P.base[2] = b2;
  P.bc = bc;
  P.code = code;
  P.copy = open & 63;
  P.dts = dts;
  P.th = th;
  P.tt = tt;
  P.fv[0] = f0;
  P.fv[1] = f1;
  P.fv[2] = f2;
  P.fpl[0] = n1 * n2;
  P.fpl[1] = (periodic(per, 1) ? n1 : n1 - 1) * n2;
  P.fpl[2] = n1 * (periodic(per, 2) ? n2 : n2 - 1);
  P.g.n[0] = n0;
  P.g.n[1] = n1;
  P.g.n[2] = n2;
  P.inv2h[0] = inv2h0;
  P.inv2h[1] = inv2h1;
  P.inv2h[2] = inv2h2;
  P.invh[0] = invh0;
  P.invh[1] = invh1;
  P.invh[2] = invh2;
  P.invh2[0] = invhh0;
  P.invh2[1] = invhh1;
  P.invh2[2] = invhh2;
  P.nu = nu;
  P.gamma = gamma;
  P.one_minus_gamma = one_minus_gamma;
  P.run = run_for(P.g);
  if (!valid_masks(per, halo)) return (int)cudaErrorInvalidValue;
  const int based = b0 != nullptr;
  if ((b1 != nullptr) != based || (b2 != nullptr) != based) {
    return (int)cudaErrorInvalidValue;
  }
  const int thermal = th != nullptr;
  if ((tt != nullptr) != (bool)thermal) return (int)cudaErrorInvalidValue;
  const bool vols = f0 != nullptr || f1 != nullptr || f2 != nullptr;
  if (vols && (force == 0 || (long long)n0 * n1 * n2 >= (1ll << 31))) {
    return (int)cudaErrorInvalidValue;
  }
  const int forced = force != 0 || thermal;
  if (forced && halo != 0) return (int)cudaErrorInvalidValue;
  const int mode = open_mode(per, halo, open, code);
  if (mode < 0 || (mode != 0 && forced)) return (int)cudaErrorInvalidValue;
  const PredKernel k = mode != 0   ? kPredictorOpen[mode - 1][based]
                       : halo == 0 ? kPredictor[forced][based][per]
                                 : kPredictorHalo[based][halo - 1][per >> 1];
  k<<<march_grid(P.g, P.run), kThreads, 0, (cudaStream_t)stream>>>(
      P, o0, o1, o2, rhs);
  return (int)cudaGetLastError();
}

int nss_correct_diag_3d(const float* s0, const float* s1, const float* s2,
                        const float* p, float* o0, float* o1, float* o2,
                        int* maxes, const float* scale, const float* th,
                        float* tho, const float* tt, const float* dt,
                        const uint8_t* code, int n0, int n1, int n2,
                        float invh0, float invh1, float invh2, float invhh0,
                        float invhh1, float invhh2, int per, int halo,
                        int twrap, int open, void* stream) {
  CorrParams C;
  C.us[0] = s0;
  C.us[1] = s1;
  C.us[2] = s2;
  C.p = p;
  C.code = code;
  C.copy = open & 63;
  C.scale = scale;
  C.th = th;
  C.tt = tt;
  C.dt = dt;
  C.tho = tho;
  C.g.n[0] = n0;
  C.g.n[1] = n1;
  C.g.n[2] = n2;
  C.invh[0] = invh0;
  C.invh[1] = invh1;
  C.invh[2] = invh2;
  C.invhh[0] = invhh0;
  C.invhh[1] = invhh1;
  C.invhh[2] = invhh2;
  C.twrap = twrap;
  C.run = run_for(C.g);
  if (!valid_masks(per, halo)) return (int)cudaErrorInvalidValue;
  const int thermal = th != nullptr;
  if ((tho != nullptr) != (bool)thermal || (tt != nullptr) != (bool)thermal ||
      (dt != nullptr) != (bool)thermal || (thermal && halo != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int mode = open_mode(per, halo, open, code);
  if (mode < 0 || (mode != 0 && thermal)) return (int)cudaErrorInvalidValue;
  const CorrKernel k = mode != 0   ? kCorrectorOpen[mode - 1]
                       : halo == 0 ? kCorrector[thermal][per]
                                   : kCorrectorHalo[halo - 1][per >> 1];
  k<<<march_grid(C.g, C.run), kThreads, 0, (cudaStream_t)stream>>>(
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
