// The axis-0 march that the port's tiled 3D stencils share (kernels 1-2 in
// fused3d.cu, kernels 6-7 in predictor3d.cu): a block of 256 threads owns
// a tile of 8 rows of axis 1 by 32 cells of the contiguous axis 2 and walks
// a run of axis-0 planes; each input field's planes pass through a ring of
// 8 plane slots in shared memory (the tile plus a one-cell halo), filled by
// 4-byte cp.async two planes ahead of the one computed. The wall, wrap and
// halo case analysis happens once, where an element is staged: Stager
// copies a field's region of a plane and fixes its ghosts in place (the
// reflection 2 u_wall - edge across a wall; with KINDS, the faces' kinds
// from the bc buffer: ghost = alpha edge + (1 - alpha) u_face, the
// reflection across WALL and INFLOW faces, alpha = -1, the edge's copy
// across SLIP and OUTFLOW faces, alpha = 1), row_of picks the plane (a
// ghost plane beyond an axis-0 face, a wrap, a slab's ghost row), in_plane
// the element of a row. run_for and march_grid size the launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace nss {
namespace march {

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

constexpr int kTX = 32;        // cells of axis 2 in a tile
constexpr int kTY = 8;         // rows of axis 1 in a tile
static_assert(kTX * kTY == kThreads, "one thread a cell of the tile");
constexpr int kSlots = 8;      // plane slots of a ring (plane p in slot p & 7)
constexpr int kAhead = 2;      // planes whose copies are in flight
constexpr int kMaxRun = 32;    // axis-0 planes a block marches, at most ...
constexpr int kMinRun = 8;     // ... and at least, where the grid allows
constexpr long long kBlocksWanted = 8 * 132;  // 8 blocks an H100 SM
// the bc buffer (ops/fused3d.bc_table): the face values u_face of
// [(axis*2 + side)*3 + comp], then from kAlphaAt each one's ghost map
// alpha (tangential components: -1 reflect, 1 copy; a face's own
// component: 1 on an OUTFLOW face, whose boundary value copies the inner
// face, 0 on a Dirichlet face)
constexpr int kAlphaAt = 21;

// the ghost map v -> ga v + gb composed with the ghost of face f (an
// index of the bc buffer): without KINDS the reflection 2 u_wall - v, with
// KINDS alpha v + (1 - alpha) u_face (alpha = -1: the same reflection)
template <bool KINDS>
__device__ __forceinline__ void ghost_of(const float* bc, int f, float& ga,
                                         float& gb) {
  if (KINDS) {
    const float al = bc[kAlphaAt + f];
    ga = al * ga;
    gb = al * gb + (1.f - al) * bc[f];
  } else {
    ga = -ga;
    gb = 2.f * bc[f] - gb;
  }
}

// 4 bytes from global `src` to the shared-memory address `dst`
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group of this thread but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A field's staged region of one plane: ROWS rows of axis 1 from y0 - 1 and
// COLS columns of axis 2 from z0 - 1, row-major.
template <int ROWS, int COLS>
struct Region {
  static constexpr int kCols = COLS, kSize = ROWS * COLS;
  static constexpr int kPer = (kSize + kThreads - 1) / kThreads;
};
using R0 = Region<kTY + 2, kTX + 2>;  // u0: cells y0-1..y0+8, z0-1..z0+32
using R1 = Region<kTY + 3, kTX + 2>;  // u1: faces y0-1..y0+9
using R2 = Region<kTY + 2, kTX + 3>;  // u2: faces z0-1..z0+33
using RP = Region<kTY + 2, kTX + 2>;  // p (kernel 2)

// The array index along axis AX (1 or 2, n cells) that a staged element of
// component C (3: a cell field) at coordinate i copies, and with GHOSTS the
// affine map v -> ga v + gb that makes the ghost of it beyond a face
// tangential to C (ghost_of). Own-axis faces beyond the boundary faces are
// clamped: they feed only boundary faces, which take their boundary value.
template <int C, int AX, int PER, bool GHOSTS, bool KINDS = false>
__device__ __forceinline__ int in_plane(int i, int n, const float* bc,
                                        float& ga, float& gb) {
  if (periodic(PER, AX)) {
    i %= n;
    return i < 0 ? i + n : i;
  }
  if (C == AX) return min(max(i, 0), n);
  if (i < 0 || i >= n) {
    const int side = i < 0 ? 0 : 1;
    if (GHOSTS) ghost_of<KINDS>(bc, (AX * 2 + side) * 3 + C, ga, gb);
    return side ? n - 1 : 0;
  }
  return i;
}

// The buffer row that plane p of component C (3: p) is copied from, and
// with GHOSTS the map of a ghost plane beyond an axis-0 face tangential to
// C. A halo side has its ghost rows (u0 faces -1, b+1; u1 and u2 cells -1,
// b, b+1; p cells -1, b); a periodic axis 0 wraps (p in [-1, n0 + 1]).
template <int C, int PER, int HALO, bool GHOSTS, bool KINDS = false>
__device__ __forceinline__ int row_of(int p, int n0, const float* bc,
                                      float& a0, float& b0) {
  a0 = 1.f;
  b0 = 0.f;
  if (periodic(PER, 0)) return p < 0 ? p + n0 : (p >= n0 ? p - n0 : p);
  const int lo = halo_lo(HALO, 0) ? -1 : 0;
  const int hi = C == 0   ? (halo_hi(HALO, 0) ? n0 + 1 : n0)
                 : C == 3 ? (halo_hi(HALO, 0) ? n0 : n0 - 1)
                          : (halo_hi(HALO, 0) ? n0 + 1 : n0 - 1);
  const bool wall_lo = p < lo && !halo_lo(HALO, 0);
  const bool wall_hi = p > hi && !halo_hi(HALO, 0);
  if (GHOSTS && C != 0 && (wall_lo || wall_hi)) {
    ghost_of<KINDS>(bc, (wall_lo ? 0 : 1) * 3 + C, a0, b0);
  }
  return min(max(p, lo), hi);
}

// The elements of a Region that this thread copies (element tid + k*256)
// into the slots of a ring: their in-plane offsets (-1: none) and ghost
// maps, and the shared address of the first in slot 0.
template <class R, int C, int PER, bool GHOSTS, bool KINDS = false>
struct Stager {
  static constexpr uint32_t kSlotBytes = R::kSize * sizeof(float);
  int off[R::kPer];
  float ga[R::kPer], gb[R::kPer];
  bool ghosts;  // some element of this thread is a wall ghost
  uint32_t sdst;

  __device__ __forceinline__ void init(float (*ring)[R::kSize], int n1,
                                       int n2, int y0, int z0,
                                       const float* bc) {
    const int d2 = n2 + (C == 2);
    sdst = (uint32_t)__cvta_generic_to_shared(&ring[0][threadIdx.x]);
    ghosts = false;
#pragma unroll
    for (int k = 0; k < R::kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      ga[k] = 1.f;
      gb[k] = 0.f;
      off[k] = -1;
      if (i < R::kSize) {
        const int r = i / R::kCols;
        const int q = i - r * R::kCols;
        const int y = in_plane<C, 1, PER, GHOSTS, KINDS>(y0 - 1 + r, n1, bc,
                                                         ga[k], gb[k]);
        const int z = in_plane<C, 2, PER, GHOSTS, KINDS>(z0 - 1 + q, n2, bc,
                                                         ga[k], gb[k]);
        off[k] = y * d2 + z;
        ghosts = ghosts || ga[k] != 1.f || gb[k] != 0.f;
      }
    }
  }

  // start copying the region of buffer row `plane` into ring slot `slot`
  __device__ __forceinline__ void issue(int slot, const float* plane) const {
    const uint32_t d = sdst + (uint32_t)slot * kSlotBytes;
#pragma unroll
    for (int k = 0; k < R::kPer; ++k) {
      if (off[k] >= 0) cp_async4(d + k * kThreads * sizeof(float), plane + off[k]);
    }
  }

  // once this thread's copies into `dst` have landed: its ghost elements
  // (a0, b0: the plane's own map; only tiles at a boundary have any)
  __device__ __forceinline__ void fix(float* dst, float a0, float b0) const {
    if (!GHOSTS || !(ghosts || a0 != 1.f)) return;
#pragma unroll
    for (int k = 0; k < R::kPer; ++k) {
      if (off[k] >= 0) {
        float& v = dst[threadIdx.x + k * kThreads];
        v = a0 * (ga[k] * v + gb[k]) + b0;
      }
    }
  }
};

// The axis-0 planes a block of the march walks: the longest run, halved
// down to kMinRun while the grid would have fewer than kBlocksWanted blocks.
inline int run_for(const Grid3& g) {
  const long long tiles = (long long)((g.n[2] + kTX - 1) / kTX) *
                          ((g.n[1] + kTY - 1) / kTY);
  int run = kMaxRun;
  while (run > kMinRun && tiles * ((g.n[0] + run - 1) / run) < kBlocksWanted) {
    run /= 2;
  }
  return run;
}

inline dim3 march_grid(const Grid3& g, int run) {
  return dim3((g.n[2] + kTX - 1) / kTX, (g.n[1] + kTY - 1) / kTY,
              (g.n[0] + run - 1) / run);
}

}  // namespace march
}  // namespace nss
