// Multigrid level kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels carry the 2D V-cycle of the PyTorch port's multigrid
// pressure solver (navierstokessolver_tpu_torch/ops/multigrid_kernels.py
// binds them with ctypes):
//
//   nss_rb_sweeps  replaces navierstokessolver_tpu/ops/pallas_kernels.py
//                  _rb_sweep_kernel: n red-black Gauss-Seidel/SOR sweeps.
//   nss_mg_pre     replaces pallas_kernels.py _mg_pre_kernel: n sweeps, then
//                  the residual r = (b - A p') * fluid.
//   nss_mg_post    replaces pallas_kernels.py _mg_post_kernel: the
//                  correction p0 = (p + e) * fluid, n sweeps, then one
//                  partial sum of ((b - A p') * fluid)^2 per block (the
//                  wrapper sums the partials: deterministic, no atomics).
//
// Layout: the exact (n0, n1) C-contiguous layout of the port's fields,
// float32 p, b, e and diag, uint8 stencil code (bits 1/2: axis-0 low/high
// coupling, 4/8: axis-1 low/high, 64: fluid). None of the TPU kernels'
// 32-row halo stripes, 128-lane padding or (8, 128) partial tiles carries
// over.
//
// Semantics kept from the Pallas kernels: red means (i + j) % 2 == 0 over
// global indices, red updated first; gs = b/d - (cl0 up + ch0 dn + cl1 lf +
// ch1 rt) with cl = w * bit / d; the blend (1 - omega) p + omega gs only when
// omega != 1; no fluid gate inside a sweep (a non-fluid cell has b = 0, no
// coupling and d = 1, so gs = 0 = p under the solver's p = p * fluid); an
// out-of-range neighbor counts as zero coupling; the residual uses the
// undivided coefficients, b - (d p + l0 up + h0 dn + l1 lf + h1 rt).
//
// What bounds them on this card: memory. Per cell a kernel must read p, b,
// diag (and e) as float32 and the code as one byte, and write p (and r):
// rb_sweeps 13 + 4 B, mg_pre 13 + 8 B, mg_post 17 + 4 B; at 2048^2 that is
// 71, 88 and 88 MB, 21, 26 and 26 us at 3.35 TB/s. The work is ~15 flops
// per cell per colour pass, far below the card's float32 rate. The design
// answers the bound with one pass over memory per call, whatever n: each
// block stages an output tile plus a halo in shared memory (p, b, diag,
// code: 13 B a cell; mg_post also e), runs all 2n colour passes there,
// and writes the tile. A pass updates each interior cell of the staged
// region from its neighbors; the region's edge cells are never updated,
// so a wrong value moves in one cell per pass and stays out of the tile
// as long as the halo is as wide as the passes (and the residual's one
// more neighbor).
//
// rb_sweeps_kernel and level_kernel (mg_pre, mg_post) are laid out for
// Hopper the same way. The staging is asynchronous, every copy of the
// block in flight at once (cp.async, 16 bytes a copy of p, b, diag and e
// and 4 of the code where n1 % 4 == 0 and every array is 16-byte aligned,
// else 4-byte copies and byte loads of the code; the copies beyond the
// domain zero-fill). A pass updates only the cells of its colour that the
// last pass needs, its lanes every other cell of a row, no division of an
// index. The tile leaves in 16-byte stores.
//
// rb_sweeps (rb_sweeps_kernel): a 32 x 56 tile (a row of a pass at n = 2
// fits one warp, which takes the row); the halo is 2n rows and 2n columns
// rounded up to 4 (no residual follows); pass s updates the cells within
// 2n - 1 - s of the tile.
//
// mg_pre and mg_post (level_kernel): the tile, the halo, the grid and the
// shared memory come from the wrapper's plan for the level
// (ops/multigrid_kernels.level_plan, checked here by plan_ok): tall, wide
// tiles on the large levels (32 x 88 at 2048^2), which stage fewer halo
// cells a cell, short, narrow ones on the small levels (8 x 24 at 128^2),
// which keep more SMs busy. The halo is 2n + 1 rows and 2n + 1 columns
// rounded up to 4: pass s updates the cells within 2n - s of the tile, so
// the last one leaves the tile and the ring around it final, which the
// residual reads. A warp takes two rows of a pass, a half-warp each, so
// that its lanes never share a bank. mg_post stages e beside p and folds
// p = (p + e) fluid over the whole staged region after the wait (the
// first pass reads the region's edge). The residual is computed as the
// tile leaves, from 16-byte loads on the vector path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::kThreads;

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

enum Mode { kPre = 1, kPost = 2 };

struct Level {
  const float* p;
  const float* b;
  const float* diag;
  const uint8_t* code;
  const float* e;    // kPost: the prolongated correction
  float* p_out;
  float* r_out;      // kPre: the residual
  float* partials;   // kPost: one sum of squares per block
  int n0, n1, n_sweeps;
  float omega, one_minus_omega;
  int blend;         // omega != 1
  float w0, w1;      // couplings 1/h_a^2
};

// mg_pre's and mg_post's tiling of one level, from the wrapper's plan
struct Plan {
  int tile_rows, tile_cols;  // output cells per block along axes 0, 1
  int halo_rows, halo_cols;  // staged on either side of the tile
  int grid_rows, grid_cols;  // blocks along axes 0, 1
  int smem_bytes;            // dynamic shared memory
};

__host__ __device__ inline int staged_rows(const Plan& P) {
  return P.tile_rows + 2 * P.halo_rows;
}

__host__ __device__ inline int staged_cols(const Plan& P) {
  return P.tile_cols + 2 * P.halo_cols;
}

// p, b, diag (and e) as float32 and the code as one byte per staged cell
template <int MODE>
inline long long level_smem_bytes(const Plan& P) {
  return (long long)staged_rows(P) * staged_cols(P) *
         ((MODE == kPost ? 4 : 3) * (long long)sizeof(float) + 1);
}

// The plan covers the level's cells once, stages the halo the 2n passes
// and the residual read (2n + 1), keeps the region's rows 16-byte aligned
// (the tile and halo columns multiples of 4) and states its shared memory.
template <int MODE>
bool plan_ok(const Plan& P, int n0, int n1, int n_sweeps) {
  const int h = 2 * n_sweeps + 1;
  return n0 > 0 && n1 > 0 && P.tile_rows > 0 && P.tile_cols > 0 &&
         P.tile_cols % 4 == 0 && P.halo_rows >= h && P.halo_cols >= h &&
         P.halo_cols % 4 == 0 &&
         P.grid_rows == (n0 + P.tile_rows - 1) / P.tile_rows &&
         P.grid_cols == (n1 + P.tile_cols - 1) / P.tile_cols &&
         (long long)P.smem_bytes == level_smem_bytes<MODE>(P) &&
         P.smem_bytes <= kMaxSmem;
}

// Sum over the block, valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sum[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? warp_sum[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
  }
  return v;
}

constexpr int kRbRows = 32;  // rb_sweeps: output rows per block (axis 0)
constexpr int kRbCols = 56;  // output columns per block (axis 1)

// rb_sweeps' staged region: the tile, h = 2n rows above and below it, and
// ha = h rounded up to 4 columns on either side, so that a row of the
// region starts 16 bytes into the row where n1 % 4 == 0.
struct RbRegion {
  int h, ha, rows, cols;
};

__host__ __device__ inline RbRegion rb_region(int n_sweeps) {
  const int h = 2 * n_sweeps;
  const int ha = (h + 3) & ~3;
  return {h, ha, kRbRows + 2 * h, kRbCols + 2 * ha};
}

inline size_t rb_smem_bytes(int n_sweeps) {
  const RbRegion R = rb_region(n_sweeps);
  return (size_t)R.rows * R.cols * (3 * sizeof(float) + 1);
}

// `bytes` (4 or 16) from global `src` to shared `dst`; src_size 0 fills
// the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

// n red-black sweeps on one kRbRows x kRbCols tile. `vec`: n1 % 4 == 0 and
// every array 16-byte aligned (the code 4-byte), so 16-byte copies.
__global__ void __launch_bounds__(kThreads)
rb_sweeps_kernel(Level L, int vec) {
  extern __shared__ __align__(16) float rb_smem[];
  const RbRegion R = rb_region(L.n_sweeps);
  const int cells = R.rows * R.cols;
  float* sp = rb_smem;
  float* sb = sp + cells;
  float* sd = sb + cells;
  uint8_t* sc = reinterpret_cast<uint8_t*>(sd + cells);
  const int n0 = L.n0, n1 = L.n1, C = R.cols;
  const int ti0 = (int)blockIdx.y * kRbRows;  // the tile's first cell
  const int tj0 = (int)blockIdx.x * kRbCols;
  const int gi0 = ti0 - R.h;                  // the region's; may be < 0
  const int gj0 = tj0 - R.ha;

  // stage every copy of the block, then wait once; cells beyond the
  // domain hold p = b = diag = 0 and no coupling (no pass reads their diag)
  if (vec) {
    const int q = C / 4;  // 16-byte pieces a row
    for (int k = threadIdx.x; k < R.rows * q; k += blockDim.x) {
      const int li = k / q;
      const int lj = 4 * (k - li * q);
      const int gi = gi0 + li, gj = gj0 + lj;
      // a piece lies wholly inside or outside: gj0 and n1 are multiples of 4
      const bool in = gi >= 0 && gi < n0 && gj >= 0 && gj < n1;
      const long long g = in ? (long long)gi * n1 + gj : 0;
      const int c = li * C + lj;
      cp_async(sp + c, L.p + g, 16, in);
      cp_async(sb + c, L.b + g, 16, in);
      cp_async(sd + c, L.diag + g, 16, in);
      cp_async(sc + c, L.code + g, 4, in);
    }
  } else {
    for (int k = threadIdx.x; k < cells; k += blockDim.x) {
      const int li = k / C;
      const int gi = gi0 + li, gj = gj0 + (k - li * C);
      const bool in = gi >= 0 && gi < n0 && gj >= 0 && gj < n1;
      const long long g = in ? (long long)gi * n1 + gj : 0;
      cp_async(sp + k, L.p + g, 4, in);
      cp_async(sb + k, L.b + g, 4, in);
      cp_async(sd + k, L.diag + g, 4, in);
      sc[k] = in ? L.code[g] : 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2n colour passes, red ((i + j) even) first. Pass s updates the cells
  // of its colour within m = h - 1 - s of the tile (and in the domain): a
  // warp a row, its lanes every other cell of the row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = 0; s < 2 * L.n_sweeps; ++s) {
    const int m = R.h - 1 - s;
    const int r_lo = max(ti0 - m, 0), r_hi = min(ti0 + kRbRows + m, n0);
    const int c_lo = max(tj0 - m, 0), c_hi = min(tj0 + kRbCols + m, n1);
    for (int gi = r_lo + warp; gi < r_hi; gi += kThreads / 32) {
      const int row = (gi - gi0) * C - gj0;  // shared index of (gi, 0)
      const int first = c_lo + ((s + gi + c_lo) & 1);
      for (int gj = first + 2 * lane; gj < c_hi; gj += 64) {
        const int c = row + gj;
        const unsigned cc = sc[c];
        const float inv_d = 1.f / sd[c];
        const float cl0 = ((cc & 1u) ? L.w0 : 0.f) * inv_d;
        const float ch0 = ((cc & 2u) ? L.w0 : 0.f) * inv_d;
        const float cl1 = ((cc & 4u) ? L.w1 : 0.f) * inv_d;
        const float ch1 = ((cc & 8u) ? L.w1 : 0.f) * inv_d;
        float gs = sb[c] * inv_d - (((cl0 * sp[c - C] + ch0 * sp[c + C]) +
                                     cl1 * sp[c - 1]) +
                                    ch1 * sp[c + 1]);
        if (L.blend) gs = L.one_minus_omega * sp[c] + L.omega * gs;
        sp[c] = gs;
      }
    }
    __syncthreads();
  }

  // write the tile
  if (vec) {
    const int q = kRbCols / 4;
    for (int k = threadIdx.x; k < kRbRows * q; k += blockDim.x) {
      const int ti = k / q;
      const int tj = 4 * (k - ti * q);
      const int gi = ti0 + ti, gj = tj0 + tj;
      if (gi < n0 && gj < n1) {
        *reinterpret_cast<float4*>(L.p_out + (long long)gi * n1 + gj) =
            *reinterpret_cast<const float4*>(sp + (ti + R.h) * C + R.ha +
                                             tj);
      }
    }
  } else {
    for (int k = threadIdx.x; k < kRbRows * kRbCols; k += blockDim.x) {
      const int ti = k / kRbCols;
      const int tj = k - ti * kRbCols;
      const int gi = ti0 + ti, gj = tj0 + tj;
      if (gi < n0 && gj < n1) {
        L.p_out[(long long)gi * n1 + gj] = sp[(ti + R.h) * C + R.ha + tj];
      }
    }
  }
}

// (b - A p) fluid of a cell with code cc, diagonal d and right side b,
// from p and its neighbours, with the undivided coefficients, summed in
// the Pallas order
__device__ __forceinline__ float residual_of(unsigned cc, float d, float b,
                                             float p, float up, float dn,
                                             float lf, float rt, float w0,
                                             float w1) {
  const float l0 = (cc & 1u) ? w0 : 0.f;
  const float h0 = (cc & 2u) ? w0 : 0.f;
  const float l1 = (cc & 4u) ? w1 : 0.f;
  const float h1 = (cc & 8u) ? w1 : 0.f;
  const float fluid = (cc & 64u) ? 1.f : 0.f;
  const float ap = (((d * p + l0 * up) + h0 * dn) + l1 * lf) + h1 * rt;
  return (b - ap) * fluid;
}

// mg_pre (n sweeps, then r) or mg_post ((p + e) fluid, n sweeps, one
// partial sum of r^2) on one tile of the plan. `vec`: n1 % 4 == 0 and
// every array 16-byte aligned (the code 4-byte), so 16-byte copies.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
level_kernel(Level L, Plan P, int vec) {
  extern __shared__ __align__(16) float lv_smem[];
  const int C = staged_cols(P);  // a multiple of 4
  const int rows = staged_rows(P);
  const int cells = rows * C;
  float* sp = lv_smem;
  float* sb = sp + cells;
  float* sd = sb + cells;
  float* se = sd + cells;  // kPost only
  uint8_t* sc = reinterpret_cast<uint8_t*>(MODE == kPost ? se + cells : se);
  const int n0 = L.n0, n1 = L.n1;
  const int ti0 = (int)blockIdx.y * P.tile_rows;  // the tile's first cell
  const int tj0 = (int)blockIdx.x * P.tile_cols;
  const int gi0 = ti0 - P.halo_rows;              // the region's; may be < 0
  const int gj0 = tj0 - P.halo_cols;

  // stage every copy of the block, then wait once; cells beyond the
  // domain hold p = b = e = diag = 0 and no coupling (no pass reads their
  // diag, and the residual only the tile's)
  if (vec) {
    const int q = C / 4;  // 16-byte pieces a row
    for (int k = threadIdx.x; k < rows * q; k += blockDim.x) {
      const int li = k / q;
      const int lj = 4 * (k - li * q);
      const int gi = gi0 + li, gj = gj0 + lj;
      // a piece lies wholly inside or outside: gj0 and n1 are multiples of 4
      const bool in = gi >= 0 && gi < n0 && gj >= 0 && gj < n1;
      const long long g = in ? (long long)gi * n1 + gj : 0;
      const int c = li * C + lj;
      cp_async(sp + c, L.p + g, 16, in);
      cp_async(sb + c, L.b + g, 16, in);
      cp_async(sd + c, L.diag + g, 16, in);
      if (MODE == kPost) cp_async(se + c, L.e + g, 16, in);
      cp_async(sc + c, L.code + g, 4, in);
    }
  } else {
    for (int k = threadIdx.x; k < cells; k += blockDim.x) {
      const int li = k / C;
      const int gi = gi0 + li, gj = gj0 + (k - li * C);
      const bool in = gi >= 0 && gi < n0 && gj >= 0 && gj < n1;
      const long long g = in ? (long long)gi * n1 + gj : 0;
      cp_async(sp + k, L.p + g, 4, in);
      cp_async(sb + k, L.b + g, 4, in);
      cp_async(sd + k, L.diag + g, 4, in);
      if (MODE == kPost) cp_async(se + k, L.e + g, 4, in);
      sc[k] = in ? L.code[g] : 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (MODE == kPost) {
    // the correction p = (p + e) fluid, on the whole staged region
    for (int k = 4 * threadIdx.x; k < cells; k += 4 * blockDim.x) {
      float4 pv = *reinterpret_cast<const float4*>(sp + k);
      const float4 ev = *reinterpret_cast<const float4*>(se + k);
      const uchar4 cv = *reinterpret_cast<const uchar4*>(sc + k);
      pv.x = (pv.x + ev.x) * ((cv.x & 64u) ? 1.f : 0.f);
      pv.y = (pv.y + ev.y) * ((cv.y & 64u) ? 1.f : 0.f);
      pv.z = (pv.z + ev.z) * ((cv.z & 64u) ? 1.f : 0.f);
      pv.w = (pv.w + ev.w) * ((cv.w & 64u) ? 1.f : 0.f);
      *reinterpret_cast<float4*>(sp + k) = pv;
    }
    __syncthreads();
  }

  // 2n colour passes, red ((i + j) even) first. Pass s updates the cells
  // of its colour within m = 2n - s of the tile (and in the domain). A
  // warp takes two rows, a half-warp each, its 16 lanes every other cell
  // of the row: one row's cells of a colour lie on even banks and the
  // other's on odd ones (C is even), so no two lanes share a bank, as
  // they would with a warp on one row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int passes = 2 * L.n_sweeps;
  for (int s = 0; s < passes; ++s) {
    const int m = passes - s;
    const int r_lo = max(ti0 - m, 0), r_hi = min(ti0 + P.tile_rows + m, n0);
    const int c_lo = max(tj0 - m, 0), c_hi = min(tj0 + P.tile_cols + m, n1);
    for (int gi = r_lo + 2 * warp + half; gi < r_hi; gi += kThreads / 16) {
      const int row = (gi - gi0) * C - gj0;  // shared index of (gi, 0)
      const int first = c_lo + ((s + gi + c_lo) & 1);
      for (int gj = first + 2 * hl; gj < c_hi; gj += 32) {
        const int c = row + gj;
        const unsigned cc = sc[c];
        const float inv_d = 1.f / sd[c];
        const float cl0 = ((cc & 1u) ? L.w0 : 0.f) * inv_d;
        const float ch0 = ((cc & 2u) ? L.w0 : 0.f) * inv_d;
        const float cl1 = ((cc & 4u) ? L.w1 : 0.f) * inv_d;
        const float ch1 = ((cc & 8u) ? L.w1 : 0.f) * inv_d;
        float gs = sb[c] * inv_d - (((cl0 * sp[c - C] + ch0 * sp[c + C]) +
                                     cl1 * sp[c - 1]) +
                                    ch1 * sp[c + 1]);
        if (L.blend) gs = L.one_minus_omega * sp[c] + L.omega * gs;
        sp[c] = gs;
      }
    }
    __syncthreads();
  }

  // write the tile and its residual (mg_pre) or sum the residual's
  // squares (mg_post); on the vector path a thread reads 4 cells and their
  // rows above and below in 16-byte loads
  float acc = 0.f;
  const float w0 = L.w0, w1 = L.w1;
  if (vec) {
    const int q = P.tile_cols / 4;
    for (int k = threadIdx.x; k < P.tile_rows * q; k += blockDim.x) {
      const int ti = k / q;
      const int tj = 4 * (k - ti * q);
      const int gi = ti0 + ti, gj = tj0 + tj;
      if (gi >= n0 || gj >= n1) continue;
      const int c = (ti + P.halo_rows) * C + P.halo_cols + tj;
      const long long g = (long long)gi * n1 + gj;
      const float4 p = *reinterpret_cast<const float4*>(sp + c);
      const float4 up = *reinterpret_cast<const float4*>(sp + c - C);
      const float4 dn = *reinterpret_cast<const float4*>(sp + c + C);
      const float4 b = *reinterpret_cast<const float4*>(sb + c);
      const float4 d = *reinterpret_cast<const float4*>(sd + c);
      const uchar4 cc = *reinterpret_cast<const uchar4*>(sc + c);
      const float lf = sp[c - 1], rt = sp[c + 4];
      float4 r;
      r.x = residual_of(cc.x, d.x, b.x, p.x, up.x, dn.x, lf, p.y, w0, w1);
      r.y = residual_of(cc.y, d.y, b.y, p.y, up.y, dn.y, p.x, p.z, w0, w1);
      r.z = residual_of(cc.z, d.z, b.z, p.z, up.z, dn.z, p.y, p.w, w0, w1);
      r.w = residual_of(cc.w, d.w, b.w, p.w, up.w, dn.w, p.z, rt, w0, w1);
      *reinterpret_cast<float4*>(L.p_out + g) = p;
      if (MODE == kPre) {
        *reinterpret_cast<float4*>(L.r_out + g) = r;
      } else {
        acc += r.x * r.x;
        acc += r.y * r.y;
        acc += r.z * r.z;
        acc += r.w * r.w;
      }
    }
  } else {
    for (int k = threadIdx.x; k < P.tile_rows * P.tile_cols;
         k += blockDim.x) {
      const int ti = k / P.tile_cols;
      const int tj = k - ti * P.tile_cols;
      const int gi = ti0 + ti, gj = tj0 + tj;
      if (gi >= n0 || gj >= n1) continue;
      const int c = (ti + P.halo_rows) * C + P.halo_cols + tj;
      const long long g = (long long)gi * n1 + gj;
      const float r =
          residual_of(sc[c], sd[c], sb[c], sp[c], sp[c - C], sp[c + C],
                      sp[c - 1], sp[c + 1], w0, w1);
      L.p_out[g] = sp[c];
      if (MODE == kPre) {
        L.r_out[g] = r;
      } else {
        acc += r * r;
      }
    }
  }
  if (MODE == kPost) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) {
      L.partials[blockIdx.y * gridDim.x + blockIdx.x] = acc;
    }
  }
}

template <int MODE>
int launch(const Level& L, const Plan& P, void* stream) {
  if (!plan_ok<MODE>(P, L.n0, L.n1, L.n_sweeps)) {
    return (int)cudaErrorInvalidValue;
  }
  if (P.smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const auto aligned = [](const void* x, uintptr_t a) {
    return ((uintptr_t)x & (a - 1)) == 0;
  };
  const int vec = (L.n1 % 4 == 0) && aligned(L.p, 16) && aligned(L.b, 16) &&
                  aligned(L.diag, 16) && aligned(L.p_out, 16) &&
                  aligned(L.code, 4) &&
                  (MODE == kPost ? aligned(L.e, 16) : aligned(L.r_out, 16));
  const dim3 grid((unsigned)P.grid_cols, (unsigned)P.grid_rows);
  level_kernel<MODE><<<grid, kThreads, P.smem_bytes, (cudaStream_t)stream>>>(
      L, P, vec);
  return (int)cudaGetLastError();
}

Level make_level(const float* p, const float* b, const float* diag,
                 const uint8_t* code, int n0, int n1, int n_sweeps,
                 float omega, float one_minus_omega, int blend, float w0,
                 float w1) {
  Level L = {};
  L.p = p;
  L.b = b;
  L.diag = diag;
  L.code = code;
  L.n0 = n0;
  L.n1 = n1;
  L.n_sweeps = n_sweeps;
  L.omega = omega;
  L.one_minus_omega = one_minus_omega;
  L.blend = blend;
  L.w0 = w0;
  L.w1 = w1;
  return L;
}

}  // namespace

extern "C" {

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a plan
// that does not fit the level. n_sweeps is 1..8 (the wrapper checks).
// nss_mg_pre and nss_mg_post take the level's plan as its seven ints:
// tile rows and columns, halo rows and columns, grid rows and columns,
// shared memory bytes; nss_mg_post writes grid rows x columns partials.

int nss_rb_sweeps(const float* p, const float* b, const float* diag,
                  const uint8_t* code, float* p_out, int n0, int n1,
                  int n_sweeps, float omega, float one_minus_omega,
                  int blend, float w0, float w1, void* stream) {
  Level L = make_level(p, b, diag, code, n0, n1, n_sweeps, omega,
                       one_minus_omega, blend, w0, w1);
  L.p_out = p_out;
  const size_t bytes = rb_smem_bytes(n_sweeps);
  if (bytes > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rb_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const auto aligned = [](const void* x, uintptr_t a) {
    return ((uintptr_t)x & (a - 1)) == 0;
  };
  const int vec = (n1 % 4 == 0) && aligned(p, 16) && aligned(b, 16) &&
                  aligned(diag, 16) && aligned(p_out, 16) && aligned(code, 4);
  const dim3 grid((unsigned)((n1 + kRbCols - 1) / kRbCols),
                  (unsigned)((n0 + kRbRows - 1) / kRbRows));
  rb_sweeps_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(L, vec);
  return (int)cudaGetLastError();
}

int nss_mg_pre(const float* p, const float* b, const float* diag,
               const uint8_t* code, float* p_out, float* r_out, int n0,
               int n1, int n_sweeps, float omega, float one_minus_omega,
               int blend, float w0, float w1, int tile_rows, int tile_cols,
               int halo_rows, int halo_cols, int grid_rows, int grid_cols,
               int smem_bytes, void* stream) {
  Level L = make_level(p, b, diag, code, n0, n1, n_sweeps, omega,
                       one_minus_omega, blend, w0, w1);
  L.p_out = p_out;
  L.r_out = r_out;
  const Plan P = {tile_rows, tile_cols, halo_rows, halo_cols,
                  grid_rows, grid_cols, smem_bytes};
  return launch<kPre>(L, P, stream);
}

int nss_mg_post(const float* p, const float* b, const float* diag,
                const uint8_t* code, const float* e, float* p_out,
                float* partials, int n0, int n1, int n_sweeps, float omega,
                float one_minus_omega, int blend, float w0, float w1,
                int tile_rows, int tile_cols, int halo_rows, int halo_cols,
                int grid_rows, int grid_cols, int smem_bytes, void* stream) {
  Level L = make_level(p, b, diag, code, n0, n1, n_sweeps, omega,
                       one_minus_omega, blend, w0, w1);
  L.e = e;
  L.p_out = p_out;
  L.partials = partials;
  const Plan P = {tile_rows, tile_cols, halo_rows, halo_cols,
                  grid_rows, grid_cols, smem_bytes};
  return launch<kPost>(L, P, stream);
}

}  // extern "C"
