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
// code: 13 B a cell), runs all 2n colour passes there, and writes the
// tile. A pass updates each interior cell of the staged region from its
// neighbors; the region's edge cells are never updated, so a wrong value
// moves in one cell per pass and stays out of the tile as long as the
// halo is as wide as the passes (and the residual's one more neighbor).
//
// mg_pre and mg_post (level_kernel) keep their first design: a 32 x 64
// tile, a halo of 2n + 1 on every side, each thread's staging loads
// waiting before its next ones, every pass over the whole region.
//
// rb_sweeps (rb_sweeps_kernel) is laid out for Hopper: the staging is
// asynchronous, every copy of the block in flight at once (cp.async, 16
// bytes a copy of p, b and diag and 4 of the code where the rows are
// 16-byte aligned, else 4-byte copies and byte loads of the code; the
// copies beyond the domain zero-fill); the halo is 2n rows and 2n columns
// rounded up to 4 (no residual follows); pass s updates only the cells
// within 2n - 1 - s of the tile, which are all the last pass needs; a
// warp takes one row of a pass and its lanes the row's cells of the
// colour, no division of an index; the tile leaves in 16-byte stores.
// Its tile is 32 x 56 so that a row of a pass at n = 2 fits one warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::kThreads;

constexpr int kTileRows = 32;  // mg_pre, mg_post: output rows per block
constexpr int kTileCols = 64;  // and columns (axes 0, 1)
constexpr int kDefaultSmem = 48 * 1024;

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

__host__ __device__ inline int halo_of(int n_sweeps) {
  return 2 * n_sweeps + 1;
}

__host__ __device__ inline int region_cells(int n_sweeps) {
  const int h = halo_of(n_sweeps);
  return (kTileRows + 2 * h) * (kTileCols + 2 * h);
}

inline size_t smem_bytes(int n_sweeps) {
  // p, b, diag as float32 and the code as one byte per staged cell
  return (size_t)region_cells(n_sweeps) * (3 * sizeof(float) + 1);
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

template <int MODE>
__global__ void __launch_bounds__(kThreads) level_kernel(Level L) {
  extern __shared__ float smem[];
  const int h = halo_of(L.n_sweeps);
  const int r0 = kTileRows + 2 * h;  // staged rows
  const int r1 = kTileCols + 2 * h;  // staged columns
  const int cells = r0 * r1;
  float* sp = smem;
  float* sb = sp + cells;
  float* sd = sb + cells;
  uint8_t* sc = reinterpret_cast<uint8_t*>(sd + cells);
  // global index of staged cell (0, 0); may be negative at the low edges
  const int i0 = (int)blockIdx.y * kTileRows - h;
  const int j0 = (int)blockIdx.x * kTileCols - h;

  // stage: cells outside the domain hold p = b = 0, diag 1 and no coupling
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int li = k / r1;
    const int lj = k - li * r1;
    const int gi = i0 + li;
    const int gj = j0 + lj;
    float pv = 0.f, bv = 0.f, dv = 1.f;
    uint8_t cv = 0;
    if (gi >= 0 && gi < L.n0 && gj >= 0 && gj < L.n1) {
      const long long g = (long long)gi * L.n1 + gj;
      pv = L.p[g];
      bv = L.b[g];
      dv = L.diag[g];
      cv = L.code[g];
      if (MODE == kPost) pv = (pv + L.e[g]) * ((cv & 64) ? 1.f : 0.f);
    }
    sp[k] = pv;
    sb[k] = bv;
    sd[k] = dv;
    sc[k] = cv;
  }
  __syncthreads();

  // 2 n colour passes; thread k takes the k-th cell of the pass's colour
  const int half = (r1 + 1) >> 1;
  for (int s = 0; s < L.n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {  // red ((i + j) even) first
      for (int k = threadIdx.x; k < r0 * half; k += blockDim.x) {
        const int li = k / half;
        const int gi = i0 + li;
        // (gi + j0 + lj) % 2 == color  <=>  lj % 2 == (color + gi + j0) % 2
        const int lj = 2 * (k - li * half) + ((color + gi + j0) & 1);
        if (li == 0 || li == r0 - 1 || lj == 0 || lj >= r1 - 1) continue;
        const int gj = j0 + lj;
        if (gi < 0 || gi >= L.n0 || gj < 0 || gj >= L.n1) continue;
        const int c = li * r1 + lj;
        const unsigned cc = sc[c];
        const float inv_d = 1.f / sd[c];
        const float cl0 = ((cc & 1u) ? L.w0 : 0.f) * inv_d;
        const float ch0 = ((cc & 2u) ? L.w0 : 0.f) * inv_d;
        const float cl1 = ((cc & 4u) ? L.w1 : 0.f) * inv_d;
        const float ch1 = ((cc & 8u) ? L.w1 : 0.f) * inv_d;
        float gs = sb[c] * inv_d - (((cl0 * sp[c - r1] + ch0 * sp[c + r1]) +
                                     cl1 * sp[c - 1]) +
                                    ch1 * sp[c + 1]);
        if (L.blend) gs = L.one_minus_omega * sp[c] + L.omega * gs;
        sp[c] = gs;
      }
      __syncthreads();
    }
  }

  // write the tile (and its residual)
  float acc = 0.f;
  for (int k = threadIdx.x; k < kTileRows * kTileCols; k += blockDim.x) {
    const int ti = k / kTileCols;
    const int tj = k - ti * kTileCols;
    const int gi = (int)blockIdx.y * kTileRows + ti;
    const int gj = (int)blockIdx.x * kTileCols + tj;
    if (gi >= L.n0 || gj >= L.n1) continue;
    const long long g = (long long)gi * L.n1 + gj;
    const int c = (ti + h) * r1 + (tj + h);
    const float pc = sp[c];
    L.p_out[g] = pc;
    const unsigned cc = sc[c];
    const float l0 = (cc & 1u) ? L.w0 : 0.f;
    const float h0 = (cc & 2u) ? L.w0 : 0.f;
    const float l1 = (cc & 4u) ? L.w1 : 0.f;
    const float h1 = (cc & 8u) ? L.w1 : 0.f;
    const float fluid = (cc & 64u) ? 1.f : 0.f;
    const float ap = (((sd[c] * pc + l0 * sp[c - r1]) + h0 * sp[c + r1]) +
                      l1 * sp[c - 1]) +
                     h1 * sp[c + 1];
    const float r = (sb[c] - ap) * fluid;
    if (MODE == kPre) {
      L.r_out[g] = r;
    } else {
      acc += r * r;
    }
  }
  if (MODE == kPost) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) {
      L.partials[blockIdx.y * gridDim.x + blockIdx.x] = acc;
    }
  }
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

template <int MODE>
int launch(const Level& L, void* stream) {
  const size_t bytes = smem_bytes(L.n_sweeps);
  if (bytes > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((L.n1 + kTileCols - 1) / kTileCols),
                  (unsigned)((L.n0 + kTileRows - 1) / kTileRows));
  level_kernel<MODE><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(L);
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

// The number of blocks (and of nss_mg_post's partial sums) for (n0, n1).
int nss_mg_blocks(int n0, int n1) {
  return ((n0 + kTileRows - 1) / kTileRows) *
         ((n1 + kTileCols - 1) / kTileCols);
}

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched). n_sweeps is 1..8 (the wrapper checks).

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
               int blend, float w0, float w1, void* stream) {
  Level L = make_level(p, b, diag, code, n0, n1, n_sweeps, omega,
                       one_minus_omega, blend, w0, w1);
  L.p_out = p_out;
  L.r_out = r_out;
  return launch<kPre>(L, stream);
}

int nss_mg_post(const float* p, const float* b, const float* diag,
                const uint8_t* code, const float* e, float* p_out,
                float* partials, int n0, int n1, int n_sweeps, float omega,
                float one_minus_omega, int blend, float w0, float w1,
                void* stream) {
  Level L = make_level(p, b, diag, code, n0, n1, n_sweeps, omega,
                       one_minus_omega, blend, w0, w1);
  L.e = e;
  L.p_out = p_out;
  L.partials = partials;
  return launch<kPost>(L, stream);
}

}  // extern "C"
