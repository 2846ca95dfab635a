// Fused trailing-axes spectral transform for Hopper (sm_90a), plain C
// interface (navierstokessolver_tpu_torch/ops/trailing_dct.py binds it with
// ctypes).
//
//   nss_fused_trailing  replaces navierstokessolver_tpu/ops/pallas_dct.py
//                       _kernel (its wrapper fused_trailing): over the axis-0
//                       slabs of x (n0, n1, n2),
//                           out[i] = (m1 @ x[i] @ m2^T) * eig[i]
//                       with m1 (k1, n1), m2 (k2, n2), out and the optional
//                       eig (n0, k1, k2), all C-contiguous float32.
//
// The 3D direct Poisson solve's fused route runs it twice per solve: the two
// trailing-axis transforms and the spectral multiply in one pass over the
// field instead of three.
//
// What bounds it on this card: floating-point operations. Per slab it does
// two products of 2 k1 n1 n2 + 2 k1 n2 k2 operations; at 256^3 that is
// 17.2 GFLOP per call against 0.2 GB of traffic (with eig), so the H100's
// 67 TFLOP/s of float32 FMA (no TF32, as the port's transform GEMMs run) sets
// the bound, 0.256 ms. The TPU kernel's 3-pass bf16 split product, which
// emulates float32 on the MXU, does not carry over: this kernel runs plain
// float32 FMAs.
//
// Design: one CTA of 256 threads takes one slab i and a block of 64 output
// rows (rows of m1). Stage 1 computes Y = m1[rows, :] @ x[i] (64 x n2) into
// shared memory, tiled over n1 in steps of 16 with both operands staged in
// shared memory; x[i] (256 KB at 256^2) is read by the k1/64 CTAs of the slab
// through L2. Stage 2 computes Y @ m2^T in passes of 256 output columns, m2
// staged transposed, and applies the eig epilogue as it stores, so every
// output value is written once. Each thread keeps an 8 x 8 register tile: its
// 8 rows are a warp's (A operands are shared-memory broadcasts), its 8
// columns two groups of 4 at lane*4 and 128 + lane*4 (conflict-free 16-byte
// shared loads). Y takes 64 round_up(n2, 16) floats of shared memory, which
// caps n2 (ops/trailing_dct.applicable). No tensor cores, no TMA and no
// double buffering: those are later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = nss::kThreads;  // 256: 8 warps
constexpr int kRows = 64;                // output rows (of m1) per CTA
constexpr int kCols = 256;               // output columns per pass
constexpr int kDepth = 16;               // reduction depth per stage
constexpr int kLdb = kCols + 4;          // padded row of the B tile

static_assert(kThreads == 256, "the 8 x 8 thread tiles assume 8 warps");

struct Params {
  const float* x;
  const float* m1;
  const float* m2;
  const float* eig;  // nullptr: no multiply
  float* out;
  int n0, n1, n2, k1, k2;
  int yw;  // row stride of Y: n2 rounded up to kDepth
};

__device__ __forceinline__ int tile_col(int lane, int j) {
  return (j < 4) ? lane * 4 + j : 128 + lane * 4 + (j - 4);
}

// acc[m][j] += sum_{k < kDepth} A[(warp*8 + m)*lda + k] * B[k*kLdb + col_j]
__device__ __forceinline__ void tile_fma(const float* A, int lda,
                                         const float* B, float acc[8][8],
                                         int warp, int lane) {
#pragma unroll 4
  for (int k = 0; k < kDepth; ++k) {
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * kLdb + lane * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(B + k * kLdb + 128 + lane * 4);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float a = A[(warp * 8 + m) * lda + k];
      acc[m][0] = fmaf(a, b0.x, acc[m][0]);
      acc[m][1] = fmaf(a, b0.y, acc[m][1]);
      acc[m][2] = fmaf(a, b0.z, acc[m][2]);
      acc[m][3] = fmaf(a, b0.w, acc[m][3]);
      acc[m][4] = fmaf(a, b1.x, acc[m][4]);
      acc[m][5] = fmaf(a, b1.y, acc[m][5]);
      acc[m][6] = fmaf(a, b1.z, acc[m][6]);
      acc[m][7] = fmaf(a, b1.w, acc[m][7]);
    }
  }
}

__device__ __forceinline__ void zero(float acc[8][8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
trailing_dct_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* Y = reinterpret_cast<float*>(smem4);  // kRows x yw
  float* As = Y + kRows * P.yw;                 // kRows x kDepth
  float* Bs = As + kRows * kDepth;              // kDepth x kLdb

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int row0 = blockIdx.x * kRows;
  const long long slab = blockIdx.y;
  const float* xs = P.x + slab * P.n1 * P.n2;
  float acc[8][8];

  // stage 1: Y = m1[row0 : row0 + 64, :] @ x[slab]; rows of m1 past k1 and
  // columns past n2 are zero
  for (int c0 = 0; c0 < P.yw; c0 += kCols) {
    zero(acc);
    for (int j0 = 0; j0 < P.n1; j0 += kDepth) {
#pragma unroll
      for (int q = 0; q < kRows * kDepth / kThreads; ++q) {
        const int idx = t + q * kThreads;
        const int r = idx / kDepth, k = idx % kDepth;
        const int gr = row0 + r, gk = j0 + k;
        As[r * kDepth + k] =
            (gr < P.k1 && gk < P.n1) ? P.m1[(long long)gr * P.n1 + gk] : 0.f;
      }
      const int gc = c0 + t;
#pragma unroll 4
      for (int k = 0; k < kDepth; ++k) {
        const int gk = j0 + k;
        Bs[k * kLdb + t] =
            (gk < P.n1 && gc < P.n2) ? xs[(long long)gk * P.n2 + gc] : 0.f;
      }
      __syncthreads();
      tile_fma(As, kDepth, Bs, acc, warp, lane);
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tile_col(lane, j);
        if (c < P.yw) Y[(warp * 8 + m) * P.yw + c] = acc[m][j];
      }
    }
  }
  __syncthreads();

  // stage 2: out[slab, rows, :] = (Y @ m2^T) * eig, in passes of kCols
  for (int k0 = 0; k0 < P.k2; k0 += kCols) {
    zero(acc);
    for (int c0 = 0; c0 < P.yw; c0 += kDepth) {
#pragma unroll 4
      for (int q = 0; q < kCols * kDepth / kThreads; ++q) {
        const int idx = t + q * kThreads;
        const int c = idx % kDepth, k = idx / kDepth;
        const int gk = k0 + k, gc = c0 + c;
        Bs[c * kLdb + k] =
            (gk < P.k2 && gc < P.n2) ? P.m2[(long long)gk * P.n2 + gc] : 0.f;
      }
      __syncthreads();
      tile_fma(Y + c0, P.yw, Bs, acc, warp, lane);
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int r = row0 + warp * 8 + m;
      if (r >= P.k1) continue;
      const long long base = (slab * P.k1 + r) * P.k2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + tile_col(lane, j);
        if (k < P.k2) {
          float v = acc[m][j];
          if (P.eig != nullptr) v *= P.eig[base + k];
          P.out[base + k] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream`; returns cudaGetLastError() (0 =
// launched), or the error of raising the kernel's shared-memory limit.
int nss_fused_trailing(const float* x, const float* m1, const float* m2,
                       const float* eig, float* out, int n0, int n1, int n2,
                       int k1, int k2, void* stream) {
  Params P;
  P.x = x;
  P.m1 = m1;
  P.m2 = m2;
  P.eig = eig;
  P.out = out;
  P.n0 = n0;
  P.n1 = n1;
  P.n2 = n2;
  P.k1 = k1;
  P.k2 = k2;
  P.yw = (n2 + kDepth - 1) / kDepth * kDepth;
  // Y, the A tile and the B tile (ops/trailing_dct.smem_bytes)
  const long long smem =
      (long long)sizeof(float) * (kRows * P.yw + kRows * kDepth + kDepth * kLdb);
  cudaError_t err = cudaFuncSetAttribute(
      trailing_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((k1 + kRows - 1) / kRows), (unsigned int)n0);
  trailing_dct_kernel<<<grid, kThreads, (size_t)smem,
                        (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
