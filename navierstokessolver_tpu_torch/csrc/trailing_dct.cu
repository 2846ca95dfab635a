// Fused trailing-axes spectral transform for Hopper (sm_90a), plain C
// interface (navierstokessolver_tpu_torch/ops/trailing_dct.py binds it with
// ctypes).
//
//   nss_fused_trailing  replaces navierstokessolver_tpu/ops/pallas_dct.py
//                       _kernel (its wrapper fused_trailing): over the axis-0
//                       slabs of x (n0, n1, n2),
//                           out[i] = (m1 @ x[i] @ m2^T) * eig[i]
//                       with m1 (k1, n1), m2 (k2, n2), out and the optional
//                       eig (n0, k1, k2), float32, at the TPU kernel's own
//                       arithmetic (pallas_dct._dot): every product of both
//                       stages is the bf16 split product of its float32
//                       operands, hi = bf16_rn(a), lo = bf16_rn(a - hi), with
//                       float32 accumulation; P = 3 passes (Precision.HIGH,
//                       the solver's default) sum hi.hi + hi.lo + lo.hi into
//                       one accumulator, P = 1 (DEFAULT) takes hi.hi.
//
// The 3D direct Poisson solve's fused route runs it twice per solve: the two
// trailing-axis transforms and the spectral multiply in one pass over the
// field instead of three.
//
// What bounds it on this card: bytes, closely followed by tensor-core
// operations. At 256^3 one call does P x 17.2 GFLOP of bf16 products (P = 3:
// 0.052 ms at 989 TFLOP/s) and moves 202 MB (x, eig, out: 0.060 ms at 3.35
// TB/s). In float32 FMAs the same call would take 0.256 ms; so the design
// puts every product on bf16 wgmma and keeps the loads of x ahead of them:
//
// * One CTA of two warpgroups takes one slab i and 64 rows of m1. Stage 1,
//   Y = m1[rows] @ x[i] (64 x n2, n2 <= 256): warpgroup w owns Y's columns
//   [128 w, 128 w + 128) as one m64n128 float32 accumulator (64 registers a
//   thread, shared by all P passes). K (n1) runs in pieces of 16: cp.async
//   brings the float32 piece of x (16 x 256) into a two-stage ring, a piece
//   ahead; all 256 threads split it into bf16 hi/lo and store it, transposed
//   to K-major, into the 128-byte-swizzled B tile the wgmma descriptors read
//   (4 slots of 16 K), while the previous piece's wgmmas run (at most one
//   group in flight). m1 is a solver constant, split once into padded bf16
//   hi/lo (ops/trailing_dct.split_matrix); its 64 x 16 slices arrive by
//   cp.async into the swizzled A tile beside each x piece.
// * Y is split by the threads that hold it, into bf16 hi/lo in shared memory
//   (64 KB, where the stage-1 B tile was), K-major and swizzled: stage 2's A.
// * Stage 2, out = Y @ m2^T in passes of 128 output columns (m64n64 a
//   warpgroup): m2's split slices stream by cp.async through a 4-slot ring
//   (the x staging space), two slices ahead and on across passes. Each
//   thread loads its multipliers of a pass into registers before the pass's
//   K loop, so the eig multiply in the epilogue waits on nothing, and each
//   output is written once, two columns a store.
//
// Shared memory, 113 KB, and at most 128 registers a thread let two CTAs
// share an SM: one loads while the other multiplies (a deeper x ring at one
// CTA an SM measured slower). Zero fill (cp.async's source size, the padded
// constants) puts
// zeros in hi and lo alike outside the operands, so ragged n1, n2, k1, k2 add
// nothing. The gate (ops/trailing_dct.applicable) admits n2 <= 256; n1, k1
// and k2 are free. The TPU kernel's 8-slab tiles are not copied: a slab's
// 64-row blocks are separate CTAs, which read x[i] through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = nss::kThreads;  // 256: two warpgroups
constexpr int kRows = 64;                // rows of m1 (of out) per CTA
constexpr int kPassN = 256;              // stage-1 N: the gate's largest n2
constexpr int kPassN2 = 128;             // stage-2 output columns per pass
constexpr int kPiece = 16;               // K per wgmma and per cp.async piece
constexpr int kPackRows = 128;           // m1, m2 rows padded to this
constexpr int kPackCols = 64;            // their columns padded to this

// shared-memory map, bytes from a 1024-aligned base
constexpr int kOffB = 0;       // stage-1 B tile: 256 rows x 128 B, hi | lo;
                               // then Y: 4 atoms of 64 rows x 128 B, hi | lo
constexpr int kHalfB = 32768;  // hi to lo in the B / Y region
constexpr int kOffX = 65536;   // x staging: 2 x (16 x 256 float32);
                               // stage 2: m2 slices, 128 rows x 128 B, hi | lo
constexpr int kStageX = 16384;
constexpr int kHalfX = 16384;
constexpr int kOffA = 98304;   // m1 slices: 64 rows x 128 B, hi | lo
constexpr int kHalfA = 8192;
constexpr int kAtomY = 8192;   // one 64-column atom of Y
constexpr int kSmem = 114688 + 1024;  // + alignment slack

static_assert(kThreads == 256, "two warpgroups");

struct Params {
  const float* x;
  const __nv_bfloat16* m1p;  // (2, k1p, n1p): hi, lo, zero-padded
  const __nv_bfloat16* m2p;  // (2, k2p, n2p)
  const float* eig;          // nullptr: no multiply
  float* out;
  int n0, n1, n2, k1, k2;
  int n1p, n2p, k1p, k2p;
};

// Byte offset of bf16 element (row, col), col < 64, in a K-major tile of
// 128-byte rows under the 128-byte swizzle: 16-byte chunk col / 8 lands at
// chunk (col / 8) ^ (row % 8), as TMA's SWIZZLE_128B lays it out.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 3) ^ (row & 7)) << 4) |
                                 ((col & 7) << 1)));
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand at
// shared address `addr`: 8-row groups 1024 bytes apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy shared stores (and completed cp.async) visible to wgmma
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += A (64 x 16, desc a) B (16 x 128, desc b): 64 floats a thread
__device__ __forceinline__ void wgmma_128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// acc += A_hi B_hi + A_hi B_lo + A_lo B_hi (64 x 16 by 16 x 128), the three
// products in one asm statement so that nothing touches the accumulator
// between them
__device__ __forceinline__ void wgmma_128x3(float* d, uint64_t a_hi,
                                             uint64_t a_lo, uint64_t b_hi,
                                             uint64_t b_lo) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %66, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %67, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%65, %66, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_hi), "l"(a_lo), "l"(b_hi), "l"(b_lo), "r"(1));
}

// acc += A (64 x 16, desc a) B (16 x 64, desc b): 32 floats a thread
__device__ __forceinline__ void wgmma_64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// acc += A_hi B_hi + A_hi B_lo + A_lo B_hi (64 x 16 by 16 x 64), the three
// products in one asm statement so that nothing touches the accumulator
// between them
__device__ __forceinline__ void wgmma_64x3(float* d, uint64_t a_hi,
                                             uint64_t a_lo, uint64_t b_hi,
                                             uint64_t b_lo) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %34, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %35, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%33, %34, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_hi), "l"(a_lo), "l"(b_hi), "l"(b_lo), "r"(1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// hi = bf16_rn(v), lo = bf16_rn(v - hi): JAX's _split_bf16
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Stage-1 cp.async of piece p: x[slab] rows [16p, 16p + 16) x columns
// [0, 256) into staging stage p % 2 (zero past n1 and n2), and m1's split
// rows [row0, row0 + 64) x columns [16p, 16p + 16) into A slot p % 4.
template <int P>
__device__ __forceinline__ void load_piece(const Params& Q, const float* xs,
                                           int row0, int p, uint32_t sbase,
                                           bool vec4) {
  const int t = threadIdx.x;
  const uint32_t xst = sbase + kOffX + (uint32_t)((p & 1) * kStageX);
  const int j0 = p * kPiece;
  if (vec4) {
#pragma unroll
    for (int q = 0; q < kPiece * kPassN / 4 / kThreads; ++q) {
      const int v = t + q * kThreads;
      const int r = v / (kPassN / 4), c = (v % (kPassN / 4)) * 4;
      const int j = j0 + r;
      int bytes = (j < Q.n1) ? (Q.n2 - c) * 4 : 0;
      bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
      const float* src = bytes > 0 ? xs + (long long)j * Q.n2 + c : Q.x;
      cp_async16(xst + (uint32_t)((r * kPassN + c) * 4), src, bytes);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kPiece * kPassN / kThreads; ++q) {
      const int v = t + q * kThreads;
      const int r = v / kPassN, c = v % kPassN;
      const int j = j0 + r;
      const bool in = j < Q.n1 && c < Q.n2;
      cp_async4(xst + (uint32_t)(v * 4),
                in ? xs + (long long)j * Q.n2 + c : Q.x, in ? 4 : 0);
    }
  }
  // one 16-byte chunk a thread: (hi | lo, row, half of the 16 columns)
  const int hl = t >> 7, r = (t >> 1) & 63, h = t & 1;
  if (P == 3 || hl == 0) {
    const __nv_bfloat16* src = Q.m1p + (long long)hl * Q.k1p * Q.n1p +
                               (long long)(row0 + r) * Q.n1p + j0 + 8 * h;
    cp_async16(sbase + kOffA + hl * kHalfA + swz(r, (p & 3) * kPiece + 8 * h),
               src, 16);
  }
}

// Stage-2 cp.async of the g-th slice of the launch, slice s of pass q: m2's
// split rows [128 q, 128 q + 128) x columns [16 s, 16 s + 16) into slot g % 4
// of the m2 ring.
template <int P>
__device__ __forceinline__ void load_m2(const Params& Q, int g, int np2,
                                        uint32_t sbase) {
  const int q = g / np2, s = g % np2;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = t + i * kThreads;
    const int hl = v >> 8, r = (v >> 1) & 127, h = v & 1;
    if (P == 3 || hl == 0) {
      const __nv_bfloat16* src = Q.m2p + (long long)hl * Q.k2p * Q.n2p +
                                 (long long)(q * kPassN2 + r) * Q.n2p +
                                 s * kPiece + 8 * h;
      cp_async16(sbase + kOffX + hl * kHalfX + swz(r, (g & 3) * kPiece + 8 * h),
                 src, 16);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
trailing_dct_kernel(const Params Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (sbase - raw);

  const int t = threadIdx.x;
  const int wg = t >> 7;             // warpgroup
  const int wl = (t >> 5) & 3;       // warp in the warpgroup
  const int lane = t & 31;
  const int row0 = blockIdx.x * kRows;
  const long long slab = blockIdx.y;
  const float* xs = Q.x + slab * Q.n1 * Q.n2;
  const bool vec4 = (Q.n2 & 3) == 0;

  // -- stage 1: Y = m1[row0 : row0 + 64] @ x[slab] -------------------------
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int np1 = (Q.n1 + kPiece - 1) / kPiece;
  load_piece<P>(Q, xs, row0, 0, sbase, vec4);
  cp_commit();
  for (int p = 0; p < np1; ++p) {
    if (p + 1 < np1) load_piece<P>(Q, xs, row0, p + 1, sbase, vec4);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // split column t of the float32 piece into K-major B rows: row t, K
    // slot p % 4 (two 16-byte chunks of hi, two of lo)
    {
      const float* xst =
          reinterpret_cast<const float*>(smem + kOffX + (p & 1) * kStageX);
      uint32_t hw[8], lw[8];
#pragma unroll
      for (int k = 0; k < kPiece; k += 2) {
        __nv_bfloat16 h0, l0, h1, l1;
        split(xst[k * kPassN + t], h0, l0);
        split(xst[(k + 1) * kPassN + t], h1, l1);
        hw[k / 2] = pack2(h0, h1);
        lw[k / 2] = pack2(l0, l1);
      }
      const int col = (p & 3) * kPiece;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        *reinterpret_cast<uint4*>(smem + kOffB + swz(t, col + 8 * c)) =
            make_uint4(hw[4 * c], hw[4 * c + 1], hw[4 * c + 2], hw[4 * c + 3]);
        if (P == 3) {
          *reinterpret_cast<uint4*>(smem + kOffB + kHalfB +
                                    swz(t, col + 8 * c)) =
              make_uint4(lw[4 * c], lw[4 * c + 1], lw[4 * c + 2],
                         lw[4 * c + 3]);
        }
      }
    }
    fence_async();
    __syncthreads();
    const uint32_t slot = (uint32_t)((p & 3) * kPiece * 2);  // bytes
    const uint32_t a_hi = sbase + kOffA + slot;
    const uint32_t b_hi = sbase + kOffB + (uint32_t)(wg * 128 * 128) + slot;
    fence_acc<64>(acc);
    wg_fence();
    if (P == 3) {
      wgmma_128x3(acc, desc(a_hi), desc(a_hi + kHalfA), desc(b_hi),
                  desc(b_hi + kHalfB));
    } else {
      wgmma_128(acc, desc(a_hi), desc(b_hi));
    }
    wg_commit();
    wg_wait<1>();
    fence_acc<64>(acc);
  }
  wg_wait<0>();
  fence_acc<64>(acc);
  __syncthreads();  // every wgmma has read its B tile: Y may overwrite it

  // Y's fragment (m64n128 layout) split into bf16 hi/lo, K-major atoms
  {
    const int r = wl * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = wg * 128 + j * 8 + (lane & 3) * 2;
      const uint32_t at = (uint32_t)((c >> 6) * kAtomY);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half;
        __nv_bfloat16 h0, l0, h1, l1;
        split(acc[4 * j + 2 * half], h0, l0);
        split(acc[4 * j + 2 * half + 1], h1, l1);
        const uint32_t off = kOffB + at + swz(rr, c & 63);
        *reinterpret_cast<uint32_t*>(smem + off) = pack2(h0, h1);
        if (P == 3) {
          *reinterpret_cast<uint32_t*>(smem + off + kHalfB) = pack2(l0, l1);
        }
      }
    }
  }
  fence_async();
  __syncthreads();

  // -- stage 2: out[slab, rows, :] = (Y @ m2^T) * eig ----------------------
  // The m2 slices g = (pass, K slice) of the launch run through one 4-slot
  // ring, two ahead of the wgmmas and on across passes, so the next pass's
  // first slices load during an epilogue. A slice is issued after the
  // barrier that follows every warpgroup's wait for the wgmmas of slice
  // g - 2, whose slot it takes.
  const int np2 = (Q.n2 + kPiece - 1) / kPiece;
  const int total2 = np2 * ((Q.k2 + kPassN2 - 1) / kPassN2);
  const bool vec2 = (Q.k2 & 1) == 0;
  for (int g = 0; g < 2; ++g) {
    if (g < total2) load_m2<P>(Q, g, np2, sbase);
    cp_commit();
  }
  for (int g0 = 0; g0 < total2; g0 += np2) {
    const int q = g0 / np2;
    // this thread's multipliers of the pass, loaded now, used after the
    // K loop: (j, half) pairs of columns k, k + 1 of row rr
    const int r = row0 + wl * 16 + (lane >> 2);
    const int kc = q * kPassN2 + wg * 64 + (lane & 3) * 2;
    float2 ev[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half, k = kc + j * 8;
        const long long at = (slab * Q.k1 + rr) * Q.k2 + k;
        float2 e = make_float2(1.f, 1.f);
        if (Q.eig != nullptr && rr < Q.k1) {
          if (vec2 && k < Q.k2) {
            e = __ldg(reinterpret_cast<const float2*>(Q.eig + at));
          } else {
            if (k < Q.k2) e.x = __ldg(Q.eig + at);
            if (k + 1 < Q.k2) e.y = __ldg(Q.eig + at + 1);
          }
        }
        ev[2 * j + half] = e;
      }
    }
    float acc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
    for (int s = 0; s < np2; ++s) {
      const int g = g0 + s;
      cp_wait<1>();
      fence_async();
      __syncthreads();
      if (g + 2 < total2) load_m2<P>(Q, g + 2, np2, sbase);
      cp_commit();
      const uint32_t a_hi = sbase + kOffB + (uint32_t)((s >> 2) * kAtomY) +
                            (uint32_t)((s & 3) * kPiece * 2);
      const uint32_t b_hi = sbase + kOffX + (uint32_t)(wg * 64 * 128) +
                            (uint32_t)((g & 3) * kPiece * 2);
      fence_acc<32>(acc2);
      wg_fence();
      if (P == 3) {
        wgmma_64x3(acc2, desc(a_hi), desc(a_hi + kHalfB), desc(b_hi),
                   desc(b_hi + kHalfX));
      } else {
        wgmma_64(acc2, desc(a_hi), desc(b_hi));
      }
      wg_commit();
      wg_wait<1>();
      fence_acc<32>(acc2);
    }
    wg_wait<0>();
    fence_acc<32>(acc2);
    // epilogue: the m64n64 fragment times eig, stored once, two columns a
    // store where k2 is even
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half, k = kc + j * 8;
        if (rr >= Q.k1 || k >= Q.k2) continue;
        float* o = Q.out + (slab * Q.k1 + rr) * Q.k2 + k;
        const float2 e = ev[2 * j + half];
        const float v0 = acc2[4 * j + 2 * half] * e.x;
        const float v1 = acc2[4 * j + 2 * half + 1] * e.y;
        if (vec2) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (k + 1 < Q.k2) o[1] = v1;
        }
      }
    }
  }
}

template <int P>
int launch(const Params& Q, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trailing_dct_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((Q.k1 + kRows - 1) / kRows),
                  (unsigned int)Q.n0);
  trailing_dct_kernel<P><<<grid, kThreads, kSmem, stream>>>(Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` at `passes` bf16 passes (1 or 3); m1p and
// m2p are the split constants, (2, k padded to 128, n padded to 64) bf16.
// Returns cudaGetLastError() (0 = launched), the error of raising the
// kernel's shared-memory limit, or cudaErrorInvalidValue for a shape outside
// the gate or a pass count other than 1 and 3.
int nss_fused_trailing(const float* x, const void* m1p, const void* m2p,
                       const float* eig, float* out, int n0, int n1, int n2,
                       int k1, int k2, int passes, void* stream) {
  if (n0 < 1 || n0 > 65535 || n1 < 1 || n2 < 1 || n2 > kPassN || k1 < 1 ||
      k2 < 1 || (passes != 1 && passes != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  Params Q;
  Q.x = x;
  Q.m1p = static_cast<const __nv_bfloat16*>(m1p);
  Q.m2p = static_cast<const __nv_bfloat16*>(m2p);
  Q.eig = eig;
  Q.out = out;
  Q.n0 = n0;
  Q.n1 = n1;
  Q.n2 = n2;
  Q.k1 = k1;
  Q.k2 = k2;
  Q.n1p = (n1 + kPackCols - 1) / kPackCols * kPackCols;
  Q.n2p = (n2 + kPackCols - 1) / kPackCols * kPackCols;
  Q.k1p = (k1 + kPackRows - 1) / kPackRows * kPackRows;
  Q.k2p = (k2 + kPackRows - 1) / kPackRows * kPackRows;
  cudaStream_t s = (cudaStream_t)stream;
  return passes == 3 ? launch<3>(Q, s) : launch<1>(Q, s);
}

}  // extern "C"
