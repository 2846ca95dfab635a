// What the port's kernel sources share: the block size, the launch grid,
// the 3D MAC-layout indexing and the NaN-propagating max reduction of the
// corrector diagnostics.

#pragma once

#include <cuda_runtime.h>

namespace nss {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

struct Grid3 {
  int n[3];
};

// Linear index of face/cell (x0, x1, x2) in the C-contiguous array of
// component `a` of the exact MAC layout (a = 3: a cell-centred field).
__device__ __forceinline__ long long lin(const Grid3& g, int a, int x0, int x1,
                                         int x2) {
  const long long d1 = g.n[1] + (a == 1);
  const long long d2 = g.n[2] + (a == 2);
  return ((long long)x0 * d1 + x1) * d2 + x2;
}

// Cell (x0, x1, x2) of the flat cell index `idx`.
__device__ __forceinline__ void unflatten(const Grid3& g, long long idx,
                                          int x[3]) {
  x[2] = (int)(idx % g.n[2]);
  const long long t = idx / g.n[2];
  x[1] = (int)(t % g.n[1]);
  x[0] = (int)(t / g.n[1]);
}

// Max over the block of non-negative floats (and NaNs), carried as their
// int bit patterns. For x >= 0 the bit pattern orders as the value does, and
// every NaN with its sign bit cleared (the callers take fabsf last) has a
// pattern above +inf's 0x7f800000, so a NaN anywhere wins the max and shows
// up in the diagnostic, as jnp.max and torch.max propagate it. fmaxf would
// drop it. The cross-block step is an atomicMax on the same patterns into a
// buffer the wrapper zeroes (0 is the pattern of +0.0f).
__device__ __forceinline__ void block_max_to(int v, int* out) {
  __shared__ int warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? warp_max[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = max(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) atomicMax(out, v);
  }
  __syncthreads();
}

__device__ __forceinline__ int abs_bits(float x) {
  return __float_as_int(fabsf(x));
}

}  // namespace nss
