// Row messages between the slabs of a sharded volume, for Hopper (sm_90a),
// plain C interface.
//
//   nss_exchange_rows  replaces navierstokessolver_tpu/parallel/remote_dma.py
//                      _exchange_rows_multi_kernel (any static set of row
//                      messages for any number of volumes, in one launch)
//                      and, with that kernel's fixed message set,
//                      _exchange_kernel (the slab ghost refresh of one
//                      volume). navierstokessolver_tpu_torch/parallel/
//                      remote_dma.py binds it with ctypes.
//
// On the TPU each message is a kernel-initiated DMA into the neighbouring
// chip's HBM, with send and receive semaphores, and every row no message
// targets is copied through to a fresh output. Here every shard's buffers
// sit on one card, so a message is a plain store into the neighbour's
// buffer, made in place: the wrapper checks that no message's source rows
// are any message's destination rows and that destinations do not overlap,
// which makes the stores race-free, and the rows no message targets are
// never touched (no pass-through copy). In-stream order makes the next
// kernel see the writes; no semaphore is needed.
//
// A message is `n_rows` consecutive rows of a C-contiguous volume, so it is
// one contiguous run of bytes in the source and in the destination. The
// message table lives on the card as int64 triples (source address,
// destination address, bytes), built once per set of buffers: a launch
// copies nothing from the host. Grid axis y runs over the messages, so every
// message of every volume and shard is in flight in one launch; x runs over
// each message's bytes in 16-byte vectors (4- or 1-byte words where an
// address or the length is not a multiple of 16), consecutive threads on
// consecutive vectors.
//
// What bounds it on this card: bytes. Each message is read once and written
// once; at 256^3 a row of u0 is 256 KiB, and the slab step's largest launch
// (the velocity refresh, 3 volumes x 2 messages x up to 2 rows a shard)
// moves a few MB, which at 3.35 TB/s is microseconds: the launch itself
// costs as much. Nothing else is done about it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nss::kThreads;

// at most this many blocks along a message (a grid-stride loop covers the
// rest); 64 blocks of 256 threads move one 256 KiB row in one pass
constexpr long long kMaxBlocksPerMessage = 128;

template <typename T>
__device__ __forceinline__ void copy_words(const unsigned char* src,
                                           unsigned char* dst,
                                           long long nbytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const long long n = nbytes / (long long)sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    d[i] = s[i];
  }
}

__global__ void __launch_bounds__(kThreads)
exchange_rows_kernel(const long long* __restrict__ table) {
  const long long* m = table + 3 * (long long)blockIdx.y;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(m[0]);
  unsigned char* dst = reinterpret_cast<unsigned char*>(m[1]);
  const long long nbytes = m[2];
  const uintptr_t bits = (uintptr_t)src | (uintptr_t)dst | (uintptr_t)nbytes;
  if ((bits & 15) == 0) {
    copy_words<int4>(src, dst, nbytes);
  } else if ((bits & 3) == 0) {
    copy_words<int>(src, dst, nbytes);
  } else {
    copy_words<unsigned char>(src, dst, nbytes);
  }
}

}  // namespace

extern "C" {

// Enqueues one launch moving the `n_msgs` messages of `table` (device
// memory, int64 triples: source address, destination address, bytes) on
// `stream`; `max_bytes` is the longest message. Returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a message count outside
// 1..65535 or a non-positive length.
int nss_exchange_rows(const long long* table, int n_msgs, long long max_bytes,
                      void* stream) {
  if (n_msgs < 1 || n_msgs > 65535 || max_bytes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (max_bytes / 16 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocksPerMessage) blocks = kMaxBlocksPerMessage;
  const dim3 grid((unsigned int)blocks, (unsigned int)n_msgs);
  exchange_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(table);
  return (int)cudaGetLastError();
}

}  // extern "C"
