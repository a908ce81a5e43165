// Ring all-to-all over the virtual mesh: the block transpose of the
// per-shard send buffers.
//
// Replaces sparkrdma_tpu/ops/ring_exchange.py::_ring_kernel (called by
// ring_all_to_all_shard, the pl.pallas_call at ring_exchange.py:127). On
// the TPU that kernel is a D-1 step shift-register ring of remote DMAs
// into a neighbour's double-buffered VMEM, with send/recv DMA semaphores
// and a per-direction step barrier. On one card the D shards are regions
// of the same device memory and there is no link to ring over, so this
// kernel computes the function, not the TPU schedule: one launch copies
// every (source i -> destination j) block to out[j, i].
//
// What bounds it: bytes. It reads and writes D*D*C*W*4 bytes each, with
// no arithmetic, so its least time is 2*D*D*C*W*4 bytes over the card's
// memory rate (H100 SXM: 3.35 TB/s). The design serves that bound:
// every thread moves 16-byte vectors with streaming (evict-first) loads
// and stores, four in flight per thread, falling back to scalar words
// only where a block's source or destination is not 16-byte aligned
// (the block size C*W*4 need not be a multiple of 16) and at a block's
// tail. The grid is (chunk, pair): pairs along y, a bounded number of
// chunks along x, and each thread walks its pair's block with a stride
// loop, so a block of any size stays inside the launch limits.
//
// The kernel takes a device array of D source base pointers and D
// destination base pointers (shard i sends from src[i] + j*block,
// shard j receives at dst[j] + i*block), so a multi-GPU form with peer
// pointers over NVLink needs no new signature. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTargetBlocks = 4096;  // ~3-4 waves of 8 blocks per SM

__global__ void __launch_bounds__(kThreads)
ring_all_to_all_kernel(const long long* __restrict__ ptrs, int num_shards,
                       long long block_words) {
  const int pair = blockIdx.y;
  const int dst_shard = pair / num_shards;
  const int src_shard = pair % num_shards;
  const int32_t* __restrict__ src =
      reinterpret_cast<const int32_t*>(ptrs[src_shard]) +
      static_cast<long long>(dst_shard) * block_words;
  int32_t* __restrict__ dst =
      reinterpret_cast<int32_t*>(ptrs[num_shards + dst_shard]) +
      static_cast<long long>(src_shard) * block_words;

  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long vec_words = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const long long nvec = block_words / 4;
    const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
    int4* __restrict__ d4 = reinterpret_cast<int4*>(dst);
    long long v = tid;
    for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
      int4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = __ldcs(s4 + v + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) __stcs(d4 + v + u * stride, r[u]);
    }
    for (; v < nvec; v += stride) __stcs(d4 + v, __ldcs(s4 + v));
    vec_words = nvec * 4;
  }
  for (long long w = vec_words + tid; w < block_words; w += stride) {
    dst[w] = src[w];
  }
}

}  // namespace

// ptrs: device int64[2 * num_shards], source bases then destination bases.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ring_all_to_all_launch(const void* ptrs, int num_shards,
                                      long long block_words, void* stream) {
  const long long pairs = static_cast<long long>(num_shards) * num_shards;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll * 4;
  long long chunks = (block_words + per_block - 1) / per_block;
  const long long cap = kTargetBlocks / pairs > 0 ? kTargetBlocks / pairs : 1;
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(pairs));
  ring_all_to_all_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ptrs), num_shards, block_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ring_all_to_all_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
