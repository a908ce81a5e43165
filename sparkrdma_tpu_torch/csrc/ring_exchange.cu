// Ring all-to-all over the virtual mesh: the block transpose of the
// per-shard send buffers, out[j, i] = blocks[i, j].
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
// memory rate (H100 SXM: 3.35 TB/s). Two bodies serve that bound; the
// host picks one per launch from the alignment of the blocks:
//
// - TMA body (every source and destination base and the block size
//   C*W*4 are multiples of 16, which every block the caching allocator
//   hands out meets): a persistent grid of at most ctas_per_sm CTAs per
//   SM walks the (pair, tile) work items, tile = blockIdx.x, += gridDim.x.
//   In each CTA one thread runs a ring of `stages` tiles in dynamic
//   shared memory: a cp.async.bulk load per tile, completion counted in
//   bytes on the stage's mbarrier, then a cp.async.bulk store from the
//   same stage back to device memory. `stages - 1` loads stay in flight
//   behind each store, so each SM keeps tens of kilobytes moving without
//   spending registers or per-thread instructions on the copy, and no
//   block of a few kilobytes is scheduled on its own.
// - Load/store body (anything else): 256 threads a block, grid (chunk,
//   pair), 16-byte streaming loads and stores four in flight per thread
//   where the pair's block is aligned, scalar words otherwise and at a
//   block's tail.
//
// The D source and D destination bases travel by value in the kernel's
// parameter block (Bases, 2 KB), so a launch needs no device-side
// pointer array, no host-to-device copy, and can be captured in a CUDA
// graph. Shard i sends from src[i] + j*block and shard j receives at
// dst[j] + i*block, so a multi-GPU form with peer pointers over NVLink
// needs no new signature. A launch runs on the caller's stream, allocates
// nothing and does not synchronise. An mbarrier wait that outlasts
// kWaitTimeoutNs traps, so a fault in the pipeline ends the kernel with
// an error instead of hanging the card.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 128;  // Bases is 2 KB of the 4 KB parameter block

struct Bases {
  long long src[kMaxShards];
  long long dst[kMaxShards];
};

// ---- load/store body -------------------------------------------------

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTargetBlocks = 4096;  // ~3-4 waves of 8 blocks per SM

__global__ void __launch_bounds__(kThreads)
ring_ldst_kernel(const __grid_constant__ Bases bases, int num_shards,
                 long long block_words) {
  const int pair = blockIdx.y;
  const int dst_shard = pair / num_shards;
  const int src_shard = pair % num_shards;
  const int32_t* __restrict__ src =
      reinterpret_cast<const int32_t*>(bases.src[src_shard]) +
      static_cast<long long>(dst_shard) * block_words;
  int32_t* __restrict__ dst =
      reinterpret_cast<int32_t*>(bases.dst[dst_shard]) +
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

// ---- TMA body --------------------------------------------------------

constexpr int kTmaThreads = 32;  // one warp; thread 0 issues every copy
constexpr int kMaxStages = 8;
// Hopper's per-CTA cap (227 KB) less room for the static mbarriers
constexpr int kMaxSmemBytes = 232448 - 1024;
constexpr long long kMaxTileBytes = (1 << 20) - 16;  // mbarrier tx limit
constexpr unsigned long long kWaitTimeoutNs = 2000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > kWaitTimeoutNs) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t smem, const void* gmem,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, uint32_t smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(smem), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

struct Tile {
  const char* src;
  char* dst;
  uint32_t bytes;
};

// Work item t: tile k of the block that source shard i sends to
// destination shard j, pair = j * D + i (as the load/store body's grid).
__device__ __forceinline__ Tile tile_at(const Bases& bases, int num_shards,
                                        long long block_bytes,
                                        long long tiles_per_block,
                                        uint32_t tile_bytes, long long t) {
  const long long pair = t / tiles_per_block;
  const long long off = (t - pair * tiles_per_block) * tile_bytes;
  const int dst_shard = static_cast<int>(pair / num_shards);
  const int src_shard = static_cast<int>(pair % num_shards);
  const long long left = block_bytes - off;
  Tile tile;
  tile.src = reinterpret_cast<const char*>(bases.src[src_shard]) +
             dst_shard * block_bytes + off;
  tile.dst = reinterpret_cast<char*>(bases.dst[dst_shard]) +
             src_shard * block_bytes + off;
  tile.bytes = static_cast<uint32_t>(left < tile_bytes ? left : tile_bytes);
  return tile;
}

__global__ void __launch_bounds__(kTmaThreads)
ring_tma_kernel(const __grid_constant__ Bases bases, int num_shards,
                long long block_bytes, long long tiles_per_block,
                long long num_tiles, uint32_t tile_bytes, int stages) {
  extern __shared__ __align__(128) unsigned char stage_buf[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  if (threadIdx.x != 0) return;

  const uint32_t buf = smem_addr(stage_buf);
  for (int s = 0; s < stages; ++s) mbar_init(smem_addr(&full[s]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // this CTA's tiles are blockIdx.x + i * gridDim.x, i in [0, n)
  const long long n =
      (num_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int ahead = stages - 1;  // loads in flight behind each store
  auto load = [&](long long i) {
    const Tile tile = tile_at(bases, num_shards, block_bytes,
                              tiles_per_block, tile_bytes,
                              blockIdx.x + i * gridDim.x);
    const int s = static_cast<int>(i % stages);
    const uint32_t bar = smem_addr(&full[s]);
    mbar_expect_tx(bar, tile.bytes);
    bulk_load(buf + s * tile_bytes, tile.src, tile.bytes, bar);
  };

  for (long long i = 0; i < ahead && i < n; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int s = static_cast<int>(i % stages);
    // the stage's (i / stages)-th load has landed
    mbar_wait(smem_addr(&full[s]), static_cast<uint32_t>((i / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const Tile tile = tile_at(bases, num_shards, block_bytes,
                              tiles_per_block, tile_bytes,
                              blockIdx.x + i * gridDim.x);
    bulk_store(tile.dst, buf + s * tile_bytes, tile.bytes);
    if (i + ahead < n) {
      // every store but this one has read its stage: tile i - 1's stage
      // is free for tile i + ahead
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i + ahead);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Per-device values read once: the SM count, and the dynamic shared
// memory size the TMA kernel has been allowed so far.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem_allowed[kMaxDevices];

int launch_tma(const Bases& bases, int num_shards, long long block_bytes,
               int tile_bytes, int stages, int ctas_per_sm,
               cudaStream_t stream) {
  const long long smem = static_cast<long long>(tile_bytes) * stages;
  if (tile_bytes < 16 || tile_bytes % 16 != 0 || tile_bytes > kMaxTileBytes ||
      stages < 2 || stages > kMaxStages || smem > kMaxSmemBytes ||
      ctas_per_sm < 1 || block_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < num_shards; ++k) {
    if ((bases.src[k] | bases.dst[k]) & 15) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (g_sms[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[dev] = sms;
  }
  if (g_smem_allowed[dev] < smem) {
    err = cudaFuncSetAttribute(ring_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_allowed[dev] = static_cast<int>(smem);
  }
  const long long tiles_per_block = (block_bytes + tile_bytes - 1) / tile_bytes;
  const long long num_tiles =
      static_cast<long long>(num_shards) * num_shards * tiles_per_block;
  long long grid = static_cast<long long>(ctas_per_sm) * g_sms[dev];
  if (grid > num_tiles) grid = num_tiles;
  ring_tma_kernel<<<static_cast<unsigned>(grid), kTmaThreads,
                    static_cast<size_t>(smem), stream>>>(
      bases, num_shards, block_bytes, tiles_per_block, num_tiles,
      static_cast<uint32_t>(tile_bytes), stages);
  return static_cast<int>(cudaGetLastError());
}

int launch_ldst(const Bases& bases, int num_shards, long long block_bytes,
                cudaStream_t stream) {
  const long long block_words = block_bytes / 4;
  const long long pairs = static_cast<long long>(num_shards) * num_shards;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll * 4;
  long long chunks = (block_words + per_block - 1) / per_block;
  const long long cap = kTargetBlocks / pairs > 0 ? kTargetBlocks / pairs : 1;
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(pairs));
  ring_ldst_kernel<<<grid, kThreads, 0, stream>>>(bases, num_shards,
                                                  block_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bases: host pointer to a Bases (D source bases, then D destination
// bases, each a device address); the launch copies it into the kernel's
// parameters, so it need not outlive the call. block_bytes = C*W*4.
// use_tma selects the body (the caller checks alignment; the TMA body
// refuses misaligned bases). tile_bytes, stages and ctas_per_sm shape
// the TMA body and are ignored by the other. Returns cudaGetLastError()
// after the launch, or the error that kept it from launching (0 =
// launched).
extern "C" int ring_all_to_all_launch(const void* bases, int num_shards,
                                      long long block_bytes, int use_tma,
                                      int tile_bytes, int stages,
                                      int ctas_per_sm, void* stream) {
  if (num_shards < 1 || num_shards > kMaxShards || block_bytes < 4 ||
      block_bytes % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bases& b = *static_cast<const Bases*>(bases);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return use_tma ? launch_tma(b, num_shards, block_bytes, tile_bytes, stages,
                              ctas_per_sm, s)
                 : launch_ldst(b, num_shards, block_bytes, s);
}

extern "C" int ring_all_to_all_max_shards() { return kMaxShards; }

extern "C" const char* ring_all_to_all_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
