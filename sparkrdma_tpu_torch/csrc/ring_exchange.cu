// Ring all-to-all over the virtual mesh: the block transpose of the
// per-shard send buffers, out[j, i] = blocks[i, j]; and the ragged
// all-to-all (ragged_all_to_all_launch and its range form, their own
// section below), which copies each pair with the same load/store body.
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
// memory rate (H100 SXM: 3.35 TB/s). One load/store body serves that
// bound for every launch, whatever the alignment of the blocks (bases
// and block size need only be multiples of 4 bytes):
//
// - Each pair is one contiguous copy of C*W*4 bytes between two
//   4-byte-aligned addresses, cut so that every 16-byte word it loads or
//   stores lies wholly inside the pair's bytes: a scalar head until the
//   destination is 16-byte aligned (one vector longer where the first
//   aligned source vector would start before the block), an interior of
//   16-byte streaming loads and stores, and a scalar tail; head and tail
//   are at most 15 words together, and both are empty when the pair's
//   bases and the block size are multiples of 16 bytes.
// - Where the source is r = 1..3 words past a 16-byte boundary at the
//   interior's start, each lane loads aligned source vectors and builds
//   each output from words r..3 of its own and words 0..r-1 of its
//   neighbour's, handed over by a warp shuffle, so every source vector is
//   read from memory once whatever the alignment.
// - The grid is sized from the work: (tile groups, pairs), one warp per
//   tile of 128 vectors (2 KB, four loads in flight a lane), so a large
//   block is hundreds of CTAs a pair, a 13 KB block still spreads over
//   two CTAs of four warps, and a block of a few words is one warp's
//   scalar words, loaded before and stored after its vectors.
//
// The D source and D destination bases travel by value in the kernel's
// parameter block (Bases, 2 KB), so a launch needs no device-side
// pointer array, no host-to-device copy, and can be captured in a CUDA
// graph. Shard i sends from src[i] + j*block and shard j receives at
// dst[j] + i*block. A launch may cover a range of source shards only:
// sources [s0, s0 + S) of G, with S source bases and G destination bases
// (ring_all_to_all_launch_range), so each process of a global mesh
// launches over its own shards and writes through peer pointers into the
// other processes' receive buffers, opened from CUDA IPC handles
// (ring_ipc_*, at the end). The full launch is the range s0 = 0, S = G =
// D. A launch runs on the caller's stream, allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 128;  // Bases is 2 KB of the 4 KB parameter block

struct Bases {
  long long src[kMaxShards];
  long long dst[kMaxShards];
};

constexpr int kLdstThreads = 128;                    // 4 warps a CTA
constexpr int kLdstWarps = kLdstThreads / 32;
constexpr int kLdstUnroll = 4;                       // vectors in flight a lane
constexpr int kTileVecs = 32 * kLdstUnroll;          // a warp tile, 2 KB

// Where the 16-byte interior of one pair's copy of n words lies: words
// [0, head) and [head + 4 * nvec, n) are copied one by one; destination
// vector k < nvec of the interior is words head + 4k .. head + 4k + 3,
// read from the aligned source vectors at word head - r + 4k (and the
// next one when r > 0), all inside the block.
struct Interior {
  long long head;
  long long nvec;
  int r;
};

__device__ __forceinline__ Interior interior_of(const int32_t* src,
                                                const int32_t* dst,
                                                long long n) {
  Interior in;
  in.head = static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
  in.r = 0;
  in.nvec = 0;
  if (in.head >= n) {
    in.head = n;
    return in;
  }
  in.r = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src + in.head) & 15) >> 2);
  // the first aligned source vector starts r words before the interior:
  // inside the block only if the head is at least r words long
  if (in.r > in.head) in.head += 4;
  // the last output vector reads up to 8 - r words past its start
  const long long room = n - in.head - (in.r ? 4 - in.r : 0);
  if (in.head > n) {
    in.head = n;
  } else if (room >= 4) {
    in.nvec = room / 4;
  }
  return in;
}

// One warp tile: the first min(left, kTileVecs) vectors of s4 -> d4 (the
// tile's start in a pair's interior; left > 0 vectors remain from there)
// of a pair whose source is R words past the aligned vectors s4. Lane l
// takes vectors 32u + l, u < kLdstUnroll. R = 0: a straight copy. R > 0:
// output k is words R..3 of s4[k] and 0..R-1 of s4[k + 1]; lane l gets
// s4[k + 1] from lane l + 1, and lane 31 from lane 0, which hands over
// the first vector of the next group (or of the next tile) instead of
// its own. s4[left] is the last vector the pair reads.
template <int R>
__device__ __forceinline__ void copy_tile(const int4* __restrict__ s4,
                                          int4* __restrict__ d4,
                                          long long left, int lane) {
  const int outs = left < kTileVecs ? static_cast<int>(left) : kTileVecs;
  // vectors s4[i], i < loads, lie inside the pair's bytes
  const int loads = R == 0 ? outs
                    : left < kTileVecs ? static_cast<int>(left) + 1
                                       : kTileVecs + 1;
  int4 cur[kLdstUnroll];
#pragma unroll
  for (int u = 0; u < kLdstUnroll; ++u) {
    const int i = u * 32 + lane;
    cur[u] = i < loads ? __ldcs(s4 + i) : make_int4(0, 0, 0, 0);
  }
  if (R == 0) {
#pragma unroll
    for (int u = 0; u < kLdstUnroll; ++u) {
      const int i = u * 32 + lane;
      if (i < outs) __stcs(d4 + i, cur[u]);
    }
    return;
  }
  int4 ext = make_int4(0, 0, 0, 0);
  if (lane == 0 && kTileVecs < loads) ext = __ldcs(s4 + kTileVecs);
  const int from = (lane + 1) & 31;
#pragma unroll
  for (int u = 0; u < kLdstUnroll; ++u) {
    const int4 give =
        lane == 0 ? (u + 1 < kLdstUnroll ? cur[u + 1] : ext) : cur[u];
    const int4 c = cur[u];
    int4 o;
    if (R == 1) {
      o = make_int4(c.y, c.z, c.w, __shfl_sync(0xffffffffu, give.x, from));
    } else if (R == 2) {
      o = make_int4(c.z, c.w, __shfl_sync(0xffffffffu, give.x, from),
                    __shfl_sync(0xffffffffu, give.y, from));
    } else {
      o = make_int4(c.w, __shfl_sync(0xffffffffu, give.x, from),
                    __shfl_sync(0xffffffffu, give.y, from),
                    __shfl_sync(0xffffffffu, give.z, from));
    }
    const int i = u * 32 + lane;
    if (i < outs) __stcs(d4 + i, o);
  }
}

// Tile `tile` of one pair's copy of n words from src to dst, by one warp:
// the tile's 128 interior vectors, and for tile 0 also the scalar head
// and tail. Every value but the lane's own indices is the same in the
// warp, so the warp stays converged through the shuffles.
__device__ __forceinline__ void copy_pair_tile(
    const int32_t* __restrict__ src, int32_t* __restrict__ dst,
    long long n, long long tile, int lane) {
  const Interior in = interior_of(src, dst, n);
  // tile 0 also copies the head's and the tail's words, at most 15, one
  // a lane: loaded here and stored last, so its load is in flight
  // together with the tile's vector loads
  long long w = n;
  if (tile == 0) {
    w = lane < in.head ? lane : in.head + 4 * in.nvec + (lane - in.head);
  }
  const int32_t word = w < n ? src[w] : 0;
  const long long first = tile * kTileVecs;
  if (first < in.nvec) {
    const int4* s4 =
        reinterpret_cast<const int4*>(src + in.head - in.r) + first;
    int4* d4 = reinterpret_cast<int4*>(dst + in.head) + first;
    const long long left = in.nvec - first;
    switch (in.r) {
      case 0: copy_tile<0>(s4, d4, left, lane); break;
      case 1: copy_tile<1>(s4, d4, left, lane); break;
      case 2: copy_tile<2>(s4, d4, left, lane); break;
      default: copy_tile<3>(s4, d4, left, lane); break;
    }
  }
  if (w < n) dst[w] = word;
}

__global__ void __launch_bounds__(kLdstThreads)
ring_ldst_kernel(const __grid_constant__ Bases bases, int num_src,
                 int src_begin, long long block_words) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int pair = static_cast<int>(blockIdx.y);
  const long long tile =
      static_cast<long long>(blockIdx.x) * kLdstWarps + threadIdx.x / 32;
  const int dst_shard = pair / num_src;
  const int src_local = pair % num_src;
  const int32_t* src =
      reinterpret_cast<const int32_t*>(bases.src[src_local]) +
      static_cast<long long>(dst_shard) * block_words;
  int32_t* dst =
      reinterpret_cast<int32_t*>(bases.dst[dst_shard]) +
      static_cast<long long>(src_begin + src_local) * block_words;
  copy_pair_tile(src, dst, block_words, tile, lane);
}

int launch_ldst(const Bases& bases, int num_dst, int src_begin, int num_src,
                long long block_bytes, cudaStream_t stream) {
  const long long block_words = block_bytes / 4;
  // a pair's interior has at most block_words / 4 vectors; its tile 0
  // also copies the scalar head and tail, so every pair has one
  const long long tiles = (block_words / 4 + kTileVecs - 1) / kTileVecs;
  const long long groups = tiles > 0 ? (tiles + kLdstWarps - 1) / kLdstWarps
                                     : 1;
  if (groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(groups),
            static_cast<unsigned>(num_dst * num_src));
  ring_ldst_kernel<<<grid, kLdstThreads, 0, stream>>>(bases, num_src,
                                                      src_begin, block_words);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* bases, int num_dst, int src_begin, int num_src,
           long long block_bytes, void* stream) {
  if (num_dst < 1 || num_dst > kMaxShards || num_src < 1 ||
      num_src > kMaxShards || src_begin < 0 ||
      src_begin + num_src > num_dst || block_bytes < 4 ||
      block_bytes % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_ldst(*static_cast<const Bases*>(bases), num_dst, src_begin,
                     num_src, block_bytes, static_cast<cudaStream_t>(stream));
}

// ---- the ragged all-to-all ----------------------------------------------
//
// Replaces the JAX package's `native` transport, the XLA collective
// lax.ragged_all_to_all in ragged_exchange_shard
// (sparkrdma_tpu/parallel/exchange.py:177-180): each (source i,
// destination j) pair is one contiguous run of mat[i, j] rows, from row
// start[i, j] of source i (start = the exclusive prefix of mat along j)
// to row land[i, j] of receiver j (land = the exclusive prefix of
// mat[:, j] over all sources), with no slots, no padding and no pack.
// Rows at or past out_rows are not written (the gather transport's
// truncation) and rows of a receiver past its total keep their values.
//
// What bounds it: bytes, each copied row read once and written once, so
// its least time is 2 * sum(rows) * W * 4 bytes over the memory rate.
// Each pair is the ring's pair with its own length and bases, so the
// ring's load/store body copies it (copy_pair_tile). The grid is sized
// from the send ranges alone, never from the counts, so a launch reads
// nothing on the host and can be captured in a CUDA graph:
// (tile groups over a source's cap*W words plus one tile a pair, the
// launch's sources). A warp finds its pair by a warp scan of the pairs'
// tile counts, 32 pairs at a time, and copies that tile; a warp past its
// source's last tile exits. ragged_book_kernel, one block launched
// before it, turns the int32 counts into the int64 counts, starts and
// lands the warps read.
//
// Like the ring, every launch is a range launch with its bases by value
// (Bases, in the copy's parameters): sources [s0, s0 + S) of G, source k
// at src[k], receiver j at dst[j]. The book always covers the whole
// [G, G] matrix, so a land is the prefix over every source, local or
// not. On one card s0 = 0, S = G = D and the bases are the shards of two
// tensors
// (ragged_all_to_all_launch); across processes each process launches
// over its own sources and dst[j] is shard j's rows in the arena of the
// process that holds it, opened from a CUDA IPC handle
// (ragged_all_to_all_launch_range): each pair's rows are written once,
// straight into the receiving process's memory.

constexpr int kBookThreads = kMaxShards;

// book[0][i][j] = max(mat[i][j], 0), book[1][i][j] = the exclusive
// prefix of book[0][i] along j, book[2][i][j] = the exclusive prefix of
// book[0][.][j] over sources i.
__global__ void __launch_bounds__(kBookThreads)
ragged_book_kernel(const int32_t* __restrict__ mat,
                   long long* __restrict__ book, int d) {
  const int t = static_cast<int>(threadIdx.x);
  if (t >= d) return;
  const long long dd = static_cast<long long>(d) * d;
  long long acc = 0;
  for (int j = 0; j < d; ++j) {
    const long long c = max(mat[t * d + j], 0);
    book[t * d + j] = c;
    book[dd + t * d + j] = acc;
    acc += c;
  }
  acc = 0;
  for (int i = 0; i < d; ++i) {
    book[2 * dd + i * d + t] = acc;
    acc += max(mat[i * d + t], 0);
  }
}

// Lane l of a warp reads pair j0 + l's destination base from the
// parameters, bases.dst[j0 + l]: d different words, once a warp. At
// shapes of a few KB that costs less than loading the bases from a copy
// that the book launch writes beside the counts.
__global__ void __launch_bounds__(kLdstThreads)
ragged_ldst_kernel(const __grid_constant__ Bases bases,
                   const long long* __restrict__ book, int d,
                   int src_begin, long long cap_rows, long long out_rows,
                   long long row_words) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int src_shard = src_begin + static_cast<int>(blockIdx.y);
  const long long tile =
      static_cast<long long>(blockIdx.x) * kLdstWarps + threadIdx.x / 32;
  const long long dd = static_cast<long long>(d) * d;
  const long long* counts = book + static_cast<long long>(src_shard) * d;
  const long long* starts = counts + dd;
  const long long* lands = counts + 2 * dd;
  const int32_t* shard =
      reinterpret_cast<const int32_t*>(bases.src[blockIdx.y]);
  long long before = 0;  // tiles of the pairs of earlier rounds
  for (int j0 = 0; j0 < d; j0 += 32) {
    // lane l takes pair j0 + l: its words, source offset, destination
    // address and tiles
    const int j = j0 + lane;
    long long n = 0, src_off = 0, dst = 0, tiles = 0;
    if (j < d) {
      const long long start = starts[j];
      const long long land = lands[j];
      // rows past the source's capacity are not read, rows at or past
      // the receiver's capacity are not written
      const long long rows =
          min(counts[j], min(cap_rows - start, out_rows - land));
      if (rows > 0) {
        n = rows * row_words;
        src_off = start * row_words;
        int32_t* to =
            reinterpret_cast<int32_t*>(bases.dst[j]) + land * row_words;
        dst = static_cast<long long>(reinterpret_cast<uintptr_t>(to));
        const Interior in = interior_of(shard + src_off, to, n);
        tiles = in.nvec > 0 ? (in.nvec + kTileVecs - 1) / kTileVecs : 1;
      }
    }
    long long incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const long long total = __shfl_sync(0xffffffffu, incl, 31);
    if (tile < before + total) {  // the same in the whole warp
      const int owner =
          __ffs(__ballot_sync(0xffffffffu, before + incl > tile)) - 1;
      const long long first = __shfl_sync(0xffffffffu, incl - tiles, owner);
      const long long pn = __shfl_sync(0xffffffffu, n, owner);
      const long long ps = __shfl_sync(0xffffffffu, src_off, owner);
      const long long pd = __shfl_sync(0xffffffffu, dst, owner);
      copy_pair_tile(shard + ps,
                     reinterpret_cast<int32_t*>(static_cast<uintptr_t>(pd)),
                     pn, tile - before - first, lane);
      return;
    }
    before += total;
  }
}

int launch_ragged(const Bases& bases, int num_dst, int src_begin,
                  int num_src, const int32_t* mat, long long* book,
                  long long cap_rows, long long out_rows, long long row_words,
                  cudaStream_t stream) {
  if (num_dst < 1 || num_dst > kMaxShards || num_src < 1 ||
      num_src > kMaxShards || src_begin < 0 ||
      src_begin + num_src > num_dst || cap_rows < 1 || out_rows < 1 ||
      row_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a pair's tiles are its interior's vectors over kTileVecs, or 1 for a
  // pair of scalar words only: at most a source's cap*W/4 vectors over
  // kTileVecs, plus one a pair
  const long long tiles =
      (cap_rows * row_words / 4 + kTileVecs - 1) / kTileVecs + num_dst;
  const long long groups = (tiles + kLdstWarps - 1) / kLdstWarps;
  if (groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ragged_book_kernel<<<1, kBookThreads, 0, stream>>>(mat, book, num_dst);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(num_src));
  ragged_ldst_kernel<<<grid, kLdstThreads, 0, stream>>>(
      bases, book, num_dst, src_begin, cap_rows, out_rows, row_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bases: host pointer to a Bases (D source bases, then D destination
// bases, each a device address); the launch copies it into the kernel's
// parameters, so it need not outlive the call. block_bytes = C*W*4.
// Returns cudaGetLastError() after the launch, or the error that kept it
// from launching (0 = launched).
extern "C" int ring_all_to_all_launch(const void* bases, int num_shards,
                                      long long block_bytes, void* stream) {
  return launch(bases, num_shards, 0, num_shards, block_bytes, stream);
}

// The launch over source shards [src_begin, src_begin + num_src) of
// num_dst: bases holds num_src source bases (src[k] is shard src_begin +
// k's send buffer, its num_dst blocks one after another) and num_dst
// destination bases (dst[j] is shard j's receive buffer, num_dst blocks,
// block i from source shard i); a destination base may be a peer
// process's buffer opened by ring_ipc_open. Block (i, j) goes to
// dst[j] + i*block_bytes. Otherwise as ring_all_to_all_launch.
extern "C" int ring_all_to_all_launch_range(const void* bases, int num_dst,
                                            int src_begin, int num_src,
                                            long long block_bytes,
                                            void* stream) {
  return launch(bases, num_dst, src_begin, num_src, block_bytes, stream);
}

// The ragged all-to-all on one card: data [D, cap_rows, row_words] and
// out [D, out_rows, row_words] int32 (device), mat [D, D] int32 counts
// (device, mat[i, j] rows from shard i to shard j; shard i's rows
// grouped by destination), book a device scratch of 3*D*D long longs
// that the launch fills before its copy reads it. Writes out in place.
// The range launch over all D sources, with shard i's rows at data +
// i*cap_rows*row_words and receiver j's at out + j*out_rows*row_words.
// Two launches on `stream`; returns the first error (0 = launched).
extern "C" int ragged_all_to_all_launch(const void* data, void* out,
                                        const void* mat, void* book,
                                        int num_shards, long long cap_rows,
                                        long long out_rows,
                                        long long row_words, void* stream) {
  if (num_shards < 1 || num_shards > kMaxShards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bases bases = {};
  const int32_t* src = static_cast<const int32_t*>(data);
  int32_t* dst = static_cast<int32_t*>(out);
  for (int i = 0; i < num_shards; ++i) {
    bases.src[i] = static_cast<long long>(reinterpret_cast<uintptr_t>(
        src + static_cast<long long>(i) * cap_rows * row_words));
    bases.dst[i] = static_cast<long long>(reinterpret_cast<uintptr_t>(
        dst + static_cast<long long>(i) * out_rows * row_words));
  }
  return launch_ragged(bases, num_shards, 0, num_shards,
                       static_cast<const int32_t*>(mat),
                       static_cast<long long*>(book), cap_rows, out_rows,
                       row_words, static_cast<cudaStream_t>(stream));
}

// The ragged all-to-all over source shards [src_begin, src_begin +
// num_src) of num_dst: bases holds num_src source bases (src[k] is shard
// src_begin + k's cap_rows rows, grouped by destination) and num_dst
// destination bases (dst[j] is receiver j's out_rows rows; it may lie in
// a peer process's arena opened by ring_ipc_open); mat is the whole
// [num_dst, num_dst] int32 count matrix (device) and book a device
// scratch of 3*num_dst*num_dst long longs. Pair (i, j) lands
// at dst[j] + land[i, j]*row_words words, land over all num_dst sources.
// Otherwise as ragged_all_to_all_launch.
extern "C" int ragged_all_to_all_launch_range(
    const void* bases, int num_dst, int src_begin, int num_src,
    const void* mat, void* book, long long cap_rows, long long out_rows,
    long long row_words, void* stream) {
  return launch_ragged(*static_cast<const Bases*>(bases), num_dst,
                       src_begin, num_src, static_cast<const int32_t*>(mat),
                       static_cast<long long*>(book), cap_rows, out_rows,
                       row_words, static_cast<cudaStream_t>(stream));
}

extern "C" int ring_all_to_all_max_shards() { return kMaxShards; }

extern "C" const char* ring_all_to_all_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---- peer buffers (CUDA IPC) -------------------------------------------
//
// A receive buffer that other processes write into is allocated here with
// cudaMalloc, outside PyTorch's caching allocator: the legacy IPC API
// exports only cudaMalloc memory (not the caching allocator's expandable
// segments), and an export names a whole allocation, so a buffer of its
// own has offset 0. Each returns a cudaError_t (0 = success).

extern "C" int ring_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int ring_ipc_alloc(long long bytes, void** ptr) {
  if (bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMalloc(ptr, static_cast<size_t>(bytes)));
}

extern "C" int ring_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// The IPC handle of the allocation at `base` (from ring_ipc_alloc) into
// handle_out (ring_ipc_handle_bytes() bytes), and the offset of `ptr`
// inside it.
extern "C" int ring_ipc_export(const void* base, const void* ptr,
                               void* handle_out, long long* offset_out) {
  const char* b = static_cast<const char*>(base);
  const char* p = static_cast<const char*>(ptr);
  if (p < b) return static_cast<int>(cudaErrorInvalidValue);
  cudaIpcMemHandle_t handle;
  const cudaError_t err =
      cudaIpcGetMemHandle(&handle, const_cast<void*>(base));
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(handle_out, &handle, sizeof(handle));
  *offset_out = static_cast<long long>(p - b);
  return 0;
}

// Map a peer process's allocation from its handle; *ptr is its base (add
// the exporter's offset). Peer access is enabled lazily.
extern "C" int ring_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int ring_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}
