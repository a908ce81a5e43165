// Stable partition by destination: for every shard d of dest [D, N] (int32
// or int64, read as given), with B = P + 1 buckets (a row whose destination
// lies in [0, P) goes to that bucket, every other row is a pad and goes to
// the last bucket P):
//
// - order [D, N] int64: shard d's row indices grouped by bucket, ascending
//   within a bucket, the pads last;
// - totals [D, B] int32: the rows of each bucket, the pads' last.
//
// That is what a stable sort of the destinations with the pads mapped to
// P yields (its permutation, and the counts that a search of the sorted
// destinations and a difference give), byte for byte: the grouping in
// front of every shuffle (parallel/exchange.py's group_by_destination).
// Replaces no Pallas kernel: the JAX package groups with XLA's
// jnp.argsort(dest, stable=True) (sparkrdma_tpu/parallel/exchange.py,
// group_by_destination), and the port did with torch.sort, whose radix
// sort takes all 64 bits of an int64 key: eight digit passes, each reading
// and writing 16 bytes a row, where the destination has one digit.
//
// What bounds it: bytes. Each destination read once and each index written
// once, D * N * (dest bytes + 8) over the card's memory rate (H100 SXM:
// 3.35 TB/s); q95's grouping of [8, 2,699,088] int32 destinations is 259
// MB, 0.077 ms. The design:
//
// - Tiles. Each shard is cut into tiles of kTileRows rows, one block a
//   tile, and each tile into one chunk of kChunkRows a warp. A warp takes
//   its chunk 32 rows at a time, lane l row l, loading kUnroll groups of
//   32 before it works on the first.
// - Peers. The lanes of a group that share a lane's bucket come from one
//   __ballot_sync a bit of the bucket (bits_of: 4 at P = 8), each lane
//   keeping the lanes that agree with it on the bit: the mask that
//   __match_any_sync gives.
// - Count pass (count_kernel): each warp counts its chunk's buckets in a
//   row of shared memory, the lowest lane of each bucket adding the
//   number of its peers, so a bucket costs one add a group however many
//   rows it has. The block sums its warps and writes the tile's B counts
//   to table[d][b][t], bucket-major.
// - Scan pass (scan_kernel), one block a shard: the exclusive prefix of
//   table[d] in place. Bucket-major, that is for every (b, t) where tile
//   t's rows of bucket b start in order: every row of the buckets below b,
//   then bucket b's rows of the tiles before t. The block then writes the
//   bucket totals from the bucket starts.
// - Place pass (place_kernel): each warp counts its chunk again and the
//   block turns the warps' counts into each warp's start in every bucket
//   (a prefix over the warps, from the tile's start out of the table).
//   Then each warp walks its chunk again: a row's place is its warp's
//   start in its bucket plus its peers below its lane, and the lowest
//   peer advances the start by their number. Rows of a bucket leave in
//   row order: tiles in order, warps in order inside a tile, groups in
//   order inside a chunk, lanes in order inside a group. The index stores
//   of one warp run on in each bucket, so the L2 gathers them into whole
//   sectors.
//
// Measured on an H100 (700 W), at q95's groupings with P = 8: [8,
// 2,699,088] int32, two thirds pads, 0.226 ms (34% of the bound; the
// stable torch.sort of the int64 destinations, a search and a difference
// 3.40 ms); [8, 899,696], no pads, 0.089 ms (29%); the same [8, 2,699,088]
// as int64 0.242 ms (43%). Tiles of 2048 rows and blocks of 256 threads
// won over 4096 x 256 (0.244 ms at [8, 2,699,088]), 4096 x 512 (0.231),
// 8192 x 512 (0.241); loading one group at a time cost 0.277 (4096 x 512),
// two 0.256. Matching peers with __match_any_sync instead of ballots ran
// 0.224 at 4096 x 512 and 0.273 at 4096 x 256, with one group at a time.
// A single pass with decoupled look-back (a histogram kernel adding into
// the totals, then tiles taken in ticket order, each publishing its counts
// and summing its predecessors' before it places) ran 0.250 at 4096 x 256,
// against 0.273 for the three passes in the same form: the look-back
// waits cost about what the second read of the destinations does. At P =
// 128 every form ran 0.36-0.42 ms (these tiles 0.41: the scan's table is
// 129 x 1,318 entries a shard).
//
// Nothing comes back to the host: the launch depends on the shapes alone.
// The wrapper allocates the outputs and the table scratch ([D, B,
// ceil(N / kTileRows)] int32) with torch.empty. Runs on the caller's
// stream, allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 2048;     // rows a block of the count and place passes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = kTileRows / kWarps;  // rows a warp
constexpr int kMaxBuckets = 256;    // B = P + 1: the partitions and the pads
constexpr long long kMaxRows = 0x7fffffffLL;   // N
constexpr int kUnroll = 4;          // groups of 32 rows a warp loads at once
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;       // consecutive entries a scan thread

static_assert(kChunkRows % 32 == 0, "a chunk is whole groups of 32 rows");

// A row's bucket: its destination in [0, P), else P (a pad); a lane past
// `end` takes P + 1, which no row has.
template <typename T>
__device__ __forceinline__ int bucket_at(const T* __restrict__ dest,
                                         long long row, long long end,
                                         int partitions) {
  if (row >= end) return partitions + 1;
  const T v = __ldg(dest + row);
  return (v < 0 || v >= partitions) ? partitions : static_cast<int>(v);
}

// The lanes whose b equals this lane's, b in [0, 2^bits): one ballot a bit
// of b, each lane keeping the lanes that agree with it on the bit (as
// __match_any_sync gives, in `bits` ballots).
__device__ __forceinline__ unsigned peers_of(int b, int bits) {
  unsigned peers = 0xffffffffu;
  for (int i = 0; i < bits; ++i) {
    const bool on = (b >> i) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, on);
    peers &= on ? set : ~set;
  }
  return peers;
}

// Adds the buckets of rows [first, end) of `dest` to `hist`, one row a
// lane; the loop runs alike on every lane, so the ballots take the whole
// warp.
template <typename T>
__device__ __forceinline__ void count_chunk(const T* __restrict__ dest,
                                            long long first, long long end,
                                            int partitions, int bits,
                                            int* hist, int lane) {
  for (long long r0 = first; r0 < end; r0 += 32 * kUnroll) {
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      b[u] = bucket_at(dest, r0 + 32 * u + lane, end, partitions);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = peers_of(b[u], bits);
      if (b[u] <= partitions && lane == __ffs(peers) - 1) {
        hist[b[u]] += __popc(peers);
      }
      __syncwarp();
    }
  }
}

// Bits that tell apart the buckets and P + 1.
__device__ __forceinline__ int bits_of(int partitions) {
  return 32 - __clz(partitions + 1);
}

__device__ __forceinline__ void zero_rows(int (*rows)[kMaxBuckets],
                                          int buckets) {
  for (int j = threadIdx.x; j < kWarps * buckets; j += kThreads) {
    rows[j / buckets][j % buckets] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_kernel(const T* __restrict__ dest, int* __restrict__ table,
             long long rows, int partitions, int tiles) {
  __shared__ int hist[kWarps][kMaxBuckets];
  const int buckets = partitions + 1;
  const long long d = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x % tiles);
  const int warp = threadIdx.x >> 5;
  zero_rows(hist, buckets);
  __syncthreads();
  const long long first = static_cast<long long>(t) * kTileRows
                          + warp * kChunkRows;
  count_chunk(dest + d * rows, first, min(first + kChunkRows, rows),
              partitions, bits_of(partitions), hist[warp], threadIdx.x & 31);
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += hist[w][b];
    table[(d * buckets + b) * tiles + t] = sum;
  }
}

// table[d] (buckets * tiles entries) to its exclusive prefix, in place;
// then totals[d][b], the rows of bucket b.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ table, int* __restrict__ totals,
            long long rows, int buckets, int tiles) {
  __shared__ int warp_below[kScanThreads / 32];
  __shared__ int chunk_sum;
  const long long d = blockIdx.x;
  int* t = table + d * buckets * tiles;
  const long long len = static_cast<long long>(buckets) * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (long long c0 = 0; c0 < len; c0 += kScanThreads * kScanItems) {
    const long long at = c0 + static_cast<long long>(threadIdx.x)
                         * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = at + i < len ? t[at + i] : 0;
      sum += v[i];
    }
    int incl = sum;  // inclusive over the warp's threads
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) warp_below[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_below[lane];
      int wi = w;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, wi, off);
        if (lane >= off) wi += up;
      }
      warp_below[lane] = wi - w;
      if (lane == 31) chunk_sum = wi;
    }
    __syncthreads();
    int run = carry + warp_below[warp] + incl - sum;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (at + i < len) t[at + i] = run;
      run += v[i];
    }
    carry += chunk_sum;
    __syncthreads();  // the next chunk rewrites warp_below and chunk_sum
  }
  for (int b = threadIdx.x; b < buckets; b += kScanThreads) {
    const long long end = b + 1 < buckets ? t[(b + 1LL) * tiles] : rows;
    totals[d * buckets + b] = static_cast<int>(end - t[1LL * b * tiles]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
place_kernel(const T* __restrict__ dest, const int* __restrict__ table,
             long long* __restrict__ order, long long rows, int partitions,
             int tiles) {
  __shared__ int start[kWarps][kMaxBuckets];
  const int buckets = partitions + 1;
  const long long d = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x % tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* src = dest + d * rows;
  const long long first = static_cast<long long>(t) * kTileRows
                          + warp * kChunkRows;
  const long long end = min(first + kChunkRows, rows);
  zero_rows(start, buckets);
  __syncthreads();
  const int bits = bits_of(partitions);
  count_chunk(src, first, end, partitions, bits, start[warp], lane);
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    int run = table[(d * buckets + b) * tiles + t];
    for (int w = 0; w < kWarps; ++w) {
      const int c = start[w][b];
      start[w][b] = run;
      run += c;
    }
  }
  __syncthreads();
  long long* out = order + d * rows;
  int* mine = start[warp];
  const unsigned below = (1u << lane) - 1;
  for (long long r0 = first; r0 < end; r0 += 32 * kUnroll) {
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      b[u] = bucket_at(src, r0 + 32 * u + lane, end, partitions);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = peers_of(b[u], bits);
      const int rank = __popc(peers & below);
      if (b[u] <= partitions) out[mine[b[u]] + rank] = r0 + 32 * u + lane;
      __syncwarp();
      if (b[u] <= partitions && rank == 0) mine[b[u]] += __popc(peers);
      __syncwarp();
    }
  }
}

template <typename T>
int launch(const void* dest, void* order, void* table, void* totals,
           long long shards, long long rows, int partitions, int tiles,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(shards * tiles);
  count_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dest), static_cast<int*>(table), rows,
      partitions, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(shards), kScanThreads, 0, stream>>>(
      static_cast<int*>(table), static_cast<int*>(totals), rows,
      partitions + 1, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  place_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dest), static_cast<const int*>(table),
      static_cast<long long*>(order), rows, partitions, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The partition of `shards` rows of destinations: dest [shards, rows] of
// dest_bytes (4: int32, 8: int64), order int64 [shards, rows], table int32
// [shards, partitions + 1, ceil(rows / kTileRows)] scratch and totals int32
// [shards, partitions + 1] (device, contiguous, each aligned to its
// element). Refuses (cudaErrorInvalidValue) anything else, partitions
// outside [1, kMaxBuckets - 1], rows past kMaxRows or a grid past 2^31
// blocks; an empty partition launches nothing. Returns cudaGetLastError()
// after each launch.
extern "C" int dest_partition_launch(const void* dest, void* order,
                                     void* table, void* totals,
                                     long long shards, long long rows,
                                     long long partitions, int dest_bytes,
                                     void* stream) {
  const uintptr_t misaligned =
      (reinterpret_cast<uintptr_t>(dest) & (dest_bytes - 1))
      | (reinterpret_cast<uintptr_t>(order) & 7)
      | (reinterpret_cast<uintptr_t>(table) & 3)
      | (reinterpret_cast<uintptr_t>(totals) & 3);
  if (shards < 0 || rows < 0 || rows > kMaxRows || partitions < 1
      || partitions >= kMaxBuckets || (dest_bytes != 4 && dest_bytes != 8)
      || misaligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shards == 0 || rows == 0) return static_cast<int>(cudaSuccess);
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  if (shards * tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(partitions);
  const int tl = static_cast<int>(tiles);
  if (dest_bytes == 8) {
    return launch<long long>(dest, order, table, totals, shards, rows, p, tl,
                             s);
  }
  return launch<int>(dest, order, table, totals, shards, rows, p, tl, s);
}

extern "C" const char* dest_partition_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
