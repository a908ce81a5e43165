// ALS's normal equations for one shard's entities: from rows r = 0..N-1,
// each with an entity local_key[r] in [0, E) (E = the caller's bucketed
// entity count), the other side's id other[r] and a float32 rating[r],
//
// - ata [E, k, k] float32: sum over e's rows of f f^T, f = fixed[other[r]]
//   (a row of the other side's factors [M, k]), both triangles written;
// - atr [E, k] float32: sum over e's rows of rating * f;
// - counts [E] int32: e's rows (MLlib's n_e under the weighted
//   regularisation).
//
// An entity with no row, and every padded one, gets zeros. A row whose
// entity lies outside [0, E) takes no part; a row whose other id is not
// below M adds nothing to the sums (no read leaves the factor table), but
// counts. Neither comes from the port's exchange.
//
// Replaces no Pallas kernel: the JAX package sums by XLA's scatter-add
// (sparkrdma_tpu/models/als.py, solve_item_factors), and so did the port,
// with float index_add_ atomics over [2^20, k, k] outer products written
// out a chunk at a time (ops/normal_equations.py's plain version, which the
// CPU runs).
//
// What bounds it: bytes, not operations. A row costs k(k+1)/2 + k FMAs (65
// at k = 10), while its bytes are its local key (8), its other id and
// rating (8 of a 12-byte row), its packed pair written and read back (8 +
// 8) and its factor row (4k) gathered, which stays in the 50 MB L2 for
// both of the cell's sides (17,770 x 40 B items, 480,189 x 40 B users).
// The benchmark's byte count (als.gram_bytes) is rows x (4k + 8) +
// entities x 4(k^2 + k); the passes here read the keys twice and the pairs
// once more, so 100% of that bound is out of reach by design.
//
// The design: order the rows by entity, then sum each entity's rows in
// registers, a piece of at most kPieceRows rows a warp, with no float
// atomic anywhere and no running total longer than one piece.
//
// - Count pass: counts, and each row's rank among its entity's rows
//   (rank [N], unique and below the entity's count), taken by integer
//   atomics on counts that return the rank. It adapts to the entities it
//   observes. Up to kSmemEntities (the item side: 1,777 in 2,048), each
//   block of count_smem_kernel takes a contiguous range of rows and
//   counts it twice in a shared-memory histogram: first each entity's
//   rows, reserved on counts with one atomicAdd an entity a block, then
//   each row's rank from the reserved base by a shared-memory atomicAdd.
//   A hot item's rows (the cell's top item holds ~116-231k of a shard's
//   ~10M) then cost one global atomic a block, not one a warp: atomics
//   a warp on 2,048 counters ran the pass at 1.21 ms where their
//   bandwidth allows 0.03. Past kSmemEntities (the user side: 48,019 in
//   65,536), count_kernel's lanes of a warp that share an entity
//   (__match_any_sync) take their ranks with one atomicAdd from the
//   lowest of them.
// - scan_kernel, up to kScanBlocks blocks of a tile of entities each:
//   each block first sums the counts before its tile, then takes the
//   exclusive prefix of counts (offsets [E + 1]) and of each entity's
//   pieces, ceil(count / kPieceRows) (piece_start [E + 1]) over its tile;
//   it writes each piece's entity into plan, in piece order, and adds
//   into state[0] the entities whose rows take more than one piece (the
//   als.gram_split counter). One block over the user side's 65,536 took
//   0.097 ms, sixteen 0.009.
// - place_kernel: each row's (other id, rating bits) pair to slot
//   offsets[e] + rank, with no atomic. The place is NOT stable: an
//   entity's rows land in the order the count pass's atomics ranked
//   them, so the float32 sums may round differently from run to run, as
//   the index_add_ atomics' did. Its 8-byte stores land at random slots
//   of an 80 MB array, a 32-byte sector or more of memory traffic each:
//   ~0.5 ms of a side's ~0.8-1.1. Placing in five launches of 2^21 slots
//   each, so that the written range stays in the L2, ran 0.61 ms against
//   0.54 in one: each launch reads every key and rank again.
// - piece_kernel<k>: one warp a piece (entity e's rows [offsets[e] + j P,
//   min(offsets[e] + (j + 1) P, offsets[e + 1])) for its j-th piece, P =
//   kPieceRows). Its lanes stride over the piece's pairs, kPieceUnroll
//   rows at a time, each keeping the k(k+1)/2 + k partial sums (the lower
//   triangle and A^T r) in registers; then a butterfly of shuffles adds
//   the lanes' sums and the piece's partial goes to partial [pieces,
//   k(k+1)/2 + k]. A lane sums at most P / 32 rows. Its time is the
//   random 40-byte factor rows it gathers from the L2 (two sectors each):
//   0.19 ms for the item side's 10M rows, 0.22 for the user side's; one,
//   two or four rows at a time and pieces of 1024, 2048 or 4096 rows all
//   ran within 10% of that.
// - combine_kernel<k>: one thread an (entity, entry): the entity's pieces'
//   partials added in piece order, written to both triangles of ata or to
//   atr. A hot item of 231k rows adds 113 partials; the float32 running
//   total a chunk of 2^20 rows kept before lost 5.8% of a diagonal entry
//   of a 25M-row item in a float32 simulation (ROADMAP C.1).
//
// kMaxRank bounds k: the sums live in registers (152 at k = 16). The
// wrapper refuses a larger rank.
//
// Measured on an H100 (700 W) at a block of the ALS cell (10,048,051
// rows, k = 10): the item side (1,777 of 2,048 entities) 0.80 ms, the
// user side (48,019 of 65,536) 1.01 ms, against byte bounds of 0.144 and
// 0.150 and 12.0 and 12.3 ms for the plain version; in the cell the
// als.gram span is 17.9 ms a job (16.5% of its bound) where the plain
// sums took 227.9.
//
// Nothing comes back to the host: the launches depend on the shapes alone
// (the piece pass is launched for the most pieces the shapes allow, E +
// ceil(N / P), and its surplus warps return). The wrapper allocates the
// outputs and scratch with torch.empty; the counts are zeroed here. Runs
// on the caller's stream, allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPieceRows = 2048;     // rows a piece at most: a power of two
constexpr int kPieceUnroll = 2;      // rows a lane loads before it sums them
constexpr int kMaxRank = 16;
constexpr long long kMaxRows = 0x7fffffffLL;       // N: offsets are int32
constexpr long long kMaxEntities = 0x3fffffffLL;   // E: piece_start is int32
constexpr unsigned kNoEntity = 0xffffffffu;
constexpr int kPassBlocks = 132 * 8;  // blocks of the count and place passes at most
constexpr int kSmemEntities = 4096;   // entities a shared-memory histogram holds
constexpr int kSmemThreads = 512;
constexpr int kSmemBlocks = 132 * 4;  // blocks of the shared-memory count at most
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;         // consecutive entities a scan thread
constexpr int kScanBlocks = 32;       // blocks of the scan at most

static_assert((kPieceRows & (kPieceRows - 1)) == 0, "P is a power of two");
static_assert(kScanThreads == 32 * 32, "the scan adds 32 warps' sums in one warp");

// An int32 column [N]: word r at ptr[r * stride].
struct Column {
  const unsigned* ptr;
  long long stride;

  __device__ __forceinline__ unsigned at(long long r) const {
    return __ldg(ptr + r * stride);
  }
};

// Row r's entity, or kNoEntity past the rows or outside [0, entities).
__device__ __forceinline__ unsigned entity_at(const long long* __restrict__ key,
                                              long long r, long long rows,
                                              long long entities) {
  if (r >= rows) return kNoEntity;
  const long long e = __ldg(key + r);
  return (e >= 0 && e < entities) ? static_cast<unsigned>(e) : kNoEntity;
}

// The first row of this thread's warp. A step moves on by every thread of
// the grid, so every lane of a warp runs the same number of steps and the
// warp-wide intrinsics see the whole warp.
__device__ __forceinline__ long long warp_first_row() {
  return static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const long long* __restrict__ key, long long rows,
             long long entities, int* __restrict__ counts,
             int* __restrict__ rank) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = warp_first_row(); base < rows; base += step) {
    const unsigned e = entity_at(key, base + lane, rows, entities);
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (e != kNoEntity && lane == leader) first = atomicAdd(counts + e, __popc(peers));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (e != kNoEntity) rank[base + lane] = first + __popc(peers & below);
  }
}

__global__ void __launch_bounds__(kSmemThreads)
count_smem_kernel(const long long* __restrict__ key, long long rows,
                  int entities, int* __restrict__ counts,
                  int* __restrict__ rank) {
  __shared__ int hist[kSmemEntities];
  const long long span = (rows + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * span;
  const long long hi = min(rows, lo + span);
  for (int b = threadIdx.x; b < entities; b += kSmemThreads) hist[b] = 0;
  __syncthreads();
  for (long long r = lo + threadIdx.x; r < hi; r += kSmemThreads) {
    const unsigned e = entity_at(key, r, rows, entities);
    if (e != kNoEntity) atomicAdd(hist + e, 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < entities; b += kSmemThreads) {
    const int n = hist[b];
    if (n != 0) hist[b] = atomicAdd(counts + b, n);
  }
  __syncthreads();
  for (long long r = lo + threadIdx.x; r < hi; r += kSmemThreads) {
    const unsigned e = entity_at(key, r, rows, entities);
    if (e != kNoEntity) rank[r] = atomicAdd(hist + e, 1);
  }
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, long long entities,
            long long tile, int* __restrict__ offsets,
            int* __restrict__ piece_start, int* __restrict__ plan,
            unsigned long long* __restrict__ state) {
  __shared__ int warp_sums[2][32];
  __shared__ int carry[2];
  __shared__ int split_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lo = blockIdx.x * tile;
  const long long hi = min(entities, lo + tile);
  // the block's carry: the rows and pieces of the entities before lo
  int before_c = 0;
  int before_p = 0;
  for (long long e = threadIdx.x; e < lo; e += kScanThreads) {
    const int c = counts[e];
    before_c += c;
    before_p += (c + kPieceRows - 1) / kPieceRows;
  }
  before_c = __reduce_add_sync(0xffffffffu, before_c);
  before_p = __reduce_add_sync(0xffffffffu, before_p);
  if (threadIdx.x == 0) {
    carry[0] = 0;
    carry[1] = 0;
    split_total = 0;
  }
  __syncthreads();
  if (lane == 0) {
    atomicAdd(carry, before_c);
    atomicAdd(carry + 1, before_p);
  }
  int split = 0;
  __syncthreads();
  for (long long sub = lo; sub < hi;
       sub += static_cast<long long>(kScanThreads) * kScanItems) {
    const long long first = sub + static_cast<long long>(threadIdx.x) * kScanItems;
    int c[kScanItems];
    int pieces[kScanItems];
    int sum_c = 0;
    int sum_p = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      c[i] = first + i < hi ? counts[first + i] : 0;
      pieces[i] = (c[i] + kPieceRows - 1) / kPieceRows;
      split += c[i] > kPieceRows;
      sum_c += c[i];
      sum_p += pieces[i];
    }
    const int inc_c = warp_inclusive(sum_c, lane);
    const int inc_p = warp_inclusive(sum_p, lane);
    if (lane == 31) {
      warp_sums[0][warp] = inc_c;
      warp_sums[1][warp] = inc_p;
    }
    __syncthreads();
    if (warp == 0) {
      warp_sums[0][lane] = warp_inclusive(warp_sums[0][lane], lane);
      warp_sums[1][lane] = warp_inclusive(warp_sums[1][lane], lane);
    }
    __syncthreads();
    int at_c = carry[0] + (warp > 0 ? warp_sums[0][warp - 1] : 0) + inc_c - sum_c;
    int at_p = carry[1] + (warp > 0 ? warp_sums[1][warp - 1] : 0) + inc_p - sum_p;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const long long e = first + i;
      if (e < hi) {
        offsets[e] = at_c;
        piece_start[e] = at_p;
        for (int j = 0; j < pieces[i]; ++j) plan[at_p + j] = static_cast<int>(e);
      }
      at_c += c[i];
      at_p += pieces[i];
    }
    __syncthreads();   // every thread has read the carry
    if (threadIdx.x == kScanThreads - 1) {
      carry[0] = at_c;
      carry[1] = at_p;
    }
    __syncthreads();
  }
  const int warp_split = __reduce_add_sync(0xffffffffu, split);
  if (lane == 0 && warp_split != 0) atomicAdd(&split_total, warp_split);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (split_total != 0) atomicAdd(state, static_cast<unsigned long long>(split_total));
    if (hi == entities) {
      offsets[entities] = carry[0];
      piece_start[entities] = carry[1];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const long long* __restrict__ key, Column other, Column rating,
             long long rows, long long entities,
             const int* __restrict__ offsets, const int* __restrict__ rank,
             uint2* __restrict__ pairs) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       r < rows; r += step) {
    const unsigned e = entity_at(key, r, rows, entities);
    if (e != kNoEntity) {
      pairs[__ldg(offsets + e) + __ldg(rank + r)] = make_uint2(other.at(r), rating.at(r));
    }
  }
}

// Factor row `id` of fixed [fixed_rows, K] into v, or zeros where id is no
// row. fixed is 16-byte aligned, so a row of an even (a multiple of four)
// K starts on 8 (16) bytes.
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ fixed,
                                         long long fixed_rows, unsigned id,
                                         float (&v)[K]) {
  if (id >= fixed_rows) {
#pragma unroll
    for (int a = 0; a < K; ++a) v[a] = 0.f;
    return;
  }
  const float* f = fixed + static_cast<long long>(id) * K;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int a = 0; a < K; a += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(f + a));
      v[a] = q.x;
      v[a + 1] = q.y;
      v[a + 2] = q.z;
      v[a + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int a = 0; a < K; a += 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(f + a));
      v[a] = q.x;
      v[a + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int a = 0; a < K; ++a) v[a] = __ldg(f + a);
  }
}

// acc += the lower triangle of v v^T (row-major: entry a(a+1)/2 + b for b
// <= a), then rating * v.
template <int K>
__device__ __forceinline__ void add_row(float (&acc)[K * (K + 1) / 2 + K],
                                        const float (&v)[K], float rating) {
  int t = 0;
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      acc[t] = fmaf(v[a], v[b], acc[t]);
      ++t;
    }
  }
#pragma unroll
  for (int a = 0; a < K; ++a) acc[K * (K + 1) / 2 + a] = fmaf(v[a], rating, acc[K * (K + 1) / 2 + a]);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
piece_kernel(const uint2* __restrict__ pairs, const int* __restrict__ offsets,
             const int* __restrict__ piece_start, const int* __restrict__ plan,
             long long entities, const float* __restrict__ fixed,
             long long fixed_rows, float* __restrict__ partial) {
  constexpr int kEntries = K * (K + 1) / 2 + K;
  const int lane = threadIdx.x & 31;
  const long long p = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (p >= __ldg(piece_start + entities)) return;   // the whole warp
  const int e = __ldg(plan + p);
  const long long first = __ldg(offsets + e)
                          + (p - __ldg(piece_start + e)) * kPieceRows;
  const long long end = min(first + kPieceRows,
                            static_cast<long long>(__ldg(offsets + e + 1)));
  float acc[kEntries];
#pragma unroll
  for (int i = 0; i < kEntries; ++i) acc[i] = 0.f;
  for (long long r = first + lane; r < end; r += 32 * kPieceUnroll) {
    uint2 x[kPieceUnroll];
#pragma unroll
    for (int u = 0; u < kPieceUnroll; ++u) {
      x[u] = r + 32 * u < end ? __ldg(pairs + r + 32 * u) : make_uint2(kNoEntity, 0u);
    }
    float v[kPieceUnroll][K];
#pragma unroll
    for (int u = 0; u < kPieceUnroll; ++u) load_row<K>(fixed, fixed_rows, x[u].x, v[u]);
#pragma unroll
    for (int u = 0; u < kPieceUnroll; ++u) {
      add_row<K>(acc, v[u], x[u].x < fixed_rows ? __uint_as_float(x[u].y) : 0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < kEntries; ++i) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], d);
  }
  float* out = partial + p * kEntries;
#pragma unroll
  for (int i = 0; i < kEntries; ++i) {
    if (i % 32 == lane) out[i] = acc[i];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partial,
               const int* __restrict__ piece_start, long long entities,
               float* __restrict__ ata, float* __restrict__ atr) {
  constexpr int kTriangle = K * (K + 1) / 2;
  constexpr int kEntries = kTriangle + K;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= entities * kEntries) return;
  const long long e = idx / kEntries;
  const int i = static_cast<int>(idx - e * kEntries);
  float sum = 0.f;
  const int last = __ldg(piece_start + e + 1);
  for (int p = __ldg(piece_start + e); p < last; ++p) {
    sum += __ldg(partial + static_cast<long long>(p) * kEntries + i);
  }
  if (i < kTriangle) {
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= i) ++a;
    const int b = i - a * (a + 1) / 2;
    ata[(e * K + a) * K + b] = sum;
    ata[(e * K + b) * K + a] = sum;
  } else {
    atr[e * K + (i - kTriangle)] = sum;
  }
}

struct Args {
  const long long* key;
  long long rows;
  Column other;
  Column rating;
  const float* fixed;
  long long fixed_rows;
  long long entities;
  long long max_pieces;
  int* counts;
  int* offsets;
  int* row_rank;
  int* piece_start;
  int* plan;
  uint2* pairs;
  float* partial;
  float* ata;
  float* atr;
  unsigned long long* state;
  cudaStream_t stream;
};

unsigned blocks_of(long long threads, long long cap) {
  const long long b = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < cap ? (b > 0 ? b : 1) : cap);
}

template <int K>
int launch(const Args& a) {
  constexpr int kEntries = K * (K + 1) / 2 + K;
  cudaError_t err = cudaMemsetAsync(a.counts, 0, a.entities * sizeof(int), a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned pass_blocks = blocks_of(a.rows, kPassBlocks);
  if (a.rows > 0) {
    if (a.entities <= kSmemEntities) {
      const long long spans = (a.rows + kSmemThreads - 1) / kSmemThreads;
      count_smem_kernel<<<static_cast<unsigned>(spans < kSmemBlocks ? spans : kSmemBlocks),
                          kSmemThreads, 0, a.stream>>>(
          a.key, a.rows, static_cast<int>(a.entities), a.counts, a.row_rank);
    } else {
      count_kernel<<<pass_blocks, kThreads, 0, a.stream>>>(a.key, a.rows, a.entities,
                                                           a.counts, a.row_rank);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long scan_tiles = (a.entities + kScanThreads * kScanItems - 1)
                               / (kScanThreads * kScanItems);
  const long long scan_blocks = scan_tiles < kScanBlocks ? scan_tiles : kScanBlocks;
  err = cudaMemsetAsync(a.state, 0, sizeof(unsigned long long), a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(scan_blocks), kScanThreads, 0, a.stream>>>(
      a.counts, a.entities, (a.entities + scan_blocks - 1) / scan_blocks, a.offsets,
      a.piece_start, a.plan, a.state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.rows > 0) {
    place_kernel<<<pass_blocks, kThreads, 0, a.stream>>>(a.key, a.other, a.rating, a.rows,
                                                         a.entities, a.offsets, a.row_rank,
                                                         a.pairs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    piece_kernel<K><<<blocks_of(a.max_pieces * 32, 0x7fffffffLL), kThreads, 0, a.stream>>>(
        a.pairs, a.offsets, a.piece_start, a.plan, a.entities, a.fixed, a.fixed_rows,
        a.partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine_kernel<K><<<blocks_of(a.entities * kEntries, 0x7fffffffLL), kThreads, 0, a.stream>>>(
      a.partial, a.piece_start, a.entities, a.ata, a.atr);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(int rank, const Args& a) {
  if constexpr (K > kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return rank == K ? launch<K>(a) : dispatch<K + 1>(rank, a);
  }
}

}  // namespace

// The normal equations of `rows` rows over `entities` entities at rank
// `rank`: local_key int64 [rows] (contiguous); the other side's ids and the
// ratings' float32 bits as int32 columns, each a pointer and a stride in
// words; fixed float32 [fixed_rows, rank] (contiguous, 16-byte aligned);
// the outputs counts int32 [entities], ata float32 [entities, rank, rank]
// and atr float32 [entities, rank]; scratch offsets and piece_start int32
// [entities + 1], row_rank int32 [rows], plan int32 [max_pieces], pairs
// int64 [rows] (8-byte aligned), partial float32 [max_pieces, rank (rank +
// 1) / 2 + rank] and state int64 [1] (its entry 0 receives the entities of
// more than one piece). max_pieces must be entities + ceil(rows /
// kPieceRows). Refuses (cudaErrorInvalidValue) a rank outside [1,
// kMaxRank], rows past kMaxRows, entities outside [1, kMaxEntities],
// fixed_rows of 2^32 - 1 or more, a stride below 1, another max_pieces,
// or misaligned fixed, pairs or state.
// Returns cudaGetLastError() after each launch.
extern "C" int normal_equations_launch(const void* local_key, long long rows,
                                       const void* other,
                                       long long other_stride,
                                       const void* rating,
                                       long long rating_stride,
                                       const void* fixed,
                                       long long fixed_rows, int rank,
                                       long long entities, void* counts,
                                       void* offsets, void* row_rank,
                                       void* piece_start, void* plan,
                                       long long max_pieces, void* pairs,
                                       void* partial, void* ata, void* atr,
                                       void* state, void* stream) {
  if (rank < 1 || rank > kMaxRank || rows < 0 || rows > kMaxRows
      || entities < 1 || entities > kMaxEntities || fixed_rows < 0
      || fixed_rows >= static_cast<long long>(kNoEntity)
      || other_stride < 1 || rating_stride < 1
      || max_pieces != entities + (rows + kPieceRows - 1) / kPieceRows
      || (reinterpret_cast<uintptr_t>(fixed) & 15) != 0
      || (reinterpret_cast<uintptr_t>(pairs) & 7) != 0
      || (reinterpret_cast<uintptr_t>(state) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const long long*>(local_key),
               rows,
               Column{static_cast<const unsigned*>(other), other_stride},
               Column{static_cast<const unsigned*>(rating), rating_stride},
               static_cast<const float*>(fixed),
               fixed_rows,
               entities,
               max_pieces,
               static_cast<int*>(counts),
               static_cast<int*>(offsets),
               static_cast<int*>(row_rank),
               static_cast<int*>(piece_start),
               static_cast<int*>(plan),
               static_cast<uint2*>(pairs),
               static_cast<float*>(partial),
               static_cast<float*>(ata),
               static_cast<float*>(atr),
               static_cast<unsigned long long*>(state),
               static_cast<cudaStream_t>(stream)};
  return dispatch<1>(rank, a);
}

extern "C" const char* normal_equations_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
