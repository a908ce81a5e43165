// Row gather over the virtual mesh: out[d, k] = rows[d, idx[d, k]] for
// every shard d of rows [D, N, row_bytes] and indices [D, K] (int32 or
// int64), out [D, K, row_bytes]. The port's per-shard take
// (parallel/mesh.py::take_rows), under every grouping, sort and landing of
// the device plane.
//
// Replaces no Pallas kernel: the JAX package leaves its per-shard
// jnp.take to XLA's gather. It was added because PyTorch's index_select
// runs such a gather one picked row per thread block: for rows that are a
// multiple of 16 bytes a block is one warp in which each lane moves 16
// bytes, so a row of 32 bytes keeps 2 of 32 lanes busy, loads its index,
// then its row, and retires. Bound by how fast the SMs start and retire
// blocks, that gather ran at 3.5% of its byte bound at q95's 8-word rows
// on an H100.
//
// What bounds it: bytes. Each picked row is read and written once and
// its index read once, D*K*(2*row_bytes + index_bytes) bytes over the
// card's memory rate (H100 SXM: 3.35 TB/s); rows picked at random cost
// more, since a row's bytes share their 32-byte sectors with its
// neighbours'. The design:
//
// - Flat over output chunks, 32 rows a warp or more. out is D*K rows of
//   row_bytes, cut into chunks of V bytes. A warp takes a run of 32 * G
//   output rows at a time, one contiguous run of 32 * G * row_bytes: lane
//   l loads the indices of rows l, l + 32, ... (G coalesced loads of 32
//   indices, all in flight together) and writes their source bases,
//   (d*N + idx[r]) * row_bytes for row r of shard d = r / K, to the warp's
//   slice of shared memory. Chunk c of the run belongs to row c /
//   (row_bytes / V) and reads that row's base plus (c mod (row_bytes /
//   V)) * V. Lane l takes chunks l, l + 32, ...: neighbouring lanes store
//   neighbouring V-byte words, the lanes of one row read together, and a
//   warp moves 16 rows of 32 bytes in one load where index_select moved
//   one.
// - G gives narrow rows as many chunks in flight as wide ones: a lane
//   loads kUnroll chunks before it stores them, and a run of 32 rows of
//   fewer than kUnroll chunks each would leave most of them idle (one
//   row in flight a lane at rows of one chunk). G = kUnroll / (chunks a
//   row), at least 1: 1-word rows run 256 to a warp, q95's 32-byte rows
//   and TeraSort's 100-byte rows 32. Measured on an H100 against runs of
//   32 rows: 1-word rows grouped as q95's web_returns are 0.0122 -> 0.0065
//   ms (index_select over a ready index: 0.0071), ALS's 3-word gathers of
//   one exchange 14.07 -> 9.99 ms (the plain arange and index_select:
//   16.50).
// - V adapts to the input's shape: the largest of 16, 8, 4, 2, 1 that
//   divides the row bytes and both tensors' base addresses (the wrapper
//   chooses it; the launch refuses one that does not divide them). q95's
//   fact rows of 32 bytes move as 16-byte vectors, TeraSort's 100-byte
//   rows as 4-byte words.
// - Enough bytes in flight: a grid of the blocks an SM holds at once
//   (Word<V>::kMinBlocks, which also caps the registers) strides over
//   the runs; each lane loads kUnroll chunks of a run, then stores them,
//   and the index of a run's rows is loaded once for all their chunks.
//   The divisions by the launch's constants (chunks a row, rows a shard)
//   are a multiply-high and a shift (FastDiv), not hardware divides.
//   Measured on an H100 against one index load a chunk (each thread
//   kUnroll chunks a grid's width apart): equal at q95's 32-byte rows; at
//   TeraSort's 100-byte rows 62% of the byte bound against 42%, where
//   index_select reads 53%.
// - An index outside [0, N) is the caller's bug, as for index_select: the
//   kernel traps before it would read out of bounds.
//
// A launch covers fewer than 2^31 rows of fewer than 2^26 chunks each (a
// run of more than 32 rows has rows of fewer than kUnroll chunks), so a
// row's number, a chunk's place in its run and the divisions fit 32
// bits; the wrapper cuts larger gathers into launches over shards, or over
// a shard's indices. It runs on the caller's stream, allocates nothing
// and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxRows = 0x7fffffffLL;  // rows a launch covers
constexpr long long kMaxRowChunks = 1LL << 26;  // chunks a row: 32 < 2^31
constexpr int kMaxDevices = 64;

// The word a lane moves at a time; kUnroll, the chunks a lane loads
// before it stores them (a run of 32 rows of 32 bytes is two 16-byte
// vectors a lane), and the most row groups G a run takes; kMinBlocks, the
// blocks an SM must hold, which caps the registers and sizes the grid
// (measured: 4-byte words at 8 a lane ran faster at 4 blocks an SM than
// at 6)
template <int V> struct Word;
template <> struct Word<16> {
  using T = uint4;
  static constexpr int kUnroll = 2;
  static constexpr int kMinBlocks = 8;
};
template <> struct Word<8> {
  using T = uint2;
  static constexpr int kUnroll = 4;
  static constexpr int kMinBlocks = 8;
};
template <> struct Word<4> {
  using T = unsigned int;
  static constexpr int kUnroll = 8;
  static constexpr int kMinBlocks = 4;
};
template <> struct Word<2> {
  using T = unsigned short;
  static constexpr int kUnroll = 8;
  static constexpr int kMinBlocks = 4;
};
template <> struct Word<1> {
  using T = unsigned char;
  static constexpr int kUnroll = 8;
  static constexpr int kMinBlocks = 4;
};

// n / divisor for n < 2^31 and 1 <= divisor < 2^31: with l = ceil(log2
// divisor), mul = ceil(2^(31+l) / divisor) < 2^32 and the quotient is
// (n * mul) >> (31 + l); its error (mul*divisor - 2^(31+l)) * n stays
// below 2^(31+l), so it is exact.
struct FastDiv {
  unsigned divisor;
  unsigned mul;
  unsigned shift;
};

FastDiv fast_div(unsigned divisor) {
  FastDiv f = {divisor, 0, 0};
  if (divisor > 1) {
    unsigned l = 0;
    while ((1ULL << l) < divisor) ++l;
    f.mul = static_cast<unsigned>(((1ULL << (31 + l)) + divisor - 1)
                                  / divisor);
    f.shift = l - 1;
  }
  return f;
}

__device__ __forceinline__ unsigned div_of(unsigned n, const FastDiv& f) {
  return f.divisor == 1 ? n : __umulhi(n, f.mul) >> f.shift;
}

template <typename Index, int V>
__global__ void __launch_bounds__(kThreads, Word<V>::kMinBlocks)
row_gather_kernel(const char* __restrict__ rows,
                  const Index* __restrict__ idx, char* __restrict__ out,
                  unsigned total_rows, FastDiv per_row, FastDiv per_shard,
                  long long n, long long row_bytes, unsigned groups) {
  using T = typename Word<V>::T;
  constexpr int kUnroll = Word<V>::kUnroll;
  __shared__ long long bases[kWarps][32 * kUnroll];
  const unsigned lane = threadIdx.x & 31;
  long long* base = bases[threadIdx.x / 32];
  const unsigned run_rows = 32 * groups;
  const unsigned runs = (total_rows + run_rows - 1) / run_rows;
  for (unsigned run = (blockIdx.x * kThreads + threadIdx.x) / 32;
       run < runs; run += gridDim.x * kWarps) {
    const unsigned first = run * run_rows;
    Index at[kUnroll];
#pragma unroll
    for (int g = 0; g < kUnroll; ++g) {
      const unsigned r = first + g * 32 + lane;
      at[g] = static_cast<unsigned>(g) < groups && r < total_rows ? __ldg(idx + r) : Index(0);
    }
#pragma unroll
    for (int g = 0; g < kUnroll; ++g) {
      if (static_cast<unsigned>(g) < groups) {
        const unsigned r = first + g * 32 + lane;
        if (static_cast<unsigned long long>(at[g])
            >= static_cast<unsigned long long>(n)) {
          __trap();
        }
        base[g * 32 + lane] =
            (static_cast<long long>(div_of(r, per_shard)) * n + at[g])
            * row_bytes;
      }
    }
    __syncwarp();
    const unsigned chunks = min(run_rows, total_rows - first)
                            * per_row.divisor;
    T* o = reinterpret_cast<T*>(out + static_cast<long long>(first)
                                * row_bytes);
    for (unsigned c0 = 0; c0 < chunks; c0 += 32 * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned c = c0 + u * 32 + lane;
        if (c < chunks) {
          const unsigned row = div_of(c, per_row);
          v[u] = __ldg(reinterpret_cast<const T*>(
              rows + base[row]
              + static_cast<long long>(c - row * per_row.divisor) * V));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned c = c0 + u * 32 + lane;
        if (c < chunks) o[c] = v[u];
      }
    }
    __syncwarp();  // the bases stay until every lane has read them
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 132;
  }
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess || n < 1) {
      return 132;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename Index, int V>
void launch(const void* rows, const void* idx, void* out, unsigned total,
            long long k, long long n, long long row_bytes,
            cudaStream_t stream) {
  constexpr long long kUnroll = Word<V>::kUnroll;
  const long long per_row = row_bytes / V;
  const long long groups = per_row >= kUnroll ? 1 : kUnroll / per_row;
  const long long runs = (total + 32 * groups - 1) / (32 * groups);
  long long blocks = (runs + kWarps - 1) / kWarps;
  const long long most = static_cast<long long>(sm_count())
                         * Word<V>::kMinBlocks;
  if (blocks > most) blocks = most;
  row_gather_kernel<Index, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
      static_cast<const char*>(rows), static_cast<const Index*>(idx),
      static_cast<char*>(out), total,
      fast_div(static_cast<unsigned>(per_row)),
      fast_div(static_cast<unsigned>(k)), n, row_bytes,
      static_cast<unsigned>(groups));
}

template <typename Index>
void launch_index(const void* rows, const void* idx, void* out,
                  unsigned total, long long k, long long n,
                  long long row_bytes, int vec_bytes, cudaStream_t stream) {
  switch (vec_bytes) {
    case 16: launch<Index, 16>(rows, idx, out, total, k, n, row_bytes,
                               stream); break;
    case 8: launch<Index, 8>(rows, idx, out, total, k, n, row_bytes,
                             stream); break;
    case 4: launch<Index, 4>(rows, idx, out, total, k, n, row_bytes,
                             stream); break;
    case 2: launch<Index, 2>(rows, idx, out, total, k, n, row_bytes,
                             stream); break;
    default: launch<Index, 1>(rows, idx, out, total, k, n, row_bytes,
                              stream); break;
  }
}

}  // namespace

// The gather of num_shards shards: rows [num_shards, num_rows, row_bytes]
// and out [num_shards, num_picked, row_bytes] (device, contiguous), idx
// [num_shards, num_picked] of index_bytes (4: int32, 8: int64) each,
// vec_bytes (1, 2, 4, 8 or 16) dividing row_bytes and both bases. Refuses
// (cudaErrorInvalidValue) anything else, num_shards * num_picked rows of
// 2^31 or more, or 2^26 or more chunks a row; an empty gather launches
// nothing. Returns cudaGetLastError() after the launch.
extern "C" int row_gather_launch(const void* rows, const void* idx,
                                 void* out, long long num_shards,
                                 long long num_rows, long long num_picked,
                                 long long row_bytes, int index_bytes,
                                 int vec_bytes, void* stream) {
  const bool vec_ok = vec_bytes == 1 || vec_bytes == 2 || vec_bytes == 4
                      || vec_bytes == 8 || vec_bytes == 16;
  if (num_shards < 0 || num_rows < 0 || num_picked < 0 || row_bytes < 0
      || (index_bytes != 4 && index_bytes != 8) || !vec_ok
      || ((reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(
               out) | static_cast<uintptr_t>(row_bytes))
          & static_cast<uintptr_t>(vec_bytes - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_shards == 0 || num_picked == 0 || row_bytes == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (num_rows == 0 || num_shards > kMaxRows || num_picked > kMaxRows
      || num_shards * num_picked > kMaxRows
      || row_bytes / vec_bytes >= kMaxRowChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned total = static_cast<unsigned>(num_shards * num_picked);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) {
    launch_index<long long>(rows, idx, out, total, num_picked, num_rows,
                            row_bytes, vec_bytes, s);
  } else {
    launch_index<int>(rows, idx, out, total, num_picked, num_rows,
                      row_bytes, vec_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
