// Merge of key-sorted runs: for every receiver d of received [D, R,
// row_bytes] (R = rows a receiver, column 0 a u32 key), whose rows hold S
// runs back to back, run s at rows [off_s, off_s + counts[d, s]) with off_s
// the exclusive prefix of counts[d], each run sorted by key:
//
// - out rows [0, L), L = min(sum of counts[d], R), are the stable merge of
//   the runs by key: ties go to the lower run, then the lower position
//   (a run's end is clamped at R, so a receive past R stays in bounds);
// - out rows [L, R) are pad rows: word 0 is 0xFFFFFFFF, the rest zero.
//
// That is what a stable key sort of the whole buffer with rows past the
// total keyed 0xFFFFFFFF yields (parallel/device_plane.py's
// sort_received), given the zero rows that every transport leaves past
// the total: the range step's receive side, whose sources key-sort their
// rows before the range split hands each receiver one sorted run a
// source. Replaces no Pallas kernel: the JAX package sorts the received
// rows with XLA's sort.
//
// What bounds it: bytes. Each live row is read once and every output row
// written once, (L + R) * row_bytes a receiver over the card's memory rate
// (H100 SXM: 3.35 TB/s); TeraSort at HiBench large is 9.6 GB a job, 2.87 ms,
// where the stable radix sort of the padded buffer and its row gather
// took 19.6 ms. The design:
//
// - Output tiles. Each receiver's output is cut into tiles of kTileRows
//   rows; a tile's live rows come from one contiguous segment of each run,
//   bounded by the co-ranks of the tile's first and last position.
// - Co-rank pass (corank_kernel): for every tile boundary p < L, the
//   co-ranks c_s(p), sum c_s = p, under the (key, run, position) order.
//   A group of lanes (one lane a run) finds the key
//   of rank p, v* = max{v : #(keys < v) <= p}, bit by bit from the top;
//   each lane keeps the bracket of its run in which the count below the
//   next candidate lies, so a run is searched only inside what the
//   earlier bits left. Then the p - #(keys < v*) rows of key v*
//   go to the runs in run order. Keys are read from column 0 of the rows,
//   one 32-byte sector a probe; a boundary is a few hundred probes.
// - Merge pass (merge_kernel), one block a tile: load the tile's keys from
//   the S segments into shared memory (one sector a row, which the copy
//   then finds in the L2), rank each key inside the tile by binary
//   searches of the other segments in shared memory, and write the source
//   row of each output row to its rank. Then copy: the tile's output is
//   one contiguous run of rows, cut into V-byte chunks; lane l takes chunks
//   l, l + 32, ..., loads kUnroll of them, then stores them, so stores are
//   contiguous and loads come from S sequential streams. V is the largest
//   of 16, 8, 4 dividing the row bytes and both bases (the wrapper
//   chooses it, as for the row gather): 4 at TeraSort's 100-byte rows.
// - Pad rows are written without any reads: a tile past L only stores.
//
// Measured on an H100 at HiBench large's receive ([8, 8M, 25], 9.6 GB):
// tiles of 1024 rows and blocks of 512 threads ran 4.50 ms against 4.84
// at 2048 and 256 (4.56 at 2048 and 512; blocks of 1024 threads 5.26).
// Slower there: copying in input order and scattering the stores to the
// ranks (9.3 ms: partial-sector writes), staging each 256 output rows in
// shared memory so that loads run in input order too (5.67 ms: a quarter
// of the blocks an SM holds), and ranking by galloping from the last
// bound (no faster: the ranking's searches are not what the copy waits
// on).
//
// Runs that are not sorted (the counts of a slot transport's flagged
// pair overflow, whose runs lie elsewhere) give no merge, but stay in
// bounds. A co-rank lies inside its run, and c_s(p) is monotone in p with
// sum c_s(p) = p whatever the keys: two boundaries take the same bits of
// v* down to the first bit where the larger takes and the smaller does
// not, and from there each run's co-rank for the smaller is at most the
// probe that split them and for the larger at least it. So a tile's
// segments hold its live rows, and ranks lie inside the tile; only two
// rows of unsorted segments may share a rank, and an output row that no
// rank reaches copies the buffer's row at its own position. Every output
// row is then a row of the receiver's buffer or a pad row.
//
// The counts are read on the card: nothing comes back to the host, the
// launch is the same for every count matrix, and the wrapper allocates the
// output and the co-rank scratch ([D, tiles + 1, S] int32) with
// torch.empty. Runs on the caller's stream, allocates nothing and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 1024;      // output rows a merge block takes
constexpr int kMaxRuns = 32;         // S: runs a receiver, one a lane
constexpr int kThreads = 512;
constexpr long long kMaxRows = 0x7fffffffLL - kTileRows;  // R
constexpr long long kMaxRowChunks = 1LL << 20;  // chunks a row: T * that < 2^31

template <int V> struct Word;
template <> struct Word<16> {
  using T = uint4;
  static constexpr int kUnroll = 2;
  __device__ static T pad_head() { return make_uint4(0xffffffffu, 0, 0, 0); }
  __device__ static T zero() { return make_uint4(0, 0, 0, 0); }
};
template <> struct Word<8> {
  using T = uint2;
  static constexpr int kUnroll = 4;
  __device__ static T pad_head() { return make_uint2(0xffffffffu, 0); }
  __device__ static T zero() { return make_uint2(0, 0); }
};
template <> struct Word<4> {
  using T = unsigned int;
  static constexpr int kUnroll = 8;
  __device__ static T pad_head() { return 0xffffffffu; }
  __device__ static T zero() { return 0; }
};

// n / divisor for n < 2^31 and 1 <= divisor < 2^31, as in row_gather.cu
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

__device__ __forceinline__ unsigned key_at(const char* rows, long long row,
                                           long long row_bytes) {
  return __ldg(reinterpret_cast<const unsigned*>(rows + row * row_bytes));
}

// The first position in [lo, hi) of the run at row `first` whose key is
// not below v (hi if none): the ends first, so a bracket wholly on one
// side of v costs one or two probes.
__device__ int lower_in_run(const char* rows, long long first, int lo,
                            int hi, unsigned v, long long row_bytes) {
  if (lo >= hi || key_at(rows, first + lo, row_bytes) >= v) return lo;
  if (key_at(rows, first + hi - 1, row_bytes) < v) return hi;
  int l = lo, h = hi - 1;  // key(l) < v <= key(h)
  while (h - l > 1) {
    const int m = l + ((h - l) >> 1);
    if (key_at(rows, first + m, row_bytes) < v) l = m; else h = m;
  }
  return h;
}

// Run `lane` of receiver d (none past `runs`): its first row and length,
// clamped at rows. Every lane of the warp calls it; `group` lanes (a power
// of two up to 32) share a receiver, lane = the lane's place in its group.
__device__ void run_bounds(const int* counts, int runs, long long rows,
                           int lane, int group, long long* start, int* len) {
  const long long c = lane < runs ? max(counts[lane], 0) : 0;
  long long incl = c;  // inclusive scan over the group's lanes
  for (int off = 1; off < group; off <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, incl, off, group);
    if (lane >= off) incl += up;
  }
  *start = min(incl - c, rows);
  *len = static_cast<int>(min(incl, rows) - *start);
}

__device__ __forceinline__ long long group_sum(long long v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off, group);
  }
  return v;
}

// One group of `group` lanes a boundary: co[d][t][s] = c_s(min(t * T, L))
// for t in [0, tiles]. Every lane of the grid runs the same loop (the
// shuffles need the whole warp); a lane past the last boundary or the last
// run, or of a boundary at 0 or at or past L, keeps an empty bracket and
// makes no probe. Each co-rank lies in [0, its run's length].
__global__ void __launch_bounds__(kThreads)
corank_kernel(const char* __restrict__ received,
              const int* __restrict__ counts, int* __restrict__ co,
              long long receivers, long long rows, int runs, int tiles,
              long long row_bytes, int group) {
  const long long gid = (static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x);
  const int lane = static_cast<int>(threadIdx.x) & (group - 1);
  const long long boundary = gid / group;
  const bool active = boundary < receivers * (tiles + 1);
  const long long d = active ? boundary / (tiles + 1) : 0;
  const int t = active ? static_cast<int>(boundary % (tiles + 1)) : 0;
  long long start;
  int len;
  run_bounds(counts + d * runs, runs, rows, lane, group, &start, &len);
  const long long live = group_sum(len, group);
  const long long p = min(static_cast<long long>(t) * kTileRows, live);
  const bool search = active && p > 0 && p < live;
  const char* base = received + d * rows * row_bytes;
  int lo = p >= live ? len : 0;
  int hi = search || p >= live ? len : 0;
  unsigned cur = 0;
  for (int b = 31; b >= 0; --b) {
    const unsigned cand = cur | (1u << b);
    const int m = lower_in_run(base, start, lo, hi, cand, row_bytes);
    const bool take = group_sum(m, group) <= p;
    if (take) {
      cur = cand;
      lo = m;
    } else {
      hi = m;
    }
  }
  // lo = #keys < v*, hi = #keys <= v*: the p - sum(lo) rows of key v* go
  // to the runs in run order
  const long long rest = p - group_sum(lo, group);
  const int eq = hi - lo;
  int incl = eq;
  for (int off = 1; off < group; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off, group);
    if (lane >= off) incl += up;
  }
  const long long take = min(static_cast<long long>(eq),
                             max(0LL, rest - (incl - eq)));
  if (active && lane < runs) {
    co[(d * (tiles + 1) + t) * runs + lane] = static_cast<int>(lo + take);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const char* __restrict__ received,
             const int* __restrict__ counts, const int* __restrict__ co,
             char* __restrict__ out, long long rows, int runs, int tiles,
             long long row_bytes, FastDiv per_row) {
  using T = typename Word<V>::T;
  constexpr int kUnroll = Word<V>::kUnroll;
  __shared__ unsigned keys[kTileRows];
  __shared__ int source[kTileRows];     // the row each output row copies
  __shared__ unsigned char seg_of[kTileRows];
  __shared__ int seg_off[kMaxRuns + 1];  // the tile's segments, packed
  __shared__ long long seg_first[kMaxRuns];  // their first rows
  __shared__ int tile_live;

  const long long d = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x % tiles);
  const long long p0 = static_cast<long long>(t) * kTileRows;
  const int n = static_cast<int>(min(rows - p0,
                                     static_cast<long long>(kTileRows)));
  const char* base = received + d * rows * row_bytes;
  if (threadIdx.x < 32) {
    // run `lane`'s segment: rows [c_s(p0), c_s(p0 + T)) of the run; the
    // segments hold the tile's live rows
    const int lane = threadIdx.x;
    long long start;
    int len;
    run_bounds(counts + d * runs, runs, rows, lane, 32, &start, &len);
    const long long all = group_sum(len, 32);
    const int live = static_cast<int>(max(0LL, min(all - p0,
                                                   static_cast<long long>(n))));
    const int* c0 = co + (d * (tiles + 1) + t) * runs;
    const bool mine = lane < runs && live > 0;
    const int first = mine ? c0[lane] : 0;
    const int m = mine ? c0[runs + lane] - first : 0;
    int incl = m;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane < runs) {
      seg_off[lane] = incl - m;
      seg_first[lane] = start + first;
    }
    if (lane == 31) {
      seg_off[runs] = incl;
      tile_live = live;
    }
  }
  __syncthreads();
  const int live = tile_live;
  if (live > 0) {
    for (int j = threadIdx.x; j < live; j += kThreads) {
      source[j] = static_cast<int>(p0 + j);  // where no rank lands
      int lo = 0, hi = runs;  // the last segment with seg_off <= j
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (seg_off[mid] <= j) lo = mid; else hi = mid;
      }
      seg_of[j] = static_cast<unsigned char>(lo);
      keys[j] = key_at(base, seg_first[lo] + (j - seg_off[lo]), row_bytes);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < live; j += kThreads) {
      const int s = seg_of[j];
      const unsigned key = keys[j];
      int rank = j - seg_off[s];
      for (int r = 0; r < runs; ++r) {
        if (r == s) continue;
        // keys of segment r before this one: <= key for an earlier run,
        // < key for a later one
        int lo = seg_off[r], hi = seg_off[r + 1];
        const int first = lo;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const bool before = r < s ? keys[mid] <= key : keys[mid] < key;
          if (before) lo = mid + 1; else hi = mid;
        }
        rank += lo - first;
      }
      source[rank] = static_cast<int>(seg_first[s] + (j - seg_off[s]));
    }
    __syncthreads();
  }
  const unsigned chunks = static_cast<unsigned>(n) * per_row.divisor;
  T* o = reinterpret_cast<T*>(out + (d * rows + p0) * row_bytes);
  for (unsigned c0 = 0; c0 < chunks; c0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned c = c0 + u * kThreads + threadIdx.x;
      if (c < chunks) {
        const unsigned row = div_of(c, per_row);
        const unsigned w = c - row * per_row.divisor;
        if (static_cast<int>(row) < live) {
          v[u] = __ldg(reinterpret_cast<const T*>(
              base + static_cast<long long>(source[row]) * row_bytes
              + static_cast<long long>(w) * V));
        } else {
          v[u] = w == 0 ? Word<V>::pad_head() : Word<V>::zero();
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned c = c0 + u * kThreads + threadIdx.x;
      if (c < chunks) o[c] = v[u];
    }
  }
}

template <int V>
int launch(const void* received, const void* counts, void* out, void* co,
           long long receivers, long long rows, int runs, long long row_bytes,
           cudaStream_t stream) {
  const int tiles = static_cast<int>((rows + kTileRows - 1) / kTileRows);
  int group = 1;
  while (group < runs && group < 32) group <<= 1;
  const long long lanes = receivers * (tiles + 1) * group;
  corank_kernel<<<static_cast<unsigned>((lanes + kThreads - 1) / kThreads),
                  kThreads, 0, stream>>>(
      static_cast<const char*>(received), static_cast<const int*>(counts),
      static_cast<int*>(co), receivers, rows, runs, tiles, row_bytes, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<V><<<static_cast<unsigned>(receivers * tiles), kThreads, 0,
                    stream>>>(
      static_cast<const char*>(received), static_cast<const int*>(counts),
      static_cast<const int*>(co), static_cast<char*>(out), rows, runs, tiles,
      row_bytes, fast_div(static_cast<unsigned>(row_bytes / V)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The merge of `receivers` receive buffers: received and out [receivers,
// rows, row_bytes], counts int32 [receivers, runs], co int32 [receivers,
// ceil(rows / kTileRows) + 1, runs] scratch (device, contiguous), vec_bytes
// (4, 8 or 16) dividing row_bytes and both row bases. A negative count
// counts as 0. Refuses (cudaErrorInvalidValue) anything else, runs outside
// [1, kMaxRuns], rows past kMaxRows, 2^20 or more chunks a row, or a grid
// past 2^31 blocks; an empty merge launches nothing. Returns
// cudaGetLastError() after each launch.
extern "C" int run_merge_launch(const void* received, const void* counts,
                                void* out, void* co, long long receivers,
                                long long rows, long long runs,
                                long long row_bytes, int vec_bytes,
                                void* stream) {
  const bool vec_ok = vec_bytes == 4 || vec_bytes == 8 || vec_bytes == 16;
  if (receivers < 0 || rows < 0 || runs < 1 || runs > kMaxRuns
      || row_bytes < 4 || !vec_ok
      || ((reinterpret_cast<uintptr_t>(received)
           | reinterpret_cast<uintptr_t>(out)
           | static_cast<uintptr_t>(row_bytes))
          & static_cast<uintptr_t>(vec_bytes - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (receivers == 0 || rows == 0) return static_cast<int>(cudaSuccess);
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  if (rows > kMaxRows || row_bytes / vec_bytes >= kMaxRowChunks
      || receivers * tiles > 0x7fffffffLL
      || receivers * (tiles + 1) * 32 / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(runs);
  switch (vec_bytes) {
    case 16: return launch<16>(received, counts, out, co, receivers, rows, r,
                               row_bytes, s);
    case 8: return launch<8>(received, counts, out, co, receivers, rows, r,
                             row_bytes, s);
    default: return launch<4>(received, counts, out, co, receivers, rows, r,
                              row_bytes, s);
  }
}

extern "C" const char* run_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
