// Unique-key lookup of the query plans' joins: for every shard s of a
// dimension side [D, M] and a probe side [D, P], each live probe of shard s
// is answered by the live dimension row of shard s with an equal key, the
// one of lowest row index where several are; then
//
// - found [D, P] (bool): whether such a row exists;
// - attr [D, P] (int64, optional): that row's attribute word zero-extended,
//   and 0 where none is found.
//
// A key is one u32 word or two (high, low), read in place from strided
// int32 views of the received rows. A row is live where its valid byte is
// set (or no mask is given) and its key is a key: a two-word key only where
// its high word lies below 2^31 - 1 (q64's item words; a dead row's PAD
// item is not one), a one-word key only where it is not 0xFFFFFFFF (the
// "no row" word). That is the stable sort of the masked keys and the
// binary search of the probes that ops/sort.py's lookup_unique computes
// (the plain version in ops/hash_lookup.py), except that a probe it does
// not find takes attr 0 here where the search gives its neighbour's.
// Replaces no Pallas kernel: the JAX package sorts and searches with XLA
// (sparkrdma_tpu/models/tpcds_queries.py, _lookup), and so did the port,
// radix-sorting the whole padded dimension buffer as int64 (eight digit
// passes) and binary-searching every probe slot.
//
// What bounds it: the live rows' random table accesses, and the bytes
// every row costs. A pad row costs its valid byte and, on the probe side,
// the found byte and attr word written; a live row its key words, one
// random 16-byte slot (usually one 32-byte sector) a probe step, and a
// live probe that is found one random attribute word. q64's store join
// ([8, 14,400,496] slots a side, 2.5% of the dimension's and 25% of the
// probes' live) reads 0.48 GB of valid bytes and key words and writes
// 0.12 GB of found bytes: 0.18 ms at 3.35 TB/s.
//
// The design:
//
// - One table a call, open addressing with linear probing, shared by the
//   D shards: the shard is mixed into the hash and checked on a match (a
//   slot's row number r lies in [s * M, (s + 1) * M) for shard s). Its
//   size is a power of two of at least twice the caller's bound on the
//   live dimension rows (the wrapper's table_slots), so it is at most half
//   full. A slot holds the 64-bit key and the 32-bit row number, 16 bytes
//   aligned, so one vector load reads it. Nothing is kept across calls.
// - clear_kernel writes every slot empty (row 0xFFFFFFFF).
// - build_kernel, one thread a row, kRowsPerThread rows a thread: a live
//   row claims the first slot on its probe path whose row is empty, by a
//   compare-and-swap of its row number, then stores its key. A slot
//   already held by a row of the same shard with an equal key (read from
//   that row's own key words, so no thread waits for another's key store)
//   takes the lower row number by atomicMin, as the stable sort puts the
//   lower row first. A key moves at most kMaxProbe slots from its home;
//   at half load that is never reached (the chance falls as e^(-0.19 k)).
// - probe_kernel, the same grid over the probes: each thread loads the
//   keys of its rows and their home slots first, so those loads overlap,
//   then walks each live key's path to an empty slot or its match, and
//   writes found and attr for every row, pads included.
// - Overflow. The bound is the caller's (the rows the dimension side sent,
//   known from shapes): each warp adds its live rows to state[0], and the
//   sum passing the bound, or a key finding no slot within kMaxProbe,
//   sets state[1]. The build then stops inserting and the probe pass
//   answers nothing, so a flagged call neither hangs nor writes out of
//   bounds; the step ORs the flag into its overflowed, as a shuffle's.
// - Counters. With count set, each warp adds its live probes to state[2]
//   and those found to state[3] (the lookup.probes and lookup.found
//   counters, read while profiled).
//
// Measured on an H100 (700 W), at q64's four lookups at SF10: the store
// join ([8, 14,400,496] a side, 359,429 live returns and 3,600,124 live
// sales a shard, no attribute) 2.03 ms, the catalog join ([8, 7,200,632],
// 179,969 and 1,800,158 live, with the refund) 1.09, the date join
// (9,132 live dates a shard against 359,429 live probes in 14,400,496
// slots) 0.63, the cs_ui semi-join (12,750 live items against 240,000)
// 0.51; the int64 sort and search did the store join in 32.95 ms. Four
// rows a thread and 8 resident blocks an SM (32 registers; the two-word
// probe spills 36 bytes) won over 4 x 4 (2.06 ms at the store join), 2
// x 8 (2.16), 8 x 4 (2.41), 8 x 3 (2.40) and 16 x 2 (3.48): the probes
// wait on random table reads, so resident warps count more than rows a
// thread. The bytes bound (every valid byte, each live row's key words,
// each found byte and attribute written, at 3.35 TB/s) is 0.18 ms at the
// store join; the random 32-byte table sectors (one or two a live
// probe, the 128 MB table past the 50 MB L2) are most of the rest.
//
// Nothing comes back to the host: the launch depends on the shapes alone.
// The wrapper allocates the table ([slots, 2] int64), the state (int64
// [4], zeroed) and the outputs with torch; runs on the caller's stream,
// allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;   // rows a block
constexpr int kMinBlocks = 8;       // blocks an SM keeps resident: 32 registers a thread
constexpr int kMaxProbe = 1024;     // slots a key may lie past its home
constexpr unsigned kEmpty = 0xffffffffu;       // a slot's row when empty
constexpr unsigned kHighLimit = 0x7fffffffu;   // a two-word key's high word lies below
constexpr unsigned kNoKey = 0xffffffffu;       // never a one-word key
constexpr long long kMaxRows = 0xfffffffeLL;   // D * M: row numbers below kEmpty
constexpr int kClearBlocks = 132 * 8;

struct alignas(16) Slot {
  unsigned long long key;
  unsigned row;
  unsigned unused;
};

// An int32 view [D, N]: word (s, r) at ptr[s * shard + r * row].
struct Words {
  const unsigned* ptr;
  long long shard;
  long long row;

  __device__ __forceinline__ unsigned at(long long s, long long r) const {
    return __ldg(ptr + s * shard + r * row);
  }
};

// Row r of shard s's key, and whether it is a key (see the header).
template <int kWords>
__device__ __forceinline__ bool key_at(const Words& hi, const Words& lo,
                                       long long s, long long r,
                                       unsigned long long* key) {
  if (kWords == 2) {
    const unsigned h = hi.at(s, r);
    *key = (static_cast<unsigned long long>(h) << 32) | lo.at(s, r);
    return h < kHighLimit;
  }
  const unsigned w = lo.at(s, r);
  *key = w;
  return w != kNoKey;
}

// Whether row r of shard s is live: in range, valid, and a key.
template <int kWords>
__device__ __forceinline__ bool live_at(const Words& hi, const Words& lo,
                                        const unsigned char* valid,
                                        long long s, long long r,
                                        long long rows,
                                        unsigned long long* key) {
  if (r >= rows) return false;
  if (valid != nullptr && !__ldg(valid + s * rows + r)) return false;
  return key_at<kWords>(hi, lo, s, r, key);
}

// The key's home slot in shard s's share of the hash (a 64-bit mix, the
// finaliser of MurmurHash3).
__device__ __forceinline__ unsigned long long home_of(unsigned long long key,
                                                      long long s,
                                                      unsigned long long mask) {
  unsigned long long h =
      key ^ (static_cast<unsigned long long>(s + 1) * 0x9e3779b97f4a7c15ULL);
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h & mask;
}

__device__ __forceinline__ Slot load_slot(const Slot* table,
                                          unsigned long long pos) {
  const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(table + pos));
  return Slot{v.x, static_cast<unsigned>(v.y), 0u};
}

// Adds the warp's `n`s to state[word], one atomic from lane 0. Returns
// state[word] after the add on lane 0 (0 where the warp adds nothing), 0
// on the other lanes. Every lane of the warp calls it.
__device__ __forceinline__ unsigned long long warp_add(
    unsigned long long* state, int word, int n) {
  const unsigned total = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(n));
  if ((threadIdx.x & 31) != 0 || total == 0) return 0;
  return atomicAdd(state + word, static_cast<unsigned long long>(total)) + total;
}

__global__ void clear_kernel(Slot* __restrict__ table, long long slots) {
  const uint4 empty = make_uint4(0xffffffffu, 0xffffffffu, kEmpty, 0u);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < slots; i += static_cast<long long>(gridDim.x) * kThreads) {
    reinterpret_cast<uint4*>(table)[i] = empty;
  }
}

template <int kWords>
__device__ bool insert(Slot* table, unsigned long long mask, int max_probe,
                       const Words& hi, const Words& lo, long long s,
                       long long rows, unsigned long long key, unsigned row) {
  const unsigned base = static_cast<unsigned>(s * rows);
  unsigned long long pos = home_of(key, s, mask);
  for (int step = 0; step < max_probe; ++step) {
    Slot* slot = table + pos;
    const unsigned held = atomicCAS(&slot->row, kEmpty, row);
    if (held == kEmpty) {
      slot->key = key;
      return true;
    }
    // held by a row of this shard (unsigned: a row below base wraps past
    // rows, since D * M < 2^32) whose key is this one
    if (static_cast<unsigned long long>(held - base)
        < static_cast<unsigned long long>(rows)) {
      unsigned long long other;
      key_at<kWords>(hi, lo, s, held - base, &other);
      if (other == key) {
        atomicMin(&slot->row, row);
        return true;
      }
    }
    pos = (pos + 1) & mask;
  }
  return false;
}

template <int kWords>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
build_kernel(Words hi, Words lo, const unsigned char* __restrict__ valid,
             long long rows, Slot* __restrict__ table,
             unsigned long long mask, int max_probe,
             unsigned long long bound, unsigned long long* state) {
  const long long s = blockIdx.y;
  const long long first =
      static_cast<long long>(blockIdx.x) * kTileRows + threadIdx.x;
  unsigned long long key[kRowsPerThread];
  bool live[kRowsPerThread];
  int taking = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    live[i] = live_at<kWords>(hi, lo, valid, s, first + i * kThreads, rows,
                              &key[i]);
    taking += live[i];
  }
  if (warp_add(state, 0, taking) > bound) atomicExch(state + 1, 1ULL);
  const volatile unsigned long long* flag = state + 1;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (!live[i]) continue;
    if (*flag) return;
    const unsigned row = static_cast<unsigned>(s * rows + first + i * kThreads);
    if (!insert<kWords>(table, mask, max_probe, hi, lo, s, rows, key[i], row)) {
      atomicExch(state + 1, 1ULL);
      return;
    }
  }
}

template <int kWords, bool kAttr>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
probe_kernel(Words hi, Words lo, const unsigned char* __restrict__ valid,
             long long rows, const Slot* __restrict__ table,
             unsigned long long mask, int max_probe, long long dim_rows,
             Words attr_words, unsigned long long* state, int count,
             bool* __restrict__ found, long long* __restrict__ attr) {
  const long long s = blockIdx.y;
  const long long first =
      static_cast<long long>(blockIdx.x) * kTileRows + threadIdx.x;
  const bool flagged = *static_cast<volatile unsigned long long*>(state + 1) != 0;
  const unsigned base = static_cast<unsigned>(s * dim_rows);
  unsigned long long key[kRowsPerThread];
  Slot slot[kRowsPerThread];
  bool live[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    live[i] = !flagged && live_at<kWords>(hi, lo, valid, s,
                                          first + i * kThreads, rows, &key[i]);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (live[i]) slot[i] = load_slot(table, home_of(key[i], s, mask));
  }
  unsigned hit[kRowsPerThread];
  int probes = 0;
  int hits = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    hit[i] = kEmpty;
    if (!live[i]) continue;
    ++probes;
    Slot cur = slot[i];
    unsigned long long p = home_of(key[i], s, mask);   // again: fewer registers
    for (int step = 0; step < max_probe && cur.row != kEmpty; ++step) {
      if (cur.key == key[i] && static_cast<unsigned long long>(cur.row - base)
                                   < static_cast<unsigned long long>(dim_rows)) {
        hit[i] = cur.row - base;
        ++hits;
        break;
      }
      p = (p + 1) & mask;
      cur = load_slot(table, p);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long r = first + i * kThreads;
    if (r >= rows) continue;
    found[s * rows + r] = hit[i] != kEmpty;
    if (kAttr) {
      attr[s * rows + r] = hit[i] != kEmpty ? attr_words.at(s, hit[i]) : 0;
    }
  }
  if (count) {
    warp_add(state, 2, probes);
    warp_add(state, 3, hits);
  }
}

template <int kWords>
int launch(Words dim_hi, Words dim_lo, const unsigned char* dim_valid,
           Words dim_attr, bool has_attr, long long shards,
           long long dim_rows, Words probe_hi, Words probe_lo,
           const unsigned char* probe_valid, long long probe_rows,
           Slot* table, long long slots, long long bound,
           unsigned long long* state, int count, bool* found,
           long long* attr, cudaStream_t stream) {
  const unsigned long long mask = static_cast<unsigned long long>(slots - 1);
  const int max_probe = slots < kMaxProbe ? static_cast<int>(slots) : kMaxProbe;
  const long long clear_blocks =
      (slots + kThreads - 1) / kThreads < kClearBlocks
          ? (slots + kThreads - 1) / kThreads : kClearBlocks;
  clear_kernel<<<static_cast<unsigned>(clear_blocks), kThreads, 0, stream>>>(
      table, slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dim_rows > 0) {
    const dim3 grid(static_cast<unsigned>((dim_rows + kTileRows - 1) / kTileRows),
                    static_cast<unsigned>(shards));
    build_kernel<kWords><<<grid, kThreads, 0, stream>>>(
        dim_hi, dim_lo, dim_valid, dim_rows, table, mask, max_probe,
        static_cast<unsigned long long>(bound), state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (probe_rows == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((probe_rows + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>(shards));
  if (has_attr) {
    probe_kernel<kWords, true><<<grid, kThreads, 0, stream>>>(
        probe_hi, probe_lo, probe_valid, probe_rows, table, mask, max_probe,
        dim_rows, dim_attr, state, count, found, attr);
  } else {
    probe_kernel<kWords, false><<<grid, kThreads, 0, stream>>>(
        probe_hi, probe_lo, probe_valid, probe_rows, table, mask, max_probe,
        dim_rows, dim_attr, state, count, found, attr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lookup of `shards` shards: the dimension side's key words (dim_hi
// only when words is 2; each an int32 view given by its pointer and its
// shard and row strides in words) over dim_rows rows a shard, its valid
// bytes [shards, dim_rows] (contiguous; null: every row) and attribute
// words; the probe side's the same over probe_rows rows; table [slots, 2]
// int64 (slots a power of two), state int64 [4] zeroed, found bool
// [shards, probe_rows] and attr int64 [shards, probe_rows] (contiguous;
// null: no attr output). A pointer of an empty side may be null. Refuses (cudaErrorInvalidValue) words other
// than 1 or 2, a table that is not a power of two of slots or not 16-byte
// aligned, shards * dim_rows past kMaxRows, or a grid past its limits; a
// lookup with no shards launches nothing. Returns cudaGetLastError() after
// each launch.
extern "C" int hash_lookup_launch(const void* dim_hi, long long dim_hi_shard,
                                  long long dim_hi_row, const void* dim_lo,
                                  long long dim_lo_shard,
                                  long long dim_lo_row, const void* dim_valid,
                                  const void* dim_attr, long long attr_shard,
                                  long long attr_row, long long shards,
                                  long long dim_rows, const void* probe_hi,
                                  long long probe_hi_shard,
                                  long long probe_hi_row,
                                  const void* probe_lo,
                                  long long probe_lo_shard,
                                  long long probe_lo_row,
                                  const void* probe_valid,
                                  long long probe_rows, int words,
                                  void* table, long long slots,
                                  long long bound, void* state, int count,
                                  void* found, void* attr, void* stream) {
  if ((words != 1 && words != 2) || shards < 0 || shards > 65535
      || dim_rows < 0 || probe_rows < 0 || slots < 1
      || (slots & (slots - 1)) != 0 || bound < 0
      || (reinterpret_cast<uintptr_t>(table) & 15) != 0
      || (reinterpret_cast<uintptr_t>(state) & 7) != 0
      || (reinterpret_cast<uintptr_t>(attr) & 7) != 0
      || (shards > 0 && dim_rows > kMaxRows / shards)
      || (dim_rows + kTileRows - 1) / kTileRows > 0x7fffffffLL
      || (probe_rows + kTileRows - 1) / kTileRows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shards == 0) return static_cast<int>(cudaSuccess);
  const Words dhi{static_cast<const unsigned*>(dim_hi), dim_hi_shard,
                  dim_hi_row};
  const Words dlo{static_cast<const unsigned*>(dim_lo), dim_lo_shard,
                  dim_lo_row};
  const Words da{static_cast<const unsigned*>(dim_attr), attr_shard, attr_row};
  const Words phi{static_cast<const unsigned*>(probe_hi), probe_hi_shard,
                  probe_hi_row};
  const Words plo{static_cast<const unsigned*>(probe_lo), probe_lo_shard,
                  probe_lo_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<Slot*>(table);
  auto* st = static_cast<unsigned long long*>(state);
  auto* dv = static_cast<const unsigned char*>(dim_valid);
  auto* pv = static_cast<const unsigned char*>(probe_valid);
  auto* f = static_cast<bool*>(found);
  auto* a = static_cast<long long*>(attr);
  const bool has_attr = attr != nullptr;
  if (words == 2) {
    return launch<2>(dhi, dlo, dv, da, has_attr, shards, dim_rows, phi, plo,
                     pv, probe_rows, t, slots, bound, st, count, f, a, s);
  }
  return launch<1>(dhi, dlo, dv, da, has_attr, shards, dim_rows, phi, plo, pv,
                   probe_rows, t, slots, bound, st, count, f, a, s);
}

extern "C" const char* hash_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
