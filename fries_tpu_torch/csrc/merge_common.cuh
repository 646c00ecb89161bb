// The sorted-merge accumulate on the H100, shared by kernel A (merge.cu, one
// value channel, fused compaction) and kernel C (merge_multi.cu, a channel
// per value row).  Each translation unit gets its own copy (anonymous
// namespace); the entry points fill a MergeArgs and call launch_merge.
//
// What bounds it: bytes.  The arena's rows up to n_valid are read (packed
// keys and value rows), the spawns' sorted keys and permutation are read and
// their values, flags and rows gathered through the permutation, the arena
// is written at capacity.  In practice each tile is a chain of dependent
// trips to device memory (ticket, partition, loads, look-back, writes), so
// a thread issues all reads of its items in one batch before using any.
// Four device operations, each one pass:
//
//   0. one memset of the control block (tickets, look-back words, stats);
//   1. reduce_spawns: a segmented reduction of the sorted spawns by key.
//      Tiles of kTile spawns; per unique key u and channel c it writes the
//      sum of the valid spawns (all), of the initiator spawns (ini), the
//      count of non-initiator spawns, and per key the count of initiator
//      spawns.  Which sum counts depends only on whether the target is
//      occupied, so it is decided in step 2.  A run of equal keys that
//      crosses tiles is carried by a decoupled look-back over the tiles'
//      (head count, trailing-run sums) records, so no thread walks a run;
//      the head count gives each unique key its index.  Summation order:
//      each thread sums its kItems spawns in order, then a warp and block
//      tree, then the carry from earlier tiles (a run's total is
//      (carry + block prefix) + thread's spawns), not the one-thread
//      left-to-right walk of earlier versions: values agree with the plain
//      version within rtol 1e-12.  The order is fixed by the data, never
//      by which tiles happen to have finished: a tile's look-back ends
//      only at a tile that has published its inclusive prefix AND holds a
//      head (kInclusiveHead).  Such a tile's inclusive sums are its own
//      aggregate's, bit for bit (a head restarts the run), and every tile
//      between it and this one is folded from its aggregate in a tree
//      anchored at this tile, so the carry of a run that crosses tiles
//      is summed from the aggregates of the tiles since its head, in one
//      order, whichever tiles were done when the walk passed them (the
//      inclusive prefix of a tile without a head carries a sum whose order
//      depended on that tile's own walk, so the walk passes it).  The merge
//      is bitwise reproducible run to run.  One extra block counts the
//      arena's valid rows (a 32-way warp search for the first sentinel
//      key).
//   2. merge_tiles: merge path over the arena's valid rows [0, n_valid) and
//      the U unique keys, both read on the device.  A block takes a ticket,
//      finds its tile's two diagonals with a 32-way warp search, loads both
//      key slices into shared memory, and each thread merges kItems rows
//      (arena first on equal keys).  A key of both lists is "found": the
//      arena row takes the counted sum, the unique key is dropped.  Alive
//      rows are counted by a block scan and placed by a decoupled look-back
//      over the tiles' alive counts; the rows are written coalesced from
//      shared-memory descriptors; the last tile writes n_out, n_used and
//      overflow; every tile adds its non-initiator-onto-occupied count.
//   3. fill_tail: the sentinel key and zero values in rows [n_used, C).
//
// Keys (Key<W>, W a template parameter): W = 1 or 2 words pack into one
// sign-flipped int64, W = 3 or 4 into an unsigned 128-bit integer (words 0-1
// the low half, 2-3 the high half), both compared as integers, the last word
// the most significant.  Wider keys, W = 5..16, are Limbs<L>: L = ceil(W / 2)
// uint64 limbs, limb j words 2j and 2j + 1 (the top limb of an odd W holds
// one word), compared lexicographically from the top limb.  Their kernels are
// instantiated once per L (W = 2L, kMaxWords = 16 at most) and read the
// arena's row stride, W or W - 1, from MergeArgs::w.  The arena's (C, W)
// int64 words are packed on the fly and written back as words; spawn keys
// come sorted from torch.sort, as one int64 each or as L sign-flipped int64
// columns.  The sentinel is the all-ones row's key, the largest.  The key
// tiles sit in dynamic shared memory: at L = 8 (64-byte keys) merge_tiles'
// two tiles take 131 KB, past the 48 KB of a static allocation, so a launch
// that needs more raises the kernel's limit first (up to the H100's 227 KB a
// block).  Tickets come from atomic counters, not blockIdx,
// so a tile only waits on tiles already running: the look-backs always make
// progress.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // merge.py TILE
constexpr int kMaxChannels = 32;          // merge_multi.py MAX_ROWS
constexpr int kFillBlocks = 2048;
constexpr int kMaxWords = 16;             // merge.py MAX_WORDS
constexpr size_t kStaticSmem = 48 * 1024;
constexpr int64_t kWordMask = 0xFFFFFFFFll;
constexpr uint64_t kSignBit = 0x8000000000000000ull;

// Control block (int64 words, zeroed by the entry's memset): stats first,
// then the reduce tiles' flags, then the merge tiles' status words.
enum : int {
  kNOut = 0, kNonini = 1, kNUsed = 2, kReduceTicket = 3, kMergeTicket = 4,
  kNValid = 5, kNUnique = 6, kCtrlHead = 8
};
// Look-back states: 0 not ready, 1 aggregate published, 2 inclusive prefix,
// 3 inclusive prefix of a reduce tile that holds a head.
constexpr int64_t kAggregate = 1, kInclusive = 2, kInclusiveHead = 3;
constexpr int kStatusShift = 56;
constexpr int64_t kStatusValue = (1ll << kStatusShift) - 1;

struct MergeArgs {
  // arena: keys (C, W) words, values (n_rows, C), keep mask (C) or NULL
  const int64_t* akw;
  const double* avals;
  const uint8_t* akeep;
  int64_t c;
  int w;  // the arena's words per row (the row stride)
  int n_rows;
  // per_row: channel r tests occupancy in and adds to value row r (kernel
  // C); otherwise one channel tests origin_row and adds to dest_row (A)
  int per_row, origin_row, dest_row;
  // spawns: keys sorted (S int64, or S rows of L columns for W > 2), the
  // sort's permutation, and values,
  // initiator flags and rows (NULL: channel 0) in the stream's order
  const int64_t* skey;
  const int64_t* perm;
  const double* sval;
  const uint8_t* sini;
  const int64_t* srow;
  int64_t s;
  int n_chan;
  int64_t sentinel;  // the packed sentinel key (W <= 2)
  // scratch: unique keys (S Key<W>), sums (2 * n_chan * S: all, then ini), counts
  // ((n_chan + 1) * S: non-initiator per channel, then initiator per key),
  // look-back records, control block
  int64_t* ukey;
  double* usum;
  int32_t* ucnt;
  double* records;
  int64_t* ctrl;
  // outputs: keys (C, W) words, values (n_rows, C), overflow flag
  int64_t* okw;
  double* ovals;
  uint8_t* overflow;
};

inline int64_t n_reduce_tiles(int64_t s) { return (s + kTile - 1) / kTile; }
inline int64_t n_merge_tiles(int64_t c, int64_t s) { return (c + s + kTile - 1) / kTile; }

// A key of W = 5..16 words: limb j holds words 2j and 2j + 1, the top limb
// the most significant.
template <int L>
struct Limbs {
  uint64_t v[L];
};

template <int L>
__device__ __forceinline__ bool operator==(const Limbs<L>& x, const Limbs<L>& y) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < L; ++j) eq &= x.v[j] == y.v[j];
  return eq;
}

template <int L>
__device__ __forceinline__ bool operator!=(const Limbs<L>& x, const Limbs<L>& y) {
  return !(x == y);
}

template <int L>
__device__ __forceinline__ bool operator<(const Limbs<L>& x, const Limbs<L>& y) {
#pragma unroll
  for (int j = L - 1; j > 0; --j)
    if (x.v[j] != y.v[j]) return x.v[j] < y.v[j];
  return x.v[0] < y.v[0];
}

template <int L>
__device__ __forceinline__ bool operator<=(const Limbs<L>& x, const Limbs<L>& y) {
  return !(y < x);
}

template <int W>
using Key = typename std::conditional<
    (W <= 2), int64_t,
    typename std::conditional<(W <= 4), unsigned __int128, Limbs<(W + 1) / 2>>::type>::type;

// The arena's words per row: W, or for limb keys (instantiated at even W)
// the run-time width W or W - 1.
template <int W>
__device__ __forceinline__ int row_words(const MergeArgs& a) {
  return W <= 4 ? W : a.w;
}

template <int W>
__device__ __forceinline__ Key<W> arena_key(const MergeArgs& a, int64_t i) {
  const int64_t* akw = a.akw;
  if constexpr (W <= 2) {
    uint64_t u = static_cast<uint64_t>(akw[i * W]);
    if (W == 2) u |= static_cast<uint64_t>(akw[i * 2 + 1]) << 32;
    return static_cast<int64_t>(u ^ kSignBit);
  } else if constexpr (W <= 4) {
    const uint64_t lo = static_cast<uint64_t>(akw[i * W]) |
                        static_cast<uint64_t>(akw[i * W + 1]) << 32;
    uint64_t hi = static_cast<uint64_t>(akw[i * W + 2]);
    if (W == 4) hi |= static_cast<uint64_t>(akw[i * W + 3]) << 32;
    return static_cast<unsigned __int128>(hi) << 64 | lo;
  } else {
    const int w = a.w;
    const int64_t* row = akw + i * w;
    Key<W> key;
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      uint64_t u = static_cast<uint64_t>(row[2 * j]);
      if (2 * j + 1 < w) u |= static_cast<uint64_t>(row[2 * j + 1]) << 32;
      key.v[j] = u;
    }
    return key;
  }
}

template <int W>
__device__ __forceinline__ Key<W> sentinel_key(const MergeArgs& a) {
  if constexpr (W <= 2) {
    return a.sentinel;
  } else if constexpr (W <= 4) {
    return static_cast<unsigned __int128>(W == 4 ? ~0ull : kWordMask) << 64 | ~0ull;
  } else {
    Key<W> key;
#pragma unroll
    for (int j = 0; j < W / 2; ++j) key.v[j] = ~0ull;
    if (a.w & 1) key.v[W / 2 - 1] = kWordMask;
    return key;
  }
}

// The i-th sorted spawn key.
template <int W>
__device__ __forceinline__ Key<W> spawn_key(const MergeArgs& a, int64_t i) {
  if constexpr (W <= 2) {
    return a.skey[i];
  } else if constexpr (W <= 4) {
    return static_cast<unsigned __int128>(static_cast<uint64_t>(a.skey[2 * i + 1]) ^ kSignBit)
               << 64 | (static_cast<uint64_t>(a.skey[2 * i]) ^ kSignBit);
  } else {
    Key<W> key;
#pragma unroll
    for (int j = 0; j < W / 2; ++j)
      key.v[j] = static_cast<uint64_t>(a.skey[(W / 2) * i + j]) ^ kSignBit;
    return key;
  }
}

template <int W>
__device__ __forceinline__ Key<W>* unique_keys(const MergeArgs& a) {
  return reinterpret_cast<Key<W>*>(a.ukey);
}

// A key's words, written to word[0, row_words) (W <= 4: a register array).
template <int W>
__device__ __forceinline__ void key_words(const MergeArgs& a, const Key<W>& key, int64_t* word) {
  if constexpr (W <= 2) {
    const uint64_t u = static_cast<uint64_t>(key) ^ kSignBit;
    word[0] = static_cast<int64_t>(u & kWordMask);
    if (W == 2) word[W - 1] = static_cast<int64_t>((u >> 32) & kWordMask);
  } else if constexpr (W <= 4) {
    const uint64_t lo = static_cast<uint64_t>(key), hi = static_cast<uint64_t>(key >> 64);
    word[0] = static_cast<int64_t>(lo & kWordMask);
    word[1] = static_cast<int64_t>(lo >> 32);
    word[2] = static_cast<int64_t>(hi & kWordMask);
    if (W == 4) word[W - 1] = static_cast<int64_t>(hi >> 32);
  } else {
    const int w = a.w;
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      word[2 * j] = static_cast<int64_t>(key.v[j] & kWordMask);
      if (2 * j + 1 < w) word[2 * j + 1] = static_cast<int64_t>(key.v[j] >> 32);
    }
  }
}

// First index in [lo, hi) where the monotone (true..., false...) predicate
// is false, hi if none; one warp, 32 probes a round.
template <class Pred>
__device__ int64_t warp_partition(int64_t lo, int64_t hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t x = lo + lane * step;
    const int c = __popc(__ballot_sync(0xffffffffu, x < hi && pred(x)));
    if (c == 0) return lo;
    const int64_t next_hi = lo + c * step < hi ? lo + c * step : hi;
    lo = lo + (c - 1) * step + 1;
    hi = next_hi;
  }
  const int64_t x = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, x < hi && pred(x)));
}

__device__ __forceinline__ int64_t load_volatile(const int64_t* p) {
  return *reinterpret_cast<const volatile int64_t*>(p);
}

__device__ __forceinline__ void store_volatile(int64_t* p, int64_t v) {
  *reinterpret_cast<volatile int64_t*>(p) = v;
}

// ---------------------------------------------------------------------------
// 1. segmented reduction of the sorted spawns
// ---------------------------------------------------------------------------

// A stretch of spawns in key order: its heads (first spawns of a key), and
// over the spawns from its last head on (all of it without a head): the
// initiator count, the non-initiator count and the sums of one channel.
struct Part {
  int n, ci, nn;
  double sa, si;
};

// a followed by b (Part{} is the identity)
__device__ __forceinline__ Part combine(const Part& a, const Part& b) {
  if (b.n > 0) return Part{a.n + b.n, b.ci, b.nn, b.sa, b.si};
  return Part{a.n + b.n, a.ci + b.ci, a.nn + b.nn, a.sa + b.sa, a.si + b.si};
}

__device__ __forceinline__ int combine(int a, int b) { return a + b; }
__device__ __forceinline__ long long combine(long long a, long long b) { return a + b; }

__device__ __forceinline__ Part shfl_up(const Part& p, int o) {
  return Part{__shfl_up_sync(0xffffffffu, p.n, o), __shfl_up_sync(0xffffffffu, p.ci, o),
              __shfl_up_sync(0xffffffffu, p.nn, o), __shfl_up_sync(0xffffffffu, p.sa, o),
              __shfl_up_sync(0xffffffffu, p.si, o)};
}

template <class T>
__device__ __forceinline__ T shfl_up(T x, int o) { return __shfl_up_sync(0xffffffffu, x, o); }

// Exclusive scan of v over the block in thread order under combine (a sum,
// or the segmented combine of Parts); *total receives the block's
// aggregate.
template <class T>
__device__ T block_scan(T v, T* total) {
  __shared__ T warp_inc[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x);
  }
  if (lane == 31) warp_inc[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 1; k < kWarps; ++k) warp_inc[k] = combine(warp_inc[k - 1], warp_inc[k]);
  __syncthreads();
  T e = shfl_up(x, 1);
  if (lane == 0) e = T{};
  const T excl = warp == 0 ? e : lane == 0 ? warp_inc[warp - 1] : combine(warp_inc[warp - 1], e);
  *total = warp_inc[kWarps - 1];
  __syncthreads();
  return excl;
}

// One spawn's part in channel ch.
__device__ __forceinline__ Part spawn_part(bool head, bool counted, bool ini, int64_t row,
                                           double val, int ch) {
  Part p = Part{};
  p.n = head;
  if (counted) {
    p.ci = ini;
    if (row == ch) {
      p.sa = val;
      if (ini) p.si = val; else p.nn = 1;
    }
  }
  return p;
}

// Look-back record of a tile: {n, ci, sa[n_chan], si[n_chan], nn[n_chan]}.
__device__ __forceinline__ void put_record(double* rec, int nc, int ch, const Part& p) {
  if (ch == 0) { rec[0] = p.n; rec[1] = p.ci; }
  rec[2 + ch] = p.sa;
  rec[2 + nc + ch] = p.si;
  rec[2 + 2 * nc + ch] = p.nn;
}

__device__ __forceinline__ Part get_record(const double* rec, int nc, int ch) {
  return Part{static_cast<int>(__ldcg(rec)), static_cast<int>(__ldcg(rec + 1)),
              static_cast<int>(__ldcg(rec + 2 + 2 * nc + ch)), __ldcg(rec + 2 + ch),
              __ldcg(rec + 2 + nc + ch)};
}

// Block-wide look-back over the tiles before t, kThreads at a time: thread
// k waits for tile hi - (kThreads - 1) + k of the window ending at hi (the
// oldest at thread 0), the nearest tile in state `stop` ends the walk, and
// fold(word, tile, use) folds the window with block scans (use: the
// thread's tile is in it, no older than that tile).
template <class Fold>
__device__ void look_back(const int64_t* status, int64_t t, int shift, int64_t stop_state,
                          Fold fold) {
  __shared__ int s_stop;
  for (int64_t hi = t - 1; hi >= 0; hi -= kThreads) {
    const int64_t q = hi - (kThreads - 1) + threadIdx.x;
    int64_t word = 0;
    if (q >= 0)
      while ((word = load_volatile(status + q)) == 0) __nanosleep(20);
    __threadfence();
    if (threadIdx.x == 0) s_stop = -1;
    __syncthreads();
    if ((word >> shift) == stop_state) atomicMax(&s_stop, static_cast<int>(threadIdx.x));
    __syncthreads();
    const int stop = s_stop;
    fold(word, q, q >= 0 && static_cast<int>(threadIdx.x) >= stop);
    __syncthreads();
    if (stop >= 0) return;
  }
}

// Dynamic shared memory of reduce_spawns: the tile's keys, one before, one
// after.
template <int W>
constexpr size_t reduce_smem() { return (kTile + 2) * sizeof(Key<W>); }

template <int W>
__global__ void __launch_bounds__(kThreads) reduce_spawns(MergeArgs a, int64_t nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key<W>* s_key = reinterpret_cast<Key<W>*>(smem);
  __shared__ Part s_agg[kMaxChannels], s_ex[kMaxChannels];
  __shared__ int64_t s_tile;
  if (threadIdx.x == 0)
    s_tile = static_cast<int64_t>(
        atomicAdd(reinterpret_cast<unsigned long long*>(a.ctrl + kReduceTicket), 1ull));
  __syncthreads();
  const int64_t t = s_tile;
  const int lane = threadIdx.x & 31;
  const Key<W> sent = sentinel_key<W>(a);
  if (t == nt) {  // the extra block: the arena's valid rows (sentinels sort last)
    if (threadIdx.x < 32) {
      const int64_t nv = warp_partition(0, a.c, [&](int64_t i) {
        return arena_key<W>(a, i) != sent;
      });
      if (lane == 0) a.ctrl[kNValid] = nv;
    }
    return;
  }
  // the spawns' values, flags and rows through the permutation, in one
  // batch with the tile's keys (the tile's keys, one before, one after)
  const int64_t base = t * kTile;
  double val[kItems];
  int64_t row[kItems];
  bool ini[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + threadIdx.x * kItems + j;
    const int64_t p = i < a.s ? a.perm[i] : -1;
    val[j] = p >= 0 ? a.sval[p] : 0.0;
    ini[j] = p >= 0 && a.sini[p] != 0;
    row[j] = p >= 0 && a.srow != nullptr ? a.srow[p] : 0;
  }
  for (int q = threadIdx.x; q < kTile + 2; q += kThreads) {
    const int64_t i = base - 1 + q;
    s_key[q] = i >= 0 && i < a.s ? spawn_key<W>(a, i) : sent;
  }
  __syncthreads();
  bool head[kItems], end[kItems], counted[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int q = threadIdx.x * kItems + j;
    const Key<W> key = s_key[q + 1];
    const bool valid = key != sent;
    head[j] = valid && key != s_key[q];
    end[j] = valid && key != s_key[q + 2];
    counted[j] = valid && row[j] >= 0 && row[j] < a.n_chan;   // a valid spawn of a valid row
  }
  const int nc = a.n_chan;
  auto thread_part = [&](int ch) {
    Part v = Part{};
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v = combine(v, spawn_part(head[j], counted[j], ini[j], row[j], val[j], ch));
    return v;
  };
  for (int ch = 0; ch < nc; ++ch) {
    Part tot;
    block_scan(thread_part(ch), &tot);
    if (threadIdx.x == 0) s_agg[ch] = tot;
  }
  __syncthreads();

  // publish the aggregate, look back, publish the inclusive prefix
  const int rec_len = 2 + 3 * nc;
  int64_t* flags = a.ctrl + kCtrlHead;
  if (threadIdx.x < nc) {
    put_record(a.records + (2 * t) * rec_len, nc, threadIdx.x, s_agg[threadIdx.x]);
    s_ex[threadIdx.x] = Part{};
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_volatile(flags + t, kAggregate);
  // the walk ends at the nearest tile with a head and an inclusive prefix;
  // the tiles after it count by their aggregates (see the note at the top)
  look_back(flags, t, 0, kInclusiveHead, [&](int64_t flag, int64_t q, bool use) {
    const double* rec = a.records + (2 * q + (flag == kInclusiveHead)) * rec_len;
    for (int ch = 0; ch < nc; ++ch) {   // the window oldest first, before later windows
      Part tot;
      block_scan(use ? get_record(rec, nc, ch) : Part{}, &tot);
      if (threadIdx.x == 0) s_ex[ch] = combine(tot, s_ex[ch]);
    }
  });
  if (threadIdx.x < nc) {
    const Part inc = combine(s_ex[threadIdx.x], s_agg[threadIdx.x]);
    put_record(a.records + (2 * t + 1) * rec_len, nc, threadIdx.x, inc);
    if (threadIdx.x == 0 && t == nt - 1) a.ctrl[kNUnique] = inc.n;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_volatile(flags + t, s_agg[0].n > 0 ? kInclusiveHead : kInclusive);

  for (int ch = 0; ch < nc; ++ch) {
    Part tot;
    Part run = combine(s_ex[ch], block_scan(thread_part(ch), &tot));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      run = combine(run, spawn_part(head[j], counted[j], ini[j], row[j], val[j], ch));
      const int64_t u = run.n - 1;
      if (ch == 0 && head[j]) unique_keys<W>(a)[u] = s_key[threadIdx.x * kItems + j + 1];
      if (end[j]) {
        a.usum[ch * a.s + u] = run.sa;
        a.usum[(nc + ch) * a.s + u] = run.si;
        a.ucnt[ch * a.s + u] = run.nn;
        if (ch == 0) a.ucnt[nc * a.s + u] = run.ci;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. merge path over the arena's valid rows and the unique keys
// ---------------------------------------------------------------------------

// The channel that adds to value row `row`, or -1.
__device__ __forceinline__ int row_channel(const MergeArgs& a, int row) {
  return a.per_row ? row : row == a.dest_row ? 0 : -1;
}

__device__ __forceinline__ bool occupied(const MergeArgs& a, int ch, int64_t i) {
  return a.avals[(a.per_row ? ch : a.origin_row) * a.c + i] != 0.0;
}

// A thread's merged rows (kItems of them, or kItems output rows) read the
// device memory they need in one batch before using any of it: the kernel
// is bound by the latency of those reads, not by their bytes.

// Rows o[k] of the output from arena row src[k] >= 0 (with unique key
// m[k], or -1) or unique key -src[k] - 1; live bit k marks a row to write.
template <int W>
__device__ __forceinline__ void write_rows(const MergeArgs& a, const int64_t* o,
                                           const int* src, const int* m, unsigned live) {
  if constexpr (W <= 4) {
    int64_t word[kItems][W];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!(live >> k & 1)) continue;
      if (src[k] >= 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) word[k][w] = a.akw[static_cast<int64_t>(src[k]) * W + w];
      } else {
        key_words<W>(a, unique_keys<W>(a)[-src[k] - 1], word[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (live >> k & 1)
#pragma unroll
        for (int w = 0; w < W; ++w) a.okw[o[k] * W + w] = word[k][w];
  } else {   // limb keys: each row's words copied straight, not held in registers
    const int w = a.w;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!(live >> k & 1)) continue;
      int64_t* out = a.okw + o[k] * w;
      if (src[k] >= 0) {
        const int64_t* in = a.akw + static_cast<int64_t>(src[k]) * w;
        for (int j = 0; j < w; ++j) out[j] = in[j];
      } else {
        key_words<W>(a, unique_keys<W>(a)[-src[k] - 1], out);
      }
    }
  }
  for (int row = 0; row < a.n_rows; ++row) {
    const int ch = row_channel(a, row);
    double v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = 0.0;
      if (!(live >> k & 1)) continue;
      if (src[k] >= 0) {   // the arena's value, plus the counted sum if found
        v[k] = a.avals[row * a.c + src[k]];
        if (ch >= 0 && m[k] >= 0) {
          const double all = a.usum[ch * a.s + m[k]], ini = a.usum[(a.n_chan + ch) * a.s + m[k]];
          v[k] += occupied(a, ch, src[k]) ? all : ini;
        }
      } else if (ch >= 0) {   // a new key: its initiator sum
        v[k] = a.usum[(a.n_chan + ch) * a.s + (-src[k] - 1)];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (live >> k & 1) a.ovals[row * a.c + o[k]] = v[k];
  }
}

// Dynamic shared memory of merge_tiles: the arena keys [a0 - 1, a1) and
// the unique keys [b0, b1] of its tile, then the row descriptors.  With the
// few hundred bytes of static words (scans, look-back) it stays within the
// 227 KB a block can have at 64-byte keys (139 KB).
template <int W>
constexpr size_t merge_smem() {
  return 2 * (kTile + 1) * sizeof(Key<W>) + 2 * kTile * sizeof(int32_t);
}
static_assert(merge_smem<kMaxWords>() + 1024 <= 227 * 1024,
              "merge_tiles' shared memory exceeds the H100's 227 KB a block");

template <int W>
__global__ void __launch_bounds__(kThreads) merge_tiles(MergeArgs a, int64_t nt_reduce) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key<W>* s_a = reinterpret_cast<Key<W>*>(smem);
  Key<W>* s_b = s_a + (kTile + 1);
  int32_t* s_src = reinterpret_cast<int32_t*>(s_b + (kTile + 1));
  int32_t* s_match = s_src + kTile;
  __shared__ int64_t s_split[2], s_tile;
  __shared__ unsigned long long s_nonini;
  int64_t* status = a.ctrl + kCtrlHead + nt_reduce;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int64_t>(
        atomicAdd(reinterpret_cast<unsigned long long*>(a.ctrl + kMergeTicket), 1ull));
    s_nonini = 0;
  }
  __syncthreads();
  const int64_t t = s_tile;
  const Key<W> sent = sentinel_key<W>(a);
  const Key<W>* ukey = unique_keys<W>(a);
  const int64_t n_a = a.ctrl[kNValid], n_b = a.ctrl[kNUnique], total = n_a + n_b;
  const int64_t nt = total > 0 ? (total + kTile - 1) / kTile : 1;
  if (t >= nt) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {  // the arena rows among the first d merged rows, d at each end
    const int64_t d = (t + warp) * kTile < total ? (t + warp) * kTile : total;
    const int64_t split = warp_partition(d > n_b ? d - n_b : 0, d < n_a ? d : n_a,
                                         [&](int64_t m) {
      return arena_key<W>(a, m) <= ukey[d - 1 - m];
    });
    if (lane == 0) s_split[warp] = split;
  }
  __syncthreads();
  const int64_t a0 = s_split[0], a1 = s_split[1];
  const int64_t d0 = t * kTile < total ? t * kTile : total;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  const int64_t b0 = d0 - a0, b1 = d1 - a1;
  const int na = static_cast<int>(a1 - a0), nb = static_cast<int>(b1 - b0), n = na + nb;
  // the sentinel stands for "no key": no valid key equals it
  for (int q = threadIdx.x; q <= na; q += kThreads)
    s_a[q] = a0 - 1 + q >= 0 ? arena_key<W>(a, a0 - 1 + q) : sent;
  for (int q = threadIdx.x; q <= nb; q += kThreads)
    s_b[q] = b0 + q < n_b ? ukey[b0 + q] : sent;
  __syncthreads();

  const int dk = threadIdx.x * kItems < n ? threadIdx.x * kItems : n;
  int lo = dk > nb ? dk - nb : 0, hi = dk < na ? dk : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_a[mid + 1] <= s_b[dk - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  // merge in shared memory: item k is arena row src[k] (found: unique key
  // match[k]) or unique key -src[k] - 1; uq[k] the unique key whose counts
  // decide it (-1: none; a found unique key is dropped)
  int ia = lo, ib = dk - lo;
  int src[kItems], match[kItems], uq[kItems];
  unsigned have = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    src[k] = 0; match[k] = -1; uq[k] = -1;
    if (dk + k >= n) continue;
    if (ib >= nb || (ia < na && s_a[ia + 1] <= s_b[ib])) {  // found iff the next
      src[k] = static_cast<int>(a0 + ia);                   // unique key is its own
      match[k] = uq[k] = s_b[ib] == s_a[ia + 1] ? static_cast<int>(b0 + ib) : -1;
      ++ia;
      have |= 1u << k;
    } else {  // found iff the arena row before it has its key
      src[k] = -static_cast<int>(b0 + ib) - 1;
      if (s_a[ia] != s_b[ib]) { uq[k] = static_cast<int>(b0 + ib); have |= 1u << k; }
      ++ib;
    }
  }
  // an arena row lives without a keep mask, or with an origin value, its
  // keep bit or a counted spawn (with a zero origin value: an initiator
  // one); a new key lives if an initiator spawn of a valid row lands on it
  int ci[kItems];
  double orig[kItems];
  bool keep[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    ci[k] = uq[k] >= 0 ? a.ucnt[a.n_chan * a.s + uq[k]] : 0;
    const bool kept = a.akeep != nullptr && src[k] >= 0 && (have >> k & 1);
    orig[k] = kept ? a.avals[a.origin_row * a.c + src[k]] : 1.0;
    keep[k] = kept && a.akeep[src[k]];
  }
  unsigned long long nonini = 0;
  for (int ch = 0; ch < a.n_chan; ++ch)
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (match[k] >= 0) {
        const int nn = a.ucnt[ch * a.s + match[k]];
        nonini += occupied(a, ch, src[k]) ? nn : 0;
      }
  unsigned alive = 0;
  int n_alive = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool lives = (have >> k & 1) &&
                       (src[k] >= 0 ? orig[k] != 0.0 || keep[k] || ci[k] > 0 : ci[k] > 0);
    alive |= static_cast<unsigned>(lives) << k;
    n_alive += lives;
  }
  if (nonini) atomicAdd(&s_nonini, nonini);
  int k_tile;
  int pos = block_scan(n_alive, &k_tile);

  // the tile's output offset by look-back
  if (threadIdx.x == 0) store_volatile(status + t, (kAggregate << kStatusShift) | k_tile);
  long long excl = 0;
  look_back(status, t, kStatusShift, kInclusive, [&](int64_t word, int64_t, bool use) {
    long long tot;
    block_scan<long long>(use ? word & kStatusValue : 0, &tot);
    excl += tot;
  });
  if (threadIdx.x == 0) {
    store_volatile(status + t, (kInclusive << kStatusShift) | (excl + k_tile));
    if (t == nt - 1) {
      const int64_t n_out = excl + k_tile;
      a.ctrl[kNOut] = n_out;
      a.ctrl[kNUsed] = n_out < a.c ? n_out : a.c;
      *a.overflow = n_out > a.c;
    }
    if (s_nonini)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.ctrl + kNonini), s_nonini);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (alive >> k & 1) { s_src[pos] = src[k]; s_match[pos] = match[k]; ++pos; }
  __syncthreads();
  // write the alive rows in order, coalesced: thread x takes x + k kThreads
  int64_t o[kItems];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = threadIdx.x + k * kThreads;
    o[k] = excl + q;
    live |= static_cast<unsigned>(q < k_tile && o[k] < a.c) << k;
    src[k] = live >> k & 1 ? s_src[q] : 0;
    match[k] = live >> k & 1 ? s_match[q] : -1;
  }
  write_rows<W>(a, o, src, match, live);
}

// ---------------------------------------------------------------------------
// 3. the sentinel tail
// ---------------------------------------------------------------------------

template <int W>
__global__ void fill_tail(MergeArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int nw = row_words<W>(a);
  for (int64_t j = a.ctrl[kNUsed] + blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       j < a.c; j += stride) {
#pragma unroll
    for (int w = 0; w < nw; ++w) a.okw[j * nw + w] = kWordMask;
    for (int row = 0; row < a.n_rows; ++row) a.ovals[row * a.c + j] = 0.0;
  }
}

// Allows a kernel more than 48 KB of dynamic shared memory when it needs it.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int W>
cudaError_t launch_w(const MergeArgs& a, int64_t nt_r, int64_t nt_m, cudaStream_t stream) {
  cudaError_t err = allow_smem(reduce_spawns<W>, reduce_smem<W>());
  if (!err) err = allow_smem(merge_tiles<W>, merge_smem<W>());
  if (err) return err;
  reduce_spawns<W><<<nt_r + 1, kThreads, reduce_smem<W>(), stream>>>(a, nt_r);
  merge_tiles<W><<<nt_m, kThreads, merge_smem<W>(), stream>>>(a, nt_r);
  const int64_t fill = (a.c + kThreads - 1) / kThreads;
  fill_tail<W><<<fill < kFillBlocks ? fill : kFillBlocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The control block holds kCtrlHead + n_reduce_tiles(s) + n_merge_tiles(c, s)
// words and the records 2 * n_reduce_tiles(s) * (2 + 3 * n_chan) doubles
// (merge.py allocates both).
cudaError_t launch_merge(const MergeArgs& a, int w, cudaStream_t stream) {
  if (a.n_chan < 1 || a.n_chan > kMaxChannels || a.c < 1 || a.s < 1 || a.w != w)
    return cudaErrorInvalidValue;
  if (!a.per_row && (a.origin_row < 0 || a.origin_row >= a.n_rows || a.dest_row < 0 ||
                     a.dest_row >= a.n_rows))
    return cudaErrorInvalidValue;
  const int64_t nt_r = n_reduce_tiles(a.s), nt_m = n_merge_tiles(a.c, a.s);
  cudaError_t err = cudaMemsetAsync(a.ctrl, 0, (kCtrlHead + nt_r + nt_m) * sizeof(int64_t), stream);
  if (err) return err;
  if (w == 1) return launch_w<1>(a, nt_r, nt_m, stream);
  if (w == 2) return launch_w<2>(a, nt_r, nt_m, stream);
  if (w == 3) return launch_w<3>(a, nt_r, nt_m, stream);
  if (w == 4) return launch_w<4>(a, nt_r, nt_m, stream);
  // limb keys, one instance per L = ceil(w / 2)
  if (w <= 6) return launch_w<6>(a, nt_r, nt_m, stream);
  if (w <= 8) return launch_w<8>(a, nt_r, nt_m, stream);
  if (w <= 10) return launch_w<10>(a, nt_r, nt_m, stream);
  if (w <= 12) return launch_w<12>(a, nt_r, nt_m, stream);
  if (w <= 14) return launch_w<14>(a, nt_r, nt_m, stream);
  if (w <= kMaxWords) return launch_w<16>(a, nt_r, nt_m, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
