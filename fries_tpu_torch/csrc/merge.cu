// Sorted-merge accumulate of a spawn stream into the sorted arena.
//
// Replaces the TPU kernel fries_tpu/runtime/pallas_merge.py:_kernel_v2 (and
// its v1 _kernel).  Contract (see fries_tpu_torch/runtime/merge.py): the
// result of compact-then-accumulate with the initiator rule, for the layouts
// (n_vecs, origin, dest) = (1, 0, 0) (adest == odest == NULL) and (2, 0, 1).
//
// Keys are the packed int64 determinant keys (fries_tpu_torch.dets.pack_key):
// the arena's are sorted ascending and padded with the sentinel key, the
// spawns' are sorted (stable) by the caller.  The merge is memory-bound on the
// H100 (~C*(8+16) + S*(8+8+1) bytes); each phase is one coalesced pass:
//
//   1. per spawn: binary search of its key in the arena, the allowed flag,
//      and the non-initiator-onto-occupied count (warp ballot + one atomic);
//   2. per segment head: the segment's allowed values summed in sorted order
//      (native f64), written to the arena row it hits or kept as a new key;
//   3. alive flags of arena rows, then exclusive scans of arena-alive and
//      new-alive flags (block scan + a pass over block sums);
//   4. scatter: arena row i goes to rankA(i) + #new keys below key_i, new key
//      u to rankN(u) + rankA(insertion point of u); slots past the end are
//      filled with the sentinel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kThreads * kScanItems;  // merge.py SCAN_TILE

constexpr uint8_t kAllowed = 1;
constexpr uint8_t kFound = 2;
constexpr uint8_t kHead = 4;

__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix of v over the block; *total receives the block sum.
__device__ int64_t block_exclusive_scan(int64_t v, int64_t* total) {
  __shared__ int64_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int64_t excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return excl;
}

__global__ void spawn_lookup(const int64_t* akey, const double* aorig,
                             const int64_t* skey, const uint8_t* sini,
                             int64_t sentinel, int64_t c, int64_t s,
                             int64_t* s_pos, uint8_t* s_flag,
                             unsigned long long* nonini_out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  bool nonini = false;
  if (i < s) {
    const int64_t k = skey[i];
    const bool valid = k != sentinel;
    const int64_t pos = lower_bound(akey, c, k);
    const bool found = valid && pos < c && akey[pos] == k;
    const bool occupied = found && aorig[pos] != 0.0;
    const bool ini = sini[i] != 0;
    const bool head = valid && (i == 0 || skey[i - 1] != k);
    nonini = valid && !ini && occupied;
    s_pos[i] = pos;
    s_flag[i] = (valid && (ini || occupied) ? kAllowed : 0) |
                (found ? kFound : 0) | (head ? kHead : 0);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, nonini);
  if ((threadIdx.x & 31) == 0 && ballot)
    atomicAdd(nonini_out, (unsigned long long)__popc(ballot));
}

__global__ void segment_sums(const int64_t* skey, const double* sval,
                             const int64_t* s_pos, const uint8_t* s_flag,
                             int64_t s, double* a_add, uint8_t* a_hit,
                             double* new_val, int64_t* new_flag) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= s) return;
  const uint8_t f = s_flag[i];
  if (!(f & kHead)) { new_flag[i] = 0; return; }
  const int64_t k = skey[i];
  double sum = 0.0;
  int64_t cnt = 0;
  for (int64_t j = i; j < s && skey[j] == k; ++j) {
    if (s_flag[j] & kAllowed) { sum += sval[j]; ++cnt; }
  }
  if (f & kFound) {
    a_add[s_pos[i]] = sum;
    a_hit[s_pos[i]] = cnt > 0;
    new_flag[i] = 0;
  } else {
    new_val[i] = sum;
    new_flag[i] = cnt > 0;
  }
}

__global__ void arena_alive(const int64_t* akey, const double* aorig,
                            const uint8_t* akeep, const uint8_t* a_hit,
                            int64_t sentinel, int64_t c, int64_t* alive) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= c) return;
  const bool valid = akey[i] != sentinel;
  alive[i] = valid && (akeep == nullptr || aorig[i] != 0.0 || akeep[i] ||
                       a_hit[i]);
}

__global__ void scan_tile_sums(const int64_t* data, int64_t n, int64_t* bsum) {
  const int64_t base = blockIdx.x * (int64_t)kScanTile + threadIdx.x * kScanItems;
  int64_t v = 0;
  for (int t = 0; t < kScanItems; ++t)
    if (base + t < n) v += data[base + t];
  int64_t total;
  block_exclusive_scan(v, &total);
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// One block: exclusive scan of the nb block sums, in chunks with a carry.
__global__ void scan_block_sums(int64_t* bsum, int64_t nb) {
  int64_t carry = 0;
  for (int64_t start = 0; start < nb; start += kScanTile) {
    const int64_t base = start + threadIdx.x * kScanItems;
    int64_t item[kScanItems];
    int64_t v = 0;
    for (int t = 0; t < kScanItems; ++t) {
      item[t] = base + t < nb ? bsum[base + t] : 0;
      v += item[t];
    }
    int64_t total;
    int64_t run = carry + block_exclusive_scan(v, &total);
    for (int t = 0; t < kScanItems; ++t) {
      if (base + t < nb) bsum[base + t] = run;
      run += item[t];
    }
    carry += total;
  }
}

__global__ void scan_tiles(int64_t* data, int64_t n, const int64_t* bsum) {
  const int64_t base = blockIdx.x * (int64_t)kScanTile + threadIdx.x * kScanItems;
  int64_t item[kScanItems];
  int64_t v = 0;
  for (int t = 0; t < kScanItems; ++t) {
    item[t] = base + t < n ? data[base + t] : 0;
    v += item[t];
  }
  int64_t total;
  int64_t run = bsum[blockIdx.x] + block_exclusive_scan(v, &total);
  for (int t = 0; t < kScanItems; ++t) {
    if (base + t < n) data[base + t] = run;
    run += item[t];
  }
}

// In-place exclusive scan of data[0..n); bsum holds ceil(n / kScanTile) slots.
cudaError_t exclusive_scan(int64_t* data, int64_t n, int64_t* bsum,
                           cudaStream_t stream) {
  const int64_t nb = (n + kScanTile - 1) / kScanTile;
  scan_tile_sums<<<nb, kThreads, 0, stream>>>(data, n, bsum);
  scan_block_sums<<<1, kThreads, 0, stream>>>(bsum, nb);
  scan_tiles<<<nb, kThreads, 0, stream>>>(data, n, bsum);
  return cudaGetLastError();
}

__global__ void scatter_arena(const int64_t* akey, const double* aorig,
                              const double* adest, const double* a_add,
                              const int64_t* skey, const int64_t* scan_a,
                              const int64_t* scan_n, int64_t c, int64_t s,
                              int64_t* okey, double* oorig, double* odest) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= c || scan_a[i + 1] == scan_a[i]) return;  // not alive
  const int64_t k = akey[i];
  const int64_t out = scan_a[i] + scan_n[lower_bound(skey, s, k)];
  if (out >= c) return;
  okey[out] = k;
  if (odest != nullptr) {
    oorig[out] = aorig[i];
    odest[out] = adest[i] + a_add[i];
  } else {
    oorig[out] = aorig[i] + a_add[i];
  }
}

__global__ void scatter_new(const int64_t* skey, const int64_t* s_pos,
                            const double* new_val, const int64_t* scan_a,
                            const int64_t* scan_n, int64_t c, int64_t s,
                            int64_t* okey, double* oorig, double* odest) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= s || scan_n[i + 1] == scan_n[i]) return;  // not a live new key
  const int64_t out = scan_n[i] + scan_a[s_pos[i]];
  if (out >= c) return;
  okey[out] = skey[i];
  if (odest != nullptr) {
    oorig[out] = 0.0;
    odest[out] = new_val[i];
  } else {
    oorig[out] = new_val[i];
  }
}

__global__ void fill_tail(const int64_t* scan_a, const int64_t* scan_n,
                          int64_t sentinel, int64_t c, int64_t s,
                          int64_t* okey, double* oorig, double* odest,
                          int64_t* stats) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t n_out = scan_a[c] + scan_n[s];
  if (j == 0) stats[0] = n_out;
  if (j >= c || j < n_out) return;
  okey[j] = sentinel;
  oorig[j] = 0.0;
  if (odest != nullptr) odest[j] = 0.0;
}

inline int64_t blocks(int64_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" const char* fries_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers; adest/odest are NULL for the one-row
// layout and akeep is NULL without fused compaction.  Scratch: s_pos (S),
// s_flag (S), new_val (S), a_add (C), a_hit (C), scan_a (C+1), scan_n (S+1),
// bsum (ceil((C+1)/1024) + ceil((S+1)/1024)).  stats = {n_out, nonini}.
extern "C" int fries_merge(const int64_t* akey, const double* aorig,
                           const double* adest, const uint8_t* akeep,
                           const int64_t* skey, const double* sval,
                           const uint8_t* sini, int64_t sentinel, int64_t c,
                           int64_t s, int64_t* s_pos, uint8_t* s_flag,
                           double* new_val, double* a_add, uint8_t* a_hit,
                           int64_t* scan_a, int64_t* scan_n, int64_t* bsum,
                           int64_t* okey, double* oorig, double* odest,
                           int64_t* stats, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if ((err = cudaMemsetAsync(stats, 0, 2 * sizeof(int64_t), stream))) return err;
  if ((err = cudaMemsetAsync(a_add, 0, c * sizeof(double), stream))) return err;
  if ((err = cudaMemsetAsync(a_hit, 0, c, stream))) return err;
  if ((err = cudaMemsetAsync(scan_a + c, 0, sizeof(int64_t), stream))) return err;
  if ((err = cudaMemsetAsync(scan_n + s, 0, sizeof(int64_t), stream))) return err;

  spawn_lookup<<<blocks(s), kThreads, 0, stream>>>(
      akey, aorig, skey, sini, sentinel, c, s, s_pos, s_flag,
      reinterpret_cast<unsigned long long*>(stats + 1));
  segment_sums<<<blocks(s), kThreads, 0, stream>>>(
      skey, sval, s_pos, s_flag, s, a_add, a_hit, new_val, scan_n);
  arena_alive<<<blocks(c), kThreads, 0, stream>>>(
      akey, aorig, akeep, a_hit, sentinel, c, scan_a);
  if ((err = cudaGetLastError())) return err;
  if ((err = exclusive_scan(scan_a, c + 1, bsum, stream))) return err;
  if ((err = exclusive_scan(scan_n, s + 1, bsum + (c + kScanTile) / kScanTile,
                            stream)))
    return err;
  scatter_arena<<<blocks(c), kThreads, 0, stream>>>(
      akey, aorig, adest, a_add, skey, scan_a, scan_n, c, s, okey, oorig, odest);
  scatter_new<<<blocks(s), kThreads, 0, stream>>>(
      skey, s_pos, new_val, scan_a, scan_n, c, s, okey, oorig, odest);
  fill_tail<<<blocks(c), kThreads, 0, stream>>>(
      scan_a, scan_n, sentinel, c, s, okey, oorig, odest, stats);
  return cudaGetLastError();
}
