// Kernel A: the sorted-merge accumulate of a spawn stream into the sorted
// arena, with the initiator rule and fused compaction.
//
// Replaces the TPU kernel fries_tpu/runtime/pallas_merge.py:617 _kernel_v2
// (and its v1 _kernel, :264).  Contract (fries_tpu_torch/runtime/merge.py):
// the result of compact-then-accumulate; one value channel, occupancy
// tested on the origin row, sums added to the dest row, the other value
// rows passed through.  Without a keep mask any layout (n_vecs, origin,
// dest) with origin, dest < n_vecs (origin == dest included; the
// observables' four-row arena merges at (4, s, s) and (4, s, 3)); with one,
// (1, 0, 0) and (2, 0, 1), the layouts whose fused compaction is shown equal
// (runtime/merge.py).  A row outside [0, n_vecs) is refused.
//
// What bounds it on the H100: bytes, about 32 B per valid arena row read
// (two key words, two value rows, the keep bit), 33 B per spawn (sorted key,
// permutation, gathered value and flag) and 32 B per arena row written at
// capacity; at W = 3..16 (128-bit keys, then L = ceil(W / 2) 64-bit limbs)
// 8 B per word more per arena row read and written, and 8 (L - 1) B more per
// spawn.  The Pallas kernel walks both streams on a sequential grid;
// here the design of merge_common.cuh runs it in four passes: a memset, a
// segmented reduction of the sorted spawns by key (carries by decoupled
// look-back), a merge path over the arena's valid rows and the unique keys
// in shared-memory tiles (output offsets by decoupled look-back), and the
// sentinel tail.  No binary search over whole arrays, no pass over the
// arena's empty rows but the tail's writes, and the arena is read and
// written as (C, W) words and (R, C) value rows with no pack or stack.

#include "merge_common.cuh"

extern "C" const char* fries_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers.  akw (C, W) int64 words, avals (n_rows,
// C), akeep (C) or NULL (no fused compaction); skey sorted, (S) packed or, for
// 3 <= W <= 16, (S, L) sign-flipped columns (L = ceil(W / 2), the lowest
// first); ukey scratch of one key each (L int64); perm (S) the sort's
// permutation, sval (S) and sini (S) in the stream's order; scratch and the
// control block as runtime/merge.py allocates them; okw (C, W), ovals
// (n_rows, C), overflow one byte.
extern "C" int fries_merge(const int64_t* akw, const double* avals, int64_t c, int w,
                           int n_rows, const uint8_t* akeep, int origin_row, int dest_row,
                           const int64_t* skey, const int64_t* perm, const double* sval,
                           const uint8_t* sini, int64_t s, int64_t sentinel, int64_t* ukey,
                           double* usum, int32_t* ucnt, double* records, int64_t* ctrl,
                           int64_t* okw, double* ovals, uint8_t* overflow, void* stream) {
  const MergeArgs a{akw, avals, akeep, c, w, n_rows, 0, origin_row, dest_row,
                    skey, perm, sval, sini, nullptr, s, 1, sentinel,
                    ukey, usum, ucnt, records, ctrl, okw, ovals, overflow};
  return launch_merge(a, w, static_cast<cudaStream_t>(stream));
}
