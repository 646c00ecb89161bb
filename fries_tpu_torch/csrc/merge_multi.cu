// Kernel C: the multi-row sorted merge; spawns that each carry their
// destination value row merged into the sorted arena of R value rows.
//
// Replaces the TPU kernel fries_tpu/runtime/pallas_merge.py:894
// _make_kernel_multi (launched by _merge_call_multi), reached through
// arena.accumulate_multi_best from the subspace driver.  Contract
// (fries_tpu_torch/runtime/merge_multi.py): the result of
// arena.accumulate_multi.
//
//   * a spawn counts iff its key is valid, its row r_s is in [0, R), and it is
//     an initiator or lands on an arena key whose value in row r_s is nonzero;
//   * every valid arena row passes through, with each row's counted sums
//     added; a new key is inserted iff at least one counted spawn lands on it;
//   * n_out counts the merged rows (overflow: n_out > C, the first C kept);
//     nonini counts non-initiator spawns onto occupied targets, all rows.
//
// What bounds it on the H100: bytes, about (16 + 8R) B per valid arena row
// read, 41 B per spawn (sorted key, permutation, gathered value, row and
// flag) and (16 + 8R) B per arena row written at capacity.  The TPU kernel
// walks both streams on a sequential grid with an OR-scan of 2R+2 flag bits
// in an int32 (hence its R <= 14); here kernel A's design (merge_common.cuh)
// runs with one channel per value row, R <= 32 (one look-back lane each).

#include "merge_common.cuh"

// As fries_merge (merge.cu), with srow (S) int64 the spawns' rows and R =
// n_rows value rows, each its own channel.  R outside [1, 32] is refused.
extern "C" int fries_merge_multi(const int64_t* akw, const double* avals, int64_t c, int w,
                                 int n_rows, const int64_t* skey, const int64_t* perm,
                                 const double* sval, const int64_t* srow, const uint8_t* sini,
                                 int64_t s, int64_t sentinel, int64_t* ukey, double* usum,
                                 int32_t* ucnt, double* records, int64_t* ctrl, int64_t* okw,
                                 double* ovals, uint8_t* overflow, void* stream) {
  const MergeArgs a{akw, avals, nullptr, c, w, n_rows, 1, 0, 0,
                    skey, perm, sval, sini, srow, s, n_rows, sentinel,
                    ukey, usum, ucnt, records, ctrl, okw, ovals, overflow};
  return launch_merge(a, w, static_cast<cudaStream_t>(stream));
}
