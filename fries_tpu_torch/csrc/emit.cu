// comp_sub output-slot emission.
//
// Replaces the TPU kernel fries_tpu/runtime/pallas_emit.py:_make_kernel.
// Contract (see fries_tpu_torch/runtime/emit.py): one thread per output slot
// s < out_size.
//
//   * parent p = the LAST i with offsets[i] <= s (zero-count parents share an
//     offset, so an upper-bound search), r = s - offsets[p];
//   * r < kept_counts[p]: the r-th kept sub (w > w_floor && w >= thr) and its
//     stage value widened to f64 (uniform parents: sub r, value u_val[p]);
//   * otherwise the grid point y = (rn + g_start[p] + r - kept) * unit -
//     cum_parent[p], value unit: uniform parents take
//     floor(y / rem * ndiv) clamped to [0, ndiv-1]; weighted parents the
//     non-kept sub whose inclusive mass prefix, accumulated in f32 as the
//     reference's kernels.row_cumsum does, first exceeds y, clamped to the
//     last non-kept sub;
//   * slots s >= total emit (0, -1, -1).
//
// Bound on the H100 by bytes: a log2(N) binary search over offsets (L2
// resident at these sizes) and two reads of one K-wide parent row per slot.
// Neighbouring slots mostly share a parent, so the row reads coalesce in
// L1/L2; everything else is registers.  Native f64 throughout, no slot cap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void emit_kernel(const int64_t* __restrict__ offsets,
                            const int64_t* __restrict__ kept_counts,
                            const int64_t* __restrict__ g_start,
                            const int64_t* __restrict__ ndiv,
                            const uint8_t* __restrict__ uniform,
                            const T* __restrict__ w_sub,
                            const double* __restrict__ cum_parent,
                            const double* __restrict__ parent_rem,
                            const double* __restrict__ u_val,
                            const double* __restrict__ scal,
                            const int64_t* __restrict__ total_p, int64_t n,
                            int64_t k, int64_t out_size,
                            double* __restrict__ out_val,
                            int64_t* __restrict__ out_parent,
                            int64_t* __restrict__ out_sub) {
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s >= out_size) return;
  if (s >= *total_p) {
    out_val[s] = 0.0;
    out_parent[s] = -1;
    out_sub[s] = -1;
    return;
  }
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (offsets[mid] <= s) lo = mid + 1; else hi = mid;
  }
  const int64_t p = lo > 0 ? (lo - 1 < n ? lo - 1 : n - 1) : 0;

  const double rn = scal[0], unit = scal[1], thr = scal[2], w_floor = scal[3];
  const int64_t r = s - offsets[p];
  const int64_t kept = kept_counts[p];
  const bool uni = uniform[p] != 0;
  const T* row = w_sub + p * k;

  double val = unit;
  int64_t sub = 0;
  if (r < kept) {
    if (uni) {
      sub = r;
      val = u_val[p];
    } else {
      val = (double)row[0];
      int64_t cnt = 0;
      for (int64_t j = 0; j < k; ++j) {
        const double w = (double)row[j];
        if (w > w_floor && w >= thr) {
          if (cnt == r) { sub = j; val = w; break; }
          ++cnt;
        }
      }
    }
  } else {
    const double g = (double)g_start[p] + (double)(r - kept);
    const double y = (rn + g) * unit - cum_parent[p];
    if (uni) {
      const double nd = (double)(ndiv[p] > 1 ? ndiv[p] : 1);
      const double q = floor(y / fmax(parent_rem[p], 1e-300) * nd);
      sub = (int64_t)fmin(fmax(q, 0.0), nd - 1.0);
    } else {
      float prefix = 0.0f;
      int64_t passed = 0, live = 0;
      for (int64_t j = 0; j < k; ++j) {
        const T w = row[j];
        const bool keep = (double)w > w_floor && (double)w >= thr;
        const T rem = keep ? (T)0 : w;
        prefix += (float)rem;
        if (rem > (T)0) {
          ++live;
          if ((double)prefix <= y) ++passed;
        }
      }
      const int64_t last = live > 1 ? live - 1 : 0;
      const int64_t target = passed < last ? passed : last;
      int64_t cnt = 0;
      for (int64_t j = 0; j < k; ++j) {
        const T w = row[j];
        const bool keep = (double)w > w_floor && (double)w >= thr;
        if (!keep && w > (T)0) {
          if (cnt == target) { sub = j; break; }
          ++cnt;
        }
      }
    }
  }
  out_val[s] = val;
  out_parent[s] = p;
  out_sub[s] = sub;
}

template <typename T>
int launch(const int64_t* offsets, const int64_t* kept_counts,
           const int64_t* g_start, const int64_t* ndiv, const uint8_t* uniform,
           const T* w_sub, const double* cum_parent, const double* parent_rem,
           const double* u_val, const double* scal, const int64_t* total,
           int64_t n, int64_t k, int64_t out_size, double* out_val,
           int64_t* out_parent, int64_t* out_sub, void* stream) {
  const int64_t grid = (out_size + kThreads - 1) / kThreads;
  emit_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, kept_counts, g_start, ndiv, uniform, w_sub, cum_parent,
      parent_rem, u_val, scal, total, n, k, out_size, out_val, out_parent,
      out_sub);
  return cudaGetLastError();
}

}  // namespace

// scal = {rn, unit, thr, w_floor} (f64, device); total: int64 (device).
extern "C" int fries_emit_f32(const int64_t* offsets, const int64_t* kept_counts,
                              const int64_t* g_start, const int64_t* ndiv,
                              const uint8_t* uniform, const float* w_sub,
                              const double* cum_parent, const double* parent_rem,
                              const double* u_val, const double* scal,
                              const int64_t* total, int64_t n, int64_t k,
                              int64_t out_size, double* out_val,
                              int64_t* out_parent, int64_t* out_sub,
                              void* stream) {
  return launch<float>(offsets, kept_counts, g_start, ndiv, uniform, w_sub,
                       cum_parent, parent_rem, u_val, scal, total, n, k,
                       out_size, out_val, out_parent, out_sub, stream);
}

extern "C" int fries_emit_f64(const int64_t* offsets, const int64_t* kept_counts,
                              const int64_t* g_start, const int64_t* ndiv,
                              const uint8_t* uniform, const double* w_sub,
                              const double* cum_parent, const double* parent_rem,
                              const double* u_val, const double* scal,
                              const int64_t* total, int64_t n, int64_t k,
                              int64_t out_size, double* out_val,
                              int64_t* out_parent, int64_t* out_sub,
                              void* stream) {
  return launch<double>(offsets, kept_counts, g_start, ndiv, uniform, w_sub,
                        cum_parent, parent_rem, u_val, scal, total, n, k,
                        out_size, out_val, out_parent, out_sub, stream);
}
