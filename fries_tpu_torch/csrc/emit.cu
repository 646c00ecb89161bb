// comp_sub output-slot emission (kernel B), one thread per parent.
//
// Replaces the TPU kernel fries_tpu/runtime/pallas_emit.py:_make_kernel
// (pallas_emit.py:147).  Contract (see fries_tpu_torch/runtime/emit.py):
// parent p owns the slots [offsets[p], offsets[p] + count_p), count_p =
// offsets[p+1] - offsets[p] (total - offsets[n-1] for the last parent);
// its r-th slot holds
//
//   * r < kept_counts[p]: the r-th kept sub (w > w_floor && w >= thr) and its
//     stage value widened to f64 (uniform parents: sub r, value u_val[p]);
//   * otherwise the grid point y = (rn + g_start[p] + r - kept) * unit -
//     cum_parent[p], value unit: uniform parents take
//     floor(y / rem * ndiv) clamped to [0, ndiv-1]; weighted parents the
//     non-kept sub whose inclusive mass prefix, accumulated in f32 as the
//     reference's kernels.row_cumsum does, first exceeds y, clamped to the
//     last non-kept sub;
//   * slots in [total, out_size) hold (0, -1, -1); slots >= out_size are not
//     written (overflow).
//
// Two row sources, one design:
//   dense     w (n, k) f32 / f64 (the A+B and E rounds);
//   factored  fa (n, e), fb (n, v), kill (n, e) bool or null, k = e * v (the
//             C+D round): w[c = i*v + j] = fa[i] * fb[j], zero at j = 0 where
//             kill[i].  The product is one correctly rounded multiply
//             (__fmul_rn / __dmul_rn, never contracted), exactly what
//             torch's elementwise product gives the plain version, so keep
//             masks are bit-identical; the (n, k) joint never reaches device
//             memory.
//
// Bound on the H100 by bytes (3.35 TB/s): offsets for every parent (8 B),
// for each parent with slots its other scalars (weighted 25 B: kept_counts,
// g_start, uniform, cum_parent; uniform 49 B, with ndiv, parent_rem and
// u_val), the part of each weighted parent's row that its walk reaches
// (dense: columns up to its last emitted sub, sizeof(T) each; factored: the
// fa, fb and kill entries of those columns), and 24 B per output slot.
// What the design does about the limits of the first version (one thread
// per slot):
//   1. no per-slot search over offsets: a block takes P consecutive parents,
//      one thread each, and a thread knows its slot range from two
//      neighbouring offsets;
//   2. a row is read from device memory once, into shared memory by 16-byte
//      cp.async copies, and each thread walks its row once.  Factored: the
//      block copies its P parents' contiguous fa, fb and kill spans,
//      skipping the copy when no parent of the block walks a row.  Dense:
//      each walking thread copies its own row, so parents without slots
//      cost no row bytes; the copy issues the whole row's loads at once,
//      ahead of the per-parent scalar reads, where a walk over the row in
//      device memory waits on one load per column (the A+B walk took 0.154
//      ms that way against 0.127 staged, NVIDIA H100 80GB HBM3; PERF.md).
//      Rows too wide to stage for 32 parents a block are walked where they
//      lie.  The grid points of one
//      parent increase with r, so one walk over the f32 prefix serves them
//      all as a merge of two sorted sequences: O(k + count) per parent, with
//      no prefix array and no per-slot search (a shared prefix searched per
//      slot would cost the same walk to build, then log k per slot); the
//      walk stops once the parent's last kept and grid slots are out;
//   3. a thread does one kind of work at a time: uniform lanes run their
//      closed form, then weighted lanes run the walk, in which kept, live
//      and dead columns are predicated steps of one loop;
//   4. the factored source forms its rows on chip (above).
// One thread per parent rather than one warp: parents mostly own one or two
// slots, so a warp per parent would leave most of its lanes idle.  The f32
// prefix is summed left to right, as in the first version; torch.cumsum
// (the plain version) sums in a scan order of its own, so a grid point
// within an f32 ulp of a prefix boundary may pick the neighbouring sub.
// Grid points and values are native f64, built with explicit _rn
// intrinsics so that no FMA contraction changes y.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxParents = 256;          // threads (= parents) per block
constexpr int kSmemTarget = 96 * 1024;    // halve P while a block needs more
constexpr int kSmemLimit = 227 * 1024;

struct Parents {
  const int64_t* offsets;
  const int64_t* kept_counts;
  const int64_t* g_start;
  const int64_t* ndiv;
  const uint8_t* uniform;
  const double* cum_parent;
  const double* parent_rem;
  const double* u_val;
  const double* scal;      // {rn, unit, thr, w_floor}
  const int64_t* total;
  int64_t n, out_size;
};

struct Out {
  double* val;
  int64_t* parent;
  int64_t* sub;
};

__host__ __device__ __forceinline__ int64_t round16(int64_t b) {
  return (b + 15) & ~int64_t(15);
}
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Block-wide copy of `bytes` from device memory to 16-byte-aligned shared
// memory: 16-byte cp.async for the aligned bulk, `elem`-byte copies for the
// rest (or for all of it where src is not 16-byte aligned).  The caller
// commits, waits and synchronizes the block.
__device__ void stage_block(void* dst, const void* src, int64_t bytes, int elem) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  const int64_t bulk = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? bytes & ~int64_t(15) : 0;
  for (int64_t i = threadIdx.x * 16; i < bulk; i += blockDim.x * 16)
    __pipeline_memcpy_async(d + i, g + i, 16);
  for (int64_t i = bulk + threadIdx.x * elem; i < bytes; i += blockDim.x * elem) {
    if (elem == 8) *reinterpret_cast<int64_t*>(d + i) = *reinterpret_cast<const int64_t*>(g + i);
    else if (elem == 4) *reinterpret_cast<int32_t*>(d + i) = *reinterpret_cast<const int32_t*>(g + i);
    else d[i] = g[i];
  }
}

// One thread's cp.async copy of its own row (`elem` = 4 or 8 bytes a value):
// 16-byte copies where source and destination allow, else one per value.
// The caller commits and waits; no other thread reads the row.
__device__ __forceinline__ void stage_row(void* dst, const void* src, int bytes, int elem) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  const bool wide = ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  const int bulk = wide ? bytes & ~15 : 0;
  for (int i = 0; i < bulk; i += 16) __pipeline_memcpy_async(d + i, g + i, 16);
  for (int i = bulk; i < bytes; i += elem) __pipeline_memcpy_async(d + i, g + i, elem);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Exact f32 stand-ins for comparisons with an f64 x: for f32 w,
// w > x <=> w > below(x) and w >= x <=> w >= above(x).
__device__ __forceinline__ float below(double x) { return __double2float_rd(x); }
__device__ __forceinline__ float above(double x) { return __double2float_ru(x); }

// y = (rn + g0 + (r - kept)) * unit - cum, rounded as the plain version's
// three elementwise ops.
__device__ __forceinline__ double grid_y(double rn, double g0, int rk, double unit,
                                         double cum) {
  return __dsub_rn(__dmul_rn(__dadd_rn(rn, __dadd_rn(g0, (double)rk)), unit), cum);
}

// One weighted parent's walk over its row: emits kept subs by rank and grid
// points in increasing y as the f32 prefix passes them.  The inner loop
// compares in T and f32 only: the keep test (double)w > w_floor &&
// (double)w >= thr is w > floor_t && w >= thr_t, and (double)prefix > y is
// prefix > y_t, with the thresholds rounded outward once (exact, see
// below()).  Ranks and columns are 32-bit (a parent's count and k are far
// below 2^31); only the output address is 64-bit.
template <typename T>
struct Walk {
  Out out;
  int64_t p, base;
  int kept, kept_lim, lim, kr, gr, last_live;
  double unit, rn, g0, cum;
  T floor_t, thr_t;
  float prefix, y_t;

  __device__ __forceinline__ void set_thresholds(double w_floor, double thr) {
    if constexpr (sizeof(T) == 4) {
      floor_t = below(w_floor);
      thr_t = above(thr);
    } else {
      floor_t = w_floor;
      thr_t = thr;
    }
  }
  __device__ __forceinline__ void set_y() { y_t = below(grid_y(rn, g0, gr - kept, unit, cum)); }

  __device__ __forceinline__ void emit(int r, double v, int sub) const {
    out.val[base + r] = v;
    out.parent[base + r] = p;
    out.sub[base + r] = sub;
  }
  __device__ __forceinline__ bool done() const { return kr >= kept_lim && gr >= lim; }
  // Visit column c of value w; returns true once every slot is out.
  __device__ __forceinline__ bool step(T w, int c) {
    if (w > floor_t && w >= thr_t) {
      if (kr < kept_lim) emit(kr++, (double)w, c);
    } else if (w > (T)0) {
      prefix = __fadd_rn(prefix, (float)w);
      last_live = c;
      while (gr < lim && prefix > y_t) {
        emit(gr++, unit, c);
        set_y();
      }
    }
    return done();
  }
  // Slots the walk left: grid points past the last prefix take the last live
  // sub; kept ranks the row lacks take sub 0 (both as the plain version).
  __device__ __forceinline__ void finish(T w0) {
    for (; gr < lim; ++gr) emit(gr, unit, last_live >= 0 ? last_live : 0);
    for (; kr < kept_lim; ++kr) emit(kr, (double)w0, 0);
  }
};

template <typename T, bool kFactored>
__global__ void __launch_bounds__(kMaxParents)
emit_kernel(Parents pa, const T* __restrict__ w, const T* __restrict__ fa,
            const T* __restrict__ fb, const uint8_t* __restrict__ kill, int k,
            int e, int v, bool stage, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int64_t p0 = blockIdx.x * (int64_t)blockDim.x;
  const int64_t p = p0 + t;
  const int64_t total = *pa.total;
  const int64_t out_size = pa.out_size;

  for (int64_t s = total + p; s < out_size; s += (int64_t)gridDim.x * blockDim.x) {
    out.val[s] = 0.0;
    out.parent[s] = -1;
    out.sub[s] = -1;
  }

  int64_t off = 0;
  int lim = 0;
  bool uni = false;
  if (p < pa.n) {
    off = pa.offsets[p];
    const int64_t next = p + 1 < pa.n ? pa.offsets[p + 1] : total;
    lim = (int)(imin(next, out_size) - imin(off, out_size));
    uni = lim > 0 && pa.uniform[p] != 0;
  }
  const bool walks = lim > 0 && !uni;

  // Stage the rows in shared memory.  Dense: each walking thread copies its
  // own row (parents without slots cost no row bytes) unless `stage` is
  // false (rows too wide); factored: the block copies its contiguous fa, fb
  // and kill spans (most C+D parents walk), then synchronizes.  Layout:
  // thread t's row at t * k (dense), or fa rows | fb rows | kill rows, each
  // span 16-byte aligned (factored).
  unsigned char* fb_smem = smem + round16(blockDim.x * e * sizeof(T));
  unsigned char* kill_smem = fb_smem + round16(blockDim.x * v * sizeof(T));
  if (kFactored) {
    if (__syncthreads_or(walks)) {
      const int64_t np = imin((int64_t)blockDim.x, pa.n - p0);
      stage_block(smem, fa + p0 * e, np * e * sizeof(T), sizeof(T));
      stage_block(fb_smem, fb + p0 * v, np * v * sizeof(T), sizeof(T));
      if (kill != nullptr) stage_block(kill_smem, kill + p0 * e, np * e, 1);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  } else if (walks && stage) {
    stage_row(smem + (int64_t)t * k * sizeof(T), w + p * k, k * (int)sizeof(T), sizeof(T));
    __pipeline_commit();
  }
  if (lim <= 0) return;

  // per-parent scalars, read while a dense row is still in flight
  const double rn = pa.scal[0], unit = pa.scal[1];
  const int kept = (int)pa.kept_counts[p];
  const double g0 = (double)pa.g_start[p];
  const double cum = pa.cum_parent[p];

  if (uni) {
    const double u = pa.u_val[p];
    const double nd = (double)(pa.ndiv[p] > 1 ? pa.ndiv[p] : 1);
    const double rem = fmax(pa.parent_rem[p], 1e-300);
    for (int r = 0; r < lim; ++r) {
      double val = u;
      int64_t sub = r;
      if (r >= kept) {
        const double y = grid_y(rn, g0, r - kept, unit, cum);
        const double q = floor(__dmul_rn(__ddiv_rn(y, rem), nd));
        sub = (int64_t)fmin(fmax(q, 0.0), nd - 1.0);
        val = unit;
      }
      out.val[off + r] = val;
      out.parent[off + r] = p;
      out.sub[off + r] = sub;
    }
    return;
  }

  Walk<T> wk;
  wk.out = out;
  wk.p = p;
  wk.base = off;
  wk.kept = kept;
  wk.lim = lim;
  wk.kept_lim = kept < lim ? kept : lim;
  wk.kr = 0;
  wk.gr = kept;
  wk.last_live = -1;
  wk.unit = unit;
  wk.rn = rn;
  wk.g0 = g0;
  wk.cum = cum;
  wk.prefix = 0.0f;
  wk.set_thresholds(pa.scal[3], pa.scal[2]);
  wk.set_y();
  T w0;
  if (kFactored) {
    const T* a_row = reinterpret_cast<const T*>(smem) + t * e;
    const T* b_row = reinterpret_cast<const T*>(fb_smem) + t * v;
    const uint8_t* kill_row = kill != nullptr ? kill_smem + t * e : nullptr;
    w0 = kill_row != nullptr && kill_row[0] ? (T)0 : mul_rn(a_row[0], b_row[0]);
    bool done = wk.done();
    for (int i = 0, c = 0; i < e && !done; ++i) {
      const T a = a_row[i];
      const bool killed = kill_row != nullptr && kill_row[i] != 0;
      for (int j = 0; j < v && !done; ++j, ++c)
        done = wk.step(j == 0 && killed ? (T)0 : mul_rn(a, b_row[j]), c);
    }
  } else {
    const T* row = w + p * k;
    if (stage) {
      __pipeline_wait_prior(0);
      row = reinterpret_cast<const T*>(smem) + t * k;
    }
    w0 = row[0];
    for (int c = 0; c < k && !wk.done(); ++c) wk.step(row[c], c);
  }
  wk.finish(w0);
}

// Shared memory of a block of np parents.
template <typename T, bool kFactored>
int64_t smem_bytes(int64_t np, int64_t k, int64_t e, int64_t v, bool has_kill) {
  if (!kFactored) return round16(np * k * (int64_t)sizeof(T));
  return round16(np * e * (int64_t)sizeof(T)) + round16(np * v * (int64_t)sizeof(T)) +
         (has_kill ? round16(np * e) : 0);
}

template <typename T, bool kFactored>
int launch(const Parents& pa, const T* w, const T* fa, const T* fb,
           const uint8_t* kill, int64_t k, int64_t e, int64_t v, const Out& out,
           void* stream) {
  int np = kMaxParents;
  while (np > 32 && smem_bytes<T, kFactored>(np, k, e, v, kill != nullptr) > kSmemTarget)
    np /= 2;
  int64_t smem = smem_bytes<T, kFactored>(np, k, e, v, kill != nullptr);
  const bool stage = smem <= kSmemLimit;
  if (!stage && kFactored) return cudaErrorInvalidConfiguration;
  if (!stage) {   // dense rows too wide to stage: walked where they lie
    np = kMaxParents;
    smem = 0;
  }
  if (pa.out_size > INT32_MAX || k > INT32_MAX) return cudaErrorInvalidValue;  // 32-bit ranks
  auto kernel = emit_kernel<T, kFactored>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t grid = (pa.n + np - 1) / np;
  kernel<<<grid, np, smem, static_cast<cudaStream_t>(stream)>>>(pa, w, fa, fb, kill, (int)k,
                                                                  (int)e, (int)v, stage, out);
  return cudaGetLastError();
}

}  // namespace

// scal = {rn, unit, thr, w_floor} (f64, device); total: int64 (device).
#define FRIES_EMIT_DENSE(NAME, T)                                                   \
  extern "C" int NAME(const int64_t* offsets, const int64_t* kept_counts,         \
                      const int64_t* g_start, const int64_t* ndiv,                \
                      const uint8_t* uniform, const T* w_sub,                     \
                      const double* cum_parent, const double* parent_rem,         \
                      const double* u_val, const double* scal,                    \
                      const int64_t* total, int64_t n, int64_t k,                 \
                      int64_t out_size, double* out_val, int64_t* out_parent,     \
                      int64_t* out_sub, void* stream) {                           \
    return launch<T, false>(                                                      \
        Parents{offsets, kept_counts, g_start, ndiv, uniform, cum_parent,         \
                parent_rem, u_val, scal, total, n, out_size},                     \
        w_sub, nullptr, nullptr, nullptr, k, 0, 0,                                \
        Out{out_val, out_parent, out_sub}, stream);                               \
  }

// fa (n, e), fb (n, v), kill (n, e) bool or NULL.
#define FRIES_EMIT_FACTORED(NAME, T)                                                \
  extern "C" int NAME(const int64_t* offsets, const int64_t* kept_counts,         \
                      const int64_t* g_start, const int64_t* ndiv,                \
                      const uint8_t* uniform, const T* fa, const T* fb,           \
                      const uint8_t* kill, const double* cum_parent,              \
                      const double* parent_rem, const double* u_val,              \
                      const double* scal, const int64_t* total, int64_t n,        \
                      int64_t e, int64_t v, int64_t out_size, double* out_val,    \
                      int64_t* out_parent, int64_t* out_sub, void* stream) {      \
    return launch<T, true>(                                                       \
        Parents{offsets, kept_counts, g_start, ndiv, uniform, cum_parent,         \
                parent_rem, u_val, scal, total, n, out_size},                     \
        nullptr, fa, fb, kill, e * v, e, v, Out{out_val, out_parent, out_sub},    \
        stream);                                                                  \
  }

FRIES_EMIT_DENSE(fries_emit_f32, float)
FRIES_EMIT_DENSE(fries_emit_f64, double)
FRIES_EMIT_FACTORED(fries_emit_factored_f32, float)
FRIES_EMIT_FACTORED(fries_emit_factored_f64, double)
