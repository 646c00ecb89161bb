// comp_sub_factored's threshold plan (kernel F): every reduction of the C+D
// round's plan, computed from the rank-1 factors.
//
// Replaces no TPU kernel: the JAX package computes this plan with XLA over
// the materialized joint (fries_tpu/compress.py, comp_sub_factored).
// Contract (fries_tpu_torch/runtime/plan.py): parent i's joint row is
//
//   w[i, c = k * v + j] = fa[i, k] * fb[i, j],  zero at j = 0 where kill[i, k],
//
// each value one correctly rounded multiply (__fmul_rn / __dmul_rn, never
// contracted), the product torch's elementwise multiply gives the plain
// version, so every comparison below sees the plain version's values bit for
// bit.  A parent split into ndiv[i] equal parts carries w_uni[i] (f64), each
// part u_uni[i].  Four modes share one row loop:
//
//   total    the sum of (double) w over every row;
//   seed     for each of the 20 edges x_m (f64): the mass of the w >= x_m
//            (x_m rounded to the stage dtype), summed within a row in the
//            stage dtype and over the rows in f64, and their count; plus,
//            where u_uni[i] >= x_m, w_uni[i] and max(ndiv[i], 1);
//   counts   at a threshold thr (f64) and a floor w_floor (stage dtype), with
//            kept = w > w_floor && (double) w >= thr: the f64 sum of the
//            unkept w and the count of the kept; plus w_uni[i], or ndiv[i]
//            where w_uni[i] > 0 && u_uni[i] >= thr;
//   parents  the first two for each row: rem[i] (f64), kept[i] (int64).
//
// Bound on the H100 by bytes (3.35 TB/s): a mode reads the factors once,
// N (E + V) sizeof(T) B, plus N E B of kill bytes and, for seed and counts,
// 24 B a row of the split parents' arrays; parents writes 16 B a row.  The
// plain version forms the (N, E V) joint in device memory for every pass,
// with its f64 copy and its masks, about 80 times in the seed alone.  Design:
//   1. a block stages a tile of P consecutive parents' fa, fb and kill rows in
//      shared memory with coalesced loads, row strides padded to an odd count
//      of values so that the threads' reads of their own rows fall in
//      distinct banks; each thread then walks its parent's E V products in
//      registers, in column order; nothing of (N, E V) reaches device memory;
//   2. blocks loop over tiles (a grid of one wave of resident blocks), so the
//      per-block partial sums are few;
//   3. sums run in a fixed order: a thread over its rows in tile order, a warp
//      by shuffles, a block over its warps, and the grid in block order by the
//      last block to finish (it takes the last ticket of an integer counter,
//      then resets it); no floating-point atomics, so a call repeats bit for
//      bit.  Counts are 32-bit within a tile (one row a thread: E V + ndiv
//      below 2^32) and 64-bit per warp across tiles;
//   4. the seed's 20 edges sit in registers and the edge loop is unrolled: one
//      pass over the factors serves all 20.
// Exact f32 stand-in for the f64 threshold: for f32 w, (double) w >= thr <=>
// w >= thr rounded up to f32 (thr's smallest f32 upper bound).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdges = 20;               // compress._SEED_EDGES
constexpr int kMaxRows = 256;            // parents per tile = threads per block
constexpr int kMinRows = 32;
constexpr int kWarps = kMaxRows / 32;
constexpr int kSmemTarget = 96 * 1024;   // halve P while a tile needs more
constexpr int kSmemLimit = 227 * 1024;

enum Mode { kTotal = 0, kSeed = 1, kCounts = 2, kParents = 3 };

template <typename T>
struct Args {
  const T* fa;             // (n, e)
  const T* fb;             // (n, v)
  const uint8_t* kill;     // (n, e) or null
  const double* u_uni;     // (n,): seed, counts
  const double* w_uni;     // (n,): seed, counts
  const long long* ndiv;   // (n,): seed, counts
  const double* edges;     // (kEdges,): seed
  const T* w_floor;        // counts, parents
  const double* thr;       // counts, parents
  double* out_f;           // total 1, seed 2 kEdges (masses, then costs), counts 1, parents n
  long long* out_i;        // total 1 (0), counts 1, parents n
  double* part_f;          // (grid, kQ) per-block partials: kQ = kEdges (seed), else 1
  long long* part_i;       // (grid, kQ)
  unsigned int* ticket;    // 0 between calls
  int64_t n;
  int e, v, rows;
};

__host__ __device__ __forceinline__ int64_t round16(int64_t b) {
  return (b + 15) & ~int64_t(15);
}

// Shared memory of a tile of `rows` parents: fa rows | fb rows | kill rows,
// each span 16-byte aligned, value rows at odd strides.
template <typename T>
__host__ __device__ int64_t smem_bytes(int64_t rows, int64_t e, int64_t v, bool kill) {
  return round16(rows * (e | 1) * (int64_t)sizeof(T)) +
         round16(rows * (v | 1) * (int64_t)sizeof(T)) + (kill ? round16(rows * e) : 0);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float thr_as(double thr, float) { return __double2float_ru(thr); }
__device__ __forceinline__ double thr_as(double thr, double) { return thr; }

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x = __dadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ long long warp_sum(long long x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ unsigned int warp_sum(unsigned int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Block-wide copy of `count` values, `width` a row, into rows of `stride`.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int count, int width,
                                      int stride) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / width;
    dst[r * stride + (i - r * width)] = src[i];
  }
}

// One parent's joint row in column order.
template <typename T, typename Visit>
__device__ __forceinline__ void walk(const T* a, const T* b, const uint8_t* kill, int e, int v,
                                     Visit&& visit) {
  for (int k = 0; k < e; ++k) {
    const T x = a[k];
    visit(kill != nullptr && kill[k] != 0 ? T(0) : mul_rn(x, b[0]));
    for (int j = 1; j < v; ++j) visit(mul_rn(x, b[j]));
  }
}

// The block's kQ f64 sums (one a thread) and kQ counts (one a warp, in
// `warp_cnt`) as its partials, then, in the last block to finish, the grid's
// sums in block order (seed: the counts go out as f64 after the masses).
template <int kQ, bool kCountsAsF64, typename T>
__device__ void finish(const Args<T>& a, const double (&sum)[kQ],
                       const unsigned long long (&warp_cnt)[kWarps][kQ]) {
  __shared__ double red_f[kWarps][kQ];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const double x = warp_sum(sum[q]);
    if (lane == 0) red_f[warp][q] = x;
  }
  __syncthreads();
  if (t < kQ) {
    double s = 0.0;
    long long c = 0;
    for (int w = 0; w < n_warps; ++w) {
      s = __dadd_rn(s, red_f[w][t]);
      c += (long long)warp_cnt[w][t];
    }
    a.part_f[(int64_t)blockIdx.x * kQ + t] = s;
    a.part_i[(int64_t)blockIdx.x * kQ + t] = c;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int grid = gridDim.x;
  for (int q = warp; q < 2 * kQ; q += n_warps) {
    if (q < kQ) {
      double s = 0.0;
      for (int b = lane; b < grid; b += 32) s = __dadd_rn(s, __ldcg(a.part_f + (int64_t)b * kQ + q));
      s = warp_sum(s);
      if (lane == 0) a.out_f[q] = s;
    } else {
      const int qi = q - kQ;
      long long s = 0;
      for (int b = lane; b < grid; b += 32) s += __ldcg(a.part_i + (int64_t)b * kQ + qi);
      s = warp_sum(s);
      if (lane == 0) {
        if (kCountsAsF64) a.out_f[kQ + qi] = (double)s;
        else a.out_i[qi] = s;
      }
    }
  }
  if (t == 0) *a.ticket = 0u;
}

// The f32 seed keeps two blocks an SM resident (128 registers a thread).
template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxRows, kMode == kSeed && sizeof(T) == 4 ? 2 : 1)
plan_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQ = kMode == kSeed ? kEdges : 1;
  __shared__ unsigned long long warp_cnt[kWarps][kQ];
  __shared__ double edge_f64[kEdges];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ep = a.e | 1, vp = a.v | 1;
  T* fa_s = reinterpret_cast<T*>(smem);
  T* fb_s = reinterpret_cast<T*>(smem + round16((int64_t)a.rows * ep * sizeof(T)));
  uint8_t* kill_s = reinterpret_cast<uint8_t*>(fb_s) + round16((int64_t)a.rows * vp * sizeof(T));

  double sum[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) sum[q] = 0.0;
  if (lane == 0)
    for (int q = 0; q < kQ; ++q) warp_cnt[warp][q] = 0ull;
  T edge[kMode == kSeed ? kEdges : 1];
  T floor_t = T(0), thr_t = T(0);
  double thr = 0.0;
  if constexpr (kMode == kSeed) {
#pragma unroll
    for (int m = 0; m < kEdges; ++m) edge[m] = (T)a.edges[m];   // torch's .to(): nearest
    if (t < kEdges) edge_f64[t] = a.edges[t];
  }
  if constexpr (kMode == kCounts || kMode == kParents) {
    floor_t = *a.w_floor;
    thr = *a.thr;
    thr_t = thr_as(thr, T(0));
  }

  const int64_t tiles = (a.n + a.rows - 1) / a.rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t p0 = tile * a.rows;
    const int np = (int)(a.n - p0 < a.rows ? a.n - p0 : a.rows);
    __syncthreads();   // the last tile's rows are read (and edge_f64 written)
    stage(fa_s, a.fa + p0 * a.e, np * a.e, a.e, ep);
    stage(fb_s, a.fb + p0 * a.v, np * a.v, a.v, vp);
    if (a.kill != nullptr)
      for (int i = t; i < np * a.e; i += blockDim.x) kill_s[i] = a.kill[p0 * a.e + i];
    __syncthreads();
    unsigned int cnt[kQ];   // this tile's row: at most E V + ndiv
#pragma unroll
    for (int q = 0; q < kQ; ++q) cnt[q] = 0u;
    if (t < np) {
      const int64_t p = p0 + t;
      const T* ar = fa_s + t * ep;
      const T* br = fb_s + t * vp;
      const uint8_t* kr = a.kill != nullptr ? kill_s + t * a.e : nullptr;
      if constexpr (kMode == kTotal) {
        walk(ar, br, kr, a.e, a.v, [&](T w) { sum[0] = __dadd_rn(sum[0], (double)w); });
      } else if constexpr (kMode == kSeed) {
        T row[kEdges];
#pragma unroll
        for (int m = 0; m < kEdges; ++m) row[m] = T(0);
        walk(ar, br, kr, a.e, a.v, [&](T w) {
#pragma unroll
          for (int m = 0; m < kEdges; ++m) {
            const bool ge = w >= edge[m];
            row[m] = ge ? add_rn(row[m], w) : row[m];
            cnt[m] += ge;
          }
        });
        const double u = a.u_uni[p], wu = a.w_uni[p];
        const unsigned int nd = (unsigned int)(a.ndiv[p] > 1 ? a.ndiv[p] : 1);
#pragma unroll
        for (int m = 0; m < kEdges; ++m) {
          sum[m] = __dadd_rn(sum[m], (double)row[m]);
          if (u >= edge_f64[m]) {
            sum[m] = __dadd_rn(sum[m], wu);
            cnt[m] += nd;
          }
        }
      } else {
        double rem = 0.0;
        unsigned int kept = 0u;
        walk(ar, br, kr, a.e, a.v, [&](T w) {
          if (w > floor_t && w >= thr_t) ++kept;
          else rem = __dadd_rn(rem, (double)w);
        });
        if constexpr (kMode == kCounts) {
          const double wu = a.w_uni[p];
          if (wu > 0.0 && a.u_uni[p] >= thr) kept += (unsigned int)a.ndiv[p];
          else rem = __dadd_rn(rem, wu);
          sum[0] = __dadd_rn(sum[0], rem);
          cnt[0] = kept;
        } else {
          a.out_f[p] = rem;
          a.out_i[p] = kept;
        }
      }
    }
    if constexpr (kMode == kSeed || kMode == kCounts) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const unsigned int c = warp_sum(cnt[q]);
        if (lane == 0) warp_cnt[warp][q] += c;
      }
    }
  }
  if constexpr (kMode != kParents) finish<kQ, kMode == kSeed>(a, sum, warp_cnt);
}

// The tile rows and shared memory of a launch; false where the shapes do not
// fit the kernel.
template <typename T>
bool tile_of(int64_t n, int64_t e, int64_t v, bool kill, int* rows, int64_t* smem) {
  if (n < 1 || e < 1 || v < 1 || e * v >= INT32_MAX) return false;
  int r = kMaxRows;
  while (r > kMinRows && smem_bytes<T>(r, e, v, kill) > kSmemTarget) r /= 2;
  *rows = r;
  *smem = smem_bytes<T>(r, e, v, kill);
  return *smem <= kSmemLimit;
}

template <typename T, int kMode>
cudaError_t prepare(int rows, int64_t smem, int* per_sm) {
  auto kernel = plan_kernel<T, kMode>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (per_sm == nullptr) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, rows, (size_t)smem);
}

template <typename T>
cudaError_t prepare_mode(int mode, int rows, int64_t smem, int* per_sm) {
  switch (mode) {
    case kTotal: return prepare<T, kTotal>(rows, smem, per_sm);
    case kSeed: return prepare<T, kSeed>(rows, smem, per_sm);
    case kCounts: return prepare<T, kCounts>(rows, smem, per_sm);
    case kParents: return prepare<T, kParents>(rows, smem, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// The grid of a launch: one wave of resident blocks, at most one block a
// tile.
template <typename T>
int64_t grid_of(int mode, int64_t n, int64_t e, int64_t v, bool kill) {
  int rows = 0, dev = 0, sms = 0, per_sm = 0;
  int64_t smem = 0;
  if (!tile_of<T>(n, e, v, kill, &rows, &smem)) return -(int64_t)cudaErrorInvalidValue;
  cudaError_t err = prepare_mode<T>(mode, rows, smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int64_t)err;
  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t g = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  return g < tiles ? g : tiles;
}

template <typename T>
int launch(int mode, Args<T> a, int64_t grid, void* stream) {
  int64_t smem = 0;
  if (!tile_of<T>(a.n, a.e, a.v, a.kill != nullptr, &a.rows, &smem)) return cudaErrorInvalidValue;
  if (grid < 1 || grid > (a.n + a.rows - 1) / a.rows) return cudaErrorInvalidValue;
  const cudaError_t err = prepare_mode<T>(mode, a.rows, smem, nullptr);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kTotal: plan_kernel<T, kTotal><<<grid, a.rows, smem, s>>>(a); break;
    case kSeed: plan_kernel<T, kSeed><<<grid, a.rows, smem, s>>>(a); break;
    case kCounts: plan_kernel<T, kCounts><<<grid, a.rows, smem, s>>>(a); break;
    default: plan_kernel<T, kParents><<<grid, a.rows, smem, s>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

// The grid of a launch of `mode` (the caller allocates that many blocks'
// partials and passes it back to the launch), or minus the CUDA error;
// elem = sizeof(T), 4 or 8.
extern "C" int64_t fries_plan_grid(int mode, int elem, int64_t n, int64_t e, int64_t v,
                                   int has_kill) {
  if (elem == 4) return grid_of<float>(mode, n, e, v, has_kill != 0);
  if (elem == 8) return grid_of<double>(mode, n, e, v, has_kill != 0);
  return -(int64_t)cudaErrorInvalidValue;
}

// fa (n, e), fb (n, v), kill (n, e) bool or NULL; u_uni, w_uni (f64) and
// ndiv (int64), each (n,) (seed, counts); edges (20,) f64 (seed); w_floor (T)
// and thr (f64) device scalars (counts, parents); out_f, out_i, part_f
// (grid, kQ), part_i (grid, kQ) and the ticket as runtime/plan.py allocates
// them; grid from fries_plan_grid.
#define FRIES_PLAN(NAME, T)                                                                 \
  extern "C" int NAME(int mode, const T* fa, const T* fb, const uint8_t* kill,             \
                      const double* u_uni, const double* w_uni, const long long* ndiv,     \
                      const double* edges, const T* w_floor, const double* thr, int64_t n, \
                      int64_t e, int64_t v, double* out_f, long long* out_i,               \
                      double* part_f, long long* part_i, unsigned int* ticket,             \
                      int64_t grid, void* stream) {                                        \
    return launch<T>(mode,                                                                 \
                     Args<T>{fa, fb, kill, u_uni, w_uni, ndiv, edges, w_floor, thr, out_f, \
                             out_i, part_f, part_i, ticket, n, (int)e, (int)v, 0},         \
                     grid, stream);                                                        \
  }

FRIES_PLAN(fries_plan_f32, float)
FRIES_PLAN(fries_plan_f64, double)
