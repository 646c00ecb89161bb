// The walker attempt pass of initiator FCIQMC (kernel G): for each attempt
// slot, one heat-bath double or one uniform single drawn, weighed and keyed
// in registers.
//
// Replaces no TPU kernel: the JAX package leaves this pass to XLA
// (fries_tpu/drivers/fciqmc.py).  Contract (fries_tpu_torch/runtime/attempt.py;
// the plain version is drivers/fciqmc._attempt_pass_plain): slot k belongs to
// the arena row p = parent[k].  Where valid[k], it draws u = element k of a
// key node's uniforms (rng.KeyTree: splitmix64 of k * GOLDEN + node key, its
// top 53 bits times 2^-53) and is a double where u(split) < p_doub:
//
//   double  four categorical draws (o1 over the electrons by s_tens, o2 by
//           d_same / d_diff given o1, u1 over o1's spin's empty orbitals by
//           exch_sqrt[o1], u2 over the symmetry row by exch_sqrt[o2]), each by
//           compress.sample_categorical_rows' rule; its probability
//           heat_bath.norm_weight's, both orders of selection summed;
//   single  an electron with an allowed single, then one of its allowed empty
//           orbitals, uniformly (near_uniform.sample_singles);
//
// then the element (molecule.doub_matr_el / sing_matr_el), the parity and
// the new key (dets.double_parity / single_parity), and writes the spawn
// before rounding, -(eps * mel / prob * (1 / p)) * sign * walk_sign[p], its
// key and the initiator flag n_walk[p] > init_thresh.  Slots that are not
// valid, or whose draw is not, write 0.  Where a result meets a draw (the
// categorical totals and f32 prefixes, and the spawn, whose fraction meets
// the binomial rounding) the arithmetic is round-to-nearest f64 operations
// (__dadd_rn, __dmul_rn: never contracted) in the torch path's order; the
// rows' normalizing sums, the single's element and norm_weight's sums run
// left to right, torch's reductions in their own order, so a value may differ
// from the plain version's in its last bits.
//
// Bound on the H100: per slot it reads the parent's index and flag (9 B),
// its key (8 W B), occupied list (8 E B), n_walk and walk_sign (16 B) and
// writes the spawn, its key and the flag (9 + 8 W B): ~150 B a slot at N2's
// shapes, ~0.75 ms for 2^24 slots at 3.35 TB/s; about 2,000 f64 operations a
// double (four categorical rows of up to 26 columns, norm_weight's sums over
// the orbitals), ~1 ms at 33.5 TFLOP/s.  The plain version builds
// (2^24, K) rows of bits, weights and gathers for every slot, a double and a
// single each.  Design:
//   1. a block stages the heat-bath tables (d_same, d_diff, exch_sqrt, s_tens,
//      exch_norms, exch_sqrt's sums per irrep) and the symmetry tables in
//      shared memory once, then walks the slots in a grid-stride loop, one
//      slot a thread: the per-slot loads and stores are coalesced, and
//      consecutive slots mostly share a parent, whose rows L1 serves;
//   2. a slot samples only the excitation it takes: the generator is indexed
//      by slot, so the draws of the other sampler are never needed;
//   3. a categorical row is walked three times (its norm, its f64 total, its
//      f32 prefix), each column's weight recomputed from the tables, so no
//      row is held in memory or in a register array; occupancy is two 64-bit
//      words of the key, per-(irrep, spin) counts eight bits each in two more;
//   4. no state is shared between slots (the fallback count is an integer
//      atomic), so a launch repeats bit for bit; eris and hcore are read
//      through L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOrb = 64;              // runtime/attempt.py MAX_ORB
constexpr int kMaxElec = 32;             // runtime/attempt.py MAX_ELEC
constexpr int kIrreps = 8;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMul1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMul2 = 0x94D049BB133111EBull;

struct Args {
  const long long* keys;          // (rows, w): 32-bit words in int64
  const long long* occ;           // (rows, e) at row stride occ_stride: occupied spin orbitals
  const double* n_walk;           // (rows,)
  const double* walk_sign;        // (rows,)
  const long long* parent;        // (a,)
  const uint8_t* valid;           // (a,)
  const double* ftab;             // d_same | d_diff | exch_sqrt (n n each) | s_tens |
                                  // exch_norms (n each) | symm_sums (n 8)
  const int* itab;                // symm (n) | symm_counts (8) | lookup (8, maxc)
  const double* hcore;            // (t, t)
  const double* eris;             // (t, t, t, t)
  long long* words_out;           // (a, w)
  double* val_out;                // (a,)
  uint8_t* ini_out;               // (a,)
  long long* exc_out;             // (a,) or null: the draws, packed
  unsigned long long* fallback;   // (1,) or null
  uint64_t key_split, key_d[4], key_s[2];
  double eps, p_doub, inv_p_doub, inv_p_sing, init_thresh;
  long long a, occ_stride;
  int n, e, w, maxc, t, hf;
};

struct Tabs {
  const double *d_same, *d_diff, *exch, *s_tens, *exch_norms, *symm_sums;
  const int *symm, *symm_counts, *lookup;
};

__host__ __device__ __forceinline__ int n_ftab(int n) { return 3 * n * n + 2 * n + kIrreps * n; }
__host__ __device__ __forceinline__ int n_itab(int n, int maxc) {
  return n + kIrreps + kIrreps * maxc;
}
__host__ __device__ __forceinline__ int smem_bytes(int n, int maxc) {
  return n_ftab(n) * (int)sizeof(double) + ((n_itab(n, maxc) * (int)sizeof(int) + 15) & ~15);
}

__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }

// Element k of the uniforms of the node with key `key` (rng.KeyTree.uniform).
__device__ __forceinline__ double uniform(uint64_t key, uint64_t k) {
  uint64_t z = k * kGolden + key;
  z = (z ^ (z >> 30)) * kMul1;
  z = (z ^ (z >> 27)) * kMul2;
  z ^= z >> 31;
  return (double)(z >> 11) * 0x1.0p-53;
}

// min(trunc(u * count), max(count - 1, 0)): near_uniform._uniform_index.
__device__ __forceinline__ int uniform_index(double u, int count) {
  const int r = (int)mul(u, (double)count);
  const int top = count - 1 > 0 ? count - 1 : 0;
  return r < top ? r : top;
}

// A determinant's bits 0..127 (words 0-1, 2-3).
struct Det {
  uint64_t lo, hi;
};

__device__ __forceinline__ Det load_det(const long long* words, int w) {
  Det d{0, 0};
  d.lo = (uint64_t)words[0] & 0xFFFFFFFFull;
  if (w > 1) d.lo |= ((uint64_t)words[1] & 0xFFFFFFFFull) << 32;
  if (w > 2) d.hi = (uint64_t)words[2] & 0xFFFFFFFFull;
  if (w > 3) d.hi |= ((uint64_t)words[3] & 0xFFFFFFFFull) << 32;
  return d;
}

__device__ __forceinline__ bool bit_at(const Det& d, int pos) {
  return pos < 64 ? (d.lo >> pos) & 1 : (d.hi >> (pos - 64)) & 1;
}

// Bit `pos` with pos clamped to [0, n_bits - 1] (heat_bath.dets_read).
__device__ __forceinline__ bool bit_clamped(const Det& d, int pos, int n_bits) {
  return bit_at(d, pos < 0 ? 0 : (pos > n_bits - 1 ? n_bits - 1 : pos));
}

__device__ __forceinline__ void flip(Det& d, int pos, bool on) {
  if (pos < 0 || pos >= 128) return;
  uint64_t& x = pos < 64 ? d.lo : d.hi;
  const uint64_t m = 1ull << (pos & 63);
  x = on ? (x | m) : (x & ~m);
}

// Set bits below position p, 0 <= p <= 128.
__device__ __forceinline__ int bits_below(const Det& d, int p) {
  const uint64_t mlo = p >= 64 ? ~0ull : ((1ull << p) - 1);
  const uint64_t mhi = p <= 64 ? 0ull : (p >= 128 ? ~0ull : ((1ull << (p - 64)) - 1));
  return __popcll(d.lo & mlo) + __popcll(d.hi & mhi);
}

// dets.excite_sign: (-1)^(set bits strictly between cre and des).
__device__ __forceinline__ double excite_sign(const Det& d, int cre, int des) {
  const int lo = cre < des ? cre : des, hi = cre < des ? des : cre;
  return ((bits_below(d, hi) - bits_below(d, lo + 1)) & 1) ? -1.0 : 1.0;
}

// compress.sample_categorical_rows on one row of k columns, whose weights
// `cols(visit)` visits in column order, normalized as heat_bath._normalize
// (w / max(norm, 1e-300)); `*norm` gets the row's norm.
template <typename Cols>
__device__ __forceinline__ int categorical(double u, int k, const Cols& cols, double* norm,
                                           unsigned long long* fallback) {
  double s = 0.0;
  cols([&](int, double w) { s = add(s, w); });
  *norm = s;
  const double div = s < 1e-300 ? 1e-300 : s;
  double tot = 0.0;
  cols([&](int, double w) { tot = add(tot, w / div); });
  const double x = mul(u, tot);
  float acc = 0.0f;
  int idx = 0, last = k - 1;
  cols([&](int c, double w) {
    const double p = w / div;
    acc = __fadd_rn(acc, __double2float_rn(p));
    idx += (double)acc <= x ? 1 : 0;
    if (p > 0.0) last = c;
  });
  if (idx < k) return idx;
  if (fallback != nullptr && last < k - 1) atomicAdd(fallback, 1ull);
  return last;
}

// heat_bath.norm_weight for o1 < o2, u1 < u2 (spin orbitals).
__device__ double norm_weight(const Tabs& tb, int n, const Det& d, int o1, int o2, int u1,
                              int u2) {
  const int o1s = o1 % n, o2s = o2 % n, u1s = u1 % n, u2s = u2 % n;
  const int o1spin = o1 / n, o2spin = o2 / n;
  const bool same = o1spin == o2spin;
  double s_denom = 0.0, d1 = 0.0, d2 = 0.0, x1 = 0.0, x2 = 0.0;
  for (int t = 0; t < n; ++t) {
    const double na = bit_at(d, t) ? 1.0 : 0.0, nb = bit_at(d, n + t) ? 1.0 : 0.0;
    s_denom = add(s_denom, mul(tb.s_tens[t], add(na, nb)));
    const double ns1 = o1spin == 0 ? na : nb, nd1 = o1spin == 0 ? nb : na;
    const double ns2 = o2spin == 0 ? na : nb, nd2 = o2spin == 0 ? nb : na;
    d1 = add(d1, add(mul(tb.d_same[o1s * n + t], ns1), mul(tb.d_diff[o1s * n + t], nd1)));
    d2 = add(d2, add(mul(tb.d_same[o2s * n + t], ns2), mul(tb.d_diff[o2s * n + t], nd2)));
    x1 = add(x1, mul(tb.exch[o1s * n + t], ns1));
    x2 = add(x2, mul(tb.exch[o2s * n + t], ns2));
  }
  const double e1_virt = sub(tb.exch_norms[o1s], x1), e2_virt = sub(tb.exch_norms[o2s], x2);
  const int g1 = tb.symm[u1s], g2 = tb.symm[u2s];
  const double exo1u1 = tb.exch[o1s * n + u1s], exo1u2 = tb.exch[o1s * n + u2s];
  const double exo2u1 = tb.exch[o2s * n + u1s], exo2u2 = tb.exch[o2s * n + u2s];
  const bool excl = same && g1 == g2;
  const double e2_no1 = sub(tb.symm_sums[o2s * kIrreps + g2], excl ? exo2u1 : 0.0);
  const double e1_no1 = sub(tb.symm_sums[o1s * kIrreps + g2], excl ? exo1u1 : 0.0);
  const double e2_no2 = sub(tb.symm_sums[o2s * kIrreps + g1], excl ? exo2u2 : 0.0);
  const double e1_no2 = sub(tb.symm_sums[o1s * kIrreps + g1], excl ? exo1u2 : 0.0);
  auto sdiv = [](double x, double y) { return y == 0.0 ? 0.0 : x / y; };
  const double so1 = tb.s_tens[o1s], so2 = tb.s_tens[o2s];
  if (same) {
    const double first = mul(sdiv(so1, mul(d1, e1_virt)), add(sdiv(mul(exo1u1, exo2u2), e2_no1),
                                                              sdiv(mul(exo1u2, exo2u1), e2_no2)));
    const double second = mul(sdiv(so2, mul(d2, e2_virt)), add(sdiv(mul(exo2u1, exo1u2), e1_no1),
                                                               sdiv(mul(exo2u2, exo1u1), e1_no2)));
    return mul(tb.d_same[o1s * n + o2s] / s_denom, add(first, second));
  }
  const double sum = add(sdiv(mul(so1, tb.d_diff[o1s * n + o2s]), mul(mul(d1, e1_virt), e2_no1)),
                         sdiv(mul(so2, tb.d_diff[o2s * n + o1s]), mul(mul(d2, e2_virt), e1_no2)));
  return mul(mul(sum, exo1u1), exo2u2) / s_denom;
}

__device__ __forceinline__ double eri(const Args& a, int p, int q, int r, int s) {
  const long long t = a.t;
  return a.eris[((p * t + q) * t + r) * t + s];
}

// molecule.sing_matr_el for o -> u over the occupied list `occ`.
__device__ double sing_matr_el(const Args& a, const long long* occ, int o, int u) {
  const int n = a.n, so = o % n + a.hf, su = u % n + a.hf, spin = o / n;
  double coul = 0.0, exch = 0.0;
  for (int j = 0; j < a.e; ++j) {
    const int oj = (int)occ[j], sp = oj % n + a.hf;
    coul = add(coul, eri(a, so, sp, su, sp));
    if (oj / n == spin) exch = add(exch, eri(a, so, sp, sp, su));
  }
  double mel = sub(add(a.hcore[(long long)so * a.t + su], coul), exch);
  if (a.hf > 0) {
    double cf = 0.0, xf = 0.0;
    for (int t = 0; t < a.hf; ++t) {
      cf = add(cf, eri(a, so, t, su, t));
      xf = add(xf, eri(a, so, t, t, su));
    }
    mel = sub(add(mel, mul(2.0, cf)), xf);
  }
  return mel;
}

// One slot's heat-bath double: returns the spawn before rounding (0 where the
// draw is not valid) and sets its key; `code` gets the draws.
__device__ double hb_double(const Args& a, const Tabs& tb, long long k, const Det& det,
                            const long long* occ, double ws, Det* out, long long* code) {
  const int n = a.n, e = a.e, half = e / 2, nv = n - half;
  double norm1, norm2, norm3, norm4;
  const int i1 = categorical(
      uniform(a.key_d[0], k), e,
      [&](auto visit) {
        for (int j = 0; j < e; ++j) visit(j, tb.s_tens[(int)(occ[j] % n)]);
      },
      &norm1, a.fallback);
  const int o1 = (int)occ[i1], o1s = o1 % n, o1spin = o1 / n;
  const int i2 = categorical(
      uniform(a.key_d[1], k), e,
      [&](auto visit) {
        for (int j = 0; j < e; ++j) {
          const int col = o1s * n + (int)(occ[j] % n);
          const double w = ((j >= half ? 1 : 0) == o1spin) ? tb.d_same[col] : tb.d_diff[col];
          visit(j, j == i1 ? 0.0 : w);
        }
      },
      &norm2, a.fallback);
  const int o2 = (int)occ[i2], o2s = o2 % n;
  const int off1 = o1spin == 0 ? 0 : n;
  const int c3 = categorical(
      uniform(a.key_d[2], k), nv,
      [&](auto visit) {
        int c = 0;
        for (int t = 0; t < n && c < nv; ++t)
          if (!bit_at(det, off1 + t)) visit(c++, tb.exch[o1s * n + t]);
        for (; c < nv; ++c) visit(c, 0.0);
      },
      &norm3, a.fallback);
  int u1_sp = n;   // the column's orbital (n past the empty ones, as virtual_slots pads)
  for (int t = 0, c = 0, want = c3 < nv - 1 ? c3 : nv - 1; t < n; ++t) {
    if (!bit_at(det, off1 + t) && c++ == want) {
      u1_sp = t;
      break;
    }
  }
  const int u1 = (u1_sp < n ? u1_sp : 0) + o1spin * n, u1s = u1 % n;
  const bool same_spin = o1spin == o2 / n;
  const int* row = tb.lookup + (tb.symm[o1s] ^ tb.symm[o2s] ^ tb.symm[u1s]) * a.maxc;
  const int c4 = categorical(
      uniform(a.key_d[3], k), a.maxc,
      [&](auto visit) {
        for (int c = 0; c < a.maxc; ++c) {
          const int r = row[c];
          visit(c, r < n && !(same_spin && r == u1s) ? tb.exch[o2s * n + r] : 0.0);
        }
      },
      &norm4, a.fallback);
  const int u2_sp = row[c4 < a.maxc - 1 ? c4 : a.maxc - 1];
  const int u2 = (u2_sp < n ? u2_sp : 0) + (o2 / n) * n;
  const bool valid = norm1 > 0.0 && norm2 > 0.0 && norm3 > 0.0 && norm4 > 0.0 && u1_sp < n &&
                     u2_sp < n && !bit_clamped(det, u2, 2 * n) && u1 != u2 && o1 != o2;
  const int ol = o1 < o2 ? o1 : o2, oh = o1 < o2 ? o2 : o1;
  const int ul = u1 < u2 ? u1 : u2, uh = u1 < u2 ? u2 : u1;
  *code = 1 | (valid ? 2 : 0) | ((long long)ol << 8) | ((long long)oh << 16) |
          ((long long)ul << 24) | ((long long)uh << 32);
  if (!valid) return 0.0;
  const double prob = norm_weight(tb, n, det, ol, oh, ul, uh);
  const int hf = a.hf;
  const int s0 = ol % n + hf, s1 = oh % n + hf, s2 = ul % n + hf, s3 = uh % n + hf;
  const double mel = sub(eri(a, s0, s1, s2, s3), ol / n == oh / n ? eri(a, s0, s1, s3, s2) : 0.0);
  Det cleared = det;
  flip(cleared, ol, false);
  flip(cleared, oh, false);
  const double sign = excite_sign(cleared, ul, ol) * excite_sign(cleared, uh, oh);
  *out = cleared;
  flip(*out, ul, true);
  flip(*out, uh, true);
  const double mag = mul(mul(a.eps, mel) / prob, a.inv_p_doub);
  return mul(mul(-mag, sign), ws);
}

// One slot's uniform single, as hb_double.
__device__ double single(const Args& a, const Tabs& tb, long long k, const Det& det,
                         const long long* occ, double ws, Det* out, long long* code) {
  const int n = a.n, e = a.e, half = e / 2;
  // occupied counts per (irrep, electron slot's spin), 8 bits each
  uint64_t held_lo = 0, held_hi = 0;   // keys 0-7, 8-15
  for (int j = 0; j < e; ++j) {
    const int key = tb.symm[(int)(occ[j] % n)] * 2 + (j >= half ? 1 : 0);
    (key < 8 ? held_lo : held_hi) += 1ull << ((key & 7) * 8);
  }
  auto per_elec = [&](int j) {
    const int key = tb.symm[(int)(occ[j] % n)] * 2 + (j >= half ? 1 : 0);
    const uint64_t held = key < 8 ? held_lo : held_hi;
    return tb.symm_counts[key >> 1] - (int)((held >> ((key & 7) * 8)) & 0xFF);
  };
  int n_allowed = 0;
  for (int j = 0; j < e; ++j) n_allowed += per_elec(j) > 0 ? 1 : 0;
  const int e_rank = uniform_index(uniform(a.key_s[0], k), n_allowed > 1 ? n_allowed : 1);
  int e_idx = 0;
  bool found_e = false;
  for (int j = 0, r = 0; j < e; ++j) {
    if (per_elec(j) > 0) {
      if (r == e_rank) {
        e_idx = j;
        found_e = true;
        break;
      }
      ++r;
    }
  }
  bool valid = n_allowed > 0 && found_e;
  if (!valid) e_idx = 0;
  const int o = (int)occ[e_idx], o_spin = o / n;
  const int* row = tb.lookup + tb.symm[o % n] * a.maxc;
  const int m_allow = per_elec(e_idx);
  const int u_rank = uniform_index(uniform(a.key_s[1], k), m_allow > 1 ? m_allow : 1);
  int u_col = 0;
  bool found_u = false;
  for (int c = 0, r = 0; c < a.maxc; ++c) {
    const int orb = row[c];
    if (orb < n && !bit_clamped(det, orb + o_spin * n, 2 * n)) {
      if (r == u_rank) {
        u_col = c;
        found_u = true;
        break;
      }
      ++r;
    }
  }
  const int u_orb = row[u_col];
  const int u = (u_orb < n ? u_orb : 0) + o_spin * n;
  valid = valid && m_allow > 0 && found_u;
  *code = (valid ? 2 : 0) | ((long long)o << 8) | ((long long)u << 16);
  if (!valid) return 0.0;
  const double prob = (1.0 / (double)m_allow) / (double)n_allowed;
  const double mel = sing_matr_el(a, occ, o, u);
  Det cleared = det;
  flip(cleared, o, false);
  const double sign = excite_sign(cleared, u, o);
  *out = cleared;
  flip(*out, u, true);
  const double mag = mul(mul(a.eps, mel) / prob, a.inv_p_sing);
  return mul(mul(-mag, sign), ws);
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) attempt_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n;
  double* f = reinterpret_cast<double*>(smem);
  int* g = reinterpret_cast<int*>(f + n_ftab(n));
  stage(f, a.ftab, n_ftab(n));
  stage(g, a.itab, n_itab(n, a.maxc));
  __syncthreads();
  const Tabs tb{f, f + n * n, f + 2 * n * n, f + 3 * n * n, f + 3 * n * n + n,
                f + 3 * n * n + 2 * n, g, g + n, g + n + kIrreps};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < a.a; k += stride) {
    const long long p = a.parent[k];
    a.ini_out[k] = a.n_walk[p] > a.init_thresh ? 1 : 0;
    double val = 0.0;
    Det out{0, 0};
    long long code = -1;
    if (a.valid[k]) {
      const Det det = load_det(a.keys + p * a.w, a.w);
      const long long* occ = a.occ + p * a.occ_stride;
      const double ws = a.walk_sign[p];
      if (uniform(a.key_split, (uint64_t)k) < a.p_doub)
        val = hb_double(a, tb, k, det, occ, ws, &out, &code);
      else
        val = single(a, tb, k, det, occ, ws, &out, &code);
    }
    a.val_out[k] = val;
    long long* wo = a.words_out + k * a.w;
    wo[0] = (long long)(out.lo & 0xFFFFFFFFull);
    if (a.w > 1) wo[1] = (long long)(out.lo >> 32);
    if (a.w > 2) wo[2] = (long long)(out.hi & 0xFFFFFFFFull);
    if (a.w > 3) wo[3] = (long long)(out.hi >> 32);
    if (a.exc_out != nullptr) a.exc_out[k] = code;
  }
}

bool fits(const Args& a) {
  return a.n >= 1 && a.n <= kMaxOrb && a.e >= 2 && a.e <= kMaxElec && a.e / 2 < a.n &&
         a.w == (2 * a.n + 31) / 32 && a.maxc >= 1 && a.maxc <= kMaxOrb && a.t >= a.n + a.hf &&
         a.hf >= 0 && a.a >= 0 && a.occ_stride >= a.e;
}

int launch(const Args& a, void* stream) {
  if (!fits(a)) return cudaErrorInvalidValue;
  if (a.a == 0) return cudaSuccess;
  const int smem = smem_bytes(a.n, a.maxc);
  cudaError_t err = cudaFuncSetAttribute(attempt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attempt_kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  const long long tiles = (a.a + kThreads - 1) / kThreads;
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long grid = tiles < wave ? tiles : wave;
  attempt_kernel<<<(unsigned int)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

// keys (rows, w) int64, occ (rows, e) int64 at row stride occ_stride; n_walk,
// walk_sign (rows,) f64; parent (a,) int64, valid (a,) bool; ftab (3 n^2 + 10 n,) f64 and itab
// (n + 8 + 8 maxc,) int32 as runtime/attempt.py builds them; hcore (t, t),
// eris (t, t, t, t) f64; out: words (a, w) int64, values (a,) f64, initiator
// flags (a,) bool, exc (a,) int64 or NULL, fallback (1,) int64 or NULL.
// node_keys (host, 7): split, the doubles' four, the singles' two; scalars
// (host, 5): eps, p_doub, 1 / p_doub, 1 / (1 - p_doub), init_thresh.
extern "C" int fries_attempt(const long long* keys, const long long* occ, const double* n_walk,
                             const double* walk_sign, const long long* parent,
                             const uint8_t* valid, const double* ftab, const int* itab,
                             const double* hcore, const double* eris, long long* words_out,
                             double* val_out, uint8_t* ini_out, long long* exc_out,
                             unsigned long long* fallback, const unsigned long long* node_keys,
                             const double* scalars, long long a, long long occ_stride, int n,
                             int e, int w, int maxc, int t, int hf, void* stream) {
  Args args{keys,   occ,    n_walk,    walk_sign, parent,  valid, ftab,
            itab,   hcore,  eris,      words_out, val_out, ini_out, exc_out,
            fallback, node_keys[0], {node_keys[1], node_keys[2], node_keys[3], node_keys[4]},
            {node_keys[5], node_keys[6]}, scalars[0], scalars[1], scalars[2], scalars[3],
            scalars[4], a, occ_stride, n, e, w, maxc, t, hf};
  return launch(args, stream);
}
