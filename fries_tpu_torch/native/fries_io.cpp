// The native FCIDUMP and vector-file reader of fries_tpu_torch: the FCIDUMP
// record body and bulk numeric tables (values, u64 determinant masks) parsed
// at memory speed instead of a Python loop per token.
//
// A copy of the reference package's fries_tpu/native/fries_io.cpp (the port
// keeps its own and imports nothing of the reference), which mirrors the
// original framework's C++ readers (FRIES/io_utils.cpp:236-357 integral
// records, :410-480 text vectors).  Python parses the small FCIDUMP header.
//
// Loaded with ctypes by fries_tpu_torch/native/__init__.py, built with
// g++ -O3 at first use.  Every function is plain C ABI, allocates nothing
// the caller keeps, and returns a negative errno on I/O failure.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Read the whole file into a NUL-terminated heap buffer.
// Returns byte count (excluding the NUL) or -errno.
long read_all(const char *path, char **out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -(long)errno;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return -(long)errno;
  }
  std::fseek(f, 0, SEEK_SET);
  char *buf = (char *)std::malloc((size_t)n + 1);
  if (!buf) {
    std::fclose(f);
    return -ENOMEM;
  }
  size_t got = std::fread(buf, 1, (size_t)n, f);
  std::fclose(f);
  buf[got] = '\0';
  *out = buf;
  return (long)got;
}

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v';
}

}  // namespace

extern "C" {

// Parse FCIDUMP integral records starting at byte `offset`:
//   val i j k l     (chemist notation, 1-based; 0 indices flag specials)
// Fills hcore (n*n, symmetric) and eris_chem (n^4, all 8 images), sets
// *core_energy from the 0 0 0 0 record.  Lines without exactly five
// parsable fields are skipped (matching the Python reader's
// `len(parts) != 5` guard).  Returns the record count or -errno.
long fries_parse_fcidump_body(const char *path, long offset, long n_orb,
                              double *hcore, double *eris_chem,
                              double *core_energy) {
  char *buf;
  long n = read_all(path, &buf);
  if (n < 0) return n;
  if (offset < 0) offset = 0;
  if (offset > n) offset = n;
  const char *p = buf + offset;
  const char *end = buf + n;
  const long N = n_orb;
  long nrec = 0;

  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', (size_t)(end - p));
    if (!nl) nl = end;

    double val = 0.0;
    long idx[4] = {0, 0, 0, 0};
    int ntok = 0;
    bool ok = true;
    const char *q = p;
    while (q < nl) {
      while (q < nl && is_space(*q)) q++;
      if (q >= nl) break;
      if (ntok >= 5) {  // a sixth token disqualifies the line
        ntok++;
        break;
      }
      char *qe;
      if (ntok == 0) {
        val = strtod(q, &qe);
      } else {
        idx[ntok - 1] = strtol(q, &qe, 10);
      }
      if (qe == q || qe > nl) {
        ok = false;
        break;
      }
      q = qe;
      ntok++;
    }

    if (ok && ntok == 5) {
      long i = idx[0], j = idx[1], k = idx[2], l = idx[3];
      if (i == 0 && j == 0 && k == 0 && l == 0) {
        *core_energy = val;
      } else if (k == 0 && l == 0) {
        if (j != 0) {  // j == 0 records are orbital energies: ignored
          hcore[(i - 1) * N + (j - 1)] = val;
          hcore[(j - 1) * N + (i - 1)] = val;
        }
      } else {
        i--, j--, k--, l--;
        const long ab[2][2] = {{i, j}, {j, i}};
        const long cd[2][2] = {{k, l}, {l, k}};
        for (int x = 0; x < 2; x++) {
          for (int y = 0; y < 2; y++) {
            long a = ab[x][0], b = ab[x][1];
            long c = cd[y][0], d = cd[y][1];
            eris_chem[((a * N + b) * N + c) * N + d] = val;
            eris_chem[((c * N + d) * N + a) * N + b] = val;
          }
        }
      }
      nrec++;
    }
    p = nl + 1;
  }
  std::free(buf);
  return nrec;
}

// Parse every whitespace-separated floating-point token in the file.
// Returns the token count (<= max_out) or -errno; unparsable tokens are
// skipped.  Callers size `out` as filesize/2 + 1 (each token needs at least
// one digit plus one separator byte).
long fries_parse_doubles(const char *path, double *out, long max_out) {
  char *buf;
  long n = read_all(path, &buf);
  if (n < 0) return n;
  const char *q = buf;
  const char *end = buf + n;
  long cnt = 0;
  while (q < end && cnt < max_out) {
    while (q < end && (is_space(*q) || *q == '\n')) q++;
    if (q >= end) break;
    char *qe;
    double v = strtod(q, &qe);
    if (qe == q) {  // skip the unparsable token
      while (q < end && !is_space(*q) && *q != '\n') q++;
      continue;
    }
    out[cnt++] = v;
    q = qe;
  }
  std::free(buf);
  return cnt;
}

// Parse every whitespace-separated decimal token as uint64 (determinant
// bit-mask files, one per line).  Same contract as fries_parse_doubles.
long fries_parse_u64(const char *path, unsigned long long *out, long max_out) {
  char *buf;
  long n = read_all(path, &buf);
  if (n < 0) return n;
  const char *q = buf;
  const char *end = buf + n;
  long cnt = 0;
  while (q < end && cnt < max_out) {
    while (q < end && (is_space(*q) || *q == '\n')) q++;
    if (q >= end) break;
    char *qe;
    unsigned long long v = strtoull(q, &qe, 10);
    if (qe == q) {
      while (q < end && !is_space(*q) && *q != '\n') q++;
      continue;
    }
    out[cnt++] = v;
    q = qe;
  }
  std::free(buf);
  return cnt;
}

}  // extern "C"
