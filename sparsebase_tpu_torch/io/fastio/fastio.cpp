// Native parallel sparse-file parser (PIGO-equivalent), and the
// MatrixMarket body formatter of the port's MTX writer.
//
// The PyTorch port's own copy of sparsebase_tpu/io/fastio/fastio.cpp
// (the analogue of the reference's vendored PIGO layer, reference:
// src/sparsebase/external/pigo/pigo.hpp; io/pigo_mtx_reader.cc,
// io/pigo_edge_list_reader.cc): memory-mapped input + OpenMP chunked
// numeric parsing, exposed through a plain C ABI consumed via ctypes.
// The port adds sbtpu_format_mtx, which writes body lines byte for byte
// as the Python writer does (repr of each value as a double).
//
// Strategy: mmap the file; split the body into per-thread byte ranges
// aligned to line boundaries; two passes (count entries, then parse into
// preallocated arrays at per-chunk offsets). Integer and floating
// parsing are hand-rolled (strtod-free hot loop).

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  madvise(p, st.st_size, MADV_SEQUENTIAL);
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  double v = 0.0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10.0 + (*p++ - '0');
  if (p < end && *p == '.') {
    ++p;
    double frac = 0.0, scale = 1.0;
    while (p < end && *p >= '0' && *p <= '9') {
      frac = frac * 10.0 + (*p - '0');
      scale *= 10.0;
      ++p;
    }
    v += frac / scale;
  }
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    int64_t ex = 0;
    p = parse_i64(p, end, &ex);
    v *= std::pow(10.0, static_cast<double>(ex));
  }
  if (p == start) *out = 0.0;
  else *out = neg ? -v : v;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Split [begin, end) into nchunks line-aligned ranges.
std::vector<std::pair<const char*, const char*>> chunk_lines(
    const char* begin, const char* end, int nchunks) {
  std::vector<std::pair<const char*, const char*>> out;
  size_t total = static_cast<size_t>(end - begin);
  const char* cur = begin;
  for (int i = 0; i < nchunks && cur < end; ++i) {
    const char* target = begin + total * (i + 1) / nchunks;
    const char* stop = (i == nchunks - 1 || target >= end)
                           ? end
                           : next_line(target, end);
    if (stop < cur) stop = cur;
    out.emplace_back(cur, stop);
    cur = stop;
  }
  return out;
}

inline bool is_comment_or_blank(const char* p, const char* end) {
  p = skip_ws(p, end);
  return p >= end || *p == '\n' || *p == '%' || *p == '#';
}

int threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}


// Python's repr() of a double: the shortest digits that read back to v,
// in fixed notation when -4 < decpt <= 16 (decpt: v = 0.d1d2... x 10^decpt)
// with ".0" after a whole number, else d[.ddd]e+XX / e-XX with at least two
// exponent digits; "inf", "-inf", "nan" (any sign), "0.0", "-0.0".
// At most 24 characters.
inline char* put_repr(char* p, double v) {
  if (std::isnan(v)) {
    memcpy(p, "nan", 3);
    return p + 3;
  }
  if (std::signbit(v)) *p++ = '-';
  if (std::isinf(v)) {
    memcpy(p, "inf", 3);
    return p + 3;
  }
  if (v == 0.0) {
    memcpy(p, "0.0", 3);
    return p + 3;
  }
  char buf[32];
  auto res = std::to_chars(buf, buf + sizeof buf, std::fabs(v),
                           std::chars_format::scientific);
  *res.ptr = '\0';  // at most 23 of the 32 bytes: atoi below stops here
  char digits[20];
  int nd = 0;
  const char* q = buf;
  for (; q < res.ptr && *q != 'e'; ++q)
    if (*q != '.') digits[nd++] = *q;
  int exp10 = std::atoi(q + 1);  // "+16", "-05"
  int decpt = exp10 + 1;
  if (decpt > -4 && decpt <= 16) {
    if (decpt <= 0) {
      *p++ = '0';
      *p++ = '.';
      for (int i = 0; i < -decpt; ++i) *p++ = '0';
      memcpy(p, digits, nd);
      p += nd;
    } else if (decpt < nd) {
      memcpy(p, digits, decpt);
      p += decpt;
      *p++ = '.';
      memcpy(p, digits + decpt, nd - decpt);
      p += nd - decpt;
    } else {
      memcpy(p, digits, nd);
      p += nd;
      for (int i = nd; i < decpt; ++i) *p++ = '0';
      *p++ = '.';
      *p++ = '0';
    }
    return p;
  }
  *p++ = digits[0];
  if (nd > 1) {
    *p++ = '.';
    memcpy(p, digits + 1, nd - 1);
    p += nd - 1;
  }
  *p++ = 'e';
  int e = exp10;
  if (e < 0) {
    *p++ = '-';
    e = -e;
  } else {
    *p++ = '+';
  }
  if (e < 10) *p++ = '0';
  return std::to_chars(p, p + 4, e).ptr;
}

inline char* put_i64(char* p, int64_t v) {
  return std::to_chars(p, p + 21, v).ptr;
}

}  // namespace

extern "C" {

// Count data lines (non-comment, non-blank) after `offset` bytes.
// Returns -1 on error.
int64_t sbtpu_count_entries(const char* path, int64_t offset) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  if (offset >= static_cast<int64_t>(m.size)) {
    unmap(m);
    return 0;
  }
  const char* begin = m.data + offset;
  const char* end = m.data + m.size;
  auto chunks = chunk_lines(begin, end, threads() * 4);
  int64_t total = 0;
#pragma omp parallel for reduction(+ : total) schedule(dynamic)
  for (size_t c = 0; c < chunks.size(); ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t local = 0;
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) ++local;
      p = next_line(p, stop);
    }
    total += local;
  }
  unmap(m);
  return total;
}

// Parse whitespace-separated numeric triplets/pairs after `offset` bytes.
// ncols_data: numbers per line to read (2 = pattern, 3 = weighted).
// rows/cols: int64 output arrays of length n; vals: double array or null.
// Returns number of parsed entries, or -1 on error.
int64_t sbtpu_parse_entries(const char* path, int64_t offset, int ncols_data,
                            int64_t n, int64_t* rows, int64_t* cols,
                            double* vals) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  if (offset >= static_cast<int64_t>(m.size)) {
    unmap(m);
    return 0;
  }
  const char* begin = m.data + offset;
  const char* end = m.data + m.size;
  auto chunks = chunk_lines(begin, end, threads() * 4);
  size_t nchunk = chunks.size();
  // pass 1: per-chunk entry counts -> offsets
  std::vector<int64_t> counts(nchunk, 0);
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t local = 0;
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) ++local;
      p = next_line(p, stop);
    }
    counts[c] = local;
  }
  std::vector<int64_t> offsets(nchunk + 1, 0);
  for (size_t c = 0; c < nchunk; ++c) offsets[c + 1] = offsets[c] + counts[c];
  int64_t total = std::min<int64_t>(offsets[nchunk], n);
  // pass 2: parse
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t at = offsets[c];
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) {
        if (at < n) {
          int64_t r = 0, cc = 0;
          const char* q = parse_i64(p, stop, &r);
          q = parse_i64(q, stop, &cc);
          rows[at] = r;
          cols[at] = cc;
          if (ncols_data >= 3 && vals != nullptr) {
            double v = 0.0;
            parse_f64(q, stop, &v);
            vals[at] = v;
          }
        }
        ++at;
      }
      p = next_line(p, stop);
    }
  }
  unmap(m);
  return total;
}

// Parse a dense column of numbers (MTX array format body).
int64_t sbtpu_parse_values(const char* path, int64_t offset, int64_t n,
                           double* vals) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* begin = m.data + offset;
  const char* end = m.data + m.size;
  auto chunks = chunk_lines(begin, end, threads() * 4);
  size_t nchunk = chunks.size();
  std::vector<int64_t> counts(nchunk, 0);
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t local = 0;
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) ++local;
      p = next_line(p, stop);
    }
    counts[c] = local;
  }
  std::vector<int64_t> offsets(nchunk + 1, 0);
  for (size_t c = 0; c < nchunk; ++c) offsets[c + 1] = offsets[c] + counts[c];
  int64_t total = std::min<int64_t>(offsets[nchunk], n);
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t at = offsets[c];
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) {
        if (at < n) {
          double v = 0.0;
          parse_f64(p, stop, &v);
          vals[at] = v;
        }
        ++at;
      }
      p = next_line(p, stop);
    }
  }
  unmap(m);
  return total;
}

// Parallel binary write/read (SBFF data plane; PIGO WFile/ROFile analogue).
int64_t sbtpu_write_file(const char* path, const char* data, int64_t size) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t written = fwrite(data, 1, static_cast<size_t>(size), f);
  fclose(f);
  return static_cast<int64_t>(written);
}

// Parallel argsort by (major, minor) — the host-side row-major COO sort
// (PIGO's reading path ends in the same sort inside the reference's COO
// ctor, format/coo.cc:112-140). np.lexsort is single-threaded and costs
// ~35 s at 50M entries on a 2-core host; packing both keys into one uint64
// and gnu-parallel-sorting (key, index) pairs runs the same sort in a
// few seconds on the available cores. Sorting (key, idx) pairs makes
// ties resolve by original position = exactly np.lexsort's stability.
// width flags: 1 = int64 input, 0 = int32.
int64_t sbtpu_argsort_pairs(int64_t n, const void* major, const void* minor,
                            int major64, int minor64, int64_t* order) {
  if (n <= 0) return 0;
  auto get = [](const void* p, int is64, int64_t i) -> int64_t {
    return is64 ? static_cast<const int64_t*>(p)[i]
                : static_cast<int64_t>(static_cast<const int32_t*>(p)[i]);
  };
  // packable iff both keys fit in uint32 (nonnegative < 2^32)
  bool packable = true;
#pragma omp parallel for reduction(&& : packable) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t a = get(major, major64, i);
    int64_t b = get(minor, minor64, i);
    packable = packable && a >= 0 && a < (int64_t(1) << 32) && b >= 0 &&
               b < (int64_t(1) << 32);
  }
  using P = std::pair<uint64_t, int64_t>;
  std::vector<P> buf(static_cast<size_t>(n));
  if (packable) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
      buf[i] = {(static_cast<uint64_t>(get(major, major64, i)) << 32) |
                    static_cast<uint32_t>(get(minor, minor64, i)),
                i};
#ifdef _OPENMP
    __gnu_parallel::sort(buf.begin(), buf.end());
#else
    std::sort(buf.begin(), buf.end());
#endif
  } else {
    for (int64_t i = 0; i < n; ++i) buf[i] = {0, i};
    std::sort(buf.begin(), buf.end(), [&](const P& x, const P& y) {
      int64_t ax = get(major, major64, x.second), ay = get(major, major64, y.second);
      if (ax != ay) return ax < ay;
      int64_t bx = get(minor, minor64, x.second), by = get(minor, minor64, y.second);
      if (bx != by) return bx < by;
      return x.second < y.second;
    });
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) order[i] = buf[i].second;
  return n;
}

// In-place row-major sort of a PATTERN pair list (no payload): pack the
// (major, minor) u32 keys into one uint64, gnu-parallel-sort the packed
// keys directly, unpack. Half the memory traffic of the (key, index)
// argsort (8 B vs 16 B per element), no order array, and callers skip
// the two apply-gathers — duplicates are bit-identical so stability is
// unobservable. Returns 1 on success, 0 if keys don't fit u32 (caller
// falls back to sbtpu_argsort_pairs).
int64_t sbtpu_sort_packed(int64_t n, int64_t* major, int64_t* minor) {
  if (n <= 0) return 1;
  bool packable = true;
#pragma omp parallel for reduction(&& : packable) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    packable = packable && major[i] >= 0 && major[i] < (int64_t(1) << 32) &&
               minor[i] >= 0 && minor[i] < (int64_t(1) << 32);
  }
  if (!packable) return 0;
  std::vector<uint64_t> buf(static_cast<size_t>(n));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    buf[i] = (static_cast<uint64_t>(major[i]) << 32) |
             static_cast<uint32_t>(minor[i]);
#ifdef _OPENMP
  __gnu_parallel::sort(buf.begin(), buf.end());
#else
  std::sort(buf.begin(), buf.end());
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    major[i] = static_cast<int64_t>(buf[i] >> 32);
    minor[i] = static_cast<int64_t>(buf[i] & 0xffffffffu);
  }
  return 1;
}

// Weighted variant: sort (packed u64 key, f64 value) structs by key in
// place — the value rides the sort, so callers skip the (key, index)
// argsort AND the three apply-gathers. Unstable ties are unobservable
// (duplicate coordinates accumulate). Returns 1, or 0 if keys exceed
// u32 (caller falls back to argsort).
int64_t sbtpu_sort_packed_weighted(int64_t n, int64_t* major, int64_t* minor,
                                   double* vals) {
  if (n <= 0) return 1;
  bool packable = true;
#pragma omp parallel for reduction(&& : packable) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    packable = packable && major[i] >= 0 && major[i] < (int64_t(1) << 32) &&
               minor[i] >= 0 && minor[i] < (int64_t(1) << 32);
  }
  if (!packable) return 0;
  using P = std::pair<uint64_t, double>;
  std::vector<P> buf(static_cast<size_t>(n));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    buf[i] = {(static_cast<uint64_t>(major[i]) << 32) |
                  static_cast<uint32_t>(minor[i]),
              vals[i]};
#ifdef _OPENMP
  __gnu_parallel::sort(buf.begin(), buf.end(),
                       [](const P& a, const P& b) { return a.first < b.first; });
#else
  std::sort(buf.begin(), buf.end(),
            [](const P& a, const P& b) { return a.first < b.first; });
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    major[i] = static_cast<int64_t>(buf[i].first >> 32);
    minor[i] = static_cast<int64_t>(buf[i].first & 0xffffffffu);
    vals[i] = buf[i].second;
  }
  return 1;
}

// MatrixMarket body lines for entries [0, n): "r c\n" (kind 0), "r c i\n"
// (kind 1, i = ivals[k]) or "r c v\n" (kind 2, v = repr of dvals[k]), with
// r = rows[k] + base and c = cols[k] + base; rows == nullptr writes the
// value alone ("v\n", the array format). Lines are at most 72 bytes; out
// holds cap bytes. Returns the bytes written, or -1 if cap is too small.
int64_t sbtpu_format_mtx(int64_t n, const int64_t* rows, const int64_t* cols,
                         int64_t base, int kind, const int64_t* ivals,
                         const double* dvals, char* out, int64_t cap) {
  if (n <= 0) return 0;
  const int64_t kLine = 72;
  int nchunk = static_cast<int>(std::min<int64_t>(threads() * 4, (n + 4095) / 4096));
  std::vector<std::vector<char>> parts(nchunk);
#pragma omp parallel for schedule(dynamic)
  for (int c = 0; c < nchunk; ++c) {
    int64_t lo = n * c / nchunk, hi = n * (c + 1) / nchunk;
    std::vector<char>& buf = parts[c];
    buf.resize(static_cast<size_t>((hi - lo) * kLine));
    char* p = buf.data();
    for (int64_t k = lo; k < hi; ++k) {
      if (rows != nullptr) {
        p = put_i64(p, rows[k] + base);
        *p++ = ' ';
        p = put_i64(p, cols[k] + base);
        if (kind != 0) *p++ = ' ';
      }
      if (kind == 1) p = put_i64(p, ivals[k]);
      else if (kind == 2) p = put_repr(p, dvals[k]);
      *p++ = '\n';
    }
    buf.resize(static_cast<size_t>(p - buf.data()));
  }
  std::vector<int64_t> at(nchunk + 1, 0);
  for (int c = 0; c < nchunk; ++c) at[c + 1] = at[c] + static_cast<int64_t>(parts[c].size());
  if (at[nchunk] > cap) return -1;
#pragma omp parallel for schedule(static)
  for (int c = 0; c < nchunk; ++c) memcpy(out + at[c], parts[c].data(), parts[c].size());
  return at[nchunk];
}

int64_t sbtpu_read_file(const char* path, char* out, int64_t size) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  int64_t n = std::min<int64_t>(size, static_cast<int64_t>(m.size));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i += (1 << 20)) {
    int64_t len = std::min<int64_t>(1 << 20, n - i);
    memcpy(out + i, m.data + i, static_cast<size_t>(len));
  }
  unmap(m);
  return n;
}

}  // extern "C"
