// Native host library of the data loader and the host predictor.
//
// The reference's DatasetLoader reads training text through C++ parsers
// (src/io/parser.cpp CSV/TSV/LibSVM + PipelineReader); this is the
// port's native front-end: a small C++17 shared library, loaded through
// ctypes (lightgbm_tpu_torch/native/__init__.py), that turns delimited
// text / LibSVM into dense row-major double matrices, finds bin bounds,
// maps values to bins and walks a packed forest over host rows. The
// same source as the JAX package's native library, built apart.
// Parsing is parallelized over line ranges with std::thread (the
// reference parallelizes by OpenMP rows, dataset_loader.cpp).
//
// Plain C ABI on purpose: no Python.h, no pybind11 — the caller owns
// NumPy allocation and copies out of the returned malloc'd buffer.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <limits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  ~FileBuf() { std::free(data); }
};

bool read_file(const char* path, FileBuf* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->data = static_cast<char*>(std::malloc(static_cast<size_t>(sz) + 1));
  if (!out->data) {
    std::fclose(f);
    return false;
  }
  size_t rd = std::fread(out->data, 1, static_cast<size_t>(sz), f);
  std::fclose(f);
  out->size = rd;
  out->data[rd] = '\0';
  return true;
}

// line start offsets (excluding trailing empty line)
std::vector<size_t> line_starts(const char* s, size_t n) {
  std::vector<size_t> starts;
  size_t i = 0;
  while (i < n) {
    starts.push_back(i);
    const char* nl = static_cast<const char*>(std::memchr(s + i, '\n', n - i));
    if (!nl) break;
    i = static_cast<size_t>(nl - s) + 1;
  }
  return starts;
}

size_t line_end(const char* s, size_t n, size_t start) {
  const char* nl =
      static_cast<const char*>(std::memchr(s + start, '\n', n - start));
  size_t e = nl ? static_cast<size_t>(nl - s) : n;
  while (e > start && (s[e - 1] == '\r')) --e;
  return e;
}

// `bad` (optional): set to true when the token is non-empty, not a
// recognized missing-value token, and not fully numeric — callers use
// it to fail the whole parse so the Python fallback (np.loadtxt, which
// RAISES on such tokens) keeps native and fallback behavior aligned.
double parse_field(const char* b, const char* e, bool* bad = nullptr) {
  while (b < e && std::isspace(static_cast<unsigned char>(*b))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(e[-1]))) --e;
  if (b == e) return std::nan("");
  if ((e - b) <= 4) {
    // na / nan / null / none / ? (Common::AtofPrecise missing tokens)
    char buf[5];
    int k = 0;
    for (const char* p = b; p < e; ++p)
      buf[k++] = static_cast<char>(std::tolower(static_cast<unsigned char>(*p)));
    buf[k] = '\0';
    if (!std::strcmp(buf, "na") || !std::strcmp(buf, "nan") ||
        !std::strcmp(buf, "null") || !std::strcmp(buf, "none") ||
        !std::strcmp(buf, "?"))
      return std::nan("");
  }
  char* endp = nullptr;
  std::string tmp(b, e);  // strtod needs NUL termination
  double v = std::strtod(tmp.c_str(), &endp);
  if (endp == tmp.c_str() || *endp != '\0') {
    if (bad) *bad = true;
    return std::nan("");
  }
  return v;
}

int n_threads_for(size_t rows) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  size_t by_rows = rows / 4096 + 1;
  return static_cast<int>(by_rows < hw ? by_rows : hw);
}

}  // namespace

extern "C" {

// Parse a delimited numeric file into a dense row-major matrix.
// Returns 0 on success; caller frees *out with fp_free.
int fp_parse_delim(const char* path, char delim, int skip_rows,
                   double** out, int64_t* out_rows, int64_t* out_cols) {
  FileBuf fb;
  if (!read_file(path, &fb)) return 1;
  std::vector<size_t> starts = line_starts(fb.data, fb.size);
  // drop skipped header rows and blank trailing lines
  size_t first = static_cast<size_t>(skip_rows) < starts.size()
                     ? static_cast<size_t>(skip_rows)
                     : starts.size();
  // skip BLANK lines entirely (np.loadtxt semantics — the numpy
  // fallback must see the same row set)
  std::vector<size_t> rows_;
  for (size_t i = first; i < starts.size(); ++i) {
    if (line_end(fb.data, fb.size, starts[i]) > starts[i])
      rows_.push_back(starts[i]);
  }
  int64_t n_rows = static_cast<int64_t>(rows_.size());
  if (n_rows == 0) return 2;

  // column count from the first data row
  size_t e0 = line_end(fb.data, fb.size, rows_[0]);
  int64_t n_cols = 1;
  for (size_t i = rows_[0]; i < e0; ++i)
    if (fb.data[i] == delim) ++n_cols;

  double* mat = static_cast<double*>(
      std::malloc(sizeof(double) * static_cast<size_t>(n_rows * n_cols)));
  if (!mat) return 3;

  int nt = n_threads_for(static_cast<size_t>(n_rows));
  std::vector<std::thread> threads;
  std::vector<int> errs(static_cast<size_t>(nt), 0);
  auto work = [&](int tid) {
    int64_t lo = n_rows * tid / nt, hi = n_rows * (tid + 1) / nt;
    bool bad = false;
    for (int64_t r = lo; r < hi && !bad; ++r) {
      size_t b = rows_[static_cast<size_t>(r)];
      size_t e = line_end(fb.data, fb.size, b);
      int64_t c = 0;
      size_t fs = b;
      for (size_t i = b; i <= e; ++i) {
        if (i == e || fb.data[i] == delim) {
          if (c < n_cols)
            mat[r * n_cols + c] = parse_field(fb.data + fs, fb.data + i, &bad);
          ++c;
          fs = i + 1;
        }
      }
      // field-count mismatch = malformed file: fail the parse so the
      // caller falls back to np.loadtxt, which raises (no silent
      // NaN-padding / truncation on the native path only)
      if (c != n_cols) bad = true;
    }
    if (bad) errs[static_cast<size_t>(tid)] = 1;
  };
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  for (int err : errs) {
    if (err) {
      std::free(mat);
      return 4;
    }
  }

  *out = mat;
  *out_rows = n_rows;
  *out_cols = n_cols;
  return 0;
}

// Parse LibSVM ("label idx:val idx:val ...", 0- or 1-based indices kept
// as-is) into a dense (rows, max_idx+1) matrix of zeros + a label vec.
int fp_parse_libsvm(const char* path, double** out, double** out_label,
                    int64_t* out_rows, int64_t* out_cols) {
  FileBuf fb;
  if (!read_file(path, &fb)) return 1;
  std::vector<size_t> starts = line_starts(fb.data, fb.size);
  while (!starts.empty() &&
         line_end(fb.data, fb.size, starts.back()) == starts.back())
    starts.pop_back();
  int64_t n_rows = static_cast<int64_t>(starts.size());
  if (n_rows == 0) return 2;

  // pass 1 (parallel): max feature index per thread
  int nt = n_threads_for(static_cast<size_t>(n_rows));
  std::vector<int64_t> maxidx(static_cast<size_t>(nt), -1);
  {
    std::vector<std::thread> threads;
    auto scan = [&](int tid) {
      int64_t lo = n_rows * tid / nt, hi = n_rows * (tid + 1) / nt;
      int64_t mx = -1;
      for (int64_t r = lo; r < hi; ++r) {
        size_t b = starts[static_cast<size_t>(r)];
        size_t e = line_end(fb.data, fb.size, b);
        for (size_t i = b; i < e; ++i) {
          if (fb.data[i] == ':') {
            size_t j = i;
            while (j > b && std::isdigit(static_cast<unsigned char>(
                                fb.data[j - 1])))
              --j;
            // index part must be non-empty, all digits from the token
            // start (skip qid:/cost: style tokens — strtoll("qid")
            // would otherwise alias them onto feature 0, diverging
            // from the numpy fallback which raises on int("qid"))
            if (j == i) continue;
            if (j > b && !std::isspace(static_cast<unsigned char>(
                             fb.data[j - 1])))
              continue;
            int64_t idx = std::strtoll(std::string(fb.data + j, fb.data + i).c_str(),
                                       nullptr, 10);
            if (idx > mx) mx = idx;
          }
        }
      }
      maxidx[static_cast<size_t>(tid)] = mx;
    };
    for (int t = 0; t < nt; ++t) threads.emplace_back(scan, t);
    for (auto& th : threads) th.join();
  }
  int64_t n_cols = 0;
  for (int64_t m : maxidx)
    if (m + 1 > n_cols) n_cols = m + 1;
  if (n_cols == 0) return 2;

  double* mat = static_cast<double*>(
      std::calloc(static_cast<size_t>(n_rows * n_cols), sizeof(double)));
  double* lab = static_cast<double*>(
      std::malloc(sizeof(double) * static_cast<size_t>(n_rows)));
  if (!mat || !lab) {
    std::free(mat);
    std::free(lab);
    return 3;
  }

  std::vector<std::thread> threads;
  auto work = [&](int tid) {
    int64_t lo = n_rows * tid / nt, hi = n_rows * (tid + 1) / nt;
    for (int64_t r = lo; r < hi; ++r) {
      size_t b = starts[static_cast<size_t>(r)];
      size_t e = line_end(fb.data, fb.size, b);
      size_t i = b;
      while (i < e && !std::isspace(static_cast<unsigned char>(fb.data[i])))
        ++i;
      lab[r] = parse_field(fb.data + b, fb.data + i);
      while (i < e) {
        while (i < e && std::isspace(static_cast<unsigned char>(fb.data[i])))
          ++i;
        size_t fs = i;
        while (i < e && fb.data[i] != ':' &&
               !std::isspace(static_cast<unsigned char>(fb.data[i])))
          ++i;
        if (i >= e || fb.data[i] != ':') continue;
        bool all_digits = i > fs;
        for (size_t k = fs; k < i && all_digits; ++k)
          if (!std::isdigit(static_cast<unsigned char>(fb.data[k])))
            all_digits = false;
        if (!all_digits) {
          // qid:/cost: style token — skip it (value included) entirely
          while (i < e && !std::isspace(static_cast<unsigned char>(fb.data[i])))
            ++i;
          continue;
        }
        int64_t idx = std::strtoll(
            std::string(fb.data + fs, fb.data + i).c_str(), nullptr, 10);
        ++i;
        size_t vs = i;
        while (i < e && !std::isspace(static_cast<unsigned char>(fb.data[i])))
          ++i;
        if (idx >= 0 && idx < n_cols)
          mat[r * n_cols + idx] = parse_field(fb.data + vs, fb.data + i);
      }
    }
  };
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();

  *out = mat;
  *out_label = lab;
  *out_rows = n_rows;
  *out_cols = n_cols;
  return 0;
}

// ---------------------------------------------------------------- binning
// GreedyFindBin (reference src/io/bin.cpp:80), bit-identical to the
// Python mirror in binning.py:46 — the Python greedy loop over a 200k
// distinct-value sample costs ~110 ms per call (~6 s of a 1M x 28
// Dataset construct); this is the same double arithmetic in C++.

static bool check_double_equal_ordered(double a, double b) {
  return b <= std::nextafter(a, std::numeric_limits<double>::infinity());
}

// out must hold max_bin + 2 doubles; returns the number of bounds.
int64_t fp_greedy_find_bin(const double* distinct, const int64_t* counts,
                           int64_t n, int64_t max_bin, int64_t total_cnt,
                           int64_t min_data_in_bin, double* out) {
  const double kInf = std::numeric_limits<double>::infinity();
  int64_t nb = 0;
  if (n == 0) {
    out[nb++] = kInf;
    return nb;
  }
  if (n <= max_bin) {
    int64_t cur = 0;
    for (int64_t i = 0; i + 1 < n; ++i) {
      cur += counts[i];
      if (cur >= min_data_in_bin) {
        double val = std::nextafter((distinct[i] + distinct[i + 1]) / 2.0,
                                    kInf);
        if (nb == 0 || !check_double_equal_ordered(out[nb - 1], val)) {
          out[nb++] = val;
          cur = 0;
        }
      }
    }
    out[nb++] = kInf;
    return nb;
  }

  if (min_data_in_bin > 0) {
    int64_t mb = total_cnt / min_data_in_bin;
    if (mb < max_bin) max_bin = mb;
    if (max_bin < 1) max_bin = 1;
  }
  double mean_bin_size = static_cast<double>(total_cnt) / max_bin;
  std::vector<char> is_big(n);
  int64_t big_cnt = 0, big_data = 0;
  for (int64_t i = 0; i < n; ++i) {
    is_big[i] = counts[i] >= mean_bin_size;
    if (is_big[i]) {
      ++big_cnt;
      big_data += counts[i];
    }
  }
  int64_t rest_bin_cnt = max_bin - big_cnt;
  int64_t rest_sample_cnt = total_cnt - big_data;
  mean_bin_size = rest_bin_cnt > 0
                      ? static_cast<double>(rest_sample_cnt) / rest_bin_cnt
                      : kInf;
  // max_bin + 1: the loop body writes lowers[bin_cnt] BEFORE the
  // bin_cnt >= max_bin - 1 break check runs, so with max_bin == 1 the
  // statement order would write lowers[1] one element past a
  // max_bin-sized buffer (found by manual bounds review of this file
  // while hunting a suite heap corruption; the count arithmetic makes
  // the max_bin==1 write unreachable today, but the ordering is a
  // heap-overflow trap for any future threshold tweak)
  std::vector<double> uppers(max_bin + 1, kInf), lowers(max_bin + 1, kInf);
  int64_t bin_cnt = 0;
  lowers[0] = distinct[0];
  int64_t cur = 0;
  for (int64_t i = 0; i + 1 < n; ++i) {
    if (!is_big[i]) rest_sample_cnt -= counts[i];
    cur += counts[i];
    if (is_big[i] || cur >= mean_bin_size ||
        (is_big[i + 1] &&
         cur >= std::max(1.0, mean_bin_size * 0.5))) {
      uppers[bin_cnt] = distinct[i];
      ++bin_cnt;
      lowers[bin_cnt] = distinct[i + 1];
      if (bin_cnt >= max_bin - 1) break;
      cur = 0;
      if (!is_big[i]) {
        --rest_bin_cnt;
        mean_bin_size = rest_bin_cnt > 0
                            ? static_cast<double>(rest_sample_cnt) /
                                  rest_bin_cnt
                            : kInf;
      }
    }
  }
  ++bin_cnt;
  for (int64_t i = 0; i + 1 < bin_cnt; ++i) {
    double val = std::nextafter((uppers[i] + lowers[i + 1]) / 2.0, kInf);
    if (nb == 0 || !check_double_equal_ordered(out[nb - 1], val)) {
      out[nb++] = val;
    }
  }
  out[nb++] = kInf;
  return nb;
}

// Vectorized numerical ValueToBin (reference bin.h:161; the Python
// np.searchsorted path is single-threaded): first index with
// bounds[i] >= v (lower_bound), NaN -> nan_target. Multithreaded.
void fp_values_to_bins(const double* values, int64_t n, const double* bounds,
                       int64_t nb, int32_t nan_target, int32_t* out) {
  int nt = static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n < (1 << 16)) nt = 1;
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    for (int64_t i = lo; i < hi; ++i) {
      double v = values[i];
      if (std::isnan(v)) {
        out[i] = nan_target;
        continue;
      }
      int64_t b = std::lower_bound(bounds, bounds + nb, v) - bounds;
      if (b >= nb) b = nb - 1;
      out[i] = static_cast<int32_t>(b);
    }
  };
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------- predict
// Batch prediction over packed tree arrays (the reference predicts in
// C++, src/io/tree.h Tree::Predict; the numpy level-vectorized walk in
// tree.py peaks ~1.4M row-trees/s — pointer-chasing threads reach tens
// of millions). Semantics mirror tree.py predict_leaf exactly:
// decision_type bit0 = categorical, bit1 = default_left, bits2-3 =
// missing type (0 none, 1 zero: NaN or |x|<=1e-35, 2 NaN); NaN with
// missing type != NaN is treated as 0.0; categorical NaN goes right.

int64_t fp_predict(const double* X, int64_t n_rows, int64_t n_cols,
                   const int32_t* tree_idx, int64_t n_trees,
                   const int64_t* node_off, const int32_t* feature,
                   const double* threshold, const int32_t* dtype,
                   const int32_t* left, const int32_t* right,
                   const int64_t* leaf_off, const double* leaf_value,
                   const uint32_t* catw, const int64_t* cat_lo,
                   const int64_t* cat_hi, double* out) {
  int nt = static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n_rows < (1 << 12)) nt = 1;
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    int64_t lo = n_rows * t / nt, hi = n_rows * (t + 1) / nt;
    for (int64_t r = lo; r < hi; ++r) {
      const double* row = X + r * n_cols;
      double acc = 0.0;
      for (int64_t ti = 0; ti < n_trees; ++ti) {
        int64_t tr = tree_idx[ti];
        int64_t base = node_off[tr];
        int64_t n_nodes = node_off[tr + 1] - base;
        if (n_nodes == 0) {
          acc += leaf_value[leaf_off[tr]];
          continue;
        }
        int32_t node = 0;
        while (node >= 0) {
          int64_t k = base + node;
          double v = row[feature[k]];
          int32_t dt = dtype[k];
          bool go_left;
          if (dt & 1) {  // categorical
            bool ok = !std::isnan(v);
            int64_t iv = ok ? static_cast<int64_t>(v) : -1;
            int64_t wlo = cat_lo[k], whi = cat_hi[k];
            int64_t nbits = (whi - wlo) * 32;
            go_left = ok && iv >= 0 && iv < nbits &&
                      ((catw[wlo + iv / 32] >> (iv % 32)) & 1u);
          } else {
            int32_t mt = (dt >> 2) & 3;
            bool dl = (dt & 2) != 0;
            bool isna = std::isnan(v);
            bool miss = mt == 2 ? isna
                        : mt == 1 ? (isna || std::fabs(v) <= 1e-35)
                                  : false;
            double xv = (isna && mt != 2) ? 0.0 : v;
            go_left = miss ? dl : (xv <= threshold[k]);
          }
          node = go_left ? left[k] : right[k];
        }
        acc += leaf_value[leaf_off[tr] + (~node)];
      }
      out[r] = acc;
    }
  };
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  return 0;
}

void fp_free(double* p) { std::free(p); }

}  // extern "C"
