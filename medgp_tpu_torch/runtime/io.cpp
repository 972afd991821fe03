// Native cohort loader of medgp_tpu_torch: a copy of the JAX package's
// medgp_tpu/runtime/io.cpp with the same C ABI.
//
// The counterpart of the reference's C++ dataio layer
// (medgpc/src/dataio/c_experiment.cpp:254-309 `get_one_patient_data`): fast
// parsing of per-patient feature{idx}.txt files with z-score normalization
// against cohort stats, plus a threaded cohort scanner for bucketing (the
// role medgpc/util/profile.py:get_sample_num plays for Slurm tier
// selection). At cohort scale (10k+ patients x 24 feature files)
// Python-level parsing becomes the pipeline's host bottleneck, so it is
// native here like it is in the reference.
//
// Exposed as a plain C ABI consumed through ctypes
// (medgp_tpu_torch/runtime/bindings.py, which builds this file with g++ on
// first use); the pure-Python loader in medgp_tpu_torch/data/formats.py
// remains the authoritative fallback and oracle.

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read a whole file into a buffer; returns false on error.
bool read_file(const std::string &path, std::vector<char> &buf) {
  FILE *f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  buf.resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';
  buf.resize(got + 1);
  return true;
}

// Parse whitespace-separated doubles (the layout the C++ `>>` operator and
// our writer produce). Returns the number parsed.
size_t parse_doubles(const char *s, std::vector<double> &out) {
  char *end = nullptr;
  const char *p = s;
  out.clear();
  for (;;) {
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (!*p) break;
    double v = std::strtod(p, &end);
    if (end == p) break;
    out.push_back(v);
    p = end;
  }
  return out.size();
}

// Parse one feature file: first token = count, then (t, v) pairs.
// Returns -1 on IO/parse failure, else the observation count.
long parse_feature_file(const std::string &path, std::vector<double> &t,
                        std::vector<double> &v) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  std::vector<double> vals;
  parse_doubles(buf.data(), vals);
  if (vals.empty()) return -1;
  long n = static_cast<long>(vals[0]);
  if (n < 0 || vals.size() < static_cast<size_t>(1 + 2 * n)) return -1;
  t.resize(n);
  v.resize(n);
  for (long i = 0; i < n; ++i) {
    t[i] = vals[1 + 2 * i];
    v[i] = vals[2 + 2 * i];
  }
  return n;
}

std::string feature_path(const char *data_dir, const char *pan, int fid) {
  std::string p(data_dir);
  p += "/";
  p += pan;
  p += "/feature";
  p += std::to_string(fid);
  p += ".txt";
  return p;
}

}  // namespace

extern "C" {

// Load one patient's observations, feature-major, z-normalized.
// means/stds are per-feature cohort stats (length n_features).
// Returns the total observation count; -(needed) if cap is too small;
// missing feature files contribute zero observations (like the Python
// loader, which the cohort tooling relies on).
long mgp_load_patient(const char *data_dir, const char *pan,
                      const int *feature_ids, const double *means,
                      const double *stds, int n_features, float *t_out,
                      float *y_out, int *meta_out, long cap) {
  long total = 0;
  std::vector<double> t, v;
  for (int j = 0; j < n_features; ++j) {
    long n = parse_feature_file(
        feature_path(data_dir, pan, feature_ids[j]), t, v);
    if (n < 0) continue;  // missing file -> no observations
    if (total + n > cap) {
      // finish counting so the caller can retry with a big enough buffer
      long needed = total + n;
      for (int k = j + 1; k < n_features; ++k) {
        long m = parse_feature_file(
            feature_path(data_dir, pan, feature_ids[k]), t, v);
        if (m > 0) needed += m;
      }
      return -needed;
    }
    double mean = means[j], std = stds[j];
    for (long i = 0; i < n; ++i) {
      t_out[total + i] = static_cast<float>(t[i]);
      y_out[total + i] = static_cast<float>((v[i] - mean) / std);
      meta_out[total + i] = j;
    }
    total += n;
  }
  return total;
}

// Count one patient's total observations (reads only the first token of
// each feature file — the reference's job-size profile,
// medgpc/util/profile.py:4-12).
long mgp_count_patient(const char *data_dir, const char *pan,
                       const int *feature_ids, int n_features) {
  long total = 0;
  for (int j = 0; j < n_features; ++j) {
    FILE *f = std::fopen(
        feature_path(data_dir, pan, feature_ids[j]).c_str(), "rb");
    if (!f) continue;
    char head[64];
    size_t got = std::fread(head, 1, sizeof(head) - 1, f);
    std::fclose(f);
    head[got] = '\0';
    total += static_cast<long>(std::strtod(head, nullptr));
  }
  return total;
}

// Threaded cohort scan: counts[i] = total observations of pans[i].
// Returns 0 on success.
int mgp_count_cohort(const char *data_dir, const char *const *pans,
                     int n_pans, const int *feature_ids, int n_features,
                     long *counts, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_pans) break;
      counts[i] = mgp_count_patient(data_dir, pans[i], feature_ids,
                                    n_features);
    }
  };
  std::vector<std::thread> pool;
  for (int k = 0; k < n_threads; ++k) pool.emplace_back(worker);
  for (auto &th : pool) th.join();
  return 0;
}

// Threaded cohort load into one packed ragged buffer.
// offsets must have n_pans + 1 entries, offsets[0] = 0, and the caller must
// first fill counts via mgp_count_cohort and prefix-sum them into offsets.
// Returns 0 on success, -1 if any patient overflowed its slot.
int mgp_load_cohort(const char *data_dir, const char *const *pans,
                    int n_pans, const int *feature_ids, const double *means,
                    const double *stds, int n_features, const long *offsets,
                    float *t_out, float *y_out, int *meta_out,
                    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_pans) break;
      long cap = offsets[i + 1] - offsets[i];
      long n = mgp_load_patient(data_dir, pans[i], feature_ids, means, stds,
                                n_features, t_out + offsets[i],
                                y_out + offsets[i], meta_out + offsets[i],
                                cap);
      if (n < 0 || n != cap) status.store(-1);
    }
  };
  std::vector<std::thread> pool;
  for (int k = 0; k < n_threads; ++k) pool.emplace_back(worker);
  for (auto &th : pool) th.join();
  return status.load();
}

}  // extern "C"
