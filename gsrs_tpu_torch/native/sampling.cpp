// Native host-side BPR negative sampler (the port's copy of
// gsrs_tpu/native/sampling.cpp, the same code).
//
// The reference's sampler contract: emit [user, positive, negative...]
// triplet rows with uniform positives from the user's CSR list and
// rejection-sampled negatives, through a plain C ABI for ctypes.
//  - std::mt19937_64, deterministic given the seed
//  - binary search membership test on the sorted CSR row
//  - no OpenMP
//
// The device sampler (gsrs_tpu_torch/ops/sampling.py) is the training
// path; this one serves host-side runs (ops/sampling.py::sample_triplets_host).

#include <algorithm>
#include <cstdint>
#include <random>

namespace {
std::mt19937_64 g_rng{2020};

inline bool contains(const int32_t* begin, const int32_t* end, int32_t x) {
  return std::binary_search(begin, end, x);
}

inline int64_t randint(int64_t hi) {  // uniform in [0, hi)
  return static_cast<int64_t>(
      std::uniform_int_distribution<uint64_t>(0, hi - 1)(g_rng));
}
}  // namespace

extern "C" {

void gsrs_seed(uint64_t seed) { g_rng.seed(seed); }

// Round-robin over users, train_num/user_num rows per user
// (reference sample_negative, code/sources/sampling.cpp:27-56).
// indptr: (user_num+1,) CSR offsets; indices: sorted positives.
// out: (rows, 2+neg_num) int64 row-major; returns rows written.
int64_t gsrs_sample_negative(int64_t user_num, int64_t item_num,
                             int64_t train_num, const int32_t* indptr,
                             const int32_t* indices, int64_t neg_num,
                             int64_t* out) {
  const int64_t per_user = train_num / user_num;
  int64_t row = 0;
  for (int64_t u = 0; u < user_num; ++u) {
    const int32_t* begin = indices + indptr[u];
    const int32_t* end = indices + indptr[u + 1];
    const int64_t deg = end - begin;
    // deg == item_num: no valid negative exists — skip instead of an
    // unbounded rejection spin
    if (deg == 0 || deg >= item_num) continue;
    for (int64_t k = 0; k < per_user; ++k) {
      int64_t* r = out + row * (2 + neg_num);
      r[0] = u;
      r[1] = begin[randint(deg)];
      for (int64_t j = 0; j < neg_num; ++j) {
        int64_t neg;
        do {
          neg = randint(item_num);
        } while (contains(begin, end, static_cast<int32_t>(neg)));
        r[2 + j] = neg;
      }
      ++row;
    }
  }
  return row;
}

// Explicit user list variant
// (reference sample_negative_ByUser, code/sources/sampling.cpp:58-86).
int64_t gsrs_sample_negative_by_user(const int64_t* users, int64_t n_rows,
                                     int64_t item_num, const int32_t* indptr,
                                     const int32_t* indices, int64_t neg_num,
                                     int64_t* out) {
  int64_t row = 0;
  for (int64_t k = 0; k < n_rows; ++k) {
    const int64_t u = users[k];
    const int32_t* begin = indices + indptr[u];
    const int32_t* end = indices + indptr[u + 1];
    const int64_t deg = end - begin;
    if (deg == 0 || deg >= item_num) continue;
    int64_t* r = out + row * (2 + neg_num);
    r[0] = u;
    r[1] = begin[randint(deg)];
    for (int64_t j = 0; j < neg_num; ++j) {
      int64_t neg;
      do {
        neg = randint(item_num);
      } while (contains(begin, end, static_cast<int32_t>(neg)));
      r[2 + j] = neg;
    }
    ++row;
  }
  return row;
}

}  // extern "C"
