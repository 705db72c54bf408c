// k-reciprocal re-ranking — native CPU implementation (OpenMP).
//
// ref mpreid_tpu/native/rerank.cpp, copied. The reference's CPU path is
// single-threaded NumPy with python loops (reference
// utils/reranking.py:29-100). This is the same algorithm as a multithreaded
// C++ kernel for CPU-only deployments and for checking the card's dense
// re-ranking at scale. Exposed through ctypes (see rerank.py); built at
// first use by native/build.py.
//
// Inputs: the (N, N) column-max-normalized-and-transposed original distance
// matrix (fp32, row-major) where N = Q + G. Output: the (Q, G) re-ranked
// distance matrix.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// indices of the k smallest entries of row (ascending by value)
void topk_row(const float* row, int n, int k, int32_t* out) {
    std::vector<int32_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                      [row](int32_t a, int32_t b) { return row[a] < row[b]; });
    std::memcpy(out, idx.data(), sizeof(int32_t) * k);
}

bool contains(const int32_t* arr, int n, int32_t v) {
    for (int i = 0; i < n; ++i)
        if (arr[i] == v) return true;
    return false;
}

}  // namespace

extern "C" {

// orig: (n, n) fp32 normalized distance; out: (num_q, n - num_q) fp32
int rerank_kreciprocal(const float* orig, int n, int num_q, int k1, int k2,
                       float lambda, float* out) {
    const int half = static_cast<int>(std::lround(k1 / 2.0));
    const int kmax = std::max(std::max(k1 + 1, half + 1), k2);
    if (kmax > n) return -1;

    // forward neighbor lists (kmax per row)
    std::vector<int32_t> rank(static_cast<size_t>(n) * kmax);
#pragma omp parallel for schedule(dynamic, 16)
    for (int i = 0; i < n; ++i)
        topk_row(orig + static_cast<size_t>(i) * n, n, kmax,
                 rank.data() + static_cast<size_t>(i) * kmax);

    auto reciprocal = [&](int p, int k, std::vector<int32_t>& dst) {
        dst.clear();
        const int32_t* fwd = rank.data() + static_cast<size_t>(p) * kmax;
        for (int j = 0; j <= k; ++j) {
            int32_t cand = fwd[j];
            const int32_t* back = rank.data() + static_cast<size_t>(cand) * kmax;
            if (contains(back, k + 1, p)) dst.push_back(cand);
        }
    };

    // sparse V rows: expanded k-reciprocal sets + exp(-d) weights
    std::vector<std::vector<int32_t>> v_idx(n);
    std::vector<std::vector<float>> v_val(n);
#pragma omp parallel
    {
        std::vector<int32_t> rset, hset, expanded;
#pragma omp for schedule(dynamic, 16)
        for (int p = 0; p < n; ++p) {
            reciprocal(p, k1, rset);
            expanded = rset;
            for (int32_t q : rset) {
                reciprocal(q, half, hset);
                int inter = 0;
                for (int32_t h : hset)
                    if (std::find(rset.begin(), rset.end(), h) != rset.end()) ++inter;
                if (3 * inter > 2 * static_cast<int>(hset.size()))
                    expanded.insert(expanded.end(), hset.begin(), hset.end());
            }
            std::sort(expanded.begin(), expanded.end());
            expanded.erase(std::unique(expanded.begin(), expanded.end()),
                           expanded.end());
            const float* row = orig + static_cast<size_t>(p) * n;
            float sum = 0.f;
            std::vector<float> w(expanded.size());
            for (size_t j = 0; j < expanded.size(); ++j) {
                w[j] = std::exp(-row[expanded[j]]);
                sum += w[j];
            }
            for (float& x : w) x /= sum;
            v_idx[p] = expanded;
            v_val[p] = std::move(w);
        }
    }

    // local query expansion: V[p] <- mean over p's k2-NN of V
    std::vector<std::vector<int32_t>> vq_idx(n);
    std::vector<std::vector<float>> vq_val(n);
    if (k2 != 1) {
#pragma omp parallel
        {
            std::vector<float> dense(n);
#pragma omp for schedule(dynamic, 16)
            for (int p = 0; p < n; ++p) {
                std::fill(dense.begin(), dense.end(), 0.f);
                const int32_t* fwd = rank.data() + static_cast<size_t>(p) * kmax;
                for (int j = 0; j < k2; ++j) {
                    int32_t nb = fwd[j];
                    const auto& ii = v_idx[nb];
                    const auto& vv = v_val[nb];
                    for (size_t t = 0; t < ii.size(); ++t) dense[ii[t]] += vv[t];
                }
                const float inv = 1.0f / k2;
                for (int c = 0; c < n; ++c) {
                    if (dense[c] != 0.f) {
                        vq_idx[p].push_back(c);
                        vq_val[p].push_back(dense[c] * inv);
                    }
                }
            }
        }
    } else {
        vq_idx = v_idx;
        vq_val = v_val;
    }

    // inverted index over columns
    std::vector<std::vector<int32_t>> inv_rows(n);
    std::vector<std::vector<float>> inv_vals(n);
    for (int r = 0; r < n; ++r)
        for (size_t t = 0; t < vq_idx[r].size(); ++t) {
            inv_rows[vq_idx[r][t]].push_back(r);
            inv_vals[vq_idx[r][t]].push_back(vq_val[r][t]);
        }

    const int num_g = n - num_q;
#pragma omp parallel
    {
        std::vector<float> minsum(n);
#pragma omp for schedule(dynamic, 4)
        for (int qi = 0; qi < num_q; ++qi) {
            std::fill(minsum.begin(), minsum.end(), 0.f);
            const auto& ii = vq_idx[qi];
            const auto& vv = vq_val[qi];
            for (size_t t = 0; t < ii.size(); ++t) {
                const int col = ii[t];
                const float qv = vv[t];
                const auto& rows = inv_rows[col];
                const auto& vals = inv_vals[col];
                for (size_t u = 0; u < rows.size(); ++u)
                    minsum[rows[u]] += std::min(qv, vals[u]);
            }
            const float* orow = orig + static_cast<size_t>(qi) * n;
            for (int g = 0; g < num_g; ++g) {
                const float ms = minsum[num_q + g];
                const float jac = 1.0f - ms / (2.0f - ms);
                out[static_cast<size_t>(qi) * num_g + g] =
                    jac * (1.0f - lambda) + orow[num_q + g] * lambda;
            }
        }
    }
    return 0;
}

}  // extern "C"
