// Native setup-path kernels for juliachem_jl_tpu.
//
// Role parity with the reference's C++ layer (deps/src/jeri-*.hpp): the
// reference keeps its integral engine in C++; here the integral *compute*
// lives on the device (XLA), and the native layer instead owns the
// host-side combinatorial setup that feeds the device — Schwarz-screened
// quartet enumeration and shell-pair bookkeeping — which is O(n_pairs^2)
// and must stream rather than materialize (a numpy meshgrid of w50's
// ~1e5 x 1e5 pair products would need ~80 GB; this emits only survivors).
//
// Interface: plain C ABI consumed via ctypes (no CPython API, no pybind11).
// Build: g++ -O3 -march=native -shared -fPIC (driven by ops/native.py).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Count quartets (i, j) with qb[i] * qk[j] >= cutoff.
// same_block != 0 restricts to the upper triangle i <= j (symmetry-unique
// pairs of pairs within one class block).
int64_t count_screened_quartets(const double* qb, int64_t nb,
                                const double* qk, int64_t nk,
                                double cutoff, int same_block) {
    int64_t count = 0;
    for (int64_t i = 0; i < nb; ++i) {
        const double qi = qb[i];
        if (qi <= 0.0) continue;
        const double thresh = cutoff / qi;
        const int64_t j0 = same_block ? i : 0;
        for (int64_t j = j0; j < nk; ++j) {
            count += (qk[j] >= thresh);
        }
    }
    return count;
}

// Emit the surviving quartets into out_r/out_c (caller sizes them from
// count_screened_quartets).  Returns the number written.
int64_t emit_screened_quartets(const double* qb, int64_t nb,
                               const double* qk, int64_t nk,
                               double cutoff, int same_block,
                               int64_t* out_r, int64_t* out_c,
                               int64_t cap) {
    int64_t count = 0;
    for (int64_t i = 0; i < nb && count < cap; ++i) {
        const double qi = qb[i];
        if (qi <= 0.0) continue;
        const double thresh = cutoff / qi;
        const int64_t j0 = same_block ? i : 0;
        for (int64_t j = j0; j < nk; ++j) {
            if (qk[j] >= thresh) {
                if (count >= cap) break;
                out_r[count] = i;
                out_c[count] = j;
                ++count;
            }
        }
    }
    return count;
}

// Screened pair selection for the DF 3-center build: keep pair p when
// q[p]^2 >= sigma^2 / metric_max (Huang et al. 2020 criterion,
// reference SchwarzScreening.jl:1-8).  Writes a 0/1 mask; returns count.
int64_t df_pair_mask(const double* q, int64_t n, double sigma,
                     double metric_max, uint8_t* mask) {
    const double thresh = (sigma * sigma) / metric_max;
    int64_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
        const bool keep = q[i] * q[i] >= thresh;
        mask[i] = keep;
        kept += keep;
    }
    return kept;
}

}  // extern "C"
