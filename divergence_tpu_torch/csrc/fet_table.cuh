// The per-table Fisher's exact test score -log10 p, shared by K1
// (fet_snp.cu) and K10 (fet_window.cu), and the table count and grid
// index that K1r (fet_rank.cu) uses too: one definition, so every kernel
// gives the same value for the same 2x2 table, bit for bit.
//
// Replaces divergence_tpu/kernels/fet.py: _shift_min_first,
// _support_logp, fet_two_tailed (exact, f64) and fet_two_tailed_neglog10
// (fast, f32).  Plain torch versions: divergence_tpu_torch/kernels/fet.py.
//
// Numerics: the operations and their order follow the plain torch
// version (build flag --fmad=false: no contracted multiply-adds); only
// the support sums run in another order than torch's reductions, an
// ulp-level difference.  Tie and snap decisions use the JAX package's
// constants (tie_rtol = snap = 1e-12 in f64, 1e-5 in f32).
#pragma once

#include "fet_common.cuh"

namespace fetk {

constexpr double kTieExact = 1e-12;
constexpr double kSnapExact = 1e-12;
// float32(log1p(-1e-5)), float32(log(2)), float32(log(10)): the f32 tie /
// snap band and constants of fet_two_tailed_neglog10
constexpr float kLog1pNegTolF = -0x1.4f8bc6p-17f;
constexpr float kLog2F = 0x1.62e430p-1f;
constexpr float kLog10F = 0x1.26bb1cp+1f;

// A table rotated so that its minimum cell leads
// (reference statistics/fisher/cFisher.c:327-346).
struct Shifted {
    int a0, r1, r2, c1, n, hi;
    bool equal_margins;
};

__device__ __forceinline__ Shifted shift_min_first(int f0, int f1, int f2,
                                                   int f3) {
    Shifted t;
    t.equal_margins = (f0 + f1 == f2 + f3) || (f0 + f2 == f1 + f3);
    const int cw[4] = {f0, f1, f3, f2};   // clockwise order
    int idx = 0;
    for (int k = 1; k < 4; ++k) {
        if (cw[k] < cw[idx]) idx = k;     // first minimum, like argmin
    }
    const int s0 = cw[idx];
    const int s1 = cw[(idx + 1) & 3];
    const int s3 = cw[(idx + 2) & 3];
    const int s2 = cw[(idx + 3) & 3];
    t.a0 = s0;
    t.r1 = s0 + s1;
    t.r2 = s2 + s3;
    t.c1 = s0 + s2;
    t.n = t.r1 + t.r2;
    t.hi = min(t.r1, t.c1);
    return t;
}

template <typename T>
__device__ __forceinline__ T lchoose(int n, int k, const T* __restrict__ lf,
                                     int nmax) {
    if (k < 0 || k > n || n < 0) return neg_inf<T>();
    const int kc = min(max(k, 0), nmax);
    const int nc = min(max(n, 0), nmax);
    const int nk = min(max(nc - kc, 0), nmax);
    return (__ldg(lf + nc) - __ldg(lf + kc)) - __ldg(lf + nk);
}

// log point probability of support point x (valid: x <= hi)
template <typename T>
__device__ __forceinline__ T support_logp(const Shifted& t, int x, T lc,
                                          const T* __restrict__ lf, int nmax) {
    return (lchoose<T>(t.r1, x, lf, nmax) +
            lchoose<T>(t.r2, t.c1 - x, lf, nmax)) - lc;
}

// Exact mode: linear-space f64 p (fet_two_tailed), then -log10.
__device__ inline double neglog10_p(int f0, int f1, int f2, int f3, int maxs,
                                    const double* __restrict__ lf, int nmax) {
    const Shifted t = shift_min_first(f0, f1, f2, f3);
    const double lc = lchoose<double>(t.n, t.c1, lf, nmax);
    const int top = min(t.hi, maxs - 1);   // highest valid support point
    const int a0 = min(t.a0, maxs - 1);    // in range for every real table
    // first tail: every table from the observed one down to zero
    double t1 = 0.0;
    for (int x = 0; x <= a0; ++x) {
        t1 += t_exp(support_logp(t, x, lc, lf, nmax));
    }
    double total;
    if (t.equal_margins) {
        total = 2.0 * t1;
    } else {
        // second tail: from the opposite extreme inward while STRICTLY
        // less probable than the observed table (cFisher.c:440)
        const double thr =
            t_exp(support_logp(t, a0, lc, lf, nmax)) * (1.0 - kTieExact);
        double t2 = 0.0;
        for (int x = top; x > t.a0; --x) {
            const double px = t_exp(support_logp(t, x, lc, lf, nmax));
            if (px >= thr) break;
            t2 += px;
        }
        total = t1 + t2;
    }
    // snap round-off-shy-of-1 totals to 1, clamp overshoots (cFisher.c:451)
    if (total > 1.0 - kSnapExact) total = 1.0;
    return -log10(total);
}

// Fast mode: log-space f32 score (fet_two_tailed_neglog10) — a
// max-shifted log-sum-exp over the selected support, finite where f32 p
// would underflow.
__device__ inline float neglog10_p(int f0, int f1, int f2, int f3, int maxs,
                                   const float* __restrict__ lf, int nmax) {
    const Shifted t = shift_min_first(f0, f1, f2, f3);
    const float lc = lchoose<float>(t.n, t.c1, lf, nmax);
    const int top = min(t.hi, maxs - 1);
    const int a0 = min(t.a0, maxs - 1);
    // second tail = (cut, top]: above the highest point at least as
    // probable as the observed table (tie band log1p(-1e-5))
    int cut = top;
    if (!t.equal_margins) {
        const float thr = support_logp(t, a0, lc, lf, nmax) + kLog1pNegTolF;
        cut = t.a0;
        for (int x = top; x > t.a0; --x) {
            if (support_logp(t, x, lc, lf, nmax) >= thr) {
                cut = x;
                break;
            }
        }
    }
    float M = neg_inf<float>();
    for (int x = 0; x <= a0; ++x) M = t_max(M, support_logp(t, x, lc, lf, nmax));
    for (int x = cut + 1; x <= top; ++x) {
        M = t_max(M, support_logp(t, x, lc, lf, nmax));
    }
    float ssum = 0.0f;
    for (int x = 0; x <= a0; ++x) {
        ssum += t_exp(support_logp(t, x, lc, lf, nmax) - M);
    }
    for (int x = cut + 1; x <= top; ++x) {
        ssum += t_exp(support_logp(t, x, lc, lf, nmax) - M);
    }
    float log_total = M + t_log(ssum);
    log_total = log_total + (t.equal_margins ? kLog2F : 0.0f);
    const float neglog10 = -log_total / kLog10F;
    return log_total > kLog1pNegTolF ? 0.0f : neglog10;
}

// The 2x2 allele-count table of one SNP from its int16 genotype codes:
// homozygous calls only (count_tables; reference
// statistics/fisher/cFisher.c:208-238).  ra holds asize codes, rb bsize.
struct Table {
    int f0, f1, f2, f3;
};

__device__ __forceinline__ Table count_table(const int16_t* ra, int asize,
                                             const int16_t* rb, int bsize) {
    Table t{0, 0, 0, 0};
#pragma unroll 4
    for (int k = 0; k < asize; ++k) {
        const int c = ra[k];
        t.f0 += c == 3;
        t.f1 += c == -3;
    }
#pragma unroll 4
    for (int k = 0; k < bsize; ++k) {
        const int c = rb[k];
        t.f2 += c == 3;
        t.f3 += c == -3;
    }
    return t;
}

// The table's entry of the row-major (f0, f1, f2, f3) grid (_lut_index).
__device__ __forceinline__ int table_index(const Table& t, int asize,
                                           int bsize) {
    const int A1 = asize + 1, B1 = bsize + 1;
    return ((t.f0 * A1 + t.f1) * B1 + t.f2) * B1 + t.f3;
}

// The score of one SNP from its table: the LUT entry where the panel's
// LUT is on (lut != nullptr), else the support scan.
template <typename T>
__device__ __forceinline__ T snp_score(const Table& t, int asize, int bsize,
                                       const T* __restrict__ lut,
                                       const T* __restrict__ lf, int nmax,
                                       int maxs) {
    if (lut != nullptr) {
        return __ldg(lut + table_index(t, asize, bsize));
    }
    return neglog10_p(t.f0, t.f1, t.f2, t.f3, maxs, lf, nmax);
}

}  // namespace fetk
