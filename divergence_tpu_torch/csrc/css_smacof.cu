// K6: SMACOF scoring of every window of a chromosome in one launch
// (run-css --mds smacof and --mds cmds+smacof): fill-averages, the
// restarts' starting configurations, up to max_iters + 1 Guttman
// transforms per restart, the best restart by stress, pairwise distances
// and the CSS score.
//
// Replaces divergence_tpu/kernels/css.py: smacof, _stress, _guttman and
// smacof_runs, as _score_pipeline calls them with mds=1 and mds=2.  Plain
// torch version: divergence_tpu_torch/kernels/css.py css_smacof_plain;
// kernels/css.py smacof_pairs mirrors this kernel's order of operations
// (held to the JAX package on the CPU by tests/test_torch_smacof_pairs.py).
//
// A task is one restart of one window, run by one warp: mode 1 has n_init
// tasks a window, restart r starting from x0[j][c] = uniform(fold_in(
// chrom_key, slot), (r*m + j)*2 + c), the threefry draws of
// jax.random.uniform(wkey, (n_init, m, 2)) (threefry.cuh;
// rng.smacof_inits); mode 2 one, from the CMDS embedding of F
// (css_common.cuh's cmds_embed, K5's warp code; the Guttman transform
// commutes with sign flips of X, so the eigenvector signs do not matter).
// The warps are persistent: each takes the next task from a global counter
// when it finishes one, so a restart that stops early frees its warp at
// once and no warp waits for another's restart.  The task's warp fills its
// window (fill_stats_warp), keeps F's upper triangle Fp [m(m-1)/2] and the
// symmetric B(X) [m][m | 1] in its own shared memory (the odd stride keeps
// a column read by 32 lanes free of bank conflicts), and iterates:
//   pair pass — one pass over the unordered pairs i < j in row-major
//     order, pair p on lane p % 32: d_ij = ||x_i - x_j|| once a pair
//     (calc_dist's d_ij == d_ji bit for bit), b_ij = -F_ij / d_ij where
//     d_ij >= 1e-5 (else 0) written to B's (i, j) and (j, i) (F is
//     symmetric), and the stress of X, sum_{i<j} (d_ij - F_ij)^2 + 0.5
//     sum_i F_ii^2: half the full-matrix sum of css.py:205-209, whose
//     diagonal carries the fill average (d_ii = 0), as lane partials in
//     pair order and one xor-butterfly warp sum, so every lane holds the
//     same bits and takes the same branch;
//   row pass — lane l owns rows l and l + 32: XN_i = (sum_{j != i} b_ij
//     x_j - (sum_{j != i} b_ij) x_i) / m, j in order (css.py:212-221);
//   one transform is a row pass on the last pair pass's B, then the pair
//     pass of XN: XN's distances give its stress and the next transform's
//     B at once (css.py:241-252 carries d = dn the same way), so a
//     transform takes m(m-1)/2 square roots and divisions where the
//     two-pass form took 2 m^2 and m^2;
//   stop: the first transform is unconditional; the restart freezes when
//     sigma_prev - sigma <= eps (NaN included) or after max_iters + 1
//     transforms; a NaN start (mode 2 after a truly negative eigenvalue)
//     never iterates, as JAX's active0 = (sig0 == sig0).  Frozen state
//     never changes, so this equals JAX's fixed-trip lax.scan with
//     per-element freezing.
// The task publishes its stress, transform count and X to device scratch
// and counts itself in its window's counter; the window's last restart to
// finish runs the epilogue: numpy's argmin of the stresses (the first NaN,
// else the first minimum), css_common.cuh's score_window_warp on the best
// X (distances, score, valid flag), and the diagnostics: the chosen
// restart, its transform count, and (if asked for) the transforms summed
// over every restart.
//
// What bounds it on H100: latency of dependent iterations.  A restart is
// up to 301 transforms, each a pair pass (m(m-1)/2 square roots and
// divisions over 32 lanes, then a warp sum) and a row pass (3 chains of m
// dependent adds a lane; at m = 21 a third of the lanes idle in it), with
// nothing to overlap inside the warp; many warps an SM hide it.
#include "css_common.cuh"
#include "threefry.cuh"

namespace {

using namespace cssk;

constexpr int kWarps = 4;   // independent warps a block
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int npairs(int m) { return m * (m - 1) / 2; }

// Elements of T before X in one warp's shared memory: Fp and B (mode 2:
// cmds_embed's scratch over both, before they are filled).
__host__ __device__ constexpr int head_elems(int m, int mode) {
    return mode == 2 && cmds_scratch(m) > npairs(m) + m * (m | 1)
               ? cmds_scratch(m)
               : npairs(m) + m * (m | 1);
}

// Elements of T of one warp's shared memory: the head, X and XN [m][2],
// rounded up to keep every warp's slab 16-byte aligned.
__host__ __device__ constexpr int warp_elems(int m, int mode) {
    return ((head_elems(m, mode) + 4 * m + 1) / 2) * 2;
}

// Move (i, j) past the end of its row onto the pair of the same packed
// index (row i holds the pairs j = i + 1 .. m - 1).
__device__ __forceinline__ void wrap_pair(int m, int& i, int& j) {
    while (j >= m) {
        ++i;
        j += i + 1 - m;
    }
}

// The pair pass over X: B(X) written, the stress of X returned (every
// lane the same bits).  Ends with __syncwarp.
template <typename T>
__device__ T pair_pass(const T* Fp, const T* X, T* B, int m, T diag, int lane) {
    const int P = npairs(m);
    const int ld = m | 1;
    T part = T(0);
    int i = 0, j = 1 + lane;
    if (lane < P) wrap_pair(m, i, j);
    for (int p = lane; p < P; p += 32) {
        const T dx0 = X[2 * i] - X[2 * j];
        const T dx1 = X[2 * i + 1] - X[2 * j + 1];
        const T d = t_sqrt(dx0 * dx0 + dx1 * dx1);
        const T f = Fp[p];
        const T r = d - f;
        part += r * r;
        const T b = d >= T(0.00001) ? -f / d : T(0);
        B[i * ld + j] = b;
        B[j * ld + i] = b;
        j += 32;
        if (p + 32 < P) wrap_pair(m, i, j);
    }
    __syncwarp();
    return warp_sum(part) + diag;
}

// The row pass: XN = B X / m with B's diagonal -rowsum.  Ends with
// __syncwarp.
template <typename T>
__device__ void row_pass(const T* B, const T* X, T* XN, int m, int lane) {
    const int ld = m | 1;
    for (int i = lane; i < m; i += 32) {
        const T* row = B + i * ld;
        T rs = T(0), a0 = T(0), a1 = T(0);
        for (int j = 0; j < m; ++j) {
            if (j == i) continue;
            const T b = row[j];
            rs += b;
            a0 += b * X[2 * j];
            a1 += b * X[2 * j + 1];
        }
        XN[2 * i] = (a0 - rs * X[2 * i]) / static_cast<T>(m);
        XN[2 * i + 1] = (a1 - rs * X[2 * i + 1]) / static_cast<T>(m);
    }
    __syncwarp();
}

// One restart from *X: returns its final stress and writes its transform
// count; *X points at the final configuration (X and XN swap roles each
// transform).
template <typename T>
__device__ T smacof_restart(const T* Fp, T* B, T** X, T** XN, int m, T diag,
                            int max_iters, T eps, int lane, int* ntrans) {
    T sig = pair_pass(Fp, *X, B, m, diag, lane);
    bool active = sig == sig;
    int n = 0;
    for (int it = 0; it <= max_iters && active; ++it) {
        row_pass(B, *X, *XN, m, lane);
        const T s = pair_pass(Fp, *XN, B, m, diag, lane);
        active = (sig - s) > eps;
        sig = s;
        ++n;
        T* t = *X;
        *X = *XN;
        *XN = t;
    }
    *ntrans = n;
    return sig;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
css_smacof(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
           const int64_t* __restrict__ slots, uint2 chrom_key, int64_t nwin, int asize,
           int bsize, int mode, int nrest, int max_iters, T eps, T wa, T wb,
           int* __restrict__ counters, T* __restrict__ sig_s, T* __restrict__ x_s,
           int* __restrict__ n_s, T* __restrict__ scores, T* __restrict__ dist_out,
           uint8_t* __restrict__ valid_out, int* __restrict__ restart_out,
           int* __restrict__ ntrans_out, int* __restrict__ total_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const unsigned full = 0xffffffffu;
    const int m = asize + bsize;
    const int mm = m * m;
    const int P = npairs(m);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T* S = reinterpret_cast<T*>(smem_raw) + warp * warp_elems(m, mode);
    T* Fp = S;                             // [P] F's upper triangle
    T* B = Fp + P;                         // [m][m | 1] B(X)
    T* X0 = S + head_elems(m, mode);       // [m][2]
    T* XN0 = X0 + 2 * m;                   // [m][2]
    int* next_task = counters;             // tasks handed out
    int* finished = counters + 1;          // [nwin] restarts finished
    const int ntask = static_cast<int>(nwin) * nrest;

    for (;;) {
        int task = 0;
        if (lane == 0) task = atomicAdd(next_task, 1);
        task = __shfl_sync(full, task, 0);
        if (task >= ntask) break;
        const int64_t w = task / nrest;
        const int r = task - static_cast<int>(w) * nrest;
        const T* D = dis + w * mm;
        const Fill<T> fs = fill_stats_warp(D, m, lane);
        if (mode == 2) {
            cmds_embed(D, m, fs.avg, S, X0);   // ends with __syncwarp
        } else {
            const uint2 wkey = tf::fold_in(chrom_key, static_cast<uint32_t>(slots[w]));
            for (int p = lane; p < 2 * m; p += 32) {
                X0[p] = tf::uniform<T>(wkey, static_cast<uint32_t>(r * 2 * m + p));
            }
        }
        T dpart = T(0);
        for (int i = lane; i < m; i += 32) {
            const T f = filled(D[i * m + i], fs.avg);
            dpart += f * f;
        }
        const T diag = T(0.5) * warp_sum(dpart);
        int i = 0, j = 1 + lane;
        if (lane < P) wrap_pair(m, i, j);
        for (int p = lane; p < P; p += 32) {
            Fp[p] = filled(D[i * m + j], fs.avg);
            j += 32;
            if (p + 32 < P) wrap_pair(m, i, j);
        }
        __syncwarp();

        T* X = X0;
        T* XN = XN0;
        int n = 0;
        const T s = smacof_restart(Fp, B, &X, &XN, m, diag, max_iters, eps, lane, &n);
        for (int p = lane; p < 2 * m; p += 32) x_s[static_cast<int64_t>(task) * 2 * m + p] = X[p];
        if (lane == 0) {
            sig_s[task] = s;
            n_s[task] = n;
        }
        __threadfence();
        __syncwarp();
        int prior = 0;
        if (lane == 0) prior = atomicAdd(finished + w, 1);
        prior = __shfl_sync(full, prior, 0);
        if (prior != nrest - 1) continue;

        // the window's last restart: the best by numpy's argmin (the first
        // NaN, else the first minimum), its distances and score
        __threadfence();
        const int64_t t0 = w * nrest;
        int best = 0;
        T bs = __ldcg(sig_s + t0);
        int total = __ldcg(n_s + t0);
        for (int q = 1; q < nrest; ++q) {
            const T sq = __ldcg(sig_s + t0 + q);
            total += __ldcg(n_s + t0 + q);
            if (!isnan(bs) && (isnan(sq) || sq < bs)) {
                best = q;
                bs = sq;
            }
        }
        for (int p = lane; p < 2 * m; p += 32) X0[p] = __ldcg(x_s + (t0 + best) * 2 * m + p);
        __syncwarp();
        score_window_warp(X0, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,
                          dist_out + w * mm, scores + w, valid_out + w);
        if (lane == 0) {
            restart_out[w] = best;
            ntrans_out[w] = __ldcg(n_s + t0 + best);
            if (total_out) total_out[w] = total;
        }
        __syncwarp();   // X0 is the next task's
    }
}

template <typename T>
int launch_smacof(const T* dis, const int64_t* npos, const int64_t* slots,
                  int64_t nwin, uint32_t key0, uint32_t key1, int asize,
                  int bsize, int mode, int n_init, int max_iters, double eps,
                  double wa, double wb, T* scores, T* dist,
                  uint8_t* valid, int* restart, int* ntrans, int* total, int* counters,
                  T* sig_s, T* x_s, int* n_s, void* stream) {
    if (nwin == 0) return 0;
    const int m = asize + bsize;
    const int nrest = mode == 1 ? n_init : 1;
    if ((mode != 1 && mode != 2) || nrest < 1 || max_iters < 0 || m < 2 || m > 64 ||
        asize < 1 || bsize < 1 || nwin * nrest > 0x7fffffff - kThreads * 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = static_cast<size_t>(kWarps) * warp_elems(m, mode) * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        css_smacof<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    // persistent warps: as many blocks as fit on the card at once
    int device = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, css_smacof<T>, kThreads,
                                                           smem)) != cudaSuccess) {
        return static_cast<int>(e);
    }
    const int64_t want = (nwin * nrest + kWarps - 1) / kWarps;
    const int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = static_cast<unsigned>(want < fit ? want : fit);
    css_smacof<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        dis, npos, slots, make_uint2(key0, key1), nwin, asize, bsize, mode, nrest,
        max_iters, static_cast<T>(eps), static_cast<T>(wa), static_cast<T>(wb), counters,
        sig_s, x_s, n_s, scores, dist, valid, restart, ntrans, total);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int css_smacof_f64(const double* dis, const int64_t* npos,
                              const int64_t* slots, int64_t nwin,
                              uint32_t key0, uint32_t key1, int asize,
                              int bsize, int mode, int n_init, int max_iters,
                              double eps, double wa, double wb, double* scores,
                              double* dist, uint8_t* valid, int* restart, int* ntrans,
                              int* total, int* counters, double* sig_s, double* x_s,
                              int* n_s, void* stream) {
    return launch_smacof<double>(dis, npos, slots, nwin, key0, key1, asize, bsize, mode,
                                 n_init, max_iters, eps, wa, wb, scores, dist, valid,
                                 restart, ntrans, total, counters, sig_s, x_s, n_s, stream);
}

FET_EXPORT int css_smacof_f32(const float* dis, const int64_t* npos,
                              const int64_t* slots, int64_t nwin,
                              uint32_t key0, uint32_t key1, int asize,
                              int bsize, int mode, int n_init, int max_iters,
                              double eps, double wa, double wb, float* scores,
                              float* dist, uint8_t* valid, int* restart, int* ntrans,
                              int* total, int* counters, float* sig_s, float* x_s,
                              int* n_s, void* stream) {
    return launch_smacof<float>(dis, npos, slots, nwin, key0, key1, asize, bsize, mode,
                                n_init, max_iters, eps, wa, wb, scores, dist, valid,
                                restart, ntrans, total, counters, sig_s, x_s, n_s, stream);
}
