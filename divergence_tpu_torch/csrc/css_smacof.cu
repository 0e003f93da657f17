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
// Large panels (css_smacof_block): where kWarps warps' slabs do not fit a
// block's shared memory, a task runs on one block of kBlockThreads
// threads instead of one warp, with persistent blocks taking tasks from
// the same counter.  The same passes and stop rule, with B kept as the
// packed pair triangle Bp [m(m-1)/2] beside Fp (the row pass reads b_ij
// at pair (min, max), j ascending, so each row's sums are the warp
// form's): a task takes 2 m(m-1)/2 + 4m elements, in shared memory where
// they fit (float64 up to m = 168, float32 up to m = 239; mode 2 also
// needs css_block.cuh's cmds_embed_block scratch there) and in device
// memory above that, one slab per block of a grid of one block per SM.
// Pair p of a pass is on thread p % kBlockThreads and the stress is
// block_reduce of the threads' partials (warp butterflies, then the
// warps in order): kernels/css.py smacof_pairs(lanes=kBlockThreads)
// follows that order.  Mode 2 embeds with cmds_embed_block.
//
// What bounds it on H100: latency of dependent iterations.  A restart is
// up to 301 transforms, each a pair pass (m(m-1)/2 square roots and
// divisions over 32 lanes, then a warp sum) and a row pass (3 chains of m
// dependent adds a lane; at m = 21 a third of the lanes idle in it), with
// nothing to overlap inside the warp; many warps an SM hide it.
#include "css_block.cuh"
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

// ---------------------------------------------------------------- block form

// Elements of T before X in one block's slab: Fp and Bp (mode 2:
// cmds_embed_block's scratch over both, before they are filled).
__host__ __device__ constexpr int block_head(int m, int mode) {
    return mode == 2 && cmds_block_scratch(m) > 2 * npairs(m) ? cmds_block_scratch(m)
                                                               : 2 * npairs(m);
}

// Elements of T of one block's slab: the head, X and XN [m][2], rounded
// up to keep every slab 16-byte aligned.
__host__ __device__ constexpr int block_elems(int m, int mode) {
    return ((block_head(m, mode) + 4 * m + 1) / 2) * 2;
}

// pair_pass with the block's threads as lanes: Bp [P] written, the stress
// of X returned (every thread the same bits).  Ends with __syncthreads.
template <typename T>
__device__ T pair_pass_block(const T* Fp, const T* X, T* Bp, int m, T diag, void* red) {
    const int P = npairs(m);
    const int tid = threadIdx.x;
    T part = T(0);
    int i = 0, j = 1 + tid;
    if (tid < P) wrap_pair(m, i, j);
    for (int p = tid; p < P; p += kBlockThreads) {
        const T dx0 = X[2 * i] - X[2 * j];
        const T dx1 = X[2 * i + 1] - X[2 * j + 1];
        const T d = t_sqrt(dx0 * dx0 + dx1 * dx1);
        const T f = Fp[p];
        const T r = d - f;
        part += r * r;
        Bp[p] = d >= T(0.00001) ? -f / d : T(0);
        j += kBlockThreads;
        if (p + kBlockThreads < P) wrap_pair(m, i, j);
    }
    return block_reduce(part, red, Add()) + diag;
}

// row_pass from the pair triangle: b_ij at pair (min(i, j), max(i, j)),
// j in order.  Ends with __syncthreads.
template <typename T>
__device__ void row_pass_block(const T* Bp, const T* X, T* XN, int m) {
    for (int i = threadIdx.x; i < m; i += kBlockThreads) {
        T rs = T(0), a0 = T(0), a1 = T(0);
        int p = i - 1;                    // pair (0, i)
        for (int j = 0; j < i; ++j) {
            const T b = Bp[p];
            rs += b;
            a0 += b * X[2 * j];
            a1 += b * X[2 * j + 1];
            p += m - j - 2;               // pair (j + 1, i)
        }
        p = i * m - i * (i + 1) / 2;      // pair (i, i + 1)
        for (int j = i + 1; j < m; ++j, ++p) {
            const T b = Bp[p];
            rs += b;
            a0 += b * X[2 * j];
            a1 += b * X[2 * j + 1];
        }
        XN[2 * i] = (a0 - rs * X[2 * i]) / static_cast<T>(m);
        XN[2 * i + 1] = (a1 - rs * X[2 * i + 1]) / static_cast<T>(m);
    }
    __syncthreads();
}

template <typename T>
__device__ T smacof_restart_block(const T* Fp, T* Bp, T** X, T** XN, int m, T diag,
                                  int max_iters, T eps, void* red, int* ntrans) {
    T sig = pair_pass_block(Fp, *X, Bp, m, diag, red);
    bool active = sig == sig;
    int n = 0;
    for (int it = 0; it <= max_iters && active; ++it) {
        row_pass_block(Bp, *X, *XN, m);
        const T s = pair_pass_block(Fp, *XN, Bp, m, diag, red);
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
__global__ void __launch_bounds__(kBlockThreads)
css_smacof_block(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
                 const int64_t* __restrict__ slots, uint2 chrom_key, int64_t nwin, int asize,
                 int bsize, int mode, int nrest, int max_iters, T eps, T wa, T wb,
                 int* __restrict__ counters, T* __restrict__ sig_s, T* __restrict__ x_s,
                 int* __restrict__ n_s, T* __restrict__ scores, T* __restrict__ dist_out,
                 uint8_t* __restrict__ valid_out, int* __restrict__ restart_out,
                 int* __restrict__ ntrans_out, int* __restrict__ total_out,
                 T* __restrict__ gslab) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the task, then its window's finished count
    int* bc = reinterpret_cast<int*>(smem_raw + kBcastOffset);
    const int m = asize + bsize;
    const int mm = m * m;
    const int P = npairs(m);
    const int tid = threadIdx.x;
    void* red = smem_raw;
    T* S = gslab ? gslab + static_cast<int64_t>(blockIdx.x) * block_elems(m, mode)
                 : reinterpret_cast<T*>(smem_raw + kRedBytes);
    T* Fp = S;                             // [P] F's upper triangle
    T* Bp = Fp + P;                        // [P] B(X)'s upper triangle
    T* X0 = S + block_head(m, mode);       // [m][2]
    T* XN0 = X0 + 2 * m;                   // [m][2]
    int* next_task = counters;
    int* finished = counters + 1;
    const int ntask = static_cast<int>(nwin) * nrest;

    for (;;) {
        if (tid == 0) bc[0] = atomicAdd(next_task, 1);
        __syncthreads();
        const int task = bc[0];
        if (task >= ntask) break;
        const int64_t w = task / nrest;
        const int r = task - static_cast<int>(w) * nrest;
        const T* D = dis + w * mm;
        const Fill<T> fs = fill_stats_block(D, m, red);
        if (mode == 2) {
            cmds_embed_block(D, m, fs.avg, S, X0, red);   // ends with __syncthreads
        } else {
            const uint2 wkey = tf::fold_in(chrom_key, static_cast<uint32_t>(slots[w]));
            for (int p = tid; p < 2 * m; p += kBlockThreads) {
                X0[p] = tf::uniform<T>(wkey, static_cast<uint32_t>(r * 2 * m + p));
            }
        }
        T dpart = T(0);
        for (int i = tid; i < m; i += kBlockThreads) {
            const T f = filled(D[static_cast<int64_t>(i) * m + i], fs.avg);
            dpart += f * f;
        }
        const T diag = T(0.5) * block_reduce(dpart, red, Add());
        int i = 0, j = 1 + tid;
        if (tid < P) wrap_pair(m, i, j);
        for (int p = tid; p < P; p += kBlockThreads) {
            Fp[p] = filled(D[static_cast<int64_t>(i) * m + j], fs.avg);
            j += kBlockThreads;
            if (p + kBlockThreads < P) wrap_pair(m, i, j);
        }
        __syncthreads();

        T* X = X0;
        T* XN = XN0;
        int n = 0;
        const T s = smacof_restart_block(Fp, Bp, &X, &XN, m, diag, max_iters, eps, red, &n);
        for (int p = tid; p < 2 * m; p += kBlockThreads) {
            x_s[static_cast<int64_t>(task) * 2 * m + p] = X[p];
        }
        if (tid == 0) {
            sig_s[task] = s;
            n_s[task] = n;
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) bc[1] = atomicAdd(finished + w, 1);
        __syncthreads();
        if (bc[1] != nrest - 1) continue;

        // the window's last restart: the best by numpy's argmin, its
        // distances and score
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
        for (int p = tid; p < 2 * m; p += kBlockThreads) {
            X0[p] = __ldcg(x_s + (t0 + best) * 2 * m + p);
        }
        __syncthreads();
        score_window_block(X0, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,
                           dist_out + w * mm, scores + w, valid_out + w, red);
        if (tid == 0) {
            restart_out[w] = best;
            ntrans_out[w] = __ldcg(n_s + t0 + best);
            if (total_out) total_out[w] = total;
        }
        __syncthreads();   // X0 and bc are the next task's
    }
}

// Shared memory of the warp form's kWarps slabs, and of the block form
// (the reduction scratch, and the slab unless it lives in device memory).
template <typename T>
size_t warps_smem(int m, int mode) {
    return static_cast<size_t>(kWarps) * warp_elems(m, mode) * sizeof(T);
}

template <typename T>
size_t block_smem(int m, int mode, bool in_device) {
    return kRedBytes + (in_device ? 0 : static_cast<size_t>(block_elems(m, mode)) * sizeof(T));
}

// The form css_smacof takes at panel size m in mode 1 or 2: 0, css_smacof
// (persistent warps), where kWarps warps' slabs fit a block (to m = 68 in
// float64, 97 in float32 on Hopper); 1, css_smacof_block with its slab in
// shared memory (to 168 / 239); 2, css_smacof_block with slabs of
// *slab_elems elements in device memory.  -1 where the device cannot be
// asked.
template <typename T>
int smacof_form(int m, int mode, int64_t* slab_elems) {
    const size_t limit = fetk::smem_optin();
    if (limit == 0) return -1;
    *slab_elems = block_elems(m, mode);
    if (warps_smem<T>(m, mode) <= limit) return 0;
    return block_smem<T>(m, mode, false) <= limit ? 1 : 2;
}

// gslab: nslab slabs of block_elems(m, mode) in device memory (the grid
// is then at most nslab blocks), or null for the slab in shared memory.
template <typename T>
int launch_smacof_block(const T* dis, const int64_t* npos, const int64_t* slots,
                        int64_t nwin, uint32_t key0, uint32_t key1, int asize,
                        int bsize, int mode, int n_init, int max_iters, double eps,
                        double wa, double wb, T* scores, T* dist,
                        uint8_t* valid, int* restart, int* ntrans, int* total, int* counters,
                        T* sig_s, T* x_s, int* n_s, T* gslab, int64_t nslab, void* stream) {
    if (nwin == 0) return 0;
    const int m = asize + bsize;
    const int nrest = mode == 1 ? n_init : 1;
    if ((mode != 1 && mode != 2) || nrest < 1 || max_iters < 0 || m < 2 || asize < 1 ||
        bsize < 1 || nwin * nrest > 0x7fffffff - kBlockThreads * 1024 || (gslab && nslab < 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = block_smem<T>(m, mode, gslab != nullptr);
    if (smem > fetk::smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        css_smacof_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int device = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, css_smacof_block<T>,
                                                           kBlockThreads, smem)) != cudaSuccess) {
        return static_cast<int>(e);
    }
    const int64_t want = nwin * nrest;
    int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    if (gslab && nslab < fit) fit = nslab;
    const unsigned blocks = static_cast<unsigned>(want < fit ? want : fit);
    css_smacof_block<T><<<blocks, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        dis, npos, slots, make_uint2(key0, key1), nwin, asize, bsize, mode, nrest,
        max_iters, static_cast<T>(eps), static_cast<T>(wa), static_cast<T>(wb), counters,
        sig_s, x_s, n_s, scores, dist, valid, restart, ntrans, total, gslab);
    return static_cast<int>(cudaGetLastError());
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
    const size_t smem = warps_smem<T>(m, mode);
    if ((mode != 1 && mode != 2) || nrest < 1 || max_iters < 0 || m < 2 ||
        smem > fetk::smem_optin() || asize < 1 || bsize < 1 ||
        nwin * nrest > 0x7fffffff - kThreads * 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
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

FET_EXPORT int css_smacof_form_f64(int m, int mode, int64_t* slab_elems) {
    return smacof_form<double>(m, mode, slab_elems);
}

FET_EXPORT int css_smacof_form_f32(int m, int mode, int64_t* slab_elems) {
    return smacof_form<float>(m, mode, slab_elems);
}

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

FET_EXPORT int css_smacof_block_f64(const double* dis, const int64_t* npos,
                                    const int64_t* slots, int64_t nwin,
                                    uint32_t key0, uint32_t key1, int asize,
                                    int bsize, int mode, int n_init, int max_iters,
                                    double eps, double wa, double wb, double* scores,
                                    double* dist, uint8_t* valid, int* restart, int* ntrans,
                                    int* total, int* counters, double* sig_s, double* x_s,
                                    int* n_s, double* gslab, int64_t nslab, void* stream) {
    return launch_smacof_block<double>(dis, npos, slots, nwin, key0, key1, asize, bsize, mode,
                                     n_init, max_iters, eps, wa, wb, scores, dist, valid,
                                     restart, ntrans, total, counters, sig_s, x_s, n_s, gslab,
                                     nslab, stream);
}

FET_EXPORT int css_smacof_block_f32(const float* dis, const int64_t* npos,
                                    const int64_t* slots, int64_t nwin,
                                    uint32_t key0, uint32_t key1, int asize,
                                    int bsize, int mode, int n_init, int max_iters,
                                    double eps, double wa, double wb, float* scores,
                                    float* dist, uint8_t* valid, int* restart, int* ntrans,
                                    int* total, int* counters, float* sig_s, float* x_s,
                                    int* n_s, float* gslab, int64_t nslab, void* stream) {
    return launch_smacof_block<float>(dis, npos, slots, nwin, key0, key1, asize, bsize, mode,
                                     n_init, max_iters, eps, wa, wb, scores, dist, valid,
                                     restart, ntrans, total, counters, sig_s, x_s, n_s, gslab,
                                     nslab, stream);
}
