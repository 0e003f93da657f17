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
// block's shared memory, a window runs on one block of kSmacofThreads =
// 256 threads (8 warps), persistent blocks taking windows from the same
// counter.  The block fills its window and stages F's upper triangle Fp
// once, then runs the restarts one after another and keeps the best X
// (numpy's argmin, as above) in its own slab; no B is stored.  A
// transform is one fused pass over the pairs (pair_sums: rows snaked over
// the warps, lane l on the pairs j = i + 1 + l + 32t of row i; each pair's
// d_ij and b_ij once, the stress and the row partials by butterflies, the
// column partials in each warp's own [m][4] of shared memory) and one pass over the rows
// (guttman_finish: column partials in warp order, then the row's own),
// two barriers in all; the pass that gives a configuration's stress also
// gives its transform, so the stop test reads the pass that made the next
// X.  A window takes m(m-1)/2 + 41m elements (Fp, 8 warps' column
// partials [m][4], the row partials, X, XN and the best X): in shared
// memory to m = 203 in float64, 302 in float32 (mode 2 also needs
// css_block.cuh's cmds_embed_block scratch there, which is smaller), in
// device memory above, one slab per block of a grid of one block per SM.
// kernels/css.py smacof_pairs(lanes=BLOCK_LANES) follows this order bit
// for bit.  Mode 2 embeds with cmds_embed_block.  Its least work is
// smacof_ops(m) a transform; what bounds it is the latency of each
// pair's square root and division (a lane overlaps two pairs' at a time)
// with 8 warps an SM in float64 at m = 200 (one block), then shared
// memory: a pair reads F_ij and x_j and adds into column j's three
// partials.
//
// What bounds the warp form on H100: latency of dependent iterations.  A restart is
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

constexpr int kSmacofThreads = 256;   // the block form's threads
constexpr int kSmacofWarps = kSmacofThreads / 32;
constexpr int kSmacofRed = red_bytes<kSmacofThreads>();

// Elements of T before X in one block's slab: Fp [P] (rounded up to 4
// elements), the warps' column partials [NW][m][4] (three used, so a
// column's partials load and store as one 4-vector) and the rows' own
// partials [3][m] (mode 2: cmds_embed_block's scratch over them, before
// they are filled), rounded up to an even count so X's pairs load as
// 2-vectors.
__host__ __device__ constexpr int fp_elems(int m) { return (npairs(m) + 3) / 4 * 4; }
__host__ __device__ constexpr int block_head(int m, int mode) {
    return ((mode == 2 && cmds_block_scratch(m) > fp_elems(m) + m * (4 * kSmacofWarps + 3)
                 ? cmds_block_scratch(m)
                 : fp_elems(m) + m * (4 * kSmacofWarps + 3)) + 1) / 2 * 2;
}

// Elements of T of one block's slab: the head, then X, XN and the best
// restart's X [m][2] (an even count: every slab stays 16-byte aligned).
__host__ __device__ constexpr int block_elems(int m, int mode) {
    return block_head(m, mode) + 6 * m;
}

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
    using type = float4;
};
template <>
struct Vec4<double> {
    using type = double4;
};

// Chunks of 32 pairs a lane takes at once in the fused pass: independent
// square roots and divisions that overlap.
constexpr int kPairChunks = 2;

// warp_sum of x, y and z in 6 shuffles where three butterflies take 15:
// at offset 16 each half keeps two of (x, y, z, 0), at offset 8 one of
// two, then three plain levels.  Every sum adds the same two operands as
// warp_sum's butterfly (in the other order, which floating addition does
// not see), so lane 0 ends with warp_sum(x), lane 8 with warp_sum(y) and
// lane 16 with warp_sum(z), bit for bit.
template <typename T>
__device__ __forceinline__ T warp_sum3(T x, T y, T z, int lane) {
    const unsigned full = 0xffffffffu;
    const bool hi = lane & 16;
    const T a = (hi ? z : x) + __shfl_xor_sync(full, hi ? x : z, 16);
    const T b = (hi ? T(0) : y) + __shfl_xor_sync(full, hi ? y : T(0), 16);
    const bool mid = lane & 8;
    T c = (mid ? b : a) + __shfl_xor_sync(full, mid ? a : b, 8);
    for (int o = 4; o > 0; o >>= 1) c += __shfl_xor_sync(full, c, o);
    return c;
}

// One chunk group of row i (pairs j = i + 1 + o + 32u, u < kPairChunks)
// on one lane: its stress, row and column partials added; MASK for the
// row's last group, where a lane past the row adds +0.0 (to partials
// that are never -0.0: the same bits as adding nothing).
template <bool MASK, typename T, typename P2, typename P4>
__device__ __forceinline__ void pair_chunks(const T* Fi, const P2* X2, P4* cw4, P2 xi, int i,
                                            int o, int n, T& sp, T& rs, T& a0, T& a1) {
    constexpr int U = kPairChunks;
    bool on[U];
    int jj[U];
    T f[U];
    P2 xj[U];
    P4 c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        on[u] = !MASK || o + 32 * u < n;
        jj[u] = i + 1 + (on[u] ? o + 32 * u : 0);
        f[u] = Fi[jj[u]];
        xj[u] = X2[jj[u]];
        c[u] = cw4[jj[u]];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const T dx0 = xi.x - xj[u].x;
        const T dx1 = xi.y - xj[u].y;
        const T d = t_sqrt(dx0 * dx0 + dx1 * dx1);
        const T r = on[u] ? d - f[u] : T(0);
        sp += r * r;
        const T b = on[u] && d >= T(0.00001) ? -f[u] / d : T(0);
        rs += b;
        a0 += b * xj[u].x;
        a1 += b * xj[u].y;
        c[u].x += b;
        c[u].y += b * xi.x;
        c[u].z += b * xi.y;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (on[u]) cw4[jj[u]] = c[u];
    }
}

// The fused pass over X: the stress of X returned (every thread the same
// bits) and the sums of the transform T(X) left in colp / rowp.  Warp w
// takes rows i = s NW + w (s even) or s NW + NW - 1 - w (s odd), s
// ascending (the triangle's rows snaked over the warps, so each warp has
// as many pairs as the next to a row); in row i lane l takes the pairs
// j = i + 1 + l + 32t, t ascending, kPairChunks chunks at a time (masked
// only in the row's last group).  Each pair's d_ij and b_ij = -F_ij /
// d_ij (0 where d_ij < 1e-5) once: (d_ij - F_ij)^2 into the lane's stress
// partial, b_ij and b_ij x_j into row i's lane partials (closed by an xor
// butterfly, warp_sum3, stored to rowp [3][m]), b_ij and b_ij x_i into column j's
// partials in the warp's colp [m][4], each added over the warp's rows in
// row order.  The stress: the lanes' partials by a butterfly, the warps'
// in warp order, then diag.  Ends with __syncthreads.
template <typename T>
__device__ T pair_sums(const T* Fp, const T* X, T* colp, T* rowp, T* spw, int m, T diag) {
    constexpr int NW = kSmacofWarps;
    constexpr int U = kPairChunks;
    using P2 = typename Vec2<T>::type;
    using P4 = typename Vec4<T>::type;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const P2* X2 = reinterpret_cast<const P2*>(X);
    P4* cw4 = reinterpret_cast<P4*>(colp) + warp * m;
    for (int j = lane; j < m; j += 32) cw4[j] = P4{T(0), T(0), T(0), T(0)};
    __syncwarp();
    T sp = T(0);
    for (int s = 0; s * NW < m; ++s) {
        const int i = s * NW + ((s & 1) ? NW - 1 - warp : warp);
        if (i >= m) continue;   // warp-uniform
        const P2 xi = X2[i];
        const int n = m - 1 - i;                                 // the row's pairs
        const T* Fi = Fp + (i * m - i * (i + 1) / 2 - i - 1);   // Fi[j]: pair (i, j)
        T rs = T(0), a0 = T(0), a1 = T(0);
        int o = lane;
        for (; o - lane + 32 * U <= n; o += 32 * U) {   // whole groups (warp-uniform)
            pair_chunks<false>(Fi, X2, cw4, xi, i, o, n, sp, rs, a0, a1);
        }
        if (o - lane < n) pair_chunks<true>(Fi, X2, cw4, xi, i, o, n, sp, rs, a0, a1);
        __syncwarp();   // the next row's lanes add to these columns
        const T sum = warp_sum3(rs, a0, a1, lane);
        if ((lane & 7) == 0 && lane < 24) rowp[(lane >> 3) * m + i] = sum;
    }
    sp = warp_sum(sp);
    if (lane == 0) spw[warp] = sp;
    __syncthreads();
    T st = spw[0];
    for (int q = 1; q < NW; ++q) st += spw[q];
    return st + diag;
}

// The transform from pair_sums' partials: row j's sums are its column
// partials added in warp order, then its own row partial; XN_j =
// (sum_{k != j} b_jk x_k - (sum_{k != j} b_jk) x_j) / m.  Ends with
// __syncthreads.
template <typename T>
__device__ void guttman_finish(const T* colp, const T* rowp, const T* X, T* XN, int m) {
    using P4 = typename Vec4<T>::type;
    const P4* c4 = reinterpret_cast<const P4*>(colp);
    for (int j = threadIdx.x; j < m; j += kSmacofThreads) {
        P4 c = c4[j];
        T rs = c.x, a0 = c.y, a1 = c.z;
        for (int q = 1; q < kSmacofWarps; ++q) {
            c = c4[q * m + j];
            rs += c.x;
            a0 += c.y;
            a1 += c.z;
        }
        rs += rowp[j];
        a0 += rowp[m + j];
        a1 += rowp[2 * m + j];
        XN[2 * j] = (a0 - rs * X[2 * j]) / static_cast<T>(m);
        XN[2 * j + 1] = (a1 - rs * X[2 * j + 1]) / static_cast<T>(m);
    }
    __syncthreads();
}

// One restart from *X: its final stress returned, its transform count
// written; *X points at the final configuration.  Each pass over the
// pairs gives the stress of the configuration it reads and the sums of
// its transform, so the stop test reads the pass that also made the next
// X; at the stop those sums are left unused.
template <typename T>
__device__ T smacof_restart_block(const T* Fp, T* colp, T* rowp, T* spw, T** X, T** XN, int m,
                                  T diag, int max_iters, T eps, int* ntrans) {
    T sig = pair_sums(Fp, *X, colp, rowp, spw, m, diag);
    bool active = sig == sig;
    int n = 0;
    while (active) {
        guttman_finish(colp, rowp, *X, *XN, m);
        ++n;
        T* t = *X;
        *X = *XN;
        *XN = t;
        const T s = pair_sums(Fp, *X, colp, rowp, spw, m, diag);
        active = (sig - s) > eps && n <= max_iters;
        sig = s;
    }
    *ntrans = n;
    return sig;
}

// Registers for MB blocks an SM: the launcher takes MB = 3 in float32
// where three slabs fit an SM (to m = 159 on an H100), else MB = 2 (two
// fit in float32 to m = 203, in float64 to m = 134).
// kDevSlab: the slab lives in device memory (gslab), else in shared
// memory, where the compiler then addresses it as shared (one kernel for
// both, its slab pointer generic, took 1.01-1.12x the time on an H100:
// tests/measure_smacof_block.py).
template <int MB, bool kDevSlab, typename T>
__global__ void __launch_bounds__(kSmacofThreads, MB)
css_smacof_block(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
                 const int64_t* __restrict__ slots, uint2 chrom_key, int64_t nwin, int asize,
                 int bsize, int mode, int nrest, int max_iters, T eps, T wa, T wb,
                 int* __restrict__ counters, T* __restrict__ scores, T* __restrict__ dist_out,
                 uint8_t* __restrict__ valid_out, int* __restrict__ restart_out,
                 int* __restrict__ ntrans_out, int* __restrict__ total_out,
                 T* __restrict__ gslab) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int NT = kSmacofThreads;
    int* bc = reinterpret_cast<int*>(smem_raw + bcast_offset<NT>());   // the task
    const int m = asize + bsize;
    const int mm = m * m;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    void* red = smem_raw;
    T* spw = static_cast<T*>(red) + 2 * kSmacofWarps;   // [NW] the warps' stress
    T* S = kDevSlab ? gslab + static_cast<int64_t>(blockIdx.x) * block_elems(m, mode)
                    : reinterpret_cast<T*>(smem_raw + kSmacofRed);
    T* Fp = S;                                   // [P] F's upper triangle
    T* colp = Fp + fp_elems(m);                  // [NW][m][4]
    T* rowp = colp + 4 * m * kSmacofWarps;       // [3][m]
    T* X0 = S + block_head(m, mode);             // [m][2]
    T* XN0 = X0 + 2 * m;                         // [m][2]
    T* Xb = XN0 + 2 * m;                         // [m][2] the best restart's X

    for (;;) {
        if (tid == 0) bc[0] = atomicAdd(counters, 1);
        __syncthreads();
        const int64_t w = bc[0];
        if (w >= nwin) break;
        const T* D = dis + w * mm;
        const Fill<T> fs = fill_stats_block<NT>(D, m, red);
        if (mode == 2) cmds_embed_block<NT>(D, m, fs.avg, S, X0, red);   // ends with a barrier
        T dpart = T(0);
        for (int i = tid; i < m; i += NT) {
            const T f = filled(D[static_cast<int64_t>(i) * m + i], fs.avg);
            dpart += f * f;
        }
        const T diag = T(0.5) * block_reduce<NT>(dpart, red, Add());
        // F staged once a window, for every restart
        for (int i = warp; i < m; i += kSmacofWarps) {
            T* Fi = Fp + (i * m - i * (i + 1) / 2 - i - 1);
            for (int j = i + 1 + lane; j < m; j += 32) {
                Fi[j] = filled(D[static_cast<int64_t>(i) * m + j], fs.avg);
            }
        }
        int best = 0, best_n = 0, total = 0;
        T bs = T(0);
        for (int r = 0; r < nrest; ++r) {
            if (mode == 1) {
                const uint2 wkey = tf::fold_in(chrom_key, static_cast<uint32_t>(slots[w]));
                for (int p = tid; p < 2 * m; p += NT) {
                    X0[p] = tf::uniform<T>(wkey, static_cast<uint32_t>(r * 2 * m + p));
                }
            }
            __syncthreads();
            T* X = X0;
            T* XN = XN0;
            int n = 0;
            const T s = smacof_restart_block(Fp, colp, rowp, spw, &X, &XN, m, diag, max_iters,
                                             eps, &n);
            total += n;
            // numpy's argmin over the restarts: the first NaN, else the
            // first minimum (block-uniform)
            if (r == 0 || (!isnan(bs) && (isnan(s) || s < bs))) {
                best = r;
                best_n = n;
                bs = s;
                for (int p = tid; p < 2 * m; p += NT) Xb[p] = X[p];
            }
            __syncthreads();   // X0 and the stress slots are the next restart's
        }
        score_window_block<NT>(Xb, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,
                               dist_out + w * mm, scores + w, valid_out + w, red);
        if (tid == 0) {
            restart_out[w] = best;
            ntrans_out[w] = best_n;
            if (total_out) total_out[w] = total;
        }
        __syncthreads();   // Xb and bc are the next task's
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
    return kSmacofRed + (in_device ? 0 : static_cast<size_t>(block_elems(m, mode)) * sizeof(T));
}

// The form css_smacof takes at panel size m in mode 1 or 2: 0, css_smacof
// (persistent warps), where kWarps warps' slabs fit a block (to m = 68 in
// float64, 97 in float32 on Hopper); 1, css_smacof_block with its slab in
// shared memory (to 203 / 302); 2, css_smacof_block with slabs of
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

// Blocks of css_smacof_block<MB, kDevSlab, T> that fit an SM with smem
// bytes each (after setting its shared-memory attribute); negative: a
// CUDA error.
template <int MB, bool kDevSlab, typename T>
int blocks_per_sm(size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(css_smacof_block<MB, kDevSlab, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    int per_sm = 0;
    if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, css_smacof_block<MB, kDevSlab, T>, kSmacofThreads, smem);
    }
    return e == cudaSuccess ? per_sm : -static_cast<int>(e);
}

// Launches css_smacof_block<MB, kDevSlab, T> on ``blocks`` blocks, its
// arguments passed through.
template <int MB, bool kDevSlab, typename T, typename... Args>
int start_block(unsigned blocks, size_t smem, cudaStream_t st, Args... args) {
    css_smacof_block<MB, kDevSlab, T><<<blocks, kSmacofThreads, smem, st>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// A window a task, its restarts one after another in the block; the
// blocks persistent, as many as fit on the card at once (at most nslab
// with slabs in device memory).  gslab: nslab slabs of block_elems(m,
// mode) in device memory, or null for the slab in shared memory.
template <typename T>
int launch_smacof_block(const T* dis, const int64_t* npos, const int64_t* slots,
                        int64_t nwin, uint32_t key0, uint32_t key1, int asize,
                        int bsize, int mode, int n_init, int max_iters, double eps,
                        double wa, double wb, T* scores, T* dist,
                        uint8_t* valid, int* restart, int* ntrans, int* total, int* counters,
                        T* gslab, int64_t nslab, void* stream) {
    if (nwin == 0) return 0;
    const int m = asize + bsize;
    const int nrest = mode == 1 ? n_init : 1;
    if ((mode != 1 && mode != 2) || nrest < 1 || max_iters < 0 || m < 2 || asize < 1 ||
        bsize < 1 || nwin > 0x7fffffff - kSmacofThreads * 1024 || (gslab && nslab < 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = block_smem<T>(m, mode, gslab != nullptr);
    if (smem > fetk::smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    int device = 0, sms = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess) {
        return static_cast<int>(e);
    }
    bool three = false;
    if constexpr (sizeof(T) == 4) {
        const int b3 = gslab ? 0 : blocks_per_sm<3, false, T>(smem);
        if (b3 < 0) return -b3;
        three = b3 >= 3;
    }
    const int per_sm = three  ? 3
                       : gslab ? blocks_per_sm<2, true, T>(smem)
                               : blocks_per_sm<2, false, T>(smem);
    if (per_sm < 0) return -per_sm;
    int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    if (gslab && nslab < fit) fit = nslab;
    const unsigned blocks = static_cast<unsigned>(nwin < fit ? nwin : fit);
    const uint2 key = make_uint2(key0, key1);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T teps = static_cast<T>(eps), twa = static_cast<T>(wa), twb = static_cast<T>(wb);
    if constexpr (sizeof(T) == 4) {
        if (three) {
            return start_block<3, false, T>(blocks, smem, st, dis, npos, slots, key, nwin, asize,
                                            bsize, mode, nrest, max_iters, teps, twa, twb,
                                            counters, scores, dist, valid, restart, ntrans,
                                            total, gslab);
        }
    }
    if (gslab) {
        return start_block<2, true, T>(blocks, smem, st, dis, npos, slots, key, nwin, asize,
                                       bsize, mode, nrest, max_iters, teps, twa, twb, counters,
                                       scores, dist, valid, restart, ntrans, total, gslab);
    }
    return start_block<2, false, T>(blocks, smem, st, dis, npos, slots, key, nwin, asize, bsize,
                                    mode, nrest, max_iters, teps, twa, twb, counters, scores,
                                    dist, valid, restart, ntrans, total, gslab);
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
                                    int* total, int* counters, double* gslab, int64_t nslab,
                                    void* stream) {
    return launch_smacof_block<double>(dis, npos, slots, nwin, key0, key1, asize, bsize, mode,
                                       n_init, max_iters, eps, wa, wb, scores, dist, valid,
                                       restart, ntrans, total, counters, gslab, nslab, stream);
}

FET_EXPORT int css_smacof_block_f32(const float* dis, const int64_t* npos,
                                    const int64_t* slots, int64_t nwin,
                                    uint32_t key0, uint32_t key1, int asize,
                                    int bsize, int mode, int n_init, int max_iters,
                                    double eps, double wa, double wb, float* scores,
                                    float* dist, uint8_t* valid, int* restart, int* ntrans,
                                    int* total, int* counters, float* gslab, int64_t nslab,
                                    void* stream) {
    return launch_smacof_block<float>(dis, npos, slots, nwin, key0, key1, asize, bsize, mode,
                                      n_init, max_iters, eps, wa, wb, scores, dist, valid,
                                      restart, ntrans, total, counters, gslab, nslab, stream);
}
