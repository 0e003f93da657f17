// K3 (and K4): opposite-homozygote pair counts of every window, in two
// forms: the windows of a chromosome (K3) and pre-gathered windows (K4's
// gather form, the sharded step's).
//
// Replaces divergence_tpu/kernels/css.py: dissimilarity_prefix +
// dissimilarity_from_prefix (the [N+1, m, m] chromosome prefix, K3) and
// dissimilarity_counts (the one-hot product over gathered windows, K4).
// All give the same integer counts.  Plain torch versions:
// divergence_tpu_torch/kernels/css.py dissimilarity_plain and
// dissimilarity_gathered_plain; the bit-plane mirrors pack_bitplanes_plain,
// dissimilarity_bitplanes_plain, gathered_bitplanes_plain and (the
// large-panel kernel's slabs and popcounts) dissimilarity_rows_plain follow
// the kernels' words step by step.
//
// D[i][j] = #{SNPs s in the window : (c_si == 3 && c_sj == -3) ||
//                                     (c_si == -3 && c_sj == 3)}
// (reference statistics/css/css.c:277-327).  The missing code -10000
// and heterozygotes 0 never count; the diagonal is 0.
//
// Chromosome form, two launches in one call:
//   1. css_pack: the chromosome's codes once into a hom-major (== 3) and
//      a hom-minor (== -3) bit plane, word-major [W + 1][m] uint32 each
//      (W = ceil(N/32); bit b of word k of individual i is SNP 32 k + b;
//      the last word is 0 so a window's funnel shift may read one past
//      its end).  One warp a word: lane b holds SNP 32 k + b, a ballot per
//      individual, coalesced stores of 32 individuals' words.  It mirrors
//      JAX's two phases: one chromosome-wide pass, then a read per window.
//   2. css_dissim: one warp per window [lo, lo + n).  In passes of up to
//      kWords words it reads word k of individual i as
//      __funnelshift_r(plane[w0 + k][i], plane[w0 + k + 1][i], lo % 32)
//      (w0 = lo / 32; individuals fastest, so the reads are coalesced),
//      clears the bits past n, and keeps the window's words in shared
//      memory.
// Gathered form (css_dissim_gathered): [B, P, a] and [B, P, b] int16
// codes as two pointers, window w's rows 0 .. npos[w]; one warp per
// window stages 128 rows at a time of its contiguous a and b blocks in
// shared memory (16-byte cp.async copies where the batch's rows allow,
// else 2-byte copies) and packs its words from them (lane b holds row
// 32 k + b, a ballot per individual, a's individuals then b's), with no
// joint copy of the codes.
// Both forms then count alike: each lane owns pairs i < j of the upper
// triangle (row-major, pair p = lane + 32 t, about 7 a lane at m = 21)
// and adds popc(maj_i & mnr_j) + popc(mnr_i & maj_j) over the words into
// both triangles of an int32 [m][m] count in shared memory (set, with the
// zero diagonal, by the first pass); the warp copies it out in one
// coalesced pass in the compute dtype (exact: a count is at most the
// window's n).
//
// Large panels: the chromosome form takes the warp form where a block
// holds all kWarps windows' slabs (4 m^2 + 64 m bytes each, to m = 112);
// above that fewer warps an SM write the counts (one at m = 200: 24.4 ms
// against the tiles' 2.9 on 19,997 windows, tests/measure_large_panels.py).
// The gathered form keeps its warp form while one window's slab fits (to
// m = 207 at an even split).  Above those css_dissim_rows counts a window
// with one block (a few past kRowTasksPerBlock tasks): its words staged
// once, four output rows' runs counted in registers at a time, each row
// written as one stream of streaming stores (see the kernel).  The gathered form
// first packs its windows' words (css_pack_gathered: one warp per
// (window, word), a ballot per individual, the last word of a window 0)
// into per-window planes, then runs the same kernel with window w's
// planes starting at bit 32 w (ceil(P/32) + 1).  Past the panel size
// where a block cannot stage one word a plane (m > 29,056),
// css_dissim_tile takes over: one block of 32 x 8 threads per (window,
// 32 x 32 tile) of the pair matrix, its counts in registers.
//
// What bounds it on H100: the output.  A window writes m^2 counts (3.5 KB
// at m = 21 in float64, 160 KB at m = 200 in float32) and reads its m
// (ceil(n/32) + 1) words of each plane (~500 bytes at n = 50, from L2: the
// planes of an 8 M-SNP chromosome at m = 21 take 42 MB); the gathered
// form reads its n m codes once.  The popcounts are m(m-1)/2 pairs x 2 x
// ceil(n/32) words in the warp form (m^2 x ceil(n/32) in the large-panel
// form, one a word and cell): small at n = 50.  No block barrier in the
// warp form: each warp owns its window.
#include "fet_common.cuh"

namespace {

using fetk::kAsync16;
using fetk::kCopy2;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 8;                 // words of 32 SNPs a chromosome pass keeps
constexpr int kGatherWords = 4;           // words (and 32-row blocks) a gathered pass stages

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
    return (bytes + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one window's warp, 16-byte aligned: the staged codes
// of a pass (the gathered form: a and b codes of 32 words rows each, each
// block 16-byte aligned), then the maj and mnr words [m][words], then the
// pair counts [m][m] (the upper triangle used).
__host__ __device__ __forceinline__ size_t codes_bytes(int asize, int bsize, int words) {
    return align16(static_cast<size_t>(32) * words * asize * 2) +
           align16(static_cast<size_t>(32) * words * bsize * 2);
}

__host__ __device__ __forceinline__ size_t warp_bytes(int m, int words, size_t codes) {
    return align16(codes + (2 * static_cast<size_t>(m) * words + static_cast<size_t>(m) * m) * 4);
}

inline int warps_per_block(size_t bytes) {
    const size_t fit = fetk::smem_optin() / bytes;
    return static_cast<int>(fit < kWarps ? fit : kWarps);
}

// Add the pairs' popcounts over `words` words of the shared slabs (row
// stride `stride` words) to both triangles of cnt, or set them (and the
// zero diagonal) on the first pass.  Lane l owns pairs p = l + 32 t of
// the row-major upper triangle, pair (i, i + 1 + t') found by walking
// whole rows.
__device__ __forceinline__ void count_pairs(const uint32_t* maj, const uint32_t* mnr,
                                            int stride, int* cnt, int m, int words,
                                            bool first, int lane) {
    int i = 0, t = lane;
    for (;;) {
        while (i < m - 1 && t >= m - 1 - i) {
            t -= m - 1 - i;
            ++i;
        }
        if (i >= m - 1) break;
        const int j = i + 1 + t;
        int acc = 0;
        for (int k = 0; k < words; ++k) {
            acc += __popc(maj[i * stride + k] & mnr[j * stride + k]) +
                   __popc(mnr[i * stride + k] & maj[j * stride + k]);
        }
        const int c = first ? acc : cnt[i * m + j] + acc;
        cnt[i * m + j] = c;
        cnt[j * m + i] = c;
        t += 32;
    }
    if (first) {
        for (int d = lane; d < m; d += 32) cnt[d * m + d] = 0;
    }
}

// The window's [m][m] counts (all zero when `empty`), element p by lane
// p % 32: one coalesced pass.
template <typename T>
__device__ __forceinline__ void write_counts(const int* cnt, int m, bool empty,
                                             T* __restrict__ o, int lane) {
    for (int p = lane; p < m * m; p += 32) o[p] = static_cast<T>(empty ? 0 : cnt[p]);
}

__global__ void __launch_bounds__(kThreads)
css_pack(const int16_t* __restrict__ vals, int64_t N, int m, int64_t words,
         uint32_t* __restrict__ maj, uint32_t* __restrict__ mnr) {
    const int lane = threadIdx.x & 31;
    const int64_t k = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (k >= words) return;
    const int64_t s = k * 32 + lane;
    const int16_t* row = vals + s * m;
    for (int i0 = 0; i0 < m; i0 += 32) {
        uint32_t my_maj = 0, my_mnr = 0;
        const int span = min(32, m - i0);
        for (int d = 0; d < span; ++d) {
            const int v = s < N ? row[i0 + d] : 0;
            const uint32_t bmaj = __ballot_sync(kFullMask, v == 3);
            const uint32_t bmnr = __ballot_sync(kFullMask, v == -3);
            if (lane == d) {
                my_maj = bmaj;
                my_mnr = bmnr;
            }
        }
        if (lane < span) {
            maj[k * m + i0 + lane] = my_maj;
            mnr[k * m + i0 + lane] = my_mnr;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
css_dissim(const uint32_t* __restrict__ maj, const uint32_t* __restrict__ mnr,
           const int64_t* __restrict__ lo_arr, const int64_t* __restrict__ npos_arr,
           int64_t nwin, int m, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (w >= nwin) return;
    uint32_t* smaj = reinterpret_cast<uint32_t*>(smem_raw + warp * warp_bytes(m, kWords, 0));
    uint32_t* smnr = smaj + m * kWords;
    int* cnt = reinterpret_cast<int*>(smnr + m * kWords);

    const int64_t lo = lo_arr[w];
    const int n = static_cast<int>(npos_arr[w]);
    const int64_t w0 = lo >> 5;
    const int sh = static_cast<int>(lo & 31);
    const int nwords = (n + 31) / 32;
    for (int k0 = 0; k0 < nwords; k0 += kWords) {
        const int kw = min(kWords, nwords - k0);
        __syncwarp();   // the previous pass has read the slabs
        for (int k = 0; k < kw; ++k) {
            const int rem = n - (k0 + k) * 32;   // >= 1: the window's SNPs in this word
            const uint32_t keep = rem < 32 ? (1u << rem) - 1u : ~0u;
            const int64_t g = (w0 + k0 + k) * m;
            for (int i = lane; i < m; i += 32) {
                smaj[i * kWords + k] = __funnelshift_r(maj[g + i], maj[g + m + i], sh) & keep;
                smnr[i * kWords + k] = __funnelshift_r(mnr[g + i], mnr[g + m + i], sh) & keep;
            }
        }
        __syncwarp();
        count_pairs(smaj, smnr, kWords, cnt, m, kw, k0 == 0, lane);
    }
    __syncwarp();
    write_counts(cnt, m, nwords == 0, out + w * m * m, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
css_dissim_gathered(const int16_t* __restrict__ av, const int16_t* __restrict__ bv,
                    const int64_t* __restrict__ npos_arr, int64_t nwin, int p_in,
                    int asize, int bsize, int stage, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = asize + bsize;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (w >= nwin) return;
    const size_t codes = codes_bytes(asize, bsize, kGatherWords);
    unsigned char* mine = smem_raw + warp * warp_bytes(m, kGatherWords, codes);
    int16_t* sa = reinterpret_cast<int16_t*>(mine);
    int16_t* sb = reinterpret_cast<int16_t*>(
        mine + align16(static_cast<size_t>(32) * kGatherWords * asize * 2));
    uint32_t* smaj = reinterpret_cast<uint32_t*>(mine + codes);
    uint32_t* smnr = smaj + m * kGatherWords;
    int* cnt = reinterpret_cast<int*>(smnr + m * kGatherWords);

    const int n = static_cast<int>(npos_arr[w]);
    const int nwords = (n + 31) / 32;
    for (int k0 = 0; k0 < nwords; k0 += kGatherWords) {
        const int kw = min(kGatherWords, nwords - k0);
        const int r0 = 32 * k0;                  // the pass's first row
        const int rows = min(32 * kw, n - r0);
        __syncwarp();   // the previous pass has read the slabs
        fetk::stage_codes(sa, av + (w * p_in + r0) * asize, rows * asize, stage, lane);
        fetk::stage_codes(sb, bv + (w * p_in + r0) * bsize, rows * bsize, stage, lane);
        fetk::stage_wait(stage);
        for (int k = 0; k < kw; ++k) {
            const int r = 32 * k + lane;         // this lane's row of the pass
            const bool row_in = r < rows;
            for (int i0 = 0; i0 < m; i0 += 32) {
                uint32_t my_maj = 0, my_mnr = 0;
                const int span = min(32, m - i0);
                for (int d = 0; d < span; ++d) {
                    const int i = i0 + d;
                    const int v = !row_in ? 0 : (i < asize ? sa[r * asize + i]
                                                           : sb[r * bsize + i - asize]);
                    const uint32_t bmaj = __ballot_sync(kFullMask, v == 3);
                    const uint32_t bmnr = __ballot_sync(kFullMask, v == -3);
                    if (lane == d) {
                        my_maj = bmaj;
                        my_mnr = bmnr;
                    }
                }
                if (lane < span) {
                    smaj[(i0 + lane) * kGatherWords + k] = my_maj;
                    smnr[(i0 + lane) * kGatherWords + k] = my_mnr;
                }
            }
        }
        __syncwarp();
        count_pairs(smaj, smnr, kGatherWords, cnt, m, kw, k0 == 0, lane);
    }
    __syncwarp();
    write_counts(cnt, m, nwords == 0, out + w * m * m, lane);
}

constexpr int kTile = 32;                   // individuals per tile side
constexpr int kTileRows = 8;                // thread rows: each owns 4 rows of the tile
constexpr int kTileThreads = kTile * kTileRows;
constexpr int kTileWords = kTileRows;       // words a tile pass stages (one per thread row)

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
css_dissim_tile(const uint32_t* __restrict__ maj, const uint32_t* __restrict__ mnr,
                const int64_t* __restrict__ lo_arr, const int64_t* __restrict__ npos_arr,
                int64_t nwin, int m, int tiles, T* __restrict__ out) {
    // [i maj, i mnr, j maj, j mnr][individual][word]; the odd stride keeps
    // the column words' reads (tx varying) free of bank conflicts
    __shared__ uint32_t sw[4][kTile][kTileWords + 1];
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    const int64_t per = static_cast<int64_t>(tiles) * tiles;
    const int64_t w = blockIdx.x / per;
    if (w >= nwin) return;
    const int t = static_cast<int>(blockIdx.x - w * per);
    const int i0 = (t / tiles) * kTile;
    const int j0 = (t % tiles) * kTile;
    const int64_t lo = lo_arr[w];
    const int n = static_cast<int>(npos_arr[w]);
    const int64_t w0 = lo >> 5;
    const int sh = static_cast<int>(lo & 31);
    const int nwords = (n + 31) / 32;
    int acc[4] = {0, 0, 0, 0};
    for (int k0 = 0; k0 < nwords; k0 += kTileWords) {
        const int kw = min(kTileWords, nwords - k0);
        __syncthreads();   // the previous pass has read the words
        if (ty < kw) {
            const int k = k0 + ty;
            const int rem = n - k * 32;
            const uint32_t keep = rem < 32 ? (1u << rem) - 1u : ~0u;
            const int64_t g = (w0 + k) * m;
            const int ii = i0 + tx;
            const int jj = j0 + tx;
            uint32_t a = 0, b = 0, c = 0, d = 0;
            if (ii < m) {
                a = __funnelshift_r(maj[g + ii], maj[g + m + ii], sh) & keep;
                b = __funnelshift_r(mnr[g + ii], mnr[g + m + ii], sh) & keep;
            }
            if (jj < m) {
                c = __funnelshift_r(maj[g + jj], maj[g + m + jj], sh) & keep;
                d = __funnelshift_r(mnr[g + jj], mnr[g + m + jj], sh) & keep;
            }
            sw[0][tx][ty] = a;
            sw[1][tx][ty] = b;
            sw[2][tx][ty] = c;
            sw[3][tx][ty] = d;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = ty + kTileRows * q;
            for (int k = 0; k < kw; ++k) {
                acc[q] += __popc(sw[0][r][k] & sw[3][tx][k]) + __popc(sw[1][r][k] & sw[2][tx][k]);
            }
        }
    }
    const int j = j0 + tx;
    if (j >= m) return;
    T* o = out + w * m * m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty + kTileRows * q;
        if (i < m) o[static_cast<int64_t>(i) * m + j] = static_cast<T>(acc[q]);
    }
}

// css_dissim_rows: a block (or, past kRowTasksPerBlock tasks, a few) owns
// a window.  It stages the window's words, funnel-shifted and masked, in
// slabs of up to row_slab_words(m) words [S][m] a plane (individuals
// fastest: a warp's 32 columns read 32 banks); a warp then takes a task,
// kRowsPerTask output rows over one run of their columns, lane l counting
// columns c0 + l + 32 u of each row in registers: each column word is
// loaded once for the task's rows, and each cell adds
// popc((maj_i & mnr_j) | (mnr_i & maj_j)) a word (the two terms never
// share a bit: no individual is both homozygotes at a SNP).  Each row's
// run is then written as one stream of coalesced streaming stores, 128
// contiguous bytes a warp store in float32 (16-byte stores through a
// shared buffer took 6-11 % longer at m = 200, tests/measure_dissim_large.py).
// A window of one slab is staged once; a longer one restages its slabs for
// each round of tasks, its counts kept in registers between slabs.
constexpr int kRowWarps = 8;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowRegs = 8;                    // columns a lane counts: runs of 256
constexpr int kRowRun = 32 * kRowRegs;
constexpr int kRowsPerTask = 4;                // rows a warp counts at once
constexpr int kRowSlabWords = 8;               // words a slab stages at most (256 SNPs)
constexpr size_t kRowStageBytes = 16 * 1024;   // fewer words a slab past it
constexpr int kRowTasksPerBlock = 256;         // (row group, run) tasks a block takes at most

__host__ __device__ __forceinline__ int row_slab_words(int m) {
    const size_t fit = kRowStageBytes / (8 * static_cast<size_t>(m));
    return fit < 1 ? 1 : (fit > kRowSlabWords ? kRowSlabWords : static_cast<int>(fit));
}

// Columns of a run: a row's runs balanced, each a multiple of 32.
__host__ __device__ __forceinline__ int run_width(int m) {
    const int runs = (m + kRowRun - 1) / kRowRun;
    return 32 * (((m + runs - 1) / runs + 31) / 32);
}

// (row group, run) tasks of a window.
__host__ __device__ __forceinline__ int row_tasks(int m) {
    const int width = run_width(m);
    return (m + kRowsPerTask - 1) / kRowsPerTask * ((m + width - 1) / width);
}

__host__ __device__ __forceinline__ size_t rows_smem(int m) {
    return sizeof(uint32_t) * 2 * row_slab_words(m) * static_cast<size_t>(m);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
css_dissim_rows(const uint32_t* __restrict__ maj, const uint32_t* __restrict__ mnr,
                const int64_t* __restrict__ lo_arr, const int64_t* __restrict__ npos_arr,
                int64_t nwin, int m, int groups, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int S = row_slab_words(m);
    uint32_t* smaj = reinterpret_cast<uint32_t*>(smem_raw);   // [S][m]
    uint32_t* smnr = smaj + S * m;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = blockIdx.x / groups;
    const int g = static_cast<int>(blockIdx.x - w * groups);
    const int width = run_width(m);
    const int runs = (m + width - 1) / width;
    const int ntasks = row_tasks(m);
    const int per = (ntasks + groups - 1) / groups;
    const int t0 = g * per;
    const int t1 = min(ntasks, t0 + per);
    const int64_t lo = lo_arr[w];
    const int n = static_cast<int>(npos_arr[w]);
    const int64_t w0 = lo >> 5;
    const int sh = static_cast<int>(lo & 31);
    const int nwords = (n + 31) / 32;
    const int nslab = nwords == 0 ? 1 : (nwords + S - 1) / S;

    const auto stage = [&](int slab) {
        const int k0 = slab * S;
        const int kw = min(S, nwords - k0);
        for (int k = 0; k < kw; ++k) {
            const int rem = n - (k0 + k) * 32;   // >= 1: the window's SNPs in this word
            const uint32_t keep = rem < 32 ? (1u << rem) - 1u : ~0u;
            const int64_t gk = (w0 + k0 + k) * m;
            for (int i = threadIdx.x; i < m; i += kRowThreads) {
                smaj[k * m + i] = __funnelshift_r(maj[gk + i], maj[gk + m + i], sh) & keep;
                smnr[k * m + i] = __funnelshift_r(mnr[gk + i], mnr[gk + m + i], sh) & keep;
            }
        }
    };
    if (nslab == 1) {
        stage(0);
        __syncthreads();
    }
    for (int tb = t0; tb < t1; tb += kRowWarps) {   // a round: a task a warp
        const int task = tb + warp;
        const int i0 = task < t1 ? task / runs * kRowsPerTask : m;
        const int c0 = task < t1 ? (task - i0 / kRowsPerTask * runs) * width : 0;
        const int len = i0 < m ? min(width, m - c0) : 0;    // columns of the run
        const int rows = min(kRowsPerTask, m - i0);         // <= 0 past the last task
        int acc[kRowsPerTask][kRowRegs];
#pragma unroll
        for (int r = 0; r < kRowsPerTask; ++r) {
#pragma unroll
            for (int u = 0; u < kRowRegs; ++u) acc[r][u] = 0;
        }
        for (int slab = 0; slab < nslab; ++slab) {
            if (nslab > 1) {
                __syncthreads();   // the last slab is read
                stage(slab);
                __syncthreads();
            }
            const int kw = len > 0 ? min(S, nwords - slab * S) : 0;
            for (int k = 0; k < kw; ++k) {
                uint32_t a[kRowsPerTask], b[kRowsPerTask];
#pragma unroll
                for (int r = 0; r < kRowsPerTask; ++r) {
                    const int i = min(i0 + r, m - 1);
                    a[r] = smaj[k * m + i];
                    b[r] = smnr[k * m + i];
                }
                const uint32_t* cmaj = smaj + k * m + c0 + lane;
                const uint32_t* cmnr = smnr + k * m + c0 + lane;
#pragma unroll
                for (int u = 0; u < kRowRegs; ++u) {
                    if (32 * u >= len) break;
                    if (32 * u + lane < len) {
                        const uint32_t cj = cmnr[32 * u];
                        const uint32_t dj = cmaj[32 * u];
#pragma unroll
                        for (int r = 0; r < kRowsPerTask; ++r) {
                            acc[r][u] += __popc((a[r] & cj) | (b[r] & dj));
                        }
                    }
                }
            }
        }
        // each row's run as one stream of coalesced streaming stores
#pragma unroll
        for (int r = 0; r < kRowsPerTask; ++r) {
            if (r >= rows) break;
            T* dst = out + (w * m + i0 + r) * static_cast<int64_t>(m) + c0 + lane;
#pragma unroll
            for (int u = 0; u < kRowRegs; ++u) {
                if (32 * u >= len) break;
                if (32 * u + lane < len) __stcs(dst + 32 * u, static_cast<T>(acc[r][u]));
            }
        }
    }
}

// The gathered windows' words into per-window planes [nwin][wpw][m] (word
// wpw - 1 of every window, past its P rows, is 0): one warp per (window,
// word), lane b holding row 32 k + b, a's individuals then b's.
__global__ void __launch_bounds__(kThreads)
css_pack_gathered(const int16_t* __restrict__ av, const int16_t* __restrict__ bv,
                  const int64_t* __restrict__ npos_arr, int64_t nwin, int p_in, int asize,
                  int bsize, int wpw, uint32_t* __restrict__ maj, uint32_t* __restrict__ mnr) {
    const int lane = threadIdx.x & 31;
    const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (gw >= nwin * wpw) return;
    const int64_t w = gw / wpw;
    const int k = static_cast<int>(gw - w * wpw);
    const int m = asize + bsize;
    const int r = 32 * k + lane;
    const bool row_in = r < npos_arr[w];
    const int16_t* ra = av + (w * p_in + r) * asize;
    const int16_t* rb = bv + (w * p_in + r) * bsize;
    for (int i0 = 0; i0 < m; i0 += 32) {
        uint32_t my_maj = 0, my_mnr = 0;
        const int span = min(32, m - i0);
        for (int d = 0; d < span; ++d) {
            const int i = i0 + d;
            const int v = !row_in ? 0 : (i < asize ? ra[i] : rb[i - asize]);
            const uint32_t bmaj = __ballot_sync(kFullMask, v == 3);
            const uint32_t bmnr = __ballot_sync(kFullMask, v == -3);
            if (lane == d) {
                my_maj = bmaj;
                my_mnr = bmnr;
            }
        }
        if (lane < span) {
            maj[gw * m + i0 + lane] = my_maj;
            mnr[gw * m + i0 + lane] = my_mnr;
        }
    }
}

// The large-panel counts from packed planes: css_dissim_rows where its
// slab of one word a plane fits a block's shared memory (to m = 29,056 on
// Hopper), else css_dissim_tile.
template <typename T>
int launch_tiles(const uint32_t* maj, const uint32_t* mnr, const int64_t* lo,
                 const int64_t* npos, int64_t nwin, int m, T* out, cudaStream_t st) {
    const size_t smem = rows_smem(m);
    if (smem <= fetk::smem_optin()) {
        const int groups = (row_tasks(m) + kRowTasksPerBlock - 1) / kRowTasksPerBlock;
        const int64_t blocks = nwin * groups;
        if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                css_dissim_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        css_dissim_rows<T><<<static_cast<unsigned>(blocks), kRowThreads, smem, st>>>(
            maj, mnr, lo, npos, nwin, m, groups, out);
        return static_cast<int>(cudaGetLastError());
    }
    const int tiles = (m + kTile - 1) / kTile;
    const int64_t blocks = nwin * tiles * tiles;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    css_dissim_tile<T><<<static_cast<unsigned>(blocks), kTileThreads, 0, st>>>(
        maj, mnr, lo, npos, nwin, m, tiles, out);
    return static_cast<int>(cudaGetLastError());
}

// Block size and shared memory of a warp-per-window launch.
template <typename K>
int configure(K kernel, size_t bytes, int* wpb, size_t* smem) {
    *wpb = warps_per_block(bytes);
    if (*wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
    *smem = *wpb * bytes;
    if (*smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

template <typename T>
int launch_dissim(const int16_t* vals, int64_t N, const int64_t* lo,
                  const int64_t* npos, int64_t nwin, int m, uint32_t* planes,
                  T* out, void* stream) {
    if (nwin == 0) return 0;
    if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t words = (N + 31) / 32 + 1;
    uint32_t* maj = planes;
    uint32_t* mnr = planes + words * m;
    css_pack<<<static_cast<unsigned>((words + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        vals, N, m, words, maj, mnr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    int wpb;
    size_t smem;
    const int rc = configure(css_dissim<T>, warp_bytes(m, kWords, 0), &wpb, &smem);
    if (rc != 0) return rc;
    css_dissim<T><<<static_cast<unsigned>((nwin + wpb - 1) / wpb), wpb * 32, smem, st>>>(
        maj, mnr, lo, npos, nwin, m, out);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gathered(const int16_t* av, const int16_t* bv, const int64_t* npos,
                    int64_t nwin, int p_in, int asize, int bsize, T* out,
                    void* stream) {
    if (nwin == 0) return 0;
    if (asize < 1 || bsize < 1 || p_in < 1) return static_cast<int>(cudaErrorInvalidValue);
    // 16-byte copies need every pass's blocks 16-byte aligned: the bases and
    // the window strides p_in a 2 and p_in b 2 (a pass starts 64 a bytes
    // further, a multiple of 16)
    const bool aligned = reinterpret_cast<uintptr_t>(av) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(bv) % 16 == 0 &&
                         (static_cast<int64_t>(p_in) * asize * 2) % 16 == 0 &&
                         (static_cast<int64_t>(p_in) * bsize * 2) % 16 == 0;
    const int m = asize + bsize;
    int wpb;
    size_t smem;
    const int rc = configure(css_dissim_gathered<T>,
                             warp_bytes(m, kGatherWords, codes_bytes(asize, bsize, kGatherWords)),
                             &wpb, &smem);
    if (rc != 0) return rc;
    css_dissim_gathered<T><<<static_cast<unsigned>((nwin + wpb - 1) / wpb), wpb * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        av, bv, npos, nwin, p_in, asize, bsize, aligned ? kAsync16 : kCopy2, out);
    return static_cast<int>(cudaGetLastError());
}

// The tile form of the chromosome counts: css_pack, then css_dissim_tile.
template <typename T>
int launch_dissim_tiles(const int16_t* vals, int64_t N, const int64_t* lo,
                        const int64_t* npos, int64_t nwin, int m, uint32_t* planes,
                        T* out, void* stream) {
    if (nwin == 0) return 0;
    if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t words = (N + 31) / 32 + 1;
    uint32_t* maj = planes;
    uint32_t* mnr = planes + words * m;
    css_pack<<<static_cast<unsigned>((words + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        vals, N, m, words, maj, mnr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_tiles(maj, mnr, lo, npos, nwin, m, out, st);
}

// The tile form of the gathered counts: css_pack_gathered into planes
// [2][nwin][wpw][m], then css_dissim_tile with lo = the windows' first
// bits (32 wpw w, on the card).
template <typename T>
int launch_gathered_tiles(const int16_t* av, const int16_t* bv, const int64_t* npos,
                          const int64_t* lo, int64_t nwin, int p_in, int asize, int bsize,
                          uint32_t* planes, T* out, void* stream) {
    if (nwin == 0) return 0;
    if (asize < 1 || bsize < 1 || p_in < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int m = asize + bsize;
    const int wpw = (p_in + 31) / 32 + 1;
    uint32_t* maj = planes;
    uint32_t* mnr = planes + nwin * wpw * m;
    const int64_t warps = nwin * wpw;
    css_pack_gathered<<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kThreads, 0,
                        st>>>(av, bv, npos, nwin, p_in, asize, bsize, wpw, maj, mnr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_tiles(maj, mnr, lo, npos, nwin, m, out, st);
}

}  // namespace

// The form css_dissim takes at panel size m: 0, css_dissim (a warp per
// window), where a block holds all kWarps windows' slabs (to m = 112 on
// Hopper; with fewer warps a block it is the slower), else 1,
// css_dissim_tiles; neither takes a device slab (*slab_elems = 0).  -1
// where the device cannot be asked.
FET_EXPORT int css_dissim_form(int m, int64_t* slab_elems) {
    *slab_elems = 0;
    const size_t limit = fetk::smem_optin();
    if (limit == 0) return -1;
    return kWarps * warp_bytes(m, kWords, 0) <= limit ? 0 : 1;
}

// The form css_dissim_gathered takes: 0, a warp per window, while one
// window's staged codes, words and counts fit a block (to m = 207 at an
// even split on Hopper), else 1, the tiles.
FET_EXPORT int css_dissim_gathered_form(int asize, int bsize, int64_t* slab_elems) {
    *slab_elems = 0;
    const size_t limit = fetk::smem_optin();
    if (limit == 0) return -1;
    const size_t bytes =
        warp_bytes(asize + bsize, kGatherWords, codes_bytes(asize, bsize, kGatherWords));
    return bytes <= limit ? 0 : 1;
}

FET_EXPORT int css_dissim_f64(const int16_t* vals, int64_t N, const int64_t* lo,
                              const int64_t* npos, int64_t nwin, int m,
                              uint32_t* planes, double* out, void* stream) {
    return launch_dissim<double>(vals, N, lo, npos, nwin, m, planes, out, stream);
}

FET_EXPORT int css_dissim_f32(const int16_t* vals, int64_t N, const int64_t* lo,
                              const int64_t* npos, int64_t nwin, int m,
                              uint32_t* planes, float* out, void* stream) {
    return launch_dissim<float>(vals, N, lo, npos, nwin, m, planes, out, stream);
}

FET_EXPORT int css_dissim_gathered_f64(const int16_t* av, const int16_t* bv,
                                       const int64_t* npos, int64_t nwin, int p_in,
                                       int asize, int bsize, double* out, void* stream) {
    return launch_gathered<double>(av, bv, npos, nwin, p_in, asize, bsize, out, stream);
}

FET_EXPORT int css_dissim_gathered_f32(const int16_t* av, const int16_t* bv,
                                       const int64_t* npos, int64_t nwin, int p_in,
                                       int asize, int bsize, float* out, void* stream) {
    return launch_gathered<float>(av, bv, npos, nwin, p_in, asize, bsize, out, stream);
}

FET_EXPORT int css_dissim_tiles_f64(const int16_t* vals, int64_t N, const int64_t* lo,
                                    const int64_t* npos, int64_t nwin, int m,
                                    uint32_t* planes, double* out, void* stream) {
    return launch_dissim_tiles<double>(vals, N, lo, npos, nwin, m, planes, out, stream);
}

FET_EXPORT int css_dissim_gathered_tiles_f64(const int16_t* av, const int16_t* bv,
                                             const int64_t* npos, const int64_t* lo,
                                             int64_t nwin, int p_in, int asize, int bsize,
                                             uint32_t* planes, double* out, void* stream) {
    return launch_gathered_tiles<double>(av, bv, npos, lo, nwin, p_in, asize, bsize, planes,
                                       out, stream);
}

FET_EXPORT int css_dissim_tiles_f32(const int16_t* vals, int64_t N, const int64_t* lo,
                                    const int64_t* npos, int64_t nwin, int m,
                                    uint32_t* planes, float* out, void* stream) {
    return launch_dissim_tiles<float>(vals, N, lo, npos, nwin, m, planes, out, stream);
}

FET_EXPORT int css_dissim_gathered_tiles_f32(const int16_t* av, const int16_t* bv,
                                             const int64_t* npos, const int64_t* lo,
                                             int64_t nwin, int p_in, int asize, int bsize,
                                             uint32_t* planes, float* out, void* stream) {
    return launch_gathered_tiles<float>(av, bv, npos, lo, nwin, p_in, asize, bsize, planes,
                                       out, stream);
}
