// K1r: the LUT-rank form of K1 — the ascending sort of the per-table
// score LUT and every SNP's int32 rank into it.
//
// Replaces divergence_tpu/kernels/fet.py: fet_snp_ranks_joint (the
// stable jnp.argsort of the LUT, lut_sorted = lut[order],
// rank_of_entry[order] = arange(G), then each SNP's table entry).  Plain
// torch versions: divergence_tpu_torch/kernels/fet.py fet_lut_rank_plain
// and fet_snp_ranks_plain.  The LUT itself is K1's fet_lut_build
// (fet_snp.cu), which the wrapper launches first.
//
// Two kernels, behind two entry points:
//   fet_lut_rank   sorts the G (value, index) pairs of the LUT: by value
//                  with IEEE < (so -0.0 and +0.0 tie), ties by index.  That
//                  is JAX's stable argsort; a radix sort on the float bits
//                  would put -0.0 before +0.0.  Two stages:
//                    1. a counting rank: each thread takes one entry and
//                       counts the entries of its run that sort before it,
//                       the run staged through shared memory in tiles.  It
//                       is exact and stable by construction.  One run is
//                       the whole LUT when G <= the wrapper's bound (17,424
//                       entries at 11 + 10: 3e8 compares); above it, runs of
//                       `span` entries;
//                    2. merge passes that double the run width: an entry's
//                       place in the merged run is its place in its own run
//                       plus the number of entries of the other run that
//                       sort before it, found by binary search.  The order
//                       is total (no two entries share an index), so every
//                       pass is a permutation.
//                  The last stage writes lut_sorted[r] and
//                  rank_of_entry[index] = r.
//   fet_snp_ranks  (kernel snp_rank_lookup) one thread per SNP counts the
//                  homozygous codes of its int16 row (fet_table.cuh, K1's
//                  code) and writes its table's rank.
//
// What bounds it on H100: the LUT sort is operations (G^2 compares in
// one run; G * span + G log2(G) log2(G / span) with runs), a one-off per
// chromosome and device.  The per-SNP lookup is memory, as K1: 2(a+b)
// bytes of codes in and 4 bytes out per SNP; the rank table (70 KB at
// 11 + 10) stays in L1/L2.
#include "fet_table.cuh"

namespace {

using namespace fetk;

constexpr int kThreads = 128;
constexpr int kTile = 2048;   // entries staged in shared memory per step

// (va, ia) sorts before (vb, ib): JAX's stable argsort order.  The LUT
// holds no NaN (every table's p is positive).
template <typename T>
__device__ __forceinline__ bool sorts_before(T va, int ia, T vb, int ib) {
    return va < vb || (va == vb && ia < ib);
}

// Stage 1.  A block's entries lie in one run: span is G or a multiple of
// the block size.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_count_rank(const T* __restrict__ lut, int G, int span, bool last,
               T* __restrict__ keys_out, int* __restrict__ idx_out,
               T* __restrict__ lut_sorted, int* __restrict__ rank_of_entry) {
    __shared__ T tile[kTile];
    const int first = blockIdx.x * blockDim.x;
    const int i = first + threadIdx.x;
    const int base = (first / span) * span;
    const int end = min(base + span, G);
    const T v = i < G ? lut[i] : T(0);
    int rank = 0;
    for (int t0 = base; t0 < end; t0 += kTile) {
        const int nt = min(kTile, end - t0);
        __syncthreads();
        for (int k = threadIdx.x; k < nt; k += blockDim.x) tile[k] = lut[t0 + k];
        __syncthreads();
        if (i < G) {
            for (int k = 0; k < nt; ++k) rank += sorts_before(tile[k], t0 + k, v, i);
        }
    }
    if (i >= G) return;
    if (last) {
        lut_sorted[rank] = v;
        rank_of_entry[i] = rank;
    } else {
        keys_out[base + rank] = v;
        idx_out[base + rank] = i;
    }
}

// Stage 2: runs [base, base + width) and [base + width, base + 2 width)
// become one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_merge(const T* __restrict__ keys_in, const int* __restrict__ idx_in,
          int G, int width, bool last, T* __restrict__ keys_out,
          int* __restrict__ idx_out, T* __restrict__ lut_sorted,
          int* __restrict__ rank_of_entry) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= G) return;
    const T v = keys_in[p];
    const int id = idx_in[p];
    const int run = p / width;
    const int base = (run & ~1) * width;
    // the other run of the pair (empty for a last, unpaired run)
    int lo = base, hi = base + width;
    if ((run & 1) == 0) {
        lo = min(base + width, G);
        hi = min(base + 2 * width, G);
    }
    int a = lo, b = hi;   // the first entry of [lo, hi) not before (v, id)
    while (a < b) {
        const int mid = (a + b) >> 1;
        if (sorts_before(keys_in[mid], idx_in[mid], v, id)) {
            a = mid + 1;
        } else {
            b = mid;
        }
    }
    const int pos = base + (p - run * width) + (a - lo);
    if (last) {
        lut_sorted[pos] = v;
        rank_of_entry[id] = pos;
    } else {
        keys_out[pos] = v;
        idx_out[pos] = id;
    }
}

__global__ void snp_rank_lookup(const int16_t* __restrict__ vals, int64_t n,
                                int asize, int bsize,
                                const int* __restrict__ rank_of_entry,
                                int* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int16_t* row = vals + i * (asize + bsize);
    const Table t = count_table(row, asize, row + asize, bsize);
    out[i] = __ldg(rank_of_entry + table_index(t, asize, bsize));
}

// The scratch runs (ka, ia) and (kb, ib) hold G entries each; they may be
// null when span >= G (one run, no merge).
template <typename T>
int launch_lut_rank(const T* lut, int G, int span, T* ka, int* ia, T* kb,
                    int* ib, T* lut_sorted, int* rank_of_entry, void* stream) {
    if (G <= 0) return 0;
    if (span <= 0 || (span < G && (span % kThreads != 0 || ka == nullptr ||
                                   ia == nullptr || kb == nullptr || ib == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (G + kThreads - 1) / kThreads;
    lut_count_rank<T><<<blocks, kThreads, 0, s>>>(lut, G, span, span >= G, ka,
                                                 ia, lut_sorted, rank_of_entry);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    for (int64_t width = span; width < G; width *= 2) {
        lut_merge<T><<<blocks, kThreads, 0, s>>>(ka, ia, G, static_cast<int>(width),
                                                2 * width >= G, kb, ib,
                                                lut_sorted, rank_of_entry);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        T* kt = ka;
        ka = kb;
        kb = kt;
        int* it = ia;
        ia = ib;
        ib = it;
    }
    return 0;
}

}  // namespace

FET_EXPORT int fet_lut_rank_f64(const double* lut, int G, int span, double* ka,
                                int* ia, double* kb, int* ib,
                                double* lut_sorted, int* rank_of_entry,
                                void* stream) {
    return launch_lut_rank<double>(lut, G, span, ka, ia, kb, ib, lut_sorted,
                                   rank_of_entry, stream);
}

FET_EXPORT int fet_lut_rank_f32(const float* lut, int G, int span, float* ka,
                                int* ia, float* kb, int* ib, float* lut_sorted,
                                int* rank_of_entry, void* stream) {
    return launch_lut_rank<float>(lut, G, span, ka, ia, kb, ib, lut_sorted,
                                  rank_of_entry, stream);
}

FET_EXPORT int fet_snp_ranks(const int16_t* vals, int64_t n, int asize,
                             int bsize, const int* rank_of_entry, int* out,
                             void* stream) {
    if (n == 0) return 0;
    const int64_t blocks = (n + 255) / 256;
    snp_rank_lookup<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(vals, n, asize, bsize,
                                                           rank_of_entry, out);
    return static_cast<int>(cudaGetLastError());
}
