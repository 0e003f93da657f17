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
// Two entry points:
//   fet_lut_rank   a stable LSD radix sort of the G (key, index) pairs of
//                  the LUT.  The key is the value plus 0.0 (so -0.0 and
//                  +0.0 share one) mapped by Radix (fet_common.cuh) to an
//                  unsigned integer in IEEE < order; the LUT holds no NaN
//                  (every table's p is positive), so the stable sort is
//                  JAX's stable argsort: IEEE <, ties by index.  8-bit
//                  digits, least significant first, one pass each
//                  (mirrored by kernels/fet.py:lut_radix_rank): no digit
//                  of a FET LUT's keys is trivial, since +-0.0 at p = 1
//                  sits beside scores from ~1e-16 up.  The output carries
//                  each value's own bits (-0.0 stays -0.0): lut_sorted[r] =
//                  lut[index], rank_of_entry[index] = r.  One read of the
//                  LUT for every digit's histogram (lut_histogram: each
//                  pass's digit starts), then a onesweep pass a digit
//                  (lut_onesweep): tiles of 256 x kItems entries, each warp
//                  ranking its entries among its entries of the same digit
//                  (__match_any_sync; the lowest peer adds to the warp's
//                  count), each tile's digit offsets found by decoupled
//                  look-back (tile ids from an atomic ticket, so every tile
//                  it waits on is running), the tile put in digit order in
//                  shared memory and written to global memory in coalesced
//                  digit runs.  The entries carry the value's bits and
//                  index; the key is remade each pass.  The caller gives
//                  the scratch, fet_lut_rank_scratch's bytes.
//   fet_snp_ranks  (kernel snp_rank_lookup) one thread per SNP counts the
//                  homozygous codes of its int16 row (fet_table.cuh, K1's
//                  code) and writes its table's rank.
//
// What bounds it on H100: the sort is one call per chromosome and panel;
// memory, (key + 4) bytes in and out an entry a pass (12 bytes in
// float64), the first pass reading the LUT alone, and below a wave of
// tiles the passes' latency.  The per-SNP lookup is memory, as K1: 2(a+b)
// bytes of codes in and 4 bytes out per SNP; the rank table (70 KB at
// 11 + 10) stays in L1/L2.
#include <algorithm>

#include "fet_table.cuh"

namespace {

using namespace fetk;

constexpr int kBins = 256;                     // 8-bit digits
constexpr int kMaxDigits = 8;                  // float64 keys
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps >= kMaxDigits, "the histogram's last block scans a digit a warp");
constexpr unsigned kAggregate = 1u << 30;      // a tile's look-back word: its count
constexpr unsigned kInclusive = 2u << 30;      // ... or its digit's inclusive prefix
constexpr unsigned kCountMask = kAggregate - 1;
constexpr int kWindow = 16;                    // look-back words a thread reads at once
constexpr int kBatch = 8;                      // LUT entries a histogram thread loads at once

__host__ __device__ constexpr size_t align256(size_t bytes) {
    return (bytes + 255) & ~size_t(255);
}

template <typename T>
__device__ __forceinline__ typename Radix<T>::U lut_key(T v);
template <>
__device__ __forceinline__ uint32_t lut_key<float>(float v) {
    return Radix<float>::to(__fadd_rn(v, 0.0f));
}
template <>
__device__ __forceinline__ unsigned long long lut_key<double>(double v) {
    return Radix<double>::to(__dadd_rn(v, 0.0));
}

template <typename U>
__device__ __forceinline__ int digit_of(U key, int shift) {
    return static_cast<int>((key >> shift) & (kBins - 1));
}

__device__ __forceinline__ unsigned lanes_below() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// The scratch's head, zeroed before each call with the look-back words.
struct Head {
    uint32_t hist[kMaxDigits][kBins];    // every digit's histogram
    uint32_t start[kMaxDigits][kBins];   // pass p's digit starts
    uint32_t done;                       // histogram blocks finished
    uint32_t ticket[kMaxDigits];         // pass p's next tile
};

// Entries a thread of a pass ranks: 16 where the LUT makes two
// waves of 4,096-entry tiles on the card, else 4 (more tiles in flight).
int items_for(int G) {
    int sms = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return G >= 2 * sms * kThreads * 16 ? 16 : 4;
}

struct Layout {
    int items, tiles;
    size_t status, values, index, zero, total;    // byte offsets; zero = bytes zeroed
};

Layout layout(int G, int key_bytes) {
    Layout L;
    L.items = items_for(G);
    const int tile = kThreads * L.items;
    L.tiles = (G + tile - 1) / tile;
    L.status = align256(sizeof(Head));
    L.zero = L.status + static_cast<size_t>(kMaxDigits) * L.tiles * kBins * 4;
    L.values = align256(L.zero);
    L.index = L.values + 2 * align256(static_cast<size_t>(G) * key_bytes);
    L.total = L.index + 2 * align256(static_cast<size_t>(G) * 4);
    return L;
}

template <typename T>
size_t onesweep_smem(int items) {
    return static_cast<size_t>(kThreads) * items * (sizeof(T) + 4) +
           (kWarps + 2) * kBins * 4 + 64;
}

// Exclusive block scan of one int a thread (kThreads of them).  wsum:
// kWarps ints of shared memory.
__device__ int block_exclusive(int x, int* wsum) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = x;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    __syncthreads();
    return before + inc - x;
}

// Every digit's histogram in one read of the LUT; the last block to
// finish makes each pass's digit starts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_histogram(const T* __restrict__ lut, int G, Head* __restrict__ head) {
    using U = typename Radix<T>::U;
    constexpr int kDigits = sizeof(U);
    __shared__ uint32_t hist[kDigits * kBins];
    __shared__ bool last;
    const int tid = threadIdx.x;
    for (int i = tid; i < kDigits * kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    // each warp reads its own run of the LUT, 32 entries at a time, and
    // each lane counts, a digit, its entries of one bin in registers,
    // adding them when the bin changes: entries 32 apart mostly share
    // their high digits, so those take few atomics
    const int warps = gridDim.x * kWarps, gw = blockIdx.x * kWarps + (tid >> 5);
    const int per = (G + 32 * warps - 1) / (32 * warps) * 32;
    const int lo = min(gw * per, G) + (tid & 31), hi = min(gw * per + per, G);
    int run_bin[kDigits], run_count[kDigits];
#pragma unroll
    for (int d = 0; d < kDigits; ++d) run_bin[d] = run_count[d] = 0;
    for (int i0 = lo; i0 < hi; i0 += 32 * kBatch) {
        U key[kBatch];                                      // kBatch loads in flight
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            key[k] = i0 + 32 * k < hi ? lut_key(lut[i0 + 32 * k]) : U(0);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (i0 + 32 * k >= hi) break;
#pragma unroll
            for (int d = 0; d < kDigits; ++d) {
                const int bin = digit_of(key[k], 8 * d);
                if (bin != run_bin[d]) {
                    if (run_count[d]) {
                        atomicAdd(hist + d * kBins + run_bin[d], unsigned(run_count[d]));
                    }
                    run_bin[d] = bin;
                    run_count[d] = 0;
                }
                ++run_count[d];
            }
        }
    }
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
        if (run_count[d]) atomicAdd(hist + d * kBins + run_bin[d], unsigned(run_count[d]));
    }
    __syncthreads();
    for (int i = tid; i < kDigits * kBins; i += kThreads) {
        if (hist[i]) atomicAdd(&head->hist[0][0] + i, hist[i]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&head->done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int i = tid; i < kDigits * kBins; i += kThreads) hist[i] = __ldcg(&head->hist[0][0] + i);
    __syncthreads();
    // warp d scans digit d's counts: lane l takes 8 bins
    const int lane = tid & 31, warp = tid >> 5;
    if (warp < kDigits) {
        const uint32_t* h = hist + warp * kBins + 8 * lane;
        uint32_t sum = 0;
        for (int k = 0; k < 8; ++k) sum += h[k];
        uint32_t inc = sum;
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += y;
        }
        uint32_t run = inc - sum;
        for (int k = 0; k < 8; ++k) {
            head->start[warp][8 * lane + k] = run;
            run += h[k];
        }
    }
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
    return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned* p, unsigned v) {
    *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Pass p (digit p) of the sort over one tile (a block).  A tile's entries lie
// in warp-major runs: lane l of warp w holds, in its round r, entry
// w * 32 * kItems + 32 r + l of the tile, so (warp, round, lane) is the
// order of the input and ranking in that order keeps the sort stable.
template <typename T, int kItems>
__global__ void __launch_bounds__(kThreads)
lut_onesweep(const T* __restrict__ lut, int G, int p, Head* __restrict__ head,
             unsigned* __restrict__ status, int tiles, T* __restrict__ values,
             int* __restrict__ index, T* __restrict__ lut_sorted,
             int* __restrict__ rank_of_entry) {
    constexpr int kTile = kThreads * kItems;
    const bool final_pass = p == static_cast<int>(sizeof(T)) - 1;
    const int sh = 8 * p;
    extern __shared__ __align__(16) unsigned char smem[];
    T* tv = reinterpret_cast<T*>(smem);                               // [kTile]
    int* ti = reinterpret_cast<int*>(tv + kTile);                     // [kTile]
    int* wcnt = ti + kTile;                                           // [kWarps][kBins]
    int* tstart = wcnt + kWarps * kBins;                              // [kBins]
    int* gdst = tstart + kBins;                                       // [kBins]
    int* misc = gdst + kBins;                                         // ticket, wsum
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    if (tid == 0) misc[0] = static_cast<int>(atomicAdd(head->ticket + p, 1u));
    for (int i = tid; i < kWarps * kBins; i += kThreads) wcnt[i] = 0;
    __syncthreads();
    const int tile = misc[0];
    const int base = tile * kTile + warp * 32 * kItems + lane;
    const T* vin = p == 0 ? lut : values + static_cast<size_t>((p - 1) & 1) * G;
    const int* iin = index + static_cast<size_t>((p - 1) & 1) * G;
    T v[kItems];
    int id[kItems], rank[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
        const int e = base + 32 * r;
        v[r] = e < G ? vin[e] : T(0);
        id[r] = e < G ? (p == 0 ? e : iin[e]) : 0;
    }
    // rank each entry among its warp's entries of the same digit
    int* mine = wcnt + warp * kBins;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
        const int bin = base + 32 * r < G ? digit_of(lut_key(v[r]), sh) : kBins;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (bin < kBins && lane == leader) {
            at = mine[bin];
            mine[bin] = at + __popc(peers);
        }
        rank[r] = __shfl_sync(0xffffffffu, at, leader) + __popc(peers & lanes_below());
        __syncwarp();
    }
    __syncthreads();
    // thread t takes digit t: the tile's count, published at once, and
    // each warp's place in it
    int count = 0;
    for (int w = 0; w < kWarps; ++w) {
        const int x = wcnt[w * kBins + tid];
        wcnt[w * kBins + tid] = count;
        count += x;
    }
    const size_t col = static_cast<size_t>(p) * tiles * kBins + tid;    // digit t's words
    unsigned* word = status + col + static_cast<size_t>(tile) * kBins;
    store_volatile(word, (tile == 0 ? kInclusive : kAggregate) | static_cast<unsigned>(count));
    const int start = block_exclusive(count, misc + 1);
    tstart[tid] = start;
    __syncthreads();
    // the tile in digit order in shared memory
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
        if (base + 32 * r < G) {
            const int bin = digit_of(lut_key(v[r]), sh);
            const int at = tstart[bin] + wcnt[warp * kBins + bin] + rank[r];
            tv[at] = v[r];
            ti[at] = id[r];
        }
    }
    // decoupled look-back: the entries of digit t in the tiles before,
    // kWindow tiles' words read at a time
    int before = 0;
    if (tile > 0) {
        int j = tile - 1;                                   // the nearest tile not added
        bool done = false;
        while (!done) {
            unsigned w[kWindow];
#pragma unroll
            for (int k = 0; k < kWindow; ++k) {
                w[k] = j - k < 0 ? kInclusive
                                 : load_volatile(status + col + static_cast<size_t>(j - k) * kBins);
            }
            bool stop = false;
#pragma unroll
            for (int k = 0; k < kWindow; ++k) {
                if (!stop && !done) {
                    if ((w[k] & ~kCountMask) == 0) {
                        stop = true;                        // not published: read again
                    } else {
                        before += static_cast<int>(w[k] & kCountMask);
                        done = (w[k] & kInclusive) != 0;
                        --j;
                    }
                }
            }
        }
        store_volatile(word, kInclusive | static_cast<unsigned>(before + count));
    }
    gdst[tid] = static_cast<int>(head->start[p][tid]) + before - start;
    __syncthreads();
    // out in digit runs: entry q of the ordered tile goes to gdst[its digit] + q
    const int n = min(kTile, G - tile * kTile);
    T* vout = values + static_cast<size_t>(p & 1) * G;
    int* iout = index + static_cast<size_t>(p & 1) * G;
    for (int q = tid; q < n; q += kThreads) {
        const T x = tv[q];
        const int g = gdst[digit_of(lut_key(x), sh)] + q;
        if (final_pass) {
            lut_sorted[g] = x;
            rank_of_entry[ti[q]] = g;
        } else {
            vout[g] = x;
            iout[g] = ti[q];
        }
    }
}

template <typename T, int kItems>
int launch_passes(const T* lut, int G, unsigned char* scratch, const Layout& L,
                 T* lut_sorted, int* rank_of_entry, cudaStream_t s) {
    const size_t smem = onesweep_smem<T>(kItems);
    if (smem > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(lut_onesweep<T, kItems>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    Head* head = reinterpret_cast<Head*>(scratch);
    unsigned* status = reinterpret_cast<unsigned*>(scratch + L.status);
    T* values = reinterpret_cast<T*>(scratch + L.values);
    int* index = reinterpret_cast<int*>(scratch + L.index);
    for (int p = 0; p < static_cast<int>(sizeof(T)); ++p) {
        lut_onesweep<T, kItems><<<L.tiles, kThreads, smem, s>>>(
            lut, G, p, head, status, L.tiles, values, index, lut_sorted, rank_of_entry);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

// The sort with the bytes fet_lut_rank_scratch names.
template <typename T>
int launch_lut_rank(const T* lut, int G, void* scratch, T* lut_sorted, int* rank_of_entry,
                    void* stream) {
    if (G <= 0) return 0;
    if (G >= (1 << 24) || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned char* bytes = static_cast<unsigned char*>(scratch);
    const Layout L = layout(G, sizeof(T));
    cudaError_t e = cudaMemsetAsync(bytes, 0, L.zero, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const int blocks = std::min((G + 4 * kThreads - 1) / (4 * kThreads), 2 * sms);
    lut_histogram<T><<<blocks, kThreads, 0, s>>>(lut, G, reinterpret_cast<Head*>(bytes));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return L.items == 16 ? launch_passes<T, 16>(lut, G, bytes, L, lut_sorted, rank_of_entry, s)
                         : launch_passes<T, 4>(lut, G, bytes, L, lut_sorted, rank_of_entry, s);
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

}  // namespace

// The bytes of device scratch fet_lut_rank takes for G keys of
// key_bytes on the current device (its tile size follows the device's
// SMs).  -1 where the device cannot be asked, -2 for arguments it does
// not take.
FET_EXPORT int fet_lut_rank_scratch(int G, int key_bytes, int64_t* scratch_bytes) {
    if (G <= 0 || G >= (1 << 24) || (key_bytes != 4 && key_bytes != 8)) return -2;
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
        return -1;
    }
    *scratch_bytes = static_cast<int64_t>(layout(G, key_bytes).total);
    return 0;
}

FET_EXPORT int fet_lut_rank_f64(const double* lut, int G, void* scratch, double* lut_sorted,
                                int* rank_of_entry, void* stream) {
    return launch_lut_rank<double>(lut, G, scratch, lut_sorted, rank_of_entry, stream);
}

FET_EXPORT int fet_lut_rank_f32(const float* lut, int G, void* scratch, float* lut_sorted,
                                int* rank_of_entry, void* stream) {
    return launch_lut_rank<float>(lut, G, scratch, lut_sorted, rank_of_entry, stream);
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
