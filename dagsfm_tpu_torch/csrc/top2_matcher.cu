// Top-2 descriptor matchers for Hopper (sm_90a): per-row best, second
// best and argbest of a similarity matrix, and per-column argmax, with the
// product computed in the kernel's own body.
//
// Replaces three Pallas kernels:
//   K2 `_batch_matcher_kernel` (dagsfm_tpu/ops/pallas_matcher.py, entry
//      `pallas_top2_batch`): bf16 pairs with masks, forward top-2 and the
//      reverse argmax. Here: the tile engine of matcher_tiles.cuh in mode 3.
//   K4 `_mk_kernel(mode)` (tools/matcher_mfu.py, entry `run_variant`): K2
//      with its stages switched on one at a time, MODE 0..3 of the same
//      engine, so K2 is exactly mode 3:
//        0 product + row max (second = -inf, idx = 0, rev = 0)
//        1 + forward top-2 (rev = 0)
//        2 + reverse argmax
//        3 + masks (modes 0-2 ignore them)
//   K3 `_matcher_kernel` (pallas_matcher.py, entry `pallas_top2`): one f32
//      pair, no masks, forward top-2 only. Here: top2_f32_tiles and
//      top2_f32_fold.
//
// For pair b, row r of d1 (R x 128) and column c of d2 (C x 128):
//   S[r, c] = sum_k d1[r, k] * d2[c, k] in f32 (-inf where m1[r] or m2[c]
//   is unset, mode 3 only);
//   best = max_c S, idx = first c attaining it, second = max over c != idx
//   (an exact tie counts as second, as the reference's >= merge gives);
//   rev[c] = first r attaining max_r S[r, c] (an all -inf column gives 0).
//
// K2 / K4 (bf16): the bf16 tensor cores add the products in their own
// order, so scores may differ from the plain version's by a few f32 ulps
// and the checks hold them to the borderline rule
// (ops/top2_matcher.borderline). Bound and design: matcher_tiles.cuh.

#include "matcher_tiles.cuh"

// K3 (f32): each score is one ordered chain of fused multiply-adds in one
// thread, acc = fmaf(d1[r, k], d2[c, k], acc) for k = 0..127 from acc = 0,
// one rounding per step; no split of k, no tree sum. The plain version
// (ops/top2_matcher.ordered_fma_scores, an exact emulation of fmaf) gives
// the same bits however the (row, column) plane is tiled. Bound on an
// H100: R*C*128 FMAs (2*R*C*128 operations) against the f32 FMA peak (67
// TFLOP/s: 128 lanes per SM, one FMA each per clock); the inputs, (R + C)
// * 512 bytes, take far less time (TF32 tensor cores would change the
// results). Design:
//   - a 2-D grid, one CTA per (64-row tile of d1, 128-column tile of d2):
//     1024 x 1024 gives 128 CTAs, 3,712 x 3,712 gives 1,682; three CTAs
//     fit on an SM (168 registers a thread, 55 KB of shared memory);
//   - both tiles stream through a 2-stage ring of 32-deep k slices, 16-byte
//     cp.async copies into rows padded to a stride of 144 bytes, so slice
//     s + 1 is in flight while slice s computes and the 16-byte reads of 8
//     neighbouring rows hit distinct banks;
//   - 128 threads, each an 8 x 8 register tile (rows ty + 8i, columns
//     tx + 16j): per 4 k, 8 float4 reads of d2, 8 of d1 and 256 FMAs. At
//     the FMA peak these reads would need all of the 128 bytes a clock
//     that shared memory returns to an SM; the product alone runs at about
//     half the peak (PERF.md has the split and what was tried);
//   - the epilogue: every thread scans its 8 columns of each row in
//     ascending order with a strict > (a tie goes to second), then a
//     reduce-scatter over the 16 lanes of the row (24 shuffles a thread,
//     not 96 for a full butterfly per row) leaves each row's top-2 over
//     the tile in one pair of lanes, which writes it to scratch;
//   - a second kernel folds the column tiles' partial top-2s, one warp per
//     row, its lanes over the tiles, then a shuffle tree. The merge (the
//     larger best wins, the smaller column on a tie; second = max of the
//     losing best and the winner's second) ranks by a total order and
//     takes maxima, so any order of merging gives the bits of a fold in
//     column order. It is launched as a programmatic dependent of the
//     first, so its launch overlaps the first's run and it waits
//     (griddepcontrol.wait) only for its results. No atomics: the results
//     repeat bit for bit.
// K1 and K2 must be multiples of 128 (the reference's shape rule; the
// wrapper checks), so every tile is full. K3_SPLIT, unset in the library
// the port loads, builds the stages one at a time for tools/k3_split.py:
// 1 the product and a max per thread, 2 + the tiles' top-2 (no fold).

namespace k3 {
constexpr int DIM = 128;
constexpr int TM = 8, TN = 8;            // register tile of a thread
constexpr int TY = 8, TX = 16;           // threads of a CTA along rows, columns
constexpr int BM = TY * TM;              // d1 rows per CTA
constexpr int BN = TX * TN;              // d2 columns per CTA
constexpr int THREADS = TX * TY;
constexpr int BK = 32;                   // k per ring stage
constexpr int STAGES = 2;
constexpr int KSTEPS = DIM / BK;
constexpr int LD = BK + 4;               // padded row stride, in floats
constexpr int A_FLOATS = BM * LD;        // one stage of the row tile
constexpr int STAGE_FLOATS = (BM + BN) * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
static_assert(TX <= 32 && 32 % TX == 0 && TX % TM == 0 && (TM & (TM - 1)) == 0,
              "a row group is TX lanes of one warp, TM rows a power of 2");
}  // namespace k3

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// (b, s, i) <- the top-2 of the union of (b, s, i) and (b2, s2, i2), two
// partial top-2s over disjoint columns: the larger best wins, the smaller
// column on a tie, and second = max(the losing best, the winner's second)
__device__ __forceinline__ void top2_merge(float& b, float& s, int& i,
                                           float b2, float s2, int i2) {
    const bool other = b2 > b || (b2 == b && i2 < i);
    const float lose = other ? b : b2;
    s = fmaxf(other ? s2 : s, lose);
    b = other ? b2 : b;
    i = other ? i2 : i;
}

// acc += a.x * b.x, then a.y * b.y, a.z * b.z, a.w * b.w: four steps of
// the ordered chain, one rounding each
__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
    acc = __fmaf_rn(a.x, b.x, acc);
    acc = __fmaf_rn(a.y, b.y, acc);
    acc = __fmaf_rn(a.z, b.z, acc);
    acc = __fmaf_rn(a.w, b.w, acc);
}

// Reduce-scatter of R rows' top-2s (b, s, i)[0..R) over the lanes that
// differ in bits M, M/2, .., 1 of tx: each step with R > 1 keeps half of
// the rows (the upper half where bit M is set), merges them with the
// partner lane's copies and adds the half's offset to `row`; once one row
// is left, the remaining steps merge it whole. Three shuffles per row
// and step: 3 * (R - 1) + 3 * log2(M * 2 / R) in all.
template <int M, int R>
__device__ __forceinline__ void scatter_top2(float* b, float* s, int* i,
                                             int tx, int& row) {
    if constexpr (M >= 1) {
        const bool up = tx & M;
        if constexpr (R > 1) {
            constexpr int H = R / 2;
#pragma unroll
            for (int r = 0; r < H; ++r) {
                const float ob = __shfl_xor_sync(0xffffffffu,
                                                 up ? b[r] : b[r + H], M);
                const float os = __shfl_xor_sync(0xffffffffu,
                                                 up ? s[r] : s[r + H], M);
                const int oi = __shfl_xor_sync(0xffffffffu,
                                               up ? i[r] : i[r + H], M);
                if (up) {
                    b[r] = b[r + H];
                    s[r] = s[r + H];
                    i[r] = i[r + H];
                }
                top2_merge(b[r], s[r], i[r], ob, os, oi);
            }
            if (up) row += H;
            scatter_top2<M / 2, H>(b, s, i, tx, row);
        } else {
            top2_merge(b[0], s[0], i[0],
                       __shfl_xor_sync(0xffffffffu, b[0], M),
                       __shfl_xor_sync(0xffffffffu, s[0], M),
                       __shfl_xor_sync(0xffffffffu, i[0], M));
            scatter_top2<M / 2, 1>(b, s, i, tx, row);
        }
    }
}

// The tile's top-2 of each row: every thread's scan of its columns
// col0 + TX * j (ascending) for each of its rows, then a reduce-scatter
// over the TX lanes of the row group. Returns in (b, s, i) the top-2 of
// the thread's row tx / (TX / TM).
__device__ __forceinline__ void reduce_tile(const float (&acc)[k3::TM][k3::TN],
                                            int col0, int tx, float& b,
                                            float& s, int& i) {
    const float NEG = -__int_as_float(0x7f800000);   // -inf
    float tb[k3::TM], ts[k3::TM];
    int ti[k3::TM];
#pragma unroll
    for (int r = 0; r < k3::TM; ++r) {
        tb[r] = acc[r][0];
        ts[r] = NEG;
        ti[r] = col0;
#pragma unroll
        for (int j = 1; j < k3::TN; ++j) {
            const float v = acc[r][j];
            if (v > tb[r]) {
                ts[r] = tb[r];
                tb[r] = v;
                ti[r] = col0 + k3::TX * j;
            } else {
                ts[r] = fmaxf(ts[r], v);
            }
        }
    }
    int row = 0;
    scatter_top2<k3::TX / 2, k3::TM>(tb, ts, ti, tx, row);
    b = tb[0];
    s = ts[0];
    i = ti[0];
}

__global__ void __launch_bounds__(k3::THREADS, 3)
top2_f32_tiles(const float* __restrict__ d1, const float* __restrict__ d2,
               int K1, float* __restrict__ best, float* __restrict__ second,
               int* __restrict__ idx) {
    using namespace k3;
    // the fold may launch now; it waits for this grid's results
    asm volatile("griddepcontrol.launch_dependents;");
    extern __shared__ __align__(16) float smem[];
    const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

    // k slice s of the row tile and of the column tile into stage s % STAGES
    auto load_slice = [&](int s) {
        const uint32_t dst = s0 + (s % STAGES) * STAGE_FLOATS * 4;
        for (int c = tid; c < (BM + BN) * BK / 4; c += THREADS) {
            const int r = c / (BK / 4), q = c % (BK / 4);
            const float* src = r < BM ? d1 + (size_t)(row0 + r) * DIM
                                      : d2 + (size_t)(col0 + r - BM) * DIM;
            matcher_tiles::cp_async16(dst + (r * LD + q * 4) * 4,
                                      src + s * BK + q * 4, 16);
        }
        matcher_tiles::cp_async_commit();
    };
    load_slice(0);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll 1
    for (int s = 0; s < KSTEPS; ++s) {
        if (s + 1 < KSTEPS) {
            load_slice(s + 1);
            cp_async_wait_one();               // slice s has arrived
        } else {
            matcher_tiles::cp_async_wait_all();
        }
        __syncthreads();
        const float* a_row = smem + (s % STAGES) * STAGE_FLOATS + ty * LD;
        const float* b_col = smem + (s % STAGES) * STAGE_FLOATS + A_FLOATS +
                             tx * LD;
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            // 4 k of the thread's 8 columns held in registers, then row by
            // row; k, k + 1, k + 2, k + 3 in order on every accumulator
            float4 b[TN];
#pragma unroll
            for (int j = 0; j < TN; ++j)
                b[j] = *reinterpret_cast<const float4*>(b_col + j * TX * LD +
                                                        kk);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const float4 a = *reinterpret_cast<const float4*>(
                    a_row + i * TY * LD + kk);
#pragma unroll
                for (int j = 0; j < TN; ++j) fma4(acc[i][j], a, b[j]);
            }
        }
        __syncthreads();                       // stage s % STAGES is free
    }
    float b, s;
    int i;
#if K3_SPLIT == 1
    // analysis build (tools/k3_split.py): the product and one max a thread
    b = acc[0][0];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) b = fmaxf(b, acc[r][j]);
    s = b;
    i = col0 + tx;
#else
    reduce_tile(acc, col0 + tx, tx, b, s, i);
#endif
    if (tx % (TX / TM) == 0) {                 // one lane per row writes
        const size_t o = (size_t)(row0 + ty + TY * (tx / (TX / TM))) *
                             gridDim.y + blockIdx.y;
        best[o] = b;
        second[o] = s;
        idx[o] = i;
    }
}

// folds the column tiles' partial top-2s, (K1, ntiles): one warp per row
__global__ void top2_f32_fold(const float* __restrict__ part_b,
                              const float* __restrict__ part_s,
                              const int* __restrict__ part_i, int ntiles,
                              int K1, float* __restrict__ best,
                              float* __restrict__ second,
                              int* __restrict__ idx) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= K1) return;                       // the whole warp
    // the merge's identity: below every partial, column beyond every one
    float b = -__int_as_float(0x7f800000), s = b;
    int i = 0x7fffffff;
    for (int c = lane; c < ntiles; c += 32) {
        const size_t o = (size_t)r * ntiles + c;
        top2_merge(b, s, i, part_b[o], part_s[o], part_i[o]);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
        top2_merge(b, s, i, __shfl_xor_sync(0xffffffffu, b, m),
                   __shfl_xor_sync(0xffffffffu, s, m),
                   __shfl_xor_sync(0xffffffffu, i, m));
    if (lane == 0) {
        best[r] = b;
        second[r] = s;
        idx[r] = i;
    }
}

__global__ void rows_from_keys(const unsigned long long* __restrict__ col_key,
                               long long n, int* __restrict__ rev) {
    long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    unsigned int low = (unsigned int)(col_key[g] & 0xFFFFFFFFull);
    rev[g] = (int)(0xFFFFFFFFu - low);
}

template <int MODE>
static int launch_batch(const __nv_bfloat16* d1, const __nv_bfloat16* d2,
                        const uint8_t* m1, const uint8_t* m2, int B, int K,
                        float* best, float* second, int* idx, int* rev,
                        unsigned long long* col_key, cudaStream_t s) {
    long long ncol = (long long)B * K;
    cudaError_t e = MODE >= 2 ? cudaMemsetAsync(col_key, 0, ncol * 8, s)
                              : cudaMemsetAsync(rev, 0, ncol * 4, s);
    if (e != cudaSuccess) return (int)e;
    int err = matcher_tiles::launch_match_tiles<(MODE >= 1), (MODE >= 2),
                                                (MODE >= 3)>(
        d1, d2, m1, m2, B, K, K, best, second, idx, col_key, s);
    if (err != 0 || MODE < 2) return err;
    int threads = 256;
    int blocks = (int)((ncol + threads - 1) / threads);
    rows_from_keys<<<blocks, threads, 0, s>>>(col_key, ncol, rev);
    return (int)cudaGetLastError();
}

// K2 (mode 3) and K4 (modes 0-3): d1, d2 (B, K, 128) bf16; m1, m2 (B, K)
// bool; best, second (B, K) f32; idx, rev (B, K) int32; col_key (B, K)
// uint64 scratch (modes 2-3).
extern "C" int top2_batch_launch(const void* d1, const void* d2,
                                 const void* m1, const void* m2, int B,
                                 int K, int mode, void* best, void* second,
                                 void* idx, void* rev, void* col_key,
                                 void* stream) {
    if (B <= 0 || K <= 0) return 0;
    const __nv_bfloat16* a = (const __nv_bfloat16*)d1;
    const __nv_bfloat16* b = (const __nv_bfloat16*)d2;
    const uint8_t* ma = (const uint8_t*)m1;
    const uint8_t* mb = (const uint8_t*)m2;
    float* bo = (float*)best;
    float* so = (float*)second;
    int* io = (int*)idx;
    int* ro = (int*)rev;
    unsigned long long* ck = (unsigned long long*)col_key;
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
        case 0: return launch_batch<0>(a, b, ma, mb, B, K, bo, so, io, ro, ck, s);
        case 1: return launch_batch<1>(a, b, ma, mb, B, K, bo, so, io, ro, ck, s);
        case 2: return launch_batch<2>(a, b, ma, mb, B, K, bo, so, io, ro, ck, s);
        case 3: return launch_batch<3>(a, b, ma, mb, B, K, bo, so, io, ro, ck, s);
    }
    return (int)cudaErrorInvalidValue;
}

// K3: d1 (K1, 128), d2 (K2, 128) f32, K1 and K2 multiples of 128; out:
// best (K1,) f32, second (K1,) f32, idx (K1,) int32, one after the other;
// part: 3 * K1 * (K2 / 128) words of scratch for the column tiles'
// partial top-2s, (K1, K2 / 128) each (unused when K2 = 128).
extern "C" int top2_f32_launch(const void* d1, const void* d2, int K1,
                               int K2, void* out, void* part, void* stream) {
    if (K1 <= 0 || K2 <= 0) return 0;
    if (K1 % k3::BM || K2 % k3::BN) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int ntiles = K2 / k3::BN;
    float* best = (float*)out;
    float* second = best + K1;
    int* idx = (int*)(second + K1);
    float* pb = ntiles > 1 ? (float*)part : best;
    float* ps = ntiles > 1 ? pb + (size_t)ntiles * K1 : second;
    int* pi = ntiles > 1 ? (int*)(ps + (size_t)ntiles * K1) : idx;
    cudaError_t e = cudaFuncSetAttribute(
        top2_f32_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        k3::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    top2_f32_tiles<<<dim3(K1 / k3::BM, ntiles), k3::THREADS, k3::SMEM_BYTES,
                     st>>>((const float*)d1, (const float*)d2, K1, pb, ps,
                           pi);
    e = cudaGetLastError();
#ifdef K3_SPLIT
    return (int)e;                             // analysis builds: no fold
#endif
    if (e != cudaSuccess || ntiles == 1) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((K1 + 7) / 8);          // 8 rows, one per warp
    cfg.blockDim = dim3(256);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, top2_f32_fold, (const float*)pb,
                           (const float*)ps, (const int*)pi, ntiles, K1, best,
                           second, idx);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
