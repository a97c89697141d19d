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
//      pair, no masks, forward top-2 only. Here: top2_f32_tiles.
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
//
// K3 (f32): the sum runs in order k = 0..127 with the product and the sum
// rounded separately (__fmul_rn / __fadd_rn), so the plain version
// (ops/top2_matcher.ordered_scores), which adds in the same order, gives
// the same bits. Bound on an H100: 2*R*C*128 operations against the f32
// FMA peak (67 TFLOP/s; TF32 tensor cores would change its results).
// Design: one CTA per 64-row tile walks all 64-column tiles; each tile's
// scores go to shared memory; 64 threads keep their rows' running (best,
// second, argbest) in registers (a scan in column order with a strict >
// keeps the first index on ties). Ragged R and C pad the last tiles in
// the kernel: rows and columns beyond them never enter a reduction.

#include "matcher_tiles.cuh"

// K3's tile sizes (the engine's are matcher_tiles::BM, ...)
#define K3_BM 64
#define K3_BN 64
#define K3_BK 32
#define K3_DIM 128
#define K3_THREADS 256

// 8 consecutive f32 elements (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, bool ok, float* out) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ok) {
        a = reinterpret_cast<const float4*>(p)[0];
        b = reinterpret_cast<const float4*>(p)[1];
    }
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__global__ void __launch_bounds__(K3_THREADS)
top2_f32_tiles(const float* __restrict__ d1, const float* __restrict__ d2,
               int R, int C, float* __restrict__ best_out,
               float* __restrict__ second_out, int* __restrict__ idx_out) {
    __shared__ float As[K3_BK][K3_BM];
    __shared__ float Bs[K3_BK][K3_BN];
    __shared__ float Ss[K3_BM][K3_BN + 1];
    __shared__ uint8_t rowok[K3_BM];
    __shared__ uint8_t colok[K3_BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.x * K3_BM;
    const float NEG = -__int_as_float(0x7f800000);   // -inf

    if (tid < K3_BM) rowok[tid] = row0 + tid < R;
    float run_best = NEG, run_second = NEG;
    int run_idx = 0;

    // loader mapping: 256 threads x 8 elements = one 64 x 32 chunk
    const int ld_row = tid / 4, ld_k = (tid % 4) * 8;

    for (int col0 = 0; col0 < C; col0 += K3_BN) {
        if (tid < K3_BN) colok[tid] = col0 + tid < C;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

        for (int k0 = 0; k0 < K3_DIM; k0 += K3_BK) {
            float v[8];
            int r = row0 + ld_row;
            load8(d1 + (long long)r * K3_DIM + k0 + ld_k, r < R, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) As[ld_k + e][ld_row] = v[e];
            int c = col0 + ld_row;
            load8(d2 + (long long)c * K3_DIM + k0 + ld_k, c < C, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) Bs[ld_k + e][ld_row] = v[e];
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < K3_BK; ++kk) {
                float a[4], bb[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx + 16 * j];
                // the product rounds before the add, as the plain
                // version's multiply and add
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], bb[j]));
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int m = ty + 16 * i, n = tx + 16 * j;
                Ss[m][n] = (rowok[m] && colok[n]) ? acc[i][j] : NEG;
            }
        __syncthreads();

        const int ncols = min(K3_BN, C - col0);
        const int nrows = min(K3_BM, R - row0);
        if (tid < nrows) {
            for (int n = 0; n < ncols; ++n) {
                float s = Ss[tid][n];
                if (s > run_best) {
                    run_second = run_best;
                    run_best = s;
                    run_idx = col0 + n;
                } else if (s > run_second) {
                    run_second = s;
                }
            }
        }
        __syncthreads();
    }
    if (tid < K3_BM && row0 + tid < R) {
        best_out[row0 + tid] = run_best;
        second_out[row0 + tid] = run_second;
        idx_out[row0 + tid] = run_idx;
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

// K3: d1 (K1, 128), d2 (K2, 128) f32; best, second (K1,) f32; idx (K1,)
// int32.
extern "C" int top2_f32_launch(const void* d1, const void* d2, int K1,
                               int K2, void* best, void* second, void* idx,
                               void* stream) {
    if (K1 <= 0 || K2 <= 0) return 0;
    top2_f32_tiles<<<(K1 + K3_BM - 1) / K3_BM, K3_THREADS, 0,
                     (cudaStream_t)stream>>>(
        (const float*)d1, (const float*)d2, K1, K2, (float*)best,
        (float*)second, (int*)idx);
    return (int)cudaGetLastError();
}
