// Fused descriptor matcher for Hopper (sm_90a): bf16 descriptors, f32
// similarity, per-row top-2 + ratio/distance test + mutual cross-check.
//
// Replaces the Pallas kernel `_fused_matcher_kernel` in
// dagsfm_tpu/ops/pallas_matcher.py (entry `pallas_match_j_batch`).
//
// For each pair b and row r of d1 (K x 128) against d2 (K x 128):
//   S[r, c] = dot(bf16(d1[r]), bf16(d2[c])) in f32, -inf where m1[r] or
//   m2[c] is unset; best = max_c S, argbest = first c attaining it,
//   second = max over c != argbest (a tied duplicate counts as second);
//   mutual: the first row attaining the max of column argbest over all K
//   rows is r (an all -inf column gives row 0, as argmax does);
//   j[r] = argbest if sqrt(max(2-2best,0)) < ratio*sqrt(max(2-2second,1e-12))
//          and that distance < max_distance and m1[r] (and mutual), else -1.
//
// Bound on an H100: 2*K*K*128 FLOP per pair (268 MFLOP at K=1024) against
// ~0.5 MB of bf16 input, so it is compute-bound. This first version does
// the products with plain f32 FMAs (67 TFLOP/s peak, not the 989 TFLOP/s
// bf16 tensor-core rate) - right and simple first; mma/wgmma is later work.
//
// Design (the TPU kept the whole (K, TILE_J) score block in VMEM, so the
// column argmax for the mutual check fell out of one tile; a CTA here
// holds only a 64x64 tile):
//   kernel 1: one CTA per (pair, 64-row tile) walks all 64-column tiles.
//     Each tile's scores go to shared memory; 64 threads keep the running
//     (best, second, argbest) of their rows in registers (sequential scan
//     in column order gives the first index on ties), and 64 threads
//     reduce each column over the tile's rows and publish it with one
//     64-bit atomicMax of (order-preserving float bits << 32 | ~row), so
//     the largest value wins and, on ties, the smallest row.
//   kernel 2: per row, the ratio / distance tests and the mutual check
//     rev[argbest] == row against the finished column keys.
// Ragged K (e.g. 1000) pads the last tiles in-kernel: rows/columns >= K
// never enter a reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64
#define BN 64
#define BK 32
#define DIM 128
#define THREADS 256

__device__ __forceinline__ unsigned int ordered_bits(float f) {
    if (f == 0.0f) f = 0.0f;  // -0 and +0 compare equal: one key for both
    unsigned int u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS)
match_rows_kernel(const __nv_bfloat16* __restrict__ d1,
                  const __nv_bfloat16* __restrict__ d2,
                  const uint8_t* __restrict__ m1,
                  const uint8_t* __restrict__ m2,
                  int K, int cross_check,
                  float* __restrict__ best_out,
                  float* __restrict__ second_out,
                  int* __restrict__ idx_out,
                  unsigned long long* __restrict__ col_key) {
    __shared__ float As[BK][BM];
    __shared__ float Bs[BK][BN];
    __shared__ float Ss[BM][BN + 1];
    __shared__ uint8_t rowok[BM];
    __shared__ uint8_t colok[BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int b = blockIdx.y;
    const int row0 = blockIdx.x * BM;
    const long long base = (long long)b * K;
    const float NEG = -__int_as_float(0x7f800000);   // -inf

    if (tid < BM) {
        int r = row0 + tid;
        rowok[tid] = (r < K) ? m1[base + r] : 0;
    }
    float run_best = NEG, run_second = NEG;
    int run_idx = 0;

    // loader mapping: 256 threads x 8 bf16 = one 64 x 32 chunk
    const int ld_row = tid / 4, ld_k = (tid % 4) * 8;

    for (int col0 = 0; col0 < K; col0 += BN) {
        if (tid < BN) {
            int c = col0 + tid;
            colok[tid] = (c < K) ? m2[base + c] : 0;
        }
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

        for (int k0 = 0; k0 < DIM; k0 += BK) {
            {
                int r = row0 + ld_row;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (r < K)
                    v = *reinterpret_cast<const uint4*>(
                        d1 + (base + r) * DIM + k0 + ld_k);
                const __nv_bfloat16* h =
                    reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    As[ld_k + e][ld_row] = __bfloat162float(h[e]);
            }
            {
                int c = col0 + ld_row;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (c < K)
                    v = *reinterpret_cast<const uint4*>(
                        d2 + (base + c) * DIM + k0 + ld_k);
                const __nv_bfloat16* h =
                    reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    Bs[ld_k + e][ld_row] = __bfloat162float(h[e]);
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < BK; ++kk) {
                float a[4], bb[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
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

        const int ncols = min(BN, K - col0);
        const int nrows = min(BM, K - row0);
        if (tid < BM) {
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
        } else if (cross_check && tid < BM + BN) {
            int n = tid - BM;
            if (n < ncols) {
                float cb = NEG;
                int cr = 0;
                for (int m = 0; m < nrows; ++m) {
                    float s = Ss[m][n];
                    if (s > cb) { cb = s; cr = m; }
                }
                unsigned long long key =
                    ((unsigned long long)ordered_bits(cb) << 32) |
                    (unsigned long long)(0xFFFFFFFFu - (unsigned int)(row0 + cr));
                atomicMax(col_key + base + col0 + n, key);
            }
        }
        __syncthreads();
    }
    if (tid < BM && row0 + tid < K) {
        best_out[base + row0 + tid] = run_best;
        second_out[base + row0 + tid] = run_second;
        idx_out[base + row0 + tid] = run_idx;
    }
}

__global__ void match_epilogue_kernel(const float* __restrict__ best,
                                      const float* __restrict__ second,
                                      const int* __restrict__ idx,
                                      const unsigned long long* __restrict__ col_key,
                                      const uint8_t* __restrict__ m1,
                                      int B, int K, float max_ratio,
                                      float max_distance, int cross_check,
                                      int* __restrict__ j_out) {
    long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)B * K) return;
    int r = (int)(g % K);
    long long base = g - r;
    // __f*_rn: no FMA contraction, so the f32 arithmetic rounds exactly as
    // the plain version's separate multiply and subtract
    float db = sqrtf(fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, best[g])), 0.0f));
    float ds = sqrtf(fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, second[g])),
                           1e-12f));
    int bi = idx[g];
    bool ok = (db < __fmul_rn(max_ratio, ds)) && (db < max_distance) &&
              (m1[g] != 0);
    if (cross_check) {
        unsigned int low = (unsigned int)(col_key[base + bi] & 0xFFFFFFFFull);
        ok = ok && ((0xFFFFFFFFu - low) == (unsigned int)r);
    }
    j_out[g] = ok ? bi : -1;
}

extern "C" int fused_match_j_launch(const void* d1, const void* d2,
                                    const void* m1, const void* m2,
                                    int B, int K, float max_ratio,
                                    float max_distance, int cross_check,
                                    void* best, void* second, void* idx,
                                    void* col_key, void* j_out,
                                    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (B <= 0 || K <= 0) return 0;
    dim3 grid((K + BM - 1) / BM, B);
    match_rows_kernel<<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)d1, (const __nv_bfloat16*)d2,
        (const uint8_t*)m1, (const uint8_t*)m2, K, cross_check,
        (float*)best, (float*)second, (int*)idx,
        (unsigned long long*)col_key);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    long long n = (long long)B * K;
    int threads = 256;
    int blocks = (int)((n + threads - 1) / threads);
    match_epilogue_kernel<<<blocks, threads, 0, s>>>(
        (const float*)best, (const float*)second, (const int*)idx,
        (const unsigned long long*)col_key, (const uint8_t*)m1, B, K,
        max_ratio, max_distance, cross_check, (int*)j_out);
    return (int)cudaGetLastError();
}
