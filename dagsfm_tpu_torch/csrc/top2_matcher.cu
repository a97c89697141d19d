// Top-2 descriptor matchers for Hopper (sm_90a): per-row best, second
// best and argbest of a similarity matrix, and per-column argmax, with the
// product computed in the kernel's own body.
//
// Replaces three Pallas kernels:
//   K2 `_batch_matcher_kernel` (dagsfm_tpu/ops/pallas_matcher.py, entry
//      `pallas_top2_batch`): bf16 pairs with masks, forward top-2 and the
//      reverse argmax. Here: top2_tiles<3, __nv_bfloat16>.
//   K4 `_mk_kernel(mode)` (tools/matcher_mfu.py, entry `run_variant`): K2
//      with its stages switched on one at a time. Here: top2_tiles<MODE,
//      __nv_bfloat16>, MODE 0..3, so K2 is exactly mode 3:
//        0 product + row max (second = -inf, idx = 0, rev = 0)
//        1 + forward top-2 (rev = 0)
//        2 + reverse argmax
//        3 + masks (modes 0-2 ignore them)
//   K3 `_matcher_kernel` (pallas_matcher.py, entry `pallas_top2`): one f32
//      pair, no masks, forward top-2 only. Here: top2_tiles<1, float>.
//
// For pair b, row r of d1 (R x 128) and column c of d2 (C x 128):
//   S[r, c] = sum_k d1[r, k] * d2[c, k] in f32, summed in order k = 0..127
//   (-inf where m1[r] or m2[c] is unset, mode 3 only);
//   best = max_c S, idx = first c attaining it, second = max over c != idx
//   (an exact tie counts as second, as the reference's >= merge gives);
//   rev[c] = first r attaining max_r S[r, c] (an all -inf column gives 0).
// The sum runs in a fixed order with one rounding per step, so the plain
// PyTorch versions (ops/top2_matcher.py), which add the products in the
// same order, give the same bits: a bf16 x bf16 product is exact in f32,
// so fmaf equals a multiply then an add; for f32 inputs the kernel rounds
// the product and the sum separately (__fmul_rn / __fadd_rn).
//
// Bound on an H100: 2*R*C*128 operations per pair (268 MFLOP at 1024 x
// 1024) against ~0.5 MB of bf16 input, so compute-bound. Like K1 this
// first version multiplies with plain f32 FMAs (67 TFLOP/s peak), not the
// 989 TFLOP/s bf16 tensor cores, and K3 with separate f32 multiplies and
// adds; tensor cores are later work.
//
// Design: the tile loop of K1 (csrc/fused_matcher.cu). One CTA per (pair,
// 64-row tile) walks all 64-column tiles; each tile's scores go to shared
// memory; 64 threads keep their rows' running (best, second, argbest) in
// registers (a scan in column order with a strict > keeps the first index
// on ties) and, from mode 2, 64 threads reduce each column over the tile's
// rows and publish it with one 64-bit atomicMax of (order-preserving float
// bits << 32 | ~row): the largest score wins and, on ties, the smallest
// row. A second small kernel turns the column keys into rows. Ragged R
// and C pad the last tiles in the kernel: rows and columns beyond them
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

// 8 consecutive elements (16-byte aligned) as float
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool ok,
                                      float* out) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ok) v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void load8(const float* p, bool ok, float* out) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ok) {
        a = reinterpret_cast<const float4*>(p)[0];
        b = reinterpret_cast<const float4*>(p)[1];
    }
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// one step of the ordered sum: exact bf16 products allow the FMA; f32
// products round before the add, as the plain version's multiply and add
__device__ __forceinline__ float madd(float acc, float a, float b,
                                      const __nv_bfloat16*) {
    return fmaf(a, b, acc);
}
__device__ __forceinline__ float madd(float acc, float a, float b,
                                      const float*) {
    return __fadd_rn(acc, __fmul_rn(a, b));
}

template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS)
top2_tiles(const T* __restrict__ d1, const T* __restrict__ d2,
           const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
           int R, int C, float* __restrict__ best_out,
           float* __restrict__ second_out, int* __restrict__ idx_out,
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
    const long long rbase = (long long)b * R;
    const long long cbase = (long long)b * C;
    const float NEG = -__int_as_float(0x7f800000);   // -inf

    if (tid < BM) {
        int r = row0 + tid;
        rowok[tid] = (r < R) ? (MODE >= 3 ? m1[rbase + r] : 1) : 0;
    }
    float run_best = NEG, run_second = NEG;
    int run_idx = 0;

    // loader mapping: 256 threads x 8 elements = one 64 x 32 chunk
    const int ld_row = tid / 4, ld_k = (tid % 4) * 8;

    for (int col0 = 0; col0 < C; col0 += BN) {
        if (tid < BN) {
            int c = col0 + tid;
            colok[tid] = (c < C) ? (MODE >= 3 ? m2[cbase + c] : 1) : 0;
        }
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

        for (int k0 = 0; k0 < DIM; k0 += BK) {
            float v[8];
            int r = row0 + ld_row;
            load8(d1 + (rbase + r) * DIM + k0 + ld_k, r < R, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) As[ld_k + e][ld_row] = v[e];
            int c = col0 + ld_row;
            load8(d2 + (cbase + c) * DIM + k0 + ld_k, c < C, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) Bs[ld_k + e][ld_row] = v[e];
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
                        acc[i][j] = madd(acc[i][j], a[i], bb[j], d1);
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

        const int ncols = min(BN, C - col0);
        const int nrows = min(BM, R - row0);
        if (tid < BM) {
            if (tid < nrows) {
                for (int n = 0; n < ncols; ++n) {
                    float s = Ss[tid][n];
                    if (MODE == 0) {
                        if (s > run_best) run_best = s;
                    } else if (s > run_best) {
                        run_second = run_best;
                        run_best = s;
                        run_idx = col0 + n;
                    } else if (s > run_second) {
                        run_second = s;
                    }
                }
            }
        } else if (MODE >= 2 && tid < BM + BN) {
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
                atomicMax(col_key + cbase + col0 + n, key);
            }
        }
        __syncthreads();
    }
    if (tid < BM && row0 + tid < R) {
        best_out[rbase + row0 + tid] = run_best;
        second_out[rbase + row0 + tid] = run_second;
        idx_out[rbase + row0 + tid] = run_idx;
    }
}

__global__ void rows_from_keys(const unsigned long long* __restrict__ col_key,
                               long long n, int* __restrict__ rev) {
    long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    unsigned int low = (unsigned int)(col_key[g] & 0xFFFFFFFFull);
    rev[g] = (int)(0xFFFFFFFFu - low);
}

template <int MODE, typename T>
static int launch(const T* d1, const T* d2, const uint8_t* m1,
                  const uint8_t* m2, int B, int R, int C, float* best,
                  float* second, int* idx, int* rev,
                  unsigned long long* col_key, cudaStream_t s) {
    long long ncol = (long long)B * C;
    if (MODE >= 2) {
        cudaError_t e = cudaMemsetAsync(col_key, 0, ncol * 8, s);
        if (e != cudaSuccess) return (int)e;
    } else if (rev) {
        cudaError_t e = cudaMemsetAsync(rev, 0, ncol * 4, s);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((R + BM - 1) / BM, B);
    top2_tiles<MODE, T><<<grid, THREADS, 0, s>>>(d1, d2, m1, m2, R, C, best,
                                                 second, idx, col_key);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || MODE < 2) return (int)e;
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
        case 0: return launch<0>(a, b, ma, mb, B, K, K, bo, so, io, ro, ck, s);
        case 1: return launch<1>(a, b, ma, mb, B, K, K, bo, so, io, ro, ck, s);
        case 2: return launch<2>(a, b, ma, mb, B, K, K, bo, so, io, ro, ck, s);
        case 3: return launch<3>(a, b, ma, mb, B, K, K, bo, so, io, ro, ck, s);
    }
    return (int)cudaErrorInvalidValue;
}

// K3: d1 (K1, 128), d2 (K2, 128) f32; best, second (K1,) f32; idx (K1,)
// int32.
extern "C" int top2_f32_launch(const void* d1, const void* d2, int K1,
                               int K2, void* best, void* second, void* idx,
                               void* stream) {
    if (K1 <= 0 || K2 <= 0) return 0;
    return launch<1>((const float*)d1, (const float*)d2, nullptr, nullptr, 1,
                     K1, K2, (float*)best, (float*)second, (int*)idx,
                     (int*)nullptr, (unsigned long long*)nullptr,
                     (cudaStream_t)stream);
}
