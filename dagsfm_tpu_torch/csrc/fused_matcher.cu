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
// The tensor cores add the 128 products in their own order, so a score
// may differ from the plain version's by a few f32 ulps; the checks hold
// the kernel to the borderline rule (ops/matcher_kernel.borderline_rows).
//
// Bound on an H100: 2*K*K*128 operations per pair (268 MFLOP at K=1024)
// against ~0.5 MB of bf16 input, so the bf16 tensor cores (989 TFLOP/s)
// bound it.
//
// Design (the TPU kept the whole (K, TILE_J) score block in VMEM, so the
// column argmax for the mutual check fell out of one tile; a CTA here
// holds a 128-row tile and walks the columns):
//   kernel 1: the tile engine of matcher_tiles.cuh (tensor cores, a
//     cp.async ring, top-2 and column argmax on the accumulators) gives
//     best, second, argbest per row and, with the cross-check, one 64-bit
//     key per column (the column max's value bits << 32 | ~row);
//   kernel 2: per row, the ratio / distance tests and the mutual check
//     rev[argbest] == row against the finished column keys.

#include "matcher_tiles.cuh"

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

// d1, d2 (B, K, 128) bf16; m1, m2 (B, K) bool; best, second (B, K) f32,
// idx (B, K) int32 scratch; col_key (B, K) uint64, zeroed (cross_check);
// j_out (B, K) int32.
extern "C" int fused_match_j_launch(const void* d1, const void* d2,
                                    const void* m1, const void* m2,
                                    int B, int K, float max_ratio,
                                    float max_distance, int cross_check,
                                    void* best, void* second, void* idx,
                                    void* col_key, void* j_out,
                                    void* stream) {
    using namespace matcher_tiles;
    cudaStream_t s = (cudaStream_t)stream;
    if (B <= 0 || K <= 0) return 0;
    const __nv_bfloat16* a = (const __nv_bfloat16*)d1;
    const __nv_bfloat16* b = (const __nv_bfloat16*)d2;
    const uint8_t* ma = (const uint8_t*)m1;
    const uint8_t* mb = (const uint8_t*)m2;
    int e = cross_check
        ? launch_match_tiles<1, true, true>(
              a, b, ma, mb, B, K, K, (float*)best, (float*)second, (int*)idx,
              (unsigned long long*)col_key, s)
        : launch_match_tiles<1, false, true>(
              a, b, ma, mb, B, K, K, (float*)best, (float*)second, (int*)idx,
              (unsigned long long*)col_key, s);
    if (e != 0) return e;
    long long n = (long long)B * K;
    int threads = 256;
    int blocks = (int)((n + threads - 1) / threads);
    match_epilogue_kernel<<<blocks, threads, 0, s>>>(
        (const float*)best, (const float*)second, (const int*)idx,
        (const unsigned long long*)col_key, ma, B, K, max_ratio,
        max_distance, cross_check, (int*)j_out);
    return (int)cudaGetLastError();
}
