// Tile engine of the bf16 descriptor matchers (K1, K2, K4) for Hopper
// (sm_90a): scores on the bf16 tensor cores with f32 accumulation, fed by
// a ring of asynchronous copies, and the row top-2 / column argmax
// reduced on the accumulator registers.
//
// For pair b, row r of d1 (R x 128) and column c of d2 (C x 128), bf16:
//   S[r, c] = dot(d1[r], d2[c]) in f32 (tensor-core order of addition),
//   -inf where m1[r] or m2[c] is unset (MASKS);
//   best = max_c S, idx = first c attaining it, second = max over c != idx
//   (a tied duplicate counts as second); ROW = 0 keeps only best (second
//   -inf, idx 0);
//   COLS: col_key[c] = max over rows of (value bits << 32 | ~r), one
//   atomicMax per column per CTA, where the value bits are the
//   order-preserving bits of S + 2 (so -0 and +0 agree) with the low 4
//   cleared: the largest score wins and, on ties, the smallest row; an all
//   -inf column gives row 0. The + 2 rounds to 2^-22 and the 4 bits span
//   16 of those ulps, so a column can go to a row whose score is up to
//   4e-6 below the column's best, inside the borderline rule's 2 * EPS;
//   exact ties go to the first row wherever S > -2 (unit descriptors give
//   |S| <= 1). col_key must be zeroed before the launch.
// Rows >= R and columns >= C, and masked ones, are zero-filled in shared
// memory (so NaN in a masked slot never enters a product) and never enter
// a reduction (their scores are -inf). No float atomics: the results
// repeat bit for bit from run to run.
//
// Bound on an H100: 2*R*C*128 operations per pair against (R+C)*256 bytes
// of input, so the tensor cores (989 TFLOP/s bf16) bound it. Design:
//   - one CTA (2 warpgroups, 8 warps) per (pair, 128-row tile) walks every
//     128-column tile of its pair; two CTAs share an SM, so one's epilogue
//     runs while the other's products are on the tensor cores. The row
//     tile of d1 is copied to shared memory once and kept for the walk;
//   - the d2 column tiles (128 x 128 bf16, 32 KB) stream through a ring of
//     STAGES stages filled by cp.async (16-byte chunks, zero-filled where
//     the column is invalid), so tile t + 1 is in flight while tile t
//     multiplies. Both operands sit in wgmma's 128-byte-swizzled K-major
//     layout (two 64-wide k blocks of 128 rows x 128 bytes, 16-byte chunk
//     ^ row % 8);
//   - wgmma.m64n64k16 bf16 -> f32, both operands from shared memory
//     through descriptors, 8 per 64-column half of a tile and warpgroup.
//     The halves alternate between two accumulator sets: a warpgroup
//     issues one half's products, then reduces the half before it while
//     they run on the tensor cores;
//   - the masks enter after the products, as + 0 or -inf per column (on the
//     FMA pipe) and per row with the column keys' + 2; a masked row's own
//     results are set at the end. No instruction but a wgmma writes the
//     accumulators, which ptxas needs to keep the wgmmas asynchronous. The
//     column validity of tile t + 2 is read from global memory while tile t
//     multiplies, so no global load waits inside the walk;
//   - the epilogue never writes scores to shared memory. Each thread scans
//     its own accumulator columns in ascending order with a strict >,
//     keeping (best, second, idx) of its 2 rows across all column tiles;
//     a shuffle butterfly over the 4 lanes of a row merges them once at
//     the end. Column argmax: each score's key is the float S + 2 with its
//     low 4 bits replaced by 15 - the row within the warp, so one fmaxf
//     merges the thread's 2 rows; a reduce-scatter of the keys over the 8
//     lanes of a column (3 shuffle steps), the 8 warps through shared
//     memory two tiles later, then one 64-bit atomicMax per column per CTA.
// The epilogue's compares, maxima, selects and shuffles set the pace: the
// product alone runs at about half the tensor cores' peak (PERF.md, PR 3,
// has the split).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace matcher_tiles {

constexpr int DIM = 128;                 // descriptor length (bf16)
constexpr int BM = 128;                  // d1 rows per CTA: 16 per warp
constexpr int BN = 128;                  // d2 columns per ring stage
constexpr int STAGES = 2;                // two CTAs fit on an SM
constexpr int SLOTS = 4;                 // column validity of tiles t-1..t+2
constexpr int THREADS = 256;             // 2 warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int KBLOCK_BYTES = BN * 128;   // one 64-wide k block of a ring tile
constexpr int TILE_BYTES = 2 * KBLOCK_BYTES;  // BN rows x 128 bf16
constexpr int A_KBLOCK_BYTES = BM * 128;  // ... and of the row tile
constexpr int A_BYTES = 2 * A_KBLOCK_BYTES;
constexpr int COPY_ROWS = THREADS / 16;   // rows one pass of 16-byte copies covers
constexpr int SMEM_BYTES = 1024          // slack to align the tiles to 1 KB
                           + A_BYTES + STAGES * TILE_BYTES
                           + SLOTS * BN * 4           // column bias
                           + SLOTS * 4 * 4            // column validity bits
                           + 3 * WARPS * BN * 4;      // column keys, 3 buffers

// order-preserving bits of a float: a larger float gives a larger unsigned
__device__ __forceinline__ unsigned int order_bits(float f) {
    unsigned int u = __float_as_uint(f);
    return u ^ ((unsigned int)((int)u >> 31) | 0x80000000u);
}

// byte offset of 16-byte chunk `chunk` (0..15) of row `row` of a tile of
// ROWS rows: wgmma's 128-byte swizzle, K-major, 64-wide k blocks
template <int ROWS>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
    return (uint32_t)((chunk >> 3) * ROWS * 128 + row * 128 +
                      (((chunk & 7) ^ (row & 7)) << 4));
}

// shared-memory matrix descriptor of a 128-byte-swizzled K-major operand:
// start address, leading offset 1 (unused), 1024 bytes between 8-row
// groups, layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d (64 x 64 f32 over the warpgroup) = a (64 x 16) * b (16 x 64) + (d if
// ACC, else 0); a and b in shared memory through their descriptors. The
// first k step (ACC false) defines d, so no other instruction writes the
// accumulators (ptxas would serialize every wgmma if one did)
#define MATCHER_WGMMA_64x64x16                                          \
    "{\n"                                                                \
    ".reg .pred p;\n"                                                    \
    "setp.ne.b32 p, %34, 0;\n"                                           \
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "               \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
    "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                    \
    "}\n"
template <bool ACC>
__device__ __forceinline__ void wgmma_64x64x16(float* d, uint64_t da,
                                               uint64_t db) {
    if constexpr (ACC) {
        asm volatile(MATCHER_WGMMA_64x64x16
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
    } else {
        asm volatile(MATCHER_WGMMA_64x64x16
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(da), "l"(db), "r"(0));
    }
}
#undef MATCHER_WGMMA_64x64x16

// keep the compiler from moving accumulator accesses across a wgmma fence,
// commit or wait
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// one reduce-scatter step of column keys over lane bit `bit` (xor `m`): of
// the 2N keys the lane keeps half, maxed with its partner's
template <int N>
__device__ __forceinline__ void scatter_max(float* k, int bit, int m) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float send = bit ? k[i] : k[i + N];
        float keep = bit ? k[i + N] : k[i];
        k[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, m));
    }
}

// a column key: v's bits with the low 4 replaced by `row_bits`
__device__ __forceinline__ float pack_row(float v, unsigned int row_bits) {
    return __uint_as_float((__float_as_uint(v) & ~15u) | row_bits);
}

// a warp's float column key as the order-preserving 32-bit key of the
// flush (value bits, low 4 = 15 - row in the warp); no valid row (-inf or
// NaN) gives -inf on the warp's first row
__device__ __forceinline__ unsigned int col_bits(float k) {
    const unsigned int u = __float_as_uint(k);
    if ((u & 0x7f800000u) == 0x7f800000u) return order_bits(-__int_as_float(0x7f800000)) | 15u;
    return (order_bits(k) & ~15u) | (u & 15u);
}

template <int ROW, bool COLS, bool MASKS>
__global__ void __launch_bounds__(THREADS, 2)
match_tiles(const __nv_bfloat16* __restrict__ d1,
            const __nv_bfloat16* __restrict__ d2,
            const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
            int R, int C, float* __restrict__ best_out,
            float* __restrict__ second_out, int* __restrict__ idx_out,
            unsigned long long* __restrict__ col_key) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
    unsigned char* smem = smem_raw + pad;
    const uint32_t sA = raw + pad;                 // the row tile, 1 KB aligned
    const uint32_t sB = sA + A_BYTES;              // the ring
    float* colbias = reinterpret_cast<float*>(smem + A_BYTES + STAGES * TILE_BYTES);
    unsigned int* colbits = reinterpret_cast<unsigned int*>(colbias + SLOTS * BN);
    unsigned int* colk = colbits + SLOTS * 4;      // [3][WARPS][BN]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int row0 = blockIdx.x * BM;
    const long long rbase = (long long)b * R;
    const long long cbase = (long long)b * C;
    const __nv_bfloat16* A = d1 + rbase * DIM;
    const __nv_bfloat16* Bm = d2 + cbase * DIM;
    const float NEG = -__int_as_float(0x7f800000);   // -inf
    const int NT = (C + BN - 1) / BN;
    // this thread's copy chunks: chunk `ch` of rows q + COPY_ROWS * k
    const int q = tid >> 4, ch = tid & 15;

    // column validity of tile t (threads tid < BN, one column each): read
    // from global memory two tiles ahead, published to slot t % SLOTS as a
    // bias (0 / -inf) and as 4 words of bits
    auto col_ok = [&](int t) {
        const int c = t * BN + tid;
        return c < C && (!MASKS || m2[cbase + c] != 0);
    };
    auto put_valid = [&](int t, bool ok) {
        const int slot = t % SLOTS;
        colbias[slot * BN + tid] = ok ? 0.0f : NEG;
        const unsigned int bits = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) colbits[slot * 4 + warp] = bits;
    };
    // tile t of d2 into its ring stage; an invalid column is zero-filled
    auto issue = [&](int t) {
        const uint4 ok = *reinterpret_cast<const uint4*>(colbits + (t % SLOTS) * 4);
        const unsigned int words[4] = {ok.x, ok.y, ok.z, ok.w};
        const uint32_t dst = sB + (t % STAGES) * TILE_BYTES;
        const __nv_bfloat16* src = Bm + (long long)(t * BN + q) * DIM + ch * 8;
#pragma unroll
        for (int k = 0; k < BN / COPY_ROWS; ++k) {
            const int rk = COPY_ROWS * k;    // row q + rk: word rk / 32, bit q + rk % 32
            const bool on = (words[rk >> 5] >> (q + (rk & 31))) & 1u;
            cp_async16(dst + tile_off<BN>(q + rk, ch),
                       on ? src + rk * DIM : Bm, on ? 16 : 0);
        }
    };

    // the CTA's row tile of d1, copied once
#pragma unroll
    for (int k = 0; k < BM / COPY_ROWS; ++k) {
        const int r = row0 + q + COPY_ROWS * k;
        const bool on = r < R && (!MASKS || m1[rbase + r] != 0);
        cp_async16(sA + tile_off<BM>(q + COPY_ROWS * k, ch),
                   on ? A + (long long)r * DIM + ch * 8 : A, on ? 16 : 0);
    }
    bool ok_next = false;
    if (tid < BN) {
        put_valid(0, col_ok(0));
        put_valid(1, col_ok(1));
        ok_next = col_ok(2);
    }
    __syncthreads();
    issue(0);
    cp_async_commit();

    // this thread's rows: warp*16 + h*8 + lane/4; its columns of a half
    // tile: nb*8 + 2*(lane%4) + e, accumulator nb*4 + h*2 + e
    float rbias[2];
    int rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = row0 + warp * 16 + h * 8 + (lane >> 2);
        rows[h] = r;
        const bool ok = r < R && (!MASKS || m1[rbase + r] != 0);
        rbias[h] = ok ? 0.0f : NEG;
    }
    float best[2] = {NEG, NEG}, second[2] = {NEG, NEG};
    // argbest as (tile tb, index jl of the tile's accumulator columns:
    // half * 16 + nb * 2 + e)
    int jl[2] = {0, 0}, tb[2] = {-1, -1};
    // a column key's low 4 bits: 15 - the row within the warp
    const unsigned int lr0 = 15u - (lane >> 2), lr1 = 7u - (lane >> 2);
    // + 2 (+ -inf for a masked row) before a score becomes a column key
    const float shift[2] = {2.0f + rbias[0], 2.0f + rbias[1]};
    const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
    const uint32_t a_rows = sA + (warp >> 2) * 64 * 128;   // the warpgroup's 64 rows

    // the column keys of tile t (both halves written by iteration t + 1)
    // are published after the barrier of iteration t + 2: the 8 warps' keys
    // merged (warps hold ascending rows, so a strict > keeps the first row
    // on ties), then one 64-bit atomicMax of (value bits << 32 | ~row) per
    // column
    auto flush_cols = [&](int t) {
        if (tid < BN) {
            const int c = t * BN + tid;
            const unsigned int* k = colk + (t % 3) * WARPS * BN + tid;
            unsigned int bv = k[0] & ~15u;
            int br = 15 - (int)(k[0] & 15u);
#pragma unroll
            for (int w = 1; w < WARPS; ++w) {
                const unsigned int kw = k[w * BN];
                const bool take = (kw & ~15u) > bv;
                bv = take ? (kw & ~15u) : bv;
                br = take ? w * 16 + 15 - (int)(kw & 15u) : br;
            }
            if (c < C)
                atomicMax(col_key + cbase + c,
                          ((unsigned long long)bv << 32) |
                          (unsigned long long)(0xFFFFFFFFu - (unsigned int)(row0 + br)));
        }
    };

    // half `hf` of tile t: its 8 wgmmas, committed as one group
    auto mma_half = [&](float* acc, int t, int hf) {
        const uint32_t bh = sB + (t % STAGES) * TILE_BYTES + hf * 64 * 128;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_64x64x16<false>(acc, smem_desc(a_rows), smem_desc(bh));
#pragma unroll
        for (int ks = 1; ks < 8; ++ks) {
            const uint32_t kk = (ks & 3) * 32;
            wgmma_64x64x16<true>(acc, smem_desc(a_rows + (ks >> 2) * A_KBLOCK_BYTES + kk),
                                 smem_desc(bh + (ks >> 2) * KBLOCK_BYTES + kk));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
    };

    // the epilogue of half `hf` of tile t on its accumulators, columns in
    // ascending order. The column masks enter first (+ 0 or -inf), the row
    // masks with the column keys' shift and, for the row results, at the end
    auto reduce_half = [&](const float* acc_in, int t, int hf) {
        float acc[32];
        const float* cb = colbias + (t % SLOTS) * BN + hf * 64;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
            const float2 c2 = *reinterpret_cast<const float2*>(cb + nb * 8 + 2 * (lane & 3));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                acc[nb * 4 + h * 2] = acc_in[nb * 4 + h * 2] + c2.x;
                acc[nb * 4 + h * 2 + 1] = acc_in[nb * 4 + h * 2 + 1] + c2.y;
            }
        }
        if (ROW == 0) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
                best[(i >> 1) & 1] = fmaxf(best[(i >> 1) & 1], acc[i]);
        } else {
            const float before[2] = {best[0], best[1]};
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float s = acc[nb * 4 + h * 2 + e];
                        // a strict > keeps the first column; a tie goes to
                        // second: max(second, min(s, best))
                        jl[h] = s > best[h] ? hf * 16 + nb * 2 + e : jl[h];
                        second[h] = fmaxf(second[h], fminf(s, best[h]));
                        best[h] = fmaxf(best[h], s);
                    }
#pragma unroll
            for (int h = 0; h < 2; ++h) tb[h] = best[h] > before[h] ? t : tb[h];
        }
        if (COLS) {
            // each score as a float key: S + 2 (positive for |S| < 2, and -0
            // and +0 both give 2) with its low 4 bits replaced by 15 - the
            // row in the warp, so a float max picks the largest value and,
            // within 16 ulps, the first row; a masked row adds -inf (a
            // masked score's key is -inf or NaN, which fmaxf passes over)
            float ck[16];
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float k0 = pack_row(acc[nb * 4 + e] + shift[0], lr0);
                    const float k1 = pack_row(acc[nb * 4 + 2 + e] + shift[1], lr1);
                    ck[nb * 2 + e] = fmaxf(k0, k1);
                }
            // reduce-scatter over the 8 lanes of each column (lane bits 4,
            // 3, 2): the lane keeps the keys of nb = 4*b4 + 2*b3 + b2, e = 0, 1
            scatter_max<8>(ck, b4, 16);
            scatter_max<4>(ck, b3, 8);
            scatter_max<2>(ck, b2, 4);
            *reinterpret_cast<uint2*>(colk + (t % 3) * WARPS * BN + warp * BN + hf * 64 +
                                      (4 * b4 + 2 * b3 + b2) * 8 + 2 * (lane & 3)) =
                make_uint2(col_bits(ck[0]), col_bits(ck[1]));
        }
    };

    float acc0[32], acc1[32];

    for (int t = 0; t < NT; ++t) {
        // the second half of tile t - 1 is done: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc1);
        cp_async_wait_all();          // tile t has arrived
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();              // ... for every thread
        if (COLS && t > 1) flush_cols(t - 2);
        if (t + 1 < NT) issue(t + 1);
        cp_async_commit();
        if (tid < BN) {
            put_valid(t + 2, ok_next);
            ok_next = col_ok(t + 3);
        }

        mma_half(acc0, t, 0);
        if (t > 0) {
            reduce_half(acc1, t - 1, 1);
        }
        mma_half(acc1, t, 1);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc0);
        reduce_half(acc0, t, 0);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc1);
    reduce_half(acc1, NT - 1, 1);
    cp_async_wait_all();
    __syncthreads();
    if (COLS) {
        if (NT > 1) flush_cols(NT - 2);
        flush_cols(NT - 1);
    }

    // merge the row states over the 4 lanes of a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int hf = jl[h] >> 4, j = jl[h] & 15;
        int idx = tb[h] < 0 ? 0 : tb[h] * BN + hf * 64 + (j >> 1) * 8 + 2 * (lane & 3) + (j & 1);
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
            float ob = __shfl_xor_sync(0xffffffffu, best[h], m);
            if (ROW == 0) {
                best[h] = fmaxf(best[h], ob);
            } else {
                float os = __shfl_xor_sync(0xffffffffu, second[h], m);
                int oi = __shfl_xor_sync(0xffffffffu, idx, m);
                bool take = (ob > best[h]) | ((ob == best[h]) & (oi < idx));
                second[h] = take ? fmaxf(os, best[h]) : fmaxf(second[h], ob);
                best[h] = take ? ob : best[h];
                idx = take ? oi : idx;
            }
        }
        if (rbias[h] != 0.0f) {       // a masked row: its scores are all -inf
            best[h] = second[h] = NEG;
            idx = 0;
        }
        if ((lane & 3) == 0 && rows[h] < R) {
            best_out[rbase + rows[h]] = best[h];
            second_out[rbase + rows[h]] = second[h];
            idx_out[rbase + rows[h]] = idx;
        }
    }
}

// One launch of the engine over B pairs; returns the CUDA error code.
template <int ROW, bool COLS, bool MASKS>
inline int launch_match_tiles(const __nv_bfloat16* d1, const __nv_bfloat16* d2,
                              const uint8_t* m1, const uint8_t* m2, int B,
                              int R, int C, float* best, float* second,
                              int* idx, unsigned long long* col_key,
                              cudaStream_t s) {
    auto kernel = match_tiles<ROW, COLS, MASKS>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((R + BM - 1) / BM, B);
    kernel<<<grid, THREADS, SMEM_BYTES, s>>>(d1, d2, m1, m2, R, C, best,
                                             second, idx, col_key);
    return (int)cudaGetLastError();
}

}  // namespace matcher_tiles
