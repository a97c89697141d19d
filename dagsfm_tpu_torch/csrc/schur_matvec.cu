// Schur product S·x of bundle adjustment's iterative Schur PCG for Hopper
// (sm_90a), in float64 (or float32, as the solver's tensors are; the
// float32 rows are read in 8-byte pieces): S = U - W V⁻¹ Wᵀ over the
// camera-side unknowns,
// poses x_p (I, 6) and, with the intrinsics (G = 8), x_g (C, G), never
// formed. Per observation n of image i(n), camera c(n) = camidx[i(n)] and
// point p(n): Wc_n (6 x 3) and Wg_n (G x 3), both row-major, contiguous.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (`S_mv` of dagsfm_tpu/sfm/bundle_adjustment.py's two iterative
// solvers). On the card the port ran it as PyTorch ops: gathers of x per
// observation, a cuBLAS batched GEMV per 6 x 3 and G x 3 block, and
// `torch.segment_reduce` sums that check their lengths on the host;
// together about 12 ms a CG iteration at BAL Dubrovnik-356's 1.26 M
// observations.
//
// Bound on an H100: bytes. A product reads Wc and Wg once in each of its
// two passes, 336 bytes an observation with G = 8 (144 with G = 0), plus
// V⁻¹ (72 bytes a point) and 24 bytes of indices an observation; x, y and
// the per-image blocks stay in L2. At Dubrovnik's shape that is about
// 0.9 GB, 0.27 ms at 3.35 TB/s (the benchmark's count, which reads W
// once, gives 0.14 ms). The operations, 2 x 2 x 3 x (6 + G) flops an
// observation, are far below the float64 peak.
//
// Design. Every sum is taken in a fixed order, with no atomics, so two
// launches give the same bits:
//   A (point pass, `schur_point_launch`): t_p = Σ_{n∈obs(p)} Wc_nᵀ x_p[i]
//     free_i + Wg_nᵀ (x_g gfree)[c], and y_p = V⁻¹_p t_p (or t_p itself
//     for the back-substitution). A group of 8 threads (4 with G = 0) a
//     point walks its observations in the point-major order; thread q
//     reads one pair of 3-wide rows of Wc (q < 3) or Wg (q = 3..6), 48
//     contiguous bytes in three 16-byte loads, so a group reads an
//     observation's rows whole; the group's sums meet in a xor butterfly,
//     which leaves the same bits in every lane.
//   B (image pass, `schur_image_launch`): z_i = Σ_{n∈obs(i)} Wc_n y_p(n)
//     and zg_i = Σ Wg_n y_p(n) over the image-major order, cut into the
//     chunks of at most SEGMENT_CHUNK rows that the port's segment sums
//     use: one warp a chunk (four groups of 8 threads, or eight of 4,
//     taking its rows in turn), one partial a chunk; then a second launch
//     adds the partials of each image in chunk order.
//   D (camera pass, `schur_camera_launch`): after the caller's reduce of z
//     over the ranks, S x_p = U_pp x_p + U_pg x_g[c] - z and S x_g = U_gg
//     x_g + Σ_{i of c} (U_pgᵀ x_p - zg_i), pinned images and intrinsic
//     slots held (free, gfree), as the plain version computes them; a
//     thread a pose row, a warp a camera whose images it folds in lane
//     order and a xor butterfly.
// G is a template parameter: the launch chooses from whether Wg is given.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kWarp = 32;

// threads that share an observation: one per pair of 3-wide rows
template <int G>
struct Lanes {
    static constexpr int kPerObs = G ? 8 : 4;
    static constexpr int kUsed = 3 + G / 2;   // row pairs of Wc, then Wg
};

template <int L, typename T>
__device__ __forceinline__ T xor_sum(T v) {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// Thread q's pair of rows of an observation: its matrix, row stride and
// offset, and where its two entries of x (and of their mask) lie.
template <typename T>
struct RowPair {
    const T* W;
    int w_stride, w_off;     // entries a row of W, first of the pair
    const T* x;
    const T* mask;
    int x_stride, m_stride, m_step;
    int x_off;               // first entry of the pair in x's row
    bool camera;             // indexed by camera (Wg) or by image (Wc)
};

template <int G, typename T>
__device__ __forceinline__ RowPair<T> row_pair(int q, const T* Wc,
                                               const T* Wg, const T* xp,
                                               const T* free_, const T* xg,
                                               const T* gfree) {
    RowPair<T> r;
    const bool cam = G && q >= 3;
    const int s = cam ? q - 3 : q;
    r.W = cam ? Wg : Wc;
    r.w_stride = cam ? 3 * G : 18;
    r.w_off = 6 * s;
    r.x = cam ? xg : xp;
    r.mask = cam ? gfree : free_;
    r.x_stride = cam ? G : 6;
    r.m_stride = cam ? G : 1;
    r.m_step = cam ? 1 : 0;
    r.x_off = 2 * s;
    r.camera = cam;
    return r;
}

__device__ __forceinline__ void load6(const double* __restrict__ p,
                                      double (&m)[6]) {
    const double2* v = reinterpret_cast<const double2*>(p);
    const double2 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2);
    m[0] = a.x; m[1] = a.y; m[2] = b.x; m[3] = b.y; m[4] = c.x; m[5] = c.y;
}
__device__ __forceinline__ void load6(const float* __restrict__ p,
                                      float (&m)[6]) {
    const float2* v = reinterpret_cast<const float2*>(p);
    const float2 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2);
    m[0] = a.x; m[1] = a.y; m[2] = b.x; m[3] = b.y; m[4] = c.x; m[5] = c.y;
}

// A: rows (observation, image, camera, -) in point-major order, off (P + 1)
template <int G, typename T>
__global__ void __launch_bounds__(kBlock)
point_pass(const T* __restrict__ Wc, const T* __restrict__ Wg,
           const int4* __restrict__ rows, const int* __restrict__ off,
           const T* __restrict__ xp, const T* __restrict__ free_,
           const T* __restrict__ xg, const T* __restrict__ gfree,
           const T* __restrict__ Vinv, T* __restrict__ out, int P) {
    constexpr int L = Lanes<G>::kPerObs;
    const long long t = (long long)blockIdx.x * kBlock + threadIdx.x;
    const int p = (int)(t / L);
    const int q = threadIdx.x % L;
    const bool live = p < P;
    const RowPair<T> rp = row_pair<G>(q, Wc, Wg, xp, free_, xg, gfree);
    T t0 = 0, t1 = 0, t2 = 0;
    if (live && q < Lanes<G>::kUsed) {
        const int end = __ldg(off + p + 1);
#pragma unroll 4
        for (int r = __ldg(off + p); r < end; ++r) {
            const int4 e = __ldg(rows + r);
            const int k = rp.camera ? e.z : e.y;
            T m[6];
            load6(rp.W + (long long)e.x * rp.w_stride + rp.w_off, m);
            const T* xk = rp.x + (long long)k * rp.x_stride + rp.x_off;
            const T* mk = rp.mask + (long long)k * rp.m_stride +
                          rp.m_step * rp.x_off;
            const T v0 = __ldg(xk) * __ldg(mk);
            const T v1 = __ldg(xk + 1) * __ldg(mk + rp.m_step);
            t0 += m[0] * v0 + m[3] * v1;
            t1 += m[1] * v0 + m[4] * v1;
            t2 += m[2] * v0 + m[5] * v1;
        }
    }
    t0 = xor_sum<L>(t0);
    t1 = xor_sum<L>(t1);
    t2 = xor_sum<L>(t2);
    if (!live || q >= 3) return;
    T v = q == 0 ? t0 : (q == 1 ? t1 : t2);
    if (Vinv) {
        const T* row = Vinv + (long long)p * 9 + 3 * q;
        v = row[0] * t0 + row[1] * t1 + row[2] * t2;
    }
    out[(long long)p * 3 + q] = v;
}

// B: rows (observation, point) in image-major order, chunk k's rows
// [roff[k], roff[k + 1]); part (K, 6 + G)
template <int G, typename T>
__global__ void __launch_bounds__(kBlock)
chunk_pass(const T* __restrict__ Wc, const T* __restrict__ Wg,
           const int2* __restrict__ rows, const int* __restrict__ roff,
           const T* __restrict__ y, T* __restrict__ part, int K) {
    constexpr int L = Lanes<G>::kPerObs;
    constexpr int GROUPS = kWarp / L;
    constexpr int R = 6 + G;
    const int k = (int)(((long long)blockIdx.x * kBlock + threadIdx.x) / kWarp);
    const int lane = threadIdx.x % kWarp;
    const int q = lane % L, g = lane / L;
    const bool live = k < K;
    const RowPair<T> rp = row_pair<G, T>(q, Wc, Wg, nullptr, nullptr,
                                         nullptr, nullptr);
    T a = 0, b = 0;
    if (live && q < Lanes<G>::kUsed) {
        const int end = __ldg(roff + k + 1);
#pragma unroll 4
        for (int r = __ldg(roff + k) + g; r < end; r += GROUPS) {
            const int2 e = __ldg(rows + r);
            T m[6];
            load6(rp.W + (long long)e.x * rp.w_stride + rp.w_off, m);
            const T* yp = y + (long long)e.y * 3;
            const T y0 = __ldg(yp), y1 = __ldg(yp + 1), y2 = __ldg(yp + 2);
            a += m[0] * y0 + m[1] * y1 + m[2] * y2;
            b += m[3] * y0 + m[4] * y1 + m[5] * y2;
        }
    }
#pragma unroll
    for (int o = kWarp / 2; o >= L; o >>= 1) {
        a += __shfl_xor_sync(kFull, a, o);
        b += __shfl_xor_sync(kFull, b, o);
    }
    // rows 2q, 2q + 1 of the image's (6 + G)-vector: Wc's, then Wg's
    if (live && g == 0 && q < Lanes<G>::kUsed) {
        T* out = part + (long long)k * R + 2 * q;
        out[0] = a;
        out[1] = b;
    }
}

// B, second launch: image i's chunks [coff[i], coff[i + 1]) in order
template <typename T>
__global__ void __launch_bounds__(kBlock)
image_sum(const T* __restrict__ part, const int* __restrict__ coff,
          T* __restrict__ zc, T* __restrict__ zg, int I, int G) {
    const int R = 6 + G;
    const long long t = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (t >= (long long)I * R) return;
    const int i = (int)(t / R), c = (int)(t % R);
    T s = 0;
    for (int k = coff[i]; k < coff[i + 1]; ++k) s += part[(long long)k * R + c];
    if (c < 6) zc[(long long)i * 6 + c] = s;
    else zg[(long long)i * G + c - 6] = s;
}

// D: the first img_blocks blocks a thread per pose row, the rest a warp
// per camera
template <int G, typename T>
__global__ void __launch_bounds__(kBlock)
camera_pass(const T* __restrict__ Upp, const T* __restrict__ Upg,
            const T* __restrict__ Ugg, const T* __restrict__ xp,
            const T* __restrict__ free_, const T* __restrict__ xg,
            const T* __restrict__ gfree, const T* __restrict__ zc,
            const T* __restrict__ zg, const int* __restrict__ camidx,
            const int* __restrict__ cam_off,
            const int* __restrict__ cam_images, T* __restrict__ outp,
            T* __restrict__ outg, int I, int C, int img_blocks) {
    if ((int)blockIdx.x < img_blocks) {
        const long long t = (long long)blockIdx.x * kBlock + threadIdx.x;
        if (t >= (long long)I * 6) return;
        const int i = (int)(t / 6), k = (int)(t % 6);
        const T f = free_[i];
        const T* u = Upp + (long long)i * 36 + k * 6;
        const T* x = xp + (long long)i * 6;
        T s = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) s += u[j] * (x[j] * f);
        if (G) {
            const int c = camidx[i];
            const T* v = Upg + (long long)i * 6 * G + k * G;
#pragma unroll
            for (int h = 0; h < G; ++h)
                s += v[h] * (xg[(long long)c * G + h] * gfree[(long long)c * G + h]);
        }
        s -= zc[(long long)i * 6 + k];
        outp[(long long)i * 6 + k] = s * f + x[k] * (T(1) - f);
        return;
    }
    if (!G) return;
    constexpr int GG = G ? G : 1;
    const int c = (int)((((long long)blockIdx.x - img_blocks) * kBlock +
                         threadIdx.x) / kWarp);
    const int lane = threadIdx.x % kWarp;
    const bool live = c < C;
    T a[GG], b[GG];
#pragma unroll
    for (int h = 0; h < GG; ++h) a[h] = b[h] = 0;
    if (live) {
        for (int j = cam_off[c] + lane; j < cam_off[c + 1]; j += kWarp) {
            const int i = cam_images[j];
            const T f = free_[i];
            const T* v = Upg + (long long)i * 6 * GG;
#pragma unroll
            for (int k = 0; k < 6; ++k) {
                const T xk = xp[(long long)i * 6 + k] * f;
#pragma unroll
                for (int h = 0; h < GG; ++h) a[h] += v[k * GG + h] * xk;
            }
#pragma unroll
            for (int h = 0; h < GG; ++h) b[h] += zg[(long long)i * GG + h];
        }
    }
#pragma unroll
    for (int h = 0; h < GG; ++h) {
        a[h] = xor_sum<kWarp>(a[h]);
        b[h] = xor_sum<kWarp>(b[h]);
    }
    if (!live) return;
#pragma unroll
    for (int h = 0; h < GG; ++h) {
        if (lane != h) continue;
        const T* u = Ugg + (long long)c * GG * GG + h * GG;
        const T* x = xg + (long long)c * GG;
        const T* m = gfree + (long long)c * GG;
        T s = 0;
#pragma unroll
        for (int j = 0; j < GG; ++j) s += u[j] * (x[j] * m[j]);
        s = s + a[h] - b[h];
        outg[(long long)c * GG + h] = s * m[h] + x[h] * (T(1) - m[h]);
    }
}

unsigned blocks_for(long long threads) {
    return (unsigned)((threads + kBlock - 1) / kBlock);
}

template <int G, typename T>
int point_launch(const void* Wc, const void* Wg, const void* rows,
                 const void* off, const void* xp, const void* free_,
                 const void* xg, const void* gfree, const void* Vinv,
                 void* out, int P, cudaStream_t s) {
    point_pass<G, T><<<blocks_for((long long)P * Lanes<G>::kPerObs), kBlock,
                       0, s>>>(
        (const T*)Wc, (const T*)Wg, (const int4*)rows, (const int*)off,
        (const T*)xp, (const T*)free_, (const T*)xg, (const T*)gfree,
        (const T*)Vinv, (T*)out, P);
    return (int)cudaGetLastError();
}

template <int G, typename T>
int image_launch(const void* Wc, const void* Wg, const void* rows,
                 const void* roff, const void* coff, const void* y,
                 void* part, void* zc, void* zg, int K, int I,
                 cudaStream_t s) {
    if (K > 0) {
        chunk_pass<G, T><<<blocks_for((long long)K * kWarp), kBlock, 0, s>>>(
            (const T*)Wc, (const T*)Wg, (const int2*)rows, (const int*)roff,
            (const T*)y, (T*)part, K);
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    image_sum<T><<<blocks_for((long long)I * (6 + G)), kBlock, 0, s>>>(
        (const T*)part, (const int*)coff, (T*)zc, (T*)zg, I, G);
    return (int)cudaGetLastError();
}

template <int G, typename T>
int camera_launch(const void* Upp, const void* Upg, const void* Ugg,
                  const void* xp, const void* free_, const void* xg,
                  const void* gfree, const void* zc, const void* zg,
                  const void* camidx, const void* cam_off,
                  const void* cam_images, void* outp, void* outg, int I,
                  int C, cudaStream_t s) {
    const int img_blocks = (int)blocks_for((long long)I * 6);
    const unsigned nb = img_blocks + (G ? blocks_for((long long)C * kWarp) : 0);
    camera_pass<G, T><<<nb, kBlock, 0, s>>>(
        (const T*)Upp, (const T*)Upg, (const T*)Ugg, (const T*)xp,
        (const T*)free_, (const T*)xg, (const T*)gfree, (const T*)zc,
        (const T*)zg, (const int*)camidx, (const int*)cam_off,
        (const int*)cam_images, (T*)outp, (T*)outg, I, C, img_blocks);
    return (int)cudaGetLastError();
}

}  // namespace

// Each launch takes G = 0 (Wg and the intrinsics' blocks null) or 8, and
// float64 tensors when is_double, else float32; it returns the CUDA error
// of its launches (0 = success). The dispatch picks the template.
#define SCHUR_DISPATCH(fn, ...)                                           \
    (G == 8 ? (is_double ? fn<8, double>(__VA_ARGS__)                     \
                         : fn<8, float>(__VA_ARGS__))                     \
     : G == 0 ? (is_double ? fn<0, double>(__VA_ARGS__)                   \
                           : fn<0, float>(__VA_ARGS__))                   \
     : (int)cudaErrorInvalidValue)

// A: y (P, 3) = V⁻¹ t, or t itself when Vinv is null.
extern "C" int schur_point_launch(const void* Wc, const void* Wg,
                                  const void* rows, const void* off,
                                  const void* xp, const void* free_,
                                  const void* xg, const void* gfree,
                                  const void* Vinv, void* out, int P, int G,
                                  int is_double, void* stream) {
    if (P <= 0) return 0;
    return SCHUR_DISPATCH(point_launch, Wc, Wg, rows, off, xp, free_, xg,
                          gfree, Vinv, out, P, (cudaStream_t)stream);
}

// B: zc (I, 6) and zg (I, G) from y, through part (K, 6 + G); two launches.
extern "C" int schur_image_launch(const void* Wc, const void* Wg,
                                  const void* rows, const void* roff,
                                  const void* coff, const void* y, void* part,
                                  void* zc, void* zg, int K, int I, int G,
                                  int is_double, void* stream) {
    if (I <= 0) return 0;
    return SCHUR_DISPATCH(image_launch, Wc, Wg, rows, roff, coff, y, part,
                          zc, zg, K, I, (cudaStream_t)stream);
}

// D: S x_p (I, 6) and, with G = 8, S x_g (C, G).
extern "C" int schur_camera_launch(const void* Upp, const void* Upg,
                                   const void* Ugg, const void* xp,
                                   const void* free_, const void* xg,
                                   const void* gfree, const void* zc,
                                   const void* zg, const void* camidx,
                                   const void* cam_off,
                                   const void* cam_images, void* outp,
                                   void* outg, int I, int C, int G,
                                   int is_double, void* stream) {
    if (I <= 0) return 0;
    return SCHUR_DISPATCH(camera_launch, Upp, Upg, Ugg, xp, free_, xg, gfree,
                          zc, zg, camidx, cam_off, cam_images, outp, outg, I,
                          C, (cudaStream_t)stream);
}
