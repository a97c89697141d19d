// Nullspace of the exact minimal systems of two-view verification for
// Hopper (sm_90a): N = Q[:, r:] of the complete QR of Aᵀ, for A (S, r, 9)
// contiguous and r in {5, 7, 8} (the 5-point E, 7-point F and 4-point H
// systems), in float64 or float32. N is (S, 9, 9 - r) contiguous.
//
// Replaces no TPU kernel: the JAX package leaves this QR to XLA's
// `jnp.linalg.qr` (dagsfm_tpu/ops/epipolar.py, `_nullspace_k`). On the
// card, torch.linalg.qr(..., mode="complete") forms Q with one cuSOLVER
// `orgqr` per matrix, about a dozen launches for each 9 x r system, which
// left the card idle most of a verification job.
//
// Arithmetic: LAPACK's dgeqr2 + dorg2r, as JAX's QR on the CPU and
// cuSOLVER give it, so N equals their columns to rounding (not only their
// span), and the 5- and 7-point solution sets stay what they were. For
// column j of M = Aᵀ, with alpha = M[j, j] and x = M[j+1:, j] (dlarfg):
//   ‖x‖ = 0:  tau = 0 (H_j = I; a repeated or zero row stays finite);
//   else:     beta = -sign(alpha) hypot(alpha, ‖x‖) with sign(0) = +,
//             tau = (beta - alpha) / beta, v = (1, x / (alpha - beta));
// H_j = I - tau v vᵀ is applied to the columns right of j (dlarf:
// w = Cᵀv, C -= v (tau w)ᵀ). Column c >= r of Q is H_0 H_1 ... H_{r-1}
// e_c, the reflectors applied to e_c last first (dorg2r).
//
// Bound on an H100: about 1-2 kflop a system against 8 (9 r + 9 (9 - r))
// = 648 bytes in float64, so bytes bound it: 16,384 systems are about
// 10.6 MB, 3.2 µs at 3.35 TB/s, which a launch costs anyway.
//
// Design: one thread per system, its 9 x r matrix in registers (every
// loop unrolled at compile time, so each index is a register; ptxas -v
// shows the registers and that nothing spills). A block of 64 threads
// copies its systems' contiguous rows into shared memory with coalesced
// reads, each thread takes its own at an odd stride (no bank conflicts),
// and N leaves the same way. 16,384 systems are 256 blocks on 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 9;
constexpr int kThreads = 64;

__device__ __forceinline__ double hypot_(double a, double b) {
    return hypot(a, b);
}
__device__ __forceinline__ float hypot_(float a, float b) {
    return hypotf(a, b);
}
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double fma_(double a, double b, double c) {
    return fma(a, b, c);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
    return fmaf(a, b, c);
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
minimal_nullspace_kernel(const T* __restrict__ A, T* __restrict__ N,
                         long long S) {
    constexpr int K = kCols - R;            // nullspace columns
    constexpr int IN = R * kCols, OUT = kCols * K;
    constexpr int PIN = IN | 1, POUT = OUT | 1;   // odd strides
    constexpr int STRIDE = PIN > POUT ? PIN : POUT;
    __shared__ T buf[kThreads * STRIDE];

    const long long s0 = (long long)blockIdx.x * kThreads;
    const int n = (int)(S - s0 < kThreads ? S - s0 : kThreads);
    const T* src = A + s0 * IN;
    for (int e = threadIdx.x; e < n * IN; e += kThreads)
        buf[(e / IN) * STRIDE + e % IN] = src[e];
    __syncthreads();

    const bool mine = threadIdx.x < n;
    T m[kCols][R];                           // M = Aᵀ
    if (mine) {
        const T* a = buf + threadIdx.x * STRIDE;
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < kCols; ++i) m[i][j] = a[j * kCols + i];
    }
    __syncthreads();                         // buf is N's from here

    if (mine) {
        T tau[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {        // dgeqr2
            const T alpha = m[j][j];
            T ss = T(0);
#pragma unroll
            for (int i = j + 1; i < kCols; ++i) ss = fma_(m[i][j], m[i][j], ss);
            const T xnorm = sqrt_(ss);
            const T h = hypot_(alpha, xnorm);
            const T beta = alpha >= T(0) ? -h : h;
            const bool zero = xnorm == T(0);
            tau[j] = zero ? T(0) : (beta - alpha) / beta;
            const T scale = zero ? T(0) : T(1) / (alpha - beta);
#pragma unroll
            for (int i = j + 1; i < kCols; ++i) m[i][j] *= scale;
#pragma unroll
            for (int k = j + 1; k < R; ++k) {
                T w = m[j][k];
#pragma unroll
                for (int i = j + 1; i < kCols; ++i) w = fma_(m[i][j], m[i][k], w);
                w *= tau[j];
                m[j][k] -= w;
#pragma unroll
                for (int i = j + 1; i < kCols; ++i) m[i][k] = fma_(-m[i][j], w, m[i][k]);
            }
        }
        T* out = buf + threadIdx.x * STRIDE;
#pragma unroll
        for (int c = 0; c < K; ++c) {        // dorg2r, column R + c
            T q[kCols];
#pragma unroll
            for (int i = 0; i < kCols; ++i) q[i] = i == R + c ? T(1) : T(0);
#pragma unroll
            for (int j = R - 1; j >= 0; --j) {
                T w = q[j];
#pragma unroll
                for (int i = j + 1; i < kCols; ++i) w = fma_(m[i][j], q[i], w);
                w *= tau[j];
                q[j] -= w;
#pragma unroll
                for (int i = j + 1; i < kCols; ++i) q[i] = fma_(-m[i][j], w, q[i]);
            }
#pragma unroll
            for (int i = 0; i < kCols; ++i) out[i * K + c] = q[i];
        }
    }
    __syncthreads();

    T* dst = N + s0 * OUT;
    for (int e = threadIdx.x; e < n * OUT; e += kThreads)
        dst[e] = buf[(e / OUT) * STRIDE + e % OUT];
}

template <int R, typename T>
int launch(const void* A, void* N, long long S, cudaStream_t s) {
    const long long blocks = (S + kThreads - 1) / kThreads;
    minimal_nullspace_kernel<R, T><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)A, (T*)N, S);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_r(const void* A, void* N, long long S, int r, cudaStream_t s) {
    switch (r) {
        case 5: return launch<5, T>(A, N, S, s);
        case 7: return launch<7, T>(A, N, S, s);
        case 8: return launch<8, T>(A, N, S, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// A (S, r, 9) -> N (S, 9, 9 - r), both contiguous, float64 when is_double
// else float32; returns the CUDA error of the launch (0 = success).
extern "C" int minimal_nullspace_launch(const void* A, void* N, long long S,
                                        int r, int is_double, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (S <= 0) return 0;
    return is_double ? launch_r<double>(A, N, S, r, s)
                     : launch_r<float>(A, N, S, r, s);
}
