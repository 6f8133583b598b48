// Ablation builds of the dense DP's first design, for measurement only: no
// path of the port runs this file, and it lies outside the port's package.
// `python3 chip_smoke.py --ablation` builds it (nvcc, the dense DP's flags)
// and times each mode at the main path's shapes beside
// svecalign_tpu_torch/csrc/dense_dp.cu, to say what a step of the first
// design spent its time on.
//
// The first design (svecalign_tpu_torch/csrc/dense_dp.cu as it stood until
// the lane-per-row redesign): one CTA per pair, a thread per cell of the anti-diagonal,
// three diagonals in shared memory, one __syncthreads() a step, each
// thread's cost of the next diagonal read from the (P, N, M) costs in
// device memory (strided: a row of the matrix apart), each bp byte and
// csum value stored to the node-layout planes (strided too). Modes:
//
//   0  the first design as it was (its planes equal the plain version's
//      inside each pair's rectangle);
//   1  no bp or csum store;
//   2  costs read from a pre-staged diagonal-major copy (P, N + M + 2,
//      min(N, M) + 1), so a step's cost reads are coalesced;
//   3  2 and 1 together: what is left is the barrier and the arithmetic;
//   4  the barrier only: the loop over anti-diagonals with nothing in it
//      but __syncthreads().
//
// Plain C interface, bound from Python with ctypes (chip_smoke.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <int MODE>
__global__ void dense_dp_ablation_kernel(
    const float* __restrict__ costs,    // (P, N, M), or modes 2-3: (P, N + M + 2, min(N, M) + 1)
    const float* __restrict__ pens,
    const int* __restrict__ x_sizes,
    const int* __restrict__ y_sizes,
    int N, int M, int row_stride,       // row_stride = min(N, M) + 2
    int8_t* __restrict__ bp,
    float* __restrict__ csum)
{
    constexpr bool STORE = MODE == 0 || MODE == 2;
    constexpr bool STAGED = MODE == 2 || MODE == 3;
    extern __shared__ float rows[];
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int n = min(max(x_sizes[p], 0), N);
    const int m = min(max(y_sizes[p], 0), M);
    const float pen = pens[p];
    const bool by_row = n <= m;
    const int L = by_row ? n : m;
    const int staged_w = (N < M ? N : M) + 1;
    const float* cost_p = costs + (STAGED ? (size_t)p * (N + M + 2) * staged_w : (size_t)p * N * M);
    const size_t plane = (size_t)(N + 1) * (M + 1);
    int8_t* bp_p = bp + (size_t)p * plane;
    float* csum_p = csum ? csum + (size_t)p * plane : nullptr;

    for (int i = tid; i < 3 * row_stride; i += blockDim.x) rows[i] = CUDART_INF_F;
    __syncthreads();
    const int n_diags = n + m + 1;
    if (MODE == 4) {
        for (int d = 0; d < n_diags; ++d) __syncthreads();
        return;
    }
    float* cur = rows;
    float* p1 = rows + row_stride;
    float* p2 = rows + 2 * row_stride;

    auto cost_at = [&](int d, int s) -> float {
        if (STAGED) return s < staged_w ? cost_p[(size_t)d * staged_w + s] : CUDART_INF_F;
        const int r = by_row ? s : d - s;
        const int c = d - r;
        if (s > L || r < 1 || c < 1 || r > n || c > m) return CUDART_INF_F;
        return cost_p[(size_t)(r - 1) * M + (c - 1)];
    };

    float next_cost = cost_at(0, tid);
    for (int d = 0; d < n_diags; ++d) {
        const float my_cost = next_cost;
        next_cost = cost_at(d + 1, tid);
        for (int s = tid; s <= L; s += blockDim.x) {
            const int r = by_row ? s : d - s;
            const int c = d - r;
            float val = CUDART_INF_F;
            if (r >= 0 && r <= n && c >= 0 && c <= m) {
                int b;
                if (r == 0) {
                    val = c == 0 ? 0.0f : __fmul_rn((float)c, pen);
                    b = c == 0 ? 4 : 1;
                } else if (c == 0) {
                    val = __fmul_rn((float)r, pen);
                    b = 2;
                } else {
                    const float cd = s == tid ? my_cost : cost_at(d, s);
                    const float cost0 = __fadd_rn(p2[s], cd);
                    const float cost1 = __fadd_rn(p1[by_row ? s + 1 : s], pen);
                    const float cost2 = __fadd_rn(p1[by_row ? s : s + 1], pen);
                    const bool left = cost1 < cost0;
                    val = left ? cost1 : cost0;
                    b = left ? 1 : 0;
                    if (cost2 < val) {
                        val = cost2;
                        b = 2;
                    }
                }
                if (STORE) {
                    const size_t k = (size_t)r * (M + 1) + c;
                    bp_p[k] = (int8_t)b;
                    if (csum_p) csum_p[k] = val;
                }
            }
            cur[s + 1] = val;
        }
        __syncthreads();
        float* t = p2;
        p2 = p1;
        p1 = cur;
        cur = t;
    }
}

template <int MODE>
int launch(const float* costs, const float* pens, const int* x_sizes, const int* y_sizes,
           int P, int N, int M, int8_t* bp, float* csum, int threads, cudaStream_t stream) {
    const size_t smem = 3 * (size_t)((N < M ? N : M) + 2) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        dense_dp_ablation_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dense_dp_ablation_kernel<MODE><<<P, threads, smem, stream>>>(
        costs, pens, x_sizes, y_sizes, N, M, (N < M ? N : M) + 2, bp, csum);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch mode `mode` (0-4, above) on `stream` with `threads` threads a CTA
// (the first design's: one per cell of the longest anti-diagonal, in whole
// warps, at most 1024). Returns the CUDA error code (0 on success).
int dense_dp_ablation_launch(int mode, const float* costs, const float* pens,
                             const int* x_sizes, const int* y_sizes, int P, int N, int M,
                             int8_t* bp, float* csum, int threads, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (mode) {
        case 0: return launch<0>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, threads, st);
        case 1: return launch<1>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, threads, st);
        case 2: return launch<2>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, threads, st);
        case 3: return launch<3>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, threads, st);
        case 4: return launch<4>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, threads, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
