// Dense 3-move wavefront DP for P document pairs in one launch, for sm_90a.
//
// The fused form of the JAX package's svecalign_tpu/ops/dp.py::dense_dp_scan
// (a lax.scan over anti-diagonals) plus dense_reassemble (the host gather
// from diagonal-major planes into node layout): it writes the (N+1, M+1)
// backpointer plane in node layout directly. The plain version is
// svecalign_tpu_torch/ops/dp.py::dense_dp_batched.
//
// For node (r, c) of pair p, with r in 1..n and c in 1..m (n, m the pair's
// own sizes, at most the bucket's N, M):
//
//   cost0 = csum[r-1, c-1] + costs[r-1, c-1]     (diag, bp 0)
//   cost1 = csum[r,   c-1] + pen                 (left, bp 1)
//   cost2 = csum[r-1, c  ] + pen                 (up,   bp 2)
//
// minimised with a strict '<' in the order diag, left, up; row 0 holds
// c * pen (bp 1), column 0 holds r * pen (bp 2), the origin 0 (bp 4).
// Nodes outside the pair's (n+1, m+1) rectangle are not written: the
// wrapper fills the planes with -1 / +inf first, and no node inside the
// rectangle reads one outside it.
//
// What bounds it: n + m + 1 dependent anti-diagonals, each a few hundred
// cells, so latency and not bandwidth (a 300 x 275 pair moves ~0.4 MB).
// One CTA per pair; a thread per cell of the anti-diagonal (looping where
// the diagonal is longer than the block), the last two diagonals and the
// one being written in a ring of three rows in shared memory, one
// __syncthreads() per step: the row written at step d is the one that was
// read as "d - 2" at step d - 1, before that step's barrier. A diagonal is
// indexed by r where n <= m and by c otherwise, so a row has
// min(n, m) + 1 slots whatever the longer side is. Each thread loads the
// cost of its cell of the NEXT diagonal before the barrier, off the
// dependent chain (the read along a diagonal is strided and left so).
//
// Exactness: each candidate is one fp32 add (__fadd_rn) and each edge value
// one fp32 multiply (__fmul_rn), nothing is contracted into an FMA, so the
// planes equal the JAX scan's and the torch loop's bit for bit.
//
// Plain C interface, bound from Python with ctypes (ops/dense_dp_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__global__ void dense_dp_kernel(
    const float* __restrict__ costs,    // (P, N, M)
    const float* __restrict__ pens,     // (P,)
    const int* __restrict__ x_sizes,    // (P,)
    const int* __restrict__ y_sizes,    // (P,)
    int N, int M, int row_stride,       // row_stride = min(N, M) + 2
    int8_t* __restrict__ bp,            // (P, N + 1, M + 1)
    float* __restrict__ csum)           // (P, N + 1, M + 1) or null
{
    extern __shared__ float rows[];     // 3 rows of row_stride floats
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int n = min(max(x_sizes[p], 0), N);
    const int m = min(max(y_sizes[p], 0), M);
    const float pen = pens[p];
    const bool by_row = n <= m;
    const int L = by_row ? n : m;       // slots 0..L; slot s lives at [s + 1]
    const float* cost_p = costs + (size_t)p * N * M;
    const size_t plane = (size_t)(N + 1) * (M + 1);
    int8_t* bp_p = bp + (size_t)p * plane;
    float* csum_p = csum ? csum + (size_t)p * plane : nullptr;

    // [0] of every row stays +inf: "slot -1"
    for (int i = tid; i < 3 * row_stride; i += blockDim.x) rows[i] = CUDART_INF_F;
    __syncthreads();
    float* cur = rows;
    float* p1 = rows + row_stride;      // diagonal d - 1
    float* p2 = rows + 2 * row_stride;  // diagonal d - 2

    auto cost_at = [&](int d, int s) -> float {
        const int r = by_row ? s : d - s;
        const int c = d - r;
        if (s > L || r < 1 || c < 1 || r > n || c > m) return CUDART_INF_F;
        return cost_p[(size_t)(r - 1) * M + (c - 1)];
    };

    const int n_diags = n + m + 1;
    float next_cost = cost_at(0, tid);
    for (int d = 0; d < n_diags; ++d) {
        const float my_cost = next_cost;
        next_cost = cost_at(d + 1, tid);  // next step's, off the chain
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
                const size_t k = (size_t)r * (M + 1) + c;
                bp_p[k] = (int8_t)b;
                if (csum_p) csum_p[k] = val;
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch over (N, M) cost matrices needs.
size_t dense_dp_smem_bytes(int N, int M) {
    return 3 * (size_t)((N < M ? N : M) + 2) * sizeof(float);
}

// Launch on `stream`: one CTA of `threads` threads per pair. csum may be
// null. Returns the CUDA error code of the launch (0 on success).
int dense_dp_launch(const float* costs, const float* pens, const int* x_sizes,
                    const int* y_sizes, int P, int N, int M, int8_t* bp,
                    float* csum, int threads, void* stream) {
    const size_t smem = dense_dp_smem_bytes(N, M);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            dense_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dense_dp_kernel<<<P, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        costs, pens, x_sizes, y_sizes, N, M, (N < M ? N : M) + 2, bp, csum);
    return (int)cudaGetLastError();
}

}  // extern "C"
