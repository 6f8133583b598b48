// Traceback walks on the card for P document pairs in one launch, for
// sm_90a: follow the DP's backpointers from node (x_size, y_size) to the
// origin and emit only the visited path, so the planes never leave the
// card.
//
// The fused forms of the JAX package's svecalign_tpu/ops/dp.py::
// dense_traceback_scan and banded_traceback_scan (lax.scan programs of
// N + M + 1 and A + 2 steps). The plain versions are
// svecalign_tpu_torch/ops/dp.py::dense_traceback_walk and
// banded_traceback_walk.
//
// dense_walk_kernel reads the node-layout (N+1, M+1) int8 plane of
// csrc/dense_dp.cu (0 = diag, 1 = left, 2 = up, 4 = origin) and emits, per
// step, the node and its pointer: xs, ys (int32), vs (int8), N + M + 1
// steps. banded_walk_kernel reads the (A+2, B) planes of csrc/banded_dp.cu
// in rotated coordinates (a = x + y, b = y - boff_out[a]) and emits xs, ys
// (int32), the two pointers and the cumulative cost at every visited node,
// A + 2 steps. Once a walk is at the origin it stays there; the host
// conversion (vecalign/traceback.py::*_alignments_from_steps) stops at the
// first origin step.
//
// What bounds them: a chain of dependent loads, one pointer fetch per step
// (a few bytes), so latency and not bandwidth or arithmetic. One CTA per
// pair and one walking thread in it, so pairs do not wait for each other.
// The banded walk's other threads first copy the pair's A + 2 node offsets
// into shared memory (where they fit), which takes the offset lookup, the
// first of a step's two dependent loads, off device memory; the two
// pointers and the cumulative cost of a node are independent loads at one
// address. Indices are clamped to the planes, so corrupt pointers give a
// path that the host conversion rejects, never a fault.
//
// Plain C interface, bound from Python with ctypes (ops/traceback_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void dense_walk_kernel(
    const int8_t* __restrict__ bp,     // (P, N + 1, M + 1)
    const int* __restrict__ x_sizes,   // (P,)
    const int* __restrict__ y_sizes,   // (P,)
    int N, int M,
    int* __restrict__ xs,              // (P, N + M + 1)
    int* __restrict__ ys,              // (P, N + M + 1)
    int8_t* __restrict__ vs)           // (P, N + M + 1)
{
    if (threadIdx.x != 0) return;
    const int p = blockIdx.x;
    const int steps = N + M + 1;
    const int8_t* bp_p = bp + (size_t)p * (N + 1) * (M + 1);
    int xx = min(max(x_sizes[p], 0), N);
    int yy = min(max(y_sizes[p], 0), M);
    for (int i = 0; i < steps; ++i) {
        const int v = bp_p[(size_t)xx * (M + 1) + yy];
        const size_t o = (size_t)p * steps + i;
        xs[o] = xx;
        ys[o] = yy;
        vs[o] = (int8_t)v;
        if (xx != 0 || yy != 0) {
            xx = max(xx - (int)(v == 0 || v == 2), 0);
            yy = max(yy - (int)(v == 0 || v == 1), 0);
        }
    }
}

template <typename BP>
__global__ void banded_walk_kernel(
    const float* __restrict__ csum,     // (P, A2, B)
    const BP* __restrict__ xp,          // (P, A2, B)
    const BP* __restrict__ yp,          // (P, A2, B)
    const int* __restrict__ boff_out,   // (P, A2)
    const int* __restrict__ x_sizes,    // (P,)
    const int* __restrict__ y_sizes,    // (P,)
    int A2, int B, int offsets_on_chip,
    int* __restrict__ xs,               // (P, A2)
    int* __restrict__ ys,               // (P, A2)
    BP* __restrict__ xps,               // (P, A2)
    BP* __restrict__ yps,               // (P, A2)
    float* __restrict__ cs)             // (P, A2)
{
    extern __shared__ int s_boff[];
    const int p = blockIdx.x;
    const int* boff = boff_out + (size_t)p * A2;
    if (offsets_on_chip) {
        for (int i = threadIdx.x; i < A2; i += blockDim.x) s_boff[i] = boff[i];
        __syncthreads();
        boff = s_boff;
    }
    if (threadIdx.x != 0) return;
    const size_t base = (size_t)p * A2 * B;
    int xx = x_sizes[p];
    int yy = y_sizes[p];
    for (int i = 0; i < A2; ++i) {
        const int aa = min(max(xx + yy, 0), A2 - 1);
        const int bb = min(max(yy - boff[aa], 0), B - 1);
        const size_t k = base + (size_t)aa * B + bb;
        const BP vx = xp[k];
        const BP vy = yp[k];
        const size_t o = (size_t)p * A2 + i;
        xs[o] = xx;
        ys[o] = yy;
        xps[o] = vx;
        yps[o] = vy;
        cs[o] = csum[k];
        if (xx != 0 || yy != 0) {
            xx -= (int)vx;
            yy -= (int)vy;
        }
    }
}

}  // namespace

extern "C" {

// Walk the dense planes of P pairs on `stream`. Returns the CUDA error code
// of the launch (0 on success).
int dense_walk_launch(const int8_t* bp, const int* x_sizes, const int* y_sizes,
                      int P, int N, int M, int* xs, int* ys, int8_t* vs, void* stream) {
    dense_walk_kernel<<<P, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        bp, x_sizes, y_sizes, N, M, xs, ys, vs);
    return (int)cudaGetLastError();
}

// Walk the banded planes of P pairs on `stream`; bp_int8 tells the type of
// xp, yp, xps and yps (int8, else int32). The node offsets are held in
// shared memory where A2 ints fit the 48 KB a block has without opting in.
int banded_walk_launch(const float* csum, const void* xp, const void* yp,
                       const int* boff_out, const int* x_sizes, const int* y_sizes,
                       int P, int A2, int B, int bp_int8, int* xs, int* ys,
                       void* xps, void* yps, float* cs, void* stream) {
    const size_t want = (size_t)A2 * sizeof(int);
    const int on_chip = want <= 48 * 1024;
    const size_t smem = on_chip ? want : 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (bp_int8) {
        banded_walk_kernel<int8_t><<<P, 128, smem, st>>>(
            csum, (const int8_t*)xp, (const int8_t*)yp, boff_out, x_sizes, y_sizes,
            A2, B, on_chip, xs, ys, (int8_t*)xps, (int8_t*)yps, cs);
    } else {
        banded_walk_kernel<int32_t><<<P, 128, smem, st>>>(
            csum, (const int32_t*)xp, (const int32_t*)yp, boff_out, x_sizes, y_sizes,
            A2, B, on_chip, xs, ys, (int32_t*)xps, (int32_t*)yps, cs);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
