// A measurement probe, not a kernel of the port: the latencies, in SM
// cycles, of the dependent operations that the banded DP's step-to-step
// chain is made of (csrc/banded_dp.cu), on the card it runs on.
// chip_smoke.py computes the DP's latency bound from them.
//
// One warp runs three dependent chains of `iters` links each (iters a
// multiple of 8) and times each with clock64():
//   0. fp32 arithmetic: x = min(x + c, d), two dependent operations a link
//      (an add, a minimum), so half a link is one operation;
//   1. a warp shuffle: x = shfl(x, (lane + shift) % 32);
//   2. a shared-memory round trip: store x, __syncwarp(), load the word
//      another lane stored. Two buffers in turns, so no second barrier is
//      needed before the next store, as in the DP's ring of K + 1 rows.
// A link's input is the link before's output, so nothing overlaps and
// cycles / links is the latency. The loop counter is an independent chain
// and hides behind it.
//
// Plain C interface, bound from Python with ctypes (chip_smoke.py).

#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 8;

__global__ void __launch_bounds__(32) chain_latency_kernel(
    int iters, int shift, float c, float d,
    long long* __restrict__ cycles,  // (3,): whole chain, lane 0's clock
    float* __restrict__ sink)        // (3, 32): keeps the chains alive
{
    __shared__ volatile float buf[2][32];
    const int lane = threadIdx.x;
    const int src = (lane + shift) & 31;
    float x = (float)lane;

    __syncwarp();
    long long t0 = clock64();
    for (int i = 0; i < iters; i += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) x = fminf(__fadd_rn(x, c), d);
    }
    long long t1 = clock64();
    sink[lane] = x;
    if (lane == 0) cycles[0] = t1 - t0;

    x = (float)lane;
    __syncwarp();
    t0 = clock64();
    for (int i = 0; i < iters; i += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) x = __shfl_sync(0xffffffffu, x, src);
    }
    t1 = clock64();
    sink[32 + lane] = x;
    if (lane == 0) cycles[1] = t1 - t0;

    x = (float)lane;
    __syncwarp();
    t0 = clock64();
    for (int i = 0; i < iters; i += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            buf[u & 1][lane] = x;
            __syncwarp();
            x = buf[u & 1][src];
        }
    }
    t1 = clock64();
    sink[64 + lane] = x;
    if (lane == 0) cycles[2] = t1 - t0;
}

}  // namespace

extern "C" {

// Run the three chains on `stream`. cycles: 3 int64 on the device, sink: 96
// floats on the device. Returns the CUDA error code of the launch, or
// cudaErrorInvalidValue where iters is not a positive multiple of 8.
int chain_latency_probe(int iters, int shift, float c, float d, long long* cycles,
                        float* sink, void* stream) {
    if (iters <= 0 || iters % UNROLL != 0) return (int)cudaErrorInvalidValue;
    chain_latency_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        iters, shift, c, d, cycles, sink);
    return (int)cudaGetLastError();
}

}  // extern "C"
