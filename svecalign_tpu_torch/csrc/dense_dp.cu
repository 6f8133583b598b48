// Dense 3-move wavefront DP for P document pairs in one launch, for sm_90a.
//
// The fused form of the JAX package's svecalign_tpu/ops/dp.py::dense_dp_scan
// (a lax.scan over anti-diagonals) plus dense_reassemble (the host gather
// from diagonal-major planes into node layout): it writes the whole
// (N+1, M+1) backpointer plane in node layout. The plain version is
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
// Nodes outside the pair's (n+1, m+1) rectangle hold -1 (bp) and +inf
// (csum): the kernel writes every node of the planes, so the wrapper
// allocates them without a fill.
//
// What bounds it: n + m + 1 dependent anti-diagonals, so latency and not
// bandwidth (a 300 x 275 pair moves ~0.4 MB); then the instructions a step
// issues. The design keeps every step's chain inside one warp, off device
// memory and free of block-wide barriers, and keeps the warps few:
//
// - Strips of rows. Compute warp w of W takes strips w, w + W, ... of 32 R rows;
//   lane l of strip s holds the R rows u = 32 R s + 1 + R l + r (r < R)
//   and walks the columns v = 1..m one step at a time, skewed: at step t
//   it is at v = t - l + 1. A row's left neighbour is its own value of the
//   step before; the row above is the lane's previous row, just computed,
//   or for the lane's first row lane l - 1's last row of the step before,
//   one __shfl_up_sync a step; the diagonal is the row above of the step
//   before, kept in a register. R = ceil(N / 256), at most 2: eight warps
//   cover up to 512 rows. A step's instructions, and its chain, grow with
//   R; more warps share the schedulers (measured best at R <= 2 on an H100).
// - Strip handover. Lane 31 of strip s puts its last row's value at each v
//   into its warp's queue in shared memory, one 8-byte store of (value,
//   sequence number); lane 0 of strip s + 1 polls the entry until its
//   sequence number is the one it expects, so no flag or fence is needed.
//   The consumer publishes how far it has read once every 32 steps
//   (release/acquire), and the producer waits for room before it writes
//   QLEN entries ahead. Where strips outnumber the warps, the last warp
//   hands over to the first warp's next strip, which starts only when that
//   warp's strip is done: that queue is a whole row long, in device memory
//   the wrapper allocates, so the last warp never waits for room (a cycle
//   of waits otherwise).
// - Costs and backpointers in tiles, moved by a helper warp. A lane needs
//   R costs a step, from its own rows. Each compute warp keeps, for each of
//   two 32-step blocks, R tiles of 32 x 33 floats in shared memory, skewed
//   like the strip (tile r, row l, column j: the cost of lane l's row r at
//   step j of the block), so that a step's reads hit 32 banks, and R
//   skewed tiles of its bp bytes (36-byte rows: conflict-free). A helper
//   warp per compute warp requests the next block's cost tiles with
//   cp.async, one coalesced row segment of the cost matrix per
//   instruction, and writes the previous block's bp tiles to the plane the
//   same way; the two meet at a named barrier once per block, so a step
//   makes no device-memory access. csum, which only checks ask for, is
//   stored straight from the step (a kernel variant of its own).
// - The 32 steps of a block are unrolled, so tile offsets are immediates,
//   and a step has no branch but the rare wait for a queue entry.
// - The planes' edges and everything outside the rectangle are written
//   row by row by whichever warps finish their strips first.
// - Every wait traps after ~17 s (a launch error, not a hung card).
//
// Exactness: each candidate is one fp32 add (__fadd_rn) and each edge value
// one fp32 multiply (__fmul_rn), nothing is contracted into an FMA, so the
// planes equal the JAX scan's and the torch loop's bit for bit.
//
// The rows a lane, warps and shared memory are dense_dp_plan's, which the
// wrapper calls before it launches (its Python copy ops/dense_dp_cuda.py::
// dense_dp_plan serves the tests where nvcc is not at hand).
//
// Plain C interface, bound from Python with ctypes (ops/dense_dp_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define DP_MAX_WARPS 8                         // compute warps; a helper warp each
#define DP_MAX_ROWS 2                          // rows a lane, at most
#define COST_STRIDE 33                         // floats a cost-tile row
#define BP_STRIDE 36                           // bytes a bp-tile row
#define QLEN 256                               // entries of a strip-boundary queue
#define COST_TILE_BYTES (2 * 32 * COST_STRIDE * 4)  // two blocks' tiles a row of a lane
#define BP_TILE_BYTES (2 * 32 * BP_STRIDE)
#define QUEUE_BYTES (QLEN * 8)
#define DP_STATIC_SMEM 1024                    // the kernel's static shared memory, rounded up

namespace {

// shared-memory flags and queue entries: explicit state space, so that no
// access takes the generic path
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.cta.shared.s32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// A wait that has spun for 2^35 cycles (~17 s) traps: a launch error, not a
// hung card. `since` starts at 0 and is set on the first failed poll.
__device__ __forceinline__ void watchdog(long long& since) {
    const long long now = clock64();
    if (since == 0) since = now;
    else if (now - since > (1LL << 35)) __trap();
}

// a queue entry: (value, sequence number) in one 8-byte access. Where
// strips go round the warps, the wrap queue lies in device memory and
// every entry is read and written through a generic address (GENERIC);
// else all queues are in shared memory.
template <bool GENERIC>
__device__ __forceinline__ unsigned long long ld_entry(const unsigned long long* p) {
    unsigned long long v;
    if (GENERIC)
        asm volatile("ld.volatile.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    else
        asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(v) : "r"(smem_addr(p)) : "memory");
    return v;
}

template <bool GENERIC>
__device__ __forceinline__ void st_entry(unsigned long long* p, unsigned long long v) {
    if (GENERIC)
        asm volatile("st.volatile.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
    else
        asm volatile("st.volatile.shared.u64 [%0], %1;" ::"r"(smem_addr(p)), "l"(v) : "memory");
}

// the entry `want` at p, once its producer has written it
__device__ __noinline__ unsigned long long wait_entry(const unsigned long long* p, int want) {
    long long since = 0;
    unsigned long long got;
    do {
        watchdog(since);
        got = ld_entry<true>(p);
    } while ((int)(got >> 32) != want);
    return got;
}

// the same at shared-memory address a: the queues' common case. No memory
// clobber: the step's tile loads may be scheduled around it
__device__ __forceinline__ unsigned long long lds_entry(unsigned a) {
    unsigned long long v;
    asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(v) : "r"(a));
    return v;
}

__device__ __noinline__ unsigned long long wait_entry_shared(unsigned a, int want) {
    long long since = 0;
    unsigned long long got;
    do {
        watchdog(since);
        got = lds_entry(a);
    } while ((int)(got >> 32) != want);
    return got;
}

// compute warp and helper warp `id - 1`: 64 threads
__device__ __forceinline__ void named_barrier(int id) {
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float edge(int i, float pen) {
    return i == 0 ? 0.0f : __fmul_rn((float)i, pen);
}

// dynamic shared memory of one warp at R rows a lane: R cost and R bp
// tiles for each of two blocks, and the queue to the next strip
__host__ __device__ constexpr int warp_smem(int R) {
    return R * (COST_TILE_BYTES + BP_TILE_BYTES) + QUEUE_BYTES;
}

// Tile items [it0, it1) of a block, item it = (i, r) = (it / R, it % R):
// row i R + r of the strip (lane i's row r), lanes along the block's steps
// (v = 32 bb + lane - i + 1). `src` is the lane's cost at (row 0, v of step
// `lane` of the block's lane 0), `dst` its bp node likewise; w = 32 bb +
// lane. An item is valid where its row and v lie in the pair.
template <int R>
__device__ __forceinline__ void cost_items(int it0, int it1, const float* src, float* tile,
                                           int w, int row_max, int m, int M) {
#pragma unroll
    for (int it = it0; it < it1; ++it) {
        const int i = it / R, r = it % R;
        if (i * R + r <= row_max && i <= w && i > w - m)
            cp_async4(tile + (r * 32 + i) * COST_STRIDE, src + ((i * R + r) * M - i));
    }
}

template <int R>
__device__ __forceinline__ void bp_items(int it0, int it1, int8_t* dst, const int8_t* tile,
                                         int w, int row_max, int m, int rs) {
    // eight tile bytes loaded before their eight stores: the compiler cannot
    // tell the plane from the tile, and would otherwise wait out each load
#pragma unroll
    for (int g = it0; g < it1; g += 8) {
        int8_t b[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int it = g + q, i = it / R, r = it % R;
            b[q] = it < it1 ? tile[(r * 32 + i) * BP_STRIDE] : 0;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int it = g + q, i = it / R, r = it % R;
            if (it < it1 && i * R + r <= row_max && i <= w && i > w - m)
                dst[(i * R + r) * rs - i] = b[q];
        }
    }
}

template <int R, bool ROUNDS, bool CSUM>
__global__ void __launch_bounds__(DP_MAX_WARPS * 64) dense_dp_kernel(
    const float* __restrict__ costs,    // (P, N, M)
    const float* __restrict__ pens,     // (P,)
    const int* __restrict__ x_sizes,    // (P,)
    const int* __restrict__ y_sizes,    // (P,)
    int N, int M,
    int8_t* __restrict__ bp,            // (P, N + 1, M + 1)
    float* __restrict__ csum,           // (P, N + 1, M + 1) or null
    unsigned long long* __restrict__ wrap)  // (P, M) where strips outnumber warps, else null
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int consumed[DP_MAX_WARPS];  // entries of compute warp w's queue its consumer has read
    __shared__ int fill_next;

    constexpr int SR = 32 * R;          // rows of a strip
    constexpr int TILE = R * 32 * COST_STRIDE, BTILE = R * 32 * BP_STRIDE;
    const int W = blockDim.x >> 6;      // compute warps; as many helper warps after them
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool helper = warp >= W;
    const int cw = helper ? warp - W : warp;  // the compute warp this warp is or serves
    const unsigned FULL = 0xffffffffu;
    const int p = blockIdx.x;
    const int n = min(max(x_sizes[p], 0), N);
    const int m = min(max(y_sizes[p], 0), M);
    const float pen = pens[p];
    const float* cost_p = costs + (size_t)p * N * M;
    const size_t plane = (size_t)(N + 1) * (M + 1);
    const int rs = M + 1;               // node row stride
    int8_t* bp_p = bp + (size_t)p * plane;
    float* csum_p = csum ? csum + (size_t)p * plane : nullptr;

    unsigned char* mine = smem + (size_t)cw * warp_smem(R);
    float* ctile = reinterpret_cast<float*>(mine);                            // [2][R][32][33]
    int8_t* btile = reinterpret_cast<int8_t*>(mine + R * COST_TILE_BYTES);   // [2][R][32][36]
    // compute warp w's queue: after its tiles
    unsigned long long* const queues = reinterpret_cast<unsigned long long*>(
        smem + R * (COST_TILE_BYTES + BP_TILE_BYTES));
    constexpr int QSTRIDE = warp_smem(R) / 8;
    unsigned long long* qout = queues + cw * QSTRIDE;
    if (!helper) {
        for (int i = lane; i < QLEN; i += 32) qout[i] = 0xffffffff00000000ull;  // sequence -1
        if (lane == 0) consumed[cw] = 0;
    }
    if (threadIdx.x == 0) fill_next = 0;
    const int nstrips = (n + SR - 1) / SR;
    // the last warp's strip hands over to the first warp's next strip, which
    // starts only when that warp's strip is done: through `wrap`, a whole
    // strip long, so that the last warp never waits for room
    unsigned long long* wrap_p = wrap ? wrap + (size_t)p * M : nullptr;
    if (nstrips > W)
        for (int i = threadIdx.x; i < m; i += blockDim.x) wrap_p[i] = 0xffffffff00000000ull;
    __syncthreads();
    const int nblocks = (m + 31 + 31) >> 5;
    const int bar = 1 + cw;             // the named barrier of compute warp cw and its helper

    if (helper) {
        // the tiles of cw's strips: block k's costs are in before barrier k,
        // block k - 2's backpointers are out before barrier k, and after the
        // last barrier the last block's
        for (int s = cw; s < nstrips; s += W) {
            const int u0 = SR * s + 1;
            const int row_max = n - u0;
            const float* cost_lane = cost_p + (size_t)(u0 - 1) * M + lane;
            int8_t* bp_lane = bp_p + (size_t)u0 * rs + lane + 1;
            cost_items<R>(0, 32 * R, cost_lane, ctile + lane, lane, row_max, m, M);
            cp_async_commit_wait_all();
            named_barrier(bar);
            for (int k = 1; k <= nblocks; ++k) {
                if (k < nblocks)
                    cost_items<R>(0, 32 * R, cost_lane + 32 * k, ctile + (k & 1) * TILE + lane,
                                  32 * k + lane, row_max, m, M);
                if (k >= 2)
                    bp_items<R>(0, 32 * R, bp_lane + 32 * (k - 2),
                                btile + (k & 1) * BTILE + lane, 32 * (k - 2) + lane, row_max, m, rs);
                cp_async_commit_wait_all();
                named_barrier(bar);
            }
            const int k = nblocks - 1;
            bp_items<R>(0, 32 * R, bp_lane + 32 * k, btile + (k & 1) * BTILE + lane,
                        32 * k + lane, row_max, m, rs);
            __syncwarp();
        }
    } else {
        const int qin_w = (cw + W - 1) % W;
        for (int s = cw; s < nstrips; s += W) {
            const int u0 = SR * s + 1;              // the strip's first row
            const int ul = u0 + R * lane;           // this lane's first row
            const int rows_on = min(R, n - ul + 1); // this lane's rows in the pair (<= 0: none)
            const bool has_next = s + 1 < nstrips;
            const bool wrap_out = ROUNDS && cw == W - 1, wrap_in = ROUNDS && cw == 0;
            const unsigned long long* qin = wrap_in ? wrap_p : queues + qin_w * QSTRIDE;
            const unsigned qin_s = smem_addr(queues + qin_w * QSTRIDE);
            const int in_base = s > 0 ? ((s - 1) / W) * m : 0;  // sequence of (strip s - 1, v = 1)
            const int out_base = (s / W) * m;
            float own[R];                           // this lane's rows at v - 1
#pragma unroll
            for (int r = 0; r < R; ++r) own[r] = edge(ul + r, pen);
            float nb_prev = edge(ul - 1, pen);      // the row above at v - 1
            float last = own[R - 1];                // what lane + 1 reads at the next step
            for (int blk = 0; blk < nblocks; ++blk) {
                const int cb = blk & 1;
                if (has_next && !wrap_out) {
                    // room for this block's entries: v up to 32 blk + 1
                    const int need = out_base + min(32 * blk + 1, m) - 1;
                    long long since = 0;
                    while (ld_acquire(&consumed[cw]) + QLEN <= need) watchdog(since);
                }
                named_barrier(bar);  // this block's costs are in, its bp tiles free
                const float* ct = ctile + cb * TILE + lane * COST_STRIDE;
                int8_t* bt = btile + cb * BTILE + lane * BP_STRIDE;
                const int v0 = 32 * blk - lane + 1;       // this lane's v at step 0 of the block
                const int polls = min(32, m - 32 * blk);  // steps at which lane 0's v is in the pair
                const int qbase = in_base + 32 * blk;
                const unsigned long long* qb = qin + (wrap_in ? 32 * blk : 0);
#pragma unroll
                for (int j = 0; j < 32; ++j) {
                    float cst[R];  // the step's costs, first: off the chain
#pragma unroll
                    for (int r = 0; r < R; ++r) cst[r] = ct[r * 32 * COST_STRIDE + j];
                    // lane 0's row above: the previous strip's last row (its
                    // queue entry), or row 0
                    const float sh = __shfl_up_sync(FULL, last, 1);
                    const bool polled = s > 0 && j < polls;
                    const int want = qbase + j;
                    unsigned long long got = 0;
                    if (ROUNDS) {
                        const unsigned long long* e =
                            wrap_in ? qb + j : qin + (want & (QLEN - 1));
                        if (polled) got = ld_entry<true>(e);
                        if (polled && (int)(got >> 32) != want) got = wait_entry(e, want);
                    } else {
                        const unsigned e = qin_s + ((want & (QLEN - 1)) << 3);
                        if (polled) got = lds_entry(e);
                        if (polled && (int)(got >> 32) != want) got = wait_entry_shared(e, want);
                    }
                    const float nq = s > 0 ? __uint_as_float((unsigned)got)
                                           : __fmul_rn((float)(32 * blk + j + 1), pen);
                    const float nb = lane == 0 ? nq : sh;
                    const int v = v0 + j;
                    const bool act = (unsigned)(v - 1) < (unsigned)m;
                    float up = nb, diag = nb_prev;
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float cost0 = __fadd_rn(diag, cst[r]);
                        const float cost1 = __fadd_rn(own[r], pen);
                        const float cost2 = __fadd_rn(up, pen);
                        const bool left = cost1 < cost0;
                        const float v1 = left ? cost1 : cost0;
                        const bool upw = cost2 < v1;
                        const float val = upw ? cost2 : v1;
                        bt[r * 32 * BP_STRIDE + j] = (int8_t)(upw ? 2 : (left ? 1 : 0));
                        if (CSUM && act && r < rows_on) csum_p[(size_t)(ul + r) * rs + v] = val;
                        diag = own[r];
                        up = val;
                        own[r] = act ? val : own[r];
                    }
                    last = up;  // the lane's last row at v; read only where it is in the pair
                    nb_prev = act ? nb : nb_prev;
                    if (lane == 31 && has_next && act) {
                        const int seq = out_base + v - 1;
                        const unsigned long long entry =
                            ((unsigned long long)(unsigned)seq << 32) | __float_as_uint(up);
                        if (ROUNDS)
                            st_entry<true>(wrap_out ? wrap_p + v - 1 : qout + (seq & (QLEN - 1)),
                                           entry);
                        else
                            st_entry<false>(qout + (seq & (QLEN - 1)), entry);
                    }
                }
                if (s > 0 && !wrap_in && lane == 0)
                    st_release(&consumed[qin_w], in_base + min(32 * blk + 32, m));
            }
            named_barrier(bar);  // the last block's bp tiles are complete
        }
    }

    // edges and the nodes outside the rectangle, a node row at a time
    for (;;) {
        int r = 0;
        if (lane == 0) r = atomicAdd(&fill_next, 1);
        r = __shfl_sync(FULL, r, 0);
        if (r > N) break;
        int8_t* brow = bp_p + (size_t)r * rs;
        float* crow = csum_p ? csum_p + (size_t)r * rs : nullptr;
        int c0 = 0;
        if (r == 0) {
            for (int c = lane; c <= m; c += 32) {
                brow[c] = (int8_t)(c == 0 ? 4 : 1);
                if (crow) crow[c] = edge(c, pen);
            }
            c0 = m + 1;
        } else if (r <= n) {
            if (lane == 0) {
                brow[0] = 2;
                if (crow) crow[0] = edge(r, pen);
            }
            c0 = m + 1;
        }
        for (int c = c0 + lane; c <= M; c += 32) {
            brow[c] = -1;
            if (crow) crow[c] = CUDART_INF_F;
        }
    }
}

template <int R, bool ROUNDS, bool CSUM>
int launch_variant(const float* costs, const float* pens, const int* x_sizes,
                   const int* y_sizes, int P, int N, int M, int8_t* bp, float* csum,
                   unsigned long long* wrap, int warps, int smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_dp_kernel<R, ROUNDS, CSUM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dense_dp_kernel<R, ROUNDS, CSUM><<<P, warps * 64, smem, stream>>>(
        costs, pens, x_sizes, y_sizes, N, M, bp, csum, wrap);
    return (int)cudaGetLastError();
}

// the variant of the wrap queue (strips past the last warp) and of the
// csum plane (checks only), each a kernel of its own
template <int R, bool ROUNDS>
int launch_rounds(const float* costs, const float* pens, const int* x_sizes,
                  const int* y_sizes, int P, int N, int M, int8_t* bp, float* csum,
                  unsigned long long* wrap, int warps, int smem, cudaStream_t stream) {
    if (csum)
        return launch_variant<R, ROUNDS, true>(costs, pens, x_sizes, y_sizes, P, N, M, bp,
                                               csum, wrap, warps, smem, stream);
    return launch_variant<R, ROUNDS, false>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum,
                                            wrap, warps, smem, stream);
}

template <int R>
int launch(const float* costs, const float* pens, const int* x_sizes, const int* y_sizes,
           int P, int N, int M, int8_t* bp, float* csum, unsigned long long* wrap, int warps,
           int smem, cudaStream_t stream) {
    if (wrap)
        return launch_rounds<R, true>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, wrap,
                                      warps, smem, stream);
    return launch_rounds<R, false>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, wrap,
                                   warps, smem, stream);
}

}  // namespace

extern "C" {

// The launch geometry over (N, M) cost matrices: plan[3] rows a lane, R =
// ceil(N / 256) (eight warps take up to 512 rows), at most DP_MAX_ROWS;
// plan[0] compute warps a block (a helper warp each), one per strip of
// 32 R rows, at most DP_MAX_WARPS and as many as smem_optin bytes hold
// (strips past the last warp go round again); plan[1] bytes of dynamic
// shared memory (warp_smem(R) a compute warp); plan[2] 1 where strips can outnumber the
// warps: then the launch needs `wrap`, M 8-byte entries a pair of device
// memory. Returns 0, or 1 where smem_optin bytes do not hold the warps
// needed: one for N of 32 R or less, else two.
int dense_dp_plan(int N, int M, int smem_optin, int* plan) {
    int R = (N + 255) / 256;
    R = R < 1 ? 1 : (R > DP_MAX_ROWS ? DP_MAX_ROWS : R);
    const int strips = (N + 32 * R - 1) / (32 * R);
    int warps = strips < 1 ? 1 : strips;
    if (warps > DP_MAX_WARPS) warps = DP_MAX_WARPS;
    const int fit = (smem_optin - DP_STATIC_SMEM) / warp_smem(R);
    if (warps > fit) warps = fit;
    const int need = strips > 1 ? 2 : 1;  // strips past the last warp wait on a queue
    plan[2] = strips > warps;
    plan[3] = R;
    if (warps < need) {
        plan[0] = need;
        plan[1] = need * warp_smem(R);
        return 1;
    }
    plan[0] = warps;
    plan[1] = warps * warp_smem(R);
    return 0;
}

// Launch on `stream`: one CTA per pair, its geometry dense_dp_plan's. csum
// may be null; wrap must be given where the plan says so. Returns the CUDA
// error code of the launch (0 on success); cudaErrorInvalidValue where
// dense_dp_plan refuses the shape or wrap is missing.
int dense_dp_launch(const float* costs, const float* pens, const int* x_sizes,
                    const int* y_sizes, int P, int N, int M, int8_t* bp,
                    float* csum, unsigned long long* wrap, int smem_optin, void* stream) {
    int plan[4];
    if (dense_dp_plan(N, M, smem_optin, plan) != 0 || (plan[2] && !wrap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (plan[3] == 1)
        return launch<1>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, wrap, plan[0], plan[1], st);
    return launch<2>(costs, pens, x_sizes, y_sizes, P, N, M, bp, csum, wrap, plan[0], plan[1], st);
}

}  // extern "C"
