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
// What bounds them: a chain of dependent steps, each a pointer fetch of a
// few bytes, so latency and not bandwidth or arithmetic. One CTA per pair,
// so pairs do not wait for each other.
//
// dense_walk_kernel: one walking thread; each step's pointer is a load
// from device memory on the chain.
//
// banded_walk_kernel takes every device-memory load off the chain. Fifteen
// producer warps turn the pair's planes into a successor plane in shared
// memory, ahead of the walker: for band cell (a, b) the index of the cell
// the walk moves to next, k' = a' << row_shift | b' (row_shift =
// ceil(log2 B)), computed from the cell's two pointers and the node
// offsets of rows a and a'. A walk moves to a lower row at every step, so
// the producers fill chunks of rows downwards from the walk's first row
// into a ring of slots (a power of two of rows, so that the ring address
// is k & mask), each slot's chunks by one warp in order; a slot's flag
// names the chunk it holds (release/acquire), the walker's count of
// released chunks frees a slot for the chunk `slots` further down, and a
// chunk the walker has jumped over is skipped. The walk's first chunk is
// split over every producer: the walker waits for it alone. Every wait
// traps after ~17 s (a launch error, not a hung card). The walker (thread
// 0) then runs k = ring[k & mask]: one shared-memory load a step, and a
// compare that is
// true only at a new chunk or the walk's end, four steps a turn (the test
// off the chain: a turn that meets a new chunk or the end is cut back to
// that step). It records each visited k in shared memory (in xs where the
// walk could outrun WALK_MAX_RECORDS), and stops at the first cell that
// stays put (the origin). The whole block then gathers each step's node, two
// pointers and cumulative cost at the recorded cells and writes the five
// arrays coalesced, and writes the tail of origin repeats in parallel.
// Where a cell's successor is no band cell of a lower row (a start outside
// the band, or a corrupt pointer: the plain version clamps there), the
// successor is marked and the walker follows the rest of that walk from
// device memory, step by step and clamped as the plain version does, so
// every input gives the plain version's five arrays. The ring's geometry is
// banded_walk_plan's, which the wrapper calls before it launches (its
// Python copy ops/traceback_cuda.py::banded_walk_plan serves the tests
// where nvcc is not at hand); a band too wide for one ring row of shared
// memory is refused there.
//
// Plain C interface, bound from Python with ctypes (ops/traceback_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define WALK_THREADS 512         // the walker's warp and up to 15 producer warps
#define WALK_MAX_PRODUCERS 15
// producer warps at work: every warp but the walker's (a measurement build
// may set fewer with -DWALK_PRODUCERS=k)
#ifndef WALK_PRODUCERS
#define WALK_PRODUCERS WALK_MAX_PRODUCERS
#endif
#define WALK_CHUNK_SHIFT 9       // a chunk: 1 << 9 cells (whole rows, at least one)
#define WALK_BATCH 16            // cells a producer lane loads at once (32 x 16 = 1 << 9)
#define WALK_RING_BYTES 65536    // the ring grows to this, or to the plane's rows
#define WALK_MAX_SLOTS 64
#define WALK_MAX_RECORDS 16384   // records in shared memory (64 KB); a longer walk's go to xs
#define WALK_STATIC_SMEM 1024    // the kernel's static shared memory, rounded up
#define WALK_STOP (1 << 30)      // `released` value that ends the producers
#define WALK_END (-2)            // successor mark: the walk stays at this cell
#define WALK_ESCAPE (-1)         // successor mark: not a band cell of a lower row

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

// shared-memory flags: explicit state space, so that no access takes the
// generic path
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

// The successor of band cell (a, b) whose pointers are (vx, vy): the index
// of the next band cell, WALK_END where the walk stays (the origin, or
// zero pointers), WALK_ESCAPE where the next node is no band cell of a
// lower row.
__device__ __forceinline__ int successor(int a, int b, int vx, int vy, const int* boff, int B,
                                         int row_shift) {
    const int yy = b + __ldg(boff + a);
    const int xx = a - yy;
    if ((xx == 0 && yy == 0) || (vx == 0 && vy == 0)) return WALK_END;
    const int a2 = a - vx - vy;
    if (a2 < 0 || a2 >= a) return WALK_ESCAPE;
    const int b2 = yy - vy - __ldg(boff + a2);
    return b2 >= 0 && b2 < B ? (a2 << row_shift) | b2 : WALK_ESCAPE;
}

template <typename BP>
__global__ void __launch_bounds__(WALK_THREADS) banded_walk_kernel(
    const float* __restrict__ csum,     // (P, A2, B)
    const BP* __restrict__ xp,          // (P, A2, B)
    const BP* __restrict__ yp,          // (P, A2, B)
    const int* __restrict__ boff_out,   // (P, A2)
    const int* __restrict__ x_sizes,    // (P,)
    const int* __restrict__ y_sizes,    // (P,)
    int A2, int B, int row_shift, int chunk_shift, int slots, int rec_cap,
    int* __restrict__ xs,               // (P, A2); the walker's scratch first
    int* __restrict__ ys,               // (P, A2)
    BP* __restrict__ xps,               // (P, A2)
    BP* __restrict__ yps,               // (P, A2)
    float* __restrict__ cs)             // (P, A2)
{
    extern __shared__ int ring[];       // slots << chunk_shift rows of 1 << row_shift, then
                                        // rec_cap records of the walk
    __shared__ int slot_chunk[WALK_MAX_SLOTS];
    __shared__ int released;            // chunks below the top one the walker is done with
    __shared__ int first_done;          // producers done with the walk's first chunk
    __shared__ int s_fast, s_end, s_tx, s_ty;

    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int* boff = boff_out + (size_t)p * A2;
    const size_t base = (size_t)p * A2 * B;
    const size_t obase = (size_t)p * A2;
    const int x0 = x_sizes[p], y0 = y_sizes[p];
    const int a_top = min(max(x0 + y0, 0), A2 - 1);
    const int c_top = a_top >> chunk_shift;
    const int mask = (slots << (chunk_shift + row_shift)) - 1;
    for (int i = tid; i < slots; i += blockDim.x) slot_chunk[i] = -1;
    if (tid == 0) released = first_done = 0;
    __syncthreads();

    // producers 0-11 sit on the three schedulers the walker (warp 0) does
    // not use, 12-14 on the walker's
    const int producer = (warp & 3) ? warp - 1 - (warp >> 2) : (warp ? 11 + (warp >> 2) : -1);
    if (producer >= 0 && producer < WALK_PRODUCERS) {
        // producers: chunk j (rows of chunk c = c_top - j) goes to slot
        // c mod slots, and a slot's chunks to one warp, in order, so that a
        // slot never takes an older chunk after a newer one
        const int n_prod = WALK_PRODUCERS;
        const int cells = 1 << (chunk_shift + row_shift);  // a multiple of 32 * WALK_BATCH
        const int bmask = (1 << row_shift) - 1;
        {
            // the walk's first chunk, split over every producer: the walker
            // waits for it alone, so it comes first and fastest
            const int a_lo = c_top << chunk_shift;
            for (int e = producer * 32 + lane; e < cells; e += n_prod * 32) {
                const int a = a_lo + (e >> row_shift), b = e & bmask;
                if (a < A2 && b < B) {
                    const size_t idx = base + (size_t)a * B + b;
                    ring[((a << row_shift) | b) & mask] =
                        successor(a, b, (int)xp[idx], (int)yp[idx], boff, B, row_shift);
                }
            }
            __threadfence_block();
            __syncwarp();
            if (lane == 0) atomicAdd(&first_done, 1);
        }
        for (int j = 1; j <= c_top; ++j) {
            const int c = c_top - j;
            if ((c & (slots - 1)) % n_prod != producer) continue;
            int rel;
            long long since = 0;
            while ((rel = ld_acquire(&released)) <= j - slots && rel < WALK_STOP) {
                // a producer a ring ahead need not wake at once: sleep, and
                // leave the walker's scheduler its issue slots
                __nanosleep(200);
                watchdog(since);
            }
            if (rel >= WALK_STOP) break;
            if (rel > j) continue;  // the walker is below this chunk already
            // the chunk's cells, WALK_BATCH a lane at a time: every pointer
            // load of a batch in flight at once, then the successors
            const int a_lo = c << chunk_shift;
            for (int e0 = 0; e0 < cells; e0 += 32 * WALK_BATCH) {
                int vx[WALK_BATCH], vy[WALK_BATCH];
#pragma unroll
                for (int q = 0; q < WALK_BATCH; ++q) {
                    const int e = e0 + 32 * q + lane;
                    const int a = a_lo + (e >> row_shift), b = e & bmask;
                    vx[q] = vy[q] = 0;
                    if (a < A2 && b < B) {
                        const size_t idx = base + (size_t)a * B + b;
                        vx[q] = (int)xp[idx];
                        vy[q] = (int)yp[idx];
                    }
                }
#pragma unroll
                for (int q = 0; q < WALK_BATCH; ++q) {
                    const int e = e0 + 32 * q + lane;
                    const int a = a_lo + (e >> row_shift), b = e & bmask;
                    if (a < A2 && b < B)
                        ring[((a << row_shift) | b) & mask] =
                            successor(a, b, vx[q], vy[q], boff, B, row_shift);
                }
            }
            __threadfence_block();
            __syncwarp();
            if (lane == 0) st_release(&slot_chunk[c & (slots - 1)], c);
        }
    } else if (warp == 0 && lane == 0) {
        // the walker
        int fast = 0, end = A2, xx = x0, yy = y0;
        bool tail = false, general = true;
        const int b0 = (x0 + y0 >= 0 && x0 + y0 < A2) ? y0 - boff[x0 + y0] : -1;
        if (b0 >= 0 && b0 < B) {
            int k = (a_top << row_shift) | b0;
            int lo = (c_top << chunk_shift) << row_shift;
            long long since = 0;
            while (ld_acquire(&first_done) != WALK_PRODUCERS) watchdog(since);
            // shared-memory addresses held in registers: the loop is a store
            // of the record and one load, and nothing else on the way
            unsigned ring_s, rec_s;
            asm volatile("mov.u32 %0, %1;" : "=r"(ring_s) : "r"(smem_addr(ring)));
            asm volatile("mov.u32 %0, %1;" : "=r"(rec_s) : "r"(smem_addr(ring + mask + 1)));
            // a row is left at every step: at most a_top + 1 records
            auto next = [&](int c) {
                int v;
                asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(ring_s + ((c & mask) << 2)));
                return v;
            };
            int nk;
            if (a_top + 4 <= rec_cap) {
                // four steps a turn, one test: a successor below the chunk
                // that is in (or a mark) ends the turn at that step; the
                // steps before it are good, those after it are redone
                for (;;) {
                    const int k1 = next(k), k2 = next(k1), k3 = next(k2), k4 = next(k3);
                    const unsigned r = rec_s + (fast << 2);
                    asm volatile("st.shared.s32 [%0], %1;" ::"r"(r), "r"(k));
                    asm volatile("st.shared.s32 [%0 + 4], %1;" ::"r"(r), "r"(k1));
                    asm volatile("st.shared.s32 [%0 + 8], %1;" ::"r"(r), "r"(k2));
                    asm volatile("st.shared.s32 [%0 + 12], %1;" ::"r"(r), "r"(k3));
                    if (min(min(k1, k2), min(k3, k4)) >= lo) {
                        fast += 4;
                        k = k4;
                        continue;
                    }
                    int last;
                    if (k1 < lo) {
                        fast += 1; last = k; nk = k1;
                    } else if (k2 < lo) {
                        fast += 2; last = k1; nk = k2;
                    } else if (k3 < lo) {
                        fast += 3; last = k2; nk = k3;
                    } else {
                        fast += 4; last = k3; nk = k4;
                    }
                    if (nk < 0) {
                        k = last;
                        break;
                    }
                    const int c2 = nk >> (row_shift + chunk_shift);
                    st_release(&released, c_top - c2);
                    since = 0;
                    while (ld_acquire(&slot_chunk[c2 & (slots - 1)]) != c2) watchdog(since);
                    lo = (c2 << chunk_shift) << row_shift;
                    k = nk;
                }
            } else {
                // a walk longer than the records shared memory holds: a step a
                // turn, the records in xs
                for (;;) {
                    xs[obase + fast++] = k;
                    nk = next(k);
                    if (nk < lo) {
                        if (nk < 0) break;
                        const int c2 = nk >> (row_shift + chunk_shift);
                        st_release(&released, c_top - c2);
                        since = 0;
                        while (ld_acquire(&slot_chunk[c2 & (slots - 1)]) != c2) watchdog(since);
                        lo = (c2 << chunk_shift) << row_shift;
                    }
                    k = nk;
                }
            }
            const int a = k >> row_shift, b = k & ((1 << row_shift) - 1);
            yy = b + boff[a];
            xx = a - yy;
            if (nk == WALK_END) {
                tail = true;
                general = false;
                end = fast;
            } else {
                const size_t idx = base + (size_t)a * B + b;
                xx -= (int)xp[idx];
                yy -= (int)yp[idx];
            }
        }
        st_release(&released, WALK_STOP);
        if (general) {
            // the rest of the walk from device memory, as the plain version
            int i = fast;
            for (; i < A2; ++i) {
                const int aa = min(max(xx + yy, 0), A2 - 1);
                const int bb = min(max(yy - boff[aa], 0), B - 1);
                const size_t k = base + (size_t)aa * B + bb;
                const BP vx = xp[k];
                const BP vy = yp[k];
                const size_t o = obase + i;
                xs[o] = xx;
                ys[o] = yy;
                xps[o] = vx;
                yps[o] = vy;
                cs[o] = csum[k];
                if (xx == 0 && yy == 0) {
                    tail = true;
                    ++i;
                    break;
                }
                xx -= (int)vx;
                yy -= (int)vy;
            }
            end = i;
        }
        s_fast = fast;
        s_end = tail ? end : A2;
        s_tx = xx;
        s_ty = yy;
    }
    __syncthreads();

    // the recorded cells' nodes, pointers and costs; then the tail
    const int fast = s_fast, end = s_end;
    const int* recs = ring + mask + 1;
    const bool shared_recs = a_top + 4 <= rec_cap;
    for (int i = tid; i < fast; i += blockDim.x) {
        const int k = shared_recs ? recs[i] : xs[obase + i];
        const int a = k >> row_shift, b = k & ((1 << row_shift) - 1);
        const int yy = b + __ldg(boff + a);
        const size_t idx = base + (size_t)a * B + b;
        xs[obase + i] = a - yy;
        ys[obase + i] = yy;
        xps[obase + i] = xp[idx];
        yps[obase + i] = yp[idx];
        cs[obase + i] = csum[idx];
    }
    if (end < A2) {
        const int tx = s_tx, ty = s_ty;
        const int aa = min(max(tx + ty, 0), A2 - 1);
        const int bb = min(max(ty - __ldg(boff + aa), 0), B - 1);
        const size_t idx = base + (size_t)aa * B + bb;
        const BP vx = xp[idx], vy = yp[idx];
        const float c = csum[idx];
        for (int i = end + tid; i < A2; i += blockDim.x) {
            xs[obase + i] = tx;
            ys[obase + i] = ty;
            xps[obase + i] = vx;
            yps[obase + i] = vy;
            cs[obase + i] = c;
        }
    }
}

int ceil_log2(long long v) {
    int s = 0;
    while ((1LL << s) < v) ++s;
    return s;
}

}  // namespace

extern "C" {

// The banded walk's ring for planes of A2 rows of B cells: fills plan[0..4]
// with row_shift (a ring row holds 1 << row_shift successors, >= B),
// chunk_shift (a chunk is 1 << chunk_shift rows: 1 << WALK_CHUNK_SHIFT cells,
// or one row), slots (chunks in the ring, a power of two), the bytes of
// dynamic shared memory (the ring, then the records) and records (room for
// the walk's records in shared memory: A2 + 3 rounded up to 4, at most
// WALK_MAX_RECORDS; a walk that does not fit records into xs). The ring
// holds at most WALK_RING_BYTES,
// or the plane's rows rounded up to a power of two, whichever is less, and
// at least one chunk. Returns 0, or 1 where one chunk and the static
// shared memory do not fit smem_optin bytes or a cell index does not fit 31 bits.
int banded_walk_plan(int A2, int B, int smem_optin, int* plan) {
    const int row_shift = ceil_log2(B);
    const int chunk_shift = row_shift < WALK_CHUNK_SHIFT ? WALK_CHUNK_SHIFT - row_shift : 0;
    const long long row_bytes = 4LL << row_shift;
    const long long a2_rows = 1LL << ceil_log2(A2);
    const long long cap_rows = a2_rows > (1LL << chunk_shift) ? a2_rows : 1LL << chunk_shift;
    long long rows = 1LL << chunk_shift;
    while (rows * 2 <= cap_rows && rows * 2 * row_bytes <= WALK_RING_BYTES &&
           (rows * 2 >> chunk_shift) <= WALK_MAX_SLOTS)
        rows *= 2;
    // records: the longest walk (A2 steps) and the three a batch may overrun,
    // in whole 16-byte stores
    const int records = A2 + 3 < WALK_MAX_RECORDS ? (A2 + 3 + 3) & ~3 : WALK_MAX_RECORDS;
    const long long bytes = rows * row_bytes + 4LL * records;
    plan[0] = row_shift;
    plan[1] = chunk_shift;
    plan[2] = (int)(rows >> chunk_shift);
    plan[3] = bytes < INT32_MAX ? (int)bytes : INT32_MAX;
    plan[4] = records;
    if (bytes + WALK_STATIC_SMEM > smem_optin) return 1;
    if (((long long)A2 << row_shift) > INT32_MAX) return 1;
    return 0;
}

// Walk the dense planes of P pairs on `stream`. Returns the CUDA error code
// of the launch (0 on success).
int dense_walk_launch(const int8_t* bp, const int* x_sizes, const int* y_sizes,
                      int P, int N, int M, int* xs, int* ys, int8_t* vs, void* stream) {
    dense_walk_kernel<<<P, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        bp, x_sizes, y_sizes, N, M, xs, ys, vs);
    return (int)cudaGetLastError();
}

// Walk the banded planes of P pairs on `stream`; bp_int8 tells the type of
// xp, yp, xps and yps (int8, else int32). Returns the CUDA error code of
// the launch (0 on success); cudaErrorInvalidValue where banded_walk_plan
// refuses the shape.
int banded_walk_launch(const float* csum, const void* xp, const void* yp,
                       const int* boff_out, const int* x_sizes, const int* y_sizes,
                       int P, int A2, int B, int bp_int8, int smem_optin,
                       int* xs, int* ys, void* xps, void* yps, float* cs, void* stream) {
    int plan[5];
    if (banded_walk_plan(A2, B, smem_optin, plan) != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)plan[3];
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bp_int8) {
        err = cudaFuncSetAttribute(banded_walk_kernel<int8_t>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        banded_walk_kernel<int8_t><<<P, WALK_THREADS, smem, st>>>(
            csum, (const int8_t*)xp, (const int8_t*)yp, boff_out, x_sizes, y_sizes,
            A2, B, plan[0], plan[1], plan[2], plan[4], xs, ys, (int8_t*)xps,
            (int8_t*)yps, cs);
    } else {
        err = cudaFuncSetAttribute(banded_walk_kernel<int32_t>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        banded_walk_kernel<int32_t><<<P, WALK_THREADS, smem, st>>>(
            csum, (const int32_t*)xp, (const int32_t*)yp, boff_out, x_sizes, y_sizes,
            A2, B, plan[0], plan[1], plan[2], plan[4], xs, ys, (int32_t*)xps,
            (int32_t*)yps, cs);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
