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
// so pairs do not wait for each other. Both kernels keep device memory off
// the walker's chain: it reads the pair's pointers from shared memory,
// staged there ahead of it, and stops at the walk's end.
//
// dense_walk_kernel: a step moves from flat index k = x (M + 1) + y to a
// strictly lower one, so the walk reads the pair's int8 plane over [0, k0]
// (k0 its start) from the top down, and nothing above k0 is copied. One lane
// of a copier warp streams that range into a ring of shared-memory slots, a
// chunk of 1 << DWALK_CHUNK_SHIFT bytes a slot, one cp.async.bulk (TMA, 1-D)
// a chunk on the slot's mbarrier, from the top chunk down. Chunks are
// aligned in absolute address, since bulk copies need 16-byte aligned ends
// and a pair's plane starts at p (N + 1) (M + 1), anywhere: the fewer than
// 16 bytes at each end of [0, k0] that no aligned copy covers are loaded by
// the warp's lanes (plain loads: a bulk copy rounded out to 16 bytes would
// read outside the range, and past the tensor's end for the last pair) and
// stored into their slot before its barrier's second arrival, which comes
// after the next chunk's issue, so that the top chunk waits on nothing else.
// Where every chunk the range may touch fits the ring (planes under ~124 KB;
// the main path's are 28.5 and 83 KB), the ring holds all of it and no slot
// is reused. Otherwise (WRAP) a power of two of slots is reused in order: a
// chunk is copied only after the walker has left the slot's previous chunk
// (it publishes how many chunks from the top it is done with) and that
// chunk's copy has landed; the walker waits on every chunk in order, so no
// mbarrier wait is ever more than one phase behind. The walker (thread 0)
// steps by one shared-memory load and two multiply-adds (dense_step), four
// steps a turn and one test, the next turn's first load issued before it.
// A turn starts only where its steps stay on rows that have landed, off row
// 0, and counts only if its four pointers are 0, 1 or 2 and its cells lie
// off column 0 (y is tracked beside k, off the chain). Anything else (a
// move clamped at row 0 or column 0, a pointer that does not move, the
// origin, rows not landed yet, which are probed again first) is one step,
// clamped as the plain version is. The walk stops at the first cell that
// does not move; the walker records each visited cell in shared memory (in
// xs where the walk could outrun DWALK_MAX_RECORDS), and the whole block
// then writes xs, ys (a division a step), vs (from the ring, or from device
// memory where slots were reused) and the tail of repeats of the last cell,
// coalesced. Every wait traps after ~17 s. The ring's geometry is
// dense_walk_plan's, which the launch calls (its Python copy
// ops/traceback_cuda.py::dense_walk_plan serves the tests where nvcc is not
// at hand); the wrapper calls it first and raises where it refuses.
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

#define DWALK_THREADS 256        // the walker's warp, the copier's warp, six more for the write-out
#define DWALK_CHUNK_SHIFT 12     // a chunk: 4096 bytes of the plane, aligned in absolute address
#define DWALK_MAX_SLOTS 32       // the ring's most: 128 KB
#define DWALK_GUARD 256          // bytes after the records: a turn's loads on corrupt pointers
#define DWALK_MAX_RECORDS 16384  // records in shared memory (64 KB); a longer walk's go to xs
#define DWALK_STATIC_SMEM 1024   // the kernel's static shared memory, rounded up

namespace {

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

// mbarriers of the dense walk's ring (shared addresses)
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// whether the barrier's phase of this parity has completed: test_wait does
// not block, try_wait may wait a while for it
template <bool BLOCKING>
__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
    unsigned done;
    if (BLOCKING)
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
        asm volatile("{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    long long since = 0;
    while (!mbar_done<true>(bar, parity)) watchdog(since);
}

// one 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, unsigned long long src, unsigned bytes,
                                          unsigned bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The dense walk's step from coordinate x by pointer v: x - 1 (v = 1, left),
// x - C - 1 (v = 0, diag), x - C (v = 2, up), as
// x - C - 1 + v C + (v >> 1) K, K = 1 - 2C: two dependent multiply-adds after
// the load lands (the shift runs beside the first; x - C - 1 is ready
// before). Any other pointer, which the caller rejects, moves the coordinate
// by m - C - 1 (v = 2m) or m - 1 (v = 2m + 1): at most C + 65 down and 62 up.
// In PTX, so that the compiler does not re-associate x - C - 1 onto the chain.
__device__ __forceinline__ int dense_step(int x, int v, int C, int K) {
    int r;
    asm("{\n.reg .s32 t, h;\n"
        "mad.lo.s32 t, %1, %2, %3;\n"
        "shr.s32 h, %1, 1;\n"
        "mad.lo.s32 %0, h, %4, t;\n}"
        : "=r"(r) : "r"(v), "r"(C), "r"(x - C - 1), "r"(K));
    return r;
}

#ifdef DWALK_CLOCKS
// Measurement builds only (chip_smoke.py --ablation): per block, clock64 at
// the kernel's start, after the barriers' set-up, when the walker's first
// chunk has landed, at the walk's end, after the copier's drain and after the
// write-out; then the walk's records, turns of four and single steps; then
// clock64 when the copier has issued the top chunk and when it has completed
// it (its second arrival).
#define DWALK_CLOCK_BLOCKS 64
#define DWALK_CLOCK_VALUES 11
__device__ long long dwalk_clocks[DWALK_CLOCK_BLOCKS][DWALK_CLOCK_VALUES];
#define DWALK_CLOCK(i, v) \
    if (blockIdx.x < DWALK_CLOCK_BLOCKS) dwalk_clocks[blockIdx.x][i] = (v)
#define DWALK_COUNT(c) ++c
#else
#define DWALK_CLOCK(i, v)
#define DWALK_COUNT(c)
#endif

template <bool WRAP, bool SREC>
__global__ void __launch_bounds__(DWALK_THREADS) dense_walk_kernel(
    const int8_t* __restrict__ bp,     // (P, N + 1, M + 1)
    const int* __restrict__ x_sizes,   // (P,)
    const int* __restrict__ y_sizes,   // (P,)
    int N, int M, int slots, int rec_cap,  // SREC: rec_cap records in shared memory, else none
    int* __restrict__ xs,              // (P, N + M + 1); the walker's records first where !SREC
    int* __restrict__ ys,              // (P, N + M + 1)
    int8_t* __restrict__ vs)           // (P, N + M + 1)
{
    extern __shared__ __align__(128) int8_t dring[];  // slots chunks, then rec_cap records
    __shared__ unsigned long long bars[DWALK_MAX_SLOTS];
    __shared__ int released;            // (WRAP) chunks from the top the walker is done with
    __shared__ int s_n, s_end, s_v;

    const int p = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int C = M + 1, steps = N + M + 1, CH = 1 << DWALK_CHUNK_SHIFT;
    const long long plane = (long long)(N + 1) * C;
    const int k0 = min(max(x_sizes[p], 0), N) * C + min(max(y_sizes[p], 0), M);
    // absolute addresses: the pair's plane from lo_abs, the walk's range up to hi_abs (one past
    // k0); a byte's place s = its address - base, and s = koff + k
    const unsigned long long lo_abs = (unsigned long long)bp + (unsigned long long)p * plane;
    const unsigned long long hi_abs = lo_abs + k0 + 1;
    const unsigned long long base = lo_abs & ~(unsigned long long)(CH - 1);
    const int koff = (int)(lo_abs - base);
    const int j_top = (koff + k0) >> DWALK_CHUNK_SHIFT;  // chunk j holds s in [j CH, (j + 1) CH)
    const int mask = WRAP ? slots * CH - 1 : -1;          // a ring offset is s & mask
    const unsigned ring_s = smem_addr(dring);
    // the walker's coordinate of a byte: its shared address (s & mask in a reused ring)
    const int xoff = WRAP ? 0 : (int)ring_s;
    const size_t obase = (size_t)p * steps;
    int* recs = SREC ? reinterpret_cast<int*>(dring + (size_t)slots * CH) : xs + obase;
    if (tid == 0) {
        DWALK_CLOCK(0, clock64());
        for (int i = 0; i < slots; ++i) mbar_init(smem_addr(&bars[i]), 2);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        released = 0;
    }
    __syncthreads();
    if (tid == 0) DWALK_CLOCK(1, clock64());
    // the phase of chunk j's slot that holds it: chunks go into slots from the top, in order
    auto parity = [&](int j) { return (unsigned)((j_top - j) / slots) & 1u; };
    auto bar = [&](int j) { return smem_addr(&bars[WRAP ? j & (slots - 1) : j]); };

    if (warp == 1) {
        // the copier. A bulk copy takes [lo_al, hi_al); the head below lo_al (in chunk 0) and the
        // tail from max(hi_al, lo_al) (in chunk j_top) take a lane a byte, loaded now. A chunk is
        // issued (lane 0: the first arrival, with its bytes, and the bulk copy), then completed
        // (its edge bytes stored, the second arrival) after the next chunk's issue: the top
        // chunk lands without waiting on the tail's load or on the arrivals of the rest
        const unsigned long long lo_al = (lo_abs + 15) & ~15ULL, hi_al = hi_abs & ~15ULL;
        const unsigned long long ea = lane < 16 ? lo_abs + lane : max(hi_al, lo_al) + lane - 16;
        const bool edge = ea < (lane < 16 ? min(lo_al, hi_abs) : hi_abs);
        const int edge_j = lane < 16 ? 0 : j_top;
        const int8_t edge_v = edge ? *reinterpret_cast<const int8_t*>(ea) : 0;
        auto complete = [&](int jc) {
            if (jc == edge_j && edge) dring[(int)(ea - base) & mask] = edge_v;
            __syncwarp();
            if (lane == 0) mbar_arrive(bar(jc));
            if (lane == 0 && jc == j_top) DWALK_CLOCK(10, clock64());
        };
        int j = j_top;
        for (; j >= 0; --j) {
            int stop = 0;
            if (lane == 0) {
                if (WRAP && j + slots <= j_top) {
                    // the slot's previous chunk j + slots: left by the walker, and landed
                    int rel;
                    long long since = 0;
                    while ((rel = ld_acquire(&released)) <= j_top - j - slots && rel < WALK_STOP) {
                        __nanosleep(100);
                        watchdog(since);
                    }
                    stop = rel >= WALK_STOP;
                    if (!stop) mbar_wait(bar(j + slots), parity(j + slots));
                }
                if (!stop) {
                    const unsigned long long c0 =
                        base + ((unsigned long long)j << DWALK_CHUNK_SHIFT);
                    const unsigned long long b0 = max(c0, lo_al), b1 = min(c0 + CH, hi_al);
                    const unsigned n = b1 > b0 ? (unsigned)(b1 - b0) : 0u;
                    mbar_arrive_tx(bar(j), n);
                    if (n) bulk_load(ring_s + ((int)(b0 - base) & mask), b0, n, bar(j));
                    if (j == j_top) DWALK_CLOCK(9, clock64());
                }
            }
            if (__shfl_sync(0xffffffffu, stop, 0)) break;
            if (j < j_top) complete(j + 1);
        }
        if (j + 1 <= j_top) complete(j + 1);
        // every copy lands before the block may exit: the last chunk issued in each slot
        if (lane == 0)
            for (int i = j + 1; i <= min(j + slots, j_top); ++i) mbar_wait(bar(i), parity(i));
    } else if (tid == 0) {
        // the walker
        auto load = [&](int x) {
            int v;
            const unsigned a = WRAP ? ring_s + (unsigned)(x & mask) : (unsigned)x;
            asm volatile("ld.shared.s8 %0, [%1];" : "=r"(v) : "r"(a));
            return v;
        };
        // a record: a shared-memory store by its own address, or a store into xs
        const unsigned rec_s = ring_s + slots * CH;
        auto record = [&](int i, int value) {
            if (SREC)
                asm volatile("st.shared.s32 [%0], %1;" ::"r"(rec_s + 4 * i), "r"(value)
                             : "memory");
            else
                recs[i] = value;
        };
        const int row1 = xoff + koff + C;  // the lowest coordinate off row 0
        const int cap = SREC ? rec_cap : steps, K = 1 - 2 * C;
        int x = xoff + koff + k0, y = min(max(y_sizes[p], 0), M), n = 0, v;
        int jc = j_top + 1, jlo, lo, lo_fast;
        // lo: the lowest landed coordinate, the base of chunk jlo; a turn of four starts at
        // lo_fast or above: three steps of at most C + 65 down stay on landed rows off row 0,
        // and the fourth successor, loaded before the turn's test, lies at most 65 bytes below
        // the ring (in the kernel's static shared memory, which precedes it)
        auto set_lo = [&](int j) {
            jlo = j;
            lo = xoff + (j << DWALK_CHUNK_SHIFT);
            lo_fast = max(lo, row1) + 3 * (C + 65);
        };
        // (a ring not reused) lower lo over the chunks below it that have landed
        auto probe = [&]() {
            int j = jlo;
            while (j > 0 && mbar_done<false>(bar(j - 1), 0)) --j;
            set_lo(j);
        };
        // make the chunk of coordinate xt ready
        auto reach = [&](int xt) {
            const int j = (xt - xoff) >> DWALK_CHUNK_SHIFT;
            if (WRAP) {
                st_release(&released, j_top - j);
                for (int i = jc - 1; i >= j; --i) mbar_wait(bar(i), parity(i));
                jc = j;
                set_lo(j);
            } else {
                mbar_wait(bar(j), 0);
                set_lo(j);
                probe();
            }
        };
        reach(x);
        DWALK_CLOCK(2, clock64());
        [[maybe_unused]] long long turns = 0, singles = 0;
        for (;;) {
            if (x >= lo_fast && n + 4 <= cap) {
                // four steps a turn, one test; the next turn's first load is issued before the
                // test, so that no branch stands between two loads of the chain
                int v0 = load(x);
                for (;;) {
                    // the tests run beside the chain, each pointer's as soon as it lands
                    const int x1 = dense_step(x, v0, C, K);
                    const int v1 = load(x1);
                    bool bad = (unsigned)v0 > 2u;
                    int y3 = y - (v0 != 2);
                    const int x2 = dense_step(x1, v1, C, K);
                    const int v2 = load(x2);
                    bad |= (unsigned)v1 > 2u;
                    y3 -= v1 != 2;
                    const int x3 = dense_step(x2, v2, C, K);
                    const int v3 = load(x3);
                    bad |= (unsigned)v2 > 2u;
                    y3 -= v2 != 2;
                    const int x4 = dense_step(x3, v3, C, K);
                    // up to 4 x 62 bytes over the ring's top on corrupt pointers: the records and
                    // the guard are there
                    const int v4 = load(x4);
                    bad |= (unsigned)v3 > 2u;
                    record(n, x);
                    record(n + 1, x1);
                    record(n + 2, x2);
                    record(n + 3, x3);
                    if (bad || y3 <= 0) break;  // from x again, a step at a time
                    n += 4;
                    x = x4;
                    y = y3 - (v3 != 2);
                    DWALK_COUNT(turns);
                    if (x < lo_fast || n + 4 > cap) break;
                    v0 = v4;
                }
            }
            // one step, clamped at row 0 and column 0; first, where the turn was refused for
            // want of landed rows, the rows that have landed since
            if (!WRAP && x < lo_fast && jlo > 0) {
                probe();
                if (x >= lo_fast) continue;
            }
            if (x < lo) reach(x);
            v = load(x);
            record(n++, x);
            DWALK_COUNT(singles);
            const int dx = x >= row1 && (v == 0 || v == 2) ? C : 0;
            const int dy = y > 0 && (v == 0 || v == 1) ? 1 : 0;
            if (dx + dy == 0) break;  // the origin, or a cell that does not move
            x -= dx + dy;
            y -= dy;
        }
        if (WRAP) st_release(&released, WALK_STOP);
        DWALK_CLOCK(3, clock64());
        DWALK_CLOCK(6, n);
        DWALK_CLOCK(7, turns);
        DWALK_CLOCK(8, singles);
        s_n = n;
        s_end = x - xoff;
        s_v = v;
    }
    __syncthreads();
    if (tid == 0) DWALK_CLOCK(4, clock64());

    // the recorded cells, then the tail of repeats of the last
    const int n = s_n, k_end = s_end - koff, x_end = k_end / C;
    const int8_t* bp_p = bp + (size_t)p * plane;
    for (int i = tid; i < steps; i += blockDim.x) {
        int xx = x_end, yy = k_end - x_end * C, vv = s_v;
        if (i < n) {
            const int s = recs[i] - xoff, k = s - koff;
            xx = k / C;
            yy = k - xx * C;
            vv = WRAP ? bp_p[k] : dring[s];
        }
        xs[obase + i] = xx;
        ys[obase + i] = yy;
        vs[obase + i] = (int8_t)vv;
    }
#ifdef DWALK_CLOCKS
    __syncthreads();
    if (tid == 0) DWALK_CLOCK(5, clock64());
#endif
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

// Makes `device` current for the scope of a launch where it is not, and
// restores the caller's device after it.
struct DeviceScope {
    int prev = -1, dev;
    explicit DeviceScope(int d) : dev(d) {
        if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
        if (prev != dev) cudaSetDevice(dev);
    }
    ~DeviceScope() {
        if (prev >= 0 && prev != dev) cudaSetDevice(prev);
    }
};

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

// The dense walk's ring for planes of (N + 1) x (M + 1) bytes: fills plan[0..3]
// with slots (chunks of 1 << DWALK_CHUNK_SHIFT bytes in the ring), wrap (1 where
// slots are reused: a power of two of them, DWALK_MAX_SLOTS), the bytes of
// dynamic shared memory (the ring, the records, DWALK_GUARD) and records (room for the
// walk's records in shared memory: N + M + 4 rounded up to 4, for the N + M + 1
// steps and the three a turn of four may overrun; 0 where that is over
// DWALK_MAX_RECORDS, and the walk records into xs). A pair's [0, k0] touches at
// most (plane + CH - 2) / CH + 1 chunks (its plane starts anywhere in its first
// chunk); the ring holds that many where it is at most DWALK_MAX_SLOTS. Returns
// 0, or 1 where a side is negative, the ring, the records and the static shared
// memory do not fit smem_optin bytes, or the walker's coordinates do not fit 31
// bits.
int dense_walk_plan(int N, int M, int smem_optin, int* plan) {
    const long long C = (long long)M + 1, plane = ((long long)N + 1) * C;
    const long long steps = (long long)N + M + 1, chunk = 1LL << DWALK_CHUNK_SHIFT;
    const long long need = (plane + chunk - 2) / chunk + 1;
    const int wrap = need > DWALK_MAX_SLOTS;
    const long long slots = wrap ? DWALK_MAX_SLOTS : need;
    const long long records = steps + 3 <= DWALK_MAX_RECORDS ? (steps + 6) & ~3LL : 0;
    const long long bytes = slots * chunk + 4 * records + DWALK_GUARD;
    plan[0] = (int)slots;
    plan[1] = wrap;
    plan[2] = bytes < INT32_MAX ? (int)bytes : INT32_MAX;
    plan[3] = (int)records;
    if (N < 0 || M < 0) return 1;
    if (bytes + DWALK_STATIC_SMEM > smem_optin) return 1;
    // a coordinate: a shared address (under 2^18) or a chunk offset, plus k, plus four rows
    if (plane + chunk + 4 * C + (1LL << 18) > INT32_MAX) return 1;
    return 0;
}

// Walk the dense planes of P pairs on `stream` of `device`. Returns the CUDA
// error code of the launch (0 on success); cudaErrorInvalidValue where
// dense_walk_plan refuses the shape.
int dense_walk_launch(const int8_t* bp, const int* x_sizes, const int* y_sizes, int P, int N,
                      int M, int smem_optin, int device, int* xs, int* ys, int8_t* vs,
                      void* stream) {
    int plan[4];
    if (dense_walk_plan(N, M, smem_optin, plan) != 0) return (int)cudaErrorInvalidValue;
    DeviceScope scope(device);
    const size_t smem = (size_t)plan[2];
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    auto kernel = plan[1]
        ? (plan[3] ? dense_walk_kernel<true, true> : dense_walk_kernel<true, false>)
        : (plan[3] ? dense_walk_kernel<false, true> : dense_walk_kernel<false, false>);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<P, DWALK_THREADS, smem, st>>>(bp, x_sizes, y_sizes, N, M, plan[0], plan[3], xs, ys,
                                           vs);
    return (int)cudaGetLastError();
}

#ifdef DWALK_CLOCKS
// Measurement builds only: copies the first `blocks` blocks' clocks of the
// last dense walk (DWALK_CLOCK_VALUES a block, see dwalk_clocks) to `out` on
// the host.
int dense_walk_clocks(long long* out, int blocks) {
    return (int)cudaMemcpyFromSymbol(
        out, dwalk_clocks,
        sizeof(long long) * DWALK_CLOCK_VALUES * min(blocks, DWALK_CLOCK_BLOCKS));
}
#endif

// Walk the banded planes of P pairs on `stream` of `device`; bp_int8 tells the type of
// xp, yp, xps and yps (int8, else int32). Returns the CUDA error code of
// the launch (0 on success); cudaErrorInvalidValue where banded_walk_plan
// refuses the shape.
int banded_walk_launch(const float* csum, const void* xp, const void* yp,
                       const int* boff_out, const int* x_sizes, const int* y_sizes,
                       int P, int A2, int B, int bp_int8, int smem_optin, int device,
                       int* xs, int* ys, void* xps, void* yps, float* cs, void* stream) {
    int plan[5];
    if (banded_walk_plan(A2, B, smem_optin, plan) != 0) return (int)cudaErrorInvalidValue;
    DeviceScope scope(device);
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
