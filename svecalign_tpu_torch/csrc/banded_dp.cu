// Banded wavefront DP for P document pairs in one launch, for sm_90a.
//
// Replaces the TPU kernel svecalign_tpu/ops/dp_pallas.py::
// banded_dp_pallas_batched and computes exactly what it computes (the
// plain version is svecalign_tpu_torch/ops/dp.py::banded_dp_batched).
// Rotated coordinates: a = x + y, b = y - boff_out[a]. For anti-diagonal
// a, band lane b and type t (the given types, then (0,1), then (1,0)):
//
//   cand_t = ring[a - span_t][b + boff_out[a] - yo_t - boff_out[a - span_t]]
//            + (t < T ? cost[t, a - 2, b] : pen)
//
// masked to +inf where the cell or its predecessor leaves the document,
// minimised with a strict '<' in type order (first minimum wins), then the
// x = 0 column and y = 0 row are overridden with pen * y and pen * x.
//
// What bounds it: A + 2 dependent steps, each moving a few hundred bytes,
// so latency and not bandwidth (the bytes of one pair at the stage-5.4
// defaults are ~2.5 MB, under a microsecond at 3.35 TB/s). Only the csum
// values depend on earlier steps; costs, offsets and types are known
// before the first step. Two kernels, picked by shape in ops/dp_cuda.py:
//
// banded_dp_warp_kernel (B <= 32): one warp per pair, one CTA per warp,
// lane b owns band lane b, so a step's barrier is a __syncwarp() and a
// bucket of pairs spreads over the SMs (32 resident CTAs each). Every load
// is taken off the dependent chain: the T cost rows of a step are copied
// into a ring of DP_STAGES stages in shared memory by cp.async,
// DP_STAGES - 1 steps before the wavefront reads them (one commit group
// per step, empty where a step has no cost row), the pair's A + 2 node
// offsets and the type table are loaded into shared memory once, and the
// loop over anti-diagonals makes no global load. What is left per step is
// one shared-memory write -> barrier -> read round trip, an add and a
// minimum over the types (see the kernel for how the type loop is kept
// free of tests and dependent loads).
//
// banded_dp_kernel (any B): one CTA per pair, threads across band lanes
// (looping when B exceeds the block), costs and offsets read from global
// memory as each step needs them, one __syncthreads() per anti-diagonal.
//
// Both keep the last K + 1 csum rows in a ring in shared memory (the block
// kernel in global scratch when it does not fit). The ring has K + 1 rows,
// not K, so the row written at step a is never one that step a reads, and
// one barrier per step separates the writes of a from the reads of a + 1.
// Each ring row holds the B band lanes between K lanes of +inf on either
// side: boff_out steps by 0 or 1, so |shift| <= K and the shifted read
// needs no branch.
//
// Exactness: each candidate is one fp32 add (__fadd_rn), each edge value one
// fp32 multiply (__fmul_rn), so nothing can be contracted into an FMA and
// the result equals the JAX scan, the Pallas kernel and the torch loop bit
// for bit.
//
// Plain C interface, bound from Python with ctypes (ops/dp_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NEG_BP = -42;

template <typename BP>
__global__ void banded_dp_kernel(
    const float* __restrict__ costs,     // (P, T, A, B)
    const int* __restrict__ boff_out,    // (P, A + 2)
    const float* __restrict__ pens,      // (P,)
    const int* __restrict__ x_in_size,   // (P,)
    const int* __restrict__ y_in_size,   // (P,)
    const int* __restrict__ type_off,    // (2, n_types): xo then yo
    int n_types, int T, int A, int B, int K,
    float* __restrict__ csum,            // (P, A + 2, B)
    BP* __restrict__ xp_out,             // (P, A + 2, B)
    BP* __restrict__ yp_out,             // (P, A + 2, B)
    float* __restrict__ ring_global)     // (P, K + 1, B + 2K) or null
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* s_xo = reinterpret_cast<int*>(smem_raw);
    int* s_yo = s_xo + n_types;
    float* ring;
    const int W = B + 2 * K;
    const int ring_rows = K + 1;
    const int p = blockIdx.x;
    if (ring_global != nullptr) {
        ring = ring_global + (size_t)p * ring_rows * W;
    } else {
        ring = reinterpret_cast<float*>(s_yo + n_types);
    }

    for (int i = threadIdx.x; i < n_types; i += blockDim.x) {
        s_xo[i] = type_off[i];
        s_yo[i] = type_off[n_types + i];
    }
    for (int i = threadIdx.x; i < ring_rows * W; i += blockDim.x) {
        ring[i] = CUDART_INF_F;
    }
    __syncthreads();

    const int a2 = A + 2;
    const int x_in = x_in_size[p];
    const int y_in = y_in_size[p];
    const int x_out = x_in + 1;
    const int y_out = y_in + 1;
    const float pen = pens[p];
    const int* boff = boff_out + (size_t)p * a2;
    const float* cost_p = costs + (size_t)p * T * A * B;
    float* csum_p = csum + (size_t)p * a2 * B;
    BP* xp_p = xp_out + (size_t)p * a2 * B;
    BP* yp_p = yp_out + (size_t)p * a2 * B;

    for (int aa = 0; aa < a2; ++aa) {
        const int boff_a = __ldg(boff + aa);
        float* ring_out = ring + (aa % ring_rows) * W + K;
        for (int b = threadIdx.x; b < B; b += blockDim.x) {
            const int yy = boff_a + b;
            const int xx = aa - yy;
            const bool cell_ok =
                xx - 1 >= 0 && xx - 1 < x_in && yy - 1 >= 0 && yy - 1 < y_in;
            float best = CUDART_INF_F;
            int bxp = NEG_BP;
            int byp = NEG_BP;
            for (int t = 0; t < n_types; ++t) {
                const int xo = s_xo[t];
                const int yo = s_yo[t];
                const int s = xo + yo;
                const int xpv = xx - xo;
                const int ypv = yy - yo;
                const bool valid = cell_ok && aa >= s && xpv >= 0 && xpv < x_out &&
                                   ypv >= 0 && ypv < y_out;
                if (!valid) continue;  // cand = +inf never beats best
                const int prev_a = aa - s;
                int shift = boff_a - yo - __ldg(boff + prev_a);
                shift = max(-K, min(K, shift));  // memory safety on bad offsets
                const float prev = ring[(prev_a % ring_rows) * W + K + b + shift];
                // cost rows exist for 2 <= aa < A + 2 only
                const float cost = t >= T ? pen
                    : aa >= 2 ? __ldg(cost_p + ((size_t)t * A + (aa - 2)) * B + b)
                    : CUDART_INF_F;
                const float cand = __fadd_rn(prev, cost);
                if (cand < best) {  // strict: first minimum wins
                    best = cand;
                    bxp = xo;
                    byp = yo;
                }
            }
            if (!(best < CUDART_INF_F)) {  // unreachable: +inf / NEG_BP
                best = CUDART_INF_F;
                bxp = NEG_BP;
                byp = NEG_BP;
            }
            const bool edge_y = xx == 0 && yy >= 0 && yy < y_out;
            const bool edge_x = !edge_y && yy == 0 && xx >= 0 && xx < x_out;
            if (edge_y) {
                best = __fmul_rn(pen, (float)yy);
                bxp = 0;
                byp = 1;
            }
            if (edge_x) {
                best = __fmul_rn(pen, (float)xx);
                bxp = 1;
                byp = 0;
            }
            ring_out[b] = best;
            const size_t o = (size_t)aa * B + b;
            csum_p[o] = best;
            xp_p[o] = (BP)bxp;
            yp_p[o] = (BP)byp;
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// The warp route
// ---------------------------------------------------------------------------

constexpr int WARP = 32;
// Cost stages in flight. A step's rows are requested DP_STAGES - 1 steps
// ahead and must have landed one step before they are used: at 0.2-0.5 us
// a step that is a few microseconds, several DRAM round trips.
// ops/dp_cuda.py::WARP_STAGES mirrors it.
constexpr int DP_STAGES = 16;
static_assert((DP_STAGES & (DP_STAGES - 1)) == 0 && DP_STAGES >= 4, "power of two");

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    if constexpr (BYTES == 16) {  // streamed once: past L1
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The minimum takes the types four at a time, and where two band rows fit
// one warp (2 B <= 32) the types are split over its two halves: lanes
// [0, B) take the first half of the types and lanes [B, 2B) the second, for
// the same band lane, and one shuffle merges them. So the types are padded
// to a multiple of 4 per half.
constexpr int QUAD = 4;
// Ring offsets are computed a batch of WARP steps at a time, lane l for
// step base + l, and kept for two batches.
constexpr int OFFSET_STEPS = 2 * WARP;

__host__ __device__ constexpr int lane_groups(int B) { return 2 * B <= WARP ? 2 : 1; }

__host__ __device__ constexpr int padded_types(int n_types, int B) {
    const int m = QUAD * lane_groups(B);
    return (n_types + m - 1) / m * m;
}

// The first minimum of two (value, tag) candidates: b, the later one in
// type order, wins only if it is strictly smaller.
__device__ __forceinline__ void first_min(float& va, int& ta, float vb, int tb) {
    const bool later = vb < va;
    va = later ? vb : va;
    ta = later ? tb : ta;
}

// First minimum over 4 * NQ contiguous types, unrolled: r holds their
// (ring offset, tag) pairs, two to an int4, c their costs, rng is the ring
// at this band lane. Every ring load is issued before the first use, and
// the minimum is a tree over contiguous ranges in which the lower range
// wins ties, which is the first minimum of a scan in type order.
template <int NQ>
__device__ __forceinline__ void min_unrolled(const int4 (&r)[2 * NQ], const float (&c)[QUAD * NQ],
                                             const float* rng, float& best, int& btag) {
    float v[QUAD * NQ];
    int tg[QUAD * NQ];
#pragma unroll
    for (int i = 0; i < 2 * NQ; ++i) {
        v[2 * i] = __fadd_rn(rng[r[i].x], c[2 * i]);
        tg[2 * i] = r[i].y;
        v[2 * i + 1] = __fadd_rn(rng[r[i].z], c[2 * i + 1]);
        tg[2 * i + 1] = r[i].w;
    }
#pragma unroll
    for (int stride = 1; stride < QUAD * NQ; stride *= 2) {
#pragma unroll
        for (int i = 0; i + stride < QUAD * NQ; i += 2 * stride) {
            first_min(v[i], tg[i], v[i + stride], tg[i + stride]);
        }
    }
    best = v[0];
    btag = tg[0];
}

// The same over any number nq of quads, as a loop: the pairs start at rp,
// the cost rows at cst, B floats apart.
__device__ __forceinline__ void min_loop(const int4* rp, const float* rng, const float* cst,
                                         int B, int nq, float& best, int& btag) {
    best = CUDART_INF_F;
    btag = 0;
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
        const int4 r01 = rp[2 * q];      // (roff, tag) of two types
        const int4 r23 = rp[2 * q + 1];  // and of the next two
        const float* cq = cst + QUAD * q * B;
        float c0 = __fadd_rn(rng[r01.x], cq[0]);
        const float c1 = __fadd_rn(rng[r01.z], cq[B]);
        float c2 = __fadd_rn(rng[r23.x], cq[2 * B]);
        const float c3 = __fadd_rn(rng[r23.z], cq[3 * B]);
        int t0 = r01.y;
        int t2 = r23.y;
        first_min(c0, t0, c1, r01.w);
        first_min(c2, t2, c3, r23.w);
        first_min(c0, t0, c2, t2);
        first_min(best, btag, c0, t0);
    }
}

// What a step does, with n_types padded to NTP:
//
//   cand_t = ring[roff_t + b] + stage[t * B + b]      for t < NTP
//
// and nothing else per type: no test, no branch, no address arithmetic
// that depends on another load. That takes three things.
// - Validity is in the data. A predecessor outside the document holds +inf
//   in the ring (a cell outside the node grid is never written with
//   anything else, a lane outside the band is the row's +inf padding, a row
//   before the first is still as initialised), and +inf + cost is +inf, which
//   never beats `best` under the strict '<'. So the per-type test of the
//   predecessor's coordinates is dropped; the cell's own (cell_ok) is
//   applied once after the minimum. No input makes a NaN: costs are finite
//   or +inf.
// - The ring offset roff_t = ((a - s_t) % R) * W + K + shift_t is the same
//   for every lane, and depends on the offsets and the types alone, not on
//   earlier steps. So every 32 steps the lanes compute it for the 32 steps
//   after the next 32, lane l for one step and all its types, and leave it
//   in shared memory beside each type's packed (xo, yo) tag: about ten
//   instructions a step, against forty when each step computed the next
//   one's.
// - In the unrolled kernels (NQ > 0) a step's operands, the (roff, tag)
//   pairs and the costs of the lane's types, are loaded into registers at
//   the end of the step before: both are published early enough for that
//   (the offsets as above; the cost stage because each lane waits for its
//   copies of step a + 1 before the barrier of step a). What is left
//   between the barrier and the ring write is the ring loads, the adds, the
//   minimum and a few selects.
// - The two deletion types read their cost, pen, from rows T and T + 1 of
//   every stage, written once at set-up, so they are types like any other;
//   the padding types read row R of the ring, all +inf, never written.
//   Stages 0 and 1 start as +inf: steps 0 and 1 have no cost row.
// One warp has little to overlap a dependent instruction or a taken branch
// with, so the step is kept short and straight: pointers advance by B a
// step, the lane's band offset is carried from the step before, the copy
// loop has the same trip count on every lane, and the lanes past the band
// run the whole step on lane 0's addresses and only skip the stores.
//
// CPB: bytes per asynchronous copy, 16 where B % 4 == 0 and costs is
// 16-byte aligned (every cost row then is), else 4. NQ: quads of types per
// lane group, unrolled, or 0 for any number.
template <typename BP, int CPB, int NQ>
__global__ void __launch_bounds__(WARP) banded_dp_warp_kernel(
    const float* __restrict__ costs,     // (P, T, A, B)
    const int* __restrict__ boff_out,    // (P, A + 2)
    const float* __restrict__ pens,      // (P,)
    const int* __restrict__ x_in_size,   // (P,)
    const int* __restrict__ y_in_size,   // (P,)
    const int* __restrict__ type_off,    // (2, n_types): xo then yo
    int n_types, int T, int A, int B, int K,
    float* __restrict__ csum,            // (P, A + 2, B)
    BP* __restrict__ xp_out,             // (P, A + 2, B)
    BP* __restrict__ yp_out)             // (P, A + 2, B)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x;
    const int p = blockIdx.x;
    const int W = B + 2 * K;
    const int R = K + 1;
    const int a2 = A + 2;
    const int G = lane_groups(B);
    const int NTP = padded_types(n_types, B);
    const int nq = NTP / G / QUAD;  // quads of types per lane group
    const int stage_floats = NTP * B;
    // layout: cost stages | csum ring (R rows + one of +inf) | node offsets
    // | types | ring offsets and tags of OFFSET_STEPS steps (16-byte segments)
    float* s_cost = reinterpret_cast<float*>(smem_raw);
    float* ring = reinterpret_cast<float*>(
        smem_raw + round16((size_t)DP_STAGES * stage_floats * sizeof(float)));
    int* s_boff = reinterpret_cast<int*>(
        reinterpret_cast<unsigned char*>(ring) + round16((size_t)(R + 1) * W * sizeof(float)));
    int2* s_ty = reinterpret_cast<int2*>(  // [NTP]: (xo, yo); padding types xo = -1
        reinterpret_cast<unsigned char*>(s_boff) + round16((size_t)a2 * sizeof(int)));
    int2* s_rp = s_ty + NTP;  // [OFFSET_STEPS][NTP]: (roff, xo | yo << 16)

    const int x_in = x_in_size[p];
    const int y_in = y_in_size[p];
    const int x_out = x_in + 1;
    const int y_out = y_in + 1;
    const float pen = pens[p];
    const float* cost_p = costs + (size_t)p * T * A * B;

    // Lane group g takes types [g * 4 nq, (g + 1) * 4 nq) of band lane b.
    // Lanes past the groups shadow lane 0.
    int g = lane / B;
    int b = lane - g * B;
    if (g >= G) g = b = 0;
    const bool writer = lane < B;
    float* csum_w = csum + (size_t)p * a2 * B + b;
    BP* xp_w = xp_out + (size_t)p * a2 * B + b;
    BP* yp_w = yp_out + (size_t)p * a2 * B + b;

    // Copies of one stage, spread over all 32 lanes: a cost row is cpr
    // copies, a pass of the warp covers rows_pp rows.
    constexpr int CPF = CPB / (int)sizeof(float);
    const int cpr = B / CPF;
    const int rows_pp = WARP / cpr;
    const int r_sub = lane / cpr;
    const int c_sub = lane - r_sub * cpr;
    const bool copier = r_sub < rows_pp;
    const int dst_lane = r_sub * B + c_sub * CPF;
    const size_t src_pass = (size_t)rows_pp * A * B;
    const int dst_pass = rows_pp * B;
    // the lane's first source of the next step to request; step 2 reads row 0
    const float* src_next = cost_p + (size_t)r_sub * A * B + c_sub * CPF;

    // Request the cost rows of anti-diagonal `step` (row step - 2 of each
    // type) into stage step % DP_STAGES, and commit one group for the step
    // whether or not it copies, so that group g is always step g's.
    // The first two passes are written out (the stage's T = 15 at B = 16
    // is two); the loop takes the rest.
    const int n_pass = (T + rows_pp - 1) / rows_pp;
    const bool copy0 = copier && r_sub < T;
    const bool copy1 = copier && r_sub + rows_pp < T;
    auto request = [&](int step) {
        if (step >= 2 && step < a2) {
            const float* src = src_next;
            float* dst = s_cost + (step & (DP_STAGES - 1)) * stage_floats + dst_lane;
            if (copy0) cp_async<CPB>(dst, src);
            if (copy1) cp_async<CPB>(dst + dst_pass, src + src_pass);
            if (n_pass > 2) {
                src += 2 * src_pass;
                dst += 2 * dst_pass;
#pragma unroll 1
                for (int t = r_sub + 2 * rows_pp; t < T; t += rows_pp) {
                    if (copier) cp_async<CPB>(dst, src);
                    src += src_pass;
                    dst += dst_pass;
                }
            }
            src_next += B;
        }
        cp_async_commit();
    };

    // Stages 0 and 1 serve steps 0 and 1 first, which have no cost row:
    // +inf there; the copies of steps 16 and 17 overwrite them later.
    for (int i = lane; i < 2 * stage_floats; i += WARP) {
        if (i % stage_floats < T * B) s_cost[i] = CUDART_INF_F;
    }
    // rows T.. of every stage: pen for the two deletions, 0 for the padding
    for (int i = lane; i < DP_STAGES * (NTP - T) * B; i += WARP) {
        const int d = i / ((NTP - T) * B);
        const int r = i - d * (NTP - T) * B;
        s_cost[d * stage_floats + T * B + r] = r < 2 * B ? pen : 0.0f;
    }
    for (int step = 0; step < DP_STAGES - 1; ++step) request(step);

    for (int i = lane; i < (R + 1) * W; i += WARP) ring[i] = CUDART_INF_F;
    const int* boff = boff_out + (size_t)p * a2;
    for (int i = lane; i < a2; i += WARP) s_boff[i] = boff[i];

    for (int i = lane; i < NTP; i += WARP) {
        s_ty[i] = i < n_types ? make_int2(type_off[i], type_off[n_types + i])
                              : make_int2(-1, 0);
    }
    __syncwarp();
    // Ring offsets and tags of steps base .. base + 31 (base a multiple of
    // 32), lane l for step base + l and all its types, into their slots of
    // s_rp.
    auto publish = [&](int base) {
        const int an = base + lane;
        const int bn = s_boff[min(an, a2 - 1)];
        const int am = an % R;  // the step's ring row
        int2* out = s_rp + (an & (OFFSET_STEPS - 1)) * NTP;
#pragma unroll 2
        for (int t = 0; t < NTP; ++t) {
            const int2 ty = s_ty[t];
            const int s = ty.x + ty.y;
            int row = am - s;  // (an - s) % R, as s <= K < R
            row += row < 0 ? R : 0;
            int shift = bn - ty.y - s_boff[min(max(an - s, 0), a2 - 1)];
            shift = max(-K, min(K, shift));  // memory safety on bad offsets
            out[t] = make_int2(ty.x < 0 ? R * W : row * W + K + shift, ty.x | (ty.y << 16));
        }
    };
    publish(0);
    publish(WARP);

    // A step's operands in registers (the unrolled kernels only).
    constexpr int NR = NQ > 0 ? 2 * NQ : 1;
    constexpr int NC = NQ > 0 ? QUAD * NQ : 1;
    int4 opr[NR];
    float opc[NC];
    const int group_first = g * nq * QUAD;  // the lane group's first type
    auto load_operands = [&](int step) {
        if constexpr (NQ > 0) {
            const int4* rp = reinterpret_cast<const int4*>(
                s_rp + (step & (OFFSET_STEPS - 1)) * NTP + group_first);
            const float* cst =
                s_cost + (step & (DP_STAGES - 1)) * stage_floats + group_first * B + b;
#pragma unroll
            for (int i = 0; i < NR; ++i) opr[i] = rp[i];
#pragma unroll
            for (int i = 0; i < NC; ++i) opc[i] = cst[i * B];
        }
    };
    // Step 0's operands: its stage is +inf and pen from the set-up stores,
    // its offsets were published above.
    __syncwarp();
    load_operands(0);

    int cur = 0;  // aa % R
    for (int aa = 0; aa < a2; ++aa) {
        // Groups 0 .. aa + DP_STAGES - 2 are committed; all but the newest
        // DP_STAGES - 3 complete means group aa + 1, the next step's, has
        // landed: it is read at the end of this step.
        cp_async_wait<DP_STAGES - 3>();
        // A lane's wait covers its own copies only. This barrier makes every
        // lane's copies of stage aa + 1, and the ring row and any offsets
        // written at step aa - 1, visible to all lanes, and it orders the
        // reads of step aa - 1 before what follows: the request below
        // overwrites stage (aa - 1) % DP_STAGES, publish (every 32 steps)
        // overwrites the offsets of steps aa - 32 .. aa - 1, and this step's
        // ring write lands in a row that step aa - 1 could still read only
        // if the ring had K rows (it has K + 1).
        __syncwarp();
        request(aa + DP_STAGES - 1);

        // what does not wait for the minimum
        const int yy = s_boff[aa] + b;
        const int xx = aa - yy;
        const bool cell_ok = (unsigned)(xx - 1) < (unsigned)x_in && (unsigned)(yy - 1) < (unsigned)y_in;
        const bool edge_y = xx == 0 && (unsigned)yy < (unsigned)y_out;
        const bool edge_x = !edge_y && yy == 0 && (unsigned)xx < (unsigned)x_out;
        const bool edge = edge_y || edge_x;
        const float edge_val = __fmul_rn(pen, (float)(edge_y ? yy : xx));

        float best;
        int btag;
        if constexpr (NQ > 0) {
            min_unrolled<NQ>(opr, opc, ring + b, best, btag);
        } else {
            min_loop(reinterpret_cast<const int4*>(
                         s_rp + (aa & (OFFSET_STEPS - 1)) * NTP + group_first), ring + b,
                     s_cost + (aa & (DP_STAGES - 1)) * stage_floats + group_first * B + b, B, nq,
                     best, btag);
        }
        if (G == 2) {  // the upper half of the types, from lane b + B
            const float other = __shfl_down_sync(0xffffffffu, best, B);
            const int other_tag = __shfl_down_sync(0xffffffffu, btag, B);
            first_min(best, btag, other, other_tag);
        }
        // unreachable: +inf / NEG_BP; then the x = 0 column (0, 1) and the
        // y = 0 row (1, 0)
        const bool reach = cell_ok && best < CUDART_INF_F;
        float val = reach ? best : CUDART_INF_F;
        int bxp = reach ? (btag & 0xffff) : NEG_BP;
        int byp = reach ? (btag >> 16) : NEG_BP;
        val = edge ? edge_val : val;
        bxp = edge ? (int)edge_x : bxp;
        byp = edge ? (int)edge_y : byp;
        if (writer) {
            ring[cur * W + K + b] = val;
            // fire and forget: nothing reads these back
            *csum_w = val;
            *xp_w = (BP)bxp;
            *yp_w = (BP)byp;
        }
        csum_w += B;
        xp_w += B;
        yp_w += B;
        load_operands(aa + 1);
        cur = cur + 1 == R ? 0 : cur + 1;
        // steps aa .. aa + 31 are published; now the 32 after them
        if ((aa & (WARP - 1)) == 0 && aa > 0) publish(aa + WARP);
    }
    cp_async_wait<0>();
}

size_t warp_smem_bytes(int B, int K, int T, int A, int n_types) {
    const int NTP = padded_types(n_types, B);
    return round16((size_t)DP_STAGES * NTP * B * sizeof(float)) +
           round16((size_t)(K + 2) * (B + 2 * K) * sizeof(float)) +
           round16((size_t)(A + 2) * sizeof(int)) +
           (size_t)(1 + OFFSET_STEPS) * NTP * sizeof(int2);
}

template <typename BP, int CPB, int NQ>
cudaError_t launch_warp(const float* costs, const int* boff_out, const float* pens,
                        const int* x_in_size, const int* y_in_size, const int* type_off,
                        int n_types, int T, int P, int A, int B, int K, float* csum,
                        void* xp, void* yp, size_t smem, cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(banded_dp_warp_kernel<BP, CPB, NQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    banded_dp_warp_kernel<BP, CPB, NQ><<<P, WARP, smem, st>>>(
        costs, boff_out, pens, x_in_size, y_in_size, type_off, n_types, T, A, B, K,
        csum, (BP*)xp, (BP*)yp);
    return cudaGetLastError();
}

// The unrolled kernels cover the quads of types per lane group that the
// stage's type sets give: T = 1 is 1, T = 15 is 3 at B <= 16 and 5 above.
// The loop kernel (NQ = 0) takes every other count.
template <typename BP, int CPB, typename... Args>
cudaError_t launch_warp_nq(int nq, Args... args) {
    switch (nq) {
        case 1: return launch_warp<BP, CPB, 1>(args...);
        case 3: return launch_warp<BP, CPB, 3>(args...);
        case 5: return launch_warp<BP, CPB, 5>(args...);
        default: return launch_warp<BP, CPB, 0>(args...);
    }
}

size_t ring_bytes(int B, int K) {
    return (size_t)(K + 1) * (B + 2 * K) * sizeof(float);
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt in to on this device.
int banded_dp_smem_optin(int device) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) != cudaSuccess) {
        return -1;
    }
    return v;
}

// Bytes of dynamic shared memory the kernel needs with the ring on chip.
size_t banded_dp_smem_bytes(int B, int K, int n_types) {
    return 2 * (size_t)n_types * sizeof(int) + ring_bytes(B, K);
}

// Launch on `stream`. ring_global is null to keep the ring in shared memory,
// else a (P, K + 1, B + 2K) float32 scratch buffer. Returns the CUDA error
// code of the launch (0 on success).
int banded_dp_launch(const float* costs, const int* boff_out, const float* pens,
                     const int* x_in_size, const int* y_in_size,
                     const int* type_off, int n_types, int T, int P, int A,
                     int B, int K, float* csum, void* xp, void* yp, int bp_int8,
                     float* ring_global, int threads, void* stream) {
    size_t smem = 2 * (size_t)n_types * sizeof(int);
    if (ring_global == nullptr) smem += ring_bytes(B, K);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bp_int8) {
        err = cudaFuncSetAttribute(banded_dp_kernel<int8_t>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        banded_dp_kernel<int8_t><<<P, threads, smem, st>>>(
            costs, boff_out, pens, x_in_size, y_in_size, type_off, n_types, T,
            A, B, K, csum, (int8_t*)xp, (int8_t*)yp, ring_global);
    } else {
        err = cudaFuncSetAttribute(banded_dp_kernel<int32_t>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        banded_dp_kernel<int32_t><<<P, threads, smem, st>>>(
            costs, boff_out, pens, x_in_size, y_in_size, type_off, n_types, T,
            A, B, K, csum, (int32_t*)xp, (int32_t*)yp, ring_global);
    }
    return (int)cudaGetLastError();
}

// The warp route (B <= 32): cost stages in flight, and the dynamic shared
// memory it needs; ops/dp_cuda.py mirrors both for its route rule.
int banded_dp_warp_stages() { return DP_STAGES; }

size_t banded_dp_warp_smem_bytes(int B, int K, int T, int A, int n_types) {
    return warp_smem_bytes(B, K, T, A, n_types);
}

// Launch the warp kernel on `stream`: one warp per pair. Returns the CUDA
// error code of the launch (0 on success, cudaErrorInvalidValue for a shape
// the route does not take: B > 32).
int banded_dp_warp_launch(const float* costs, const int* boff_out, const float* pens,
                          const int* x_in_size, const int* y_in_size,
                          const int* type_off, int n_types, int T, int P, int A,
                          int B, int K, float* csum, void* xp, void* yp, int bp_int8,
                          void* stream) {
    if (B < 1 || B > WARP || n_types != T + 2) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = warp_smem_bytes(B, K, T, A, n_types);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const bool wide = B % 4 == 0 && reinterpret_cast<uintptr_t>(costs) % 16 == 0;
    const int nq = padded_types(n_types, B) / lane_groups(B) / QUAD;
#define WARP_LAUNCH(BP, CPB)                                                          \
    launch_warp_nq<BP, CPB>(nq, costs, boff_out, pens, x_in_size, y_in_size, type_off, \
                            n_types, T, P, A, B, K, csum, xp, yp, smem, st)
    cudaError_t err;
    if (bp_int8) {
        err = wide ? WARP_LAUNCH(int8_t, 16) : WARP_LAUNCH(int8_t, 4);
    } else {
        err = wide ? WARP_LAUNCH(int32_t, 16) : WARP_LAUNCH(int32_t, 4);
    }
#undef WARP_LAUNCH
    return (int)err;
}

}  // extern "C"
