// Rel-key flash attention of the w2v-BERT trunk, for sm_90a.
//
// Replaces the TPU kernel svecalign_tpu/ops/attention_pallas.py::
// relkey_flash_attention (body _kernel) and computes what it computes (the
// plain version is svecalign_tpu_torch/ops/attention.py::relkey_attention):
//
//   out[b, l, h] = sum_r softmax_r(s[l, r]) v[b, r, h]
//   s[l, r]      = q[b, l, h] . k[b, r, h] * scale + p[b, l, h, clip(r - l, -left, right) + left]
//                  for r < lengths[b], else the finite NEG
//
// with scale = 1/sqrt(64) and p = (q . table^T) * scale, computed in fp32 and
// rounded to q's dtype, as the TPU kernel's caller computes it. q, k, v and
// the output are (B, T, H, 64), the projections' own layout, read in place
// (no transposes). Scores, the running max, the running sum and the
// accumulator are fp32; probabilities are rounded to v's dtype before the
// value product (the running sum takes them unrounded), and the output to
// q's dtype once, as the TPU kernel does.
//
// Two routes, one per dtype:
//
// bf16 (the main path): tensor cores and TMA. What bounds it: at the main
// path's shapes (B = 16, H = 16, T = 100-1000) it does 4 B H L^2 64
// operations on 4 B T H 64 elements; the least time is about even between
// the bytes and the bf16 tensor-core rate. But at head size 64 each score
// costs the ex2 unit (16 per clock per SM) as many cycles as its two
// products cost the tensor cores, plus a few ALU instructions (bias, mask,
// max, sum, rounding), and on the card the products and the softmax add up
// rather than overlap; the K/V loads hide behind them. The design answers
// with occupancy and a short softmax. One CTA per (64-row query tile, head,
// batch row): one consumer warpgroup and one producer warp, up to four CTAs
// per SM, so one CTA's loads, projection and epilogue overlap the others'
// products and softmax; on key tiles wholly outside the clip band the bias,
// the scale and the max fold into one FMA per score. The producer's one
// thread loads the query tile and the distance table by TMA, then keeps
// 64-key tiles of K and V in flight by TMA in a two-stage ring (mbarriers:
// full when the bytes land, empty when each consumer warp is done with a
// stage). The tensor maps are
// 4-D over the (B, T, H, 64) layout as it stands, box (64, 1, 64, 1),
// 128-byte swizzle, so each tile lands as 64 rows of 128 bytes in the
// layout wgmma's 128-byte-swizzle descriptors read, and rows past T come
// back as zeros. The warpgroup computes the projection p = (q . table^T) / 8
// with wgmma (fp32, rounded to bf16, kept in shared memory, so the wrapper
// makes no projection), then per key tile: S = Q K^T by wgmma (Q and K
// from shared memory, both K-major), bias and key mask and the online
// softmax on S's accumulator fragment (row max and sum by quad shuffles,
// exp2 with a log2(e) prescale), probabilities rounded to bf16 in
// registers, which is already the A-operand layout of the next product,
// and O += P V by wgmma with P from registers and V from shared memory
// (transposed operand: the contraction runs over keys). A CTA whose query
// rows all lie past the length writes zeros and returns. On an H100 this
// was faster than the alternatives tried (128-row tiles of two to four
// warpgroups, 128-key tiles, deeper rings, FA3's intra-warpgroup overlap
// and ping-pong, a persistent grid); PERF.md says what each did.
//
// fp32 (the tests' dtype): wgmma has no fp32 product (TF32 keeps about
// three digits, and the plain version is held to 1e-5), so fp32 runs on the
// CUDA cores: one CTA of 256 threads per (64-row query tile, head, batch
// row), 64-key tiles of K and V staged in shared memory, the query row in
// registers, four lanes per row (row max and sum by two shuffles), and
// p = (q . table^T) / 8 computed by the wrapper. Its arithmetic rate on the
// CUDA cores (67 TFLOP/s at most) bounds it.
//
// Both routes: the rel-key bias never exists as a (T, T) tensor. The
// tile's rows of p sit in shared memory and each score in the clip band
// reads one entry of it; key tiles wholly outside the band use each row's
// edge column. Key tiles wholly past the length are skipped. Key columns at
// or past lengths[b] get NEG = -0.7 FLT_MAX, never -inf, and at least one
// key tile is processed, so every output row stays finite (a NaN there
// would reach valid rows through 0 * NaN in the next layer).
//
// Plain C interface, bound from Python with ctypes (ops/attention_cuda.py).
// The tensor maps are encoded on the host per call through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;  // head size: the only one the TPU kernel takes
constexpr float NEG = -0.7f * FLT_MAX;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int MAX_C = 128;            // table rows: at most one TMA box
constexpr int ROW_BYTES = DH * 2;     // one 128-byte swizzle row per time step
constexpr int BQ = 64;                // query rows per CTA: one consumer warpgroup
constexpr int BK = 64;                // keys per K/V tile
constexpr int STAGES = 2;             // K/V ring
constexpr int CONSUMER_WARPS = 4;
constexpr int WG_THREADS = 32 * CONSUMER_WARPS + 32;  // + one producer warp
constexpr int CTAS_PER_SM = 4;        // at 96 registers and ~53 KB each (C <= 96)
constexpr int TILE_BYTES = BQ * ROW_BYTES;  // a query, K or V tile (BQ == BK)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE_LOG2 = 0.125f * LOG2E;  // 1 / sqrt(64), in log2 units
constexpr long long WAIT_LIMIT = 40000000000LL;  // cycles (~20 s): a deadlock traps

static_assert(BQ == BK, "the query tile and the K/V tiles share one tensor-map box");

// Shared memory, from a 1024-byte aligned base: the query tile; the table
// (table_rows of 128 bytes), overwritten by the (BQ, p_ld) bf16 projection
// once the projection's products are done; the ring of K and V tiles
// (1024-byte aligned); the mbarriers.
__host__ __device__ inline int smem_ring(int table_rows, int p_ld) {
    const int table = table_rows * ROW_BYTES, proj = BQ * p_ld * 2;
    return (TILE_BYTES + (table > proj ? table : proj) + 1023) & ~1023;
}
inline size_t smem_bytes(int table_rows, int p_ld) {
    return 1024 /* alignment slack */ + smem_ring(table_rows, p_ld) + STAGES * 2 * TILE_BYTES
         + 8 * (1 + 2 * STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// Wait until the barrier's phase of this parity completes. A wait that
// outlasts WAIT_LIMIT cycles traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity)) {
        if (clock64() - t0 > WAIT_LIMIT) __trap();
    }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// wgmma shared-memory descriptor for a tile of 128-byte rows in the
// 128-byte swizzle (as TMA writes it), 1024-byte aligned: 8-row groups
// 1024 bytes apart (stride byte offset); the leading byte offset is unused
// for this swizzle when a K-major operand's depth (16 bf16) or an MN-major
// operand's width (64 bf16) fits in one 128-byte row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)1 << 16)                // leading byte offset (16 B; unused)
         | ((uint64_t)(1024 >> 4) << 32)      // stride byte offset: 8 rows of 128 B
         | ((uint64_t)1 << 62);               // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>  // until at most N of this thread's wgmma groups are pending
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }

// Keep the compiler from moving reads or writes of an asynchronous
// operand's registers across the wgmma that uses them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for x far below -126
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments of wgmma m64nN (fp32): register i of thread t in
// the warpgroup holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (t % 4) + i % 2. Two adjacent fp32 registers,
// rounded to bf16 and packed, are the A fragment of a register-A wgmma
// m64nNk16: registers 8 kk .. 8 kk + 7 of the scores are the A operand of
// keys 16 kk .. 16 kk + 15, so P never goes through shared memory.
// d (64 x 32, fp32) += A (64 x 16, shared, K-major) . B (32 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16, shared, K-major) . B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B (16 x 64, shared, 64-major)
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q K^T: 64 query rows by 64 keys, depth 64
__device__ __forceinline__ void issue_scores(float (&d)[BK / 2], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_m64n64_ss(d, smem_desc(q_tile + 32 * kk), smem_desc(k_tile + 32 * kk), kk > 0);
}

// O += P V, P (64 x BK) in registers, V a BK-key tile
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pr)[BK / 4], uint32_t v_tile) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3]};
        // 16 keys = two 8-row groups of V: 2048 bytes per step
        wgmma_m64n64_rs_tb(o, a, smem_desc(v_tile + kk * 16 * ROW_BYTES));
    }
}

// This thread's state of the online softmax, for its two rows. Scores go
// to log2 units: (q.k / 8 + bias) log2(e).
struct RowState {
    const __nv_bfloat16* prow[2];  // this thread's two rows of p
    float edge_lo[2], edge_hi[2];  // their bias at distance <= -left and >= +right, log2 units
    float m_run[2];        // running max, log2 units
    float l_run[2];        // this thread's part of the running sum
    int qrow0;             // query row of register half 0 (half 1: +8)
    int q0;                // first query row of the tile
    int cq;                // column within each 8-column block
};

// One key tile's softmax, over each row's 4-lane quad: key mask, bias,
// running max and sum; probabilities rounded to bf16 into pr (the running
// sum takes them unrounded); alpha rescales what came before. Every
// probability is ex2(sc * scale + shift[row]). A tile wholly outside the
// clip band has one bias per row, so its max runs on the raw scores and
// the scaling, the bias and the max fold into that one FMA.
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], uint32_t (&pr)[BK / 4], RowState& st,
                                             float (&alpha)[2], int k0, int klen, int left, int right) {
    constexpr int N = BK / 2;
    if (k0 + BK > klen) {  // NEG stays far below every score after the scaling
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (k0 + 8 * (i / 4) + st.cq + (i % 2) >= klen) sc[i] = NEG;
    }
    const bool hi = k0 - (st.q0 + BQ - 1) >= right;  // the whole tile right of the band
    const bool lo = k0 + BK - 1 - st.q0 <= -left;    // ... left of it
    float scale = SCALE_LOG2;
    if (!hi && !lo) {  // in the band: scores to log2 units with each one's bias
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int hr = (i / 2) % 2;
            const int d = k0 + 8 * (i / 4) + st.cq + (i % 2) - (st.qrow0 + 8 * hr);
            const float bias = __bfloat162float(st.prow[hr][min(max(d, -left), right) + left]);
            sc[i] = fmaf(sc[i], SCALE_LOG2, bias * LOG2E);
        }
        scale = 1.f;
    }
    float shift[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float mt = NEG;
#pragma unroll
        for (int j = 0; j < N / 2; ++j) mt = fmaxf(mt, sc[4 * (j / 2) + 2 * hr + (j % 2)]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float edge = hi ? st.edge_hi[hr] : (lo ? st.edge_lo[hr] : 0.f);
        const float m_new = fmaxf(st.m_run[hr], fmaf(mt, scale, edge));
        alpha[hr] = ex2(st.m_run[hr] - m_new);
        st.m_run[hr] = m_new;
        shift[hr] = edge - m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; i += 2) {
        const int hr = (i / 2) % 2;
        const float e0 = ex2(fmaf(sc[i], scale, shift[hr]));
        const float e1 = ex2(fmaf(sc[i + 1], scale, shift[hr]));
        rs[hr] += e0 + e1;
        pr[i / 2] = pack_bf16(e0, e1);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) st.l_run[hr] = st.l_run[hr] * alpha[hr] + rs[hr];
}

__global__ void __launch_bounds__(WG_THREADS, CTAS_PER_SM) relkey_attention_wgmma(
    const __grid_constant__ CUtensorMap q_map,  // (B, T, H, 64) bf16, box (64, 1, 64, 1)
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap t_map,  // (C, 64) bf16, box (64, table_rows)
    const int* __restrict__ lengths,            // (B,) or null: all T keys valid
    __nv_bfloat16* __restrict__ out,            // (B, T, H, 64)
    int T_len, int H, int C, int left, int right, int p_ld, int table_rows)
{
    extern __shared__ unsigned char smem_raw[];
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int64_t row_stride = (int64_t)H * DH;  // elements between time steps
    const int64_t head_base = (int64_t)b * T_len * row_stride + (int64_t)h * DH;
    const int klen = lengths ? min(max(lengths[b], 0), T_len) : T_len;

    if (q0 >= klen) {  // every query row is padding: finite zeros
        const int rows = min(BQ, T_len - q0);
        for (int i = threadIdx.x; i < rows * (DH / 8); i += WG_THREADS) {
            const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
            *reinterpret_cast<uint4*>(out + head_base + (q0 + r) * row_stride + c) = make_uint4(0, 0, 0, 0);
        }
        return;
    }
    const int n_kt = (klen + BK - 1) / BK;  // >= 1: klen > q0 >= 0

    // 1024-byte aligned tiles for the 128-byte swizzle
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    const uint32_t q_tile = base;
    const uint32_t table = base + TILE_BYTES;
    __nv_bfloat16* pbias = reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw) + TILE_BYTES);  // over the table
    const uint32_t ring = base + smem_ring(table_rows, p_ld);  // stage s: K, then V
    const uint32_t bars = ring + STAGES * 2 * TILE_BYTES;
    const uint32_t q_bar = bars;                       // query tile and table landed
    const uint32_t full_bar = bars + 8;                // [STAGES]: K/V stage landed
    const uint32_t empty_bar = bars + 8 + 8 * STAGES;  // [STAGES]: stage released

    if (threadIdx.x == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_bar + 8 * s, 1);
            mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 32 * CONSUMER_WARPS) {
        // producer warp: one thread issues every copy
        if (threadIdx.x == 32 * CONSUMER_WARPS) {
            mbar_expect_tx(q_bar, TILE_BYTES + table_rows * ROW_BYTES);
            tma_load_4d(q_tile, &q_map, q_bar, 0, h, q0, b);
            tma_load_2d(table, &t_map, q_bar, 0, 0);
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % STAGES;
                const uint32_t k_dst = ring + s * 2 * TILE_BYTES;
                mbar_wait(empty_bar + 8 * s, ((kt / STAGES) & 1) ^ 1);
                mbar_expect_tx(full_bar + 8 * s, 2 * TILE_BYTES);
                tma_load_4d(k_dst, &k_map, full_bar + 8 * s, 0, h, kt * BK, b);
                tma_load_4d(k_dst + TILE_BYTES, &v_map, full_bar + 8 * s, 0, h, kt * BK, b);
            }
        }
        return;
    }

    // the consumer warpgroup
    const int t = threadIdx.x;
    const int rl = (t / 32) * 16 + (t % 32) / 4;  // tile row of register half 0; +8 for half 1
    RowState st;
    st.cq = 2 * (t % 4);
    st.q0 = q0;
    st.qrow0 = q0 + rl;
    mbar_wait(q_bar, 0);

    // p = (q . table^T) / 8, 32 table rows per product, rounded to bf16 (as
    // the plain version rounds it) over the table once every product has
    // read it. Each warp reads back only the rows it wrote.
    {
        constexpr int MAX_CH = MAX_C / 32;
        const int n_ch = table_rows / 32;
        float acc[MAX_CH][16];
#pragma unroll
        for (int ch = 0; ch < MAX_CH; ++ch) {
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[ch][i] = 0.f;
            fence_regs(acc[ch]);
        }
        wgmma_fence();
#pragma unroll
        for (int ch = 0; ch < MAX_CH; ++ch) {
            if (ch < n_ch) {
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk)
                    wgmma_m64n32_ss(acc[ch], smem_desc(q_tile + 32 * kk),
                                    smem_desc(table + ch * 32 * ROW_BYTES + 32 * kk), kk > 0);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ch = 0; ch < MAX_CH; ++ch) fence_regs(acc[ch]);
        // every warp's products are done with the table
        asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMER_WARPS) : "memory");
#pragma unroll
        for (int ch = 0; ch < MAX_CH; ++ch) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int col = ch * 32 + 8 * (i / 4) + st.cq + (i % 2);
                if (ch < n_ch && col < C)
                    pbias[(rl + 8 * ((i / 2) % 2)) * p_ld + col] = __float2bfloat16_rn(acc[ch][i] * 0.125f);
            }
        }
    }
    __syncwarp();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        st.prow[hr] = pbias + (rl + 8 * hr) * p_ld;
        st.edge_lo[hr] = __bfloat162float(st.prow[hr][0]) * LOG2E;
        st.edge_hi[hr] = __bfloat162float(st.prow[hr][C - 1]) * LOG2E;
        st.m_run[hr] = NEG;
        st.l_run[hr] = 0.f;
    }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float sc[BK / 2];
    uint32_t pr[BK / 4];  // probabilities in bf16: the A operand of P V
    float alpha[2];
    for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const uint32_t k_src = ring + s * 2 * TILE_BYTES;
        mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
        wgmma_fence();
        issue_scores(sc, q_tile, k_src);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(sc, pr, st, alpha, kt * BK, klen, left, right);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];
        fence_regs(o);
        fence_regs(pr);
        wgmma_fence();
        issue_pv(o, pr, k_src + TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pr);
        __syncwarp();  // the warp's wgmma reads of this stage are done
        if ((t & 31) == 0) mbar_arrive(empty_bar + 8 * s);
    }

    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float l = st.l_run[hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[hr] = 1.f / l;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int qrow = st.qrow0 + 8 * hr;
        if (qrow < T_len) {
            __nv_bfloat16* o_row = out + head_base + qrow * row_stride;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<uint32_t*>(o_row + 8 * j + st.cq) =
                    pack_bf16(o[4 * j + 2 * hr] * inv[hr], o[4 * j + 2 * hr + 1] * inv[hr]);
        }
    }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int S_BQ = 64;          // query rows per CTA
constexpr int S_BK = 64;          // key columns per tile
constexpr int S_THREADS = 256;    // 8 warps; lane = 4 * (row % 8) + g
constexpr int KS_LD = DH + 4;     // K row stride: float4 aligned, 4 rows in 16 banks
constexpr int VS_LD = DH;         // V row stride
constexpr int PS_LD = S_BK + 1;   // probability row stride: 8 rows in 8 banks

// S_BQ rows of 64 floats, starting at element offset `base`, rows `stride`
// elements apart, into shared memory with row stride LD; rows at or past
// n_rows are zero. 16-byte loads and stores.
template <int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int64_t base, int64_t stride, int n_rows) {
    constexpr int PER_ROW = DH / 4;
    for (int i = threadIdx.x; i < S_BQ * PER_ROW; i += S_THREADS) {
        const int r = i / PER_ROW;
        const int c = (i % PER_ROW) * 4;
        const float4 val = r < n_rows ? *reinterpret_cast<const float4*>(src + base + r * stride + c)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
}

__global__ void __launch_bounds__(S_THREADS, 2) relkey_attention_simt(
    const float* __restrict__ q,          // (B, T, H, 64)
    const float* __restrict__ k,          // (B, T, H, 64)
    const float* __restrict__ v,          // (B, T, H, 64)
    const float* __restrict__ p,          // (B, T, H, C)
    const int* __restrict__ lengths,      // (B,) or null: all T keys valid
    float* __restrict__ out,              // (B, T, H, 64)
    int T_len, int H, int C, int left, int right, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Ks = reinterpret_cast<float*>(smem_raw);  // (S_BK, KS_LD); Q first
    float* Vs = Ks + S_BK * KS_LD;                    // (S_BK, VS_LD)
    float* Ps = Vs + S_BK * VS_LD;                    // (S_BQ, PS_LD)
    float* Pb = Ps + S_BQ * PS_LD;                    // (S_BQ, C)

    const int q0 = blockIdx.x * S_BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = warp * 8 + (lane >> 2);  // query row within the tile
    const int g = lane & 3;                  // column group within the row
    const int qrow = q0 + row;

    const int64_t row_stride = (int64_t)H * DH;  // elements between time steps
    const int64_t head_base = ((int64_t)b * T_len) * row_stride + (int64_t)h * DH;
    int klen = T_len;
    if (lengths != nullptr) klen = min(max(lengths[b], 0), T_len);
    const int n_kt = max(1, (klen + S_BK - 1) / S_BK);

    // the query tile (staged through Ks) and the tile's slice of p
    const int q_rows = min(S_BQ, T_len - q0);
    load_rows<KS_LD>(Ks, q, head_base + q0 * row_stride, row_stride, q_rows);
    for (int i = threadIdx.x; i < S_BQ * C; i += S_THREADS) {
        const int r = i / C, c = i % C;
        Pb[i] = r < q_rows ? p[(((int64_t)b * T_len + q0 + r) * H + h) * C + c] : 0.f;
    }
    __syncthreads();
    float4 qv[DH / 4];
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4)
        qv[d4] = *reinterpret_cast<const float4*>(Ks + row * KS_LD + 4 * d4);
    const float bias_lo = Pb[row * C];          // distance clipped at -left
    const float bias_hi = Pb[row * C + C - 1];  // distance clipped at +right

    float m_run = NEG, l_run = 0.f;
    float4 acc[DH / 16];
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * S_BK;
        __syncthreads();  // the previous tile's (and Q's) readers are done
        const int k_rows = min(S_BK, T_len - k0);
        load_rows<KS_LD>(Ks, k, head_base + k0 * row_stride, row_stride, k_rows);
        load_rows<VS_LD>(Vs, v, head_base + k0 * row_stride, row_stride, k_rows);
        __syncthreads();

        // scores of this thread's 16 columns: 4j + g
        float s[S_BK / 4];
#pragma unroll
        for (int j = 0; j < S_BK / 4; ++j) s[j] = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 qq = qv[d4];
#pragma unroll
            for (int j = 0; j < S_BK / 4; ++j) {
                const float4 kk = *reinterpret_cast<const float4*>(Ks + (4 * j + g) * KS_LD + 4 * d4);
                s[j] = fmaf(qq.x, kk.x, s[j]);
                s[j] = fmaf(qq.y, kk.y, s[j]);
                s[j] = fmaf(qq.z, kk.z, s[j]);
                s[j] = fmaf(qq.w, kk.w, s[j]);
            }
        }

        // rel-key bias and key mask; a tile wholly right (left) of the clip
        // band sees the +right (-left) edge column for every score of a row
        const int edge = (k0 - (q0 + S_BQ - 1) >= right) ? 1 : ((k0 + S_BK - 1 - q0 <= -left) ? -1 : 0);
        float m_tile = NEG;
#pragma unroll
        for (int j = 0; j < S_BK / 4; ++j) {
            const int col = k0 + 4 * j + g;
            float bias;
            if (edge > 0) {
                bias = bias_hi;
            } else if (edge < 0) {
                bias = bias_lo;
            } else {
                const int dist = min(max(col - qrow, -left), right) + left;
                bias = Pb[row * C + dist];
            }
            s[j] = col < klen ? s[j] * scale + bias : NEG;
            m_tile = fmaxf(m_tile, s[j]);
        }
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
        const float m_new = fmaxf(m_run, m_tile);
        const float alpha = expf(m_run - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < S_BK / 4; ++j) {
            const float pr = expf(s[j] - m_new);
            rs += pr;
            Ps[row * PS_LD + 4 * j + g] = pr;
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_run = l_run * alpha + rs;
        m_run = m_new;
        __syncwarp();  // a row's probabilities come from its own warp

        // value product: this thread's 16 columns are 16 i + 4 g + (0..3)
#pragma unroll
        for (int i = 0; i < DH / 16; ++i) {
            acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
        }
#pragma unroll 8
        for (int c = 0; c < S_BK; ++c) {
            const float pc = Ps[row * PS_LD + c];
#pragma unroll
            for (int i = 0; i < DH / 16; ++i) {
                const float4 vv = *reinterpret_cast<const float4*>(Vs + c * VS_LD + 16 * i + 4 * g);
                acc[i].x = fmaf(pc, vv.x, acc[i].x);
                acc[i].y = fmaf(pc, vv.y, acc[i].y);
                acc[i].z = fmaf(pc, vv.z, acc[i].z);
                acc[i].w = fmaf(pc, vv.w, acc[i].w);
            }
        }
    }

    if (qrow < T_len) {
        const float inv = 1.f / l_run;
        float* o = out + head_base + qrow * row_stride;
#pragma unroll
        for (int i = 0; i < DH / 16; ++i)
            *reinterpret_cast<float4*>(o + 16 * i + 4 * g) =
                make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_ENCODE = -2;      // the driver refused a tensor map

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
        if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// bf16 tensor map with a 128-byte swizzle; dims and box innermost first,
// strides in bytes of dims 1..rank-1
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
               box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

namespace {

constexpr int MAX_DEVICES = 64;

// The bf16 kernel's table rows (C rounded up to whole 32-row products), its
// bias row stride (= 9 mod 64: conflict-free bias reads) and its dynamic
// shared memory.
void bf16_layout(int C, int* table_rows, int* p_ld, size_t* smem) {
    *table_rows = (C + 31) / 32 * 32;
    *p_ld = C + ((9 - C) % 64 + 64) % 64;
    *smem = smem_bytes(*table_rows, *p_ld);
}

size_t simt_smem_bytes(int C) {
    return sizeof(float) * ((size_t)S_BK * KS_LD + (size_t)S_BK * VS_LD + (size_t)S_BQ * PS_LD
                            + (size_t)S_BQ * C);
}

// Raise both kernels' dynamic shared-memory limits, once per device, to what
// the largest table (C = MAX_C rows) needs: the attribute belongs to the
// current device, and one process may launch on several cards. The first
// launch on a device sets them (an eager call, such as the warm-up that
// precedes a CUDA graph's capture), so no launch inside a capture does.
cudaError_t smem_limits_once() {
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (done[dev]) return cudaSuccess;
    size_t bf16 = 0;
    for (int C = 1; C <= MAX_C; ++C) {  // p_ld is not monotone in C
        int table_rows, p_ld;
        size_t smem;
        bf16_layout(C, &table_rows, &p_ld, &smem);
        bf16 = smem > bf16 ? smem : bf16;
    }
    err = cudaFuncSetAttribute(relkey_attention_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bf16);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(relkey_attention_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)simt_smem_bytes(MAX_C));
    if (err == cudaSuccess) done[dev] = true;
    return err;
}

}  // namespace

// The bf16 kernel's dynamic shared memory for a C-row table and how many of
// its CTAs fit on one SM of the current device. Returns a CUDA error code.
extern "C" int relkey_attention_bf16_occupancy(int C, int* smem_out, int* ctas_per_sm) {
    if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
    const cudaError_t err = smem_limits_once();
    if (err != cudaSuccess) return (int)err;
    int table_rows, p_ld;
    size_t smem;
    bf16_layout(C, &table_rows, &p_ld, &smem);
    *smem_out = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, relkey_attention_wgmma,
                                                              WG_THREADS, smem);
}

// q, k, v, out: (B, T, H, 64) bf16, contiguous, 16-byte aligned; table:
// (C, 64) bf16, contiguous, 16-byte aligned, C = left + right + 1 <= 128;
// lengths: (B,) int32 or null. Launches on `stream`, does not synchronise,
// and returns the launch's CUDA error code (0 on success), or -1 / -2 when
// the driver's tensor-map encoder is missing / refuses a map.
extern "C" int relkey_attention_bf16_launch(const void* q, const void* k, const void* v,
                                            const void* table, const int* lengths, void* out,
                                            int B, int T_len, int H, int C, int left, int right,
                                            void* stream) {
    if (left < 0 || right < 0 || C != left + right + 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
    if (B <= 0 || T_len <= 0 || H <= 0) return 0;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return ERR_NO_ENCODER;
    CUtensorMap maps[4];
    const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)H, (cuuint64_t)T_len, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)ROW_BYTES, (cuuint64_t)H * ROW_BYTES,
                                   (cuuint64_t)T_len * H * ROW_BYTES};
    const cuuint32_t box[4] = {(cuuint32_t)DH, 1, (cuuint32_t)BK, 1};
    const cudaError_t err = smem_limits_once();
    if (err != cudaSuccess) return (int)err;
    int table_rows, p_ld;
    size_t smem;
    bf16_layout(C, &table_rows, &p_ld, &smem);
    const cuuint64_t t_dims[2] = {(cuuint64_t)DH, (cuuint64_t)C};
    const cuuint64_t t_strides[1] = {(cuuint64_t)ROW_BYTES};
    const cuuint32_t t_box[2] = {(cuuint32_t)DH, (cuuint32_t)table_rows};
    if (!encode(enc, &maps[0], q, 4, dims, strides, box) ||
        !encode(enc, &maps[1], k, 4, dims, strides, box) ||
        !encode(enc, &maps[2], v, 4, dims, strides, box) ||
        !encode(enc, &maps[3], table, 2, t_dims, t_strides, t_box))
        return ERR_ENCODE;

    // The maps are __grid_constant__ parameters, taken by value: a launch
    // captured into a CUDA graph keeps its own copy, which holds the
    // addresses of the buffers the capture gave it, as the graph's replays do.
    const dim3 grid((T_len + BQ - 1) / BQ, H, B);
    relkey_attention_wgmma<<<grid, WG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        maps[0], maps[1], maps[2], maps[3], lengths, static_cast<__nv_bfloat16*>(out),
        T_len, H, C, left, right, p_ld, table_rows);
    return (int)cudaGetLastError();
}

// q, k, v, out: (B, T, H, 64) fp32, contiguous, 16-byte aligned; p:
// (B, T, H, C) fp32, C = left + right + 1; lengths: (B,) int32 or null.
// Launches on `stream`, does not synchronise, and returns the launch's
// CUDA error code (0 on success).
extern "C" int relkey_attention_fp32_launch(const void* q, const void* k, const void* v,
                                            const void* p, const int* lengths, void* out,
                                            int B, int T_len, int H, int C, int left, int right,
                                            void* stream) {
    if (left < 0 || right < 0 || C != left + right + 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
    if (B <= 0 || T_len <= 0 || H <= 0) return 0;
    const cudaError_t err = smem_limits_once();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = simt_smem_bytes(C);
    const dim3 grid((T_len + S_BQ - 1) / S_BQ, H, B);
    relkey_attention_simt<<<grid, S_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(p), lengths, static_cast<float*>(out),
        T_len, H, C, left, right, 0.125f /* 1 / sqrt(64) */);
    return (int)cudaGetLastError();
}
