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
// with scale = 1/sqrt(64) and p = (q . table^T) * scale, the (B, T, H, C)
// projection that the wrapper computes in fp32 and rounds to q's dtype, as
// the TPU kernel's caller does. q, k, v and the output are (B, T, H, 64),
// the projections' own layout, read in place (no transposes). bf16 and fp32
// go through one template. Scores, the running max, the running sum and the
// accumulator are fp32; probabilities are rounded to v's dtype before the
// value product, and the output to q's dtype, as the TPU kernel does.
//
// What bounds it on this card: at the main path's shapes (B = 16, H = 16,
// T = 350-700) it does 4 B H T^2 64 operations on 4 B T H 64 elements, over
// 100 operations per byte, so it is bound by arithmetic, not memory. This
// first version runs that arithmetic on the fp32 CUDA cores (no tensor
// cores, no TMA): one CTA of 256 threads per (64-row query tile, head,
// batch row), 64-key tiles of K and V staged in shared memory as fp32, the
// query row held in registers. Each row belongs to the 4 adjacent lanes
// that hold 16 interleaved key columns each (scores) and 16 interleaved
// value columns each (accumulator), so the row max and sum are two shuffles
// and every shared-memory read is a broadcast or conflict free. The
// rel-key bias never exists as a (T, T) tensor: the tile's (64, C) slice of
// p sits in shared memory and each score reads one entry of it; tiles wholly
// outside the clip band read one edge column per row. Key tiles wholly past
// the length are skipped. The tensor-core (wgmma) version is later work.
//
// Padding: key columns at or past lengths[b] get NEG = -0.7 FLT_MAX, never
// -inf, so a batch row that is only padding (length 0) still averages
// exp(NEG - NEG) = 1 over its first key tile and every output stays finite
// (a NaN there would reach valid rows through 0 * NaN in the next layer).
//
// Plain C interface, bound from Python with ctypes (ops/attention_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;          // head size: the only one the TPU kernel takes
constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // key columns per tile
constexpr int THREADS = 256;    // 8 warps; lane = 4 * (row % 8) + g
constexpr int KS_LD = DH + 4;   // K row stride: float4 aligned, 4 rows in 16 banks
constexpr int VS_LD = DH;       // V row stride
constexpr int PS_LD = BK + 1;   // probability row stride: 8 rows in 8 banks
constexpr float NEG = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// BQ rows of 64 elements, starting at element offset `base`, rows `stride`
// elements apart, into shared memory as fp32 with row stride LD; rows at or
// past n_rows are zero. 16-byte loads and stores.
template <typename T, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int64_t base, int64_t stride, int n_rows) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int PER_ROW = DH / VEC;
    for (int i = threadIdx.x; i < BQ * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW;
        const int c = (i % PER_ROW) * VEC;
        float vals[VEC];
        if (r < n_rows) {
            const uint4 raw = *reinterpret_cast<const uint4*>(src + base + r * stride + c);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) vals[j] = to_f(e[j]);
        } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
            *reinterpret_cast<float4*>(dst + r * LD + c + j) =
                make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) relkey_attention_kernel(
    const T* __restrict__ q,          // (B, T, H, 64)
    const T* __restrict__ k,          // (B, T, H, 64)
    const T* __restrict__ v,          // (B, T, H, 64)
    const T* __restrict__ p,          // (B, T, H, C)
    const int* __restrict__ lengths,  // (B,) or null: all T keys valid
    T* __restrict__ out,              // (B, T, H, 64)
    int T_len, int H, int C, int left, int right, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Ks = reinterpret_cast<float*>(smem_raw);  // (BK, KS_LD); Q first
    float* Vs = Ks + BK * KS_LD;                      // (BK, VS_LD)
    float* Ps = Vs + BK * VS_LD;                      // (BQ, PS_LD)
    float* Pb = Ps + BQ * PS_LD;                      // (BQ, C)

    const int q0 = blockIdx.x * BQ;
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
    const int n_kt = max(1, (klen + BK - 1) / BK);

    // the query tile (staged through Ks) and the tile's slice of p
    const int q_rows = min(BQ, T_len - q0);
    load_rows<T, KS_LD>(Ks, q, head_base + q0 * row_stride, row_stride, q_rows);
    for (int i = threadIdx.x; i < BQ * C; i += THREADS) {
        const int r = i / C, c = i % C;
        Pb[i] = r < q_rows ? to_f(p[(((int64_t)b * T_len + q0 + r) * H + h) * C + c]) : 0.f;
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
        const int k0 = kt * BK;
        __syncthreads();  // the previous tile's (and Q's) readers are done
        const int k_rows = min(BK, T_len - k0);
        load_rows<T, KS_LD>(Ks, k, head_base + k0 * row_stride, row_stride, k_rows);
        load_rows<T, VS_LD>(Vs, v, head_base + k0 * row_stride, row_stride, k_rows);
        __syncthreads();

        // scores of this thread's 16 columns: 4j + g
        float s[BK / 4];
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 qq = qv[d4];
#pragma unroll
            for (int j = 0; j < BK / 4; ++j) {
                const float4 kk = *reinterpret_cast<const float4*>(Ks + (4 * j + g) * KS_LD + 4 * d4);
                s[j] = fmaf(qq.x, kk.x, s[j]);
                s[j] = fmaf(qq.y, kk.y, s[j]);
                s[j] = fmaf(qq.z, kk.z, s[j]);
                s[j] = fmaf(qq.w, kk.w, s[j]);
            }
        }

        // rel-key bias and key mask; a tile wholly right (left) of the clip
        // band sees the +right (-left) edge column for every score of a row
        const int edge = (k0 - (q0 + BQ - 1) >= right) ? 1 : ((k0 + BK - 1 - q0 <= -left) ? -1 : 0);
        float m_tile = NEG;
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) {
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
        for (int j = 0; j < BK / 4; ++j) {
            const float pr = expf(s[j] - m_new);
            rs += pr;
            Ps[row * PS_LD + 4 * j + g] = to_f(from_f<T>(pr));  // in v's dtype
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
        for (int c = 0; c < BK; ++c) {
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
        T* o = out + head_base + qrow * row_stride;
#pragma unroll
        for (int i = 0; i < DH / 16; ++i) {
            const int d = 16 * i + 4 * g;
            o[d] = from_f<T>(acc[i].x * inv);
            o[d + 1] = from_f<T>(acc[i].y * inv);
            o[d + 2] = from_f<T>(acc[i].z * inv);
            o[d + 3] = from_f<T>(acc[i].w * inv);
        }
    }
}

size_t smem_bytes(int C) {
    return sizeof(float) * ((size_t)BK * KS_LD + (size_t)BK * VS_LD + (size_t)BQ * PS_LD + (size_t)BQ * C);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const int* lengths, void* out, int B, int T_len, int H, int C,
                   int left, int right, cudaStream_t stream) {
    const size_t smem = smem_bytes(C);
    cudaError_t err = cudaFuncSetAttribute(relkey_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_len + BQ - 1) / BQ, H, B);
    relkey_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(p), lengths, static_cast<T*>(out),
        T_len, H, C, left, right, 0.125f /* 1 / sqrt(64) */);
    return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, T, H, 64) contiguous, 16-byte aligned, fp32 (is_bf16 =
// 0) or bf16 (is_bf16 = 1); p: (B, T, H, C) in the same type, C = left +
// right + 1; lengths: (B,) int32 or null. Launches on `stream`, does not
// synchronise, and returns the launch's CUDA error code (0 on success).
extern "C" int relkey_attention_launch(const void* q, const void* k, const void* v,
                                       const void* p, const int* lengths, void* out,
                                       int B, int T_len, int H, int C, int left, int right,
                                       int is_bf16, void* stream) {
    if (left < 0 || right < 0 || C != left + right + 1) return (int)cudaErrorInvalidValue;
    if (B <= 0 || T_len <= 0 || H <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = is_bf16
        ? launch<__nv_bfloat16>(q, k, v, p, lengths, out, B, T_len, H, C, left, right, s)
        : launch<float>(q, k, v, p, lengths, out, B, T_len, H, C, left, right, s);
    return (int)err;
}
