// flax's LayerNorm of the speech encoders, for sm_90a.
//
// Replaces no TPU kernel: on the TPU, XLA fuses each flax LayerNorm with
// its cast and neighbours into one pass. Eagerly, PyTorch runs the same
// arithmetic (svecalign_tpu_torch/ops/layer_norm.py::flax_layer_norm, the
// plain version) as about nine kernels on fp32 copies, and in SpeechLASER
// and SONAR those kernels took about half the card's time. This kernel
// computes what the plain version computes in one pass:
//
//   x'  = x + pre[c], rounded to x's dtype          (optional: a conv's bias)
//   mu  = sum_c x' / C,  var = max(sum_c x'^2 / C - mu^2, 0)   (fp32, one pass)
//   y   = (x' - mu) * (rsqrt(var + eps) * w[c]) + b[c]          (fp32)
//   out = y rounded to the output dtype, then, optionally, GELU of it in fp32
//         (tanh approximation for a bf16 output, erf for fp32) rounded again
//
// with each product and sum of the last line rounded on its own
// (__fmul_rn, __fadd_rn), as PyTorch's separate kernels round them, so
// that only the order of the statistics' sums differs from the plain
// version. Inputs are fp32 or bf16, outputs fp32 or bf16, w and b fp32.
//
// Its bound is bytes: it reads x once and writes the output once (plus the
// C-wide w, b and pre), and does a few operations an element. Two layouts,
// the two the encoders call it with, each read in place:
//
// rows (the normalised axis contiguous: the trunks' norms, SONAR's
// fp_layer_norm; groups of contiguous rows at a stride, as a (B, T, C)
// slice of a longer T is): one warp a row, eight rows a block; each lane
// loads 8 channels at a time by 16-byte vector loads (32 bytes for fp32),
// keeps the row in registers, and the warp sums x and x^2 by shuffles
// (80-85% of the byte bound at the trunks' shapes). Rows must be 16-byte
// aligned.
//
// channels-first ((B, C, T) with T contiguous: the extractor's norms, the
// transposed views fed to post_extract_norm and SONAR's
// depthwise_layer_norm): one block a tile of TF consecutive frames of one
// batch row, threads along T so that a warp's loads are coalesced
// (element loads: T is odd at most of the extractor's layers, so a
// channel's frames start anywhere in a 16-byte chunk). The block stages
// the whole (C, TF) tile in shared memory, so x is read from device memory
// once, sums each frame's x and x^2 over C (partial sums a thread, then
// across threads in shared memory), and writes the output either
// channels-first (for the next conv) or as (B, T, C) (for a following
// dense), lanes then along C so the writes stay coalesced; the tile's rows
// are padded by 4 bytes so that this transposed read hits 32 banks. TF is
// the largest of 64, 32, 16, 8 whose tile fits 16 KB: at SONAR's and
// post_extract_norm's shapes larger tiles leave the grid at one or two
// waves (2.3x slower at 64 KB), and the extractor's time does not move
// with the tile (16-128 KB measured). The extractor's norms are held by
// instructions, not bytes (element loads, tanhf in the GELU epilogue:
// PERF.md); a design that loaded and stored 16-byte chunks was slower
// there (more index arithmetic an element) and was dropped.
//
// Launches on the given stream, does not synchronise, allocates nothing,
// and sets no attribute: a channels-first block takes at most 39 KB of
// dynamic shared memory (C = 1024 in fp32), under the 48 KB that needs no
// opt-in.
//
// Plain C interface, bound from Python with ctypes (ops/layer_norm_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNIT = 8;  // channels a lane loads at once in the rows layout
constexpr int MAX_WIDTH = 1024;  // the encoders' widest: four 8-channel units a lane in rows
constexpr int TILE_BYTES = 16 * 1024;

enum Act { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_ERF = 2 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// PyTorch's GELU kernels (aten/src/ATen/native/cuda/ActivationGeluKernel.cu)
// in fp32, written as they are written there.
__device__ __forceinline__ float gelu_tanh(float x) {
    constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;
    constexpr float kKappa = 0.044715;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_erf(float x) {
    constexpr float kAlpha = 0.70710678118654752440;
    return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// y rounded to the output dtype, then the activation of it rounded again
template <typename Tout>
__device__ __forceinline__ Tout finish(float y, int act) {
    if (act == ACT_NONE) return from_f<Tout>(y);
    const float r = round_to<Tout>(y);
    return from_f<Tout>(act == ACT_GELU_TANH ? gelu_tanh(r) : gelu_erf(r));
}

__device__ __forceinline__ float normed(float x, float mu, float rstd, float w, float b) {
    return __fadd_rn(__fmul_rn(__fsub_rn(x, mu), __fmul_rn(rstd, w)), b);
}

// 8 consecutive values, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 c = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
    }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const bf16* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __halves2bfloat162(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void stats(float sum, float sq, float inv_c, float eps, float* mu,
                                      float* rstd) {
    const float m = __fmul_rn(sum, inv_c);
    const float var = fmaxf(__fsub_rn(__fmul_rn(sq, inv_c), __fmul_rn(m, m)), 0.0f);
    *mu = m;
    *rstd = rsqrtf(__fadd_rn(var, eps));
}

// One warp a row of C = 8 U channels; lane l holds units l, l + 32, ...
// Input rows come in groups of group_rows contiguous rows, group_stride
// elements apart; output rows are contiguous.
template <typename Tin, typename Tout, int NU>
__global__ void __launch_bounds__(THREADS) layer_norm_rows(
    const Tin* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    const Tin* __restrict__ pre, Tout* __restrict__ out, long long rows, long long group_rows,
    long long group_stride, int C, float inv_c, float eps, int act) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int U = C / UNIT;
    const Tin* xr = x + (row / group_rows) * group_stride + (row % group_rows) * C;
    float v[NU][UNIT];
    float sum = 0.0f, sq = 0.0f;
#pragma unroll
    for (int k = 0; k < NU; ++k) {
        const int u = lane + 32 * k;
        if (u < U) load8(xr + u * UNIT, v[k]);
    }
#pragma unroll
    for (int k = 0; k < NU; ++k) {
        const int u = lane + 32 * k;
        if (u < U) {
            if (pre != nullptr) {
                float p[UNIT];
                load8(pre + u * UNIT, p);
#pragma unroll
                for (int i = 0; i < UNIT; ++i) v[k][i] = round_to<Tin>(v[k][i] + p[i]);
            }
#pragma unroll
            for (int i = 0; i < UNIT; ++i) {
                sum += v[k][i];
                sq += v[k][i] * v[k][i];
            }
        }
    }
    float mu, rstd;
    stats(warp_sum(sum), warp_sum(sq), inv_c, eps, &mu, &rstd);
    Tout* orow = out + row * C;
#pragma unroll
    for (int k = 0; k < NU; ++k) {
        const int u = lane + 32 * k;
        if (u < U) {
            float wv[UNIT], bv[UNIT];
            load8(w + u * UNIT, wv);
            load8(b + u * UNIT, bv);
            Tout o[UNIT];
#pragma unroll
            for (int i = 0; i < UNIT; ++i) o[i] = finish<Tout>(normed(v[k][i], mu, rstd, wv[i], bv[i]), act);
            store8(orow + u * UNIT, o);
        }
    }
}

// The channels-first tile: TF frames, each row padded by 4 bytes.
__host__ __device__ inline int tile_pitch(int TF, int in_size) { return TF + 4 / in_size; }

__host__ __device__ inline int cfirst_frames(int C, int in_size) {
    int TF = 64;
    while (TF > 8 && (long long)C * TF * in_size > TILE_BYTES) TF /= 2;
    return TF;
}

__host__ __device__ inline size_t cfirst_smem_bytes(int C, int in_size) {
    const int TF = cfirst_frames(C, in_size);
    const size_t tile = ((size_t)C * tile_pitch(TF, in_size) * in_size + 15) / 16 * 16;
    const int LF = TF < 32 ? TF : 32;
    const int CPS = THREADS / LF;
    return tile + sizeof(float) * (2 * (size_t)CPS * TF + 2 * (size_t)TF);
}

// One block a tile of TF frames of batch row blockIdx.y, all C channels.
// Thread i takes frames (i % LF) + LF j (j < TF / LF) of channels
// i / LF + CPS k.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS) layer_norm_cfirst(
    const Tin* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    const Tin* __restrict__ pre, Tout* __restrict__ out, int C, long long T, float inv_c,
    float eps, int act, int out_rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int TF = cfirst_frames(C, (int)sizeof(Tin));
    const int pitch = tile_pitch(TF, (int)sizeof(Tin));
    const int LF = TF < 32 ? TF : 32;
    const int FPT = TF / LF;
    const int CPS = THREADS / LF;
    Tin* tile = reinterpret_cast<Tin*>(smem);
    float* psum = reinterpret_cast<float*>(
        smem + ((size_t)C * pitch * sizeof(Tin) + 15) / 16 * 16);
    float* psq = psum + CPS * TF;
    float* smu = psq + CPS * TF;
    float* srstd = smu + TF;

    const long long t0 = (long long)blockIdx.x * TF;
    const int nf = (int)(T - t0 < TF ? T - t0 : TF);
    const int f0 = threadIdx.x % LF, cs = threadIdx.x / LF;
    const long long base = (long long)blockIdx.y * C * T + t0;
    const Tin* xb = x + base;

    // the tile, its conv bias added, and each thread's sums over its channels
    float s0 = 0.0f, q0 = 0.0f, s1 = 0.0f, q1 = 0.0f;
    const bool in0 = f0 < nf, in1 = FPT > 1 && f0 + LF < nf;
#pragma unroll 8
    for (int c = cs; c < C; c += CPS) {
        const Tin* xc = xb + (long long)c * T;
        const float pb = pre != nullptr ? to_f(pre[c]) : 0.0f;
        if (in0) {
            float v = to_f(xc[f0]);
            if (pre != nullptr) v = round_to<Tin>(v + pb);
            tile[c * pitch + f0] = from_f<Tin>(v);
            s0 += v;
            q0 += v * v;
        }
        if (in1) {
            float v = to_f(xc[f0 + LF]);
            if (pre != nullptr) v = round_to<Tin>(v + pb);
            tile[c * pitch + f0 + LF] = from_f<Tin>(v);
            s1 += v;
            q1 += v * v;
        }
    }
    psum[cs * TF + f0] = s0;
    psq[cs * TF + f0] = q0;
    if (FPT > 1) {
        psum[cs * TF + f0 + LF] = s1;
        psq[cs * TF + f0 + LF] = q1;
    }
    __syncthreads();
    for (int f = threadIdx.x; f < TF; f += THREADS) {
        float sum = 0.0f, sq = 0.0f;
        for (int k = 0; k < CPS; ++k) {
            sum += psum[k * TF + f];
            sq += psq[k * TF + f];
        }
        stats(sum, sq, inv_c, eps, &smu[f], &srstd[f]);
    }
    __syncthreads();

    if (!out_rows) {
        // (B, C, T): the loads' pattern
        Tout* ob = out + base;
        const float mu0 = smu[f0], r0 = srstd[f0];
        const float mu1 = FPT > 1 ? smu[f0 + LF] : 0.0f, r1 = FPT > 1 ? srstd[f0 + LF] : 0.0f;
#pragma unroll 4
        for (int c = cs; c < C; c += CPS) {
            const float wc = w[c], bc = b[c];
            Tout* oc = ob + (long long)c * T;
            if (in0) oc[f0] = finish<Tout>(normed(to_f(tile[c * pitch + f0]), mu0, r0, wc, bc), act);
            if (in1)
                oc[f0 + LF] =
                    finish<Tout>(normed(to_f(tile[c * pitch + f0 + LF]), mu1, r1, wc, bc), act);
        }
    } else {
        // (B, T, C): a warp a frame, lanes along the channels
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        Tout* ob = out + ((long long)blockIdx.y * T + t0) * C;
        for (int f = warp; f < nf; f += WARPS) {
            const float mu = smu[f], r = srstd[f];
            Tout* of = ob + (long long)f * C;
#pragma unroll 4
            for (int c = lane; c < C; c += 32)
                of[c] = finish<Tout>(normed(to_f(tile[c * pitch + f]), mu, r, w[c], b[c]), act);
        }
    }
}

template <typename Tin, typename Tout, int NU>
void launch_rows(const void* x, const float* w, const float* b, const void* pre, void* out,
                 long long rows, long long group_rows, long long group_stride, int C, float eps,
                 int act, cudaStream_t stream) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    layer_norm_rows<Tin, Tout, NU><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const Tin*>(x), w, b, static_cast<const Tin*>(pre), static_cast<Tout*>(out),
        rows, group_rows, group_stride, C, 1.0f / (float)C, eps, act);
}

template <typename Tin, typename Tout>
void launch_rows_nu(const void* x, const float* w, const float* b, const void* pre, void* out,
                    long long rows, long long group_rows, long long group_stride, int C,
                    float eps, int act, cudaStream_t stream) {
    const int per_lane = (C / UNIT + 31) / 32;
    if (per_lane <= 1)
        launch_rows<Tin, Tout, 1>(x, w, b, pre, out, rows, group_rows, group_stride, C, eps, act, stream);
    else if (per_lane <= 2)
        launch_rows<Tin, Tout, 2>(x, w, b, pre, out, rows, group_rows, group_stride, C, eps, act, stream);
    else
        launch_rows<Tin, Tout, 4>(x, w, b, pre, out, rows, group_rows, group_stride, C, eps, act, stream);
}

template <typename Tin, typename Tout>
void launch_cfirst(const void* x, const float* w, const float* b, const void* pre, void* out,
                   long long B, int C, long long T, float eps, int act, int out_rows,
                   cudaStream_t stream) {
    const int TF = cfirst_frames(C, (int)sizeof(Tin));
    const dim3 grid((unsigned)((T + TF - 1) / TF), (unsigned)B);
    layer_norm_cfirst<Tin, Tout><<<grid, THREADS, cfirst_smem_bytes(C, (int)sizeof(Tin)), stream>>>(
        static_cast<const Tin*>(x), w, b, static_cast<const Tin*>(pre), static_cast<Tout*>(out), C,
        T, 1.0f / (float)C, eps, act, out_rows);
}

template <typename Tin, typename Tout>
void launch(const void* x, const float* w, const float* b, const void* pre, void* out,
            int channels_first, int out_rows, long long outer, int C, long long inner,
            long long outer_stride, float eps, int act, cudaStream_t stream) {
    if (channels_first)
        launch_cfirst<Tin, Tout>(x, w, b, pre, out, outer, C, inner, eps, act, out_rows, stream);
    else
        launch_rows_nu<Tin, Tout>(x, w, b, pre, out, outer * inner, inner, outer_stride, C, eps,
                                  act, stream);
}

}  // namespace

// The channels-first plan for width C and input element size in_size (2 or
// 4): frames a tile and dynamic shared-memory bytes a block.
extern "C" int layer_norm_cfirst_plan(int C, int in_size, int* frames, int* smem_bytes) {
    if (C < UNIT || C > MAX_WIDTH || C % UNIT || (in_size != 2 && in_size != 4))
        return (int)cudaErrorInvalidValue;
    *frames = cfirst_frames(C, in_size);
    *smem_bytes = (int)cfirst_smem_bytes(C, in_size);
    return 0;
}

// x: rows layout (outer groups of inner contiguous rows of C, outer_stride
// elements apart, 16-byte aligned) or channels-first (outer = B, inner = T;
// (B, C, T) contiguous; outer_stride ignored).
// out: the same element order, or (B, T, C) where out_rows (channels-first
// only). w, b: (C,) fp32, 16-byte aligned; pre: (C,) of x's dtype, 16-byte
// aligned, or null. in_bf16 / out_bf16: 1 for bf16, 0 for fp32. act: 0
// none, 1 GELU by tanh, 2 GELU by erf. Launches on `stream`, does not
// synchronise, and returns the launch's CUDA error code (0 on success).
extern "C" int layer_norm_launch(const void* x, const float* w, const float* b, const void* pre,
                                 void* out, int in_bf16, int out_bf16, int channels_first,
                                 int out_rows, long long outer, int C, long long inner,
                                 long long outer_stride, float eps, int act, void* stream) {
    if (C < UNIT || C > MAX_WIDTH || C % UNIT || act < ACT_NONE || act > ACT_GELU_ERF || outer < 0 ||
        inner < 0 || (channels_first && outer > 65535) || (!channels_first && out_rows))
        return (int)cudaErrorInvalidValue;
    if (outer == 0 || inner == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_bf16 && out_bf16)
        launch<bf16, bf16>(x, w, b, pre, out, channels_first, out_rows, outer, C, inner, outer_stride,
                           eps, act, s);
    else if (in_bf16)
        launch<bf16, float>(x, w, b, pre, out, channels_first, out_rows, outer, C, inner, outer_stride,
                            eps, act, s);
    else if (out_bf16)
        launch<float, bf16>(x, w, b, pre, out, channels_first, out_rows, outer, C, inner, outer_stride,
                            eps, act, s);
    else
        launch<float, float>(x, w, b, pre, out, channels_first, out_rows, outer, C, inner, outer_stride,
                             eps, act, s);
    return (int)cudaGetLastError();
}
