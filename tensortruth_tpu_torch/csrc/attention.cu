// Padding-masked bidirectional attention for the encoder (kernel B3).
//
// Replaces: tensortruth_tpu/ops/attention.py::_attn_kernel, reached through
// blocked_attention (the pl.pallas_call at ops/attention.py:74).
//
// What it computes (as the TPU kernel): for q/k/v of shape (B, NH, S, 64)
// bf16 and a (B, S) int mask, softmax(q . k^T * scale + bias) . v per head,
// where bias is 0 on real keys and -1e9 on padding, all score and softmax
// math in f32 and the output rounded to bf16 once.
//
// What bounds it on an H100: the TPU kernel keeps one head's whole K and V
// in VMEM and runs an exact softmax over the full (256, S) score block. At
// S = 2048 K and V are 256 KB each, more than the 227 KB of shared memory a
// block may use, so that layout does not carry over. Per (batch, head) the
// work is 4 * S^2 * 64 FLOP against 3 * S * 128 bytes: compute bound from S
// of a few hundred up, as long as the (S, S) scores never leave the chip.
//
// Design: online softmax (flash-style) on the tensor cores.
// * One block of 4 warps per (batch, head, 64-row query tile); each warp
//   owns 16 query rows. K and V tiles of 64 keys are staged in shared memory
//   (rows padded to 72 elements so fragment loads hit 32 distinct banks).
// * Scores S = Q . K^T and the output O += P . V use mma.sync m16n8k16 (bf16
//   in, f32 accumulate). S, P and O never leave registers: the score
//   accumulator layout of one mma is the A-operand layout of the next, so
//   exp(S - max) is packed to bf16 in place.
// * f32 running row max and sum; O rescaled by exp(old max - new max); the
//   row sum is reduced across the 4 threads of a row once, at the end.
// * Padding: a key tile with no real key contributes exactly 0 (exp(-1e9 -
//   max) underflows in f32), so it is skipped. A batch row with no real key
//   at all gets the same -1e9 on every key, i.e. the uniform average of V
//   (whenever |q . k| * scale < 32, which keeps every score at exactly
//   -1e9 in f32); it is written directly as bf16(1/S) * sum(V), the
//   reference's rounding of the normalised weights.
// * The reference rounds the normalised p to bf16 before P . V; this kernel
//   rounds the unnormalised p and divides at the end, so the two agree to
//   bf16 rounding.
// Not yet: cp.async/TMA double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kDH = 64;              // head dim
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per step
constexpr int kWarps = kBQ / 16;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kDH + 8;         // padded shared-memory row (elements)
constexpr int kMaxTiles = 256;       // S <= 16384

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D = A(16x16, row) . B(16x8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy 64 rows x 64 dims (row stride `stride` elements) into a padded tile.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride) {
  for (int x = threadIdx.x; x < 64 * (kDH / 8); x += kThreads) {
    const int row = x / (kDH / 8);
    const int col = (x % (kDH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + row * kLd + col) =
        *reinterpret_cast<const uint4*>(src + row * stride + col);
  }
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                 int nh, int s, long long sb, long long sh, long long ss,
                 float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBK * kLd];
  __shared__ float bias_s[kBK];
  __shared__ float colsum_s[kThreads];
  __shared__ unsigned char tile_real[kMaxTiles];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within a quad
  const long long head = b * sb + h * sh;
  const int* mrow = mask + (long long)b * s;
  const int n_tiles = s / kBK;
  __nv_bfloat16* obase = out + (((long long)b * nh + h) * s + q0) * kDH;

  // Which key tiles hold a real key.
  int any_real = 0;
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    const int real = __any_sync(0xffffffffu, mrow[tile * kBK + lane] > 0 ||
                                                 mrow[tile * kBK + 32 + lane] > 0);
    if (lane == 0) tile_real[tile] = (unsigned char)real;
    any_real |= real;
  }
  if (!__syncthreads_or(any_real)) {
    // No real key in this batch row: bf16(1/S) * sum of V over all keys.
    const int d = threadIdx.x % kDH;
    float acc = 0.0f;
    for (int key = threadIdx.x / kDH; key < s; key += kThreads / kDH)
      acc += __bfloat162float(v[head + key * ss + d]);
    colsum_s[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < kDH) {
      const float p = __bfloat162float(__float2bfloat16(1.0f / (float)s));
      const __nv_bfloat16 o = __float2bfloat16(p * (colsum_s[d] + colsum_s[d + kDH]));
      for (int r = 0; r < kBQ; ++r) obase[r * kDH + d] = o;
    }
    return;
  }

  // This warp's 16 query rows as mma A fragments (4 chunks of 16 dims).
  uint32_t qa[kDH / 16][4];
  {
    const __nv_bfloat16* r0 = q + head + (long long)(q0 + warp * 16 + g) * ss;
    const __nv_bfloat16* r8 = r0 + 8 * ss;
#pragma unroll
    for (int c = 0; c < kDH / 16; ++c) {
      qa[c][0] = *reinterpret_cast<const uint32_t*>(r0 + c * 16 + 2 * t);
      qa[c][1] = *reinterpret_cast<const uint32_t*>(r8 + c * 16 + 2 * t);
      qa[c][2] = *reinterpret_cast<const uint32_t*>(r0 + c * 16 + 8 + 2 * t);
      qa[c][3] = *reinterpret_cast<const uint32_t*>(r8 + c * 16 + 8 + 2 * t);
    }
  }

  float o[kDH / 8][4];
#pragma unroll
  for (int n = 0; n < kDH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float max_g = -CUDART_INF_F, max_g8 = -CUDART_INF_F;  // rows g and g + 8
  float sum_g = 0.0f, sum_g8 = 0.0f;                     // this thread's share

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (!tile_real[tile]) continue;  // uniform across the block
    const int k0 = tile * kBK;
    load_tile(k_s, k + head + k0 * ss, ss);
    load_tile(v_s, v + head + k0 * ss, ss);
    if (threadIdx.x < kBK) bias_s[threadIdx.x] = mrow[k0 + threadIdx.x] > 0 ? 0.0f : -1e9f;
    __syncthreads();

    // S = Q . K^T: 8 n-tiles of 8 keys.
    float sc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
      const __nv_bfloat16* krow = k_s + (j * 8 + g) * kLd + 2 * t;
#pragma unroll
      for (int c = 0; c < kDH / 16; ++c) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + c * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + c * 16 + 8);
        mma16816(sc[j], qa[c], b0, b1);
      }
    }

    // Online softmax over this tile.
    float tmax_g = -CUDART_INF_F, tmax_g8 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float b0 = bias_s[j * 8 + 2 * t], b1 = bias_s[j * 8 + 2 * t + 1];
      sc[j][0] = sc[j][0] * scale + b0;
      sc[j][1] = sc[j][1] * scale + b1;
      sc[j][2] = sc[j][2] * scale + b0;
      sc[j][3] = sc[j][3] * scale + b1;
      tmax_g = fmaxf(tmax_g, fmaxf(sc[j][0], sc[j][1]));
      tmax_g8 = fmaxf(tmax_g8, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax_g = fmaxf(tmax_g, __shfl_xor_sync(0xffffffffu, tmax_g, off));
      tmax_g8 = fmaxf(tmax_g8, __shfl_xor_sync(0xffffffffu, tmax_g8, off));
    }
    const float new_g = fmaxf(max_g, tmax_g), new_g8 = fmaxf(max_g8, tmax_g8);
    const float alpha_g = expf(max_g - new_g), alpha_g8 = expf(max_g8 - new_g8);
    max_g = new_g;
    max_g8 = new_g8;
    sum_g *= alpha_g;
    sum_g8 *= alpha_g8;
#pragma unroll
    for (int n = 0; n < kDH / 8; ++n) {
      o[n][0] *= alpha_g;
      o[n][1] *= alpha_g;
      o[n][2] *= alpha_g8;
      o[n][3] *= alpha_g8;
    }

    // P (bf16) as A fragments, 4 chunks of 16 keys; O += P . V.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      float p[8];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float* x = sc[2 * c + h2];
        p[4 * h2 + 0] = expf(x[0] - new_g);
        p[4 * h2 + 1] = expf(x[1] - new_g);
        p[4 * h2 + 2] = expf(x[2] - new_g8);
        p[4 * h2 + 3] = expf(x[3] - new_g8);
        sum_g += p[4 * h2 + 0] + p[4 * h2 + 1];
        sum_g8 += p[4 * h2 + 2] + p[4 * h2 + 3];
      }
      pa[c][0] = pack_bf16(p[0], p[1]);
      pa[c][1] = pack_bf16(p[2], p[3]);
      pa[c][2] = pack_bf16(p[4], p[5]);
      pa[c][3] = pack_bf16(p[6], p[7]);
    }
#pragma unroll
    for (int n = 0; n < kDH / 8; ++n) {
      const __nv_bfloat16* vcol = v_s + n * 8 + g;
#pragma unroll
      for (int c = 0; c < kBK / 16; ++c) {
        const __nv_bfloat16* v0 = vcol + (c * 16 + 2 * t) * kLd;
        const uint32_t b0 = pack_raw(v0[0], v0[kLd]);
        const uint32_t b1 = pack_raw(v0[8 * kLd], v0[9 * kLd]);
        mma16816(o[n], pa[c], b0, b1);
      }
    }
    __syncthreads();  // k_s, v_s and bias_s are reloaded next step
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sum_g += __shfl_xor_sync(0xffffffffu, sum_g, off);
    sum_g8 += __shfl_xor_sync(0xffffffffu, sum_g8, off);
  }
  const float inv_g = 1.0f / sum_g, inv_g8 = 1.0f / sum_g8;
  __nv_bfloat16* row_g = obase + (warp * 16 + g) * kDH + 2 * t;
  __nv_bfloat16* row_g8 = row_g + 8 * kDH;
#pragma unroll
  for (int n = 0; n < kDH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(row_g + n * 8) = pack_bf16(o[n][0] * inv_g, o[n][1] * inv_g);
    *reinterpret_cast<uint32_t*>(row_g8 + n * 8) = pack_bf16(o[n][2] * inv_g8, o[n][3] * inv_g8);
  }
}

}  // namespace

// q, k, v: (B, NH, S, 64) bf16 with the same strides (sb, sh, ss) in
// elements, last dim contiguous, strides multiples of 8 and pointers 16-byte
// aligned; mask: (B, S) int32 contiguous; out: (B, NH, S, 64) bf16
// contiguous. S must be a multiple of 64 and at most 16384. Returns the
// CUDA launch error.
extern "C" int tt_blocked_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int b, int nh,
                                    int s, long long sb, long long sh,
                                    long long ss, float scale, void* stream) {
  dim3 grid(s / kBQ, nh, b);
  attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), nh, s, sb, sh, ss, scale);
  return cudaGetLastError();
}
