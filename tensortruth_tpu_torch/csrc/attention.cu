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
// Design: online softmax (flash-style) on wgmma, fed by TMA.
// * One block per (batch, head, 128-row query tile): two consumer
//   warpgroups of 64 query rows and one producer warp; two blocks per SM,
//   so one block's softmax runs beside the other's products.
// * The producer loads each consumer's 64 query rows once, then the K and V
//   tiles of 64 keys through a ring of three stages, with 4-D tensor maps
//   over (B, NH, S, 64) built from the strides the caller passes (the
//   encoder's transposed projection views included), 128-byte swizzled. A
//   stage's full barrier counts TMA's bytes; its empty barrier one arrival
//   per consumer warp once the products that read it have retired.
// * S = Q . K^T: wgmma m64n64k16, Q and K both from shared memory (K rows
//   are head-dim contiguous: K-major). O += P . V: wgmma m64n64k16 with P
//   from registers (the score accumulator's layout is the A operand's, so
//   exp2(S - max) is packed to bf16 in place) and V from shared memory,
//   MN-major through the descriptor's transpose bit.
// * Softmax in the log2 domain, exp2 on the special-function unit: on a
//   tile of real keys the row max is taken over the raw scores and scaled
//   once, and each weight costs one FMA (s * scale * log2(e) - max) and one
//   exp2; a tile with padding first adds the -1e9 bias (times log2(e)) to
//   its scaled scores. f32 running row max and sum, O rescaled by
//   exp2(old max - new max); the row sum is reduced across the 4 threads of
//   a row once, at the end.
// * Each warpgroup waits for its scores before the softmax and for P . V
//   before the next tile; the overlap comes from the four consumer
//   warpgroups on an SM. A software pipeline within the warpgroup (the next
//   tile's scores beside this tile's P . V) needs a second set of P
//   registers: at the 96 registers ptxas allots a thread here it spilled,
//   and the spills between the wgmmas made ptxas serialise them (C7513),
//   which ran slower than this plain order.
// * Padding: a key tile with no real key contributes exactly 0 (exp(-1e9 -
//   max) underflows in f32), so neither the producer loads it nor the
//   consumers visit it: the block builds a table of real keys per tile
//   first. A batch row with no real key at all gets the same -1e9 on every
//   key, i.e. the uniform average of V (whenever |q . k| * scale < 32, which
//   keeps every score at exactly -1e9 in f32); it is written directly as
//   bf16(1/S) * sum(V), the reference's rounding of the normalised weights.
// * The reference rounds the normalised p to bf16 before P . V; this kernel
//   rounds the unnormalised p and divides at the end, so the two agree to
//   bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kDH = 64;                        // head dim: one 128-byte row
constexpr int kBQ = 128;                       // query rows per block
constexpr int kMinBlocks = 2;                  // resident blocks per SM
constexpr int kBK = 64;                        // keys per tile
constexpr int kStages = 3;                     // K/V tiles in the ring
constexpr int kConsumers = kBQ / 64;           // warpgroups of 64 query rows
constexpr int kProducerWarp = kConsumers * 4;  // the warp after them
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kMaxTiles = 256;                 // S <= 16384
constexpr int kTile = 64 * kDH * 2;            // 8 KiB: 64 rows of q, k or v
// Shared memory, 1024-byte aligned: q of each consumer, the K and V ring,
// the real-key bits of every key tile, the barriers.
constexpr int kSmemBytes = 1024 + (kConsumers + 2 * kStages) * kTile + kMaxTiles * 8 + (kConsumers + 2 * kStages) * 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLog2 = -1e9f * kLog2e;     // the -1e9 bias in the log2 domain

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D(64x64) += A(64x16) . B(16x64): bf16 operands in shared memory, f32 sums in
// registers; scale_d == 0 overwrites D. A and B K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x64) += A(64x16) . B(16x64): A bf16 in registers (the layout of an f32
// accumulator's columns, packed in pairs), B bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S = Q . K^T of one key tile over the 64 head dims, 16 per wgmma (32
// bytes of a row); Q and K both K-major. Issued and committed, not waited for.
__device__ __forceinline__ void issue_scores(float (&sc)[32], const unsigned char* q_tile,
                                             const unsigned char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < kDH / 16; ++kk)
    wgmma_m64n64k16_ss(sc, smem_desc(q_tile + kk * 32, 16, 1024), smem_desc(k_tile + kk * 32, 16, 1024), kk);
  wgmma_commit();
}

// O += P . V of one key tile: P from registers (the score accumulator's
// layout packed to bf16 pairs), V MN-major through the transpose bit, 16 keys
// (V rows) per wgmma, one 64-column group (lbo unused). Committed, not waited.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[kBK / 16][4],
                                         const unsigned char* v_tile) {
#pragma unroll
  for (int k2 = 0; k2 < kBK / 16; ++k2) wgmma_m64n64k16_rs(o, pa[k2], smem_desc(v_tile + k2 * 16 * 128, 0, 1024));
  wgmma_commit();
}

// Online softmax state of a thread's two rows (g and g + 8 of its warp's 16),
// in the log2 domain: running max, this thread's share of the running sum,
// and the rescale of O that the last step's weights need.
struct Softmax {
  float max_g, max_g8, sum_g, sum_g8, alpha_g, alpha_g8;

  __device__ __forceinline__ Softmax()
      : max_g(-INFINITY), max_g8(-INFINITY), sum_g(0.0f), sum_g8(0.0f), alpha_g(0.0f), alpha_g8(0.0f) {}

  // One key tile's scores sc (raw q . k) -> bf16 weights w as A fragments of
  // 16 keys each. A tile of real keys only takes max(sc) * c and
  // exp2(sc * c - max), one FMA a score (c = scale * log2(e)); a tile with
  // padding first adds the -1e9 bias to the scaled scores.
  __device__ __forceinline__ void step(float (&sc)[32], unsigned long long real, int t, float scale_log2,
                                       uint32_t (&w)[kBK / 16][4]) {
    float c = scale_log2;
    if (real != ~0ull) {
      const unsigned long long mine = real >> (2 * t);  // bit 8j + e: key 8j + 2t + e
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = (mine >> (8 * j + e)) & 1 ? 0.0f : kPadLog2;
          sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2, bias);
          sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], scale_log2, bias);
        }
      c = 1.0f;
    }
    float tmax_g = sc[0], tmax_g8 = sc[2];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      tmax_g = fmaxf(tmax_g, fmaxf(sc[4 * j], sc[4 * j + 1]));
      tmax_g8 = fmaxf(tmax_g8, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax_g = fmaxf(tmax_g, __shfl_xor_sync(0xffffffffu, tmax_g, off));
      tmax_g8 = fmaxf(tmax_g8, __shfl_xor_sync(0xffffffffu, tmax_g8, off));
    }
    const float new_g = fmaxf(max_g, tmax_g * c), new_g8 = fmaxf(max_g8, tmax_g8 * c);
    alpha_g = ex2(max_g - new_g);
    alpha_g8 = ex2(max_g8 - new_g8);
    max_g = new_g;
    max_g8 = new_g8;
    sum_g *= alpha_g;
    sum_g8 *= alpha_g8;
#pragma unroll
    for (int k2 = 0; k2 < kBK / 16; ++k2) {
      float p[8];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = 4 * (2 * k2 + h2);
        p[4 * h2 + 0] = ex2(fmaf(sc[j], c, -new_g));
        p[4 * h2 + 1] = ex2(fmaf(sc[j + 1], c, -new_g));
        p[4 * h2 + 2] = ex2(fmaf(sc[j + 2], c, -new_g8));
        p[4 * h2 + 3] = ex2(fmaf(sc[j + 3], c, -new_g8));
        sum_g += p[4 * h2 + 0] + p[4 * h2 + 1];
        sum_g8 += p[4 * h2 + 2] + p[4 * h2 + 3];
      }
      w[k2][0] = pack_bf16(p[0], p[1]);
      w[k2][1] = pack_bf16(p[2], p[3]);
      w[k2][2] = pack_bf16(p[4], p[5]);
      w[k2][3] = pack_bf16(p[6], p[7]);
    }
  }

  // O's rows were summed against the previous max: bring them to the new one.
  __device__ __forceinline__ void rescale(float (&o)[32]) const {
#pragma unroll
    for (int j = 0; j < kDH / 8; ++j) {
      o[4 * j] *= alpha_g;
      o[4 * j + 1] *= alpha_g;
      o[4 * j + 2] *= alpha_g8;
      o[4 * j + 3] *= alpha_g8;
    }
  }
};

// The first key tile at or after `tile` that holds a real key (n_tiles: none).
__device__ __forceinline__ int next_real_tile(const unsigned long long* real_bits, int tile, int n_tiles) {
  while (tile < n_tiles && !real_bits[tile]) ++tile;
  return tile;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ out, int nh, int s, long long sb,
                 long long sh, long long ss, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + kConsumers * kTile;
  unsigned char* v_s = k_s + kStages * kTile;
  auto* real_bits = reinterpret_cast<unsigned long long*>(v_s + kStages * kTile);  // bit i: key i of the tile is real
  uint64_t* q_full = reinterpret_cast<uint64_t*>(real_bits + kMaxTiles);
  uint64_t* full = q_full + kConsumers;
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = s / kBK;
  const int active = min(kBQ, s - q0) / 64;  // consumers with query rows
  const int* mrow = mask + (long long)b * s;

  int any_real = 0;
  for (int tile = warp; tile < n_tiles; tile += kThreads / 32) {
    const unsigned lo = __ballot_sync(0xffffffffu, mrow[tile * kBK + lane] > 0);
    const unsigned hi = __ballot_sync(0xffffffffu, mrow[tile * kBK + 32 + lane] > 0);
    if (lane == 0) real_bits[tile] = lo | ((unsigned long long)hi << 32);
    any_real |= (lo | hi) != 0;
  }
  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w) mbar_init(&q_full[w], 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], active * 4);
    }
    mbar_init_fence();
  }
  __nv_bfloat16* obase = out + (((long long)b * nh + h) * s + q0) * kDH;
  if (!__syncthreads_or(any_real)) {
    // No real key in this batch row: bf16(1/S) * sum of V over all keys.
    float* colsum = reinterpret_cast<float*>(k_s);
    const __nv_bfloat16* vh = v + b * sb + h * sh;
    if (threadIdx.x < 4 * kDH) {
      float acc = 0.0f;
      for (int key = threadIdx.x / kDH; key < s; key += 4) acc += __bfloat162float(vh[key * ss + threadIdx.x % kDH]);
      colsum[threadIdx.x] = acc;
    }
    __syncthreads();
    const float p = __bfloat162float(__float2bfloat16(1.0f / (float)s));
    for (int i = threadIdx.x; i < active * 64 * kDH; i += kThreads) {
      const int d = i % kDH;
      obase[i] = __float2bfloat16(p * (colsum[d] + colsum[d + kDH] + colsum[d + 2 * kDH] + colsum[d + 3 * kDH]));
    }
    return;
  }

  if (warp == kProducerWarp) {
    if (lane != 0) return;
    for (int w = 0; w < active; ++w) {
      mbar_arrive_expect_tx(&q_full[w], kTile);
      tma_load_4d(q_s + w * kTile, &map_q, &q_full[w], 0, q0 + 64 * w, h, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      if (!real_bits[tile]) continue;
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], 2 * kTile);
      tma_load_4d(k_s + stage * kTile, &map_k, &full[stage], 0, tile * kBK, h, b);
      tma_load_4d(v_s + stage * kTile, &map_v, &full[stage], 0, tile * kBK, h, b);
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    return;
  }

  // Consumer warpgroup wg: query rows wg * 64 .. + 63 of the block. A thread
  // holds rows g and g + 8 of its warp's 16, columns 8j + 2t and + 1 of each
  // accumulator (keys of S, head dims of O).
  const int wg = warp / 4;
  if (wg >= active) return;
  const int t = lane % 4;
  const unsigned char* q_tile = q_s + wg * kTile;
  mbar_wait(&q_full[wg], 0);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  Softmax sm;
  float sc[32];              // scores of the tile in hand
  uint32_t pa[kBK / 16][4];  // its bf16 weights: P . V's A operand
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = next_real_tile(real_bits, 0, n_tiles); tile < n_tiles;
       tile = next_real_tile(real_bits, tile + 1, n_tiles)) {
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    issue_scores(sc, q_tile, k_s + stage * kTile);
    wgmma_wait<0>();
    fence_regs(sc);
    sm.step(sc, real_bits[tile], t, scale_log2, pa);
    sm.rescale(o);
    wgmma_fence();
    issue_pv(o, pa, v_s + stage * kTile);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) stage = 0, phase ^= 1;
  }
  float sum_g = sm.sum_g, sum_g8 = sm.sum_g8;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sum_g += __shfl_xor_sync(0xffffffffu, sum_g, off);
    sum_g8 += __shfl_xor_sync(0xffffffffu, sum_g8, off);
  }
  const float inv_g = 1.0f / sum_g, inv_g8 = 1.0f / sum_g8;
  __nv_bfloat16* row_g = obase + (wg * 64 + (warp % 4) * 16 + lane / 4) * kDH + 2 * t;
  __nv_bfloat16* row_g8 = row_g + 8 * kDH;
#pragma unroll
  for (int j = 0; j < kDH / 8; ++j) {
    *reinterpret_cast<uint32_t*>(row_g + j * 8) = pack_bf16(o[4 * j] * inv_g, o[4 * j + 1] * inv_g);
    *reinterpret_cast<uint32_t*>(row_g8 + j * 8) = pack_bf16(o[4 * j + 2] * inv_g8, o[4 * j + 3] * inv_g8);
  }
}

}  // namespace

// q, k, v: (B, NH, S, 64) bf16 with the same strides (sb, sh, ss) in
// elements, last dim contiguous, strides multiples of 8 and pointers 16-byte
// aligned; mask: (B, S) int32 contiguous; out: (B, NH, S, 64) bf16
// contiguous. S must be a multiple of 64 and at most 16384. Returns the
// CUDA launch error (cudaErrorInvalidValue if a tensor map cannot be
// encoded).
extern "C" int tt_blocked_attention(const void* q, const void* k, const void* v, const void* mask, void* out, int b,
                                    int nh, int s, long long sb, long long sh, long long ss, float scale,
                                    void* stream) {
  // (head dim, S, NH, B), innermost first; strides in bytes.
  const uint64_t dims[4] = {kDH, uint64_t(s), uint64_t(nh), uint64_t(b)};
  const uint64_t byte_strides[3] = {uint64_t(ss) * 2, uint64_t(sh) * 2, uint64_t(sb) * 2};
  const uint32_t box[4] = {kDH, 64, 1, 1};
  alignas(64) CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!encode_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i], 4, dims, byte_strides, box))
      return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBQ - 1) / kBQ, nh, b);
  attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), nh, s, sb, sh, ss, scale * kLog2e);
  return cudaGetLastError();
}
