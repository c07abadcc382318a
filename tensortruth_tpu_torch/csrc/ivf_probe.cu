// IVF probe scores over bf16 or int8 cluster blocks (kernel B4, both
// variants; templated on the block element type).
//
// Replaces: tensortruth_tpu/ops/ivf.py::_probe_kernel, reached through
// _probe_scores (the pl.pallas_call at ops/ivf.py:124), with and without
// `quantized`.
//
// What it computes (identical to the TPU kernel): for each query b, probe p
// and slot r of the probed cluster c = probe[b, p],
//   out[b, p, r] = valid[c, r] ? dot(q_b, blocks[c, r]) (* scales[c, r]) : -inf
// with bf16 operands, f32 products and f32 sums; an int8 row is converted to
// bf16 (exact: |v| <= 127) and the f32 dot is then multiplied by the row's
// f32 scale. Invalid (padding) slots are written as -inf, never as scale x 0.
//
// What bounds it on an H100: one query against one row is a dot product:
// 2 FLOP per element for 2 (bf16) or 1 (int8) bytes read, so it is bound by
// device memory, and by L2 where queries share a probed cluster.
//
// Design (a simple correct kernel first): the TPU scalar-prefetches the
// cluster id so its DMA engine fetches the probed block; here each CUDA
// block, one per (row tile, probe, query), loads probe[b, p] itself and uses
// it for pointer arithmetic into `blocks`. The block copies q_b to shared
// memory as f32 once; each warp then scores 16 rows of the tile, its lanes
// reading a row in 16-byte pieces (neighbouring lanes on neighbouring
// addresses) and reducing the row's partial sums with warp shuffles. A slot
// whose `valid` is 0 is skipped without reading its row. Grouping the
// queries that probe one cluster into tensor-core tiles, so that a probed
// block is read once per batch instead of once per query, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

template <typename T>
__device__ __forceinline__ float dot_piece(const int4 raw, const float* q) {
  float acc = 0.0f;
  if constexpr (std::is_same<T, signed char>::value) {
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = (w[i / 4] << (24 - 8 * (i % 4))) >> 24;  // byte i, sign-extended
      acc = fmaf(static_cast<float>(v), q[i], acc);
    }
  } else {
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(__bfloat162float(v[i]), q[i], acc);
  }
  return acc;
}

// T is the block element: __nv_bfloat16, or signed char with `scales`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ probe, const __nv_bfloat16* __restrict__ q,
             const T* __restrict__ blocks, const int* __restrict__ valid,
             const float* __restrict__ scales, float* __restrict__ out,
             int nprobe, int rpc, int d) {
  constexpr bool kInt8 = std::is_same<T, signed char>::value;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte piece
  extern __shared__ float q_s[];        // [d]

  const int p = blockIdx.y, b = blockIdx.z;
  const long long cluster = probe[(long long)b * nprobe + p];
  for (int i = threadIdx.x; i < d; i += kThreads) q_s[i] = __bfloat162float(q[(long long)b * d + i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_vec = d / kVec;
  float* out_row = out + ((long long)b * nprobe + p) * rpc;
  const int r_begin = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int r_end = min(r_begin + kRowsPerWarp, rpc);
  for (int r = r_begin; r < r_end; ++r) {
    const long long slot = cluster * rpc + r;
    if (valid[slot] == 0) {
      if (lane == 0) out_row[r] = -CUDART_INF_F;
      continue;
    }
    const int4* row = reinterpret_cast<const int4*>(blocks + slot * d);
    float acc = 0.0f;
#pragma unroll 4
    for (int v = lane; v < n_vec; v += 32) acc += dot_piece<T>(row[v], q_s + v * kVec);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      if constexpr (kInt8) acc *= scales[slot];  // f32 dot x f32 row scale
      out_row[r] = acc;
    }
  }
}

template <typename T>
cudaError_t launch(const void* probe, const void* q, const void* blocks, const void* valid,
                   const float* scales, void* out, int b, int nprobe, int rpc, int d, cudaStream_t s) {
  dim3 grid((rpc + kRowsPerBlock - 1) / kRowsPerBlock, nprobe, b);
  probe_kernel<T><<<grid, kThreads, d * sizeof(float), s>>>(
      static_cast<const int*>(probe), static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(blocks),
      static_cast<const int*>(valid), scales, static_cast<float*>(out), nprobe, rpc, d);
  return cudaGetLastError();
}

}  // namespace

// probe: (b, nprobe) int32 cluster ids in [0, n_clusters); q: (b, d) bf16;
// blocks: (n_clusters, rpc, d) bf16 when `scales` is null, else int8 with
// `scales` (n_clusters, rpc) f32; valid: (n_clusters, rpc) int32; out:
// (b, nprobe, rpc) f32. d a multiple of 16 with d * 4 bytes of shared
// memory; blocks 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int tt_ivf_probe_scores(const void* probe, const void* q, const void* blocks,
                                   const void* valid, const void* scales, void* out, int b,
                                   int nprobe, int rpc, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  return sc ? launch<signed char>(probe, q, blocks, valid, sc, out, b, nprobe, rpc, d, s)
            : launch<__nv_bfloat16>(probe, q, blocks, valid, nullptr, out, b, nprobe, rpc, d, s);
}
