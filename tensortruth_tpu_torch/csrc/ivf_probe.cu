// IVF probe scores over bf16 or int8 cluster blocks (kernel B4, both
// variants).
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
// device memory: at best each valid row of each probed cluster is read once.
//
// bf16 blocks (the first design, kept): each CUDA block, one per (row tile,
// probe, query), loads probe[b, p] itself (the TPU scalar-prefetches it) and
// copies q_b to shared memory as f32 once; each warp then scores 16 rows of
// the tile, its lanes reading a row in 16-byte pieces and reducing the row's
// partial sums with warp shuffles. A slot whose `valid` is 0 is skipped
// without reading its row. A probed block is read once per query that
// probes it.
//
// int8 blocks: each probed cluster is read once for all the (query, probe)
// pairs that name it, on B2's machinery (fused_topk.cu, hopper.cuh).
// * group_kernel (one block) sorts the B * nprobe pairs by cluster (a
//   counting sort: histogram, scan, scatter) and cuts each cluster's pairs
//   into chunks of at most 32, wgmma's N: (cluster, first pair, count). The
//   chunk count stays on the device; the host never waits for it. A query
//   may name a cluster twice and a cluster may be named by more than 32
//   pairs: pairs, not queries, are grouped.
// * score_kernel is persistent (one block an SM): work items are (chunk,
//   range of 64-row steps of its cluster), walked round-robin by the blocks;
//   every output element has one writer, so no order matters. Each block
//   reads the chunk count and cuts every cluster into the fewest ranges that
//   give each block kProbeItemsPerBlock items: each item costs a staging of
//   its queries and a barrier, so whole clusters are the items when there
//   are enough of them. The block's two consumer warpgroups share an item's
//   queries, staged once per item in shared memory (32 x D bf16, zero
//   columns past the chunk's count and dims past D, each 16 dims permuted
//   as ops/topk.py::permute_dims) and take its steps in turn.
// * Each warpgroup's producer warp streams the rows by TMA (a 2-D map over
//   (n_clusters * rpc, D) int8, 128-byte swizzle, boxes of 128 dims x 64
//   rows) into its ring; a step without a valid slot is not read at all
//   (the producer warp and the consumers each OR the step's `valid` flags).
// * The consumers convert each box exactly to bf16 in registers and run
//   wgmma m64n32k16 with A from registers (hopper.cuh, consume_int8_box).
//   The epilogue multiplies the f32 dot by the f32 row scale, writes -inf
//   exactly where `valid` is 0, drops rows of a box past rpc (any rpc
//   works), and writes out[pair, r] for each of the chunk's pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// -- bf16 blocks ---------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ probe, const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ blocks, const int* __restrict__ valid,
             float* __restrict__ out, int nprobe, int rpc, int d) {
  constexpr int kVec = 8;  // elements per 16-byte piece
  extern __shared__ float q_s[];  // [d]

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
    for (int v = lane; v < n_vec; v += 32) {
      const int4 raw = row[v];
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float* qv = q_s + v * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc = fmaf(__bfloat162float(x[i]), qv[i], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out_row[r] = acc;
  }
}

// -- int8 blocks ---------------------------------------------------------------

constexpr int kProbeConsumers = 2;   // warpgroups per block, sharing each item's queries (stage_queries: 256 threads)
constexpr int kProbeStages = 6;      // ring stages per warpgroup
constexpr int kProbeItemsPerBlock = 4;  // work items a block walks, at least: a cluster's steps cut as needed
constexpr int kProbeThreads = kProbeConsumers * (128 + 32);  // the consumer warpgroups, then one producer warp each
constexpr int kChunk = 32;           // pairs per chunk: wgmma's N
constexpr int kSmemLimit = 232448;
constexpr int kBarBytes = 8 * 2 * kProbeConsumers * kProbeStages;
constexpr int kGroupThreads = 1024;

// Shared memory at dimension d: the chunk's queries in units of 128 dims (a
// row box's span), the rings, the barriers.
__host__ __device__ inline int query_bytes(int d) { return (d + 127) / 128 * 2 * kQueryBox; }
inline int stages_for(int d) {
  const int room = (kSmemLimit - 1024 - kBarBytes - query_bytes(d)) / (kProbeConsumers * kRowsBox);
  return room < kProbeStages ? room : kProbeStages;
}
inline int smem_bytes(int d) { return 1024 + query_bytes(d) + kProbeConsumers * stages_for(d) * kRowsBox + kBarBytes; }

// Exclusive prefix sums of two per-thread values over the block (1024
// threads); `carry` holds the totals so far and is advanced by this tile.
__device__ __forceinline__ int2 block_scan(int a, int b, int2* warp_sums, int2& carry) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int ia = a, ib = b;  // inclusive within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(0xffffffffu, ia, off), ub = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) ia += ua, ib += ub;
  }
  if (lane == 31) warp_sums[warp] = make_int2(ia, ib);
  __syncthreads();
  if (warp == 0) {
    int2 w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ua = __shfl_up_sync(0xffffffffu, w.x, off), ub = __shfl_up_sync(0xffffffffu, w.y, off);
      if (lane >= off) w.x += ua, w.y += ub;
    }
    warp_sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const int2 before = warp > 0 ? warp_sums[warp - 1] : make_int2(0, 0);
  const int2 out = make_int2(carry.x + before.x + ia - a, carry.y + before.y + ib - b);
  const int2 total = warp_sums[31];
  __syncthreads();  // warp_sums is rewritten by the next tile
  carry.x += total.x, carry.y += total.y;
  return out;
}

// Pairs x = b * nprobe + p grouped by cluster probe[x]: order[] lists them
// cluster by cluster (ascending clusters; within one, in no set order);
// chunks[3k .. 3k + 2] = (cluster, first position in order, count <= 32) for
// k < *n_chunks, a cluster's chunks in a row. count/cursor: (n_clusters,)
// scratch.
__global__ void __launch_bounds__(kGroupThreads)
group_kernel(const int* __restrict__ probe, int* __restrict__ count, int* __restrict__ cursor,
             int* __restrict__ order, int* __restrict__ chunks, int* __restrict__ n_chunks, int n_pairs,
             int n_clusters) {
  __shared__ int2 warp_sums[32];
  for (int c = threadIdx.x; c < n_clusters; c += kGroupThreads) count[c] = 0;
  __syncthreads();
  for (int x = threadIdx.x; x < n_pairs; x += kGroupThreads) atomicAdd(&count[probe[x]], 1);
  __syncthreads();
  int2 carry = make_int2(0, 0);  // (pairs, chunks) of the clusters before this tile
  for (int c0 = 0; c0 < n_clusters; c0 += kGroupThreads) {
    const int c = c0 + threadIdx.x;
    const int n = c < n_clusters ? count[c] : 0;
    const int2 start = block_scan(n, (n + kChunk - 1) / kChunk, warp_sums, carry);
    if (c < n_clusters) cursor[c] = start.x;
    for (int k = 0; k * kChunk < n; ++k) {
      int* chunk = chunks + 3 * (start.y + k);
      chunk[0] = c, chunk[1] = start.x + k * kChunk, chunk[2] = min(kChunk, n - k * kChunk);
    }
  }
  if (threadIdx.x == 0) *n_chunks = carry.y;
  __syncthreads();
  for (int x = threadIdx.x; x < n_pairs; x += kGroupThreads) order[atomicAdd(&cursor[probe[x]], 1)] = x;
}

// Whether any slot of 64-row step s of cluster c is valid (one warp).
__device__ __forceinline__ bool step_has_valid(const int* __restrict__ valid, long long c, int rpc, int s, int lane) {
  const int r0 = s * 64 + lane, r1 = r0 + 32;
  const bool v = (r0 < rpc && valid[c * rpc + r0] > 0) || (r1 < rpc && valid[c * rpc + r1] > 0);
  return __any_sync(0xffffffffu, v);
}

// The chunk's queries into q_s by 256 threads, 8 a column: column n holds
// the query of pair pairs[n] (zeros from the count on, and past d), in boxes
// of 64 dims x 32 columns, 128-byte swizzled, each 16 dims permuted as
// ops/topk.py::permute_dims: words {0, 2, 4, 6} of each 16 dims, then
// {1, 3, 5, 7}. A thread loads four 32-byte groups before it stores any, so
// the L2 reads of an item's queries overlap.
__device__ __forceinline__ void stage_queries(unsigned char* q_s, const __nv_bfloat16* __restrict__ q,
                                              const int* __restrict__ pairs, int count, int nprobe, int d, int tid) {
  const int groups = (d + 127) / 128 * 8;  // 16-dim groups, to whole row boxes
  const int n = tid / 8, sub = tid % 8;
  const uint4* src = reinterpret_cast<const uint4*>(q + (long long)(n < count ? pairs[n] / nprobe : 0) * d);
  for (int g0 = sub; g0 < groups; g0 += 32) {
    uint4 lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = g0 + 8 * i;
      lo[i] = hi[i] = make_uint4(0, 0, 0, 0);
      if (n < count && 16 * g < d) {
        const uint4 w0 = __ldg(src + 2 * g), w1 = __ldg(src + 2 * g + 1);
        lo[i] = make_uint4(w0.x, w0.z, w1.x, w1.z);
        hi[i] = make_uint4(w0.y, w0.w, w1.y, w1.w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = g0 + 8 * i;
      if (g >= groups) break;
      unsigned char* row = q_s + (g / 4) * kQueryBox + n * 128;
      const int c0 = (g % 4) * 2;
      *reinterpret_cast<uint4*>(row + ((c0 ^ (n & 7)) << 4)) = lo[i];
      *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (n & 7)) << 4)) = hi[i];
    }
  }
}

// A work item: the cluster, pairs and 64-row steps [s_begin, s_end) of
// item = chunk * ranges + range.
struct ProbeItem {
  int cluster, first, count, s_begin, s_end;
};

__device__ __forceinline__ ProbeItem decode(const int* __restrict__ chunks, int item, int ranges, int steps) {
  const int* chunk = chunks + 3 * (item / ranges);
  const int range = item % ranges;
  return {chunk[0], chunk[1], chunk[2], range * steps / ranges, (range + 1) * steps / ranges};
}

__global__ void __launch_bounds__(kProbeThreads, 1)
score_kernel(const __grid_constant__ CUtensorMap map_e, const __nv_bfloat16* __restrict__ q,
             const int* __restrict__ order, const int* __restrict__ chunks, const int* __restrict__ n_chunks,
             const int* __restrict__ valid, const float* __restrict__ scales, float* __restrict__ out, int nprobe,
             int rpc, int d, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  const int qbytes = query_bytes(d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp < 4 * kProbeConsumers ? warp / 4 : warp - 4 * kProbeConsumers;  // consumer or producer of wg
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + qbytes + kProbeConsumers * stages * kRowsBox);
  uint64_t* full = bars + wg * 2 * kProbeStages;
  uint64_t* empty = full + kProbeStages;
  unsigned char* ring = smem + qbytes + wg * stages * kRowsBox;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kProbeConsumers; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(&bars[w * 2 * kProbeStages + s], 1);
        mbar_init(&bars[w * 2 * kProbeStages + kProbeStages + s], 4);
      }
    mbar_init_fence();
  }
  __syncthreads();

  const int steps = (rpc + 63) / 64;
  const int ranges = min(steps, (kProbeItemsPerBlock * gridDim.x + *n_chunks - 1) / *n_chunks);
  const int n_items = *n_chunks * ranges;
  const int n_boxes = (d + 127) / 128;

  if (warp >= 4 * kProbeConsumers) {  // producer of warpgroup wg
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const ProbeItem it = decode(chunks, item, ranges, steps);
      for (int s = it.s_begin + wg; s < it.s_end; s += kProbeConsumers) {
        if (!step_has_valid(valid, it.cluster, rpc, s, lane)) continue;
        if (lane == 0)  // the other lanes only help decide which steps hold a valid slot
          for (int bx = 0; bx < n_boxes; ++bx) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], kRowsBox);
            tma_load_2d(ring + stage * kRowsBox, &map_e, &full[stage], bx * 128, it.cluster * rpc + s * 64);
            if (++stage == stages) stage = 0, phase ^= 1;
          }
        __syncwarp();
      }
    }
    return;
  }

  // Consumer warpgroup wg. A thread holds rows r and r + 8 of each step's 64
  // (its warp's 16, r % 8 == lane / 4) and the chunk's columns 8j + 2t,
  // 8j + 2t + 1.
  const int t = lane % 4;
  const int r = (warp % 4) * 16 + lane / 4;
  Ring ring_state{ring, full, empty, stages, 0, 0, -1};
  float acc[16];  // a step's scores; its first wgmma overwrites them
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const ProbeItem it = decode(chunks, item, ranges, steps);
    named_sync(1, 128 * kProbeConsumers);  // both warpgroups are done with the last item's queries
    stage_queries(q_s, q, order + it.first, it.count, nprobe, d, threadIdx.x);
    fence_async_shared();
    named_sync(1, 128 * kProbeConsumers);
    int pair[8];  // [2j + e]: the pair of column 8j + 2t + e, or -1
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t + e;
        pair[2 * j + e] = n < it.count ? order[it.first + n] : -1;
      }
    // Rows r and r + 8 of step s: whether each is a valid slot, and its
    // scale; the next step's are loaded while this one's boxes go by.
    const long long slots = (long long)it.cluster * rpc;
    auto load_step = [&](int s, bool (&ok)[2], float (&scale)[2]) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int row = s * 64 + r + 8 * v;
        ok[v] = s < it.s_end && row < rpc && valid[slots + row] > 0;
        scale[v] = ok[v] ? scales[slots + row] : 0.0f;
      }
    };
    bool ok[2], next_ok[2];
    float scale[2], next_scale[2];
    load_step(it.s_begin + wg, ok, scale);
    for (int s = it.s_begin + wg; s < it.s_end; s += kProbeConsumers) {
      const bool any = named_any(2 + wg, 128, ok[0] || ok[1]);  // then the producer loaded this step
      load_step(s + kProbeConsumers, next_ok, next_scale);
      if (any) {
        for (int bx = 0; bx < n_boxes; ++bx) consume_int8_box(ring_state, q_s, bx, r, lane, acc);
        wgmma_wait<0>();
        fence_regs(acc);
      }
      const int row[2] = {s * 64 + r, s * 64 + r + 8};
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (row[v] >= rpc) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = pair[2 * j + e];
            if (p >= 0)  // f32 dot x f32 row scale; -inf exactly on the padding slots
              out[(long long)p * rpc + row[v]] = ok[v] ? acc[4 * j + 2 * v + e] * scale[v] : -CUDART_INF_F;
          }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) ok[v] = next_ok[v], scale[v] = next_scale[v];
    }
  }
}

}  // namespace

// probe: (b, nprobe) int32 cluster ids in [0, n_clusters); q: (b, d) bf16;
// blocks: (n_clusters, rpc, d) bf16; valid: (n_clusters, rpc) int32; out:
// (b, nprobe, rpc) f32. d a multiple of 16 with d * 4 bytes of shared
// memory; blocks 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int tt_ivf_probe_scores(const void* probe, const void* q, const void* blocks, const void* valid, void* out,
                                   int b, int nprobe, int rpc, int d, void* stream) {
  dim3 grid((rpc + kRowsPerBlock - 1) / kRowsPerBlock, nprobe, b);
  probe_kernel<<<grid, kThreads, d * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probe), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(blocks), static_cast<const int*>(valid), static_cast<float*>(out), nprobe,
      rpc, d);
  return cudaGetLastError();
}

// probe: (n_pairs,) int32 cluster ids in [0, n_clusters), the flattened
// (b, nprobe) array; scratch: (2 * n_clusters,) int32; order: (n_pairs,)
// int32; chunks: (n_pairs, 3) int32; n_chunks: (1,) int32 (group_kernel says
// what they hold). Returns the CUDA error of the launch.
extern "C" int tt_ivf_group_probes(const void* probe, void* scratch, void* order, void* chunks, void* n_chunks,
                                   int n_pairs, int n_clusters, void* stream) {
  int* counts = static_cast<int*>(scratch);
  group_kernel<<<1, kGroupThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probe), counts, counts + n_clusters, static_cast<int*>(order),
      static_cast<int*>(chunks), static_cast<int*>(n_chunks), n_pairs, n_clusters);
  return cudaGetLastError();
}

// B4 over int8 blocks, after tt_ivf_group_probes on the same stream: q (b, d)
// bf16, 16-byte aligned; blocks (n_clusters, rpc, d) int8 with scales and
// valid (n_clusters, rpc) f32 / int32; order, chunks, n_chunks as grouped;
// out (b, nprobe, rpc) f32. d a multiple of 16 and at most 2048;
// n_clusters * rpc < 2^31. Returns the CUDA error of the launch
// (cudaErrorInvalidValue if the tensor map cannot be encoded).
extern "C" int tt_ivf_probe_scores_int8(const void* q, const void* blocks, const void* valid, const void* scales,
                                        const void* order, const void* chunks, const void* n_chunks, void* out,
                                        int nprobe, int n_clusters, int rpc, int d, void* stream) {
  const uint64_t dims[2] = {uint64_t(d), uint64_t(n_clusters) * rpc}, strides[1] = {uint64_t(d)};
  const uint32_t box[2] = {128, 64};
  alignas(64) CUtensorMap map_e;
  if (stages_for(d) < 1 || !encode_map(&map_e, CU_TENSOR_MAP_DATA_TYPE_UINT8, blocks, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  score_kernel<<<sms, kProbeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map_e, static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(order), static_cast<const int*>(chunks),
      static_cast<const int*>(n_chunks), static_cast<const int*>(valid), static_cast<const float*>(scales),
      static_cast<float*>(out), nprobe, rpc, d, stages_for(d));
  return cudaGetLastError();
}
