// Fused matmul + bucketed top-k candidates over a bf16 corpus (kernel B1)
// or an int8 corpus with per-row f32 scales (kernel B2).
//
// Replaces: tensortruth_tpu/ops/topk.py::_fused_kernel, reached through
// fused_topk (B1, the pl.pallas_call at ops/topk.py:233) and, with
// quantized=True, through fused_topk_int8 (B2, the pl.pallas_call at
// ops/topk.py:383).
//
// What it computes (identical to the TPU kernel): scores Q(B, D) . E(N, D)^T
// with f32 accumulation, tile by tile of `tile_n` corpus rows; for an int8
// corpus the rows are converted to bf16 (exact: |v| <= 128) and each f32
// score is then multiplied by its row's f32 scale, after the dot, as the
// reference does (pre-scaling the rows would round differently and could
// change the order of ties); rows at or past `n_actual` are masked to -inf;
// each tile is reduced to c = tile_n / m strided-bucket max + argmax (bucket
// j = rows {j, j + c, ..., j + (m-1)c} of the tile); the per-tile result
// max-merges into a (B, c_out) candidate accumulator where tile
// t * n_rot + b feeds candidate block b. Ties keep the earlier segment and
// the earlier tile (strict `>` everywhere). The final top-k over the
// candidates runs outside, in torch, as in the reference.
//
// What bounds it on an H100: at the serving batch (B = 32, D = 1024) every
// corpus row costs 2 KB (bf16) or 1 KB (int8) of HBM reads for 64 kFLOP,
// 32 or 64 FLOP/byte, far under the ~295 FLOP/byte at which bf16 tensor
// cores stop waiting on HBM. So it is bound by device memory, and the design
// goal is to read E exactly once with every byte of each fetched sector used.
//
// Order: the TPU kernel walks each candidate block's tiles in a sequential
// grid with the accumulator resident in VMEM. Blocks here run in parallel and
// in no order, so each candidate block's tile sequence is cut into contiguous
// ascending ranges; one worker walks the (tile, segment) steps of a (range,
// candidate block, 64-slot chunk) in ascending order with a strict `>`,
// keeps the 32 x 64 best values and indices, and writes one partial per
// range. A second, elementwise pass merges the partials in ascending range
// order with a strict `>`. First occurrence in (tile, segment) order wins,
// which is exactly the reference's rule (earlier segment, then earlier tile).
//
// Design, one kernel template for both (topk_stream_kernel<Rows>):
// * Persistent: the blocks the SMs hold at once (tt_fused_topk_occupancy,
//   one an SM) are split between the 32-query blocks; a block's consumer
//   warpgroups each walk their own work items, (range, candidate block, slot
//   chunk) in turn, so every (slot, query) pair has one owner and its steps
//   are seen in ascending order. The wrapper picks the number of ranges that
//   balances the items over the warpgroups (ops/topk.py::stream_schedule,
//   which also states the item order).
// * Each consumer warpgroup has a producer warp and a ring of up to 6 stages
//   of 8 KiB: the producer streams the rows by TMA (a 2-D map over (N, D),
//   128-byte swizzle, boxes of 64 rows x 128 bytes: 64 bf16 or 128 int8
//   dims). The block's 32 queries are loaded once by TMA into shared memory
//   (64 KiB at D = 1024); what is left of the 227 KB goes to the rings.
// * A step's 64 rows are the M of wgmma m64n32k16, the queries its N.
//   B1 (Bf16Rows): both operands from shared memory, A the ring stage and B
//   the queries, in the same 128-byte swizzle (descriptors +32 bytes per k16
//   inside a box); a stage is freed once the wgmma group after the one that
//   read it has been committed and the one before has retired (wait_group 1),
//   so one box's products overlap the next box's wait. No register holds A,
//   so the serialisation B2 has to avoid (below) cannot arise.
//   B2 (Int8Rows): A from registers: each consumer thread reads 4 consecutive
//   dims of rows g and g + 8 of its warp's 16 with 32-bit ld.shared
//   (conflict-free under the swizzle), converts them exactly to bf16
//   (hopper.cuh's bf16x4_from_s8x4) and frees the stage; the wrapper stores
//   the queries with each 16 dims permuted to the fragments' k order
//   (ops/topk.py::permute_dims), which leaves every dot product's terms
//   unchanged. The A registers are rewritten only after the last box's
//   wgmmas retire (hopper.cuh, consume_int8_box); the other warpgroup keeps
//   the tensor cores busy meanwhile.
// * The m64n32 accumulator is laid out by row: a thread owns 2 rows x 8
//   queries, multiplies them by its two rows' scales (B2; loaded as the step
//   starts) and max-merges them into its own 16 best values and indices in
//   registers. No score goes through shared memory, and no barrier spans
//   the block after the start.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQB = 32;  // queries per block
constexpr int kSJ = 64;  // candidate slots (rows) per step
constexpr int kSmemLimit = 232448;

constexpr int kBf16Stages = 6;     // B1: ring stages per warpgroup
constexpr int kBf16Consumers = 2;  // B1: consumer warpgroups per block
constexpr int kInt8Stages = 6;     // B2: ring stages per warpgroup
constexpr int kInt8Consumers = 2;  // B2: consumer warpgroups per block

// D(64x32) += A(64x16) . B(16x32): bf16 operands K-major in shared memory,
// f32 sums in registers; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// B1's rows: a box is 64 bf16 dims of a step's 64 rows, which wgmma reads
// from the ring stage itself.
struct Bf16Rows {
  static constexpr int kBoxDims = 64, kConsumers = kBf16Consumers, kMaxStages = kBf16Stages;
  static constexpr bool kScaled = false;

  // 4 wgmmas of the box against the queries' same 64 dims, committed; then
  // the group before has retired, and the stage it read is freed.
  static __device__ __forceinline__ void consume_box(Ring& ring, const unsigned char* q_s, int bx, int, int lane,
                                                     float (&acc)[16]) {
    mbar_wait(&ring.full[ring.stage], ring.phase);
    const unsigned char* rows = ring.base + ring.stage * kRowsBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n32k16_ss(acc, smem_desc(rows + kk * 32, 16, 1024), smem_desc(q_s + bx * kQueryBox + kk * 32, 16, 1024),
                         bx > 0 || kk > 0);
    wgmma_commit();
    if (ring.held >= 0) {
      wgmma_wait<1>();  // B1: the box before has been read
      if (lane == 0) mbar_arrive(&ring.empty[ring.held]);
    }
    ring.held = ring.stage;
    if (++ring.stage == ring.stages) ring.stage = 0, ring.phase ^= 1;
  }

  static __device__ __forceinline__ void end_step(Ring& ring, int lane) {
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&ring.empty[ring.held]);
    ring.held = -1;
  }
};

// B2's rows: a box is 128 int8 dims, converted to bf16 in registers.
struct Int8Rows {
  static constexpr int kBoxDims = 128, kConsumers = kInt8Consumers, kMaxStages = kInt8Stages;
  static constexpr bool kScaled = true;

  static __device__ __forceinline__ void consume_box(Ring& ring, const unsigned char* q_s, int bx, int r, int lane,
                                                     float (&acc)[16]) {
    consume_int8_box(ring, q_s, bx, r, lane, acc);
  }

  static __device__ __forceinline__ void end_step(Ring&, int) { wgmma_wait<0>(); }
};

template <class Rows>
__host__ __device__ constexpr int threads_of() {
  return Rows::kConsumers * (128 + 32);  // the consumer warpgroups, then one producer warp each
}

template <class Rows>
__host__ __device__ constexpr int bar_bytes() {
  return 8 * (1 + 2 * Rows::kConsumers * Rows::kMaxStages);
}

// Shared memory at dimension d: the queries in units of a box's dims (zeros
// past d), the rings, the barriers.
template <class Rows>
__host__ __device__ inline int query_bytes(int d) {
  return (d + Rows::kBoxDims - 1) / Rows::kBoxDims * (Rows::kBoxDims / 64) * kQueryBox;
}

template <class Rows>
inline int stages_for(int d) {
  const int room = (kSmemLimit - 1024 - bar_bytes<Rows>() - query_bytes<Rows>(d)) / (Rows::kConsumers * kRowsBox);
  return room < Rows::kMaxStages ? room : Rows::kMaxStages;
}

template <class Rows>
inline int smem_bytes(int d) {
  return 1024 + query_bytes<Rows>(d) + Rows::kConsumers * stages_for<Rows>(d) * kRowsBox + bar_bytes<Rows>();
}

// A work item: item = (range * n_rot + rot) * chunks + chunk, walked by
// worker item % workers; its steps walk the range's (tile, segment) pairs in
// ascending order up to the first step past n_actual.
struct Item {
  int range, rot, j0, t_begin, n_steps;
  __device__ __forceinline__ long long row0(int step, int m, int n_rot, int tile_n, int c) const {
    const int t = t_begin + step / m, i = step % m;
    return (long long)(t * n_rot + rot) * tile_n + (long long)i * c + j0;
  }
};

__device__ __forceinline__ Item decode(int item, int chunks, int n_rot, int n_ranges, int inner, int m, int tile_n,
                                       int c, long long n_actual) {
  Item it;
  it.j0 = (item % chunks) * kSJ;
  it.rot = (item / chunks) % n_rot;
  it.range = item / (chunks * n_rot);
  it.t_begin = (int)((long long)it.range * inner / n_ranges);
  const int t_end = (int)((long long)(it.range + 1) * inner / n_ranges);
  it.n_steps = 0;
  while (it.n_steps < (t_end - it.t_begin) * m && it.row0(it.n_steps, m, n_rot, tile_n, c) < n_actual) ++it.n_steps;
  return it;
}

template <class Rows>
__global__ void __launch_bounds__(threads_of<Rows>(), 1)
topk_stream_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_e,
                   const float* __restrict__ scales, float* __restrict__ part_vals, int* __restrict__ part_idx,
                   int b_pad, int d, long long n_actual, int tile_n, int m, int n_rot, int inner, int n_ranges,
                   int c_out, int stages) {
  constexpr int kConsumers = Rows::kConsumers, kMaxStages = Rows::kMaxStages, kThreads = threads_of<Rows>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  const int qbytes = query_bytes<Rows>(d);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + qbytes + kConsumers * stages * kRowsBox);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp < 4 * kConsumers ? warp / 4 : warp - 4 * kConsumers;  // consumer or producer of warpgroup wg
  uint64_t* full = q_full + 1 + wg * 2 * kMaxStages;
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + qbytes + wg * stages * kRowsBox;

  const int c = tile_n / m, chunks = c / kSJ;
  const int q0 = blockIdx.y * kQB;
  const int n_items = n_ranges * n_rot * chunks;
  const int worker = blockIdx.x * kConsumers + wg, workers = gridDim.x * kConsumers;
  const int q_loaded = (d + 63) / 64;  // 64-dim query boxes TMA fills; the rest of qbytes is zeroed
  const int n_boxes = (d + Rows::kBoxDims - 1) / Rows::kBoxDims;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(&q_full[1 + w * 2 * kMaxStages + s], 1);
        mbar_init(&q_full[1 + w * 2 * kMaxStages + kMaxStages + s], 4);
      }
    mbar_init_fence();
  }
  for (int i = q_loaded * kQueryBox / 16 + threadIdx.x; i < qbytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // producer of warpgroup wg
    if (lane != 0) return;
    if (wg == 0) {
      mbar_arrive_expect_tx(q_full, q_loaded * kQueryBox);
      for (int x = 0; x < q_loaded; ++x) tma_load_2d(q_s + x * kQueryBox, &map_q, q_full, 64 * x, q0);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int item = worker; item < n_items; item += workers) {
      const Item it = decode(item, chunks, n_rot, n_ranges, inner, m, tile_n, c, n_actual);
      for (int s = 0; s < it.n_steps; ++s) {
        const int row0 = (int)it.row0(s, m, n_rot, tile_n, c);
        for (int bx = 0; bx < n_boxes; ++bx) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kRowsBox);
          tma_load_2d(ring + stage * kRowsBox, &map_e, &full[stage], bx * Rows::kBoxDims, row0);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg. A thread holds rows r and r + 8 of each step's 64
  // (its warp's 16, r % 8 == lane / 4) and queries 8j + 2t, 8j + 2t + 1.
  const int t = lane % 4;
  const int r = (warp % 4) * 16 + lane / 4;
  mbar_wait(q_full, 0);
  Ring ring_state{ring, full, empty, stages, 0, 0, -1};
  float acc[16];  // a step's scores; its first wgmma overwrites them
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;

  for (int item = worker; item < n_items; item += workers) {
    const Item it = decode(item, chunks, n_rot, n_ranges, inner, m, tile_n, c, n_actual);
    float best_val[16];  // [v * 8 + 2j + e]: row r + 8v, query 8j + 2t + e
    int best_idx[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      best_val[u] = -CUDART_INF_F;
      best_idx[u] = -1;
    }
    for (int s = 0; s < it.n_steps; ++s) {
      const long long row0 = it.row0(s, m, n_rot, tile_n, c) + r;
      float scale[2] = {1.0f, 1.0f};
      if constexpr (Rows::kScaled) scale[0] = __ldg(scales + row0), scale[1] = __ldg(scales + row0 + 8);
      for (int bx = 0; bx < n_boxes; ++bx) Rows::consume_box(ring_state, q_s, bx, r, lane, acc);
      Rows::end_step(ring_state, lane);
      fence_regs(acc);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const long long row = row0 + 8 * v;
        if (row >= n_actual) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = acc[4 * j + 2 * v + e];
            if constexpr (Rows::kScaled) x *= scale[v];  // f32 score x f32 row scale
            const int u = v * 8 + 2 * j + e;
            if (x > best_val[u]) {
              best_val[u] = x;
              best_idx[u] = (int)row;
            }
          }
      }
    }
    const long long base = ((long long)it.range * b_pad + q0) * c_out + it.rot * c + it.j0 + r;
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long out = base + (long long)(8 * j + 2 * t + e) * c_out + 8 * v;
          part_vals[out] = best_val[v * 8 + 2 * j + e];
          part_idx[out] = best_idx[v * 8 + 2 * j + e];
        }
  }
}

// Merge the per-range partials in ascending range order, strict `>`.
__global__ void topk_merge_kernel(const float* __restrict__ part_vals,
                                  const int* __restrict__ part_idx,
                                  float* __restrict__ cand_vals,
                                  int* __restrict__ cand_idx, int n_ranges,
                                  long long total) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= total) return;
  float best = -CUDART_INF_F;
  int best_i = -1;
  for (int r = 0; r < n_ranges; ++r) {
    const float v = part_vals[r * total + x];
    if (v > best) {
      best = v;
      best_i = part_idx[r * total + x];
    }
  }
  cand_vals[x] = best;
  cand_idx[x] = best_i;
}

template <class Rows>
int occupancy(int d, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(topk_stream_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<Rows>(d));
  if (err != cudaSuccess) return err;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_stream_kernel<Rows>, threads_of<Rows>(),
                                                smem_bytes<Rows>(d));
  out[0] = per_sm * sms;
  out[1] = Rows::kConsumers;
  return cudaGetLastError();
}

template <class Rows>
int candidates(const void* q, const void* e, const void* scales, void* part_vals, void* part_idx, void* cand_vals,
               void* cand_idx, int b_pad, int d, long long n_actual, int tile_n, int m, int n_rot, int inner,
               int n_ranges, int blocks, cudaStream_t s) {
  constexpr int elem = Rows::kScaled ? 1 : 2;  // bytes per corpus element
  // The rows any step reads: the tiles that hold a row below n_actual.
  const uint64_t rows = uint64_t((n_actual + tile_n - 1) / tile_n) * tile_n;
  const uint64_t q_dims[2] = {uint64_t(d), uint64_t(b_pad)}, q_strides[1] = {uint64_t(d) * 2};
  const uint64_t e_dims[2] = {uint64_t(d), rows}, e_strides[1] = {uint64_t(d) * elem};
  const uint32_t q_box[2] = {64, kQB}, e_box[2] = {Rows::kBoxDims, kSJ};
  alignas(64) CUtensorMap map_q, map_e;
  if (!encode_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, 2, q_dims, q_strides, q_box) ||
      !encode_map(&map_e, Rows::kScaled ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, e, 2,
                  e_dims, e_strides, e_box))
    return cudaErrorInvalidValue;
  if (stages_for<Rows>(d) < 2) return cudaErrorInvalidValue;  // a stage is held while the next one fills
  const int smem = smem_bytes<Rows>(d);
  cudaError_t err = cudaFuncSetAttribute(topk_stream_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int c_out = n_rot * (tile_n / m);
  topk_stream_kernel<Rows><<<dim3(blocks, b_pad / kQB), threads_of<Rows>(), smem, s>>>(
      map_q, map_e, static_cast<const float*>(scales), static_cast<float*>(part_vals), static_cast<int*>(part_idx),
      b_pad, d, n_actual, tile_n, m, n_rot, inner, n_ranges, c_out, stages_for<Rows>(d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)b_pad * c_out;
  const int threads = 256;
  topk_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(part_vals), static_cast<const int*>(part_idx), static_cast<float*>(cand_vals),
      static_cast<int*>(cand_idx), n_ranges, total);
  return cudaGetLastError();
}

}  // namespace

// The partial pass of B2 (int8 != 0) or B1 at dimension d: out[0] = blocks
// the current device holds at once, out[1] = consumer warpgroups (workers)
// per block.
extern "C" int tt_fused_topk_occupancy(int int8, int d, int* out) {
  return int8 ? occupancy<Int8Rows>(d, out) : occupancy<Bf16Rows>(d, out);
}

// q: (b_pad, d) bf16, b_pad a multiple of 32, each 16 dims permuted
// (ops/topk.py::permute_dims) for an int8 corpus; e: (n_rows, d) bf16 when
// `scales` is null (B1), else int8 with `scales` (n_rows,) f32 (B2); n_rows a
// multiple of tile_n and >= n_actual; d a multiple of 16 and at most 2048; q
// and e 16-byte aligned. `blocks` persistent blocks per query block walk the
// n_ranges * n_rot * (tile_n / m / 64) work items. part_*: (n_ranges, b_pad,
// c_out) scratch; cand_*: (b_pad, c_out) with c_out = n_rot * tile_n / m.
// Returns the CUDA error of the launches (cudaErrorInvalidValue if a tensor
// map cannot be encoded).
extern "C" int tt_fused_topk_candidates(const void* q, const void* e, const void* scales, void* part_vals,
                                        void* part_idx, void* cand_vals, void* cand_idx, int b_pad, int d,
                                        long long n_actual, int tile_n, int m, int n_rot, int inner, int n_ranges,
                                        int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scales ? candidates<Int8Rows>(q, e, scales, part_vals, part_idx, cand_vals, cand_idx, b_pad, d, n_actual,
                                       tile_n, m, n_rot, inner, n_ranges, blocks, s)
                : candidates<Bf16Rows>(q, e, scales, part_vals, part_idx, cand_vals, cand_idx, b_pad, d, n_actual,
                                       tile_n, m, n_rot, inner, n_ranges, blocks, s);
}
