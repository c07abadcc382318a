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
// Shared by both: the TPU kernel walks each candidate block's tiles in a
// sequential grid with the accumulator resident in VMEM. Blocks here run in
// parallel and in no order, so each candidate block's tile sequence is cut
// into contiguous ascending ranges; one worker walks the (tile, segment)
// steps of a (range, 64-slot chunk, candidate block, 32-query block) in
// ascending order with a strict `>`, keeps the 32 x 64 best values and
// indices, and writes one partial per range. A second, elementwise pass
// merges the partials in ascending range order with a strict `>`. First
// occurrence in (tile, segment) order wins, which is exactly the reference's
// rule (earlier segment, then earlier tile).
//
// B1 (bf16 corpus; first design, kept): one CUDA block of 4 warps per work
// item, as many ranges as make all partial-pass blocks resident at once
// (tt_fused_topk_resident_blocks: one full wave). Corpus rows stream through
// shared memory with cp.async, 16 KB per stage (64 rows x 128 dims), two
// stages in flight; each warp scores 16 of the staged rows against the
// block's 32 queries with WMMA fragments (bf16 products, f32 sums); the
// scores go through shared memory to the bucket merge. The queries are copied
// to shared memory once per block: read from global memory they are re-read
// from L2 for every corpus tile (L1 is mostly given to shared memory), at
// twice the corpus's own traffic.
//
// B2 (int8 corpus): a TMA-fed stream with the bucket merge in registers.
// * Persistent: the blocks the SMs hold at once (tt_fused_topk_int8_occupancy,
//   one an SM) are split between the 32-query blocks; a block's two consumer
//   warpgroups each walk their own work items, (range, slot chunk, candidate
//   block) in turn, so every (slot, query) pair has one owner and its steps
//   are seen in ascending order. The wrapper picks the number of ranges that
//   balances the items over the warpgroups (ops/topk.py::int8_schedule, which
//   also states the item order).
// * Each warpgroup has a producer warp and a ring of up to 6 stages of 8 KiB:
//   the producer streams the int8 rows by TMA (a 2-D map over (N, D), 128-byte
//   swizzle, boxes of 128 dims x 64 rows), one box per 128 dims of a step.
//   The block's 32 queries are loaded once by TMA into shared memory (64 KiB
//   at D = 1024); what is left of the 227 KB goes to the rings.
// * A step's 64 rows are the M of wgmma m64n32k16 with A from registers: each
//   consumer thread reads 4 consecutive dims of one row with one 32-bit
//   ld.shared (conflict-free under the 128-byte swizzle) for rows g and g + 8
//   of its warp's 16, converts them exactly to bf16 (the byte + 128 into the
//   mantissa of 2^23, minus 2^23 + 128, packed by cvt.rn.bf16x2.f32), and frees
//   the stage as soon as the box is in registers. Fragment k-slots {2t, 2t+1}
//   then carry dims {4t, 4t+1} and slots {2t+8, 2t+9} dims {4t+2, 4t+3}: the
//   wrapper stores the queries (wgmma's B, K-major in shared memory) with the
//   same permutation of each 16 dims (ops/topk.py::permute_dims), which
//   leaves every dot product's terms unchanged. A box's bytes are loaded
//   while the last box's wgmmas run, and converted once they have retired
//   (consume_box says why); the other warpgroup keeps the tensor cores busy
//   meanwhile.
// * The m64n32 accumulator is laid out by row: a thread owns 2 rows x 8
//   queries, multiplies them by its two rows' scales (loaded as the step
//   starts) and max-merges them into its own 16 best values and indices in
//   registers. No score goes through shared memory, and no barrier spans
//   the block after the start.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

using namespace hopper;

constexpr int kQB = 32;                        // queries per block
constexpr int kSJ = 64;                        // candidate slots (rows) per step

// -- B1: bf16 corpus ----------------------------------------------------------

constexpr int kWarps = kSJ / 16;               // each warp scores 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kPairs = kQB * kSJ / kThreads;   // (query, slot) pairs a thread keeps
constexpr int kKC = 128;                       // bf16 dims per shared-memory stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ e,
                    float* __restrict__ part_vals, int* __restrict__ part_idx,
                    int b_pad, int d, long long n_actual, int tile_n, int m,
                    int n_rot, int inner, int n_ranges, int c_out) {
  constexpr int kVec = 8;                      // elements per 16-byte piece
  constexpr int kDims = kKC;                   // dims per stage: 16 KB of rows
  constexpr int kLdS = kDims + kVec;           // padded stage row (elements)
  __shared__ __align__(128) __nv_bfloat16 stage[2][kSJ * kLdS];
  __shared__ __align__(32) float scores[kQB * kSJ];
  extern __shared__ __align__(128) unsigned char dyn[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(dyn);  // [kQB][d + 8]
  const int ldq = d + 8;

  const int c = tile_n / m;
  const int j0 = blockIdx.x * kSJ;
  const int range = blockIdx.y;
  const int rot = blockIdx.z % n_rot;
  const int q0 = (blockIdx.z / n_rot) * kQB;
  const int t_begin = (int)((long long)range * inner / n_ranges);
  const int t_end = (int)((long long)(range + 1) * inner / n_ranges);
  const int warp = threadIdx.x / 32;
  const int n_chunks = (d + kDims - 1) / kDims;

  // First row of step s: steps walk (tile, segment) in ascending order; rows
  // only grow, so the steps before the first all-padding one are the work
  // (which also keeps every load inside E, a whole number of tiles).
  auto step_row0 = [&](int step) -> long long {
    const int t = t_begin + step / m, i = step % m;
    return (long long)(t * n_rot + rot) * tile_n + (long long)i * c + j0;
  };
  int n_steps = 0;
  while (n_steps < (t_end - t_begin) * m && step_row0(n_steps) < n_actual) ++n_steps;
  const int total = n_steps * n_chunks;

  // Stage (step, chunk) number p into stage[p & 1]; always commit a group so
  // that "all but the newest group done" means "p done".
  auto prefetch = [&](int p) {
    if (p < total) {
      const long long row0 = step_row0(p / n_chunks);
      const int k0 = (p % n_chunks) * kDims;
      const int pieces = min(kDims, d - k0) / kVec;
      __nv_bfloat16* buf = stage[p & 1];
      for (int x = threadIdx.x; x < kSJ * pieces; x += kThreads) {
        const int row = x / pieces, col = (x % pieces) * kVec;
        cp_async16(buf + row * kLdS + col, e + (row0 + row) * d + k0 + col);
      }
    }
    cp_async_commit();
  };

  float best_val[kPairs];
  int best_idx[kPairs];
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    best_val[u] = -CUDART_INF_F;
    best_idx[u] = -1;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
  wmma::fill_fragment(acc0, 0.0f);
  wmma::fill_fragment(acc1, 0.0f);
  if (total > 0) {
    const __nv_bfloat16* q_rows = q + (long long)q0 * d;
    for (int x = threadIdx.x; x < kQB * (d / 8); x += kThreads) {
      const int row = x / (d / 8), col = (x % (d / 8)) * 8;
      cp_async16(q_s + row * ldq + col, q_rows + (long long)row * d + col);
    }
  }
  prefetch(0);  // the queries ride in the first group
  for (int p = 0; p < total; ++p) {
    prefetch(p + 1);
    cp_async_wait_one();
    __syncthreads();  // stage p has landed for every thread

    const int kc = p % n_chunks;
    const int k0 = kc * kDims;
    const int len = min(kDims, d - k0);
    const __nv_bfloat16* rows = stage[p & 1] + warp * 16 * kLdS;
    for (int kk = 0; kk < len; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa0, fa1;
      wmma::load_matrix_sync(fb, rows + kk, kLdS);
      wmma::load_matrix_sync(fa0, q_s + k0 + kk, ldq);
      wmma::load_matrix_sync(fa1, q_s + 16 * ldq + k0 + kk, ldq);
      wmma::mma_sync(acc0, fa0, fb, acc0);
      wmma::mma_sync(acc1, fa1, fb, acc1);
    }

    if (kc == n_chunks - 1) {  // the step's scores are complete
      const long long row0 = step_row0(p / n_chunks);
      wmma::store_matrix_sync(scores + warp * 16, acc0, kSJ, wmma::mem_row_major);
      wmma::store_matrix_sync(scores + 16 * kSJ + warp * 16, acc1, kSJ, wmma::mem_row_major);
      wmma::fill_fragment(acc0, 0.0f);
      wmma::fill_fragment(acc1, 0.0f);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const int pair = threadIdx.x + u * kThreads;  // = query * kSJ + slot
        const long long row = row0 + (pair % kSJ);
        if (row < n_actual) {
          const float v = scores[pair];
          if (v > best_val[u]) {
            best_val[u] = v;
            best_idx[u] = (int)row;
          }
        }
      }
    }
    __syncthreads();  // stage[p & 1] and `scores` are rewritten next
  }

#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    const int pair = threadIdx.x + u * kThreads;
    const long long out =
        ((long long)range * b_pad + q0 + pair / kSJ) * c_out + rot * c + j0 + pair % kSJ;
    part_vals[out] = best_val[u];
    part_idx[out] = best_idx[u];
  }
}

// -- B2: int8 corpus ----------------------------------------------------------

namespace int8_stream {

constexpr int kBoxBytes = 128;                 // dims of an int8 row per TMA box: the swizzle's span
constexpr int kBox = kSJ * kBoxBytes;          // 8 KiB: one step's 64 rows over 128 dims
constexpr int kQBox = kQB * 128;               // 4 KiB: 64 dims (128 bytes) of the 32 bf16 queries
constexpr int kConsumers = 2;                  // warpgroups per block, each with its own work items
constexpr int kMaxStages = 6;                  // ring stages per warpgroup
constexpr int kThreads = kConsumers * (128 + 32);  // the consumer warpgroups, then one producer warp each
constexpr int kSmemLimit = 232448;
constexpr int kBarBytes = 8 * (1 + 2 * kConsumers * kMaxStages);

// Shared memory at dimension d: the queries in units of 128 dims (a corpus
// box's span; zeros past d), the rings, the barriers.
__host__ __device__ inline int query_bytes(int d) { return (d + kBoxBytes - 1) / kBoxBytes * 2 * kQBox; }
inline int stages_for(int d) {
  const int room = (kSmemLimit - 1024 - kBarBytes - query_bytes(d)) / (kConsumers * kBox);
  return room < kMaxStages ? room : kMaxStages;
}
inline int smem_bytes(int d) { return 1024 + query_bytes(d) + kConsumers * stages_for(d) * kBox + kBarBytes; }

// D(64x32) += A(64x16) . B(16x32): A bf16 in registers (mma.sync's A layout
// per warp of 16 rows), B bf16 K-major in shared memory, f32 sums; scale_d
// == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The four int8 of w as two bf16 pairs, exactly (every int8 is a bf16): lo
// holds bytes 0 and 1, hi bytes 2 and 3, the lower byte in the lower half.
// Each byte + 128 (as unsigned) goes into the mantissa of 2^23, minus
// 2^23 + 128; cvt.rn.bf16x2.f32 packs the pairs. Taking the f32s' upper
// halves with byte permutes instead moves floats through integer registers,
// which made ptxas serialise the wgmmas (C7520), and ran 6-9% slower.
__device__ __forceinline__ void bf16x4_from_s8x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
  __nv_bfloat162 l = __floats2bfloat162_rn(f0, f1), h = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<uint32_t*>(&l);
  hi = *reinterpret_cast<uint32_t*>(&h);
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

// A consumer warpgroup's ring: its stages and barriers, and where it is.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage;
  uint32_t phase;
};

// One box (128 dims) of a step for the thread holding rows r and r + 8:
// the rows into registers, the stage freed, then 8 wgmmas against the
// queries' matching dims, committed as one group and not waited for. The A
// registers are rewritten only after the last group has retired: ptxas
// serialises every wgmma of a kernel that redefines a wgmma's input
// registers while wgmmas are in flight (C7513).
__device__ __forceinline__ void consume_box(Ring& ring, const unsigned char* q_s, int bx, int r, int lane,
                                            float (&acc)[16]) {
  const int g = lane / 4, t = lane % 4;
  mbar_wait(&ring.full[ring.stage], ring.phase);
  const unsigned char* rows = ring.base + ring.stage * kBox + r * kBoxBytes;
  uint32_t w[2][8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)  // 16-byte chunk kk of rows r and r + 8 sits at kk ^ g
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w[e][kk] = *reinterpret_cast<const uint32_t*>(rows + 8 * e * kBoxBytes + ((kk ^ g) << 4) + 4 * t);
  wgmma_wait<0>();  // the last box's wgmmas have read their A registers
  uint32_t a[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    bf16x4_from_s8x4(w[0][kk], a[kk][0], a[kk][2]);
    bf16x4_from_s8x4(w[1][kk], a[kk][1], a[kk][3]);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&ring.empty[ring.stage]);
  if (++ring.stage == ring.stages) ring.stage = 0, ring.phase ^= 1;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int kg = bx * 8 + kk;  // k-step over the whole row: 64-dim query box kg / 4, 32 bytes into it
    wgmma_m64n32k16_rs(acc, a[kk], smem_desc(q_s + (kg >> 2) * kQBox + (kg & 3) * 32, 16, 1024), kg > 0);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
partial_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_e,
               const float* __restrict__ scales, float* __restrict__ part_vals, int* __restrict__ part_idx,
               int b_pad, int d, long long n_actual, int tile_n, int m, int n_rot, int inner, int n_ranges,
               int c_out, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  const int qbytes = query_bytes(d);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + qbytes + kConsumers * stages * kBox);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp < 4 * kConsumers ? warp / 4 : warp - 4 * kConsumers;  // consumer or producer of warpgroup wg
  uint64_t* full = q_full + 1 + wg * 2 * kMaxStages;
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + qbytes + wg * stages * kBox;

  const int c = tile_n / m, chunks = c / kSJ;
  const int q0 = blockIdx.y * kQB;
  const int n_items = n_ranges * n_rot * chunks;
  const int worker = blockIdx.x * kConsumers + wg, workers = gridDim.x * kConsumers;
  const int q_loaded = (d + 63) / 64;  // 64-dim query boxes TMA fills; one more is zeroed if odd
  const int n_boxes = (d + kBoxBytes - 1) / kBoxBytes;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(&q_full[1 + w * 2 * kMaxStages + s], 1);
        mbar_init(&q_full[1 + w * 2 * kMaxStages + kMaxStages + s], 4);
      }
    mbar_init_fence();
  }
  if (q_loaded % 2) {
    for (int i = threadIdx.x; i < kQBox / 16; i += kThreads)
      reinterpret_cast<uint4*>(q_s + q_loaded * kQBox)[i] = make_uint4(0, 0, 0, 0);
    fence_async_shared();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // producer of warpgroup wg
    if (lane != 0) return;
    if (wg == 0) {
      mbar_arrive_expect_tx(q_full, q_loaded * kQBox);
      for (int x = 0; x < q_loaded; ++x) tma_load_2d(q_s + x * kQBox, &map_q, q_full, 64 * x, q0);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int item = worker; item < n_items; item += workers) {
      const Item it = decode(item, chunks, n_rot, n_ranges, inner, m, tile_n, c, n_actual);
      for (int s = 0; s < it.n_steps; ++s) {
        const int row0 = (int)it.row0(s, m, n_rot, tile_n, c);
        for (int bx = 0; bx < n_boxes; ++bx) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kBox);
          tma_load_2d(ring + stage * kBox, &map_e, &full[stage], bx * kBoxBytes, row0);
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
  Ring ring_state{ring, full, empty, stages, 0, 0};
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
      const float scale[2] = {__ldg(scales + row0), __ldg(scales + row0 + 8)};
      for (int bx = 0; bx < n_boxes; ++bx) consume_box(ring_state, q_s, bx, r, lane, acc);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const long long row = row0 + 8 * v;
        if (row >= n_actual) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[4 * j + 2 * v + e] * scale[v];  // f32 score x f32 row scale
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

}  // namespace int8_stream

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

cudaError_t launch_merge(const void* part_vals, const void* part_idx, void* cand_vals, void* cand_idx, int b_pad,
                         int c_out, int n_ranges, cudaStream_t s) {
  const long long total = (long long)b_pad * c_out;
  const int threads = 256;
  topk_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(part_vals), static_cast<const int*>(part_idx),
      static_cast<float*>(cand_vals), static_cast<int*>(cand_idx), n_ranges, total);
  return cudaGetLastError();
}

int query_smem_bytes(int d) { return kQB * (d + 8) * (int)sizeof(__nv_bfloat16); }

}  // namespace

// How many B1 partial-pass blocks the current device holds at once at
// dimension d. The wrapper sizes the tile ranges so the partial pass is one
// full wave: a second, nearly empty wave would double its time.
extern "C" int tt_fused_topk_resident_blocks(int d, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         query_smem_bytes(d));
  if (err != cudaSuccess) return err;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_partial_kernel, kThreads, query_smem_bytes(d));
  *out = per_sm * sms;
  return cudaGetLastError();
}

// q: (b_pad, d) bf16, b_pad a multiple of 32; e: (n_rows, d) bf16, n_rows a
// multiple of tile_n and >= n_actual; d a multiple of 16 and at most 2048; q
// and e 32-byte aligned. part_*: (n_ranges, b_pad, c_out) scratch; cand_*:
// (b_pad, c_out) with c_out = n_rot * tile_n / m. Returns the CUDA error of
// the launches.
extern "C" int tt_fused_topk_candidates(const void* q, const void* e, void* part_vals, void* part_idx,
                                        void* cand_vals, void* cand_idx, int b_pad, int d, long long n_actual,
                                        int tile_n, int m, int n_rot, int inner, int n_ranges, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = tile_n / m;
  dim3 grid(c / kSJ, n_ranges, n_rot * (b_pad / kQB));
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         query_smem_bytes(d));
  if (err != cudaSuccess) return err;
  topk_partial_kernel<<<grid, kThreads, query_smem_bytes(d), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(e), static_cast<float*>(part_vals),
      static_cast<int*>(part_idx), b_pad, d, n_actual, tile_n, m, n_rot, inner, n_ranges, n_rot * c);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_merge(part_vals, part_idx, cand_vals, cand_idx, b_pad, n_rot * c, n_ranges, s);
}

// B2's partial pass at dimension d: out[0] = blocks the current device holds
// at once, out[1] = consumer warpgroups (workers) per block.
extern "C" int tt_fused_topk_int8_occupancy(int d, int* out) {
  namespace b2 = int8_stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err =
      cudaFuncSetAttribute(b2::partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, b2::smem_bytes(d));
  if (err != cudaSuccess) return err;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, b2::partial_kernel, b2::kThreads, b2::smem_bytes(d));
  out[0] = per_sm * sms;
  out[1] = b2::kConsumers;
  return cudaGetLastError();
}

// q: (b_pad, d) bf16 with each 16 dims permuted (ops/topk.py::permute_dims),
// b_pad a multiple of 32; e: (n_rows, d) int8 with `scales` (n_rows,) f32,
// n_rows a multiple of tile_n and >= n_actual; d a multiple of 16 and at
// most 2048; q and e 16-byte aligned. `blocks` persistent blocks per query
// block walk the n_ranges * n_rot * (tile_n / m / 64) work items. part_*:
// (n_ranges, b_pad, c_out) scratch; cand_*: (b_pad, c_out) with c_out =
// n_rot * tile_n / m. Returns the CUDA error of the launches
// (cudaErrorInvalidValue if a tensor map cannot be encoded).
extern "C" int tt_fused_topk_int8_candidates(const void* q, const void* e, const void* scales, void* part_vals,
                                             void* part_idx, void* cand_vals, void* cand_idx, int b_pad, int d,
                                             long long n_actual, int tile_n, int m, int n_rot, int inner,
                                             int n_ranges, int blocks, void* stream) {
  namespace b2 = int8_stream;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The rows any step reads: the tiles that hold a row below n_actual.
  const uint64_t rows = uint64_t((n_actual + tile_n - 1) / tile_n) * tile_n;
  const uint64_t q_dims[2] = {uint64_t(d), uint64_t(b_pad)}, q_strides[1] = {uint64_t(d) * 2};
  const uint64_t e_dims[2] = {uint64_t(d), rows}, e_strides[1] = {uint64_t(d)};
  const uint32_t q_box[2] = {64, kQB}, e_box[2] = {b2::kBoxBytes, kSJ};
  alignas(64) CUtensorMap map_q, map_e;
  if (!hopper::encode_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, 2, q_dims, q_strides, q_box) ||
      !hopper::encode_map(&map_e, CU_TENSOR_MAP_DATA_TYPE_UINT8, e, 2, e_dims, e_strides, e_box))
    return cudaErrorInvalidValue;
  const int smem = b2::smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(b2::partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int c_out = n_rot * (tile_n / m);
  b2::partial_kernel<<<dim3(blocks, b_pad / kQB), b2::kThreads, smem, s>>>(
      map_q, map_e, static_cast<const float*>(scales), static_cast<float*>(part_vals), static_cast<int*>(part_idx),
      b_pad, d, n_actual, tile_n, m, n_rot, inner, n_ranges, c_out, b2::stages_for(d));
  err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_merge(part_vals, part_idx, cand_vals, cand_idx, b_pad, c_out, n_ranges, s);
}
