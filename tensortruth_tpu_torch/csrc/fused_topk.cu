// Fused matmul + bucketed top-k candidates over a bf16 corpus (kernel B1)
// or an int8 corpus with per-row f32 scales (kernel B2): one kernel,
// templated on the corpus element type.
//
// Replaces: tensortruth_tpu/ops/topk.py::_fused_kernel, reached through
// fused_topk (B1, the pl.pallas_call at ops/topk.py:233) and, with
// quantized=True, through fused_topk_int8 (B2, the pl.pallas_call at
// ops/topk.py:383).
//
// What it computes (identical to the TPU kernel): scores Q(B, D) . E(N, D)^T
// with f32 accumulation, tile by tile of `tile_n` corpus rows; for an int8
// corpus the tile is converted to bf16 (exact: |v| <= 127) and each f32
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
// Design:
// * The TPU kernel walks each candidate block's tiles in a sequential grid
//   with the accumulator resident in VMEM. Blocks here run in parallel and
//   in no order, so each candidate block's tile sequence is cut into
//   contiguous ascending ranges, one CUDA block per (range, slot chunk,
//   candidate block, query block). A block keeps its (32 queries x 64 slots)
//   best values and indices in registers, walks its tiles and segments in
//   ascending order with a strict `>`, and writes one partial per range.
//   The wrapper picks the number of ranges so that all partial-pass blocks
//   are resident at once (tt_fused_topk_resident_blocks): one full wave.
// * A second, elementwise pass merges the partials in ascending range order
//   with a strict `>`. First occurrence in (tile, segment) order wins, which
//   is exactly the reference's rule (earlier segment, then earlier tile).
// * Each block streams its corpus rows through shared memory with cp.async,
//   16 KB per stage (64 rows x 128 bf16 dims, or x 256 int8 dims), two
//   stages in flight, so the HBM reads are whole 16-byte pieces of
//   contiguous rows and overlap the tensor-core work. Each warp scores 16 of
//   the staged rows against the block's 32 queries, so each corpus row is
//   read once per 32 queries, with bf16 tensor-core products and f32
//   accumulation: WMMA fragments (16x16x16) for a bf16 corpus; for an int8
//   corpus, mma.sync m16n8k16 whose B fragments are built in registers from
//   the staged int8 bytes (int8 -> bf16 is exact, so the products are B1's;
//   an int8 MMA would need a quantised query and give other scores). A lane
//   reads 4 consecutive dims of a row with one 32-bit load; the same
//   permutation of the 16 dims inside each k-step is applied to the query
//   fragments, which leaves each dot product's terms unchanged. The queries
//   are copied to shared memory once per block: read from global memory they
//   are re-read from L2 for every corpus tile (L1 is mostly given to shared
//   memory), at twice the corpus's own traffic.
//   TMA, wgmma and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kQB = 32;                        // queries per block
constexpr int kSJ = 64;                        // candidate slots (rows) per step
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

// Bytes 2h and 2h+1 of `w`, sign-extended and converted (exactly) to a
// bf16x2 register: the lower dim in the low half, as mma.sync expects.
__device__ __forceinline__ unsigned bf16x2_from_s8(int w, int h) {
  const int lo = (w << (24 - 16 * h)) >> 24;
  const int hi = (w << (16 - 16 * h)) >> 24;
  __nv_bfloat162 v = __halves2bfloat162(__int2bfloat16_rn(lo), __int2bfloat16_rn(hi));
  return *reinterpret_cast<unsigned*>(&v);
}

// D += A . B for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// T is the corpus element: __nv_bfloat16 (B1) or signed char (B2, with
// `scales`, one f32 per corpus row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ e,
                    const float* __restrict__ scales,
                    float* __restrict__ part_vals, int* __restrict__ part_idx,
                    int b_pad, int d, long long n_actual, int tile_n, int m,
                    int n_rot, int inner, int n_ranges, int c_out) {
  constexpr bool kInt8 = std::is_same<T, signed char>::value;
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte piece
  constexpr int kDims = kKC * 2 / sizeof(T);   // dims per stage: 16 KB of rows
  constexpr int kLdS = kDims + kVec;           // padded stage row (elements)
  __shared__ __align__(128) T stage[2][kSJ * kLdS];
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
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;      // mma.sync fragment coordinates
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
      T* buf = stage[p & 1];
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;  // bf16 corpus
  wmma::fill_fragment(acc0, 0.0f);
  wmma::fill_fragment(acc1, 0.0f);
  float acc[2][2][4] = {};  // int8 corpus: [query tile][row tile][mma.sync accumulator]
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
    if constexpr (kInt8) {
      const signed char* rows = stage[p & 1] + warp * 16 * kLdS;
      for (int kk = 0; kk < len; kk += 16) {
        // Lane (g, t4) holds dims 4*t4 .. 4*t4+3 of row g of each 8-row tile
        // and of queries g, g + 8 of each 16-query tile: fragment k-slots
        // {2t4, 2t4+1} carry dims {4t4, 4t4+1}, slots {2t4+8, 2t4+9} dims
        // {4t4+2, 4t4+3}, for A and B alike.
        unsigned b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int w = *reinterpret_cast<const int*>(rows + (nt * 8 + g) * kLdS + kk + 4 * t4);
          b[nt][0] = bf16x2_from_s8(w, 0);
          b[nt][1] = bf16x2_from_s8(w, 1);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* qa = q_s + (mt * 16 + g) * ldq + k0 + kk + 4 * t4;
          const uint2 top = *reinterpret_cast<const uint2*>(qa);
          const uint2 bot = *reinterpret_cast<const uint2*>(qa + 8 * ldq);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], top.x, bot.x, top.y, bot.y, b[nt][0], b[nt][1]);
        }
      }
    } else {
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
    }

    if (kc == n_chunks - 1) {  // the step's scores are complete
      const long long row0 = step_row0(p / n_chunks);
      if constexpr (kInt8) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* out = scores + (mt * 16 + g) * kSJ + warp * 16 + nt * 8 + 2 * t4;
            *reinterpret_cast<float2*>(out) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(out + 8 * kSJ) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
          }
        }
      } else {
        wmma::store_matrix_sync(scores + warp * 16, acc0, kSJ, wmma::mem_row_major);
        wmma::store_matrix_sync(scores + 16 * kSJ + warp * 16, acc1, kSJ, wmma::mem_row_major);
        wmma::fill_fragment(acc0, 0.0f);
        wmma::fill_fragment(acc1, 0.0f);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const int pair = threadIdx.x + u * kThreads;  // = query * kSJ + slot
        const long long row = row0 + (pair % kSJ);
        if (row < n_actual) {
          float v = scores[pair];
          if constexpr (kInt8) v *= scales[row];  // f32 score x f32 row scale
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

int query_smem_bytes(int d) { return kQB * (d + 8) * (int)sizeof(__nv_bfloat16); }

template <typename T>
cudaError_t resident_blocks(int d, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         query_smem_bytes(d));
  if (err != cudaSuccess) return err;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_partial_kernel<T>, kThreads, query_smem_bytes(d));
  *out = per_sm * sms;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial(const void* q, const void* e, const float* scales, void* part_vals,
                           void* part_idx, int b_pad, int d, long long n_actual, int tile_n,
                           int m, int n_rot, int inner, int n_ranges, cudaStream_t s) {
  const int c = tile_n / m;
  dim3 grid(c / kSJ, n_ranges, n_rot * (b_pad / kQB));
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         query_smem_bytes(d));
  if (err != cudaSuccess) return err;
  topk_partial_kernel<T><<<grid, kThreads, query_smem_bytes(d), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(e), scales,
      static_cast<float*>(part_vals), static_cast<int*>(part_idx), b_pad, d,
      n_actual, tile_n, m, n_rot, inner, n_ranges, n_rot * c);
  return cudaGetLastError();
}

}  // namespace

// How many partial-pass blocks the current device holds at once for a bf16
// (quantized = 0) or int8 (quantized = 1) corpus. The wrapper sizes the tile
// ranges so the partial pass is one full wave: a second, nearly empty wave
// would double its time.
extern "C" int tt_fused_topk_resident_blocks(int d, int quantized, int* out) {
  return quantized ? resident_blocks<signed char>(d, out) : resident_blocks<__nv_bfloat16>(d, out);
}

// q: (b_pad, d) bf16, b_pad a multiple of 32; e: (n_rows, d) bf16 when
// `scales` is null, else int8 with `scales` (n_rows,) f32; n_rows a multiple
// of tile_n and >= n_actual; d a multiple of 16 and at most 2048; q and e
// 32-byte aligned. part_*: (n_ranges, b_pad, c_out) scratch; cand_*:
// (b_pad, c_out) with c_out = n_rot * tile_n / m. Returns the CUDA error of
// the launches.
extern "C" int tt_fused_topk_candidates(const void* q, const void* e, const void* scales,
                                        void* part_vals, void* part_idx,
                                        void* cand_vals, void* cand_idx,
                                        int b_pad, int d, long long n_actual,
                                        int tile_n, int m, int n_rot, int inner,
                                        int n_ranges, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  cudaError_t err =
      sc ? launch_partial<signed char>(q, e, sc, part_vals, part_idx, b_pad, d, n_actual, tile_n,
                                       m, n_rot, inner, n_ranges, s)
         : launch_partial<__nv_bfloat16>(q, e, nullptr, part_vals, part_idx, b_pad, d, n_actual,
                                         tile_n, m, n_rot, inner, n_ranges, s);
  if (err != cudaSuccess) return err;
  const long long total = (long long)b_pad * n_rot * (tile_n / m);
  const int threads = 256;
  topk_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(part_vals), static_cast<const int*>(part_idx),
      static_cast<float*>(cand_vals), static_cast<int*>(cand_idx), n_ranges, total);
  return cudaGetLastError();
}
