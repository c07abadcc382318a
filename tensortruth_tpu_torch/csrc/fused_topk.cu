// Fused matmul + bucketed top-k candidates over a bf16 corpus (kernel B1).
//
// Replaces: tensortruth_tpu/ops/topk.py::_fused_kernel, reached through
// fused_topk (the pl.pallas_call at ops/topk.py:233).
//
// What it computes (identical to the TPU kernel): scores Q(B, D) . E(N, D)^T
// with f32 accumulation, tile by tile of `tile_n` corpus rows; rows at or past
// `n_actual` are masked to -inf; each tile is reduced to c = tile_n / m
// strided-bucket max + argmax (bucket j = rows {j, j + c, ..., j + (m-1)c} of
// the tile); the per-tile result max-merges into a (B, c_out) candidate
// accumulator where tile t * n_rot + b feeds candidate block b. Ties keep the
// earlier segment and the earlier tile (strict `>` everywhere). The final
// top-k over the candidates runs outside, in torch, as in the reference.
//
// What bounds it on an H100: at the serving batch (B = 32, D = 1024) every
// corpus row costs 2 KB of HBM reads for 64 kFLOP, about 32 FLOP/byte, far
// under the ~295 FLOP/byte at which bf16 tensor cores stop waiting on HBM.
// So it is bound by device memory, and the design goal is to read E exactly
// once with every byte of each fetched sector used.
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
//   64 rows x 128 dims per stage, two stages in flight, so the HBM reads are
//   whole 16-byte pieces of contiguous rows and overlap the tensor-core work.
//   Scores come from bf16 WMMA fragments (16x16x16, f32 accumulate): each
//   warp scores 16 of the staged rows against the block's 32 queries, so
//   each corpus row is read once per 32 queries. The queries are copied to
//   shared memory once per block: read from global memory they are re-read
//   from L2 for every corpus tile (L1 is mostly given to shared memory), at
//   twice the corpus's own traffic.
//   TMA, wgmma and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kQB = 32;                        // queries per block
constexpr int kSJ = 64;                        // candidate slots (rows) per step
constexpr int kWarps = kSJ / 16;               // each warp scores 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kPairs = kQB * kSJ / kThreads;   // (query, slot) pairs a thread keeps
constexpr int kKC = 128;                       // dims per shared-memory stage
constexpr int kLd = kKC + 8;                   // padded stage row (elements)

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
  __shared__ __align__(128) __nv_bfloat16 stage[2][kSJ * kLd];
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
  const int n_chunks = (d + kKC - 1) / kKC;

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
      const int k0 = (p % n_chunks) * kKC;
      const int pieces = min(kKC, d - k0) / 8;
      __nv_bfloat16* buf = stage[p & 1];
      for (int x = threadIdx.x; x < kSJ * pieces; x += kThreads) {
        const int row = x / pieces, col = (x % pieces) * 8;
        cp_async16(buf + row * kLd + col, e + (row0 + row) * d + k0 + col);
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
    const int k0 = kc * kKC;
    const int len = min(kKC, d - k0);
    const __nv_bfloat16* rows = stage[p & 1] + warp * 16 * kLd;
    for (int kk = 0; kk < len; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa0, fa1;
      wmma::load_matrix_sync(fb, rows + kk, kLd);
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
        const long long g = row0 + (pair % kSJ);
        const float v = scores[pair];
        if (g < n_actual && v > best_val[u]) {
          best_val[u] = v;
          best_idx[u] = (int)g;
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

}  // namespace

// How many partial-pass blocks the current device holds at once. The
// wrapper sizes the tile ranges so the partial pass is one full wave: a
// second, nearly empty wave would double its time.
static int query_smem_bytes(int d) { return kQB * (d + 8) * (int)sizeof(__nv_bfloat16); }

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
// multiple of tile_n and >= n_actual; d a multiple of 16 and at most 2048;
// both 32-byte aligned. part_*: (n_ranges, b_pad, c_out) scratch; cand_*: (b_pad, c_out)
// with c_out = n_rot * tile_n / m. Returns the CUDA error of the launches.
extern "C" int tt_fused_topk_candidates(const void* q, const void* e,
                                        void* part_vals, void* part_idx,
                                        void* cand_vals, void* cand_idx,
                                        int b_pad, int d, long long n_actual,
                                        int tile_n, int m, int n_rot, int inner,
                                        int n_ranges, void* stream) {
  const int c = tile_n / m;
  const int c_out = n_rot * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(c / kSJ, n_ranges, n_rot * (b_pad / kQB));
  cudaError_t err = cudaFuncSetAttribute(topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         query_smem_bytes(d));
  if (err != cudaSuccess) return err;
  topk_partial_kernel<<<grid, kThreads, query_smem_bytes(d), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(e),
      static_cast<float*>(part_vals), static_cast<int*>(part_idx), b_pad, d,
      n_actual, tile_n, m, n_rot, inner, n_ranges, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)b_pad * c_out;
  const int threads = 256;
  topk_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(part_vals), static_cast<const int*>(part_idx),
      static_cast<float*>(cand_vals), static_cast<int*>(cand_idx), n_ranges, total);
  return cudaGetLastError();
}
