// Hopper building blocks shared by the kernels that run on TMA + wgmma
// (tc_matmul.cu, attention.cu, fused_topk.cu, ivf_probe.cu's int8 path):
// mbarriers, TMA tile loads and stores, named barriers, wgmma descriptors and
// fences, the host-side tensor-map encoder, and the int8 row boxes that B2
// and B4 feed to wgmma from registers.
//
// Shared-memory tiles are stored in the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma's layout type 1 reads: rows of
// 128 bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8), in
// atoms of 8 rows (1024 bytes) that must start 1024-byte aligned.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the inits visible to the async proxy (TMA) before any use.
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Block until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so waiting on parity 1 returns at once (an empty slot). A wait
// that outlasts ~10 s of clock cycles is a broken pipeline: it traps, and the
// launch fails, rather than holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

// -- TMA loads (global -> shared, completion counted on an mbarrier) ---------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- TMA stores (shared -> global, tracked in bulk groups of the issuing thread)

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's bulk groups have completed their writes.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Make this thread's generic-proxy shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Barrier `id` over `threads` threads that returns whether `pred` held in any.
__device__ __forceinline__ bool named_any(int id, int threads, bool pred) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, %3, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"(uint32_t(pred)), "r"(id), "r"(threads)
      : "memory");
  return any != 0;
}

// -- wgmma -------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile at `tile` (shared memory).
// K-major (rows of 128 bytes along K): lbo unused, sbo = 1024, the stride of
// 8-row groups. MN-major (rows of 128 bytes = 64 elements along M or N, one
// row per k): lbo = the stride between 64-element groups along M or N, sbo =
// 1024, the stride of 8-k groups. A k16 step along a K-major row adds 32
// bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulators at this point of the program: after a wgmma wait, their
// reads may not be hoisted above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- int8 rows as wgmma's A, from registers (B2, B4's int8 path) -----------
//
// A TMA box holds 64 rows x 128 bytes (128 int8 dims) in the 128-byte swizzle;
// a consumer warpgroup's ring of such boxes is fed by a producer warp (full:
// one arrival + the box's bytes; empty: one arrival per consumer warp). The 32
// bf16 queries (wgmma's B, K-major) sit in boxes of 64 dims x 32 queries, each
// 16 dims in the order of ops/topk.py::permute_dims, which is the order in
// which the A fragments below take a row's dims.

constexpr int kRowsBox = 64 * 128;   // bytes of one ring stage
constexpr int kQueryBox = 32 * 128;  // bytes of 64 dims of the 32 queries

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

// A consumer warpgroup's ring: its stages and barriers, where it is, and the
// stage the wgmma group in flight still reads (-1: none).
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage;
  uint32_t phase;
  int held;
};

// One int8 box (128 dims) of a step for the thread holding rows r and r + 8:
// the rows into registers, the stage freed, then 8 wgmmas against the
// queries' matching dims, committed as one group and not waited for. The A
// registers are rewritten only after the last group has retired: ptxas
// serialises every wgmma of a kernel that redefines a wgmma's input
// registers while wgmmas are in flight (C7513).
__device__ __forceinline__ void consume_int8_box(Ring& ring, const unsigned char* q_s, int bx, int r, int lane,
                                                 float (&acc)[16]) {
  const int g = lane / 4, t = lane % 4;
  mbar_wait(&ring.full[ring.stage], ring.phase);
  const unsigned char* rows = ring.base + ring.stage * kRowsBox + r * 128;
  uint32_t w[2][8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)  // 16-byte chunk kk of rows r and r + 8 sits at kk ^ g
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w[e][kk] = *reinterpret_cast<const uint32_t*>(rows + 8 * e * 128 + ((kk ^ g) << 4) + 4 * t);
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
    wgmma_m64n32k16_rs(acc, a[kk], smem_desc(q_s + (kg >> 2) * kQueryBox + (kg & 3) * 32, 16, 1024), kg > 0);
  }
  wgmma_commit();
}

// -- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// so the library needs no link to libcuda; null if the installed CUDA lacks
// it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A 128-byte-swizzled tensor map over elements of `type`: `rank` dims,
// innermost first (dims[0] contiguous), strides in bytes of dims 1.., and
// the box each copy moves (box[0] spans 128 bytes at most). Elements of a
// load's box past the tensor's end read as zeros; a store skips them.
// Returns false if the map cannot be encoded.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const uint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
