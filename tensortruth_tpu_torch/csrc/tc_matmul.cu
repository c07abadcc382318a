// Tensor-core matrix product, bf16 -> f32 and int8 -> int32 (kernel B5, both
// operand types and both block orders).
//
// Replaces: scripts/probe_int8_mxu_pallas.py::_matmul_kernel, reached through
// pallas_matmul (the pl.pallas_call at probe_int8_mxu_pallas.py:70), with
// acc_dtype float32 (bf16 operands) and int32 (int8 operands), with and
// without n_outer.
//
// What it computes (as the TPU kernel): o = a @ b, a (M, K) and b (K, N) both
// row-major, every product of the whole K summed in the accumulator type: f32
// for bf16 operands, s32 for int8 operands (exact). o is (M, N) row-major.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8,
// dense) at the probe's shape, M = 16384, K = 1024, N = 4096: bf16 does
// 2MKN = 137.4 GFLOP, 0.139 ms, against 0.093 ms for its 310 MB of traffic
// (a 32 MiB, b 8 MiB, the f32 o 256 MiB): compute-bound. int8 does the same
// operations in 0.069 ms, but the int32 o alone is 256 MiB, and its 289 MB of
// traffic take 0.086 ms: memory-bound. The int8 over bf16 speed-up this shape
// allows is therefore at most 0.139 / 0.086 = 1.61x.
//
// The TPU kernel takes a 512x1024 output tile per grid step with the whole K
// resident in VMEM; that f32 tile alone is 2 MiB. Here one design serves both
// operand types: wgmma from shared memory, fed by TMA through an mbarrier
// ring, templated on the operand type (struct Operand holds what differs).
// * A block owns a 128 x kBN output tile (kBN: 256 bf16, 128 int8): two
//   consumer warpgroups of 64 rows, each issuing wgmma m64n256k16 (bf16, f32
//   sums in 128 registers a thread) or m64n128k32 (int8, s32 sums in 64)
//   with both operands read from shared memory, and one producer warp.
// * K streams in slices of 128 bytes of an a row (64 bf16, 128 int8) through
//   a ring of stages (4 of 48 KiB bf16, 5 of 32 KiB int8): the a slice (128
//   rows, one TMA box) and the b slice for kBN columns, both 128-byte
//   swizzled. Each stage has a full barrier (the producer's expected bytes,
//   completed by TMA) and an empty barrier (one arrival per consumer warp
//   once the wgmma that read the stage has retired, wgmma.wait_group 1).
// * b's operand layout. bf16: b is (K, N) row-major, i.e. MN-major for the B
//   operand, and the descriptor's transpose bit takes it as it lies (four
//   TMA boxes of 64 columns x 64 k). int8: 8-bit wgmma takes B only K-major
//   (the transpose bit exists for 16-bit types only), so a small kernel
//   (tt_transpose_s8) first writes b^T (N, K) into scratch the caller
//   provides; b is 4 MiB at the probe's shape and is shared by all 128 rows
//   of tiles, so this adds 8 MiB to 289 MB of traffic. The product then reads
//   b^T K-major like a (one TMA box of 128 columns x 128 k).
// * Persistent: one block per SM walks the output tiles (n_outer chooses
//   N-tile-major or M-tile-major order), so the producer loads the next
//   tile's slices while the consumers write this one's sums.
// * Epilogue: each warpgroup stages its sums 32 columns at a time in 8 KiB
//   buffers (the 128-byte swizzle of a 64 x 32 TMA box of 4-byte elements, so
//   the register-to-shared writes are free of bank conflicts) and one thread
//   hands each box to a TMA store; a buffer is rewritten once its store has
//   read it (cp.async.bulk.wait_group.read). bf16 (compute-bound): two
//   buffers, the rest of shared memory to the ring; the f32 tile (128 KiB)
//   would not fit beside it. int8 (bound by writing its int32 output): the
//   narrower tile's 64 KiB is staged whole, so its stores drain while the next
//   tile's products run; at K = 1024 that beat 128 x 256 tiles with two
//   buffers, which wait on the stores (scripts/kernel_variants.py times the
//   alternatives; PERF.md).
// * Edges: K not a multiple of the slice reads zeros past the end (TMA fills
//   them); bf16 N a multiple of 128 but not of 256 skips the loads and the
//   stores of the missing half of the last column of tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;             // output rows of a block's tile (its columns: the operand type's kBN)
constexpr int kSliceBytes = 128;     // bytes of an a row per stage
constexpr int kConsumers = 2;                        // warpgroups, 64 output rows each
constexpr int kProducerWarp = kConsumers * 4;        // the warp after them
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kATile = kBM * kSliceBytes;            // 16 KiB
// Epilogue: a warpgroup stages kEpiCols of its 64 rows' sums per round in
// one of the operand type's kEpiBufs buffers, as TMA store boxes of 64 rows x
// kEpiBox columns (128 bytes a row, the swizzle's span).
constexpr int kEpiCols = 32;
constexpr int kEpiBox = 32;
constexpr int kEpiBytes = 64 * kEpiCols * 4;

// D(64x256) += A(64x16) . B(16x256): bf16 operands in shared memory, f32 sums in
// registers; scale_d == 0 overwrites D. A is K-major, B MN-major.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x128) += A(64x32) . B(32x128): s8 operands in shared memory, both
// K-major, s32 sums in registers; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k32_ss(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// What the operand type changes: the tile's width, the accumulator, k per
// slice, b's TMA boxes (kBoxCols output columns of kSliceBytes each), the
// wgmma of one k-step, the ring's depth and the epilogue's buffers.
template <typename T>
struct Operand;

template <>
struct Operand<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kBN = 256;
  static constexpr int kStages = 4, kEpiBufs = 2;  // bf16 ring and staging
  static constexpr int kBK = kSliceBytes / 2;  // 64 k
  static constexpr int kBoxCols = 64;          // b boxes: 64 columns x 64 k rows of 128 bytes, MN-major
  static constexpr CUtensorMapDataType kIn = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType kOut = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // b box j of a stage holds columns 64j.. for k rows (kt * kBK ..).
  static __device__ __forceinline__ void load_b(void* dst, const CUtensorMap* map, uint64_t* bar, int n0, int kt) {
    tma_load_2d(dst, map, bar, n0, kt * kBK);
  }
  // k-step kk (16 k, 32 bytes of an a row) of the slice at `st`: a K-major
  // rows of 128 bytes; b MN-major, 16 k rows of 128 bytes per step, boxes
  // kBBox apart.
  static __device__ __forceinline__ void mma(float (&d)[kBN / 2], const unsigned char* st, int wg, int kk, int scale_d) {
    constexpr int kBBox = kBoxCols * kSliceBytes;
    wgmma_m64n256k16_ss(d, smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024),
                        smem_desc(st + kATile + kk * 16 * 128, kBBox, 1024), scale_d);
  }
};

template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr int kBN = 128;
  static constexpr int kStages = 5, kEpiBufs = 4;  // int8 ring and staging: the whole tile
  static constexpr int kBK = kSliceBytes;  // 128 k
  static constexpr int kBoxCols = 128;     // b^T box: 128 columns (rows of b^T) x 128 k bytes, K-major
  static constexpr CUtensorMapDataType kIn = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType kOut = CU_TENSOR_MAP_DATA_TYPE_INT32;
  static __device__ __forceinline__ void load_b(void* dst, const CUtensorMap* map, uint64_t* bar, int n0, int kt) {
    tma_load_2d(dst, map, bar, kt * kBK, n0);
  }
  // k-step kk (32 k, 32 bytes of a row) of a and of b^T, both K-major rows
  // of 128 bytes.
  static __device__ __forceinline__ void mma(int (&d)[kBN / 2], const unsigned char* st, int wg, int kk, int scale_d) {
    wgmma_m64n128k32_ss(d, smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024),
                        smem_desc(st + kATile + kk * 32, 16, 1024), scale_d);
  }
};

// Shared memory of a block: slack for the 1024-byte alignment, the ring,
// the epilogue's buffers, the barriers.
template <typename T>
__host__ __device__ constexpr int stage_bytes() { return kATile + Operand<T>::kBN * kSliceBytes; }  // 48 KiB at 256 columns

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  using Op = Operand<T>;
  static_assert((Op::kBN / kEpiCols) % Op::kEpiBufs == 0, "every tile's epilogue starts in buffer 0");
  return 1024 + Op::kStages * stage_bytes<T>() + kConsumers * Op::kEpiBufs * kEpiBytes + 2 * Op::kStages * 8;
}
static_assert(smem_bytes<__nv_bfloat16>() <= 232448 && smem_bytes<int8_t>() <= 232448, "shared memory of one block");

// Two sums side by side in shared memory, in their own type: moving f32
// accumulators through integer registers (__float_as_uint) made ptxas
// serialise every wgmma of the bf16 kernel (C7520).
__device__ __forceinline__ void store2(unsigned char* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(unsigned char* p, int x, int y) { *reinterpret_cast<int2*>(p) = make_int2(x, y); }

template <int kBN>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int n_outer, int& m0, int& n0) {
  m0 = (n_outer ? tile % tiles_m : tile / tiles_n) * kBM;
  n0 = (n_outer ? tile / tiles_m : tile % tiles_n) * kBN;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_o, int m, int k, int n, int n_outer) {
  using Op = Operand<T>;
  using Acc = typename Op::Acc;
  constexpr int kBBox = Op::kBoxCols * kSliceBytes;
  constexpr int kBN = Op::kBN, kStages = Op::kStages, kEpiBufs = Op::kEpiBufs;
  constexpr int kStageBytes = stage_bytes<T>(), kEpiRounds = kBN / kEpiCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kConsumers * kEpiBufs * kEpiBytes);
  uint64_t* empty = full + kStages;
  const int tiles_m = m / kBM, tiles_n = (n + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n, slices = (k + Op::kBK - 1) / Op::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin<kBN>(tile, tiles_m, tiles_n, n_outer, m0, n0);
      const int boxes = min(kBN, n - n0) / Op::kBoxCols;  // b boxes inside N
      for (int kt = 0; kt < slices; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kATile + boxes * kBBox);
        tma_load_2d(st, &map_a, &full[stage], kt * Op::kBK, m0);
        for (int j = 0; j < boxes; ++j) Op::load_b(st + kATile + j * kBBox, &map_b, &full[stage], n0 + Op::kBoxCols * j, kt);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows wg * 64 .. + 63 of each tile.
  const int wg = warp / 4;
  unsigned char* epi = smem + kStages * kStageBytes + wg * kEpiBufs * kEpiBytes;
  Acc acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin<kBN>(tile, tiles_m, tiles_n, n_outer, m0, n0);
    int held = -1;  // the stage the wgmma group in flight reads
    for (int kt = 0; kt < slices; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Op::mma(acc, st, wg, kk, kt > 0 || kk > 0);  // 32 bytes of k per step
      wgmma_commit();
      if (held >= 0) {
        wgmma_wait<1>();  // the previous slice's group has retired
        if (lane == 0) mbar_arrive(&empty[held]);
      }
      held = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);

    // Rows r and r + 8 of the warpgroup's 64 (r % 8 == lane / 4), columns
    // 8j + 2t and + 1 of the tile: staged in the stores' 128-byte swizzle (the
    // 16-byte chunk c of a row at c ^ (row % 8)), then written by TMA while
    // the next tile's products run.
    const int r = (warp % 4) * 16 + lane / 4, t = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
#pragma unroll
    for (int round = 0; round < kEpiRounds; ++round) {
      unsigned char* buf = epi + (round % kEpiBufs) * kEpiBytes;
      if (leader) bulk_wait_read<kEpiBufs - 1>();  // the buffer's last stores have read it
      named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < kEpiCols / 8; ++jj) {
        const int j = round * (kEpiCols / 8) + jj;
        const int col = jj * 8 + 2 * t;  // in the round
        unsigned char* box = buf + (col / kEpiBox) * (64 * 128) + ((((col % kEpiBox) / 4) ^ (r % 8)) << 4) + (t % 2) * 8;
        store2(box + r * 128, acc[4 * j], acc[4 * j + 1]);
        store2(box + (r + 8) * 128, acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (leader) {
        for (int bx = 0; bx < kEpiCols / kEpiBox; ++bx) {
          const int c0 = n0 + round * kEpiCols + bx * kEpiBox;
          if (c0 < n) tma_store_2d(&map_o, buf + bx * (64 * 128), c0, m0 + wg * 64);
        }
        bulk_commit();
      }
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait_all();
}

// b^T of an int8 (k, n) row-major matrix into (n, k) row-major: a block per
// 64 x 64 tile, read as 16-byte pieces of b's rows, written as 16-byte
// pieces of b^T's rows (k and n multiples of 64).
__global__ void __launch_bounds__(256) transpose_s8_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt,
                                                           int k, int n) {
  __shared__ uint32_t tile[64][17];  // 64 k rows of 64 bytes, padded a word
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int j = threadIdx.x / 4, c = threadIdx.x % 4;
  const uint4 v = *reinterpret_cast<const uint4*>(b + (long long)(k0 + j) * n + n0 + 16 * c);
  tile[j][4 * c] = v.x;
  tile[j][4 * c + 1] = v.y;
  tile[j][4 * c + 2] = v.z;
  tile[j][4 * c + 3] = v.w;
  __syncthreads();
  // Column j of the tile over k rows 16c .. 16c + 15: byte j % 4 of word j / 4.
  const uint32_t pick = (j % 4) | ((j % 4 + 4) << 4);  // that byte of two words, side by side
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 16 * c + 4 * q;
    const uint32_t lo = __byte_perm(tile[r][j / 4], tile[r + 1][j / 4], pick);
    const uint32_t hi = __byte_perm(tile[r + 2][j / 4], tile[r + 3][j / 4], pick);
    w[q] = __byte_perm(lo, hi, 0x5410);
  }
  *reinterpret_cast<uint4*>(bt + (long long)(n0 + j) * k + k0 + 16 * c) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, int m, int k, int n, int n_outer, cudaStream_t s) {
  using Op = Operand<T>;
  alignas(64) CUtensorMap map_a, map_b, map_o;
  const uint64_t a_dims[2] = {uint64_t(k), uint64_t(m)}, a_strides[1] = {uint64_t(k) * sizeof(T)};
  const uint64_t o_dims[2] = {uint64_t(n), uint64_t(m)}, o_strides[1] = {uint64_t(n) * 4};
  const uint32_t a_box[2] = {Op::kBK, kBM}, o_box[2] = {kEpiBox, 64};
  // bf16: b (K, N) in boxes of 64 columns x 64 k; int8: b^T (N, K) in boxes
  // of 128 k x 128 columns.
  const bool kmajor = sizeof(T) == 1;
  const uint64_t b_dims[2] = {uint64_t(kmajor ? k : n), uint64_t(kmajor ? n : k)};
  const uint64_t b_strides[1] = {b_dims[0] * sizeof(T)};
  const uint32_t b_box[2] = {kmajor ? uint32_t(Op::kBK) : 64u, kmajor ? uint32_t(Op::kBoxCols) : uint32_t(Op::kBK)};
  if (!encode_map(&map_a, Op::kIn, a, 2, a_dims, a_strides, a_box) ||
      !encode_map(&map_b, Op::kIn, b, 2, b_dims, b_strides, b_box) ||
      !encode_map(&map_o, Op::kOut, out, 2, o_dims, o_strides, o_box))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const int tiles = (m / kBM) * ((n + Op::kBN - 1) / Op::kBN);
  const int blocks = tiles < sms ? tiles : sms;  // persistent: at most one block per SM
  gemm_kernel<T><<<blocks, kThreads, smem_bytes<T>(), s>>>(map_a, map_b, map_o, m, k, n, n_outer);
  return cudaGetLastError();
}

}  // namespace

// b: (k, n) int8 row-major, b_t: (n, k) int8 row-major, k and n multiples
// of 64, both 16-byte aligned: b_t = b^T, the K-major B operand of the int8
// product. Returns the CUDA error of the launch.
extern "C" int tt_transpose_s8(const void* b, void* b_t, int k, int n, void* stream) {
  transpose_s8_kernel<<<dim3(n / 64, k / 64), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(b_t), k, n);
  return cudaGetLastError();
}

// a: (m, k) row-major; for bf16 operands (int8 == 0) b is (k, n) row-major,
// for int8 operands (int8 != 0) b is b^T, (n, k) row-major (tt_transpose_s8).
// out: (m, n) row-major, f32 for bf16 operands, int32 for int8. m and n
// multiples of 128, k a multiple of 64 bytes of an a row (32 bf16, 64 int8),
// all pointers 16-byte aligned. n_outer != 0 walks the output tiles
// N-tile-major. Returns the CUDA error of the launch (cudaErrorInvalidValue
// if a tensor map cannot be encoded).
extern "C" int tt_tc_matmul(const void* a, const void* b, void* out, int m, int k, int n, int int8, int n_outer,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? launch<int8_t>(a, b, out, m, k, n, n_outer, s)
              : launch<__nv_bfloat16>(a, b, out, m, k, n, n_outer, s);
}
