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
// resident in VMEM; that f32 tile alone is 2 MiB. Here the two operand types
// take two designs.
//
// bf16 (compute-bound, so built to keep the tensor cores fed): wgmma from
// shared memory, fed by TMA through an mbarrier ring.
// * A block owns a 128x256 output tile: two consumer warpgroups of 64 rows,
//   each issuing wgmma m64n256k16 (f32 sums in 128 registers a thread) with
//   both operands read from shared memory, and one producer warp.
// * K streams in slices of 64 (128 bytes of an a row) through a ring of four
//   48 KiB stages: the a slice (128 rows, one TMA box) and the b slice (64 k
//   rows x 256 columns, four TMA boxes of 64 columns), both 128-byte swizzled.
//   Each stage has a full barrier (the producer's expected bytes, completed by
//   TMA) and an empty barrier (one arrival per consumer warp once the wgmma
//   that read the stage has retired, wgmma.wait_group 1).
// * b is (K, N) row-major, i.e. MN-major for the B operand: the descriptor's
//   transpose bit takes it as it lies, with no transposed copy.
// * Persistent: one block per SM walks the output tiles (n_outer chooses
//   N-tile-major or M-tile-major order), so the producer loads the next
//   tile's slices while the consumers write this one's f32 sums.
// * Epilogue: the 128 KiB f32 tile does not fit in shared memory beside the
//   ring, and when every SM writes its tile at once the stores wait on
//   device memory. Each warpgroup stages its sums 32 columns at a time in
//   two 8 KiB buffers (the 128-byte swizzle of a 64 x 32 f32 TMA box, so the
//   register-to-shared writes are free of bank conflicts) and one thread
//   hands each box to a TMA store; a buffer is rewritten once its store has
//   read it (cp.async.bulk.wait_group.read 1). Stores straight from the
//   registers, or larger staged boxes that leave room for fewer stages, ran
//   slower; scripts/kernel_variants.py times the alternatives (PERF.md).
// * Edges: K not a multiple of 64 reads zeros past the end (TMA fills them);
//   N a multiple of 128 but not of 256 skips the loads and the stores of the
//   missing half of the last column of tiles.
//
// int8 (memory-bound by its int32 output; first design, kept): 8-bit wgmma
// takes only a K-major B, and b is (K, N). A block of 8 warps owns a 128x128
// output tile, each warp 64x32 of it in registers, fed by mma.sync m16n8k32
// (s8 in, s32 sums); K streams through shared memory in slices of 64 bytes of
// an a row, copied with cp.async into a ring of three. Shared-memory rows are
// XOR-swizzled in 16-byte chunks so that each 8-row ldmatrix phase reads 8
// distinct bank groups. ldmatrix .trans exists only for 16-bit elements, and
// m16n8k32 wants 4 consecutive k of one column in each register.
// ldmatrix .trans over byte pairs (two adjacent columns) gives each register 2
// k x 2 columns; its rows are chosen so that one register holds k = 4t, 4t+1
// and its partner k = 4t+2, 4t+3, and __byte_perm splits the pair into one
// register per column. So one ldmatrix.x4.trans feeds two MMAs, over the even
// and over the odd columns of a 16-column group, and a thread's int32 sums
// come out as 4 adjacent columns of a row: 16-byte stores, no transposed copy
// of b anywhere. n_outer is the order in which block ids walk the tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

namespace bf16_wgmma {

constexpr int kBM = 128, kBN = 256;  // output tile of a block
constexpr int kBK = 64;              // k per stage: 128 bytes of an a row
constexpr int kStages = 4;
constexpr int kConsumers = 2;                        // warpgroups, 64 output rows each
constexpr int kProducerWarp = kConsumers * 4;        // the warp after them
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kATile = kBM * kBK * 2;                // 16 KiB
constexpr int kBBox = 64 * kBK * 2;                  // 8 KiB: 64 columns of b over one slice
constexpr int kStageBytes = kATile + (kBN / 64) * kBBox;  // 48 KiB
// Epilogue: a warpgroup stages kEpiCols of its 64 rows' f32 sums per round in
// one of kEpiBufs buffers, as TMA store boxes of 64 rows x kEpiBox columns
// (128 bytes a row, the swizzle's span).
constexpr int kEpiCols = 32, kEpiBufs = 2;
constexpr int kEpiBox = 32;
constexpr int kEpiRounds = kBN / kEpiCols;
constexpr int kEpiBytes = 64 * kEpiCols * 4;
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + kConsumers * kEpiBufs * kEpiBytes + 2 * kStages * 8;  // slack, tiles, barriers
static_assert(kEpiRounds % kEpiBufs == 0, "every tile's epilogue starts in buffer 0");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

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

__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int n_outer, int& m0, int& n0) {
  m0 = (n_outer ? tile % tiles_m : tile / tiles_n) * kBM;
  n0 = (n_outer ? tile / tiles_m : tile % tiles_n) * kBN;
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_o, int m, int k, int n, int n_outer) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kConsumers * kEpiBufs * kEpiBytes);
  uint64_t* empty = full + kStages;
  const int tiles_m = m / kBM, tiles_n = (n + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n, slices = (k + kBK - 1) / kBK;
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
      tile_origin(tile, tiles_m, tiles_n, n_outer, m0, n0);
      const int boxes = min(kBN, n - n0) / 64;  // b boxes inside N
      for (int kt = 0; kt < slices; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kATile + boxes * kBBox);
        tma_load_2d(st, &map_a, &full[stage], kt * kBK, m0);
        for (int j = 0; j < boxes; ++j) tma_load_2d(st + kATile + j * kBBox, &map_b, &full[stage], n0 + 64 * j, kt * kBK);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows wg * 64 .. + 63 of each tile.
  const int wg = warp / 4;
  unsigned char* epi = smem + kStages * kStageBytes + wg * kEpiBufs * kEpiBytes;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, tiles_m, tiles_n, n_outer, m0, n0);
    int held = -1;  // the stage the wgmma group in flight reads
    for (int kt = 0; kt < slices; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a: K-major rows of 128 bytes, 32 bytes per k16 step; b: MN-major,
        // 16 k rows of 128 bytes per step, 64-column boxes kBBox apart.
        const uint64_t da = smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = smem_desc(st + kATile + kk * 16 * 128, kBBox, 1024);
        wgmma_m64n256k16_ss(acc, da, db, kt > 0 || kk > 0);
      }
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
        *reinterpret_cast<float2*>(box + r * 128) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(box + (r + 8) * 128) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
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

cudaError_t launch(const void* a, const void* b, float* out, int m, int k, int n, int n_outer, cudaStream_t s) {
  alignas(64) CUtensorMap map_a, map_b, map_o;
  const uint64_t a_dims[2] = {uint64_t(k), uint64_t(m)}, a_strides[1] = {uint64_t(k) * 2};
  const uint64_t b_dims[2] = {uint64_t(n), uint64_t(k)}, b_strides[1] = {uint64_t(n) * 2};
  const uint64_t o_dims[2] = {uint64_t(n), uint64_t(m)}, o_strides[1] = {uint64_t(n) * 4};
  const uint32_t a_box[2] = {kBK, kBM}, b_box[2] = {64, kBK}, o_box[2] = {kEpiBox, 64};
  if (!encode_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, 2, a_dims, a_strides, a_box) ||
      !encode_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, 2, b_dims, b_strides, b_box) ||
      !encode_map(&map_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, 2, o_dims, o_strides, o_box))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = (m / kBM) * ((n + kBN - 1) / kBN);
  const int blocks = tiles < sms ? tiles : sms;  // persistent: at most one block per SM
  gemm_kernel<<<blocks, kThreads, kSmemBytes, s>>>(map_a, map_b, map_o, m, k, n, n_outer);
  return cudaGetLastError();
}

}  // namespace bf16_wgmma

namespace int8_mma {

constexpr int kBM = 128, kBN = 128;        // output tile of a block
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kWarpM = 64, kWarpN = 32;    // output tile of a warp (2 x 4 warps)
constexpr int kStages = 3;                 // K slices in the shared-memory ring
constexpr int kSliceBytes = 64;            // bytes of one a row in a slice
constexpr int kTileBytes = kBM * kSliceBytes;  // 8 KiB: a's slice; b's slice is the same size
constexpr int kBK = kSliceBytes;           // k per slice
constexpr int kBRowBytes = kBN;            // b slice row
constexpr int kBChunks = kBRowBytes / 16;

static_assert(kWarps == (kBM / kWarpM) * (kBN / kWarpN), "warp grid covers the block tile");
static_assert(kBK * kBRowBytes == kTileBytes, "a and b slices are the same size");

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a slice: 128 rows x 4 chunks of 16 bytes. The 8 rows of an ldmatrix phase
// (same chunk) land on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int a_off(int row, int chunk) { return row * kSliceBytes + ((chunk ^ ((row >> 1) & 3)) << 4); }

// b slice: kBK rows (k) x kBChunks chunks. The phases read k rows
// {0,1,4,5,8,9,12,13} (+2, +16, ...), hence this function of the row.
__device__ __forceinline__ int b_off(int row, int chunk) {
  const int swz = (row & 1) | ((row >> 1) & 6);
  return row * kBRowBytes + ((chunk ^ swz) << 4);
}

__device__ __forceinline__ void load_slice(unsigned char* a_s, unsigned char* b_s, const unsigned char* a,
                                           const unsigned char* b, int m0, int n0, int slice, int k, int n) {
  for (int i = threadIdx.x; i < kBM * (kSliceBytes / 16); i += kThreads) {
    const int row = i >> 2, chunk = i & 3;
    const unsigned char* src = a + (long long)(m0 + row) * k + (long long)slice * kBK + chunk * 16;
    cp_async16(smem_u32(a_s + a_off(row, chunk)), src);
  }
  for (int i = threadIdx.x; i < kBK * kBChunks; i += kThreads) {
    const int row = i / kBChunks, chunk = i % kBChunks;
    const unsigned char* src = b + (long long)(slice * kBK + row) * n + n0 + chunk * 16;
    cp_async16(smem_u32(b_s + b_off(row, chunk)), src);
  }
}

// b fragments of the warp's four n8 tiles for k-step `s` of a slice (k32).
__device__ __forceinline__ void load_b(unsigned (&bf)[4][2], const unsigned char* b_s, int s, int warp_n, int lane) {
  const int j = lane >> 3, i = lane & 7;  // the lane addresses row i of matrix j
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // 16 columns per ldmatrix.x4
    unsigned r[4];
    // matrices X0, Y0 (k 0..15), X1, Y1 (k 16..31) of 16 columns: X rows
    // are k = 4(i/2) + i%2, Y rows the same + 2.
    const int row = s * 32 + (j >> 1) * 16 + 4 * (i >> 1) + 2 * (j & 1) + (i & 1);
    ldmatrix_x4_trans(r, smem_u32(b_s + b_off(row, warp_n * 2 + p)));
    bf[2 * p][0] = __byte_perm(r[0], r[1], 0x6420);  // even columns, k 4t..4t+3
    bf[2 * p][1] = __byte_perm(r[2], r[3], 0x6420);  // even columns, k 16+4t..
    bf[2 * p + 1][0] = __byte_perm(r[0], r[1], 0x7531);  // odd columns
    bf[2 * p + 1][1] = __byte_perm(r[2], r[3], 0x7531);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
mma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int* __restrict__ out, int m, int k, int n,
           int n_outer) {
  __shared__ __align__(128) unsigned char smem[kStages][2][kTileBytes];

  const int tiles_m = m / kBM, tiles_n = n / kBN;
  const int bid = blockIdx.x;
  const int tm = n_outer ? bid % tiles_m : bid / tiles_n;
  const int tn = n_outer ? bid / tiles_m : bid % tiles_n;
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp / (kBN / kWarpN), warp_n = warp % (kBN / kWarpN);
  const auto* a_bytes = reinterpret_cast<const unsigned char*>(a);
  const auto* b_bytes = reinterpret_cast<const unsigned char*>(b);

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int slices = k / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < slices) load_slice(smem[st][0], smem[st][1], a_bytes, b_bytes, m0, n0, st, k, n);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (for this thread)
    __syncthreads();               // ... for every thread, and slice kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < slices) load_slice(smem[next % kStages][0], smem[next % kStages][1], a_bytes, b_bytes, m0, n0, next, k, n);
    cp_async_commit();

    const unsigned char* a_s = smem[kt % kStages][0];
    const unsigned char* b_s = smem[kt % kStages][1];
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // two k-steps of 32 bytes per slice
      unsigned bf[4][2];
      load_b(bf, b_s, s, warp_n, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned af[4];
        const int row = warp_m * kWarpM + mi * 16 + (lane & 15);
        ldmatrix_x4(af, smem_u32(a_s + a_off(row, 2 * s + (lane >> 4))));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
      }
    }
  }
  cp_async_wait<0>();

  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const long long row = m0 + warp_m * kWarpM + mi * 16 + (lane >> 2);
    int* o_lo = out + row * n + n0 + warp_n * kWarpN;
    int* o_hi = o_lo + 8LL * n;
#pragma unroll
    for (int p = 0; p < 2; ++p) {  // columns 16p + 4t .. +3: even, odd, even, odd
      const int* ev = acc[mi][2 * p];
      const int* od = acc[mi][2 * p + 1];
      *reinterpret_cast<int4*>(o_lo + p * 16 + 4 * t) = make_int4(ev[0], od[0], ev[1], od[1]);
      *reinterpret_cast<int4*>(o_hi + p * 16 + 4 * t) = make_int4(ev[2], od[2], ev[3], od[3]);
    }
  }
}

cudaError_t launch(const void* a, const void* b, int* out, int m, int k, int n, int n_outer, cudaStream_t s) {
  const int blocks = (m / kBM) * (n / kBN);
  mma_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), out, m, k, n,
                                         n_outer);
  return cudaGetLastError();
}

}  // namespace int8_mma

}  // namespace

// a: (m, k) and b: (k, n), row-major, bf16 (int8 == 0) or int8 (int8 != 0);
// out: (m, n) row-major, f32 for bf16 operands, int32 for int8. m and n
// multiples of 128, k a multiple of 64 bytes of an a row (32 bf16, 64 int8),
// all pointers 16-byte aligned. n_outer != 0 walks the output tiles
// N-tile-major. Returns the CUDA error of the launch (cudaErrorInvalidValue if
// a tensor map cannot be encoded).
extern "C" int tt_tc_matmul(const void* a, const void* b, void* out, int m, int k, int n, int int8, int n_outer,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? int8_mma::launch(a, b, static_cast<int*>(out), m, k, n, n_outer, s)
              : bf16_wgmma::launch(a, b, static_cast<float*>(out), m, k, n, n_outer, s);
}
