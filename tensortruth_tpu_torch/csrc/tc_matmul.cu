// Tensor-core matrix product, bf16 -> f32 and int8 -> int32 (kernel B5, both
// operand types and both block orders; one template over the operand type).
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
// Design (a simple correct kernel first; wgmma, TMA and warp specialisation
// are later work). The TPU kernel takes a 512x1024 output tile per grid step
// with the whole K resident in VMEM; that f32 tile alone is 2 MiB. Here a
// block of 8 warps owns a 128x128 output tile, each warp 64x32 of it in
// registers, fed by mma.sync (m16n8k16 bf16 with f32 sums, m16n8k32 s8 with
// s32 sums), and K streams through shared memory in slices of 64 bytes of an
// a row (32 bf16 or 64 int8 columns of a, the same rows of b), copied with
// cp.async into a ring of three (two loading while one is consumed).
// Shared-memory rows are XOR-swizzled in 16-byte chunks so that each 8-row
// ldmatrix phase reads 8 distinct bank groups.
//
// The int8 b operand: ldmatrix .trans exists only for 16-bit elements, and
// m16n8k32 wants 4 consecutive k of one column in each register. ldmatrix
// .trans over byte pairs (two adjacent columns) gives each register 2 k x 2
// columns; its rows are chosen so that one register holds k = 4t, 4t+1 and
// its partner k = 4t+2, 4t+3, and __byte_perm splits the pair into one
// register per column. So one ldmatrix.x4.trans feeds two MMAs, over the even
// and over the odd columns of a 16-column group, and a thread's int32 sums
// come out as 4 adjacent columns of a row: no transposed copy of b anywhere.
//
// n_outer (the TPU kernel's N-tile-major grid, which keeps the b block
// resident in VMEM across a column sweep) becomes the order in which block
// ids walk the output tiles: N-tile-major keeps one column of b tiles hot in
// L2 while the a tiles stream past.
//
// The output (256 MiB at the probe's shape) is stored straight from the
// accumulators, 8 bytes (f32) or 16 bytes (int32) per thread and row: every
// store writes whole 32-byte sectors, with no staging through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128, kBN = 128;        // output tile of a block
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kWarpM = 64, kWarpN = 32;    // output tile of a warp (2 x 4 warps)
constexpr int kStages = 3;                 // K slices in the shared-memory ring
constexpr int kSliceBytes = 64;            // bytes of one a row in a slice
constexpr int kTileBytes = kBM * kSliceBytes;  // 8 KiB: a's slice; b's slice is the same size

static_assert(kWarps == (kBM / kWarpM) * (kBN / kWarpN), "warp grid covers the block tile");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// T is the operand type: __nv_bfloat16 or int8_t.
template <typename T>
struct Tile {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static constexpr int kBK = kSliceBytes / sizeof(T);         // k per slice: 32 or 64
  static constexpr int kBRowBytes = kBN * sizeof(T);          // b slice row: 256 or 128 bytes
  static constexpr int kBChunks = kBRowBytes / 16;
  static_assert(kBK * kBRowBytes == kTileBytes, "a and b slices are the same size");

  // a slice: 128 rows x 4 chunks of 16 bytes. The 8 rows of an ldmatrix
  // phase (same chunk) land on 8 distinct 16-byte bank groups.
  __device__ static int a_off(int row, int chunk) { return row * kSliceBytes + ((chunk ^ ((row >> 1) & 3)) << 4); }

  // b slice: kBK rows (k) x kBChunks chunks. bf16 phases read 8 consecutive
  // k rows; int8 phases read k rows {0,1,4,5,8,9,12,13} (+2, +16, ...), so
  // the int8 swizzle is a different function of the row.
  __device__ static int b_off(int row, int chunk) {
    const int swz = kInt8 ? ((row & 1) | ((row >> 1) & 6)) : (row & 7);
    return row * kBRowBytes + ((chunk ^ swz) << 4);
  }
};

template <typename T>
__device__ __forceinline__ void load_slice(unsigned char* a_s, unsigned char* b_s, const unsigned char* a,
                                           const unsigned char* b, int m0, int n0, int slice, int k, int n) {
  using Tl = Tile<T>;
  constexpr int kES = sizeof(T);
  for (int i = threadIdx.x; i < kBM * (kSliceBytes / 16); i += kThreads) {
    const int row = i >> 2, chunk = i & 3;
    const unsigned char* src = a + ((long long)(m0 + row) * k + (long long)slice * Tl::kBK) * kES + chunk * 16;
    cp_async16(smem_addr(a_s + Tl::a_off(row, chunk)), src);
  }
  for (int i = threadIdx.x; i < Tl::kBK * Tl::kBChunks; i += kThreads) {
    const int row = i / Tl::kBChunks, chunk = i % Tl::kBChunks;
    const unsigned char* src = b + ((long long)(slice * Tl::kBK + row) * n + n0) * kES + chunk * 16;
    cp_async16(smem_addr(b_s + Tl::b_off(row, chunk)), src);
  }
}

// b fragments of the warp's four n8 tiles for k-step `s` of a slice (32
// bytes of an a row: k16 bf16 or k32 int8).
template <typename T>
__device__ __forceinline__ void load_b(unsigned (&bf)[4][2], const unsigned char* b_s, int s, int warp_n,
                                       int lane) {
  using Tl = Tile<T>;
  const int j = lane >> 3, i = lane & 7;  // the lane addresses row i of matrix j
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // 16 columns per ldmatrix.x4
    unsigned r[4];
    if constexpr (Tl::kInt8) {
      // matrices X0, Y0 (k 0..15), X1, Y1 (k 16..31) of 16 columns: X rows
      // are k = 4(i/2) + i%2, Y rows the same + 2.
      const int row = s * 32 + (j >> 1) * 16 + 4 * (i >> 1) + 2 * (j & 1) + (i & 1);
      ldmatrix_x4_trans(r, smem_addr(b_s + Tl::b_off(row, warp_n * 2 + p)));
      bf[2 * p][0] = __byte_perm(r[0], r[1], 0x6420);  // even columns, k 4t..4t+3
      bf[2 * p][1] = __byte_perm(r[2], r[3], 0x6420);  // even columns, k 16+4t..
      bf[2 * p + 1][0] = __byte_perm(r[0], r[1], 0x7531);  // odd columns
      bf[2 * p + 1][1] = __byte_perm(r[2], r[3], 0x7531);
    } else {
      // matrices (k 0..7 | k 8..15) x (columns 0..7 | 8..15)
      const int row = s * 16 + (j & 1) * 8 + i;
      ldmatrix_x4_trans(r, smem_addr(b_s + Tl::b_off(row, warp_n * 4 + p * 2 + (j >> 1))));
      bf[2 * p][0] = r[0];
      bf[2 * p][1] = r[1];
      bf[2 * p + 1][0] = r[2];
      bf[2 * p + 1][1] = r[3];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tc_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, typename Tile<T>::Acc* __restrict__ out, int m,
                 int k, int n, int n_outer) {
  using Tl = Tile<T>;
  using Acc = typename Tl::Acc;
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

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

  const int slices = k / Tl::kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < slices) load_slice<T>(smem[st][0], smem[st][1], a_bytes, b_bytes, m0, n0, st, k, n);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (for this thread)
    __syncthreads();               // ... for every thread, and slice kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < slices) load_slice<T>(smem[next % kStages][0], smem[next % kStages][1], a_bytes, b_bytes, m0, n0,
                                     next, k, n);
    cp_async_commit();

    const unsigned char* a_s = smem[kt % kStages][0];
    const unsigned char* b_s = smem[kt % kStages][1];
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // two k-steps of 32 bytes per slice
      unsigned bf[4][2];
      load_b<T>(bf, b_s, s, warp_n, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned af[4];
        const int row = warp_m * kWarpM + mi * 16 + (lane & 15);
        ldmatrix_x4(af, smem_addr(a_s + Tl::a_off(row, 2 * s + (lane >> 4))));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const long long row = m0 + warp_m * kWarpM + mi * 16 + g;
    Acc* o_lo = out + row * n + n0 + warp_n * kWarpN;
    Acc* o_hi = o_lo + 8LL * n;
    if constexpr (Tl::kInt8) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // columns 16p + 4t .. +3: even, odd, even, odd
        const int* ev = acc[mi][2 * p];
        const int* od = acc[mi][2 * p + 1];
        *reinterpret_cast<int4*>(o_lo + p * 16 + 4 * t) = make_int4(ev[0], od[0], ev[1], od[1]);
        *reinterpret_cast<int4*>(o_hi + p * 16 + 4 * t) = make_int4(ev[2], od[2], ev[3], od[3]);
      }
    } else {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {  // columns 8ni + 2t, +1
        *reinterpret_cast<float2*>(o_lo + ni * 8 + 2 * t) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(o_hi + ni * 8 + 2 * t) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, int m, int k, int n, int n_outer, cudaStream_t s) {
  const int blocks = (m / kBM) * (n / kBN);
  tc_matmul_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                  static_cast<typename Tile<T>::Acc*>(out), m, k, n, n_outer);
  return cudaGetLastError();
}

}  // namespace

// a: (m, k) and b: (k, n), row-major, bf16 (int8 == 0) or int8 (int8 != 0);
// out: (m, n) row-major, f32 for bf16 operands, int32 for int8. m and n
// multiples of 128, k a multiple of 64 bytes of an a row (32 bf16, 64 int8),
// all pointers 16-byte aligned. n_outer != 0 walks the output tiles
// N-tile-major. Returns the CUDA error of the launch.
extern "C" int tt_tc_matmul(const void* a, const void* b, void* out, int m, int k, int n, int int8, int n_outer,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? launch<int8_t>(a, b, out, m, k, n, n_outer, s)
              : launch<__nv_bfloat16>(a, b, out, m, k, n, n_outer, s);
}
