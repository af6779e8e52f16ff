// Tensor-core GEMM core for Hopper (sm_90a), shared by int8_mm.cu and tconv.cu.
//
// C[z](M, N) = A[z](M, K) @ B(K, N) for z in [0, batches). B comes K-major:
// Bt (N, K) row-major, each column's K values contiguous, which is the "col"
// operand of mma.sync (on sm_90 ldmatrix cannot transpose 8-bit data). A is
// read through a loader object, so a caller can gather its rows from anywhere
// (tconv.cu assembles each row from kt shifted rows of a T-major slab); C is
// row-major. Two element types:
//
//   Int8: int8 x int8 -> int32 on mma.sync m16n8k32 s8, exact (the
//         non-saturating form: K * 127^2 < 2^31 for every K of the model,
//         at most 22,464)
//   Bf16: bf16 x bf16 -> f32 on mma.sync m16n8k16 bf16
//
// Both see a row as bytes: one K step is kRowBytes = 64 bytes of each row by
// default (64 int8 or 32 bf16 values), two mma K slices of 32 bytes.
//
// Tiling: a block of 8 warps computes a 128 x kBN tile of C, kBN = 128, 64,
// 32 or 16 chosen by the host from N so that thin outputs do not idle most of
// the block. The warps split the tile kWarpsM x kWarpsN; each warp holds a
// (16 kMI) x (8 kNI) grid of m16n8 accumulators in registers and loads its
// fragments with ldmatrix.x4. Blocks are numbered with z fastest, then the N
// tile, then the M tile, so the blocks that read the same rows of A (tconv's
// output taps of one M tile, int8_mm's N tiles of one M tile) run together
// and find those rows in L2.
//
// Staging: a ring of kStages = 4 (A, B) tiles in dynamic shared memory, 36 to
// 64 KB by tile width (above 48 KB only after cudaFuncSetAttribute). The async
// variant fills it with 16-byte cp.async.cg copies, one commit group per K
// step, kStages - 1 steps ahead of the products, so the copies of step
// k + 3 overlap the products of step k. Chunks beyond M, N or K are
// zero-filled by the copy (src-size 0), not branched around. It needs every
// row of A and Bt to start 16-byte aligned (the host checks). The masked
// variant fills the same ring with ordinary element loads, for any K and
// alignment. A 64-byte row is stored with its 16-byte chunk index XORed by
// (row / 2) % 4, so the eight rows that one ldmatrix phase reads fall in
// eight different bank groups.
//
// Epilogue: in an m16n8 fragment each thread owns two adjacent columns of a
// row; they go out as one 8-byte store when N is even, else as two masked
// 4-byte stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The K step, the ring depth and the widest tile can be set at compile time
// (-DGEMM_ROW_BYTES=32|64|128, -DGEMM_STAGES=2.., -DGEMM_MAX_BN=16..128), so
// that vinet_tpu_torch/tools/sweep_gemm.py can time other tilings; the
// package builds the defaults.
#ifndef GEMM_ROW_BYTES
#define GEMM_ROW_BYTES 64
#endif
#ifndef GEMM_STAGES
#define GEMM_STAGES 4
#endif
#ifndef GEMM_MAX_BN
#define GEMM_MAX_BN 128
#endif

namespace gemm {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of C per block
constexpr int kRowBytes = GEMM_ROW_BYTES;  // bytes of each operand row per K step
constexpr int kChunks = kRowBytes / 16;    // 16-byte chunks per row per step
constexpr int kStages = GEMM_STAGES;       // ring slots
constexpr int kMaxBN = GEMM_MAX_BN;        // widest tile the host may choose
static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128, "K step");
static_assert(kStages >= 2, "ring");

// A block's tile: kBN columns of C, split over kWarpsN warps (8 / kWarpsN
// along M).
template <int kBN_, int kWarpsN_>
struct Tile {
  static constexpr int kBN = kBN_, kWarpsN = kWarpsN_;
  static constexpr int kSlot = (kBM + kBN) * kRowBytes;  // one ring slot: A, then B
  static constexpr int kSmem = kStages * kSlot;
};

struct Int8 {
  using In = int8_t;
  using Acc = int32_t;
  __device__ static __forceinline__ void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ void store2(Acc* p, Acc x, Acc y) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  }
};

struct Bf16 {
  using In = uint16_t;  // bf16 bits: the core only moves them
  using Acc = float;
  __device__ static __forceinline__ void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ void store2(Acc* p, Acc x, Acc y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk ch of row r in a tile of kRowBytes rows: the
// chunk index is XORed with the row's place among the 128-byte lines that
// eight rows span ((r / 2) % 4 for 64-byte rows), so the eight rows that one
// ldmatrix phase reads fall in eight different bank groups.
__device__ __forceinline__ uint32_t swizzle(int r, int ch) {
  return static_cast<uint32_t>(r * kRowBytes + ((ch ^ ((r / (8 / kChunks)) % kChunks)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// One 16-byte chunk of a tile row: elements k .. k + 16 / sizeof(In) - 1 of
// the row at `row(k)`, where valid_row says the row exists and K bounds k.
// The async variant copies it whole; the masked one element by element.
template <bool kAsync, typename In, typename RowAt>
__device__ __forceinline__ void load_chunk(unsigned char* dst, const In* origin, RowAt at,
                                           bool valid_row, int k, int K) {
  constexpr int kE = 16 / static_cast<int>(sizeof(In));
  if constexpr (kAsync) {
    const bool ok = valid_row && k < K;
    cp_async16(smem_addr(dst), ok ? at(k) : origin, ok);
  } else {
    alignas(16) In v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = valid_row && k + e < K ? *at(k + e) : In(0);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// Stage K step `step` of A and Bt into ring slot `slot` (A then B).
template <typename T, typename Tl, bool kAsync, typename ALoader>
__device__ __forceinline__ void load_step(unsigned char* slot, const ALoader& a,
                                          const typename T::In* bt, int z, int m0, int n0, int M,
                                          int N, int K, int step) {
  using In = typename T::In;
  constexpr int kE = 16 / static_cast<int>(sizeof(In));
  constexpr int kBK = kRowBytes / static_cast<int>(sizeof(In));
  const int k0 = step * kBK;
#pragma unroll
  for (int j = 0; j < kBM * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, ch = i % kChunks, m = m0 + r;
    load_chunk<kAsync>(slot + swizzle(r, ch), a.origin(),
                       [&](int k) { return a.at(z, m, k); }, m < M, k0 + ch * kE, K);
  }
  unsigned char* bslot = slot + kBM * kRowBytes;
  constexpr int kBUnits = Tl::kBN * kChunks;
#pragma unroll
  for (int j = 0; j < (kBUnits + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (kBUnits % kThreads == 0 || i < kBUnits) {
      const int r = i / kChunks, ch = i % kChunks, n = n0 + r;
      const In* row = bt + static_cast<int64_t>(n) * K;
      load_chunk<kAsync>(bslot + swizzle(r, ch), bt,
                         [&](int k) { return row + k; }, n < N, k0 + ch * kE, K);
    }
  }
}

template <typename T, typename Tl, bool kAsync, typename ALoader>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(ALoader a, const typename T::In* __restrict__ bt, typename T::Acc* __restrict__ c,
            int M, int N, int K, int batches) {
  using In = typename T::In;
  using Acc = typename T::Acc;
  constexpr int kBN = Tl::kBN, kWarpsN = Tl::kWarpsN, kTile = Tl::kSlot;
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;
  constexpr int kMI = kWM / 16, kNI = kWN / 8;
  constexpr int kBK = kRowBytes / static_cast<int>(sizeof(In));
  static_assert(kMI >= 1 && kNI >= 2 && kNI % 2 == 0, "warp tile");

  extern __shared__ __align__(128) unsigned char smem[];

  // block -> (z, N tile, M tile), z fastest
  const unsigned gn = static_cast<unsigned>((N + kBN - 1) / kBN);
  unsigned bid = blockIdx.x;
  const int z = static_cast<int>(bid % static_cast<unsigned>(batches));
  bid /= static_cast<unsigned>(batches);
  const int n0 = static_cast<int>(bid % gn) * kBN;
  const int m0 = static_cast<int>(bid / gn) * kBM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  const int steps = (K + kBK - 1) / kBK;

  Acc acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step<T, Tl, kAsync>(smem + s * kTile, a, bt, z, m0, n0, M, N, K, s);
    cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // step's copies have landed (this thread's)
    __syncthreads();               // ... everyone's; and slot step - 1 is free
    const int next = step + kStages - 1;
    if (next < steps) {
      load_step<T, Tl, kAsync>(smem + (next % kStages) * kTile, a, bt, z, m0, n0, M, N, K,
                               next);
    }
    cp_async_commit();

    const uint32_t sa = smem_addr(smem + (step % kStages) * kTile);
    const uint32_t sb = sa + kBM * kRowBytes;
#pragma unroll
    for (int ks = 0; ks < kRowBytes / 32; ++ks) {  // 32-byte K slices
      uint32_t af[kMI][4], bf[kNI][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        ldmatrix_x4(af[mi], sa + swizzle(wm + mi * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + swizzle(wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    ks * 2 + ((lane >> 3) & 1)));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) T::mma(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

  Acc* cz = c + static_cast<int64_t>(z) * M * N;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + h * 8;
      if (m >= M) continue;
      Acc* crow = cz + static_cast<int64_t>(m) * N;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int n = n0 + wn + ni * 8 + tq * 2;
        const Acc x = acc[mi][ni][2 * h], y = acc[mi][ni][2 * h + 1];
        if ((N & 1) == 0) {
          if (n < N) T::store2(crow + n, x, y);
        } else {
          if (n < N) crow[n] = x;
          if (n + 1 < N) crow[n + 1] = y;
        }
      }
    }
  }
}

// True when every row of A and Bt starts 16-byte aligned: the async variant.
inline bool rows_aligned(const void* a, const void* bt, int64_t row_bytes) {
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(bt) % 16 == 0;
}

template <typename T, typename Tl, bool kAsync, typename ALoader>
int launch_tile(const ALoader& a, const typename T::In* bt, typename T::Acc* c, int M, int N,
                int K, int batches, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(gemm_kernel<T, Tl, kAsync, ALoader>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Tl::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>((M + kBM - 1) / kBM) *
                         ((N + Tl::kBN - 1) / Tl::kBN) * batches;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  gemm_kernel<T, Tl, kAsync, ALoader>
      <<<static_cast<unsigned>(blocks), kThreads, Tl::kSmem, stream>>>(a, bt, c, M, N, K,
                                                                        batches);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAsync, typename ALoader>
int launch_width(const ALoader& a, const typename T::In* bt, typename T::Acc* c, int M, int N,
                 int K, int batches, cudaStream_t s) {
  if (N > 64 && kMaxBN >= 128)  // warps 2 x 4, each 64 x 32
    return launch_tile<T, Tile<128, 4>, kAsync>(a, bt, c, M, N, K, batches, s);
  if (N > 32 && kMaxBN >= 64)  // 4 x 2, each 32 x 32
    return launch_tile<T, Tile<64, 2>, kAsync>(a, bt, c, M, N, K, batches, s);
  if (N > 16 && kMaxBN >= 32)  // 4 x 2, each 32 x 16
    return launch_tile<T, Tile<32, 2>, kAsync>(a, bt, c, M, N, K, batches, s);
  return launch_tile<T, Tile<16, 1>, kAsync>(a, bt, c, M, N, K, batches, s);  // 16 x 16
}

// Launch over `batches` values of z on the caller's stream, the async variant
// when `aligned` (see rows_aligned), else the masked one; returns the first
// CUDA error of the shared-memory attribute or the launch (0 on success).
template <typename T, typename ALoader>
int launch(const ALoader& a, const void* Bt, void* C, int M, int N, int K, int batches,
           bool aligned, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bt = static_cast<const typename T::In*>(Bt);
  auto* c = static_cast<typename T::Acc*>(C);
  return aligned ? launch_width<T, true>(a, bt, c, M, N, K, batches, s)
                 : launch_width<T, false>(a, bt, c, M, N, K, batches, s);
}

}  // namespace gemm
