// Tiled GEMM core on the CUDA cores, shared by int8_mm.cu and tconv.cu.
//
// C[z](M, N) = A[z](M, K) @ B(K, N), row-major, for z in [0, gridDim.z). A is
// read through a loader object, so a caller can gather its rows from anywhere
// (tconv.cu assembles each row from kt shifted rows of a T-major slab); B and
// C are plain row-major arrays. Two element types:
//
//   Int8: int8 x int8 -> int32. Four consecutive K values are packed into one
//         32-bit word in shared memory and multiplied with __dp4a, exactly.
//   Bf16: bf16 x bf16 -> f32, converted to f32 in shared memory, f32 FMA.
//
// Tiling: a block of 256 threads computes a 128 x (16 * kTN) tile of C; each
// thread an 8 x kTN micro-tile held in registers (kTN = 8, 4 or 2, chosen by
// the host from N so that thin outputs do not waste most of the block). The K
// loop steps 8 packed units at a time (32 int8 values or 8 bf16 values): the
// block stages an A tile (units x rows, padded by 4 words against bank
// conflicts on the transposed store) and a B tile (units x cols) in shared
// memory, then every thread reads its rows and columns as 16-byte vectors
// (broadcast for A, conflict-free for B). Rows, columns and K beyond the
// array are masked in the loaders (zero), so any M, N and K work.
//
// Left for later: tensor cores (mma.sync s8 m16n8k32, then wgmma with TMA),
// double-buffered tiles and 16-byte global loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // rows of C per block: 16 thread rows x 8
constexpr int kUnits = 8;      // packed K units staged per step
constexpr int kPadA = 4;       // words of padding per A-tile row

struct Int8 {
  using In = int8_t;
  using Unit = int32_t;  // four int8 along K
  using Acc = int32_t;
  static constexpr int kPerUnit = 4;
  __device__ static __forceinline__ Acc mac(Unit a, Unit b, Acc c) { return __dp4a(a, b, c); }
  // element e of a unit, alone in its byte; the elements of a unit add up
  __device__ static __forceinline__ Unit place(In v, int e) {
    return static_cast<Unit>(static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * e));
  }
};

struct Bf16 {
  using In = __nv_bfloat16;
  using Unit = float;
  using Acc = float;
  static constexpr int kPerUnit = 1;
  __device__ static __forceinline__ Acc mac(Unit a, Unit b, Acc c) { return fmaf(a, b, c); }
  __device__ static __forceinline__ Unit place(In v, int) { return __bfloat162float(v); }
};

// One packed unit of a row, from kPerUnit elements at p[0], p[step], ...
// whose K index starts at k; elements at K index >= K are zero.
template <typename T>
__device__ __forceinline__ typename T::Unit gather_unit(const typename T::In* p, int64_t step,
                                                        int k, int K) {
  typename T::Unit v = 0;
#pragma unroll
  for (int e = 0; e < T::kPerUnit; ++e) {
    if (k + e < K) v += T::place(p[e * step], e);
  }
  return v;
}

template <typename T, int kTN, typename ALoader>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(ALoader a, const typename T::In* __restrict__ B, typename T::Acc* __restrict__ C,
            int M, int N, int K) {
  using Unit = typename T::Unit;
  using Acc = typename T::Acc;
  constexpr int kBN = 16 * kTN;
  constexpr int kVec = kTN < 4 ? kTN : 4;  // units per vector read of B
  constexpr int kBK = kUnits * T::kPerUnit;

  __shared__ __align__(16) Unit As[kUnits][kBM + kPadA];
  __shared__ __align__(16) Unit Bs[kUnits][kBN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int z = blockIdx.z;

  Acc acc[8][kTN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kUnits; i += kThreads) {
      const int r = i / kUnits, q = i % kUnits;
      As[q][r] = a.template load<T>(z, m0 + r, k0 + q * T::kPerUnit);
    }
    for (int i = threadIdx.x; i < kUnits * kBN; i += kThreads) {
      const int q = i / kBN, c = i % kBN;
      const int k = k0 + q * T::kPerUnit, n = n0 + c;
      Bs[q][c] = n < N ? gather_unit<T>(B + static_cast<int64_t>(k) * N + n, N, k, K) : Unit(0);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kUnits; ++q) {
      Unit av[8], bv[kTN];
      *reinterpret_cast<uint4*>(&av[0]) = *reinterpret_cast<const uint4*>(&As[q][ty * 4]);
      *reinterpret_cast<uint4*>(&av[4]) = *reinterpret_cast<const uint4*>(&As[q][64 + ty * 4]);
#pragma unroll
      for (int g = 0; g < kTN / kVec; ++g) {
        const Unit* src = &Bs[q][g * 16 * kVec + tx * kVec];
        if constexpr (kVec == 4) {
          *reinterpret_cast<uint4*>(&bv[g * 4]) = *reinterpret_cast<const uint4*>(src);
        } else {
          *reinterpret_cast<uint2*>(&bv[g * 2]) = *reinterpret_cast<const uint2*>(src);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = T::mac(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  Acc* Cz = C + static_cast<int64_t>(z) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + (j / kVec) * 16 * kVec + tx * kVec + j % kVec;
      if (n < N) Cz[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

// Launch over gridDim.z = batches on the caller's stream; returns
// cudaGetLastError() (0 on success).
template <typename T, typename ALoader>
int launch(const ALoader& a, const void* B, void* C, int M, int N, int K, int batches,
           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const typename T::In*>(B);
  auto* c = static_cast<typename T::Acc*>(C);
  const unsigned gm = static_cast<unsigned>((M + kBM - 1) / kBM);
  if (N > 64) {
    const dim3 grid(gm, static_cast<unsigned>((N + 127) / 128), static_cast<unsigned>(batches));
    gemm_kernel<T, 8><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K);
  } else if (N > 32) {
    const dim3 grid(gm, static_cast<unsigned>((N + 63) / 64), static_cast<unsigned>(batches));
    gemm_kernel<T, 4><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K);
  } else {
    const dim3 grid(gm, static_cast<unsigned>((N + 31) / 32), static_cast<unsigned>(batches));
    gemm_kernel<T, 2><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
