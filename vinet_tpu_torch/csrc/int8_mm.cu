// Matrix product for Hopper (sm_90a): C = A @ B, int8 x int8 -> int32 or
// bf16 x bf16 -> f32, on the CUDA cores.
//
// Replaces the TPU kernel scripts/exp_int8_mxu_r5.py::pallas_mm (kernel body
// _mm_kernel): a @ b accumulated in acc_dtype. A (M, K) and B (K, N) are
// row-major and contiguous, C (M, N) row-major. Unlike the Pallas kernel,
// which needs M and N to be multiples of its 512 blocks, any M, N and K
// work: a convolution's M is B*T*H*W. The int8 sums are exact (int32).
//
// Bound on the card (H100 SXM data sheet): at the experiment's 4096 x 1024 x
// 1024 the int8 product must move 22.0 MB (6.6 us at 3.35 TB/s) and do 8.6
// GOP (4.3 us at the tensor cores' 1,979 TOPS), so it is bound by its bytes
// at best. This kernel does not reach the tensor cores: __dp4a on the CUDA
// cores (four products an instruction) limits it far above that bound, and
// the bf16 entry is limited by the f32 FMA rate.
//
// Design: the shared tile core of gemm_core.cuh; A's rows are read as packed
// 32-bit words when K is a multiple of 4 and A is 4-byte aligned, else byte by
// byte with the ragged edge masked.

#include "gemm_core.cuh"

namespace {

template <typename In>
struct RowMajorA {
  const In* a;
  int M, K;
  bool words;  // int8 only: K % 4 == 0 and a 4-byte aligned

  template <typename T>
  __device__ __forceinline__ typename T::Unit load(int, int row, int k) const {
    if (row >= M || k >= K) return typename T::Unit(0);
    const In* p = a + static_cast<int64_t>(row) * K + k;
    if constexpr (T::kPerUnit == 4) {
      if (words) return *reinterpret_cast<const int32_t*>(p);
    }
    return gemm::gather_unit<T>(p, 1, k, K);
  }
};

}  // namespace

// Plain C entries, loaded with ctypes; each returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int int8_mm_s8(const void* a, const void* b, void* c, int m, int n, int k,
                          void* stream) {
  const auto* pa = static_cast<const int8_t*>(a);
  const bool words = k % 4 == 0 && reinterpret_cast<uintptr_t>(pa) % 4 == 0;
  return gemm::launch<gemm::Int8>(RowMajorA<int8_t>{pa, m, k, words}, b, c, m, n, k, 1, stream);
}

extern "C" int int8_mm_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                            void* stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  return gemm::launch<gemm::Bf16>(RowMajorA<__nv_bfloat16>{pa, m, k, false}, b, c, m, n, k, 1,
                                  stream);
}
