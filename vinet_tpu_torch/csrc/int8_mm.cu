// Matrix product for Hopper (sm_90a) on the tensor cores: C = A @ B,
// int8 x int8 -> int32 or bf16 x bf16 -> f32.
//
// Replaces the TPU kernel scripts/exp_int8_mxu_r5.py::pallas_mm (kernel body
// _mm_kernel): a @ b accumulated in acc_dtype. A (M, K) is row-major and
// contiguous; B comes K-major, as Bt (N, K) row-major; C (M, N) is row-major.
// Unlike the Pallas kernel, which needs M and N to be multiples of its 512
// blocks, any M, N and K work: a convolution's M is B*T*H*W. The int8 sums
// are exact (int32).
//
// Bound on the card (H100 SXM data sheet): at the experiment's 4096 x 1024 x
// 1024 the int8 product must move 22.0 MB (6.6 us at 3.35 TB/s) and do 8.6
// GOP (4.3 us at the tensor cores' 1,979 TOPS), so it is bound by its bytes;
// the thin products of the model (N 16 to 832, M up to 11 M rows) are bound
// by reading A.
//
// Design: the tensor-core core of gemm_core.cuh (mma.sync, a 4-stage
// cp.async ring). A's rows are copied 16 bytes at a time when K * element
// size is a multiple of 16 and A and Bt are 16-byte aligned (every product of
// the model: its im2col pads K to a multiple of 16); any other K takes the
// masked variant of the same kernel.

#include "gemm_core.cuh"

namespace {

// A (M, K) row-major: element k of row m.
template <typename In>
struct Int8MmA {
  const In* a;
  int K;

  __device__ __forceinline__ const In* origin() const { return a; }
  __device__ __forceinline__ const In* at(int, int m, int k) const {
    return a + static_cast<int64_t>(m) * K + k;
  }
};

template <typename T>
int int8_mm(const void* a, const void* bt, void* c, int m, int n, int k, void* stream) {
  using In = typename T::In;
  const bool aligned = gemm::rows_aligned(a, bt, static_cast<int64_t>(k) * sizeof(In));
  return gemm::launch<T>(Int8MmA<In>{static_cast<const In*>(a), k}, bt, c, m, n, k, 1, aligned,
                         stream);
}

}  // namespace

// Plain C entries, loaded with ctypes: a (m, k), bt (n, k), c (m, n). Each
// returns the first CUDA error of the launch (0 on success).
extern "C" int int8_mm_s8(const void* a, const void* bt, void* c, int m, int n, int k,
                          void* stream) {
  return int8_mm<gemm::Int8>(a, bt, c, m, n, k, stream);
}

extern "C" int int8_mm_bf16(const void* a, const void* bt, void* c, int m, int n, int k,
                            void* stream) {
  return int8_mm<gemm::Bf16>(a, bt, c, m, n, k, stream);
}
