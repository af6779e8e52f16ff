// Temporal (kt, 1, 1) convolution for Hopper (sm_90a) as one K = kt * C
// product per output tap, int8 x int8 -> int32 or bf16 x bf16 -> f32, on the
// CUDA cores.
//
// Replaces the TPU kernel scripts/exp_int8_mxu_r5.py::pallas_tconv (kernel
// body _tconv_kernel). With x the zero-padded T-major slab (T_pad, M, C), w
// (kt, C, CO) and t_out = (T_pad - kt) / stride + 1, it computes
//
//   out[to, m, co] = sum_{k < kt, c < C} x[stride * to + k, m, c] * w[k, c, co]
//
// into out (T_out, M, CO). The Pallas kernel assembles, for each output tap,
// the (m_blk, kt*C) GEMM operand in VMEM scratch from kt shifted rows of the
// slab, then does one K = kt*C dot against the whole weight. Here a block
// (one tap `to` = blockIdx.z, one 128-row M tile, one CO tile) gathers the
// same shifted rows straight into its shared-memory A tile, K step by K step,
// so the (M, kt*C) operand never exists in device memory. The weight goes
// through shared memory in (32 x CO-tile) steps rather than whole: kt*C*CO
// reaches 442 KB for the model's 3 x 384 x 384 convs, above a block's 227 KB.
// Any M (a multiple of nothing: B*H*W), C, CO and stride work.
//
// Bound on the card (H100 SXM data sheet): at the experiment's stem shape,
// x (38, 344064, 64) int8 and w (7, 64, 64), stride 2, the kernel must read
// 0.84 GB and write 1.41 GB of int32, 0.67 ms at 3.35 TB/s, for 316 GOP (0.16
// ms at 1,979 int8 TOPS): bound by its bytes. On the CUDA cores with __dp4a it
// is limited by its multiply rate instead (gemm_core.cuh).

#include "gemm_core.cuh"

namespace {

template <typename In>
struct SlabA {
  const In* x;  // (T_pad, M, C)
  int M, C, K, stride;
  bool words;  // int8 only: C % 4 == 0 and x 4-byte aligned

  template <typename T>
  __device__ __forceinline__ typename T::Unit load(int to, int m, int k) const {
    using Unit = typename T::Unit;
    if (m >= M || k >= K) return Unit(0);
    if constexpr (T::kPerUnit == 4) {
      if (words) {  // four channels of one tap
        const int tap = k / C, c = k % C;
        return *reinterpret_cast<const int32_t*>(
            x + (static_cast<int64_t>(stride * to + tap) * M + m) * C + c);
      }
    }
    Unit v = 0;  // a unit may straddle two taps when C % 4 != 0
#pragma unroll
    for (int e = 0; e < T::kPerUnit; ++e) {
      const int kk = k + e;
      if (kk < K) {
        const int tap = kk / C, c = kk % C;
        v += T::place(x[(static_cast<int64_t>(stride * to + tap) * M + m) * C + c], e);
      }
    }
    return v;
  }
};

}  // namespace

// Plain C entries, loaded with ctypes; each returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int tconv_s8(const void* x, const void* w, void* out, int t_out, int m, int c,
                        int kt, int co, int stride, void* stream) {
  const auto* px = static_cast<const int8_t*>(x);
  const bool words = c % 4 == 0 && reinterpret_cast<uintptr_t>(px) % 4 == 0;
  return gemm::launch<gemm::Int8>(SlabA<int8_t>{px, m, c, kt * c, stride, words}, w, out, m, co,
                                  kt * c, t_out, stream);
}

extern "C" int tconv_bf16(const void* x, const void* w, void* out, int t_out, int m, int c,
                          int kt, int co, int stride, void* stream) {
  const auto* px = static_cast<const __nv_bfloat16*>(x);
  return gemm::launch<gemm::Bf16>(SlabA<__nv_bfloat16>{px, m, c, kt * c, stride, false}, w, out,
                                  m, co, kt * c, t_out, stream);
}
