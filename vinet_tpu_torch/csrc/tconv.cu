// Temporal (kt, 1, 1) convolution for Hopper (sm_90a) on the tensor cores, as
// one K = kt * C product per output tap: int8 x int8 -> int32 or bf16 x bf16
// -> f32.
//
// Replaces the TPU kernel scripts/exp_int8_mxu_r5.py::pallas_tconv (kernel
// body _tconv_kernel). With x the zero-padded T-major slab (T_pad, M, C), the
// weight given K-major as wt (CO, kt, C) and t_out = (T_pad - kt) / stride + 1,
// it computes
//
//   out[to, m, co] = sum_{k < kt, c < C} x[stride * to + k, m, c] * wt[co, k, c]
//
// into out (T_out, M, CO). The Pallas kernel assembles, for each output tap,
// the (m_blk, kt*C) GEMM operand in VMEM scratch from kt shifted rows of the
// slab, then does one K = kt*C dot against the whole weight. Here one block
// computes one output tap of one 128-row M tile and one CO tile, and copies
// the same shifted rows straight into its shared-memory ring: each 16-byte
// chunk of an operand row is 16 / element-size channels of one tap, at
// x[stride * to + tap, m, c0 ...] with tap = k / C, its address computed per
// chunk. So the (M, kt*C) operand never exists in device memory, and a 32-byte
// mma K slice may straddle two taps (C = 48 or 208). The weight streams
// through the ring with A rather than sitting in shared memory whole: kt*C*CO
// reaches 442 KB for the model's 3 x 384 x 384 convs, above a block's 227 KB.
// Any M, C, CO and stride work; C * element size % 16 != 0 (or a misaligned
// slab) takes the masked variant of the core.
//
// Bound on the card (H100 SXM data sheet): at the experiment's stem shape,
// x (38, 344064, 64) int8 and w (7, 64, 64), stride 2, the kernel must read
// 0.84 GB and write 1.41 GB of int32, 0.67 ms at 3.35 TB/s, for 316 GOP (0.16
// ms at 1,979 int8 TOPS): bound by its bytes. The blocks of one M tile's
// output taps run together (gemm_core.cuh), so the slab rows that the taps
// share are read from device memory about once.

#include "gemm_core.cuh"

namespace {

// Row m of the operand of output tap `to`: kt shifted slab rows, end to end.
template <typename In>
struct TconvA {
  const In* x;  // (T_pad, M, C)
  int M, C, stride;

  __device__ __forceinline__ const In* origin() const { return x; }
  __device__ __forceinline__ const In* at(int to, int m, int k) const {
    const int tap = k / C;
    return x + (static_cast<int64_t>(stride * to + tap) * M + m) * C + (k - tap * C);
  }
};

template <typename T>
int tconv(const void* x, const void* wt, void* out, int t_out, int m, int c, int kt, int co,
          int stride, void* stream) {
  using In = typename T::In;
  const bool aligned = gemm::rows_aligned(x, wt, static_cast<int64_t>(c) * sizeof(In));
  return gemm::launch<T>(TconvA<In>{static_cast<const In*>(x), m, c, stride}, wt, out, m, co,
                         kt * c, t_out, aligned, stream);
}

}  // namespace

// Plain C entries, loaded with ctypes: x (t_pad, m, c), wt (co, kt, c), out
// (t_out, m, co). Each returns the first CUDA error of the launch (0 on
// success).
extern "C" int tconv_s8(const void* x, const void* wt, void* out, int t_out, int m, int c,
                        int kt, int co, int stride, void* stream) {
  return tconv<gemm::Int8>(x, wt, out, t_out, m, c, kt, co, stride, stream);
}

extern "C" int tconv_bf16(const void* x, const void* wt, void* out, int t_out, int m, int c,
                          int kt, int co, int stride, void* stream) {
  return tconv<gemm::Bf16>(x, wt, out, t_out, m, c, kt, co, stride, stream);
}
