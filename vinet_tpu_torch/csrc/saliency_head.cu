// Fused saliency head for Hopper (sm_90a): conv6 + ReLU + conv7 + sigmoid.
//
// Replaces the TPU kernel vinet_tpu/ops/pallas_head.py::saliency_head_pallas
// (kernel body _head_kernel). Computes, for every pixel (b, h, w):
//
//   out[b,h,w] = sigmoid(b7 + sum_d w7[d] * relu(b6[d]
//                         + sum_{t,c} z[b,c,t,h,w] * w6[d,c,t]))
//
// z is the decoder's relu(conv5) upsampled to full map resolution, contiguous
// NCDHW (B, 32, kt, H, W) in bf16 or f32; w6 is conv6's (32, 32, kt) weight,
// b6 its optional bias, w7 conv7's (32,) weight and b7 its bias; all weights
// f32. The output is (B, H, W) f32. Accumulation is f32 throughout.
//
// Bound on the card, for the clip-32 main-path shape (16, 32, 2, 224, 384)
// bf16, derived from the H100 SXM data sheet: the kernel must read 176.2 MB
// of z and write 5.5 MB of maps, 54 us at 3.35 TB/s, so the head is
// memory-bound. It does 5.73 GFLOP (4,160 FLOP a pixel); on the CUDA cores in
// f32, without tensor cores, that takes 85 us at the data sheet's 67 TFLOP/s,
// so this design is expected to be limited by its FMA rate above the memory
// bound.
//
// Design: one thread per output pixel, so neighbouring threads read
// neighbouring w and each (c, t) plane of z is read coalesced, once. conv6,
// conv7 and the biases are staged in shared memory once per block (8 KB for
// kt 2); every thread of a warp reads the same weight, a broadcast, four at a
// time as float4. The 32 conv6 accumulators live in registers. The ragged
// edge is masked, so any H and W work. The kernel launches on the caller's
// stream, does not synchronise and allocates nothing.
//
// Left for later: tensor cores (the 32x32 conv6 per tap as an MMA) to get
// under the FMA limit, and fusing the preceding 2x upsample into the kernel
// so the upsampled z is never written to device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;        // conv5 / conv6 channels
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
saliency_head_kernel(const T* __restrict__ z, const float* __restrict__ w6,
                     const float* __restrict__ b6, const float* __restrict__ w7,
                     const float* __restrict__ b7, float* __restrict__ out,
                     int kt, int64_t hw) {
  // shared layout: w6s[t][c][d] (kt*32*32), then b6s[32], w7s[32]
  extern __shared__ __align__(16) float smem[];
  float* w6s = smem;
  float* b6s = smem + kt * kC * kC;
  float* w7s = b6s + kC;

  const int n_w6 = kt * kC * kC;
  for (int i = threadIdx.x; i < n_w6; i += blockDim.x) {
    // global w6 is (d, c, t): i = (d * 32 + c) * kt + t
    const int t = i % kt;
    const int c = (i / kt) % kC;
    const int d = i / (kt * kC);
    w6s[(t * kC + c) * kC + d] = w6[i];
  }
  if (threadIdx.x < kC) {
    b6s[threadIdx.x] = b6 != nullptr ? b6[threadIdx.x] : 0.f;
    w7s[threadIdx.x] = w7[threadIdx.x];
  }
  __syncthreads();

  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y;

  float acc[kC];
#pragma unroll
  for (int d = 0; d < kC; ++d) acc[d] = b6s[d];

  const T* zb = z + static_cast<int64_t>(b) * kC * kt * hw + p;
  for (int t = 0; t < kt; ++t) {
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float v = to_f32(zb[(static_cast<int64_t>(c) * kt + t) * hw]);
      const float4* wrow = reinterpret_cast<const float4*>(w6s + (t * kC + c) * kC);
#pragma unroll
      for (int q = 0; q < kC / 4; ++q) {
        const float4 w = wrow[q];
        acc[4 * q + 0] = fmaf(v, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v, w.w, acc[4 * q + 3]);
      }
    }
  }

  float y = b7[0];
#pragma unroll
  for (int d = 0; d < kC; ++d) y = fmaf(w7s[d], fmaxf(acc[d], 0.f), y);
  out[static_cast<int64_t>(b) * hw + p] = 1.f / (1.f + expf(-y));
}

template <typename T>
int launch(const void* z, const void* w6, const void* b6, const void* w7,
           const void* b7, void* out, int batch, int kt, int64_t hw, void* stream) {
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const size_t smem = sizeof(float) * (kt * kC * kC + 2 * kC);
  saliency_head_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const float*>(w6),
      static_cast<const float*>(b6), static_cast<const float*>(w7),
      static_cast<const float*>(b7), static_cast<float*>(out), kt, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, loaded with ctypes. Each returns cudaGetLastError() after
// the launch (0 on success). b6 may be null.
extern "C" int saliency_head_bf16(const void* z, const void* w6, const void* b6,
                                  const void* w7, const void* b7, void* out,
                                  int batch, int kt, int64_t hw, void* stream) {
  return launch<__nv_bfloat16>(z, w6, b6, w7, b7, out, batch, kt, hw, stream);
}

extern "C" int saliency_head_f32(const void* z, const void* w6, const void* b6,
                                 const void* w7, const void* b7, void* out,
                                 int batch, int kt, int64_t hw, void* stream) {
  return launch<float>(z, w6, b6, w7, b7, out, batch, kt, hw, stream);
}
