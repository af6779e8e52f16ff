// S3D's stem spatial convolution for Hopper (sm_90a), with its bias and
// ReLU: relu(conv3d(x, w, b, stride (1, 2, 2), padding (0, 3, 3))) for x
// (B, 3, T, H, W) bf16 NCDHW, w (64, 3, 1, 7, 7), b (64,), out (B, 64, T,
// H_out, W_out) bf16 NCDHW. Products of bf16 values summed in f32 on the
// tensor cores, the bias added in f32, then the ReLU and one rounding to bf16.
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (vinet_tpu/models/s3d.py). It was added because cuDNN has no bf16
// tensor-core kernel for 3 input channels: it converts the clip to f32, runs
// an f32 FFMA implicit GEMM at about 3 % of the byte bound, converts the
// output back and adds the bias and the ReLU in passes of their own, about a
// quarter of a parity window batch's device time (PERF.md).
//
// Bound on the card (H100 SXM data sheet): bytes. A parity window batch (16
// clips of 32 x 224 x 384) reads its 264 MB clip once and writes a 1.41 GB
// output: 0.50 ms at 3.35 TB/s, where its 207 GFLOP take 0.21 ms at 989
// TFLOP/s. As a GEMM it is thin in K and N (K = 147 taps, N = 64 channels)
// and long in M (11.0 M output pixels a batch). So:
//
// - Weights stay put. Each block scatters the (64, 147) weights once into
//   shared memory as a (64, 176) K-major matrix, K ordered (c, kh, kw') with
//   8 slots a (c, kh) row: slot kw' = kw + 1, slot 0 and row 21 zero. They
//   are the mma's A operand (m = channel), read by ldmatrix; the bias waits
//   beside them in f32.
// - Inputs are staged as patches. Blocks are persistent and walk tiles of 4
//   output rows x 64 output columns of one frame. A tile's input patch, 13
//   rows x 144 columns of each channel plane from column 2 w0 - 8, arrives in
//   shared memory by 16-byte cp.async copies (zero-filled outside x), one
//   tile ahead of the one being multiplied.
// - The im2col operand is built in registers. With slot kw' = kw + 1, the
//   two taps of each 32-bit B register (kw' even, kw' + 1) sit at input
//   columns 2 wo - 4 + kw', an even column: each register is one aligned
//   32-bit shared load of the staged patch, with no expanded tile anywhere.
//   The taps kw = -1 (slot 0) read a real pixel against a zero weight; the
//   load masks them to +0 so that an infinity there cannot leak a NaN.
// - mma.sync m16n8k16: a warp owns 64 channels x 32 pixels of one output
//   row, 11 K steps. Operations are not the limit.
// - The epilogue stores coalesced. Bias, ReLU and the bf16 rounding in
//   registers; each thread's (channel, two adjacent pixels) pairs go to a
//   (channel, pixel) tile in shared memory, which leaves in 16-byte stores
//   along W of each channel plane, 128 contiguous bytes a (channel, row).
//   That path carries 85 % of the kernel's bytes.
//
// A W that is not a multiple of 8, or x not 16-byte aligned, stages the patch
// element by element; a W_out not a multiple of 8 stores element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = uint16_t;  // bits

constexpr int kThreads = 256;  // 8 warps
constexpr int kCo = 64;        // output channels
constexpr int kCi = 3;         // input channels
constexpr int kTaps = 7;       // kernel height and width
constexpr int kRt = 4;         // output rows a tile
constexpr int kWt = 64;        // output columns a tile
constexpr int kPatchRows = 2 * kRt + 5;      // input rows a tile reads
constexpr int kPatchCols = 2 * kWt + 16;     // staged input columns, from 2 w0 - 8
constexpr int kRowWords = kPatchCols / 2;    // 72
constexpr int kChunksPerRow = kPatchCols / 8;  // 16-byte chunks
constexpr int kPatchChunks = kCi * kPatchRows * kChunksPerRow;  // 702
constexpr int kPatchElems = kCi * kPatchRows * kPatchCols;
constexpr int kQ = kCi * kTaps;  // 21 real (c, kh) rows of K
constexpr int kK = 176;          // (kQ + 1) x 8 slots
constexpr int kSteps = kK / 16;  // 11
constexpr int kWRow = kK + 8;    // weight row stride (halves): ldmatrix rows in 8 bank groups
constexpr int kOutRow = kRt * kWt + 8;  // staged output row stride (halves)

constexpr int kWBytes = kCo * kWRow * 2;           // 23,552
constexpr int kPatchBytes = kPatchElems * 2;       // 11,232
constexpr int kOutBytes = kCo * kOutRow * 2;       // 33,792
constexpr int kBiasBytes = kCo * 4;                // f32
constexpr int kSmem = kWBytes + 2 * kPatchBytes + kOutBytes + kBiasBytes;  // 80,064

static_assert(kPatchBytes % 16 == 0 && kWBytes % 16 == 0, "16-byte aligned regions");
static_assert(2 * kRt == kThreads / 32 && kWt == 64, "two warps of 32 pixels an output row");

struct Geo {
  int B, T, H, W, Ho, Wo;
  long long sb, sc, st;  // x's strides of b, c, t in elements; H and W contiguous
  int tiles_w, tiles_h, tiles;
};

// Word offset in a staged patch of (c, kh) row q of K (q < kQ).
__host__ __device__ constexpr int q_offset(int q) {
  return ((q / kTaps) * kPatchRows + q % kTaps) * kRowWords;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_to_f32(bf16 v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// bias + sum, the ReLU (a NaN stays NaN, as torch.relu keeps it), rounded
// to bf16; two values packed low first.
__device__ __forceinline__ uint32_t relu_pack(float lo, float hi) {
  lo = lo < 0.f ? 0.f : lo;
  hi = hi < 0.f ? 0.f : hi;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Tile {
  int b, t, ho0, wo0;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int tile) {
  const int tw = tile % g.tiles_w;
  const int rest = tile / g.tiles_w;
  const int th = rest % g.tiles_h;
  const int f = rest / g.tiles_h;
  return {f / g.T, f % g.T, th * kRt, tw * kWt};
}

// Stage a tile's input patch: rows 2 ho0 - 3 .. + kPatchRows of each
// channel plane, columns 2 wo0 - 8 .. + kPatchCols, zeros outside x.
template <bool kVecIn>
__device__ __forceinline__ void load_patch(const Geo& g, const bf16* __restrict__ x, Tile tl,
                                           bf16* patch) {
  const int h0 = 2 * tl.ho0 - 3, c0 = 2 * tl.wo0 - 8;
  const long long frame = tl.b * g.sb + tl.t * g.st;
  if constexpr (kVecIn) {
    for (int id = threadIdx.x; id < kPatchChunks; id += kThreads) {
      const int ci = id / (kPatchRows * kChunksPerRow);
      const int rem = id - ci * (kPatchRows * kChunksPerRow);
      const int pr = rem / kChunksPerRow;
      const int qc = rem - pr * kChunksPerRow;
      const int h = h0 + pr, col = c0 + 8 * qc;
      const bool ok = h >= 0 && h < g.H && col >= 0 && col < g.W;  // W % 8 == 0: whole chunks
      const bf16* src = ok ? x + frame + ci * g.sc + static_cast<long long>(h) * g.W + col : x;
      cp_async16(smem_addr(patch + (ci * kPatchRows + pr) * kPatchCols + 8 * qc), src, ok);
    }
  } else {
    for (int id = threadIdx.x; id < kPatchElems; id += kThreads) {
      const int ci = id / (kPatchRows * kPatchCols);
      const int rem = id - ci * (kPatchRows * kPatchCols);
      const int pr = rem / kPatchCols;
      const int h = h0 + pr, col = c0 + rem - pr * kPatchCols;
      bf16 v = 0;
      if (h >= 0 && h < g.H && col >= 0 && col < g.W)
        v = x[frame + ci * g.sc + static_cast<long long>(h) * g.W + col];
      patch[id] = v;
    }
  }
}

// Two blocks an SM (128 registers a thread) on the main paths' form; the
// element-wise staging and stores take more, at one block an SM.
template <bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kThreads, kVecIn && kVecOut ? 2 : 1)
    stemconv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* patches = reinterpret_cast<bf16*>(smem + kWBytes);
  bf16* out_s = reinterpret_cast<bf16*>(smem + kWBytes + 2 * kPatchBytes);
  float* bias_s = reinterpret_cast<float*>(smem + kWBytes + 2 * kPatchBytes + kOutBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;  // mma fragment row group, thread in group
  const int r = warp >> 1, cb = (warp & 1) * 32;  // the warp's output row and first pixel

  if (blockIdx.x < g.tiles) load_patch<kVecIn>(g, x, tile_at(g, blockIdx.x), patches);
  cp_async_commit();

  // weights: slot k = q * 8 + kw + 1 of row co holds w[co, q / 7, 0, q % 7, kw]
  for (int i = tid; i < kCo * kWRow; i += kThreads) {
    const int co = i / kWRow, k = i - co * kWRow;
    const int q = k >> 3, kw = (k & 7) - 1;
    w_s[i] = k < kK && q < kQ && kw >= 0 ? w[co * kQ * kTaps + q * kTaps + kw] : bf16(0);
  }
  if (tid < kCo) bias_s[tid] = bias ? bf16_to_f32(bias[tid]) : 0.f;

  // this thread's ldmatrix row address and its B word in a staged patch
  const uint32_t w_lane = smem_addr(w_s) + (lane & 15) * (kWRow * 2) + (lane >> 4) * 16;
  const int b_word = 2 * r * kRowWords + cb + g8 + 2 + c4;
  const uint32_t mask = c4 == 0 ? 0xFFFF0000u : 0xFFFFFFFFu;  // slot 0: kw = -1
  uint32_t* out_w = reinterpret_cast<uint32_t*>(out_s);
  const long long plane_out = static_cast<long long>(g.Ho) * g.Wo;

  int it = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    if (next < g.tiles)
      load_patch<kVecIn>(g, x, tile_at(g, next), patches + ((it + 1) & 1) * kPatchElems);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's patch (and at first the weights and bias) in; out_s free

    const uint32_t* pw = reinterpret_cast<const uint32_t*>(patches + (it & 1) * kPatchElems) +
                         b_word;
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(a[mt], w_lane + mt * 16 * (kWRow * 2) + s * 32);
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt][0] = pw[q_offset(2 * s) + 8 * nt] & mask;
        b[nt][1] = 2 * s + 1 < kQ ? pw[q_offset(2 * s + 1) + 8 * nt] & mask : 0u;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }

    // epilogue: (channel, pixel pair) words into the staged (channel, pixel) tile
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int co = mt * 16 + g8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int px = r * kWt + cb + 8 * nt + 2 * c4;
        const float* d = acc[mt][nt];
        const float b0 = bias_s[co], b1 = bias_s[co + 8];
        out_w[(co * kOutRow + px) >> 1] = relu_pack(d[0] + b0, d[1] + b0);
        out_w[((co + 8) * kOutRow + px) >> 1] = relu_pack(d[2] + b1, d[3] + b1);
      }
    }
    __syncthreads();

    // 16-byte runs along W: 8 a (channel, row), 32 a channel, 8 a thread
    const Tile tl = tile_at(g, tile);
    const long long frame_out = (static_cast<long long>(tl.b) * kCo * g.T + tl.t) * plane_out;
#pragma unroll
    for (int i = 0; i < kCo * kRt * kWt / 8 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int seg = id & 7, rr = (id >> 3) & 3, co = id >> 5;
      const int ho = tl.ho0 + rr, wo = tl.wo0 + 8 * seg;
      if (ho >= g.Ho || wo >= g.Wo) continue;
      const bf16* src = out_s + co * kOutRow + rr * kWt + 8 * seg;
      bf16* dst = out + frame_out + co * g.T * plane_out + static_cast<long long>(ho) * g.Wo + wo;
      if constexpr (kVecOut) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const int n = g.Wo - wo < 8 ? g.Wo - wo : 8;
        for (int e = 0; e < n; ++e) dst[e] = src[e];
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends
}

template <bool kVecIn, bool kVecOut>
int launch(const bf16* x, const bf16* w, const bf16* bias, bf16* out, const Geo& g,
           cudaStream_t stream) {
  auto kernel = stemconv_bf16_kernel<kVecIn, kVecOut>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
  if (e != cudaSuccess) return int(e);
  const int grid = g.tiles < sms * (per_sm > 0 ? per_sm : 1) ? g.tiles
                                                            : sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<grid, kThreads, kSmem, stream>>>(x, w, bias, out, g);
  return int(cudaGetLastError());
}

}  // namespace

// out (B, 64, T, Ho, Wo) contiguous = relu(conv3d(x, w, bias)) with stride
// (1, 2, 2) and padding (0, 3, 3); x (B, 3, T, H, W) with strides sb, sc, st
// (elements) of B, C and T and its H and W contiguous; w (64, 3, 1, 7, 7)
// contiguous; bias (64,) or null. All bf16. Returns 0 or a cudaError.
extern "C" int stemconv_bf16(const void* x, const void* w, const void* bias, void* out, int B,
                             int T, int H, int W, int Ho, int Wo, long long sb, long long sc,
                             long long st, void* stream) {
  Geo g{};
  g.B = B, g.T = T, g.H = H, g.W = W, g.Ho = Ho, g.Wo = Wo, g.sb = sb, g.sc = sc, g.st = st;
  g.tiles_w = (Wo + kWt - 1) / kWt;
  g.tiles_h = (Ho + kRt - 1) / kRt;
  g.tiles = B * T * g.tiles_w * g.tiles_h;
  const bool vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 8 == 0 && sb % 8 == 0 &&
                      sc % 8 == 0 && st % 8 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && Wo % 8 == 0;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(bias);
  auto* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_in && vec_out) return launch<true, true>(xb, wb, bb, ob, g, s);
  if (vec_in) return launch<true, false>(xb, wb, bb, ob, g, s);
  if (vec_out) return launch<false, true>(xb, wb, bb, ob, g, s);
  return launch<false, false>(xb, wb, bb, ob, g, s);
}
