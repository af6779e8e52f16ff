// Saliency head for Hopper (sm_90a): conv6 + ReLU + conv7 + sigmoid, in two
// input modes of one templated kernel.
//
// Replaces the TPU kernel vinet_tpu/ops/pallas_head.py::saliency_head_pallas
// (kernel body _head_kernel), and in its fused mode the JAX package's
// phase-folded head (vinet_tpu/models/decoder.py::Decoder._phase_tail with
// vinet_tpu/ops/phasefold.py::up_stencil). For every output pixel (b, y, x):
//
//   out[b,y,x] = sigmoid(b7 + sum_d w7[d] * relu(g[d](b,y,x)))
//   g[d] = b6[d] + sum_{t,c} z[b,c,t,y,x] * w6[d,c,t]            (conv6)
//
// * full-resolution mode (saliency_head_{bf16,f32}): z (B, 32, kt, H, W) is
//   the decoder's relu(conv5) already upsampled; out (B, H, W).
// * fused mode (saliency_head_up2x_{bf16,f32}): z5 (B, 32, kt, h, w) is
//   relu(conv5) at the coarse grid, and z = upsample2x_hw(z5) is never
//   formed; out (B, 2h, 2w). conv6 is spatially 1x1 and linear and the 2x
//   bilinear upsample (half-pixel centres, edge clamp) is linear per channel
//   with taps that sum to 1, so conv6(up(z5)) + b6 == up(conv6(z5) + b6):
//   the kernel computes g at the coarse grid and interpolates g. Each fine
//   pixel takes its four coarse neighbours with weights (9, 3, 3, 1) / 16 by
//   phase; clamping the neighbour indices at the border is the upsample's
//   edge rule.
//
// z is NCDHW contiguous in bf16 or f32; w6 is conv6's (32, 32, kt) weight,
// b6 its optional bias, w7 conv7's (32,) weight and b7 its bias, all f32;
// out is f32. Accumulation is f32 throughout.
//
// Bound on the card (H100 SXM data sheet), at the clip-32 main path's shape:
// fused, z5 (16, 32, 2, 112, 192) bf16 in (44.0 MB) and 5.5 MB of maps out,
// 14.8 us at 3.35 TB/s; full resolution, z (16, 32, 2, 224, 384) bf16 (176.2
// MB) and the same maps, 54 us. Both are bound by bytes once conv6 leaves the
// CUDA cores: its 2 x 64 x 32 FLOP a pixel in f32 FMAs took the earlier
// one-thread-a-pixel kernel 85 us at 67 TFLOP/s, over the byte bound.
//
// Design. A block of 8 warps owns a tile of 8 x 32 pixels of the input grid
// and, in the fused mode, a 1-pixel halo around it (10 x 34 pixels).
// * Staging: the tile's rows of z stream through a 3-slot ring in shared
//   memory, one slot per 16 channels of one time tap (one k16 slice of
//   conv6), filled with 16-byte cp.async copies two slots ahead of the
//   products. A fused tile row holds one 16-byte chunk more on each side,
//   so that the halo columns x0 - 1 and x0 + 32 arrive in aligned chunks;
//   halo rows are clamped at the border when they are loaded, halo columns
//   when they are read. Chunks outside the image are zero-filled. Rows whose
//   width is not a multiple of a 16-byte chunk take a variant that loads
//   element by element into the same layout.
// * conv6 as a GEMM per tile: M = 32 output channels, N = the tile's pixels
//   (340 with the halo, 256 without), K = 32 kt. bf16 input runs on the
//   tensor cores, mma.sync m16n8k16 with f32 accumulators: conv6's f32
//   weights are the A operand, split into bf16 hi = bf16(w) and lo =
//   bf16(w - hi), two products each, so the weights keep 16 of f32's 24
//   bits (a relative error of at most 2^-16 a weight), and none is rounded
//   to bf16 silently. The A fragments of every slice are built once a block
//   in shared memory; each thread gathers its B fragment (two channels a
//   register, one pixel) with 16-bit loads, because the NCDHW planes put a
//   pixel's channels a plane apart. The plane stride is 16 mod 64 bytes, so
//   the four channel pairs of one gather fall in different banks. f32 input
//   runs the same fragment layout on the CUDA cores (TF32 would keep only
//   10 bits of z).
// * g = conv6 + b6 goes to shared memory as f32, over the spent ring. Full
//   resolution: each thread takes one pixel, dots relu(g) with w7 and stores
//   the sigmoid. Fused: each thread takes one coarse column of two coarse
//   rows (eight fine pixels) for 16 of the 32 channels, reads the 4 x 3
//   neighbourhood of g once a channel, interpolates rows then columns,
//   applies the ReLU and the dot with w7; the two channel halves are summed
//   in shared memory. Stores are float2 along W, a warp writing 256
//   contiguous bytes a fine row.
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.
//
// Measured on an H100 (PERF.md): the fused mode takes about 4.6 times its
// byte bound, and memory is not what holds it back: it is bound by issuing
// instructions (address arithmetic of the copies, B-fragment gathers, 16
// channels of interpolation a thread) with little latency hidden, as 122
// registers a thread leave room for 2 blocks (16 warps) an SM and each tile
// passes 6 barriers. Persistent blocks that prefetch the next tile across
// its epilogue were no faster. What would be: fewer instructions a fine
// pixel, and more warps an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;          // conv5 / conv6 channels
constexpr int kThreads = 256;   // 8 warps
constexpr int kTH = 8;          // tile rows (input grid)
constexpr int kTW = 32;         // tile columns: one warp lane each
constexpr int kKC = 16;         // channels a ring slot: one k16 slice
constexpr int kStages = 3;      // ring slots
constexpr int kSplits = 2;      // bf16 terms of each f32 weight (hi, lo)

// Tile geometry of element type T (uint16_t: bf16 bits; float) and mode.
template <typename T, bool kUp>
struct Geo {
  static constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  static constexpr int kHalo = kUp ? 1 : 0;
  static constexpr int kPadC = kUp ? kE : 0;       // staged columns left of x0
  static constexpr int kRows = kTH + 2 * kHalo;    // staged rows
  static constexpr int kCols = kTW + 2 * kPadC;    // staged columns
  static constexpr int kChunks = kCols / kE;
  static constexpr int kHC = kTW + 2 * kHalo;      // conv6 pixel columns
  static constexpr int kNP = kRows * kHC;          // conv6 pixels: GEMM N
  static constexpr int kNT = (kNP + 7) / 8;        // n8 tiles
  static constexpr int kNTW = (kNT + 7) / 8;       // n8 tiles a warp, at most
  // bytes of one channel plane of a slot: 16-byte aligned, 16 mod 64
  static constexpr int kPlane =
      (kRows * kCols * static_cast<int>(sizeof(T)) + 63) / 64 * 64 + 16;
  static constexpr int kPE = kPlane / static_cast<int>(sizeof(T));
  static constexpr int kSlot = kKC * kPlane;
  // floats between g's channel planes: >= kNP and 8 mod 32 (conflict-free
  // float2 stores from the accumulator fragments)
  static constexpr int kGStride = (kNP - 8 + 31) / 32 * 32 + 8;
  static constexpr int kRing = kStages * kSlot;
  static constexpr int kG = kC * kGStride * 4;
  static constexpr int kUnion = kRing > kG ? kRing : kG;  // ring, then g
  static constexpr int kRed = kUp ? 8 * 4 * 32 * 4 : 0;   // channel-half sums
  // weight bytes a slot: bf16 A fragments (splits x 2 m16 tiles x 32 lanes
  // x 16 bytes), or f32 weights (16 k x 32 d)
  static constexpr int kWSlot = sizeof(T) == 2 ? kSplits * 2 * 32 * 16 : kKC * kC * 4;
  static_assert(kNP % 2 == 0 && kCols % kE == 0, "tile");
};

template <typename T, bool kUp>
size_t smem_bytes(int kt) {
  using G = Geo<T, kUp>;
  return static_cast<size_t>(2 * kt) * G::kWSlot + 2 * kC * 4 + G::kUnion + G::kRed;
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 term `sp` of w: 0 -> bf16(w), 1 -> bf16(w - bf16(w)); as bits
__device__ __forceinline__ uint32_t split_bits(float w, int sp) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(w);
  const __nv_bfloat16 term = sp == 0 ? hi : __float2bfloat16_rn(w - __bfloat162float(hi));
  return __bfloat16_as_ushort(term);
}

__device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + expf(-y)); }

template <typename T, bool kUp, bool kAsync>
__global__ void __launch_bounds__(kThreads, 2)
saliency_head_kernel(const T* __restrict__ z, const float* __restrict__ w6,
                     const float* __restrict__ b6, const float* __restrict__ w7,
                     const float* __restrict__ b7, float* __restrict__ out, int kt, int h,
                     int w) {
  using G = Geo<T, kUp>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];

  const int slices = 2 * kt;  // K = 32 kt in k16 slices, one ring slot each
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group, column pair
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, b = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const T* zb = z + static_cast<int64_t>(b) * kC * kt * hw;

  unsigned char* wreg = smem;  // weights: A fragments (bf16) or ws[k][d] (f32)
  float* b6s = reinterpret_cast<float*>(smem + slices * G::kWSlot);
  float* w7s = b6s + kC;
  unsigned char* ring = reinterpret_cast<unsigned char*>(w7s + kC);
  float* gs = reinterpret_cast<float*>(ring);  // g[d][pixel], after the ring is spent
  float* red = reinterpret_cast<float*>(ring + G::kUnion);

  // Stage slice s (time tap s / 2, channels 16 (s % 2) ..) into its slot.
  auto load_slice = [&](int s) {
    unsigned char* slot = ring + (s % kStages) * G::kSlot;
    const int t = s >> 1, c0 = (s & 1) * kKC;
    constexpr int kUnits = kKC * G::kRows * G::kChunks;
    for (int i = tid; i < kUnits; i += kThreads) {
      const int ch = i % G::kChunks;
      const int r = (i / G::kChunks) % G::kRows;
      const int cc = i / (G::kChunks * G::kRows);
      int gy = y0 - G::kHalo + r;
      bool row_ok = gy < h;
      if constexpr (kUp) {
        gy = min(max(gy, 0), h - 1);
        row_ok = true;
      }
      const int gx = x0 - G::kPadC + ch * G::kE;
      unsigned char* dst = slot + cc * G::kPlane + (r * G::kCols + ch * G::kE) * sizeof(T);
      const T* row = zb + (static_cast<int64_t>(c0 + cc) * kt + t) * hw +
                     static_cast<int64_t>(gy) * w;
      if constexpr (kAsync) {  // w % kE == 0: a chunk is wholly in or out
        const bool ok = row_ok && gx >= 0 && gx < w;
        cp_async16(smem_addr(dst), ok ? row + gx : z, ok);
      } else {
        alignas(16) T v[G::kE];
#pragma unroll
        for (int e = 0; e < G::kE; ++e) {
          const int x = gx + e;
          v[e] = row_ok && x >= 0 && x < w ? row[x] : T(0);
        }
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  // Weights, once a block.
  if constexpr (kBf16) {
    // A fragment i = ((sp * slices + s) * 2 + mt) * 32 + lane of the
    // m16n8k16 row-major operand: registers (row, k) = (g, 2tq), (g + 8,
    // 2tq), (g, 2tq + 8), (g + 8, 2tq + 8), two k a register, low k low.
    uint4* afr = reinterpret_cast<uint4*>(wreg);
    const int n = kSplits * slices * 2 * 32;
    for (int i = tid; i < n; i += kThreads) {
      const int fl = i & 31, mt = (i >> 5) & 1, s = (i >> 6) % slices, sp = (i >> 6) / slices;
      const int t = s >> 1, c0 = (s & 1) * kKC;
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = mt * 16 + (fl >> 2) + (q & 1) * 8;
        const int c = c0 + 2 * (fl & 3) + (q >> 1) * 8;
        r[q] = split_bits(w6[(d * kC + c) * kt + t], sp) |
               split_bits(w6[(d * kC + c + 1) * kt + t], sp) << 16;
      }
      afr[i] = make_uint4(r[0], r[1], r[2], r[3]);
    }
  } else {
    float* ws = reinterpret_cast<float*>(wreg);  // ws[t * 32 + c][d]
    for (int i = tid; i < kC * kC * kt; i += kThreads) {  // w6 (d, c, t)
      const int t = i % kt, c = (i / kt) % kC, d = i / (kt * kC);
      ws[(t * kC + c) * kC + d] = w6[i];
    }
  }
  if (tid < kC) {
    b6s[tid] = b6 != nullptr ? b6[tid] : 0.f;
    w7s[tid] = w7[tid];
  }

  // Element offset in a channel plane of conv6 pixel p (clamped to the
  // tile's pixels): halo columns clamp at the image border here.
  auto pixel_offset = [&](int p) {
    p = min(p, G::kNP - 1);
    const int r = p / G::kHC, hx = p % G::kHC;
    int col = hx;
    if constexpr (kUp) col = min(max(x0 - 1 + hx, 0), w - 1) - (x0 - G::kPadC);
    return r * G::kCols + col;
  };

  // n8 tile i of this warp is warp + 8 i. bf16 gathers pixel 8 nt + g (B
  // fragment); f32 computes the accumulator fragment's pixels 8 nt + 2 tq,
  // + 1 directly.
  constexpr int kOffs = kBf16 ? 1 : 2;
  int off[G::kNTW][kOffs];
#pragma unroll
  for (int i = 0; i < G::kNTW; ++i) {
    const int p = (warp + 8 * i) * 8;
#pragma unroll
    for (int j = 0; j < kOffs; ++j) off[i][j] = pixel_offset(kBf16 ? p + g : p + 2 * tq + j);
  }

  float acc[G::kNTW][2][4];
#pragma unroll
  for (int i = 0; i < G::kNTW; ++i)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][mt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load_slice(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();               // ... everyone's; the slot of s - 1 is free
    if (s + kStages - 1 < slices) load_slice(s + kStages - 1);
    cp_async_commit();

    const T* zs = reinterpret_cast<const T*>(ring + (s % kStages) * G::kSlot);
    if constexpr (kBf16) {
      const uint4* afr = reinterpret_cast<const uint4*>(wreg);
      uint32_t a[kSplits][2][4];
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint4 v = afr[((sp * slices + s) * 2 + mt) * 32 + lane];
          a[sp][mt][0] = v.x;
          a[sp][mt][1] = v.y;
          a[sp][mt][2] = v.z;
          a[sp][mt][3] = v.w;
        }
#pragma unroll
      for (int i = 0; i < G::kNTW; ++i) {
        if (warp + 8 * i < G::kNT) {
          const T* p = zs + off[i][0];
          const uint32_t b0 = p[(2 * tq) * G::kPE] | uint32_t(p[(2 * tq + 1) * G::kPE]) << 16;
          const uint32_t b1 =
              p[(2 * tq + 8) * G::kPE] | uint32_t(p[(2 * tq + 9) * G::kPE]) << 16;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int sp = 0; sp < kSplits; ++sp) mma_bf16(acc[i][mt], a[sp][mt], b0, b1);
        }
      }
    } else {
      const float* ws = reinterpret_cast<const float*>(wreg) + s * kKC * kC;
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        const float* wr = ws + kk * kC;
        const float wd[4] = {wr[g], wr[g + 8], wr[g + 16], wr[g + 24]};
#pragma unroll
        for (int i = 0; i < G::kNTW; ++i) {
          if (warp + 8 * i < G::kNT) {
            const float z0 = zs[kk * G::kPE + off[i][0]], z1 = zs[kk * G::kPE + off[i][1]];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              acc[i][mt][0] = fmaf(wd[2 * mt], z0, acc[i][mt][0]);
              acc[i][mt][1] = fmaf(wd[2 * mt], z1, acc[i][mt][1]);
              acc[i][mt][2] = fmaf(wd[2 * mt + 1], z0, acc[i][mt][2]);
              acc[i][mt][3] = fmaf(wd[2 * mt + 1], z1, acc[i][mt][3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: g may overwrite it

  // g = conv6 + b6 to shared memory: fragment (i, mt) holds channels
  // 16 mt + g (+ 8) at pixels 8 nt + 2 tq (+ 1).
#pragma unroll
  for (int i = 0; i < G::kNTW; ++i) {
    const int p = (warp + 8 * i) * 8 + 2 * tq;
    if (warp + 8 * i < G::kNT && p < G::kNP) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = mt * 16 + g + 8 * hh;
          *reinterpret_cast<float2*>(gs + d * G::kGStride + p) =
              make_float2(acc[i][mt][2 * hh] + b6s[d], acc[i][mt][2 * hh + 1] + b6s[d]);
        }
    }
  }
  __syncthreads();

  const int x = x0 + lane;
  if constexpr (kUp) {
    // warp: coarse rows 2 rp, 2 rp + 1 of the tile, channels 16 dh .. + 15
    const int rp = warp & 3, dh = warp >> 2;
    float y[2][4];  // [coarse row][fine (0,0), (0,1), (1,0), (1,1)]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) y[i][q] = 0.f;
    const float* base = gs + 2 * rp * G::kHC + lane;  // halo (row 2 rp, column lane)
#pragma unroll 2
    for (int d = 16 * dh; d < 16 * dh + 16; ++d) {
      const float* q = base + d * G::kGStride;
      float v[4][3];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[r][j] = q[r * G::kHC + j];
      const float wd = w7s[d];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float top[3], bot[3];  // fine rows 2y and 2y + 1, at coarse columns x - 1 .. x + 1
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          top[j] = 0.25f * v[i][j] + 0.75f * v[i + 1][j];
          bot[j] = 0.75f * v[i + 1][j] + 0.25f * v[i + 2][j];
        }
        y[i][0] = fmaf(wd, fmaxf(0.25f * top[0] + 0.75f * top[1], 0.f), y[i][0]);
        y[i][1] = fmaf(wd, fmaxf(0.75f * top[1] + 0.25f * top[2], 0.f), y[i][1]);
        y[i][2] = fmaf(wd, fmaxf(0.25f * bot[0] + 0.75f * bot[1], 0.f), y[i][2]);
        y[i][3] = fmaf(wd, fmaxf(0.75f * bot[1] + 0.25f * bot[2], 0.f), y[i][3]);
      }
    }
    float* rd = red + rp * 32 + lane;  // red[k][rp][lane]
    if (dh == 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) rd[k * 128] = y[k >> 2][k & 3];
    }
    __syncthreads();
    if (dh == 0 && x < w) {
      const float bias = b7[0];
      const int fw = 2 * w;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int cy = y0 + 2 * rp + i;
        if (cy < h) {
          float* o = out + static_cast<int64_t>(b) * 4 * hw +
                     static_cast<int64_t>(2 * cy) * fw + 2 * x;
          float f[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) f[q] = sigmoid(y[i][q] + rd[(4 * i + q) * 128] + bias);
          *reinterpret_cast<float2*>(o) = make_float2(f[0], f[1]);
          *reinterpret_cast<float2*>(o + fw) = make_float2(f[2], f[3]);
        }
      }
    }
  } else {
    const int cy = y0 + warp;
    const float* q = gs + warp * kTW + lane;
    float y = b7[0];
#pragma unroll 8
    for (int d = 0; d < kC; ++d) y = fmaf(w7s[d], fmaxf(q[d * G::kGStride], 0.f), y);
    if (cy < h && x < w) out[static_cast<int64_t>(b) * hw + static_cast<int64_t>(cy) * w + x] =
        sigmoid(y);
  }
}

template <typename T, bool kUp, bool kAsync>
int launch_variant(const void* z, const void* w6, const void* b6, const void* w7,
                   const void* b7, void* out, int batch, int kt, int h, int w,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, kUp>(kt);
  const cudaError_t err =
      cudaFuncSetAttribute(saliency_head_kernel<T, kUp, kAsync>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((w + kTW - 1) / kTW),
                  static_cast<unsigned>((h + kTH - 1) / kTH), static_cast<unsigned>(batch));
  saliency_head_kernel<T, kUp, kAsync><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const float*>(w6), static_cast<const float*>(b6),
      static_cast<const float*>(w7), static_cast<const float*>(b7), static_cast<float*>(out),
      kt, h, w);
  return static_cast<int>(cudaGetLastError());
}

// The cp.async variant when every row of z starts 16-byte aligned, else the
// element-load one.
template <typename T, bool kUp>
int launch(const void* z, const void* w6, const void* b6, const void* w7, const void* b7,
           void* out, int batch, int kt, int h, int w, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = w % Geo<T, kUp>::kE == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  return aligned ? launch_variant<T, kUp, true>(z, w6, b6, w7, b7, out, batch, kt, h, w, s)
                 : launch_variant<T, kUp, false>(z, w6, b6, w7, b7, out, batch, kt, h, w, s);
}

}  // namespace

// Plain C entries, loaded with ctypes. Each returns the first CUDA error of
// the shared-memory attribute or the launch (0 on success). b6 may be null.
// (h, w) is z's grid: the output is (batch, h, w), or (batch, 2h, 2w) for
// the fused entries.
extern "C" int saliency_head_bf16(const void* z, const void* w6, const void* b6,
                                  const void* w7, const void* b7, void* out, int batch, int kt,
                                  int h, int w, void* stream) {
  return launch<uint16_t, false>(z, w6, b6, w7, b7, out, batch, kt, h, w, stream);
}

extern "C" int saliency_head_f32(const void* z, const void* w6, const void* b6,
                                 const void* w7, const void* b7, void* out, int batch, int kt,
                                 int h, int w, void* stream) {
  return launch<float, false>(z, w6, b6, w7, b7, out, batch, kt, h, w, stream);
}

extern "C" int saliency_head_up2x_bf16(const void* z, const void* w6, const void* b6,
                                       const void* w7, const void* b7, void* out, int batch,
                                       int kt, int h, int w, void* stream) {
  return launch<uint16_t, true>(z, w6, b6, w7, b7, out, batch, kt, h, w, stream);
}

extern "C" int saliency_head_up2x_f32(const void* z, const void* w6, const void* b6,
                                      const void* w7, const void* b7, void* out, int batch,
                                      int kt, int h, int w, void* stream) {
  return launch<float, true>(z, w6, b6, w7, b7, out, batch, kt, h, w, stream);
}
