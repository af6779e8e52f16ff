// ReLU and the decoder's 2x spatial upsample for Hopper (sm_90a):
// F.interpolate(relu(x), scale_factor=(1, 2, 2), mode="trilinear",
// align_corners=False) for x (B, C, T, H, W) in bf16 or f32, whose (b, c, t)
// planes are contiguous in H x W; out (B, C, T, 2H, 2W) contiguous, in x's
// dtype.
//
// Semantics, as PyTorch's kernel computes them. Time is untouched. Along H
// and along W an output takes two inputs with half-pixel centres, clamped at
// the edges: output 2i = 0.25 x[i - 1] + 0.75 x[i] (i >= 1), output 0 =
// x[0], output 2i + 1 = 0.75 x[i] + 0.25 x[min(i + 1, n - 1)]. An output is
// h0 (w0 a + w1 b) + h1 (w0 c + w1 d) in f32, in that order, rounded once to
// x's dtype. The ReLU is applied as each input is staged and keeps a NaN, as
// torch.relu does (fmaxf would drop it). Where an input is NaN or infinite
// there is one difference: PyTorch's upsample_trilinear3d also adds terms of
// weight 0 (the next time slice, or the slice itself at the last; x[1] at
// output 0), which turn an infinity into NaN and carry a NaN into the slice
// before. Here an output reads only the inputs it weighs: a NaN reaches the
// outputs that weigh it, and an infinity stays infinite.
//
// Replaces no TPU kernel: the JAX package leaves the upsample to XLA
// (vinet_tpu/ops/upsample.py). It was added because PyTorch's CUDA kernel
// starts one thread per output (t, h, w) position and loops over every (b, c)
// plane in it: at the decoder's shapes (hundreds of channels, planes of 7 x
// 12 to 28 x 48) that is 1 344 to 21 504 threads where the card holds about
// 270 000, and it ran at under 1 % of the byte bound, the costliest device op
// of a parity window batch and of a live AV decode (PERF.md).
//
// Bound on the card: bytes. Each input is read once and each output, four
// times as many, written once; a few operations an output. The three stage
// upsamples of a parity window batch (16 windows at 224 x 384, bf16) move
// 313 MB, 0.093 ms at 3.35 TB/s.
//
// Design: a stencil over a flat run of planes. A block takes one unit: a run
// of whole planes (about kStageBytes of input), or, where one plane is larger
// than that, a band of rows of one plane with a row above and below. It
// stages the unit's input, ReLU applied, in shared memory by 16-byte loads
// (8, 4 or 2 where x's alignment or its strides allow no more); where the
// planes follow each other in x (the decoder's conv outputs) the run is one
// contiguous range, else one range a plane, at any B, C and T strides. Then
// its outputs, one contiguous range of out, leave in 16-byte stores: a
// thread computes E outputs of one output row from 2 x (E / 2 + 2) staged
// inputs. Units are small enough that every main-path shape gives the card
// several blocks an SM, so one block's staging overlaps another's stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 8192;  // input a unit stages, aimed at
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may have
constexpr int kBlocksPerSm = 8;    // 2048 threads an SM / kThreads: units for a full round

struct Geo {
  int C, T, H, W;
  long long sb, sc, st;  // x's B, C and T strides, in elements
  int planes;            // B x C x T
  int np;                // planes a unit; 0: bands of rows of one plane
  int band_rows, bands;  // band units: input rows a band, bands a plane
  int flat;              // plane p starts at p H W: a unit's planes are one range of x
  int vec;               // elements a staging load
};

// A unit: planes [p0, p0 + nplanes), of each the input rows [lo, lo + rows)
// staged and the output rows [oy0, oy0 + rows_out) written, from out0 on.
struct Unit {
  int p0, nplanes, lo, rows, oy0, rows_out;
  long long out0;
};

template <typename R> struct Val;
template <> struct Val<float> {
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float f) { return f; }
  static __device__ __forceinline__ float relu(float v) { return v > 0.f || isnan(v) ? v : 0.f; }
};
template <> struct Val<uint16_t> {  // bf16 bits
  static __device__ __forceinline__ float widen(uint16_t v) {
    return __uint_as_float(uint32_t(v) << 16);
  }
  static __device__ __forceinline__ uint16_t narrow(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));  // nearest even; a NaN stays NaN
  }
  static __device__ __forceinline__ uint16_t relu(uint16_t v) {  // negative and not NaN: +0
    return (v & 0x8000u) && (v & 0x7fffu) <= 0x7f80u ? uint16_t(0) : v;
  }
};

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };

template <typename R, int BYTES>
__device__ __forceinline__ void copy_relu(const R* __restrict__ src, R* dst) {
  using V = typename VecOf<BYTES>::type;
  union {
    V v;
    R e[BYTES / sizeof(R)];
  } u;
  u.v = __ldg(reinterpret_cast<const V*>(src));
#pragma unroll
  for (int i = 0; i < int(BYTES / sizeof(R)); ++i) u.e[i] = Val<R>::relu(u.e[i]);
  *reinterpret_cast<V*>(dst) = u.v;
}

template <typename R>
__device__ __forceinline__ void copy_relu_vec(const R* __restrict__ src, R* dst, int bytes) {
  if (bytes == 16)
    copy_relu<R, 16>(src, dst);
  else if (bytes == 8)
    copy_relu<R, 8>(src, dst);
  else if (bytes == 4)
    copy_relu<R, 4>(src, dst);
  else
    *dst = Val<R>::relu(__ldg(src));
}

__device__ __forceinline__ long long plane_offset(const Geo& g, int p) {
  const int t = p % g.T, bc = p / g.T;
  return (bc / g.C) * g.sb + (bc % g.C) * g.sc + t * g.st;
}

__device__ __forceinline__ Unit unit_of(const Geo& g, int u) {
  Unit n;
  if (g.np) {
    n.p0 = u * g.np;
    n.nplanes = min(g.np, g.planes - n.p0);
    n.lo = 0, n.rows = g.H, n.oy0 = 0, n.rows_out = 2 * g.H;
  } else {
    n.p0 = u / g.bands;
    const int r0 = (u % g.bands) * g.band_rows, r1 = min(g.H, r0 + g.band_rows);
    n.nplanes = 1;
    n.lo = max(r0 - 1, 0);
    n.rows = min(r1 + 1, g.H) - n.lo;
    n.oy0 = 2 * r0, n.rows_out = 2 * (r1 - r0);
  }
  n.out0 = (long long)n.p0 * 4 * g.H * g.W + (long long)n.oy0 * 2 * g.W;
  return n;
}

// The unit's input rows, ReLU applied, to s: plane i's rows at i x rows x W.
template <typename R>
__device__ __forceinline__ void stage(const Geo& g, const Unit& n, const R* __restrict__ x,
                                      R* s) {
  const int bytes = g.vec * int(sizeof(R));
  const long long row0 = (long long)n.lo * g.W;
  if (g.flat || n.nplanes == 1) {  // one range of x
    const int len = n.nplanes * n.rows * g.W, vecs = len / g.vec;
    const R* src = x + plane_offset(g, n.p0) + row0;
    for (int k = threadIdx.x; k < vecs; k += blockDim.x)
      copy_relu_vec(src + k * g.vec, s + k * g.vec, bytes);
    for (int k = vecs * g.vec + threadIdx.x; k < len; k += blockDim.x)
      s[k] = Val<R>::relu(__ldg(src + k));
    return;
  }
  const int len = n.rows * g.W, per = len / g.vec;  // the host makes vec divide H W
  for (int k = threadIdx.x; k < n.nplanes * per; k += blockDim.x) {
    const int i = k / per, e = (k - i * per) * g.vec;
    copy_relu_vec(x + plane_offset(g, n.p0 + i) + row0 + e, s + i * len + e, bytes);
  }
}

template <typename R, int E>
struct Pack {
  using V = typename VecOf<E * sizeof(R)>::type;
  union {
    V v;
    R e[E];
  };
};

// The unit's outputs from the staged input: E of one output row a thread and
// step, stored as one vector.
template <typename R, int E>
__device__ __forceinline__ void emit(const Geo& g, const Unit& n, const R* s,
                                     R* __restrict__ out) {
  constexpr int NC = E / 2 + 2;  // input columns c0 - 1 ... c0 + E / 2
  const int wo = 2 * g.W, per_row = wo / E;
  const int chunks = n.nplanes * n.rows_out * per_row;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const int j = k / per_row, ox0 = (k - j * per_row) * E;
    const int i = j / n.rows_out, oy = n.oy0 + (j - i * n.rows_out), iy = oy >> 1;
    const bool top = oy == 0;  // row 0 alone
    int ya, yb;
    float h0, h1;
    if (oy & 1) {
      ya = iy, yb = min(iy + 1, g.H - 1), h0 = 0.75f, h1 = 0.25f;
    } else {
      ya = max(iy - 1, 0), yb = iy, h0 = 0.25f, h1 = 0.75f;
    }
    const R* ra = s + (i * n.rows + ya - n.lo) * g.W;
    const R* rb = s + (i * n.rows + yb - n.lo) * g.W;
    const int c0 = ox0 >> 1;
    float a[NC], b[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = min(max(c0 - 1 + m, 0), g.W - 1);
      a[m] = Val<R>::widen(ra[c]);
      b[m] = Val<R>::widen(rb[c]);
    }
    Pack<R, E> o;
#pragma unroll
    for (int q = 0; q < E / 2; ++q) {
      // outputs 2 (c0 + q) (column 0 alone) and 2 (c0 + q) + 1 of rows a and b
      const bool first = q == 0 && c0 == 0;
      const float ea = first ? a[q + 1] : 0.25f * a[q] + 0.75f * a[q + 1];
      const float eb = first ? b[q + 1] : 0.25f * b[q] + 0.75f * b[q + 1];
      const float oa = 0.75f * a[q + 1] + 0.25f * a[q + 2];
      const float ob = 0.75f * b[q + 1] + 0.25f * b[q + 2];
      o.e[2 * q] = Val<R>::narrow(top ? ea : h0 * ea + h1 * eb);
      o.e[2 * q + 1] = Val<R>::narrow(top ? oa : h0 * oa + h1 * ob);
    }
    *reinterpret_cast<typename Pack<R, E>::V*>(out + n.out0 + (long long)j * wo + ox0) = o.v;
  }
}

template <typename R, int E>
__global__ void __launch_bounds__(kThreads)
    relu_up2x_kernel(const R* __restrict__ x, R* __restrict__ out, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  R* s = reinterpret_cast<R*>(smem);
  const Unit n = unit_of(g, blockIdx.x);
  stage(g, n, x, s);
  __syncthreads();
  emit<R, E>(g, n, s, out);
}

int gcd(long long a, long long b) {
  while (b) {
    const long long r = a % b;
    a = b, b = r;
  }
  return int(a);
}

// The most elements, 16 bytes' worth down to one, that a load may take with
// x at ptr and every offset a multiple of each of offs.
int vec_elems(uintptr_t ptr, int es, std::initializer_list<long long> offs) {
  for (int v = 16 / es; v > 1; v /= 2) {
    bool ok = ptr % (v * es) == 0;
    for (long long o : offs) ok = ok && o % v == 0;
    if (ok) return v;
  }
  return 1;
}

template <typename R, int E>
int start(const R* x, R* out, const Geo& g, int units, size_t smem, cudaStream_t stream) {
  auto kernel = relu_up2x_kernel<R, E>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<units, kThreads, smem, stream>>>(x, out, g);
  return int(cudaGetLastError());
}

template <typename R>
int launch(const R* x, R* out, Geo g, int B, cudaStream_t stream) {
  constexpr int es = sizeof(R);
  const long long hw = (long long)g.H * g.W;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  // strides of dimensions of size 1 are never used
  const long long sb = B > 1 ? g.sb : 0, sc = g.C > 1 ? g.sc : 0, st = g.T > 1 ? g.st : 0;
  g.flat = (g.T == 1 || g.st == hw) && (g.C == 1 || g.sc == g.T * hw) &&
           (B == 1 || g.sb == (long long)g.C * g.T * hw);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (long long)sms * kBlocksPerSm;
  long long units;
  size_t smem;
  if (hw * es <= kStageBytes) {  // runs of whole planes
    int np = int(kStageBytes / (hw * es)), step = 1;
    if (g.flat) {  // a unit starts at p0 H W: np H W a multiple of vec
      g.vec = vec_elems(xp, es, {});
      step = g.vec / gcd(hw, g.vec);
    } else {
      g.vec = vec_elems(xp, es, {hw, sb, sc, st});
    }
    np = max(step, np / step * step);
    while (np > step && (g.planes + np - 1) / np < want)  // too few units to fill the card
      np = max(step, np / 2 / step * step);
    g.np = np;
    units = (g.planes + np - 1) / np;
    smem = size_t(np) * hw * es;
  } else {  // bands of rows of one plane, a row of halo on each side
    g.np = 0;
    g.band_rows = max(1, int(kStageBytes / ((long long)g.W * es)) - 2);
    g.bands = (g.H + g.band_rows - 1) / g.band_rows;
    g.band_rows = (g.H + g.bands - 1) / g.bands;
    g.vec = vec_elems(xp, es, {g.W, sb, sc, st});
    units = (long long)g.planes * g.bands;
    smem = size_t(min(g.band_rows + 2, g.H)) * g.W * es;
  }
  if (smem > kMaxSmem || units >= (1LL << 31)) return -1;
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const int wo = 2 * g.W;
  const int u = int(units);
  if (es == 2 && wo % 8 == 0 && op % 16 == 0) return start<R, 16 / es>(x, out, g, u, smem, stream);
  if (wo % 4 == 0 && op % (4 * es) == 0) return start<R, 4>(x, out, g, u, smem, stream);
  return start<R, 2>(x, out, g, u, smem, stream);
}

}  // namespace

// out (B, C, T, 2H, 2W) contiguous = the upsample of relu(x), x (B, C, T, H,
// W) with H and W contiguous and B, C, T strides sb, sc, st (elements);
// dtype 0 bf16, 1 f32. Returns 0, a cudaError, or -1 when no unit fits
// shared memory.
extern "C" int relu_up2x(const void* x, void* out, int dtype, int B, int C, int T, int H, int W,
                         long long sb, long long sc, long long st, void* stream) {
  Geo g{};
  g.C = C, g.T = T, g.H = H, g.W = W, g.sb = sb, g.sc = sc, g.st = st;
  g.planes = B * C * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), g, B, s);
  return launch(static_cast<const float*>(x), static_cast<float*>(out), g, B, s);
}
