// Max pooling over (T, H, W) for Hopper (sm_90a), without indices: exactly
// F.max_pool3d(x, kernel, stride, padding) with dilation 1 and floor-mode
// output sizes, in bf16 or f32, on a contiguous NCDHW x.
//
// Replaces no TPU kernel: the JAX package leaves pooling to XLA's
// reduce_window (vinet_tpu/ops/conv.py::maxpool3d). It was added because
// PyTorch has no index-free 3-D max pool on CUDA: F.max_pool3d runs
// max_pool3d_with_indices, which writes an int64 index beside every output
// that inference never reads, and moved S3D's fourteen pools at about 13 %
// of the card's bandwidth, a fifth of a parity window batch (PERF.md).
//
// Semantics, as PyTorch's kernel: padding never wins (it is -inf), and the
// window is scanned in (t, h, w) order with `x > m || isnan(x)` replacing
// the running max m, from -inf. A scan over a sequence splits exactly into
// scans over its consecutive parts, each started at -inf, then combined in
// order by the same rule. So the max over W of each row, then over those of
// a plane's rows, then over those of the slices gives PyTorch's result bit
// for bit: the first of tied values (the sign of a zero), the last NaN.
//
// Bound on the card: bytes. A pool reads its input once and writes its
// output once, about one comparison a byte: the fourteen pools of a parity
// window batch (B 16, 32 x 224 x 384, bf16) move 3.16 GB, 0.94 ms at 3.35
// TB/s. Two kernels; the host picks by what the call can see:
//
// - maxpool3d_rows (bf16, W a multiple of 4, the windows of the port's
//   pools: every pool of the main paths). A thread owns 8 outputs along W of
//   R output rows of one plane and walks the output time positions, so each
//   input slice is loaded once a thread and kept, reduced, in a register
//   ring of k_t slices. Its rows come straight from device memory in 16-byte
//   loads (8-byte where W is not a multiple of 8); a row that the windows of
//   neighbouring threads share is served again from L1. The max is taken two
//   outputs at a time on packed bf16 pairs (set.gt and set.nan masks, one
//   select): over W, then over the rows, then over the ring's slices. No
//   shared memory and no barrier: the warps of an SM, as many as the
//   registers allow (MINB), hide each other's loads. At parity's shapes it
//   runs the fourteen pools at about 60 % of the bound (PERF.md).
// - maxpool3d_kernel (f32, and any other shape or window). A tile is np
//   planes x th output rows x all of W, over a run of output time positions.
//   Its input is staged one time slice at a time in shared memory (np x rows
//   input rows, -inf columns for the spatial padding written once per block,
//   -inf rows beyond H) by cp.async copies of 16, 8 or 4 bytes, two slices
//   ahead of the one in use; each thread then takes a column of a plane's
//   output rows (the max over W of each row it needs, then over the rows),
//   the results go to a ring of k_t slices in shared memory, and
//   each output leaves as the max over its ring slices in 16-byte runs where
//   W_out allows. Blocks are persistent, walking tiles blockIdx.x, +
//   gridDim.x, ..., so a block's next tile is in flight while it finishes
//   the one before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;  // staged slices: one in use, two in flight
constexpr int kStageBytes = 8192;  // the size aimed at for a tile's staged input slice
constexpr int kTilesPerBlock = 2;  // tiles cut finer until a resident block gets this many
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may have

struct Geo {
  int planes, T, H, W, To, Ho, Wo;
  int kt, kh, kw, st, sh, sw, pt, ph, pw;
  int np, th, tc;          // planes, output rows and output time positions a tile
  int rows, pitch, left;   // staged rows a plane, elements a staged row, column of w = 0
  int bands, chunks, groups;
  int copy_bytes;          // 16, 8 or 4: cp.async size; 0: element loads
  int store_elems;         // output elements a store
  int strips, strip_len;   // a tile's output rows split among threads
  int stage_elems, slot_elems;
};

template <typename R> struct Raw;
template <> struct Raw<float> {
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float f) { return f; }
};
template <> struct Raw<uint16_t> {  // bf16 bits: widening and narrowing are exact
  static __device__ __forceinline__ float widen(uint16_t v) {
    return __uint_as_float(uint32_t(v) << 16);
  }
  static __device__ __forceinline__ uint16_t narrow(float f) {
    return uint16_t(__float_as_uint(f) >> 16);
  }
};

// PyTorch's rule: x replaces the running max m when x > m or x is NaN
__device__ __forceinline__ float take(float m, float x) { return (x > m || isnan(x)) ? x : m; }

// Walks k = threadIdx.x, + blockDim.x, ... over an (n2, n1, n0) index space,
// n0 fastest, with no division in the loop.
struct Walk {
  int a0, a1, a2, n0, n1, e0, e1, e2;
  __device__ static Walk start(int n0, int n1) {
    const int t = threadIdx.x, s = blockDim.x;
    return {t % n0, (t / n0) % n1, t / (n0 * n1), n0, n1, s % n0, (s / n0) % n1, s / (n0 * n1)};
  }
  __device__ __forceinline__ void step() {
    a0 += e0;
    int c = a0 >= n0;
    a0 -= c * n0;
    a1 += e1 + c;
    c = a1 >= n1;
    a1 -= c * n1;
    a2 += e2 + c;
  }
};

struct Step {
  int tile, s, s_end, p0, h0, hin0, to0, to1;
  __device__ bool valid() const { return tile >= 0; }
};

__device__ __forceinline__ Step tile_step(const Geo& g, int tile) {
  Step st;
  if (tile >= g.bands * g.chunks * g.groups) {
    st.tile = -1;
    return st;
  }
  st.tile = tile;
  const int band = tile % g.bands, rest = tile / g.bands;
  const int chunk = rest % g.chunks, group = rest / g.chunks;
  st.p0 = group * g.np;
  st.h0 = band * g.th;
  st.hin0 = st.h0 * g.sh - g.ph;
  st.to0 = chunk * g.tc;
  st.to1 = min(g.To, st.to0 + g.tc);
  st.s = max(0, st.to0 * g.st - g.pt);
  st.s_end = min(g.T - 1, (st.to1 - 1) * g.st - g.pt + g.kt - 1);
  return st;
}

__device__ __forceinline__ Step advance(const Geo& g, Step st) {
  if (!st.valid()) return st;
  if (st.s < st.s_end) {
    ++st.s;
    return st;
  }
  return tile_step(g, st.tile + gridDim.x);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Stage slice st.s of the tile into buf: np x rows rows of W elements.
template <typename R>
__device__ __forceinline__ void issue(const Geo& g, const R* __restrict__ x, R* buf,
                                      const Step& st, Walk w) {
  if (!st.valid()) return;
  const int ce = g.copy_bytes ? g.copy_bytes / int(sizeof(R)) : 1;
  const int64_t plane = int64_t(g.T) * g.H * g.W;
  const R* base = x + int64_t(st.p0) * plane + int64_t(st.s) * g.H * g.W;
  const R ninf = Raw<R>::narrow(-INFINITY);
  for (; w.a2 < g.np; w.step()) {  // (plane, row, chunk)
    if (st.p0 + w.a2 >= g.planes) break;
    R* dst = buf + (w.a2 * g.rows + w.a1) * g.pitch + g.left + w.a0 * ce;
    const int h = st.hin0 + w.a1;
    if (h < 0 || h >= g.H) {
      for (int e = 0; e < ce; ++e) dst[e] = ninf;
      continue;
    }
    const R* src = base + w.a2 * plane + int64_t(h) * g.W + w.a0 * ce;
    if (g.copy_bytes)
      cp_async(dst, src, g.copy_bytes);
    else
      *dst = *src;
  }
}

template <typename R>
__device__ __forceinline__ float row_max(const Geo& g, const R* p) {
  float m = Raw<R>::widen(p[0]);
  for (int b = 1; b < g.kw; ++b) m = take(m, Raw<R>::widen(p[b]));
  return m;
}

// The max over each output's (k_h, k_w) window of one staged slice, into a
// ring slot: a thread takes a column of a plane's output rows.
template <typename R>
__device__ __forceinline__ void hw_phase(const Geo& g, const R* buf, R* slot, const Step& st,
                                         Walk w) {
  const int last = min(g.th, g.Ho - st.h0);
  for (; w.a2 < g.np; w.step()) {  // (plane, strip, column)
    const int r0 = w.a1 * g.strip_len, r1 = min(last, r0 + g.strip_len);
    const R* col = buf + w.a2 * g.rows * g.pitch + g.left - g.pw + w.a0 * g.sw;
    R* dst = slot + w.a2 * g.th * g.Wo + w.a0;
    for (int r = r0; r < r1; ++r) {
      float m = row_max(g, col + r * g.sh * g.pitch);
      for (int a = 1; a < g.kh; ++a) m = take(m, row_max(g, col + (r * g.sh + a) * g.pitch));
      dst[r * g.Wo] = Raw<R>::narrow(m);
    }
  }
}

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<2> { using type = uint16_t; };

// Outputs [lo_to, hi_to) of the tile, each the max over its window's ring
// slots in time order; E elements a store.
template <typename R, int E>
__device__ __forceinline__ void emit(const Geo& g, const R* ring, R* __restrict__ out,
                                     const Step& st, int lo_to, int hi_to, Walk w) {
  using V = typename VecOf<E * sizeof(R)>::type;
  union Pack {
    V v;
    R e[E];
  };
  const int last = min(g.th, g.Ho - st.h0);
  for (; w.a2 < g.np; w.step()) {  // (plane, row, run of E)
    const int p = st.p0 + w.a2;
    if (p >= g.planes) break;
    if (w.a1 >= last) continue;
    const int off = (w.a2 * g.th + w.a1) * g.Wo + w.a0 * E;
    R* o = out + (int64_t(p) * g.To * g.Ho + st.h0 + w.a1) * g.Wo + w.a0 * E;
    for (int to = lo_to; to < hi_to; ++to) {
      const int lo = max(0, to * g.st - g.pt), hi = min(g.T - 1, to * g.st - g.pt + g.kt - 1);
      Pack a;
      a.v = *reinterpret_cast<const V*>(ring + (lo % g.kt) * g.slot_elems + off);
      if (hi > lo) {
        float m[E];
#pragma unroll
        for (int e = 0; e < E; ++e) m[e] = Raw<R>::widen(a.e[e]);
        for (int s = lo + 1; s <= hi; ++s) {
          Pack b;
          b.v = *reinterpret_cast<const V*>(ring + (s % g.kt) * g.slot_elems + off);
#pragma unroll
          for (int e = 0; e < E; ++e) m[e] = take(m[e], Raw<R>::widen(b.e[e]));
        }
#pragma unroll
        for (int e = 0; e < E; ++e) a.e[e] = Raw<R>::narrow(m[e]);
      }
      *reinterpret_cast<V*>(o + int64_t(to) * g.Ho * g.Wo) = a.v;
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads, 1)
    maxpool3d_kernel(const R* __restrict__ x, R* __restrict__ out, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  R* stage = reinterpret_cast<R*>(smem);
  R* ring = stage + kStages * g.stage_elems;
  Step cur = tile_step(g, blockIdx.x);
  if (!cur.valid()) return;

  // -inf in the padding columns of every staged row, once
  const R ninf = Raw<R>::narrow(-INFINITY);
  const int pads = g.pitch - g.W;
  for (int k = threadIdx.x; k < kStages * g.np * g.rows * pads; k += blockDim.x) {
    const int c = k % pads;
    stage[(k / pads) * g.pitch + (c < g.left ? c : c + g.W)] = ninf;
  }
  const int ce = g.copy_bytes ? g.copy_bytes / int(sizeof(R)) : 1;
  const Walk w_issue = Walk::start(g.W / ce, g.rows);
  const Walk w_hw = Walk::start(g.Wo, g.strips);
  const Walk w_emit = Walk::start(g.Wo / g.store_elems, g.th);

  Step ahead = cur;
  issue(g, x, stage, ahead, w_issue);
  commit();
  ahead = advance(g, ahead);
  issue(g, x, stage + g.stage_elems, ahead, w_issue);
  commit();
  for (int k = 0; cur.valid(); ++k) {
    ahead = advance(g, ahead);
    issue(g, x, stage + ((k + 2) % kStages) * g.stage_elems, ahead, w_issue);
    commit();
    asm volatile("cp.async.wait_group 2;\n" ::);
    __syncthreads();
    hw_phase(g, stage + (k % kStages) * g.stage_elems, ring + (cur.s % g.kt) * g.slot_elems, cur,
             w_hw);
    __syncthreads();
    // the outputs whose (clipped) window ends at this slice
    int lo_to = 0, hi_to = 0;
    if (cur.s == g.T - 1) {
      const int num = g.T - g.kt + g.pt;
      lo_to = num <= 0 ? 0 : (num + g.st - 1) / g.st;
      hi_to = g.To;
    } else {
      const int num = cur.s + g.pt - g.kt + 1;
      if (num >= 0 && num % g.st == 0) {
        lo_to = num / g.st;
        hi_to = lo_to + 1;
      }
    }
    lo_to = max(lo_to, cur.to0);
    hi_to = min(hi_to, cur.to1);
    if (lo_to < hi_to) {
      const int e = g.store_elems * int(sizeof(R));
      if (e == 16)
        emit<R, 16 / sizeof(R)>(g, ring, out, cur, lo_to, hi_to, w_emit);
      else if (e == 8)
        emit<R, 8 / sizeof(R)>(g, ring, out, cur, lo_to, hi_to, w_emit);
      else if (sizeof(R) == 2 && e == 4)
        emit<R, 2>(g, ring, out, cur, lo_to, hi_to, w_emit);
      else
        emit<R, 1>(g, ring, out, cur, lo_to, hi_to, w_emit);
    }
    cur = advance(g, cur);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---- maxpool3d_rows ----

constexpr int kRowThreads = 256;
constexpr uint32_t kNegInf2 = 0xff80ff80u;  // two bf16 -inf

// PyTorch's rule on two bf16 lanes: x replaces m where x > m or x is NaN
__device__ __forceinline__ uint32_t take2(uint32_t m, uint32_t x) {
  uint32_t gt, nan;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(x), "r"(m));
  asm("set.nan.u32.bf16x2 %0, %1, %1;" : "=r"(nan) : "r"(x));
  const uint32_t k = gt | nan;
  return (x & k) | (m & ~k);
}

// A row segment: elements [0, 8 SW) two a word, the element before it (l)
// and the one after it (r) in their low halves.
template <int SW>
struct Row {
  uint32_t w[4 * SW];
  uint32_t l, r;
};

// Elements k0 and k1 of a segment as the low and high lanes of a word.
template <int SW>
__device__ __forceinline__ uint32_t pair(const Row<SW>& row, int k0, int k1) {
  constexpr int n = 8 * SW;
  if (k0 >= 0 && k1 == k0 + 1 && !(k0 & 1) && k1 < n) return row.w[k0 >> 1];
  const uint32_t a = k0 < 0 ? row.l : k0 >= n ? row.r : row.w[k0 >> 1];
  const uint32_t b = k1 < 0 ? row.l : k1 >= n ? row.r : row.w[k1 >> 1];
  const bool h0 = k0 >= 0 && k0 < n && (k0 & 1), h1 = k1 >= 0 && k1 < n && (k1 & 1);
  return __byte_perm(a, b, (h0 ? 0x32 : 0x10) | ((h1 ? 0x76 : 0x54) << 8));
}

// The segment of input row src at column b, -inf beyond the row: 16-byte
// loads, or 8-byte ones where W is a multiple of 4 and not of 8.
template <int SW, int LH, int RH>
__device__ __forceinline__ void load_row(Row<SW>& row, const uint16_t* __restrict__ src, int b,
                                         int W) {
#pragma unroll
  for (int v = 0; v < SW; ++v) {
    const int c = b + 8 * v;
    uint4 q = make_uint4(kNegInf2, kNegInf2, kNegInf2, kNegInf2);
    if (!(W & 7)) {
      if (c < W) q = __ldg(reinterpret_cast<const uint4*>(src + c));
    } else {
      if (c < W) {
        const uint2 lo = __ldg(reinterpret_cast<const uint2*>(src + c));
        q.x = lo.x, q.y = lo.y;
      }
      if (c + 4 < W) {
        const uint2 hi = __ldg(reinterpret_cast<const uint2*>(src + c + 4));
        q.z = hi.x, q.w = hi.y;
      }
    }
    row.w[4 * v] = q.x, row.w[4 * v + 1] = q.y, row.w[4 * v + 2] = q.z, row.w[4 * v + 3] = q.w;
  }
  row.l = LH && b > 0 ? __ldg(src + b - 1) : 0xff80u;
  row.r = RH && b + 8 * SW < W ? __ldg(src + b + 8 * SW) : 0xff80u;
}

template <int SW>
__device__ __forceinline__ void fill_row(Row<SW>& row) {
#pragma unroll
  for (int i = 0; i < 4 * SW; ++i) row.w[i] = kNegInf2;
  row.l = row.r = 0xff80u;
}

// The max over W of each output pair's window in one row, taps in order.
template <int KW, int SW, int PW>
__device__ __forceinline__ void row_max2(const Row<SW>& row, uint32_t (&m)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k0 = 2 * j * SW - PW, k1 = (2 * j + 1) * SW - PW;
    m[j] = pair(row, k0, k1);
#pragma unroll
    for (int t = 1; t < KW; ++t) m[j] = take2(m[j], pair(row, k0 + t, k1 + t));
  }
}

// valid outputs of o to dst in runs of e elements (8, 4, 2 or 1), e | valid
__device__ __forceinline__ void store8(uint16_t* dst, const uint32_t (&o)[4], int valid, int e) {
  if (e == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  } else if (e == 4) {
#pragma unroll
    for (int i = 0; i < 8; i += 4)
      if (i < valid) *reinterpret_cast<uint2*>(dst + i) = make_uint2(o[i / 2], o[i / 2 + 1]);
  } else if (e == 2) {
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      if (i < valid) *reinterpret_cast<uint32_t*>(dst + i) = o[i / 2];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < valid) dst[i] = uint16_t(o[i / 2] >> (16 * (i & 1)));
  }
}

template <int KT, int KH, int KW, int SH, int SW, int PH, int PW, int R, int MINB>
__global__ void __launch_bounds__(kRowThreads, MINB)
    maxpool3d_rows(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, const Geo g) {
  constexpr int LH = PW, RH = KW - PW - SW > 0 ? KW - PW - SW : 0;
  constexpr int NR = (R - 1) * SH + KH;  // input rows of R output rows
  static_assert(PW <= 1 && RH <= 1, "a window reaches one element past its 8 outputs' span");
  const int groups = (g.Wo + 7) / 8, bands = (g.Ho + R - 1) / R;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int gi = i % groups;
  i /= groups;
  const int r0 = i % bands * R;
  i /= bands;
  const int chunk = i % g.chunks, p = i / g.chunks;
  if (p >= g.planes) return;
  const int to0 = chunk * g.tc, to1 = min(g.To, to0 + g.tc);
  if (to0 >= to1) return;
  const int s0 = max(0, to0 * g.st - g.pt);
  const int s1 = min(g.T - 1, (to1 - 1) * g.st - g.pt + KT - 1);
  const int b = 8 * gi * SW, valid = min(8, g.Wo - 8 * gi);
  const int64_t hw_size = int64_t(g.H) * g.W;
  const uint16_t* plane = x + int64_t(p) * g.T * hw_size;
  uint16_t* dst = out + (int64_t(p) * g.To * g.Ho + r0) * g.Wo + 8 * gi;

  uint32_t ring[KT][R][4];  // per slice and output row, the max over its (k_h, k_w) windows
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int j = 0; j < 4; ++j) ring[k][rr][j] = kNegInf2;
  for (int s = s0; s <= s1; ++s) {
    const uint16_t* slice = plane + s * hw_size;
    Row<SW> rows[NR];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const int h = r0 * SH - PH + a;
      if (h >= 0 && h < g.H)
        load_row<SW, LH, RH>(rows[a], slice + int64_t(h) * g.W, b, g.W);
      else
        fill_row(rows[a]);
    }
    uint32_t m[NR][4];
#pragma unroll
    for (int a = 0; a < NR; ++a) row_max2<KW, SW, PW>(rows[a], m[a]);
#pragma unroll
    for (int k = 0; k + 1 < KT; ++k)
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int j = 0; j < 4; ++j) ring[k][rr][j] = ring[k + 1][rr][j];
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t v = m[rr * SH][j];
#pragma unroll
        for (int a = 1; a < KH; ++a) v = take2(v, m[rr * SH + a][j]);
        ring[KT - 1][rr][j] = v;
      }
    // the outputs whose (clipped) window ends at this slice
    int lo_to = 0, hi_to = 0;
    if (s == g.T - 1) {
      const int num = g.T - KT + g.pt;
      lo_to = num <= 0 ? 0 : (num + g.st - 1) / g.st;
      hi_to = g.To;
    } else {
      const int num = s + g.pt - KT + 1;
      if (num >= 0 && num % g.st == 0) {
        lo_to = num / g.st;
        hi_to = lo_to + 1;
      }
    }
    for (int to = max(lo_to, to0); to < min(hi_to, to1); ++to) {
      const int n = s - max(0, to * g.st - g.pt) + 1;  // the window's slices: the ring's last n
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (r0 + rr >= g.Ho) continue;
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < KT; ++k) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k == KT - n) o[j] = ring[k][rr][j];
            else if (k > KT - n) o[j] = take2(o[j], ring[k][rr][j]);
          }
        }
        store8(dst + (int64_t(to) * g.Ho + rr) * g.Wo, o, valid, g.store_elems);
      }
    }
  }
}

int round_up(int a, int b) { return (a + b - 1) / b * b; }
int cdiv(int a, int b) { return (a + b - 1) / b; }

// The largest of 16, 8, 4 bytes (or 0) that every offset a multiple of n
// elements of es bytes, from a base aligned to it, keeps aligned.
int access_bytes(int64_t n, int es, uintptr_t base) {
  for (int b = 16; b >= 4; b /= 2)
    if ((n * es) % b == 0 && base % b == 0) return b;
  return 0;
}

template <typename R>
size_t smem_bytes(const Geo& g) {
  return sizeof(R) * size_t(kStages * g.stage_elems + g.kt * g.slot_elems);
}

// The tiling of a call; returns its shared memory, or 0 if none fits.
template <typename R>
size_t plan(Geo& g, int want_tiles, uintptr_t xp, uintptr_t op) {
  const int es = sizeof(R), ve = 16 / es;
  g.left = round_up(g.pw, ve);
  g.pitch = round_up(g.left + g.W + g.pw, ve);
  const int row_bytes = g.pitch * es;
  const int fit = max(g.kh, kStageBytes / row_bytes);
  g.th = min(g.Ho, (fit - g.kh) / g.sh + 1);
  g.bands = cdiv(g.Ho, g.th);
  g.th = cdiv(g.Ho, g.bands);
  g.rows = (g.th - 1) * g.sh + g.kh;
  g.np = min(g.planes, max(1, kStageBytes / (g.rows * row_bytes)));
  while (g.np > 1 && cdiv(g.planes, g.np) * g.bands < want_tiles) g.np = cdiv(g.np, 2);
  g.groups = cdiv(g.planes, g.np);
  g.tc = g.To;
  g.chunks = 1;
  if (g.groups * g.bands < want_tiles && g.To > 1) {
    g.tc = cdiv(g.To, min(g.To, cdiv(want_tiles, g.groups * g.bands)));
    g.chunks = cdiv(g.To, g.tc);
  }
  const int64_t plane = int64_t(g.T) * g.H * g.W;
  g.copy_bytes = access_bytes(g.W, es, xp);
  if (g.copy_bytes && (plane * es % g.copy_bytes || int64_t(g.H) * g.W * es % g.copy_bytes))
    g.copy_bytes = 0;
  if (g.copy_bytes == 0 && es == 4) g.copy_bytes = xp % 4 ? 0 : 4;
  const int sb = access_bytes(g.Wo, es, op);
  g.store_elems = sb ? sb / es : 1;
  const int cols = g.np * g.Wo;
  g.strips = min(g.th, max(1, kThreads / cols));
  g.strip_len = cdiv(g.th, g.strips);
  g.strips = cdiv(g.th, g.strip_len);
  g.stage_elems = g.np * g.rows * g.pitch;
  g.slot_elems = round_up(g.np * g.th * g.Wo, ve);
  const size_t smem = smem_bytes<R>(g);
  return smem <= kMaxSmem ? smem : 0;
}

template <typename R>
int launch(const R* x, R* out, Geo g, cudaStream_t stream) {
  auto kernel = maxpool3d_kernel<R>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = plan<R>(g, kTilesPerBlock * sms * (2048 / kThreads),
                              reinterpret_cast<uintptr_t>(x), reinterpret_cast<uintptr_t>(out));
  if (smem == 0) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return int(e);
  const int tiles = g.bands * g.chunks * g.groups;
  const int grid = max(1, min(tiles, sms * max(1, per_sm)));
  kernel<<<grid, kThreads, smem, stream>>>(x, out, g);
  return int(cudaGetLastError());
}

constexpr int kNotRows = -2;  // the row kernel does not take the call

template <int KT, int KH, int KW, int SH, int SW, int PH, int PW, int R, int MINB>
int launch_rows(const uint16_t* x, uint16_t* out, Geo g, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // time positions split in runs (each reads its window's overlap again)
  // only until the card holds a round of threads
  const int64_t per_run = int64_t(g.planes) * cdiv(g.Ho, R) * cdiv(g.Wo, 8);
  const int64_t want = int64_t(sms) * 1024;
  const int64_t runs = (want + per_run - 1) / per_run;
  g.chunks = int(runs < g.To ? runs : g.To);
  g.tc = cdiv(g.To, g.chunks);
  g.chunks = cdiv(g.To, g.tc);
  const int64_t total = per_run * g.chunks;
  if (total > INT32_MAX - kRowThreads) return kNotRows;
  const int sb = access_bytes(g.Wo, 2, reinterpret_cast<uintptr_t>(out));
  g.store_elems = sb ? sb / 2 : 1;
  const int grid = int((total + kRowThreads - 1) / kRowThreads);
  maxpool3d_rows<KT, KH, KW, SH, SW, PH, PW, R, MINB>
      <<<grid, kRowThreads, 0, stream>>>(x, out, g);
  return int(cudaGetLastError());
}

// The row kernel for a bf16 call it takes, else kNotRows.
int dispatch_rows(const uint16_t* x, uint16_t* out, const Geo& g, cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  if (g.W % 8 ? g.W % 4 || base % 8 : base % 16) return kNotRows;
  const auto is = [&](int kt, int kh, int kw, int sh, int sw, int ph, int pw) {
    return g.kt == kt && g.kh == kh && g.kw == kw && g.sh == sh && g.sw == sw && g.ph == ph &&
           g.pw == pw;
  };
  // R: output rows a thread, so an input row shared by two windows is
  // reduced once; MINB: blocks an SM must hold, which caps the registers
  if (is(1, 3, 3, 2, 2, 1, 1)) return launch_rows<1, 3, 3, 2, 2, 1, 1, 1, 4>(x, out, g, s);
  if (is(3, 3, 3, 1, 1, 1, 1)) return launch_rows<3, 3, 3, 1, 1, 1, 1, 2, 3>(x, out, g, s);
  if (is(3, 3, 3, 2, 2, 1, 1)) return launch_rows<3, 3, 3, 2, 2, 1, 1, 1, 3>(x, out, g, s);
  if (is(2, 1, 1, 1, 1, 0, 0)) return launch_rows<2, 1, 1, 1, 1, 0, 0, 2, 4>(x, out, g, s);
  if (is(1, 2, 2, 2, 2, 0, 0)) return launch_rows<1, 2, 2, 2, 2, 0, 0, 1, 4>(x, out, g, s);
  if (is(4, 1, 1, 1, 2, 0, 0)) return launch_rows<4, 1, 1, 1, 2, 0, 0, 1, 4>(x, out, g, s);
  return kNotRows;
}

}  // namespace

// out (planes, To, Ho, Wo) = max_pool3d of x (planes, T, H, W), both
// contiguous; dtype 0 bf16, 1 f32. k*, s*, p*: kernel, stride, padding in
// (t, h, w). Returns 0, a cudaError, or -1 when no tiling fits shared memory.
extern "C" int maxpool3d(const void* x, void* out, int dtype, int planes, int T, int H, int W,
                         int To, int Ho, int Wo, int kt, int kh, int kw, int st, int sh, int sw,
                         int pt, int ph, int pw, void* stream) {
  Geo g{};
  g.planes = planes, g.T = T, g.H = H, g.W = W, g.To = To, g.Ho = Ho, g.Wo = Wo;
  g.kt = kt, g.kh = kh, g.kw = kw, g.st = st, g.sh = sh, g.sw = sw;
  g.pt = pt, g.ph = ph, g.pw = pw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int rc =
        dispatch_rows(static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), g, s);
    if (rc != kNotRows) return rc;
    return launch(static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), g, s);
  }
  return launch(static_cast<const float*>(x), static_cast<float*>(out), g, s);
}
