// The decoder's (kt, 3, 3) convolutions for Hopper (sm_90a), as an implicit
// GEMM on the tensor cores: bf16 x bf16 -> f32, the bias added and the sum
// rounded once to bf16.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (vinet_tpu/models/decoder.py). It was added because cuDNN runs the 480 ->
// 192 ones in bf16 on its generic implicit_convolveNd_sgemm at about 2 % of
// the card's bf16 peak, a third of a parity window batch's device time and
// two fifths of a live feed's (PERF.md).
//
// With x channels-last (B, T, H, W, C), the weight K-major as wt (N, kt, 3,
// 3, C) and out NCDHW (B, N, T_out, H_out, W_out), it computes
//
//   out[b, n, to, h, w] = bias[n] + sum_{dt < kt, dh < 3, dw < 3, c < C}
//       x[b, st * to + dt - pt, h + dh - p, w + dw - p, c] * wt[n, dt, dh, dw, c]
//
// with zeros outside x: temporal stride st and padding pt, spatial stride 1
// and padding p of 0 (VALID) or 1. As a GEMM: M = B * T_out * H_out * W_out
// output positions, N = C_out, K = kt * 9 * C.
//
// Bound on the card (H100 SXM data sheet): the parity window batch's conv3
// (M = 86,016, N = 192, K = 21,600) is 713 GFLOP against 41 MB read and 33 MB
// written, 0.72 ms at 989 TFLOP/s and 0.02 ms at 3.35 TB/s: bound by its
// operations, as is every decoder conv at the main paths' shapes. So the
// design keeps the tensor cores fed and moves nothing it need not:
//
// - Two warpgroups of a block each own 64 (or 128) rows of a kBM x kBN tile
//   and multiply on wgmma (m64 n kBN k16, both operands from shared memory,
//   K-major, 128-byte swizzle), the card's full tensor-core rate.
// - All 256 threads fill a ring of kStages (A, B) slots of 64-channel K
//   steps with 16-byte cp.async copies, kStages - 2 steps ahead, while one
//   wgmma group stays in flight. K runs over (dt, dh, dw, c), channels
//   fastest, and C % 8 == 0, so each 16-byte chunk of an A row is 8 channels
//   of one tap at one output position: its address is the row's base,
//   computed once per block, plus its tap's offset, which each thread
//   advances a step at a time. A chunk outside x (the spatial halo, the
//   temporal padding, K's end) is zero-filled by the copy itself (src-size
//   0). So the (M, K) operand never exists in memory and the halo costs no
//   copy.
// - The tile is chosen on the host from M, N and the card's SM count
//   (tile_width): 128 x {256, 192, 160} or 256 x {128, 64}, whichever
//   finishes its rounds of blocks soonest; conv3's 192 and conv4's 64 run
//   unpadded, conv2's 480 as three 160-wide tiles. Every tile holds at most
//   128 f32 sums a thread.
// - Epilogue: the sums plus the bias, rounded to bf16, go through shared
//   memory as (n, m) rows and leave in 16-byte runs along m, which NCDHW
//   keeps contiguous, so the output needs no transpose.
//
// x reaches the kernel channels-last through dconv_channels_last below, a
// tiled transpose through shared memory that reads a timeline's gathered
// windows (T outside C) and T slices as they lie: 2-6 times faster than
// PyTorch's strided copy at the decoder's shapes on the H100 (PERF.md). It
// costs 3-16 % of conv1-conv3's time and a third of conv4's, whose input is
// the decoder's largest (660 MB at parity's batch). The weight's K-major
// copy is made once per weight by the wrapper.

#include <cuda_bf16.h>

#include "gemm_core.cuh"

namespace {

using bf16 = uint16_t;  // bits; only the epilogue converts

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRowBytes = 128;  // bytes of a tile row per K step: one swizzle row
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks of a row
constexpr int kBK = kRowBytes / 2;  // channels per K step
constexpr int kRowsPerPass = kThreads / kChunks;  // A rows one pass of the block loads
constexpr int kFar = -(1 << 29);  // a row beyond M: every tap outside x
constexpr int kSmemMax = 232448;  // a block's dynamic shared memory on the H100
constexpr int kAlign = 1024;  // a 128-byte swizzle atom: 8 rows

struct Shape {
  int T, H, W, C;          // input extents (B is implied by M)
  int N, kt, st, pt, pad;  // C_out, temporal kernel, stride, padding; spatial padding
  int To, Ho, Wo;          // output grid
  int M, K;                // GEMM extents
  int vec_out;             // 1: T_out * H_out * W_out % 8 == 0, so 8-m runs stay in one b
};

// ------------------------------------------------------------------ wgmma --

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows in the
// 128-byte swizzle: 8-row atoms 1024 bytes apart (the leading offset is
// unused in this layout).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes of them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy writes to shared memory (cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N f32, the warpgroup's m64nNk16 fragment) += A (64 x 16) B (16 x N)^T.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  __device__ static __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ static __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<160> {
  __device__ static __forceinline__ void run(float (&d)[80], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<192> {
  __device__ static __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ static __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ------------------------------------------------------------ the kernel --

template <int kBM_, int kBN_>
struct Cfg {
  static constexpr int kBM = kBM_, kBN = kBN_;
  static constexpr int kSub = kBM / 128;  // m64 tiles of each warpgroup
  static constexpr int kAcc = kBN / 2;  // f32 sums a thread per m64 tile
  static constexpr int kARows = kBM / kRowsPerPass;  // A rows each thread loads
  static constexpr int kBUnits = kBN * kChunks;  // B chunks a step
  static constexpr int kSlot = (kBM + kBN) * kRowBytes;
  static constexpr int kStagesFit = (kSmemMax - kAlign) / kSlot;
  static constexpr int kStages = kStagesFit < 6 ? kStagesFit : 6;
  static constexpr int kAhead = kStages - 2;  // steps loaded ahead: one wgmma group in flight
  static constexpr int kPitch = kBM + 8;  // staged output row (one n), bf16s
  static constexpr int kStaged = kBN * kPitch * 2;
  static constexpr int kRing = kStages * kSlot;
  static constexpr int kSmem = (kRing > kStaged ? kRing : kStaged) + kAlign;
  static_assert(kBM % 128 == 0 && kBN % 8 == 0 && kBN <= 256, "wgmma tile");
  static_assert(kSub * kAcc <= 128, "f32 sums a thread");
  static_assert(kStages >= 3, "ring");
  static_assert((kPitch * 2) % 16 == 0, "16-byte staged runs");
};

// This thread's A rows and the tap its chunk is at. Rows are fixed for the
// block; the tap (dt, dh, dw) and channel c advance by kBK channels a step.
template <int kRows>
struct ARows {
  int base[kRows];  // element offset of x[b, ti, hi, wi, 0] (may lie outside x)
  int ti[kRows], hi[kRows], wi[kRows];
  int c, dt, dh, dw;

  __device__ __forceinline__ void advance(int by, int C) {
    c += by;
    while (c >= C) {
      c -= C;
      if (++dw == 3) {
        dw = 0;
        if (++dh == 3) {
          dh = 0;
          ++dt;
        }
      }
    }
  }
};

// Byte offset of 16-byte chunk ch of row r in the 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzle128(int r, int ch) {
  return static_cast<uint32_t>(r * kRowBytes + ((ch ^ (r & 7)) << 4));
}

template <typename Cf>
__device__ __forceinline__ void load_step(unsigned char* slot, const bf16* __restrict__ x,
                                          const bf16* __restrict__ wt, ARows<Cf::kARows>& a,
                                          const Shape& s, int n0, int step) {
  const int ch = threadIdx.x % kChunks;
  const bool tap_ok = a.dt < s.kt;  // else k >= K: zeros
  const int tap = ((a.dt * s.H + a.dh) * s.W + a.dw) * s.C + a.c;
#pragma unroll
  for (int j = 0; j < Cf::kARows; ++j) {
    const int r = threadIdx.x / kChunks + j * kRowsPerPass;
    const int ti = a.ti[j] + a.dt, hi = a.hi[j] + a.dh, wi = a.wi[j] + a.dw;
    const bool ok = tap_ok && static_cast<unsigned>(ti) < static_cast<unsigned>(s.T) &&
                    static_cast<unsigned>(hi) < static_cast<unsigned>(s.H) &&
                    static_cast<unsigned>(wi) < static_cast<unsigned>(s.W);
    gemm::cp_async16(gemm::smem_addr(slot + swizzle128(r, ch)), ok ? x + (a.base[j] + tap) : x,
                     ok);
  }
  unsigned char* bslot = slot + Cf::kBM * kRowBytes;
  const int k = step * kBK + ch * 8;
#pragma unroll
  for (int j = 0; j < (Cf::kBUnits + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (Cf::kBUnits % kThreads == 0 || i < Cf::kBUnits) {
      const int r = i / kChunks, n = n0 + r;
      const bool ok = n < s.N && k < s.K;
      gemm::cp_async16(gemm::smem_addr(bslot + swizzle128(r, ch)),
                       ok ? wt + (static_cast<int64_t>(n) * s.K + k) : wt, ok);
    }
  }
  a.advance(kBK, s.C);
}

template <typename Cf>
__global__ void __launch_bounds__(kThreads, 1)
dconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
             const float* __restrict__ bias, bf16* __restrict__ out, Shape s) {
  constexpr int kBM = Cf::kBM, kBN = Cf::kBN, kSub = Cf::kSub, kAcc = Cf::kAcc;
  constexpr int kStages = Cf::kStages, kAhead = Cf::kAhead;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));

  // block -> (N tile, M tile), N fastest: the N tiles of one M tile read the
  // same A rows and run together
  const int gn = (s.N + kBN - 1) / kBN;
  const int n0 = static_cast<int>(blockIdx.x % static_cast<unsigned>(gn)) * kBN;
  const int m0 = static_cast<int>(blockIdx.x / static_cast<unsigned>(gn)) * kBM;
  const int wg = threadIdx.x / 128;
  const int plane = s.To * s.Ho * s.Wo, hw = s.Ho * s.Wo;

  ARows<Cf::kARows> a;
#pragma unroll
  for (int j = 0; j < Cf::kARows; ++j) {
    const int m = m0 + threadIdx.x / kChunks + j * kRowsPerPass;
    if (m < s.M) {
      const int b = m / plane;
      int rem = m - b * plane;
      const int to = rem / hw;
      rem -= to * hw;
      const int h = rem / s.Wo, w = rem - h * s.Wo;
      a.ti[j] = to * s.st - s.pt;
      a.hi[j] = h - s.pad;
      a.wi[j] = w - s.pad;
      a.base[j] = (((b * s.T + a.ti[j]) * s.H + a.hi[j]) * s.W + a.wi[j]) * s.C;
    } else {
      a.ti[j] = a.hi[j] = a.wi[j] = kFar;
      a.base[j] = 0;
    }
  }
  a.c = (threadIdx.x % kChunks) * 8;
  a.dt = a.dh = a.dw = 0;
  a.advance(0, s.C);

  float acc[kSub][kAcc];
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[u][i] = 0.f;

  const int steps = (s.K + kBK - 1) / kBK;
#pragma unroll
  for (int p = 0; p < kAhead; ++p) {
    if (p < steps) load_step<Cf>(smem + p * Cf::kSlot, x, wt, a, s, n0, p);
    gemm::cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    gemm::cp_async_wait<kAhead - 1>();  // step's copies have landed (this thread's)
    fence_proxy_async();                // ... and are visible to wgmma
    __syncthreads();  // everyone's; and the slot loaded next is free (its wgmma done)
    const int next = step + kAhead;
    if (next < steps) load_step<Cf>(smem + (next % kStages) * Cf::kSlot, x, wt, a, s, n0, next);
    gemm::cp_async_commit();

    const uint32_t sa = gemm::smem_addr(smem + (step % kStages) * Cf::kSlot);
    const uint32_t sb = sa + kBM * kRowBytes;
#pragma unroll
    for (int u = 0; u < kSub; ++u) fence_regs(acc[u]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {  // 16-channel K slices: 32 bytes into the row
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        Mma<kBN>::run(acc[u], smem_desc(sa + (wg * kSub + u) * 64 * kRowBytes + ks * 32),
                      smem_desc(sb + ks * 32));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's group is done: its slot may be refilled
#pragma unroll
    for (int u = 0; u < kSub; ++u) fence_regs(acc[u]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < kSub; ++u) fence_regs(acc[u]);
  gemm::cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile there

  // sums + bias -> bf16, as (n, m) rows of kPitch. In the m64nN fragment,
  // sum i of a thread is row 16 warp + lane / 4 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (lane % 4) + i % 2.
  bf16* staged = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x & 31, wq = (threadIdx.x / 32) & 3;
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int nl = 8 * (i / 4) + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (n0 + nl < s.N) b0 = __ldg(bias + n0 + nl);
      if (n0 + nl + 1 < s.N) b1 = __ldg(bias + n0 + nl + 1);
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const int ml = (wg * kSub + u) * 64 + 16 * wq + (lane >> 2) + 8 * ((i / 2) % 2);
      staged[nl * Cf::kPitch + ml] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[u][i] + b0));
      staged[(nl + 1) * Cf::kPitch + ml] =
          __bfloat16_as_ushort(__float2bfloat16_rn(acc[u][i + 1] + b1));
    }
  }
  __syncthreads();

  // out[b, n, m - b * plane] in runs of 8 positions along m
  constexpr int kRuns = kBM / 8;
  for (int i = threadIdx.x; i < kBN * kRuns; i += kThreads) {
    const int nl = i / kRuns, m = m0 + (i % kRuns) * 8, n = n0 + nl;
    if (n >= s.N || m >= s.M) continue;
    const bf16* src = staged + nl * Cf::kPitch + (i % kRuns) * 8;
    if (s.vec_out && m + 8 <= s.M) {
      const int b = m / plane;
      *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(b) * s.N + n) * plane +
                                (m - b * plane)) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && m + e < s.M; ++e) {
        const int b = (m + e) / plane;
        out[(static_cast<int64_t>(b) * s.N + n) * plane + (m + e - b * plane)] = src[e];
      }
    }
  }
}

template <typename Cf>
int launch(const bf16* x, const bf16* wt, const float* bias, bf16* out, const Shape& s,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dconv_kernel<Cf>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>((s.M + Cf::kBM - 1) / Cf::kBM) *
                         ((s.N + Cf::kBN - 1) / Cf::kBN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  dconv_kernel<Cf><<<static_cast<unsigned>(blocks), kThreads, Cf::kSmem, stream>>>(x, wt, bias,
                                                                                   out, s);
  return static_cast<int>(cudaGetLastError());
}

// The tile for M x N on `sms` SMs (one block an SM): the one whose rounds of
// blocks take least time, a round taking the tile's area over the tile's
// rate. The rates are relative, measured at the live path's shapes on an
// H100 80GB HBM3 at 700 W, where rounds hardly matter (PERF.md): the
// 256-wide tile runs fastest for each product it computes, the 64-wide one
// (m64n64 products, half the K step's bytes reused) slowest. At the parity
// batch's conv1 and conv2, whose M fills the card only two to four times,
// the rounds decide: three 160-wide tiles for conv2's N = 480 make 504
// blocks in 4 rounds at 95 %, two 256-wide ones 336 in 3 at 85 %.
int tile_width(int64_t m, int n, int sms) {
  const struct { int bn; double rate; } tiles[] = {
      {256, 1.0}, {192, 0.88}, {160, 0.87}, {128, 0.92}, {64, 0.68}};
  int best = 0;
  double best_cost = 0;
  for (const auto& t : tiles) {
    const int bm = t.bn <= 128 ? 256 : 128;
    const int64_t blocks = (m + bm - 1) / bm * ((n + t.bn - 1) / t.bn);
    const double cost = static_cast<double>((blocks + sms - 1) / sms) * bm * t.bn / t.rate;
    if (best == 0 || cost < best_cost) best = t.bn, best_cost = cost;
  }
  return best;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// ----------------------------------------------------- channels-last copy --

constexpr int kTile = 64;  // channels x positions of a transpose tile
constexpr int kMaxGridZ = 65535;

// dst (B, T, P, C) contiguous = src (B, C, T, P) with strides (sb, sc, st,
// 1): one 64 x 64 tile of each (b, t) a block through shared memory, read
// along P (16 bytes a thread where vec, else 2) and written along C in
// 16-byte runs (C % 8 == 0). The grid is (P tiles, C tiles, up to 65535
// of the B * T planes), each block looping over its planes.
__global__ void __launch_bounds__(256)
dconv_channels_last(const bf16* __restrict__ src, bf16* __restrict__ dst, int T, int C, int P,
                    int G, int64_t sb, int64_t sc, int64_t st, int vec) {
  __shared__ __align__(16) bf16 tile[kTile][kTile + 2];  // [c][p]
  const int p0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  for (int g = blockIdx.z; g < G; g += gridDim.z) {
    const int b = g / T, t = g - b * T;
    const bf16* sg = src + b * sb + t * st;
    if (vec) {
      for (int i = threadIdx.x; i < kTile * kTile / 8; i += 256) {
        const int r = i / (kTile / 8), q = (i % (kTile / 8)) * 8, c = c0 + r, p = p0 + q;
        if (c < C && p < P) {
          const uint4 v = *reinterpret_cast<const uint4*>(sg + c * sc + p);
          uint32_t* d = reinterpret_cast<uint32_t*>(&tile[r][q]);
          d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTile * kTile; i += 256) {
        const int r = i / kTile, q = i % kTile, c = c0 + r, p = p0 + q;
        if (c < C && p < P) tile[r][q] = sg[c * sc + p];
      }
    }
    __syncthreads();
    bf16* dg = dst + static_cast<int64_t>(g) * P * C;
    for (int i = threadIdx.x; i < kTile * kTile / 8; i += 256) {
      const int pr = i / (kTile / 8), q = (i % (kTile / 8)) * 8, p = p0 + pr, c = c0 + q;
      if (p < P && c < C) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = static_cast<uint32_t>(tile[q + 2 * e][pr]) |
                 (static_cast<uint32_t>(tile[q + 2 * e + 1][pr]) << 16);
        }
        *reinterpret_cast<uint4*>(dg + static_cast<int64_t>(p) * C + c) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();  // the tile is read before the next plane fills it
  }
}

}  // namespace

// Plain C entries, loaded with ctypes; each returns the first CUDA error of
// its launch (0 on success).
//
// dconv_bf16: x (B, T, H, W, C) channels-last, wt (N, kt, 3, 3, C), bias (N,)
// f32 or null, out (B, N, T_out, H_out, W_out), all contiguous and 16-byte
// aligned; C % 8 == 0 and x smaller than 2^31 elements (the wrapper checks).
extern "C" int dconv_bf16(const void* x, const void* wt, const void* bias, void* out, int b,
                          int t, int h, int w, int c, int n, int kt, int st, int pt, int pad,
                          void* stream) {
  Shape s;
  s.T = t, s.H = h, s.W = w, s.C = c;
  s.N = n, s.kt = kt, s.st = st, s.pt = pt, s.pad = pad;
  s.To = (t + 2 * pt - kt) / st + 1;
  s.Ho = h + 2 * pad - 2;
  s.Wo = w + 2 * pad - 2;
  const int64_t m = static_cast<int64_t>(b) * s.To * s.Ho * s.Wo;
  const int64_t k = static_cast<int64_t>(kt) * 9 * c;
  const int64_t elems = static_cast<int64_t>(b) * t * h * w * c;
  if (m <= 0 || m > 0x7fffffff || k > 0x7fffffff || elems >= (int64_t(1) << 31) || c % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.M = static_cast<int>(m);
  s.K = static_cast<int>(k);
  s.vec_out = (s.To * s.Ho * s.Wo) % 8 == 0;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(wt);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<bf16*>(out);
  const auto strm = static_cast<cudaStream_t>(stream);
  switch (tile_width(m, n, sm_count())) {
    case 256:
      return launch<Cfg<128, 256>>(xp, wp, bp, op, s, strm);
    case 192:
      return launch<Cfg<128, 192>>(xp, wp, bp, op, s, strm);
    case 160:
      return launch<Cfg<128, 160>>(xp, wp, bp, op, s, strm);
    case 128:
      return launch<Cfg<256, 128>>(xp, wp, bp, op, s, strm);
    default:
      return launch<Cfg<256, 64>>(xp, wp, bp, op, s, strm);
  }
}

// to_channels_last_bf16: dst (B, T, P, C) contiguous from src (B, C, T, P)
// with strides (sb, sc, st, 1); C % 8 == 0, dst 16-byte aligned.
extern "C" int to_channels_last_bf16(const void* src, void* dst, int b, int t, int c, int p,
                                     int64_t sb, int64_t sc, int64_t st, void* stream) {
  if (b <= 0 || t <= 0 || c % 8 != 0 || c <= 0 || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t g = static_cast<int64_t>(b) * t;
  if (g > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = p % 8 == 0 && sb % 8 == 0 && sc % 8 == 0 && st % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const dim3 grid((p + kTile - 1) / kTile, (c + kTile - 1) / kTile,
                  static_cast<unsigned>(g < kMaxGridZ ? g : kMaxGridZ));
  dconv_channels_last<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), t, c, p, static_cast<int>(g), sb,
      sc, st, vec);
  return static_cast<int>(cudaGetLastError());
}
