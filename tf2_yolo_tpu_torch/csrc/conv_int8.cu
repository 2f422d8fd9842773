// Static-scale int8 convolution (implicit GEMM, NHWC) with a dequantize +
// BatchNorm affine epilogue, in two launches:
//
//   xq  = clamp(rint(x / sx), -127, 127)        x bf16 or f32, sx > 0
//   acc = sum over (ky, kx, c) of xq * wq        s8 x s8 -> s32, exact
//   y   = round_to_out(fl(fl((float)acc * c[o]) + t[o]))
//
// with c[o] = (sx * sw[o]) * s_bn[o] and t[o] = bias[o] - mean[o] * s_bn[o]
// precomputed in f32 by the wrapper's caller (models/layers.Int8ConvBN).
//
// Replaces, on the serving path, the JAX package's static-scale int8 ConvBN
// (ConvBN._quant_call, tf2_yolo_tpu/models/layers.py:362-398).  There it is
// XLA's conv_general_dilated with s8 x s8 -> s32, not a Pallas kernel; here
// it is a kernel of its own, since PyTorch has no int8 convolution on CUDA.
//
// Geometry: a ks x ks conv of stride 1 or 2 (ks = 1, 2, 3 or 7) whose top
// and left pad and output size (ho, wo) come from the wrapper
// (ops/kernels/conv_bn.conv_geometry: the darknet 3x3 stride-2 pad, flax's
// SAME, or an explicit pad): input row ho_i*stride - pad_top + ky, column
// wo_i*stride - pad_left + kx, zero outside the image, past the bottom and
// right edges included (a zero quantizes to zero, so the padding is
// exact).  K = ks*ks*Ci in the HWIO order (ky, kx, c),
// zero-padded to kp, a multiple of 32.  The weights come as the (Co, kp)
// int8 matrix, row-major (ops/kernels/conv_int8.weight_layout): K-major,
// as wgmma's 8-bit B operand must be.
//
// What bounds it on an H100: int8 tensor cores peak at 1979 TOP/s dense, so
// every YOLOv4 layer is bound by its bytes (x read in bf16/f32, y written)
// at 3.35 TB/s, except the 3x3 layers at 26^2 and below with Ci >= 256,
// which are bound by operations.  The design, for both:
//
// 1. quantize_int8_kernel quantizes x once (16-byte loads, 8 values a
//    thread, rintf of the correctly rounded division: round half to even,
//    as jnp.round and torch.round; no reciprocal) into int8 scratch, so the
//    nine taps of a 3x3 re-read one byte an element from L2 instead of
//    quantizing again per tap and column block.  It also clears the
//    split-K tile counters of the conv that follows on the stream.
// 2. conv_int8_wgmma_kernel: a block of two warpgroups computes 128 output
//    pixels (64 a warpgroup) x BN (256, 128, 64 or 32) channels with
//    wgmma.mma_async m64nBNk32 s8 -> s32, both operands K-major in
//    128-byte-swizzled shared memory (rows of 128 bytes of K, the 16-byte
//    chunk j of row r at chunk j ^ (r % 8)).  Slices of 128 bytes of K
//    (four k32 steps) arrive through a ring of STAGES slots by 16-byte
//    cp.async copies with zero fill (the halo, rows past M, channels past
//    Co, K past kp: zeros add nothing, so every slice runs four steps),
//    STAGES - 2 slices in flight; one cp.async.wait_group and one
//    __syncthreads a slice, and one wgmma batch kept in flight across the
//    barrier (wgmma.wait_group 1): the slot refilled at slice i was read
//    by slice i - 2.  A 16-byte chunk lies in one tap when Ci % 16 == 0
//    (the "ring" route).  For other Ci (the stem, Ci = 3, K = 27 padded
//    to 32: the "gather" route) step 1 writes the implicit GEMM's rows
//    instead, (M, kp) int8, which this kernel reads as a 1x1 conv.
// 3. Split-K over the slices (gridDim.z) where the tiles alone would not
//    cover the 132 SMs: each split writes its int32 partial tile to a
//    workspace, and the last split to arrive at the tile's counter adds
//    the others' partials (int32 addition is exact and associative, so
//    any split and any order give the same bits) and applies the epilogue
//    once.  No host read-back: the counters are cleared by step 1 on the
//    same stream, so a CUDA graph can replay both launches.
// 4. The epilogue from the accumulators: __int2float_rn, __fmul_rn,
//    __fadd_rn (no FMA contraction, so the plain version's two separate
//    ops give the same bits), one rounding to the output dtype.
//
// conv_int8_before_launch keeps the first kernel (mma.sync.m16n8k32 with a
// quantizing prologue and a two-stage ring of 32-byte slices) for the
// before/after timing of chip_smoke.py; no model path calls it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

// clamp(rint(v / sx), -127, 127) as the low byte of a word
__device__ __forceinline__ uint32_t quant(float v, float sx) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
  return (uint32_t)(int)q & 0xffu;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four f32 (one 16-byte chunk) -> four int8 in a word
__device__ __forceinline__ uint32_t quant_f32x4(const uint4& v, float sx) {
  return quant(__uint_as_float(v.x), sx) | quant(__uint_as_float(v.y), sx) << 8
         | quant(__uint_as_float(v.z), sx) << 16
         | quant(__uint_as_float(v.w), sx) << 24;
}
// two bf16 a word, the lower address in the low half; a bf16's bits are
// the top half of the f32 of the same value
__device__ __forceinline__ uint32_t quant_bf16x4(uint32_t lo, uint32_t hi,
                                                 float sx) {
  return quant(__uint_as_float(lo << 16), sx)
         | quant(__uint_as_float(lo & 0xffff0000u), sx) << 8
         | quant(__uint_as_float(hi << 16), sx) << 16
         | quant(__uint_as_float(hi & 0xffff0000u), sx) << 24;
}

// ---------------------------------------------------------------------
// 1. the quantize pass.  The ring route's: 8 elements a thread and step
// (one 16-byte load of bf16, two of f32; one 8-byte store), the numel % 8
// tail element by element.  The first `ncounters` threads clear the
// split-K counters.
template <typename T>
__global__ void __launch_bounds__(256)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     int64_t numel, float sx, int* __restrict__ counters,
                     int ncounters) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < ncounters; i += step) counters[i] = 0;
  const int64_t vecs = numel / 8;
  for (int64_t v = tid; v < vecs; v += step) {
    uint2 q;
    if (sizeof(T) == 2) {
      const uint4 a = *reinterpret_cast<const uint4*>(x + v * 8);
      q.x = quant_bf16x4(a.x, a.y, sx);
      q.y = quant_bf16x4(a.z, a.w, sx);
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(x + v * 8);
      q.x = quant_f32x4(p[0], sx);
      q.y = quant_f32x4(p[1], sx);
    }
    *reinterpret_cast<uint2*>(xq + v * 8) = q;
  }
  const int64_t tail = vecs * 8 + tid;
  if (tail < numel) xq[tail] = (int8_t)quant(to_f32(x[tail]), sx);
}

// The gather route's (Ci % 16 != 0: the stem): quantize x straight into
// the rows of the implicit GEMM, cols (M, kp) int8 in the K order (ky, kx,
// c), zero outside the image and past K, one output pixel a thread and
// step, 16 bytes a store; the conv then reads cols as a 1x1 conv over kp
// channels.  Each input element is quantized once for each tap that
// reads it (ks*ks times at most): only the stem takes this route, at
// Ci = 3.
template <typename T>
__global__ void __launch_bounds__(256)
quantize_im2col_kernel(const T* __restrict__ x, int8_t* __restrict__ cols,
                       int n, int h, int wd, int ci, int ks, int stride,
                       int ho, int wo, int pad_top, int pad_left, int kp,
                       float sx, int* __restrict__ counters,
                       int ncounters) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  for (int i = tid; i < ncounters; i += step) counters[i] = 0;
  const int m_total = n * ho * wo, kfull = ks * ks * ci;
  for (int m = tid; m < m_total; m += step) {
    const int wo_i = m % wo, t = m / wo, ho_i = t % ho, nn = t / ho;
    const int hi0 = ho_i * stride - pad_top, wi0 = wo_i * stride - pad_left;
    for (int k16 = 0; k16 < kp; k16 += 16) {
      // (ky, kx, c) of byte k16, then stepped byte by byte
      int c = k16 % ci, kx = k16 / ci % ks, ky = k16 / ci / ks;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int hi = hi0 + ky, wi = wi0 + kx;
        if (k16 + e < kfull && hi >= 0 && hi < h && wi >= 0 && wi < wd)
          w[e >> 2] |= quant(to_f32(x[((int64_t)(nn * h + hi) * wd + wi)
                                      * ci + c]),
                             sx) << (8 * (e & 3));
        if (++c == ci) {
          c = 0;
          if (++kx == ks) {
            kx = 0;
            ++ky;
          }
        }
      }
      *reinterpret_cast<uint4*>(cols + (int64_t)m * kp + k16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---------------------------------------------------------------------
// 2. the int8 conv on wgmma
namespace wg {

constexpr int THREADS = 256;        // two warpgroups
constexpr int BM = 128;             // output rows a block, 64 a warpgroup
constexpr int SLICE = 128;          // bytes of K a ring slot (4 k32 steps)
constexpr int A_BYTES = BM * SLICE;
constexpr int ALIGN = 1024;         // the 128-byte swizzle repeats at 1 KB

// A ring slot; a block uses min(STAGES, its slices) of them (slice i
// goes to slot i % STAGES), so short K leaves room for more blocks an SM.
// Blocks an SM the registers must allow: a 6-slot ring fills the shared
// memory alone.
template <int BN, int STAGES>
struct Smem {
  static constexpr int STAGE = A_BYTES + BN * SLICE;
  static constexpr int MIN_BLOCKS =
      STAGES == 6 || BN == 256 ? 1 : BN == 32 ? 3 : 2;
  static int bytes(int slices) {
    return (slices < STAGES ? slices : STAGES) * STAGE + ALIGN;
  }
};

// wgmma's shared-memory matrix descriptor: start address, leading byte
// offset (unused by a swizzled K-major operand: 1), stride byte offset
// between 8-row groups (1024 bytes: 8 rows of 128), 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (uint64_t)1 << 16
         | (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
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
// this thread's generic-proxy writes (cp.async landed, st.shared) made
// visible to the async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of the accumulators
// across the wgmma fences and waits
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, s32) += A (64 x 32, s8) * B (N x 32, s8)^T, both from
// shared-memory descriptors; the s32 accumulator layout is mma.sync's
// m16n8 C fragment, the warps of the warpgroup stacked by 16 rows and
// the N / 8 column groups side by side
template <int N>
struct Wgmma;
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
          "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
          "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
          "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};


// A block: rows m0 .. m0 + 127 (blockIdx.x), channels c0 .. c0 + BN - 1
// (blockIdx.y), slices s_begin .. s_begin + sps - 1 of K (blockIdx.z of
// gridDim.z splits).  ws (splits, M, Co) int32 and counters (one a tile)
// are read only when gridDim.z > 1.  Ci % 16 == 0: a 16-byte chunk of K
// lies in one tap.  M = n * ho * wo < 2^31 (the wrapper checks).
template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, (Smem<BN, STAGES>::MIN_BLOCKS))
conv_int8_wgmma_kernel(const int8_t* __restrict__ xq,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ cs,
                       const float* __restrict__ ts, void* __restrict__ y,
                       int* __restrict__ ws, int* __restrict__ counters,
                       int out_bf16, int n, int h, int wd, int ci, int co,
                       int kp, int ks, int stride, int ho, int wo,
                       int pad_top, int pad_left, int sps) {
  constexpr int STAGE = Smem<BN, STAGES>::STAGE;
  constexpr int AHEAD = STAGES - 2;       // slices in flight
  constexpr int R = BN / 2;               // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem = smem_raw + ((ALIGN - (tc::smem_u32(smem_raw) & (ALIGN - 1)))
                              & (ALIGN - 1));

  const int tid = threadIdx.x, wgi = tid >> 7;
  const int kfull = ks * ks * ci;
  const int m_total = n * ho * wo;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int s_begin = split * sps;

  // this thread's 16-byte chunk j of K in rows r0 + 32 i of the tile
  const int j = tid & 7, r0 = tid >> 3;
  int a_pix[4], a_hi[4], a_wi[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    a_ok[i] = m < m_total;
    const int mm = a_ok[i] ? m : 0;
    const int wo_i = mm % wo, t = mm / wo, ho_i = t % ho, nn = t / ho;
    a_hi[i] = ho_i * stride - pad_top;
    a_wi[i] = wo_i * stride - pad_left;
    a_pix[i] = (nn * h + a_hi[i]) * wd + a_wi[i];
  }

  // slice s of K into ring slot `slot`: the A rows (zero past K, outside
  // the image and past M), the B rows (zero past kp and Co)
  auto load = [&](int s, int slot) {
    uint8_t* a = smem + slot * STAGE;
    uint8_t* b = a + A_BYTES;
    const int k = s * SLICE + 16 * j;
    const bool k_ok = k < kfull;
    const int tap = k_ok ? k / ci : 0;
    const int c = k - tap * ci, ky = tap / ks, kx = tap - ky * ks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 32 * i;
      const int hi = a_hi[i] + ky, wi = a_wi[i] + kx;
      const bool ok = k_ok && a_ok[i] && hi >= 0 && hi < h && wi >= 0
                      && wi < wd;
      tc::cp_async16(
          a + r * SLICE + ((j ^ (r & 7)) << 4),
          ok ? xq + (int64_t)(a_pix[i] + ky * wd + kx) * ci + c : xq, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int r = r0 + 32 * i;
      const bool ok = c0 + r < co && k < kp;
      tc::cp_async16(b + r * SLICE + ((j ^ (r & 7)) << 4),
                     ok ? wq + (int64_t)(c0 + r) * kp + k : wq, ok);
    }
  };

  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;

#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    if (p < sps) load(s_begin + p, p);
    tc::cp_async_commit();
  }
  int slot = 0, fill = AHEAD;     // the slot of slice it, of slice it + AHEAD
  for (int it = 0; it < sps; ++it) {
    // slice it has landed (AHEAD + it groups committed, AHEAD - 1 may
    // still be in flight); the slot refilled below was read by slice
    // it - 2, whose wgmma batch every warpgroup waited for before this
    // barrier
    tc::cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + AHEAD < sps) load(s_begin + it + AHEAD, fill);
    tc::cp_async_commit();
    const uint32_t a = tc::smem_u32(smem + slot * STAGE) + wgi * 64 * SLICE;
    const uint32_t b = tc::smem_u32(smem + slot * STAGE) + A_BYTES;
    // four k32 steps; past kp both operands are zero-filled
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      Wgmma<BN>::mma(acc, desc_sw128(a + 32 * q), desc_sw128(b + 32 * q));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    fill = fill + 1 == STAGES ? 0 : fill + 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator i: row g + 8 ((i / 2) % 2) of the warp's 16, column
  // 8 (i / 4) + 2 t + i % 2 (g = lane / 4, t = lane % 4)
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + wgi * 64 + warp * 16 + (lane >> 2);
  const int col0 = c0 + 2 * (lane & 3);
  const bool pairs = (co & 1) == 0;      // two columns in one store
  if (splits > 1) {
    int* part = ws + (int64_t)split * m_total * co;
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const int64_t row = row0 + 8 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2);
      if (row >= m_total || col >= co) continue;
      if (pairs)
        *reinterpret_cast<int2*>(part + row * co + col) =
            make_int2(acc[i], acc[i + 1]);
      else {
        part[row * co + col] = acc[i];
        if (col + 1 < co) part[row * co + col + 1] = acc[i + 1];
      }
    }
    __threadfence();
    __syncthreads();
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = atomicAdd(counter, 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;
    // every split has arrived: the counter is free again (so a replay of
    // this launch alone finds it cleared too)
    if (tid == 0) *counter = 0;
    __threadfence();
    for (int s = 0; s < splits; ++s) {
      if (s == split) continue;
      const int* other = ws + (int64_t)s * m_total * co;
#pragma unroll
      for (int i = 0; i < R; i += 2) {
        const int64_t row = row0 + 8 * ((i >> 1) & 1);
        const int col = col0 + 8 * (i >> 2);
        if (row >= m_total || col >= co) continue;
        if (pairs) {
          const int2 v = __ldcg(
              reinterpret_cast<const int2*>(other + row * co + col));
          acc[i] += v.x;
          acc[i + 1] += v.y;
        } else {
          acc[i] += __ldcg(other + row * co + col);
          if (col + 1 < co) acc[i + 1] += __ldcg(other + row * co + col + 1);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int64_t row = row0 + 8 * ((i >> 1) & 1);
    const int col = col0 + 8 * (i >> 2);
    if (row >= m_total || col >= co) continue;
    const bool two = col + 1 < co;
    const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), cs[col]),
                               ts[col]);
    const float v1 = two ? __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 1]),
                                               cs[col + 1]),
                                     ts[col + 1])
                         : 0.f;
    if (out_bf16) {
      __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(y) + row * co + col;
      if (pairs && two) {
        *reinterpret_cast<__nv_bfloat162*>(yb) =
            __halves2bfloat162(__float2bfloat16_rn(v0),
                               __float2bfloat16_rn(v1));
      } else {
        yb[0] = __float2bfloat16_rn(v0);
        if (two) yb[1] = __float2bfloat16_rn(v1);
      }
    } else {
      float* yf = reinterpret_cast<float*>(y) + row * co + col;
      if (pairs && two) {
        *reinterpret_cast<float2*>(yf) = make_float2(v0, v1);
      } else {
        yf[0] = v0;
        if (two) yf[1] = v1;
      }
    }
  }
}

template <int BN, int STAGES>
int launch_wgmma(const int8_t* xq, const int8_t* wq, const float* cs,
                 const float* ts, void* y, int* ws, int* counters,
                 int out_bf16, int n, int h, int wd, int ci, int co, int kp,
                 int ks, int stride, int ho, int wo, int pad_top,
                 int pad_left, int sps, dim3 grid, cudaStream_t stream) {
  static int allowed[tc::MAX_DEVICES] = {};
  auto kernel = conv_int8_wgmma_kernel<BN, STAGES>;
  const int bytes = Smem<BN, STAGES>::bytes(sps);
  int err = tc::allow_smem((const void*)kernel, bytes, allowed);
  if (err != 0) return err;
  kernel<<<grid, THREADS, bytes, stream>>>(
      xq, wq, cs, ts, y, ws, counters, out_bf16, n, h, wd, ci, co, kp, ks,
      stride, ho, wo, pad_top, pad_left, sps);
  return 0;
}

template <int STAGES>
int launch_bn(int config, const int8_t* xq, const int8_t* wq,
              const float* cs, const float* ts, void* y, int* ws,
              int* counters, int out_bf16, int n, int h, int wd, int ci,
              int co, int kp, int ks, int stride, int ho, int wo,
              int pad_top, int pad_left, int sps, dim3 grid,
              cudaStream_t stream) {
  switch (config) {
    case 0:     // 4 slots of 48 KB fill the shared memory
      if constexpr (STAGES == 4)
        return launch_wgmma<256, STAGES>(
            xq, wq, cs, ts, y, ws, counters, out_bf16, n, h, wd, ci, co, kp,
            ks, stride, ho, wo, pad_top, pad_left, sps, grid, stream);
      break;
    case 1:
      return launch_wgmma<128, STAGES>(
          xq, wq, cs, ts, y, ws, counters, out_bf16, n, h, wd, ci, co, kp,
          ks, stride, ho, wo, pad_top, pad_left, sps, grid, stream);
    case 2:
      return launch_wgmma<64, STAGES>(
          xq, wq, cs, ts, y, ws, counters, out_bf16, n, h, wd, ci, co, kp,
          ks, stride, ho, wo, pad_top, pad_left, sps, grid, stream);
    case 3:
      return launch_wgmma<32, STAGES>(
          xq, wq, cs, ts, y, ws, counters, out_bf16, n, h, wd, ci, co, kp,
          ks, stride, ho, wo, pad_top, pad_left, sps, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------------
// the first kernel (before the wgmma redesign), kept for chip_smoke.py's
// before/after timing only
namespace before {

constexpr int BK = 32;            // bytes of K a slice (one m16n8k32 step)
constexpr int PITCH = BK + 16;    // shared-memory row, bytes
constexpr int STAGES = 2;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of x -> int8 values at dst
__device__ __forceinline__ void quant_chunk(const uint4& v, float sx,
                                            int8_t* dst, float) {
  *reinterpret_cast<uint32_t*>(dst) = quant_f32x4(v, sx);
}
__device__ __forceinline__ void quant_chunk(const uint4& v, float sx,
                                            int8_t* dst, __nv_bfloat16) {
  uint2 p;
  p.x = quant_bf16x4(v.x, v.y, sx);
  p.y = quant_bf16x4(v.z, v.w, sx);
  *reinterpret_cast<uint2*>(dst) = p;
}

template <typename T, int KS, int STRIDE, bool RING, class TL>
__global__ void __launch_bounds__(tc::THREADS)
conv_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ cs, const float* __restrict__ ts,
                 void* __restrict__ y, int out_bf16, int n, int h, int wd,
                 int ci, int co, int kp, int ho, int wo, float sx) {
  constexpr int PAD = KS == 3 ? 1 : 0;
  constexpr int BN = TL::BN;
  __shared__ __align__(16) int8_t as[STAGES][tc::BM * PITCH];
  __shared__ __align__(16) int8_t bs[STAGES][BN * PITCH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int64_t m_total = (int64_t)n * ho * wo;
  const int64_t m0 = (int64_t)blockIdx.x * tc::BM;
  const int c0 = blockIdx.y * BN;
  const int slices = kp / BK;

  // ring route: 16-byte chunks of CE elements, CPR a row of the slice;
  // this thread's chunk a_chunk of rows a_row + RSTEP * r
  constexpr int CE = 16 / (int)sizeof(T);
  constexpr int CPR = BK / CE;
  constexpr int RPT = tc::BM * CPR / tc::THREADS;
  constexpr int RSTEP = tc::THREADS / CPR;
  const int a_chunk = tid % CPR, a_row = tid / CPR;
  int64_t a_pix[RPT];
  int a_hi[RPT], a_wi[RPT];
  bool a_ok[RPT];
  uint4 regs[RPT];
  int l_c = 0, l_kx = 0, l_ky = 0;     // the next slice to load
  if (RING) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int64_t m = m0 + a_row + RSTEP * r;
      a_ok[r] = m < m_total;
      const int64_t mm = a_ok[r] ? m : 0;
      const int wo_i = (int)(mm % wo);
      const int64_t t = mm / wo;
      const int ho_i = (int)(t % ho);
      const int64_t nn = t / ho;
      a_hi[r] = ho_i * STRIDE - PAD;
      a_wi[r] = wo_i * STRIDE - PAD;
      a_pix[r] = (nn * h + a_hi[r]) * wd + a_wi[r];
    }
  }
  auto load_regs = [&]() {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int hi = a_hi[r] + l_ky, wi = a_wi[r] + l_kx;
      const bool ok = a_ok[r] && hi >= 0 && hi < h && wi >= 0 && wi < wd;
      regs[r] = ok ? *reinterpret_cast<const uint4*>(
                         x + (a_pix[r] + l_ky * wd + l_kx) * ci + l_c
                         + a_chunk * CE)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    l_c += BK;
    if (l_c == ci) {
      l_c = 0;
      if (++l_kx == KS) {
        l_kx = 0;
        ++l_ky;
      }
    }
  };
  // gather route: this thread's column k of the slice, rows warp + 8 i
  auto gather_slice = [&](int kt, int8_t* a) {
    const int k = lane, kk = kt * BK + k;
    const bool k_ok = kk < KS * KS * ci;
    int c = 0, ky = 0, kx = 0;
    if (k_ok) {
      c = kk % ci;
      const int tap = kk / ci;
      kx = tap % KS;
      ky = tap / KS;
    }
    for (int r = warp; r < tc::BM; r += tc::THREADS / 32) {
      const int64_t m = m0 + r;
      float v = 0.f;
      if (k_ok && m < m_total) {
        const int wo_i = (int)(m % wo);
        const int64_t t = m / wo;
        const int ho_i = (int)(t % ho);
        const int64_t nn = t / ho;
        const int hi = ho_i * STRIDE - PAD + ky, wi = wo_i * STRIDE - PAD + kx;
        if (hi >= 0 && hi < h && wi >= 0 && wi < wd)
          v = to_f32(x[((nn * h + hi) * wd + wi) * ci + c]);
      }
      a[r * PITCH + k] = (int8_t)quant(v, sx);
    }
  };
  // B: BN weight rows of the slice, two 16-byte chunks a row
  auto copy_b = [&](int kt, int8_t* b) {
    for (int i = tid; i < BN * 2; i += tc::THREADS) {
      const int r = i >> 1, half = i & 1;
      const bool ok = c0 + r < co;
      tc::cp_async16(b + r * PITCH + half * 16,
                     ok ? wq + (int64_t)(c0 + r) * kp + kt * BK + half * 16
                        : wq,
                     ok);
    }
  };

  int acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  if (RING) load_regs();
  for (int kt = 0; kt < slices; ++kt) {
    // stage kt & 1 was last read by slice kt - 2, before every thread
    // passed the __syncthreads of slice kt - 1
    int8_t* a = as[kt & 1];
    int8_t* b = bs[kt & 1];
    if (RING) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        quant_chunk(regs[r], sx, a + (a_row + RSTEP * r) * PITCH
                                     + a_chunk * CE, T());
    } else {
      gather_slice(kt, a);
    }
    copy_b(kt, b);
    tc::cp_async_commit();
    if (RING && kt + 1 < slices) load_regs();   // in flight over the mma
    tc::cp_async_wait<0>();
    __syncthreads();
    uint32_t af[TL::MI][4];
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi)
      tc::ldsm_x4(af[mi], a + (wm * TL::WTM + mi * 16 + (lane & 15)) * PITCH
                              + (lane >> 4) * 16);
#pragma unroll
    for (int nj = 0; nj < TL::NI / 2; ++nj) {
      uint32_t bf[4];
      tc::ldsm_x4(bf, b + (wn * TL::WTN + nj * 16 + (lane >> 4) * 8
                           + (lane & 7)) * PITCH
                          + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi) {
        mma_s8(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
        mma_s8(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
      }
    }
  }

  // epilogue: rows g and g + 8 of each fragment, columns 2t, 2t + 1
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int64_t m = m0 + wm * TL::WTM + mi * 16 + g + 8 * h2;
      if (m >= m_total) continue;
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni) {
        const int col = c0 + wn * TL::WTN + ni * 8 + 2 * tq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j >= co) continue;
          const float v = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * h2 + j]),
                        cs[col + j]),
              ts[col + j]);
          if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(y)[m * co + col + j] =
                __float2bfloat16_rn(v);
          else
            reinterpret_cast<float*>(y)[m * co + col + j] = v;
        }
      }
    }
  }
}

template <typename T, int KS, int STRIDE, bool RING>
int launch_tile(const void* x, const int8_t* wq, const float* cs,
                const float* ts, void* y, int out_bf16, int n, int h, int wd,
                int ci, int co, int kp, float sx, int config, dim3 grid,
                cudaStream_t stream) {
  const int ho = h / STRIDE, wo = wd / STRIDE;
  const T* xt = static_cast<const T*>(x);
  switch (config) {
    case 0:
      conv_int8_kernel<T, KS, STRIDE, RING, tc::Tile128>
          <<<grid, tc::THREADS, 0, stream>>>(xt, wq, cs, ts, y, out_bf16, n,
                                             h, wd, ci, co, kp, ho, wo, sx);
      return 0;
    case 1:
      conv_int8_kernel<T, KS, STRIDE, RING, tc::Tile64>
          <<<grid, tc::THREADS, 0, stream>>>(xt, wq, cs, ts, y, out_bf16, n,
                                             h, wd, ci, co, kp, ho, wo, sx);
      return 0;
    case 2:
      conv_int8_kernel<T, KS, STRIDE, RING, tc::Tile32>
          <<<grid, tc::THREADS, 0, stream>>>(xt, wq, cs, ts, y, out_bf16, n,
                                             h, wd, ci, co, kp, ho, wo, sx);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int KS, int STRIDE>
int launch_route(const void* x, const int8_t* wq, const float* cs,
                 const float* ts, void* y, int out_bf16, int n, int h,
                 int wd, int ci, int co, int kp, float sx, int ring,
                 int config, dim3 grid, cudaStream_t stream) {
  if (ring) {
    // a slice inside one tap, 16-byte chunks of x
    if (ci % BK || kp != KS * KS * ci) return (int)cudaErrorInvalidValue;
    return launch_tile<T, KS, STRIDE, true>(x, wq, cs, ts, y, out_bf16, n, h,
                                            wd, ci, co, kp, sx, config, grid,
                                            stream);
  }
  if (kp != (KS * KS * ci + BK - 1) / BK * BK)
    return (int)cudaErrorInvalidValue;
  return launch_tile<T, KS, STRIDE, false>(x, wq, cs, ts, y, out_bf16, n, h,
                                           wd, ci, co, kp, sx, config, grid,
                                           stream);
}

template <int KS, int STRIDE>
int launch_geom(const void* x, const int8_t* wq, const float* cs,
                const float* ts, void* y, int in_bf16, int out_bf16, int n,
                int h, int wd, int ci, int co, int kp, float sx, int ring,
                int config, dim3 grid, cudaStream_t stream) {
  if (in_bf16)
    return launch_route<__nv_bfloat16, KS, STRIDE>(
        x, wq, cs, ts, y, out_bf16, n, h, wd, ci, co, kp, sx, ring, config,
        grid, stream);
  return launch_route<float, KS, STRIDE>(x, wq, cs, ts, y, out_bf16, n, h,
                                         wd, ci, co, kp, sx, ring, config,
                                         grid, stream);
}

}  // namespace before

}  // namespace

// The geometry of a ksize x ksize conv of stride `stride` with output
// (ho, wo) and top / left pad (pad_top, pad_left) that the kernels take.
static bool geometry_ok(int ksize, int stride, int ho, int wo, int pad_top,
                        int pad_left) {
  return ksize >= 1 && ksize <= 7 && (stride == 1 || stride == 2) && ho >= 1
         && wo >= 1 && pad_top >= 0 && pad_top < ksize && pad_left >= 0
         && pad_left < ksize;
}

// The quantize pass: x (N, H, W, Ci), bf16 if in_dtype is 1 else f32,
// 16-byte aligned.  im2col 0: xq the int8 copy of x (the ring route);
// im2col 1: xq the (M, kp) int8 rows, M = n * ho * wo, of the implicit
// GEMM of the ksize x ksize, stride conv with top / left pad (pad_top,
// pad_left) (the gather route), 16-byte aligned.  Clears counters[0 ..
// ncounters).  Returns the cudaError_t of the launch.
extern "C" int conv_int8_quantize_launch(const void* x, void* xq, int n,
                                         int h, int wd, int ci, int ksize,
                                         int stride, int ho, int wo,
                                         int pad_top, int pad_left, int kp,
                                         int im2col, int in_dtype, float sx,
                                         void* counters, int ncounters,
                                         void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || n < 1 || h < 1 || wd < 1 || ci < 1
      || ncounters < 0 || (ncounters > 0 && counters == nullptr)
      || !(sx > 0.f) || kp % 16 || kp < ksize * ksize * ci
      || !geometry_ok(ksize, stride, ho, wo, pad_top, pad_left))
    return (int)cudaErrorInvalidValue;
  const int64_t numel = (int64_t)n * h * wd * ci;
  const int64_t rows = (int64_t)n * ho * wo;
  int64_t work = im2col ? rows : numel / 8;
  if (work < ncounters) work = ncounters;
  int64_t blocks = (work + 255) / 256;       // grid-stride beyond 8 a SM
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* q = static_cast<int8_t*>(xq);
  int* cnt = static_cast<int*>(counters);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (im2col && in_dtype == 1)
    quantize_im2col_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        xb, q, n, h, wd, ci, ksize, stride, ho, wo, pad_top, pad_left, kp,
        sx, cnt, ncounters);
  else if (im2col)
    quantize_im2col_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        xf, q, n, h, wd, ci, ksize, stride, ho, wo, pad_top, pad_left, kp,
        sx, cnt, ncounters);
  else if (in_dtype == 1)
    quantize_int8_kernel<<<(unsigned)blocks, 256, 0, s>>>(xb, q, numel, sx, cnt,
                                                ncounters);
  else
    quantize_int8_kernel<<<(unsigned)blocks, 256, 0, s>>>(xf, q, numel, sx, cnt,
                                                ncounters);
  return (int)cudaGetLastError();
}

// The int8 conv on the quantized input xq (N, H, W, Ci) int8, Ci % 16 ==
// 0 (a 16-byte chunk inside one tap; the gather route passes its (M, kp)
// rows as N = H = 1, W = M, Ci = kp, a 1x1 conv), output (N, ho, wo, co)
// with top / left pad (pad_top, pad_left).  wq is the (co, kp) int8
// weight matrix, cs and ts the f32 affine of co entries; out_dtype 0 =
// float32, 1 = bfloat16.  config 0/1/2/3 is the tile of 256/128/64/32
// channels, stages the ring's slots (4 or 6; 4 for 256); grid (ceil(M /
// 128), ceil(co / BN),
// splits) with splits dividing ceil(kp / 128).  With splits > 1, ws holds
// (splits, M, co) int32 and counters grid_x * grid_y zeros (the quantize
// pass clears them; the kernel leaves them cleared).  xq, wq, ws and y
// 16-byte aligned.  The plan comes from ops/kernels/conv_int8._plan.
// Returns the cudaError_t of the launch.
extern "C" int conv_int8_launch(const void* xq, const void* wq,
                                const void* cs, const void* ts, void* y,
                                void* ws, void* counters, int n, int h,
                                int wd, int ci, int co, int kp, int ksize,
                                int stride, int ho, int wo, int pad_top,
                                int pad_left, int out_dtype, int config,
                                int stages, int grid_x, int grid_y,
                                int splits, void* stream) {
  const int slices = (kp + wg::SLICE - 1) / wg::SLICE;
  if (!geometry_ok(ksize, stride, ho, wo, pad_top, pad_left)
      || out_dtype < 0 || out_dtype > 1 || config < 0 || config > 3
      || kp != (ksize * ksize * ci + 31) / 32 * 32 || ci % 16 || splits < 1
      || slices % splits
      || (splits > 1 && (ws == nullptr || counters == nullptr))
      || (stages != 4 && stages != 6))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y, (unsigned)splits);
  const int8_t* q = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* c = static_cast<const float*>(cs);
  const float* t = static_cast<const float*>(ts);
  int* part = static_cast<int*>(ws);
  int* cnt = static_cast<int*>(counters);
  const int sps = slices / splits;
  const int err =
      stages == 4
          ? wg::launch_bn<4>(config, q, w, c, t, y, part, cnt, out_dtype, n,
                             h, wd, ci, co, kp, ksize, stride, ho, wo,
                             pad_top, pad_left, sps, grid, s)
          : wg::launch_bn<6>(config, q, w, c, t, y, part, cnt, out_dtype, n,
                             h, wd, ci, co, kp, ksize, stride, ho, wo,
                             pad_top, pad_left, sps, grid, s);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The first kernel, quantizing in its prologue (chip_smoke.py's "before"
// column).  in_dtype / out_dtype: 0 = float32, 1 = bfloat16.  ring 1 takes
// Ci % 32 == 0 (kp = ks*ks*Ci) with x 16-byte aligned; ring 0 gathers x
// element by element.  config 0/1/2 is the tile of 128/64/32 channels;
// grid (ceil(M / 128), ceil(co / BN)) from ops/kernels/conv_int8.
// _before_plan.  Returns the cudaError_t of the launch.
extern "C" int conv_int8_before_launch(const void* x, const void* wq,
                                       const void* cs, const void* ts,
                                       void* y, int n, int h, int wd, int ci,
                                       int co, int kp, int ksize, int stride,
                                       int in_dtype, int out_dtype, float sx,
                                       int ring, int config, int grid_x,
                                       int grid_y, void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1
      || config < 0 || config > 2 || !(sx > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* c = static_cast<const float*>(cs);
  const float* t = static_cast<const float*>(ts);
  int err;
  if (ksize == 1 && stride == 1)
    err = before::launch_geom<1, 1>(x, w, c, t, y, in_dtype, out_dtype, n,
                                    h, wd, ci, co, kp, sx, ring, config,
                                    grid, s);
  else if (ksize == 3 && stride == 1)
    err = before::launch_geom<3, 1>(x, w, c, t, y, in_dtype, out_dtype, n,
                                    h, wd, ci, co, kp, sx, ring, config,
                                    grid, s);
  else if (ksize == 3 && stride == 2)
    err = before::launch_geom<3, 2>(x, w, c, t, y, in_dtype, out_dtype, n,
                                    h, wd, ci, co, kp, sx, ring, config,
                                    grid, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
