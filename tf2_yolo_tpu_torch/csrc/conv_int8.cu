// Static-scale int8 convolution (implicit GEMM, NHWC) with a quantizing
// prologue and a dequantize + BatchNorm affine epilogue:
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
// Geometry: 1x1 stride 1; 3x3 stride 1 SAME; 3x3 stride 2 with the darknet
// top/left pad then VALID (H, W even): input row ho*stride - 1 + ky, column
// wo*stride - 1 + kx, zero outside the image (a zero quantizes to zero, so
// the padding is exact).  K = ks*ks*Ci in the HWIO order (ky, kx, c),
// zero-padded to kp, a multiple of 32.  The weights come as the (Co, kp)
// int8 matrix, row-major (ops/kernels/conv_int8.weight_layout): the "col"
// B operand of mma.sync, read as 16-byte rows.
//
// A block computes 128 output pixels x BN (128, 64 or 32) channels with 8
// warps (the tc::Tile shapes of conv_mma.cuh), one 32-deep slice of K at a
// time, in two shared-memory stages:
// * A, the ring route (Ci % 32 == 0: a slice lies in one tap): each thread
//   loads 16-byte chunks of x for its rows (2 rows of 8 bf16, or 4 rows of
//   4 f32) into registers one slice ahead, and quantizes them into the
//   stage as int8 (rintf of the correctly rounded division: round half to
//   even, as jnp.round and torch.round; no reciprocal);
// * A, the gather route (other Ci: the stem, Ci = 3, K = 27 in one slice):
//   element by element, each thread one column k of the slice;
// * B: 16-byte cp.async copies of the weight rows (zero past Co);
// * one mma.sync.m16n8k32 s8 step a slice per fragment pair, fed by
//   ldmatrix from 48-byte rows (the 8 rows of a matrix fall on distinct
//   banks), one __syncthreads a slice;
// * epilogue straight from the accumulators: __int2float_rn, __fmul_rn,
//   __fadd_rn (no FMA contraction, so the plain version's two separate ops
//   give the same bits), one rounding to the output dtype.
//
// What bounds it on an H100: int8 tensor cores peak at 1979 TOP/s dense, so
// every YOLOv4 layer is bound by its bytes (x read in bf16/f32, y written)
// at 3.35 TB/s, except the 3x3 layers at 26^2 and below with Ci >= 256.
// This first kernel is simple: mma.sync with a two-stage ring, no wgmma or
// TMA, and the quantize is recomputed for each of the ks*ks taps that read
// an input pixel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

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

// clamp(rint(v / sx), -127, 127) as the low byte of a word
__device__ __forceinline__ uint32_t quant(float v, float sx) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
  return (uint32_t)(int)q & 0xffu;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of x -> int8 values at dst
__device__ __forceinline__ void quant_chunk(const uint4& v, float sx,
                                            int8_t* dst, float) {
  *reinterpret_cast<uint32_t*>(dst) =
      quant(__uint_as_float(v.x), sx) | quant(__uint_as_float(v.y), sx) << 8
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

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16.  wq is the (co, kp) int8
// weight matrix, cs and ts the f32 affine of co entries, sx the input scale.
// ring 1 takes Ci % 32 == 0 (kp = ks*ks*Ci) with x 16-byte aligned; ring 0
// gathers x element by element (kp = ks*ks*Ci rounded up to 32).  config
// 0/1/2 is the tile of 128/64/32 channels; grid (ceil(M / 128), ceil(co /
// BN)) comes from the Python plan (ops/kernels/conv_int8._plan).  wq must
// be 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int conv_int8_launch(const void* x, const void* wq, const void* cs,
                                const void* ts, void* y, int n, int h, int wd,
                                int ci, int co, int kp, int ksize, int stride,
                                int in_dtype, int out_dtype, float sx,
                                int ring, int config, int grid_x, int grid_y,
                                void* stream) {
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
    err = launch_geom<1, 1>(x, w, c, t, y, in_dtype, out_dtype, n, h, wd, ci,
                            co, kp, sx, ring, config, grid, s);
  else if (ksize == 3 && stride == 1)
    err = launch_geom<3, 1>(x, w, c, t, y, in_dtype, out_dtype, n, h, wd, ci,
                            co, kp, sx, ring, config, grid, s);
  else if (ksize == 3 && stride == 2)
    err = launch_geom<3, 2>(x, w, c, t, y, in_dtype, out_dtype, n, h, wd, ci,
                            co, kp, sx, ring, config, grid, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
