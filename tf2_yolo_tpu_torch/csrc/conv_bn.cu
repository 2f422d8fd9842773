// Direct NHWC convolution (implicit GEMM) with an optional per-channel
// statistics epilogue: y = conv(x, w) + b rounded to the output type,
// s1 = sum(y), s2 = sum(y^2) over N*H*W of the ROUNDED y, accumulated in
// f64.
//
// Replaces the Pallas TPU kernels conv1x1_stats (_conv1x1_stats_fwd_impl)
// and conv3x3_stats (_conv3x3_stats_fwd_impl) of
// tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py, forward only.
//
// Geometry: KS x KS stride STRIDE for (KS, STRIDE) = (1, 1), (1, 2),
// (3, 1), (3, 2), (7, 2) and (2, 1), with the top and left pad and the
// output size Ho x Wo given at run time (ops/kernels/conv_bn.py,
// conv_geometry):
// output pixel (ho, wo) reads input row ho*STRIDE - pad_top + ky and
// column wo*STRIDE - pad_left + kx, zero outside the image.  That is
// the darknet stride-2 pad (pad 1, Ho = H/2 on even H: the bottom/right
// pad is never touched) and flax's SAME (the smaller half of the pad on
// top and left, Ho = ceil(H/STRIDE): the YOLOv1 stem's 7x7 stride 2 pads
// 2 above and 3 below at 448^2, its 3x3 stride 2 0 and 1 at 14^2, the
// UNet's 2x2 0 and 1), 1x1 stride 2 (pad 0: the ring's rows are the
// input pixels (n, 2 ho, 2 wo), read where they stand) and an explicit
// pad on every side (the ResNet stem: 3, then its 7x7 stride-2 window);
// the rows below the image are the bounds check.
//
// GEMM view: M = N*Ho*Wo output pixels, Co columns, K = ks*ks*Ci.  The
// HWIO weight tensor is already the row-major (K, Co) B matrix.  Three
// kernels compute it, chosen per shape by the Python plan
// (ops/kernels/conv_bn.py, _tc_plan), which passes the tile config, the
// grid and the dynamic shared memory:
//
// * conv_bn_stats_tc_kernel, bf16 with Ci % 32 == 0 and Co % 8 == 0
//   (every conv of YOLOv4 but the stem): tensor cores.  A block computes
//   128 output pixels x BN (128, 64 or 32) channels with 8 warps; each
//   32-deep slice of K lies inside one tap, so a row's (n, hi, wi) is
//   computed once per block and the tap once per slice.  A ring of 4
//   stages of 16-byte cp.async copies (8 channels of one pixel at one
//   tap; a pixel outside the image is zero-filled by a source size of 0,
//   which is the halo) feeds ldmatrix and mma.sync m16n8k16 (bf16 in
//   shared memory, f32 accumulators), with one __syncthreads per slice.
//   Epilogue in conv_mma.cuh: bias in f32, one rounding to bf16, 16-byte
//   stores through shared memory, statistics of the rounded values.
// * conv_bn_stats_ic_kernel, bf16 3x3 stride 1 or 2 or 7x7 stride 2 with
//   Ci < 32 and Co % 8 == 0 (the stems, Ci = 3: a pixel is 6 bytes, no
//   16-byte rows): tensor cores through an im2col in shared memory.  A
//   block takes an 8 x 16 tile of output pixels of one image and BN
//   (128, 64 or 32) channels: it copies the tile's input halo, (8 - 1)
//   STRIDE + KS x (16 - 1) STRIDE + KS pixels (10 x 18 at 3x3 s1, 17 x 33
//   at 3x3 s2, 21 x 37 at 7x7 s2), once (2-byte loads of each halo row's
//   contiguous span, zero outside the image), builds the A tile [128
//   pixels][K] with K = KS^2 Ci rounded up to 32 (zero columns past KS^2
//   Ci; 27 -> 32, 147 -> 160) from it through a table of tap offsets,
//   copies the weights [K][BN] (zero rows past KS^2 Ci) with 16-byte
//   cp.async, runs K / 16 mma.sync steps and the same epilogue.
// * conv_bn_stats_kernel, f32 (the tensor cores' f32 route would be TF32)
//   and bf16 shapes no tensor-core kernel takes: 64 x 64 tiles on the
//   CUDA cores, a BK = 16 slice gathered element by element (zero-filled
//   halo) into f32 shared memory, a 4 x 4 FMA micro-tile per thread.
//
// What bounds it on an H100: the tensor-core kernel is bound by
// operations for the 3x3 layers at 52^2 and below with Ci >= 128 (K =
// 1152-4608), where mma.sync reaches a fraction of the 989 TFLOP/s that
// wgmma could, and by bytes for the 1x1 layers and the wide early layers
// (the A operand is re-read ks*ks times, through L2).  The small-Ci
// kernel is bound by the bytes of y (the stem writes 32 channels for 3
// it reads: 354 MB of y against 33 MB of x at batch 32).  The CUDA-core
// kernel is bound by the f32 FMA rate (67 TFLOP/s peak).
//
// Statistics: the TPU kernel carries s1/s2 across its sequential grid.
// Blocks here run in parallel in no order, so each block reduces its
// tile's columns in f32 and adds them with one f64 atomicAdd per column
// and block.  A training batch sums millions of rows per channel (5.5e6
// in the stem at batch 32) over tens of thousands of blocks, and the
// variance s2/M - mean^2 cancels: f32 atomics lost 8e-6 of sum(y^2)
// there, f64 ones lose nothing that shows after the wrapper rounds the
// sums to f32, whatever the block order.  STATS is a template flag, so
// the served forward (want_stats = 0) carries no reduction and no
// atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int KS, int STRIDE, bool STATS>
__global__ void __launch_bounds__(THREADS)
conv_bn_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ y,
                     double* __restrict__ s1, double* __restrict__ s2,
                     int n, int h, int wd, int ci, int co, int ho, int wo,
                     int pad_top, int pad_left) {
  // +4 floats per row: the gather writes column-wise, and the pad
  // spreads its 16 k-rows over the banks; rows stay 16-byte aligned
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int64_t m_total = (int64_t)n * ho * wo;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int k_total = KS * KS * ci;

  // A loads: thread owns k-lane (tid % BK) and 4 rows (tid / BK) + 16*r,
  // so 16 neighbouring threads read 16 neighbouring input channels.
  const int a_k = tid % BK;
  const int a_m = tid / BK;               // 0..15
  int a_n[4], a_hi[4], a_wi[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int64_t m = m0 + a_m + 16 * r;
    a_ok[r] = m < m_total;
    int64_t mm = a_ok[r] ? m : 0;
    int wo_i = (int)(mm % wo);
    int64_t t = mm / wo;
    int ho_i = (int)(t % ho);
    a_n[r] = (int)(t / ho);
    a_hi[r] = ho_i * STRIDE - pad_top;
    a_wi[r] = wo_i * STRIDE - pad_left;
  }
  // B loads: thread owns column (tid % BN) and 4 k-rows (tid / BN) * 4 + r.
  const int b_c = tid % BN;
  const int b_k = (tid / BN) * 4;

  // micro-tile of this thread
  const int ty = tid / 16;                // rows ty*4 .. +3
  const int tx = tid % 16;                // cols tx*4 .. +3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    // gather A (input pixels, zero outside the image)
    {
      int kk = k0 + a_k;
      int c = 0, ky = 0, kx = 0;
      bool k_ok = kk < k_total;
      if (k_ok) {
        c = kk % ci;
        int r = kk / ci;
        kx = r % KS;
        ky = r / KS;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = 0.f;
        int hi = a_hi[r] + ky;
        int wi = a_wi[r] + kx;
        if (k_ok && a_ok[r] && hi >= 0 && hi < h && wi >= 0 && wi < wd) {
          v = to_f32(x[(((int64_t)a_n[r] * h + hi) * wd + wi) * ci + c]);
        }
        As[a_k][a_m + 16 * r] = v;
      }
    }
    // load B (weights, HWIO == row-major (K, Co))
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int kk = k0 + b_k + r;
      int cc = c0 + b_c;
      float v = 0.f;
      if (kk < k_total && cc < co) v = to_f32(w[(int64_t)kk * co + cc]);
      Bs[b_k + r][b_c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      float4 bb = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias, round to T, store; statistics of the rounded values
  float p1[4] = {0.f, 0.f, 0.f, 0.f};
  float p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int cc = c0 + tx * 4 + j;
    if (cc >= co) continue;
    float bias = to_f32(b[cc]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int64_t m = m0 + ty * 4 + i;
      if (m >= m_total) continue;
      T yr = from_f32<T>(acc[i][j] + bias);
      y[m * co + cc] = yr;
      if (STATS) {
        float yv = to_f32(yr);
        p1[j] += yv;
        p2[j] += yv * yv;
      }
    }
  }
  if (STATS) {
    // reduce the 16 row-groups of each column in shared memory (the
    // main loop's last __syncthreads has released As/Bs), then one
    // atomicAdd per column and block
    float (*r1)[BM + 4] = As;             // [16][BM + 4], BM == BN
    float (*r2)[BN] = Bs;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r1[ty][tx * 4 + j] = p1[j];
      r2[ty][tx * 4 + j] = p2[j];
    }
    __syncthreads();
    if (tid < BN && c0 + tid < co) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        t1 += r1[r][tid];
        t2 += r2[r][tid];
      }
      atomicAdd(&s1[c0 + tid], (double)t1);
      atomicAdd(&s2[c0 + tid], (double)t2);
    }
  }
}

// The output size and the top/left pad of one launch (conv_geometry).
struct Geom {
  int ho, wo, pad_top, pad_left;
};

template <typename T, int KS, int STRIDE>
void launch(const void* x, const void* w, const void* b, void* y, double* s1,
            double* s2, int n, int h, int wd, int ci, int co, Geom g,
            int want_stats, dim3 grid, cudaStream_t stream) {
  if (want_stats) {
    conv_bn_stats_kernel<T, KS, STRIDE, true><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)y, s1, s2, n, h, wd, ci,
        co, g.ho, g.wo, g.pad_top, g.pad_left);
  } else {
    conv_bn_stats_kernel<T, KS, STRIDE, false><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)y, s1, s2, n, h, wd, ci,
        co, g.ho, g.wo, g.pad_top, g.pad_left);
  }
}

// ------------------------------------------------ tensor cores (bf16)

// the ring's slices (tc::Ring): 32 deep, inside one tap (Ci % 32 == 0)
constexpr int TC_BK = tc::RING_BK;
constexpr int TC_STAGES = tc::RING_STAGES;
constexpr int TC_APITCH = tc::RING_APITCH;
// configs 0-2 of the plan: the ring kernel's tiles; 3-5 the small-Ci
// kernel's (Tile128, Tile64, Tile32)
constexpr int IC_CONFIG = 3;

template <int KS, int STRIDE, bool STATS, class TL>
__global__ void __launch_bounds__(tc::THREADS)
conv_bn_stats_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ y,
                        double* __restrict__ s1, double* __restrict__ s2,
                        int n, int h, int wd, int ci, int co, int ho,
                        int wo, int pad_top, int pad_left) {
  using SM = tc::Ring<TL>;
  constexpr int BN = TL::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int64_t m_total = (int64_t)n * ho * wo;
  const int64_t m0 = (int64_t)blockIdx.x * tc::BM;
  const int c0 = blockIdx.y * BN;
  const int slices = KS * KS * ci / TC_BK;

  // A copies: this thread's 16-byte chunk (tid % 4) of rows tid / 4 and
  // tid / 4 + 64; each row's first input pixel and window origin
  const int a_chunk = tid & 3;
  int64_t a_pix[2];
  int a_hi[2], a_wi[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int64_t m = m0 + (tid >> 2) + 64 * r;
    a_ok[r] = m < m_total;
    int64_t mm = a_ok[r] ? m : 0;
    int wo_i = (int)(mm % wo);
    int64_t t = mm / wo;
    int ho_i = (int)(t % ho);
    int64_t nn = t / ho;
    a_hi[r] = ho_i * STRIDE - pad_top;
    a_wi[r] = wo_i * STRIDE - pad_left;
    a_pix[r] = (nn * h + a_hi[r]) * wd + a_wi[r];
  }
  // position of the next slice to copy: channel base and tap
  int l_c = 0, l_kx = 0, l_ky = 0;
  auto copy_slice = [&](int stage) {
    __nv_bfloat16* as = ring + stage * SM::STAGE_ELEMS;
    __nv_bfloat16* bs = as + SM::A_ELEMS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hi = a_hi[r] + l_ky, wi = a_wi[r] + l_kx;
      const bool ok = a_ok[r] && hi >= 0 && hi < h && wi >= 0 && wi < wd;
      const __nv_bfloat16* src =
          ok ? x + (a_pix[r] + l_ky * wd + l_kx) * ci + l_c + a_chunk * 8 : x;
      tc::cp_async16(as + ((tid >> 2) + 64 * r) * TC_APITCH + a_chunk * 8,
                     src, ok);
    }
    const int64_t k_row = (int64_t)(l_ky * KS + l_kx) * ci + l_c;
    constexpr int B_CHUNKS = TC_BK * BN / 8;
#pragma unroll
    for (int i = tid; i < B_CHUNKS; i += tc::THREADS) {
      const int kr = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const bool ok = c0 + col < co;
      tc::cp_async16(bs + kr * SM::BPITCH + col,
                     ok ? w + (k_row + kr) * co + c0 + col : w, ok);
    }
    l_c += TC_BK;
    if (l_c == ci) {
      l_c = 0;
      if (++l_kx == KS) {
        l_kx = 0;
        ++l_ky;
      }
    }
  };

  float acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < slices) copy_slice(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    tc::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // slice kt has landed; slice kt - 1 is consumed
    if (kt + TC_STAGES - 1 < slices)
      copy_slice((kt + TC_STAGES - 1) % TC_STAGES);
    tc::cp_async_commit();
    const __nv_bfloat16* as = ring + (kt % TC_STAGES) * SM::STAGE_ELEMS;
    const __nv_bfloat16* bs = as + SM::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      const __nv_bfloat16* a_rows[TL::MI];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
        a_rows[mi] = as + (wm * TL::WTM + mi * 16 + (lane & 15)) * TC_APITCH
                     + kk + (lane >> 4) * 8;
      tc::mma_k16<TL>(acc, a_rows,
                      bs + (kk + (lane & 15)) * SM::BPITCH + wn * TL::WTN
                          + (lane >> 4) * 8);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  tc::store_tile<TL, STATS>(
      acc, smem, b, c0, co,
      [&](int r) -> int64_t {
        int64_t m = m0 + r;
        return m < m_total ? m * co : -1;
      },
      y, s1, s2);
}

template <int KS, int STRIDE, bool STATS, class TL>
int launch_tc(const void* x, const void* w, const void* b, void* y,
              double* s1, double* s2, int n, int h, int wd, int ci, int co,
              Geom g, dim3 grid, int smem_bytes, cudaStream_t stream) {
  // the plan's shared memory must be this config's
  if (smem_bytes != tc::Ring<TL>::BYTES || ci % TC_BK || co % 8)
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_bn_stats_tc_kernel<KS, STRIDE, STATS, TL>;
  static int allowed[tc::MAX_DEVICES] = {0};   // per instance and device
  int err = tc::allow_smem((const void*)kernel, smem_bytes, allowed);
  if (err != 0) return err;
  kernel<<<grid, tc::THREADS, smem_bytes, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)y, s1, s2, n, h, wd, ci, co,
      g.ho, g.wo, g.pad_top, g.pad_left);
  return 0;
}

template <int KS, int STRIDE, bool STATS>
int dispatch_tc(const void* x, const void* w, const void* b, void* y,
                double* s1, double* s2, int n, int h, int wd, int ci, int co,
                Geom g, int config, dim3 grid, int smem_bytes,
                cudaStream_t stream) {
  switch (config) {
    case 0:
      return launch_tc<KS, STRIDE, STATS, tc::Tile128>(
          x, w, b, y, s1, s2, n, h, wd, ci, co, g, grid, smem_bytes, stream);
    case 1:
      return launch_tc<KS, STRIDE, STATS, tc::Tile64>(
          x, w, b, y, s1, s2, n, h, wd, ci, co, g, grid, smem_bytes, stream);
    case 2:
      return launch_tc<KS, STRIDE, STATS, tc::Tile32>(
          x, w, b, y, s1, s2, n, h, wd, ci, co, g, grid, smem_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------- tensor cores, small Ci (bf16)

// The small-Ci kernel's output tile (8 x 16 = tc::BM pixels); its input
// halo is (IC_TH - 1) STRIDE + KS rows of (IC_TW - 1) STRIDE + KS pixels.
constexpr int IC_TH = 8;
constexpr int IC_TW = 16;

template <int KS, int STRIDE>
struct IcGeom {
  static constexpr int HH = (IC_TH - 1) * STRIDE + KS;
  static constexpr int HW = (IC_TW - 1) * STRIDE + KS;
  // K = KS^2 Ci rounded up to whole 32-deep slices
  __host__ __device__ static int kp(int ci) {
    return (KS * KS * ci + TC_BK - 1) / TC_BK * TC_BK;
  }
};

// Shared memory: the A tile [128][K + 8] (80-byte rows at K = 32, so the
// 8 rows of an ldmatrix hit 8 banks), the B tile [K][BN + 8], the halo
// [HH][HW Ci] (to 16 bytes) and the tap table [K] ints; or the
// epilogue's, whichever is larger (_ic_smem in ops/kernels/conv_bn.py).
template <int KS, int STRIDE, class TL>
struct IcSmem {
  using G = IcGeom<KS, STRIDE>;
  __host__ __device__ static int a_elems(int ci) {
    return tc::BM * (G::kp(ci) + 8);
  }
  __host__ __device__ static int b_elems(int ci) {
    return G::kp(ci) * (TL::BN + 8);
  }
  __host__ __device__ static int halo_bytes(int ci) {
    return (G::HH * G::HW * ci * 2 + 15) / 16 * 16;
  }
  __host__ __device__ static int main_bytes(int ci) {
    return (a_elems(ci) + b_elems(ci)) * 2 + halo_bytes(ci)
           + G::kp(ci) * 4;
  }
  static int bytes(int ci) {
    const int m = main_bytes(ci);
    return m > TL::EPI_BYTES ? m : TL::EPI_BYTES;
  }
};

// One block: output pixels (i0 .. i0 + 8) x (j0 .. j0 + 16) of image
// blockIdx.x / tiles, channels blockIdx.y * BN .. + BN.  The halo's row
// hy is input row i0 STRIDE - pad_top + hy, its column hx input column
// j0 STRIDE - pad_left + hx.  A[r][k] for tile pixel r = (ty, tx) and k =
// (ky KS + kx) Ci + c (the HWIO row order) is halo[ty STRIDE + ky][(tx
// STRIDE + kx) Ci + c]: for one ky the KS Ci values of a row are
// contiguous in the halo row, so the table holds ky * (halo pitch) + (k -
// KS Ci ky) per k, -1 past KS^2 Ci.
template <int KS, int STRIDE, bool STATS, class TL>
__global__ void __launch_bounds__(tc::THREADS)
conv_bn_stats_ic_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ y,
                        double* __restrict__ s1, double* __restrict__ s2,
                        int n, int h, int wd, int ci, int co, int ho, int wo,
                        int pad_top, int pad_left) {
  using SM = IcSmem<KS, STRIDE, TL>;
  using G = IcGeom<KS, STRIDE>;
  constexpr int BN = TL::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = G::kp(ci), k_real = KS * KS * ci;
  const int apitch = kp + 8, bpitch = BN + 8, hp = G::HW * ci;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + SM::a_elems(ci);
  __nv_bfloat16* halo = bs + SM::b_elems(ci);
  int* koff = reinterpret_cast<int*>(
      smem + (SM::a_elems(ci) + SM::b_elems(ci)) * 2 + SM::halo_bytes(ci));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int tiles_x = (wo + IC_TW - 1) / IC_TW;
  const int per_img = tiles_x * ((ho + IC_TH - 1) / IC_TH);
  const int img = blockIdx.x / per_img, rem = blockIdx.x % per_img;
  const int i0 = (rem / tiles_x) * IC_TH, j0 = (rem % tiles_x) * IC_TW;
  const int c0 = blockIdx.y * BN;

  // B: rows k < KS^2 Ci of w at columns c0 .., zero elsewhere
  for (int i = tid; i < kp * (BN / 8); i += tc::THREADS) {
    const int kr = i / (BN / 8), col = (i % (BN / 8)) * 8;
    const bool ok = kr < k_real && c0 + col < co;
    tc::cp_async16(bs + kr * bpitch + col,
                   ok ? w + (int64_t)kr * co + c0 + col : w, ok);
  }
  tc::cp_async_commit();
  for (int k = tid; k < kp; k += tc::THREADS) {
    int off = -1;
    if (k < k_real) {
      const int ky = k / (KS * ci);
      off = ky * hp + (k - ky * KS * ci);
    }
    koff[k] = off;
  }
  // halo row hy is input row iy0 + hy; its HW Ci elements are one
  // contiguous span of the input row from column jx0, of which [lo, hi)
  // lie inside the image
  const int iy0 = i0 * STRIDE - pad_top, jx0 = j0 * STRIDE - pad_left;
  const int lo = jx0 < 0 ? -jx0 * ci : 0;
  const int hi = (wd - jx0) * ci;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < G::HH * hp; i += tc::THREADS) {
    const int hy = i / hp, e = i - hy * hp;
    const int iy = iy0 + hy;
    __nv_bfloat16 v = zero;
    if (iy >= 0 && iy < h && e >= lo && e < hi)
      v = x[(((int64_t)img * h + iy) * wd + jx0) * ci + e];
    halo[i] = v;
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  // the im2col, two columns a thread at a time
  const int pairs = kp / 2;
  for (int p = tid; p < tc::BM * pairs; p += tc::THREADS) {
    const int r = p / pairs, k = 2 * (p - r * pairs);
    const int base = (r / IC_TW) * STRIDE * hp + (r % IC_TW) * STRIDE * ci;
    const int o0 = koff[k], o1 = koff[k + 1];
    __nv_bfloat162 v;
    v.x = o0 >= 0 ? halo[base + o0] : zero;
    v.y = o1 >= 0 ? halo[base + o1] : zero;
    *reinterpret_cast<__nv_bfloat162*>(as + r * apitch + k) = v;
  }
  __syncthreads();

  float acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  for (int kk = 0; kk < kp; kk += 16) {
    const __nv_bfloat16* a_rows[TL::MI];
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi)
      a_rows[mi] = as + (wm * TL::WTM + mi * 16 + (lane & 15)) * apitch + kk
                   + (lane >> 4) * 8;
    tc::mma_k16<TL>(acc, a_rows,
                    bs + (kk + (lane & 15)) * bpitch + wn * TL::WTN
                        + (lane >> 4) * 8);
  }
  __syncthreads();   // the epilogue reuses the A tile's memory
  tc::store_tile<TL, STATS>(
      acc, smem, b, c0, co,
      [&](int r) -> int64_t {
        const int i = i0 + r / IC_TW, j = j0 + r % IC_TW;
        return i < ho && j < wo ? (((int64_t)img * ho + i) * wo + j) * co
                                : -1;
      },
      y, s1, s2);
}

template <int KS, int STRIDE, bool STATS, class TL>
int launch_ic(const void* x, const void* w, const void* b, void* y,
              double* s1, double* s2, int n, int h, int wd, int ci, int co,
              Geom g, dim3 grid, int smem_bytes, cudaStream_t stream) {
  // the plan's shared memory must be this config's
  if (ci < 1 || ci >= TC_BK || co % 8
      || smem_bytes != IcSmem<KS, STRIDE, TL>::bytes(ci))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_bn_stats_ic_kernel<KS, STRIDE, STATS, TL>;
  static int allowed[tc::MAX_DEVICES] = {0};   // per instance and device
  int err = tc::allow_smem((const void*)kernel, smem_bytes, allowed);
  if (err != 0) return err;
  kernel<<<grid, tc::THREADS, smem_bytes, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)y, s1, s2, n, h, wd, ci, co,
      g.ho, g.wo, g.pad_top, g.pad_left);
  return 0;
}

template <int KS, int STRIDE, bool STATS>
int dispatch_ic(const void* x, const void* w, const void* b, void* y,
                double* s1, double* s2, int n, int h, int wd, int ci, int co,
                Geom g, int tile, dim3 grid, int smem_bytes,
                cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch_ic<KS, STRIDE, STATS, tc::Tile128>(
          x, w, b, y, s1, s2, n, h, wd, ci, co, g, grid, smem_bytes, stream);
    case 1:
      return launch_ic<KS, STRIDE, STATS, tc::Tile64>(
          x, w, b, y, s1, s2, n, h, wd, ci, co, g, grid, smem_bytes, stream);
    case 2:
      return launch_ic<KS, STRIDE, STATS, tc::Tile32>(
          x, w, b, y, s1, s2, n, h, wd, ci, co, g, grid, smem_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the small-Ci kernel is built for the stems' geometries only
template <int KS, int STRIDE>
constexpr bool has_ic = KS == 3 || (KS == 7 && STRIDE == 2);

template <int KS, int STRIDE>
int launch_geom(const void* x, const void* w, const void* b, void* y,
                double* s1, double* s2, int n, int h, int wd, int ci, int co,
                Geom g, int dtype, int want_stats, int config, dim3 grid,
                int smem_bytes, cudaStream_t stream) {
  if (config >= IC_CONFIG) {
    if constexpr (has_ic<KS, STRIDE>) {
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      return want_stats
                 ? dispatch_ic<KS, STRIDE, true>(
                       x, w, b, y, s1, s2, n, h, wd, ci, co, g,
                       config - IC_CONFIG, grid, smem_bytes, stream)
                 : dispatch_ic<KS, STRIDE, false>(
                       x, w, b, y, s1, s2, n, h, wd, ci, co, g,
                       config - IC_CONFIG, grid, smem_bytes, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (config >= 0) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return want_stats
               ? dispatch_tc<KS, STRIDE, true>(x, w, b, y, s1, s2, n, h, wd,
                                               ci, co, g, config, grid,
                                               smem_bytes, stream)
               : dispatch_tc<KS, STRIDE, false>(x, w, b, y, s1, s2, n, h, wd,
                                                ci, co, g, config, grid,
                                                smem_bytes, stream);
  }
  if (dtype == 0)
    launch<float, KS, STRIDE>(x, w, b, y, s1, s2, n, h, wd, ci, co, g,
                              want_stats, grid, stream);
  else if (dtype == 1)
    launch<__nv_bfloat16, KS, STRIDE>(x, w, b, y, s1, s2, n, h, wd, ci, co,
                                      g, want_stats, grid, stream);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  s1/s2 are zeroed f64 buffers of co
// entries, and may be null when want_stats == 0.  ho, wo, pad_top and
// pad_left are the geometry's (conv_geometry in ops/kernels/conv_bn.py).
// config, grid and smem_bytes come from the Python plan: config -1 runs
// the CUDA-core kernel (64 x 64 tiles, static shared memory), 0/1/2 the
// tensor-core kernel with BN = 128/64/32 (bf16 only) and smem_bytes of
// dynamic shared memory, 3/4/5 the small-Ci tensor-core kernel with BN =
// 128/64/32 (bf16 3x3 stride 1 or 2, 7x7 stride 2, Ci < 32; grid.x walks
// the 8 x 16 output pixel tiles of every image).  Tensor-core routes
// need w and y 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int conv_bn_stats_launch(const void* x, const void* w,
                                    const void* b, void* y, double* s1,
                                    double* s2, int n, int h, int wd, int ci,
                                    int co, int ho, int wo, int pad_top,
                                    int pad_left, int ksize, int stride,
                                    int dtype, int want_stats, int config,
                                    int grid_x, int grid_y, int smem_bytes,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const Geom g{ho, wo, pad_top, pad_left};
  if (ho < 1 || wo < 1 || pad_top < 0 || pad_left < 0 || pad_top >= ksize
      || pad_left >= ksize)
    return (int)cudaErrorInvalidValue;
  int err;
  if (ksize == 1 && stride == 1)
    err = launch_geom<1, 1>(x, w, b, y, s1, s2, n, h, wd, ci, co, g, dtype,
                            want_stats, config, grid, smem_bytes, s);
  else if (ksize == 1 && stride == 2)
    err = launch_geom<1, 2>(x, w, b, y, s1, s2, n, h, wd, ci, co, g, dtype,
                            want_stats, config, grid, smem_bytes, s);
  else if (ksize == 3 && stride == 1)
    err = launch_geom<3, 1>(x, w, b, y, s1, s2, n, h, wd, ci, co, g, dtype,
                            want_stats, config, grid, smem_bytes, s);
  else if (ksize == 3 && stride == 2)
    err = launch_geom<3, 2>(x, w, b, y, s1, s2, n, h, wd, ci, co, g, dtype,
                            want_stats, config, grid, smem_bytes, s);
  else if (ksize == 7 && stride == 2)
    err = launch_geom<7, 2>(x, w, b, y, s1, s2, n, h, wd, ci, co, g, dtype,
                            want_stats, config, grid, smem_bytes, s);
  else if (ksize == 2 && stride == 1)
    err = launch_geom<2, 1>(x, w, b, y, s1, s2, n, h, wd, ci, co, g, dtype,
                            want_stats, config, grid, smem_bytes, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
