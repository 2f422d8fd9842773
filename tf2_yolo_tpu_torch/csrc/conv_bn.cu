// Direct NHWC convolution (implicit GEMM) with an optional per-channel
// statistics epilogue: y = conv(x, w) + b rounded to the output type,
// s1 = sum(y), s2 = sum(y^2) over N*H*W of the ROUNDED y, accumulated in
// f64.
//
// Replaces the Pallas TPU kernels conv1x1_stats (_conv1x1_stats_fwd_impl)
// and conv3x3_stats (_conv3x3_stats_fwd_impl) of
// tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py, forward only.
//
// Geometry: 1x1 stride 1; 3x3 stride 1 with SAME padding (1 on every
// side); 3x3 stride 2 with the darknet top/left pad and VALID (H, W
// even).  Both 3x3 cases read input row ho*stride - 1 + ky and column
// wo*stride - 1 + kx, zero outside the image; at stride 2 with even H
// the bottom/right pad is never touched, which is exactly the darknet
// (1,0),(1,0) pad.
//
// GEMM view: M = N*Ho*Wo output pixels, Co columns, K = ks*ks*Ci.  The
// HWIO weight tensor is already the row-major (K, Co) B matrix.  A block
// computes a BM x BN tile, stages a BK-deep slice of the gathered input
// (zero-filled halo) and of the weights through shared memory, and each
// of its 256 threads accumulates a 4x4 micro-tile in f32 registers with
// FMA on the CUDA cores.
//
// What bounds it on an H100: FMA throughput of the CUDA cores (f32
// peak 67 TFLOP/s), far below the bf16 tensor-core rate this layer
// could reach with wgmma; the input gather re-reads each activation
// ks*ks times through L1/L2.  This is the simple, correct first kernel;
// tensor cores and TMA come later.
//
// Statistics: the TPU kernel carries s1/s2 across its sequential grid.
// Blocks here run in parallel in no order, so each block reduces its
// tile's columns in shared memory (64 f32 terms) and adds them with one
// f64 atomicAdd per column and block.  A training batch sums millions of
// rows per channel (5.5e6 in the stem at batch 32) over tens of
// thousands of blocks, and the variance s2/M - mean^2 cancels: f32
// atomics lost 8e-6 of sum(y^2) there, f64 ones lose nothing that shows
// after the wrapper rounds the sums to f32, whatever the block order.
// STATS is a template flag, so the served forward (want_stats = 0)
// carries no reduction and no atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
                     int n, int h, int wd, int ci, int co, int ho, int wo) {
  constexpr int PAD = KS == 3 ? 1 : 0;
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
    a_hi[r] = ho_i * STRIDE - PAD;
    a_wi[r] = wo_i * STRIDE - PAD;
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

template <typename T, int KS, int STRIDE>
void launch(const void* x, const void* w, const void* b, void* y, double* s1,
            double* s2, int n, int h, int wd, int ci, int co, int want_stats,
            cudaStream_t stream) {
  int ho = h / STRIDE, wo = wd / STRIDE;
  int64_t m_total = (int64_t)n * ho * wo;
  dim3 grid((unsigned)((m_total + BM - 1) / BM), (co + BN - 1) / BN);
  if (want_stats) {
    conv_bn_stats_kernel<T, KS, STRIDE, true><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)y, s1, s2, n, h, wd, ci,
        co, ho, wo);
  } else {
    conv_bn_stats_kernel<T, KS, STRIDE, false><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)y, s1, s2, n, h, wd, ci,
        co, ho, wo);
  }
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, double* s1,
             double* s2, int n, int h, int wd, int ci, int co, int ksize,
             int stride, int want_stats, cudaStream_t stream) {
  if (ksize == 1 && stride == 1) {
    launch<T, 1, 1>(x, w, b, y, s1, s2, n, h, wd, ci, co, want_stats, stream);
  } else if (ksize == 3 && stride == 1) {
    launch<T, 3, 1>(x, w, b, y, s1, s2, n, h, wd, ci, co, want_stats, stream);
  } else if (ksize == 3 && stride == 2) {
    launch<T, 3, 2>(x, w, b, y, s1, s2, n, h, wd, ci, co, want_stats, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  s1/s2 are zeroed f64 buffers of co
// entries, and may be null when want_stats == 0.  Returns the
// cudaError_t of the launch.
extern "C" int conv_bn_stats_launch(const void* x, const void* w,
                                    const void* b, void* y, double* s1,
                                    double* s2, int n, int h, int wd, int ci,
                                    int co, int ksize, int stride, int dtype,
                                    int want_stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, w, b, y, s1, s2, n, h, wd, ci, co, ksize,
                           stride, want_stats, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, b, y, s1, s2, n, h, wd, ci, co,
                                   ksize, stride, want_stats, s);
  return (int)cudaErrorInvalidValue;
}
