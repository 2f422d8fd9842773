// Shared pieces of the fused kernels (fused_gemm.cu, fused_conv3x3.cu):
// the compute-type conversions, the f32 prologue activations with their
// derivatives, the 64 x 64 x 16 FMA tile step and the per-block column
// reduction that ends in one f64 atomic per column.
//
// Sources that include this header are built with --fmad=false so that
// the prologue's f32 chain rounds as the plain PyTorch version does (no
// contraction); the tile step calls fmaf explicitly.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int M_CHUNK = 1024;      // rows per block of a split-M dW kernel

constexpr int ACT_MISH = 0;
constexpr int ACT_LEAKY = 1;
constexpr int ACT_LINEAR = 2;

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
// round an f32 value to T and bring it back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// activation value g and derivative gp at z, f32, the formulas of
// packed_gemm._act_and_grad (mish with the exponent clamped at 20)
template <int ACT>
__device__ __forceinline__ void act_and_grad(float z, float& g, float& gp) {
  if (ACT == ACT_MISH) {
    float u = expf(fminf(z, 20.0f));
    float d = (1.0f + u) * (1.0f + u) + 1.0f;
    float c = 1.0f - 2.0f / d;
    g = z * c;
    gp = c + z * (2.0f / (d * d)) * (2.0f * (1.0f + u) * u);
  } else if (ACT == ACT_LEAKY) {
    g = z >= 0.0f ? z : z * 0.1f;
    gp = z >= 0.0f ? 1.0f : 0.1f;
  } else {
    g = z;
    gp = 1.0f;
  }
}

template <int ACT>
__device__ __forceinline__ float act_only(float z) {
  float g, gp;
  act_and_grad<ACT>(z, g, gp);
  return g;
}

// acc[4][4] += As[k][ty*4 + i] * Bs[k][tx*4 + j] over one staged slice
__device__ __forceinline__ void tile_fma(float (*As)[BM + 4],
                                         float (*Bs)[BN + 4], int ty, int tx,
                                         float acc[4][4]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    float av[4] = {a.x, a.y, a.z, a.w};
    float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Reduce per-thread column partials p[4] (thread (ty, tx) owns columns
// tx*4 .. +3 for its 4 rows) over the 16 row groups of the block through
// shared memory, then one atomicAdd per column.  Must be called by all
// threads, after a __syncthreads() that released `red`.
__device__ __forceinline__ void column_atomic_add(float (*red)[BN + 4],
                                                  const float p[4], int ty,
                                                  int tx, int tid, int c0,
                                                  int cols, double* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = p[j];
  __syncthreads();
  if (tid < BN && c0 + tid < cols) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) t += red[r][tid];
    atomicAdd(&out[c0 + tid], (double)t);
  }
  __syncthreads();
}

}  // namespace
