// Tensor-core pieces shared by the bf16 convolutions (conv_bn.cu,
// fused_conv3x3.cu): 16-byte cp.async copies with a zero fill,
// ldmatrix, mma.sync m16n8k16 (bf16 x bf16 -> f32), the block tile
// shapes and the epilogue that rounds the f32 tile to bf16, stores it as
// 16-byte rows through shared memory and adds the per-column sums of the
// ROUNDED values (one f64 atomic per column and block).
//
// A block is 8 warps over BM = 128 output rows (pixels) and BN output
// channels.  Warp (wm, wn) owns rows wm*WTM .. +WTM and columns
// wn*WTN .. +WTN as MI x NI fragments of 16 x 8; a thread holds, per
// fragment, rows g and g + 8 (g = lane / 4) at columns 2t, 2t + 1
// (t = lane % 4), the mma.sync accumulator layout.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int THREADS = 256;
constexpr int BM = 128;

template <int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int WTM = BM / WARPS_M;
  static constexpr int WTN = BN / WARPS_N;
  static constexpr int MI = WTM / 16;
  static constexpr int NI = WTN / 8;
  // staged output row: BN bf16 + 8 of padding, so the fragments' 4-byte
  // writes of 8 rows x 4 column pairs fall on 32 different banks
  static constexpr int CPITCH = BN + 8;
  static constexpr int EPI_BYTES = BM * CPITCH * 2 + 2 * WARPS_M * BN * 4;
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "whole x4 ldmatrix tiles");
};

// the three tile shapes, by the config id the Python plan passes
using Tile128 = Tile<128, 2, 4>;     // config 0
using Tile64 = Tile<64, 4, 2>;       // config 1
using Tile32 = Tile<32, 4, 2>;       // config 2

// Dynamic shared memory above 48 KB must be allowed per kernel and
// device before the first launch, or the launch is refused (and never
// runs: synchronize() would not report it).  `allowed` is the caller's
// per-kernel record of what each device allows already.
constexpr int MAX_DEVICES = 64;
inline int allow_smem(const void* kernel, int bytes, int* allowed) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (allowed[dev] < bytes) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != 0) return err;
    allowed[dev] = bytes;
  }
  return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, not kept in L1; with valid false nothing is
// read and the 16 bytes are zeroed (the conv's halo)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep step of the warp tile: A rows from a_rows[mi] (the lane's
// row address for fragment mi, already offset by (lane / 16) * 8 in k),
// B as a row-major [k][n] tile read transposed from b_row (the lane's
// address of k row lane % 16, at the warp's first column plus
// (lane / 16) * 8).
template <class TL>
__device__ __forceinline__ void mma_k16(float (&acc)[TL::MI][TL::NI][4],
                                        const __nv_bfloat16* const* a_rows,
                                        const __nv_bfloat16* b_row) {
  uint32_t af[TL::MI][4];
  uint32_t bf[TL::NI / 2][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi) ldsm_x4(af[mi], a_rows[mi]);
#pragma unroll
  for (int nj = 0; nj < TL::NI / 2; ++nj) ldsm_x4_t(bf[nj], b_row + nj * 16);
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
      mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][(ni & 1) * 2],
               bf[ni / 2][(ni & 1) * 2 + 1]);
}

// Epilogue: y = bf16(acc + bias) (bias may be null), stored through
// shared memory (`smem`, at least TL::EPI_BYTES, free: the caller has
// waited for its copies and synchronised) as 16-byte rows; row r of the
// tile goes to element offset row_off(r) of y (its channel 0; negative
// for a row outside the output), columns c0 .. c0 + BN - 1 where < co
// (co % 8 == 0).  With STATS, s1 += sum y and s2 += sum y^2 per column
// over the valid rows of the rounded y: f32 within the block (own rows,
// then warp shuffles over the 8 row groups, then the WARPS_M warps in
// order), one f64 atomic per column.
template <class TL, bool STATS, class RowOff>
__device__ __forceinline__ void store_tile(
    float (&acc)[TL::MI][TL::NI][4], unsigned char* smem,
    const __nv_bfloat16* __restrict__ bias, int c0, int co, RowOff row_off,
    __nv_bfloat16* __restrict__ y, double* __restrict__ s1,
    double* __restrict__ s2) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + BM * TL::CPITCH * 2);

  float p1[TL::NI][2], p2[TL::NI][2];
#pragma unroll
  for (int ni = 0; ni < TL::NI; ++ni)
    p1[ni][0] = p1[ni][1] = p2[ni][0] = p2[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * TL::WTM + mi * 16 + g + 8 * h;
      const bool ok = !STATS || row_off(r) >= 0;
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni) {
        const int col = wn * TL::WTN + ni * 8 + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr && c0 + col < co) {
          b0 = __bfloat162float(bias[c0 + col]);
          b1 = __bfloat162float(bias[c0 + col + 1]);
        }
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][ni][2 * h] + b0,
                                                 acc[mi][ni][2 * h + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(cs + r * TL::CPITCH + col) = v;
        if (STATS && ok) {
          float2 f = __bfloat1622float2(v);
          p1[ni][0] += f.x;
          p1[ni][1] += f.y;
          p2[ni][0] += f.x * f.x;
          p2[ni][1] += f.y * f.y;
        }
      }
    }
  }
  if (STATS) {
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          p1[ni][j] += __shfl_xor_sync(0xffffffffu, p1[ni][j], off);
          p2[ni][j] += __shfl_xor_sync(0xffffffffu, p2[ni][j], off);
        }
    if (g == 0) {
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn * TL::WTN + ni * 8 + 2 * t + j;
          red[wm * TL::BN + col] = p1[ni][j];
          red[(TL::WARPS_M + wm) * TL::BN + col] = p2[ni][j];
        }
    }
  }
  __syncthreads();
  constexpr int CHUNKS = TL::BN / 8;
  for (int i = tid; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    const int64_t off = row_off(r);
    if (off >= 0 && c0 + col < co)
      *reinterpret_cast<uint4*>(y + off + c0 + col) =
          *reinterpret_cast<const uint4*>(cs + r * TL::CPITCH + col);
  }
  if (STATS && tid < TL::BN && c0 + tid < co) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < TL::WARPS_M; ++k) {
      t1 += red[k * TL::BN + tid];
      t2 += red[(TL::WARPS_M + k) * TL::BN + tid];
    }
    atomicAdd(&s1[c0 + tid], (double)t1);
    atomicAdd(&s2[c0 + tid], (double)t2);
  }
}

}  // namespace tc
