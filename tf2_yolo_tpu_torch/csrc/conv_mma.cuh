// Tensor-core pieces shared by the bf16 kernels (conv_bn.cu,
// fused_gemm.cu, fused_conv3x3.cu): 16-byte cp.async copies with a zero
// fill, ldmatrix, mma.sync m16n8k16 (bf16 x bf16 -> f32) with either
// operand read from a tile stored either way round, the block tile
// shapes, the 4-stage ring of 32-deep slices, and the epilogue that
// turns the f32 tile into bf16 values, stores them as 16-byte rows
// through shared memory and adds two per-column sums over the valid rows
// (one f64 atomic per column and block): by default Σy and Σy² of the
// ROUNDED y (or of the f32 product, RAW).
//
// A block is 8 warps over BM = 128 output rows and BN output columns.
// Warp (wm, wn) owns rows wm*WTM .. +WTM and columns wn*WTN .. +WTN as
// MI x NI fragments of 16 x 8; a thread holds, per fragment, rows g and
// g + 8 (g = lane / 4) at columns 2t, 2t + 1 (t = lane % 4), the
// mma.sync accumulator layout.

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

// A ring of STAGES slices of 32 in the contraction: the A tile [BM rows]
// [32 + 8] (80-byte rows, so the 8 rows of an ldmatrix hit 8 banks) and
// the B tile [32][BN + 8]; the epilogue reuses the same memory.
constexpr int RING_BK = 32;
constexpr int RING_STAGES = 4;
constexpr int RING_APITCH = RING_BK + 8;
template <class TL>
struct Ring {
  static constexpr int A_ELEMS = BM * RING_APITCH;
  static constexpr int BPITCH = TL::BN + 8;
  static constexpr int STAGE_ELEMS = A_ELEMS + RING_BK * BPITCH;
  static constexpr int PIPE_BYTES = RING_STAGES * STAGE_ELEMS * 2;
  static constexpr int BYTES =
      PIPE_BYTES > TL::EPI_BYTES ? PIPE_BYTES : TL::EPI_BYTES;
};

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

// One 16-deep step of a warp tile of MI x NI fragments, from each
// lane's ldmatrix row addresses: a[mi] for A fragment mi (16 rows x 16
// deep), b[nj] for the pair of B fragments nj (16 deep x 16 columns).
// A_T false reads A from a [row][k] tile: lane row (lane & 15), k offset
// (lane >> 4) * 8; A_T true from a [k][row] tile (ldmatrix .trans): k
// (lane >> 4) * 8 + (lane & 7), row offset ((lane >> 3) & 1) * 8.  B_T
// true reads B from a [k][col] tile (.trans): k (lane & 15), column
// offset (lane >> 4) * 8; B_T false from a [col][k] tile: column
// (lane >> 4) * 8 + (lane & 7), k offset ((lane >> 3) & 1) * 8.  All A
// fragments are loaded first, then each B pair just before its products.
template <int MI, int NI, bool A_T, bool B_T>
__device__ __forceinline__ void mma_step(float (&acc)[MI][NI][4],
                                         const __nv_bfloat16* const* a,
                                         const __nv_bfloat16* const* b) {
  uint32_t af[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (A_T)
      ldsm_x4_t(af[mi], a[mi]);
    else
      ldsm_x4(af[mi], a[mi]);
  }
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj) {
    uint32_t bf[4];
    if (B_T)
      ldsm_x4_t(bf, b[nj]);
    else
      ldsm_x4(bf, b[nj]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      mma_bf16(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
      mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
    }
  }
}

// One 16-deep step of the warp tile from a [row][k] A tile and a
// row-major [k][n] B tile: a_rows[mi] is the lane's row address of A
// fragment mi (already offset by (lane / 16) * 8 in k), b_row the lane's
// address of k row lane % 16 at the warp's first column plus
// (lane / 16) * 8.
template <class TL>
__device__ __forceinline__ void mma_k16(float (&acc)[TL::MI][TL::NI][4],
                                        const __nv_bfloat16* const* a_rows,
                                        const __nv_bfloat16* b_row) {
  const __nv_bfloat16* b[TL::NI / 2];
#pragma unroll
  for (int nj = 0; nj < TL::NI / 2; ++nj) b[nj] = b_row + nj * 16;
  mma_step<TL::MI, TL::NI, false, true>(acc, a_rows, b);
}

// Epilogue: every accumulator pair (tile row r, global columns c, c + 1)
// becomes fn(r, c, v0, v1, t1, t2), a bf16 pair stored through shared
// memory (`smem`, at least TL::EPI_BYTES, free: the caller has waited
// for its copies and synchronised) as 16-byte chunks of 8 columns;
// store(row_off(r), c, chunk) writes the chunk of tile row r that starts
// at global column c, for rows with row_off(r) >= 0 (negative: outside
// the output) and columns c0 .. c0 + BN - 1 where < co (co % 8 == 0).
// fn sets t1, t2, the pair's terms of the two column sums (read only
// for a valid row).  With SUMS, s1 += sum t1 and s2 += sum t2 per
// column over the valid rows: f32 within the block (own rows, then warp
// shuffles over the 8 row groups, then the WARPS_M warps in order), one
// f64 atomic per column.
template <class TL, bool SUMS, class RowOff, class Fn, class Store>
__device__ __forceinline__ void epilogue_to(
    float (&acc)[TL::MI][TL::NI][4], unsigned char* smem, int c0, int co,
    RowOff row_off, Fn fn, Store store, double* __restrict__ s1,
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
      const bool ok = SUMS && row_off(r) >= 0;
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni) {
        const int col = wn * TL::WTN + ni * 8 + 2 * t;
        float2 t1, t2;
        *reinterpret_cast<__nv_bfloat162*>(cs + r * TL::CPITCH + col) =
            fn(r, c0 + col, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], t1,
               t2);
        if (ok) {
          p1[ni][0] += t1.x;
          p1[ni][1] += t1.y;
          p2[ni][0] += t2.x;
          p2[ni][1] += t2.y;
        }
      }
    }
  }
  if (SUMS) {
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
      store(off, c0 + col,
            *reinterpret_cast<const uint4*>(cs + r * TL::CPITCH + col));
  }
  if (SUMS && tid < TL::BN && c0 + tid < co) {
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

// The epilogue into one output: row r of the tile goes to element offset
// row_off(r) of out (its column 0).
template <class TL, bool SUMS, class RowOff, class Fn>
__device__ __forceinline__ void epilogue(
    float (&acc)[TL::MI][TL::NI][4], unsigned char* smem, int c0, int co,
    RowOff row_off, Fn fn, __nv_bfloat16* __restrict__ out,
    double* __restrict__ s1, double* __restrict__ s2) {
  epilogue_to<TL, SUMS>(
      acc, smem, c0, co, row_off, fn,
      [&](int64_t off, int c, const uint4& v) {
        *reinterpret_cast<uint4*>(out + off + c) = v;
      },
      s1, s2);
}

// The convolutions' and the GEMM's epilogue: y = bf16(acc + bias) (bias
// may be null), and with STATS s1 += sum y, s2 += sum y^2 per column of
// the rounded y, or with RAW of the f32 value before rounding.
template <class TL, bool STATS, bool RAW = false, class RowOff>
__device__ __forceinline__ void store_tile(
    float (&acc)[TL::MI][TL::NI][4], unsigned char* smem,
    const __nv_bfloat16* __restrict__ bias, int c0, int co, RowOff row_off,
    __nv_bfloat16* __restrict__ y, double* __restrict__ s1,
    double* __restrict__ s2) {
  epilogue<TL, STATS>(
      acc, smem, c0, co, row_off,
      [&](int, int c, float v0, float v1, float2& t1,
          float2& t2) -> __nv_bfloat162 {
        if (bias != nullptr && c < co) {
          v0 += __bfloat162float(bias[c]);
          v1 += __bfloat162float(bias[c + 1]);
        }
        __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        t1 = RAW ? make_float2(v0, v1) : __bfloat1622float2(v);
        t2 = make_float2(t1.x * t1.x, t1.y * t1.y);
        return v;
      },
      y, s1, s2);
}

}  // namespace tc
