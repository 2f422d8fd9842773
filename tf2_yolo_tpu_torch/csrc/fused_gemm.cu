// Fused prologue + GEMM + statistics, forward and backward:
//
//   y = sum_i g_i @ w_i,   g_i = T(act(x_i * a_i + b_i))  or  x_i as it is,
//   s1 = sum_m y, s2 = sum_m y^2 of the ROUNDED y, accumulated in f64,
//
// and, from {x_i, w_i, a_i, b_i, y, dy, ds1, ds2}: dx_i (T), dW_i, da_i,
// db_i (dW in f32; da, db accumulated in f64).  T is the compute type
// (bf16 or f32); x_i is [M, K_i], w_i is [K_i, N], a_i and b_i are
// [K_i] f32, all row-major.
//
// Replaces the Pallas TPU kernels of tf2_yolo_tpu/ops/pallas/packed_gemm.py:
// _fwd_kernel (called from _fwd_call) and _bwd_kernel (from _bwd_call).
//
// Design for Hopper, not a block-by-block copy:
//
// * Forward: the inputs' K ranges are walked one after the other by a
//   loop in the block (a concat that is never stored).  Two kernels,
//   chosen per shape by the Python plan (ops/kernels/fused_gemm.py,
//   _tc_plan), which passes the tile config, the grid and the dynamic
//   shared memory:
//   - fused_gemm_fwd_tc_kernel, bf16 with every K_i % 8 == 0 and
//     N % 8 == 0 (all 43 GEMMs of a packed=3 step): tensor cores.  A
//     block takes 128 rows and BN = 128, 64 or 32 columns (the widest
//     that N fills, narrower while the grid would not cover the 132
//     SMs); 8 warps run mma.sync m16n8k16 (bf16 -> f32) fed by ldmatrix
//     from a 4-stage ring of 32-deep slices copied with 16-byte cp.async
//     (zero fill past M and past K_i).  An input without a prologue is
//     copied as it is; for an input with one, the raw slice lands in the
//     ring and is activated there ONCE per element in f32 and rounded to
//     bf16 before ldmatrix reads it (once per column block of the grid).
//   - fused_gemm_fwd_kernel, f32 (the tensor cores' f32 route would be
//     TF32) and bf16 shapes the tensor-core kernel does not take: one
//     block per 64 x 64 tile, 4 x 4 micro-tiles of f32 FMA on the CUDA
//     cores; the prologue runs in f32 while the A tile is staged.
//   Both round g to T as the TPU kernel rounds its MXU operand.  The TPU
//   kernel adds s1/s2 across its sequential grid; here each block reduces
//   its columns in shared memory and adds one f64 atomic per column:
//   M = 86528 rows are hundreds of blocks per column, and the variance
//   s2 / M - mean^2 cancels, so the cross-block sum must not lose bits.
//   The wrapper rounds the sums to f32; block order does not show.
//   With `raw_stats` the sums are of the f32 product before it is rounded
//   (the variant of tools/bench_packed_probe.py's fused_kernel; RAW in
//   the tensor-core kernel).
// * Backward (CUDA cores) reads the forward's stored y where the TPU
//   kernel recomputes it in VMEM: under PyTorch the consumer keeps y
//   alive anyway, and a block could not hold a [rows, N] tile of y for
//   N = 1024.  Two kernels per input:
//   - dx kernel, tile [64 rows, 64 of K_i], contraction over N of
//     e = dy + T(y * T(2 ds2)) + T(ds1) with w_i^T.  Each term is rounded
//     to T on its own, as the TPU kernel's three products round theirs;
//     their f32 sum is one FMA operand.  The epilogue recomputes the
//     prologue's derivative, writes dx and reduces da, db over the
//     block's rows (f64 atomics, one per column and block).
//   - dW kernel, tile [64 of K_i, 64 of N], contraction over a chunk of
//     M_CHUNK rows (split-M: grid.z walks the chunks, tiles are added
//     with f32 atomics into a zeroed dW).  Operands: the recomputed g_i
//     and dyt = T(dy + ds1 + 2 y ds2).
// * Any M >= 1, any K_i, N >= 1 on the CUDA cores: ragged edges are
//   zero-filled on load and masked on store.
//
// What bounds it on an H100: by bytes these GEMMs are light (K, N <=
// 1024).  The tensor-core forward adds to its bytes the prologue (expf
// and two divisions per element at f32 CUDA-core rates, without FMA
// contraction), repeated per column block; the backward and the f32
// forward are bound by the CUDA cores' f32 FMA rate (67 TFLOP/s peak).
//
// Built with --fmad=false so that the prologue's f32 chain rounds as the
// plain PyTorch version does (no contraction); the CUDA-core GEMM loops
// call fmaf explicitly.

#include "conv_mma.cuh"
#include "fused_common.cuh"

namespace {

constexpr int MAX_INPUTS = 9;

struct FwdInputs {
  const void* x[MAX_INPUTS];
  const void* w[MAX_INPUTS];
  const float* a[MAX_INPUTS];    // null: no prologue for this input
  const float* b[MAX_INPUTS];
  int k[MAX_INPUTS];
  int count;
};

// ------------------------------------------------------------- forward

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_gemm_fwd_kernel(FwdInputs in, T* __restrict__ y,
                      double* __restrict__ s1, double* __restrict__ s2,
                      int m_total, int n_total, int raw_stats) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  // A loads: thread owns k-lane (tid % BK) and rows (tid / BK) + 16 r
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  // B loads: thread owns column (tid % BN) and k-rows (tid / BN) * 4 + r
  const int b_c = tid % BN;
  const int b_k = (tid / BN) * 4;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int inp = 0; inp < in.count; ++inp) {
    const T* __restrict__ x = (const T*)in.x[inp];
    const T* __restrict__ w = (const T*)in.w[inp];
    const float* __restrict__ pa = in.a[inp];
    const float* __restrict__ pb = in.b[inp];
    const int k_total = in.k[inp];
    for (int k0 = 0; k0 < k_total; k0 += BK) {
      {
        int kk = k0 + a_k;
        bool k_ok = kk < k_total;
        float sa = 1.f, sb = 0.f;
        if (pa != nullptr && k_ok) {
          sa = pa[kk];
          sb = pb[kk];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int64_t m = m0 + a_m + 16 * r;
          float v = 0.f;
          if (k_ok && m < m_total) {
            v = to_f32(x[m * k_total + kk]);
            if (pa != nullptr) v = round_to<T>(act_only<ACT>(v * sa + sb));
          }
          As[a_k][a_m + 16 * r] = v;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int kk = k0 + b_k + r;
        int cc = c0 + b_c;
        float v = 0.f;
        if (kk < k_total && cc < n_total)
          v = to_f32(w[(int64_t)kk * n_total + cc]);
        Bs[b_k + r][b_c] = v;
      }
      __syncthreads();
      tile_fma(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }

  float p1[4] = {0.f, 0.f, 0.f, 0.f};
  float p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int cc = c0 + tx * 4 + j;
    if (cc >= n_total) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int64_t m = m0 + ty * 4 + i;
      if (m >= m_total) continue;
      T yr = from_f32<T>(acc[i][j]);
      y[m * n_total + cc] = yr;
      float yv = raw_stats ? acc[i][j] : to_f32(yr);
      p1[j] += yv;
      p2[j] += yv * yv;
    }
  }
  column_atomic_add(As, p1, ty, tx, tid, c0, n_total, s1);
  column_atomic_add(As, p2, ty, tx, tid, c0, n_total, s2);
}

// ------------------------------------------ forward on tensor cores (bf16)

// One block: rows blockIdx.x * 128 .. + 128 against columns
// blockIdx.y * BN .. + BN, over the slices of every input in turn.  PRO
// false: no input has a prologue (every slice goes from the ring to
// ldmatrix as it landed).  RAW: the sums are of the f32 product.
template <int ACT, bool PRO, bool RAW, class TL>
__global__ void __launch_bounds__(tc::THREADS)
fused_gemm_fwd_tc_kernel(FwdInputs in, __nv_bfloat16* __restrict__ y,
                         double* __restrict__ s1, double* __restrict__ s2,
                         int m_total, int n_total) {
  using SM = tc::Ring<TL>;
  constexpr int BN = TL::BN;
  constexpr int BK = tc::RING_BK, STAGES = tc::RING_STAGES;
  constexpr int APITCH = tc::RING_APITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int64_t m0 = (int64_t)blockIdx.x * tc::BM;
  const int c0 = blockIdx.y * BN;
  int slices = 0;
  for (int i = 0; i < in.count; ++i) slices += (in.k[i] + BK - 1) / BK;

  // copies: this thread's 16-byte chunk (tid % 4) of A rows tid / 4 and
  // tid / 4 + 64; the input and first k of the next slice to copy
  const int a_chunk = tid & 3;
  int l_inp = 0, l_k = 0;
  auto copy_slice = [&](int stage) {
    __nv_bfloat16* as = ring + stage * SM::STAGE_ELEMS;
    __nv_bfloat16* bs = as + SM::A_ELEMS;
    const __nv_bfloat16* x = (const __nv_bfloat16*)in.x[l_inp];
    const __nv_bfloat16* w = (const __nv_bfloat16*)in.w[l_inp];
    const int k_total = in.k[l_inp];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (tid >> 2) + 64 * r;
      const int64_t m = m0 + row;
      const int kk = l_k + a_chunk * 8;
      const bool ok = m < m_total && kk < k_total;
      tc::cp_async16(as + row * APITCH + a_chunk * 8,
                     ok ? x + m * k_total + kk : x, ok);
    }
    constexpr int B_CHUNKS = BK * BN / 8;
#pragma unroll
    for (int i = tid; i < B_CHUNKS; i += tc::THREADS) {
      const int kr = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const bool ok = l_k + kr < k_total && c0 + col < n_total;
      tc::cp_async16(bs + kr * SM::BPITCH + col,
                     ok ? w + (int64_t)(l_k + kr) * n_total + c0 + col : w,
                     ok);
    }
    l_k += BK;
    if (l_k >= k_total) {
      l_k = 0;
      ++l_inp;
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
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) copy_slice(s);
    tc::cp_async_commit();
  }
  int c_inp = 0, c_k = 0;       // the slice being consumed
  for (int kt = 0; kt < slices; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice kt has landed; slice kt - 1 is consumed
    if (kt + STAGES - 1 < slices) copy_slice((kt + STAGES - 1) % STAGES);
    tc::cp_async_commit();
    __nv_bfloat16* as = ring + (kt % STAGES) * SM::STAGE_ELEMS;
    const __nv_bfloat16* bs = as + SM::A_ELEMS;
    if (PRO && in.a[c_inp] != nullptr) {
      // the prologue in place, once per element: thread owns channel
      // pair tid % 16 of rows tid / 16 + 16 j (K_i % 8 == 0, so a pair
      // lies wholly inside or past K_i; past it the zeros stay)
      const int c = 2 * (tid & 15), kk = c_k + c;
      if (kk < in.k[c_inp]) {
        const float* pa = in.a[c_inp];
        const float* pb = in.b[c_inp];
        const float a0 = pa[kk], a1 = pa[kk + 1];
        const float b0 = pb[kk], b1 = pb[kk + 1];
#pragma unroll
        for (int j = 0; j < tc::BM / 16; ++j) {
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
              as + ((tid >> 4) + 16 * j) * APITCH + c);
          const float2 v = __bfloat1622float2(*e);
          *e = __floats2bfloat162_rn(act_only<ACT>(v.x * a0 + b0),
                                     act_only<ACT>(v.y * a1 + b1));
        }
      }
      __syncthreads();
    }
    c_k += BK;
    if (c_k >= in.k[c_inp]) {
      c_k = 0;
      ++c_inp;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const __nv_bfloat16* a_rows[TL::MI];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
        a_rows[mi] = as + (wm * TL::WTM + mi * 16 + (lane & 15)) * APITCH
                     + kk + (lane >> 4) * 8;
      tc::mma_k16<TL>(acc, a_rows,
                      bs + (kk + (lane & 15)) * SM::BPITCH + wn * TL::WTN
                          + (lane >> 4) * 8);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  tc::store_tile<TL, true, RAW>(
      acc, smem, nullptr, c0, n_total,
      [&](int r) -> int64_t {
        const int64_t m = m0 + r;
        return m < m_total ? m * n_total : -1;
      },
      y, s1, s2);
}

// ------------------------------------------------------- backward: dx

// dg[m, k] = sum_n e[m, n] * w[k, n];  prologue: dz = dg * act'(z),
// dx = T(dz * a), da += sum_m dz * x, db += sum_m dz;  else dx = T(dg).
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_gemm_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ pa,
                     const float* __restrict__ pb, const T* __restrict__ y,
                     const T* __restrict__ dy, const float* __restrict__ ds1,
                     const float* __restrict__ ds2, T* __restrict__ dx,
                     double* __restrict__ da, double* __restrict__ db,
                     int m_total, int k_total, int n_total) {
  __shared__ __align__(16) float As[BK][BM + 4];   // e, [n][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // w^T, [n][k]

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;                  // first k column
  // both loads: thread owns n-lane (tid % BK) and 4 rows / k columns
  const int l_n = tid % BK;
  const int l_r = tid / BK;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < n_total; n0 += BK) {
    int nn = n0 + l_n;
    bool n_ok = nn < n_total;
    float t1 = 0.f, t2 = 0.f;
    if (n_ok) {
      t1 = round_to<T>(ds1[nn]);
      t2 = round_to<T>(2.0f * ds2[nn]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int64_t m = m0 + l_r + 16 * r;
      float v = 0.f;
      if (n_ok && m < m_total) {
        int64_t at = m * n_total + nn;
        v = to_f32(dy[at]) + round_to<T>(to_f32(y[at]) * t2) + t1;
      }
      As[l_n][l_r + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int kk = c0 + l_r + 16 * r;
      float v = 0.f;
      if (n_ok && kk < k_total) v = to_f32(w[(int64_t)kk * n_total + nn]);
      Bs[l_n][l_r + 16 * r] = v;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float pda[4] = {0.f, 0.f, 0.f, 0.f};
  float pdb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int kk = c0 + tx * 4 + j;
    if (kk >= k_total) continue;
    float sa = 1.f, sb = 0.f;
    if (pa != nullptr) {
      sa = pa[kk];
      sb = pb[kk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int64_t m = m0 + ty * 4 + i;
      if (m >= m_total) continue;
      int64_t at = m * k_total + kk;
      if (pa != nullptr) {
        float xf = to_f32(x[at]);
        float g, gp;
        act_and_grad<ACT>(xf * sa + sb, g, gp);
        float dz = acc[i][j] * gp;
        dx[at] = from_f32<T>(dz * sa);
        pda[j] += dz * xf;
        pdb[j] += dz;
      } else {
        dx[at] = from_f32<T>(acc[i][j]);
      }
    }
  }
  if (pa != nullptr) {
    column_atomic_add(As, pda, ty, tx, tid, c0, k_total, da);
    column_atomic_add(As, pdb, ty, tx, tid, c0, k_total, db);
  }
}

// ------------------------------------------------------- backward: dW

// dW[k, n] += sum over this block's M chunk of g[m, k] * dyt[m, n]
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_gemm_dw_kernel(const T* __restrict__ x, const float* __restrict__ pa,
                     const float* __restrict__ pb, const T* __restrict__ y,
                     const T* __restrict__ dy, const float* __restrict__ ds1,
                     const float* __restrict__ ds2, float* __restrict__ dw,
                     int m_total, int k_total, int n_total) {
  __shared__ __align__(16) float As[BK][BM + 4];   // g, [m][k]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // dyt, [m][n]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;                  // first k row of dW
  const int c0 = blockIdx.y * BN;                  // first n column
  const int64_t m_begin = (int64_t)blockIdx.z * M_CHUNK;
  const int64_t m_end =
      m_begin + M_CHUNK < m_total ? m_begin + M_CHUNK : (int64_t)m_total;
  // both loads: thread owns column (tid % 64) and m-rows (tid / 64) * 4 + r
  const int l_c = tid % BN;
  const int l_m = (tid / BN) * 4;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const int kk = r0 + l_c;
  const bool k_ok = kk < k_total;
  float sa = 1.f, sb = 0.f;
  if (pa != nullptr && k_ok) {
    sa = pa[kk];
    sb = pb[kk];
  }
  const int nn = c0 + l_c;
  const bool n_ok = nn < n_total;
  float t1 = 0.f, t2 = 0.f;
  if (n_ok) {
    t1 = ds1[nn];
    t2 = ds2[nn];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t mb = m_begin; mb < m_end; mb += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int64_t m = mb + l_m + r;
      float g = 0.f, d = 0.f;
      if (m < m_end) {
        if (k_ok) {
          g = to_f32(x[m * k_total + kk]);
          if (pa != nullptr) g = round_to<T>(act_only<ACT>(g * sa + sb));
        }
        if (n_ok) {
          int64_t at = m * n_total + nn;
          d = round_to<T>((to_f32(dy[at]) + t1)
                          + (2.0f * to_f32(y[at])) * t2);
        }
      }
      As[l_m + r][l_c] = g;
      Bs[l_m + r][l_c] = d;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int k = r0 + ty * 4 + i;
    if (k >= k_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = c0 + tx * 4 + j;
      if (n < n_total) atomicAdd(&dw[(int64_t)k * n_total + n], acc[i][j]);
    }
  }
}

// ------------------------------------------------------------ launches

template <typename T, int ACT>
int launch_fwd(const FwdInputs& in, void* y, double* s1, double* s2, int m,
               int n, int raw_stats, cudaStream_t stream) {
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
  fused_gemm_fwd_kernel<T, ACT><<<grid, THREADS, 0, stream>>>(
      in, (T*)y, s1, s2, m, n, raw_stats);
  return (int)cudaGetLastError();
}

template <int ACT, bool PRO, bool RAW, class TL>
int launch_fwd_tc(const FwdInputs& in, void* y, double* s1, double* s2,
                  int m, int n, dim3 grid, int smem_bytes,
                  cudaStream_t stream) {
  // the plan's shared memory must be this config's
  if (smem_bytes != tc::Ring<TL>::BYTES || n % 8)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < in.count; ++i)
    if (in.k[i] % 8) return (int)cudaErrorInvalidValue;
  auto kernel = fused_gemm_fwd_tc_kernel<ACT, PRO, RAW, TL>;
  static int allowed[tc::MAX_DEVICES] = {0};   // per instance and device
  int err = tc::allow_smem((const void*)kernel, smem_bytes, allowed);
  if (err != 0) return err;
  kernel<<<grid, tc::THREADS, smem_bytes, stream>>>(
      in, (__nv_bfloat16*)y, s1, s2, m, n);
  return (int)cudaGetLastError();
}

template <bool RAW, class TL>
int fwd_tc_by_act(const FwdInputs& in, void* y, double* s1, double* s2,
                  int m, int n, int act, dim3 grid, int smem_bytes,
                  cudaStream_t stream) {
  bool pro = false;
  for (int i = 0; i < in.count; ++i) pro |= in.a[i] != nullptr;
  if (!pro)
    return launch_fwd_tc<ACT_LINEAR, false, RAW, TL>(in, y, s1, s2, m, n,
                                                     grid, smem_bytes, stream);
  if (act == ACT_MISH)
    return launch_fwd_tc<ACT_MISH, true, RAW, TL>(in, y, s1, s2, m, n, grid,
                                                  smem_bytes, stream);
  if (act == ACT_LEAKY)
    return launch_fwd_tc<ACT_LEAKY, true, RAW, TL>(in, y, s1, s2, m, n, grid,
                                                   smem_bytes, stream);
  if (act == ACT_LINEAR)
    return launch_fwd_tc<ACT_LINEAR, true, RAW, TL>(in, y, s1, s2, m, n,
                                                    grid, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

template <class TL>
int fwd_tc_by_raw(const FwdInputs& in, void* y, double* s1, double* s2,
                  int m, int n, int act, int raw_stats, dim3 grid,
                  int smem_bytes, cudaStream_t stream) {
  if (raw_stats)
    return fwd_tc_by_act<true, TL>(in, y, s1, s2, m, n, act, grid,
                                   smem_bytes, stream);
  return fwd_tc_by_act<false, TL>(in, y, s1, s2, m, n, act, grid,
                                  smem_bytes, stream);
}

template <typename T, int ACT>
int launch_bwd(const void* x, const void* w, const float* a, const float* b,
               const void* y, const void* dy, const float* ds1,
               const float* ds2, void* dx, float* dw, double* da, double* db,
               int m, int k, int n, cudaStream_t stream) {
  dim3 gx((unsigned)((m + BM - 1) / BM), (unsigned)((k + BN - 1) / BN));
  fused_gemm_dx_kernel<T, ACT><<<gx, THREADS, 0, stream>>>(
      (const T*)x, (const T*)w, a, b, (const T*)y, (const T*)dy, ds1, ds2,
      (T*)dx, da, db, m, k, n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 gw((unsigned)((k + BM - 1) / BM), (unsigned)((n + BN - 1) / BN),
          (unsigned)((m + M_CHUNK - 1) / M_CHUNK));
  fused_gemm_dw_kernel<T, ACT><<<gw, THREADS, 0, stream>>>(
      (const T*)x, a, b, (const T*)y, (const T*)dy, ds1, ds2, dw, m, k, n);
  return (int)cudaGetLastError();
}

bool pack_inputs(const void* const* xs, const void* const* ws,
                 const void* const* aas, const void* const* bbs,
                 const int* ks, int count, FwdInputs* in) {
  if (count < 1 || count > MAX_INPUTS) return false;
  in->count = count;
  for (int i = 0; i < count; ++i) {
    in->x[i] = xs[i];
    in->w[i] = ws[i];
    in->a[i] = (const float*)aas[i];
    in->b[i] = (const float*)bbs[i];
    in->k[i] = ks[i];
    if (ks[i] < 1) return false;
  }
  return true;
}

}  // namespace

#define DISPATCH(FN, ...)                                                  \
  if (dtype == 0) {                                                        \
    if (act == ACT_MISH) return FN<float, ACT_MISH>(__VA_ARGS__);          \
    if (act == ACT_LEAKY) return FN<float, ACT_LEAKY>(__VA_ARGS__);        \
    if (act == ACT_LINEAR) return FN<float, ACT_LINEAR>(__VA_ARGS__);      \
  } else if (dtype == 1) {                                                 \
    if (act == ACT_MISH) return FN<__nv_bfloat16, ACT_MISH>(__VA_ARGS__);  \
    if (act == ACT_LEAKY)                                                  \
      return FN<__nv_bfloat16, ACT_LEAKY>(__VA_ARGS__);                    \
    if (act == ACT_LINEAR)                                                 \
      return FN<__nv_bfloat16, ACT_LINEAR>(__VA_ARGS__);                   \
  }                                                                        \
  return (int)cudaErrorInvalidValue;

// Forward on the CUDA cores.  xs, ws, aas, bbs: host arrays of `count`
// device pointers (an entry of `aas` is null for an input without a
// prologue); ks: host array of the K_i.  dtype: 0 = float32, 1 =
// bfloat16.  act: 0 mish, 1 leaky, 2 linear.  s1 and s2 are zeroed f64
// buffers; they sum the rounded y, or with raw_stats != 0 the f32
// product before rounding.  Returns the cudaError_t of the launch.
extern "C" int fused_gemm_fwd_launch(const void* const* xs,
                                     const void* const* ws,
                                     const void* const* aas,
                                     const void* const* bbs, const int* ks,
                                     int count, void* y, double* s1,
                                     double* s2, int m, int n, int dtype,
                                     int act, int raw_stats, void* stream) {
  FwdInputs in;
  if (!pack_inputs(xs, ws, aas, bbs, ks, count, &in) || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH(launch_fwd, in, y, s1, s2, m, n, raw_stats, s)
}

// Forward on the tensor cores, bf16 only, arguments as above; config (0,
// 1, 2: BN = 128, 64, 32), grid and smem_bytes come from the Python plan.
// Every K_i and N must be multiples of 8, and x_i, w_i, y 16-byte
// aligned.  Returns the cudaError_t of the launch.
extern "C" int fused_gemm_fwd_tc_launch(
    const void* const* xs, const void* const* ws, const void* const* aas,
    const void* const* bbs, const int* ks, int count, void* y, double* s1,
    double* s2, int m, int n, int act, int raw_stats, int config,
    int grid_x, int grid_y, int smem_bytes, void* stream) {
  FwdInputs in;
  if (!pack_inputs(xs, ws, aas, bbs, ks, count, &in) || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (config == 0)
    return fwd_tc_by_raw<tc::Tile128>(in, y, s1, s2, m, n, act, raw_stats,
                                      grid, smem_bytes, s);
  if (config == 1)
    return fwd_tc_by_raw<tc::Tile64>(in, y, s1, s2, m, n, act, raw_stats,
                                     grid, smem_bytes, s);
  if (config == 2)
    return fwd_tc_by_raw<tc::Tile32>(in, y, s1, s2, m, n, act, raw_stats,
                                     grid, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// Backward of one input: the dx kernel, then the split-M dW kernel.  a
// and b are null for an input without a prologue (da, db are then not
// touched).  dw (f32), da and db (f64) must be zeroed.  Returns the
// first nonzero cudaError_t of the two launches.
extern "C" int fused_gemm_bwd_launch(const void* x, const void* w,
                                     const float* a, const float* b,
                                     const void* y, const void* dy,
                                     const float* ds1, const float* ds2,
                                     void* dx, float* dw, double* da,
                                     double* db, int m, int k, int n,
                                     int dtype, int act, void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH(launch_bwd, x, w, a, b, y, dy, ds1, ds2, dx, dw, da, db, m, k, n,
           s)
}
