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
// * Backward, from {x_i, w_i, a_i, b_i, y, dy, ds1, ds2}: it reads the
//   forward's stored y where the TPU kernel recomputes it in VMEM (under
//   PyTorch the consumer keeps y alive anyway, and a block could not hold
//   a [rows, N] tile of y for N = 1024).  Two routes, chosen per shape by
//   the Python plan (_tc_bwd_plan), as the forward's:
//   - bf16 with every K_i % 8 == 0 and N % 8 == 0 (every GEMM of a
//     packed=3 step): tensor cores, three launches for all inputs, whose
//     K ranges are one column space of sum K_i columns (a block may span
//     inputs: K_i % 8 == 0, so 8 columns lie in one; dy and y are read
//     once for all inputs).  (1) fused_gemm_ctab_kernel folds ds1 into
//     an f32 vector, c[gc] = sum_n T(ds1[n]) w_i[k, n] (one warp per
//     column), so that ds1, which the TPU kernel's third product keeps
//     apart, never enters a bf16 operand.  (2) fused_gemm_dx_tc_kernel:
//     K2's forward with w read the other way.  A block takes 128 rows
//     and BN = 128, 64 or 32 columns; per 32-deep slice of N, in a
//     2-stage cp.async ring, it copies dy, y and the slice of w (rows of
//     w are n-contiguous: B is read by ldmatrix without .trans), builds
//     T(y * T(2 ds2)) in place ONCE per element, and runs both products
//     into one f32 accumulator against the same B fragments; the x tile
//     of its columns is copied beside the first slice.  The epilogue
//     adds c, recomputes the prologue's derivative from the staged x,
//     writes dx through shared memory into each input's own tensor and
//     adds da, db (f64 atomics, one per column and block).
//     (3) fused_gemm_dw_tc_kernel: a block takes a tile of 128 or 64
//     columns by 128 or 64 of N of dW over a chunk of rows (the plan
//     sizes the chunks so that about two blocks per SM run); per 32-row
//     slice, in a 3-stage ring, it copies x, dy and y, activates x ONCE
//     per element in place and builds dyt = T(dy + ds1 + 2 y ds2) ONCE
//     per element in place, then contracts over the rows with both
//     operands read by ldmatrix .trans, and adds its tile to the zeroed
//     dW_i with f32 atomics.
//   - f32 and shapes without 16-byte rows: CUDA cores, two kernels per
//     input.  dx kernel, tile [64 rows, 64 of K_i], contraction over N
//     of e = dy + T(y * T(2 ds2)) + T(ds1) with w_i^T, each term rounded
//     to T on its own, as the TPU kernel's three products round theirs;
//     the epilogue as above.  dW kernel, tile [64 of K_i, 64 of N],
//     contraction over a chunk of M_CHUNK rows (split-M: grid.z walks
//     the chunks, f32 atomics) of the recomputed g_i and dyt.
// * Any M >= 1, any K_i, N >= 1 on the CUDA cores: ragged edges are
//   zero-filled on load and masked on store.
//
// What bounds it on an H100: by bytes these GEMMs are light (K, N <=
// 1024).  The tensor-core kernels add to their bytes the prologue (expf
// and two divisions per element at f32 CUDA-core rates, without FMA
// contraction), repeated per column block of the forward and per N tile
// of dW, and its derivative in dx's epilogue; dx and dW each read dy and
// y.  The f32 kernels are bound by the CUDA cores' f32 FMA rate (67
// TFLOP/s peak).
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

// ------------------------------------ backward on tensor cores (bf16)

// The inputs of one tensor-core backward, their K ranges taken as one
// column space of ktot = sum K_i columns (input i holds columns koff_i
// .. koff_i + K_i): per input its operands and outputs (a, b null
// without a prologue).  da and db are the column space's (f64, ktot).
struct BwdInputs {
  const void* x[MAX_INPUTS];
  const void* w[MAX_INPUTS];
  const float* a[MAX_INPUTS];
  const float* b[MAX_INPUTS];
  void* dx[MAX_INPUTS];
  float* dw[MAX_INPUTS];
  int k[MAX_INPUTS];
  int koff[MAX_INPUTS];
  int count;
  int ktot;
};

// the input that holds column gc (0 <= gc < ktot)
__device__ __forceinline__ int input_at(const BwdInputs& in, int gc) {
  int i = 0;
  while (i + 1 < in.count && in.koff[i + 1] <= gc) ++i;
  return i;
}

// The ds1 fold: c[gc] = sum_n T(ds1[n]) * w_i[gc - koff_i, n] in f32, one
// warp per column (a row of the stacked w_i; ds1 rounded to bf16 first,
// as the TPU kernel rounds its third product's operand).
__global__ void fused_gemm_ctab_kernel(BwdInputs in,
                                       const float* __restrict__ ds1,
                                       float* __restrict__ ctab, int n) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= in.ktot) return;
  const int i = input_at(in, row);
  const __nv_bfloat16* wr =
      (const __nv_bfloat16*)in.w[i] + (int64_t)(row - in.koff[i]) * n;
  float s = 0.f;
  for (int j = lane; j < n; j += 32)
    s = fmaf(round_to<__nv_bfloat16>(ds1[j]), __bfloat162float(wr[j]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) ctab[row] = s;
}

// The dx kernel's shared memory: a ring of 2 stages, each the dy and y
// tiles [128 rows][32 + 8] and the w tile [BN columns][32 + 8] (rows of
// w are n-contiguous), or the epilogue, whichever is larger; then the x
// tile of the block's columns [128][BN + 8], copied while the ring runs,
// and the columns' a, b and prologue flag (f32 each).
constexpr int DX_STAGES = 2;
template <class TL>
struct DxSmem {
  static constexpr int A_ELEMS = tc::BM * tc::RING_APITCH;
  static constexpr int W_ELEMS = TL::BN * tc::RING_APITCH;
  static constexpr int STAGE_ELEMS = 2 * A_ELEMS + W_ELEMS;
  static constexpr int PIPE_BYTES = DX_STAGES * STAGE_ELEMS * 2;
  static constexpr int BODY =
      PIPE_BYTES > TL::EPI_BYTES ? PIPE_BYTES : TL::EPI_BYTES;
  static constexpr int XPITCH = TL::BN + 8;
  static constexpr int X_BYTES = tc::BM * XPITCH * 2;
  static constexpr int BYTES = BODY + X_BYTES + 3 * TL::BN * 4;
};

// dg = dy @ w^T + T(y * T(2 ds2)) @ w^T + c over rows blockIdx.x * 128 ..
// + 128 and columns c0 = blockIdx.y * BN .. + BN of the column space
// (which may span inputs: K_i % 8 == 0, so 8 columns lie in one); for a
// column with a prologue dz = dg * act'(x a + b), dx = T(dz a), da +=
// sum_m dz x, db += sum_m dz; without one dx = T(dg).  PRO: some input
// has a prologue.
template <int ACT, bool PRO, class TL>
__global__ void __launch_bounds__(tc::THREADS, 2)
fused_gemm_dx_tc_kernel(BwdInputs in, const __nv_bfloat16* __restrict__ y,
                        const __nv_bfloat16* __restrict__ dy,
                        const float* __restrict__ ds2,
                        const float* __restrict__ ctab,
                        double* __restrict__ da, double* __restrict__ db,
                        int m_total, int n_total) {
  using SM = DxSmem<TL>;
  constexpr int BN = TL::BN, BK = tc::RING_BK, APITCH = tc::RING_APITCH;
  constexpr int CHUNKS = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + SM::BODY);
  float* pa_s = reinterpret_cast<float*>(smem + SM::BODY + SM::X_BYTES);
  float* pb_s = pa_s + BN;
  float* on_s = pb_s + BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int64_t m0 = (int64_t)blockIdx.x * tc::BM;
  const int c0 = blockIdx.y * BN;
  const int slices = (n_total + BK - 1) / BK;

  if (PRO) {
    // the columns' prologue coefficients, and the x tile of the columns
    // that have one (this thread's 8-column chunk is tid % CHUNKS)
    if (tid < BN) {
      const int gc = c0 + tid;
      float a = 1.f, b = 0.f, on = 0.f;
      if (gc < in.ktot) {
        const int i = input_at(in, gc);
        if (in.a[i] != nullptr) {
          a = in.a[i][gc - in.koff[i]];
          b = in.b[i][gc - in.koff[i]];
          on = 1.f;
        }
      }
      pa_s[tid] = a;
      pb_s[tid] = b;
      on_s[tid] = on;
    }
    const int ch = tid % CHUNKS, gc = c0 + ch * 8;
    const __nv_bfloat16* xb = nullptr;
    int kx = 0;
    if (gc < in.ktot) {
      const int i = input_at(in, gc);
      if (in.a[i] != nullptr) {
        xb = (const __nv_bfloat16*)in.x[i] + (gc - in.koff[i]);
        kx = in.k[i];
      }
    }
    for (int i = tid; i < tc::BM * CHUNKS; i += tc::THREADS) {
      const int r = i / CHUNKS;
      const int64_t m = m0 + r;
      const bool ok = xb != nullptr && m < m_total;
      tc::cp_async16(xs + r * SM::XPITCH + ch * 8, ok ? xb + m * kx : y,
                     ok);
    }
    tc::cp_async_commit();
  }
  // this thread's rows of the w tile (columns of the column space):
  // kr = i / 4 for i = tid + 256 j, 16-byte chunk i % 4 of the slice
  constexpr int W_COPIES = (BN * 4 + tc::THREADS - 1) / tc::THREADS;
  const __nv_bfloat16* wrow[W_COPIES];
#pragma unroll
  for (int j = 0; j < W_COPIES; ++j) {
    const int gc = c0 + ((tid + tc::THREADS * j) >> 2);
    wrow[j] = nullptr;
    if (tid + tc::THREADS * j < BN * 4 && gc < in.ktot) {
      const int i = input_at(in, gc);
      wrow[j] = (const __nv_bfloat16*)in.w[i]
                + (int64_t)(gc - in.koff[i]) * n_total;
    }
  }

  // copies of the slice n0 .. n0 + 32: this thread's 16-byte chunk
  // (tid % 4) of dy and y rows tid / 4 and tid / 4 + 64, and its w rows
  const int a_chunk = tid & 3;
  auto copy_slice = [&](int stage, int n0) {
    __nv_bfloat16* ds = ring + stage * SM::STAGE_ELEMS;
    __nv_bfloat16* ys = ds + SM::A_ELEMS;
    __nv_bfloat16* ws = ys + SM::A_ELEMS;
    const int nn = n0 + a_chunk * 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (tid >> 2) + 64 * r;
      const int64_t m = m0 + row;
      const bool ok = m < m_total && nn < n_total;
      const int64_t off = ok ? m * n_total + nn : 0;
      tc::cp_async16(ds + row * APITCH + a_chunk * 8, dy + off, ok);
      tc::cp_async16(ys + row * APITCH + a_chunk * 8, y + off, ok);
    }
#pragma unroll
    for (int j = 0; j < W_COPIES; ++j) {
      const int i = tid + tc::THREADS * j;
      if (i < BN * 4) {
        const bool ok = wrow[j] != nullptr && nn < n_total;
        tc::cp_async16(ws + (i >> 2) * APITCH + a_chunk * 8,
                       ok ? wrow[j] + nn : y, ok);
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

  copy_slice(0, 0);
  tc::cp_async_commit();
  for (int kt = 0; kt < slices; ++kt) {
    // the next slice's copies go to the stage the last slice used (all
    // threads left it at the loop's end); then this slice has landed
    if (kt + 1 < slices) copy_slice((kt + 1) & 1, (kt + 1) * BK);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ds = ring + (kt & 1) * SM::STAGE_ELEMS;
    __nv_bfloat16* ys = ring + (kt & 1) * SM::STAGE_ELEMS + SM::A_ELEMS;
    const __nv_bfloat16* ws = ys + SM::A_ELEMS;
    {
      // y -> T(y * T(2 ds2)) in place, once per element: thread owns
      // column pair tid % 16 of rows tid / 16 + 16 j (N % 8 == 0, so a
      // pair lies wholly inside or past N; past it y is 0)
      const int c = 2 * (tid & 15), nn = kt * BK + c;
      float t0 = 0.f, t1 = 0.f;
      if (nn < n_total) {
        t0 = round_to<__nv_bfloat16>(2.0f * ds2[nn]);
        t1 = round_to<__nv_bfloat16>(2.0f * ds2[nn + 1]);
      }
#pragma unroll
      for (int j = 0; j < tc::BM / 16; ++j) {
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
            ys + ((tid >> 4) + 16 * j) * APITCH + c);
        const float2 v = __bfloat1622float2(*e);
        *e = __floats2bfloat162_rn(v.x * t0, v.y * t1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // both A tiles (dy and the built y term) against one B fragment
      // pair per 16 columns: w's [column][n] rows, ldmatrix without .trans
      uint32_t af[2][TL::MI][4];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi) {
        const int off = (wm * TL::WTM + mi * 16 + (lane & 15)) * APITCH + kk
                        + (lane >> 4) * 8;
        tc::ldsm_x4(af[0][mi], ds + off);
        tc::ldsm_x4(af[1][mi], ys + off);
      }
#pragma unroll
      for (int nj = 0; nj < TL::NI / 2; ++nj) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, ws + (wn * TL::WTN + nj * 16 + (lane >> 4) * 8
                              + (lane & 7)) * APITCH
                            + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int mi = 0; mi < TL::MI; ++mi) {
            tc::mma_bf16(acc[mi][2 * nj], af[t][mi], bf[0], bf[1]);
            tc::mma_bf16(acc[mi][2 * nj + 1], af[t][mi], bf[2], bf[3]);
          }
      }
    }
    __syncthreads();   // the next copies may overwrite this stage
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // rows are row indices m here; each input's dx has its own pitch K_i
  auto row_of = [&](int r) -> int64_t {
    const int64_t m = m0 + r;
    return m < m_total ? m : -1;
  };
  auto store = [&](int64_t m, int c, const uint4& v) {
    const int i = input_at(in, c);
    *reinterpret_cast<uint4*>((__nv_bfloat16*)in.dx[i] + m * in.k[i]
                              + (c - in.koff[i])) = v;
  };
  tc::epilogue_to<TL, PRO>(
      acc, smem, c0, in.ktot, row_of,
      [&](int r, int c, float v0, float v1, float2& t1,
          float2& t2) -> __nv_bfloat162 {
        t1 = t2 = make_float2(0.f, 0.f);
        if (c >= in.ktot) return __floats2bfloat162_rn(0.f, 0.f);
        const float d0 = v0 + ctab[c], d1 = v1 + ctab[c + 1];
        const int lc = c - c0;
        if (!PRO || on_s[lc] == 0.f) return __floats2bfloat162_rn(d0, d1);
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * SM::XPITCH
                                                     + lc));
        const float a0 = pa_s[lc], a1 = pa_s[lc + 1];
        float g0, gp0, g1, gp1;
        act_and_grad<ACT>(xf.x * a0 + pb_s[lc], g0, gp0);
        act_and_grad<ACT>(xf.y * a1 + pb_s[lc + 1], g1, gp1);
        const float z0 = d0 * gp0, z1 = d1 * gp1;
        t1 = make_float2(z0 * xf.x, z1 * xf.y);
        t2 = make_float2(z0, z1);
        return __floats2bfloat162_rn(z0 * a0, z1 * a1);
      },
      store, da, db);
}

// The dW kernel's tile of the column space x N (8 warps as 2 x 4) and
// ring: per stage the x tile [32 rows][TK + 8], the dy tile [32][TN + 8]
// (dyt is built in it) and the y tile [32][TN].
constexpr int DW_STAGES = 3;
template <int TK_, int TN_>
struct DwTile {
  static constexpr int TK = TK_;
  static constexpr int TN = TN_;
  static constexpr int WARPS_N = 4;
  static constexpr int WTK = TK / 2;
  static constexpr int WTN = TN / WARPS_N;
  static constexpr int MI = WTK / 16;
  static constexpr int NI = WTN / 8;
  static constexpr int XPITCH = TK + 8;
  static constexpr int DPITCH = TN + 8;
  static constexpr int X_ELEMS = tc::RING_BK * XPITCH;
  static constexpr int D_ELEMS = tc::RING_BK * DPITCH;
  static constexpr int STAGE_ELEMS = X_ELEMS + D_ELEMS + tc::RING_BK * TN;
  static constexpr int BYTES = DW_STAGES * STAGE_ELEMS * 2;
  static_assert(WTK % 16 == 0 && WTN % 16 == 0, "whole x4 ldmatrix tiles");
};
// dW configs by the plan's id
using DwTile0 = DwTile<128, 128>;
using DwTile1 = DwTile<64, 64>;
using DwTile2 = DwTile<128, 64>;
using DwTile3 = DwTile<64, 128>;

// dW[k0 .. k0 + TK, c0 .. c0 + TN] of the column space += sum over the
// rows of this block's chunk (blockIdx.x) of g[m, k] * dyt[m, n], with g
// = T(act(x a + b)) for a column with a prologue (x without one) and dyt
// = T(dy + ds1 + 2 y ds2), each built once per element in shared memory
// (rows past the chunk stay 0: act(0 a + b) and ds1 are not).  k0 =
// blockIdx.y * TK, c0 = blockIdx.z * TN; row k of the tile adds into
// dW_i[k - koff_i] of the input that holds it.
template <int ACT, bool PRO, class DT>
__global__ void __launch_bounds__(tc::THREADS, 2)
fused_gemm_dw_tc_kernel(BwdInputs in, const __nv_bfloat16* __restrict__ y,
                        const __nv_bfloat16* __restrict__ dy,
                        const float* __restrict__ ds1,
                        const float* __restrict__ ds2, int m_total,
                        int n_total, int rows_per_chunk) {
  constexpr int BK = tc::RING_BK, STAGES = DW_STAGES;
  constexpr int TK = DT::TK, TN = DT::TN;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp / DT::WARPS_N, wn = warp % DT::WARPS_N;
  const int k0 = blockIdx.y * TK;
  const int c0 = blockIdx.z * TN;
  const int64_t m_begin = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t m_end = m_begin + rows_per_chunk < m_total
                            ? m_begin + rows_per_chunk : (int64_t)m_total;
  if (m_begin >= m_end) return;
  const int slices = (int)((m_end - m_begin + BK - 1) / BK);

  // this thread's 8-column chunk of the x tile (tid % (TK / 8)): its
  // input's columns, or none past the column space
  constexpr int X_CHUNKS = TK / 8;
  const int xch = tid % X_CHUNKS;
  const __nv_bfloat16* xb = nullptr;
  int kx = 0;
  if (k0 + xch * 8 < in.ktot) {
    const int i = input_at(in, k0 + xch * 8);
    xb = (const __nv_bfloat16*)in.x[i] + (k0 + xch * 8 - in.koff[i]);
    kx = in.k[i];
  }
  // the prologue: thread owns column pair tid % (TK / 2), rows
  // tid / (TK / 2) + j * K_STEP
  constexpr int K_PAIRS = TK / 2, K_STEP = tc::THREADS / K_PAIRS;
  const int kc = 2 * (tid % K_PAIRS), kr = tid / K_PAIRS;
  bool k_on = false;
  float a0 = 1.f, a1 = 1.f, b0 = 0.f, b1 = 0.f;
  if (PRO && k0 + kc < in.ktot) {
    const int i = input_at(in, k0 + kc);
    if (in.a[i] != nullptr) {
      const int lk = k0 + kc - in.koff[i];
      a0 = in.a[i][lk];
      a1 = in.a[i][lk + 1];
      b0 = in.b[i][lk];
      b1 = in.b[i][lk + 1];
      k_on = true;
    }
  }
  // the cotangent: thread owns column pair tid % (TN / 2) of dy, rows
  // tid / (TN / 2) + j * N_STEP
  constexpr int N_PAIRS = TN / 2, N_STEP = tc::THREADS / N_PAIRS;
  const int nc = 2 * (tid % N_PAIRS), nr = tid / N_PAIRS;
  const bool n_on = c0 + nc < n_total;
  float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;     // ds1, ds2
  if (n_on) {
    u0 = ds1[c0 + nc];
    u1 = ds1[c0 + nc + 1];
    v0 = ds2[c0 + nc];
    v1 = ds2[c0 + nc + 1];
  }

  auto copy_slice = [&](int stage, int64_t mb) {
    __nv_bfloat16* xs = ring + stage * DT::STAGE_ELEMS;
    __nv_bfloat16* ds = xs + DT::X_ELEMS;
    __nv_bfloat16* ys = ds + DT::D_ELEMS;
    for (int i = tid; i < BK * X_CHUNKS; i += tc::THREADS) {
      const int64_t m = mb + i / X_CHUNKS;
      const bool ok = xb != nullptr && m < m_end;
      tc::cp_async16(xs + (i / X_CHUNKS) * DT::XPITCH + xch * 8,
                     ok ? xb + m * kx : y, ok);
    }
    for (int i = tid; i < BK * (TN / 8); i += tc::THREADS) {
      const int r = i / (TN / 8), ch = i % (TN / 8);
      const int64_t m = mb + r;
      const bool ok = m < m_end && c0 + ch * 8 < n_total;
      const int64_t off = ok ? m * n_total + c0 + ch * 8 : 0;
      tc::cp_async16(ds + r * DT::DPITCH + ch * 8, dy + off, ok);
      tc::cp_async16(ys + r * TN + ch * 8, y + off, ok);
    }
  };

  float acc[DT::MI][DT::NI][4];
#pragma unroll
  for (int mi = 0; mi < DT::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < DT::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  // this lane's ldmatrix .trans addresses at slice row 0: A = g [m][k]
  // (row index = contraction m), B = dyt [m][n]
  const int a_off = ((lane >> 4) * 8 + (lane & 7)) * DT::XPITCH
                    + wk * DT::WTK + ((lane >> 3) & 1) * 8;
  const int b_off = (lane & 15) * DT::DPITCH + wn * DT::WTN + (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) copy_slice(s, m_begin + s * BK);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice kt has landed; slice kt - 1 is consumed
    if (kt + STAGES - 1 < slices)
      copy_slice((kt + STAGES - 1) % STAGES,
                 m_begin + (int64_t)(kt + STAGES - 1) * BK);
    tc::cp_async_commit();
    __nv_bfloat16* xs = ring + (kt % STAGES) * DT::STAGE_ELEMS;
    __nv_bfloat16* ds = xs + DT::X_ELEMS;
    const __nv_bfloat16* ys = ds + DT::D_ELEMS;
    const int64_t mb = m_begin + (int64_t)kt * BK;
    if (k_on) {
#pragma unroll
      for (int j = 0; j < BK / K_STEP; ++j) {
        const int r = kr + j * K_STEP;
        if (mb + r >= m_end) continue;
        __nv_bfloat162* e =
            reinterpret_cast<__nv_bfloat162*>(xs + r * DT::XPITCH + kc);
        const float2 v = __bfloat1622float2(*e);
        *e = __floats2bfloat162_rn(act_only<ACT>(v.x * a0 + b0),
                                   act_only<ACT>(v.y * a1 + b1));
      }
    }
    if (n_on) {
#pragma unroll
      for (int j = 0; j < BK / N_STEP; ++j) {
        const int r = nr + j * N_STEP;
        if (mb + r >= m_end) continue;
        __nv_bfloat162* e =
            reinterpret_cast<__nv_bfloat162*>(ds + r * DT::DPITCH + nc);
        const float2 d = __bfloat1622float2(*e);
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ys + r * TN + nc));
        *e = __floats2bfloat162_rn((d.x + u0) + (2.0f * v.x) * v0,
                                   (d.y + u1) + (2.0f * v.y) * v1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const __nv_bfloat16* a[DT::MI];
      const __nv_bfloat16* b[DT::NI / 2];
#pragma unroll
      for (int mi = 0; mi < DT::MI; ++mi)
        a[mi] = xs + a_off + kk * DT::XPITCH + mi * 16;
#pragma unroll
      for (int nj = 0; nj < DT::NI / 2; ++nj)
        b[nj] = ds + b_off + kk * DT::DPITCH + nj * 16;
      tc::mma_step<DT::MI, DT::NI, true, true>(acc, a, b);
    }
  }
  tc::cp_async_wait<0>();

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < DT::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wk * DT::WTK + mi * 16 + gq + 8 * h;
      if (k >= in.ktot) continue;
      const int i = input_at(in, k);
      float* row = in.dw[i] + (int64_t)(k - in.koff[i]) * n_total;
#pragma unroll
      for (int ni = 0; ni < DT::NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = c0 + wn * DT::WTN + ni * 8 + 2 * tq + j;
          if (n < n_total) atomicAdd(row + n, acc[mi][ni][2 * h + j]);
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

struct BwdTcPlan {
  int dx_config;
  dim3 dx_grid;
  int dx_smem;
  int dw_config;
  dim3 dw_grid;
  int dw_smem;
  int dw_rows;
};

template <int ACT, bool PRO, class TL, class DT>
int launch_bwd_tc(const BwdInputs& in, const void* y, const void* dy,
                  const float* ds1, const float* ds2, float* ctab,
                  double* da, double* db, int m, int n, const BwdTcPlan& p,
                  cudaStream_t stream) {
  // the plan must be this config's: shared memory, and grids that cover
  // the column space, N and the rows
  if (n % 8 || p.dx_smem != DxSmem<TL>::BYTES || p.dw_smem != DT::BYTES
      || p.dx_grid.x != (unsigned)((m + tc::BM - 1) / tc::BM)
      || p.dx_grid.y != (unsigned)((in.ktot + TL::BN - 1) / TL::BN)
      || p.dw_grid.y != (unsigned)((in.ktot + DT::TK - 1) / DT::TK)
      || p.dw_grid.z != (unsigned)((n + DT::TN - 1) / DT::TN)
      || p.dw_rows < 1 || p.dw_rows % tc::RING_BK
      || (int64_t)p.dw_grid.x * p.dw_rows < m)
    return (int)cudaErrorInvalidValue;
  fused_gemm_ctab_kernel<<<(in.ktot + 7) / 8, 256, 0, stream>>>(in, ds1,
                                                                ctab, n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto dx_kernel = fused_gemm_dx_tc_kernel<ACT, PRO, TL>;
  static int dx_allowed[tc::MAX_DEVICES] = {0};   // per instance and device
  err = tc::allow_smem((const void*)dx_kernel, p.dx_smem, dx_allowed);
  if (err != 0) return err;
  dx_kernel<<<p.dx_grid, tc::THREADS, p.dx_smem, stream>>>(
      in, (const __nv_bfloat16*)y, (const __nv_bfloat16*)dy, ds2, ctab, da,
      db, m, n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto dw_kernel = fused_gemm_dw_tc_kernel<ACT, PRO, DT>;
  static int dw_allowed[tc::MAX_DEVICES] = {0};
  err = tc::allow_smem((const void*)dw_kernel, p.dw_smem, dw_allowed);
  if (err != 0) return err;
  dw_kernel<<<p.dw_grid, tc::THREADS, p.dw_smem, stream>>>(
      in, (const __nv_bfloat16*)y, (const __nv_bfloat16*)dy, ds1, ds2, m, n,
      p.dw_rows);
  return (int)cudaGetLastError();
}

template <class TL, class DT>
int bwd_tc_by_act(const BwdInputs& in, const void* y, const void* dy,
                  const float* ds1, const float* ds2, float* ctab,
                  double* da, double* db, int m, int n, int act,
                  const BwdTcPlan& p, cudaStream_t stream) {
  bool pro = false;
  for (int i = 0; i < in.count; ++i) pro |= in.a[i] != nullptr;
  if (!pro)
    return launch_bwd_tc<ACT_LINEAR, false, TL, DT>(
        in, y, dy, ds1, ds2, ctab, da, db, m, n, p, stream);
  if (act == ACT_MISH)
    return launch_bwd_tc<ACT_MISH, true, TL, DT>(
        in, y, dy, ds1, ds2, ctab, da, db, m, n, p, stream);
  if (act == ACT_LEAKY)
    return launch_bwd_tc<ACT_LEAKY, true, TL, DT>(
        in, y, dy, ds1, ds2, ctab, da, db, m, n, p, stream);
  if (act == ACT_LINEAR)
    return launch_bwd_tc<ACT_LINEAR, true, TL, DT>(
        in, y, dy, ds1, ds2, ctab, da, db, m, n, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <class TL>
int bwd_tc_by_dw(const BwdInputs& in, const void* y, const void* dy,
                 const float* ds1, const float* ds2, float* ctab, double* da,
                 double* db, int m, int n, int act, const BwdTcPlan& p,
                 cudaStream_t stream) {
  switch (p.dw_config) {
    case 0:
      return bwd_tc_by_act<TL, DwTile0>(in, y, dy, ds1, ds2, ctab, da, db, m,
                                        n, act, p, stream);
    case 1:
      return bwd_tc_by_act<TL, DwTile1>(in, y, dy, ds1, ds2, ctab, da, db, m,
                                        n, act, p, stream);
    case 2:
      return bwd_tc_by_act<TL, DwTile2>(in, y, dy, ds1, ds2, ctab, da, db, m,
                                        n, act, p, stream);
    case 3:
      return bwd_tc_by_act<TL, DwTile3>(in, y, dy, ds1, ds2, ctab, da, db, m,
                                        n, act, p, stream);
  }
  return (int)cudaErrorInvalidValue;
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

// Backward on the tensor cores, bf16 only, all inputs at once, their K
// ranges one column space of sum K_i columns: the ds1 table (into ctab,
// sum K_i f32 of scratch), the dx kernel, then the dW kernel.  xs, ws,
// aas, bbs, ks, count as the forward's; dxs, dws: host arrays of the
// inputs' dx and dW; da, db: the column space's (f64, sum K_i, one
// input's entries at its offset; untouched for an input without a
// prologue).  dW (f32), da and db must be zeroed.  dx_config (0, 1, 2:
// BN = 128, 64, 32), dw_config (0-3: tiles of 128 x 128, 64 x 64,
// 128 x 64, 64 x 128 of the column space x N), the grids, the shared
// memory and dw_rows (rows a chunk of the dW grid.x, a multiple of 32)
// come from the Python plan.  Every K_i and N must be multiples of 8,
// and x_i, w_i, y, dy, dx_i 16-byte aligned.  Returns the first nonzero
// cudaError_t of the three launches.
extern "C" int fused_gemm_bwd_tc_launch(
    const void* const* xs, const void* const* ws, const void* const* aas,
    const void* const* bbs, const int* ks, int count, const void* y,
    const void* dy, const float* ds1, const float* ds2, float* ctab,
    void* const* dxs, void* const* dws, double* da, double* db, int m,
    int n, int act, int dx_config, int dx_grid_x, int dx_grid_y,
    int dx_smem, int dw_config, int dw_grid_x, int dw_grid_y,
    int dw_grid_z, int dw_smem, int dw_rows, void* stream) {
  if (count < 1 || count > MAX_INPUTS || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  BwdInputs in;
  in.count = count;
  in.ktot = 0;
  for (int i = 0; i < count; ++i) {
    if (ks[i] < 1 || ks[i] % 8) return (int)cudaErrorInvalidValue;
    in.x[i] = xs[i];
    in.w[i] = ws[i];
    in.a[i] = (const float*)aas[i];
    in.b[i] = (const float*)bbs[i];
    in.dx[i] = dxs[i];
    in.dw[i] = (float*)dws[i];
    in.k[i] = ks[i];
    in.koff[i] = in.ktot;
    in.ktot += ks[i];
  }
  const BwdTcPlan p{dx_config,
                    dim3((unsigned)dx_grid_x, (unsigned)dx_grid_y),
                    dx_smem,
                    dw_config,
                    dim3((unsigned)dw_grid_x, (unsigned)dw_grid_y,
                         (unsigned)dw_grid_z),
                    dw_smem,
                    dw_rows};
  cudaStream_t s = (cudaStream_t)stream;
  if (dx_config == 0)
    return bwd_tc_by_dw<tc::Tile128>(in, y, dy, ds1, ds2, ctab, da, db, m, n,
                                     act, p, s);
  if (dx_config == 1)
    return bwd_tc_by_dw<tc::Tile64>(in, y, dy, ds1, ds2, ctab, da, db, m, n,
                                    act, p, s);
  if (dx_config == 2)
    return bwd_tc_by_dw<tc::Tile32>(in, y, dy, ds1, ds2, ctab, da, db, m, n,
                                    act, p, s);
  return (int)cudaErrorInvalidValue;
}
