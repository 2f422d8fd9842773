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
// * Forward: one block per 64 x 64 tile of y; the inputs' K ranges are
//   walked one after the other by a loop in the block (a concat that is
//   never stored).  The prologue runs in f32 while the A tile is staged,
//   is rounded to T as the TPU kernel rounds its MXU operand, and goes to
//   shared memory as f32 (a bf16 value is exact in f32).  256 threads,
//   4 x 4 micro-tiles, f32 FMA on the CUDA cores.  The TPU kernel adds
//   s1/s2 across its sequential grid; here each block reduces its columns
//   in shared memory (64 f32 terms) and adds one f64 atomic per column:
//   M = 86528 rows are 1352 blocks per column, and the variance
//   s2 / M - mean^2 cancels, so the cross-block sum must not lose bits.
//   The wrapper rounds the sums to f32; block order does not show.
//   With `raw_stats` the sums are of the f32 product before it is rounded
//   (the variant of tools/bench_packed_probe.py's fused_kernel).
// * Backward reads the forward's stored y where the TPU kernel recomputes
//   it in VMEM: under PyTorch the consumer keeps y alive anyway, and a
//   block could not hold a [rows, N] tile of y for N = 1024.  Two kernels
//   per input:
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
// * Any M >= 1, any K_i, N >= 1: ragged edges are zero-filled on load and
//   masked on store.
//
// What bounds it on an H100: the f32 FMA rate of the CUDA cores (67
// TFLOP/s peak), far under the bf16 tensor cores; by bytes these GEMMs
// are memory-light.  Tensor cores (mma.sync / wgmma) are later work.
//
// Built with --fmad=false so that the prologue's f32 chain rounds as the
// plain PyTorch version does (no contraction); the GEMM loops call fmaf
// explicitly.

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

// Forward.  xs, ws, aas, bbs: host arrays of `count` device pointers (an
// entry of `aas` is null for an input without a prologue); ks: host array
// of the K_i.  dtype: 0 = float32, 1 = bfloat16.  act: 0 mish, 1 leaky,
// 2 linear.  s1 and s2 are zeroed f64 buffers; they sum the rounded y,
// or with raw_stats != 0 the f32 product before rounding.  Returns the
// cudaError_t of the launch.
extern "C" int fused_gemm_fwd_launch(const void* const* xs,
                                     const void* const* ws,
                                     const void* const* aas,
                                     const void* const* bbs, const int* ks,
                                     int count, void* y, double* s1,
                                     double* s2, int m, int n, int dtype,
                                     int act, int raw_stats, void* stream) {
  if (count < 1 || count > MAX_INPUTS || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  FwdInputs in;
  in.count = count;
  for (int i = 0; i < count; ++i) {
    in.x[i] = xs[i];
    in.w[i] = ws[i];
    in.a[i] = (const float*)aas[i];
    in.b[i] = (const float*)bbs[i];
    in.k[i] = ks[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH(launch_fwd, in, y, s1, s2, m, n, raw_stats, s)
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
