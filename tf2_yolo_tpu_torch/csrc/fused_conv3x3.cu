// Fused prologue + 3x3 convolution + statistics on NHWC tensors, forward
// and backward:
//
//   g = T(act(x * a + b)) inside the image, 0 outside it (x as it is
//       without a prologue),
//   y[b, ho, wo, :] = sum over the 9 taps (dh, dw) of
//       g[b, s*ho - 1 + dh, s*wo - 1 + dw, :] @ w[dh, dw],
//   s1 = sum y, s2 = sum y^2 over all pixels of the ROUNDED y (f64),
//
// and, from {x, w, a, b, y, dy, ds1, ds2}: dx (T), dW (f32), da, db
// (accumulated in f64).  T is the compute type (bf16 or f32); x is
// [B, H, W, K], w is [3, 3, K, N] (HWIO, the row-major [9K, N] matrix),
// y is [B, H/s, W/s, N], a and b are [K] f32.  s = 1 reads a SAME window;
// s = 2 the darknet window (one zero row on top, one zero column on the
// left; H and W even, so the bottom/right edge is never read).
//
// Replaces the Pallas TPU kernels of
// tf2_yolo_tpu/ops/pallas/packed_conv3x3.py: _fwd_s1_kernel and
// _fwd_s2_kernel (called from _fwd_call), _bwd_s1_kernel and
// _bwd_s2_kernel (from _bwd_call), and the cotangent fold of `bwd`.
//
// Design for Hopper, not a block-by-block copy.  The TPU kernels work on
// (h, w, b)-major rows with halo blocks, clamped index maps and edge
// gates; here every kernel is an implicit GEMM over the contiguous NHWC
// tensor whose A operand is gathered by index, zero where the window
// leaves the image:
//
// * Forward: M = B*Ho*Wo output pixels, N columns, contraction over the
//   9K (tap, channel) pairs.  Two kernels, chosen per shape by the Python
//   plan (ops/kernels/fused_conv3x3.py, _tc_plan), which passes the
//   config, the grid and the dynamic shared memory:
//   - fused_conv3x3_fwd_tc_kernel, bf16 with K % 16 == 0 and N % 8 == 0
//     (all five layers of packed=3): tensor cores.  A block takes an
//     8 x 16 tile of output pixels and all of N <= 128 (BN 128 or 64), so
//     the prologue is not repeated per column block.  Per slice of 16
//     input channels it copies the raw input halo of the tile,
//     (s*7 + 3) x (s*15 + 3) pixels, and the slice's nine weight taps
//     with 16-byte cp.async copies (zero outside the image), runs the
//     prologue ONCE per halo element in f32 and rounds it to bf16 in
//     shared memory, then reads nine shifted A tiles of the halo through
//     ldmatrix (stride 2 reads every other column: the halo rows keep the
//     even columns apart from the odd ones, so an ldmatrix still reads 8
//     consecutive slots) into mma.sync m16n8k16 with f32 accumulators.
//   - fused_conv3x3_fwd_kernel, f32 (the tensor cores' f32 route would be
//     TF32) and bf16 shapes the tensor-core kernel does not take (K = 3):
//     one block per 64 x 64 tile on the CUDA cores; the prologue runs in
//     f32 while the A slice is gathered, once per tap that reads an
//     element.
//   Both round g to T as the TPU kernel rounds its MXU operand, and gate
//   after the prologue: a pixel outside the image contributes 0, not
//   act(b).  Statistics: per-block column sums of the rounded y, one f64
//   atomic per column.
// * Backward, dx kernel: M = input pixels, columns = the K input
//   channels, contraction over (tap, n) of
//       e = T(dy + y * (2 ds2)) + ds1   where the tap's output pixel
//                                       exists, else 0
//   with w[tap]^T.  The fold dy + 2 y ds2 (a separate pass before the TPU
//   kernel) is computed in the load and rounded to T as there; ds1 is
//   added to the rounded value in f32 and is not rounded (the TPU kernel
//   keeps it as an exact f32 broadcast term).  At stride 2 an input pixel
//   receives only from the taps whose parity matches, so grid.z walks the
//   four parity classes (hi mod 2, wi mod 2) and a block visits 1, 2 or 4
//   taps, never 9.  The epilogue recomputes the prologue's derivative,
//   writes dx and reduces da, db over the block's rows (f64 atomics).
// * Backward, dW kernel: tile [64 of the 9K rows, 64 of N], contraction
//   over a chunk of M_CHUNK output pixels (split-M: grid.z walks the
//   chunks, tiles are added with f32 atomics into a zeroed dW).
//   Operands: the gathered, recomputed g and dyt = T(T(dy + 2 y ds2) +
//   ds1).
// * Any B, H, W, K, N >= 1 (K = 3 included): ragged edges are zero-filled
//   on load and masked on store.  Element offsets are 64-bit.
//
// What bounds it on an H100: the forward's layers are bound by bytes
// (K, N <= 128: 0.02-0.16 ms at batch 32); the tensor-core kernel adds
// to those the prologue (expf and two divisions per halo element, at
// f32 CUDA-core rates and without FMA contraction) and its halo overlap
// (1.4x the tile's input at stride 1, 1.1x at stride 2).  The f32
// forward and the backward kernels run on the CUDA cores, bound by their
// FMA rate (67 TFLOP/s peak).
//
// Built with --fmad=false (see fused_common.cuh).

#include "conv_mma.cuh"
#include "fused_common.cuh"

namespace {

struct Geom {
  int b, h, w, k, n;       // input [b, h, w, k], n output channels
  int ho, wo, stride;      // output [b, ho, wo, n]
};

// ------------------------------------------------------------- forward

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ pa,
                         const float* __restrict__ pb, T* __restrict__ y,
                         double* __restrict__ s1, double* __restrict__ s2,
                         Geom g) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int64_t m_total = (int64_t)g.b * g.ho * g.wo;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int k_total = 9 * g.k;
  // A loads: thread owns k-lane (tid % BK) and rows (tid / BK) + 16 r
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_b[4], a_hi[4], a_wi[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int64_t m = m0 + a_m + 16 * r;
    a_ok[r] = m < m_total;
    int64_t mm = a_ok[r] ? m : 0;
    int wo_i = (int)(mm % g.wo);
    int64_t t = mm / g.wo;
    int ho_i = (int)(t % g.ho);
    a_b[r] = (int)(t / g.ho);
    a_hi[r] = ho_i * g.stride - 1;
    a_wi[r] = wo_i * g.stride - 1;
  }
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

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    {
      int kk = k0 + a_k;
      bool k_ok = kk < k_total;
      int c = 0, dh = 0, dw = 0;
      float sa = 1.f, sb = 0.f;
      if (k_ok) {
        c = kk % g.k;
        int tap = kk / g.k;
        dw = tap % 3;
        dh = tap / 3;
        if (pa != nullptr) {
          sa = pa[c];
          sb = pb[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int hi = a_hi[r] + dh;
        int wi = a_wi[r] + dw;
        float v = 0.f;
        if (k_ok && a_ok[r] && hi >= 0 && hi < g.h && wi >= 0 && wi < g.w) {
          v = to_f32(x[(((int64_t)a_b[r] * g.h + hi) * g.w + wi) * g.k + c]);
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
      if (kk < k_total && cc < g.n) v = to_f32(w[(int64_t)kk * g.n + cc]);
      Bs[b_k + r][b_c] = v;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float p1[4] = {0.f, 0.f, 0.f, 0.f};
  float p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int cc = c0 + tx * 4 + j;
    if (cc >= g.n) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int64_t m = m0 + ty * 4 + i;
      if (m >= m_total) continue;
      T yr = from_f32<T>(acc[i][j]);
      y[m * g.n + cc] = yr;
      float yv = to_f32(yr);
      p1[j] += yv;
      p2[j] += yv * yv;
    }
  }
  column_atomic_add(As, p1, ty, tx, tid, c0, g.n, s1);
  column_atomic_add(As, p2, ty, tx, tid, c0, g.n, s2);
}

// ------------------------------------------ forward on tensor cores (bf16)

constexpr int TC_TH = 8, TC_TW = 16;   // output tile: 8 rows x 16 columns
constexpr int TC_KC = 16;              // input channels per slice
constexpr int TC_HPITCH = TC_KC + 8;   // bf16 per halo pixel: 48 bytes, so
                                       // 8 consecutive pixels hit 8 banks

// The block's halo of one channel slice and the slice's nine weight
// taps.  A halo row holds the HW input columns of the tile's window; at
// stride 2 the even columns come first, then the odd ones, so that at
// every tap the 8 output pixels of one ldmatrix read 8 consecutive
// slots: column ox * STRIDE + dx of the window sits at slot
// ox + slot(dx).
template <int STRIDE, class TL>
struct HaloSmem {
  static constexpr int HH = STRIDE * (TC_TH - 1) + 3;
  static constexpr int HW = STRIDE * (TC_TW - 1) + 3;
  static constexpr int HE = (HW + 1) / 2;
  static constexpr int HALO_ELEMS = HH * HW * TC_HPITCH;
  static constexpr int BPITCH = TL::BN + 8;
  static constexpr int MAIN_BYTES = (HALO_ELEMS + 9 * TC_KC * BPITCH) * 2;
  static constexpr int BYTES =
      MAIN_BYTES > TL::EPI_BYTES ? MAIN_BYTES : TL::EPI_BYTES;
  __device__ static __forceinline__ int slot(int hx) {
    return STRIDE == 1 ? hx : (hx & 1) * HE + (hx >> 1);
  }
};

// One block: a TC_TH x TC_TW tile of output pixels of image blockIdx.z
// (GEMM rows r = oy * TC_TW + ox, so fragment row block mi of a warp is
// one output row) against output channels blockIdx.y * BN .. + BN.  Per
// slice of 16 input channels: copy the raw halo and the nine weight taps
// with cp.async (zero outside the image), run the prologue once per halo
// element in f32 and round it to bf16 (pixels outside the image stay 0:
// the gate comes after the prologue), then nine shifted A tiles of the
// halo against the taps through ldmatrix and mma.sync.  PRO false is the
// input without a prologue.  One slice is in flight at a time: two
// blocks per SM (at most 128 registers a thread) overlap one block's
// copies and prologue with the other's products.
template <int STRIDE, int ACT, bool PRO, class TL>
__global__ void __launch_bounds__(tc::THREADS, 2)
fused_conv3x3_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ pa,
                            const float* __restrict__ pb,
                            __nv_bfloat16* __restrict__ y,
                            double* __restrict__ s1,
                            double* __restrict__ s2, Geom g) {
  using SM = HaloSmem<STRIDE, TL>;
  constexpr int BN = TL::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = halo + SM::HALO_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int tiles_x = (g.wo + TC_TW - 1) / TC_TW;
  const int oy0 = (blockIdx.x / tiles_x) * TC_TH;
  const int ox0 = (blockIdx.x % tiles_x) * TC_TW;
  const int c0 = blockIdx.y * BN;
  const int img = blockIdx.z;
  const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;
  const __nv_bfloat16* ximg = x + (int64_t)img * g.h * g.w * g.k;

  // this lane's halo element of each A fragment at tap (0, 0)
  int a_base[TL::MI];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi) {
    const int r = wm * TL::WTM + mi * 16 + (lane & 15);
    const int oy = r / TC_TW, ox = r % TC_TW;
    a_base[mi] = (oy * STRIDE * SM::HW + ox) * TC_HPITCH + (lane >> 4) * 8;
  }

  float acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int kc = 0; kc < g.k; kc += TC_KC) {
    // raw halo: two 16-byte chunks of 8 channels per pixel
    for (int i = tid; i < SM::HH * SM::HW * 2; i += tc::THREADS) {
      const int p = i >> 1, ch = i & 1;
      const int hy = p / SM::HW, hx = p % SM::HW;
      const int iy = iy0 + hy, ix = ix0 + hx;
      const bool ok = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      tc::cp_async16(
          halo + (hy * SM::HW + SM::slot(hx)) * TC_HPITCH + ch * 8,
          ok ? ximg + ((int64_t)iy * g.w + ix) * g.k + kc + ch * 8 : x, ok);
    }
    // weights: row tap * 16 + j is w[tap][kc + j][c0 .. c0 + BN)
    for (int i = tid; i < 9 * TC_KC * (BN / 8); i += tc::THREADS) {
      const int row = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const int tap = row / TC_KC, j = row % TC_KC;
      const bool ok = c0 + col < g.n;
      tc::cp_async16(
          ws + row * SM::BPITCH + col,
          ok ? w + ((int64_t)tap * g.k + kc + j) * g.n + c0 + col : w, ok);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (PRO) {
      // thread owns channel pair tid % 8 of every 32nd pixel
      const int c = kc + 2 * (tid & 7);
      const float a0 = pa[c], a1 = pa[c + 1], b0 = pb[c], b1 = pb[c + 1];
      for (int p = tid >> 3; p < SM::HH * SM::HW; p += tc::THREADS / 8) {
        const int hy = p / SM::HW, hx = p % SM::HW;
        const int iy = iy0 + hy, ix = ix0 + hx;
        if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) continue;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
            halo + (hy * SM::HW + SM::slot(hx)) * TC_HPITCH + 2 * (tid & 7));
        const float2 v = __bfloat1622float2(*e);
        *e = __floats2bfloat162_rn(act_only<ACT>(v.x * a0 + b0),
                                   act_only<ACT>(v.y * a1 + b1));
      }
      __syncthreads();
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * SM::HW + SM::slot(tap % 3)) * TC_HPITCH;
      const __nv_bfloat16* a_rows[TL::MI];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
        a_rows[mi] = halo + a_base[mi] + shift;
      tc::mma_k16<TL>(acc, a_rows,
                      ws + (tap * TC_KC + (lane & 15)) * SM::BPITCH
                          + wn * TL::WTN + (lane >> 4) * 8);
    }
    __syncthreads();   // the next slice's copies overwrite halo and ws
  }
  tc::store_tile<TL, true>(
      acc, smem, nullptr, c0, g.n,
      [&](int r) -> int64_t {
        const int oy = oy0 + r / TC_TW, ox = ox0 + r % TC_TW;
        return oy < g.ho && ox < g.wo
                   ? (((int64_t)img * g.ho + oy) * g.wo + ox) * g.n
                   : -1;
      },
      y, s1, s2);
}

// ------------------------------------------------------- backward: dx

// Input pixels of one parity class (stride 2: blockIdx.z = 2 * (hi mod 2)
// + (wi mod 2); stride 1: one class) against the K input channels:
// dg[m, k] = sum over the class's taps and n of e[m, tap, n] * w[tap, k, n];
// prologue: dz = dg * act'(z), dx = T(dz * a), da += sum dz * x,
// db += sum dz;  else dx = T(dg).
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_conv3x3_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ pa,
                        const float* __restrict__ pb, const T* __restrict__ y,
                        const T* __restrict__ dy,
                        const float* __restrict__ ds1,
                        const float* __restrict__ ds2, T* __restrict__ dx,
                        double* __restrict__ da, double* __restrict__ db,
                        Geom g) {
  __shared__ __align__(16) float As[BK][BM + 4];   // e, [n][pixel]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // w[tap]^T, [n][k]

  const int tid = threadIdx.x;
  const int s = g.stride;
  const int ph = s == 2 ? (int)(blockIdx.z >> 1) : 0;
  const int pw = s == 2 ? (int)(blockIdx.z & 1) : 0;
  const int hc = g.h / s;                          // pixels of the class
  const int wc = g.w / s;
  const int64_t m_total = (int64_t)g.b * hc * wc;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;                  // first input channel
  // both loads: thread owns n-lane (tid % BK) and 4 rows / k columns
  const int l_n = tid % BK;
  const int l_r = tid / BK;
  const int ty = tid / 16;
  const int tx = tid % 16;

  int p_b[4], p_hi[4], p_wi[4];
  bool p_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int64_t m = m0 + l_r + 16 * r;
    p_ok[r] = m < m_total;
    int64_t mm = p_ok[r] ? m : 0;
    int j = (int)(mm % wc);
    int64_t t = mm / wc;
    int i = (int)(t % hc);
    p_b[r] = (int)(t / hc);
    p_hi[r] = i * s + ph;
    p_wi[r] = j * s + pw;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int dh = 0; dh < 3; ++dh) {
    // output row ho = (hi + 1 - dh) / s must be whole: same for the block
    if (s == 2 && ((ph + 1 - dh) & 1)) continue;
    for (int dw = 0; dw < 3; ++dw) {
      if (s == 2 && ((pw + 1 - dw) & 1)) continue;
      const int tap = dh * 3 + dw;
      int64_t o_at[4];
      bool o_ok[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int th = p_hi[r] + 1 - dh;
        int tw = p_wi[r] + 1 - dw;
        int ho_i = th / s;
        int wo_i = tw / s;
        o_ok[r] = p_ok[r] && th >= 0 && tw >= 0 && ho_i < g.ho &&
                  wo_i < g.wo;
        o_at[r] = (((int64_t)p_b[r] * g.ho + ho_i) * g.wo + wo_i) * g.n;
      }
      for (int n0 = 0; n0 < g.n; n0 += BK) {
        int nn = n0 + l_n;
        bool n_ok = nn < g.n;
        float t1 = 0.f, t2 = 0.f;
        if (n_ok) {
          t1 = ds1[nn];
          t2 = 2.0f * ds2[nn];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = 0.f;
          if (n_ok && o_ok[r]) {
            int64_t at = o_at[r] + nn;
            v = round_to<T>(to_f32(dy[at]) + to_f32(y[at]) * t2) + t1;
          }
          As[l_n][l_r + 16 * r] = v;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int kk = c0 + l_r + 16 * r;
          float v = 0.f;
          if (n_ok && kk < g.k)
            v = to_f32(w[((int64_t)tap * g.k + kk) * g.n + nn]);
          Bs[l_n][l_r + 16 * r] = v;
        }
        __syncthreads();
        tile_fma(As, Bs, ty, tx, acc);
        __syncthreads();
      }
    }
  }

  // the rows of this thread's micro-tile, as offsets of their pixels
  int64_t x_at[4];
  bool x_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int64_t m = m0 + ty * 4 + i;
    x_ok[i] = m < m_total;
    int64_t mm = x_ok[i] ? m : 0;
    int j = (int)(mm % wc);
    int64_t t = mm / wc;
    int ii = (int)(t % hc);
    int bi = (int)(t / hc);
    x_at[i] = (((int64_t)bi * g.h + ii * s + ph) * g.w + j * s + pw) * g.k;
  }
  float pda[4] = {0.f, 0.f, 0.f, 0.f};
  float pdb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int kk = c0 + tx * 4 + j;
    if (kk >= g.k) continue;
    float sa = 1.f, sb = 0.f;
    if (pa != nullptr) {
      sa = pa[kk];
      sb = pb[kk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!x_ok[i]) continue;
      int64_t at = x_at[i] + kk;
      if (pa != nullptr) {
        float xf = to_f32(x[at]);
        float gv, gp;
        act_and_grad<ACT>(xf * sa + sb, gv, gp);
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
    column_atomic_add(As, pda, ty, tx, tid, c0, g.k, da);
    column_atomic_add(As, pdb, ty, tx, tid, c0, g.k, db);
  }
}

// ------------------------------------------------------- backward: dW

// dW[(tap, k), n] += sum over this block's chunk of output pixels m of
// g[pixel(m, tap), k] * dyt[m, n]
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_conv3x3_dw_kernel(const T* __restrict__ x, const float* __restrict__ pa,
                        const float* __restrict__ pb, const T* __restrict__ y,
                        const T* __restrict__ dy,
                        const float* __restrict__ ds1,
                        const float* __restrict__ ds2, float* __restrict__ dw,
                        Geom g) {
  __shared__ __align__(16) float As[BK][BM + 4];   // g, [m][(tap, k)]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // dyt, [m][n]

  const int tid = threadIdx.x;
  const int k_total = 9 * g.k;
  const int r0 = blockIdx.x * BM;                  // first (tap, k) row
  const int c0 = blockIdx.y * BN;                  // first n column
  const int64_t m_total = (int64_t)g.b * g.ho * g.wo;
  const int64_t m_begin = (int64_t)blockIdx.z * M_CHUNK;
  const int64_t m_end =
      m_begin + M_CHUNK < m_total ? m_begin + M_CHUNK : m_total;
  // both loads: thread owns column (tid % 64) and m-rows (tid / 64) * 4 + r
  const int l_c = tid % BN;
  const int l_m = (tid / BN) * 4;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const int kk = r0 + l_c;
  const bool k_ok = kk < k_total;
  int c = 0, dh = 0, dw_ = 0;
  float sa = 1.f, sb = 0.f;
  if (k_ok) {
    c = kk % g.k;
    int tap = kk / g.k;
    dw_ = tap % 3;
    dh = tap / 3;
    if (pa != nullptr) {
      sa = pa[c];
      sb = pb[c];
    }
  }
  const int nn = c0 + l_c;
  const bool n_ok = nn < g.n;
  float t1 = 0.f, t2 = 0.f;
  if (n_ok) {
    t1 = ds1[nn];
    t2 = 2.0f * ds2[nn];
  }

  // the output pixels of this thread's 4 rows; they advance by BK a step
  int o_b[4], o_h[4], o_w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int64_t m = m_begin + l_m + r;
    int64_t mm = m < m_total ? m : 0;
    o_w[r] = (int)(mm % g.wo);
    int64_t t = mm / g.wo;
    o_h[r] = (int)(t % g.ho);
    o_b[r] = (int)(t / g.ho);
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
      float gv = 0.f, d = 0.f;
      if (m < m_end) {
        int hi = o_h[r] * g.stride - 1 + dh;
        int wi = o_w[r] * g.stride - 1 + dw_;
        if (k_ok && hi >= 0 && hi < g.h && wi >= 0 && wi < g.w) {
          gv = to_f32(
              x[(((int64_t)o_b[r] * g.h + hi) * g.w + wi) * g.k + c]);
          if (pa != nullptr) gv = round_to<T>(act_only<ACT>(gv * sa + sb));
        }
        if (n_ok) {
          int64_t at = m * g.n + nn;
          d = round_to<T>(
              round_to<T>(to_f32(dy[at]) + to_f32(y[at]) * t2) + t1);
        }
      }
      As[l_m + r][l_c] = gv;
      Bs[l_m + r][l_c] = d;
      o_w[r] += BK;
      while (o_w[r] >= g.wo) {
        o_w[r] -= g.wo;
        if (++o_h[r] >= g.ho) {
          o_h[r] = 0;
          ++o_b[r];
        }
      }
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
      if (n < g.n) atomicAdd(&dw[(int64_t)k * g.n + n], acc[i][j]);
    }
  }
}

// ------------------------------------------------------------ launches

template <typename T, int ACT>
int launch_fwd(const void* x, const void* w, const float* a, const float* b,
               void* y, double* s1, double* s2, const Geom& g, dim3 grid,
               cudaStream_t stream) {
  fused_conv3x3_fwd_kernel<T, ACT><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)w, a, b, (T*)y, s1, s2, g);
  return (int)cudaGetLastError();
}

template <int STRIDE, int ACT, bool PRO, class TL>
int launch_fwd_tc(const void* x, const void* w, const float* a,
                  const float* b, void* y, double* s1, double* s2,
                  const Geom& g, dim3 grid, int smem_bytes,
                  cudaStream_t stream) {
  // the plan's shared memory must be this config's
  if (smem_bytes != HaloSmem<STRIDE, TL>::BYTES || g.k % TC_KC || g.n % 8)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_conv3x3_fwd_tc_kernel<STRIDE, ACT, PRO, TL>;
  static int allowed[tc::MAX_DEVICES] = {0};   // per instance and device
  int err = tc::allow_smem((const void*)kernel, smem_bytes, allowed);
  if (err != 0) return err;
  kernel<<<grid, tc::THREADS, smem_bytes, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, a, b,
      (__nv_bfloat16*)y, s1, s2, g);
  return (int)cudaGetLastError();
}

template <int STRIDE, class TL>
int fwd_tc_by_act(const void* x, const void* w, const float* a,
                  const float* b, void* y, double* s1, double* s2,
                  const Geom& g, int act, dim3 grid, int smem_bytes,
                  cudaStream_t stream) {
  if (a == nullptr)
    return launch_fwd_tc<STRIDE, ACT_LINEAR, false, TL>(
        x, w, a, b, y, s1, s2, g, grid, smem_bytes, stream);
  if (act == ACT_MISH)
    return launch_fwd_tc<STRIDE, ACT_MISH, true, TL>(
        x, w, a, b, y, s1, s2, g, grid, smem_bytes, stream);
  if (act == ACT_LEAKY)
    return launch_fwd_tc<STRIDE, ACT_LEAKY, true, TL>(
        x, w, a, b, y, s1, s2, g, grid, smem_bytes, stream);
  if (act == ACT_LINEAR)
    return launch_fwd_tc<STRIDE, ACT_LINEAR, true, TL>(
        x, w, a, b, y, s1, s2, g, grid, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

template <class TL>
int fwd_tc_by_stride(const void* x, const void* w, const float* a,
                     const float* b, void* y, double* s1, double* s2,
                     const Geom& g, int act, dim3 grid, int smem_bytes,
                     cudaStream_t stream) {
  if (g.stride == 1)
    return fwd_tc_by_act<1, TL>(x, w, a, b, y, s1, s2, g, act, grid,
                                smem_bytes, stream);
  return fwd_tc_by_act<2, TL>(x, w, a, b, y, s1, s2, g, act, grid,
                              smem_bytes, stream);
}

template <typename T, int ACT>
int launch_bwd(const void* x, const void* w, const float* a, const float* b,
               const void* y, const void* dy, const float* ds1,
               const float* ds2, void* dx, float* dw, double* da, double* db,
               const Geom& g, cudaStream_t stream) {
  int64_t m_in = (int64_t)g.b * (g.h / g.stride) * (g.w / g.stride);
  dim3 gx((unsigned)((m_in + BM - 1) / BM), (unsigned)((g.k + BN - 1) / BN),
          g.stride == 2 ? 4u : 1u);
  fused_conv3x3_dx_kernel<T, ACT><<<gx, THREADS, 0, stream>>>(
      (const T*)x, (const T*)w, a, b, (const T*)y, (const T*)dy, ds1, ds2,
      (T*)dx, da, db, g);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  int64_t m_out = (int64_t)g.b * g.ho * g.wo;
  int64_t chunks = (m_out + M_CHUNK - 1) / M_CHUNK;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 gw((unsigned)((9 * g.k + BM - 1) / BM),
          (unsigned)((g.n + BN - 1) / BN), (unsigned)chunks);
  fused_conv3x3_dw_kernel<T, ACT><<<gw, THREADS, 0, stream>>>(
      (const T*)x, a, b, (const T*)y, (const T*)dy, ds1, ds2, dw, g);
  return (int)cudaGetLastError();
}

bool make_geom(int b, int h, int w, int k, int n, int stride, Geom* g) {
  if (b < 1 || h < 1 || w < 1 || k < 1 || n < 1) return false;
  if (stride != 1 && stride != 2) return false;
  if (stride == 2 && ((h | w) & 1)) return false;
  g->b = b;
  g->h = h;
  g->w = w;
  g->k = k;
  g->n = n;
  g->ho = h / stride;
  g->wo = w / stride;
  g->stride = stride;
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

// Forward.  a and b are null for an input without a prologue.  dtype:
// 0 = float32, 1 = bfloat16.  act: 0 mish, 1 leaky, 2 linear.  s1 and s2
// are zeroed f64 buffers of n entries.  config, grid and smem_bytes come
// from the Python plan: config -1 runs the CUDA-core kernel (64 x 64
// tiles, static shared memory), 0/1 the tensor-core kernel with BN =
// 128/64 (bf16 only) and smem_bytes of dynamic shared memory.  Returns
// the cudaError_t of the launch.
extern "C" int fused_conv3x3_fwd_launch(const void* x, const void* w,
                                        const float* a, const float* b,
                                        void* y, double* s1, double* s2,
                                        int bsz, int h, int wd, int k, int n,
                                        int stride, int dtype, int act,
                                        int config, int grid_x, int grid_y,
                                        int grid_z, int smem_bytes,
                                        void* stream) {
  Geom g;
  if (!make_geom(bsz, h, wd, k, n, stride, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
  if (config >= 0) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (config == 0)
      return fwd_tc_by_stride<tc::Tile128>(x, w, a, b, y, s1, s2, g, act,
                                           grid, smem_bytes, s);
    if (config == 1)
      return fwd_tc_by_stride<tc::Tile64>(x, w, a, b, y, s1, s2, g, act,
                                          grid, smem_bytes, s);
    return (int)cudaErrorInvalidValue;
  }
  DISPATCH(launch_fwd, x, w, a, b, y, s1, s2, g, grid, s)
}

// Backward: the dx kernel, then the split-M dW kernel.  a and b are null
// for an input without a prologue (da, db are then not touched).  dw
// (f32, [9k, n]), da and db (f64) must be zeroed.  Returns the first
// nonzero cudaError_t of the two launches.
extern "C" int fused_conv3x3_bwd_launch(const void* x, const void* w,
                                        const float* a, const float* b,
                                        const void* y, const void* dy,
                                        const float* ds1, const float* ds2,
                                        void* dx, float* dw, double* da,
                                        double* db, int bsz, int h, int wd,
                                        int k, int n, int stride, int dtype,
                                        int act, void* stream) {
  Geom g;
  if (!make_geom(bsz, h, wd, k, n, stride, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH(launch_bwd, x, w, a, b, y, dy, ds1, ds2, dx, dw, da, db, g, s)
}
