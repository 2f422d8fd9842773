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
// * Backward: dx (T), dW (f32), da, db from the stored y.  Two routes,
//   chosen per shape by the Python plan (_tc_bwd_plan), as the forward's:
//   - bf16 with K % 16 == 0 and N % 8 == 0 (all five layers of
//     packed=3): tensor cores, three launches.  (1) A tiny pass folds
//     ds1 into a per-(tap, k) f32 table c[tap, k] = sum_n ds1[n] w[tap,
//     k, n], so that ds1, which the TPU kernel keeps as an exact f32
//     broadcast term, never enters a bf16 operand.  (2) dx: a block
//     takes an 8 x 16 tile of output-grid positions and 32, 64 or 128
//     input channels; at stride 2 that is the input pixels of all four
//     parity classes there (1, 2 or 4 taps reach a class, never 9), 32
//     channels.  Per slice of 16 output channels, in a two-stage ring,
//     it copies the raw dy and y of the tile's output-pixel halo and the
//     nine taps' weight rows with cp.async, builds e = T(dy + y (2 ds2))
//     ONCE per halo element in shared memory (0 where the output pixel
//     does not exist), and reads it at each tap's shift through ldmatrix
//     into mma.sync; the epilogue adds the table entries of the taps
//     whose output pixel exists (they depend on the pixel's edge class),
//     recomputes the prologue's derivative, writes dx through shared
//     memory and adds da, db with f64 atomics.
//     (3) dW: 9 warps, one per tap, over 32 input channels x 64 output
//     channels; per 8 x 16 tile of output pixels it copies the raw input
//     halo and the raw dy, y, activates the halo ONCE per element and
//     builds dyt = T(T(dy + 2 y ds2) + ds1) once per element, then
//     contracts over the tile's pixels with both operands read by
//     ldmatrix .trans.  A block walks a chunk of tiles (split-M, about
//     two blocks per SM in all) and adds its sums to the zeroed dW with
//     f32 atomics.
//   - f32 and bf16 shapes the tensor cores do not take (K = 3): CUDA
//     cores.  dx kernel: M = input pixels, columns = the K input
//     channels, contraction over (tap, n) of e + ds1 (ds1 added to the
//     rounded e in f32) with w[tap]^T; grid.z walks the four parity
//     classes at stride 2; the epilogue as above.  dW kernel: tile [64
//     of the 9K rows, 64 of N], contraction over a chunk of M_CHUNK
//     output pixels (split-M, f32 atomics).  Operands: the gathered,
//     recomputed g and dyt.
//   The fold dy + 2 y ds2 (a separate pass before the TPU kernel) is
//   computed in the loads and rounded to T as there.
// * Any B, H, W, K, N >= 1 on the CUDA cores (K = 3 included): ragged
//   edges are zero-filled on load and masked on store.  Element offsets
//   are 64-bit.
//
// What bounds it on an H100: the forward's layers are bound by bytes
// (K, N <= 128: 0.02-0.16 ms at batch 32); the tensor-core kernels add
// to those the prologue (expf and two divisions per halo element, at
// f32 CUDA-core rates and without FMA contraction) and their halo
// overlap (1.4x the tile's input at stride 1, 1.1x at stride 2).  The
// backward's two products are bound by bytes as well on the tensor
// cores, and carry the prologue's derivative (dx) and the prologue
// itself (dW).  The f32 kernels run on the CUDA cores, bound by their
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

// The input halo of a TC_TH x TC_TW tile of output pixels: HH x HW
// pixels.  A halo row holds the HW input columns of the tile's window; at
// stride 2 the even columns come first, then the odd ones, so that at
// every tap the 8 output pixels of one ldmatrix read 8 consecutive
// slots: column ox * STRIDE + dx of the window sits at slot
// ox + slot(dx).
template <int STRIDE>
struct HaloGeom {
  static constexpr int HH = STRIDE * (TC_TH - 1) + 3;
  static constexpr int HW = STRIDE * (TC_TW - 1) + 3;
  static constexpr int HE = (HW + 1) / 2;
  __device__ static __forceinline__ int slot(int hx) {
    return STRIDE == 1 ? hx : (hx & 1) * HE + (hx >> 1);
  }
};

// The forward's shared memory: the halo of one channel slice (rows of
// 16 + 8 bf16) and the slice's nine weight taps, or the epilogue.
template <int STRIDE, class TL>
struct HaloSmem : HaloGeom<STRIDE> {
  using G = HaloGeom<STRIDE>;
  static constexpr int HALO_ELEMS = G::HH * G::HW * TC_HPITCH;
  static constexpr int BPITCH = TL::BN + 8;
  static constexpr int MAIN_BYTES = (HALO_ELEMS + 9 * TC_KC * BPITCH) * 2;
  static constexpr int BYTES =
      MAIN_BYTES > TL::EPI_BYTES ? MAIN_BYTES : TL::EPI_BYTES;
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

// ---------------------------------------- backward on tensor cores (bf16)

// The ds1 fold of the dx kernel: c[tap, k] = sum_n ds1[n] * w[tap, k, n]
// in f32, one thread per (tap, k) row of w.  ds1 enters dg only through
// these sums (a tap adds its row where its output pixel exists), so it
// never becomes a bf16 operand.
__global__ void fused_conv3x3_ctab_kernel(const __nv_bfloat16* __restrict__ w,
                                          const float* __restrict__ ds1,
                                          float* __restrict__ ctab, int rows,
                                          int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const __nv_bfloat16* wr = w + (int64_t)r * n;
  float s = 0.f;
  for (int j = 0; j < n; ++j) s = fmaf(ds1[j], __bfloat162float(wr[j]), s);
  ctab[r] = s;
}

// The dx kernel's shared memory: two stages, each holding one slice of
// 16 output channels: the cotangent halo of the tile in output pixels
// (EH x EW, rows of 16 + 8 bf16: e, built in place from the raw dy),
// the raw y of the same pixels, and w[tap][k][slice] of the block's BN
// input channels for the nine taps (rows of 16 + 8); or the epilogue;
// then the ds1 table of the block's columns, [9][BN] f32, and its sum
// over each parity class's taps, [classes][BN].
template <int STRIDE, class TL>
struct DxSmem {
  static constexpr int EH = STRIDE == 1 ? TC_TH + 2 : TC_TH + 1;
  static constexpr int EW = STRIDE == 1 ? TC_TW + 2 : TC_TW + 1;
  static constexpr int E_ELEMS = EH * EW * TC_HPITCH;
  static constexpr int Y_ELEMS = EH * EW * TC_KC;
  static constexpr int W_ELEMS = 9 * TL::BN * TC_HPITCH;
  static constexpr int STAGE_ELEMS = E_ELEMS + Y_ELEMS + W_ELEMS;
  static constexpr int MAIN_BYTES = 2 * STAGE_ELEMS * 2;
  static constexpr int BODY =
      ((MAIN_BYTES > TL::EPI_BYTES ? MAIN_BYTES : TL::EPI_BYTES) + 15) / 16
      * 16;
  static constexpr int BYTES = BODY + (9 + STRIDE * STRIDE) * TL::BN * 4;
};

// dx on the tensor cores.  One block: a TC_TH x TC_TW tile of output-grid
// positions (i, j) of image blockIdx.z against input channels
// blockIdx.y * BN .. + BN.  At stride 1 these are the input pixels
// (i, j); at stride 2 the input pixels (2i + ph, 2j + pw) of the four
// parity classes (ph, pw), each of which only 1, 2 or 4 taps reach, so
// that the classes share one cotangent halo: dg[m, k] = sum over the
// class's taps and n of e[out(m, tap), n] * w[tap, k, n] with e = T(dy +
// y * (2 ds2)), built ONCE per element of the tile's output-pixel halo
// per slice of 16 channels (0 where the output pixel does not exist),
// then read through ldmatrix at each tap's shift.  The slices go through
// two stages: the next slice's copies are in flight while this one is
// built and multiplied.  The epilogue (per class) adds the ds1 table of
// the taps whose output pixel exists (unrounded f32; one precomputed sum
// away from the image's edges), then dz = dg * act'(x a + b), dx = T(dz
// a), da += dz x, db += dz (f64 atomics per column and block); without
// a prologue dx = T(dg).
template <int STRIDE, int ACT, bool PRO, class TL>
__global__ void __launch_bounds__(tc::THREADS,
                                  STRIDE == 2 || TL::BN == 128 ? 2 : 3)
fused_conv3x3_dx_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ pa,
                           const float* __restrict__ pb,
                           const __nv_bfloat16* __restrict__ y,
                           const __nv_bfloat16* __restrict__ dy,
                           const float* __restrict__ ds2,
                           const float* __restrict__ ctab,
                           __nv_bfloat16* __restrict__ dx,
                           double* __restrict__ da, double* __restrict__ db,
                           Geom g) {
  using SM = DxSmem<STRIDE, TL>;
  constexpr int BN = TL::BN, CLASSES = STRIDE * STRIDE;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ct = reinterpret_cast<float*>(smem + SM::BODY);
  float* ct_full = ct + 9 * BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int c0 = blockIdx.y * BN;
  const int tiles_x = (g.wo + TC_TW - 1) / TC_TW;
  const int i0 = (blockIdx.x / tiles_x) * TC_TH;
  const int j0 = (blockIdx.x % tiles_x) * TC_TW;
  const int img = blockIdx.z;
  // the halo's first output pixel
  const int ey0 = STRIDE == 1 ? i0 - 1 : i0;
  const int ex0 = STRIDE == 1 ? j0 - 1 : j0;
  const int64_t out_img = (int64_t)img * g.ho * g.wo * g.n;
  // a tap reaches class (ph, pw) where its output pixel is whole: every
  // tap at stride 1; at stride 2 dh = 1 for even rows, 0 and 2 for odd
  // ones (dw alike)
  auto tap_on = [](int cls, int dh, int dw) {
    return STRIDE == 1
           || ((((cls >> 1) + 1 - dh) | ((cls & 1) + 1 - dw)) & 1) == 0;
  };

  for (int i = tid; i < 9 * BN; i += tc::THREADS) {
    const int kk = c0 + i % BN;
    ct[i] = kk < g.k ? ctab[(i / BN) * g.k + kk] : 0.f;
  }
  for (int i = tid; i < CLASSES * BN; i += tc::THREADS) {
    const int cls = i / BN, kk = c0 + i % BN;
    float sum = 0.f;
    for (int tap = 0; tap < 9; ++tap)
      if (kk < g.k && tap_on(cls, tap / 3, tap % 3))
        sum += ctab[tap * g.k + kk];
    ct_full[i] = sum;
  }
  // this lane's halo element of each A fragment at shift (0, 0), and its
  // row of the weight taps
  int a_base[TL::MI];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi) {
    const int r = wm * TL::WTM + mi * 16 + (lane & 15);
    a_base[mi] = ((r / TC_TW) * SM::EW + r % TC_TW) * TC_HPITCH
                 + (lane >> 4) * 8;
  }
  const int b_base = (wn * TL::WTN + (lane >> 4) * 8 + (lane & 7))
                         * TC_HPITCH + ((lane >> 3) & 1) * 8;

  // copies of the slice of channels n0 .. n0 + 16 into a stage: raw dy
  // and y of the halo (two 16-byte chunks of 8 channels each), and the
  // weights: row tap * BN + kl is w[tap][c0 + kl][slice]
  auto copy_slice = [&](int stage, int n0) {
    __nv_bfloat16* eb = stages + stage * SM::STAGE_ELEMS;
    __nv_bfloat16* yb = eb + SM::E_ELEMS;
    __nv_bfloat16* ws = yb + SM::Y_ELEMS;
    for (int i = tid; i < SM::EH * SM::EW * 2; i += tc::THREADS) {
      const int p = i >> 1, ch = i & 1;
      const int oy = ey0 + p / SM::EW, ox = ex0 + p % SM::EW;
      const bool ok = oy >= 0 && oy < g.ho && ox >= 0 && ox < g.wo
                      && n0 + ch * 8 < g.n;
      const int64_t off =
          out_img + ((int64_t)oy * g.wo + ox) * g.n + n0 + ch * 8;
      tc::cp_async16(eb + p * TC_HPITCH + ch * 8, ok ? dy + off : dy, ok);
      tc::cp_async16(yb + p * TC_KC + ch * 8, ok ? y + off : y, ok);
    }
    for (int i = tid; i < 9 * BN * 2; i += tc::THREADS) {
      const int tap = i / (2 * BN), kl = (i >> 1) % BN, ch = i & 1;
      const bool ok = c0 + kl < g.k && n0 + ch * 8 < g.n;
      tc::cp_async16(
          ws + (tap * BN + kl) * TC_HPITCH + ch * 8,
          ok ? w + ((int64_t)tap * g.k + c0 + kl) * g.n + n0 + ch * 8 : w,
          ok);
    }
  };

  float acc[CLASSES][TL::MI][TL::NI][4];
#pragma unroll
  for (int cls = 0; cls < CLASSES; ++cls)
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[cls][mi][ni][j] = 0.f;

  const int slices = (g.n + TC_KC - 1) / TC_KC;
  copy_slice(0, 0);
  tc::cp_async_commit();
  for (int sl = 0; sl < slices; ++sl) {
    // the next slice's copies go to the stage the last slice used (all
    // threads left it at the loop's end); then this slice has landed
    if (sl + 1 < slices) copy_slice((sl + 1) & 1, (sl + 1) * TC_KC);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    __nv_bfloat16* eb = stages + (sl & 1) * SM::STAGE_ELEMS;
    const __nv_bfloat16* yb = eb + SM::E_ELEMS;
    const __nv_bfloat16* ws = yb + SM::Y_ELEMS;
    {
      // e = T(dy + y * (2 ds2)) in place: thread owns channel pair
      // tid % 8 of every 32nd halo pixel inside the output
      const int c = 2 * (tid & 7), nn = sl * TC_KC + c;
      if (nn < g.n) {
        const float t0 = 2.0f * ds2[nn], t1 = 2.0f * ds2[nn + 1];
        for (int p = tid >> 3; p < SM::EH * SM::EW; p += tc::THREADS / 8) {
          const int oy = ey0 + p / SM::EW, ox = ex0 + p % SM::EW;
          if (oy < 0 || oy >= g.ho || ox < 0 || ox >= g.wo) continue;
          __nv_bfloat162* e =
              reinterpret_cast<__nv_bfloat162*>(eb + p * TC_HPITCH + c);
          const float2 d = __bfloat1622float2(*e);
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(yb + p * TC_KC + c));
          *e = __floats2bfloat162_rn(d.x + v.x * t0, d.y + v.y * t1);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int cls = 0; cls < CLASSES; ++cls) {
      const int ph = cls >> 1, pw = cls & 1;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap % 3;
        if (!tap_on(cls, dh, dw)) continue;
        // the tap's output pixel of tile pixel (oy, ox) is halo pixel
        // (oy + sy, ox + sx)
        const int sy = STRIDE == 1 ? 2 - dh : (ph + 1 - dh) >> 1;
        const int sx = STRIDE == 1 ? 2 - dw : (pw + 1 - dw) >> 1;
        const __nv_bfloat16* a[TL::MI];
        const __nv_bfloat16* b[TL::NI / 2];
#pragma unroll
        for (int mi = 0; mi < TL::MI; ++mi)
          a[mi] = eb + a_base[mi] + (sy * SM::EW + sx) * TC_HPITCH;
#pragma unroll
        for (int nj = 0; nj < TL::NI / 2; ++nj)
          b[nj] = ws + (tap * BN + nj * 16) * TC_HPITCH + b_base;
        tc::mma_step<TL::MI, TL::NI, false, false>(acc[cls], a, b);
      }
    }
    __syncthreads();   // the next copies may overwrite this stage
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int cls = 0; cls < CLASSES; ++cls) {
    const int ph = cls >> 1, pw = cls & 1;
    // tile row r is input pixel ((i0 + r / TC_TW) * STRIDE + ph,
    // (j0 + r % TC_TW) * STRIDE + pw)
    auto row_off = [&](int r) -> int64_t {
      const int i = i0 + r / TC_TW, j = j0 + r % TC_TW;
      return i < g.ho && j < g.wo
                 ? (((int64_t)img * g.h + i * STRIDE + ph) * g.w
                    + j * STRIDE + pw) * g.k
                 : -1;
    };
    tc::epilogue<TL, PRO>(
        acc[cls], smem, c0, g.k, row_off,
        [&](int r, int c, float v0, float v1, float2& t1,
            float2& t2) -> __nv_bfloat162 {
          t1 = t2 = make_float2(0.f, 0.f);
          const int64_t off = row_off(r);
          if (off < 0 || c >= g.k) return __floats2bfloat162_rn(0.f, 0.f);
          const int hi = (i0 + r / TC_TW) * STRIDE + ph;
          const int wi = (j0 + r % TC_TW) * STRIDE + pw;
          float e0, e1;
          if (hi >= 1 && hi + 2 <= g.h && wi >= 1 && wi + 2 <= g.w) {
            // every tap of the class has its output pixel
            e0 = ct_full[cls * BN + c - c0];
            e1 = ct_full[cls * BN + c - c0 + 1];
          } else {
            e0 = e1 = 0.f;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              const int th = hi + 1 - tap / 3, tw = wi + 1 - tap % 3;
              if (th < 0 || (th % STRIDE) || th / STRIDE >= g.ho || tw < 0
                  || (tw % STRIDE) || tw / STRIDE >= g.wo)
                continue;
              e0 += ct[tap * BN + c - c0];
              e1 += ct[tap * BN + c - c0 + 1];
            }
          }
          const float d0 = v0 + e0, d1 = v1 + e1;
          if (!PRO) return __floats2bfloat162_rn(d0, d1);
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + off + c));
          float g0, gp0, g1, gp1;
          act_and_grad<ACT>(xf.x * pa[c] + pb[c], g0, gp0);
          act_and_grad<ACT>(xf.y * pa[c + 1] + pb[c + 1], g1, gp1);
          const float z0 = d0 * gp0, z1 = d1 * gp1;
          t1 = make_float2(z0 * xf.x, z1 * xf.y);
          t2 = make_float2(z0, z1);
          return __floats2bfloat162_rn(z0 * pa[c], z1 * pa[c + 1]);
        },
        dx, da, db);
    __syncthreads();   // the next class's epilogue reuses the staging
  }
}

// dW on the tensor cores: 9 warps, warp = tap (dh, dw).  One block adds
// dW[(tap, k0 .. k0 + 32), c0 .. c0 + 64) over a chunk of output-pixel
// tiles (split-M: grid.x walks the chunks, the block's f32 sums go to the
// zeroed dW with one f32 atomic per element).  Per TC_TH x TC_TW tile:
// copy the raw input halo of the block's 32 channels and the raw dy, y
// of the tile's pixels with cp.async (zero outside the image), run the
// prologue ONCE per halo element in f32 and round it to bf16 (pixels
// outside the image stay 0), build dyt = T(T(dy + y * (2 ds2)) + ds1)
// once per element (0 for a pixel outside the output), then per output
// row of the tile one 16-deep step: A = the tap's shifted halo,
// [pixel][channel] read with ldmatrix .trans (the contraction runs over
// pixels), B = dyt, [pixel][n], read with .trans.
constexpr int DW_KC = 32;              // input channels of a block
constexpr int DW_BN = 64;              // output channels of a block
constexpr int DW_THREADS = 9 * 32;     // one warp per tap
constexpr int DW_HPITCH = DW_KC + 8;   // 80-byte halo pixels
constexpr int DW_DPITCH = DW_BN + 8;   // 144-byte dyt rows

template <int STRIDE>
struct DwSmem {
  using G = HaloGeom<STRIDE>;
  static constexpr int HALO_ELEMS = G::HH * G::HW * DW_HPITCH;
  static constexpr int D_ELEMS = tc::BM * DW_DPITCH;
  static constexpr int Y_ELEMS = tc::BM * DW_BN;
  static constexpr int BYTES = (HALO_ELEMS + D_ELEMS + Y_ELEMS) * 2;
};

template <int STRIDE, int ACT, bool PRO>
__global__ void __launch_bounds__(DW_THREADS, 2)
fused_conv3x3_dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ pa,
                           const float* __restrict__ pb,
                           const __nv_bfloat16* __restrict__ y,
                           const __nv_bfloat16* __restrict__ dy,
                           const float* __restrict__ ds1,
                           const float* __restrict__ ds2,
                           float* __restrict__ dw, Geom g,
                           int tiles_per_chunk) {
  using G = HaloGeom<STRIDE>;
  using SM = DwSmem<STRIDE>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dyt = halo + SM::HALO_ELEMS;
  __nv_bfloat16* yb = dyt + SM::D_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_blocks = (g.k + DW_KC - 1) / DW_KC;
  const int k0 = (blockIdx.y % k_blocks) * DW_KC;
  const int c0 = (blockIdx.y / k_blocks) * DW_BN;
  const int tiles_x = (g.wo + TC_TW - 1) / TC_TW;
  const int per_img = tiles_x * ((g.ho + TC_TH - 1) / TC_TH);
  const int64_t t_total = (int64_t)g.b * per_img;
  const int64_t t_begin = (int64_t)blockIdx.x * tiles_per_chunk;
  const int64_t t_end = t_begin + tiles_per_chunk < t_total
                            ? t_begin + tiles_per_chunk : t_total;

  // the prologue: thread owns channel pair tid % 16 of the halo
  const int hcol = 2 * (tid & 15);
  const bool h_ok = k0 + hcol < g.k;
  float a0 = 1.f, a1 = 1.f, b0 = 0.f, b1 = 0.f;
  if (PRO && h_ok) {
    a0 = pa[k0 + hcol];
    a1 = pa[k0 + hcol + 1];
    b0 = pb[k0 + hcol];
    b1 = pb[k0 + hcol + 1];
  }
  // the cotangent: thread owns column pair tid % 32 of dyt
  const int dcol = 2 * (tid & 31);
  const bool d_ok = c0 + dcol < g.n;
  float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;   // ds1, 2 ds2
  if (d_ok) {
    u0 = ds1[c0 + dcol];
    u1 = ds1[c0 + dcol + 1];
    v0 = 2.0f * ds2[c0 + dcol];
    v1 = 2.0f * ds2[c0 + dcol + 1];
  }
  // this lane's A address at output row 0 of the tile (its pixel is the
  // contraction index (lane >> 4) * 8 + (lane & 7)), and its B address
  const int dh = warp / 3, dwx = warp % 3;
  const int a_off =
      (dh * G::HW + G::slot(((lane >> 4) * 8 + (lane & 7)) * STRIDE + dwx))
          * DW_HPITCH + ((lane >> 3) & 1) * 8;
  const int b_off = (lane & 15) * DW_DPITCH + (lane >> 4) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int img = (int)(t / per_img), rem = (int)(t % per_img);
    const int oy0 = (rem / tiles_x) * TC_TH, ox0 = (rem % tiles_x) * TC_TW;
    const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;
    const __nv_bfloat16* ximg = x + (int64_t)img * g.h * g.w * g.k;
    // raw halo: four 16-byte chunks of 8 channels per pixel
    for (int i = tid; i < G::HH * G::HW * 4; i += DW_THREADS) {
      const int p = i >> 2, ch = i & 3;
      const int hy = p / G::HW, hx = p % G::HW;
      const int iy = iy0 + hy, ix = ix0 + hx;
      const bool ok = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w
                      && k0 + ch * 8 < g.k;
      tc::cp_async16(
          halo + (hy * G::HW + G::slot(hx)) * DW_HPITCH + ch * 8,
          ok ? ximg + ((int64_t)iy * g.w + ix) * g.k + k0 + ch * 8 : x, ok);
    }
    // raw dy and y of the tile's 128 output pixels
    for (int i = tid; i < tc::BM * (DW_BN / 8); i += DW_THREADS) {
      const int r = i >> 3, ch = i & 7;
      const int oy = oy0 + r / TC_TW, ox = ox0 + r % TC_TW;
      const bool ok = oy < g.ho && ox < g.wo && c0 + ch * 8 < g.n;
      const int64_t off =
          (((int64_t)img * g.ho + oy) * g.wo + ox) * g.n + c0 + ch * 8;
      tc::cp_async16(dyt + r * DW_DPITCH + ch * 8, ok ? dy + off : dy, ok);
      tc::cp_async16(yb + r * DW_BN + ch * 8, ok ? y + off : y, ok);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (PRO && h_ok) {
      for (int p = tid >> 4; p < G::HH * G::HW; p += DW_THREADS / 16) {
        const int hy = p / G::HW, hx = p % G::HW;
        const int iy = iy0 + hy, ix = ix0 + hx;
        if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) continue;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
            halo + (hy * G::HW + G::slot(hx)) * DW_HPITCH + hcol);
        const float2 v = __bfloat1622float2(*e);
        *e = __floats2bfloat162_rn(act_only<ACT>(v.x * a0 + b0),
                                   act_only<ACT>(v.y * a1 + b1));
      }
    }
    for (int r = tid >> 5; r < tc::BM; r += DW_THREADS / 32) {
      const int oy = oy0 + r / TC_TW, ox = ox0 + r % TC_TW;
      __nv_bfloat162* e =
          reinterpret_cast<__nv_bfloat162*>(dyt + r * DW_DPITCH + dcol);
      __nv_bfloat162 out = __floats2bfloat162_rn(0.f, 0.f);
      if (d_ok && oy < g.ho && ox < g.wo) {
        const float2 d = __bfloat1622float2(*e);
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(yb + r * DW_BN + dcol));
        const float2 q = __bfloat1622float2(
            __floats2bfloat162_rn(d.x + v.x * v0, d.y + v.y * v1));
        out = __floats2bfloat162_rn(q.x + u0, q.y + u1);
      }
      *e = out;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TC_TH; ++j) {
      const __nv_bfloat16* a[2];
      const __nv_bfloat16* b[4];
      a[0] = halo + a_off + j * STRIDE * G::HW * DW_HPITCH;
      a[1] = a[0] + 16;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        b[nj] = dyt + j * 16 * DW_DPITCH + b_off + nj * 16;
      tc::mma_step<2, 8, true, true>(acc, a, b);
    }
    __syncthreads();   // the next tile's copies overwrite the buffers
  }

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + mi * 16 + gq + 8 * h;
      if (k >= g.k) continue;
      float* row = dw + ((int64_t)warp * g.k + k) * g.n;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = c0 + ni * 8 + 2 * tq + j;
          if (n < g.n) atomicAdd(row + n, acc[mi][ni][2 * h + j]);
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

struct BwdArgs {
  const void* x;
  const void* w;
  const float* a;
  const float* b;
  const void* y;
  const void* dy;
  const float* ds1;
  const float* ds2;
  float* ctab;
  void* dx;
  float* dw;
  double* da;
  double* db;
};

struct BwdTcPlan {
  dim3 dx_grid;
  int dx_smem;
  dim3 dw_grid;
  int dw_smem;
};

template <int STRIDE, int ACT, bool PRO, class TL>
int launch_bwd_tc(const BwdArgs& p, const Geom& g, const BwdTcPlan& plan,
                  cudaStream_t stream) {
  // the plan must be this config's
  const unsigned dx_cols = (unsigned)((g.k + TL::BN - 1) / TL::BN);
  const unsigned dw_blocks = (unsigned)(((g.k + DW_KC - 1) / DW_KC)
                                        * ((g.n + DW_BN - 1) / DW_BN));
  if (plan.dx_smem != DxSmem<STRIDE, TL>::BYTES
      || plan.dw_smem != DwSmem<STRIDE>::BYTES || g.k % TC_KC || g.n % 8
      || plan.dx_grid.y != dx_cols
      || plan.dw_grid.y != dw_blocks || plan.dw_grid.x < 1)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* w = (const __nv_bfloat16*)p.w;
  const int rows = 9 * g.k;
  fused_conv3x3_ctab_kernel<<<(rows + 127) / 128, 128, 0, stream>>>(
      w, p.ds1, p.ctab, rows, g.n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto dx_kernel = fused_conv3x3_dx_tc_kernel<STRIDE, ACT, PRO, TL>;
  static int dx_allowed[tc::MAX_DEVICES] = {0};   // per instance and device
  err = tc::allow_smem((const void*)dx_kernel, plan.dx_smem, dx_allowed);
  if (err != 0) return err;
  dx_kernel<<<plan.dx_grid, tc::THREADS, plan.dx_smem, stream>>>(
      (const __nv_bfloat16*)p.x, w, p.a, p.b, (const __nv_bfloat16*)p.y,
      (const __nv_bfloat16*)p.dy, p.ds2, p.ctab, (__nv_bfloat16*)p.dx, p.da,
      p.db, g);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto dw_kernel = fused_conv3x3_dw_tc_kernel<STRIDE, ACT, PRO>;
  static int dw_allowed[tc::MAX_DEVICES] = {0};
  err = tc::allow_smem((const void*)dw_kernel, plan.dw_smem, dw_allowed);
  if (err != 0) return err;
  const int64_t tiles = (int64_t)g.b * ((g.ho + TC_TH - 1) / TC_TH)
                        * ((g.wo + TC_TW - 1) / TC_TW);
  const int64_t per_chunk = (tiles + plan.dw_grid.x - 1) / plan.dw_grid.x;
  dw_kernel<<<plan.dw_grid, DW_THREADS, plan.dw_smem, stream>>>(
      (const __nv_bfloat16*)p.x, p.a, p.b, (const __nv_bfloat16*)p.y,
      (const __nv_bfloat16*)p.dy, p.ds1, p.ds2, p.dw, g, (int)per_chunk);
  return (int)cudaGetLastError();
}

template <int STRIDE, class TL>
int bwd_tc_by_act(const BwdArgs& p, const Geom& g, int act,
                  const BwdTcPlan& plan, cudaStream_t stream) {
  if (p.a == nullptr)
    return launch_bwd_tc<STRIDE, ACT_LINEAR, false, TL>(p, g, plan, stream);
  if (act == ACT_MISH)
    return launch_bwd_tc<STRIDE, ACT_MISH, true, TL>(p, g, plan, stream);
  if (act == ACT_LEAKY)
    return launch_bwd_tc<STRIDE, ACT_LEAKY, true, TL>(p, g, plan, stream);
  if (act == ACT_LINEAR)
    return launch_bwd_tc<STRIDE, ACT_LINEAR, true, TL>(p, g, plan, stream);
  return (int)cudaErrorInvalidValue;
}

// stride 2 holds four classes' accumulators: 32 columns only
template <class TL>
int bwd_tc_by_stride(const BwdArgs& p, const Geom& g, int act,
                     const BwdTcPlan& plan, cudaStream_t stream) {
  if (g.stride == 1) return bwd_tc_by_act<1, TL>(p, g, act, plan, stream);
  if constexpr (TL::BN == 32)
    return bwd_tc_by_act<2, TL>(p, g, act, plan, stream);
  return (int)cudaErrorInvalidValue;
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

// Backward on the tensor cores, bf16 only: the ds1 table (into ctab, 9k
// f32 of scratch), the dx kernel, then the split-M dW kernel.  The
// arguments are the CUDA-core entry's; dx_config (0, 1, 2: BN = 128,
// 64, 32), the grids and the shared memory come from the Python plan
// (dW's grid.x is its count of chunks).  K % 16 == 0, N % 8 == 0, and
// every tensor 16-byte aligned.  Returns the first nonzero cudaError_t
// of the three launches.
extern "C" int fused_conv3x3_bwd_tc_launch(
    const void* x, const void* w, const float* a, const float* b,
    const void* y, const void* dy, const float* ds1, const float* ds2,
    float* ctab, void* dx, float* dw, double* da, double* db, int bsz,
    int h, int wd, int k, int n, int stride, int act, int dx_config,
    int dx_grid_x, int dx_grid_y, int dx_grid_z, int dx_smem,
    int dw_grid_x, int dw_grid_y, int dw_smem, void* stream) {
  Geom g;
  if (!make_geom(bsz, h, wd, k, n, stride, &g))
    return (int)cudaErrorInvalidValue;
  const BwdArgs p{x, w, a, b, y, dy, ds1, ds2, ctab, dx, dw, da, db};
  const BwdTcPlan plan{
      dim3((unsigned)dx_grid_x, (unsigned)dx_grid_y, (unsigned)dx_grid_z),
      dx_smem, dim3((unsigned)dw_grid_x, (unsigned)dw_grid_y, 1u), dw_smem};
  cudaStream_t s = (cudaStream_t)stream;
  if (dx_config == 0)
    return bwd_tc_by_stride<tc::Tile128>(p, g, act, plan, s);
  if (dx_config == 1)
    return bwd_tc_by_stride<tc::Tile64>(p, g, act, plan, s);
  if (dx_config == 2)
    return bwd_tc_by_stride<tc::Tile32>(p, g, act, plan, s);
  return (int)cudaErrorInvalidValue;
}
