// Class-wise NMS over confidence-sorted boxes: greedy (IoU or DIoU) and
// Gaussian Soft-NMS.
//
// Input rows are (N, K, 8) f32 [x, y, w, h, conf, cls, prob, valid],
// each image sorted by joint confidence, descending.
//
// 1. Greedy NMS replaces the Pallas TPU kernel nms_pallas (_nms_kernel
//    and _nms_kernel_blocked of tf2_yolo_tpu/ops/pallas/nms_kernel.py).
//    Box i suppresses box j when i is still alive, i is valid, j > i,
//    the classes are equal and overlap(i, j) >= threshold (IoU, or DIoU
//    for iou_mode 2); keep = alive * valid.
//
//    What bounds it on an H100: two things, of different kinds.  (a)
//    The suppression lattice: an overlap (about 25 f32 operations) for
//    every pair i < j, K^2 / 2 of them, with no order among them.  (b)
//    The greedy decision: box j's fate waits on every kept box before
//    it, a dependent chain as long as the number of kept boxes.  The
//    TPU kernel and the first port walked all K rows with one barrier a
//    row, and recomputed row i at step i, so (a) ran inside (b) on one
//    SM per image.
//
//    The design separates them.  The lattice is bits: word w of row i
//    (64 bits, unsigned long long) holds bit b for candidate j = 64w + b,
//    set when i is valid, j > i, the classes are equal and the overlap
//    reaches the threshold; bits past K stay zero.  A warp builds one
//    word of one row with two __ballot_sync over 64 candidates, one
//    overlap a lane each, so (a) spreads over the whole card: the
//    lattice kernel's blocks are (word column, 16-row tile, image), with
//    the tile's 64 column boxes and 16 row boxes staged in shared memory
//    as corners and areas, and blocks wholly below the diagonal only
//    write zeros.  It writes the lattice to global scratch, (N, K,
//    words), that the wrapper allocates.
//
//    The scan kernel, one block per image, takes the words in order.  It
//    copies each row's own word (row i's word i / 64) into shared
//    memory.  Thread 0 walks the 64 boxes of the word: an alive box is
//    kept and clears from the word the boxes it suppresses there, so (b)
//    is a bit test and a masked clear a box, some 10 cycles, K of them an
//    image (the walk visits every box, kept or not: the row reads do not
//    wait on it).  Then the block clears the later words by the kept
//    boxes' rows, four threads a later word, sixteen rows each, their
//    reads from L2 in flight together (read unconditionally, clamped,
//    and masked: behind a branch each read waited on the last), between
//    two block barriers a word (K / 64 of them).  (A warp jumping from
//    kept box to kept box with __ballot_sync / __ffs, clearing each row
//    at once, took about 0.1 us a kept box on an H100: a ballot, a
//    shuffle, a row read and some 30 dependent integer operations on the
//    chain.)  Both launches go on the caller's stream and neither
//    synchronises.  The scan's one cudaFuncSetAttribute runs once, in
//    nms_setup, when the library is loaded: no launch calls it.
//
//    One plan serves every K from 1 to MAX_K (_plan in
//    ops/kernels/nms.py).  On an H100 it was the fastest of three at
//    K = 96 to 256, the serving K among them; a scan that copied the
//    whole lattice into shared memory won only at K = 1024, and a single
//    launch that built the lattice in shared memory only at K <= 64,
//    sizes no serving path of this package uses (PERF.md, K4).
//
// 2. Soft-NMS has no Pallas counterpart: the JAX package runs it as a
//    K-step lax.scan (_soft_nms_single, tf2_yolo_tpu/ops/nms.py).  Every
//    valid box i decays each later valid box j of its class with
//    iou(i, j) >= nms_threshold, deleted or not, by
//    exp(-(iou^2) / sigma); j is deleted when it was decayed at least
//    once and its confidence, after some decay, is below
//    conf_threshold.  Box j's confidence depends only on the boxes
//    before it, never on which were deleted, so there is no step-to-step
//    dependence across boxes: box j's thread multiplies its decays for
//    i = 0 .. j-1 in the scan's order, from conf0 = conf * prob, so it
//    rounds as the scan does, up to expf against the plain version's
//    exp.  Bounded by the K^2 / 2 IoUs (about 25 f32 operations each)
//    and an expf per overlapping pair.  A block takes 32 boxes j of one
//    image and walks the earlier boxes in chunks of 128: its 256 threads
//    compute the chunk's 128 x 32 factors at once into shared memory
//    (16 a thread), then the 32 threads of the tile multiply them in
//    order, one multiply and compare a factor.  (Each thread computing
//    its own j factors one after the other took 0.21 ms at N=8, K=1024
//    on an H100: the chain of one thread's IoUs and expf.)
//
// Exactness: the overlap arithmetic is written in the order of the plain
// version (tf2_yolo_tpu_torch/ops/geometry.py pair_iou), and this file is
// built with --fmad=false, so no multiply-add is contracted and every
// operation rounds as a separate IEEE f32 operation, as the plain
// version's do; greedy keep masks compare exactly.  Staging corners and
// areas computes the same values once per box instead of once per pair.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr float EPSILON = 1e-07f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;     // what a block may opt into (227 KB)

constexpr int TILE_ROWS = 16;          // lattice kernel: rows of a block
constexpr int LATTICE_THREADS = 256;   // 8 warps, 2 rows each
constexpr int SCAN_THREADS = 512;      // scan kernel: thread 0 walks
constexpr int SOFT_TJ = 32;            // Soft-NMS: boxes j of a block,
constexpr int SOFT_TI = 128;           // earlier boxes i of a chunk
constexpr int SOFT_THREADS = 256;      // 16 factors a thread a chunk

// A box as the overlap reads it: corners, area, class and centre.
struct Prep {
  float x1, y1, x2, y2, area, cls, x, y;
};

__device__ __forceinline__ Prep prep(const float* r) {
  Prep p;
  float hw = r[2] / 2.0f, hh = r[3] / 2.0f;
  p.x1 = r[0] - hw;
  p.x2 = r[0] + hw;
  p.y1 = r[1] - hh;
  p.y2 = r[1] + hh;
  p.area = r[2] * r[3];
  p.cls = r[5];
  p.x = r[0];
  p.y = r[1];
  return p;
}

// pair_iou(a, b, mode): a is the earlier box i, b the candidate j
__device__ __forceinline__ float overlap(const Prep& a, const Prep& b,
                                         int iou_mode) {
  float iw = fmaxf(fminf(b.x2, a.x2) - fmaxf(b.x1, a.x1), 0.0f);
  float ih = fmaxf(fminf(b.y2, a.y2) - fmaxf(b.y1, a.y1), 0.0f);
  float inter = iw * ih;
  float uni = a.area + b.area - inter;
  float iou = inter / (uni + EPSILON);
  if (iou_mode == 2) {
    float ew = fmaxf(b.x2, a.x2) - fminf(b.x1, a.x1);
    float eh = fmaxf(b.y2, a.y2) - fminf(b.y1, a.y1);
    float c2 = ew * ew + eh * eh;
    float dx = a.x - b.x, dy = a.y - b.y;
    float rho2 = dx * dx + dy * dy;
    iou = iou - rho2 / c2;
  }
  return iou;
}

__device__ __forceinline__ bool suppresses(const Prep& a, const Prep& b,
                                           float threshold, int iou_mode) {
  return b.cls == a.cls && overlap(a, b, iou_mode) >= threshold;
}

// Word (c0 / 64) of row i, for a valid row box bi: the lane tests
// candidates c0 + lane and c0 + 32 + lane, cols[0] being box c0.  Called
// by a whole warp.
__device__ __forceinline__ u64 lattice_word(const Prep& bi, int i,
                                            const Prep* cols, int c0, int k,
                                            float threshold, int iou_mode,
                                            int lane) {
  int j0 = c0 + lane, j1 = j0 + 32;
  bool s0 = j0 > i && j0 < k && suppresses(bi, cols[lane], threshold,
                                           iou_mode);
  bool s1 = j1 > i && j1 < k && suppresses(bi, cols[lane + 32], threshold,
                                           iou_mode);
  return (u64)__ballot_sync(FULL, s0) |
         ((u64)__ballot_sync(FULL, s1) << 32);
}

// The lattice of every image into global scratch (N, K, words).
__global__ void __launch_bounds__(LATTICE_THREADS)
nms_lattice_kernel(const float* __restrict__ boxes, u64* __restrict__ lattice,
                   int k, int words, float threshold, int iou_mode) {
  __shared__ Prep cols[64];
  __shared__ Prep rows[TILE_ROWS];
  __shared__ bool row_valid[TILE_ROWS];
  const int wd = blockIdx.x, row0 = blockIdx.y * TILE_ROWS;
  const int c0 = wd * 64, tid = threadIdx.x;
  const float* src = boxes + (size_t)blockIdx.z * k * 8;
  u64* dst = lattice + (size_t)blockIdx.z * k * words;

  if (row0 >= c0 + 64) {               // below the diagonal: j < i
    if (tid < TILE_ROWS && row0 + tid < k)
      dst[(size_t)(row0 + tid) * words + wd] = 0ull;
    return;
  }
  if (tid < 64) {
    if (c0 + tid < k) cols[tid] = prep(src + (size_t)(c0 + tid) * 8);
  } else if (tid < 64 + TILE_ROWS) {
    int i = row0 + tid - 64;
    if (i < k) {
      rows[tid - 64] = prep(src + (size_t)i * 8);
      row_valid[tid - 64] = src[(size_t)i * 8 + 7] != 0.0f;
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = warp * 2; rr < warp * 2 + 2; ++rr) {
    int i = row0 + rr;
    if (i >= k) break;
    u64 word = 0ull;
    if (row_valid[rr])
      word = lattice_word(rows[rr], i, cols, c0, k, threshold, iou_mode,
                          lane);
    if (lane == 0) dst[(size_t)i * words + wd] = word;
  }
}

// One block per image: copy the diagonal words (row i's word i / 64)
// of the image's lattice into shared memory, scan, write keep.  Dynamic
// shared memory: the alive words, then the diagonal words.
__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan_kernel(const float* __restrict__ boxes,
                const u64* __restrict__ lattice, float* __restrict__ keep,
                int k, int words) {
  extern __shared__ u64 smem[];
  u64* alive_words = smem;
  u64* diag = smem + words;
  __shared__ u64 word_kept;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int WARPS = SCAN_THREADS / 32;
  const float* src = boxes + (size_t)blockIdx.x * k * 8;
  const u64* rows = lattice + (size_t)blockIdx.x * k * words;

  // valid boxes as words
  for (int w = warp; w < words; w += WARPS) {
    int j0 = w * 64 + lane, j1 = j0 + 32;
    bool v0 = j0 < k && src[(size_t)j0 * 8 + 7] != 0.0f;
    bool v1 = j1 < k && src[(size_t)j1 * 8 + 7] != 0.0f;
    u64 word = (u64)__ballot_sync(FULL, v0) |
               ((u64)__ballot_sync(FULL, v1) << 32);
    if (lane == 0) alive_words[w] = word;
  }
  for (int i = tid; i < k; i += SCAN_THREADS)
    diag[i] = rows[(size_t)i * words + (i >> 6)];
  __syncthreads();

  for (int wk = 0; wk < words; ++wk) {
    const int base = wk * 64;
    // thread 0 walks the word's 64 boxes in order: an alive box is kept
    // and clears the later boxes of the word that it suppresses.  The
    // reads do not wait on the walk, so the chain is a test and a masked
    // clear a box; what is left alive is the word's keep mask
    if (tid == 0) {
      u64 kept = alive_words[wk];
#pragma unroll
      for (int b = 0; b < 64; ++b) {
        const u64 row = diag[min(base + b, k - 1)];
        if ((kept >> b) & 1ull) kept &= ~row;
      }
      alive_words[wk] = kept;
      word_kept = kept;
    }
    __syncthreads();
    const u64 kept = word_kept;
    // the later words drop what the kept boxes suppress: four threads a
    // later word, sixteen rows each, so that a quarter's reads are in
    // flight together, unconditionally (rows past K as row K - 1); the
    // kept rows' words are cleared with a shared atomic
    for (int e = tid; e < (words - wk - 1) * 4; e += SCAN_THREADS) {
      const int w = wk + 1 + (e >> 2), b0 = (e & 3) * 16;
      const u64 mine = (kept >> b0) & 0xffffull;
      if (mine == 0ull) continue;
      u64 v[16];
#pragma unroll
      for (int t = 0; t < 16; ++t)
        v[t] = rows[(size_t)min(base + b0 + t, k - 1) * words + w];
      u64 s = 0ull;
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if ((mine >> t) & 1ull) s |= v[t];
      atomicAnd(&alive_words[w], ~s);
    }
    __syncthreads();
  }

  float* out = keep + (size_t)blockIdx.x * k;
  for (int j = tid; j < k; j += SCAN_THREADS)
    out[j] = (alive_words[j >> 6] >> (j & 63)) & 1ull
                 ? src[(size_t)j * 8 + 7] : 0.0f;
}

// Soft-NMS: a block per (tile of SOFT_TJ boxes j, image).  For each
// chunk of SOFT_TI earlier boxes i, the block computes the decay factors
// of every (i, j) pair at once, one IoU and one expf a pair (sign bit
// set: the pair overlaps, -0.0f where expf underflows; 1: it does not),
// then thread j multiplies its column in order of i, as the scan does.
__global__ void __launch_bounds__(SOFT_THREADS)
soft_nms_keep_kernel(const float* __restrict__ boxes, float* __restrict__ keep,
                     int k, float nms_threshold, float conf_threshold,
                     float sigma) {
  __shared__ Prep ci[SOFT_TI];               // the chunk's boxes i
  __shared__ float cv[SOFT_TI];
  __shared__ Prep tj[SOFT_TJ];               // the tile's boxes j
  __shared__ float tv[SOFT_TJ];
  __shared__ float factor[SOFT_TJ][SOFT_TI + 1];   // + 1: no bank clash
  const int tid = threadIdx.x, j0 = blockIdx.x * SOFT_TJ;
  const float* src = boxes + (size_t)blockIdx.y * k * 8;
  if (tid < SOFT_TJ) {
    int j = j0 + tid;
    tv[tid] = j < k ? src[(size_t)j * 8 + 7] : 0.0f;
    if (j < k) tj[tid] = prep(src + (size_t)j * 8);
  }
  // thread tid < SOFT_TJ owns box j0 + tid; the others compute factors
  const int j = j0 + tid;
  float conf = 0.0f;
  if (tid < SOFT_TJ && j < k)
    conf = src[(size_t)j * 8 + 4] * src[(size_t)j * 8 + 6];
  bool deleted = false;
  const int ii = tid % SOFT_TI, half = tid / SOFT_TI;
  constexpr int JJ = SOFT_TJ * SOFT_TI / SOFT_THREADS;   // pairs a thread
  const int i_end = min(k, j0 + SOFT_TJ) - 1;  // i < j <= last j
  for (int i0 = 0; i0 < i_end; i0 += SOFT_TI) {
    __syncthreads();                           // the last chunk is read
    if (tid < SOFT_TI) {
      int i = i0 + tid;
      cv[tid] = i < k ? src[(size_t)i * 8 + 7] : 0.0f;
      if (i < k) ci[tid] = prep(src + (size_t)i * 8);
    }
    __syncthreads();
    const int i = i0 + ii;
#pragma unroll 4
    for (int t = 0; t < JJ; ++t) {
      const int jj = half * JJ + t;
      float f = 1.0f;
      if (i < j0 + jj && cv[ii] != 0.0f && tv[jj] != 0.0f &&
          ci[ii].cls == tj[jj].cls) {
        float iou = overlap(ci[ii], tj[jj], 1);
        // the scan's order: square, negate, divide by sigma, exp
        if (iou >= nms_threshold) f = -expf(-(iou * iou) / sigma);
      }
      factor[jj][ii] = f;
    }
    __syncthreads();
    if (tid < SOFT_TJ) {
      const int n_i = min(SOFT_TI, k - i0);
      for (int t = 0; t < n_i; ++t) {
        float f = factor[tid][t];
        if (signbit(f)) {                // -0.0f too: exp underflowed
          conf = conf * -f;
          deleted = deleted || conf < conf_threshold;
        }
      }
    }
  }
  if (tid < SOFT_TJ && j < k)
    keep[(size_t)blockIdx.y * k + j] =
        tv[tid] != 0.0f && !deleted ? 1.0f : 0.0f;
}

}  // namespace

// Allows the scan kernel the dynamic shared memory a block may use
// beside its static shared memory, on the current device.  Called once,
// when the library is loaded.
extern "C" int nms_setup() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, nms_scan_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT - (int)attr.sharedSizeBytes);
}

// Greedy NMS by the plan of _plan (ops/kernels/nms.py): words per row
// and the scan kernel's shared memory.  lattice is (N, K, words)
// scratch.  Returns the cudaError_t of the launches.
extern "C" int nms_keep_launch(const float* boxes, float* keep,
                               unsigned long long* lattice, int n, int k,
                               int words, int smem, float threshold,
                               int iou_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)words, (unsigned)((k + TILE_ROWS - 1) / TILE_ROWS),
            (unsigned)n);
  nms_lattice_kernel<<<grid, LATTICE_THREADS, 0, s>>>(
      boxes, lattice, k, words, threshold, iou_mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<n, SCAN_THREADS, smem, s>>>(boxes, lattice, keep, k,
                                                words);
  return (int)cudaGetLastError();
}

// Soft-NMS keep mask.  Returns the cudaError_t of the launch.
extern "C" int soft_nms_keep_launch(const float* boxes, float* keep, int n,
                                    int k, float nms_threshold,
                                    float conf_threshold, float sigma,
                                    void* stream) {
  dim3 grid((unsigned)((k + SOFT_TJ - 1) / SOFT_TJ), (unsigned)n);
  soft_nms_keep_kernel<<<grid, SOFT_THREADS, 0, (cudaStream_t)stream>>>(
      boxes, keep, k, nms_threshold, conf_threshold, sigma);
  return (int)cudaGetLastError();
}
