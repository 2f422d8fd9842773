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
//    before it, never on which were deleted, so boxes do not wait on
//    each other.  And in f32 a multiplication by 1.0 is exact, so only
//    the overlapping earlier boxes move j's confidence, applied in
//    ascending i, the scan's order.
//
//    What bounds it on an H100: the lattice, an IoU (about 25 f32
//    operations) for every pair i < j, K^2 / 2 of them, with no order
//    among them; then a chain per box as long as the number of earlier
//    boxes that overlap it, each link an IoU, a division, an expf and a
//    multiply.  The design takes them apart as greedy NMS does.  The
//    lattice kernel (nms_lattice_kernel<true>) writes K4's lattice
//    transposed: word w of row j holds bit b for the earlier box
//    i = 64w + b, set when both are valid, i < j, the classes are equal
//    and iou(i, j) >= nms_threshold, so that a box's words list its
//    overlapping predecessors and lie side by side.  The walk kernel
//    (soft_walk_kernel) gives each box j a thread that visits the set
//    bits of its words in ascending i, recomputes that pair's IoU, and
//    multiplies its confidence by the decay, deleting j once it falls
//    below conf_threshold: its chain is as long as its overlaps, not K,
//    and no barrier stands between its words.  (The first design had 32
//    threads of a block multiply a column of 128 factors at a time, 1.0
//    for every pair that does not overlap, so each chain was K long and
//    seven eighths of the block waited on it.)  Words past
//    row j's own word (j / 64) hold no bits and are not read.
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
constexpr int WALK_THREADS = 128;      // Soft-NMS walk: a box a thread,
constexpr int WALK_WORDS = 8;          // its words loaded 8 at a time

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

// Word (c0 / 64) of row r, for a valid row box br: the lane tests the
// column boxes c0 + lane and c0 + 32 + lane, cols[0] being box c0.
// Greedy: row box i suppresses column box j > i.  Soft-NMS (the
// transpose): column box i, valid, overlaps the later row box j.  Called
// by a whole warp.
template <bool SOFT>
__device__ __forceinline__ u64 lattice_word(const Prep& br, int r,
                                            const Prep* cols,
                                            const bool* col_valid, int c0,
                                            int k, float threshold,
                                            int iou_mode, int lane) {
  u64 word = 0ull;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + lane + 32 * h;
    const Prep& bc = cols[lane + 32 * h];
    bool s;
    if (SOFT)
      s = c < r && col_valid[lane + 32 * h] &&
          suppresses(bc, br, threshold, 1);
    else
      s = c > r && c < k && suppresses(br, bc, threshold, iou_mode);
    word |= (u64)__ballot_sync(FULL, s) << (32 * h);
  }
  return word;
}

// The lattice of every image into global scratch (N, K, words): greedy,
// row i over the later boxes j, or (SOFT) row j over the earlier boxes i.
template <bool SOFT>
__global__ void __launch_bounds__(LATTICE_THREADS)
nms_lattice_kernel(const float* __restrict__ boxes, u64* __restrict__ lattice,
                   int k, int words, float threshold, int iou_mode) {
  __shared__ Prep cols[64];
  __shared__ bool col_valid[64];
  __shared__ Prep rows[TILE_ROWS];
  __shared__ bool row_valid[TILE_ROWS];
  const int wd = blockIdx.x, row0 = blockIdx.y * TILE_ROWS;
  const int c0 = wd * 64, tid = threadIdx.x;
  const float* src = boxes + (size_t)blockIdx.z * k * 8;
  u64* dst = lattice + (size_t)blockIdx.z * k * words;

  // no pair of the tile has its column box after (greedy) or before
  // (Soft-NMS) its row box: the words are zero
  if (SOFT ? c0 >= row0 + TILE_ROWS : row0 >= c0 + 64) {
    if (tid < TILE_ROWS && row0 + tid < k)
      dst[(size_t)(row0 + tid) * words + wd] = 0ull;
    return;
  }
  if (tid < 64) {
    if (c0 + tid < k) {
      cols[tid] = prep(src + (size_t)(c0 + tid) * 8);
      col_valid[tid] = src[(size_t)(c0 + tid) * 8 + 7] != 0.0f;
    }
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
      word = lattice_word<SOFT>(rows[rr], i, cols, col_valid, c0, k,
                                threshold, iou_mode, lane);
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

// Soft-NMS: a thread per box j of an image walks the set bits of its
// row of the transposed lattice in ascending i, as the scan applies
// them: recompute iou(i, j), decay by exp(-(iou^2) / sigma) in the
// scan's order (square, negate, divide, exp), multiply, and delete j once
// its confidence is below conf_threshold (a deleted box keeps decaying;
// a decay that underflows to 0 deletes).  The row's words are loaded
// WALK_WORDS at a time, all in flight together, before their bits are
// walked (loaded one at a time, their latency lengthened the walk at
// large K on an H100; computing several decays at once before applying
// them in order gained nothing there).
__global__ void __launch_bounds__(WALK_THREADS)
soft_walk_kernel(const float* __restrict__ boxes,
                 const u64* __restrict__ lattice, float* __restrict__ keep,
                 int k, int words, float conf_threshold, float sigma) {
  const int j = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (j >= k) return;
  const float* src = boxes + (size_t)blockIdx.y * k * 8;
  const float* rj = src + (size_t)j * 8;
  float kept = 0.0f;
  if (rj[7] != 0.0f) {
    const Prep bj = prep(rj);
    float conf = rj[4] * rj[6];
    bool deleted = false;
    const u64* row = lattice + ((size_t)blockIdx.y * k + j) * words;
    const int last = j >> 6;
    for (int w0 = 0; w0 <= last; w0 += WALK_WORDS) {
      u64 batch[WALK_WORDS];
#pragma unroll
      for (int t = 0; t < WALK_WORDS; ++t)
        batch[t] = w0 + t <= last ? row[w0 + t] : 0ull;
#pragma unroll
      for (int t = 0; t < WALK_WORDS; ++t) {
        u64 word = batch[t];
        while (word != 0ull) {
          const int i = (w0 + t) * 64 + __ffsll((long long)word) - 1;
          word &= word - 1ull;
          const float iou = overlap(prep(src + (size_t)i * 8), bj, 1);
          conf = conf * expf(-(iou * iou) / sigma);
          deleted = deleted || conf < conf_threshold;
        }
      }
    }
    kept = deleted ? 0.0f : 1.0f;
  }
  keep[(size_t)blockIdx.y * k + j] = kept;
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
  nms_lattice_kernel<false><<<grid, LATTICE_THREADS, 0, s>>>(
      boxes, lattice, k, words, threshold, iou_mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<n, SCAN_THREADS, smem, s>>>(boxes, lattice, keep, k,
                                                words);
  return (int)cudaGetLastError();
}

// Soft-NMS keep mask: the transposed lattice into scratch (N, K, words),
// then the walk.  Returns the cudaError_t of the launches.
extern "C" int soft_nms_keep_launch(const float* boxes, float* keep,
                                    unsigned long long* lattice, int n,
                                    int k, int words, float nms_threshold,
                                    float conf_threshold, float sigma,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)words, (unsigned)((k + TILE_ROWS - 1) / TILE_ROWS),
            (unsigned)n);
  nms_lattice_kernel<true><<<grid, LATTICE_THREADS, 0, s>>>(
      boxes, lattice, k, words, nms_threshold, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 walk((unsigned)((k + WALK_THREADS - 1) / WALK_THREADS), (unsigned)n);
  soft_walk_kernel<<<walk, WALK_THREADS, 0, s>>>(
      boxes, lattice, keep, k, words, conf_threshold, sigma);
  return (int)cudaGetLastError();
}
