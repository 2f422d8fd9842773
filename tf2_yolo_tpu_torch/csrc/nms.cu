// Greedy class-wise NMS over confidence-sorted boxes, one block per image.
//
// Replaces the Pallas TPU kernel nms_pallas (_nms_kernel and
// _nms_kernel_blocked) of tf2_yolo_tpu/ops/pallas/nms_kernel.py.
//
// Input rows are (N, K, 8) f32 [x, y, w, h, conf, cls, prob, valid],
// each image sorted by joint confidence, descending.  Output keep is
// (N, K) f32 in {0, 1}.  Semantics of the TPU kernel: box i suppresses
// box j when i is still alive, i is valid, j > i, the classes are equal
// and overlap(i, j) >= threshold (IoU, or DIoU for iou_mode 2); the
// result is alive * valid.
//
// Layout: the block copies its image's K rows and an alive flag per row
// into shared memory, then walks i = 0 .. K-1; at each step every thread
// updates the candidates j > i it owns (threads stride over K) and the
// block synchronises once.  The TPU kernel materialises the (K, K)
// overlap lattice in VMEM and caps K at 1024; here each step recomputes
// row i of the lattice on the fly, so shared memory holds only
// 36 bytes per box and K is bounded by the 227 KB a block may use
// (K <= 6456), checked by the wrapper.
//
// What bounds it on an H100: the K dependent steps, each one
// __syncthreads and O(K / blockDim) arithmetic per thread; it is latency
// bound, with one SM per image.
//
// Exactness: the overlap arithmetic is written in the order of the plain
// version (tf2_yolo_tpu_torch/ops/geometry.py pair_iou), and this file
// is built with --fmad=false, so no multiply-add is contracted and every
// operation rounds as a separate IEEE f32 operation, as the plain
// version's do; keep masks compare exactly.

#include <cuda_runtime.h>

namespace {

constexpr float EPSILON = 1e-07f;

struct Box {
  float x, y, w, h, conf, cls, prob, valid;
};

__device__ __forceinline__ float overlap(const Box& a, const Box& b,
                                         int iou_mode) {
  float ax1 = a.x - a.w / 2.0f, ax2 = a.x + a.w / 2.0f;
  float ay1 = a.y - a.h / 2.0f, ay2 = a.y + a.h / 2.0f;
  float bx1 = b.x - b.w / 2.0f, bx2 = b.x + b.w / 2.0f;
  float by1 = b.y - b.h / 2.0f, by2 = b.y + b.h / 2.0f;
  float iw = fmaxf(fminf(bx2, ax2) - fmaxf(bx1, ax1), 0.0f);
  float ih = fmaxf(fminf(by2, ay2) - fmaxf(by1, ay1), 0.0f);
  float inter = iw * ih;
  float area_a = a.w * a.h;
  float area_b = b.w * b.h;
  float uni = area_a + area_b - inter;
  float iou = inter / (uni + EPSILON);
  if (iou_mode == 2) {
    float ew = fmaxf(bx2, ax2) - fminf(bx1, ax1);
    float eh = fmaxf(by2, ay2) - fminf(by1, ay1);
    float c2 = ew * ew + eh * eh;
    float dx = a.x - b.x, dy = a.y - b.y;
    float rho2 = dx * dx + dy * dy;
    iou = iou - rho2 / c2;
  }
  return iou;
}

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                float* __restrict__ keep, int k,
                                float threshold, int iou_mode) {
  extern __shared__ float smem[];
  Box* sb = reinterpret_cast<Box*>(smem);
  int* alive = reinterpret_cast<int*>(sb + k);
  const Box* src = reinterpret_cast<const Box*>(boxes) + (size_t)blockIdx.x * k;

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    sb[j] = src[j];
    alive[j] = 1;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // alive[i] is final here: only steps before i write it
    if (alive[i] && sb[i].valid != 0.0f) {
      const Box bi = sb[i];
      for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
        if (sb[j].cls == bi.cls && overlap(bi, sb[j], iou_mode) >= threshold)
          alive[j] = 0;
      }
    }
    __syncthreads();
  }

  float* out = keep + (size_t)blockIdx.x * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    out[j] = alive[j] ? sb[j].valid : 0.0f;
}

}  // namespace

// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int nms_keep_launch(const float* boxes, float* keep, int n, int k,
                               float threshold, int iou_mode, void* stream) {
  int smem = k * (int)(sizeof(Box) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((k + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  nms_keep_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      boxes, keep, k, threshold, iou_mode);
  return (int)cudaGetLastError();
}
