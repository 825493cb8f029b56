// Greedy non-maximum suppression for Hopper (sm_90a): a block a set.
//
// Replaces no Pallas kernel: kbe_tpu computes it in XLA, as the bounded
// lax.fori_loop of kbe_tpu/models/maskrcnn.py::_nms_keep (:222-239), and
// computes that function bit for bit on sets already sorted by score
// (kbe_torch/ops/nms.py::keep_plain is the plain version). Mask R-CNN runs
// it six times an image: on the five RPN levels' top-k sets (one launch,
// a block a level) and on the box head's set with its class offsets (one
// launch).
//
// Round i, in order for i = 0 .. cap - 1: if slot i is still alive, it kills
// every slot j > i whose IoU with it is > thresh. A slot starts alive where
// its score is > 0, and a dead slot's score is written as 0. Slots past a
// set's own size are zero-padded (score 0): they never kill, and their
// output stays 0, so a launch takes sets of several sizes.
//
// What bounds it: the rounds are serial. A set of 512 boxes moves 10 KB in
// and 2 KB out, under a microsecond of the card's memory time, and 512^2
// IoUs are a few million operations; the time goes to up to cap rounds,
// each a barrier. The design: the set's boxes, their areas and the alive
// flags sit in shared memory (at most 512 x 21 B), a thread takes a slot j
// (cap <= 512), and a round whose slot i is dead costs one shared read and
// no barrier: alive[i] was last written in a killing round before i, each
// of which ends in a barrier, so every thread reads the same value.
//
// The IoU follows _iou_matrix's operation order (:210-219), and the file
// is built with -fmad=false so that nvcc contracts no product into a sum
// (area_i + area_j - inter); the division is IEEE (__fdiv_rn).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCap = 512;

__global__ void nms_kernel(const float4* __restrict__ boxes,
                           const float* __restrict__ scores, int cap,
                           float thresh, float* __restrict__ out) {
  __shared__ float4 s_box[kMaxCap];
  __shared__ float s_area[kMaxCap];
  __shared__ unsigned char s_alive[kMaxCap];
  const int set = blockIdx.x;
  const float4* b = boxes + static_cast<long>(set) * cap;
  const float* s = scores + static_cast<long>(set) * cap;
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    const float4 bj = b[j];
    s_box[j] = bj;
    s_area[j] = fmaxf(bj.z - bj.x, 0.0f) * fmaxf(bj.w - bj.y, 0.0f);
    s_alive[j] = s[j] > 0.0f;
  }
  __syncthreads();
  for (int i = 0; i < cap; ++i) {
    if (!s_alive[i]) continue;  // the same value in every thread
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    for (int j = i + 1 + threadIdx.x; j < cap; j += blockDim.x) {
      if (!s_alive[j]) continue;
      const float4 bj = s_box[j];
      const float ix1 = fmaxf(bi.x, bj.x);
      const float iy1 = fmaxf(bi.y, bj.y);
      const float ix2 = fminf(bi.z, bj.z);
      const float iy2 = fminf(bi.w, bj.w);
      const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
      const float uni = (ai + s_area[j]) - inter;
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
      if (iou > thresh) s_alive[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < cap; j += blockDim.x)
    out[static_cast<long>(set) * cap + j] = s_alive[j] ? s[j] : 0.0f;
}

}  // namespace

extern "C" {

int kbe_nms_max_cap() { return kMaxCap; }

// boxes (sets, cap, 4) xyxy and scores (sets, cap), each set sorted by
// descending score and zero-padded to cap; out (sets, cap): the scores of
// the slots that survive, 0 elsewhere. All f32, contiguous, on the card.
int kbe_nms(const void* boxes, const void* scores, int sets, int cap,
            float thresh, void* out, void* stream) {
  if (sets <= 0 || cap <= 0) return 0;
  if (cap > kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (cap + 31) / 32 * 32;
  nms_kernel<<<sets, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      cap, thresh, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
