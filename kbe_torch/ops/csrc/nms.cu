// Greedy non-maximum suppression for Hopper (sm_90a): a bitmask NMS, one
// thread-block cluster a set.
//
// Replaces no Pallas kernel: kbe_tpu computes it in XLA, as the bounded
// lax.fori_loop of kbe_tpu/models/maskrcnn.py::_nms_keep (:222-239), and
// computes that function bit for bit on sets already sorted by score
// (kbe_torch/ops/nms.py::keep_plain is the plain version). Mask R-CNN runs
// it six times an image: on the five RPN levels' top-k sets (one launch,
// a cluster a level) and on the box head's set with its class offsets (one
// launch).
//
// The function: slot i, in order for i = 0 .. cap - 1, if still alive,
// kills every slot j > i whose IoU with it is > thresh. A slot starts alive
// where its score is > 0, and a dead slot's score is written as 0. Slots
// past a set's own size are zero-padded (score 0): they never kill, and
// their output stays 0, so a launch takes sets of several sizes.
//
// What bounds it: the chain of rounds, not bytes or arithmetic. A set of
// 512 boxes moves 10 KB in and 2 KB out, under a microsecond of the card's
// memory time, and its 131k IoUs are a few million operations. The first
// version ran the rounds themselves in order, every live round an IoU row
// and a block barrier (about 0.5 us each; PERF.md, section 6). This one
// takes the IoUs off the chain and shortens the chain:
//   1. the IoU pass, fully parallel: the bit matrix mask[i][w], bit b of
//      word w set iff j = 32 w + b > i, slots i and j alive at the start,
//      and IoU(i, j) > thresh. The set's cluster of up to 8 blocks
//      (kMaxCluster) shares the rows (block r takes rows r, r + nb, ...)
//      and writes them into the first block's shared memory through
//      distributed shared memory. A thread takes a word, 32 IoUs unrolled
//      with no branch, so that their latencies overlap, and a warp's
//      threads take rows of one word, so they read the same 32 boxes j
//      (shared-memory broadcasts);
//   2. the scan, one warp, word by word: a few rounds of two warp-wide ORs
//      (REDUX) settle a word's 32 slots, then its kept slots' rows are ORed
//      into the later words' removed bits, four shared loads at once. No
//      barrier, and a dead slot costs nothing.
// The mask sits in shared memory, a row pitch of an odd number of words
// (no bank conflicts down a column): at the largest cap, 1024 x 33 x 4 B
// = 132 KB, plus 20 KB of boxes and areas, as dynamic shared memory. Every
// block of the cluster holds the boxes; only the first one's mask is used.
//
// Exactness: the bits are the plain version's comparisons. The IoU follows
// _iou_matrix's operation order (:210-219), the file is built with
// -fmad=false so that nvcc contracts no product into a sum (area_i +
// area_j - inter), and the IEEE quotient's comparison is made exactly
// without dividing (see the IoU pass). The scan makes the greedy loop's
// decisions (see there). Rows and bits of slots dead
// from the start are never read by the scan; they are written as 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCap = 1024;     // 32 words of 32 slots: one per lane
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxDevices = 64;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int words_of(int cap) { return (cap + 31) >> 5; }
__host__ __device__ inline int pitch_of(int cap) { return words_of(cap) | 1; }

inline size_t smem_bytes(int cap) {
  return (size_t)words_of(cap) * 32 * (sizeof(float4) + sizeof(float))
         + 32 * 4 + (size_t)cap * pitch_of(cap) * 4;
}

__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    int cap, double above, bool up_even, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int set = blockIdx.x / nb;
  const int words = words_of(cap);
  const int pitch = pitch_of(cap);
  // the boxes and areas padded to whole words with zero boxes
  float4* s_box = smem;
  float* s_area = reinterpret_cast<float*>(s_box + 32 * words);
  unsigned* s_alive = reinterpret_cast<unsigned*>(s_area + 32 * words);
  unsigned* s_mask = s_alive + 32;
  const float4* b = boxes + (long long)set * cap;
  const float* s = scores + (long long)set * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < 32 * words; j += blockDim.x) {
    const float4 bj = j < cap ? b[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_box[j] = bj;
    s_area[j] = fmaxf(bj.z - bj.x, 0.0f) * fmaxf(bj.w - bj.y, 0.0f);
  }
  for (int w = warp; w < words; w += kThreads / 32) {
    const int j = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, j < cap && s[j] > 0.0f);
    if (lane == 0) s_alive[w] = bits;
  }
  // every block of the cluster has started (so its shared memory may be
  // written) and holds its boxes and alive bits
  cluster.sync();

  // the IoU pass: a thread a (row, word), its 32 IoUs unrolled and free
  // of branches, so that they overlap; bits of slots not alive dropped.
  // RN(inter / u) > thresh exactly when inter / u > above, the rounding
  // midpoint between thresh and the next float up (>= where that float
  // is even: a tie rounds to it), that is when inter > above * u: above * u
  // (25 by 24 bits) and the comparison are exact in double.
  unsigned* mask = cluster.map_shared_rank(s_mask, 0);
  const int rows = rank < cap ? (cap - rank + nb - 1) / nb : 0;
  for (int t = threadIdx.x; t < rows * words; t += blockDim.x) {
    const int w = t / rows;
    const int i = rank + nb * (t - w * rows);
    const int wi = i >> 5;
    unsigned bits = 0;
    if (w >= wi && ((s_alive[wi] >> (i & 31)) & 1u)) {
      // the live slots of word w after i
      unsigned cand = s_alive[w];
      if (w == wi) cand &= (i & 31) == 31 ? 0u : kFull << ((i & 31) + 1);
      const float4 bi = s_box[i];
      const float ai = s_area[i];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float4 bj = s_box[32 * w + k];
        const float ix1 = fmaxf(bi.x, bj.x);
        const float iy1 = fmaxf(bi.y, bj.y);
        const float ix2 = fminf(bi.z, bj.z);
        const float iy2 = fminf(bi.w, bj.w);
        const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
        const float uni = (ai + s_area[32 * w + k]) - inter;
        const double u = (double)fmaxf(uni, 1e-9f);
        const double x = (double)inter, y = above * u;
        bits |= (unsigned)(up_even ? x >= y : x > y) << k;
      }
      bits &= cand;
    }
    mask[i * pitch + w] = bits;
  }
  // every row is in the first block's shared memory
  cluster.sync();
  if (rank != 0) return;

  // the scan, one warp, word by word. Lane w holds removed[w], the slots
  // of word w killed by kept slots of earlier words; lane b holds d, row
  // 32 w + b's bits of word w (slots after it). A round keeps every
  // undecided slot that no undecided slot kills (the first one at least:
  // any slot that could still kill it is kept or dead), and drops what
  // those kill, two warp-wide ORs: the greedy loop's decisions, a round for
  // each link of the word's longest chain of kills. Then each later word
  // w' gains the OR of the kept slots' rows there, one warp-wide OR a
  // word, four at once.
  if (warp == 0) {
    unsigned removed = 0, keep = 0;
    for (int w = 0; w < words; ++w) {
      unsigned und = s_alive[w] & ~__shfl_sync(kFull, removed, w);
      if (!und) continue;
      const unsigned* row = s_mask + (32 * w + lane) * pitch;
      const bool real = 32 * w + lane < cap;
      const unsigned d = real ? row[w] : 0u;
      unsigned kept = 0;
      while (und) {
        const unsigned hit =
            __reduce_or_sync(kFull, (und >> lane) & 1u ? d : 0u);
        const unsigned now = und & ~hit;
        kept |= now;
        und &= ~(now | __reduce_or_sync(kFull, (now >> lane) & 1u ? d : 0u));
      }
      if (lane == w) keep = kept;
      const bool mine = real && ((kept >> lane) & 1u);
      for (int v = w + 1; v < words; v += 4) {
        // four ORs in flight (past the last word, the last one again)
        unsigned hit[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          hit[u] = __reduce_or_sync(
              kFull, mine ? row[min(v + u, words - 1)] : 0u);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (lane == v + u) removed |= hit[u];
        }
      }
    }
    if (lane < words) s_alive[lane] = keep;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    out[(long long)set * cap + j] =
        (s_alive[j >> 5] >> (j & 31)) & 1u ? s[j] : 0.0f;
  }
}

}  // namespace

extern "C" {

int kbe_nms_max_cap() { return kMaxCap; }

// boxes (sets, cap, 4) xyxy and scores (sets, cap), each set sorted by
// descending score and zero-padded to cap; out (sets, cap): the scores of
// the slots that survive, 0 elsewhere. All f32, contiguous, on the card.
// A cluster of one block per 64 slots, at most 8, takes a set. One launch.
int kbe_nms(const void* boxes, const void* scores, int sets, int cap,
            float thresh, void* out, void* stream) {
  if (sets <= 0 || cap <= 0) return 0;
  if (cap > kMaxCap) return (int)cudaErrorInvalidValue;
  const int nb = (cap + 63) / 64 < kMaxCluster ? (cap + 63) / 64 : kMaxCluster;
  // the midpoint between thresh and the next float up, exact in double
  // (every float is above -inf; none above +inf or NaN)
  const float up = nextafterf(thresh, INFINITY);
  const double above = thresh == -INFINITY
                           ? -INFINITY
                           : (double)thresh + 0.5 * ((double)up - thresh);
  const bool up_even = (reinterpret_cast<const unsigned&>(up) & 1u) == 0;
  // the largest cap's shared memory allowed once a device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxCap));
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const size_t smem = smem_bytes(cap);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sets * nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_kernel,
                           static_cast<const float4*>(boxes),
                           static_cast<const float*>(scores), cap, above,
                           up_even, static_cast<float*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
