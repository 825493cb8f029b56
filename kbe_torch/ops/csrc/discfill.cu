// Disocclusion fill for Hopper (sm_90a): one kernel, a half-warp per hole
// pixel.
//
// Replaces the TPU kernels
//   kbe_tpu/ops/discfill_pallas.py::_build_gated_flagging_kernel (phase 1)
//   kbe_tpu/ops/discfill_pallas.py::_build_gated_kernel          (phase 2)
// (K2; shared body _tile_fill_core, entry fill_disocclusion_pallas) and
// computes their spec, kbe_tpu/ops/discfill.py::fill_disocclusion,
// bit for bit: for each hole pixel (depth <= 0) inside the ROI, march the
// 32 rays (16 directions, both ways) over the c_round offset tables up to
// `steps`; each ray stops at its first event, a valid pixel or leaving the
// image. The first direction whose two rays both end on a valid pixel, with
// the strictly smallest f32 distance between the endpoints, wins, and the
// pixel takes all channels of the endpoint with the larger depth. Pixels
// that are no hole, or lie outside the ROI, copy their input.
//
// What the TPU kernel needed and this one does not: a TPU core walks tiles
// in order with vector-wide marches, so the Pallas fill split the march
// into a short phase 1 that proves per-pixel stability, a gated phase 2 on
// flagged tiles and an XLA phase 0 for thin holes.
//
// What bounds it: at 1024^2 with 4 channels it must read the image and the
// depth (20 MB) and write the image (16 MB), ~11 us at 3.35 TB/s; the
// march adds one dependent depth read a ray step. The first version gave
// each pixel a thread that marched its 32 rays one after another to their
// ends while the warp's other threads waited: up to 32 x 128 dependent
// steps for one hole pixel, 1.87 ms a frame where holes stay open (dolly).
//
// Design: a warp takes a strip of 32 consecutive pixels and copies it (one
// 16 B load and store a lane when C = 4). A ballot picks the strip's hole
// pixels inside the ROI; they are filled two at a time, one a half-warp.
// Lane d of a half marches direction d's two rays ("to" d, "from" d + 16)
// in rounds of kRound steps: it reads the round's offsets (one 128 B row of
// the [step][ray] shared-memory table a step, packed int16 (x, y) pairs)
// and depths first, so a round is one trip to memory, then takes each
// ray's first event in order. Exact early stop, checked after each round:
// endpoint k of a ray is c_round(k d_hat), at most sqrt(2)/2 from k d_hat,
// so a pair whose rays end at lengths kt and kf is at least kt + kf -
// sqrt(2) apart (kSlack adds a margin for f32). A marching ray's length is
// at least its steps so far + 1. Once a pair is complete at distance best,
// a pair whose bound is strictly greater than best cannot win, not even a
// tie, and stops; the half stops when no pair of it is left marching. The
// march then costs about half the winning distance, in rounds of kRound
// steps, not the sum of 32 ray lengths.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kRays = 32;
constexpr int kMaxSteps = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// sqrt(2) + 1e-3: the largest kt + kf - dist over the tables is 1.4071
constexpr float kSlack = 1.4153f;
constexpr int kRound = 8;  // steps a ray takes between two stop checks

enum RayState { kMarch = 0, kHit = 1, kFail = 2 };

// [step][ray]: step k + 1 of ray r as (ox & 0xffff) | (oy << 16); rays
// 16..31 are the negated rays 0..15, from
// kbe_torch/ops/discfill.py::_offset_tables.
__device__ int g_off[kMaxSteps * kRays];

struct Ray {
  int st = kMarch, len = 0, ey = 0, ex = 0;
};

// Steps k0 .. k0 + kRound - 1 of ray r from (y0, x0), up to its first
// event: all positions and depths are read first, so the round costs one
// trip to memory; then the first event is taken in order. Returns the
// steps up to and including the event (or the round's end).
__device__ __forceinline__ int march_round(Ray& ray, const int* s_off,
                                           const float* __restrict__ depth,
                                           int h, int w, int steps, int r,
                                           int y0, int x0, int k0) {
  if (ray.st != kMarch) return 0;
  int qy[kRound], qx[kRound];
  bool in[kRound];
  float dv[kRound];
#pragma unroll
  for (int s = 0; s < kRound; ++s) {
    const int k = k0 + s;
    const int off = k < steps ? s_off[k * kRays + r] : 0;
    qy[s] = y0 + (off >> 16);
    qx[s] = x0 + (int)(short)(off & 0xffff);
    in[s] = qy[s] >= 0 && qy[s] < h && qx[s] >= 0 && qx[s] < w;
    dv[s] = k < steps && in[s] ? depth[(long long)qy[s] * w + qx[s]] : 0.0f;
  }
  int taken = 0;
#pragma unroll
  for (int s = 0; s < kRound; ++s) {
    const int k = k0 + s;
    if (ray.st != kMarch || k >= steps) break;
    ++taken;
    if (!in[s]) {
      ray.st = kFail;
    } else if (dv[s] > 0.0f) {
      ray.st = kHit;
      ray.ey = qy[s];
      ray.ex = qx[s];
      ray.len = k + 1;
    }
  }
  if (ray.st == kMarch && k0 + kRound >= steps) ray.st = kFail;  // no steps
  return taken;
}

// min over the 16 lanes of a half-warp
__device__ __forceinline__ int half_min(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    discfill_kernel(const float* __restrict__ image,
                    const float* __restrict__ depth, int h, int w, int c,
                    int steps, int roi_y0, int roi_y1, int roi_x0, int roi_x1,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ stats) {
  __shared__ int s_off[kMaxSteps * kRays];
  for (int t = threadIdx.x; t < steps * kRays; t += blockDim.x) {
    s_off[t] = g_off[t];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int d = lane & 15;  // the lane's direction: rays d and d + 16
  const unsigned half_mask = 0xffffu << (16 * half);
  const long long npix = (long long)h * w;
  const long long nstrips = (npix + 31) / 32;
  unsigned long long ray_steps = 0, rounds = 0;
  for (long long strip = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       strip < nstrips; strip += (long long)gridDim.x * kWarps) {
    const long long pix = strip * 32 + lane;
    const bool in = pix < npix;
    int y = 0, x = 0;
    bool hole = false;
    if (in) {
      if (c == 4) {
        reinterpret_cast<float4*>(out)[pix] =
            reinterpret_cast<const float4*>(image)[pix];
      } else {
        for (int ch = 0; ch < c; ++ch) out[pix * c + ch] = image[pix * c + ch];
      }
      y = (int)(pix / w);
      x = (int)(pix - (long long)y * w);
      hole = !(depth[pix] > 0.0f) && y >= roi_y0 && y < roi_y1 &&
             x >= roi_x0 && x < roi_x1;
    }
    unsigned holes = __ballot_sync(kFull, hole);
    __syncwarp();  // the copy lands before any fill of this strip
    while (holes) {
      // two hole pixels at a time, one a half-warp
      int owner[2] = {-1, -1};
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (holes) {
          owner[o] = __ffs(holes) - 1;
          holes &= holes - 1;
        }
      }
      const int mine = owner[half];
      const int y0 = __shfl_sync(kFull, y, mine < 0 ? 0 : mine);
      const int x0 = __shfl_sync(kFull, x, mine < 0 ? 0 : mine);
      Ray to, from;
      if (mine < 0) to.st = from.st = kFail;
      bool keep = mine >= 0;
      int dist_bits = INT_MAX;  // the pair's distance once complete
      for (int k0 = 0; k0 < steps; k0 += kRound) {
        if (keep) {
          ray_steps += march_round(to, s_off, depth, h, w, steps, d, y0, x0,
                                   k0);
          ray_steps += march_round(from, s_off, depth, h, w, steps, d + 16,
                                   y0, x0, k0);
        }
        if (lane == 0) ++rounds;
        const int next = k0 + kRound + 1;  // a marching ray's least length
        const int least = (to.st == kHit ? to.len : next) +
                          (from.st == kHit ? from.len : next);
        const bool complete = to.st == kHit && from.st == kHit;
        const bool dead = to.st == kFail || from.st == kFail;
        if (complete) {
          const float ddx = (float)(to.ex - from.ex);
          const float ddy = (float)(to.ey - from.ey);
          dist_bits = __float_as_int(__fsqrt_rn(
              __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy))));
        }
        // distances are >= 0, so their bits order as the floats do
        const int best_bits = half_min(dist_bits);
        const float bound = __fsub_rn((float)least, kSlack);
        keep = !dead && !complete &&
               !(best_bits != INT_MAX && bound > __int_as_float(best_bits));
        if (!__any_sync(kFull, keep)) break;
      }
      const int win_bits = half_min(dist_bits);
      // the first direction of the smallest distance, in each half
      const unsigned winners =
          __ballot_sync(kFull, win_bits != INT_MAX && dist_bits == win_bits) &
          half_mask;
      if (winners != 0 && lane == __ffs(winners) - 1) {
        const long long t = (long long)to.ey * w + to.ex;
        const long long f = (long long)from.ey * w + from.ex;
        const long long src = depth[f] < depth[t] ? t : f;
        const long long dst = strip * 32 + mine;
        if (c == 4) {
          reinterpret_cast<float4*>(out)[dst] =
              reinterpret_cast<const float4*>(image)[src];
        } else {
          for (int ch = 0; ch < c; ++ch) {
            out[dst * c + ch] = image[src * c + ch];
          }
        }
      }
    }
  }
  if (stats != nullptr) {
    for (int o = 16; o > 0; o >>= 1) {
      ray_steps += __shfl_xor_sync(kFull, ray_steps, o);
    }
    if (lane == 0) {
      atomicAdd(stats, ray_steps);
      atomicAdd(stats + 1, rounds);
    }
  }
}

}  // namespace

extern "C" {

// packed: host array of kMaxSteps * kRays int32 offsets, [step][ray].
int kbe_discfill_set_tables(const int* packed) {
  cudaError_t err =
      cudaMemcpyToSymbol(g_off, packed, sizeof(int) * kRays * kMaxSteps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int kbe_discfill_max_steps() { return kMaxSteps; }

// image, out: (h*w, c) f32, 16 B aligned; depth: (h*w,) f32; roi as
// [y0, y1) x [x0, x1); h, w < 32768. stats: null, or two u64 that gain the
// ray steps marched (up to each ray's event) and the warps' rounds.
int kbe_discfill(const float* image, const float* depth, int h, int w, int c,
                 int steps, int roi_y0, int roi_y1, int roi_x0, int roi_x1,
                 float* out, unsigned long long* stats, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long strips = ((long long)h * w + 31) / 32;
  const long long want = (strips + kWarps - 1) / kWarps;
  const int blocks = (int)(want < 4LL * sms ? want : 4LL * sms);
  if (blocks > 0) {
    discfill_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        image, depth, h, w, c, steps, roi_y0, roi_y1, roi_x0, roi_x1, out,
        stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
