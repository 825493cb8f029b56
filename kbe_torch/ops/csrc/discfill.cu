// Disocclusion fill for Hopper (sm_90a): one kernel, one thread per pixel.
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
// flagged tiles and an XLA phase 0 for thin holes. A Hopper thread marches
// its own pixel and stops at its own events, so one pass suffices.
//
// What bounds it: at 1024^2 with 4 channels it must read the image and the
// depth (20 MB) and write the image (16 MB), ~11 us at 3.35 TB/s. Hole
// pixels add data-dependent march reads (one depth read a step), served
// mostly from L1/L2. The offset tables sit in __constant__ memory: threads
// of a warp that march in step read the same entry, which is a broadcast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRays = 32;
constexpr int kMaxSteps = 256;
constexpr int kThreads = 256;

// Row r, column k: offset of step k + 1 of ray r (rays 16..31 are the
// negated rays 0..15), from kbe_torch/ops/discfill.py::_offset_tables.
__constant__ short c_ox[kRays * kMaxSteps];
__constant__ short c_oy[kRays * kMaxSteps];

// First event of ray r from (y, x): true with the endpoint if it is a
// valid pixel; false if the ray leaves the image or runs out of steps.
__device__ __forceinline__ bool march(const float* __restrict__ depth, int h,
                                      int w, int y, int x, int r, int steps,
                                      int* ey, int* ex) {
  for (int k = 0; k < steps; ++k) {
    const int py = y + c_oy[r * kMaxSteps + k];
    const int px = x + c_ox[r * kMaxSteps + k];
    if (py < 0 || py >= h || px < 0 || px >= w) return false;
    if (depth[py * w + px] > 0.0f) {
      *ey = py;
      *ex = px;
      return true;
    }
  }
  return false;
}

__global__ void discfill_kernel(const float* __restrict__ image,
                                const float* __restrict__ depth, int h, int w,
                                int c, int steps, int roi_y0, int roi_y1,
                                int roi_x0, int roi_x1,
                                float* __restrict__ out) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  const int y = pix / w;
  const int x = pix - y * w;
  int src = pix;
  const bool hole = !(depth[pix] > 0.0f);
  if (hole && y >= roi_y0 && y < roi_y1 && x >= roi_x0 && x < roi_x1) {
    float best = INFINITY;
    int bty = 0, btx = 0, bfy = 0, bfx = 0;
    bool found = false;
    for (int d = 0; d < 16; ++d) {
      int ty, tx, fy, fx;
      if (!march(depth, h, w, y, x, d, steps, &ty, &tx)) continue;
      if (!march(depth, h, w, y, x, d + 16, steps, &fy, &fx)) continue;
      const float ddx = (float)(tx - fx);
      const float ddy = (float)(ty - fy);
      const float dist =
          __fsqrt_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)));
      if (dist < best) {  // strict: the first minimum wins
        best = dist;
        bty = ty;
        btx = tx;
        bfy = fy;
        bfx = fx;
        found = true;
      }
    }
    if (found) {
      const float d_from = depth[bfy * w + bfx];
      const float d_to = depth[bty * w + btx];
      src = d_from < d_to ? bty * w + btx : bfy * w + bfx;
    }
  }
  const float* s = image + (long long)src * c;
  float* o = out + (long long)pix * c;
  for (int ch = 0; ch < c; ++ch) o[ch] = s[ch];
}

}  // namespace

extern "C" {

// ox, oy: host arrays of kRays * kMaxSteps int16 offsets.
int kbe_discfill_set_tables(const short* ox, const short* oy) {
  cudaError_t err =
      cudaMemcpyToSymbol(c_ox, ox, sizeof(short) * kRays * kMaxSteps);
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(c_oy, oy, sizeof(short) * kRays * kMaxSteps);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int kbe_discfill_max_steps() { return kMaxSteps; }

// image, out: (h*w, c) f32; depth: (h*w,) f32; roi as [y0, y1) x [x0, x1).
int kbe_discfill(const float* image, const float* depth, int h, int w, int c,
                 int steps, int roi_y0, int roi_y1, int roi_x0, int roi_x1,
                 float* out, void* stream) {
  const long long n = (long long)h * w;
  discfill_kernel<<<(int)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(image, depth, h, w, c, steps,
                                            roi_y0, roi_y1, roi_x0, roi_x1,
                                            out);
  return (int)cudaGetLastError();
}

}  // extern "C"
