// The frame's finish for Hopper (sm_90a): quantise -> sub-pixel crop ->
// round -> bilinear resize -> round, one kernel a frame.
//
// Replaces no TPU kernel: kbe_tpu finishes a frame in XLA
// (pipeline/kenburns.py: the uint8 quantise, ops/resize.py::
// crop_rect_subpix_mm and ::resize_bilinear), which fuses the chain. The
// port ran it as plain PyTorch, about 142 launches a frame. This kernel
// computes that plain chain (kbe_torch/ops/finish.py::finish_plain) bit
// for bit:
//   Q = floor(clamp(rgb * 255, 0, 255))                    the filled frame
//   C = clamp(rint(interp_x(interp_y(Q))), 0, 255)         the crop
//   out = clamp(rint(resize_x(resize_y(C))), 0, 255)       uint8
// where each interpolation along an axis is x[lo] * w_lo + x[hi] * w_hi,
// two products rounded apart, then added (__fmul_rn, __fadd_rn, and
// -fmad=false: no contracted FMA), and rint rounds half to even as
// torch.round does. The taps (lo, hi, w_lo, w_hi) of the four axes are
// built once an effect by the plain chain's own code and passed in.
//
// What bounds it: it must read the crop's window of the (h, w, 4) f32
// frame (16 B a pixel, alpha unused) and write the (h, w, 3) uint8 frame:
// at 1024^2 with a 921^2 crop about 13.3 MB, 4 us at 3.35 TB/s. Launches,
// not bytes, were the cost of the chain it replaces.
//
// Design: a block takes a tile of ty x tx output pixels. Both tap tables
// are monotone, so the tile reads the crop rows [ry.lo[first],
// ry.hi[last]] and columns likewise, and those read the source window
// [cy.lo[first crop row], cy.hi[last crop row]] x (the same in x). The
// block stages Q of that window in shared memory (one 16 B load a pixel,
// coalesced), builds the crop rows it needs over the window's columns,
// then the crop patch, then the resized rows, each stage in shared memory
// behind a barrier, and writes the tile's bytes (consecutive threads on
// consecutive bytes). Every source pixel is read from device memory once
// a tile. The host (finish.py::finish_plan) sizes the two buffers for the
// largest window of a tile.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// a table is (4, n) int32: lo, hi, then the bits of w_lo and w_hi
struct Taps {
  const int* t;
  int n;
  __device__ __forceinline__ int lo(int i) const { return __ldg(t + i); }
  __device__ __forceinline__ int hi(int i) const { return __ldg(t + n + i); }
  __device__ __forceinline__ float wlo(int i) const {
    return __int_as_float(__ldg(t + 2 * n + i));
  }
  __device__ __forceinline__ float whi(int i) const {
    return __int_as_float(__ldg(t + 3 * n + i));
  }
};

// torch.clamp(x, 0, 255): NaN passes through
__device__ __forceinline__ float clamp255(float x) {
  return x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
}

__device__ __forceinline__ float quantise(float v) {
  return floorf(clamp255(__fmul_rn(v, 255.0f)));
}

__device__ __forceinline__ float two_taps(float a, float wl, float b,
                                          float wh) {
  return __fadd_rn(__fmul_rn(a, wl), __fmul_rn(b, wh));
}

__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float4* __restrict__ src, int h, int w, Taps cy,
                  Taps cx, Taps ry, Taps rx, int ty, int tx, int a_floats,
                  unsigned char* __restrict__ out) {
  extern __shared__ float smem[];
  float* a = smem;             // Q of the window, then the crop patch
  float* b = smem + a_floats;  // the crop's rows, then the resized rows
  const int oy0 = blockIdx.y * ty, ox0 = blockIdx.x * tx;
  const int ny = min(ty, h - oy0), nx = min(tx, w - ox0);
  const int cr0 = ry.lo(oy0), ncr = ry.hi(oy0 + ny - 1) - cr0 + 1;
  const int cc0 = rx.lo(ox0), ncc = rx.hi(ox0 + nx - 1) - cc0 + 1;
  const int sr0 = cy.lo(cr0), nsr = cy.hi(cr0 + ncr - 1) - sr0 + 1;
  const int sc0 = cx.lo(cc0), nsc = cx.hi(cc0 + ncc - 1) - sc0 + 1;

  // 1. Q of the source window: a[r][c][k], nsr x nsc
  for (int p = threadIdx.x; p < nsr * nsc; p += kThreads) {
    const int r = p / nsc, c = p - r * nsc;
    const float4 v = __ldg(src + (size_t)(sr0 + r) * w + sc0 + c);
    a[3 * p] = quantise(v.x);
    a[3 * p + 1] = quantise(v.y);
    a[3 * p + 2] = quantise(v.z);
  }
  __syncthreads();
  // 2. the crop along y over the window's columns: b, ncr x nsc
  for (int e = threadIdx.x; e < ncr * nsc * 3; e += kThreads) {
    const int p = e / 3, k = e - 3 * p;
    const int r = p / nsc, c = p - r * nsc, row = cr0 + r;
    b[e] = two_taps(a[((cy.lo(row) - sr0) * nsc + c) * 3 + k], cy.wlo(row),
                    a[((cy.hi(row) - sr0) * nsc + c) * 3 + k], cy.whi(row));
  }
  __syncthreads();
  // 3. the crop along x, rounded: a, ncr x ncc
  for (int e = threadIdx.x; e < ncr * ncc * 3; e += kThreads) {
    const int p = e / 3, k = e - 3 * p;
    const int r = p / ncc, c = p - r * ncc, col = cc0 + c;
    a[e] = clamp255(rintf(
        two_taps(b[(r * nsc + cx.lo(col) - sc0) * 3 + k], cx.wlo(col),
                 b[(r * nsc + cx.hi(col) - sc0) * 3 + k], cx.whi(col))));
  }
  __syncthreads();
  // 4. the resize along y: b, ny x ncc
  for (int e = threadIdx.x; e < ny * ncc * 3; e += kThreads) {
    const int p = e / 3, k = e - 3 * p;
    const int i = p / ncc, c = p - i * ncc, row = oy0 + i;
    b[e] = two_taps(a[((ry.lo(row) - cr0) * ncc + c) * 3 + k], ry.wlo(row),
                    a[((ry.hi(row) - cr0) * ncc + c) * 3 + k], ry.whi(row));
  }
  __syncthreads();
  // 5. the resize along x, rounded, into the frame
  for (int e = threadIdx.x; e < ny * nx * 3; e += kThreads) {
    const int p = e / 3, k = e - 3 * p;
    const int i = p / nx, j = p - i * nx, col = ox0 + j;
    const float v = clamp255(rintf(
        two_taps(b[(i * ncc + rx.lo(col) - cc0) * 3 + k], rx.wlo(col),
                 b[(i * ncc + rx.hi(col) - cc0) * 3 + k], rx.whi(col))));
    out[((size_t)(oy0 + i) * w + ox0 + j) * 3 + k] = (unsigned char)v;
  }
}

}  // namespace

extern "C" {

// src: (h, w, 4) f32, 16 B aligned; out: (h, w, 3) uint8. crop_y (4, ch)
// and crop_x (4, cw) index the frame's rows and columns, resize_y (4, h)
// and resize_x (4, w) the crop's. Tiles of ty x tx outputs; shared memory
// a_floats + b_floats floats, which must hold each tile's stages (the
// host's plan).
int kbe_finish(const void* src, int h, int w, const void* crop_y, int ch,
               const void* crop_x, int cw, const void* resize_y,
               const void* resize_x, int ty, int tx, int a_floats,
               int b_floats, void* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (ty <= 0 || tx <= 0 || ch <= 0 || cw <= 0 || a_floats <= 0
      || b_floats <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (a_floats + b_floats) * (int)sizeof(float);
  // the largest shared memory asked for so far, allowed once a device
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const dim3 grid((w + tx - 1) / tx, (h + ty - 1) / ty);
  finish_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(src), h, w,
      Taps{static_cast<const int*>(crop_y), ch},
      Taps{static_cast<const int*>(crop_x), cw},
      Taps{static_cast<const int*>(resize_y), h},
      Taps{static_cast<const int*>(resize_x), w}, ty, tx, a_floats,
      static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
