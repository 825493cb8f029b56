// The partial convolution's mask side for Hopper (sm_90a): coverage ->
// ratio -> bias -> re-mask, one kernel a partial conv.
//
// Replaces no TPU kernel: kbe_tpu computes the partial conv
// (models/partial_conv.py) in XLA, which fuses the chain. The port ran it
// as plain PyTorch: an all-ones f32 convolution over the mask's C_in
// identical channels, then about a dozen elementwise passes, most of them
// over C_out channels. This kernel computes the plain chain
// (kbe_torch/ops/pconv.py::mask_side_plain on a one-channel mask) bit for
// bit:
//   coverage = box_sum(mask) * C_in        k x k, stride, zero padding
//   new_mask = clamp(coverage, 0, 1)
//   ratio    = (window / (coverage + 1e-8)) * new_mask
//   out      = (raw * ratio + bias) * new_mask
// with window = C_in * k * k, each product and sum rounded apart
// (__fmul_rn, __fadd_rn, -fmad=false: no contracted FMA) and an IEEE
// quotient (__fdiv_rn), as torch.div gives. For a 0/1 mask the box sum is
// exact in any order. raw is bf16 or f32; bias is in raw's type; out and
// the new mask are f32.
//
// What bounds it: bytes. It must read raw (2 or 4 B a value) and write out
// (4 B a value), and read the one-channel mask and write the new one (4 B
// a pixel each): at the stem's 32 channels of 1024^2 in bf16 about 210 MB,
// 63 us at 3.35 TB/s. The chain it replaces passed the C_out-wide f32
// tensors several times and ran the coverage as a convolution without
// tensor cores.
//
// Design: a block takes a tile of pixels of one image (blockIdx.y), about
// 8192 output values, at most kThreads pixels. First one thread a pixel
// sums its window of the mask (read through the read-only cache: the
// windows of neighbouring pixels overlap), writes the new mask and keeps
// the ratio and the new mask in shared memory. Then the block streams the
// tile's values, VEC consecutive values a thread (one 8 or 16 B load, one
// 16 B store) with consecutive threads on consecutive vectors. In a
// channels-last raw the tile's values are contiguous and a vector lies in
// one pixel (C_out % VEC == 0); in an NCHW raw the block walks the
// channels' planes and a vector spans VEC pixels of one channel (H'W' %
// VEC == 0). The host picks VEC = 4 where that and the alignment hold, else
// 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch.clamp(x, 0, 1): NaN passes through
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* v) {
    v[0] = to_f32(p[0]);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a), v[1] = __high2float(a);
    v[2] = __low2float(b), v[3] = __high2float(b);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    Vec<float, 4>::store(p, v);
  }
};

template <typename T, int VEC, bool NHWC>
__global__ void __launch_bounds__(kThreads)
    pconv_kernel(const T* __restrict__ raw, const float* __restrict__ mask,
                 const T* __restrict__ bias, int c_out, int h, int w,
                 int ho, int wo, float c_in, int k, int stride, int pad,
                 float window, int tile, float* __restrict__ out,
                 float* __restrict__ new_mask) {
  __shared__ float s_ratio[kThreads];
  __shared__ float s_mask[kThreads];
  const int b = blockIdx.y;
  const long long plane = (long long)ho * wo;
  const long long p0 = (long long)blockIdx.x * tile;
  const int np = (int)min((long long)tile, plane - p0);

  // 1. the tile's pixels: coverage, new mask, ratio
  if ((int)threadIdx.x < np) {
    const long long p = p0 + threadIdx.x;
    const int y = (int)(p / wo), x = (int)(p - (long long)y * wo);
    const int y0 = y * stride - pad, x0 = x * stride - pad;
    const float* m = mask ? mask + (long long)b * h * w : nullptr;
    float sum = 0.0f;
    for (int i = 0; i < k; ++i) {
      const int yy = y0 + i;
      if (yy < 0 || yy >= h) continue;
      for (int j = 0; j < k; ++j) {
        const int xx = x0 + j;
        if (xx < 0 || xx >= w) continue;
        sum = __fadd_rn(sum, m ? __ldg(m + (long long)yy * w + xx) : 1.0f);
      }
    }
    const float cov = __fmul_rn(sum, c_in);
    const float nm = clamp01(cov);
    s_ratio[threadIdx.x] =
        __fmul_rn(__fdiv_rn(window, __fadd_rn(cov, 1e-8f)), nm);
    s_mask[threadIdx.x] = nm;
    new_mask[(long long)b * plane + p] = nm;
  }
  __syncthreads();

  // 2. the tile's values, VEC a thread
  const int n_vec = np * c_out / VEC;
  const int row_vecs = np / VEC;  // NCHW: the vectors of a channel's row
  for (int t = threadIdx.x; t < n_vec; t += kThreads) {
    long long off;
    int pix, ch;
    if (NHWC) {
      const int e = t * VEC;
      pix = e / c_out;
      ch = e - pix * c_out;
      off = ((long long)b * plane + p0 + pix) * c_out + ch;
    } else {
      ch = t / row_vecs;
      pix = (t - ch * row_vecs) * VEC;
      off = ((long long)b * c_out + ch) * plane + p0 + pix;
    }
    float v[VEC];
    Vec<T, VEC>::load(raw + off, v);
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const int pl = NHWC ? pix : pix + l;
      const float bb = to_f32(bias[NHWC ? ch + l : ch]);
      v[l] = __fmul_rn(__fadd_rn(__fmul_rn(v[l], s_ratio[pl]), bb),
                       s_mask[pl]);
    }
    Vec<T, VEC>::store(out + off, v);
  }
}

template <typename T, int VEC, bool NHWC>
int launch(const void* raw, const void* mask, const void* bias, int b,
           int c_out, int h, int w, int ho, int wo, int c_in, int k,
           int stride, int pad, int tile, void* out, void* new_mask,
           cudaStream_t stream) {
  const long long plane = (long long)ho * wo;
  const dim3 grid((unsigned)((plane + tile - 1) / tile), (unsigned)b);
  pconv_kernel<T, VEC, NHWC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const float*>(mask),
      static_cast<const T*>(bias), c_out, h, w, ho, wo, (float)c_in, k,
      stride, pad, (float)(c_in * k * k), tile, static_cast<float*>(out),
      static_cast<float*>(new_mask));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int nhwc, int vec, const void* raw, const void* mask,
             const void* bias, int b, int c_out, int h, int w, int ho,
             int wo, int c_in, int k, int stride, int pad, int tile,
             void* out, void* new_mask, cudaStream_t stream) {
  if (nhwc) {
    return vec == 4 ? launch<T, 4, true>(raw, mask, bias, b, c_out, h, w, ho,
                                         wo, c_in, k, stride, pad, tile, out,
                                         new_mask, stream)
                    : launch<T, 1, true>(raw, mask, bias, b, c_out, h, w, ho,
                                         wo, c_in, k, stride, pad, tile, out,
                                         new_mask, stream);
  }
  return vec == 4 ? launch<T, 4, false>(raw, mask, bias, b, c_out, h, w, ho,
                                        wo, c_in, k, stride, pad, tile, out,
                                        new_mask, stream)
                  : launch<T, 1, false>(raw, mask, bias, b, c_out, h, w, ho,
                                        wo, c_in, k, stride, pad, tile, out,
                                        new_mask, stream);
}

}  // namespace

extern "C" {

// raw: (b, c_out, ho, wo) in bf16 (raw_bf16) or f32, NCHW or, with nhwc,
// channels-last; mask: (b, 1, h, w) f32, or null for all ones; bias:
// (c_out) in raw's type; out: raw's shape and layout, f32; new_mask: (b, 1,
// ho, wo) f32. tile pixels a block (a multiple of vec, at most 256); vec 4
// needs c_out % 4 == 0 (nhwc) or ho * wo % 4 == 0 (NCHW) and raw aligned
// to 4 values.
int kbe_pconv(const void* raw, int raw_bf16, int nhwc, const void* mask,
              const void* bias, int b, int c_out, int h, int w, int ho,
              int wo, int c_in, int k, int stride, int pad, int tile,
              int vec, void* out, void* new_mask, void* stream) {
  if (b <= 0 || c_out <= 0 || ho <= 0 || wo <= 0) return 0;
  if (tile <= 0 || tile > kThreads || (vec != 1 && vec != 4)
      || tile % vec != 0 || c_in <= 0 || k <= 0 || stride <= 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (nhwc ? c_out % 4 != 0 : ((long long)ho * wo) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return raw_bf16
             ? dispatch<__nv_bfloat16>(nhwc, vec, raw, mask, bias, b, c_out,
                                       h, w, ho, wo, c_in, k, stride, pad,
                                       tile, out, new_mask, s)
             : dispatch<float>(nhwc, vec, raw, mask, bias, b, c_out, h, w,
                               ho, wo, c_in, k, stride, pad, tile, out,
                               new_mask, s);
}

}  // extern "C"
