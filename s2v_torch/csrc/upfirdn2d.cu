// upfirdn2d (upsample, FIR filter, downsample) for Hopper (sm_90a).
//
// Replaces the TPU kernel s2v_tpu/ops/pallas/upfirdn2d.py::upfirdn2d_pallas
// (body _fir_down_kernel), the StyleGAN2 resampling primitive behind
// GPEN's blur, upsample and encoder downsample. Semantics, per spatial axis:
//   1. insert (up-1) zeros after every sample,
//   2. pad by (pad0, pad1); a negative pad crops,
//   3. correlate with the FIR (the wrapper passes it already flipped, so
//      this is a convolution with the caller's kernel),
//   4. keep every down-th sample.
//
// What bounds it: bytes. A GPEN call does at most 16 multiply-adds per
// output against 4-8 bytes moved per output, below the H100's f32 ridge.
// The Pallas kernel pays for a zero-stuffed, padded copy built in XLA and
// falls back to XLA above ~1100 columns; this kernel never builds either:
// each thread computes output pixels directly, folding the zero-stuffing
// and the pad or crop into its index arithmetic, so device memory sees one
// read of the input (the up to 4x4 overlapping reads between neighbouring
// outputs hit L1/L2) and one write of the output, at any width. Taps are
// kernel parameters (constant bank), accumulation is f32, and the output
// rounds once. Neighbouring threads take neighbouring output columns, so
// stores coalesce and loads stay within a few cache lines per warp.
//
// Interface: plain C, one launch on the caller's stream, returns the
// cudaGetLastError() code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fir {
  float k[16];  // flipped taps, row-major, padded to 4 x 4 with zeros
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x: [planes, H, W]; out: [planes, OH, OW]. An output (oy, ox) reads the
// stuffed-and-padded signal at (oy*down + i, ox*down + j) for the taps
// (i, j); that position is input sample ((oy*down + i - pad_y0) / up, ...)
// when it is a non-negative multiple of up inside the input, else zero.
// One thread per output column; blockIdx.y walks rows and blockIdx.z
// planes, so no index needs a 64-bit division. UP and DOWN are compile-time
// for GPEN's cases (1/1, 2/1, 1/2) and 0 (read at run time) otherwise; the
// taps are padded to 4x4 so every tap index is static after unrolling.
template <typename T, int UP, int DOWN>
__global__ void upfirdn2d_direct(const T* __restrict__ x, T* __restrict__ out,
                                 int64_t planes, int H, int W, int OH, int OW,
                                 int up_rt, int down_rt, int pad_y0,
                                 int pad_x0, int kh, int kw, Fir fir) {
  const int up = UP > 0 ? UP : up_rt;
  const int down = DOWN > 0 ? DOWN : down_rt;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= OW) return;
  int ix[4];
  bool okx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int sx = ox * down + j - pad_x0;
    okx[j] = j < kw && sx >= 0 && sx % up == 0 && sx / up < W;
    ix[j] = okx[j] ? sx / up : 0;
  }
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* plane = x + p * H * W;
    T* orow = out + p * OH * OW;
    for (int oy = blockIdx.y; oy < OH; oy += gridDim.y) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sy = oy * down + i - pad_y0;
        if (i >= kh || sy < 0 || sy % up != 0 || sy / up >= H) continue;
        const T* row = plane + (int64_t)(sy / up) * W;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (okx[j]) acc += fir.k[i * 4 + j] * to_f<T>(row[ix[j]]);
      }
      orow[(int64_t)oy * OW + ox] = from_f<T>(acc);
    }
  }
}

template <typename T, int UP, int DOWN>
void launch(const void* x, void* out, int64_t planes, int H, int W, int OH,
            int OW, int up, int down, int pad_y0, int pad_x0, int kh, int kw,
            const Fir& fir, cudaStream_t stream) {
  const int threads = OW >= 256 ? 256 : ((OW + 31) / 32) * 32;
  dim3 grid((OW + threads - 1) / threads, OH < 65535 ? OH : 65535,
            planes < 65535 ? (unsigned)planes : 65535u);
  upfirdn2d_direct<T, UP, DOWN><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), planes, H, W, OH, OW,
      up, down, pad_y0, pad_x0, kh, kw, fir);
}

template <typename T>
void dispatch(const void* x, void* out, int64_t planes, int H, int W, int OH,
              int OW, int up, int down, int pad_y0, int pad_x0, int kh,
              int kw, const Fir& fir, cudaStream_t s) {
  if (up == 1 && down == 1)
    launch<T, 1, 1>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir, s);
  else if (up == 2 && down == 1)
    launch<T, 2, 1>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir, s);
  else if (up == 1 && down == 2)
    launch<T, 1, 2>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir, s);
  else
    launch<T, 0, 0>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. taps: kh*kw flipped f32 taps.
extern "C" int s2v_upfirdn2d(const void* x, void* out, long long planes, int H,
                             int W, int OH, int OW, int up, int down,
                             int pad_y0, int pad_x0, int kh, int kw,
                             const float* taps, int dtype, void* stream) {
  if (kh < 1 || kw < 1 || kh > 4 || kw > 4 || up < 1 || down < 1)
    return (int)cudaErrorInvalidValue;
  if (planes == 0 || OH <= 0 || OW <= 0) return 0;
  Fir fir = {};
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) fir.k[i * 4 + j] = taps[i * kw + j];  // host array
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir, s);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh,
                            kw, fir, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
