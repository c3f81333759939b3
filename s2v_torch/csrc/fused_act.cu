// Fused bias + scaled leaky ReLU for Hopper (sm_90a).
//
// Replaces the TPU kernel s2v_tpu/ops/pallas/fused_act.py::_fused_fwd_impl
// (body _fwd_kernel): out = scale * leaky_relu(x + bias[c], slope), the
// StyleGAN2 activation of GPEN's EqualLinear(fused_lrelu), StyledConv and
// ConvLayer.
//
// What bounds it: bytes. Every element is read once and written once (4 or
// 2 bytes each way) for four flops, far below the H100's ~20 flops/byte
// f32 ridge, so the kernel's only job is to stream memory at full rate.
//
// Design: the tensor is viewed as [outer, C, inner] (NCHW gives
// inner = H*W; a [B, C] linear output gives inner = 1). When inner is a
// multiple of the 16-byte vector width and both pointers are 16-byte
// aligned, each thread moves whole 16-byte vectors (4 f32 or 8 bf16) that
// lie inside one channel plane, so one bias load serves a vector and the
// loads and stores coalesce into full 128-byte lines. Any other shape takes
// a scalar grid-stride loop. Arithmetic is f32 and rounds once on store.
//
// Interface: plain C, one launch on the caller's stream, returns the
// cudaGetLastError() code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

__device__ __forceinline__ float act(float y, float slope, float scale) {
  return scale * (y >= 0.f ? y : y * slope);
}

template <typename T>
__global__ void fused_scalar(const T* __restrict__ x,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int64_t n, int C,
                             int64_t inner, float slope, float scale) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = (int)((i / inner) % C);
    out[i] = from_f<T>(act(to_f<T>(x[i]) + bias[c], slope, scale));
  }
}

template <typename T>
__global__ void fused_vec(const uint4* __restrict__ x,
                          const float* __restrict__ bias,
                          uint4* __restrict__ out, int64_t nvec, int C,
                          int64_t inner_vec, float slope, float scale) {
  constexpr int V = 16 / sizeof(T);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += step) {
    const float b = bias[(int)((v / inner_vec) % C)];
    uint4 raw = x[v];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < V; ++k) r[k] = from_f<T>(act(to_f<T>(e[k]) + b, slope, scale));
    out[v] = res;
  }
}

template <typename T>
void launch(const void* x, const float* bias, void* out, int64_t n, int C,
            int64_t inner, float slope, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 256;
  const int64_t max_blocks = 132 * 16;  // grid-stride beyond ~16 blocks/SM
  const bool vec = inner % V == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int64_t work = vec ? n / V : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    fused_vec<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint4*>(x), bias, static_cast<uint4*>(out), work, C,
        inner / V, slope, scale);
  } else {
    fused_scalar<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), bias, static_cast<T*>(out), n, C, inner,
        slope, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and out are contiguous
// [outer, C, inner]; bias is float32 [C].
extern "C" int s2v_fused_bias_lrelu(const void* x, const float* bias, void* out,
                                    long long outer, int C, long long inner,
                                    int dtype, float slope, float scale,
                                    void* stream) {
  const int64_t n = (int64_t)outer * C * inner;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, bias, out, n, C, inner, slope, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, bias, out, n, C, inner, slope, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
