// Fused bias + scaled leaky ReLU for Hopper (sm_90a), forward and backward.
//
// K1 replaces the TPU kernel s2v_tpu/ops/pallas/fused_act.py::_fused_fwd_impl
// (body _fwd_kernel): out = scale * leaky_relu(x + bias[c], slope), the
// StyleGAN2 activation of GPEN's EqualLinear(fused_lrelu), StyledConv and
// ConvLayer.
//
// K2 replaces the same file's _fused_bwd (body _bwd_kernel):
// dx = (g + b[c]) * (out >= 0 ? scale : scale * slope), the sign taken from
// the saved forward output. Without b it is the activation's backward; with
// b it is the gradient of that backward (the double backward that R1 needs:
// b is the incoming gradient of dbias). dbias itself is a reduction the
// wrapper leaves to PyTorch, as the TPU kernel leaves it to XLA.
//
// What bounds both: bytes. K1 reads and writes every element once (4 or 2
// bytes each way), K2 reads two and writes one, for a handful of flops, far
// below the H100's ~20 flops/byte f32 ridge, so each kernel's only job is to
// stream memory at full rate.
//
// Design: the tensor is viewed as [outer, C, inner] (NCHW gives
// inner = H*W; a [B, C] linear output gives inner = 1). When inner is a
// multiple of the 16-byte vector width and both pointers are 16-byte
// aligned, each thread moves whole 16-byte vectors (4 f32 or 8 bf16) that
// lie inside one channel plane, so one bias load serves a vector and the
// loads and stores coalesce into full 128-byte lines. Any other shape takes
// a scalar grid-stride loop. Arithmetic is f32 and rounds once on store.
//
// Interface: plain C, one launch per call on the caller's stream, returns the
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

// K2. pos and neg are the multipliers for out >= 0 and out < 0 (scale and
// scale * slope, rounded to f32 by the caller); bias may be null.
template <typename T>
__global__ void bwd_scalar(const T* __restrict__ g, const T* __restrict__ out,
                           const float* __restrict__ bias, T* __restrict__ dx,
                           int64_t n, int C, int64_t inner, float pos,
                           float neg) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float b = bias != nullptr ? bias[(int)((i / inner) % C)] : 0.f;
    const float m = to_f<T>(out[i]) >= 0.f ? pos : neg;
    dx[i] = from_f<T>((to_f<T>(g[i]) + b) * m);
  }
}

template <typename T>
__global__ void bwd_vec(const uint4* __restrict__ g,
                        const uint4* __restrict__ out,
                        const float* __restrict__ bias,
                        uint4* __restrict__ dx, int64_t nvec, int C,
                        int64_t inner_vec, float pos, float neg) {
  constexpr int V = 16 / sizeof(T);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += step) {
    const float b = bias != nullptr ? bias[(int)((v / inner_vec) % C)] : 0.f;
    uint4 graw = g[v], oraw = out[v];
    const T* ge = reinterpret_cast<const T*>(&graw);
    const T* oe = reinterpret_cast<const T*>(&oraw);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < V; ++k)
      r[k] = from_f<T>((to_f<T>(ge[k]) + b) * (to_f<T>(oe[k]) >= 0.f ? pos : neg));
    dx[v] = res;
  }
}

template <typename T>
void launch_bwd(const void* g, const void* out, const float* bias, void* dx,
                int64_t n, int C, int64_t inner, float pos, float neg,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 256;
  const int64_t max_blocks = 132 * 16;
  const bool vec = inner % V == 0 && (uintptr_t)g % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)dx % 16 == 0;
  const int64_t work = vec ? n / V : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    bwd_vec<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint4*>(g), static_cast<const uint4*>(out), bias,
        static_cast<uint4*>(dx), work, C, inner / V, pos, neg);
  } else {
    bwd_scalar<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(out), bias,
        static_cast<T*>(dx), n, C, inner, pos, neg);
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

// K2. g, out and dx are contiguous [outer, C, inner] of one dtype; bias is
// float32 [C] or null.
extern "C" int s2v_fused_lrelu_bwd(const void* g, const void* out,
                                   const float* bias, void* dx,
                                   long long outer, int C, long long inner,
                                   int dtype, float pos, float neg,
                                   void* stream) {
  const int64_t n = (int64_t)outer * C * inner;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(g, out, bias, dx, n, C, inner, pos, neg, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(g, out, bias, dx, n, C, inner, pos, neg, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
