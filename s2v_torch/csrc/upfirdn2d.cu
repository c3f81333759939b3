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
// Accumulation is f32 and the output rounds once to the input's dtype.
//
// What bounds it: bytes. At most 16 multiply-adds per output (8 when the
// FIR is an outer product of two 1-D FIRs, as every GPEN FIR is; fewer for
// up = 2, whose other taps meet stuffed zeros) against 4-8 bytes moved per
// output, far below the H100's f32 ridge (~20 flops per byte).
//
// Why the first version (one thread per output; upfirdn2d_direct below
// keeps its arithmetic) missed that bound: each thread gathered its taps
// straight from device memory, each a scalar load behind its own bounds,
// divisibility and `/ up` predicates, and neighbouring outputs re-read the
// same bytes through L1 4-16 times. It was bound by instructions and load
// requests, not bytes: bf16 and f32 ran in the same time for the same
// output count, at 9x the bytes bound.
//
// This design (upfirdn2d_strips). Each warp streams down a strip of 128
// output columns (4 adjacent per lane) and up to 64 output rows of one
// plane, with no block-wide sync:
// - Input rows go through a warp-private ring of shared rows filled with
//   4-byte cp.async copies, one or two groups of rows in flight while
//   another is read. A row is copied once, so each input byte crosses
//   device memory once (plus a 3-column and 3-row halo). Pad, crop and the
//   input's edges are zero-byte copies, not predicates per tap.
// - Alignment: rows of 2049 bf16 or 513 f32 elements have strides that are
//   no multiple of 16 bytes, and odd rows start at odd elements, so TMA
//   tiles and 16-byte vectors per row do not fit these tensors. f32 copies
//   elements; bf16 copies the aligned 32-bit words that hold the row, and a
//   lane realigns its pairs with a funnel shift by the row's phase (0 or 1,
//   the same for the whole row). Words half outside the input, and every
//   word of the tensor's first and last row, are read half by half, so no
//   read leaves the tensor.
// - Each input row is read from shared memory once per lane and added into
//   a ring of accumulators for the output rows it feeds; an output row is
//   stored, 4 columns per lane, when its last input row is in. Up, down,
//   the stuffing phase of rows and columns (up = 2) and the position in
//   the ring are compile-time, so every tap index is a constant, the taps
//   sit in the constant bank, and no multiplication by a stuffed zero or
//   `% up` is issued (polyphase). The FIR must factor into two 1-D FIRs,
//   as every GPEN FIR does: each row is filtered along x once (4
//   multiply-adds per output column) and added with one tap per output row.
// - Short planes get shorter chunks, down to 8 rows, so a launch fills the
//   card. Outputs narrower than 40 columns (GPEN-2048's 8-, 16- and 32-wide
//   layers), any up/down but GPEN's 1/1, 2/1 and 1/2, and FIRs that do not
//   factor take upfirdn2d_direct: one thread per output, over all planes.
//
// Interface: plain C, one launch on the caller's stream, returns the
// cudaGetLastError() code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

struct Fir {
  float k[16];  // flipped taps, row-major, padded to 4 x 4 with zeros
  float ky[4], kx[4];  // when separable: k[i * 4 + j] == ky[i] * kx[j]
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;             // adjacent output columns per lane (even)
constexpr int kStripW = 32 * kCols;  // output columns per warp
constexpr int kChunk = 64;           // output rows per warp, at most (a multiple of 8)
constexpr int kSmallW = 40;          // narrower outputs take upfirdn2d_direct

// The plan for one (T, UP, DOWN). A warp's strip of output columns reads
// SPAN input columns of each input row; lane l's outputs start at column
// OWN * l of them and read NA columns (at most). One input row feeds at
// most NP output rows, so NP accumulators per output column form a ring
// that P input rows turn once. A row sits in shared memory as RW 32-bit
// units: f32 elements, or (WORDS, bf16) aligned words of two elements, the
// first word holding the row's first column in its low (phase 0) or high
// (phase 1) half.
template <typename T, int UP, int DOWN>
struct Plan {
  static constexpr bool WORDS = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int OWN = kCols * DOWN / UP;
  static constexpr int SPAN = ((kStripW - 1) * DOWN + 3 + UP - 1) / UP + 1;
  static constexpr int NA = ((kCols - 1) * DOWN + 3 + UP - 1) / UP + 1;
  static constexpr int NP = 3 / DOWN + 1;
  static constexpr int P = NP * DOWN / UP;
  static constexpr int RW = ((WORDS ? (SPAN + 2) / 2 : SPAN) + 1) / 2 * 2;  // even: float2 reads
  // the ring of shared rows, in groups of P: NG - 1 groups in flight while
  // one is read, within the 48 KB of static shared memory a block may have
  static constexpr int NG = 3 * P * RW * 4 * kWarps <= 48 * 1024 ? 3 : 2;
  static constexpr int RING = NG * P;
  static_assert((kCols * DOWN) % UP == 0 && (NP * DOWN) % UP == 0, "plan");
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's task: row0 points at input column ix0 of input row iy0 (the
// strip's first input column and row) in its plane.
template <typename T>
struct Src {
  const T* x;     // the tensor (a valid address for zero-byte copies)
  const T* row0;
  int iy0, ix0, H, W;
  bool first_plane, last_plane;
  bool interior;  // the strip's input columns (bf16: and their words) all in [0, W)
};

// Starts the copy of input row q of the strip into the shared row dst.
// Rows and columns outside the input (pad, crop edge) become zeros, by
// zero-byte copies. A bf16 word with one half outside the input (at its
// left or right edge), and every word of the tensor's first and last row,
// is read half by half with plain loads instead, so no read leaves the
// tensor and no half outside the input is kept.
template <typename T, int UP, int DOWN>
__device__ __forceinline__ void copy_row(uint32_t* dst, const Src<T>& s, int q, bool live,
                                         int lane) {
  using P = Plan<T, UP, DOWN>;
  const int iy = s.iy0 + q;
  const bool row_ok = live && (unsigned)iy < (unsigned)s.H;
  const T* e0 = s.row0 + (int64_t)q * s.W;
  if (row_ok && s.interior && !(s.first_plane && iy == 0) && !(s.last_plane && iy == s.H - 1)) {
    // the whole row span inside the input, away from the tensor's ends
    const T* src = e0;
    if constexpr (P::WORDS) src -= (reinterpret_cast<uintptr_t>(e0) >> 1) & 1;
#pragma unroll
    for (int c = lane; c < P::RW; c += 32)
      if (P::WORDS || c < P::SPAN) cp_async4(dst + c, src + (P::WORDS ? 2 : 1) * c, 4);
    return;
  }
  if constexpr (!P::WORDS) {
#pragma unroll
    for (int c = lane; c < P::SPAN; c += 32) {
      const bool ok = row_ok && (unsigned)(s.ix0 + c) < (unsigned)s.W;
      cp_async4(dst + c, ok ? e0 + c : s.x, ok ? 4 : 0);
    }
  } else {
    const int ph = (int)((reinterpret_cast<uintptr_t>(e0) >> 1) & 1);
    const bool exact = (s.first_plane && iy == 0) || (s.last_plane && iy == s.H - 1);
#pragma unroll
    for (int w = lane; w < P::RW; w += 32) {
      const int col = s.ix0 - ph + 2 * w;
      const bool lo = row_ok && (unsigned)col < (unsigned)s.W;
      const bool hi = row_ok && (unsigned)(col + 1) < (unsigned)s.W;
      const T* src = e0 - ph + 2 * w;
      if (!exact && lo == hi) {
        cp_async4(dst + w, lo ? src : s.x, lo ? 4 : 0);
      } else {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
        dst[w] = (lo ? (uint32_t)h[0] : 0u) | (hi ? (uint32_t)h[1] << 16 : 0u);
      }
    }
  }
}

// a[n] = input column OWN * lane + n of the shared row, n < NA; ph is the
// row's phase (bf16 words).
template <typename T, int UP, int DOWN, int NA>
__device__ __forceinline__ void gather(float (&a)[Plan<T, UP, DOWN>::NA], const uint32_t* row,
                                       int ph, int lane) {
  using P = Plan<T, UP, DOWN>;
  if constexpr (!P::WORDS) {
    const float* f = reinterpret_cast<const float*>(row) + P::OWN * lane;
    if constexpr (P::OWN % 2 == 0) {  // 8-byte aligned
#pragma unroll
      for (int n = 0; n + 1 < NA; n += 2) {
        const float2 v = *reinterpret_cast<const float2*>(f + n);
        a[n] = v.x;
        a[n + 1] = v.y;
      }
      if constexpr (NA % 2) a[NA - 1] = f[NA - 1];
    } else {
#pragma unroll
      for (int n = 0; n < NA; ++n) a[n] = f[n];
    }
  } else {
    constexpr int NW = NA / 2 + 1;  // words that hold NA elements from either half
    const int m = P::OWN * lane + ph;
    const uint32_t* w = row + (m >> 1);
    uint32_t v[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) v[k] = w[k];
#pragma unroll
    for (int k = 0; 2 * k < NA; ++k) {  // the element pair (2k, 2k + 1) from m on
      const uint32_t pair = __funnelshift_r(v[k], k + 1 < NW ? v[k + 1] : 0u, 16 * (m & 1));
      a[2 * k] = __uint_as_float(pair << 16);
      if (2 * k + 1 < NA) a[2 * k + 1] = __uint_as_float(pair & 0xffff0000u);
    }
  }
}

// Stores the first n (where p's row ends) of the kCols outputs v at p: in
// pairs when p is aligned for them (a row of an even width always is, every
// other row of an odd width), else one by one (measured faster on those
// rows than a single, pairs and a single).
template <typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[kCols], int n) {
  if (((reinterpret_cast<uintptr_t>(p) / sizeof(T)) & 1) == 0) {
#pragma unroll
    for (int k = 0; k < kCols; k += 2) {
      if (k + 1 < n) store2(p + k, v[k], v[k + 1]);
      else if (k < n) p[k] = from_f<T>(v[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (k < n) p[k] = from_f<T>(v[k]);
  }
}

// One warp's work: n_out output rows (at most kChunk) x kStripW output
// columns of a plane, streaming down the input rows they need through its
// ring of RING shared rows. Output row t of the chunk takes input row q
// through tap row i = q * UP - t * DOWN - RY, and input column n of the
// lane through tap column j = n * UP - k * DOWN - RX for its column k.
// The FIR is separable (k[i][j] = ky[i] * kx[j]): each input row is
// filtered along x once per output column, then added into each output row
// it feeds with one tap. Within a group of P rows (q0 a multiple of P)
// every tap index, ring slot and phase test is a compile-time constant
// after unrolling: the taps are constant-bank operands, and no tap that
// meets a stuffed zero (up = 2: three in four) is issued. An accumulator is
// zeroed at its output row's first input row, which also drops what rows
// before the chunk left in it.
template <typename T, int UP, int DOWN, int RY, int RX>
__device__ __forceinline__ void strip(const Src<T>& s, uint32_t (*ring)[Plan<T, UP, DOWN>::RW],
                                      T* __restrict__ o, int n_out, int OW, int ox, int lane,
                                      const Fir& fir) {
  using P = Plan<T, UP, DOWN>;
  constexpr int NA = ((kCols - 1) * DOWN + 3 + RX) / UP + 1;
  const int q_end = ((n_out - 1) * DOWN + RY + 3) / UP + 1;  // input rows the chunk reads
  const int ph0 = (int)((reinterpret_cast<uintptr_t>(s.row0) >> 1) & 1);
  float acc[P::NP][kCols] = {};
#pragma unroll
  for (int q = 0; q < (P::NG - 1) * P::P; ++q) {
    copy_row<T, UP, DOWN>(ring[q], s, q, q < q_end, lane);
    if (q % P::P == P::P - 1) cp_async_commit();
  }
  for (int q0 = 0, g = 0; q0 < q_end; q0 += P::P, g = g + 1 == P::NG ? 0 : g + 1) {
    // refill the slots read last time with the group NG - 1 ahead
    const int ahead = q0 + (P::NG - 1) * P::P;
    uint32_t(*refill)[P::RW] = ring + (g == 0 ? P::NG - 1 : g - 1) * P::P;
#pragma unroll
    for (int r = 0; r < P::P; ++r)
      copy_row<T, UP, DOWN>(refill[r], s, ahead + r, ahead + r < q_end, lane);
    cp_async_commit();
    cp_async_wait<P::NG - 1>();  // group q0 has landed
    __syncwarp();
    const uint32_t(*rows)[P::RW] = ring + g * P::P;
    const int t0 = q0 * UP / DOWN;  // a multiple of NP
#pragma unroll
    for (int r = 0; r < P::P; ++r) {
      float a[P::NA];
      gather<T, UP, DOWN, NA>(a, rows[r], (ph0 + (q0 + r) * s.W) & 1, lane);
      float h[kCols];  // the row filtered along x, per output column
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        h[k] = 0.f;
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const int j = n * UP - k * DOWN - RX;
          if (j >= 0 && j < 4) h[k] += fir.kx[j] * a[n];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int num = r * UP - RY - i;
        if (num % DOWN != 0) continue;
        const int t = num / DOWN;  // output row, relative to t0
        const int slot = ((t % P::NP) + P::NP) % P::NP;
        if (i < UP) {  // the output row's first input row
#pragma unroll
          for (int k = 0; k < kCols; ++k) acc[slot][k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[slot][k] += fir.ky[i] * h[k];
        if (i + UP > 3 && t0 + t >= 0 && t0 + t < n_out)  // its last input row
          store_cols(o + (int64_t)(t0 + t) * OW + ox, acc[slot], OW - ox);
      }
    }
    __syncwarp();  // the group's slots may be refilled
  }
  cp_async_wait<0>();
}

// x: [planes, H, W]; out: [planes, OH, OW]. Each warp takes one task: a
// strip of kStripW output columns and `chunk` output rows of one plane,
// tasks ordered strip, chunk, plane. UP, DOWN in {1, 2}, not both 2.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_strips(const T* __restrict__ x, T* __restrict__ out, int64_t planes, int H, int W,
                 int OH, int OW, int strips, int chunks, int chunk, int pad_y0, int pad_x0,
                 Fir fir) {
  using P = Plan<T, UP, DOWN>;
  __shared__ __align__(16) uint32_t rings[kWarps][P::RING][P::RW];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t task = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t p = task / ((int64_t)strips * chunks);
  if (p >= planes) return;
  const int rest = (int)(task - p * strips * chunks);
  const int oy0 = (rest / strips) * chunk, ox0 = (rest % strips) * kStripW;
  // the strip's first input row and column, and the stuffing phase of its
  // first output (0 unless UP = 2)
  const int iy0 = floor_div(oy0 * DOWN - pad_y0, UP);
  const int ix0 = floor_div(ox0 * DOWN - pad_x0, UP);
  const int ry = oy0 * DOWN - pad_y0 - iy0 * UP;
  const int rx = ox0 * DOWN - pad_x0 - ix0 * UP;
  const Src<T> s{x, x + p * H * W + (int64_t)iy0 * W + ix0, iy0, ix0, H, W, p == 0,
                 p == planes - 1, ix0 - 1 >= 0 && ix0 + 2 * P::RW <= W};
  T* o = out + p * OH * OW + (int64_t)oy0 * OW;
  const int n_out = min(chunk, OH - oy0), ox = ox0 + kCols * lane;
  uint32_t(*ring)[P::RW] = rings[warp];
  if constexpr (UP == 1) {
    strip<T, UP, DOWN, 0, 0>(s, ring, o, n_out, OW, ox, lane, fir);
  } else if (ry == 0) {
    if (rx == 0) strip<T, UP, DOWN, 0, 0>(s, ring, o, n_out, OW, ox, lane, fir);
    else strip<T, UP, DOWN, 0, 1>(s, ring, o, n_out, OW, ox, lane, fir);
  } else {
    if (rx == 0) strip<T, UP, DOWN, 1, 0>(s, ring, o, n_out, OW, ox, lane, fir);
    else strip<T, UP, DOWN, 1, 1>(s, ring, o, n_out, OW, ox, lane, fir);
  }
}

// One thread per output, over all planes (I: a 32-bit index when the output
// has fewer than 2^31 elements): any up/down or FIR, and outputs narrower
// than kSmallW (GPEN-2048's 8-, 16- and 32-wide layers), whose planes would
// leave most lanes of a strip idle (measured 2-3x faster there). An output
// (oy, ox) reads the stuffed-and-padded signal at (oy*down + i, ox*down + j)
// for the taps (i, j); that is input sample ((oy*down + i - pad_y0) / up,
// ...) when it is a non-negative multiple of up inside the input, else
// zero. UP and DOWN are compile-time for GPEN's
// cases and 0 (read at run time) otherwise.
template <typename T, int UP, int DOWN, typename I>
__global__ void upfirdn2d_direct(const T* __restrict__ x, T* __restrict__ out, I total, int H,
                                 int W, int OH, int OW, int up_rt, int down_rt, int pad_y0,
                                 int pad_x0, int kh, int kw, Fir fir) {
  const int up = UP > 0 ? UP : up_rt;
  const int down = DOWN > 0 ? DOWN : down_rt;
  for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (I)gridDim.x * blockDim.x) {
    const int ox = (int)(idx % OW);
    const I rest = idx / OW;
    const int oy = (int)(rest % OH);
    const T* plane = x + (int64_t)(rest / OH) * H * W;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sy = oy * down + i - pad_y0;
      if (i >= kh || sy < 0 || sy % up != 0 || sy / up >= H) continue;
      const T* row = plane + (int64_t)(sy / up) * W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sx = ox * down + j - pad_x0;
        if (j < kw && sx >= 0 && sx % up == 0 && sx / up < W)
          acc += fir.k[i * 4 + j] * to_f<T>(row[sx / up]);
      }
    }
    out[idx] = from_f<T>(acc);
  }
}

template <typename T, int UP, int DOWN>
void launch_direct(const void* x, void* out, int64_t planes, int H, int W, int OH, int OW,
                   int up, int down, int pad_y0, int pad_x0, int kh, int kw, const Fir& fir,
                   cudaStream_t s) {
  const int64_t total = planes * OH * OW;
  const unsigned blocks = (unsigned)std::min<int64_t>((total + 255) / 256, 1 << 20);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (total < (int64_t)1 << 31)
    upfirdn2d_direct<T, UP, DOWN, int><<<blocks, 256, 0, s>>>(
        xt, ot, (int)total, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir);
  else
    upfirdn2d_direct<T, UP, DOWN, int64_t><<<blocks, 256, 0, s>>>(
        xt, ot, total, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir);
}

template <typename T, int UP, int DOWN>
void launch_strips(const void* x, void* out, int64_t planes, int H, int W, int OH, int OW,
                   int pad_y0, int pad_x0, const Fir& fir, cudaStream_t s) {
  // rows per warp: kChunk, or fewer (a multiple of 8, so every chunk starts
  // at the same stuffing phase) when that leaves a wave of warps short
  const int strips = (OW + kStripW - 1) / kStripW;
  const int64_t wave = 132 * 64, columns = planes * strips;  // 64 warps on each of 132 SMs
  const int want = (int)std::min<int64_t>((wave + columns - 1) / columns, (OH + 7) / 8);
  const int chunk = std::min(kChunk, ((OH + want - 1) / want + 7) / 8 * 8);
  const int chunks = (OH + chunk - 1) / chunk;
  const int64_t warps = columns * chunks;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  upfirdn2d_strips<T, UP, DOWN><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), planes, H, W, OH, OW, strips, chunks, chunk,
      pad_y0, pad_x0, fir);
}

// Whether the padded taps factor as k[i][j] == ky[i] * kx[j] exactly in
// f32 (GPEN's FIRs, outer products of [1, 3, 3, 1] / 8 and the like, do);
// fills fir.ky and fir.kx when they do.
bool separate(Fir& fir) {
  int i0 = 0, j0 = 0;
  for (int e = 0; e < 16; ++e)
    if (fabsf(fir.k[e]) > fabsf(fir.k[i0 * 4 + j0])) i0 = e / 4, j0 = e % 4;
  const float pivot = fir.k[i0 * 4 + j0];
  if (pivot == 0.f) return false;
  for (int i = 0; i < 4; ++i) fir.ky[i] = fir.k[i * 4 + j0] / pivot;
  for (int j = 0; j < 4; ++j) fir.kx[j] = fir.k[i0 * 4 + j];
  for (int e = 0; e < 16; ++e)
    if (fir.ky[e / 4] * fir.kx[e % 4] != fir.k[e]) return false;
  return true;
}

template <typename T, int UP, int DOWN>
void launch(const void* x, void* out, int64_t planes, int H, int W, int OH, int OW, int up,
            int down, int pad_y0, int pad_x0, int kh, int kw, Fir& fir, cudaStream_t s) {
  bool strips = false;
  if constexpr (UP > 0) {  // GPEN's up/down
    strips = OW >= kSmallW && separate(fir);
    if (strips)
      launch_strips<T, UP, DOWN>(x, out, planes, H, W, OH, OW, pad_y0, pad_x0, fir, s);
  }
  if (!strips)
    launch_direct<T, UP, DOWN>(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw,
                               fir, s);
}

template <typename T>
void dispatch(const void* x, void* out, int64_t planes, int H, int W, int OH, int OW,
              int up, int down, int pad_y0, int pad_x0, int kh, int kw, Fir& fir,
              cudaStream_t s) {
  auto run = up == 1 && down == 1   ? launch<T, 1, 1>
             : up == 2 && down == 1 ? launch<T, 2, 1>
             : up == 1 && down == 2 ? launch<T, 1, 2>
                                    : launch<T, 0, 0>;
  run(x, out, planes, H, W, OH, OW, up, down, pad_y0, pad_x0, kh, kw, fir, s);
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
