// Cross-channel local response normalization, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels theanompi_tpu/ops/pallas_lrn.py `_fwd_kernel`
// and `_bwd_kernel` (called through the `lrn` custom_vjp and
// `_rowblock_call`).  An NHWC activation is viewed as (M, C) rows, the
// window runs along C: W(c) = {j : j - c in [-size/2, size-1-size/2]}.
//
//   forward:  D_c = k + alpha * sum_{j in W(c)} x_j^2
//             y_c = x_c * D_c^-beta
//   backward: u_c  = dy_c * x_c * D_c^(-beta-1)
//             dx_i = dy_i * D_i^-beta
//                    - 2 alpha beta * x_i * sum_{c : i in W(c)} u_c
//
// D is recomputed from x in the backward, as the TPU kernel does: only x
// is kept between the passes.  The reverse window {c : i in W(c)} equals
// W(i) only for odd sizes.
//
// What bounds it on this card: memory.  Per element the forward does
// about size + 10 flops on 2 + 2 bytes (bf16) or 4 + 4 (fp32), far below
// the ~20 fp32 flops per byte at which the H100's ALUs become the limit.
// The least time is the bytes of x and y (forward) or x, dy and dx
// (backward) over 3.35 TB/s.  What the design does about it: each
// element of x (and dy) is read from device memory once and each output
// written once; the window sums run over an fp32 copy of the tile kept
// in shared memory, so no (M, C) intermediate (x^2, D, u) ever goes to
// device memory.  Neighbouring threads take neighbouring channels of one
// row, so every load and store is coalesced.  The TPU kernel's 0/1 band
// matmul existed because lane shifts are slow on the TPU; here each
// thread sums its `size` neighbours in shared memory directly.
//
// Design (simple first): one CTA of 256 threads takes kRows = 8 rows; C
// is at most kMaxC = 768 so that the backward's two fp32 tiles fit the
// 48 KB of shared memory a block gets without opting in (on this path C
// is 96 or 256).  Later work: more rows per CTA with vectorized 16-byte
// loads, and a fused forward that also writes the window sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kMaxC = 768;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Sum of s[lo..hi] (row-local indices), in increasing index order.
__device__ __forceinline__ float window_sum(const float* s, int lo, int hi) {
  float acc = 0.f;
  for (int j = lo; j <= hi; ++j) acc += s[j];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long m, int c,
                   int size, float alpha, float beta, float k) {
  extern __shared__ float smem[];
  float* sq = smem;  // kRows * c: x^2 of the tile in fp32
  const long row0 = static_cast<long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long>(kRows), m - row0));
  const int n = rows * c;
  const T* xt = x + row0 * c;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = to_float(xt[i]);
    sq[i] = v * v;
  }
  __syncthreads();
  const int pad = size / 2;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / c;
    const int ch = i - r * c;
    const int lo = max(0, ch - pad);
    const int hi = min(c - 1, ch + size - 1 - pad);
    const float d = k + alpha * window_sum(sq + r * c, lo, hi);
    const float v = to_float(xt[i]);
    y[row0 * c + i] = from_float<T>(v * expf(-beta * logf(d)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, long m, int c, int size, float alpha,
                   float beta, float k) {
  extern __shared__ float smem[];
  float* sq = smem;               // kRows * c: x^2
  float* su = smem + kRows * c;   // kRows * c: u = dy x D^(-beta-1)
  const long row0 = static_cast<long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long>(kRows), m - row0));
  const int n = rows * c;
  const long base = row0 * c;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = to_float(x[base + i]);
    sq[i] = v * v;
  }
  __syncthreads();
  const int pad = size / 2;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / c;
    const int ch = i - r * c;
    const float d = k + alpha * window_sum(sq + r * c, max(0, ch - pad),
                                           min(c - 1, ch + size - 1 - pad));
    const float d_mb = expf(-beta * logf(d));
    su[i] = to_float(dy[base + i]) * to_float(x[base + i]) * d_mb / d;
  }
  __syncthreads();
  const float two_ab = 2.f * alpha * beta;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / c;
    const int ch = i - r * c;
    // D again (sq is intact), then the reverse window over u:
    // {c' : ch in W(c')} = [ch - (size-1-pad), ch + pad]
    const float d = k + alpha * window_sum(sq + r * c, max(0, ch - pad),
                                           min(c - 1, ch + size - 1 - pad));
    const float d_mb = expf(-beta * logf(d));
    const float rs = window_sum(su + r * c, max(0, ch - (size - 1 - pad)),
                                min(c - 1, ch + pad));
    const float v = to_float(x[base + i]);
    const float g = to_float(dy[base + i]);
    dx[base + i] = from_float<T>(g * d_mb - two_ab * v * rs);
  }
}

int check(long m, int c, int size) {
  if (m < 0 || c < 1 || c > kMaxC || size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch_fwd(const void* x, void* y, long m, int c, int size, float alpha,
               float beta, float k, cudaStream_t stream) {
  if (int rc = check(m, c, size)) return rc;
  if (m == 0) return 0;
  const unsigned grid = static_cast<unsigned>((m + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * c;
  lrn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), m, c, size, alpha, beta,
      k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, long m, int c,
               int size, float alpha, float beta, float k,
               cudaStream_t stream) {
  if (int rc = check(m, c, size)) return rc;
  if (m == 0) return 0;
  const unsigned grid = static_cast<unsigned>((m + kRows - 1) / kRows);
  const size_t smem = 2 * sizeof(float) * kRows * c;
  lrn_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), m, c, size, alpha, beta, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after
// the launch (0 = launched); the caller raises on anything else.
extern "C" {

int lrn_max_channels() { return kMaxC; }

int lrn_fwd_f32(const void* x, void* y, long m, int c, int size, float alpha,
                float beta, float k, void* stream) {
  return launch_fwd<float>(x, y, m, c, size, alpha, beta, k,
                           static_cast<cudaStream_t>(stream));
}

int lrn_fwd_bf16(const void* x, void* y, long m, int c, int size,
                 float alpha, float beta, float k, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, y, m, c, size, alpha, beta, k,
                                   static_cast<cudaStream_t>(stream));
}

int lrn_bwd_f32(const void* x, const void* dy, void* dx, long m, int c,
                int size, float alpha, float beta, float k, void* stream) {
  return launch_bwd<float>(x, dy, dx, m, c, size, alpha, beta, k,
                           static_cast<cudaStream_t>(stream));
}

int lrn_bwd_bf16(const void* x, const void* dy, void* dx, long m, int c,
                 int size, float alpha, float beta, float k, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, dx, m, c, size, alpha, beta, k,
                                   static_cast<cudaStream_t>(stream));
}

const char* lrn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
