// Max-pool backward (VALID padding) for Hopper (sm_90a).
//
// Replaces the TPU kernel theanompi_tpu/ops/pallas_pool.py
// `_pool_bwd_kernel` (called through `maxpool_bwd` and the
// `maxpool_pallas` custom_vjp).  For x (N, H, W, C), its pooled max
// y (N, OH, OW, C) and the cotangent dy (N, OH, OW, C), all NHWC:
//
//   cnt[n,p,q,c] = #{(di,dj) : x[n, p*sh+di, q*sw+dj, c] == y[n,p,q,c]}
//   dx[n,i,j,c]  = sum over windows (p,q) whose tap (di,dj) lands on
//                  (i,j) and equals the max of dy[n,p,q,c] / cnt[n,p,q,c]
//
// The cotangent of a window is split EQUALLY across its tied maxima, as
// the TPU kernel and the reference's mask backward do (torch's own
// max-pool backward routes it to one max instead).  Taps are compared
// in fp32 after an exact widening, as the TPU kernel does.
//
// What bounds it on this card: memory.  It reads x, y and dy and writes
// dx, with a handful of compares and adds per element.  The least time
// is those bytes over 3.35 TB/s.  What the design does about it: it is a
// gather, not a scatter: launch 1 takes one thread per output element,
// counts the ties of its window and writes dy / cnt in fp32 at output
// resolution (a quarter of the input's size for 3x3/2); launch 2 takes
// one thread per input element, walks the few windows that cover it
// (at most ceil(kh/sh) * ceil(kw/sw), 4 for 3x3/2) and sums their
// shares.  Every dx element is written once by one thread, so there are
// no atomics and the result does not depend on scheduling: the shares
// are added in the reference's order (offset di outer, dj inner).
// Threads run along C, so loads and stores are coalesced.  The TPU
// kernel's 0/1 selection matmuls existed because strided gathers lower
// poorly on the TPU; here a thread computes its indices directly.  The
// two launches together are the port of the one TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
  return __float2bfloat16(x);
}

struct Geom {
  int n, h, w, c, oh, ow, kh, kw, sh, sw;
};

// Launch 1: dyc = dy / (ties of the window), fp32, output resolution.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_share_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ dy, float* __restrict__ dyc,
                      Geom g) {
  const unsigned total = static_cast<unsigned>(g.n) * g.oh * g.ow * g.c;
  for (unsigned o = blockIdx.x * kThreads + threadIdx.x; o < total;
       o += gridDim.x * kThreads) {
    const unsigned ch = o % g.c;
    unsigned t = o / g.c;
    const int q = static_cast<int>(t % g.ow);
    t /= g.ow;
    const int p = static_cast<int>(t % g.oh);
    const unsigned nn = t / g.oh;
    const float m = to_float(y[o]);
    const T* xn = x + nn * g.h * g.w * g.c + ch;
    int cnt = 0;
    for (int di = 0; di < g.kh; ++di) {
      const int i = p * g.sh + di;
      for (int dj = 0; dj < g.kw; ++dj) {
        const int j = q * g.sw + dj;
        cnt += to_float(xn[(static_cast<unsigned>(i) * g.w + j) * g.c]) == m;
      }
    }
    // every window holds its own max, so cnt >= 1 unless y is not the
    // max-pool of x (then the share is inf/nan, as in the reference)
    dyc[o] = to_float(dy[o]) / static_cast<float>(cnt);
  }
}

// Launch 2: dx by gather over the windows that cover each input element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_gather_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ dyc, T* __restrict__ dx,
                       Geom g) {
  const unsigned total = static_cast<unsigned>(g.n) * g.h * g.w * g.c;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads) {
    const unsigned ch = e % g.c;
    unsigned t = e / g.c;
    const int j = static_cast<int>(t % g.w);
    t /= g.w;
    const int i = static_cast<int>(t % g.h);
    const unsigned nn = t / g.h;
    const float v = to_float(x[e]);
    const unsigned obase = nn * g.oh * g.ow * g.c + ch;
    float acc = 0.f;
    for (int di = 0; di < g.kh; ++di) {
      const int ti = i - di;
      if (ti < 0 || ti % g.sh) continue;
      const int p = ti / g.sh;
      if (p >= g.oh) continue;
      for (int dj = 0; dj < g.kw; ++dj) {
        const int tj = j - dj;
        if (tj < 0 || tj % g.sw) continue;
        const int q = tj / g.sw;
        if (q >= g.ow) continue;
        const unsigned o = obase + (static_cast<unsigned>(p) * g.ow + q) * g.c;
        if (v == to_float(y[o])) acc += dyc[o];
      }
    }
    dx[e] = from_float<T>(acc);
  }
}

// Index arithmetic is 32-bit (64-bit division is emulated and costs
// tens of instructions): x may hold at most kMaxElems elements.
constexpr long kMaxElems = 0x7fffffffL;

unsigned grid_for(long total) {
  const long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < (1L << 20) ? blocks : (1L << 20));
}

template <typename T>
int launch(const void* x, const void* y, const void* dy, float* dyc, void* dx,
           Geom g, cudaStream_t stream) {
  if (g.n < 0 || g.h < 1 || g.w < 1 || g.c < 1 || g.kh < 1 || g.kw < 1 ||
      g.sh < 1 || g.sw < 1 || g.oh != (g.h - g.kh) / g.sh + 1 ||
      g.ow != (g.w - g.kw) / g.sw + 1 || g.oh < 1 || g.ow < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n_out = static_cast<long>(g.n) * g.oh * g.ow * g.c;
  const long n_in = static_cast<long>(g.n) * g.h * g.w * g.c;
  if (n_in > kMaxElems) return static_cast<int>(cudaErrorInvalidValue);
  if (g.n == 0) return 0;
  pool_share_kernel<T><<<grid_for(n_out), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), dyc, g);
  if (cudaError_t rc = cudaGetLastError()) return static_cast<int>(rc);
  pool_gather_kernel<T><<<grid_for(n_in), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), dyc,
      static_cast<T*>(dx), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  `dyc` is fp32 scratch of y's size that
// the caller allocates.  Returns cudaGetLastError() after the launches
// (0 = launched); the caller raises on anything else.
extern "C" {

long maxpool_bwd_max_elements() { return kMaxElems; }

int maxpool_bwd_f32(const void* x, const void* y, const void* dy, float* dyc,
                    void* dx, int n, int h, int w, int c, int oh, int ow,
                    int kh, int kw, int sh, int sw, void* stream) {
  return launch<float>(x, y, dy, dyc, dx,
                       Geom{n, h, w, c, oh, ow, kh, kw, sh, sw},
                       static_cast<cudaStream_t>(stream));
}

int maxpool_bwd_bf16(const void* x, const void* y, const void* dy,
                     float* dyc, void* dx, int n, int h, int w, int c, int oh,
                     int ow, int kh, int kw, int sh, int sw, void* stream) {
  return launch<__nv_bfloat16>(x, y, dy, dyc, dx,
                               Geom{n, h, w, c, oh, ow, kh, kw, sh, sw},
                               static_cast<cudaStream_t>(stream));
}

const char* maxpool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
