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
// is those bytes over 3.35 TB/s (AlexNet-128's three pools at batch 128
// in bf16: 0.0313 ms a step).  What the design does about it: one
// launch, every byte moved in 16-byte pieces, no scratch in device
// memory.  A CTA owns one image, a band of output rows, a band of
// output columns and a slab of channels (the plan, `plan_maxpool_bwd`
// in ops/pool.py, picks the band and slab sizes so that three CTAs fit
// on an SM).  Along each spatial dimension the band of outputs
// [p0, p1) owns the inputs [p0*s, p1*s), the last band up to the end,
// so every dx element is written exactly once, zeros where no window
// reaches; the windows that touch the owned inputs are the band's own
// and up to (k-1)/s earlier ones (the halo, recomputed by both bands).
// The CTA
//   1. copies the x and y of those windows into shared memory with
//      cp.async, 16 bytes at a time, and tabulates for each owned row
//      and column which staged window (if any) each tap offset hits;
//   2. counts each window's ties and keeps its share dy / cnt in fp32 in
//      shared memory (dy is read once, straight from device memory);
//   3. gathers dx for each owned element over the windows that cover
//      it, adding the shares in the reference's order (offset di outer,
//      dj inner), and writes it with 16-byte stores.
// A thread keeps one 16-byte vector of channels for its whole sweep and
// steps over pixels, so the loops carry no division.  Operands whose
// channel rows are not 16-byte multiples, or bases off 16 bytes, take
// the same kernel with one channel per thread (chosen once per launch).
// No atomics: the result does not depend on scheduling.  The TPU
// kernel's 0/1 selection matmuls existed because strided gathers lower
// poorly on the TPU; here a thread computes its taps directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kAlign = 128;  // shared-memory regions start on 128 B

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
  int bp, bq;  // output rows and columns per band
  int slab;    // channels per CTA (a multiple of 16 bytes on the vector path)
  int vec;     // 1: 16-byte vectors of channels; 0: one channel a thread
};

// Derived on the host, once per launch: band counts and where each
// region of shared memory starts.
struct Layout {
  int nbh, nbw, ns;  // bands along rows, along columns; channel slabs
  unsigned off_y, off_share, off_rows, off_cols, bytes;
};

// Band b (of nb, `per` outputs each) along one dimension: `len` inputs,
// `olen` outputs, window k, stride s.  Mirrors ops/pool.py `pool_band`.
struct Span {
  int w0, w1;  // windows staged: the halo and the band's own
  int o0, o1;  // inputs owned (dx written)
  int x0, x1;  // inputs staged: every tap of windows [w0, w1)
};

__host__ __device__ __forceinline__ Span span(int b, int per, int nb, int len,
                                              int olen, int k, int s) {
  const int p0 = b * per, p1 = p0 + per < olen ? p0 + per : olen;
  const int w0 = p0 - (k - 1) / s;
  Span r;
  r.w0 = w0 > 0 ? w0 : 0;
  r.w1 = p1;
  r.o0 = p0 * s;
  r.o1 = b == nb - 1 ? len : p1 * s;
  r.x0 = r.w0 * s;
  r.x1 = (p1 - 1) * s + k;
  return r;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// V channels from global src to shared dst: a 16-byte cp.async on the
// vector path, a plain copy of one element otherwise.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (V == 1) {
    *dst = *src;
  } else {
    cp_async16(dst, src);
  }
}

// A sweep over the pixels of a rows x cols region (row-major) in which
// the thread keeps one vector of channels: it visits pixels first,
// first + step, ... and tracks (row, col) without dividing.
struct Sweep {
  int k, r, c, dr, dc, cols, total;
  __device__ Sweep(int first, int step, int rows, int cols_)
      : k(first), r(first / cols_), c(first % cols_), dr(step / cols_),
        dc(step % cols_), cols(cols_), total(rows * cols_) {}
  __device__ bool more() const { return k < total; }
  __device__ void next(int step) {
    k += step;
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

template <typename T, int V>
__device__ void pool_bwd_cta(const T* __restrict__ x, const T* __restrict__ y,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             const Geom& g, const Layout& L,
                             unsigned char* smem) {
  using P = Pack<T, V>;
  // the CTA's slab, spatial band and image
  unsigned b = blockIdx.x;
  const int slab0 = static_cast<int>(b % L.ns) * g.slab;
  b /= L.ns;
  const int band = static_cast<int>(b % (L.nbh * L.nbw));
  const unsigned nn = b / (L.nbh * L.nbw);
  const Span R = span(band / L.nbw, g.bp, L.nbh, g.h, g.oh, g.kh, g.sh);
  const Span C = span(band % L.nbw, g.bq, L.nbw, g.w, g.ow, g.kw, g.sw);
  const int wr = R.w1 - R.w0, wc = C.w1 - C.w0;  // staged windows
  const int xr = R.x1 - R.x0, xc = C.x1 - C.x0;  // staged inputs
  const int orow = R.o1 - R.o0, ocol = C.o1 - C.o0;
  T* xs = reinterpret_cast<T*>(smem);                         // [xr][xc][slab]
  T* ys = reinterpret_cast<T*>(smem + L.off_y);               // [wr][wc][slab]
  float* shares = reinterpret_cast<float*>(smem + L.off_share);  // as ys
  int* rows = reinterpret_cast<int*>(smem + L.off_rows);  // [orow][kh]
  int* cols = reinterpret_cast<int*>(smem + L.off_cols);  // [ocol][kw]

  // thread -> (vector v of the slab, first pixel); `step` pixels a sweep
  const int nv = (g.c - slab0 < g.slab ? g.c - slab0 : g.slab) / V;
  const int step = kThreads / nv;
  const int tid = static_cast<int>(threadIdx.x);
  const bool active = tid < step * nv;
  const int v = tid % nv, first = tid / nv, cv = slab0 + V * v;

  // 1. stage x and y; tabulate the window each tap offset of an owned
  //    row (column) hits, as an index into the staged windows or -1
  if (active) {
    for (Sweep s(first, step, xr, xc); s.more(); s.next(step)) {
      const unsigned src =
          ((nn * g.h + R.x0 + s.r) * g.w + C.x0 + s.c) * g.c + cv;
      stage<T, V>(xs + (s.r * xc + s.c) * g.slab + V * v, x + src);
    }
    for (Sweep s(first, step, wr, wc); s.more(); s.next(step)) {
      const unsigned src =
          ((nn * g.oh + R.w0 + s.r) * g.ow + C.w0 + s.c) * g.c + cv;
      stage<T, V>(ys + (s.r * wc + s.c) * g.slab + V * v, y + src);
    }
  }
  for (int e = tid; e < orow * g.kh; e += kThreads) {
    const int di = e % g.kh, t = R.o0 + e / g.kh - di;
    const int p = t / g.sh;
    rows[e] = t >= 0 && p * g.sh == t && p >= R.w0 && p < R.w1 ? p - R.w0
                                                                 : -1;
  }
  for (int e = tid; e < ocol * g.kw; e += kThreads) {
    const int dj = e % g.kw, t = C.o0 + e / g.kw - dj;
    const int q = t / g.sw;
    cols[e] = t >= 0 && q * g.sw == t && q >= C.w0 && q < C.w1 ? q - C.w0
                                                                 : -1;
  }
  if constexpr (V > 1) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 2. each staged window's share dy / cnt, fp32, in shared memory
  if (active) {
    for (Sweep s(first, step, wr, wc); s.more(); s.next(step)) {
      const int w = (s.r * wc + s.c) * g.slab + V * v;
      const P ym = *reinterpret_cast<const P*>(ys + w);
      const P dv = *reinterpret_cast<const P*>(
          dy + ((nn * g.oh + R.w0 + s.r) * g.ow + C.w0 + s.c) * g.c + cv);
      float m[V];
      int cnt[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        m[u] = to_float(ym.e[u]);
        cnt[u] = 0;
      }
      const T* tap = xs + (s.r * g.sh * xc + s.c * g.sw) * g.slab + V * v;
      for (int di = 0; di < g.kh; ++di) {
        for (int dj = 0; dj < g.kw; ++dj) {
          const P xv = *reinterpret_cast<const P*>(
              tap + (di * xc + dj) * g.slab);
#pragma unroll
          for (int u = 0; u < V; ++u) cnt[u] += to_float(xv.e[u]) == m[u];
        }
      }
      // every window holds its own max, so cnt >= 1 unless y is not the
      // max-pool of x (then the share is inf/nan, as in the reference)
#pragma unroll
      for (int u = 0; u < V; ++u) {
        shares[w + u] = to_float(dv.e[u]) / static_cast<float>(cnt[u]);
      }
    }
  }
  __syncthreads();

  // 3. dx of every owned element: the shares of the windows whose max it
  //    ties, di outer, dj inner; zeros where no window reaches
  if (!active) return;
  for (Sweep s(first, step, orow, ocol); s.more(); s.next(step)) {
    const int i = R.o0 + s.r, j = C.o0 + s.c;
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    if (i < R.x1 && j < C.x1) {
      const P xv = *reinterpret_cast<const P*>(
          xs + ((i - R.x0) * xc + j - C.x0) * g.slab + V * v);
      float xf[V];
#pragma unroll
      for (int u = 0; u < V; ++u) xf[u] = to_float(xv.e[u]);
      for (int di = 0; di < g.kh; ++di) {
        const int pr = rows[s.r * g.kh + di];
        if (pr < 0) continue;
        for (int dj = 0; dj < g.kw; ++dj) {
          const int pc = cols[s.c * g.kw + dj];
          if (pc < 0) continue;
          const int w = (pr * wc + pc) * g.slab + V * v;
          const P ym = *reinterpret_cast<const P*>(ys + w);
#pragma unroll
          for (int u = 0; u < V; ++u) {
            if (xf[u] == to_float(ym.e[u])) acc[u] += shares[w + u];
          }
        }
      }
    }
    P out;
#pragma unroll
    for (int u = 0; u < V; ++u) out.e[u] = from_float<T>(acc[u]);
    *reinterpret_cast<P*>(dx + ((nn * g.h + i) * g.w + j) * g.c + cv) = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ dy, T* __restrict__ dx, Geom g,
                       Layout L) {
  extern __shared__ __align__(kAlign) unsigned char smem[];
  if (g.vec) {
    pool_bwd_cta<T, 16 / sizeof(T)>(x, y, dy, dx, g, L, smem);
  } else {
    pool_bwd_cta<T, 1>(x, y, dy, dx, g, L, smem);
  }
}

// Index arithmetic is 32-bit (64-bit division is emulated and costs
// tens of instructions): x may hold at most kMaxElems elements.
constexpr long kMaxElems = 0x7fffffffL;

size_t align_up(size_t bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

// Shared memory of the largest band: closed-form caps of the staged
// windows and inputs and the owned inputs along each dimension.
// Mirrors ops/pool.py `pool_smem_bytes`.
size_t layout(const Geom& g, size_t es, Layout* L) {
  L->nbh = (g.oh + g.bp - 1) / g.bp;
  L->nbw = (g.ow + g.bq - 1) / g.bq;
  L->ns = (g.c + g.slab - 1) / g.slab;
  const size_t win_r = std::min(g.bp + (g.kh - 1) / g.sh, g.oh);
  const size_t win_c = std::min(g.bq + (g.kw - 1) / g.sw, g.ow);
  const size_t x_r = std::min<size_t>((win_r - 1) * g.sh + g.kh, g.h);
  const size_t x_c = std::min<size_t>((win_c - 1) * g.sw + g.kw, g.w);
  const size_t own_r = std::min<size_t>(
      std::max(g.bp * g.sh, g.h - (L->nbh - 1) * g.bp * g.sh), g.h);
  const size_t own_c = std::min<size_t>(
      std::max(g.bq * g.sw, g.w - (L->nbw - 1) * g.bq * g.sw), g.w);
  size_t at = align_up(x_r * x_c * g.slab * es);
  L->off_y = static_cast<unsigned>(at);
  at += align_up(win_r * win_c * g.slab * es);
  L->off_share = static_cast<unsigned>(at);
  at += align_up(win_r * win_c * g.slab * sizeof(float));
  L->off_rows = static_cast<unsigned>(at);
  at += align_up(own_r * g.kh * sizeof(int));
  L->off_cols = static_cast<unsigned>(at);
  at += own_c * g.kw * sizeof(int);
  L->bytes = static_cast<unsigned>(at);
  return at;
}

int max_smem() {
  static const int bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  }();
  return bytes;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x, const void* y, const void* dy, void* dx, Geom g,
           cudaStream_t stream) {
  const int per_vec = 16 / static_cast<int>(sizeof(T));
  if (g.n < 0 || g.h < 1 || g.w < 1 || g.c < 1 || g.kh < 1 || g.kw < 1 ||
      g.sh < 1 || g.sw < 1 || g.oh != (g.h - g.kh) / g.sh + 1 ||
      g.ow != (g.w - g.kw) / g.sw + 1 || g.oh < 1 || g.ow < 1 ||
      g.bp < 1 || g.bp > g.oh || g.bq < 1 || g.bq > g.ow || g.slab < 1 ||
      g.slab > g.c || g.slab > kThreads * per_vec ||
      (!g.vec && g.slab > kThreads) ||
      (g.vec && ((g.c % per_vec) || (g.slab % per_vec) || !aligned16(x) ||
                 !aligned16(y) || !aligned16(dy) || !aligned16(dx)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n_in = static_cast<long>(g.n) * g.h * g.w * g.c;
  if (n_in > kMaxElems) return static_cast<int>(cudaErrorInvalidValue);
  if (g.n == 0) return 0;
  Layout L;
  const size_t bytes = layout(g, sizeof(T), &L);
  const long ctas = static_cast<long>(g.n) * L.nbh * L.nbw * L.ns;
  if (bytes > static_cast<size_t>(max_smem()) || ctas > 0x7fffffffL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t opt = cudaFuncSetAttribute(
      maxpool_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem());
  if (opt) return static_cast<int>(opt);
  maxpool_bwd_kernel<T><<<static_cast<unsigned>(ctas), kThreads, bytes,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), static_cast<T*>(dx), g, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  (bp, bq, slab, vec) is the plan of
// ops/pool.py `plan_maxpool_bwd`.  Returns cudaGetLastError() after the
// launch (0 = launched); the caller raises on anything else.
extern "C" {

long maxpool_bwd_max_elements() { return kMaxElems; }

int maxpool_bwd_f32(const void* x, const void* y, const void* dy, void* dx,
                    int n, int h, int w, int c, int oh, int ow, int kh, int kw,
                    int sh, int sw, int bp, int bq, int slab, int vec,
                    void* stream) {
  return launch<float>(
      x, y, dy, dx, Geom{n, h, w, c, oh, ow, kh, kw, sh, sw, bp, bq, slab, vec},
      static_cast<cudaStream_t>(stream));
}

int maxpool_bwd_bf16(const void* x, const void* y, const void* dy, void* dx,
                     int n, int h, int w, int c, int oh, int ow, int kh,
                     int kw, int sh, int sw, int bp, int bq, int slab,
                     int vec, void* stream) {
  return launch<__nv_bfloat16>(
      x, y, dy, dx, Geom{n, h, w, c, oh, ow, kh, kw, sh, sw, bp, bq, slab, vec},
      static_cast<cudaStream_t>(stream));
}

const char* maxpool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
