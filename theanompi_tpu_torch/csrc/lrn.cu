// Cross-channel local response normalization, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels theanompi_tpu/ops/pallas_lrn.py `_fwd_kernel`
// and `_bwd_kernel` (called through the `lrn` custom_vjp and
// `_rowblock_call`).  An NHWC activation is viewed as (M, C) rows, the
// window runs along C: W(c) = {j : j - c in [-lo, hi]}, lo = size / 2,
// hi = size - 1 - lo.
//
//   forward:  D_c = k + alpha * sum_{j in W(c)} x_j^2
//             y_c = x_c * D_c^-beta
//   backward: u_c  = dy_c * x_c * D_c^(-beta-1)
//             dx_i = dy_i * D_i^-beta
//                    - 2 alpha beta * x_i * sum_{c : i in W(c)} u_c
//
// D is recomputed from x in the backward, as the TPU kernel does: only x
// is kept between the passes.  The reverse window {c : i in W(c)} =
// [i - hi, i + lo] equals W(i) only for odd sizes.  Every window is
// summed in increasing channel order from 0, the plain version's order.
//
// What bounds it on this card: memory.  Per element the forward does
// about size + 10 operations on 2 + 2 bytes (bf16) or 4 + 4 (fp32), far
// below the ~20 fp32 operations per byte at which the H100's ALUs become
// the limit.  The least time is the bytes of x and y (forward) or x, dy
// and dx (backward) over 3.35 TB/s.
//
// The design (ops/lrn.py `plan_lrn` plans every launch on the host; the
// launch recomputes the plan's shared memory and refuses a mismatch):
//
// - A persistent grid.  `ctas` CTAs walk the tiles t = blockIdx.x,
//   blockIdx.x + gridDim.x, ...; a tile is `rows` whole rows, contiguous
//   in memory.  Each tile of x (and of dy) is staged into shared memory
//   by one 1-D bulk copy (cp.async.bulk, completing on the stage's
//   mbarrier) in a ring of `stages` stages.  A CTA issues its first
//   `stages` tiles at its start and refills a stage as soon as every
//   thread is done with it, so the next stages - 1 tiles are in flight
//   during a tile's math.  A copy covers the 16-byte-aligned span around
//   the tile's bytes: it never leaves the 16-byte chunks that hold the
//   tensor's bytes, so any base address and any C can be staged; the
//   tile starts `stage_off` bytes into its stage.
// - One thread per run of channels.  The CTA is tx x ty threads; thread
//   (i, j) owns runs i, i + tx, ... of rows j, j + ty, ... of every
//   tile: fixed slots, so no element pays an integer division.  A run is
//   kVec channels: 8 bf16 or 4 fp32 (16 bytes: one shared load and one
//   store of y) where C * itemsize % 16 == 0 and every operand starts on
//   16 bytes; else 1 channel.
// - Windows of at most kWin = 5 channels (sizes 1..5) are summed in
//   registers from the run and a halo of kHalo = 2 channels each side,
//   read once from the stage; a predicate per offset, the same for every
//   element, picks the window.  Larger sizes sum a loop over the stage.
// - D is computed once.  D^-beta = exp2(-beta * log2 D): one lg2 and one
//   ex2 (MUFU, approximate, relative error ~2^-22).  The backward takes
//   D^(-beta-1) = exp2((-beta-1) * log2 D) from the same log2.
// - The backward makes one pass over the staged x and dy.  Phase A
//   writes u of its runs into an fp32 u-tile in shared memory and keeps
//   D^-beta in registers (kItemFloats a thread; the plan bounds a
//   thread's runs a tile by it); a barrier; phase B sums the reverse
//   window of u and writes dx.  x and dy are read from device memory once
//   each, y and dx written once; no (M, C) intermediate leaves the SM.
//
// The TPU kernel's 0/1 band matmul existed because lane shifts are slow
// on the TPU; here each thread sums its neighbours directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxStages = 8;
constexpr int kHeader = 128;         // the stages' mbarriers
constexpr int kWin = 5;              // register windows: sizes 1..kWin
constexpr int kHalo = kWin / 2;      // channels staged each side of a run
constexpr int kItemFloats = 16;      // backward: D^-beta floats a thread keeps
constexpr size_t kSmemMax = 232448;  // 227 KB, an H100 block's most

__host__ __device__ constexpr size_t round_up(size_t n, size_t a) {
  return (n + a - 1) / a * a;
}

// A stage's room for one array of n bytes: the 16-byte-aligned span
// around them (at most round_up(n, 16) + 16 bytes), on 128 bytes.
__host__ __device__ constexpr size_t slot_bytes(size_t n) {
  return round_up(round_up(n, 16) + 16, 128);
}

// Shared memory of a CTA: the mbarriers, the ring (x, or x and dy, a
// stage) and, in the backward, the fp32 u-tile.  Mirrors ops/lrn.py
// `lrn_smem_bytes`.
__host__ __device__ constexpr size_t smem_bytes(int rows, int c,
                                                int itemsize, int stages,
                                                bool bwd) {
  return kHeader +
         static_cast<size_t>(stages) * (bwd ? 2 : 1) *
             slot_bytes(static_cast<size_t>(rows) * c * itemsize) +
         (bwd ? static_cast<size_t>(rows) * c * 4 : 0);
}

// The most channels whose one-row tile fits in two stages of every pass
// and dtype (the fp32 backward needs the most).
int max_channels() {
  int lo = 1, hi = 1 << 20;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (smem_bytes(1, mid, 4, 2, true) <= kSmemMax) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

struct Window {
  int lo, hi;  // the forward window of channel c is [c - lo, c + hi]
  float alpha, beta, k;
};

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (as csrc/paged_decode_attention.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both on
// 16 bytes), completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The 16-byte-aligned span around `n` bytes at `p`: its start and length.
struct Span {
  const unsigned char* start;
  uint32_t bytes;
};

__device__ __forceinline__ Span span_of(const void* p, size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t s = a & ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const unsigned char*>(s),
          static_cast<uint32_t>(round_up(a + n, 16) - s)};
}

// where the bytes at p begin in their staged span
__device__ __forceinline__ uint32_t stage_off(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 15);
}

// ---------------------------------------------------------------------------
// Elements
// ---------------------------------------------------------------------------

__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kVec consecutive elements at p as floats: one scalar load, or 16-byte
// loads (p on 16 bytes)
template <typename E, int kVec>
__device__ __forceinline__ void ld_run(const E* p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = to_float(p[0]);
  } else {
    constexpr int kPer = 16 / sizeof(E);  // elements a 16-byte load
#pragma unroll
    for (int q = 0; q < kVec / kPer; ++q) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(E) == 4) {
          v[4 * q + i] = __uint_as_float(w[i]);
        } else {  // bf16: element 2i in the low half of word i
          v[8 * q + 2 * i] = __uint_as_float(w[i] << 16);
          v[8 * q + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    }
  }
}

// store kVec floats at p as E (bf16 rounded to nearest even, as torch's
// .to()): one scalar store, or 16-byte stores
template <typename E, int kVec>
__device__ __forceinline__ void st_run(E* p, const float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    if constexpr (sizeof(E) == 4) {
      p[0] = v[0];
    } else {
      p[0] = __float2bfloat16(v[0]);
    }
  } else if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// channels ch0 - kHalo .. ch0 + kVec - 1 + kHalo of a row as floats,
// 0 outside [0, c); the run itself is e[kHalo .. kHalo + kVec)
template <typename E, int kVec>
__device__ __forceinline__ void ld_ext(const E* row, int ch0, int c,
                                       float (&e)[kVec + 2 * kHalo]) {
  float run[kVec];
  ld_run<E, kVec>(row + ch0, run);
#pragma unroll
  for (int h = 0; h < kHalo; ++h) {
    const int l = ch0 - kHalo + h;
    const int r = ch0 + kVec + h;
    e[h] = l >= 0 ? to_float(row[l]) : 0.f;
    e[kHalo + kVec + h] = r < c ? to_float(row[r]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[kHalo + j] = run[j];
}

// out[j] = sum of e over the offsets [-before, after] around run element
// j, in increasing offset order from 0 (before, after <= kHalo)
template <int kVec>
__device__ __forceinline__ void win_sum(const float (&e)[kVec + 2 * kHalo],
                                        int before, int after,
                                        float (&out)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int o = -kHalo; o <= kHalo; ++o) {
      if (o >= -before && o <= after) acc += e[kHalo + j + o];
    }
    out[j] = acc;
  }
}

// the same for any window, by a loop over the row (kW = 0); `square`
// sums squares
template <typename E, int kVec, bool kSquare>
__device__ __forceinline__ void win_sum_loop(const E* row, int ch0, int c,
                                             int before, int after,
                                             float (&out)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int ch = ch0 + j;
    const int a = max(0, ch - before), b = min(c - 1, ch + after);
    float acc = 0.f;
    for (int i = a; i <= b; ++i) {
      const float v = to_float(row[i]);
      acc += kSquare ? v * v : v;
    }
    out[j] = acc;
  }
}

// x of a run (xr) and the forward window sums of x^2 (d) from a staged row
template <typename T, int kVec, int kW>
__device__ __forceinline__ void window_of_x(const T* row, int ch0, int c,
                                            const Window& w,
                                            float (&xr)[kVec],
                                            float (&d)[kVec]) {
  if constexpr (kW > 0) {
    float e[kVec + 2 * kHalo];
    ld_ext<T, kVec>(row, ch0, c, e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) xr[j] = e[kHalo + j];
#pragma unroll
    for (int i = 0; i < kVec + 2 * kHalo; ++i) e[i] *= e[i];
    win_sum<kVec>(e, w.lo, w.hi, d);
  } else {
    ld_run<T, kVec>(row + ch0, xr);
    win_sum_loop<T, kVec, true>(row, ch0, c, w.lo, w.hi, d);
  }
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

// Issue tile `i` of this CTA (stage i % stages) for the arrays `src`,
// staged one after the other in the stage.
template <typename T, int kArrays>
__device__ __forceinline__ void issue_tile(const T* const (&src)[kArrays],
                                           long i, long m, int c, int rows,
                                           int stages, size_t slot,
                                           unsigned char* ring,
                                           uint64_t* full) {
  const int s = static_cast<int>(i % stages);
  const long row0 = (blockIdx.x + i * gridDim.x) * static_cast<long>(rows);
  const size_t n =
      static_cast<size_t>(min(static_cast<long>(rows), m - row0)) * c *
      sizeof(T);
  Span sp[kArrays];
  uint32_t total = 0;
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    sp[a] = span_of(src[a] + row0 * c, n);
    total += sp[a].bytes;
  }
  const uint32_t bar = smem_u32(&full[s]);
  mbar_expect_tx(bar, total);
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    bulk_load(smem_u32(ring + (static_cast<size_t>(s) * kArrays + a) * slot),
              sp[a].start, sp[a].bytes, bar);
  }
}

// The prologue of both kernels: the mbarriers, and the first tiles.
template <typename T, int kArrays>
__device__ __forceinline__ long start_ring(const T* const (&src)[kArrays],
                                           long m, int c, int rows,
                                           int stages, size_t slot,
                                           unsigned char* ring,
                                           uint64_t* full) {
  const long tiles = (m + rows - 1) / rows;
  const long mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long i = 0; i < min(static_cast<long>(stages), mine); ++i) {
      issue_tile<T, kArrays>(src, i, m, c, rows, stages, slot, ring, full);
    }
  }
  __syncthreads();
  return mine;
}

template <typename T, int kVec, int kW>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_fwd_staged(const T* __restrict__ x, T* __restrict__ y, long m, int c,
                   int rows, int stages, Window w) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHeader;
  const size_t slot = slot_bytes(static_cast<size_t>(rows) * c * sizeof(T));
  const T* const src[1] = {x};
  const long mine = start_ring<T, 1>(src, m, c, rows, stages, slot, ring,
                                     full);
  const int units = (c + kVec - 1) / kVec;
  for (long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % stages);
    const long row0 = (blockIdx.x + i * gridDim.x) * static_cast<long>(rows);
    const int n = static_cast<int>(min(static_cast<long>(rows), m - row0));
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((i / stages) & 1));
    const T* tile = reinterpret_cast<const T*>(
        ring + static_cast<size_t>(s) * slot + stage_off(x + row0 * c));
    T* out = y + row0 * c;
    for (int a = threadIdx.y; a < n; a += blockDim.y) {
      const T* row = tile + a * c;
      for (int run = threadIdx.x; run < units; run += blockDim.x) {
        const int ch0 = run * kVec;
        float xr[kVec], d[kVec], yr[kVec];
        window_of_x<T, kVec, kW>(row, ch0, c, w, xr, d);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          yr[j] = xr[j] * ex2(-w.beta * lg2(w.k + w.alpha * d[j]));
        }
        st_run<T, kVec>(out + a * c + ch0, yr);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && threadIdx.y == 0 && i + stages < mine) {
      issue_tile<T, 1>(src, i + stages, m, c, rows, stages, slot, ring,
                       full);
    }
  }
}

template <typename T, int kVec, int kW>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_bwd_staged(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, long m, int c, int rows, int stages,
                   Window w) {
  constexpr int kItems = kItemFloats / kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHeader;
  const size_t slot = slot_bytes(static_cast<size_t>(rows) * c * sizeof(T));
  float* u = reinterpret_cast<float*>(ring + 2 * stages * slot);
  const T* const src[2] = {x, dy};
  const long mine = start_ring<T, 2>(src, m, c, rows, stages, slot, ring,
                                     full);
  const int units = (c + kVec - 1) / kVec;
  const int nb = (units + blockDim.x - 1) / blockDim.x;  // runs a row
  const float two_ab = 2.f * w.alpha * w.beta;
  for (long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % stages);
    const long row0 = (blockIdx.x + i * gridDim.x) * static_cast<long>(rows);
    const int n = static_cast<int>(min(static_cast<long>(rows), m - row0));
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((i / stages) & 1));
    const T* xt = reinterpret_cast<const T*>(
        ring + static_cast<size_t>(2 * s) * slot + stage_off(x + row0 * c));
    const T* gt = reinterpret_cast<const T*>(
        ring + static_cast<size_t>(2 * s + 1) * slot +
        stage_off(dy + row0 * c));
    // a thread's items: runs threadIdx.x + b * blockDim.x (b < nb) of
    // rows threadIdx.y + a' * blockDim.y, at most kItems a tile (plan)
    float keep[kItems][kVec];  // D^-beta
    {
      int a = threadIdx.y, b = 0;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int run = threadIdx.x + b * blockDim.x;
        if (a < n && run < units) {
          const int ch0 = run * kVec;
          float xr[kVec], d[kVec], g[kVec], ur[kVec];
          window_of_x<T, kVec, kW>(xt + a * c, ch0, c, w, xr, d);
          ld_run<T, kVec>(gt + a * c + ch0, g);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float l = lg2(w.k + w.alpha * d[j]);
            keep[it][j] = ex2(-w.beta * l);
            ur[j] = g[j] * xr[j] * ex2((-w.beta - 1.f) * l);
          }
          st_run<float, kVec>(u + a * c + ch0, ur);
        }
        if (++b == nb) {
          b = 0;
          a += blockDim.y;
        }
      }
    }
    __syncthreads();  // the u-tile is whole
    {
      T* out = dx + row0 * c;
      int a = threadIdx.y, b = 0;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int run = threadIdx.x + b * blockDim.x;
        if (a < n && run < units) {
          const int ch0 = run * kVec;
          float rs[kVec], xr[kVec], g[kVec], dr[kVec];
          // reverse window [ch - hi, ch + lo]
          if constexpr (kW > 0) {
            float e[kVec + 2 * kHalo];
            ld_ext<float, kVec>(u + a * c, ch0, c, e);
            win_sum<kVec>(e, w.hi, w.lo, rs);
          } else {
            win_sum_loop<float, kVec, false>(u + a * c, ch0, c, w.hi, w.lo,
                                             rs);
          }
          ld_run<T, kVec>(xt + a * c + ch0, xr);
          ld_run<T, kVec>(gt + a * c + ch0, g);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            dr[j] = g[j] * keep[it][j] - two_ab * xr[j] * rs[j];
          }
          st_run<T, kVec>(out + a * c + ch0, dr);
        }
        if (++b == nb) {
          b = 0;
          a += blockDim.y;
        }
      }
    }
    __syncthreads();  // stage s and the u-tile are free
    if (threadIdx.x == 0 && threadIdx.y == 0 && i + stages < mine) {
      issue_tile<T, 2>(src, i + stages, m, c, rows, stages, slot, ring,
                       full);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

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
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The plan of ops/lrn.py `plan_lrn`.
struct Plan {
  int vec, tx, ty, rows, stages, smem, ctas;
};

// Opt every instance into the card's shared memory, once.
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
  *done = rc == cudaSuccess;
  return rc;
}

template <typename T, int kVec, int kW, bool kBwd>
int launch_instance(const void* const* ptrs, long m, int c, const Plan& p,
                    const Window& w, cudaStream_t stream) {
  static bool done = false;
  const dim3 block(p.tx, p.ty);
  if constexpr (kBwd) {
    auto kernel = lrn_bwd_staged<T, kVec, kW>;
    if (cudaError_t rc = allow_smem(kernel, &done)) return static_cast<int>(rc);
    kernel<<<p.ctas, block, p.smem, stream>>>(
        static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
        static_cast<T*>(const_cast<void*>(ptrs[2])), m, c, p.rows, p.stages,
        w);
  } else {
    auto kernel = lrn_fwd_staged<T, kVec, kW>;
    if (cudaError_t rc = allow_smem(kernel, &done)) return static_cast<int>(rc);
    kernel<<<p.ctas, block, p.smem, stream>>>(
        static_cast<const T*>(ptrs[0]),
        static_cast<T*>(const_cast<void*>(ptrs[1])), m, c, p.rows, p.stages,
        w);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBwd>
int launch(const void* const* ptrs, int n_ptrs, long m, int c, int size,
           float alpha, float beta, float k, const Plan& p,
           cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m < 0 || c < 1 || c > max_channels() || size < 1) return bad;
  if (m == 0) return 0;
  if (p.vec != 1 && p.vec != kV) return bad;
  if (p.vec == kV) {
    if (c % kV) return bad;
    for (int i = 0; i < n_ptrs; ++i) {
      if (!aligned16(ptrs[i])) return bad;
    }
  }
  const int units = (c + p.vec - 1) / p.vec;
  const long tiles = p.rows > 0 ? (m + p.rows - 1) / p.rows : 0;
  if (p.tx < 1 || p.ty < 1 || p.tx * p.ty > kMaxThreads || p.rows < p.ty ||
      p.rows % p.ty || p.stages < 2 || p.stages > kMaxStages || p.ctas < 1 ||
      p.ctas > tiles) {
    return bad;
  }
  if (kBwd && (p.rows / p.ty) * ((units + p.tx - 1) / p.tx) >
                  kItemFloats / p.vec) {
    return bad;  // more runs a thread than it keeps D^-beta of
  }
  const size_t bytes = smem_bytes(p.rows, c, sizeof(T), p.stages, kBwd);
  if (bytes != static_cast<size_t>(p.smem) ||
      bytes > static_cast<size_t>(max_smem())) {
    return bad;
  }
  const Window w{size / 2, size - 1 - size / 2, alpha, beta, k};
  if (size <= kWin) {
    return p.vec == kV
               ? launch_instance<T, kV, kWin, kBwd>(ptrs, m, c, p, w, stream)
               : launch_instance<T, 1, kWin, kBwd>(ptrs, m, c, p, w, stream);
  }
  return p.vec == kV
             ? launch_instance<T, kV, 0, kBwd>(ptrs, m, c, p, w, stream)
             : launch_instance<T, 1, 0, kBwd>(ptrs, m, c, p, w, stream);
}

}  // namespace

// Plain C interface for ctypes.  (vec, tx, ty, rows, stages, smem, ctas)
// is the plan of ops/lrn.py `plan_lrn`.  Each returns cudaGetLastError()
// after the launch (0 = launched); the caller raises on anything else.
extern "C" {

int lrn_max_channels() { return max_channels(); }

int lrn_fwd_f32(const void* x, void* y, long m, int c, int size, float alpha,
                float beta, float k, int vec, int tx, int ty, int rows,
                int stages, int smem, int ctas, void* stream) {
  const void* ptrs[2] = {x, y};
  const Plan p{vec, tx, ty, rows, stages, smem, ctas};
  return launch<float, false>(ptrs, 2, m, c, size, alpha, beta, k, p,
                              static_cast<cudaStream_t>(stream));
}

int lrn_fwd_bf16(const void* x, void* y, long m, int c, int size,
                 float alpha, float beta, float k, int vec, int tx, int ty,
                 int rows, int stages, int smem, int ctas, void* stream) {
  const void* ptrs[2] = {x, y};
  const Plan p{vec, tx, ty, rows, stages, smem, ctas};
  return launch<__nv_bfloat16, false>(ptrs, 2, m, c, size, alpha, beta, k, p,
                                      static_cast<cudaStream_t>(stream));
}

int lrn_bwd_f32(const void* x, const void* dy, void* dx, long m, int c,
                int size, float alpha, float beta, float k, int vec, int tx,
                int ty, int rows, int stages, int smem, int ctas,
                void* stream) {
  const void* ptrs[3] = {x, dy, dx};
  const Plan p{vec, tx, ty, rows, stages, smem, ctas};
  return launch<float, true>(ptrs, 3, m, c, size, alpha, beta, k, p,
                             static_cast<cudaStream_t>(stream));
}

int lrn_bwd_bf16(const void* x, const void* dy, void* dx, long m, int c,
                 int size, float alpha, float beta, float k, int vec, int tx,
                 int ty, int rows, int stages, int smem, int ctas,
                 void* stream) {
  const void* ptrs[3] = {x, dy, dx};
  const Plan p{vec, tx, ty, rows, stages, smem, ctas};
  return launch<__nv_bfloat16, true>(ptrs, 3, m, c, size, alpha, beta, k, p,
                                     static_cast<cudaStream_t>(stream));
}

const char* lrn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
