// Block quantization of the gradient wire, for Hopper (sm_90a):
// int8 round-to-nearest, int8 stochastic rounding, fp16 with a block
// scale, and the dequantization of an int8 or fp16 payload.
//
// Replaces the TPU kernels of theanompi_tpu/parallel/quantize.py:
// `_quant_kernel`, `_quant_sr_kernel`, `_quant_fp16_kernel` and
// `_dequant_kernel` (all through `_run_quant_kernel` and
// `pallas_dequantize_blocks`).  The input is (rows, 256) fp32, one
// quantization block per row, any number of rows:
//
//   s    = amax(|x_row|) / cap          (cap 127 for int8, 256 for fp16)
//   safe = s > 0 ? s : 1
//   int8 RN: q = rint(x / safe)                         (half to even)
//   int8 SR: q = clamp(floor(x / safe + u), -127, 127)
//            u = hash(idx * 0x9E3779B9 + seed), top 24 bits / 2^24
//   fp16:    q = __float2half_rn(x / safe)
//   dequant: out = float(q) * s
//
// idx is the element's index in the call's flattened input (uint32,
// wrapping), as the Pallas kernel computes it from its grid step, row
// and lane; the hash is the reference's `_hash_uniform` bit for bit, so
// the same seed word gives the same payload.  Both divisions are IEEE
// divisions: this file is built without -use_fast_math, so `/` on
// floats is correctly rounded and the scale equals the XLA path's
// `amax / 127` (the Pallas kernel under interpret mode multiplies by
// fp32(1/127) and can land one ulp away).
//
// What bounds it on this card: memory.  A quantize reads 4 bytes and
// writes 1 (int8) or 2 (fp16) per element plus 4 per 256-element row;
// a dequantize reads 1 or 2 and writes 4.  The SR hash costs about 12
// integer operations per element, far below the ~40 operations per
// byte the ALUs could hide behind 3.35 TB/s.  The least time is those
// bytes over 3.35 TB/s.  What the design does about it: one warp per
// row; each lane loads two float4 (elements 4l..4l+3 and 128+4l..
// 128+4l+3), so a warp's loads and stores cover its row in whole
// 128-byte segments; the amax is a __shfl_xor_sync butterfly in
// registers; nothing but the payload and the scales is written.  The
// TPU kernel's 32-row tiles follow the TPU's (32, 128) int8 tiling and
// have no meaning here: any row count is taken.
//
// Design (simple first): 8 warps (8 rows) per CTA of 256 threads, no
// shared memory.  Later work: several rows per warp to keep more loads
// in flight.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float hash_uniform(uint32_t counter) {
  // top 24 bits: an integer below 2^24, exact in fp32
  return static_cast<float>(hash_bits(counter) >> 8) * (1.0f / 16777216.0f);
}

// The row's eight elements of this lane, its scale and divide-safe scale.
struct RowSlice {
  float v[8];
  float s;
  float safe;
};

__device__ __forceinline__ RowSlice load_row(const float* __restrict__ x,
                                             long row, int lane, float cap) {
  const float4* xr = reinterpret_cast<const float4*>(x + row * kBlock);
  const float4 a = xr[lane];
  const float4 b = xr[32 + lane];
  RowSlice r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(r.v[i]));
  m = warp_max(m);
  r.s = m / cap;  // IEEE division (no fast math)
  r.safe = r.s > 0.f ? r.s : 1.f;
  return r;
}

// Element i of a lane's slice sits at column (i < 4 ? 4l + i : 128 + 4l + i - 4).
__device__ __forceinline__ int column(int lane, int i) {
  return (i < 4 ? 4 * lane + i : 128 + 4 * lane + (i - 4));
}

__device__ __forceinline__ void store_int8(int8_t* __restrict__ q, long row,
                                           int lane, const float* y) {
  char4* qr = reinterpret_cast<char4*>(q + row * kBlock);
  qr[lane] = make_char4(static_cast<signed char>(y[0]),
                        static_cast<signed char>(y[1]),
                        static_cast<signed char>(y[2]),
                        static_cast<signed char>(y[3]));
  qr[32 + lane] = make_char4(static_cast<signed char>(y[4]),
                             static_cast<signed char>(y[5]),
                             static_cast<signed char>(y[6]),
                             static_cast<signed char>(y[7]));
}

__global__ void __launch_bounds__(kThreads)
    quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ s, long rows) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const RowSlice r = load_row(x, row, lane, 127.f);
  float y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    y[i] = fminf(fmaxf(rintf(r.v[i] / r.safe), -127.f), 127.f);
  store_int8(q, row, lane, y);
  if (lane == 0) s[row] = r.s;
}

__global__ void __launch_bounds__(kThreads)
    quant_int8_sr_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, long rows, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const RowSlice r = load_row(x, row, lane, 127.f);
  // the flattened index wraps at 2^32, as the Pallas kernel's uint32 does
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(kBlock);
  float y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t idx = base + static_cast<uint32_t>(column(lane, i));
    const float u = hash_uniform(idx * 0x9E3779B9u + seed);
    const float t = r.v[i] / r.safe;
    y[i] = fminf(fmaxf(floorf(__fadd_rn(t, u)), -127.f), 127.f);
  }
  store_int8(q, row, lane, y);
  if (lane == 0) s[row] = r.s;
}

__global__ void __launch_bounds__(kThreads)
    quant_fp16_kernel(const float* __restrict__ x, __half* __restrict__ q,
                      float* __restrict__ s, long rows) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const RowSlice r = load_row(x, row, lane, 256.f);
  __half h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2half_rn(r.v[i] / r.safe);
  // 4 halves = 8 bytes per store
  uint2* qr = reinterpret_cast<uint2*>(q + row * kBlock);
  uint2 lo, hi;
  lo.x = static_cast<uint32_t>(__half_as_ushort(h[0])) |
         (static_cast<uint32_t>(__half_as_ushort(h[1])) << 16);
  lo.y = static_cast<uint32_t>(__half_as_ushort(h[2])) |
         (static_cast<uint32_t>(__half_as_ushort(h[3])) << 16);
  hi.x = static_cast<uint32_t>(__half_as_ushort(h[4])) |
         (static_cast<uint32_t>(__half_as_ushort(h[5])) << 16);
  hi.y = static_cast<uint32_t>(__half_as_ushort(h[6])) |
         (static_cast<uint32_t>(__half_as_ushort(h[7])) << 16);
  qr[lane] = lo;
  qr[32 + lane] = hi;
  if (lane == 0) s[row] = r.s;
}

__device__ __forceinline__ void store_row(float* __restrict__ out, long row,
                                          int lane, const float* v) {
  float4* o = reinterpret_cast<float4*>(out + row * kBlock);
  o[lane] = make_float4(v[0], v[1], v[2], v[3]);
  o[32 + lane] = make_float4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(kThreads)
    dequant_int8_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out,
                        long rows) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const char4* qr = reinterpret_cast<const char4*>(q + row * kBlock);
  const char4 a = qr[lane];
  const char4 b = qr[32 + lane];
  const float sc = s[row];
  const float v[8] = {a.x * sc, a.y * sc, a.z * sc, a.w * sc,
                      b.x * sc, b.y * sc, b.z * sc, b.w * sc};
  store_row(out, row, lane, v);
}

__global__ void __launch_bounds__(kThreads)
    dequant_fp16_kernel(const __half* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out,
                        long rows) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint2* qr = reinterpret_cast<const uint2*>(q + row * kBlock);
  const uint2 a = qr[lane];
  const uint2 b = qr[32 + lane];
  const uint32_t w[4] = {a.x, a.y, b.x, b.y};
  const float sc = s[row];
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __half2float(__ushort_as_half(
                   static_cast<unsigned short>(w[i] & 0xFFFFu))) * sc;
    v[2 * i + 1] = __half2float(__ushort_as_half(
                       static_cast<unsigned short>(w[i] >> 16))) * sc;
  }
  store_row(out, row, lane, v);
}

inline unsigned grid_for(long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched).
// Pointers must be 16-byte aligned (torch's allocations are); rows >= 1.

int block_quant_int8(const float* x, int8_t* q, float* s, long rows,
                     void* stream) {
  quant_int8_kernel<<<grid_for(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, q, s, rows);
  return static_cast<int>(cudaGetLastError());
}

int block_quant_int8_sr(const float* x, int8_t* q, float* s, long rows,
                        uint32_t seed, void* stream) {
  quant_int8_sr_kernel<<<grid_for(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, q, s, rows,
                                                              seed);
  return static_cast<int>(cudaGetLastError());
}

int block_quant_fp16(const float* x, __half* q, float* s, long rows,
                     void* stream) {
  quant_fp16_kernel<<<grid_for(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, q, s, rows);
  return static_cast<int>(cudaGetLastError());
}

int block_dequant_int8(const int8_t* q, const float* s, float* out, long rows,
                       void* stream) {
  dequant_int8_kernel<<<grid_for(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(q, s, out, rows);
  return static_cast<int>(cudaGetLastError());
}

int block_dequant_fp16(const __half* q, const float* s, float* out, long rows,
                       void* stream) {
  dequant_fp16_kernel<<<grid_for(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(q, s, out, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* block_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
