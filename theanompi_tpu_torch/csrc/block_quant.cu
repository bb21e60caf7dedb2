// Block quantization of the gradient wire, for Hopper (sm_90a):
// int8 round-to-nearest, int8 stochastic rounding, fp16 with a block
// scale, the dequantization of an int8 or fp16 payload (optionally
// divided by the world size and cut to the payload's length), and leg 2
// of the int8_sr wire in one launch.
//
// Replaces the TPU kernels of theanompi_tpu/parallel/quantize.py:
// `_quant_kernel`, `_quant_sr_kernel`, `_quant_fp16_kernel` and
// `_dequant_kernel` (all through `_run_quant_kernel` and
// `pallas_dequantize_blocks`), and, in `dequant_sum_quant_int8_sr_rows`,
// the reference's leg 2 of the SR wire (theanompi_tpu/parallel/
// exchanger.py `_wire_from_packed`: `_dequant_kernel`, `jnp.sum` over
// the ranks, `_quant_sr_kernel`).  The input is (rows, 256) fp32, one
// quantization block per row, any number of rows:
//
//   s    = amax(|x_row|) / cap          (cap 127 for int8, 256 for fp16)
//   safe = s > 0 ? s : 1
//   int8 RN: q = rint(x / safe)                         (half to even)
//   int8 SR: q = clamp(floor(x / safe + u), -127, 127)
//            u = hash(idx * 0x9E3779B9 + seed), top 24 bits / 2^24
//   fp16:    q = __float2half_rn(x / safe)
//   dequant: out = float(q) * s          [/ divisor, first n elements]
//   leg 2:   sum = ((q_0 s_0 + q_1 s_1) + q_2 s_2) + ...   (ranks in
//            ascending order, each product and sum rounded once), then
//            the SR quantization of the (nb, 256) sum
//
// idx is the element's index in the call's flattened input (for leg 2,
// in the (nb, 256) sum; uint32, wrapping), as the Pallas kernel
// computes it from its grid step, row and lane; the hash is the
// reference's `_hash_uniform` bit for bit, so the same seed word gives
// the same payload.  Every division is an IEEE division and every
// product and sum a single rounding (__fdiv_rn, __fmul_rn, __fadd_rn:
// no fast math, no FMA contraction), so the kernels equal the plain
// PyTorch versions bit for bit; the scale equals the XLA path's
// `amax / 127` (the Pallas kernel under interpret mode multiplies by
// fp32(1/127) and can land one ulp away).
//
// What bounds them on this card: memory.  A quantize reads 4 bytes and
// writes 1 (int8) or 2 (fp16) per element plus 4 per 256-element row;
// a dequantize reads 1 or 2 and writes 4; leg 2 reads world bytes and
// writes 1 per element of the sum.  The SR hash and the IEEE division
// cost about 30 instructions per element, about 1 µs of issue for a 4
// MB bucket's 2^20 elements on 132 SMs, under the bytes' 1.6 µs at
// 3.35 TB/s but not by much.  At the wire's sizes a call moves a few
// MB, about what the card keeps in flight at once, so what costs is
// latency: of the loads, and of each warp's instruction chain where
// too few warps share an SM to hide it.
//
// What the design does about it.  The int8 RN and fp16 quantizers
// (`quant_int8_kernel`, `quant_fp16_kernel`) keep the first design: a
// warp per row, two 16-byte loads a lane, a CTA per 8 rows.  The SR
// quantizer, leg 2 and the dequantizer (`*_rows`):
// - move the wire's chain into fewer launches: leg 2 of the SR wire
//   (dequantize the gathered shards, sum them over the ranks, SR-
//   quantize the sum) is one kernel that loads up to four ranks' rows
//   at once, sums their products in registers in ascending rank order
//   and writes only q2 and s2 (the earlier chain wrote the world·nb·256
//   fp32 dequantized shards and their nb·256 sum, and read both back);
//   the last dequantize reads only the rows that hold the first n
//   elements, writes only those n, and divides there by the world size
//   (the mean's divide, a separate pass over the output before);
// - a warp per row, 8 elements a lane, a CTA per 4 rows: a 4 MB bucket
//   gives 1024 CTAs, all resident at once, and the division, the hash
//   and the loads of many warps hide each other;
// - fp32 data as two 16-byte vectors 128 columns apart (each
//   instruction of a warp covers 512 contiguous bytes); leg 2's int8
//   payload as one 8-byte vector of 8 contiguous columns a rank, and
//   one 8-byte store;
// - what is read once is loaded with the evict-first hint (__ldcs), and
//   the payloads, read only by the next collective, stored with it
//   (__stcs).
// Tried on the H100 during development and dropped, each slower than
// this design at the 4 MB bucket or at AlexNet's bucket of 2^24
// elements: two rows of 16 elements a half-warp, for more bytes in
// flight a thread (4x fewer warps); a grid capped at the CTAs that fit
// on the SMs at once, each walking rows with the next row's loads in
// flight; a CTA's scales gathered in shared memory and written as
// whole sectors (the barrier holds each CTA for its slowest warp).

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

// ---------------------------------------------------------------------------
// int8 RN and fp16 quantizers: a warp per row
// ---------------------------------------------------------------------------

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

inline unsigned grid_for(long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

// ---------------------------------------------------------------------------
// SR quantizer, leg 2 and dequantizer: a warp per row, CTAs of 4 rows
// ---------------------------------------------------------------------------

constexpr int kRowsPerCta = 4;                  // a warp per row
constexpr int kCtaThreads = kRowsPerCta * 32;
constexpr int kPerLane = 8;                     // elements of a row a lane
constexpr int kRankChunk = 4;                   // leg 2: ranks loaded at once

// Column of element e (0..7) of lane l.  fp32 data: two runs of four,
// 128 columns apart, 4l + e%4 + 128(e/4) (each instruction of a warp
// covers 512 contiguous bytes); leg 2's int8 data: 8l + e (256).
template <bool kContig>
__device__ __forceinline__ int col(int lane, int e) {
  return kContig ? 8 * lane + e : 4 * lane + (e & 3) + 128 * (e >> 2);
}

// SR-quantizes, in place, this lane's 8 elements of a row held by its
// warp (columns col<kContig>) to integers in [-127, 127]; returns the
// row's scale.  All 32 lanes call it.
template <bool kContig>
__device__ __forceinline__ float sr_row(float v[kPerLane], long row, int lane,
                                        uint32_t seed) {
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) m = fmaxf(m, fabsf(v[e]));
  m = warp_max(m);
  const float s = __fdiv_rn(m, 127.f);
  const float safe = s > 0.f ? s : 1.f;
  // the flattened index wraps at 2^32, as the Pallas kernel's uint32 does
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(kBlock);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const uint32_t idx = base + static_cast<uint32_t>(col<kContig>(lane, e));
    const float u = hash_uniform(idx * 0x9E3779B9u + seed);
    const float t = __fdiv_rn(v[e], safe);
    v[e] = fminf(fmaxf(floorf(__fadd_rn(t, u)), -127.f), 127.f);
  }
  return s;
}

// Four of those integers as four int8 in one word.
__device__ __forceinline__ uint32_t pack4(const float* y) {
  const char4 c = make_char4(
      static_cast<signed char>(y[0]), static_cast<signed char>(y[1]),
      static_cast<signed char>(y[2]), static_cast<signed char>(y[3]));
  return *reinterpret_cast<const uint32_t*>(&c);
}

__global__ void __launch_bounds__(kCtaThreads)
    quant_int8_sr_rows(const float* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ s, long rows, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerCta +
                   (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its row is past the end
  const float4* xr = reinterpret_cast<const float4*>(x + row * kBlock) + lane;
  const float4 a = __ldcs(xr), b = __ldcs(xr + 32);  // read once: stream
  float v[kPerLane] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const float sc = sr_row<false>(v, row, lane, seed);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * kBlock) + lane;
  __stcs(qr, pack4(v));
  __stcs(qr + 32, pack4(v + 4));
  if (lane == 0) s[row] = sc;
}

__global__ void __launch_bounds__(kCtaThreads)
    dequant_sum_quant_int8_sr_rows(const int8_t* __restrict__ qt,
                                   const float* __restrict__ st,
                                   int8_t* __restrict__ q2,
                                   float* __restrict__ s2, int world, long nb,
                                   uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerCta +
                   (threadIdx.x >> 5);
  if (row >= nb) return;
  float acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;
  for (int p0 = 0; p0 < world; p0 += kRankChunk) {
    uint2 w[kRankChunk];
    float sc[kRankChunk];
#pragma unroll
    for (int c = 0; c < kRankChunk; ++c) {  // every load before any sum
      const bool in = p0 + c < world;
      const long r = static_cast<long>(p0 + c) * nb + row;  // rank's row
      w[c] = in ? __ldcs(reinterpret_cast<const uint2*>(qt + r * kBlock) + lane)
                : make_uint2(0u, 0u);
      sc[c] = in ? st[r] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kRankChunk; ++c) {
      if (p0 + c >= world) break;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {  // ascending ranks, as plain
        const uint32_t word = e < 4 ? w[c].x : w[c].y;
        const int8_t b = static_cast<int8_t>((word >> (8 * (e & 3))) & 0xFFu);
        const float d = __fmul_rn(static_cast<float>(b), sc[c]);
        acc[e] = p0 + c == 0 ? d : __fadd_rn(acc[e], d);
      }
    }
  }
  const float sc = sr_row<true>(acc, row, lane, seed);
  __stcs(reinterpret_cast<uint2*>(q2 + row * kBlock) + lane,
         make_uint2(pack4(acc), pack4(acc + 4)));
  if (lane == 0) s2[row] = sc;
}

// This lane's 8 payload elements of a row (columns col<false>) as fp32.
__device__ __forceinline__ void load_payload(const int8_t* __restrict__ q,
                                             long row, int lane,
                                             float v[kPerLane]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(q + row * kBlock) + lane;
  const uint32_t w[2] = {__ldcs(p), __ldcs(p + 32)};
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    v[e] = static_cast<int8_t>((w[e >> 2] >> (8 * (e & 3))) & 0xFFu);
}

__device__ __forceinline__ void load_payload(const __half* __restrict__ q,
                                             long row, int lane,
                                             float v[kPerLane]) {
  const uint2* p = reinterpret_cast<const uint2*>(q + row * kBlock) + lane;
  const uint2 a = __ldcs(p), b = __ldcs(p + 32);
  const uint32_t w[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    v[e] = __half2float(__ushort_as_half(static_cast<unsigned short>(
        (w[e >> 1] >> (16 * (e & 1))) & 0xFFFFu)));
}

// rows: those that hold the first n elements (the caller's ceil(n/256));
// out[row·256 + c] = float(q) · s [/ divisor] for the columns below n.
template <typename P>
__global__ void __launch_bounds__(kCtaThreads)
    dequant_rows(const P* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, long rows, long n, float divisor) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerCta +
                   (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[kPerLane];
  load_payload(q, row, lane, v);
  const float sc = s[row];
  const bool divide = divisor != 1.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    v[e] = __fmul_rn(v[e], sc);
    if (divide) v[e] = __fdiv_rn(v[e], divisor);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const long f = row * kBlock + col<false>(lane, 4 * k);
    if (f + 4 <= n) {
      *reinterpret_cast<float4*>(out + f) =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (f + i < n) out[f + i] = v[4 * k + i];
    }
  }
}

inline unsigned row_grid(long rows) {
  return static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta);
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
  quant_int8_sr_rows<<<row_grid(rows), kCtaThreads, 0,
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

// Leg 2 of the int8_sr wire: qt (world, nb, 256) int8 and st (world, nb)
// fp32 → q2 (nb, 256) int8 and s2 (nb) fp32; world, nb >= 1.
int block_dequant_sum_quant_int8_sr(const int8_t* qt, const float* st,
                                    int8_t* q2, float* s2, int world, long nb,
                                    uint32_t seed, void* stream) {
  dequant_sum_quant_int8_sr_rows<<<row_grid(nb), kCtaThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      qt, st, q2, s2, world, nb, seed);
  return static_cast<int>(cudaGetLastError());
}

// out[0:n] = (float(q) · s) / divisor over the flattened payload of rows
// rows (1 ≤ n ≤ rows · 256; divisor 1 divides nothing).
int block_dequant_int8(const int8_t* q, const float* s, float* out, long rows,
                       long n, float divisor, void* stream) {
  const long need = (n + kBlock - 1) / kBlock;
  rows = need < rows ? need : rows;
  dequant_rows<int8_t><<<row_grid(rows), kCtaThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(q, s, out, rows,
                                                              n, divisor);
  return static_cast<int>(cudaGetLastError());
}

int block_dequant_fp16(const __half* q, const float* s, float* out, long rows,
                       long n, float divisor, void* stream) {
  const long need = (n + kBlock - 1) / kBlock;
  rows = need < rows ? need : rows;
  dequant_rows<__half><<<row_grid(rows), kCtaThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(q, s, out, rows,
                                                              n, divisor);
  return static_cast<int>(cudaGetLastError());
}

const char* block_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
