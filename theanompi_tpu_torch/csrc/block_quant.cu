// Block quantization of the gradient wire, for Hopper (sm_90a):
// int8 round-to-nearest, int8 stochastic rounding, fp16 with a block
// scale, the dequantization of an int8 or fp16 payload (optionally
// divided by the world size and cut to the payload's length), and leg 2
// of each block wire (int8, int8_sr, fp16s) in one launch.
//
// Replaces the TPU kernels of theanompi_tpu/parallel/quantize.py:
// `_quant_kernel`, `_quant_sr_kernel`, `_quant_fp16_kernel` and
// `_dequant_kernel` (all through `_run_quant_kernel` and
// `pallas_dequantize_blocks`), and, in `dequant_sum_quant_rows`, the
// reference's leg 2 of the block wires (theanompi_tpu/parallel/
// exchanger.py `_wire_from_packed`: `_dequant_kernel`, `jnp.sum` over
// the ranks, then `_quant_kernel`, `_quant_sr_kernel` or
// `_quant_fp16_kernel`).  The input is (rows, 256) fp32, one
// quantization block per row, any number of rows:
//
//   s    = amax(|x_row|) / cap          (cap 127 for int8, 256 for fp16)
//   safe = s > 0 ? s : 1
//   int8 RN: q = clamp(rint(x / safe), -127, 127)       (half to even)
//   int8 SR: q = clamp(floor(x / safe + u), -127, 127)
//            u = hash(idx * 0x9E3779B9 + seed), top 24 bits / 2^24
//   fp16:    q = __float2half_rn(x / safe)
//   dequant: out = float(q) * s          [/ divisor, first n elements]
//   leg 2:   sum = ((q_0 s_0 + q_1 s_1) + q_2 s_2) + ...   (ranks in
//            ascending order, each product and sum rounded once), then
//            the wire's own quantization (RN, SR or fp16) of the
//            (nb, 256) sum
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
// a dequantize reads 1 or 2 and writes 4; leg 2 reads world payload
// bytes and writes 1 (int8) or 2 (fp16) per element of the sum.  The SR
// hash and the IEEE division cost about 30 instructions per element,
// about 1 µs of issue for a 4 MB bucket's 2^20 elements on 132 SMs,
// under the bytes' 1.6 µs at 3.35 TB/s but not by much.  At the wire's
// sizes a call moves a few MB, about what the card keeps in flight at
// once, so what costs is latency: of the launch, of the loads, and of
// each warp's instruction chain where too few warps share an SM to
// hide it.
//
// What the design does about it:
// - move the wire's chain into fewer launches: leg 2 of every block
//   wire (dequantize the gathered shards, sum them over the ranks,
//   quantize the sum) is one kernel that loads up to four ranks' rows
//   at once, sums their products in registers in ascending rank order
//   and writes only q2 and s2 (the earlier chain wrote the world·nb·256
//   fp32 dequantized shards and their nb·256 sum, and read both back);
//   the last dequantize reads only the rows that hold the first n
//   elements, writes only those n, and divides there by the world size
//   (the mean's divide, a separate pass over the output before);
// - one layout for every kernel: a warp per row, 8 elements a lane, a
//   CTA per 4 rows: a 4 MB bucket gives 1024 CTAs, all resident at
//   once, and the division, the hash and the loads of many warps hide
//   each other; the three quantizers are one row template over the
//   rounding (`quant_row<Quant>`), the scale head shared;
// - fp32 data as two 16-byte vectors 128 columns apart (each
//   instruction of a warp covers 512 contiguous bytes); leg 2's payload
//   as one vector of 8 contiguous columns a rank (8 bytes of int8, 16 of
//   fp16), and one store of the same width;
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
constexpr int kRowsPerCta = 4;                  // a warp per row
constexpr int kCtaThreads = kRowsPerCta * 32;
constexpr int kPerLane = 8;                     // elements of a row a lane
constexpr int kRankChunk = 4;                   // leg 2: ranks loaded at once

// The wire's three quantizers, and the payload type each writes.
enum class Quant { kRN, kSR, kFP16 };

template <Quant M>
struct PayloadOf {
  using type = int8_t;
};
template <>
struct PayloadOf<Quant::kFP16> {
  using type = __half;
};
template <Quant M>
using Payload = typename PayloadOf<M>::type;

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

// Column of element e (0..7) of lane l.  fp32 data: two runs of four,
// 128 columns apart, 4l + e%4 + 128(e/4) (each instruction of a warp
// covers 512 contiguous bytes); leg 2's payload: 8l + e (256).
template <bool kContig>
__device__ __forceinline__ int col(int lane, int e) {
  return kContig ? 8 * lane + e : 4 * lane + (e & 3) + 128 * (e >> 2);
}

// Quantizes, in place, this lane's 8 elements of a row held by its warp
// (columns col<kContig>): RN and SR to integers in [-127, 127], fp16 to
// the quotients x / safe (rounded to fp16 on store).  Returns the row's
// scale.  All 32 lanes call it; seed is read by SR only.
template <Quant M, bool kContig>
__device__ __forceinline__ float quant_row(float v[kPerLane], long row,
                                           int lane, uint32_t seed) {
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) m = fmaxf(m, fabsf(v[e]));
  m = warp_max(m);
  const float s = __fdiv_rn(m, M == Quant::kFP16 ? 256.f : 127.f);
  const float safe = s > 0.f ? s : 1.f;
  // the flattened index wraps at 2^32, as the Pallas kernel's uint32 does
  const uint32_t base = static_cast<uint32_t>(row) * static_cast<uint32_t>(kBlock);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    if constexpr (M == Quant::kSR) {
      const uint32_t idx = base + static_cast<uint32_t>(col<kContig>(lane, e));
      const float u = hash_uniform(idx * 0x9E3779B9u + seed);
      const float t = __fdiv_rn(v[e], safe);
      v[e] = fminf(fmaxf(floorf(__fadd_rn(t, u)), -127.f), 127.f);
    } else if constexpr (M == Quant::kRN) {
      v[e] = fminf(fmaxf(rintf(__fdiv_rn(v[e], safe)), -127.f), 127.f);
    } else {
      v[e] = __fdiv_rn(v[e], safe);
    }
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

// Two quotients as two fp16 (round to nearest even) in one word.
__device__ __forceinline__ uint32_t pack2h(float a, float b) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(a))) |
         (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(b))) << 16);
}

// Stores this lane's 8 quantized elements of a row (columns col<kContig>),
// evict-first.
template <bool kContig>
__device__ __forceinline__ void store_row(int8_t* __restrict__ q, long row,
                                          int lane, const float v[kPerLane]) {
  if constexpr (kContig) {
    __stcs(reinterpret_cast<uint2*>(q + row * kBlock) + lane,
           make_uint2(pack4(v), pack4(v + 4)));
  } else {
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * kBlock) + lane;
    __stcs(qr, pack4(v));
    __stcs(qr + 32, pack4(v + 4));
  }
}

template <bool kContig>
__device__ __forceinline__ void store_row(__half* __restrict__ q, long row,
                                          int lane, const float v[kPerLane]) {
  const uint2 lo = make_uint2(pack2h(v[0], v[1]), pack2h(v[2], v[3]));
  const uint2 hi = make_uint2(pack2h(v[4], v[5]), pack2h(v[6], v[7]));
  if constexpr (kContig) {
    __stcs(reinterpret_cast<uint4*>(q + row * kBlock) + lane,
           make_uint4(lo.x, lo.y, hi.x, hi.y));
  } else {
    uint2* qr = reinterpret_cast<uint2*>(q + row * kBlock) + lane;
    __stcs(qr, lo);
    __stcs(qr + 32, hi);
  }
}

// Leg 1: quantize (rows, 256) fp32.
template <Quant M>
__global__ void __launch_bounds__(kCtaThreads)
    quant_rows(const float* __restrict__ x, Payload<M>* __restrict__ q,
               float* __restrict__ s, long rows, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerCta +
                   (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its row is past the end
  const float4* xr = reinterpret_cast<const float4*>(x + row * kBlock) + lane;
  const float4 a = __ldcs(xr), b = __ldcs(xr + 32);  // read once: stream
  float v[kPerLane] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const float sc = quant_row<M, false>(v, row, lane, seed);
  store_row<false>(q, row, lane, v);
  if (lane == 0) s[row] = sc;
}

// A lane's 8 contiguous payload elements of a row as one vector, and
// element e of it as fp32 (exact).
template <typename P>
struct Lane8;
template <>
struct Lane8<int8_t> {
  using V = uint2;
  __device__ static V zero() { return make_uint2(0u, 0u); }
  __device__ static float at(const V& w, int e) {
    const uint32_t word = e < 4 ? w.x : w.y;
    return static_cast<int8_t>((word >> (8 * (e & 3))) & 0xFFu);
  }
};
template <>
struct Lane8<__half> {
  using V = uint4;
  __device__ static V zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static float at(const V& w, int e) {
    const uint32_t word = e < 2 ? w.x : e < 4 ? w.y : e < 6 ? w.z : w.w;
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((word >> (16 * (e & 1))) & 0xFFFFu)));
  }
};

// Leg 2: (world, nb, 256) payload and (world, nb) scales → the
// quantized (nb, 256) sum over the ranks, q2 (nb, 256) and s2 (nb).
template <Quant M>
__global__ void __launch_bounds__(kCtaThreads)
    dequant_sum_quant_rows(const Payload<M>* __restrict__ qt,
                           const float* __restrict__ st,
                           Payload<M>* __restrict__ q2,
                           float* __restrict__ s2, int world, long nb,
                           uint32_t seed) {
  using L = Lane8<Payload<M>>;
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerCta +
                   (threadIdx.x >> 5);
  if (row >= nb) return;
  float acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;
  for (int p0 = 0; p0 < world; p0 += kRankChunk) {
    typename L::V w[kRankChunk];
    float sc[kRankChunk];
#pragma unroll
    for (int c = 0; c < kRankChunk; ++c) {  // every load before any sum
      const bool in = p0 + c < world;
      const long r = static_cast<long>(p0 + c) * nb + row;  // rank's row
      w[c] = in ? __ldcs(reinterpret_cast<const typename L::V*>(
                             qt + r * kBlock) + lane)
                : L::zero();
      sc[c] = in ? st[r] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kRankChunk; ++c) {
      if (p0 + c >= world) break;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {  // ascending ranks, as plain
        const float d = __fmul_rn(L::at(w[c], e), sc[c]);
        acc[e] = p0 + c == 0 ? d : __fadd_rn(acc[e], d);
      }
    }
  }
  const float sc = quant_row<M, true>(acc, row, lane, seed);
  store_row<true>(q2, row, lane, acc);
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

template <Quant M>
int launch_quant(const float* x, Payload<M>* q, float* s, long rows,
                 uint32_t seed, void* stream) {
  quant_rows<M><<<row_grid(rows), kCtaThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, q, s, rows, seed);
  return static_cast<int>(cudaGetLastError());
}

template <Quant M>
int launch_leg2(const Payload<M>* qt, const float* st, Payload<M>* q2,
                float* s2, int world, long nb, uint32_t seed, void* stream) {
  dequant_sum_quant_rows<M><<<row_grid(nb), kCtaThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      qt, st, q2, s2, world, nb, seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_dequant(const P* q, const float* s, float* out, long rows, long n,
                   float divisor, void* stream) {
  const long need = (n + kBlock - 1) / kBlock;
  rows = need < rows ? need : rows;
  dequant_rows<P><<<row_grid(rows), kCtaThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(q, s, out, rows, n,
                                                         divisor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched).
// Pointers must be 16-byte aligned (torch's allocations are); rows >= 1.

int block_quant_int8(const float* x, int8_t* q, float* s, long rows,
                     void* stream) {
  return launch_quant<Quant::kRN>(x, q, s, rows, 0u, stream);
}

int block_quant_int8_sr(const float* x, int8_t* q, float* s, long rows,
                        uint32_t seed, void* stream) {
  return launch_quant<Quant::kSR>(x, q, s, rows, seed, stream);
}

int block_quant_fp16(const float* x, __half* q, float* s, long rows,
                     void* stream) {
  return launch_quant<Quant::kFP16>(x, q, s, rows, 0u, stream);
}

// Leg 2 of a block wire: qt (world, nb, 256) payload and st (world, nb)
// fp32 → q2 (nb, 256) payload and s2 (nb) fp32; world, nb >= 1.
int block_dequant_sum_quant_int8(const int8_t* qt, const float* st,
                                 int8_t* q2, float* s2, int world, long nb,
                                 void* stream) {
  return launch_leg2<Quant::kRN>(qt, st, q2, s2, world, nb, 0u, stream);
}

int block_dequant_sum_quant_int8_sr(const int8_t* qt, const float* st,
                                    int8_t* q2, float* s2, int world, long nb,
                                    uint32_t seed, void* stream) {
  return launch_leg2<Quant::kSR>(qt, st, q2, s2, world, nb, seed, stream);
}

int block_dequant_sum_quant_fp16(const __half* qt, const float* st,
                                 __half* q2, float* s2, int world, long nb,
                                 void* stream) {
  return launch_leg2<Quant::kFP16>(qt, st, q2, s2, world, nb, 0u, stream);
}

// out[0:n] = (float(q) · s) / divisor over the flattened payload of rows
// rows (1 ≤ n ≤ rows · 256; divisor 1 divides nothing).
int block_dequant_int8(const int8_t* q, const float* s, float* out, long rows,
                       long n, float divisor, void* stream) {
  return launch_dequant(q, s, out, rows, n, divisor, stream);
}

int block_dequant_fp16(const __half* q, const float* s, float* out, long rows,
                       long n, float divisor, void* stream) {
  return launch_dequant(q, s, out, rows, n, divisor, stream);
}

const char* block_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
