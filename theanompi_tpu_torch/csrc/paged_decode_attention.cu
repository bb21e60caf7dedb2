// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel theanompi_tpu/ops/pallas_paged.py
// `_paged_kernel` (called through `paged_decode_attention`) for pools
// held in fp32 or the bf16 compute dtype.  For every lane s and head h:
//
//   out[s, h] = softmax(q[s, h] . K[s, h]^T * scale) . V[s, h]
//
// where lane s's K/V rows are logical positions 0..lengths[s] (the
// incoming token attends to itself), found through its block table:
// position t lives in pool row tables[s, t / bs] * bs + t % bs.
//
// What bounds it on this card: memory.  Each live K/V row is read once
// and used for 2*hd flops (dot with q, then a scaled add into the
// output), about 0.5 flop per fp32 byte, while the H100 needs ~20 fp32
// flops per byte before its ALUs are the limit.  The least time is the
// bytes of the live rows over 3.35 TB/s.  What the design does about
// it: it reads only the live rows (blocks past the lane's length are
// never touched, rows past the length in the boundary block are never
// loaded, so nothing is masked after being read), reads each of them
// exactly once, and keeps scores, the softmax carry and the output
// accumulator in registers — no gathered (S, T, H, hd) image is ever
// written to device memory, which the plain version does.  A warp reads
// one K or V row as 32 neighbouring lanes on neighbouring addresses.
//
// int8 pools (`paged_decode_kernel_i8`) replace `_paged_kernel_i8` of
// the same file: the serving engine's `kv_dtype='int8'` cache holds K/V
// rows as int8 with one fp32 scale per (pool row, head) beside them.
// The same recurrence, with two changes: each row's int8 values are
// dequantized in registers (value * that row's and head's scale, read
// once per row by the warp), and a warp reads a row as 32 lanes of two
// neighbouring bytes each (a `char2`), so one 64-byte row of head_dim
// 64 is one coalesced load.  Bound: bytes again, now hd + 4 per (row,
// head) for K and again for V, against 4 * hd for an fp32 pool.
//
// Layout (all contiguous):
//   q       (S, H, hd)    float32
//   k, v    (R, H, hd)    T = float or __nv_bfloat16, R = n_blocks * bs
//   tables  (S, NT)       int32, block 0 is the trash block
//   lengths (S,)          int32, >= 0
//   out     (S, H, hd)    float32
//   int8:   k, v (R, H, hd) int8, ks, vs (R, H) float32
//
// Design (simple first): one CTA per (head, lane), four warps.  The CTA
// loops over the lane's table entries itself (the TPU kernel's
// sequential grid axis and its scratch carry have no counterpart
// between CUDA blocks), reads tables[s, j] itself (in place of scalar
// prefetch), and skips every block with j * bs > length.  Inside a
// block, warp w takes rows w, w + 4, ...; each warp keeps its own
// online-softmax carry (max, denominator, hd/32 accumulators per lane)
// in fp32, and the four carries merge through shared memory at the end,
// followed by the final divide.  Later work: stage K/V blocks with
// cp.async or TMA, put several lanes in one CTA, split long tables
// across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;
constexpr int kPerLane = kMaxHeadDim / 32;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kPairs = kMaxHeadDim / 64;  // int8: element pairs a lane holds

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const float* __restrict__ q,
                        const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int n_heads, int head_dim,
                        int n_table, int block_size, float scale) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = lengths[s];
  const size_t qo = (static_cast<size_t>(s) * n_heads + h) * head_dim;

  float qv[kPerLane];
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    qv[i] = e < head_dim ? q[qo + e] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float d = 0.f;

  const int* table = tables + static_cast<size_t>(s) * n_table;
  for (int j = 0; j < n_table && j * block_size <= length; ++j) {
    const size_t base = static_cast<size_t>(table[j]) * block_size;
    const int rows = min(block_size, length - j * block_size + 1);
    for (int r = warp; r < rows; r += kWarps) {
      const size_t off = ((base + r) * n_heads + h) * head_dim;
      const T* krow = k_pool + off;
      const T* vrow = v_pool + off;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e < head_dim) part += qv[i] * to_float(krow[e]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      const float score = part * scale;
      const float m_new = fmaxf(m, score);
      const float corr = expf(m - m_new);
      const float p = expf(score - m_new);
      d = d * corr + p;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e < head_dim) acc[i] = acc[i] * corr + p * to_float(vrow[e]);
      }
      m = m_new;
    }
  }

  __shared__ float s_m[kWarps];
  __shared__ float s_d[kWarps];
  __shared__ float s_acc[kWarps][kMaxHeadDim];
  if (lane == 0) {
    s_m[warp] = m;
    s_d[warp] = d;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < head_dim) s_acc[warp][e] = acc[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < head_dim; e += kThreads) {
    float mx = s_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w] - mx);  // 0 for a warp that saw no row
      den += s_d[w] * c;
      num += s_acc[w][e] * c;
    }
    out[qo + e] = num / den;
  }
}

// Lane `lane` holds elements 64 * i + 2 * lane + {0, 1} of an int8 row,
// dequantized with the row's scale.  `paired`: the row starts on a
// 2-byte boundary (head_dim even, pool aligned), so each pair is one
// char2 load; otherwise byte by byte.
__device__ __forceinline__ void load_row_i8(const int8_t* __restrict__ row,
                                            int head_dim, int lane,
                                            bool paired, float scale,
                                            float (&out)[2 * kPairs]) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int e = 64 * i + 2 * lane;
    if (paired && e < head_dim) {
      const char2 c = *reinterpret_cast<const char2*>(row + e);
      out[2 * i] = static_cast<float>(c.x) * scale;
      out[2 * i + 1] = static_cast<float>(c.y) * scale;
    } else {
      out[2 * i] = e < head_dim ? static_cast<float>(row[e]) * scale : 0.f;
      out[2 * i + 1] =
          e + 1 < head_dim ? static_cast<float>(row[e + 1]) * scale : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel_i8(const float* __restrict__ q,
                           const int8_t* __restrict__ k_pool,
                           const int8_t* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, int n_heads,
                           int head_dim, int n_table, int block_size,
                           float scale, bool paired) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = lengths[s];
  const size_t qo = (static_cast<size_t>(s) * n_heads + h) * head_dim;

  float qv[2 * kPairs];
  float acc[2 * kPairs];
#pragma unroll
  for (int i = 0; i < 2 * kPairs; ++i) {
    const int e = 64 * (i / 2) + 2 * lane + i % 2;
    qv[i] = e < head_dim ? q[qo + e] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float d = 0.f;

  const int* table = tables + static_cast<size_t>(s) * n_table;
  for (int j = 0; j < n_table && j * block_size <= length; ++j) {
    const size_t base = static_cast<size_t>(table[j]) * block_size;
    const int rows = min(block_size, length - j * block_size + 1);
    for (int r = warp; r < rows; r += kWarps) {
      const size_t row = (base + r) * n_heads + h;
      float kf[2 * kPairs];
      float vf[2 * kPairs];
      load_row_i8(k_pool + row * head_dim, head_dim, lane, paired,
                  k_scale[row], kf);
      load_row_i8(v_pool + row * head_dim, head_dim, lane, paired,
                  v_scale[row], vf);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * kPairs; ++i) part += qv[i] * kf[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      const float score = part * scale;
      const float m_new = fmaxf(m, score);
      const float corr = expf(m - m_new);
      const float p = expf(score - m_new);
      d = d * corr + p;
#pragma unroll
      for (int i = 0; i < 2 * kPairs; ++i) acc[i] = acc[i] * corr + p * vf[i];
      m = m_new;
    }
  }

  __shared__ float s_m[kWarps];
  __shared__ float s_d[kWarps];
  __shared__ float s_acc[kWarps][kMaxHeadDim];
  if (lane == 0) {
    s_m[warp] = m;
    s_d[warp] = d;
  }
#pragma unroll
  for (int i = 0; i < 2 * kPairs; ++i) {
    const int e = 64 * (i / 2) + 2 * lane + i % 2;
    if (e < head_dim) s_acc[warp][e] = acc[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < head_dim; e += kThreads) {
    float mx = s_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w] - mx);  // 0 for a warp that saw no row
      den += s_d[w] * c;
      num += s_acc[w][e] * c;
    }
    out[qo + e] = num / den;
  }
}

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* tables,
           const int* lengths, float* out, int n_lanes, int n_heads,
           int head_dim, int n_table, int block_size, float scale,
           cudaStream_t stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim || n_table < 1 ||
      block_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes == 0 || n_heads == 0) return 0;
  const dim3 grid(n_heads, n_lanes);
  paged_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), tables, lengths,
      out, n_heads, head_dim, n_table, block_size, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after
// the launch (0 = launched); the caller raises on anything else.
extern "C" {

int paged_decode_attention_f32(const float* q, const void* k, const void* v,
                               const int* tables, const int* lengths,
                               float* out, int n_lanes, int n_heads,
                               int head_dim, int n_table, int block_size,
                               float scale, void* stream) {
  return launch<float>(q, k, v, tables, lengths, out, n_lanes, n_heads,
                       head_dim, n_table, block_size, scale,
                       static_cast<cudaStream_t>(stream));
}

int paged_decode_attention_bf16(const float* q, const void* k, const void* v,
                                const int* tables, const int* lengths,
                                float* out, int n_lanes, int n_heads,
                                int head_dim, int n_table, int block_size,
                                float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, tables, lengths, out, n_lanes,
                               n_heads, head_dim, n_table, block_size, scale,
                               static_cast<cudaStream_t>(stream));
}

int paged_decode_attention_i8(const float* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale,
                              const int* tables, const int* lengths,
                              float* out, int n_lanes, int n_heads,
                              int head_dim, int n_table, int block_size,
                              float scale, void* stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim || n_table < 1 ||
      block_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes == 0 || n_heads == 0) return 0;
  const bool paired = head_dim % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(k) % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(v) % 2 == 0;
  const dim3 grid(n_heads, n_lanes);
  paged_decode_kernel_i8<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      k_scale, v_scale, tables, lengths, out, n_heads, head_dim, n_table,
      block_size, scale, paired);
  return static_cast<int>(cudaGetLastError());
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
