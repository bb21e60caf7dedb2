// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of theanompi_tpu/ops/pallas_paged.py:
// `_paged_kernel` (pools held in fp32 or the bf16 compute dtype) and
// `_paged_kernel_i8` (the serving engine's `kv_dtype='int8'` cache: K/V
// rows as int8 with one fp32 scale per (pool row, head) beside them),
// both called through `paged_decode_attention`.  For every lane s and
// head h:
//
//   out[s, h] = softmax(q[s, h] . K[s, h]^T * scale) . V[s, h]
//
// where lane s's K/V rows are logical positions 0..lengths[s] (the
// incoming token attends to itself), found through its block table:
// position t lives in pool row tables[s, t / bs] * bs + t % bs.  int8
// rows are dequantized as value * scale[row, head].
//
// What bounds it on this card: memory.  Each live K/V row is read once
// and used for 2*hd flops (dot with q, then a scaled add into the
// output), about 0.5 flop per fp32 byte (2 per int8 byte), while the
// H100 needs ~20 fp32 flops per byte before its ALUs are the limit.  The
// least time is the bytes of the live rows (int8: hd + 4 bytes per row
// and head, K and V) over 3.35 TB/s.  Both instances read only the live
// rows, each once, and keep scores, the softmax carry and the output
// accumulator on chip: no gathered (S, T, H, hd) image is ever written
// to device memory, which the plain version does.
//
// Layout (all contiguous):
//   q       (S, H, hd)    float32
//   k, v    (R, H, hd)    float, __nv_bfloat16 or int8, R = n_blocks * bs
//   ks, vs  (R, H)        float32 (int8 pools only)
//   tables  (S, NT)       int32, block 0 is the trash block
//   lengths (S,)          int32, >= 0
//   out     (S, H, hd)    float32
//
// Two instances; `ops.paged_attention.paged_instance` picks one per call.
//
// "bulk" (`paged_decode_kernel_bulk`): rows a bulk copy can describe —
// hd even and <= 128, 1..16 heads, a pool row of H * hd elements a
// multiple of 16 bytes, every pool (and scale) base on 16 bytes, and
// (int8) scale planes of R * H floats a multiple of 16 bytes: a chunk's
// scales are copied in 16-byte units from the boundary at or below the
// first, so the copy of the last rows ends on the plane's end.
//   - The grid covers (split, lane): split i takes table entries
//     [i * bps, (i + 1) * bps) of its lane (bps from the host's
//     `paged_split_plan`), so a long table is spread over many SMs
//     (flash-decoding).  A CTA whose split starts past its lane's length
//     exits at once.
//   - All heads of a pool row in one CTA, one warp per head: a pool row
//     (H, hd) is contiguous, so the rows of a block are one contiguous
//     span.  The CTA reads its table entries once.
//   - One thread of an extra producer warp stages the split's rows
//     through a ring of `stages` buffers in shared memory, kRows rows of
//     K and V (and their scale rows) per stage, with 1-D bulk copies
//     (cp.async.bulk; a "full" mbarrier a stage counts the bytes in, an
//     "empty" one the head warps out), as far ahead as the ring allows.
//     Rows past the lane's length are never copied.
//   - Per staged chunk a warp computes its head's kRows partial dots
//     with lanes over hd (neighbouring lanes on neighbouring shared
//     addresses: conflict-free; every row loaded unguarded, so that all
//     loads are in flight at once), reduces all of them in one transpose
//     reduction (kRows - 1 shuffles, after which lane r holds row r's
//     score), then takes one max, one exp per row and one rescale of
//     the carry per chunk.  int8: the integer-valued dot is scaled once
//     per row (score = s_k[r] * (q . k8[r])) and the V scale folds into
//     the weight (p[r] * s_v[r]).
//   - A lane with one live split writes its output directly.  Otherwise
//     each CTA writes a partial (m, l, acc[hd]) per head to a workspace,
//     takes a ticket (atomicAdd on the lane's counter), and the CTA that
//     draws the last ticket combines the lane's partials, weighting each
//     by exp(m_i - m), writes the output and resets the counter to 0.
//     Only live splits write partials, so none is empty.
//
// "general" (`paged_decode_kernel`, `paged_decode_kernel_i8`): any other
// row (odd hd, an unaligned pool, a row not a multiple of 16 bytes).
// One CTA per (head, lane), four warps; each warp walks rows w, w + 4,
// ... of the lane's blocks itself (the TPU kernel's sequential grid axis
// and its scratch carry have no counterpart between CUDA blocks), keeps
// its own online-softmax carry in registers, and the four carries merge
// through shared memory at the end.  int8 rows are dequantized in
// registers; a warp reads a row as 32 lanes of two neighbouring bytes
// (`char2`), or byte by byte where the pool starts on an odd byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The bulk instance
// ---------------------------------------------------------------------------

constexpr int kBulkMaxHeads = 16;   // one warp per head
constexpr int kBulkMaxStages = 16;
constexpr int kBulkHeader = 256;    // a full and an empty mbarrier a stage
constexpr int kCombine = 8;         // partials merged per round of loads
constexpr size_t kBulkSmemMax = 232448;  // 227 KB, an H100 block's most

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// elements e, e + 1 of a staged row (e even, so the pair is aligned)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// int8: each byte b, biased to b + 128, becomes the low byte of the
// float 2^23 + b + 128 (one byte permute), and one subtraction leaves b
// exactly: cheaper than two I2F conversions, which run at a quarter of
// the FP32 rate
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const uint32_t x =
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_float2(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) -
                         kBias,
                     __int_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) -
                         kBias);
}

// v[r] holds this lane's part of row r's dot (N a power of 2 <= 32).
// Returns the warp's sum for row (lane % N): log2(N) butterfly steps,
// each of which keeps half of a lane's rows and adds the partner's
// half (N - 1 shuffles in all), then log2(32 / N) steps across the
// groups of N lanes.
__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

template <int N>
__device__ __forceinline__ float transpose_reduce(float (&v)[N], int lane) {
  // constant trip counts, so that every index is known at compile time
  // and v stays in registers
  constexpr int kSteps = log2_of(N);
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int w = (N / 2) >> step;
    const bool upper = (lane & w) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      if (j < w) {
        const float keep = upper ? v[j + w] : v[j];
        const float send = upper ? v[j] : v[j + w];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, w);
      }
    }
  }
  float x = v[0];
#pragma unroll
  for (int o = N; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max and sum over N neighbouring lanes (after `transpose_reduce<N>`,
// every row once)
template <int N>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// barrier 1 over the consumer warps (the producer warp has left)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

// Bytes of one stage's buffer for each scale tensor: kRows rows of H
// scales, copied from the 16-byte boundary at or below the first one.
__host__ __device__ __forceinline__ size_t bulk_scale_bytes(int rows,
                                                            int n_heads) {
  return round_up(static_cast<size_t>(rows) * n_heads * 4 + 12, 16);
}

// One stage: kRows rows of K, then of V, then (int8) their scale rows.
template <typename T>
__host__ __device__ __forceinline__ size_t bulk_stage_bytes(int rows,
                                                            int n_heads,
                                                            int head_dim) {
  const size_t kv = static_cast<size_t>(rows) * n_heads * head_dim * sizeof(T);
  return 2 * kv +
         (std::is_same<T, int8_t>::value ? 2 * bulk_scale_bytes(rows, n_heads)
                                         : 0);
}

template <typename T>
__host__ __device__ __forceinline__ size_t bulk_smem_bytes(
    int rows, int n_heads, int head_dim, int stages, int blocks_per_split) {
  return kBulkHeader +
         round_up(static_cast<size_t>(blocks_per_split) * 4, 128) +
         stages * bulk_stage_bytes<T>(rows, n_heads, head_dim);
}

// kLanePairs: element pairs a lane holds (1 for head_dim <= 64, else 2)
template <typename T, int kRows, int kLanePairs>
__global__ void __launch_bounds__((kBulkMaxHeads + 1) * 32)
    paged_decode_kernel_bulk(const float* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             float* __restrict__ out,
                             float2* __restrict__ ws_ml,
                             float* __restrict__ ws_acc, int* tickets,
                             int n_heads, int head_dim, int n_table,
                             int block_size, float scale,
                             int blocks_per_split, int n_splits,
                             int stages) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  const int split = blockIdx.x;
  const int s = blockIdx.y;
  // h and the length through a shuffle from lane 0, so that the compiler
  // knows them warp-uniform: the branches on them then keep every warp
  // converged, and the shuffles below need no collective fallback
  const int h = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32),
                            0);
  const int lane = threadIdx.x % 32;
  const int j0 = split * blocks_per_split;
  const int* table = tables + static_cast<size_t>(s) * n_table + j0;
  // the split's first table entries, loaded beside the length (not
  // after it): one memory round trip for both
  const int entry = threadIdx.x < min(blocks_per_split, n_table - j0)
                        ? table[threadIdx.x]
                        : 0;
  const int length = __shfl_sync(0xffffffffu, lengths[s], 0);
  const int n_live = min(length / block_size + 1, n_table);
  if (j0 >= n_live) return;  // the split starts past the lane's length
  const int j1 = min(j0 + blocks_per_split, n_live);
  const int n_parts = (n_live + blocks_per_split - 1) / blocks_per_split;
  // rows of block j that attend (the last live one may be partial)
  auto block_rows = [&](int j) {
    return min(block_size, length + 1 - j * block_size);
  };
  const int per_block = (block_size + kRows - 1) / kRows;
  const int n_chunks =
      (j1 - j0 - 1) * per_block + (block_rows(j1 - 1) + kRows - 1) / kRows;

  const size_t row_elems = static_cast<size_t>(n_heads) * head_dim;
  const size_t kv_bytes = kRows * row_elems * sizeof(T);
  const size_t sc_bytes = kI8 ? bulk_scale_bytes(kRows, n_heads) : 0;
  const size_t stage_bytes = bulk_stage_bytes<T>(kRows, n_heads, head_dim);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kBulkMaxStages;
  int* entries = reinterpret_cast<int*>(smem + kBulkHeader);
  unsigned char* ring =
      smem + kBulkHeader + round_up(static_cast<size_t>(blocks_per_split) * 4,
                                    128);
  __shared__ int last;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), n_heads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < j1 - j0) entries[threadIdx.x] = entry;
  for (int i = threadIdx.x + blockDim.x; i < j1 - j0; i += blockDim.x) {
    entries[i] = table[i];
  }
  __syncthreads();

  // chunk c: rows [r0, r0 + rows) of block j0 + c / per_block; returns
  // the pool row of its first row
  auto chunk = [&](int c, int& rows) {
    const int b = c / per_block;
    const int r0 = (c - b * per_block) * kRows;
    rows = min(kRows, block_rows(j0 + b) - r0);
    return static_cast<size_t>(entries[b]) * block_size + r0;
  };
  // int8: the scale rows of a chunk start (pre floats) past the 16-byte
  // boundary that its copy starts from; K and V scales alike
  auto scale_pre = [&](size_t row) {
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(k_scale + row * n_heads) & 15) / 4);
  };
  auto issue = [&](int c) {
    int rows;
    const size_t row = chunk(c, rows);
    unsigned char* buf = ring + static_cast<size_t>(c % stages) * stage_bytes;
    const uint32_t bar = smem_u32(&full[c % stages]);
    const uint32_t nb = static_cast<uint32_t>(rows * row_elems * sizeof(T));
    uint32_t sc_n = 0;
    if (kI8) {
      const int pre = scale_pre(row);
      sc_n = static_cast<uint32_t>(
          round_up(static_cast<size_t>(pre + rows * n_heads) * 4, 16));
    }
    mbar_expect_tx(bar, 2 * nb + 2 * sc_n);
    bulk_load(smem_u32(buf), k_pool + row * row_elems, nb, bar);
    bulk_load(smem_u32(buf + kv_bytes), v_pool + row * row_elems, nb, bar);
    if (kI8) {
      const int pre = scale_pre(row);
      bulk_load(smem_u32(buf + 2 * kv_bytes), k_scale + row * n_heads - pre,
                sc_n, bar);
      bulk_load(smem_u32(buf + 2 * kv_bytes + sc_bytes),
                v_scale + row * n_heads - pre, sc_n, bar);
    }
  };
  if (h == n_heads) {  // the producer warp: one thread keeps the ring full
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        // a fresh stage passes at once (the phase before its first)
        mbar_wait(smem_u32(&empty[c % stages]), ((c / stages) & 1) ^ 1);
        issue(c);
      }
    }
    return;
  }

  const float* qh = q + (static_cast<size_t>(s) * n_heads + h) * head_dim;
  const int stride = n_heads * head_dim;  // elements of a pool row
  // a lane's pairs: elements at_e[i], at_e[i] + 1 of its head.  A lane
  // past head_dim reads the last pair instead (a real element, so the
  // loops need no guard) with q = 0, and its accumulator is never stored
  float2 qv[kLanePairs];
  float2 acc[kLanePairs];
  int at_e[kLanePairs];
#pragma unroll
  for (int i = 0; i < kLanePairs; ++i) {
    const int e = 64 * i + 2 * lane;
    at_e[i] = min(e, head_dim - 2);
    qv[i] = e < head_dim ? make_float2(qh[e], qh[e + 1])
                         : make_float2(0.f, 0.f);
    acc[i] = make_float2(0.f, 0.f);
  }
  float m = neg_inf();
  float l = 0.f;
  const int row_of_lane = lane & (kRows - 1);

  for (int c = 0; c < n_chunks; ++c) {
    int rows;
    const size_t row = chunk(c, rows);  // int8: where its scales start
    const unsigned char* buf =
        ring + static_cast<size_t>(c % stages) * stage_bytes;
    mbar_wait(smem_u32(&full[c % stages]), (c / stages) & 1);
    const T* kt = reinterpret_cast<const T*>(buf) + h * head_dim;
    const T* vt = reinterpret_cast<const T*>(buf + kv_bytes) + h * head_dim;
    // every row of the stage is read, unguarded, so that the loads can
    // all be in flight at once; rows past `rows` hold stale bytes, and
    // their dots stay in their own slots of the reduction and are masked
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kLanePairs; ++i) {
        const float2 kk = load_pair(kt + r * stride + at_e[i]);
        d = fmaf(qv[i].x, kk.x, d);
        d = fmaf(qv[i].y, kk.y, d);
      }
      part[r] = d;
    }
    float score = transpose_reduce<kRows>(part, lane);
    const bool live = row_of_lane < rows;
    float wv = 1.f;  // int8: the V scale folded into the weight
    if (kI8) {
      const int at = scale_pre(row) + row_of_lane * n_heads + h;
      score *= reinterpret_cast<const float*>(buf + 2 * kv_bytes)[at];
      wv = reinterpret_cast<const float*>(buf + 2 * kv_bytes + sc_bytes)[at];
    }
    score = live ? score * scale : neg_inf();
    const float m_new = fmaxf(m, group_max<kRows>(score));
    const float corr = expf(m - m_new);  // 0 on the first chunk
    float p = live ? expf(score - m_new) : 0.f;
    l = l * corr + group_sum<kRows>(p);
    p = live ? p * wv : 0.f;
#pragma unroll
    for (int i = 0; i < kLanePairs; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pr = __shfl_sync(0xffffffffu, p, r);  // 0 past `rows`
#pragma unroll
      for (int i = 0; i < kLanePairs; ++i) {
        float2 vv = load_pair(vt + r * stride + at_e[i]);
        if (!kI8 && r >= rows) vv = make_float2(0.f, 0.f);  // may be NaN
        acc[i].x = fmaf(pr, vv.x, acc[i].x);
        acc[i].y = fmaf(pr, vv.y, acc[i].y);
      }
    }
    m = m_new;
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[c % stages]));
  }

  float* oh = out + (static_cast<size_t>(s) * n_heads + h) * head_dim;
  if (n_parts == 1) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kLanePairs; ++i) {
      const int e = 64 * i + 2 * lane;
      if (e < head_dim) {
        *reinterpret_cast<float2*>(oh + e) =
            make_float2(acc[i].x * inv, acc[i].y * inv);
      }
    }
    return;
  }

  // this split's partial, then a ticket; the last CTA of the lane merges
  const size_t slot =
      (static_cast<size_t>(s) * n_splits + split) * n_heads + h;
#pragma unroll
  for (int i = 0; i < kLanePairs; ++i) {
    const int e = 64 * i + 2 * lane;
    if (e < head_dim) {
      *reinterpret_cast<float2*>(ws_acc + slot * head_dim + e) = acc[i];
    }
  }
  if (lane == 0) ws_ml[slot] = make_float2(m, l);
  __threadfence();
  consumers_sync(n_heads * 32);
  if (threadIdx.x == 0) last = atomicAdd(&tickets[s], 1) == n_parts - 1;
  consumers_sync(n_heads * 32);
  if (!last) return;
  __threadfence();
  // kCombine partials at a time: their loads all in flight together
  float mm = neg_inf();
  float ll = 0.f;
  float2 aa[kLanePairs];
#pragma unroll
  for (int i = 0; i < kLanePairs; ++i) aa[i] = make_float2(0.f, 0.f);
  const size_t first = static_cast<size_t>(s) * n_splits * n_heads + h;
  for (int g = 0; g < n_parts; g += kCombine) {
    float2 ml[kCombine];
    float2 a[kCombine][kLanePairs];
#pragma unroll
    for (int u = 0; u < kCombine; ++u) {
      const size_t at = first + static_cast<size_t>(g + u) * n_heads;
      const bool real = g + u < n_parts;
      ml[u] = real ? __ldcg(ws_ml + at) : make_float2(neg_inf(), 0.f);
#pragma unroll
      for (int i = 0; i < kLanePairs; ++i) {
        const int e = 64 * i + 2 * lane;
        a[u][i] = real && e < head_dim
                      ? __ldcg(reinterpret_cast<const float2*>(
                            ws_acc + at * head_dim + e))
                      : make_float2(0.f, 0.f);
      }
    }
    float m_new = mm;
#pragma unroll
    for (int u = 0; u < kCombine; ++u) m_new = fmaxf(m_new, ml[u].x);
    const float c_old = expf(mm - m_new);  // 0 for the first group
    ll *= c_old;
#pragma unroll
    for (int i = 0; i < kLanePairs; ++i) {
      aa[i].x *= c_old;
      aa[i].y *= c_old;
    }
#pragma unroll
    for (int u = 0; u < kCombine; ++u) {
      const float c = g + u < n_parts ? expf(ml[u].x - m_new) : 0.f;
      ll = fmaf(ml[u].y, c, ll);
#pragma unroll
      for (int i = 0; i < kLanePairs; ++i) {
        aa[i].x = fmaf(a[u][i].x, c, aa[i].x);
        aa[i].y = fmaf(a[u][i].y, c, aa[i].y);
      }
    }
    mm = m_new;
  }
  const float inv = 1.f / ll;
#pragma unroll
  for (int i = 0; i < kLanePairs; ++i) {
    const int e = 64 * i + 2 * lane;
    if (e < head_dim) {
      *reinterpret_cast<float2*>(oh + e) =
          make_float2(aa[i].x * inv, aa[i].y * inv);
    }
  }
  if (threadIdx.x == 0) tickets[s] = 0;  // ready for the next call
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

template <typename T, int kRows>
int launch_bulk_rows(const float* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* tables,
                     const int* lengths, float* out, float* ws, int* tickets,
                     int n_lanes, int n_heads, int head_dim, int n_table,
                     int block_size, float scale, int stages,
                     int blocks_per_split, int n_splits, size_t smem,
                     cudaStream_t stream) {
  auto kernel = head_dim <= 64 ? paged_decode_kernel_bulk<T, kRows, 1>
                               : paged_decode_kernel_bulk<T, kRows, 2>;
  if (smem > 48 * 1024) {  // above the default limit: opt in (per device)
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // workspace: (S, n_splits, H) float2 (m, l), then (S, n_splits, H, hd)
  float2* ws_ml = reinterpret_cast<float2*>(ws);
  float* ws_acc =
      ws == nullptr
          ? nullptr
          : ws + 2 * static_cast<size_t>(n_lanes) * n_splits * n_heads;
  const dim3 grid(n_splits, n_lanes);
  kernel<<<grid, (n_heads + 1) * 32, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, tables,
      lengths, out, ws_ml, ws_acc, tickets, n_heads, head_dim, n_table,
      block_size, scale, blocks_per_split, n_splits, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bulk(const float* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* tables, const int* lengths,
                float* out, float* ws, int* tickets, int n_lanes, int n_heads,
                int head_dim, int n_table, int block_size, float scale,
                int rows, int stages, int blocks_per_split, int n_splits,
                cudaStream_t stream) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  const size_t row_bytes = static_cast<size_t>(n_heads) * head_dim * sizeof(T);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (head_dim < 2 || head_dim > kMaxHeadDim || head_dim % 2 != 0 ||
      n_heads < 1 || n_heads > kBulkMaxHeads || row_bytes % 16 != 0 ||
      n_table < 1 || block_size < 1 || stages < 1 ||
      stages > kBulkMaxStages || blocks_per_split < 1 ||
      static_cast<long long>(n_splits) * blocks_per_split < n_table ||
      !aligned(k) || !aligned(v) || (kI8 && (!aligned(ks) || !aligned(vs))) ||
      (rows != 8 && rows != 16 && rows != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes == 0) return 0;
  const size_t smem =
      bulk_smem_bytes<T>(rows, n_heads, head_dim, stages, blocks_per_split);
  if (smem > kBulkSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto launcher = launch_bulk_rows<T, 32>;
  if (rows == 8) launcher = launch_bulk_rows<T, 8>;
  if (rows == 16) launcher = launch_bulk_rows<T, 16>;
  return launcher(q, k, v, ks, vs, tables, lengths, out, ws, tickets, n_lanes,
                  n_heads, head_dim, n_table, block_size, scale, stages,
                  blocks_per_split, n_splits, smem, stream);
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

// The bulk instance.  dtype: 0 float32, 1 bfloat16, 2 int8 (k_scale and
// v_scale only then; null otherwise).  ws: 2 * S * n_splits * H +
// S * n_splits * H * hd floats when n_splits > 1 (null otherwise);
// tickets: S ints, all 0, left 0.  rows: 8, 16 or 32 a stage.
int paged_decode_attention_bulk(int dtype, const float* q, const void* k,
                                const void* v, const float* k_scale,
                                const float* v_scale, const int* tables,
                                const int* lengths, float* out, float* ws,
                                int* tickets, int n_lanes, int n_heads,
                                int head_dim, int n_table, int block_size,
                                float scale, int rows, int stages,
                                int blocks_per_split, int n_splits,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bulk<float>(q, k, v, nullptr, nullptr, tables, lengths,
                                out, ws, tickets, n_lanes, n_heads, head_dim,
                                n_table, block_size, scale, rows, stages,
                                blocks_per_split, n_splits, st);
    case 1:
      return launch_bulk<__nv_bfloat16>(
          q, k, v, nullptr, nullptr, tables, lengths, out, ws, tickets,
          n_lanes, n_heads, head_dim, n_table, block_size, scale, rows,
          stages, blocks_per_split, n_splits, st);
    case 2:
      return launch_bulk<int8_t>(q, k, v, k_scale, v_scale, tables, lengths,
                                 out, ws, tickets, n_lanes, n_heads, head_dim,
                                 n_table, block_size, scale, rows, stages,
                                 blocks_per_split, n_splits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
