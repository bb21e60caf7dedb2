// Flash attention, forward and FlashAttention-2 backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of theanompi_tpu/ops/pallas_flash.py:
// `_fwd_kernel` (launched by `_flash_forward`), `_dq_kernel` and
// `_dkv_kernel` (launched by `flash_backward_rows`).  Operands are
// contiguous rows (BH, T, D), fp32 or bf16; statistics and every sum are
// fp32.  With S = Q K^T * scale (masked to -1e30 where a key is past the
// query when causal, or past T):
//
//   forward: out = softmax(S) V by the online-softmax recurrence, and
//            lse = m + log(den) per row (fp32)
//   dQ:      P = exp(S - lse), dS = P o (dO V^T - delta) * scale,
//            dQ = dS K
//   dK/dV:   dV = P^T dO, dK = dS^T Q
//
// where delta = rowsum(dO o out) comes from the caller.  P is recomputed,
// never stored, and is not rounded to the input dtype before it
// multiplies V and dO: in fp32 on the CUDA cores, as the TPU kernels do,
// and as two bf16 terms (16 significant bits) on the tensor cores.
// Masked probabilities are set to 0 after the exp, so a row whose scores
// are all masked in one tile adds nothing and gives no NaN.
//
// What bounds it on this card: operations.  At T = 1024, D = 64 the
// forward does about 4 T^2 D / 2 multiply-adds per (batch, head) row
// (causal) against 4 T D elements moved, some 250 flops a byte in bf16;
// the backward 2.5 times as many flops.  The least time is the products
// at the tensor cores' rate (bf16) or the fp32 rate.  What the design
// does: every Q, K, V, dO element is read from device memory once per
// tile pass and staged in shared memory; the T x T scores never leave
// registers and shared memory.  Three instances:
//
// - the bf16 forward with D <= 64 and D a multiple of 8 (the LM path):
//   wgmma on the tensor cores fed by a TMA ring, 128 query rows per CTA;
//   see its section below.  Bound at the LM's shape (BH 64, T 1024,
//   D 64, causal): 33.5 MB at 3.35 TB/s, 0.0101 ms, against 8.6 GFLOP
//   of products at 989 TFLOP/s, 0.0087 ms.
// - the other bf16 kernels with D <= 64 (dQ, dK/dV, and the forward
//   where TMA cannot describe the rows: D not a multiple of 8, or a base
//   off 16 bytes): the products run on the tensor cores (mma.sync
//   m16n8k16, fp32 accumulation), 4 warps per CTA, each warp owning 16
//   rows; see the section below.
// - fp32 (any D <= 128), and bf16 with 64 < D <= 128: fp32 FMAs on the
//   CUDA cores (SIMT).  256 threads (16 x 16, thread (ty, tx) owns rows
//   4ty..4ty+3 and columns 4tx..4tx+3 of a tile) keep a 4 x 4 tile of
//   scores and a 4 x (D/16) tile of the accumulator in registers and
//   read operands as float4 from fp32 shared-memory tiles laid out with
//   the reduction index first, so each pair of 16-byte loads feeds 16
//   FMAs.  D is padded with zeros to kD = 64 or 128.  Row statistics
//   reduce across the 16 threads of a half-warp with shuffles.
//
// The mma.sync and SIMT instances use 64 x 64 tiles:
//   forward: one CTA per (bh, q tile); K tiles up to the diagonal when
//            causal (the TPU kernel's block skip), tails masked.
//   dQ:      one CTA per (bh, q tile), looping K tiles up to the diagonal.
//   dK/dV:   one CTA per (bh, k tile), looping Q tiles from the diagonal.
// Neither backward kernel needs atomics: each writes only its own tile.
// Later work: the backward on wgmma with TMA, and the tensor cores for D
// up to 128.

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kLd = kTile + 4;  // transposed tiles [d][row]: 16-byte rows
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows [row0, row0 + 64) of a (t, d) matrix into shared memory as fp32,
// transposed: dst[c * kLd + r].  Rows >= t and columns >= d are zero.
template <typename T, int kD>
__device__ void load_t(float* dst, const T* src, int row0, int t, int d) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const int row = row0 + r;
    dst[c * kLd + r] = (row < t && c < d)
                           ? to_float(src[static_cast<size_t>(row) * d + c])
                           : 0.f;
  }
}

// The same rows, row-major: dst[r * (kD + 4) + c].
template <typename T, int kD>
__device__ void load_r(float* dst, const T* src, int row0, int t, int d) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const int row = row0 + r;
    dst[r * (kD + 4) + c] =
        (row < t && c < d) ? to_float(src[static_cast<size_t>(row) * d + c])
                           : 0.f;
  }
}

// acc[i][j] += sum_k a[k * kLd + 4ty + i] * b[k * kLd + 4tx + j],
// k < n: a 4 x 4 tile of A^T B over transposed tiles.
__device__ __forceinline__ void tile_tt(float acc[4][4], const float* a,
                                        const float* b, int n, int ty,
                                        int tx) {
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const float4 av = ld4(a + k * kLd + 4 * ty);
    const float4 bv = ld4(b + k * kLd + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += at(av, i) * at(bv, j);
    }
  }
}

// acc[i][4m + j] += sum_k p[k * kLd + 4ty + i] * r[k * (kD+4) + 64m + 4tx + j]
// over k < 64: a 4 x kD/16 tile of P^T R, R row-major.
template <int kD>
__device__ __forceinline__ void tile_tr(float acc[4][kD / 16],
                                        const float* p, const float* r,
                                        int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 av = ld4(p + k * kLd + 4 * ty);
#pragma unroll
    for (int m = 0; m < kD / 64; ++m) {
      const float4 bv = ld4(r + k * (kD + 4) + 64 * m + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * m + j] += at(av, i) * at(bv, j);
      }
    }
  }
}

// Max / sum over the 16 lanes of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Write a 4 x 4 register tile v[i][j] (rows 4ty+i, columns 4tx+j of a
// tile) transposed into shared memory: dst[(4tx + j) * kLd + 4ty + i].
__device__ __forceinline__ void store_t(float* dst, const float v[4][4],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st4(dst + (4 * tx + j) * kLd + 4 * ty, v[0][j], v[1][j], v[2][j],
        v[3][j]);
  }
}

template <typename T, int kD>
__device__ __forceinline__ void store_rows(T* dst, const float acc[4][kD / 16],
                                           int row0, int t, int d, int ty,
                                           int tx, const float* inv) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= t) continue;
#pragma unroll
    for (int m = 0; m < kD / 64; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 64 * m + 4 * tx + j;
        if (c < d) {
          const float v = inv ? acc[i][4 * m + j] / inv[i] : acc[i][4 * m + j];
          dst[static_cast<size_t>(row) * d + c] = from_float<T>(v);
        }
      }
    }
  }
}

// Number of 64-key tiles a 64-row query tile starting at q0 attends to.
__device__ __forceinline__ int key_tiles(int q0, int t, int causal) {
  const int n = (t + kTile - 1) / kTile;
  return causal ? min(n, q0 / kTile + 1) : n;
}

template <int kD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kD * kLd + kTile * (kD + 4) + kTile * kLd);
}
template <int kD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kD * kLd + kTile * (kD + 4) + kTile * kLd);
}
template <int kD>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * kD * kLd + 2 * kTile * (kD + 4) + kTile * kLd + 2 * kTile);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int t, int d, int causal,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // Q tile, transposed
  float* kt = qt + kD * kLd;          // K tile, transposed
  float* vr = kt + kD * kLd;          // V tile, row-major
  float* pt = vr + kTile * (kD + 4);  // P tile, transposed
  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_t<T, kD>(qt, q + base, q0, t, d);

  float m[4], den[4], acc[4][kD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) acc[i][j] = 0.f;
  }
  const int nk = key_tiles(q0, t, causal);
  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * kTile;
    __syncthreads();  // the last tile's readers are done
    load_t<T, kD>(kt, k + base, k0, t, d);
    load_r<T, kD>(vr, v + base, k0, t, d);
    __syncthreads();
    float s[4][4] = {};
    tile_tt(s, qt, kt, kD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        ok[j] = kj < t && (!causal || qi >= kj);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      den[i] = den[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kD / 16; ++j) acc[i][j] *= corr;
    }
    store_t(pt, s, ty, tx);
    __syncthreads();
    tile_tr<kD>(acc, pt, vr, ty, tx);
  }
  store_rows<T, kD>(out + base, acc, q0, t, d, ty, tx, den);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row < t) lse[static_cast<size_t>(blockIdx.x) * t + row] =
          m[i] + logf(den[i]);
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int t, int d, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // Q tile, transposed
  float* dot = qt + kD * kLd;         // dO tile, transposed
  float* kt = dot + kD * kLd;         // K tile, transposed
  float* vt = kt + kD * kLd;          // V tile, transposed
  float* kr = vt + kD * kLd;          // K tile, row-major
  float* dst = kr + kTile * (kD + 4);  // dS tile, transposed
  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const size_t sbase = static_cast<size_t>(blockIdx.x) * t;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_t<T, kD>(qt, q + base, q0, t, d);
  load_t<T, kD>(dot, dout + base, q0, t, d);
  float l[4], dl[4], acc[4][kD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    l[i] = row < t ? lse[sbase + row] : 0.f;
    dl[i] = row < t ? delta[sbase + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) acc[i][j] = 0.f;
  }
  const int nk = key_tiles(q0, t, causal);
  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * kTile;
    __syncthreads();
    load_t<T, kD>(kt, k + base, k0, t, d);
    load_t<T, kD>(vt, v + base, k0, t, d);
    load_r<T, kD>(kr, k + base, k0, t, d);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_tt(s, qt, kt, kD, ty, tx);
    tile_tt(dp, dot, vt, kD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        const bool ok = kj < t && (!causal || qi >= kj);
        const float p = ok ? expf(s[i][j] * scale - l[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    store_t(dst, s, ty, tx);
    __syncthreads();
    tile_tr<kD>(acc, dst, kr, ty, tx);
  }
  store_rows<T, kD>(dq + base, acc, q0, t, d, ty, tx, nullptr);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int d, int causal,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // K tile, transposed (resident)
  float* vt = kt + kD * kLd;            // V tile, transposed (resident)
  float* qt = vt + kD * kLd;            // Q tile, transposed
  float* dot = qt + kD * kLd;           // dO tile, transposed
  float* qr = dot + kD * kLd;           // Q tile, row-major
  float* dor = qr + kTile * (kD + 4);   // dO tile, row-major
  float* ps = dor + kTile * (kD + 4);   // P, then dS: [query][key]
  float* ls = ps + kTile * kLd;         // lse of the Q tile
  float* dls = ls + kTile;              // delta of the Q tile
  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const size_t sbase = static_cast<size_t>(blockIdx.x) * t;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_t<T, kD>(kt, k + base, k0, t, d);
  load_t<T, kD>(vt, v + base, k0, t, d);
  float gk[4][kD / 16], gv[4][kD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) gk[i][j] = gv[i][j] = 0.f;
  }
  const int nq = (t + kTile - 1) / kTile;
  for (int qc = causal ? blockIdx.y : 0; qc < nq; ++qc) {
    const int q0 = qc * kTile;
    __syncthreads();
    load_t<T, kD>(qt, q + base, q0, t, d);
    load_t<T, kD>(dot, dout + base, q0, t, d);
    load_r<T, kD>(qr, q + base, q0, t, d);
    load_r<T, kD>(dor, dout + base, q0, t, d);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      ls[r] = q0 + r < t ? lse[sbase + q0 + r] : 0.f;
      dls[r] = q0 + r < t ? delta[sbase + q0 + r] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are keys 4ty+i, columns queries 4tx+j
    float st[4][4] = {}, dpt[4][4] = {};
    tile_tt(st, kt, qt, kD, ty, tx);
    tile_tt(dpt, vt, dot, kD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + 4 * tx + j;
        const bool ok = qi < t && kj < t && (!causal || qi >= kj);
        const float p = ok ? expf(st[i][j] * scale - ls[4 * tx + j]) : 0.f;
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - dls[4 * tx + j]) * scale;
      }
    }
    store_t(ps, st, ty, tx);  // ps[query][key] = P
    __syncthreads();
    tile_tr<kD>(gv, ps, dor, ty, tx);
    __syncthreads();
    store_t(ps, dpt, ty, tx);  // ps[query][key] = dS
    __syncthreads();
    tile_tr<kD>(gk, ps, qr, ty, tx);
  }
  store_rows<T, kD>(dk + base, gk, k0, t, d, ty, tx, nullptr);
  store_rows<T, kD>(dv + base, gv, k0, t, d, ty, tx, nullptr);
}

// ---------------------------------------------------------------------------
// bf16 instances for D <= 64 on the tensor cores (mma.sync m16n8k16,
// fp32 accumulation).  Products of bf16 operands are exact in fp32, so
// Q K^T and dO V^T differ from the fp32 FMA path only in summation
// order.  P and dS are fp32: each is split into two bf16 terms
// (hi = bf16(x), lo = bf16(x - hi), |x - hi - lo| <= 2^-16 |x|) and
// multiplies its bf16 partner in two products, so it is not rounded to
// bf16 as a single product would round it.  4 warps per CTA; each warp
// owns 16 rows of the CTA's tile (queries in the forward and dQ, keys in
// dK/dV) and loops the other operand's 64-row tiles through shared
// memory, stored row-major as bf16 with 8 columns of padding
// (conflict-free fragment loads; `ldmatrix.trans` gives the fragments
// of the tiles that enter a product transposed).  Tiles are filled with
// 16-byte loads when D = 64 and the rows are 16-byte aligned.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kLdh = 64 + 8;  // bf16 tile row: 64 values + 16 bytes of pad

__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> the bf16 pairs hi and lo with x ~= hi.x + lo.x, y likewise.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = pack2(h);
  lo = pack2(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 64) of a (t, d <= 64) bf16 matrix into a row-major
// bf16 tile dst[r * kLdh + c]; rows >= t and columns >= d are zero.
// `vec`: d == 64 and src 16-byte aligned, so each row is 8 uint4.
__device__ void load_h(__nv_bfloat16* dst, const __nv_bfloat16* src,
                       int row0, int t, int d, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kTile * 8; i += kMmaThreads) {
      const int r = i / 8, c = 8 * (i % 8);
      const int row = row0 + r;
      const uint4 v = row < t ? *reinterpret_cast<const uint4*>(
                                    src + static_cast<size_t>(row) * 64 + c)
                              : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dst + r * kLdh + c) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < kTile * 64; i += kMmaThreads) {
    const int r = i / 64, c = i % 64;
    const int row = row0 + r;
    dst[r * kLdh + c] = (row < t && c < d)
                            ? src[static_cast<size_t>(row) * d + c]
                            : __float2bfloat16(0.f);
  }
}

// B fragments (b0: k rows 0..7, b1: rows 8..15 from `p`'s row) of a
// row-major [k][n] tile, 8 columns from p: ldmatrix, transposed.
__device__ __forceinline__ void ldsm_t(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// A fragments (16 rows from r0, all 64 columns) of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t a[4][4],
                                       const __nv_bfloat16* tile, int r0,
                                       int g, int tg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p = tile + (r0 + g) * kLdh + 16 * kk + 2 * tg;
    a[kk][0] = ld2(p);
    a[kk][1] = ld2(p + 8 * kLdh);
    a[kk][2] = ld2(p + 8);
    a[kk][3] = ld2(p + 8 * kLdh + 8);
  }
}

// c[j] += A (16 x 64, fragments a) times B, where B[k][n] = tile[n][k]
// for the 64 columns n of a row-major tile (n-tile j = columns 8j..8j+7).
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[4][4],
                                        const __nv_bfloat16* tile, int g,
                                        int tg) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* p = tile + (8 * j + g) * kLdh + 16 * kk + 2 * tg;
      mma16816(c[j], a[kk], ld2(p), ld2(p + 8));
    }
  }
}

// acc[n] += X (16 x 64 fp32, held as the C fragments x of mma_abt) times
// the row-major tile (B[k][n] = tile[k][n]); X is split into two bf16
// terms.
__device__ __forceinline__ void mma_xb(float acc[8][4], const float x[8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t b0, b1;
      ldsm_t(b0, b1, tile + (16 * kk + (lane & 15)) * kLdh + 8 * n);
      mma16816(acc[n], hi, b0, b1);
      mma16816(acc[n], lo, b0, b1);
    }
  }
}

// Write a warp's 16 x 64 fp32 fragments (rows r0 + g, r0 + g + 8) as
// bf16 rows of a (t, d) matrix, each divided by inv[0 or 1] when given.
__device__ __forceinline__ void store_frag(__nv_bfloat16* dst,
                                           const float acc[8][4], int r0,
                                           int t, int d, int g, int tg,
                                           const float* inv) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e < 2 ? 0 : 8);
      const int c = 8 * n + 2 * tg + (e & 1);
      if (row < t && c < d) {
        const float v = inv ? acc[n][e] / inv[e >> 1] : acc[n][e];
        dst[static_cast<size_t>(row) * d + c] = __float2bfloat16(v);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}

constexpr size_t kTileH = sizeof(__nv_bfloat16) * kTile * kLdh;

__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int t, int d, int causal,
                         float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // Q
  __nv_bfloat16* ks = qs + kTile * kLdh;               // K
  __nv_bfloat16* vs = ks + kTile * kLdh;               // V
  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4, r0 = 16 * warp;
  load_h(qs, q + base, q0, t, d, vec);
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, qs, r0, g, tg);
  float m[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f}, acc[8][4] = {};
  const int nk = key_tiles(q0, t, causal);
  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * kTile;
    __syncthreads();
    load_h(ks, k + base, k0, t, d, vec);
    load_h(vs, v + base, k0, t, d, vec);
    __syncthreads();
    float s[8][4] = {};
    mma_abt(s, qa, ks, g, tg);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + r0 + g + (e < 2 ? 0 : 8);
        const int kj = k0 + 8 * j + 2 * tg + (e & 1);
        const bool ok = kj < t && (!causal || qi >= kj);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores are -1e30: zero them after the exp, as the
        // row's first tiles may leave m at -1e30 too
        const float p =
            s[j][e] > 0.5f * kNegInf ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) den[h] = den[h] * corr[h] + quad_sum(ps[h]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
    mma_xb(acc, s, vs, lane);
  }
  store_frag(out + base, acc, q0 + r0, t, d, g, tg, den);
  if (tg == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + g + 8 * h;
      if (row < t) lse[static_cast<size_t>(blockIdx.x) * t + row] =
          m[h] + logf(den[h]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_kernel_mma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int t, int d,
                        int causal, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // K
  __nv_bfloat16* vs = ks + kTile * kLdh;               // V
  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const size_t sbase = static_cast<size_t>(blockIdx.x) * t;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4, r0 = 16 * warp;
  // Q and dO pass through the K and V buffers into registers
  load_h(ks, q + base, q0, t, d, vec);
  load_h(vs, dout + base, q0, t, d, vec);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, ks, r0, g, tg);
  load_a(da, vs, r0, g, tg);
  float l[2], dl[2], acc[8][4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    l[h] = row < t ? lse[sbase + row] : 0.f;
    dl[h] = row < t ? delta[sbase + row] : 0.f;
  }
  const int nk = key_tiles(q0, t, causal);
  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * kTile;
    __syncthreads();
    load_h(ks, k + base, k0, t, d, vec);
    load_h(vs, v + base, k0, t, d, vec);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    mma_abt(s, qa, ks, g, tg);
    mma_abt(dp, da, vs, g, tg);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + r0 + g + (e < 2 ? 0 : 8);
        const int kj = k0 + 8 * j + 2 * tg + (e & 1);
        const bool ok = kj < t && (!causal || qi >= kj);
        const float p = ok ? expf(s[j][e] * scale - l[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
      }
    }
    mma_xb(acc, s, ks, lane);
  }
  store_frag(dq + base, acc, q0 + r0, t, d, g, tg, nullptr);
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_kernel_mma(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int t, int d,
                         int causal, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // Q
  __nv_bfloat16* dos = qs + kTile * kLdh;              // dO
  float* ls = reinterpret_cast<float*>(dos + kTile * kLdh);
  float* dls = ls + kTile;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const size_t sbase = static_cast<size_t>(blockIdx.x) * t;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4, r0 = 16 * warp;
  // K and V pass through the Q and dO buffers into registers
  load_h(qs, k + base, k0, t, d, vec);
  load_h(dos, v + base, k0, t, d, vec);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a(ka, qs, r0, g, tg);
  load_a(va, dos, r0, g, tg);
  float gk[8][4] = {}, gv[8][4] = {};
  const int nq = (t + kTile - 1) / kTile;
  for (int qc = causal ? blockIdx.y : 0; qc < nq; ++qc) {
    const int q0 = qc * kTile;
    __syncthreads();
    load_h(qs, q + base, q0, t, d, vec);
    load_h(dos, dout + base, q0, t, d, vec);
    for (int r = threadIdx.x; r < kTile; r += kMmaThreads) {
      ls[r] = q0 + r < t ? lse[sbase + q0 + r] : 0.f;
      dls[r] = q0 + r < t ? delta[sbase + q0 + r] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's 16 keys, columns queries
    float st[8][4] = {}, dpt[8][4] = {};
    mma_abt(st, ka, qs, g, tg);
    mma_abt(dpt, va, dos, g, tg);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + r0 + g + (e < 2 ? 0 : 8);
        const int ql = 8 * j + 2 * tg + (e & 1);
        const int qi = q0 + ql;
        const bool ok = qi < t && kj < t && (!causal || qi >= kj);
        const float p = ok ? expf(st[j][e] * scale - ls[ql]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dls[ql]) * scale;
      }
    }
    mma_xb(gv, st, dos, lane);
    mma_xb(gk, dpt, qs, lane);
  }
  store_frag(dk + base, gk, k0 + r0, t, d, g, tg, nullptr);
  store_frag(dv + base, gv, k0 + r0, t, d, g, tg, nullptr);
}

// ---------------------------------------------------------------------------
// The bf16 forward for D <= 64 with D a multiple of 8 (the LM path):
// wgmma fed by a TMA ring, in a persistent grid.  A work item is 128
// query rows of one (batch, head) row; one CTA per SM walks its items
// (`tma_item`) with 384 threads: two consumer warpgroups, each owning
// 64 of an item's rows, and a producer warpgroup that gives its
// registers to them (setmaxnreg: 24 against 240 a thread).  One thread
// of the producer loads each item's Q tile (two slots, so the next
// item's Q lands while the last item still reads its own), and K and V
// tiles of 128 keys x 64 columns into a ring of kTmaStages stages, with
// cp.async.bulk.tensor (TMA), running ahead across items: "full"
// mbarriers count the copies' bytes in, "empty" ones count the 256
// consumer threads out.  The tensor maps describe the rows (BH, T, D)
// in 3-D with boxes of 64 columns, so rows past T and columns past D
// arrive as zeros: a ragged tile needs only the mask below, and D < 64
// runs as D = 64 with zero columns.  Tiles land with the 128-byte
// swizzle that the wgmma shared-memory descriptors read.  Per K/V tile
// a consumer warpgroup computes
//   S = Q K^T   4 x wgmma m64n128k16, both operands in shared memory;
//   softmax     in registers (`softmax_exp`, `softmax_split`): exp2 on
//               the SFU of the scores times scale * log2(e), row max and
//               sum over the quad of threads that holds a row; the mask
//               only on the diagonal tile (causal) and the ragged last
//               tile, masked probabilities zeroed after the exp;
//   O += P V    8 k-steps x 2 wgmma m64n64k16 with A from registers (the
//               S accumulator's layout is the A fragment's): P as its
//               bf16 hi and lo terms, V read MN-major (transposed).
// A warpgroup's tiles form one stream across its items: the exps of one
// tile overlap the P V of the tile before, an item's output store
// overlaps the next item's first S, and the two warpgroups take the
// tensor cores in turn.  The epilogue multiplies by 1/den, rounds to
// bf16, writes the warpgroup's 64 rows into its half of an output tile
// (swizzled, conflict-free 4-byte stores) and sends them out with one
// TMA store, which clips rows past T and columns past D; lse goes out
// per row in fp32.  Shared memory: two Q tiles, the output tile and the
// ring, 177 KB.
// ---------------------------------------------------------------------------

constexpr int kTmaRows = 128;         // query rows per CTA; keys per K/V tile
constexpr int kTmaStages = 4;         // K/V ring depth
constexpr int kTmaThreads = 384;      // 2 consumer + 1 producer warpgroups
constexpr int kTmaConsumers = 256;
constexpr uint32_t kTmaTile = 128 * 128;  // 128 rows x 64 bf16 = 16 KB
constexpr uint32_t kTmaHalf = kTmaTile / 2;  // one warpgroup's 64 rows
// two Q tiles, the output tile and kTmaStages (K, V) pairs, plus slack
// to align the tiles to 1024 bytes (the period of the 128-byte swizzle)
constexpr size_t kTmaSmem = 1024 + (3 + 2 * kTmaStages) * kTmaTile;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// rows [row, row + box) of head row `bh` into shared memory at dst,
// completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(bh)
      : "memory");
}

// shared memory at src to rows [row, row + box) of head row `bh`, as
// one bulk group of this thread
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(row), "r"(bh)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wgmma descriptor of a tile of 128-byte rows written with the 128-byte
// swizzle: start address, then 1024 bytes (one 8-row group) as both the
// stride and the leading byte offset (the K-major tiles ignore the
// latter; the MN-major V tile is one 64-column atom wide), in 16-byte
// units; swizzle mode 1 (128 B).  A k-step inside the tile moves the
// start address: 32 bytes along a K-major row, 16 rows down V.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most n groups of this warpgroup's wgmma are pending
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(n) : "memory");
}

// Registers an asynchronous wgmma reads or writes stay put until after
// its wait: the compiler may not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// named barrier `id` over `n` threads: wait, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// (x, y) -> bf16 pairs hi and lo with x ~= hi.x + lo.x, y likewise: hi
// truncates (a byte permute, no conversion), lo = bf16(x - hi) rounds;
// |x - hi - lo| <= 2^-16 |x|, the bound of split2 at half its
// conversions.
__device__ __forceinline__ void split2_trunc(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = pack2(__floats2bfloat162_rn(x - __uint_as_float(xb & 0xffff0000u),
                                   y - __uint_as_float(yb & 0xffff0000u)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128) (+)= A (64 x 16) B (16 x 128), bf16 operands read from
// shared memory through descriptors, both K-major, fp32 accumulators;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers, the m16n8k16 A
// fragment of each warp's 16 rows) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The online softmax of one K/V tile in a consumer warpgroup, in
// registers, in two parts.  sc[4j + e] holds S for row r + 8 (e >> 1)
// and key k0 + 8j + 2tg + (e & 1).
//
// Part 1 (while the last tile's P V still runs): mask S where a key is
// past t or, causal, past the row (kEdge: only the ragged last tile and
// the diagonal one have such keys), take the row max m (units of log2)
// over the quad of threads that holds a row, turn S into P = exp2(S *
// scale * log2(e) - m) in place (exp2 on the SFU; with kPos, scale > 0,
// the max of the raw scores gives m and each exponent is one FMA), zero
// masked probabilities after the exp (a row's first tiles may leave m
// at -1e30 too), add the row sums into den, and return corr, the factor
// that rescales the output of the tiles before.
template <bool kEdge, bool kPos>
__device__ __forceinline__ void softmax_exp(float (&sc)[64], float (&m)[2],
                                            float (&den)[2], float (&corr)[2],
                                            int r, int tg, int k0, int t,
                                            int causal, float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kPos ? sc[4 * j + e] : sc[4 * j + e] * scale_log2;
      if (kEdge) {
        const int qi = r + 8 * (e >> 1), kj = k0 + 8 * j + 2 * tg + (e & 1);
        if (kj >= t || (causal && kj > qi)) x = kNegInf;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float row_max = quad_max(mx[h]);
    const float m_new = fmaxf(m[h], kPos ? row_max * scale_log2 : row_max);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 64; ++n) {
    const float x = sc[n], mh = m[(n >> 1) & 1];
    float p = ex2(kPos ? fmaf(x, scale_log2, -mh) : x - mh);
    if (kEdge && !(x > 0.5f * kNegInf)) p = 0.f;
    sc[n] = p;
    ps[(n >> 1) & 1] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = den[h] * corr[h] + quad_sum(ps[h]);
}

// Part 2 (once the last tile's P V is done): rescale the output, and
// split P into the A fragments of P V: for k-step kk (keys 16kk..16kk+15)
// the hi terms pa[8kk..8kk+3] and the lo terms pa[8kk+4..8kk+7].
__device__ __forceinline__ void softmax_split(const float (&sc)[64],
                                              float (&acc)[32],
                                              uint32_t (&pa)[64],
                                              const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < 32; ++n) acc[n] *= corr[(n >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      split2_trunc(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1],
                   pa[8 * kk + f], pa[8 * kk + 4 + f]);
    }
  }
}

// Item k (k = 0, 1, ...) of CTA c in a grid of g CTAs: the CTAs take
// the items in rounds of g, forwards in even rounds and backwards in odd
// ones (a snake), and item w is query tile n_q - 1 - w / bh of head row
// w % bh, so the longest causal rows go first and every CTA gets a mix
// of long and short ones.  Mirrors ops/flash.py `flash_fwd_schedule`.
__device__ __forceinline__ int tma_item(int k, int c, int g) {
  return k * g + (k % 2 == 0 ? c : g - 1 - c);
}

__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_kernel_tma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to,
                         float* __restrict__ lse, int bh, int t, int causal,
                         float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 + 2 * kTmaStages];
  unsigned char* tiles =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // two Q tiles (items alternate), the output tile, then stage s: K, V
  const uint32_t sq = smem_u32(tiles), so = sq + 2 * kTmaTile;
  const auto q_at = [&](int b) { return sq + kTmaTile * b; };
  const auto k_at = [&](int s) { return sq + kTmaTile * (3 + 2 * s); };
  const auto v_at = [&](int s) { return sq + kTmaTile * (4 + 2 * s); };
  const uint32_t bar0 = smem_u32(&bars[0]);
  const auto q_full = [&](int b) { return bar0 + 8u * b; };
  const auto q_empty = [&](int b) { return bar0 + 8u * (2 + b); };
  const auto full = [&](int s) { return bar0 + 8u * (4 + s); };
  const auto empty = [&](int s) {
    return bar0 + 8u * (4 + kTmaStages + s);
  };
  const int n_q = (t + kTmaRows - 1) / kTmaRows, n_items = bh * n_q;
  const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
  const int cta = blockIdx.x, n_cta = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this CTA's next item from round k on (rounds when there is none)
  const auto find = [&](int k) {
    while (k < rounds && tma_item(k, cta, n_cta) >= n_items) ++k;
    return k;
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), kTmaConsumers);
    }
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kTmaConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTmaConsumers / 32) {  // the producer warpgroup
    // registers to the consumers: 128 x 24 + 256 x 240 <= 64 K
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == kTmaConsumers / 32 && lane == 0) {
      int it = 0;  // K/V tiles loaded so far
      for (int k = find(0), n = 0; k < rounds; k = find(k + 1), ++n) {
        const int w = tma_item(k, cta, n_cta);
        const int qt = n_q - 1 - w / bh, row = w % bh;
        const int nk = causal ? min(n_q, qt + 1) : n_q;
        // item n's Q goes to slot n % 2, once item n - 2 is done with it
        if (n >= 2) mbar_wait(q_empty(n & 1), ((n >> 1) - 1) & 1);
        mbar_expect_tx(q_full(n & 1), kTmaTile);
        tma_load(q_at(n & 1), &tq, q_full(n & 1), qt * kTmaRows, row);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % kTmaStages;
          // the stage's previous tile (it - kTmaStages) has been consumed
          if (it >= kTmaStages) {
            mbar_wait(empty(s), ((it / kTmaStages) & 1) ^ 1);
          }
          mbar_expect_tx(full(s), 2 * kTmaTile);
          tma_load(k_at(s), &tk, full(s), i * kTmaRows, row);
          tma_load(v_at(s), &tv, full(s), i * kTmaRows, row);
        }
      }
    }
    return;
  }

  // The consumer warpgroups.  Warpgroup wg owns query rows
  // qt * 128 + 64 wg + [0, 64) of each item; this thread holds rows r
  // and r + 8 of the fragments.  The CTA's K/V tiles form one stream
  // across its items: the round of tile j issues S_j = Q K_j^T and
  // O += P_{j-1} V_{j-1} as two groups, takes the exps of S_j as soon as
  // S_j is done, while P_{j-1} V_{j-1} still runs, then (when tile j - 1
  // ended an item) stores that item's output, rescales O and splits P_j.
  // The two warpgroups take the tensor cores in turn (named barriers 3
  // and 4), so that one's exps, conversions and stores overlap the
  // other's products.  The first round has no P V and a last round only
  // P V; no product is issued under a condition (ptxas would serialize
  // them).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, tg = lane % 4;
  const uint32_t o_slot = so + kTmaHalf * wg;
  unsigned char* o_tile = tiles + 2 * kTmaTile + kTmaHalf * wg;
  const bool storer = wl == 0 && lane == 0;
  float sc[64];     // S, then P, of the newest tile
  uint32_t pa[64];  // P of the tile before, see `softmax_split`
  float acc[32];    // O of the item of the tile before
  float m[2], den[2], corr[2];
  struct Item {
    int qt, row, nk, row0, r;  // row0: this warpgroup's first query row
  };
  const auto item = [&](int k) {
    const int w = tma_item(k, cta, n_cta);
    Item x;
    x.qt = n_q - 1 - w / bh;
    x.row = w % bh;
    x.nk = causal ? min(n_q, x.qt + 1) : n_q;
    x.row0 = x.qt * kTmaRows + 64 * wg;
    x.r = x.row0 + 16 * wl + g;
    return x;
  };
  const auto issue_s = [&](int s, int b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_qk(sc, sw128_desc(q_at(b) + kTmaHalf * wg + 32 * kk),
               sw128_desc(k_at(s) + 32 * kk), kk);
    }
  };
  const auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = sw128_desc(v_at(s) + 2048 * kk);
      wgmma_pv(acc, pa + 8 * kk, dv);
      wgmma_pv(acc, pa + 8 * kk + 4, dv);
    }
  };
  // the exps of tile i of item x; keys past T, or past a row when
  // causal, exist only in the last tile and, when causal, the diagonal
  const auto exps = [&](const Item& x, int i) {
    const int k_end = (i + 1) * kTmaRows;
    const bool edge = k_end > t || (causal && k_end - 1 > x.row0);
    const int k0 = i * kTmaRows;
    if (scale_log2 > 0.f) {
      if (edge) {
        softmax_exp<true, true>(sc, m, den, corr, x.r, tg, k0, t, causal,
                                scale_log2);
      } else {
        softmax_exp<false, true>(sc, m, den, corr, x.r, tg, k0, t, causal,
                                 scale_log2);
      }
    } else if (edge) {
      softmax_exp<true, false>(sc, m, den, corr, x.r, tg, k0, t, causal,
                               scale_log2);
    } else {
      softmax_exp<false, false>(sc, m, den, corr, x.r, tg, k0, t, causal,
                                scale_log2);
    }
  };
  // acc[4j + e] is row r + 8 (e >> 1), column 8j + 2tg + (e & 1): out =
  // acc / den (acc times the fp32 reciprocal of den, within an ulp of
  // the quotient) in bf16 into the warpgroup's half of the output tile,
  // 16-byte chunk j of row rl at chunk j ^ (rl % 8) (the 128-byte
  // swizzle; rl % 8 = g), once the last item's store has read it; then
  // one TMA store, and lse = m ln 2 + log(den) per row
  const auto epilogue = [&](const Item& x, const float (&me)[2],
                            const float (&dene)[2]) {
    if (storer) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * wl + g + 8 * h;
      const float inv = 1.f / dene[h];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(o_tile + 128 * rl + 16 * (j ^ g) +
                                           4 * tg) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                  acc[4 * j + 2 * h + 1] * inv);
      }
    }
    // the generic-proxy stores, then the warpgroup, before the TMA store
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + wg, 128);
    if (storer && x.row0 < t) tma_store(&to, o_slot, x.row0, x.row);
    if (tg == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = x.r + 8 * h;
        if (qi < t) lse[static_cast<size_t>(x.row) * t + qi] =
            me[h] * kLn2 + logf(dene[h]);
      }
    }
  };

  // the first tile: S_0 only
  int kc = find(0), ic = 0, it = 0, n = 0;  // item round, tile, stream, item
  Item cur = item(kc);
  m[0] = m[1] = kNegInf;
  den[0] = den[1] = 0.f;
  if (wg == 1) bar_arrive(3, kTmaConsumers);  // warpgroup 0 goes first
  mbar_wait(q_full(0), 0);
  mbar_wait(full(0), 0);
  bar_sync(3 + wg, kTmaConsumers);  // this warpgroup's turn
  wgmma_fence();
  issue_s(0, 0);
  wgmma_commit();
  bar_arrive(4 - wg, kTmaConsumers);  // the other warpgroup's turn
  wgmma_wait<0>();
  pin(sc);
  if (cur.nk == 1) mbar_arrive(q_empty(0));  // this thread is done with Q
  exps(cur, 0);
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  softmax_split(sc, acc, pa, corr);
  while (true) {
    // the tile after tile ic of the current item
    int kn = kc, in = ic + 1, nn = n;
    if (in == cur.nk) {
      kn = find(kc + 1);
      in = 0;
      nn = n + 1;
    }
    const int sc_stage = it % kTmaStages;
    if (kn == rounds) {  // the last round: P V only
      bar_sync(3 + wg, kTmaConsumers);
      wgmma_fence();
      issue_pv(sc_stage);
      wgmma_commit();
      // warpgroup 1's last hand-over would have no taker
      if (wg == 0) bar_arrive(4, kTmaConsumers);
      wgmma_wait<0>();
      pin(acc);
      pin(pa);
      mbar_arrive(empty(sc_stage));
      epilogue(cur, m, den);
      break;
    }
    const Item nx = in == 0 ? item(kn) : cur;
    const int s = (it + 1) % kTmaStages;
    if (in == 0) mbar_wait(q_full(nn & 1), (nn >> 1) & 1);
    mbar_wait(full(s), ((it + 1) / kTmaStages) & 1);
    bar_sync(3 + wg, kTmaConsumers);
    wgmma_fence();
    issue_s(s, nn & 1);
    wgmma_commit();
    issue_pv(sc_stage);
    wgmma_commit();
    bar_arrive(4 - wg, kTmaConsumers);
    wgmma_wait<1>();  // S of the new tile is done
    pin(sc);
    if (in == nx.nk - 1) mbar_arrive(q_empty(nn & 1));
    const float m_done[2] = {m[0], m[1]}, den_done[2] = {den[0], den[1]};
    if (in == 0) {  // a new item: fresh statistics; corr comes out 0
      m[0] = m[1] = kNegInf;
      den[0] = den[1] = 0.f;
    }
    exps(nx, in);
    wgmma_wait<0>();  // P V of the tile before is done
    pin(acc);
    pin(pa);
    mbar_arrive(empty(sc_stage));  // this thread is done with that tile
    if (in == 0) epilogue(cur, m_done, den_done);
    softmax_split(sc, acc, pa, corr);
    cur = nx;
    kc = kn;
    ic = in;
    n = nn;
    ++it;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

constexpr size_t kFwdMmaSmem = 3 * kTileH;
constexpr size_t kDqMmaSmem = 2 * kTileH;
constexpr size_t kDkvMmaSmem = 2 * kTileH + 2 * kTile * sizeof(float);

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return false;
  }
  return true;
}

// 16-byte tile loads: rows of exactly 64 bf16 from 16-byte aligned bases.
int vec_ok(int d, std::initializer_list<const void*> ptrs) {
  return d == 64 && aligned16(ptrs);
}

int check(int bh, int t, int d) {
  if (bh < 0 || t < 1 || d < 1 || d > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int kD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int bh, int t, int d, int causal, float scale,
               cudaStream_t stream) {
  static const int opt = allow_smem(flash_fwd_kernel<T, kD>, fwd_smem<kD>());
  if (opt) return opt;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_fwd_kernel<T, kD><<<grid, kThreads, fwd_smem<kD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int t,
              int d, int causal, float scale, cudaStream_t stream) {
  static const int opt = allow_smem(flash_dq_kernel<T, kD>, dq_smem<kD>());
  if (opt) return opt;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_dq_kernel<T, kD><<<grid, kThreads, dq_smem<kD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int t, int d, int causal, float scale, cudaStream_t stream) {
  static const int opt =
      allow_smem(flash_dkv_kernel<T, kD>, dkv_smem<kD>());
  if (opt) return opt;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_dkv_kernel<T, kD><<<grid, kThreads, dkv_smem<kD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, d, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t, int d, int causal, float scale,
                   cudaStream_t stream) {
  static const int opt = allow_smem(flash_fwd_kernel_mma, kFwdMmaSmem);
  if (opt) return opt;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_fwd_kernel_mma<<<grid, kMmaThreads, kFwdMmaSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), t, d, causal, scale, vec_ok(d, {q, k, v}));
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int bh, int t, int d, int causal, float scale,
                  cudaStream_t stream) {
  static const int opt = allow_smem(flash_dq_kernel_mma, kDqMmaSmem);
  if (opt) return opt;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_dq_kernel_mma<<<grid, kMmaThreads, kDqMmaSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), t, d,
      causal, scale, vec_ok(d, {q, k, v, dout}));
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int t, int d, int causal,
                   float scale, cudaStream_t stream) {
  static const int opt = allow_smem(flash_dkv_kernel_mma, kDkvMmaSmem);
  if (opt) return opt;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_dkv_kernel_mma<<<grid, kMmaThreads, kDkvMmaSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t, d, causal, scale,
      vec_ok(d, {q, k, v, dout}));
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled is a driver function.  It is looked up in the
// driver library that the CUDA runtime has loaded, so this library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// bf16 rows (bh, t, d) as a 3-D tensor map with boxes of 64 columns x
// `rows` rows, 128-byte swizzle, zeros for what lies past t or d.
int rows_map(CUtensorMap* map, const void* base, int bh, int t, int d,
             int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// TMA reads rows whose byte stride (2d) is a multiple of 16 from bases
// aligned to 16 bytes; the wrapper sends nothing else here.
int launch_fwd_tma(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t, int d, int causal, float scale,
                   cudaStream_t stream) {
  if (d > 64 || d % 8 || !aligned16({q, k, v, out})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int opt = allow_smem(flash_fwd_kernel_tma, kTmaSmem);
  if (opt) return opt;
  CUtensorMap mq, mk, mv, mo;
  int rc = rows_map(&mq, q, bh, t, d, kTmaRows);
  if (rc == 0) rc = rows_map(&mk, k, bh, t, d, kTmaRows);
  if (rc == 0) rc = rows_map(&mv, v, bh, t, d, kTmaRows);
  if (rc == 0) rc = rows_map(&mo, out, bh, t, d, kTmaRows / 2);
  if (rc) return rc;
  // persistent: one CTA per SM (or per item, when there are fewer)
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long items = static_cast<long>(bh) * ((t + kTmaRows - 1) / kTmaRows);
  if (items > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_kernel_tma<<<grid, kTmaThreads, kTmaSmem, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), bh, t, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// bf16 with D <= 64 runs on the tensor cores (the forward here only
// where TMA cannot describe the rows: flash_fwd_bf16_tma takes the
// rest); fp32, and bf16 with D in (64, 128], on the CUDA cores.
template <typename T>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int bh, int t, int d, int causal, float scale, void* stream) {
  if (int rc = check(bh, t, d)) return rc;
  if (bh == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (d > 64) {
    return launch_fwd<T, 128>(q, k, v, out, lse, bh, t, d, causal, scale, s);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_fwd_mma(q, k, v, out, lse, bh, t, d, causal, scale, s);
  } else {
    return launch_fwd<T, 64>(q, k, v, out, lse, bh, t, d, causal, scale, s);
  }
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* g, int bh, int t, int d,
       int causal, float scale, void* stream) {
  if (int rc = check(bh, t, d)) return rc;
  if (bh == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (d > 64) {
    return launch_dq<T, 128>(q, k, v, dout, lse, delta, g, bh, t, d, causal,
                             scale, s);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_dq_mma(q, k, v, dout, lse, delta, g, bh, t, d, causal,
                         scale, s);
  } else {
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, g, bh, t, d, causal,
                            scale, s);
  }
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* gk, void* gv, int bh, int t,
        int d, int causal, float scale, void* stream) {
  if (int rc = check(bh, t, d)) return rc;
  if (bh == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (d > 64) {
    return launch_dkv<T, 128>(q, k, v, dout, lse, delta, gk, gv, bh, t, d,
                              causal, scale, s);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_dkv_mma(q, k, v, dout, lse, delta, gk, gv, bh, t, d, causal,
                          scale, s);
  } else {
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, gk, gv, bh, t, d,
                             causal, scale, s);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after
// the launch (0 = launched); the caller raises on anything else.
extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                  void* lse, int bh, int t, int d, int causal, float scale,
                  void* stream) {
  return fwd<float>(q, k, v, out, lse, bh, t, d, causal, scale, stream);
}

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t, int d, int causal, float scale,
                   void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, out, lse, bh, t, d, causal, scale,
                            stream);
}

int flash_dq_f32(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* g, int bh, int t, int d, int causal, float scale,
                 void* stream) {
  return dq<float>(q, k, v, dout, lse, delta, g, bh, t, d, causal, scale,
                   stream);
}

int flash_dq_bf16(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* g, int bh, int t, int d, int causal, float scale,
                  void* stream) {
  return dq<__nv_bfloat16>(q, k, v, dout, lse, delta, g, bh, t, d, causal,
                           scale, stream);
}

int flash_dkv_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* gk, void* gv, int bh, int t, int d, int causal,
                  float scale, void* stream) {
  return dkv<float>(q, k, v, dout, lse, delta, gk, gv, bh, t, d, causal,
                    scale, stream);
}

int flash_dkv_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* gk, void* gv, int bh, int t, int d, int causal,
                   float scale, void* stream) {
  return dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, gk, gv, bh, t, d,
                            causal, scale, stream);
}

// bf16, D <= 64 and a multiple of 8, q/k/v/out 16-byte aligned: the
// wgmma forward fed by TMA (the wrapper sends only such operands here)
int flash_fwd_bf16_tma(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int t, int d, int causal,
                       float scale, void* stream) {
  if (int rc = check(bh, t, d)) return rc;
  if (bh == 0) return 0;
  return launch_fwd_tma(q, k, v, out, lse, bh, t, d, causal, scale,
                        static_cast<cudaStream_t>(stream));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
