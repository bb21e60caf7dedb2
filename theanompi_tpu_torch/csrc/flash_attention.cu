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
// registers and shared memory.  Two instances:
//
// - bf16 with D <= 64 (the LM path): the products run on the tensor
//   cores (mma.sync m16n8k16, fp32 accumulation), 4 warps per CTA, each
//   warp owning 16 rows; see the section below.
// - fp32 (any D <= 128), and bf16 with 64 < D <= 128: fp32 FMAs on the
//   CUDA cores (SIMT).  256 threads (16 x 16, thread (ty, tx) owns rows
//   4ty..4ty+3 and columns 4tx..4tx+3 of a tile) keep a 4 x 4 tile of
//   scores and a 4 x (D/16) tile of the accumulator in registers and
//   read operands as float4 from fp32 shared-memory tiles laid out with
//   the reduction index first, so each pair of 16-byte loads feeds 16
//   FMAs.  D is padded with zeros to kD = 64 or 128.  Row statistics
//   reduce across the 16 threads of a half-warp with shuffles.
//
// Both use 64 x 64 tiles:
//   forward: one CTA per (bh, q tile); K tiles up to the diagonal when
//            causal (the TPU kernel's block skip), tails masked.
//   dQ:      one CTA per (bh, q tile), looping K tiles up to the diagonal.
//   dK/dV:   one CTA per (bh, k tile), looping Q tiles from the diagonal.
// Neither backward kernel needs atomics: each writes only its own tile.
// Later work: cp.async/TMA staging overlapped with the products, wgmma,
// and the tensor cores for D up to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

constexpr size_t kFwdMmaSmem = 3 * kTileH;
constexpr size_t kDqMmaSmem = 2 * kTileH;
constexpr size_t kDkvMmaSmem = 2 * kTileH + 2 * kTile * sizeof(float);

// 16-byte tile loads: rows of exactly 64 bf16 from 16-byte aligned bases.
int vec_ok(int d, std::initializer_list<const void*> ptrs) {
  if (d != 64) return 0;
  for (const void* p : ptrs) {
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return 0;
  }
  return 1;
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

// bf16 with D <= 64 (the LM path) runs on the tensor cores; fp32, and
// bf16 with D in (64, 128], on the CUDA cores.
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

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
