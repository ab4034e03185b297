// Tile machinery shared by the edge-block forward (edge_block_fwd.cu) and
// backward (edge_block_bwd.cu) on Hopper tensor cores (sm_90a).
//
// Both kernels walk tiles of T = 128 / K whole receivers (T*K <= 128 edge
// rows, K <= 128) with a block of 8 warps; warp w owns the tile's rows
// 16w..16w+15 and all 64 (padded) columns, so a row sits in one lane quad.
// Both compute h, a = relu(h) and o with `recompute_tile` below: the same
// tensor-core instructions in the same order, so the forward and the
// backward take the same ReLU gate and, in bf16, the same rounding of a,
// bit for bit.
//
// Products: an f32 operand x is split as hi + lo (hi = x rounded to a
// TF32 value; lo = x - hi, exact) and each product is lo*hi + hi*lo + hi*hi
// ("3xTF32", the small terms first) in mma.m16n8k8 TF32. In bf16 the
// recompute products take mma.m16n8k16 bf16 -> f32, as JAX's _recompute
// multiplies bf16 operands with an f32 sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 16 * kWarps;  // edge rows per tile
constexpr int kMaxK = kTileRows;        // slots a tile must hold of one receiver
constexpr int kP = 64;                  // padded width: D, H <= 64
constexpr int kLd = kP + 4;             // f32 row stride in shared memory (words)
constexpr int kLdb = kP + 8;            // bf16 row stride of the transposed weights
constexpr int kRowBytes = kLd * 4;      // stride of the f32 rows and of staged rows
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, as f32 (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// x = hi + lo: hi is x rounded to its top 19 bits (a TF32 value; to
// nearest, ties away from zero, by one integer add), lo = x - hi is exact
// in f32; the tensor cores read lo's top 19 bits, so hi + lo carries x to
// ~2^-22 relative. Rounding hi keeps the products unbiased: truncated ones
// all lean toward zero, and a sum of many (agg over 128 slots) drifts.
// Three full-rate ops, no conversion instruction.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// e's staged row: 64 T elements, padded to a stride of 4 words mod 32 banks
template <typename T>
__host__ __device__ constexpr int e_row_bytes() {
  return kP * static_cast<int>(sizeof(T)) + 16;
}

// Stage rows [0, n) of a [*, W] T array into shared rows of `stride` bytes:
// by cp.async in 16-byte pieces where `vec` says rows and bases allow it
// (the caller waits), else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(char* dst, int stride, const T* src, int n, int W,
                                           bool vec) {
  if (vec) {
    const int pieces = W * static_cast<int>(sizeof(T)) / 16;
    const char* s = reinterpret_cast<const char*>(src);
    for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
      const int row = i / pieces, p = i - row * pieces;
      cp_async16(dst + row * stride + p * 16, s + (static_cast<int64_t>(row) * pieces + p) * 16);
    }
  } else {
    for (int i = threadIdx.x; i < n * W; i += kThreads) {
      const int row = i / W, c = i - row * W;
      reinterpret_cast<T*>(dst + row * stride)[c] = src[static_cast<int64_t>(row) * W + c];
    }
  }
}

// The weights as the tile products read them from shared memory, each
// zero-padded to 64 x 64 with rows of kLd words: We and W2 as TF32 hi and
// lo parts (f32 products), their bf16-rounded transposes as rows of kLdb
// (bf16 recompute), and be, b2, lns, lnb as vec[4][64].
struct TileWeights {
  float* we_hi;
  float* we_lo;
  float* w2_hi;
  float* w2_lo;
  __nv_bfloat16* wet_b;  // [h][d]
  __nv_bfloat16* w2t_b;  // [d][h]
  float* vec;
};

// Fill `w` from the f32 weights: the hi / lo parts where TF32 is set, the
// bf16 transposes where T is bf16. Shared memory must be zero beforehand.
template <typename T, bool TF32>
__device__ __forceinline__ void stage_weights(const TileWeights& w, const float* __restrict__ we,
                                              const float* __restrict__ be,
                                              const float* __restrict__ w2,
                                              const float* __restrict__ b2,
                                              const float* __restrict__ lns,
                                              const float* __restrict__ lnb, int D, int H) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kP * kP; i += kThreads) {
    const int r = i / kP, c = i % kP;
    const float wv = r < D && c < H ? we[r * H + c] : 0.f;  // We[r][c]
    const float w2v = r < H && c < D ? w2[r * D + c] : 0.f;  // W2[r][c]
    if constexpr (TF32) {
      uint32_t hi, lo;
      split(wv, hi, lo);
      w.we_hi[r * kLd + c] = __uint_as_float(hi);
      w.we_lo[r * kLd + c] = __uint_as_float(lo);
      split(w2v, hi, lo);
      w.w2_hi[r * kLd + c] = __uint_as_float(hi);
      w.w2_lo[r * kLd + c] = __uint_as_float(lo);
    }
    if constexpr (sizeof(T) == 2) {
      w.wet_b[c * kLdb + r] = __float2bfloat16_rn(wv);
      w.w2t_b[c * kLdb + r] = __float2bfloat16_rn(w2v);
    }
  }
  if (tid < kP) {
    w.vec[tid] = tid < H ? be[tid] : 0.f;
    w.vec[kP + tid] = tid < D ? b2[tid] : 0.f;
    w.vec[2 * kP + tid] = tid < D ? lns[tid] : 0.f;
    w.vec[3 * kP + tid] = tid < D ? lnb[tid] : 0.f;
  }
}

// acc[j] (n-tile j: columns 8j..8j+7) += A[16 x 64] @ B[64 x 64] for the
// warp's 16 rows, 3xTF32 (2x when A is exactly bf16). A: rows of stride kLd
// words at `a`. B(k, n) = w[k * kLd + n], or w[n * kLd + k] if TRANS, with
// its TF32 hi and lo parts.
template <bool SPLIT_A, bool TRANS>
__device__ __forceinline__ void warp_gemm_tf32(float (&acc)[8][4], const float* a,
                                               const float* w_hi, const float* w_lo, int g,
                                               int t) {
#pragma unroll 2
  for (int kk = 0; kk < kP; kk += 8) {
    const float av[4] = {a[g * kLd + kk + t], a[(g + 8) * kLd + kk + t],
                         a[g * kLd + kk + t + 4], a[(g + 8) * kLd + kk + t + 4]};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (SPLIT_A)
        split(av[i], ahi[i], alo[i]);
      else
        ahi[i] = __float_as_uint(av[i]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + g;
      const int i0 = TRANS ? n * kLd + kk + t : (kk + t) * kLd + n;
      const int i1 = TRANS ? i0 + 4 : i0 + 4 * kLd;
      const uint32_t bh0 = __float_as_uint(w_hi[i0]), bh1 = __float_as_uint(w_hi[i1]);
      const uint32_t bl0 = __float_as_uint(w_lo[i0]), bl1 = __float_as_uint(w_lo[i1]);
      if (SPLIT_A) mma_tf32(acc[j], alo, bh0, bh1);
      mma_tf32(acc[j], ahi, bl0, bl1);
      mma_tf32(acc[j], ahi, bh0, bh1);
    }
  }
}

// acc[j] += A[16 x 64] @ B[64 x 64] in bf16 -> f32. A(row, k) from load_a
// (a 32-bit pair of columns k, k+1); B^T rows of kLdb bf16 at wt: B(k, n) =
// wt[n * kLdb + k].
template <typename LoadA>
__device__ __forceinline__ void warp_gemm_bf16(float (&acc)[8][4], LoadA load_a,
                                               const __nv_bfloat16* wt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kP; kk += 16) {
    const uint32_t a[4] = {load_a(g, kk + 2 * t), load_a(g + 8, kk + 2 * t),
                           load_a(g, kk + 2 * t + 8), load_a(g + 8, kk + 2 * t + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* col = wt + (8 * j + g) * kLdb + kk + 2 * t;
      mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(col),
               *reinterpret_cast<const uint32_t*>(col + 8));
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The thread's two rows of the tile (g and g + 8 of the warp): their
// index in the tile, receiver, whether the row exists (the last tile may
// be short) and the slot mask [s < deg[r]] as 1 or 0.
__device__ __forceinline__ void tile_rows(int (&rl)[2], int (&recv)[2], bool (&valid)[2],
                                          float (&keep)[2], const float* __restrict__ degrees,
                                          int row0, int nrows, int r0, int K, int g) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rl[hr] = row0 + g + 8 * hr;
    valid[hr] = rl[hr] < nrows;
    const int lr = valid[hr] ? rl[hr] / K : 0;
    recv[hr] = r0 + lr;
    keep[hr] = valid[hr] && static_cast<float>(rl[hr] - lr * K) < degrees[recv[hr]] ? 1.f : 0.f;
  }
}

// The forward of the warp's 16 rows, from the tile's e rows (s_e, stride
// e_row_bytes<T>()) and xj rows (staged as T in s_a, stride kRowBytes):
//   h = e @ We + xj + proj_i + be        ((acc + xj) + proj_i) + be
//   a = relu(h) rounded to T             written over xj in s_a (f32 rows)
//   acc = o = a @ W2 + b2
// and the LayerNorm mean and 1 / sqrt(var + eps) of the thread's two rows
// over the D real columns (f32 moments). Returns the ReLU gate: bit 4j + i
// is h > 0 at fragment entry (j, i).
template <typename T>
__device__ __forceinline__ uint32_t recompute_tile(float (&acc)[8][4], float (&mu)[2],
                                                   float (&inv)[2], const char* s_e, float* s_a,
                                                   const TileWeights& w,
                                                   const float* __restrict__ proj_i,
                                                   const int (&rl)[2], const int (&recv)[2],
                                                   const bool (&valid)[2], int row0, int D, int H,
                                                   float inv_d, int g, int t) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kEStride = e_row_bytes<T>();

  // ---- h = e @ We + xj + proj_i + be;  a = relu(h) rounded to T ----
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  if constexpr (kBf16) {
    const char* ew = s_e + row0 * kEStride;
    warp_gemm_bf16(acc, [&](int r, int k) {
      return *reinterpret_cast<const uint32_t*>(ew + r * kEStride + 2 * k);
    }, w.wet_b, g, t);
  } else {
    warp_gemm_tf32<true, false>(acc, reinterpret_cast<const float*>(s_e) + row0 * kLd,
                                w.we_hi, w.we_lo, g, t);
  }
  uint32_t gate = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hr = i >> 1, c = 8 * j + 2 * t + (i & 1);
      const T* xs = reinterpret_cast<const T*>(reinterpret_cast<const char*>(s_a) + rl[hr] * kRowBytes);
      const bool in = valid[hr] && c < H;
      const float x = in ? to_f32(xs[c]) : 0.f;
      const float pi = in ? proj_i[static_cast<int64_t>(recv[hr]) * H + c] : 0.f;
      const float hv = ((acc[j][i] + x) + pi) + w.vec[c];
      if (hv > 0.f) gate |= 1u << (4 * j + i);
      acc[j][i] = round_to<T>(fmaxf(hv, 0.f));
    }
  __syncwarp();  // every lane has read its xj before a overwrites it
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s_a[(rl[i >> 1]) * kLd + 8 * j + 2 * t + (i & 1)] = acc[j][i];
  __syncwarp();

  // ---- o = a @ W2 + b2; LayerNorm moments ----
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  if constexpr (kBf16) {
    const float* aw = s_a + row0 * kLd;
    warp_gemm_bf16(acc, [&](int r, int k) { return pack_bf16(aw[r * kLd + k], aw[r * kLd + k + 1]); },
                   w.w2t_b, g, t);
  } else {
    warp_gemm_tf32<true, false>(acc, s_a + row0 * kLd, w.w2_hi, w.w2_lo, g, t);
  }
  float s1[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * j + 2 * t + (i & 1);
      acc[j][i] += w.vec[kP + c];
      if (c < D) s1[i >> 1] += acc[j][i];
    }
  float s2[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) mu[hr] = quad_sum(s1[hr]) * inv_d;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dv = acc[j][i] - mu[i >> 1];
      if (8 * j + 2 * t + (i & 1) < D) s2[i >> 1] += dv * dv;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) inv[hr] = rsqrtf(quad_sum(s2[hr]) * inv_d + kLnEps);
  return gate;
}

}  // namespace
