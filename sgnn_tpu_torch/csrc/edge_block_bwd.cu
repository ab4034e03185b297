// Fused edge-block backward for NVIDIA Hopper (sm_90a), on tensor cores.
//
// Replaces the TPU kernel `_bwd_kernel` of sgnn_tpu/experimental/edge_block.py
// (reached through `_fused_bwd`, the custom_vjp backward of `fused_edge_block`).
// It recomputes the forward of each edge row r*K + s from the saved inputs,
//
//   h = e @ We + xj + proj_i[r] + be,  a = relu(h),  o = a @ W2 + b2,
//   xhat = (o - mean) * inv,  inv = rsqrt(var + 1e-5)   (f32 moments)
//
// with We and W2 rounded to T and a rounded to T, and then takes the gradients
//
//   g_msg = (g_new + g_agg[r]) * [s < deg[r]]
//   g_o   = inv * (g_xhat - xhat * mean(g_xhat * xhat) - mean(g_xhat)),
//           g_xhat = g_msg * lns
//   g_h   = (g_o @ W2^T) * [h > 0]                 f32 weights
//   g_e   = g_new + g_h @ We^T                     f32 sum, stored as T
//   g_xj  = g_h (stored as T),  g_proj_i[r] = sum_s g_h (f32 sum, stored as T)
//   g_we  = sum e^T g_h,  g_be = sum g_h,  g_w2 = sum a^T g_o,  g_b2 = sum g_o,
//   g_lns = sum g_msg * xhat,  g_lnb = sum g_msg          (f32, over all edges)
//
// e, xj, g_new, g_agg, g_e, g_xj and g_proj_i are float32 or bfloat16 (T);
// proj_i, degrees, the weights and the weight gradients are float32.
//
// What bounds it: at the training shape of the f32 configuration
// (R = 155,648, K = 8, D = H = 64) it moves ~1.71 GB (0.51 ms at 3.35 TB/s)
// against six products of 2*E*D*H each = 61.2 GFLOP (0.91 ms at the 67
// TFLOP/s f32 rate without tensor cores): bound by operations. In bf16 the
// bytes halve and the products may run on tensor cores: bound by bytes.
// This design reaches neither bound: at f32 accuracy every product costs
// three TF32 passes, and mma.sync delivers about half of the card's dense
// TF32 rate, so in f32 the tensor pipe alone takes ~0.6-0.7 ms; the
// epilogues, the loads and the block barriers add to it (PERF.md).
//
// Design. The products are tile GEMMs on the tensor cores (mma.sync), with
// f32 accuracy where an operand is f32:
//   * a block (8 warps) is persistent and walks tiles of T = 128 / K whole
//     receivers, T*K <= 128 edge rows (K <= 128); whole receivers keep
//     g_proj_i a sum inside the tile, in slot order, with no atomics.
//     Warp w owns the tile's rows 16w..16w+15 and all 64 (padded) columns,
//     so a row sits in one lane quad: the LayerNorm sums are in-thread sums
//     plus two shuffles.
//   * a tile's e, xj and g_new rows arrive by cp.async (16-byte pieces) into
//     shared memory, in the buffers that e, a and g_o take over. The next
//     tile's xj and g_new are in flight while this tile computes g_we, g_e
//     and g_proj_i, its e while this tile computes g_e and g_proj_i. The
//     weights load once per block: We and W2 as TF32 hi and lo parts, and
//     for bf16 the bf16-rounded transposes the recompute multiplies by.
//   * the four row products (h, o, g_o W2^T, g_h We^T) are 16x64x64 warp
//     GEMMs. An f32 operand x is split as hi + lo (hi = x's top 19 bits,
//     lo = x - hi) and each product is lo*hi + hi*lo + hi*hi ("3xTF32", the
//     small terms first) in mma.m16n8k8 TF32; an operand that is exactly
//     bf16 (e and a in bf16) is exact in TF32 and needs no lo part (2
//     passes). In bf16 the two recompute products take mma.m16n8k16 bf16 ->
//     f32, as JAX's _recompute multiplies bf16 operands with an f32 sum.
//   * the epilogues run on the accumulator fragments: bias and residual,
//     ReLU (a rounded to T), LayerNorm statistics and backward, the gate,
//     g_e = g_new + ..., g_xj = g_h (a lane quad stores 32 contiguous bytes
//     of a row); a, g_o and g_h go to shared memory as the operands of the
//     next products, and g_proj_i sums g_h's slots from there.
//   * g_we += E^T G_h and g_w2 += A^T G_o are tile GEMMs of depth 128 (the
//     tile's rows), split 3x (2x for bf16 e and a); their fragments stay in
//     registers across the block's tiles. The vector gradients are summed
//     per column over a warp's rows by a shuffle reduce-scatter, in a fixed
//     order.
//   * each block writes one partial of every weight gradient; a second
//     kernel sums the partials in block order. The grid depends only on
//     the shapes and the card and no float atomics are used, so two
//     launches on the same inputs give the same bits.
// The ReLU gate is the one this recompute finds; the forward kernel sums
// e @ We in another order, so where |h| is within rounding of 0 the two
// may disagree (as do two f32 sums in different orders anywhere).

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

// x = hi + lo: hi keeps x's top 19 bits (a TF32 value), lo = x - hi is
// exact in f32; the tensor cores read lo's top 19 bits, so hi + lo carries
// x to ~2^-21 relative. Two full-rate ops, no conversion instruction.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
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

// Floats of one block's partial: g_we [D,H], g_be [H], g_w2 [H,D], g_b2,
// g_lns, g_lnb [D] (the order of _bwd_kernel's outputs).
__host__ __device__ __forceinline__ int partial_floats(int D, int H) {
  return 2 * D * H + H + 3 * D;
}

// e's staged row: 64 T elements, padded to a stride of 4 words mod 32 banks
template <typename T>
__host__ __device__ constexpr int e_row_bytes() {
  return kP * static_cast<int>(sizeof(T)) + 16;
}

template <typename T>
__host__ __device__ constexpr size_t shared_bytes() {
  return static_cast<size_t>(kTileRows) * e_row_bytes<T>()  // s_e
         + 3ull * kTileRows * kRowBytes                        // s_a, s_go, s_gh
         + 4ull * kP * kLd * 4                                 // We, W2 hi and lo
         + (sizeof(T) == 2 ? 2ull * kP * kLdb * 2 : 0)         // bf16 We^T, W2^T
         + 4ull * kP * 4;                                      // be, b2, lns, lnb
}

// Stage rows [0, n) of a [*, W] T array into shared rows of `stride` bytes.
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

// acc[q] (output rows 16m.., columns n0 + 8q..) += X^T @ Y over the tile's
// 128 rows, where X(row, m) = x(row, m) and Y(row, n) = y[row * kLd + n]
// (f32). 3xTF32, or 2x when X is exactly bf16.
template <bool SPLIT_X, typename LoadX>
__device__ __forceinline__ void tile_gemm_tn(float (&acc)[4][4], LoadX x, const float* y, int m0,
                                             int n0, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < kTileRows; kk += 8) {
    const float xv[4] = {x(kk + t, m0 + g), x(kk + t, m0 + g + 8), x(kk + t + 4, m0 + g),
                         x(kk + t + 4, m0 + g + 8)};
    uint32_t xhi[4], xlo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (SPLIT_X)
        split(xv[i], xhi[i], xlo[i]);
      else
        xhi[i] = __float_as_uint(xv[i]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + 8 * q + g;
      uint32_t yh0, yl0, yh1, yl1;
      split(y[(kk + t) * kLd + n], yh0, yl0);
      split(y[(kk + t + 4) * kLd + n], yh1, yl1);
      if (SPLIT_X) mma_tf32(acc[q], xlo, yh0, yh1);
      mma_tf32(acc[q], xhi, yl0, yl1);
      mma_tf32(acc[q], xhi, yh0, yh1);
    }
  }
}

// v (one value per n-tile j and column half cc, summed over the thread's
// two rows) summed over the warp's 16 rows (lanes 4g + t, g = 0..7) by a
// reduce-scatter over g's bits: lane g ends with n-tile g's sums, which it
// adds to acc. 14 shuffles where a sum of each value would take 48.
__device__ __forceinline__ void add_column_sums(float (&acc)[2], const float (&v)[8][2], int g) {
  float v4[4][2], v2[2][2];
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)  // keep n-tiles j + 4*b2
      v4[j][cc] = (b2 ? v[j + 4][cc] : v[j][cc]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? v[j][cc] : v[j + 4][cc], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)  // keep n-tiles j + 2*b1 + 4*b2
      v2[j][cc] = (b1 ? v4[j + 2][cc] : v4[j][cc]) +
                  __shfl_xor_sync(0xffffffffu, b1 ? v4[j][cc] : v4[j + 2][cc], 8);
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)  // keep n-tile g
    acc[cc] += (b0 ? v2[1][cc] : v2[0][cc]) + __shfl_xor_sync(0xffffffffu, b0 ? v2[0][cc] : v2[1][cc], 4);
}

// dst[c], dst[c + 1] = a, b (as T): one 2-element store where `vec` says
// rows are 16-byte multiples (so c + 1 < width), else element by element
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, int c, int width, float a, float b, bool vec) {
  if (vec) {
    store2(dst + c, a, b);
  } else {
    dst[c] = from_f32<T>(a);
    if (c + 1 < width) dst[c + 1] = from_f32<T>(b);
  }
}

// (row[c], row[c + 1]) in f32, c even, zero past `width`: one 2-element load
// where `pairs` says the pair is aligned and inside the row
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* row, int c, int width, bool pairs) {
  if (pairs) return load2(row + c);
  return make_float2(to_f32(row[c]), c + 1 < width ? to_f32(row[c + 1]) : 0.f);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
edge_block_bwd_kernel(const T* __restrict__ e, const T* __restrict__ xj,
                      const float* __restrict__ proj_i, const float* __restrict__ degrees,
                      const float* __restrict__ we, const float* __restrict__ be,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ lns, const float* __restrict__ lnb,
                      const T* __restrict__ g_new, const T* __restrict__ g_agg,
                      T* __restrict__ g_e, T* __restrict__ g_xj, T* __restrict__ g_proj_i,
                      float* __restrict__ partials, int R, int K, int D, int H, bool vec) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kEStride = e_row_bytes<T>();
  extern __shared__ __align__(16) char smem[];
  char* s_e = smem;                                   // [128] rows of T, stride kEStride
  float* s_a = reinterpret_cast<float*>(s_e + kTileRows * kEStride);  // xj staged, then a
  float* s_go = s_a + kTileRows * kLd;                // g_new staged, then g_o
  float* s_gh = s_go + kTileRows * kLd;               // g_h
  float* s_we_hi = s_gh + kTileRows * kLd;            // [D, H] padded to [64, kLd]
  float* s_we_lo = s_we_hi + kP * kLd;
  float* s_w2_hi = s_we_lo + kP * kLd;                // [H, D]
  float* s_w2_lo = s_w2_hi + kP * kLd;
  float* s_vec = s_w2_lo + kP * kLd;                  // be, b2, lns, lnb [4][64]
  __nv_bfloat16* s_wet_b = reinterpret_cast<__nv_bfloat16*>(s_vec + 4 * kP);  // [h][d] bf16
  __nv_bfloat16* s_w2t_b = s_wet_b + kP * kLdb;                              // [d][h] bf16

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // zero everything once: padded columns stay zero, and no tile reads
  // uninitialised words
  for (int i = tid; i < static_cast<int>(shared_bytes<T>() / 4); i += kThreads)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < kP * kP; i += kThreads) {
    const int r = i / kP, c = i % kP;
    const float wv = r < D && c < H ? we[r * H + c] : 0.f;  // We[r][c]
    const float w2v = r < H && c < D ? w2[r * D + c] : 0.f;  // W2[r][c]
    uint32_t hi, lo;
    split(wv, hi, lo);
    s_we_hi[r * kLd + c] = __uint_as_float(hi);
    s_we_lo[r * kLd + c] = __uint_as_float(lo);
    split(w2v, hi, lo);
    s_w2_hi[r * kLd + c] = __uint_as_float(hi);
    s_w2_lo[r * kLd + c] = __uint_as_float(lo);
    if (kBf16) {
      s_wet_b[c * kLdb + r] = __float2bfloat16_rn(wv);
      s_w2t_b[c * kLdb + r] = __float2bfloat16_rn(w2v);
    }
  }
  if (tid < kP) {
    s_vec[tid] = tid < H ? be[tid] : 0.f;
    s_vec[kP + tid] = tid < D ? b2[tid] : 0.f;
    s_vec[2 * kP + tid] = tid < D ? lns[tid] : 0.f;
    s_vec[3 * kP + tid] = tid < D ? lnb[tid] : 0.f;
  }

  // weight-gradient fragments: rows 16*(warp/2).., columns 32*(warp%2)..
  const int wm0 = 16 * (warp >> 1), wn0 = 32 * (warp & 1);
  float acc_we[4][4], acc_w2[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_we[q][i] = acc_w2[q][i] = 0.f;
  // vector gradients of columns 8g + 2t + cc over this warp's rows
  float acc_be[2] = {0.f, 0.f}, acc_b2[2] = {0.f, 0.f};
  float acc_lns[2] = {0.f, 0.f}, acc_lnb[2] = {0.f, 0.f};

  const int per_tile = kTileRows / K;  // receivers per tile
  const int tiles = (R + per_tile - 1) / per_tile;
  const float inv_d = 1.f / static_cast<float>(D);
  const int row0 = 16 * warp;  // the warp's first row in the tile

  // a tile's rows of e, xj and g_new land in s_e, s_a and s_go (for every
  // tile but the first, while the tile before finishes)
  auto stage_xj_g_new = [&](int tile) {
    const int64_t row = static_cast<int64_t>(tile) * per_tile * K;
    const int n = min(per_tile, R - tile * per_tile) * K;
    stage_rows<T>(reinterpret_cast<char*>(s_a), kRowBytes, xj + row * H, n, H, vec);
    stage_rows<T>(reinterpret_cast<char*>(s_go), kRowBytes, g_new + row * D, n, D, vec);
  };
  auto stage_e = [&](int tile) {
    const int64_t row = static_cast<int64_t>(tile) * per_tile * K;
    const int n = min(per_tile, R - tile * per_tile) * K;
    stage_rows<T>(s_e, kEStride, e + row * D, n, D, vec);
  };
  if (blockIdx.x < tiles) {
    stage_e(blockIdx.x);
    stage_xj_g_new(blockIdx.x);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * per_tile;
    const int n_recv = min(per_tile, R - r0);
    const int nrows = n_recv * K;
    const int64_t e0 = static_cast<int64_t>(r0) * K;  // first edge row of the tile
    const int next = tile + gridDim.x;

    // the thread's two rows (g and g + 8 of the warp) and their receivers
    int rl[2], recv[2];
    bool valid[2];
    float keep[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rl[hr] = row0 + g + 8 * hr;
      valid[hr] = rl[hr] < nrows;
      const int lr = valid[hr] ? rl[hr] / K : 0;
      recv[hr] = r0 + lr;
      keep[hr] = valid[hr] && static_cast<float>(rl[hr] - lr * K) < degrees[recv[hr]] ? 1.f : 0.f;
    }

    // ---- h = e @ We + xj + proj_i + be;  a = relu(h) rounded to T ----
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    if constexpr (kBf16) {
      const char* ew = s_e + row0 * kEStride;
      warp_gemm_bf16(acc, [&](int r, int k) {
        return *reinterpret_cast<const uint32_t*>(ew + r * kEStride + 2 * k);
      }, s_wet_b, g, t);
    } else {
      warp_gemm_tf32<true, false>(acc, reinterpret_cast<const float*>(s_e) + row0 * kLd,
                                  s_we_hi, s_we_lo, g, t);
    }
    uint32_t gate = 0;  // bit 4j + i: h > 0 at fragment entry (j, i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1, c = 8 * j + 2 * t + (i & 1);
        const T* xs = reinterpret_cast<const T*>(reinterpret_cast<const char*>(s_a) + rl[hr] * kRowBytes);
        const bool in = valid[hr] && c < H;
        const float x = in ? to_f32(xs[c]) : 0.f;
        const float pi = in ? proj_i[static_cast<int64_t>(recv[hr]) * H + c] : 0.f;
        const float hv = ((acc[j][i] + x) + pi) + s_vec[c];
        if (hv > 0.f) gate |= 1u << (4 * j + i);
        acc[j][i] = round_to<T>(fmaxf(hv, 0.f));
      }
    __syncwarp();  // every lane has read its xj before a overwrites it
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_a[(rl[i >> 1]) * kLd + 8 * j + 2 * t + (i & 1)] = acc[j][i];
    __syncwarp();

    // ---- o = a @ W2 + b2; LayerNorm backward -> g_o ----
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    if constexpr (kBf16) {
      const float* aw = s_a + row0 * kLd;
      warp_gemm_bf16(acc, [&](int r, int k) { return pack_bf16(aw[r * kLd + k], aw[r * kLd + k + 1]); },
                     s_w2t_b, g, t);
    } else {
      warp_gemm_tf32<true, false>(acc, s_a + row0 * kLd, s_w2_hi, s_w2_lo, g, t);
    }
    float gn[8][4];  // g_new at the thread's entries, kept for g_e
    float mu[2], inv[2];
    {
      float s1[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * j + 2 * t + (i & 1);
          acc[j][i] += s_vec[kP + c];
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
    }
    {
      float l1[2] = {0.f, 0.f}, l2[2] = {0.f, 0.f};
      float gm[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hr = i >> 1, c = 8 * j + 2 * t + (i & 1);
          const bool in = valid[hr] && c < D;
          const T* gs = reinterpret_cast<const T*>(reinterpret_cast<const char*>(s_go) + rl[hr] * kRowBytes);
          gn[j][i] = in ? to_f32(gs[c]) : 0.f;
          const float ga = in ? to_f32(g_agg[static_cast<int64_t>(recv[hr]) * D + c]) : 0.f;
          const float xhat = c < D ? (acc[j][i] - mu[hr]) * inv[hr] : 0.f;
          gm[j][i] = (gn[j][i] + ga) * keep[hr];
          acc[j][i] = xhat;
          const float gx = gm[j][i] * s_vec[2 * kP + c];
          l1[hr] += gx * xhat;
          l2[hr] += gx;
        }
      float m1[2], m2[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m1[hr] = quad_sum(l1[hr]) * inv_d;
        m2[hr] = quad_sum(l2[hr]) * inv_d;
      }
      float v[8][2];  // column sums over the thread's two rows
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) v[j][cc] = gm[j][cc] * acc[j][cc] + gm[j][cc + 2] * acc[j][cc + 2];
      add_column_sums(acc_lns, v, g);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) v[j][cc] = gm[j][cc] + gm[j][cc + 2];
      add_column_sums(acc_lnb, v, g);
      __syncwarp();  // every lane has read its g_new before g_o overwrites it
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hr = i >> 1, c = 8 * j + 2 * t + (i & 1);
          const float xhat = acc[j][i];
          const float gx = gm[j][i] * s_vec[2 * kP + c];
          const float go = c < D ? inv[hr] * (gx - xhat * m1[hr] - m2[hr]) : 0.f;
          s_go[rl[hr] * kLd + c] = go;
          acc[j][i] = go;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) v[j][cc] = acc[j][cc] + acc[j][cc + 2];
      add_column_sums(acc_b2, v, g);
    }
    __syncwarp();  // g_o is in s_go; every lane has read its g_new

    // ---- g_h = (g_o @ W2^T) * [h > 0] ----
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    warp_gemm_tf32<true, true>(acc, s_go + row0 * kLd, s_w2_hi, s_w2_lo, g, t);
    {
      float v[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i] = (gate >> (4 * j + i)) & 1u ? acc[j][i] : 0.f;
          s_gh[rl[i >> 1] * kLd + 8 * j + 2 * t + (i & 1)] = acc[j][i];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // g_xj = g_h
          const int c = 8 * j + 2 * t;
          if (valid[hr] && c < H)
            store_pair(g_xj + (e0 + rl[hr]) * H, c, H, acc[j][2 * hr], acc[j][2 * hr + 1], vec);
        }
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) v[j][cc] = acc[j][cc] + acc[j][cc + 2];
      }
      add_column_sums(acc_be, v, g);
    }
    __syncwarp();

    __syncthreads();  // all rows of a, g_o and g_h are in shared memory

    // ---- g_w2 += a^T g_o,  g_we += e^T g_h over the tile's rows ----
    tile_gemm_tn<!kBf16>(acc_w2, [&](int r, int m) { return s_a[r * kLd + m]; }, s_go, wm0, wn0, g, t);
    __syncthreads();  // a and g_o are read: the next tile's xj and g_new may land
    if (next < tiles) stage_xj_g_new(next);
    if constexpr (kBf16) {
      const char* es = s_e;
      tile_gemm_tn<false>(acc_we, [&](int r, int m) {
        return to_f32(reinterpret_cast<const T*>(es + r * kEStride)[m]);
      }, s_gh, wm0, wn0, g, t);
    } else {
      const float* es = reinterpret_cast<const float*>(s_e);
      tile_gemm_tn<true>(acc_we, [&](int r, int m) { return es[r * kLd + m]; }, s_gh, wm0, wn0, g, t);
    }
    __syncthreads();  // e is read: the next tile's e may land
    if (next < tiles) stage_e(next);

    // ---- g_e = g_new + g_h @ We^T ----
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    warp_gemm_tf32<true, true>(acc, s_gh + row0 * kLd, s_we_hi, s_we_lo, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int c = 8 * j + 2 * t;
        if (valid[hr] && c < D)
          store_pair(g_e + (e0 + rl[hr]) * D, c, D, gn[j][2 * hr] + acc[j][2 * hr],
                     gn[j][2 * hr + 1] + acc[j][2 * hr + 1], vec);
      }

    // g_proj_i = sum over the slots of g_h: a warp per receiver, a column
    // pair per lane
    for (int r = warp; r < n_recv; r += kWarps) {
      T* dst = g_proj_i + static_cast<int64_t>(r0 + r) * H;
      for (int c = 2 * lane; c < H; c += 64) {
        float s0 = 0.f, s1 = 0.f;
        for (int s = 0; s < K; ++s) {
          s0 += s_gh[(r * K + s) * kLd + c];
          s1 += s_gh[(r * K + s) * kLd + c + 1];
        }
        store_pair(dst, c, H, s0, s1, vec);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile's rows are in; g_h is read
  }

  // this block's partial of every weight gradient
  const int n_out = partial_floats(D, H);
  float* out = partials + static_cast<int64_t>(blockIdx.x) * n_out;
  float* o_we = out;           // [D, H]
  float* o_be = o_we + D * H;  // [H]
  float* o_w2 = o_be + H;      // [H, D]
  float* o_b2 = o_w2 + H * D;  // [D]
  float* o_lns = o_b2 + D;
  float* o_lnb = o_lns + D;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm0 + g + 8 * (i >> 1), n = wn0 + 8 * q + 2 * t + (i & 1);
      if (m < D && n < H) o_we[m * H + n] = acc_we[q][i];
      if (m < H && n < D) o_w2[m * D + n] = acc_w2[q][i];
    }
  // the vector sums: per warp into shared rows, then over warps in order
  __syncthreads();  // the last tile's readers of s_go are done
  float* red = s_go;  // [kWarps][4][64]
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int c = 8 * g + 2 * t + cc;
    red[(warp * 4 + 0) * kP + c] = acc_be[cc];
    red[(warp * 4 + 1) * kP + c] = acc_b2[cc];
    red[(warp * 4 + 2) * kP + c] = acc_lns[cc];
    red[(warp * 4 + 3) * kP + c] = acc_lnb[cc];
  }
  __syncthreads();
  for (int i = tid; i < 4 * kP; i += kThreads) {
    const int vi = i / kP, c = i % kP;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * 4 * kP + i];
    if (vi == 0 && c < H) o_be[c] = sum;
    if (vi == 1 && c < D) o_b2[c] = sum;
    if (vi == 2 && c < D) o_lns[c] = sum;
    if (vi == 3 && c < D) o_lnb[c] = sum;
  }
}

// out[j] = sum over the blocks' partials, in block order
__global__ void reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                       int blocks, int W) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < W; j += gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int b = 0; b < blocks; ++b) sum += partials[static_cast<int64_t>(b) * W + j];
    out[j] = sum;
  }
}

template <typename T>
cudaError_t grid_size(int R, int K, int* grid) {
  const size_t smem = shared_bytes<T>();
  auto kernel = edge_block_bwd_kernel<T>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // shared memory too large
  const int per_tile = kTileRows / K;
  const long long tiles = (static_cast<long long>(R) + per_tile - 1) / per_tile;
  const long long cap = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
cudaError_t launch(const void* const* in, void* g_e, void* g_xj, void* g_proj_i, float* partials,
                   float* wgrads, int R, int K, int D, int H, int grid, cudaStream_t stream) {
  int expect = 0;
  cudaError_t err = grid_size<T>(R, K, &expect);
  if (err != cudaSuccess) return err;
  if (grid != expect) return cudaErrorInvalidValue;  // workspace sized for another grid
  // cp.async moves 16-byte pieces: rows and bases must be 16-byte aligned
  const bool vec = (D * sizeof(T)) % 16 == 0 && (H * sizeof(T)) % 16 == 0 && aligned16(in[0]) &&
                   aligned16(in[1]) && aligned16(in[2]) && aligned16(in[10]) && aligned16(in[11]) &&
                   aligned16(g_e) && aligned16(g_xj) && aligned16(g_proj_i);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (grid > 0) {
    edge_block_bwd_kernel<T><<<grid, kThreads, shared_bytes<T>(), stream>>>(
        static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), f(in[2]), f(in[3]), f(in[4]),
        f(in[5]), f(in[6]), f(in[7]), f(in[8]), f(in[9]), static_cast<const T*>(in[10]),
        static_cast<const T*>(in[11]), static_cast<T*>(g_e), static_cast<T*>(g_xj),
        static_cast<T*>(g_proj_i), partials, R, K, D, H, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int n_out = partial_floats(D, H);
  reduce_partials_kernel<<<(n_out + 255) / 256, 256, 0, stream>>>(partials, wgrads, grid, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks the backward launches for these shapes on the current card: the
// workspace of sgnn_edge_block_bwd holds that many partials of
// 2*D*H + H + 3*D floats. dtype: 0 = float32, 1 = bfloat16.
int sgnn_edge_block_bwd_grid(int R, int K, int D, int H, int dtype, int* grid) {
  if (R < 0 || K < 1 || K > kMaxK || D < 1 || H < 1 || D > kP || H > kP || grid == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = grid_size<float>(R, K, grid);
  else if (dtype == 1)
    err = grid_size<__nv_bfloat16>(R, K, grid);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Inputs as the forward's plus g_new [R*K, D] and g_agg [R, D] (T). Outputs
// g_e [R*K, D], g_xj [R*K, H], g_proj_i [R, H] (T) and the weight gradients,
// f32, concatenated in wgrads as g_we [D,H], g_be [H], g_w2 [H,D], g_b2 [D],
// g_lns [D], g_lnb [D]. partials: grid * (2*D*H + H + 3*D) floats of scratch,
// grid from sgnn_edge_block_bwd_grid. K <= 128, D and H <= 64. Returns the
// cudaError_t of the launches.
int sgnn_edge_block_bwd(const void* e, const void* xj, const void* proj_i, const void* degrees,
                        const void* we, const void* be, const void* w2, const void* b2,
                        const void* lns, const void* lnb, const void* g_new, const void* g_agg,
                        void* g_e, void* g_xj, void* g_proj_i, void* partials, void* wgrads,
                        int R, int K, int D, int H, int dtype, int grid, void* stream) {
  if (R < 0 || K < 1 || K > kMaxK || D < 1 || H < 1 || D > kP || H > kP || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* in[12] = {e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, g_new, g_agg};
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partials);
  auto w = static_cast<float*>(wgrads);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(in, g_e, g_xj, g_proj_i, p, w, R, K, D, H, grid, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(in, g_e, g_xj, g_proj_i, p, w, R, K, D, H, grid, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* sgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
