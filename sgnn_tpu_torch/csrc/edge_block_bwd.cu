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
//     GEMMs. An f32 operand x is split as hi + lo (hi = x rounded to TF32,
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
// The recompute of h, a and o (and the tile machinery) is the forward
// kernel's own (edge_block_tile.cuh), so the ReLU gate and, in bf16, the
// rounding of a are the ones the forward took, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "edge_block_tile.cuh"

namespace {

// Floats of one block's partial: g_we [D,H], g_be [H], g_w2 [H,D], g_b2,
// g_lns, g_lnb [D] (the order of _bwd_kernel's outputs).
__host__ __device__ __forceinline__ int partial_floats(int D, int H) {
  return 2 * D * H + H + 3 * D;
}

template <typename T>
__host__ __device__ constexpr size_t shared_bytes() {
  return static_cast<size_t>(kTileRows) * e_row_bytes<T>()  // s_e
         + 3ull * kTileRows * kRowBytes                        // s_a, s_go, s_gh
         + 4ull * kP * kLd * 4                                 // We, W2 hi and lo
         + (sizeof(T) == 2 ? 2ull * kP * kLdb * 2 : 0)         // bf16 We^T, W2^T
         + 4ull * kP * 4;                                      // be, b2, lns, lnb
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
  const TileWeights tw{s_we_hi, s_we_lo, s_w2_hi, s_w2_lo, s_wet_b, s_w2t_b, s_vec};
  stage_weights<T, true>(tw, we, be, w2, b2, lns, lnb, D, H);

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
    tile_rows(rl, recv, valid, keep, degrees, row0, nrows, r0, K, g);

    // ---- h, a (into s_a), o + b2 and its LayerNorm moments ----
    float acc[8][4];
    float mu[2], inv[2];
    const uint32_t gate =
        recompute_tile<T>(acc, mu, inv, s_e, s_a, tw, proj_i, rl, recv, valid, row0, D, H, inv_d, g, t);

    // ---- LayerNorm backward -> g_o ----
    float gn[8][4];  // g_new at the thread's entries, kept for g_e
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
