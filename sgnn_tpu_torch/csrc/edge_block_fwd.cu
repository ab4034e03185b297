// Fused edge-block forward for NVIDIA Hopper (sm_90a), on tensor cores.
//
// Replaces the TPU kernel `_fwd_kernel` of sgnn_tpu/experimental/edge_block.py
// (reached through `_call_fwd` / `fused_edge_block`). For every receiver r and
// neighbour slot s (edge row = r*K + s, receiver-major):
//
//   h     = e @ We + xj + proj_i[r] + be        first Linear, split form
//   a     = relu(h)                              (rounded to bf16 in bf16 mode)
//   o     = a @ W2 + b2                          second Linear
//   msg   = (LN(o) * lns + lnb) * [s < deg[r]]   f32 moments, eps 1e-5
//   new_e = e + msg                              (msg rounded to e's dtype first)
//   agg[r]= sum_s msg                            f32 sum of the rounded msgs
//
// e, xj, new_e and agg are float32 or bfloat16 (T); proj_i, degrees and all
// weights are float32. In bf16 mode the weights are rounded to bf16 before the
// products, as the TPU kernel's `_recompute` does; every product then is exact
// in f32 and sums are f32.
//
// What bounds it: at the training shape of the f32 configuration
// (R = 155,648, K = 8, D = H = 64) it moves ~0.87 GB (e, xj at valid slots,
// new_e, agg: 0.26 ms at 3.35 TB/s) against two products of 2*E*D*H each,
// 10.2 GFLOP (0.15 ms at the 67 TFLOP/s f32 rate without tensor cores): bound
// by bytes; in bf16 the bytes halve and the products run on tensor cores.
// At f32 accuracy each product costs three TF32 passes on mma.sync, about
// 0.35 ms of tensor pipe for the two at that shape, so the design overlaps
// the loads with the products.
//
// Design: the backward kernel's tile layout (edge_block_tile.cuh holds the
// code the two share).
//   * a persistent block of 8 warps walks tiles of T = 128 / K whole
//     receivers, T*K <= 128 edge rows (K <= 128); warp w owns rows
//     16w..16w+15 and all 64 (padded) columns. Whole receivers keep agg a
//     sum inside the tile, in slot order, with no atomics.
//   * h, a and o: `recompute_tile`, the backward's own code, so both kernels
//     take the same ReLU gate and the same rounding of a, bit for bit:
//     16x64x64 warp GEMMs on mma.sync, every f32 operand split hi + lo
//     ("3xTF32"), native mma.m16n8k16 bf16 -> f32 in bf16; the epilogues
//     (+ xj + proj_i + be, ReLU, + b2, the LayerNorm moments by in-thread
//     sums and quad shuffles) run on the accumulator fragments.
//   * msg (masked, rounded to T) goes from the fragments into the shared
//     rows that held a; then new_e = e + msg leaves row by row in 16-byte
//     stores, and agg[r] = the column sums of r's K rows there, one 16-byte
//     piece of columns per thread.
//   * e and xj arrive by cp.async in 16-byte pieces. In f32 into one of
//     two tile buffers: the next tile's rows are in flight while this tile
//     computes. In bf16 into one buffer, which leaves room for two blocks
//     per SM, each computing while the other loads (fwd_buffers). The
//     weights load once per block: TF32 hi and lo parts in f32,
//     bf16-rounded transposes in bf16.
// Shapes outside the tile (max(D, H) > 64 or K > 128) take the
// warp-per-receiver kernel at the end of this file: one warp walks a
// receiver's K slots, one shared-memory weight read per FMA. The choice is
// by shape alone (sgnn_edge_block_fwd_variant), never a retry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "edge_block_tile.cuh"

namespace {

// Tile buffers of e and xj. Measured at the training shapes of configs A
// and B (PERF.md): f32 two buffers, 0.84 ms against 0.94 with one (one block
// per SM either way: the TF32 weight parts alone take 68 KB); bf16 one
// buffer and two blocks per SM, 0.21 ms against 0.28 with two buffers.
template <typename T>
__host__ __device__ constexpr int fwd_buffers() {
  return sizeof(T) == 2 ? 1 : 2;
}

template <typename T>
constexpr int fwd_min_blocks() {
  return fwd_buffers<T>() == 1 && sizeof(T) == 2 ? 2 : 1;
}

template <typename T>
__host__ __device__ constexpr size_t fwd_shared_bytes() {
  return fwd_buffers<T>() * static_cast<size_t>(kTileRows) * (e_row_bytes<T>() + kRowBytes)  // e; xj, a, msg
         + (sizeof(T) == 2 ? 2ull * kP * kLdb * 2    // bf16 We^T, W2^T
                           : 4ull * kP * kLd * 4)    // We, W2 hi and lo
         + 4ull * kP * 4;                            // be, b2, lns, lnb
}

// new_e = e + msg over one 16-byte piece of a row: e as staged (T), msg f32
__device__ __forceinline__ void residual_piece(float* dst, const char* es, const float* ms) {
  const float4 ev = *reinterpret_cast<const float4*>(es);
  const float4 mv = *reinterpret_cast<const float4*>(ms);
  *reinterpret_cast<float4*>(dst) = make_float4(ev.x + mv.x, ev.y + mv.y, ev.z + mv.z, ev.w + mv.w);
}
__device__ __forceinline__ void residual_piece(__nv_bfloat16* dst, const char* es, const float* ms) {
  const uint4 ev = *reinterpret_cast<const uint4*>(es);
  const float4 m0 = *reinterpret_cast<const float4*>(ms);
  const float4 m1 = *reinterpret_cast<const float4*>(ms + 4);
  const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
  const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&ev);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 ef = __bfloat1622float2(e2[q]);
    o2[q] = __floats2bfloat162_rn(ef.x + m[2 * q], ef.y + m[2 * q + 1]);
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

// dst[0 .. 16 bytes) = sum over the K rows (stride kLd) at ms, in row order
__device__ __forceinline__ void slot_sum_piece(float* dst, const float* ms, int K) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sl = 0; sl < K; ++sl) {
    const float4 v = *reinterpret_cast<const float4*>(ms + sl * kLd);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  *reinterpret_cast<float4*>(dst) = s;
}
__device__ __forceinline__ void slot_sum_piece(__nv_bfloat16* dst, const float* ms, int K) {
  float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
  for (int sl = 0; sl < K; ++sl) {
    const float4 v0 = *reinterpret_cast<const float4*>(ms + sl * kLd);
    const float4 v1 = *reinterpret_cast<const float4*>(ms + sl * kLd + 4);
    s0 = make_float4(s0.x + v0.x, s0.y + v0.y, s0.z + v0.z, s0.w + v0.w);
    s1 = make_float4(s1.x + v1.x, s1.y + v1.y, s1.z + v1.z, s1.w + v1.w);
  }
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
  o2[0] = __floats2bfloat162_rn(s0.x, s0.y);
  o2[1] = __floats2bfloat162_rn(s0.z, s0.w);
  o2[2] = __floats2bfloat162_rn(s1.x, s1.y);
  o2[3] = __floats2bfloat162_rn(s1.z, s1.w);
  *reinterpret_cast<uint4*>(dst) = out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<T>())
edge_block_fwd_tc_kernel(const T* __restrict__ e, const T* __restrict__ xj,
                         const float* __restrict__ proj_i, const float* __restrict__ degrees,
                         const float* __restrict__ we, const float* __restrict__ be,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ lns, const float* __restrict__ lnb,
                         T* __restrict__ new_e, T* __restrict__ agg, int R, int K, int D, int H,
                         bool vec) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kEStride = e_row_bytes<T>();
  constexpr int kCols = 16 / static_cast<int>(sizeof(T));  // columns of a 16-byte piece
  constexpr int kBuffers = fwd_buffers<T>();
  extern __shared__ __align__(16) char smem[];
  char* s_e_bufs = smem;  // [kBuffers][128] rows of T, stride kEStride
  char* s_x_bufs = s_e_bufs + kBuffers * kTileRows * kEStride;  // xj staged, then a, then msg
  float* s_w = reinterpret_cast<float*>(s_x_bufs + kBuffers * kTileRows * kRowBytes);
  TileWeights tw{};
  if constexpr (kBf16) {
    tw.wet_b = reinterpret_cast<__nv_bfloat16*>(s_w);
    tw.w2t_b = tw.wet_b + kP * kLdb;
    tw.vec = reinterpret_cast<float*>(tw.w2t_b + kP * kLdb);
  } else {
    tw.we_hi = s_w;  // [D, H] padded to [64, kLd]
    tw.we_lo = tw.we_hi + kP * kLd;
    tw.w2_hi = tw.we_lo + kP * kLd;  // [H, D]
    tw.w2_lo = tw.w2_hi + kP * kLd;
    tw.vec = tw.w2_lo + kP * kLd;
  }

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // zero everything once: padded columns stay zero, and no tile reads
  // uninitialised words
  for (int i = tid; i < static_cast<int>(fwd_shared_bytes<T>() / 4); i += kThreads)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  stage_weights<T, !kBf16>(tw, we, be, w2, b2, lns, lnb, D, H);

  const int per_tile = kTileRows / K;  // receivers per tile
  const int tiles = (R + per_tile - 1) / per_tile;
  const float inv_d = 1.f / static_cast<float>(D);
  const int row0 = 16 * warp;  // the warp's first row in the tile

  // a tile's rows of e and xj land in buffer `buf`
  auto stage = [&](int tile, int buf) {
    const int64_t row = static_cast<int64_t>(tile) * per_tile * K;
    const int n = min(per_tile, R - tile * per_tile) * K;
    stage_rows<T>(s_e_bufs + buf * kTileRows * kEStride, kEStride, e + row * D, n, D, vec);
    stage_rows<T>(s_x_bufs + buf * kTileRows * kRowBytes, kRowBytes, xj + row * H, n, H, vec);
  };
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * per_tile;
    const int n_recv = min(per_tile, R - r0);
    const int nrows = n_recv * K;
    const int64_t e0 = static_cast<int64_t>(r0) * K;  // first edge row of the tile
    const int next = tile + gridDim.x;
    if (kBuffers == 2 && next < tiles) stage(next, buf ^ 1);  // lands while this tile computes
    const char* s_e = s_e_bufs + buf * kTileRows * kEStride;
    float* s_a = reinterpret_cast<float*>(s_x_bufs + buf * kTileRows * kRowBytes);

    int rl[2], recv[2];
    bool valid[2];
    float keep[2];
    tile_rows(rl, recv, valid, keep, degrees, row0, nrows, r0, K, g);

    // ---- h, a (into s_a), o + b2 and its LayerNorm moments ----
    float acc[8][4];
    float mu[2], inv[2];
    recompute_tile<T>(acc, mu, inv, s_e, s_a, tw, proj_i, rl, recv, valid, row0, D, H, inv_d, g, t);

    // ---- msg = (xhat * lns + lnb) * [s < deg], rounded to T, over a ----
    __syncwarp();  // every lane has read the warp's a rows for o
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1, c = 8 * j + 2 * t + (i & 1);
        s_a[rl[hr] * kLd + c] = round_to<T>(
            ((acc[j][i] - mu[hr]) * inv[hr] * tw.vec[2 * kP + c] + tw.vec[3 * kP + c]) * keep[hr]);
      }
    __syncthreads();  // every row's msg is in s_a

    // ---- new_e = e + msg, row by row; agg = the slot sums of msg ----
    if (vec) {
      const int pieces = D / kCols;
      for (int i = tid; i < nrows * pieces; i += kThreads) {
        const int row = i / pieces, p = i - row * pieces;
        residual_piece(new_e + (e0 + row) * D + p * kCols, s_e + row * kEStride + p * 16,
                       s_a + row * kLd + p * kCols);
      }
      for (int i = tid; i < n_recv * pieces; i += kThreads) {
        const int lr = i / pieces, p = i - lr * pieces;
        slot_sum_piece(agg + static_cast<int64_t>(r0 + lr) * D + p * kCols,
                       s_a + lr * K * kLd + p * kCols, K);
      }
    } else {
      for (int i = tid; i < nrows * D; i += kThreads) {
        const int row = i / D, c = i - row * D;
        const float ev = to_f32(reinterpret_cast<const T*>(s_e + row * kEStride)[c]);
        new_e[(e0 + row) * D + c] = from_f32<T>(ev + s_a[row * kLd + c]);
      }
      for (int i = tid; i < n_recv * D; i += kThreads) {
        const int lr = i / D, c = i - lr * D;
        float sum = 0.f;
        for (int sl = 0; sl < K; ++sl) sum += s_a[(lr * K + sl) * kLd + c];
        agg[static_cast<int64_t>(r0 + lr) * D + c] = from_f32<T>(sum);
      }
    }
    if (kBuffers == 1) {
      __syncthreads();  // the tile's rows are read
      if (next < tiles) stage(next, 0);
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile's rows are in; this tile's are read
    buf ^= kBuffers - 1;
  }
}

template <typename T>
cudaError_t launch_tc(const void* e, const void* xj, const float* proj_i, const float* degrees,
                      const float* we, const float* be, const float* w2, const float* b2,
                      const float* lns, const float* lnb, void* new_e, void* agg, int R, int K,
                      int D, int H, cudaStream_t stream) {
  const size_t smem = fwd_shared_bytes<T>();
  auto kernel = edge_block_fwd_tc_kernel<T>;
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
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  if (grid == 0) return cudaSuccess;
  // cp.async and the stores move 16-byte pieces: rows and bases must be
  // 16-byte aligned
  const bool vec = (D * sizeof(T)) % 16 == 0 && (H * sizeof(T)) % 16 == 0 && aligned16(e) &&
                   aligned16(xj) && aligned16(new_e) && aligned16(agg);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(e), static_cast<const T*>(xj), proj_i, degrees, we, be, w2, b2, lns,
      lnb, static_cast<T*>(new_e), static_cast<T*>(agg), R, K, D, H, vec);
  return cudaGetLastError();
}

// ---- the warp-per-receiver kernel, for shapes outside the tile ----

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per receiver (grid-stride over receivers) loops over its K
// slots, so agg needs no atomics and its sum order is fixed. We and W2 sit
// in shared memory as f32, zero-padded to NC*32 columns; lane l owns output
// columns l, l+32, ... (NC of them); the e row and relu(h) go through a
// per-warp shared row to be broadcast to all lanes for the two products.
// D, H <= NC * 32.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
edge_block_fwd_warp_kernel(const T* __restrict__ e, const T* __restrict__ xj,
                           const float* __restrict__ proj_i, const float* __restrict__ degrees,
                           const float* __restrict__ we, const float* __restrict__ be,
                           const float* __restrict__ w2, const float* __restrict__ b2,
                           const float* __restrict__ lns, const float* __restrict__ lnb,
                           T* __restrict__ new_e, T* __restrict__ agg, int R, int K, int D, int H) {
  constexpr int P = NC * 32;  // padded column count of both weight tiles
  extern __shared__ float smem_w[];
  float* s_we = smem_w;        // [D, P]  We, columns >= H zero
  float* s_w2 = s_we + D * P;  // [H, P]  W2, columns >= D zero
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_e = s_w2 + H * P + warp * 2 * P;  // this warp's edge row  [P]
  float* s_a = s_e + P;                      // this warp's relu(h)   [P]

  for (int i = threadIdx.x; i < D * P; i += blockDim.x) {
    const int row = i / P, col = i % P;
    s_we[i] = col < H ? round_to<T>(we[row * H + col]) : 0.f;
  }
  for (int i = threadIdx.x; i < H * P; i += blockDim.x) {
    const int row = i / P, col = i % P;
    s_w2[i] = col < D ? round_to<T>(w2[row * D + col]) : 0.f;
  }
  float be_r[NC], b2_r[NC], lns_r[NC], lnb_r[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    be_r[j] = c < H ? be[c] : 0.f;
    b2_r[j] = c < D ? b2[c] : 0.f;
    lns_r[j] = c < D ? lns[c] : 0.f;
    lnb_r[j] = c < D ? lnb[c] : 0.f;
  }
  __syncthreads();

  const float inv_d = 1.f / static_cast<float>(D);
  for (int r = blockIdx.x * kWarps + warp; r < R; r += gridDim.x * kWarps) {
    float pi[NC], acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      pi[j] = c < H ? proj_i[static_cast<int64_t>(r) * H + c] : 0.f;
      acc[j] = 0.f;
    }
    const float deg = degrees[r];

    for (int s = 0; s < K; ++s) {
      const int64_t row = static_cast<int64_t>(r) * K + s;
      const T* e_row = e + row * D;
      const T* xj_row = xj + row * H;

      float ev[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        ev[j] = c < D ? to_f32(e_row[c]) : 0.f;
        s_e[c] = ev[j];
      }
      __syncwarp();

      // h = e @ We + xj + proj_i + be
      float h[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) h[j] = 0.f;
#pragma unroll 4
      for (int i = 0; i < D; ++i) {
        const float ei = s_e[i];
        const float* wrow = s_we + i * P + lane;
#pragma unroll
        for (int j = 0; j < NC; ++j) h[j] = fmaf(ei, wrow[32 * j], h[j]);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        const float x = c < H ? to_f32(xj_row[c]) : 0.f;
        const float hv = ((h[j] + x) + pi[j]) + be_r[j];
        s_a[c] = round_to<T>(fmaxf(hv, 0.f));  // padded columns stay 0
      }
      __syncwarp();

      // o = a @ W2 + b2
      float o[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) o[j] = 0.f;
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        const float ai = s_a[i];
        const float* wrow = s_w2 + i * P + lane;
#pragma unroll
        for (int j = 0; j < NC; ++j) o[j] = fmaf(ai, wrow[32 * j], o[j]);
      }

      // LayerNorm over the D real columns, f32 moments
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        o[j] += b2_r[j];
        if (lane + 32 * j < D) lsum += o[j];
      }
      const float mu = warp_sum(lsum) * inv_d;
      float lvar = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float dv = o[j] - mu;
        if (lane + 32 * j < D) lvar += dv * dv;
      }
      const float inv = rsqrtf(warp_sum(lvar) * inv_d + kLnEps);
      const float keep = static_cast<float>(s) < deg ? 1.f : 0.f;

      T* out_row = new_e + row * D;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          const float msg = round_to<T>(((o[j] - mu) * inv * lns_r[j] + lnb_r[j]) * keep);
          out_row[c] = from_f32<T>(ev[j] + msg);
          acc[j] += msg;
        }
      }
      __syncwarp();  // s_e / s_a are rewritten by the next slot
    }

#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < D) agg[static_cast<int64_t>(r) * D + c] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_warp(const void* e, const void* xj, const float* proj_i, const float* degrees,
                        const float* we, const float* be, const float* w2, const float* b2,
                        const float* lns, const float* lnb, void* new_e, void* agg, int R, int K,
                        int D, int H, cudaStream_t stream) {
  constexpr int P = NC * 32;
  const size_t smem = static_cast<size_t>(D * P + H * P + kWarps * 2 * P) * sizeof(float);
  auto kernel = edge_block_fwd_warp_kernel<T, NC>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // shared memory too large
  const long long want = (static_cast<long long>(R) + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(want < cap ? want : cap);
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(e), static_cast<const T*>(xj), proj_i, degrees, we, be, w2, b2, lns,
      lnb, static_cast<T*>(new_e), static_cast<T*>(agg), R, K, D, H);
  return cudaGetLastError();
}

// 0: the tensor-core tile kernel; 1: the warp-per-receiver kernel
int fwd_variant(int K, int D, int H) { return D <= kP && H <= kP && K <= kMaxK ? 0 : 1; }

template <typename T>
cudaError_t dispatch(const void* e, const void* xj, const float* proj_i, const float* degrees,
                     const float* we, const float* be, const float* w2, const float* b2,
                     const float* lns, const float* lnb, void* new_e, void* agg, int R, int K,
                     int D, int H, cudaStream_t stream) {
  const int width = D > H ? D : H;
  if (fwd_variant(K, D, H) == 0)
    return launch_tc<T>(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, new_e, agg, R, K, D, H,
                        stream);
  if (width <= 64)
    return launch_warp<T, 2>(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, new_e, agg, R, K,
                             D, H, stream);
  if (width <= 128)
    return launch_warp<T, 4>(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, new_e, agg, R, K,
                             D, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Which kernel sgnn_edge_block_fwd launches for these shapes: 0 = the
// tensor-core tile kernel (max(D, H) <= 64 and K <= 128), 1 = the
// warp-per-receiver kernel (D, H <= 128, any K).
int sgnn_edge_block_fwd_variant(int K, int D, int H) { return fwd_variant(K, D, H); }

// dtype: 0 = float32, 1 = bfloat16 (for e, xj, new_e, agg). Returns the
// cudaError_t of the launch (0 on success).
int sgnn_edge_block_fwd(const void* e, const void* xj, const void* proj_i, const void* degrees,
                        const void* we, const void* be, const void* w2, const void* b2,
                        const void* lns, const void* lnb, void* new_e, void* agg, int R, int K,
                        int D, int H, int dtype, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (R < 0 || K < 1 || D < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(e, xj, f(proj_i), f(degrees), f(we), f(be), f(w2), f(b2), f(lns),
                          f(lnb), new_e, agg, R, K, D, H, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(e, xj, f(proj_i), f(degrees), f(we), f(be), f(w2), f(b2),
                                  f(lns), f(lnb), new_e, agg, R, K, D, H, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* sgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
