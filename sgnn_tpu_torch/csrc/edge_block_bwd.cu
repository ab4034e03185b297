// Fused edge-block backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of sgnn_tpu/experimental/edge_block.py
// (reached through `_fused_bwd`, the custom_vjp backward of `fused_edge_block`).
// It recomputes the forward of each edge row r*K + s from the saved inputs,
//
//   h = e @ We + xj + proj_i[r] + be,  a = relu(h),  o = a @ W2 + b2,
//   xhat = (o - mean) * inv,  inv = rsqrt(var + 1e-5)   (f32 moments)
//
// with We and W2 rounded to T and a rounded to T, exactly as
// edge_block_fwd.cu does (the same loop, so the ReLU gate h > 0 is the one
// the forward took), and then takes the gradients
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
// (R = 155,648, K = 8, D = H = 64) it reads e, xj, g_new and writes g_e,
// g_xj (5 x 319 MB) and moves ~1.71 GB in all, against six products of
// 2*E*D*H each (two recomputed, four for the gradients) = 61.2 GFLOP: at
// 67 TFLOP/s without tensor cores that is 0.91 ms against 0.51 ms for the
// bytes, so in f32 it is bound by operations; in bf16 (half the bytes, the
// products at the tensor-core rate) by bytes. These counts take every slot
// as valid: a masked slot (slot >= degree) needs no read of e or xj and no
// products, so the bound of a real graph is lower by its share of them.
//
// Design (simple and deterministic; tensor cores, TMA and a persistent
// pipeline are left to later work):
//   * one warp per receiver walks its K slots (grid-stride over blocks of
//     8 receivers); lane l owns columns l, l+32 (NC chunks of 32), so the
//     row loads and stores are coalesced and g_proj_i is a register sum in
//     a fixed slot order;
//   * the four weight tiles sit in shared memory as f32, zero-padded to
//     NC*32 columns: We and W2 rounded to T for the recompute, We^T and W2^T
//     unrounded for the gradient products. Row vectors that every lane needs
//     (e, a, g_o, g_h) go through a per-warp shared row;
//   * the weight gradients are sums over all E edges. No float atomics:
//     after each slot the block waits (__syncthreads) and every thread adds
//     the 8 warps' staged rows, in warp order, into the entries of g_we and
//     g_w2 it owns (registers). The vector gradients are per-lane register
//     sums. Each block then writes one partial of every weight gradient to a
//     workspace, and a second small kernel sums the partials over the blocks
//     in block order. The grid depends only on the shapes and the card, so
//     two launches on the same inputs give the same bits.
// Like the forward, each inner product reads one weight word from shared
// memory per FMA, and the outer products one staged word per FMA: the
// instruction stream, not memory, caps this design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (receivers in flight) per block
constexpr int kThreads = kWarps * 32;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Floats of one block's partial: g_we [D,H], g_be [H], g_w2 [H,D], g_b2,
// g_lns, g_lnb [D] (the order of _bwd_kernel's outputs).
__host__ __device__ __forceinline__ int partial_floats(int D, int H) {
  return 2 * D * H + H + 3 * D;
}

template <int NC>
size_t shared_bytes(int D, int H) {
  constexpr int P = NC * 32;
  // s_we [D,P], s_w2 [H,P], s_wet [H,P], s_w2t [D,P], staged rows [kWarps][4][P]
  return static_cast<size_t>(2 * D * P + 2 * H * P + kWarps * 4 * P) * sizeof(float);
}

// NC = column chunks per lane: D, H <= NC * 32, with NC in {1, 2}.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
edge_block_bwd_kernel(const T* __restrict__ e, const T* __restrict__ xj,
                      const float* __restrict__ proj_i, const float* __restrict__ degrees,
                      const float* __restrict__ we, const float* __restrict__ be,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ lns, const float* __restrict__ lnb,
                      const T* __restrict__ g_new, const T* __restrict__ g_agg,
                      T* __restrict__ g_e, T* __restrict__ g_xj, T* __restrict__ g_proj_i,
                      float* __restrict__ partials, int R, int K, int D, int H) {
  constexpr int P = NC * 32;             // padded column count of every tile
  constexpr int EPT = P * P / kThreads;  // g_we / g_w2 entries per thread (4 or 16)
  static_assert(EPT % 4 == 0, "owned rows are read as float4");
  extern __shared__ __align__(16) float smem[];
  float* s_we = smem;            // [D, P]  We rounded to T, columns >= H zero
  float* s_w2 = s_we + D * P;    // [H, P]  W2 rounded to T, columns >= D zero
  float* s_wet = s_w2 + H * P;   // [H, P]  s_wet[i][c] = We[c][i], columns >= D zero
  float* s_w2t = s_wet + H * P;  // [D, P]  s_w2t[c][i] = W2[i][c], columns >= H zero
  float* s_rows = s_w2t + D * P; // [kWarps][4][P]  staged e, a, g_o, g_h per warp
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* s_e = s_rows + warp * 4 * P;
  float* s_a = s_e + P;
  float* s_go = s_a + P;
  float* s_gh = s_go + P;

  for (int i = tid; i < D * P; i += kThreads) {
    const int row = i / P, col = i % P;
    s_we[i] = col < H ? round_to<T>(we[row * H + col]) : 0.f;
    s_w2t[i] = col < H ? w2[col * D + row] : 0.f;
  }
  for (int i = tid; i < H * P; i += kThreads) {
    const int row = i / P, col = i % P;
    s_w2[i] = col < D ? round_to<T>(w2[row * D + col]) : 0.f;
    s_wet[i] = col < D ? we[col * H + row] : 0.f;
  }
  float be_r[NC], b2_r[NC], lns_r[NC], lnb_r[NC];
  float acc_be[NC], acc_b2[NC], acc_lns[NC], acc_lnb[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    be_r[j] = c < H ? be[c] : 0.f;
    b2_r[j] = c < D ? b2[c] : 0.f;
    lns_r[j] = c < D ? lns[c] : 0.f;
    lnb_r[j] = c < D ? lnb[c] : 0.f;
    acc_be[j] = acc_b2[j] = acc_lns[j] = acc_lnb[j] = 0.f;
  }
  // this thread's entries of g_we (rows own_row.., column own_col) and of
  // g_w2 (the same positions in its [H, D] layout)
  const int own_col = tid % P;
  const int own_row = (tid / P) * EPT;
  float acc_we[EPT], acc_w2[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) acc_we[q] = acc_w2[q] = 0.f;
  __syncthreads();

  const float inv_d = 1.f / static_cast<float>(D);
  // every warp of a block runs the same number of rounds and slots, so the
  // block-wide barriers below are reached by all of its threads
  for (int base = blockIdx.x * kWarps; base < R; base += gridDim.x * kWarps) {
    const int r = base + warp;
    const bool active = r < R;
    float pi[NC], gagg[NC], acc_gpi[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      pi[j] = active && c < H ? proj_i[static_cast<int64_t>(r) * H + c] : 0.f;
      gagg[j] = active && c < D ? to_f32(g_agg[static_cast<int64_t>(r) * D + c]) : 0.f;
      acc_gpi[j] = 0.f;
    }
    const float deg = active ? degrees[r] : 0.f;

    for (int s = 0; s < K; ++s) {
      if (active) {
        const int64_t row = static_cast<int64_t>(r) * K + s;
        const T* e_row = e + row * D;
        const T* xj_row = xj + row * H;
        const T* gn_row = g_new + row * D;

#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          s_e[c] = c < D ? to_f32(e_row[c]) : 0.f;
        }
        __syncwarp();

        // h = e @ We + xj + proj_i + be (the forward kernel's loop)
        float hv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) hv[j] = 0.f;
#pragma unroll 4
        for (int i = 0; i < D; ++i) {
          const float ei = s_e[i];
          const float* wrow = s_we + i * P + lane;
#pragma unroll
          for (int j = 0; j < NC; ++j) hv[j] = fmaf(ei, wrow[32 * j], hv[j]);
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          const float x = c < H ? to_f32(xj_row[c]) : 0.f;
          hv[j] = ((hv[j] + x) + pi[j]) + be_r[j];
          s_a[c] = round_to<T>(fmaxf(hv[j], 0.f));  // padded columns stay 0
        }
        __syncwarp();

        // o = a @ W2 + b2, LayerNorm statistics over the D real columns
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

        // LayerNorm backward: g_o from g_msg (zero beyond D)
        float xhat[NC], gm[NC], gx[NC];
        float l1 = 0.f, l2 = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          const bool in = c < D;
          xhat[j] = in ? (o[j] - mu) * inv : 0.f;
          gm[j] = in ? (to_f32(gn_row[c]) + gagg[j]) * keep : 0.f;
          gx[j] = gm[j] * lns_r[j];
          l1 += gx[j] * xhat[j];
          l2 += gx[j];
        }
        const float m1 = warp_sum(l1) * inv_d;
        const float m2 = warp_sum(l2) * inv_d;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          const float go = c < D ? inv * (gx[j] - xhat[j] * m1 - m2) : 0.f;
          s_go[c] = go;
          acc_b2[j] += go;
          acc_lns[j] += gm[j] * xhat[j];
          acc_lnb[j] += gm[j];
        }
        __syncwarp();

        // g_h = (g_o @ W2^T) * [h > 0]
        float gh[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) gh[j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < D; ++c) {
          const float goc = s_go[c];
          const float* wrow = s_w2t + c * P + lane;
#pragma unroll
          for (int j = 0; j < NC; ++j) gh[j] = fmaf(goc, wrow[32 * j], gh[j]);
        }
        T* gxj_row = g_xj + row * H;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          gh[j] = hv[j] > 0.f ? gh[j] : 0.f;
          s_gh[c] = gh[j];
          acc_gpi[j] += gh[j];
          acc_be[j] += gh[j];
          if (c < H) gxj_row[c] = from_f32<T>(gh[j]);
        }
        __syncwarp();

        // g_e = g_new + g_h @ We^T
        float ge[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) ge[j] = 0.f;
#pragma unroll 4
        for (int i = 0; i < H; ++i) {
          const float ghi = s_gh[i];
          const float* wrow = s_wet + i * P + lane;
#pragma unroll
          for (int j = 0; j < NC; ++j) ge[j] = fmaf(ghi, wrow[32 * j], ge[j]);
        }
        T* ge_row = g_e + row * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          if (c < D) ge_row[c] = from_f32<T>(to_f32(gn_row[c]) + ge[j]);
        }
      } else {
        // no receiver: stage zeros, so this warp adds nothing below
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          s_e[c] = s_a[c] = s_go[c] = s_gh[c] = 0.f;
        }
      }
      __syncthreads();

      // g_we[c][i] += e[c] * g_h[i];  g_w2[i][c] += a[i] * g_o[c]
      // over the 8 staged edges, in warp order
#pragma unroll 1
      for (int w = 0; w < kWarps; ++w) {
        const float* rows = s_rows + w * 4 * P;
        const float ghv = rows[3 * P + own_col];
        const float gov = rows[2 * P + own_col];
        const float4* ev4 = reinterpret_cast<const float4*>(rows + own_row);
        const float4* av4 = reinterpret_cast<const float4*>(rows + P + own_row);
#pragma unroll
        for (int q = 0; q < EPT / 4; ++q) {
          const float4 ev = ev4[q];
          const float4 av = av4[q];
          acc_we[4 * q + 0] = fmaf(ev.x, ghv, acc_we[4 * q + 0]);
          acc_we[4 * q + 1] = fmaf(ev.y, ghv, acc_we[4 * q + 1]);
          acc_we[4 * q + 2] = fmaf(ev.z, ghv, acc_we[4 * q + 2]);
          acc_we[4 * q + 3] = fmaf(ev.w, ghv, acc_we[4 * q + 3]);
          acc_w2[4 * q + 0] = fmaf(av.x, gov, acc_w2[4 * q + 0]);
          acc_w2[4 * q + 1] = fmaf(av.y, gov, acc_w2[4 * q + 1]);
          acc_w2[4 * q + 2] = fmaf(av.z, gov, acc_w2[4 * q + 2]);
          acc_w2[4 * q + 3] = fmaf(av.w, gov, acc_w2[4 * q + 3]);
        }
      }
      __syncthreads();  // the staged rows are rewritten by the next slot
    }

    if (active) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < H) g_proj_i[static_cast<int64_t>(r) * H + c] = from_f32<T>(acc_gpi[j]);
      }
    }
  }

  // this block's partial of every weight gradient
  const int W = partial_floats(D, H);
  float* out = partials + static_cast<int64_t>(blockIdx.x) * W;
  float* o_we = out;              // [D, H]
  float* o_be = o_we + D * H;     // [H]
  float* o_w2 = o_be + H;         // [H, D]
  float* o_b2 = o_w2 + H * D;     // [D]
  float* o_lns = o_b2 + D;
  float* o_lnb = o_lns + D;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int row = own_row + q;
    if (row < D && own_col < H) o_we[row * H + own_col] = acc_we[q];
    if (row < H && own_col < D) o_w2[row * D + own_col] = acc_w2[q];
  }
  // the vector sums: per warp into shared rows, then over warps in order
  float* red = s_rows + warp * 4 * P;  // free since the last barrier
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    red[c] = acc_be[j];
    red[P + c] = acc_b2[j];
    red[2 * P + c] = acc_lns[j];
    red[3 * P + c] = acc_lnb[j];
  }
  __syncthreads();
  for (int i = tid; i < 4 * P; i += kThreads) {
    const int v = i / P, c = i % P;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += s_rows[w * 4 * P + i];
    if (v == 0 && c < H) o_be[c] = sum;
    if (v == 1 && c < D) o_b2[c] = sum;
    if (v == 2 && c < D) o_lns[c] = sum;
    if (v == 3 && c < D) o_lnb[c] = sum;
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

template <typename T, int NC>
cudaError_t grid_size(int R, int D, int H, int* grid) {
  const size_t smem = shared_bytes<NC>(D, H);
  auto kernel = edge_block_bwd_kernel<T, NC>;
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
  const long long want = (static_cast<long long>(R) + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(want < cap ? want : cap);
  return cudaSuccess;
}

template <typename T, int NC>
cudaError_t launch(const void* const* in, void* g_e, void* g_xj, void* g_proj_i, float* partials,
                   float* wgrads, int R, int K, int D, int H, int grid, cudaStream_t stream) {
  int expect = 0;
  cudaError_t err = grid_size<T, NC>(R, D, H, &expect);
  if (err != cudaSuccess) return err;
  if (grid != expect) return cudaErrorInvalidValue;  // workspace sized for another grid
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (grid > 0) {
    edge_block_bwd_kernel<T, NC><<<grid, kThreads, shared_bytes<NC>(D, H), stream>>>(
        static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), f(in[2]), f(in[3]), f(in[4]),
        f(in[5]), f(in[6]), f(in[7]), f(in[8]), f(in[9]), static_cast<const T*>(in[10]),
        static_cast<const T*>(in[11]), static_cast<T*>(g_e), static_cast<T*>(g_xj),
        static_cast<T*>(g_proj_i), partials, R, K, D, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int W = partial_floats(D, H);
  reduce_partials_kernel<<<(W + 255) / 256, 256, 0, stream>>>(partials, wgrads, grid, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_grid(int R, int D, int H, int* grid) {
  const int width = D > H ? D : H;
  if (width <= 32) return grid_size<T, 1>(R, D, H, grid);
  if (width <= 64) return grid_size<T, 2>(R, D, H, grid);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* const* in, void* g_e, void* g_xj, void* g_proj_i,
                     float* partials, float* wgrads, int R, int K, int D, int H, int grid,
                     cudaStream_t stream) {
  const int width = D > H ? D : H;
  if (width <= 32)
    return launch<T, 1>(in, g_e, g_xj, g_proj_i, partials, wgrads, R, K, D, H, grid, stream);
  if (width <= 64)
    return launch<T, 2>(in, g_e, g_xj, g_proj_i, partials, wgrads, R, K, D, H, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Blocks the backward launches for these shapes on the current card: the
// workspace of sgnn_edge_block_bwd holds that many partials of
// 2*D*H + H + 3*D floats. dtype: 0 = float32, 1 = bfloat16.
int sgnn_edge_block_bwd_grid(int R, int D, int H, int dtype, int* grid) {
  if (R < 0 || D < 1 || H < 1 || grid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_grid<float>(R, D, H, grid);
  else if (dtype == 1)
    err = dispatch_grid<__nv_bfloat16>(R, D, H, grid);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Inputs as the forward's plus g_new [R*K, D] and g_agg [R, D] (T). Outputs
// g_e [R*K, D], g_xj [R*K, H], g_proj_i [R, H] (T) and the weight gradients,
// f32, concatenated in wgrads as g_we [D,H], g_be [H], g_w2 [H,D], g_b2 [D],
// g_lns [D], g_lnb [D]. partials: grid * (2*D*H + H + 3*D) floats of scratch,
// grid from sgnn_edge_block_bwd_grid. Returns the cudaError_t of the launches.
int sgnn_edge_block_bwd(const void* e, const void* xj, const void* proj_i, const void* degrees,
                        const void* we, const void* be, const void* w2, const void* b2,
                        const void* lns, const void* lnb, const void* g_new, const void* g_agg,
                        void* g_e, void* g_xj, void* g_proj_i, void* partials, void* wgrads,
                        int R, int K, int D, int H, int dtype, int grid, void* stream) {
  if (R < 0 || K < 1 || D < 1 || H < 1 || grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[12] = {e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, g_new, g_agg};
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partials);
  auto w = static_cast<float*>(wgrads);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(in, g_e, g_xj, g_proj_i, p, w, R, K, D, H, grid, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(in, g_e, g_xj, g_proj_i, p, w, R, K, D, H, grid, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* sgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
