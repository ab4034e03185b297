// The plain edge stage's epilogue, forward and backward, for NVIDIA Hopper (sm_90a).
//
// No Pallas original. The JAX package runs an edge stage whose MLP has two
// hidden layers (the multi-scale model, MeshGraphNets, deeper single-scale
// edge MLPs) with XLA (sgnn_tpu/models/epd_flat.py `_edge_block_xla`,
// sgnn_tpu/models/multi_scale.py `_interact_dense_scales`), and the fused
// edge-block kernels of this directory stop at D, H <= 64 and one hidden
// layer. So the port ran that stage in plain PyTorch, and after its last
// product a chain of full-size passes over the [R*K, D] edge rows: the
// bias, LayerNorm's two means, its centring, scaling and affine, the slot
// mask, the residual and the slot sum, about 12 passes forward and 20 in
// autograd's backward. These two kernels are that chain, one launch each
// way. Rows are receiver-major (row r*K + k is slot k of receiver r):
//
//   y     = o + b2                       (o: the last product, before its bias)
//   msg   = ((y - mean y) * rsqrt(var y + 1e-5) * lns + lnb) * mask
//   new_e = (e + msg) * mask
//   agg   = sum over the K slots of msg  ([R, D])
//
// with f32 moments, two-pass (the mean, then the mean square of y - mean).
// The backward recomputes the moments from o (it is the one [R*K, D]
// tensor the forward saves) and, given g_new and g_agg (either may be
// absent: zero), writes
//
//   g_msg = g_new * mask + g_agg[r];  g_ln = g_msg * mask;  g_xhat = g_ln * lns
//   g_o   = rstd * (g_xhat - mean g_xhat - xhat * mean(g_xhat * xhat))
//   g_e   = g_new * mask
//
// and the three parameter gradients g_b2 = sum g_o, g_lns = sum g_ln * xhat,
// g_lnb = sum g_ln over every row: each warp keeps its rows' sums in
// registers, each block adds its warps' in warp order into one partial row
// per block, and a second launch adds the blocks' partials in block order.
// No atomics: two launches on the same inputs give the same bits.
//
// What bounds them: the bytes. A row is D <= 128 f32 values, a handful of
// operations each. The least the forward must move is o and e at the live
// slots, the mask, and new_e and agg written once; the backward o and g_new
// at the live slots, g_agg, the mask, and g_o and g_e written once. At the
// models' shapes (155,648-466,944 rows) every pass is far past the 50 MB L2,
// so the unfused chain paid its 12 and 20 passes in full. Design:
//
//   * one warp per receiver at a time (a persistent grid, receivers strided
//     over its warps), its K slots in turn; a lane holds 4 columns of a row
//     (one float4 load or store of each tensor), so a row's moments are
//     two warp butterflies, and agg stays in registers and is written once;
//   * the receiver's K mask values come in loads of 32 (a lane a slot, one
//     group of slots at a time, so any K); a masked slot is written as
//     zeros without reading o, e or g_new (the world edges of
//     MeshGraphNets are two thirds masked slots);
//   * the next live row's loads are issued before this row's arithmetic;
//   * the grid is the blocks the card holds at once, at most one warp a
//     receiver: a fixed count per card, so the partials' order is fixed.
//
// D is at most 128 and a multiple of 4 (lanes past D/4 hold zeros); K is
// any count of slots.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-5f;
constexpr int kMaxD = 128;
constexpr int kParts = 3;  // g_b2, g_lns, g_lnb

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: lanes i and i ^ off add the same two values, so every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* __restrict__ p, long long q) {
  return reinterpret_cast<const float4*>(p)[q];
}

__device__ __forceinline__ void st4(float* __restrict__ p, long long q, float4 v) {
  reinterpret_cast<float4*>(p)[q] = v;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// the row's LayerNorm statistics from y = o + b2: xhat (zero on lanes past D) and rstd
struct Moments {
  float4 xh;
  float rstd;
};

__device__ __forceinline__ Moments moments(float4 vo, float4 vb, bool on, float fd) {
  float4 y = make_float4(vo.x + vb.x, vo.y + vb.y, vo.z + vb.z, vo.w + vb.w);
  const float mean = warp_sum(on ? ((y.x + y.y) + y.z) + y.w : 0.f) / fd;
  float4 c = on ? make_float4(y.x - mean, y.y - mean, y.z - mean, y.w - mean) : zero4();
  const float var = warp_sum(((c.x * c.x + c.y * c.y) + c.z * c.z) + c.w * c.w) / fd;
  const float rstd = rsqrtf(var + kEps);
  return {make_float4(c.x * rstd, c.y * rstd, c.z * rstd, c.w * rstd), rstd};
}

// this slot group's mask values (lane j: slot k0 + j) and the live slots as bits
__device__ __forceinline__ unsigned slot_masks(const float* __restrict__ mask, long long row0, int kn, int lane,
                                               float* mv) {
  *mv = lane < kn ? mask[row0 + lane] : 0.f;
  return __ballot_sync(kFull, *mv != 0.f);
}

__device__ __forceinline__ unsigned group_bits(int kn) { return kn == 32 ? kFull : (1u << kn) - 1u; }

__global__ void __launch_bounds__(kThreads)
edge_epilogue_fwd_kernel(const float* __restrict__ o, const float* __restrict__ b2, const float* __restrict__ lns,
                         const float* __restrict__ lnb, const float* __restrict__ mask, const float* __restrict__ e,
                         float* __restrict__ new_e, float* __restrict__ agg, int R, int K, int D) {
  const int lane = threadIdx.x & 31;
  const bool on = 4 * lane < D;  // lane holds columns 4 lane .. 4 lane + 3
  const int q4 = D / 4;
  const float fd = static_cast<float>(D);
  const float4 vb = on ? ld4(b2, lane) : zero4();
  const float4 vw = on ? ld4(lns, lane) : zero4();
  const float4 vc = on ? ld4(lnb, lane) : zero4();
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < R; r += nwarps) {
    float4 acc = zero4();
    for (int k0 = 0; k0 < K; k0 += 32) {
      const long long row0 = r * K + k0;
      const int kn = K - k0 < 32 ? K - k0 : 32;
      float mv;
      unsigned live = slot_masks(mask, row0, kn, lane, &mv);
      for (unsigned dead = ~live & group_bits(kn); dead; dead &= dead - 1)
        if (on) st4(new_e, (row0 + __ffs(dead) - 1) * q4 + lane, zero4());
      int j = live ? __ffs(live) - 1 : -1;
      float4 no = zero4(), ne = zero4();
      if (j >= 0 && on) {
        no = ld4(o, (row0 + j) * q4 + lane);
        ne = ld4(e, (row0 + j) * q4 + lane);
      }
      while (j >= 0) {
        const float4 vo = no, ve = ne;
        live &= live - 1;
        const int jn = live ? __ffs(live) - 1 : -1;
        if (jn >= 0 && on) {  // the next live row's loads, in flight during this row's arithmetic
          no = ld4(o, (row0 + jn) * q4 + lane);
          ne = ld4(e, (row0 + jn) * q4 + lane);
        }
        const float m = __shfl_sync(kFull, mv, j);
        const Moments s = moments(vo, vb, on, fd);
        const float4 msg = make_float4((s.xh.x * vw.x + vc.x) * m, (s.xh.y * vw.y + vc.y) * m,
                                       (s.xh.z * vw.z + vc.z) * m, (s.xh.w * vw.w + vc.w) * m);
        if (on) {
          st4(new_e, (row0 + j) * q4 + lane,
              make_float4((ve.x + msg.x) * m, (ve.y + msg.y) * m, (ve.z + msg.z) * m, (ve.w + msg.w) * m));
          acc = make_float4(acc.x + msg.x, acc.y + msg.y, acc.z + msg.z, acc.w + msg.w);
        }
        j = jn;
      }
    }
    if (on) st4(agg, r * q4 + lane, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
edge_epilogue_bwd_kernel(const float* __restrict__ o, const float* __restrict__ b2, const float* __restrict__ lns,
                         const float* __restrict__ mask, const float* __restrict__ g_new,
                         const float* __restrict__ g_agg, float* __restrict__ g_o, float* __restrict__ g_e,
                         float4* __restrict__ partials, int R, int K, int D) {
  __shared__ float4 sums[kWarps][kParts][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool on = 4 * lane < D;
  const int q4 = D / 4;
  const float fd = static_cast<float>(D);
  const float4 vb = on ? ld4(b2, lane) : zero4();
  const float4 vw = on ? ld4(lns, lane) : zero4();
  // this warp's sums over its rows: g_o (-> g_b2), g_ln * xhat (-> g_lns), g_ln (-> g_lnb)
  float4 pb = zero4(), pw = zero4(), pc = zero4();
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r < R; r += nwarps) {
    const float4 ga = g_agg != nullptr && on ? ld4(g_agg, r * q4 + lane) : zero4();
    for (int k0 = 0; k0 < K; k0 += 32) {
      const long long row0 = r * K + k0;
      const int kn = K - k0 < 32 ? K - k0 : 32;
      float mv;
      unsigned live = slot_masks(mask, row0, kn, lane, &mv);
      for (unsigned dead = ~live & group_bits(kn); dead; dead &= dead - 1) {
        if (on) {
          const long long q = (row0 + __ffs(dead) - 1) * q4 + lane;
          st4(g_o, q, zero4());
          st4(g_e, q, zero4());
        }
      }
      int j = live ? __ffs(live) - 1 : -1;
      float4 no = zero4(), ng = zero4();
      if (j >= 0 && on) {
        no = ld4(o, (row0 + j) * q4 + lane);
        if (g_new != nullptr) ng = ld4(g_new, (row0 + j) * q4 + lane);
      }
      while (j >= 0) {
        const float4 vo = no, vg = ng;
        live &= live - 1;
        const int jn = live ? __ffs(live) - 1 : -1;
        if (jn >= 0 && on) {
          no = ld4(o, (row0 + jn) * q4 + lane);
          if (g_new != nullptr) ng = ld4(g_new, (row0 + jn) * q4 + lane);
        }
        const float m = __shfl_sync(kFull, mv, j);
        const Moments s = moments(vo, vb, on, fd);
        const float4 ge = make_float4(vg.x * m, vg.y * m, vg.z * m, vg.w * m);
        const float4 gl = make_float4((ge.x + ga.x) * m, (ge.y + ga.y) * m, (ge.z + ga.z) * m, (ge.w + ga.w) * m);
        const float4 gx = make_float4(gl.x * vw.x, gl.y * vw.y, gl.z * vw.z, gl.w * vw.w);
        const float mg = warp_sum(((gx.x + gx.y) + gx.z) + gx.w) / fd;
        const float mgx = warp_sum(((gx.x * s.xh.x + gx.y * s.xh.y) + gx.z * s.xh.z) + gx.w * s.xh.w) / fd;
        const float4 gy = make_float4(s.rstd * (gx.x - mg - s.xh.x * mgx), s.rstd * (gx.y - mg - s.xh.y * mgx),
                                      s.rstd * (gx.z - mg - s.xh.z * mgx), s.rstd * (gx.w - mg - s.xh.w * mgx));
        if (on) {
          const long long q = (row0 + j) * q4 + lane;
          st4(g_o, q, gy);
          st4(g_e, q, ge);
          pb = make_float4(pb.x + gy.x, pb.y + gy.y, pb.z + gy.z, pb.w + gy.w);
          pw = make_float4(pw.x + gl.x * s.xh.x, pw.y + gl.y * s.xh.y, pw.z + gl.z * s.xh.z, pw.w + gl.w * s.xh.w);
          pc = make_float4(pc.x + gl.x, pc.y + gl.y, pc.z + gl.z, pc.w + gl.w);
        }
        j = jn;
      }
    }
  }
  sums[warp][0][lane] = pb;
  sums[warp][1][lane] = pw;
  sums[warp][2][lane] = pc;
  __syncthreads();
  for (int t = threadIdx.x; t < kParts * 32; t += kThreads) {  // the block's partial row, warps in order
    const int part = t / 32, l = t % 32;
    float4 v = sums[0][part][l];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 u = sums[w][part][l];
      v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
    }
    partials[static_cast<long long>(blockIdx.x) * kParts * 32 + t] = v;
  }
}

// one warp per column of the three parameter gradients: lane l adds the
// partials of blocks l, l + 32, ... in order, then a butterfly adds the lanes
__global__ void __launch_bounds__(kThreads)
edge_epilogue_reduce_kernel(const float* __restrict__ partials, int blocks, float* __restrict__ g_b2,
                            float* __restrict__ g_lns, float* __restrict__ g_lnb, int D) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);  // part * kMaxD + column
  if (col >= kParts * kMaxD) return;  // whole warps only: no warp-wide operation is cut
  float v = 0.f;
#pragma unroll 4
  for (int b = lane; b < blocks; b += 32) v += partials[static_cast<long long>(b) * kParts * kMaxD + col];
  v = warp_sum(v);
  const int part = col / kMaxD, c = col % kMaxD;
  if (lane == 0 && c < D) (part == 0 ? g_b2 : part == 1 ? g_lns : g_lnb)[c] = v;
}

// blocks of a persistent grid: as many as the card holds at once, at most one warp a receiver
template <typename Kernel>
int grid_blocks(Kernel kernel, long long R, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess) *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (R + kWarps - 1) / kWarps;
  return static_cast<int>(need < most ? need : most);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool shape_ok(long long R, int K, int D) {
  return R >= 0 && R < (1LL << 31) && K >= 1 && D >= 4 && D <= kMaxD && D % 4 == 0;
}

}  // namespace

extern "C" {

// Blocks of the backward's grid for R receivers on the current device (the
// partials hold 3 * 128 floats a block); 0 where R is 0, -1 on an error.
int sgnn_edge_epilogue_bwd_blocks(long long R) {
  if (R <= 0) return 0;
  cudaError_t err;
  const int blocks = grid_blocks(edge_epilogue_bwd_kernel, R, &err);
  return err == cudaSuccess ? blocks : -1;
}

// o, e, new_e [R*K, D]; b2, lns, lnb [D]; mask [R*K]; agg [R, D]; all f32,
// 16-byte aligned. One launch on `stream`; returns its cudaError_t.
int sgnn_edge_epilogue_fwd(const void* o, const void* b2, const void* lns, const void* lnb, const void* mask,
                           const void* e, void* new_e, void* agg, long long R, int K, int D, void* stream) {
  if (!shape_ok(R, K, D) || !aligned(o) || !aligned(e) || !aligned(new_e) || !aligned(agg) || !aligned(b2) ||
      !aligned(lns) || !aligned(lnb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  const int blocks = grid_blocks(edge_epilogue_fwd_kernel, R, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_epilogue_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(b2), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const float*>(mask), static_cast<const float*>(e),
      static_cast<float*>(new_e), static_cast<float*>(agg), static_cast<int>(R), K, D);
  return static_cast<int>(cudaGetLastError());
}

// o, g_o, g_e [R*K, D]; g_new [R*K, D] or null (zero); g_agg [R, D] or null;
// partials: `blocks` (sgnn_edge_epilogue_bwd_blocks(R)) rows of 3 * 128
// floats; g_b2, g_lns, g_lnb [D]. Two launches on `stream`; returns their
// cudaError_t.
int sgnn_edge_epilogue_bwd(const void* o, const void* b2, const void* lns, const void* mask, const void* g_new,
                           const void* g_agg, void* g_o, void* g_e, void* partials, int blocks, void* g_b2,
                           void* g_lns, void* g_lnb, long long R, int K, int D, void* stream) {
  if (!shape_ok(R, K, D) || blocks < 1 || !aligned(o) || !aligned(g_o) || !aligned(g_e) || !aligned(partials) ||
      !aligned(b2) || !aligned(lns) || (g_new != nullptr && !aligned(g_new)) ||
      (g_agg != nullptr && !aligned(g_agg)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  edge_epilogue_bwd_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(b2), static_cast<const float*>(lns),
      static_cast<const float*>(mask), static_cast<const float*>(g_new), static_cast<const float*>(g_agg),
      static_cast<float*>(g_o), static_cast<float*>(g_e), static_cast<float4*>(partials), static_cast<int>(R), K, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_epilogue_reduce_kernel<<<kParts * kMaxD / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(partials), blocks, static_cast<float*>(g_b2), static_cast<float*>(g_lns),
      static_cast<float*>(g_lnb), D);
  return static_cast<int>(cudaGetLastError());
}

const char* sgnn_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
