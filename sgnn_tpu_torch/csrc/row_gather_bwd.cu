// Backwards of the multi-scale model's row gathers, for NVIDIA Hopper (sm_90a).
//
// The forward of both gathers is csrc/row_gather.cu's take kernel,
// out[i, :] = tbl[idx[i], :]. Their backwards are the custom VJPs of the
// JAX model (sgnn_tpu/models/multi_scale.py), which JAX computes with XLA
// inside the VJP, outside any Pallas kernel:
//
//   _sorted_gather_bwd  (:243-248)  segment_sum(g, idx, N), idx ascending
//       -> sorted_segment_sum_kernel: d[n] = sum of g[i] over idx[i] == n.
//   _planned_gather_bwd (:266-287)  the static transpose plan: per plan row
//       r the masked slot sum of g[tsp_rows[r, k]], then a sorted segment
//       sum over tsp_node
//       -> planned_gather_bwd_kernel: d[n] = sum over plan rows r with
//          tsp_node[r] == n of (sum over slots k with tsp_mask[r, k] of
//          g[tsp_rows[r, k]]).
//
// Both are deterministic: one warp owns one output row, finds its run of
// ascending ids with a 32-way search (three probes of the id array at the
// model's sizes), sums the run in index order (the planned one: each plan
// row's slots in slot order, then the rows in row order) in f32 from 0,
// rounds once to g's type and writes the row, zero where the run is empty.
// No atomics; two launches on the same inputs give the same bits. The
// plain versions in sgnn_tpu_torch/ops/row_gather.py add in the same
// order, so the two agree bit for bit.
//
// Types: T = float or __nv_bfloat16 (g and the output), I = int32 or int64
// (the ids, the plan's rows and nodes). A row of W values is a multiple of
// 16 bytes, so each lane reads and writes whole 16-byte pieces (W = 128:
// one piece per lane in f32, 16 lanes in bf16). An id outside [0, N)
// matches no output row (JAX's segment_sum drops it); a plan row index is
// clamped into [0, rows of g), as XLA's gather clamps.
//
// What bounds them: no arithmetic to speak of; the bytes. The least each
// must move is g's rows that the ids (the plan's unmasked slots) name,
// the ids (plan) once and the [N, W] output. The design is the simplest
// that writes each output once without atomics: a warp per output row,
// the search's probes and the runs' rows read through L2. The warps of
// rows with an empty run only search and write zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps, one output row each
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Piece;  // a 16-byte piece of a row, as f32 values

template <>
struct Piece<float> {
  static constexpr int kValues = 4;
  __device__ __forceinline__ static void add(float* acc, const uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                      __float_as_uint(acc[3]));
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kValues = 8;
  // element 2j in the low half of word j (little-endian); bf16 -> f32 is exact
  __device__ __forceinline__ static void add2(float* acc, unsigned w) {
    acc[0] += __uint_as_float(w << 16);
    acc[1] += __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void add(float* acc, const uint4 v) {
    add2(acc + 0, v.x);
    add2(acc + 2, v.y);
    add2(acc + 4, v.z);
    add2(acc + 6, v.w);
  }
  __device__ __forceinline__ static unsigned pack2(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float* acc) {
    return make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]), pack2(acc[4], acc[5]),
                      pack2(acc[6], acc[7]));
  }
};

// The first position p in [lo, hi) with ids[p] >= key, or hi (ids
// ascending). The 32 lanes probe 32 evenly spaced positions; the ballot
// narrows the range 32-fold per round. lo and hi stay uniform over the warp.
template <typename I>
__device__ __forceinline__ int warp_lower_bound(const I* __restrict__ ids, int lo, int hi, long long key,
                                                int lane) {
  while (lo < hi) {
    const int stride = (hi - lo + 31) / 32;
    const int pos = lo + lane * stride;
    const bool ge = pos >= hi || static_cast<long long>(ids[pos]) >= key;
    const unsigned ballot = __ballot_sync(kFull, ge);
    if (ballot == 0) {  // every probe < key: past the last one
      lo += 31 * stride + 1;
    } else {
      const int first = __ffs(ballot) - 1;
      const int new_hi = min(lo + first * stride, hi);
      if (first > 0) lo += (first - 1) * stride + 1;
      hi = new_hi;
    }
  }
  return lo;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const uint4* __restrict__ g, const I* __restrict__ idx, uint4* __restrict__ out,
                          int m, int n, int ppr) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= n) return;  // the whole warp
  const int begin = warp_lower_bound(idx, 0, m, node, lane);
  const int end = warp_lower_bound(idx, begin, m, node + 1LL, lane);
  for (int p = lane; p < ppr; p += 32) {
    float acc[Piece<T>::kValues] = {};
    for (int i = begin; i < end; ++i) Piece<T>::add(acc, g[static_cast<long long>(i) * ppr + p]);
    out[static_cast<long long>(node) * ppr + p] = Piece<T>::pack(acc);
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
planned_gather_bwd_kernel(const uint4* __restrict__ g, long long g_rows, const I* __restrict__ tsp_rows,
                          const I* __restrict__ tsp_node, const uint8_t* __restrict__ tsp_mask,
                          uint4* __restrict__ out, int rs, int ks, int n, int ppr) {
  constexpr int kV = Piece<T>::kValues;
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (node >= n) return;  // the whole warp
  const int begin = warp_lower_bound(tsp_node, 0, rs, node, lane);
  const int end = warp_lower_bound(tsp_node, begin, rs, node + 1LL, lane);
  // every lane runs every loop (the shuffles need the whole warp); lanes
  // past the row's last piece only pass the slots on
  for (int c = 0; c < ppr; c += 32) {
    const int p = c + lane;
    const bool live = p < ppr;
    float total[kV] = {};
    for (int r = begin; r < end; ++r) {
      float row[kV] = {};
      for (int k0 = 0; k0 < ks; k0 += 32) {
        // lane j holds slot k0 + j of plan row r: its g row, or -1 if masked
        long long src = -1;
        if (k0 + lane < ks) {
          const long long at = static_cast<long long>(r) * ks + k0 + lane;
          if (tsp_mask[at]) {
            const long long v = static_cast<long long>(tsp_rows[at]);
            src = v < 0 ? 0 : (v >= g_rows ? g_rows - 1 : v);
          }
        }
        const int count = min(32, ks - k0);
        for (int j = 0; j < count; ++j) {
          const long long s = __shfl_sync(kFull, src, j);
          if (s >= 0 && live) Piece<T>::add(row, g[s * ppr + p]);
        }
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) total[v] += row[v];
    }
    if (live) out[static_cast<long long>(node) * ppr + p] = Piece<T>::pack(total);
  }
}

int grid_for(int n) { return (n + kWarps - 1) / kWarps; }

template <typename T, typename I>
cudaError_t launch_sorted(const void* g, const void* idx, void* out, int m, int n, int ppr, cudaStream_t st) {
  sorted_segment_sum_kernel<T, I><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const uint4*>(g), static_cast<const I*>(idx), static_cast<uint4*>(out), m, n, ppr);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_planned(const void* g, long long g_rows, const void* tsp_rows, const void* tsp_node,
                           const void* tsp_mask, void* out, int rs, int ks, int n, int ppr, cudaStream_t st) {
  planned_gather_bwd_kernel<T, I><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const uint4*>(g), g_rows, static_cast<const I*>(tsp_rows), static_cast<const I*>(tsp_node),
      static_cast<const uint8_t*>(tsp_mask), static_cast<uint4*>(out), rs, ks, n, ppr);
  return cudaGetLastError();
}

// 16-byte pieces per row of W values of `dtype`, or -1 if W * size is not
// a multiple of 16
int pieces_per_row(int W, int dtype) {
  const int bytes = W * (dtype == 0 ? 4 : 2);
  return (W < 1 || bytes % 16) ? -1 : bytes / 16;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr long long kMaxCount = (1LL << 31) - 64;  // int positions, with room for the search's probes

}  // namespace

extern "C" {

// g [m, W], idx [m] ascending, out [n, W]; dtype 0 = float32, 1 = bfloat16
// (g and out), idx_dtype 0 = int32, 1 = int64. Returns the cudaError_t of
// the launch (0 on success).
int sgnn_sorted_segment_sum(const void* g, const void* idx, void* out, long long m, long long n, int W, int dtype,
                            int idx_dtype, void* stream) {
  const int ppr = pieces_per_row(W, dtype);
  if (ppr < 0 || m < 0 || n < 0 || m > kMaxCount || n > kMaxCount || !aligned(g) || !aligned(out) ||
      (dtype != 0 && dtype != 1) || (idx_dtype != 0 && idx_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m), ni = static_cast<int>(n);
  cudaError_t err;
  if (dtype == 0)
    err = idx_dtype == 0 ? launch_sorted<float, int32_t>(g, idx, out, mi, ni, ppr, st)
                         : launch_sorted<float, int64_t>(g, idx, out, mi, ni, ppr, st);
  else
    err = idx_dtype == 0 ? launch_sorted<__nv_bfloat16, int32_t>(g, idx, out, mi, ni, ppr, st)
                         : launch_sorted<__nv_bfloat16, int64_t>(g, idx, out, mi, ni, ppr, st);
  return static_cast<int>(err);
}

// g [g_rows, W]; tsp_rows [rs, ks] and tsp_node [rs] (ascending) of
// idx_dtype; tsp_mask [rs, ks] bool (one byte each); out [n, W]. Types as
// sgnn_sorted_segment_sum's.
int sgnn_planned_gather_bwd(const void* g, long long g_rows, const void* tsp_rows, const void* tsp_node,
                            const void* tsp_mask, void* out, long long rs, long long ks, long long n, int W,
                            int dtype, int idx_dtype, void* stream) {
  const int ppr = pieces_per_row(W, dtype);
  if (ppr < 0 || g_rows < 1 || rs < 0 || ks < 0 || n < 0 || rs > kMaxCount || n > kMaxCount ||
      rs * ks > (1LL << 40) || ks > kMaxCount || !aligned(g) || !aligned(out) || (dtype != 0 && dtype != 1) ||
      (idx_dtype != 0 && idx_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rs), k = static_cast<int>(ks), ni = static_cast<int>(n);
  cudaError_t err;
  if (dtype == 0)
    err = idx_dtype == 0
              ? launch_planned<float, int32_t>(g, g_rows, tsp_rows, tsp_node, tsp_mask, out, r, k, ni, ppr, st)
              : launch_planned<float, int64_t>(g, g_rows, tsp_rows, tsp_node, tsp_mask, out, r, k, ni, ppr, st);
  else
    err = idx_dtype == 0
              ? launch_planned<__nv_bfloat16, int32_t>(g, g_rows, tsp_rows, tsp_node, tsp_mask, out, r, k, ni,
                                                       ppr, st)
              : launch_planned<__nv_bfloat16, int64_t>(g, g_rows, tsp_rows, tsp_node, tsp_mask, out, r, k, ni,
                                                       ppr, st);
  return static_cast<int>(err);
}

const char* sgnn_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
