// Row gather out[i, :] = tbl[clamp(idx[i]), :] for NVIDIA Hopper (sm_90a).
//
// Replaces the three TPU kernels of scripts/gather_kernel_probe.py, each
// reached through `make_pallas_gather` (pl.pallas_call at :83):
//
//   _gather_loop_kernel    (:56-61)  one row per loop step
//       -> row_gather_loop_kernel: each warp walks its rows one at a time;
//          the lanes copy a row with 16-byte accesses.
//   _gather_unroll8_kernel (:64-71)  8 rows per step, one stacked store
//       -> row_gather_unroll8_kernel: each warp reads 8 indices and issues
//          all 8 row loads before it stores any of them, so 8 rows are in
//          flight per warp.
//   _gather_take_kernel    (:74-75)  jnp.take of the whole tile
//       -> row_gather_take_kernel: one thread per 16-byte piece of the
//          output, row = piece / pieces_per_row, over the flat output.
//
// The multi-scale model gathers its latent rows through one of these
// (sgnn_tpu_torch/ops/row_gather.py): proj_i[receivers], proj_j[senders].
//
// Types: T = float or __nv_bfloat16 (the table), I = int32 or int64 (the
// indices). A row is W * sizeof(T) bytes and must be a multiple of 16, so
// every access is one 16-byte vector (uint4); the wrapper checks the width,
// the 16-byte alignment of both pointers and that the output has fewer
// than 2^31 pieces. An index outside [0, rows) is clamped into it, as
// XLA's gather clamps, so no kernel reads outside the table.
//
// What bounds it: a gather does no arithmetic; it moves bytes. The least
// it must move is the output (n * W * sizeof(T)), the indices, and each
// table row it reads once. The TPU design keeps the whole table in VMEM.
// On this card a block's 227 KB of shared memory does not hold it (2.5 MB
// in the multi-scale model, 4.9 MB (bf16) or 9.8 MB (f32) in the probe),
// so the table is left to the 50 MB L2, where rows read by many indices
// stay after their first read from HBM; every write goes out as a full
// 16-byte vector, and neighbouring lanes write neighbouring addresses.
// Plain loads and stores: TMA and cp.async pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // threads per block (8 warps)
constexpr int kBlocksPerSm = 8;      // grid cap of the warp-walking kernels
constexpr int kUnroll = 8;           // rows in flight per warp (unroll8)

template <typename I>
__device__ __forceinline__ long long clamp_row(I v, int rows) {
  const long long r = static_cast<long long>(v);
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

template <typename T>
__device__ __forceinline__ int pieces_per_row(int W) {
  static_assert(16 % sizeof(T) == 0, "a 16-byte piece holds whole elements");
  return W / static_cast<int>(16 / sizeof(T));
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_loop_kernel(const uint4* __restrict__ tbl, const I* __restrict__ idx,
                       uint4* __restrict__ out, int n, int rows, int W) {
  const int ppr = pieces_per_row<T>(W);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  for (int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); i < n; i += warps) {
    const uint4* src = tbl + clamp_row(idx[i], rows) * ppr;
    uint4* dst = out + static_cast<long long>(i) * ppr;
    for (int p = lane; p < ppr; p += 32) dst[p] = src[p];
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_unroll8_kernel(const uint4* __restrict__ tbl, const I* __restrict__ idx,
                          uint4* __restrict__ out, int n, int rows, int W) {
  const int ppr = pieces_per_row<T>(W);
  const int lane = threadIdx.x & 31;
  const int groups = (n + kUnroll - 1) / kUnroll;
  const int warps = gridDim.x * (kThreads / 32);
  for (int g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); g < groups; g += warps) {
    const int base = g * kUnroll;
    // lanes 0..7 read the group's indices; every lane then holds all 8
    long long mine = 0;
    if (lane < kUnroll && base + lane < n) mine = clamp_row(idx[base + lane], rows);
    long long src[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) src[j] = __shfl_sync(0xffffffffu, mine, j);
    const int live = n - base < kUnroll ? n - base : kUnroll;
    for (int c = 0; c < ppr; c += 32) {
      const int p = c + lane;
      if (p >= ppr) break;
      uint4 v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < live) v[j] = tbl[src[j] * ppr + p];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < live) out[static_cast<long long>(base + j) * ppr + p] = v[j];
    }
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_take_kernel(const uint4* __restrict__ tbl, const I* __restrict__ idx,
                       uint4* __restrict__ out, int n, int rows, int W) {
  const unsigned ppr = static_cast<unsigned>(pieces_per_row<T>(W));
  const unsigned total = static_cast<unsigned>(n) * ppr;  // < 2^31, checked by the wrapper
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const unsigned i = g / ppr;
  out[g] = tbl[clamp_row(idx[i], rows) * ppr + (g - i * ppr)];
}

enum Variant { kLoop = 0, kUnroll8 = 1, kTake = 2 };

template <typename T, typename I>
cudaError_t launch(int variant, const void* tbl, const void* idx, void* out, int n, int rows,
                   int W, cudaStream_t stream) {
  const auto* t = static_cast<const uint4*>(tbl);
  const auto* x = static_cast<const I*>(idx);
  auto* o = static_cast<uint4*>(out);
  const long long ppr = static_cast<long long>(W) * sizeof(T) / 16;
  if (variant == kTake) {
    const long long total = static_cast<long long>(n) * ppr;
    const int grid = static_cast<int>((total + kThreads - 1) / kThreads);
    row_gather_take_kernel<T, I><<<grid, kThreads, 0, stream>>>(t, x, o, n, rows, W);
    return cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long items = variant == kLoop ? n : (n + kUnroll - 1) / kUnroll;  // warp work items
  const long long want = (items + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  if (variant == kLoop)
    row_gather_loop_kernel<T, I><<<grid, kThreads, 0, stream>>>(t, x, o, n, rows, W);
  else
    row_gather_unroll8_kernel<T, I><<<grid, kThreads, 0, stream>>>(t, x, o, n, rows, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_index(int variant, const void* tbl, const void* idx, void* out, int n,
                           int rows, int W, int idx_dtype, cudaStream_t stream) {
  if (W % (16 / sizeof(T)) != 0) return cudaErrorInvalidValue;
  if (idx_dtype == 0) return launch<T, int32_t>(variant, tbl, idx, out, n, rows, W, stream);
  if (idx_dtype == 1) return launch<T, int64_t>(variant, tbl, idx, out, n, rows, W, stream);
  return cudaErrorInvalidValue;
}

int row_gather(int variant, const void* tbl, const void* idx, void* out, long long n, int rows,
               int W, int dtype, int idx_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(tbl) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (n < 0 || rows < 1 || W < 1 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  // pieces of the output must stay below 2^31 (32-bit piece indices)
  if (n * static_cast<long long>(W) * (dtype == 0 ? 4 : 2) / 16 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int ni = static_cast<int>(n);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_index<float>(variant, tbl, idx, out, ni, rows, W, idx_dtype, st);
  else if (dtype == 1)
    err = dispatch_index<__nv_bfloat16>(variant, tbl, idx, out, ni, rows, W, idx_dtype, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (table and output); idx_dtype: 0 = int32,
// 1 = int64. tbl [rows, W], idx [n], out [n, W], all contiguous. Each returns
// the cudaError_t of its launch (0 on success).
int sgnn_row_gather_loop(const void* tbl, const void* idx, void* out, long long n, int rows,
                         int W, int dtype, int idx_dtype, void* stream) {
  return row_gather(kLoop, tbl, idx, out, n, rows, W, dtype, idx_dtype, stream);
}

int sgnn_row_gather_unroll8(const void* tbl, const void* idx, void* out, long long n, int rows,
                            int W, int dtype, int idx_dtype, void* stream) {
  return row_gather(kUnroll8, tbl, idx, out, n, rows, W, dtype, idx_dtype, stream);
}

int sgnn_row_gather_take(const void* tbl, const void* idx, void* out, long long n, int rows,
                         int W, int dtype, int idx_dtype, void* stream) {
  return row_gather(kTake, tbl, idx, out, n, rows, W, dtype, idx_dtype, stream);
}

const char* sgnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
