// Row gather out[i, :] = tbl[clamp(idx[i]), :] for NVIDIA Hopper (sm_90a).
//
// Replaces the three TPU kernels of scripts/gather_kernel_probe.py, each
// reached through `make_pallas_gather` (pl.pallas_call at :83):
//
//   _gather_loop_kernel    (:56-61)  one row per loop step
//       -> row_gather_loop_kernel: a loop over rows that fills the warp.
//          Each warp walks chunks of up to 32 output rows: one coalesced
//          load of the chunk's indices (the next chunk's is issued before
//          this chunk's rows are stored), handed out by shuffles; lane
//          groups of pieces_per_row lanes take one row each, so a warp
//          step copies 32 / pieces_per_row rows (4 at W = 64 bf16, 2 in
//          f32, 1 at W = 128 f32; wider rows take several steps), and each
//          lane issues kLoopBatch steps' row loads before it stores any.
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
// The loop kernel's grid holds as many blocks as fit on the card at once
// (the occupancy query), each warp walking every (warps)-th chunk. Chunks
// hold at most 32 rows and are sized so that every warp walks the same
// number of them (one of 10 rows at the model's m2m sender gather, four of
// 25 at the probe): a short gather leaves no warp idle, and no warp walks
// one chunk more than most while the card waits for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // threads per block (8 warps)
constexpr int kBlocksPerSm = 8;      // grid cap of the unroll8 kernel
constexpr int kUnroll = 8;           // rows in flight per warp (unroll8)
constexpr int kLoopBatch = 4;        // 16-byte row loads in flight per lane (loop; 8 cost occupancy)
constexpr unsigned kFull = 0xffffffffu;

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
                       uint4* __restrict__ out, int n, int rows, int W, int chunk_rows) {
  const int ppr = pieces_per_row<T>(W);
  const int lane = threadIdx.x & 31;
  // a row of at most 32 pieces: groups of ppr lanes, rps rows per step
  // (lanes past rps * ppr idle); a wider row: the whole warp, span / 32
  // steps per row, lanes past the row's last piece idle in its last step
  const bool narrow = ppr <= 32;
  const int rps = narrow ? 32 / ppr : 1;
  const int span = narrow ? ppr : (ppr + 31) / 32 * 32;
  const int group = narrow ? lane / ppr : 0;
  const int col = narrow ? lane - group * ppr : lane;
  const int passes = narrow ? 1 : span / 32;  // steps per row (group)
  const int first = group < rps ? group : 32;  // an idle lane starts past every chunk
  const int chunks = static_cast<int>((n + chunk_rows - 1LL) / chunk_rows);
  const int warps = gridDim.x * (kThreads / 32);
  const long long stride = static_cast<long long>(warps) * chunk_rows;
  int chunk = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  long long at = static_cast<long long>(chunk) * chunk_rows + lane;
  I ahead = chunk < chunks && lane < chunk_rows && at < n ? idx[at] : I(0);
  for (; chunk < chunks; chunk += warps) {
    const int mine = static_cast<int>(clamp_row(ahead, rows));  // lane j: row j's table row
    const long long base = static_cast<long long>(chunk) * chunk_rows;
    at += stride;  // the next chunk's index, fetched ahead
    ahead = chunk + warps < chunks && lane < chunk_rows && at < n ? idx[at] : I(0);
    const int cnt = n - base < chunk_rows ? static_cast<int>(n - base) : chunk_rows;
    const int steps = (cnt + rps - 1) / rps * passes;
    uint4* dst = out + base * ppr;
    int r = first, p = col;  // this lane's row in the chunk and piece of the row
    for (int t = 0; t < steps; t += kLoopBatch) {
      uint4 v[kLoopBatch];
      int put[kLoopBatch];  // piece of the chunk's output, or -1
#pragma unroll
      for (int u = 0; u < kLoopBatch; ++u) {
        const int src = __shfl_sync(kFull, mine, r & 31);
        put[u] = r < cnt && p < ppr ? r * ppr + p : -1;
        if (put[u] >= 0) v[u] = tbl[static_cast<long long>(src) * ppr + p];
        p += 32;
        if (p >= span) {
          p = col;
          r += rps;
        }
      }
#pragma unroll
      for (int u = 0; u < kLoopBatch; ++u)
        if (put[u] >= 0) dst[put[u]] = v[u];
    }
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
  if (variant == kLoop) {
    static int resident = 0;  // blocks of the loop kernel that fit on one SM at once
    if (resident == 0 &&
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, row_gather_loop_kernel<T, I>, kThreads,
                                                             0)) != cudaSuccess)
      return err;
    const long long cap = static_cast<long long>(sms) * (resident > 0 ? resident : 1);  // blocks
    // every resident warp walks the same number of chunks, of at most 32 rows
    const long long warps = cap * (kThreads / 32), walks = (n + 32 * warps - 1) / (32 * warps);
    const int chunk_rows = static_cast<int>((n + walks * warps - 1) / (walks * warps));
    const long long want = ((n + chunk_rows - 1LL) / chunk_rows + kThreads / 32 - 1) / (kThreads / 32);
    const int grid = static_cast<int>(want < cap ? want : cap);
    row_gather_loop_kernel<T, I><<<grid, kThreads, 0, stream>>>(t, x, o, n, rows, W, chunk_rows);
  } else {
    const long long items = (n + kUnroll - 1) / kUnroll;  // warp work items
    const long long want = (items + kThreads / 32 - 1) / (kThreads / 32);
    const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
    const int grid = static_cast<int>(want < cap ? want : cap);
    row_gather_unroll8_kernel<T, I><<<grid, kThreads, 0, stream>>>(t, x, o, n, rows, W);
  }
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
