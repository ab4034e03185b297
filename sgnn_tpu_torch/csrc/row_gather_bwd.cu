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
// Both are deterministic: sums in index order (the planned one: each plan
// row's slots in slot order, then the rows in row order) in f32 from 0,
// rounded once to g's type and written once, zero where the run is empty.
// No atomics; two launches on the same inputs give the same bits. The
// plain versions in sgnn_tpu_torch/ops/row_gather.py add in the same
// order, so the two agree bit for bit.
//
// sorted_segment_sum_kernel: work goes by chunk of id positions (aligned
// at multiples of the chunk length, which the caller picks by shape: 16
// where there is at most one id per output row, 128 where there are more),
// not by output row, so no warp searches. A lane group of pieces_per_row
// lanes (as the planned kernel's) takes a chunk: it loads kRowBatch ids
// and cotangent rows per lane in one round and adds them in index order.
// Where idx[i] != idx[i - 1], position i starts a run: the group writes
// the zero rows of the nodes between the two ids (flat 16-byte stores; the
// chunk that holds position m, past the last id, writes those after it)
// and starts a new f32 sum from 0. A run inside the chunk is written to its
// node, rounded once. A run that crosses a multiple of the chunk length
// leaves one f32 partial per chunk instead, each summed in index order
// (scratch: a head slot for the chunk's first run when it began before the
// chunk, a tail slot for its last when it goes on past it).
// sorted_segment_combine_kernel, launched next on the same stream, adds
// them in chunk order from 0 and writes the node once. So a long run (the
// COO layout's thousands of padded ids at each sample's last node) is read
// by many groups at once, and a run inside one chunk keeps the plain
// index-order sum.
//
// planned_gather_bwd_kernel: work goes by plan row, not by output row,
// so no warp searches. A lane group of pieces_per_row lanes (rounded up to
// a power of two: 16 in bf16 and 32 in f32 at W = 128; 32 / group rows
// per warp) takes plan row r. If tsp_node[r] differs from tsp_node[r - 1],
// r starts its node's run and the group owns that node: it writes the zero
// rows of the nodes between the two (a flat run of 16-byte stores; a
// group past the last plan row writes those after it), sums the run row
// by row and writes the node's row. A row that continues a run does
// nothing. The group reads a round of `group` plan slots with one
// coalesced load each of tsp_rows and tsp_mask (the first round in the
// same round trip as the nodes, the next while this one's loads are in
// flight), hands them out by shuffles, and issues kSlotBatch slots' 16-byte
// cotangent loads before it adds them, in slot order, up to the last
// unmasked slot. A masked slot inside a batch adds +0.0, which leaves an
// f32 sum begun at +0.0 unchanged bit for bit (the plain version adds the
// same zero).
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
// the ids (plan) once and the [N, W] output. Both write each output once
// without atomics and read the ids and the runs' rows through L2. The
// sorted kernel was one warp per output row: two searches (three
// dependent probes each) before any load, so the warps of the rows with no
// id (three quarters of them at the dense m2m receivers) only searched and
// wrote zeros, and one warp walked each run, however long (0.07-0.13 of
// its bound on an H100 at the COO receivers). Now each cotangent row is
// loaded once, kRowBatch at a time per lane beside its ids; the crossing
// runs' f32 partials add a few per cent of scratch traffic. Where most
// output rows have no id (the dense m2m receivers: three quarters), the
// zero rows' stores set the time; short chunks give more groups to store
// them, and long chunks, where ids outnumber rows, leave fewer partials
// (TMA bulk stores of the zero rows from shared memory were no faster on
// the H100). The planned kernel was
// one warp per output row too, two searches and one load in flight per
// lane: at half the bytes its bf16 case had nothing to hide that latency
// behind. Now a group's chain is one round trip for the plan, one or two
// of cotangent loads and its stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotBatch = 8;  // cotangent loads in flight per lane (planned)
constexpr int kRowBatch = 8;   // ids and cotangent rows in flight per lane (sorted; divides the chunk)
constexpr int kPartialBatch = 16;  // partial rows in flight per lane (the sorted sum's combine)
// blocks per SM the planned kernel's registers must leave room for (at most
// 64 registers a thread): one more block of warps in flight than ptxas
// picks unasked, which was faster in f32 on the H100 and no slower in bf16
constexpr int kPlannedBlocksPerSm = 4;

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
  // four f32 sums as values 4q..4q+3 of the rows of out
  __device__ __forceinline__ static void store_quad(void* out, long long q, const float4 v) {
    static_cast<float4*>(out)[q] = v;
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
  __device__ __forceinline__ static void store_quad(void* out, long long q, const float4 v) {
    static_cast<uint2*>(out)[q] = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
  }
};

// lanes per group of the sorted and planned kernels: ppr rounded up to a power of two, at most 32
__host__ __device__ __forceinline__ int group_lanes(int ppr) {
  int gs = 1;
  while (gs < ppr && gs < 32) gs <<= 1;
  return gs;
}

// the zero rows of the nodes in [lo, hi) clamped into [0, n): flat 16-byte
// pieces, lane c of a group of gs lanes from piece c on
__device__ __forceinline__ void zero_rows(uint4* __restrict__ out, long long lo, long long hi, int n, int ppr, int c,
                                          int gs) {
  lo = lo > 0 ? lo : 0;
  hi = hi < n ? hi : n;
  for (long long q = lo * ppr + c; q < hi * ppr; q += gs) out[q] = make_uint4(0, 0, 0, 0);
}

// the end of a run's sum in a chunk (piece p of node's row): the node's row,
// rounded once, or the chunk's head (slot 0) or tail (slot 1) f32 partial
template <typename T>
__device__ __forceinline__ void finish_run(uint4* __restrict__ out, float4* __restrict__ partial_row,
                                           const float* acc, long long node, int slot, int ppr, int p) {
  constexpr int kQ = Piece<T>::kValues / 4;
  if (slot < 0) {
    out[node * ppr + p] = Piece<T>::pack(acc);
    return;
  }
  float4* dst = partial_row + (static_cast<long long>(slot) * ppr + p) * kQ;
#pragma unroll
  for (int q = 0; q < kQ; ++q) dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const uint4* __restrict__ g, const I* __restrict__ idx, uint4* __restrict__ out,
                          float4* __restrict__ partials, int m, int n, int ppr, int chunk_len) {
  constexpr int kV = Piece<T>::kValues;
  const int lane = threadIdx.x & 31;
  const int gs = group_lanes(ppr), c = lane & (gs - 1);
  const long long last_chunk = m / chunk_len;  // it also holds position m, past the last id
  const long long chunk = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * (32 / gs) + lane / gs;
  if (chunk > last_chunk) return;  // no warp-wide operation follows
  const long long begin = chunk * chunk_len, end = begin + chunk_len < m ? begin + chunk_len : m;
  float4* partial_row = partials + chunk * 2 * ppr * (kV / 4);  // this chunk's two partial rows
  // the id before the chunk (a run that goes on into it) and the one after (a run that goes on past it)
  const long long before = begin > 0 ? static_cast<long long>(idx[begin - 1]) : -1;
  const bool has_after = end < m;
  const long long after = has_after ? static_cast<long long>(idx[end]) : 0;

  for (int p0 = 0; p0 < ppr; p0 += 32) {  // pieces p0 + c; one pass where ppr <= 32
    const int p = p0 + c;
    const bool piece = p < ppr;
    long long cur = before;  // the id whose run is being summed
    bool summing = false;    // acc holds a sum of cur's run
    bool head = true;        // cur's run began before the chunk
    float acc[kV] = {};
    for (long long b0 = begin; b0 < end; b0 += kRowBatch) {
      I id[kRowBatch];
      uint4 v[kRowBatch];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {  // one round trip: the batch's ids and rows, every load issued
        const long long at = b0 + j < end ? b0 + j : end - 1;  // past the end: the last again
        id[j] = idx[at];
        v[j] = g[at * ppr + (piece ? p : 0)];
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        if (b0 + j >= end) continue;
        const long long node = static_cast<long long>(id[j]);
        if (node != cur) {  // a run starts here; cur's run ends inside the chunk
          if (summing && piece && cur >= 0 && cur < n)
            finish_run<T>(out, partial_row, acc, cur, head ? 0 : -1, ppr, p);
          if (p0 == 0) zero_rows(out, cur + 1, node, n, ppr, c, gs);
          cur = node;
          head = false;
#pragma unroll
          for (int e = 0; e < kV; ++e) acc[e] = 0.0f;
        }
        summing = true;
        Piece<T>::add(acc, v[j]);
      }
    }
    const bool goes_on = has_after && after == cur;
    if (summing && piece && cur >= 0 && cur < n)
      finish_run<T>(out, partial_row, acc, cur, head ? 0 : (goes_on ? 1 : -1), ppr, p);
    if (chunk == last_chunk && p0 == 0) zero_rows(out, cur + 1, n, n, ppr, c, gs);
  }
}

// The runs that cross a multiple of the chunk: one warp per chunk boundary
// b * chunk_len (b >= 1). It combines where the run at the boundary began in
// chunk b - 1 (so it crosses no earlier boundary): it finds the run's last
// chunk (the boundaries the run crosses, 32 probed at once), then adds
// chunk b - 1's tail partial and chunks b..last's head partials, in chunk
// order from 0, and writes the node's row, rounded once. Lanes take the
// row's float4s.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
sorted_segment_combine_kernel(const float4* __restrict__ partials, const I* __restrict__ idx,
                              void* __restrict__ out, int m, int n, int row_quads, int chunk_len) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5) + 1;
  const long long at = b * chunk_len;
  if (at >= m) return;  // the whole warp
  const long long node = static_cast<long long>(idx[at]), left = static_cast<long long>(idx[at - 1]);
  const bool earlier = b > 1 && static_cast<long long>(idx[at - chunk_len - 1]) == node;
  if (node != left || earlier || node < 0 || node >= n) return;  // the whole warp
  long long last = b;  // the run's last chunk
  for (;;) {
    const long long pos = (last + 1 + lane) * chunk_len;
    const unsigned on = __ballot_sync(kFull, pos < m && static_cast<long long>(idx[pos]) == node);
    last += __popc(on);  // the ids ascend: the boundaries the run crosses come first
    if (on != kFull) break;
  }
  const long long pieces = last - b + 2;  // chunk b - 1's tail, then chunks b..last's heads
  for (int q = lane; q < row_quads; q += 32) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long k0 = 0; k0 < pieces; k0 += kPartialBatch) {
      float4 v[kPartialBatch];
#pragma unroll
      for (int j = 0; j < kPartialBatch; ++j) {  // every load issued (past the last piece: the last again)
        const long long k = k0 + j < pieces ? k0 + j : pieces - 1;
        v[j] = partials[(k == 0 ? (b - 1) * 2 + 1 : (b - 1 + k) * 2) * row_quads + q];
      }
      // past the last piece each adds +0.0, which leaves a sum begun at +0.0 unchanged bit for bit
#pragma unroll
      for (int j = 0; j < kPartialBatch; ++j) {
        const bool keep = k0 + j < pieces;
        acc.x += keep ? v[j].x : 0.0f;
        acc.y += keep ? v[j].y : 0.0f;
        acc.z += keep ? v[j].z : 0.0f;
        acc.w += keep ? v[j].w : 0.0f;
      }
    }
    Piece<T>::store_quad(out, node * row_quads + q, acc);
  }
}

// plan slot `at`'s g row, clamped into [0, g_rows), or -1 if masked
template <typename I>
__device__ __forceinline__ int slot_row(const I* __restrict__ tsp_rows, const uint8_t* __restrict__ tsp_mask,
                                        long long at, long long g_rows) {
  const long long v = static_cast<long long>(tsp_rows[at]);
  return tsp_mask[at] ? static_cast<int>(v < 0 ? 0 : (v >= g_rows ? g_rows - 1 : v)) : -1;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, kPlannedBlocksPerSm)
planned_gather_bwd_kernel(const uint4* __restrict__ g, long long g_rows, const I* __restrict__ tsp_rows,
                          const I* __restrict__ tsp_node, const uint8_t* __restrict__ tsp_mask,
                          uint4* __restrict__ out, int rs, int ks, int n, int ppr) {
  constexpr int kV = Piece<T>::kValues;
  const int lane = threadIdx.x & 31;
  const int gs = group_lanes(ppr), groups = 32 / gs, c = lane & (gs - 1), lead = lane & ~(gs - 1);
  const unsigned gmask = gs == 32 ? kFull : ((1u << gs) - 1) << lead;
  const long long warp_item = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * groups;
  if (warp_item > rs) return;  // the whole warp: its first plan row is past the sentinel
  // this group's plan row; item rs stands past the last one (it writes the trailing zero rows)
  const long long item = warp_item + lane / gs;
  const bool mine = item <= rs, real = item < rs;

  // 1. the row's node, its neighbours' and its first slots: one round trip
  const long long past = n;  // any node >= n adds to no output row
  const long long node = real ? static_cast<long long>(tsp_node[item]) : past;
  const long long prev = mine && item > 0 ? static_cast<long long>(tsp_node[item - 1]) : -1;
  const long long next = real && item + 1 < rs ? static_cast<long long>(tsp_node[item + 1]) : past;
  const int slots0 = real && c < ks ? slot_row(tsp_rows, tsp_mask, item * ks + c, g_rows) : -1;
  const bool starts = mine && node != prev;  // a run begins here (or the sentinel)
  const bool owner = starts && real && node >= 0 && node < n;

  // 2. the zero rows of the nodes between the previous run's and this one's
  if (starts) {
    const long long lo = prev + 1 > 0 ? prev + 1 : 0, hi = node < n ? node : n;
    for (long long q = lo * ppr + c; q < hi * ppr; q += gs) out[q] = make_uint4(0, 0, 0, 0);
  }

  // 3. the owned node's run, row by row; every loop is warp-uniform
  for (int p0 = 0; p0 < ppr; p0 += 32) {  // pieces p0 + c; one pass where ppr <= 32
    const int p = p0 + c;
    bool active = owner;
    long long row = item, after = next;
    int first = slots0;  // lane c: this row's slot c
    float total[kV] = {};
    while (__any_sync(kFull, active)) {
      const long long slot0 = row * ks;
      int cur = active ? first : -1;
      float sum[kV] = {};
      for (int k0 = 0; k0 < ks; k0 += gs) {
        // the next round's slot, fetched while this round's loads are in flight
        const int k = k0 + gs + c;
        const int ahead = active && k < ks ? slot_row(tsp_rows, tsp_mask, slot0 + k, g_rows) : -1;
        const unsigned live = (__ballot_sync(kFull, cur >= 0) & gmask) >> lead;
        const int walk = __reduce_max_sync(kFull, live ? 32 - __clz(live) : 0);  // past every group's last
        for (int s0 = 0; s0 < walk; s0 += kSlotBatch) {
          uint4 v[kSlotBatch];
#pragma unroll
          for (int b = 0; b < kSlotBatch; ++b) {
            const int at = __shfl_sync(kFull, cur, lead + ((s0 + b) & (gs - 1)));
            v[b] = make_uint4(0, 0, 0, 0);
            if (s0 + b < walk && at >= 0 && p < ppr) v[b] = g[static_cast<long long>(at) * ppr + p];
          }
#pragma unroll
          for (int b = 0; b < kSlotBatch; ++b) Piece<T>::add(sum, v[b]);
        }
        cur = ahead;
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) total[e] += sum[e];
      // the run goes on while the next row holds the same node
      active = active && after == node;
      ++row;
      first = active && c < ks ? slot_row(tsp_rows, tsp_mask, row * ks + c, g_rows) : -1;
      after = active && row + 1 < rs ? static_cast<long long>(tsp_node[row + 1]) : past;
    }
    if (owner && p < ppr) out[node * ppr + p] = Piece<T>::pack(total);
  }
}

// blocks for n work items, `per_warp` to a warp
int grid_for(long long n, int per_warp) {
  const long long per_block = static_cast<long long>(kWarps) * per_warp;
  return static_cast<int>((n + per_block - 1) / per_block);
}

template <typename T, typename I>
cudaError_t launch_sorted(const void* g, const void* idx, void* out, void* partials, int m, int n, int ppr,
                          int chunk, cudaStream_t st) {
  sorted_segment_sum_kernel<T, I><<<grid_for(m / chunk + 1LL, 32 / group_lanes(ppr)), kThreads, 0, st>>>(
      static_cast<const uint4*>(g), static_cast<const I*>(idx), static_cast<uint4*>(out),
      static_cast<float4*>(partials), m, n, ppr, chunk);
  const cudaError_t err = cudaGetLastError();
  const long long boundaries = m > 0 ? (m - 1LL) / chunk : 0;
  if (err != cudaSuccess || boundaries == 0) return err;
  sorted_segment_combine_kernel<T, I><<<grid_for(boundaries, 1), kThreads, 0, st>>>(
      static_cast<const float4*>(partials), static_cast<const I*>(idx), out, m, n, ppr * Piece<T>::kValues / 4, chunk);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_planned(const void* g, long long g_rows, const void* tsp_rows, const void* tsp_node,
                           const void* tsp_mask, void* out, int rs, int ks, int n, int ppr, cudaStream_t st) {
  planned_gather_bwd_kernel<T, I><<<grid_for(rs + 1LL, 32 / group_lanes(ppr)), kThreads, 0, st>>>(
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

constexpr long long kMaxCount = (1LL << 31) - 64;  // int positions and nodes

}  // namespace

extern "C" {

// g [m, W], idx [m] ascending, out [n, W]; chunk: id positions per chunk
// (a multiple of 8, at most 1024); partials: f32 scratch of
// (m / chunk + 1) * 2 * W values; dtype 0 = float32, 1 = bfloat16 (g and
// out), idx_dtype 0 = int32, 1 = int64. Two launches on `stream`; returns
// their cudaError_t (0 on success).
int sgnn_sorted_segment_sum(const void* g, const void* idx, void* out, void* partials, long long m, long long n,
                            int W, int chunk, int dtype, int idx_dtype, void* stream) {
  const int ppr = pieces_per_row(W, dtype);
  if (ppr < 0 || m < 0 || n < 0 || m > kMaxCount || n > kMaxCount || chunk < kRowBatch || chunk > 1024 ||
      chunk % kRowBatch || !aligned(g) || !aligned(out) || !aligned(partials) || (dtype != 0 && dtype != 1) ||
      (idx_dtype != 0 && idx_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m), ni = static_cast<int>(n);
  cudaError_t err;
  if (dtype == 0)
    err = idx_dtype == 0 ? launch_sorted<float, int32_t>(g, idx, out, partials, mi, ni, ppr, chunk, st)
                         : launch_sorted<float, int64_t>(g, idx, out, partials, mi, ni, ppr, chunk, st);
  else
    err = idx_dtype == 0 ? launch_sorted<__nv_bfloat16, int32_t>(g, idx, out, partials, mi, ni, ppr, chunk, st)
                         : launch_sorted<__nv_bfloat16, int64_t>(g, idx, out, partials, mi, ni, ppr, chunk, st);
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
