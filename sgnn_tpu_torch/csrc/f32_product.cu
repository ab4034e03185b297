// The port's f32 matrix products on Hopper tensor cores (sm_90a), in 3xTF32:
//
//   forward          Y  = act(X W + b)              X [M, K], W [K, N], b [N], act ReLU or none
//   input gradient   dX = (G * gate) W^T            gate [Y > 0] where the forward took the ReLU
//   weight gradient  dW = X^T (G * gate),  db = column sums of G * gate
//
// No Pallas original: the JAX package leaves its Linears to XLA's dot. On the card PyTorch sends an f32
// product with TF32 off to cuBLAS's SIMT kernels on the CUDA cores (sm80_xmma_gemm_f32f32_*, CUTLASS's
// Kernel2), at a small share of the tensor cores' TF32 rate. These kernels take the tensor cores at f32
// accuracy instead: each operand x is split as hi + lo (hi = x rounded to TF32, lo = x - hi; `split` of
// edge_block_tile.cuh) and each product is lo*hi + hi*lo + hi*hi, summed in f32.
//
// The tensor cores add a step's products into their f32 sum with truncation, so a running sum over
// every step of a long inner dimension drifts toward zero by some ulps, enough to move a training loss
// past the f32 reference's limits. So the products go into short fresh partials (a 32-deep chunk with
// its small terms first, or one 8-deep step), which are added by rounded f32 adds.
//
// What bounds them: at the models' widths (K, N <= 128, up to 622,592 rows) a row-product moves 1-1.5 KB
// and does 3 x 2 K N tensor operations, so bytes and tensor operations are about even on this card.
//
//   * rows_wgmma_kernel (forward and input gradient, K <= 128 and N > 8: every hidden product of the
//     models): wgmma with the weight in registers and the rows in shared memory; see its comment;
//   * rows_kernel (the same function where K > 128 or N <= 8, such as the decoder's last Linear):
//     mma.sync, a persistent grid of 8-warp blocks over 128-row tiles, the weight's 128-deep block in
//     shared memory, X (or G) in 32-column chunks through a two-stage cp.async ring; the gate (the
//     saved Y) zeroes G's entries in shared memory; the bias and the ReLU are the epilogue;
//   * wgrad_kernel (the weight gradient): mma.sync, split-K over the rows. Block (s, kt, nt) adds rows
//     [s * rows_per_split, (s + 1) * rows_per_split) of X^T G into its [TK, TN] tile of a partial,
//     chunks of 32 rows in order (the gate and the bias gradient's column sums taken in the same pass
//     over shared memory); a second launch adds the partials in a fixed order (wgrad_reduce_kernel).
//
// No atomics, and no tile or sum is shared between blocks in an order the grid decides: two runs give
// the same bits (the caller fixes the weight gradient's split from M alone). Any K and N: tails read as
// zero; rows are staged in 16-byte pieces where K, the strides and the bases allow, else element by
// element; W and the weight gradient's output take any strides (a row block of a transposed torch
// weight needs no copy). Launches on the caller's stream, allocates nothing, never synchronises.

#include <type_traits>

#include "edge_block_tile.cuh"  // split, mma_tf32, cp_async16, aligned16, kThreads (256), kWarps (8)

namespace {

constexpr int kBK = 32;         // depth of a staged chunk: columns of X (rows kernel), rows (weight gradient)
constexpr int kKC = 128;        // inner depth of the weight block the rows kernel holds
constexpr int kLdA = kBK + 4;   // A chunk row stride (words): fragments read [row g][col t], banks 4 g + t

// A row stride (words) for fragments read as [k = t][n = g]: L mod 32 in {8, 24} puts the lanes' 8 t + g
// (or 24 t + g) on distinct banks; L is then a multiple of 8, so rows stay 16-byte aligned
constexpr int ld_kn(int t) {
  int l = t;
  while (l % 32 != 8 && l % 32 != 24) ++l;
  return l;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst[r][c] = src[(r0 + r) * ld + c0 + c] for an R x C block (C a multiple of 4) into rows of stride L
// words; zero where r0 + r >= rmax or c0 + c >= cmax. By cp.async (the caller commits and waits): in
// 16-byte pieces where `vec` (cmax, ld a multiple of 4, src 16-byte aligned), else element by element.
template <int R, int C, int Threads = kThreads>
__device__ __forceinline__ void stage(float* dst, int L, const float* __restrict__ src, long long ld,
                                      long long r0, long long rmax, int c0, int cmax, bool vec,
                                      int tid = threadIdx.x) {
  constexpr int kPieces = C / 4;
  for (int i = tid; i < R * kPieces; i += Threads) {
    const int r = i / kPieces, p = i - r * kPieces;
    float* d = dst + r * L + 4 * p;
    const long long row = r0 + r;
    const int col = c0 + 4 * p;
    if (vec) {
      if (row < rmax && col < cmax)
        cp_async16(d, src + row * ld + col);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (row < rmax && col + q < cmax)
          cp_async4(d + q, src + row * ld + col + q);
        else
          d[q] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------------
// rows kernel: C[M, N] = act(A[M, K] (* [gate > 0]) B[K, N] + bias), B[k][n] = b[k * sbk + n * sbn]
// 8 warps as WM x WN, each a (16 MT) x (8 NT) piece of the block's BM x BN tile.

template <int WM, int WN, int MT, int NT>
struct RowsTile {
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8, LdW = ld_kn(BN);
  static constexpr int kWFloats = kKC * LdW, kAFloats = BM * kLdA;
  static constexpr int smem_bytes(bool gate) { return 4 * (kWFloats + 2 * kAFloats * (gate ? 2 : 1)); }
};

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const float* __restrict__ a, long long lda, const float* __restrict__ gate, long long ldg,
            const float* __restrict__ b, long long sbk, long long sbn, const float* __restrict__ bias, int relu,
            float* __restrict__ c, long long ldc, long long M, int N, int K, int vec, int vec2) {
  static_assert(WM * WN == kWarps, "8 warps a block");
  using T = RowsTile<WM, WN, MT, NT>;
  extern __shared__ __align__(1024) float smem[];
  float* sW = smem;
  float* sA = smem + T::kWFloats;  // two stages of A
  float* sG = sA + 2 * T::kAFloats;  // two stages of the gate, where there is one
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int col0 = blockIdx.y * T::BN;
  const long long tiles = (M + T::BM - 1) / T::BM;
  if (blockIdx.x >= tiles) return;
  const int chunks = (K + kBK - 1) / kBK;
  const bool one_block = K <= kKC;  // the weight block is staged once
  const long long iters = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;

  auto issue = [&](long long it) {
    const long long row0 = (blockIdx.x + it / chunks * gridDim.x) * T::BM;
    const int k0 = static_cast<int>(it % chunks) * kBK, s = static_cast<int>(it & 1);
    stage<T::BM, kBK>(sA + s * T::kAFloats, kLdA, a, lda, row0, M, k0, K, vec);
    if (gate != nullptr) stage<T::BM, kBK>(sG + s * T::kAFloats, kLdA, gate, ldg, row0, M, k0, K, vec);
    cp_commit();
  };
  // the weight block [k0, k0 + 128) x this column tile, read along whichever axis is contiguous
  auto stage_w = [&](int k0) {
    const bool kfast = sbk == 1;
    for (int i = threadIdx.x; i < kKC * T::BN; i += kThreads) {
      const int kk = kfast ? i % kKC : i / T::BN, n = kfast ? i / kKC : i % T::BN;
      const int k = k0 + kk, col = col0 + n;
      sW[kk * T::LdW + n] = k < K && col < N ? b[k * sbk + col * sbn] : 0.f;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (one_block) stage_w(0);
  issue(0);
  for (long long it = 0; it < iters; ++it) {
    const int kc = static_cast<int>(it % chunks);
    const long long row0 = (blockIdx.x + it / chunks * gridDim.x) * T::BM;
    if (it + 1 < iters) {
      issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk `it` (and the weight block) is in shared memory for every warp
    const int kw = kc * kBK % kKC;  // the chunk's first row in the weight block
    if (!one_block && kw == 0) {
      stage_w(kc * kBK);
      __syncthreads();
    }
    float* A = sA + (it & 1) * T::kAFloats;
    if (gate != nullptr) {
      const float* G = sG + (it & 1) * T::kAFloats;
      for (int i = threadIdx.x; i < T::BM * kBK; i += kThreads) {
        const int q = i / kBK * kLdA + i % kBK;
        if (!(G[q] > 0.f)) A[q] = 0.f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ar = A + (wm * MT * 16 + i * 16 + g) * kLdA + kk + t;
        const float av[4] = {ar[0], ar[8 * kLdA], ar[4], ar[8 * kLdA + 4]};
#pragma unroll
        for (int q = 0; q < 4; ++q) split(av[q], ahi[i][q], alo[i][q]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* wr = sW + (kw + kk + t) * T::LdW + wn * NT * 8 + j * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(wr[0], bh0, bl0);
        split(wr[4 * T::LdW], bh1, bl1);
#pragma unroll
        for (int i = 0; i < MT; ++i) {  // the step's three products into a fresh partial, then a rounded add
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, alo[i], bh0, bh1);
          mma_tf32(p, ahi[i], bl0, bl1);
          mma_tf32(p, ahi[i], bh0, bh1);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += p[q];
        }
      }
    }
    if (kc == chunks - 1) {  // the tile's epilogue: bias, ReLU, store; then a fresh sum
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = col0 + wn * NT * 8 + j * 8 + 2 * t;
          const float b0 = bias != nullptr && col < N ? bias[col] : 0.f;
          const float b1 = bias != nullptr && col + 1 < N ? bias[col + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = row0 + wm * MT * 16 + i * 16 + g + 8 * h;
            float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
            if (bias != nullptr) {
              v0 += b0;
              v1 += b1;
            }
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if (row < M) {
              float* cr = c + row * ldc + col;
              if (vec2 && col + 1 < N) {
                *reinterpret_cast<float2*>(cr) = make_float2(v0, v1);
              } else {
                if (col < N) cr[0] = v0;
                if (col + 1 < N) cr[1] = v1;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
        }
    }
    __syncthreads();  // every warp is done with this stage before the next issue overwrites it
  }
}

// ---------------------------------------------------------------------------------------------------
// wgmma rows kernel (K <= 128, N > 8; the same function as rows_kernel), computed transposed:
// C^T = B^T A^T, so that the weight is wgmma's register operand and the rows its shared one. One block
// an SM, two warpgroups, each a 64 x 64 piece of the block's tile: where BN is 128 the tile is 64 rows
// and warpgroup w takes output columns 64w.., where BN is 64 it is 128 rows and warpgroup w takes rows
// 64w... Each thread keeps its part of the weight, split into TF32 hi and lo, in registers for the whole
// kernel (16 steps x 4 values x 2). The rows come in chunks of 32 inner columns: cp.async into a ring of
// raw chunks (the gate's beside them), then every thread splits the pieces it staged into hi and lo in
// wgmma's K-major core matrices (8 rows by 4 inner values, 16 bytes a row; LBO 144 bytes so that a
// quarter warp's eight 16-byte stores fall on distinct banks, SBO 1152) in a second ring. A chunk's
// twelve asynchronous m64n64k8 TF32 products go into a fresh f32 partial, the eight small terms
// (lo*hi, hi*lo) first, then the four hi*hi; the next chunk is split while they run; each partial is
// then added to the tile's sum by plain f32 adds. The tensor cores add a product group into their sum
// with truncation, so a running sum over all 48 products of a row drifts toward zero by some ulps;
// partials of a quarter of the terms, small terms first, keep that drift under an ulp and leave the
// long sum to rounded adds. Nothing in a tile is shared between blocks, so the bits do not depend on
// the grid.

constexpr int kWgThreads = 256;                         // two warpgroups
constexpr int kCoreLbo = 144, kCoreSbo = 8 * kCoreLbo;  // bytes
constexpr int kSplitStages = 3;  // a stage is rewritten only after both warpgroups' products on it are done

template <int BN, bool GATE>
struct WgRing {
  static constexpr int kTileRows = BN == 128 ? 64 : 128;
  static constexpr int kRawFloats = kTileRows * kBK;                  // a raw chunk (row stride kBK words)
  static constexpr int kSplitFloats = kTileRows / 8 * kCoreSbo / 4;  // one of a chunk's two split parts
  static constexpr int kRawStages = BN == 128 ? (GATE ? 4 : 6) : (GATE ? 3 : 4);
  static constexpr int kRawStageFloats = kRawFloats * (GATE ? 2 : 1);
  static constexpr int kSmemBytes = 4 * (kRawStages * kRawStageFloats + kSplitStages * 2 * kSplitFloats);
};

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// a K-major core-matrix descriptor (no swizzle) of shared memory at p
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kCoreLbo >> 4) << 16) |
         (static_cast<uint64_t>(kCoreSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep registers an asynchronous product reads or writes where they are until it is waited for
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int BN, int CHUNKS, bool GATE>
__global__ void __launch_bounds__(kWgThreads, 1)
rows_wgmma_kernel(const float* __restrict__ a, long long lda, const float* __restrict__ gate, long long ldg,
                  const float* __restrict__ b, long long sbk, long long sbn, const float* __restrict__ bias,
                  int relu, float* __restrict__ c, long long ldc, long long M, int N, int K, int vec) {
  using R = WgRing<BN, GATE>;
  constexpr int kTileRows = R::kTileRows;
  extern __shared__ __align__(1024) float smem[];
  float* raw = smem;
  float* split_ring = smem + R::kRawStages * R::kRawStageFloats;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // this thread's output columns (the products' rows g and g + 8 of the warp's 16) and its first tile row
  const int cb = blockIdx.y * BN + (BN == 128 ? 64 * wg : 0) + 16 * warp + g;
  const int rb = BN == 128 ? 0 : 64 * wg;

  // the weight, once: step s's a0..a3 = B[8s + t][cb], B[8s + t][cb + 8], B[8s + t + 4][cb], B[8s + t + 4][cb + 8]
  uint32_t whi[16][4], wlo[16][4];
  {
    float v[16][4];
#pragma unroll
    for (int s = 0; s < 16; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 8 * s + t + 4 * (q >> 1), n = cb + 8 * (q & 1);
        v[s][q] = k < K && n < N ? b[k * sbk + n * sbn] : 0.f;
      }
#pragma unroll
    for (int s = 0; s < 16; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[s][q], whi[s][q], wlo[s][q]);
  }
  const float b0 = bias != nullptr && cb < N ? bias[cb] : 0.f;
  const float b1 = bias != nullptr && cb + 8 < N ? bias[cb + 8] : 0.f;

  const long long tiles = (M + kTileRows - 1) / kTileRows;
  if (blockIdx.x >= tiles) return;
  const long long iters = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * CHUNKS;
  const long long row_stride = static_cast<long long>(gridDim.x) * kTileRows;

  // the next raw chunk to stage, counted on (no 64-bit division in the loop)
  long long in_row0 = static_cast<long long>(blockIdx.x) * kTileRows, in_left = iters;
  int in_kc = 0, in_stage = 0;
  auto issue = [&]() {  // one raw chunk into its stage; an empty group past the last keeps the count
    if (in_left > 0) {
      float* st = raw + in_stage * R::kRawStageFloats;
      stage<kTileRows, kBK, kWgThreads>(st, kBK, a, lda, in_row0, M, in_kc * kBK, K, vec);
      if (GATE) stage<kTileRows, kBK, kWgThreads>(st + R::kRawFloats, kBK, gate, ldg, in_row0, M, in_kc * kBK, K, vec);
      --in_left;
      if (++in_kc == CHUNKS) {
        in_kc = 0;
        in_row0 += row_stride;
      }
    }
    in_stage = in_stage + 1 == R::kRawStages ? 0 : in_stage + 1;
    cp_commit();
  };

  int raw_stage = 0, split_stage = 0;
  // a chunk's preparation: the raw pieces this thread staged (its own cp.async groups: no barrier for
  // them) split into the split ring; one barrier then shows the split chunk to both warpgroups. The
  // stage it rewrites was last read three chunks back, by products each warpgroup waited for before it
  // issued the chunk after, and so before it reached the barrier the last preparation ended with.
  auto prepare = [&]() {
    cp_wait<R::kRawStages - 2>();
    issue();  // into the raw stage the chunk before left (this thread's own pieces)
    const float* rs = raw + raw_stage * R::kRawStageFloats;
    float* h_out = split_ring + split_stage * 2 * R::kSplitFloats;
    float* l_out = h_out + R::kSplitFloats;
    raw_stage = raw_stage + 1 == R::kRawStages ? 0 : raw_stage + 1;
    split_stage = split_stage + 1 == kSplitStages ? 0 : split_stage + 1;
#pragma unroll
    for (int i = 0; i < kTileRows * kBK / 4 / kWgThreads; ++i) {  // the pieces stage() gave this thread
      const int piece = threadIdx.x + i * kWgThreads, r = piece / 8, q = piece % 8;
      float4 x = *reinterpret_cast<const float4*>(rs + r * kBK + 4 * q);
      if (GATE) {
        const float4 y = *reinterpret_cast<const float4*>(rs + R::kRawFloats + r * kBK + 4 * q);
        x = make_float4(y.x > 0.f ? x.x : 0.f, y.y > 0.f ? x.y : 0.f, y.z > 0.f ? x.z : 0.f, y.w > 0.f ? x.w : 0.f);
      }
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      const int at = (r / 8 * kCoreSbo + q * kCoreLbo + r % 8 * 16) / 4;
      *reinterpret_cast<uint4*>(h_out + at) = h;
      *reinterpret_cast<uint4*>(l_out + at) = l;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // generic-proxy stores, read by wgmma
    __syncthreads();
  };

  float sum[32], part[32];
  const float* hi = split_ring;  // the split stage the next products read
  // a prepared chunk's twelve products into `part`: the small terms, then the large
  auto multiply = [&](auto kc_const) {
    constexpr int kc = decltype(kc_const)::value;
    const uint64_t desc_hi = smem_desc(hi + rb / 8 * kCoreSbo / 4);
    const uint64_t desc_lo = smem_desc(hi + R::kSplitFloats + rb / 8 * kCoreSbo / 4);
    hi = hi + 2 * R::kSplitFloats == split_ring + kSplitStages * 2 * R::kSplitFloats ? split_ring
                                                                                      : hi + 2 * R::kSplitFloats;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t at = static_cast<uint64_t>(s * 2 * kCoreLbo / 16);  // the step's two core matrices
      wgmma_tf32(part, wlo[4 * kc + s], desc_hi + at, s == 0 ? 0 : 1);
      wgmma_tf32(part, whi[4 * kc + s], desc_lo + at, 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_tf32(part, whi[4 * kc + s], desc_hi + static_cast<uint64_t>(s * 2 * kCoreLbo / 16), 1);
    wgmma_commit();
  };
  // chunk kc of a tile: its products in flight, the next chunk prepared meanwhile, then its partial
  // added to the tile's sum
  auto chunk = [&](auto kc_const, long long row0) {
    constexpr int kc = decltype(kc_const)::value;
    multiply(kc_const);
    if (kc + 1 < CHUNKS || row0 + row_stride < M) prepare();
    wgmma_wait<0>();
    pin(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] = kc == 0 ? part[i] : sum[i] + part[i];
  };

  for (int s = 0; s < R::kRawStages - 1; ++s) issue();
  prepare();
  for (long long row0 = static_cast<long long>(blockIdx.x) * kTileRows; row0 < M; row0 += row_stride) {
    chunk(std::integral_constant<int, 0>{}, row0);
    if (CHUNKS > 1) chunk(std::integral_constant<int, 1>{}, row0);
    if (CHUNKS > 2) {
      chunk(std::integral_constant<int, 2>{}, row0);
      chunk(std::integral_constant<int, 3>{}, row0);
    }
    // the tile's epilogue: bias, ReLU, store; sum[4j + q] is column cb (+ 8 for q >= 2) of row 8j + 2t (+ q odd)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long row = row0 + rb + 8 * j + 2 * t + (q & 1);
        const int col = cb + 8 * (q >> 1);
        float v = sum[4 * j + q] + (q >> 1 ? b1 : b0);
        if (relu) v = fmaxf(v, 0.f);
        if (row < M && col < N) c[row * ldc + col] = v;
      }
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------------------------------
// weight-gradient kernel: partial[s][k][n] = sum over split s's rows r of X[r][k] * G'[r][n], with
// G' = G * [gate > 0]; partial_b[s][n] = sum over those rows of G'[r][n]. The block's output tile is
// TK x TN (8 warps as WM x WN, each (16 MT) x (8 NT)); mma's A is X^T, read transposed from the chunk.

template <int WM, int WN, int MT, int NT>
struct WgradTile {
  static constexpr int TK = WM * MT * 16, TN = WN * NT * 8, LdX = ld_kn(TK), LdG = ld_kn(TN);
  static constexpr int kXFloats = kBK * LdX, kGFloats = kBK * LdG, kStage = kXFloats + 2 * kGFloats;
  static constexpr int kSmemBytes = 4 * (2 * kStage + kThreads);
};

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ gr, long long ldgr,
             const float* __restrict__ gate, long long ldy, float* __restrict__ partials,
             float* __restrict__ partials_b, long long rows_per_split, long long M, int K, int N, int vec_x,
             int vec_g) {
  static_assert(WM * WN == kWarps, "8 warps a block");
  static_assert(kThreads % (WN * NT * 8) == 0, "a thread keeps one column of the bias gradient");
  using T = WgradTile<WM, WN, MT, NT>;
  extern __shared__ __align__(1024) float smem[];
  float* red = smem + 2 * T::kStage;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int s = blockIdx.x, k0 = blockIdx.y * T::TK, n0 = blockIdx.z * T::TN;
  const long long r_begin = s * rows_per_split;
  const long long r_end = r_begin + rows_per_split < M ? r_begin + rows_per_split : M;
  const int chunks = r_end > r_begin ? static_cast<int>((r_end - r_begin + kBK - 1) / kBK) : 0;
  const bool db_on = partials_b != nullptr && blockIdx.y == 0;

  auto issue = [&](int ch) {
    float* st = smem + (ch & 1) * T::kStage;
    const long long row0 = r_begin + static_cast<long long>(ch) * kBK;
    stage<kBK, T::TK>(st, T::LdX, x, ldx, row0, r_end, k0, K, vec_x);
    stage<kBK, T::TN>(st + T::kXFloats, T::LdG, gr, ldgr, row0, r_end, n0, N, vec_g);
    if (gate != nullptr) stage<kBK, T::TN>(st + T::kXFloats + T::kGFloats, T::LdG, gate, ldy, row0, r_end, n0, N, vec_g);
    cp_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float dbs = 0.f;  // this thread's column (threadIdx.x % TN) of the bias gradient, its rows in order

  if (chunks > 0) issue(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      issue(ch + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* X = smem + (ch & 1) * T::kStage;
    float* G = const_cast<float*>(X) + T::kXFloats;
    if (gate != nullptr || db_on) {
      const float* Y = G + T::kGFloats;
      for (int i = threadIdx.x; i < kBK * T::TN; i += kThreads) {
        const int q = i / T::TN * T::LdG + i % T::TN;
        float v = G[q];
        if (gate != nullptr && !(Y[q] > 0.f)) {
          v = 0.f;
          G[q] = 0.f;
        }
        dbs += v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* xr = X + (kk + t) * T::LdX + wm * MT * 16 + i * 16 + g;
        const float av[4] = {xr[0], xr[8], xr[4 * T::LdX], xr[4 * T::LdX + 8]};
#pragma unroll
        for (int q = 0; q < 4; ++q) split(av[q], ahi[i][q], alo[i][q]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* gq = G + (kk + t) * T::LdG + wn * NT * 8 + j * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(gq[0], bh0, bl0);
        split(gq[4 * T::LdG], bh1, bl1);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_tf32(acc[i][j], alo[i], bh0, bh1);
          mma_tf32(acc[i][j], ahi[i], bl0, bl1);
          mma_tf32(acc[i][j], ahi[i], bh0, bh1);
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }

  const long long kn = static_cast<long long>(K) * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm * MT * 16 + i * 16 + g + 8 * h, n = n0 + wn * NT * 8 + j * 8 + 2 * t;
        if (k >= K) continue;
        float* p = partials + s * kn + static_cast<long long>(k) * N + n;
        if (n < N) p[0] = acc[i][j][2 * h];
        if (n + 1 < N) p[1] = acc[i][j][2 * h + 1];
      }
  if (db_on) {  // the threads of one column, in thread order
    red[threadIdx.x] = dbs;
    __syncthreads();
    if (threadIdx.x < T::TN && n0 + threadIdx.x < N) {
      float v = 0.f;
      for (int q = threadIdx.x; q < kThreads; q += T::TN) v += red[q];
      partials_b[static_cast<long long>(s) * N + n0 + threadIdx.x] = v;
    }
  }
}

// dW[k * sok + n * son] = the sum over s of partial[s][k][n], db[n] likewise from partial_b, in one fixed
// order: a block takes 32 outputs (a lane each); warp w adds splits w, w + 8, w + 16, ... in order, then
// the eight warps' sums are added in warp order
constexpr int kReduceOutputs = 32;

__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ partials, const float* __restrict__ partials_b, int splits, int K,
                    int N, float* __restrict__ dw, long long sok, long long son, float* __restrict__ db) {
  __shared__ float sums[kWarps][kReduceOutputs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long kn = static_cast<long long>(K) * N, outs = kn + (db != nullptr ? N : 0);
  const long long i = static_cast<long long>(blockIdx.x) * kReduceOutputs + lane;
  float v = 0.f;
  if (i < outs) {
    const float* src = i < kn ? partials + i : partials_b + (i - kn);
    const long long stride = i < kn ? kn : N;
#pragma unroll 4
    for (int s = warp; s < splits; s += kWarps) v += src[s * stride];
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && i < outs) {
    float total = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += sums[w][lane];
    if (i < kn)
      dw[i / N * sok + i % N * son] = total;
    else
      db[i - kn] = total;
  }
}

// ---------------------------------------------------------------------------------------------------

// the dynamic shared memory above 48 KB, allowed once per kernel and device (bit d of *devices)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned* devices) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (*devices >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *devices |= 1u << dev;
  return err;
}

// persistent blocks of the rows kernel: what the card holds at once, shared by the column tiles
template <typename Kernel>
cudaError_t rows_grid(Kernel kernel, int smem, long long tiles, int col_tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) / col_tiles;
  if (most < 1) most = 1;
  *blocks = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
}

template <int WM, int WN, int MT, int NT>
int launch_rows(const float* a, long long lda, const float* gate, long long ldg, const float* b, long long sbk,
                long long sbn, const float* bias, int relu, float* c, long long ldc, long long M, int N, int K,
                bool vec, bool vec2, cudaStream_t stream) {
  using T = RowsTile<WM, WN, MT, NT>;
  auto kernel = rows_kernel<WM, WN, MT, NT>;
  static unsigned devices = 0;  // set at a kernel's first launch on a device: an eager warm-up step
  cudaError_t err = allow_smem(kernel, T::smem_bytes(true), &devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = T::smem_bytes(gate != nullptr);
  const long long tiles = (M + T::BM - 1) / T::BM;
  const int col_tiles = (N + T::BN - 1) / T::BN;
  int blocks = 0;
  err = rows_grid(kernel, smem, tiles, col_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks, col_tiles), kThreads, smem, stream>>>(a, lda, gate, ldg, b, sbk, sbn, bias, relu, c, ldc,
                                                               M, N, K, vec ? 1 : 0, vec2 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int CHUNKS, bool GATE>
int launch_rows_wgmma_chunks(const float* a, long long lda, const float* gate, long long ldg, const float* b,
                             long long sbk, long long sbn, const float* bias, int relu, float* c, long long ldc,
                             long long M, int N, int K, bool vec, cudaStream_t stream) {
  auto kernel = rows_wgmma_kernel<BN, CHUNKS, GATE>;
  constexpr int smem = WgRing<BN, GATE>::kSmemBytes;
  static unsigned devices = 0;
  cudaError_t err = allow_smem(kernel, smem, &devices);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (M + WgRing<BN, GATE>::kTileRows - 1) / WgRing<BN, GATE>::kTileRows;
  const int col_tiles = (N + BN - 1) / BN;
  const long long most = sms / col_tiles > 0 ? sms / col_tiles : 1;
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<dim3(blocks, col_tiles), kWgThreads, smem, stream>>>(a, lda, gate, ldg, b, sbk, sbn, bias, relu, c, ldc,
                                                                 M, N, K, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// the wgmma rows kernel for K <= 128: K's 32-column chunks rounded up to 1, 2 or 4 (zeros past K)
template <int BN, bool GATE>
int launch_rows_wgmma(const float* a, long long lda, const float* gate, long long ldg, const float* b, long long sbk,
                      long long sbn, const float* bias, int relu, float* c, long long ldc, long long M, int N, int K,
                      bool vec, cudaStream_t stream) {
  if (K <= kBK)
    return launch_rows_wgmma_chunks<BN, 1, GATE>(a, lda, gate, ldg, b, sbk, sbn, bias, relu, c, ldc, M, N, K, vec,
                                                 stream);
  if (K <= 2 * kBK)
    return launch_rows_wgmma_chunks<BN, 2, GATE>(a, lda, gate, ldg, b, sbk, sbn, bias, relu, c, ldc, M, N, K, vec,
                                                 stream);
  return launch_rows_wgmma_chunks<BN, 4, GATE>(a, lda, gate, ldg, b, sbk, sbn, bias, relu, c, ldc, M, N, K, vec,
                                               stream);
}

template <int WM, int WN, int MT, int NT>
int launch_wgrad(const float* x, long long ldx, const float* gr, long long ldgr, const float* gate, long long ldy,
                 float* partials, float* partials_b, int splits, long long rows_per_split, long long M, int K,
                 int N, bool vec_x, bool vec_g, cudaStream_t stream) {
  using T = WgradTile<WM, WN, MT, NT>;
  auto kernel = wgrad_kernel<WM, WN, MT, NT>;
  static unsigned devices = 0;
  const cudaError_t err = allow_smem(kernel, T::kSmemBytes, &devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, (K + T::TK - 1) / T::TK, (N + T::TN - 1) / T::TN);
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(x, ldx, gr, ldgr, gate, ldy, partials, partials_b,
                                                    rows_per_split, M, K, N, vec_x ? 1 : 0, vec_g ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

bool vec4(const void* p, long long ld, int width) { return aligned16(p) && ld % 4 == 0 && width % 4 == 0; }

}  // namespace

extern "C" {

// C [M, N] (row stride ldc) = act(A [M, K] (row stride lda; * [gate > 0] where gate, [M, K] of row stride
// ldg, is not null) B + bias), B[k][n] = b[k * sbk + n * sbn]; bias [N] or null; relu 0 or 1. The column
// tile follows N: 128 where N > 64, 64 where N > 8, else 8. One launch on `stream`; returns its
// cudaError_t (cudaErrorInvalidValue for a shape it does not take).
int sgnn_f32_product_rows(const void* a, long long lda, const void* gate, long long ldg, const void* b,
                          long long sbk, long long sbn, const void* bias, int relu, void* c, long long ldc,
                          long long M, int N, int K, void* stream) {
  if (M < 0 || N < 1 || K < 1 || lda < K || ldc < N || (gate != nullptr && ldg < K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const auto* A = static_cast<const float*>(a);
  const auto* G = static_cast<const float*>(gate);
  const auto* B = static_cast<const float*>(b);
  const auto* bi = static_cast<const float*>(bias);
  auto* C = static_cast<float*>(c);
  const bool vec = vec4(a, lda, K) && (gate == nullptr || vec4(gate, ldg, K));
  const bool vec2 = reinterpret_cast<uintptr_t>(c) % 8 == 0 && ldc % 2 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= kKC && N > 8) {  // the tensor cores' asynchronous products (wgmma)
    if (N > 64)
      return G != nullptr ? launch_rows_wgmma<128, true>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, st)
                          : launch_rows_wgmma<128, false>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, st);
    return G != nullptr ? launch_rows_wgmma<64, true>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, st)
                        : launch_rows_wgmma<64, false>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, st);
  }
  if (N > 64) return launch_rows<2, 4, 4, 4>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, vec2, st);
  if (N > 8) return launch_rows<4, 2, 2, 4>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, vec2, st);
  return launch_rows<8, 1, 1, 1>(A, lda, G, ldg, B, sbk, sbn, bi, relu, C, ldc, M, N, K, vec, vec2, st);
}

// dW (dw[k * sok + n * son], [K, N]) = X^T G', db [N] = column sums of G' (db null: not taken), with
// G' = G * [gate > 0] (gate null: G' = G); X [M, K] of row stride ldx, G and gate [M, N] of row strides
// ldgr and ldy. Rows are split as [s * rows_per_split, (s + 1) * rows_per_split) for s < splits (the
// caller's partition, which covers M); partials [splits, K, N] and partials_b [splits, N] (with db) are
// the caller's scratch. Two launches on `stream`; returns their cudaError_t.
int sgnn_f32_product_wgrad(const void* x, long long ldx, const void* gr, long long ldgr, const void* gate,
                           long long ldy, void* partials, void* partials_b, int splits, long long rows_per_split,
                           void* dw, long long sok, long long son, void* db, long long M, int K, int N,
                           void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || rows_per_split < 1 || ldx < K || ldgr < N ||
      (gate != nullptr && ldy < N) || (db != nullptr) != (partials_b != nullptr) ||
      static_cast<long long>(splits) * rows_per_split < M || static_cast<long long>(splits - 1) * rows_per_split >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* X = static_cast<const float*>(x);
  const auto* Gr = static_cast<const float*>(gr);
  const auto* Y = static_cast<const float*>(gate);
  auto* P = static_cast<float*>(partials);
  auto* Pb = static_cast<float*>(partials_b);
  const bool vx = vec4(x, ldx, K);
  const bool vg = vec4(gr, ldgr, N) && (gate == nullptr || vec4(gate, ldy, N));
  auto st = static_cast<cudaStream_t>(stream);
  int err;
  if (K > 64) {
    if (N > 64)
      err = launch_wgrad<2, 4, 4, 4>(X, ldx, Gr, ldgr, Y, ldy, P, Pb, splits, rows_per_split, M, K, N, vx, vg, st);
    else if (N > 8)
      err = launch_wgrad<4, 2, 2, 4>(X, ldx, Gr, ldgr, Y, ldy, P, Pb, splits, rows_per_split, M, K, N, vx, vg, st);
    else
      err = launch_wgrad<8, 1, 1, 1>(X, ldx, Gr, ldgr, Y, ldy, P, Pb, splits, rows_per_split, M, K, N, vx, vg, st);
  } else {
    if (N > 64)
      err = launch_wgrad<2, 4, 2, 4>(X, ldx, Gr, ldgr, Y, ldy, P, Pb, splits, rows_per_split, M, K, N, vx, vg, st);
    else if (N > 8)
      err = launch_wgrad<2, 4, 2, 2>(X, ldx, Gr, ldgr, Y, ldy, P, Pb, splits, rows_per_split, M, K, N, vx, vg, st);
    else
      err = launch_wgrad<8, 1, 1, 1>(X, ldx, Gr, ldgr, Y, ldy, P, Pb, splits, rows_per_split, M, K, N, vx, vg, st);
  }
  if (err != 0) return err;
  const long long outs = static_cast<long long>(K) * N + (db != nullptr ? N : 0);
  wgrad_reduce_kernel<<<static_cast<unsigned>((outs + kReduceOutputs - 1) / kReduceOutputs), kThreads, 0, st>>>(
      P, Pb, splits, K, N, static_cast<float*>(dw), sok, son, static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

const char* sgnn_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
