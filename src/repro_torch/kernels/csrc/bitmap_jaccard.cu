// K2, K3, K4 — bitmap-Jaccard / Hamming similarity matrices for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels of src/repro/kernels/bitmap_jaccard.py:
//   K2 `_jaccard_kernel_cached`   (bitmap_jaccard_matrix, cached=True)
//   K3 `_jaccard_kernel_nocache`  (bitmap_jaccard_matrix, cached=False)
//   K4 `_hamming_kernel`          (hamming_matrix)
//
// All three compute px = sum over w of popcount(a[q, w] ^ b[n, w]) and
// differ only in the epilogue:
//   K2  s = pq[q] + pb[n] (cached popcounts);  (s - px) / max(s + px, 1)
//   K3  the same with pq, pb recounted inside the kernel from the rows the
//       block stages, once per row and block, as the Pallas body recounts
//       them from its tile's rows
//   K4  fma(-px, f32(1 / (32 W)), 1), rounded once: what XLA makes of the
//       reference's `1 - px / (32 W)`, a division by a constant
// Empty-vs-empty Jaccard is 1.0. The Jaccard division is the IEEE
// round-to-nearest __fdiv_rn, K4 uses the __fmaf_rn intrinsic, and the
// build uses no fast-math, so results equal the plain PyTorch version bit
// for bit.
//
// Bound: per (q, n, w) an XOR, a popcount and an add against words that
// every output re-reads, so integer issue bounds it, and popcount, at 16
// per SM per clock (a quarter of the other integer operations), is the
// floor of any ALU design.
//
// Design (`bitmap_tile<EPI>`, one kernel body for the three epilogues): a
// block owns a 32 x 32 tile of outputs. It stages its 32 query rows and 32
// database rows in shared memory, up to 128 words of each row per pass,
// with coalesced loads (neighbouring threads on neighbouring words; 16-byte
// `uint4` loads when W is a multiple of 4 and both bases are 16-byte
// aligned, single words otherwise). Each of its 128 threads then keeps a
// 2 x 4 register tile of px counters and reads the staged rows as `uint4`:
// every word it loads serves 2 or 4 outputs. The rows are padded to a
// stride of 132 words, so the 8 threads of a quarter-warp read 8 database
// rows in 8 distinct bank groups and share one query row (a broadcast). At
// Q = N = 512 the grid is 16 x 16 = 256 blocks, about two per SM. Ragged
// Q, N and W are masked by zero-filling the staged tile (0 ^ 0 adds no
// bits, and a zero word adds nothing to a recount) and by the store.
//
// K3's recount happens while staging, on the words already in registers:
// (32 + 32) W popcounts beside the block's 32 x 32 W, about 6% more. Each
// row's count lives in the first padding word of its shared row (column
// 128, which the staging and the popcount loop never touch), so K3 needs
// no more shared memory than K2. When a whole warp stages one row (a full
// 128-word pass) one `__reduce_add_sync` sums the warp's words before a
// single shared add; otherwise each thread adds its own words' count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                   // query rows = database rows per block
constexpr int kChunk = 128;                 // words of each row staged per pass
constexpr int kStride = kChunk + 4;         // padded shared row stride, words
constexpr int kThreadsN = 8;                // thread owns columns tx + 8 j
constexpr int kThreadsQ = 16;               // thread owns rows ty + 16 i
constexpr int kRows = kTile / kThreadsQ;    // 2
constexpr int kCols = kTile / kThreadsN;    // 4
constexpr int kTileThreads = kThreadsN * kThreadsQ;   // 128

// Epilogues, the template argument of bitmap_tile
constexpr int kCached = 0;     // K2
constexpr int kNoCache = 1;    // K3
constexpr int kHamming = 2;    // K4

// Add `bits` to the recount of staged row r, held in dst[r][kChunk].
// `warp_row`: every lane of the warp stages a word of row r, so the warp's
// sum needs one shared add.
__device__ __forceinline__ void count_row(uint32_t (*dst)[kStride], int r,
                                          uint32_t bits, bool warp_row) {
  if (warp_row) {
    bits = __reduce_add_sync(0xffffffffu, bits);
    if ((threadIdx.x & 31) == 0) atomicAdd(&dst[r][kChunk], bits);
  } else {
    atomicAdd(&dst[r][kChunk], bits);
  }
}

// Stage rows [r0, r0 + kTile) x words [k0, k0 + kw) of `src` (R rows of W
// words) into `dst`, zero-filling rows >= R and words kw .. kw4 - 1. With
// COUNT, each staged row's popcount is added to dst[row][kChunk].
template <bool COUNT>
__device__ __forceinline__ void stage(uint32_t (*dst)[kStride],
                                      const uint32_t* __restrict__ src,
                                      int r0, int R, int W, int k0, int kw,
                                      int kw4, bool vec) {
  if (vec) {  // kw == kw4, a multiple of 4; every row 16-byte aligned
    const int n4 = kw >> 2;
    for (int i = threadIdx.x; i < kTile * n4; i += kTileThreads) {
      const int r = i / n4;
      const int c = 4 * (i - r * n4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < R)
        v = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r0 + r) * W + k0 + c);
      *reinterpret_cast<uint4*>(&dst[r][c]) = v;
      if constexpr (COUNT)
        count_row(dst, r,
                  __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w),
                  n4 % 32 == 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kw4; i += kTileThreads) {
      const int r = i / kw4;
      const int c = i - r * kw4;
      uint32_t v = 0u;
      if (r0 + r < R && c < kw)
        v = src[static_cast<size_t>(r0 + r) * W + k0 + c];
      dst[r][c] = v;
      if constexpr (COUNT) count_row(dst, r, __popc(v), kw4 % 32 == 0);
    }
  }
}

// pa, pb: the cached popcounts (kCached only; null otherwise)
template <int EPI>
__global__ void __launch_bounds__(kTileThreads)
bitmap_tile(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
            const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
            float* __restrict__ out, int Q, int N, int W, bool vec) {
  constexpr bool kCount = EPI == kNoCache;
  __shared__ __align__(16) uint32_t sa[kTile][kStride];
  __shared__ __align__(16) uint32_t sb[kTile][kStride];
  const int q0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kThreadsN;
  const int ty = threadIdx.x / kThreadsN;
  int px[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) px[i][j] = 0;
  if constexpr (kCount) {
    if (threadIdx.x < kTile) {
      sa[threadIdx.x][kChunk] = 0u;
      sb[threadIdx.x][kChunk] = 0u;
    }
    __syncthreads();
  }

  for (int k0 = 0; k0 < W; k0 += kChunk) {
    const int kw = min(kChunk, W - k0);
    const int kw4 = (kw + 3) & ~3;
    if (k0 > 0) __syncthreads();          // the previous chunk is consumed
    stage<kCount>(sa, a, q0, Q, W, k0, kw, kw4, vec);
    stage<kCount>(sb, b, n0, N, W, k0, kw, kw4, vec);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kw4; c += 4) {
      uint4 x[kRows], y[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        x[i] = *reinterpret_cast<const uint4*>(&sa[ty + kThreadsQ * i][c]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        y[j] = *reinterpret_cast<const uint4*>(&sb[tx + kThreadsN * j][c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          px[i][j] += __popc(x[i].x ^ y[j].x) + __popc(x[i].y ^ y[j].y) +
                      __popc(x[i].z ^ y[j].z) + __popc(x[i].w ^ y[j].w);
    }
  }

  // f32(1 / (32 W)) rounded to nearest; 32 W is exact in f32
  const float inv_bits =
      EPI == kHamming ? __fdiv_rn(1.0f, static_cast<float>(32 * W)) : 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kThreadsQ * i;
    if (q >= Q) continue;
    int sq = 0;
    if constexpr (EPI == kCached) sq = pa[q];
    if constexpr (EPI == kNoCache) sq = sa[ty + kThreadsQ * i][kChunk];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = n0 + tx + kThreadsN * j;
      if (n >= N) continue;
      float r;
      if constexpr (EPI == kHamming) {
        r = __fmaf_rn(-static_cast<float>(px[i][j]), inv_bits, 1.0f);
      } else {
        int s = sq;
        if constexpr (EPI == kCached) s += pb[n];
        if constexpr (EPI == kNoCache) s += sb[tx + kThreadsN * j][kChunk];
        const float union2 = static_cast<float>(s + px[i][j]);
        const float inter2 = static_cast<float>(s - px[i][j]);
        r = union2 > 0.0f ? __fdiv_rn(inter2, fmaxf(union2, 1.0f)) : 1.0f;
      }
      out[static_cast<size_t>(q) * N + n] = r;
    }
  }
}

template <int EPI>
int launch_tile(const void* a, const void* b, const void* pa, const void* pb,
                void* out, int Q, int N, int W, void* stream) {
  if (Q > 0 && N > 0) {
    const bool vec = W % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
    const dim3 grid((N + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
    bitmap_tile<EPI><<<grid, kTileThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb),
        static_cast<float*>(out), Q, N, W, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (Q, W), b (N, W) contiguous 32-bit words; pa (Q,), pb (N,) int32
// popcounts; out (Q, N) float32. Each returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int fold_bitmap_jaccard_cached(const void* a, const void* b,
                                          const void* pa, const void* pb,
                                          void* out, int Q, int N, int W,
                                          void* stream) {
  return launch_tile<kCached>(a, b, pa, pb, out, Q, N, W, stream);
}

extern "C" int fold_bitmap_jaccard_nocache(const void* a, const void* b,
                                           void* out, int Q, int N, int W,
                                           void* stream) {
  return launch_tile<kNoCache>(a, b, nullptr, nullptr, out, Q, N, W, stream);
}

extern "C" int fold_hamming(const void* a, const void* b, void* out, int Q,
                            int N, int W, void* stream) {
  return launch_tile<kHamming>(a, b, nullptr, nullptr, out, Q, N, W, stream);
}
