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
//   K3  the same with pq, pb recomputed from the words in the same loop
//   K4  1 - px / (32 W)
// Empty-vs-empty Jaccard is 1.0. Every division is the IEEE round-to-nearest
// __fdiv_rn (and the build uses no fast-math), so results equal the plain
// PyTorch version bit for bit.
//
// Bound: per (q, n, w) an XOR, a popcount and an add against words that
// every output re-reads, so integer issue bounds it, and popcount, at 16
// per SM per clock (a quarter of the other integer operations), is the
// floor of any ALU design.
//
// K2 design (`jaccard_cached_tile`): a block owns a 32 x 32 tile of
// outputs. It stages its 32 query rows and 32 database rows in shared
// memory, up to 128 words of each row per pass, with coalesced loads
// (neighbouring threads on neighbouring words; 16-byte `uint4` loads when
// W is a multiple of 4 and both bases are 16-byte aligned, single words
// otherwise). Each of its 128 threads then keeps a 2 x 4 register tile of
// px counters and reads the staged rows as `uint4`: every word it loads
// serves 2 or 4 outputs. The rows are padded to a stride of 132 words, so
// the 8 threads of a quarter-warp read 8 database rows in 8 distinct bank
// groups and share one query row (a broadcast). At Q = N = 512 the grid
// is 16 x 16 = 256 blocks, about two per SM. Ragged Q, N and W are masked
// by zero-filling the staged tile (0 ^ 0 adds no bits) and by the store.
//
// K3 and K4 (`pair_kernel`): one thread per output (q, n) with the loop
// over W inside it, in blocks of 32 n-columns by 8 q-rows; a warp reads
// 32 database rows in one load, so they wait on uncoalesced loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------ K2: tiled kernel
constexpr int kTile = 32;                   // query rows = database rows per block
constexpr int kChunk = 128;                 // words of each row staged per pass
constexpr int kStride = kChunk + 4;         // padded shared row stride, words
constexpr int kThreadsN = 8;                // thread owns columns tx + 8 j
constexpr int kThreadsQ = 16;               // thread owns rows ty + 16 i
constexpr int kRows = kTile / kThreadsQ;    // 2
constexpr int kCols = kTile / kThreadsN;    // 4
constexpr int kTileThreads = kThreadsN * kThreadsQ;   // 128

// Stage rows [r0, r0 + kTile) x words [k0, k0 + kw) of `src` (R rows of W
// words) into `dst`, zero-filling rows >= R and words kw .. kw4 - 1.
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
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kw4; i += kTileThreads) {
      const int r = i / kw4;
      const int c = i - r * kw4;
      uint32_t v = 0u;
      if (r0 + r < R && c < kw)
        v = src[static_cast<size_t>(r0 + r) * W + k0 + c];
      dst[r][c] = v;
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
jaccard_cached_tile(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const int32_t* __restrict__ pa,
                    const int32_t* __restrict__ pb,
                    float* __restrict__ out, int Q, int N, int W, bool vec) {
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

  for (int k0 = 0; k0 < W; k0 += kChunk) {
    const int kw = min(kChunk, W - k0);
    const int kw4 = (kw + 3) & ~3;
    if (k0 > 0) __syncthreads();          // the previous chunk is consumed
    stage(sa, a, q0, Q, W, k0, kw, kw4, vec);
    stage(sb, b, n0, N, W, k0, kw, kw4, vec);
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

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kThreadsQ * i;
    if (q >= Q) continue;
    const int sq = pa[q];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = n0 + tx + kThreadsN * j;
      if (n >= N) continue;
      const int s = sq + pb[n];
      const float union2 = static_cast<float>(s + px[i][j]);
      const float inter2 = static_cast<float>(s - px[i][j]);
      out[static_cast<size_t>(q) * N + n] =
          union2 > 0.0f ? __fdiv_rn(inter2, fmaxf(union2, 1.0f)) : 1.0f;
    }
  }
}

// ----------------------------------------- K3, K4: one thread per output
constexpr int kBlockN = 32;
constexpr int kBlockQ = 8;

enum Epilogue { kNoCache = 1, kHamming = 2 };

template <int EPI>
__global__ void pair_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            float* __restrict__ out, int Q, int N, int W) {
  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int q = blockIdx.y * kBlockQ + threadIdx.y;
  if (q >= Q || n >= N) return;
  const uint32_t* ar = a + static_cast<size_t>(q) * W;
  const uint32_t* br = b + static_cast<size_t>(n) * W;
  int px = 0, ca = 0, cb = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t x = ar[w];
    const uint32_t y = br[w];
    px += __popc(x ^ y);
    if (EPI == kNoCache) {
      ca += __popc(x);
      cb += __popc(y);
    }
  }
  float r;
  if (EPI == kHamming) {
    r = __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(px),
                                  static_cast<float>(W * 32)));
  } else {
    const int s = ca + cb;
    const float union2 = static_cast<float>(s + px);
    const float inter2 = static_cast<float>(s - px);
    r = union2 > 0.0f ? __fdiv_rn(inter2, fmaxf(union2, 1.0f)) : 1.0f;
  }
  out[static_cast<size_t>(q) * N + n] = r;
}

template <int EPI>
int launch_pair(const void* a, const void* b, void* out, int Q, int N, int W,
                void* stream) {
  if (Q > 0 && N > 0) {
    const dim3 block(kBlockN, kBlockQ);
    const dim3 grid((N + kBlockN - 1) / kBlockN, (Q + kBlockQ - 1) / kBlockQ);
    pair_kernel<EPI><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<float*>(out), Q, N, W);
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
  if (Q > 0 && N > 0) {
    const bool vec = W % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
    const dim3 grid((N + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
    jaccard_cached_tile<<<grid, kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb),
        static_cast<float*>(out), Q, N, W, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fold_bitmap_jaccard_nocache(const void* a, const void* b,
                                           void* out, int Q, int N, int W,
                                           void* stream) {
  return launch_pair<kNoCache>(a, b, out, Q, N, W, stream);
}

extern "C" int fold_hamming(const void* a, const void* b, void* out, int Q,
                            int N, int W, void* stream) {
  return launch_pair<kHamming>(a, b, out, Q, N, W, stream);
}
