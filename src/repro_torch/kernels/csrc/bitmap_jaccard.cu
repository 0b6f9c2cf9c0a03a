// K2, K3, K4 — bitmap-Jaccard / Hamming similarity matrices for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels of src/repro/kernels/bitmap_jaccard.py:
//   K2 `_jaccard_kernel_cached`   (bitmap_jaccard_matrix, cached=True)
//   K3 `_jaccard_kernel_nocache`  (bitmap_jaccard_matrix, cached=False)
//   K4 `_hamming_kernel`          (hamming_matrix)
//
// All three share one body — px = sum over w of popcount(a[q, w] ^ b[n, w])
// — and differ only in the epilogue:
//   K2  s = pq[q] + pb[n] (cached popcounts);  (s - px) / max(s + px, 1)
//   K3  the same with pq, pb recomputed from the words in the same loop
//   K4  1 - px / (32 W)
// Empty-vs-empty Jaccard is 1.0. Every division is the IEEE round-to-nearest
// __fdiv_rn (and the build uses no fast-math), so results equal the plain
// PyTorch version bit for bit.
//
// Bound: per (q, n, w) an XOR, a popcount and an add against words that are
// re-read Q and N times, so integer issue (popcount has a quarter of the
// ALU rate) bounds the large case; at the main path's Q = N = 512, W = 128
// the whole matrix is a few microseconds of work and the launch dominates.
// Design: one thread per output (q, n) with the loop over W inside it, a
// block of 32 n-columns by 8 q-rows, so a warp shares its query row (a
// broadcast load) and reuses each database row's cache lines across the W
// loop. The ragged Q and N edges are masked, not padded to the TPU's
// (8, 128) tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 32;
constexpr int kBlockQ = 8;

enum Epilogue { kCached = 0, kNoCache = 1, kHamming = 2 };

template <int EPI>
__global__ void pair_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            const int32_t* __restrict__ pa,
                            const int32_t* __restrict__ pb,
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
    const int s = (EPI == kCached) ? pa[q] + pb[n] : ca + cb;
    const float union2 = static_cast<float>(s + px);
    const float inter2 = static_cast<float>(s - px);
    r = union2 > 0.0f ? __fdiv_rn(inter2, fmaxf(union2, 1.0f)) : 1.0f;
  }
  out[static_cast<size_t>(q) * N + n] = r;
}

template <int EPI>
int launch(const void* a, const void* b, const void* pa, const void* pb,
           void* out, int Q, int N, int W, void* stream) {
  if (Q > 0 && N > 0) {
    const dim3 block(kBlockN, kBlockQ);
    const dim3 grid((N + kBlockN - 1) / kBlockN, (Q + kBlockQ - 1) / kBlockQ);
    pair_kernel<EPI><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb),
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
  return launch<kCached>(a, b, pa, pb, out, Q, N, W, stream);
}

extern "C" int fold_bitmap_jaccard_nocache(const void* a, const void* b,
                                           void* out, int Q, int N, int W,
                                           void* stream) {
  return launch<kNoCache>(a, b, nullptr, nullptr, out, Q, N, W, stream);
}

extern "C" int fold_hamming(const void* a, const void* b, void* out, int Q,
                            int N, int W, void* stream) {
  return launch<kHamming>(a, b, nullptr, nullptr, out, Q, N, W, stream);
}
