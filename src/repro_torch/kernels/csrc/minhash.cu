// K1 — MinHash signature min-reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_minhash_kernel`, reached through
// `minhash_kernel_signatures` in src/repro/kernels/minhash.py.
//
//   sig[b, h] = min over l of fmix32((sh[b, l] ^ seed[h]) * 0x9E3779B9 + seed[h])
//
// taken under the unsigned order, with shingles equal to 0xFFFFFFFF (padding)
// masked out; a row with no valid shingle keeps 0xFFFFFFFF.
//
// Bound: 32-bit integer ALU work, about a dozen operations per (b, h, l)
// against a few bytes per (b, l), so the card's integer issue rate and not
// its memory bounds it. Design: the TPU kernel carried the output tile as a
// min-accumulator across a sequential L grid axis; CUDA blocks run in no
// order, so the reduction over L lives inside the thread. One block per
// (document b, group of 128 hash functions): the block stages the row's
// shingles in shared memory a tile at a time, every thread owns one h and
// folds each staged shingle into a register minimum. All threads of a warp
// read the same shingle, so the shared-memory read is a broadcast and the
// padding test is warp-uniform. The ragged L edge is masked by the tile
// length, not padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // hash functions per block
constexpr int kTileL = 1024;    // shingles staged per pass

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void minhash_kernel(const uint32_t* __restrict__ sh,
                               const uint32_t* __restrict__ seeds,
                               uint32_t* __restrict__ out, int L, int H) {
  __shared__ uint32_t tile[kTileL];
  const int b = blockIdx.x;
  const int h = blockIdx.y * kThreads + threadIdx.x;
  const bool live = h < H;
  const uint32_t seed = live ? seeds[h] : 0u;
  const uint32_t* row = sh + static_cast<size_t>(b) * L;
  uint32_t best = 0xFFFFFFFFu;
  for (int l0 = 0; l0 < L; l0 += kTileL) {
    const int n = min(kTileL, L - l0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = row[l0 + i];
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const uint32_t s = tile[i];
      if (s != 0xFFFFFFFFu) {
        const uint32_t v = fmix32((s ^ seed) * 0x9E3779B9u + seed);
        best = v < best ? v : best;
      }
    }
  }
  if (live) out[static_cast<size_t>(b) * H + h] = best;
}

}  // namespace

// sh (B, L), seeds (H,), out (B, H): contiguous 32-bit words on the device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fold_minhash(const void* sh, const void* seeds, void* out,
                            int B, int L, int H, void* stream) {
  if (B > 0 && H > 0) {
    const dim3 grid(B, (H + kThreads - 1) / kThreads);
    minhash_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(sh), static_cast<const uint32_t*>(seeds),
        static_cast<uint32_t*>(out), L, H);
  }
  return static_cast<int>(cudaGetLastError());
}
