// K1 — MinHash signature min-reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_minhash_kernel`, reached through
// `minhash_kernel_signatures` in src/repro/kernels/minhash.py.
//
//   sig[b, h] = min over l of fmix32((sh[b, l] ^ seed[h]) * 0x9E3779B9 + seed[h])
//
// taken under the unsigned order, with shingles equal to 0xFFFFFFFF (padding,
// wherever it stands in the row) masked out; a row with no valid shingle
// keeps 0xFFFFFFFF.
//
// Bound: 32-bit integer ALU work, about a dozen operations per (b, h, valid
// l) against four bytes per (b, l), so the card's integer issue rate and
// not its memory bounds it, and only the valid shingles count.
//
// Design: the TPU kernel carried the output tile as a min-accumulator
// across a sequential L grid axis; CUDA blocks run in no order, so the
// reduction over L lives inside the block. One block of 128 threads per
// (document b, group of hash functions). The block loads the row's
// shingles a tile of 512 at a time (four coalesced loads in flight per
// thread) and compacts the valid ones into shared memory (warp ballot, a
// prefix count within the warp, one shared atomic per warp for its base:
// a minimum does not care about order). Threads are laid out over (hash
// slot, shingle partition): G lanes of a warp share a partition and each
// owns HPT hash functions, h = group * G * HPT + k * G + slot, so all
// lanes are live whenever G * HPT divides H (at H = 112: G = 16, HPT = 7,
// eight partitions per block). A thread folds every staged shingle of
// its partition into HPT register minima, two shingles per iteration
// (2 * HPT independent hash chains). The compacted list is padded to a
// whole number of iterations with copies of its first entry, which a
// minimum absorbs. The partitions' minima meet in shared memory at the
// end, and one coalesced store writes the group's hash functions.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLoads = 4;                        // shingles each thread loads per tile
constexpr int kTileL = kThreads * kLoads;        // shingles staged per pass
constexpr int kUnroll = 2;                       // shingles per thread per iteration
constexpr int kMaxHpt = 8;                       // hash functions per thread
constexpr uint32_t kPad = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <int HPT>
__global__ void __launch_bounds__(kThreads)
minhash_kernel(const uint32_t* __restrict__ sh,
               const uint32_t* __restrict__ seeds,
               uint32_t* __restrict__ out, int L, int H, int log_g) {
  // compacted tile, plus room to pad it to whole iterations (at most
  // kThreads partitions x kUnroll entries)
  __shared__ uint32_t tile[kTileL + kThreads * kUnroll];
  __shared__ uint32_t red[kThreads * HPT];
  __shared__ int count;
  const int G = 1 << log_g;
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x & (G - 1);
  const int part = threadIdx.x >> log_g;
  const int parts = kThreads >> log_g;
  const int step = parts * kUnroll;
  const int h0 = blockIdx.y * G * HPT;
  uint32_t seed[HPT], best[HPT];
#pragma unroll
  for (int k = 0; k < HPT; ++k) {
    const int h = h0 + k * G + slot;
    seed[k] = h < H ? seeds[h] : 0u;
    best[k] = kPad;
  }
  const uint32_t* row = sh + static_cast<size_t>(blockIdx.x) * L;

  for (int l0 = 0; l0 < L; l0 += kTileL) {
    __syncthreads();                     // the previous tile is consumed
    if (threadIdx.x == 0) count = 0;
    uint32_t v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = l0 + threadIdx.x + j * kThreads;
      v[j] = i < L ? row[i] : kPad;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const bool ok = v[j] != kPad;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, ok);
      int base = 0;
      if (lane == 0 && m != 0u) base = atomicAdd(&count, __popc(m));
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      if (ok) tile[base + __popc(m & ((1u << lane) - 1u))] = v[j];
    }
    __syncthreads();
    const int n = count;
    if (n == 0) continue;
    const int npad = (n + step - 1) / step * step;
    for (int i = n + threadIdx.x; i < npad; i += kThreads) tile[i] = tile[0];
    __syncthreads();
    for (int i = part; i < npad; i += step) {
      uint32_t s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] = tile[i + u * parts];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < HPT; ++k)
          best[k] = min(best[k],
                        fmix32((s[u] ^ seed[k]) * 0x9E3779B9u + seed[k]));
    }
  }

  // merge the partitions' minima; red is indexed by hash within the group
#pragma unroll
  for (int k = 0; k < HPT; ++k) red[part * G * HPT + k * G + slot] = best[k];
  __syncthreads();
  for (int t = threadIdx.x; t < G * HPT; t += kThreads) {
    uint32_t m = kPad;
    for (int p = 0; p < parts; ++p) m = min(m, red[p * G * HPT + t]);
    if (h0 + t < H) out[static_cast<size_t>(blockIdx.x) * H + h0 + t] = m;
  }
}

// Thread layout for H hash functions: the fewest hash groups per document
// (each group stages the row once), then the fewest idle (hash slot) lanes,
// then the widest G (the fewest partitions to merge).
void layout(int H, int* log_g, int* hpt, int* groups) {
  long best_slots = 0;
  *groups = 0;
  for (int lg = 5; lg >= 0; --lg) {
    for (int k = 1; k <= kMaxHpt; ++k) {
      const int per = (1 << lg) * k;
      const int grp = (H + per - 1) / per;
      const long slots = static_cast<long>(grp) * per;
      if (*groups == 0 || grp < *groups ||
          (grp == *groups && slots < best_slots)) {
        best_slots = slots;
        *log_g = lg;
        *hpt = k;
        *groups = grp;
      }
    }
  }
}

template <int HPT>
void launch(const void* sh, const void* seeds, void* out, int B, int L, int H,
            int log_g, int groups, cudaStream_t stream) {
  minhash_kernel<HPT><<<dim3(B, groups), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(sh), static_cast<const uint32_t*>(seeds),
      static_cast<uint32_t*>(out), L, H, log_g);
}

}  // namespace

// sh (B, L), seeds (H,), out (B, H): contiguous 32-bit words on the device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fold_minhash(const void* sh, const void* seeds, void* out,
                            int B, int L, int H, void* stream) {
  if (B > 0 && H > 0) {
    int log_g = 0, hpt = 1, groups = 1;
    layout(H, &log_g, &hpt, &groups);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hpt) {
      case 1: launch<1>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      case 2: launch<2>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      case 3: launch<3>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      case 4: launch<4>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      case 5: launch<5>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      case 6: launch<6>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      case 7: launch<7>(sh, seeds, out, B, L, H, log_g, groups, s); break;
      default: launch<8>(sh, seeds, out, B, L, H, log_g, groups, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
