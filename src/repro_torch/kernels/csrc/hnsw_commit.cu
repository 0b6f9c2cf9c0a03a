// K5 — the insert's back-links for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The reference commits a batch inside its
// jitted `hnsw_insert_batch` (src/repro/core/hnsw.py, `_commit_batch`: a
// lax.scan over the batch's rows calling `_link_back` at each level), which
// XLA compiles into one program. The port's eager PyTorch had to issue each
// (row, level) back-link as some ninety small launches from a Python loop;
// this kernel takes all of a batch's back-links in one launch.
//
// The work. A back-link adds a new node n to the adjacency row of a target
// node t at level l (hnswlib's mutuallyConnectNewElement): the row's M0
// ids and n are the M0 + 1 candidates, ranked stably by (distance to t,
// position), and the first m_l finite ones are kept (m_l = M0 at level 0,
// M above), -1 padded. With the selection heuristic on, a row that would
// overflow (more than m_l valid candidates) is instead re-selected over
// its sorted candidates: candidate c is taken iff d(c, t) < d(c, s) for
// every s already taken, until m_l are taken. Two back-links to the same
// (level, target) row change it in turn, so they are applied in the
// batch's row order; back-links to different rows are independent.
//
// Schedule (built on the host by the caller): the batch's back-links as
// groups, one per (level, target), each group's new ids in row order.
//
// Design: one warp per group, four groups per block. The warp loads its
// row into shared memory and computes each entry's distance to t once:
// the W words split across the lanes, one warp reduction each. Then, for
// each new id in turn, one more distance, a stable rank of the M0 + 1
// candidates (each lane ranks the positions it owns against all of them,
// ties broken by position, as torch.sort(stable=True) breaks them) and a
// scatter to the ranked order. The row and its distances stay in shared
// memory between new ids, and the row is written back once, at the end.
// The heuristic's candidate-candidate distances are computed as it needs
// them, one warp reduction each, in the same warp.
//
// Distances round as `core/hnsw.py::_pair_dist` rounds them:
//   bitmap_jaccard   2 px / max(pa + pb + px, 1), an IEEE division
//                    (__fdiv_rn), 0 where that denominator is 0
//   minhash_jaccard  fma(-count, f32(1 / H), 1), one rounding (as K4)
//   hamming          px * f32(1 / (32 W)), one rounding (__fmul_rn)
// and the build uses no fast-math, so rows equal the plain version's bit
// for bit.
//
// Bound: memory. Each distance reads a W-word row (512 bytes at W = 128,
// mostly from L2: a batch's targets share their neighbours); about 33 rows
// a group at M0 = 32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // groups (warps) per block
constexpr int kMaxCand = 64;       // M0 + 1 candidates at most
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBitmap = 0;
constexpr int kMinhash = 1;
constexpr int kHamming = 2;

// Distance between nodes a and b (valid ids), the same in every lane.
// inv: f32(1 / H) for minhash_jaccard, f32(1 / (32 W)) for hamming.
template <int METRIC>
__device__ __forceinline__ float pair_dist(const uint32_t* __restrict__ vec,
                                           const int32_t* __restrict__ pb,
                                           int a, int b, int W, float inv,
                                           int lane) {
  const uint32_t* va = vec + static_cast<size_t>(a) * W;
  const uint32_t* vb = vec + static_cast<size_t>(b) * W;
  unsigned s = 0u;
  for (int w = lane; w < W; w += 32) {
    const uint32_t x = __ldg(va + w);
    const uint32_t y = __ldg(vb + w);
    if constexpr (METRIC == kMinhash)
      s += x == y;
    else
      s += __popc(x ^ y);
  }
  s = __reduce_add_sync(kFull, s);
  if constexpr (METRIC == kMinhash) {
    return __fmaf_rn(-static_cast<float>(s), inv, 1.0f);
  } else if constexpr (METRIC == kHamming) {
    return __fmul_rn(static_cast<float>(s), inv);
  } else {
    const int denom = __ldg(pb + a) + __ldg(pb + b) + static_cast<int>(s);
    return denom > 0
               ? __fdiv_rn(2.0f * static_cast<float>(s),
                           static_cast<float>(denom))
               : 0.0f;
  }
}

template <int METRIC, bool HEURISTIC>
__global__ void __launch_bounds__(kWarps * 32)
link_back(int32_t* __restrict__ nbrs, const uint32_t* __restrict__ vec,
          const int32_t* __restrict__ pb,
          const int64_t* __restrict__ g_level,
          const int64_t* __restrict__ g_target,
          const int64_t* __restrict__ g_start,
          const int64_t* __restrict__ new_ids, int G, int cap, int M0, int M,
          int W) {
  // per warp: the row (ids, distances), its ranked copy, the heuristic's
  // taken positions
  __shared__ int s_id[kWarps][2][kMaxCand];
  __shared__ float s_d[kWarps][2][kMaxCand];
  __shared__ int s_take[kWarps][kMaxCand];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= G) return;                       // the whole warp leaves
  const int lev = static_cast<int>(g_level[g]);
  const int t = static_cast<int>(g_target[g]);
  const int m_l = lev == 0 ? M0 : M;
  const int C = M0 + 1;
  float inv = 0.0f;
  if constexpr (METRIC == kMinhash) inv = __fdiv_rn(1.0f, static_cast<float>(W));
  if constexpr (METRIC == kHamming)
    inv = __fdiv_rn(1.0f, static_cast<float>(32 * W));
  int32_t* row = nbrs + (static_cast<size_t>(lev) * cap + t) * M0;
  int* id = s_id[warp][0];
  float* d = s_d[warp][0];
  int* rid = s_id[warp][1];
  float* rd = s_d[warp][1];
  int* take = s_take[warp];

  for (int p = lane; p < M0; p += 32) id[p] = row[p];
  __syncwarp();
  for (int p = 0; p < M0; ++p) {            // id[p] is the same in every lane
    const int c = id[p];
    const float dist = c >= 0 ? pair_dist<METRIC>(vec, pb, t, c, W, inv, lane)
                              : INFINITY;
    if (lane == 0) d[p] = dist;
  }

  const int k1 = static_cast<int>(g_start[g + 1]);
  for (int k = static_cast<int>(g_start[g]); k < k1; ++k) {
    const int n = static_cast<int>(new_ids[k]);
    const float dn = pair_dist<METRIC>(vec, pb, t, n, W, inv, lane);
    if (lane == 0) {
      id[M0] = n;
      d[M0] = dn;
    }
    __syncwarp();
    // stable rank by (distance, position); -1 entries carry +inf
    int valid = 0;
    for (int p = lane; p < C; p += 32) {
      const float dp = d[p];
      int r = 0;
      for (int q = 0; q < C; ++q) {
        const float dq = d[q];
        r += (dq < dp) || (dq == dp && q < p);
      }
      rid[r] = id[p];
      rd[r] = dp;
      valid += id[p] >= 0;
    }
    valid = __reduce_add_sync(kFull, valid);
    __syncwarp();
    if (!HEURISTIC || valid <= m_l) {
      // the m_l closest finite candidates
      for (int p = lane; p < M0; p += 32) {
        const bool keep = p < m_l && rid[p] >= 0;
        id[p] = keep ? rid[p] : -1;
        d[p] = keep ? rd[p] : INFINITY;
      }
    } else {
      // the heuristic over the ranked candidates (valid ones first)
      int taken = 0;                         // the same in every lane
      for (int i = 0; i < valid && taken < m_l; ++i) {
        const int ci = rid[i];
        const float di = rd[i];
        bool ok = true;
        for (int s = 0; s < taken && ok; ++s)
          ok = di < pair_dist<METRIC>(vec, pb, ci, rid[take[s]], W, inv, lane);
        if (ok) {
          if (lane == 0) take[taken] = i;
          ++taken;
          __syncwarp();
        }
      }
      for (int p = lane; p < M0; p += 32) {
        const bool keep = p < taken;
        id[p] = keep ? rid[take[p]] : -1;
        d[p] = keep ? rd[take[p]] : INFINITY;
      }
    }
    __syncwarp();
  }
  for (int p = lane; p < M0; p += 32) row[p] = id[p];
}

template <int METRIC, bool HEURISTIC>
void launch(void* nbrs, const void* vec, const void* pb, const void* g_level,
            const void* g_target, const void* g_start, const void* new_ids,
            int G, int cap, int M0, int M, int W, cudaStream_t stream) {
  const int blocks = (G + kWarps - 1) / kWarps;
  link_back<METRIC, HEURISTIC><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<int32_t*>(nbrs), static_cast<const uint32_t*>(vec),
      static_cast<const int32_t*>(pb), static_cast<const int64_t*>(g_level),
      static_cast<const int64_t*>(g_target),
      static_cast<const int64_t*>(g_start),
      static_cast<const int64_t*>(new_ids), G, cap, M0, M, W);
}

}  // namespace

// nbrs (L+1, cap, M0) int32, updated in place; vec (cap, W) 32-bit words;
// pb (cap,) int32 popcounts; the schedule as int64: g_level, g_target (G,),
// g_start (G + 1,) offsets into new_ids (N,). metric: 0 bitmap_jaccard,
// 1 minhash_jaccard, 2 hamming; heuristic: 0 or 1. Returns
// cudaGetLastError() after the launch (0 = launched), or cudaErrorInvalidValue
// (1) for arguments the kernel does not take.
extern "C" int fold_link_back(void* nbrs, const void* vec, const void* pb,
                              const void* g_level, const void* g_target,
                              const void* g_start, const void* new_ids,
                              int G, int cap, int M0, int M, int W, int metric,
                              int heuristic, void* stream) {
  if (G <= 0 || M0 < 1 || M0 + 1 > kMaxCand || M < 1 || W < 1 ||
      metric < 0 || metric > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = heuristic != 0;
#define FOLD_LINK_BACK(MET)                                                  \
  (h ? launch<MET, true>(nbrs, vec, pb, g_level, g_target, g_start, new_ids, \
                         G, cap, M0, M, W, s)                                \
     : launch<MET, false>(nbrs, vec, pb, g_level, g_target, g_start,         \
                          new_ids, G, cap, M0, M, W, s))
  if (metric == kBitmap)
    FOLD_LINK_BACK(kBitmap);
  else if (metric == kMinhash)
    FOLD_LINK_BACK(kMinhash);
  else
    FOLD_LINK_BACK(kHamming);
#undef FOLD_LINK_BACK
  return static_cast<int>(cudaGetLastError());
}
