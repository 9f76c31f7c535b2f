// Fused byte-level BPE merge for words of up to 32 bytes, for Hopper (sm_90a).
//
// Replaces hutoken_tpu/ops/pallas_merge.py::_kernel / _kernel_body, and
// computes the same function: byte -> seed id through the 256-entry LUT,
// the greedy merge fixed point (each round applies the word's leftmost
// minimum-rank pair, plus every local minimum that the minsuper bound
// certifies as safe), then the survivors left-compacted with their count.
// The output is byte-exact with the sequential greedy order
// (hutoken_tpu/oracle.py::encode_word).
//
// Design.  One warp per word, lane i holding position i (words are at
// most 32 bytes, the warp width).  Each round every lane with a right
// neighbour probes the FULL packed pair table in global memory (open
// addressing, linear probing); __reduce_min_sync finds the word's
// (rank, position) minimum, __shfl_sync hands each lane its neighbours'
// rank and minsuper bound, and __ballot_sync/__popc compact the
// survivors every round, so no alive list is kept.  Each warp leaves the
// loop on its own once its word merges nothing.
//
// What bounds it.  Not bytes: a round reads a few int32 per lane.  The
// bound is the latency of the dependent L2 reads per round (key, then
// value, then minsuper), times the number of rounds.  The table is
// small enough to stay in the 50 MB L2 (4 MB of key+value for a
// 29,509-rule string-path vocabulary), probing stops at the first empty
// slot, and many resident warps (8 words per 256-thread block, a few
// registers per thread) hide the latency.  The TPU kernel's lane-bucketed
// partial table and its 0x8000 divergence flag existed for the VMEM
// budget; probing the full table makes every word exact, and none is
// flagged.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
// rank sentinel: real ranks fit 16 bits (checked when the table is built)
constexpr int kInfRank = 0x10000;
constexpr unsigned kInfKey = 0x7fffffffu;

// tables._mix_hash: uint32 multiply-xorshift with LOGICAL shifts.
__device__ __forceinline__ unsigned mix_hash(unsigned a, unsigned b) {
  unsigned h = a * 0x85EBCA6Bu;
  h ^= b * 0xC2B2AE35u;
  h ^= h >> 13;
  h *= 0x27D4EB2Fu;
  h ^= h >> 15;
  return h;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_merge_kernel(const int32_t* __restrict__ pkey,
                   const int32_t* __restrict__ pval, unsigned cap_mask,
                   int probe_len, const int32_t* __restrict__ byte_seed,
                   const int32_t* __restrict__ minsuper, int minsuper_len,
                   const uint8_t* __restrict__ raw,
                   const int32_t* __restrict__ lens, int64_t num_words,
                   int width, int32_t* __restrict__ out,
                   int32_t* __restrict__ counts) {
  __shared__ int32_t stage[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (w >= num_words) return;  // the whole warp leaves together

  int n = min(max(lens[w], 0), width);  // warp-uniform alive count
  int id = lane < n ? __ldg(byte_seed + raw[w * width + lane]) : -1;

  while (n >= 2) {
    // probe pair (lane, lane + 1)
    const int right = __shfl_down_sync(kFullMask, id, 1);
    int rank = kInfRank;
    int merged = -1;
    int msup = 0;
    if (lane + 1 < n) {
      const unsigned a = static_cast<unsigned>(id);
      const unsigned b = static_cast<unsigned>(right);
      const int key = static_cast<int>((a << 16) | (b & 0xFFFFu));
      unsigned slot = mix_hash(a, b) & cap_mask;
      for (int i = 0; i < probe_len; ++i) {
        const int k = __ldg(pkey + slot);
        if (k == key) {
          const int v = __ldg(pval + slot);
          rank = (v >> 16) & 0xFFFF;
          merged = v & 0xFFFF;
          break;
        }
        // no deletions, so a key is never stored past an empty slot
        if (k == -1) break;
        slot = (slot + 1) & cap_mask;
      }
      if (minsuper != nullptr && rank < minsuper_len) {
        msup = __ldg(minsuper + rank);
      }
    }

    // leftmost minimum-rank pair: min over rank * 32 + position
    const unsigned cand =
        rank < kInfRank ? static_cast<unsigned>(rank * 32 + lane) : kInfKey;
    const unsigned best = __reduce_min_sync(kFullMask, cand);
    if (best == kInfKey) break;  // warp-uniform: the word is done
    bool applied = lane == static_cast<int>(best & 31u);

    if (minsuper != nullptr) {
      // certified local minima (pallas_merge.py module docstring): each
      // neighbour pair must be absent, or finite, of higher rank, and
      // with minsuper above this rank; an INF neighbour blocks the pair
      const int rprev = __shfl_up_sync(kFullMask, rank, 1);
      const int msl = __shfl_up_sync(kFullMask, msup, 1);
      const int rnext = __shfl_down_sync(kFullMask, rank, 1);
      const int msr = __shfl_down_sync(kFullMask, msup, 1);
      const bool safe_l =
          lane == 0 || (rprev < kInfRank && rprev > rank && msl > rank);
      const bool safe_r = lane + 2 >= n ||
                          (rnext < kInfRank && rnext > rank && msr > rank);
      applied = applied || (rank < kInfRank && safe_l && safe_r);
    }

    // applied pairs are pairwise non-adjacent: the left element takes the
    // merged id, the right one is consumed
    const int applied_left = __shfl_up_sync(kFullMask, applied ? 1 : 0, 1);
    const bool keep = lane < n && !(lane > 0 && applied_left);
    if (applied) id = merged;
    const unsigned keep_mask = __ballot_sync(kFullMask, keep);
    if (keep) stage[warp][__popc(keep_mask & ((1u << lane) - 1u))] = id;
    __syncwarp();
    n = __popc(keep_mask);
    id = lane < n ? stage[warp][lane] : -1;
    __syncwarp();
  }

  if (lane < width) out[w * width + lane] = lane < n ? id : -1;
  if (lane == 0) counts[w] = n;
}

}  // namespace

extern "C" int ht_fused_merge(const int32_t* pkey, const int32_t* pval,
                              int64_t cap_mask, int32_t probe_len,
                              const int32_t* byte_seed,
                              const int32_t* minsuper, int32_t minsuper_len,
                              const uint8_t* raw, const int32_t* lens,
                              int64_t num_words, int32_t width, int32_t* out,
                              int32_t* counts, void* stream) {
  const int64_t blocks = (num_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_merge_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pkey, pval, static_cast<unsigned>(cap_mask), probe_len, byte_seed,
      minsuper, minsuper_len, raw, lens, num_words, width, out, counts);
  return static_cast<int>(cudaGetLastError());
}
