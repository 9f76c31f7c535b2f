// The greedy BPE merge of one word held by one warp, shared by the
// fused merge (fused_merge.cu) and the segmented merge (seg_merge.cu).
//
// Lane i holds the id at alive position i of a word of at most 32 ids.
// Each round every lane with a right neighbour probes the FULL packed
// pair table in global memory (open addressing, linear probing);
// __reduce_min_sync finds the word's leftmost minimum-rank pair as the
// minimum of rank * 32 + position, __shfl_sync hands each lane its
// neighbours' rank and minsuper bound, and __ballot_sync/__popc compact
// the survivors every round, so no alive list is kept.  The loop ends,
// warp-uniformly, once the word merges nothing.  The result is
// byte-exact with the sequential greedy order
// (hutoken_tpu/oracle.py::encode_word).
//
// What bounds it: the latency of the dependent L2 reads per round (key,
// then value, then minsuper), times the number of rounds.  The table
// stays in the 50 MB L2 (4 MB of key + value for a 29,509-rule vocab).

#pragma once

#include <cstdint>

namespace ht {

constexpr unsigned kFullMask = 0xffffffffu;
// rank sentinel: real ranks fit 16 bits (checked when the table is built)
constexpr int kInfRank = 0x10000;
constexpr unsigned kInfKey = 0x7fffffffu;

// hutoken_tpu_torch/tables.py DeviceTables, as raw device pointers.
struct PairTable {
  const int32_t* pkey;  // left << 16 | right, -1 = empty slot
  const int32_t* pval;  // rank << 16 | merged id
  unsigned cap_mask;
  int probe_len;
  const int32_t* minsuper;  // nullptr: one merge per word per round
  int minsuper_len;
};

// tables._mix_hash: uint32 multiply-xorshift with LOGICAL shifts.
__device__ __forceinline__ unsigned mix_hash(unsigned a, unsigned b) {
  unsigned h = a * 0x85EBCA6Bu;
  h ^= b * 0xC2B2AE35u;
  h ^= h >> 13;
  h *= 0x27D4EB2Fu;
  h ^= h >> 15;
  return h;
}

// Runs the fixed point of the word whose n ids sit in lanes 0..n-1 (id
// = -1 elsewhere).  Returns the final count n'; lanes 0..n'-1 then hold
// the surviving ids in order, the other lanes -1.  With kCarry, each
// lane's `tag` travels with its id through every compaction (the
// segmented merge carries the byte offset of each token's first byte).
// stage_id and stage_tag are 32 ints of shared memory owned by the warp.
template <bool kCarry>
__device__ __forceinline__ int merge_word(const PairTable& t, int lane, int n,
                                          int& id, int& tag,
                                          int32_t* stage_id,
                                          int32_t* stage_tag) {
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
      unsigned slot = mix_hash(a, b) & t.cap_mask;
      for (int i = 0; i < t.probe_len; ++i) {
        const int k = __ldg(t.pkey + slot);
        if (k == key) {
          const int v = __ldg(t.pval + slot);
          rank = (v >> 16) & 0xFFFF;
          merged = v & 0xFFFF;
          break;
        }
        // no deletions, so a key is never stored past an empty slot
        if (k == -1) break;
        slot = (slot + 1) & t.cap_mask;
      }
      if (t.minsuper != nullptr && rank < t.minsuper_len) {
        msup = __ldg(t.minsuper + rank);
      }
    }

    // leftmost minimum-rank pair: min over rank * 32 + position
    const unsigned cand =
        rank < kInfRank ? static_cast<unsigned>(rank * 32 + lane) : kInfKey;
    const unsigned best = __reduce_min_sync(kFullMask, cand);
    if (best == kInfKey) break;  // warp-uniform: the word is done
    bool applied = lane == static_cast<int>(best & 31u);

    if (t.minsuper != nullptr) {
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
    if (keep) {
      const int dst = __popc(keep_mask & ((1u << lane) - 1u));
      stage_id[dst] = id;
      if constexpr (kCarry) stage_tag[dst] = tag;
    }
    __syncwarp();
    n = __popc(keep_mask);
    id = lane < n ? stage_id[lane] : -1;
    if constexpr (kCarry) tag = lane < n ? stage_tag[lane] : -1;
    __syncwarp();
  }
  return n;
}

}  // namespace ht
