// The greedy BPE merge of one word held by one warp, shared by the
// fused merge (fused_merge.cu) and the segmented merge (seg_merge.cu).
//
// Lane i holds the id at alive position i of a word of at most 32 ids.
// Each round every lane with a right neighbour probes the FULL pair
// table in global memory (open addressing, linear probing);
// __reduce_min_sync finds the word's leftmost minimum-rank pair as the
// minimum of rank * 32 + position, __shfl_sync hands each lane its
// neighbours' rank and minsuper bound, and __ballot_sync/__popc compact
// the survivors every round, so no alive list is kept.  The loop ends,
// warp-uniformly, once the word merges nothing.  The result is
// byte-exact with the sequential greedy order
// (hutoken_tpu/oracle.py::encode_word).
//
// Two table layouts (hutoken_tpu_torch/tables.py DeviceTables), one
// type each with a device lookup() and its own rank sentinel: the narrow
// PairTable (16-bit ids and ranks packed in two int32 words a slot) and
// the WidePairTable (one 16-byte slot of four int32 for vocabularies
// past 16 bits).  merge_word is instantiated per type.
//
// What bounds it: the latency of the dependent L2 reads per round (key,
// then value, then minsuper; one read a probe step on the wide table),
// times the number of rounds.  The tables stay in the 50 MB L2 (4 MB of
// key + value for a 29,509-rule vocab, 4-8 MB of wide slots for a
// 100,256-id one).

#pragma once

#include <cstdint>

namespace ht {

constexpr unsigned kFullMask = 0xffffffffu;
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

// The narrow packed table, as raw device pointers.
struct PairTable {
  const int32_t* pkey;  // left << 16 | right, -1 = empty slot
  const int32_t* pval;  // rank << 16 | merged id
  unsigned cap_mask;
  int probe_len;
  const int32_t* minsuper;  // nullptr: one merge per word per round
  int minsuper_len;

  // rank sentinel: real ranks fit 16 bits (checked when the table is built)
  static constexpr int kInfRank = 0x10000;

  __device__ __forceinline__ void lookup(unsigned a, unsigned b, int& rank,
                                         int& merged) const {
    const int key = static_cast<int>((a << 16) | (b & 0xFFFFu));
    unsigned slot = mix_hash(a, b) & cap_mask;
    for (int i = 0; i < probe_len; ++i) {
      const int k = __ldg(pkey + slot);
      if (k == key) {
        const int v = __ldg(pval + slot);
        rank = (v >> 16) & 0xFFFF;
        merged = v & 0xFFFF;
        return;
      }
      // no deletions, so a key is never stored past an empty slot
      if (k == -1) return;
      slot = (slot + 1) & cap_mask;
    }
  }
};

// The wide table: slot s is the int4 (left, right, rank, merged), left
// -1 when empty.  One 16-byte __ldg reads key and value together, and
// both ids compare in full 32 bits.
struct WidePairTable {
  const int4* slots;
  unsigned cap_mask;
  int probe_len;
  const int32_t* minsuper;
  int minsuper_len;

  // ranks stop at 2^26 - 1 (checked when the table is built), so the
  // candidate rank * 32 + lane (lane <= 30) stays below kInfKey; 0x10000
  // is a real rank here
  static constexpr int kInfRank = 0x7fffffff;

  __device__ __forceinline__ void lookup(unsigned a, unsigned b, int& rank,
                                         int& merged) const {
    const int ia = static_cast<int>(a);
    const int ib = static_cast<int>(b);
    unsigned slot = mix_hash(a, b) & cap_mask;
    for (int i = 0; i < probe_len; ++i) {
      const int4 s = __ldg(slots + slot);
      if (s.x == ia && s.y == ib) {
        rank = s.z;
        merged = s.w;
        return;
      }
      if (s.x == -1) return;
      slot = (slot + 1) & cap_mask;
    }
  }
};

// Runs the fixed point of the word whose n ids sit in lanes 0..n-1 (id
// = -1 elsewhere).  Returns the final count n'; lanes 0..n'-1 then hold
// the surviving ids in order, the other lanes -1.  With kCarry, each
// lane's `tag` travels with its id through every compaction (the
// segmented merge carries the byte offset of each token's first byte).
// stage_id and stage_tag are 32 ints of shared memory owned by the warp.
template <bool kCarry, class Table>
__device__ __forceinline__ int merge_word(const Table& t, int lane, int n,
                                          int& id, int& tag,
                                          int32_t* stage_id,
                                          int32_t* stage_tag) {
  constexpr int kInfRank = Table::kInfRank;
  while (n >= 2) {
    // probe pair (lane, lane + 1)
    const int right = __shfl_down_sync(kFullMask, id, 1);
    int rank = kInfRank;
    int merged = -1;
    int msup = 0;
    if (lane + 1 < n) {
      t.lookup(static_cast<unsigned>(id), static_cast<unsigned>(right), rank,
               merged);
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
