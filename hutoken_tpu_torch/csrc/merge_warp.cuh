// The greedy BPE merge of one word held by one tile of G lanes (G = 8,
// 16 or 32 lanes of a warp), shared by the fused merge (fused_merge.cu)
// and the segmented merge (seg_merge.cu).
//
// Lane i of the tile holds the id at alive position i of a word of at
// most G ids.  Each round every lane with a right neighbour probes the
// FULL pair table in global memory (open addressing, linear probing);
// __reduce_min_sync over the tile finds the word's leftmost
// minimum-rank pair as the minimum of rank * 32 + position, __shfl_sync
// hands each lane its neighbours' rank and minsuper bound, and the
// survivors are compacted every round through the warp's 32 ints of
// shared memory, so no alive list is kept.  The loop ends,
// tile-uniformly, once the word merges nothing.  The result is
// byte-exact with the sequential greedy order
// (hutoken_tpu/oracle.py::encode_word).
//
// Tiles of one warp leave the loop in different rounds, so every
// collective names the tile's own lanes (tile_mask) and never the whole
// warp, and a ballot is shifted down to the tile and cut to G bits
// before it is counted.
//
// Two table layouts (hutoken_tpu_torch/tables.py DeviceTables), one type
// each with a device lookup() and its own rank sentinel: the narrow
// PairTable (16-bit ids and ranks, slots {key, value, minsuper, 0}) and
// the WidePairTable (slots {left, right, rank, merged} for vocabularies
// past 16 bits).  Either way one probe step is one 16-byte load.
//
// What bounds it: the latency of the dependent L2 probe loads per round,
// times the number of rounds.  The tables stay in the 50 MB L2 (8 MB of
// interleaved slots for a 29,509-rule vocab, 4-8 MB of wide slots for a
// 100,256-id one).  The design answers with one load per probe step
// (the narrow table's key, value and minsuper bound share a slot) and
// sub-warp tiles (a word of 8 bytes keeps 8 lanes busy, not 8 of 32).
// A compaction in registers (lane d pulling the (d+1)-th set bit of the
// keep mask, found by __fns, with __shfl_sync) was timed against the
// shared-memory one on the H100 and ran 3-8 % slower, so the loop
// stages its survivors.

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

// The narrow packed table: slot s is the int4 (key, value, minsuper,
// 0), key = left << 16 | right (-1 = empty), value = rank << 16 |
// merged, minsuper = the multi-merge bound of the slot's rank.
struct PairTable {
  const int4* slots;
  unsigned cap_mask;
  int probe_len;
  bool has_minsuper;  // false: one merge per word per round

  // rank sentinel: real ranks fit 16 bits (checked when the table is built)
  static constexpr int kInfRank = 0x10000;

  __device__ __forceinline__ bool multi() const { return has_minsuper; }

  __device__ __forceinline__ void lookup(unsigned a, unsigned b, int& rank,
                                         int& merged, int& msup) const {
    const int key = static_cast<int>((a << 16) | (b & 0xFFFFu));
    unsigned slot = mix_hash(a, b) & cap_mask;
    for (int i = 0; i < probe_len; ++i) {
      const int4 s = __ldg(slots + slot);
      if (s.x == key) {
        rank = (s.y >> 16) & 0xFFFF;
        merged = s.y & 0xFFFF;
        msup = s.z;
        return;
      }
      // no deletions, so a key is never stored past an empty slot
      if (s.x == -1) return;
      slot = (slot + 1) & cap_mask;
    }
  }
};

// The wide table: slot s is the int4 (left, right, rank, merged), left
// -1 when empty; both ids compare in full 32 bits.  Its minsuper bound
// (present only while ranks fit 16 bits) is a separate array.
struct WidePairTable {
  const int4* slots;
  unsigned cap_mask;
  int probe_len;
  const int32_t* minsuper;  // nullptr: one merge per word per round
  int minsuper_len;

  // ranks stop at 2^26 - 1 (checked when the table is built), so the
  // candidate rank * 32 + position (position <= 30) stays below kInfKey;
  // 0x10000 is a real rank here
  static constexpr int kInfRank = 0x7fffffff;

  __device__ __forceinline__ bool multi() const { return minsuper != nullptr; }

  __device__ __forceinline__ void lookup(unsigned a, unsigned b, int& rank,
                                         int& merged, int& msup) const {
    const int ia = static_cast<int>(a);
    const int ib = static_cast<int>(b);
    unsigned slot = mix_hash(a, b) & cap_mask;
    for (int i = 0; i < probe_len; ++i) {
      const int4 s = __ldg(slots + slot);
      if (s.x == ia && s.y == ib) {
        rank = s.z;
        merged = s.w;
        if (minsuper != nullptr && rank < minsuper_len) {
          msup = __ldg(minsuper + rank);
        }
        return;
      }
      if (s.x == -1) return;
      slot = (slot + 1) & cap_mask;
    }
  }
};

// One tile: G lanes starting at warp lane `base`, G a power of two.
template <int G>
struct Tile {
  static_assert(G == 8 || G == 16 || G == 32, "tiles are 8, 16 or 32 lanes");
  static constexpr unsigned kBits = G == 32 ? kFullMask : (1u << G) - 1u;
  unsigned mask;  // the tile's lanes within the warp
  int base;       // its first warp lane
  int lane;       // this thread's position in the tile

  __device__ __forceinline__ explicit Tile(int warp_lane)
      : mask(kBits << (warp_lane & ~(G - 1))),
        base(warp_lane & ~(G - 1)),
        lane(warp_lane & (G - 1)) {}

  // the tile's bits of a warp-wide ballot, at bit positions 0..G-1
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) >> base) & kBits;
  }
};

// Runs the fixed point of the word whose n ids sit in tile lanes
// 0..n-1 (id = -1 elsewhere).  Returns the final count n'; lanes
// 0..n'-1 then hold the surviving ids in order, the other lanes -1.
// With kCarry, each lane's `tag` travels with its id through every
// compaction (the segmented merge carries the byte offset of each
// token's first byte).  `stage` is the warp's 32 ints of shared memory
// (64 with kCarry); the tile uses its own lanes' entries, with two
// __syncwarp(tile mask) a round.
template <int G, bool kCarry, class Table>
__device__ __forceinline__ int merge_word(const Table& t, const Tile<G>& tile,
                                          int n, int& id, int& tag,
                                          int32_t* stage) {
  constexpr int kInfRank = Table::kInfRank;
  const unsigned m = tile.mask;
  const int lane = tile.lane;
  while (n >= 2) {
    // probe pair (lane, lane + 1)
    const int right = __shfl_down_sync(m, id, 1, G);
    int rank = kInfRank;
    int merged = -1;
    int msup = 0;
    if (lane + 1 < n) {
      t.lookup(static_cast<unsigned>(id), static_cast<unsigned>(right), rank,
               merged, msup);
    }

    // leftmost minimum-rank pair: min over rank * 32 + position
    const unsigned cand =
        rank < kInfRank ? static_cast<unsigned>(rank * 32 + lane) : kInfKey;
    const unsigned best = __reduce_min_sync(m, cand);
    if (best == kInfKey) break;  // tile-uniform: the word is done
    bool applied = lane == static_cast<int>(best & 31u);

    if (t.multi()) {
      // certified local minima (pallas_merge.py module docstring): each
      // neighbour pair must be absent, or finite, of higher rank, and
      // with minsuper above this rank; an INF neighbour blocks the pair
      const int rprev = __shfl_up_sync(m, rank, 1, G);
      const int msl = __shfl_up_sync(m, msup, 1, G);
      const int rnext = __shfl_down_sync(m, rank, 1, G);
      const int msr = __shfl_down_sync(m, msup, 1, G);
      const bool safe_l =
          lane == 0 || (rprev < kInfRank && rprev > rank && msl > rank);
      const bool safe_r = lane + 2 >= n ||
                          (rnext < kInfRank && rnext > rank && msr > rank);
      applied = applied || (rank < kInfRank && safe_l && safe_r);
    }

    // applied pairs are pairwise non-adjacent: the left element takes the
    // merged id, the right one is consumed
    const int applied_left = __shfl_up_sync(m, applied ? 1 : 0, 1, G);
    const bool keep = lane < n && !(lane > 0 && applied_left);
    if (applied) id = merged;
    const unsigned keep_bits = tile.ballot(keep);
    n = __popc(keep_bits);
    if (keep) {
      const int dst = tile.base + __popc(keep_bits & ((1u << lane) - 1u));
      stage[dst] = id;
      if constexpr (kCarry) stage[32 + dst] = tag;
    }
    __syncwarp(m);
    id = lane < n ? stage[tile.base + lane] : -1;
    if constexpr (kCarry) tag = lane < n ? stage[32 + tile.base + lane] : -1;
    __syncwarp(m);
  }
  return n;
}

}  // namespace ht
