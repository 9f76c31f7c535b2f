// Greedy BPE merge of id rows and of words of up to 128 bytes, in the
// packed or the padded output layout, for Hopper (sm_90a).
//
// Replaces the XLA program of hutoken_tpu/ops/merge.py::_merge_fixed_point
// (a lax.while_loop with the round test on the device) together with what
// surrounds it: _merge_ids_packed / _merge_bytes_packed (the seeding of
// byte words through the 256-entry LUT, then _compact_output's packing)
// and merge_words (the padded [W, L] rows).  There is no Pallas kernel
// behind it; the JAX package runs it for char-mode vocabularies, for
// byte words of 33-128 bytes and for the sharded merge.  It computes the
// same function: every round each word applies its leftmost
// minimum-rank pair, one merge a word a round (no minsuper bound: the
// byte-mode bound covers only pairs that form inside 32 bytes, and
// char-mode tables have none), until no pair has a rule.  A PAD (-1)
// anywhere in a row pairs with nothing and keeps its place; the packed
// output drops it, the padded one keeps it.
//
// What bounds it.  Not bytes: a 1,024 x 128 byte block is 132 KB in and
// at most 0.5 MB out.  One merge a word a round makes each round depend
// on the one before, so a block costs the rounds of its longest word (71-81
// on 1,024 x 128 compound blocks, 11 on a 16,384 x 32 char block) times
// what a round costs.  On the long blocks (under 8 warps an SM) that is a
// round's latency, most of it the probe of the pair table, which stays in
// the 50 MB L2 (4-8 MB of slots); on 16,384-row blocks the warps fill the
// SMs and a round's instructions count as much.
//
// Design.  Every word keeps each pair's (rank, merged) in registers across
// rounds, as _merge_fixed_point keeps its ranks array, so a round probes
// only the two pairs its merge touched.  A row of up to 32 ids takes a
// tile of 8 lanes, K = 1, 2 or 4 ids a lane (four rows a warp); a row of
// 33-128 ids a whole warp, K = 2 or 4 (merge_tile, one loop for both).  A
// round:
//   1. the shift's operands (each lane's right neighbour's id, rank and
//      merged) are shuffled before the minimum: they do not depend on
//      the winning position p;
//   2. the tile's minimum of rank * positions + position, by redux.sync
//      on a warp and by a butterfly of shuffles on an 8-lane tile, so p
//      comes out of the reduction; wide ranks reach 2^26 - 1, so over 64
//      or 128 positions the warp reduces a wide rank alone and finds the
//      leftmost lane attaining it by ballot;
//   3. p's merged id m and the ids at p - 1 and p + 2, which the two new
//      pairs take, shuffled from the winning lane, which picked them
//      ahead by unrolled selects (never a run-time register index);
//   4. every lane of the tile issues the probe of both new pairs,
//      (id[p-1], m) and (m, id[p+2]): on the narrow table both chains
//      advance together from one broadcast load each; on the wide table,
//      whose chains run longer, lanes load every slot of both chains at
//      once and a ballot finds their ends;
//   5. while those loads are in flight, position p takes m and every
//      later position its right neighbour's id and pair, in registers
//      (no staging in shared memory); then the lanes holding p - 1 and p
//      keep the probe's results.
// A pair with a PAD side, or past the row's end, is never probed (a (PAD,
// PAD) narrow key is -1, the empty slot's key).  Every collective is
// warp-wide, shuffles segmented by the tile's width: under a mask of
// fewer than 32 lanes the compiler sends each shuffle and redux.sync down
// its divergent path (WARPSYNC.COLLECTIVE) whenever the warp's tiles run
// together, as they do.  So the loop runs until the warp's last word is
// done, a done tile merging nothing.  Each row then counts its surviving
// ids, and a block of 8 warps scans its rows' counts and finds its row
// base by the decoupled look-back of merge_warp.cuh; the padded layout
// writes every position in place and skips the scan.
//
// Measured on the H100 and not kept: a 32-lane tile for every row of up
// to 32 ids (four times the warps); the lane-parallel probe on the narrow
// table (a ballot and four shuffles a round for chains that end at their
// first slot); loading 2 or 4 slots of each chain a step; picking the
// next merge among the other pairs while the probe is in flight, whose
// extra shuffles and selects cost more than the latency they hid; and
// shuffling the next round's neighbour ids under the probe (level).
//
// Why one merge a word a round stays.  Applying also every pair that the
// fused kernel's minsuper bound certifies (ops/fused_merge.py) would not
// cut the rounds of these blocks: on 1,024 compounds of 33-128 bytes the
// longest word takes 75 rounds either way on big-merges (mean 37.85 ->
// 37.58) and 110 -> 109 on big-vocab (mean 65.5 -> 65.2), and a bound for
// 33-128-byte words would need a build that grows as n^4 in the word
// length.  So the kernel keeps the function of _merge_fixed_point and
// changes only what a round costs.

#include <cstdint>

#include <cuda_runtime.h>

#include "merge_warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// One probe step: slot s against the pair (a, b).  True when the chain
// ends, at a hit, which sets (rank, merged), or at an empty slot.
__device__ __forceinline__ bool probe_step(const ht::PairTable&, const int4& s, unsigned a,
                                           unsigned b, int& rank, int& merged) {
  if (s.x == static_cast<int>((a << 16) | (b & 0xFFFFu))) {
    rank = (s.y >> 16) & 0xFFFF;
    merged = s.y & 0xFFFF;
    return true;
  }
  return s.x == -1;  // no deletions: a key is never stored past an empty slot
}

__device__ __forceinline__ bool probe_step(const ht::WidePairTable&, const int4& s, unsigned a,
                                           unsigned b, int& rank, int& merged) {
  if (s.x == static_cast<int>(a) && s.y == static_cast<int>(b)) {
    rank = s.z;
    merged = s.w;
    return true;
  }
  return s.x == -1;
}

// The (rank, merged) of two pairs, (a0, b0) when go0 and (a1, b1) when
// go1, else (kInfRank, -1), looked up alike by every lane of a tile: the
// lanes read the same addresses, so each load is one broadcast
// transaction.  A probe is split in two, so that a round can shift its
// word while the first loads are in flight: *_start issues them,
// *_finish waits for them.
//
// Chain: both chains advance together, a slot each a step, each step's
// two loads issued before either slot is tested; a chain goes on past a
// slot only when the slot neither matches nor is empty.
struct ChainStart {
  unsigned s0, s1;
  int4 v0, v1;
};

template <class Table>
__device__ __forceinline__ ChainStart chain_start(const Table& t, bool go0, unsigned a0,
                                                        unsigned b0, bool go1, unsigned a1,
                                                        unsigned b1) {
  ChainStart c;
  c.s0 = ht::mix_hash(a0, b0) & t.cap_mask;
  c.s1 = ht::mix_hash(a1, b1) & t.cap_mask;
  c.v0 = go0 ? __ldg(t.slots + c.s0) : make_int4(-1, 0, 0, 0);
  c.v1 = go1 ? __ldg(t.slots + c.s1) : make_int4(-1, 0, 0, 0);
  return c;
}

template <class Table>
__device__ __forceinline__ void chain_finish(const Table& t, ChainStart c, bool go0,
                                             unsigned a0, unsigned b0, bool go1, unsigned a1,
                                             unsigned b1, int& r0, int& m0, int& r1, int& m1) {
  r0 = r1 = Table::kInfRank;
  m0 = m1 = -1;
  for (int i = 1;; ++i) {
    if (go0) go0 = !probe_step(t, c.v0, a0, b0, r0, m0);
    if (go1) go1 = !probe_step(t, c.v1, a1, b1, r1, m1);
    if (!(go0 || go1) || i >= t.probe_len) return;
    c.s0 = (c.s0 + 1) & t.cap_mask;
    c.s1 = (c.s1 + 1) & t.cap_mask;
    c.v0 = go0 ? __ldg(t.slots + c.s0) : make_int4(-1, 0, 0, 0);
    c.v1 = go1 ? __ldg(t.slots + c.s1) : make_int4(-1, 0, 0, 0);
  }
}

template <class Table>
__device__ __forceinline__ void probe_two(const Table& t, bool go0, unsigned a0, unsigned b0,
                                          bool go1, unsigned a1, unsigned b1, int& r0,
                                          int& m0, int& r1, int& m1) {
  chain_finish(t, chain_start(t, go0, a0, b0, go1, a1, b1), go0, a0, b0, go1, a1, b1, r0, m0,
               r1, m1);
}

// Lanes: every slot of both chains at once.  Lane i < probe_len of the
// tile loads slot i of the first chain, lane probe_len + i slot i of the
// second, and a ballot finds each chain's end: one round trip however
// long the chains.  Called by all 32 lanes together, when 2 * probe_len
// <= G.
template <int G, class Table>
__device__ __forceinline__ int4 lanes_start(const Table& t, const ht::Tile<G>& tile, bool go0,
                                            unsigned a0, unsigned b0, bool go1, unsigned a1,
                                            unsigned b1) {
  const int pl = t.probe_len;
  const int lane = tile.lane;
  const bool second = lane >= pl;
  const bool go = lane < 2 * pl && (second ? go1 : go0);
  const unsigned step = static_cast<unsigned>(second ? lane - pl : lane);
  return go ? __ldg(t.slots + ((ht::mix_hash(second ? a1 : a0, second ? b1 : b0) + step) & t.cap_mask))
            : make_int4(-1, 0, 0, 0);
}

template <int G, class Table>
__device__ __forceinline__ void lanes_finish(const Table& t, const ht::Tile<G>& tile, int4 v,
                                             bool go0, unsigned a0, unsigned b0, bool go1,
                                             unsigned a1, unsigned b1, int& r0, int& m0, int& r1,
                                             int& m1) {
  const int pl = t.probe_len;
  const int lane = tile.lane;
  const bool second = lane >= pl;
  const bool go = lane < 2 * pl && (second ? go1 : go0);
  int r = Table::kInfRank;
  int m = -1;
  const bool end = go && probe_step(t, v, second ? a1 : a0, second ? b1 : b0, r, m);
  const unsigned ends = (__ballot_sync(ht::kFullMask, end) >> tile.base) & ((1u << pl << pl) - 1u);
  const unsigned lo = (1u << pl) - 1u;
  const int e0 = __ffs(ends & lo) - 1;  // -1: no end within probe_len slots
  const int e1 = __ffs(ends >> pl) - 1;
  const int q0 = __shfl_sync(ht::kFullMask, r, e0 < 0 ? 0 : e0, G);
  const int n0 = __shfl_sync(ht::kFullMask, m, e0 < 0 ? 0 : e0, G);
  const int q1 = __shfl_sync(ht::kFullMask, r, e1 < 0 ? 0 : pl + e1, G);
  const int n1 = __shfl_sync(ht::kFullMask, m, e1 < 0 ? 0 : pl + e1, G);
  const bool hit0 = go0 && e0 >= 0;
  const bool hit1 = go1 && e1 >= 0;
  r0 = hit0 ? q0 : Table::kInfRank;
  m0 = hit0 ? n0 : -1;
  r1 = hit1 ? q1 : Table::kInfRank;
  m1 = hit1 ? n1 : -1;
}

// Which of the two probes a round takes.  The narrow table is sparse (8
// MB of slots for about 30,000 rules), so its chains nearly always end at
// their first slot and the chain probe costs one round trip with fewer
// instructions.  The wide table's chains run longer, and a further slot
// often lies in another 32-byte sector, another L2 round trip: it takes
// the lane-parallel probe.
template <class Table>
struct LanesProbe {
  static constexpr bool value = false;
};
template <>
struct LanesProbe<ht::WidePairTable> {
  static constexpr bool value = true;
};

// The minimum of v over each tile of G lanes, on every lane of the warp:
// redux.sync for a whole warp, else a butterfly of G-wide shuffles.
// redux.sync and shuffles under a mask of fewer than 32 lanes would take
// the compiler's divergent path (WARPSYNC.COLLECTIVE) whenever the
// warp's tiles run together, which they do here.
template <int G>
__device__ __forceinline__ unsigned tile_min(unsigned v) {
  if constexpr (G == 32) {
    return __reduce_min_sync(ht::kFullMask, v);
  } else {
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(ht::kFullMask, v, d, G));
    return v;
  }
}

// The fixed point of one word of at most G * K ids on each tile of G
// lanes of the warp, K ids a lane: lane l of a tile holds positions
// K*l .. K*l+K-1, -1 past the word (a -1 inside it is a PAD, which pairs
// with nothing and moves with the shift).  Called by all 32 lanes
// together; the loop runs until every tile's word is done, a tile whose
// word is done merging nothing, so every collective is warp-wide.
template <int G, int K, class Table>
__device__ __forceinline__ void merge_tile(const Table& t, const ht::Tile<G>& tile,
                                           int (&id)[K]) {
  static_assert(K == 1 || K == 2 || K == 4, "a lane holds 1, 2 or 4 ids");
  constexpr int kInf = Table::kInfRank;
  constexpr int kSpan = G * K;  // the word's positions
  constexpr unsigned kNone = 0xffffffffu;
  constexpr unsigned mask = ht::kFullMask;
  // rank * kSpan + position fits 32 bits for narrow ranks (at most 2^16),
  // and for wide ones (below 2^26) over at most 32 positions
  constexpr bool kPacked = kInf <= 0x10000 || kSpan <= 32;
  static_assert(kPacked || G == 32, "a rank reduced alone needs the tile to be the warp");
  const int lane = tile.lane;
  const bool has_next = lane + 1 < G;
  // the id two positions past a lane's last: the next lane's second id,
  // or at K = 1 the id two lanes down
  const bool has_next2 = K > 1 ? has_next : lane + 2 < G;
  int rank[K];
  int merged[K];

  // (rank, merged) of the pair (slot j, its right neighbour), two at a time
  {
    const int next0 = __shfl_down_sync(mask, id[0], 1, G);
    int right[K];
#pragma unroll
    for (int j = 0; j < K; ++j) right[j] = j + 1 < K ? id[j + 1 < K ? j + 1 : j] : (has_next ? next0 : -1);
    if constexpr (K == 1) {
      rank[0] = kInf;
      merged[0] = -1;
      int msup = 0;
      if (id[0] >= 0 && right[0] >= 0) {
        t.lookup(static_cast<unsigned>(id[0]), static_cast<unsigned>(right[0]), rank[0],
                 merged[0], msup);
      }
    } else {
#pragma unroll
      for (int j = 0; j + 1 < K; j += 2) {
        probe_two(t, id[j] >= 0 && right[j] >= 0, static_cast<unsigned>(id[j]),
                  static_cast<unsigned>(right[j]), id[j + 1] >= 0 && right[j + 1] >= 0,
                  static_cast<unsigned>(id[j + 1]), static_cast<unsigned>(right[j + 1]), rank[j],
                  merged[j], rank[j + 1], merged[j + 1]);
      }
    }
  }

  while (true) {
    // independent of p: the shift's operands and the outer neighbours
    const int id_n0 = __shfl_down_sync(mask, id[0], 1, G);
    const int id_n2 = __shfl_down_sync(mask, id[K > 1 ? 1 : 0], K > 1 ? 1 : 2, G);
    const int rank_n = __shfl_down_sync(mask, rank[0], 1, G);
    const int merged_n = __shfl_down_sync(mask, merged[0], 1, G);
    const int id_p = __shfl_up_sync(mask, id[K - 1], 1, G);

    // the lane's leftmost minimum (slot lj), and the ids at lj - 1 and
    // lj + 2 that its merge would pair with, by unrolled selects
    int lr = rank[0];
    int lm = merged[0];
    int lj = 0;
    int a = lane > 0 ? id_p : -1;
    int b = K > 2 ? id[K > 2 ? 2 : 0] : K == 2 ? (has_next ? id_n0 : -1) : (has_next2 ? id_n2 : -1);
#pragma unroll
    for (int j = 1; j < K; ++j) {
      if (rank[j] < lr) {
        lr = rank[j];
        lm = merged[j];
        lj = j;
        a = id[j - 1];
        b = j + 2 < K ? id[j + 2 < K ? j + 2 : 0]
                      : j + 2 == K ? (has_next ? id_n0 : -1) : (has_next2 ? id_n2 : -1);
      }
    }

    // the word's leftmost minimum-rank pair, at position p of lane src;
    // p = kSpan + 1 (no position, nor the one before it) once the tile's
    // word is done
    const int pos0 = lane * K + lj;
    int p, src;
    if constexpr (kPacked) {
      const unsigned best = tile_min<G>(
          lr < kInf ? static_cast<unsigned>(lr) * kSpan + static_cast<unsigned>(pos0) : kNone);
      if (__all_sync(mask, best == kNone)) break;  // warp-uniform: every word done
      p = best == kNone ? kSpan + 1 : static_cast<int>(best % kSpan);
      src = p / K;
    } else {
      const unsigned best = __reduce_min_sync(mask, lr < kInf ? static_cast<unsigned>(lr) : kNone);
      if (best == kNone) break;  // warp-uniform: the word is done
      src = __ffs(__ballot_sync(mask, static_cast<unsigned>(lr) == best)) - 1;
      p = __shfl_sync(mask, pos0, src, G);
    }
    const int m = __shfl_sync(mask, lm, src, G);
    const int left = __shfl_sync(mask, a, src, G);
    const int right = __shfl_sync(mask, b, src, G);

    // the two pairs the merge touched: (p - 1, p) and (p, p + 1); their
    // first loads go out before the shift, which runs while they are in
    // flight
    int rl, ml, rr, mr;
    const bool live = p < kSpan;  // tile-uniform: the word merged
    const bool go0 = live && left >= 0;
    const bool go1 = live && right >= 0;
    const bool lanes = LanesProbe<Table>::value && 2 * t.probe_len <= G;  // launch-uniform
    ChainStart cs{};
    int4 lv = make_int4(-1, 0, 0, 0);
    if (lanes) {
      lv = lanes_start(t, tile, go0, static_cast<unsigned>(left), static_cast<unsigned>(m), go1,
                       static_cast<unsigned>(m), static_cast<unsigned>(right));
    } else {
      cs = chain_start(t, go0, static_cast<unsigned>(left), static_cast<unsigned>(m), go1,
                       static_cast<unsigned>(m), static_cast<unsigned>(right));
    }

    // apply: position p takes m, every later position its right
    // neighbour's id and pair; the last position becomes PAD
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int pos = lane * K + j;
      if (pos > p) {
        if (j + 1 < K) {
          const int k = j + 1 < K ? j + 1 : j;
          id[j] = id[k];
          rank[j] = rank[k];
          merged[j] = merged[k];
        } else {
          id[j] = has_next ? id_n0 : -1;
          rank[j] = has_next ? rank_n : kInf;
          merged[j] = has_next ? merged_n : -1;
        }
      } else if (pos == p) {
        id[j] = m;
      }
    }

    if (lanes) {
      lanes_finish(t, tile, lv, go0, static_cast<unsigned>(left), static_cast<unsigned>(m), go1,
                   static_cast<unsigned>(m), static_cast<unsigned>(right), rl, ml, rr, mr);
    } else {
      chain_finish(t, cs, go0, static_cast<unsigned>(left), static_cast<unsigned>(m), go1,
                   static_cast<unsigned>(m), static_cast<unsigned>(right), rl, ml, rr, mr);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int pos = lane * K + j;
      if (pos == p - 1) {
        rank[j] = rl;
        merged[j] = ml;
      } else if (pos == p) {
        rank[j] = rr;
        merged[j] = mr;
      }
    }
  }
}

// One word a tile of G lanes, K ids a lane.
// Input: int32 ids [W, width] (PAD = -1), or, when raw is not null,
// uint8 bytes [W, width] and lens [W] seeded through byte_seed.
template <int G, int K, class Table, typename OutT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
id_merge_kernel(Table table, const int32_t* __restrict__ ids,
                const int32_t* __restrict__ byte_seed,
                const uint8_t* __restrict__ raw,
                const int32_t* __restrict__ lens, int64_t num_words, int width,
                int padded, OutT* __restrict__ out,
                unsigned long long* __restrict__ scan) {
  constexpr int kWords = kWarpsPerBlock * (32 / G);  // words per block
  __shared__ int s_block;
  __shared__ int s_excl[kWords];
  __shared__ long long s_base;

  if (threadIdx.x == 0) s_block = static_cast<int>(atomicAdd(scan, 1ull));
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const ht::Tile<G> tile(wl);
  const int slot = threadIdx.x / G;  // the word's index in the block
  const int64_t w = static_cast<int64_t>(s_block) * kWords + slot;
  const bool live = w < num_words;  // tile-uniform

  int id[K];
#pragma unroll
  for (int j = 0; j < K; ++j) id[j] = -1;
  if (live) {
    const int n = raw != nullptr ? min(max(lens[w], 0), width) : width;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int pos = tile.lane * K + j;
      if (pos < n) {
        id[j] = raw != nullptr ? __ldg(byte_seed + raw[w * width + pos])
                               : __ldg(ids + w * width + pos);
      }
    }
  }
  merge_tile<G, K>(table, tile, id);  // a tile past the last word merges nothing

  // the row's surviving ids: count, and this lane's offset among them
  int c = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) c += id[j] >= 0 ? 1 : 0;
  int incl = c;
  for (int d = 1; d < G; d <<= 1) {
    const int v = __shfl_up_sync(ht::kFullMask, incl, d, G);
    if (tile.lane >= d) incl += v;
  }
  const int total = __shfl_sync(ht::kFullMask, incl, G - 1, G);
  if (tile.lane == 0) s_excl[slot] = total;
  __syncthreads();

  if (padded) {  // launch-uniform
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int pos = tile.lane * K + j;
        if (pos < width) out[w * width + pos] = static_cast<OutT>(id[j]);
      }
    }
    return;
  }
  if (warp == 0) {
    const long long base = ht::scan_block_counts<kWords>(s_excl, scan + 1, s_block, wl);
    if (wl == 0) s_base = base;
  }
  __syncthreads();
  if (!live) return;
  if (tile.lane == 0) out[w] = static_cast<OutT>(total);
  int64_t dst = num_words + s_base + s_excl[slot] + (incl - c);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (id[j] >= 0) out[dst++] = static_cast<OutT>(id[j]);
  }
}

template <int G, int K, class Table, typename OutT>
void launch_shape(const Table& table, const int32_t* ids, const int32_t* byte_seed,
                  const uint8_t* raw, const int32_t* lens, int64_t num_words,
                  int32_t width, int32_t padded, OutT* out,
                  unsigned long long* scan, cudaStream_t stream) {
  constexpr int kWords = kWarpsPerBlock * (32 / G);
  const int64_t blocks = (num_words + kWords - 1) / kWords;
  id_merge_kernel<G, K><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                          stream>>>(table, ids, byte_seed, raw, lens, num_words,
                                    width, padded, out, scan);
}

template <class Table, typename OutT>
int launch_typed(const Table& table, const int32_t* ids, const int32_t* byte_seed,
                 const uint8_t* raw, const int32_t* lens, int64_t num_words,
                 int32_t width, int32_t padded, OutT* out, int64_t* scan,
                 void* stream) {
  auto* sc = reinterpret_cast<unsigned long long*>(scan);
  auto st = static_cast<cudaStream_t>(stream);
  if (width <= 8) {
    launch_shape<8, 1>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
  } else if (width <= 16) {
    launch_shape<8, 2>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
  } else if (width <= 32) {
    launch_shape<8, 4>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
  } else if (width <= 64) {
    launch_shape<32, 2>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
  } else if (width <= 128) {
    launch_shape<32, 4>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Table>
int launch(const Table& table, const int32_t* ids, const int32_t* byte_seed,
           const uint8_t* raw, const int32_t* lens, int64_t num_words,
           int32_t width, int32_t u16_out, int32_t padded, void* out,
           int64_t* scan, void* stream) {
  if (u16_out) {
    return launch_typed(table, ids, byte_seed, raw, lens, num_words, width,
                        padded, static_cast<int16_t*>(out), scan, stream);
  }
  return launch_typed(table, ids, byte_seed, raw, lens, num_words, width,
                      padded, static_cast<int32_t*>(out), scan, stream);
}

}  // namespace

// ids: int32 [W, width] (raw null), or raw: uint8 [W, width] with lens
// int32 [W] and byte_seed int32 [256]; width <= 128.  out: W + W * width
// entries of int16 (u16_out) or int32 in the packed layout, or int32
// [W, width] when padded; scan: int64 [1 + blocks], zeroed (blocks =
// ceil(W / words a block): 32 for width <= 32, else 8).
// pslots: int32 [C, 4] (key, value, minsuper, 0), 16-byte aligned.
extern "C" int ht_id_merge(const int32_t* pslots, int64_t cap_mask,
                           int32_t probe_len, const int32_t* ids,
                           const int32_t* byte_seed, const uint8_t* raw,
                           const int32_t* lens, int64_t num_words,
                           int32_t width, int32_t u16_out, int32_t padded,
                           void* out, int64_t* scan, void* stream) {
  const ht::PairTable table{reinterpret_cast<const int4*>(pslots),
                            static_cast<unsigned>(cap_mask), probe_len, false};
  return launch(table, ids, byte_seed, raw, lens, num_words, width, u16_out,
                padded, out, scan, stream);
}

// slots: int32 [C, 4] (left, right, rank, merged), 16-byte aligned
extern "C" int ht_id_merge_wide(const int32_t* slots, int64_t cap_mask,
                                int32_t probe_len, const int32_t* ids,
                                const int32_t* byte_seed, const uint8_t* raw,
                                const int32_t* lens, int64_t num_words,
                                int32_t width, int32_t u16_out, int32_t padded,
                                void* out, int64_t* scan, void* stream) {
  const ht::WidePairTable table{reinterpret_cast<const int4*>(slots),
                                static_cast<unsigned>(cap_mask), probe_len,
                                nullptr, 0};
  return launch(table, ids, byte_seed, raw, lens, num_words, width, u16_out,
                padded, out, scan, stream);
}
