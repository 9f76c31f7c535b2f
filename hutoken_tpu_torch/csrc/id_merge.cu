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
// Design.  Rows of up to 32 ids take merge_warp.cuh's merge_word on a
// tile of 8, 16 or 32 lanes, as the fused merge does; only the loader
// differs.  A row of 33-128 ids takes a whole warp, K = 2 or 4 ids a
// lane, lane l holding positions K*l .. K*l+K-1, and keeps each pair's
// (rank, merged) in registers as _merge_fixed_point keeps its ranks
// array: a round takes the warp's minimum rank (__reduce_min_sync on the
// rank alone, so that a wide rank of 2^24 or more cannot overflow a
// rank * position key), the leftmost lane attaining it by ballot and that
// lane's leftmost slot, shifts every later position left by one in
// registers (one shuffle a value), and probes only the two pairs the
// merge touched.  Each row then counts its surviving ids, and a block of
// 8 warps scans its rows' counts and finds its row base by the
// decoupled look-back of merge_warp.cuh; the padded layout writes every
// position in place and skips the scan.
//
// What bounds it.  Not bytes: a 1,024 x 128 byte block is 132 KB in and
// at most 0.5 MB out.  The bound is the latency of each round's dependent
// steps (a probe of the pair table in L2, a handful of warp shuffles)
// times the rounds of the longest word of a block.  The long-word loop
// probes two pairs a round instead of every pair, so a round costs about
// one L2 probe chain.

#include <cstdint>

#include <cuda_runtime.h>

#include "merge_warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// The fixed point of one word of at most 32 * K ids held by a whole warp,
// K ids a lane (lane l holds positions K*l .. K*l+K-1; -1 past the word).
// Called by all 32 lanes together.
template <int K, class Table>
__device__ __forceinline__ void merge_long(const Table& t, int lane, int (&id)[K]) {
  constexpr int kInf = Table::kInfRank;
  constexpr unsigned full = ht::kFullMask;
  int rank[K];
  int merged[K];

  // (rank, merged) of the pair (slot j, its right neighbour)
  const int next0 = __shfl_down_sync(full, id[0], 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int right = j + 1 < K ? id[j + 1 < K ? j + 1 : j] : (lane < 31 ? next0 : -1);
    int r = kInf;
    int m = -1;
    int msup = 0;
    if (id[j] >= 0 && right >= 0) {
      t.lookup(static_cast<unsigned>(id[j]), static_cast<unsigned>(right), r, m, msup);
    }
    rank[j] = r;
    merged[j] = m;
  }

  while (true) {
    // the lane's leftmost minimum, then the warp's
    int lr = rank[0];
    int lm = merged[0];
    int lj = 0;
#pragma unroll
    for (int j = 1; j < K; ++j) {
      if (rank[j] < lr) {
        lr = rank[j];
        lm = merged[j];
        lj = j;
      }
    }
    const unsigned best = __reduce_min_sync(full, static_cast<unsigned>(lr));
    if (best >= static_cast<unsigned>(kInf)) break;  // warp-uniform: done
    const int src = __ffs(__ballot_sync(full, static_cast<unsigned>(lr) == best)) - 1;
    const int p = __shfl_sync(full, lane * K + lj, src);
    const int m = __shfl_sync(full, lm, src);

    // apply: position p takes m, every later position its right
    // neighbour's id and pair; the last position becomes PAD
    const int id_n = __shfl_down_sync(full, id[0], 1);
    const int rank_n = __shfl_down_sync(full, rank[0], 1);
    const int merged_n = __shfl_down_sync(full, merged[0], 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int pos = lane * K + j;
      if (pos > p) {
        const int k = j + 1 < K ? j + 1 : j;
        const bool from_next = j + 1 == K;
        id[j] = from_next ? (lane < 31 ? id_n : -1) : id[k];
        rank[j] = from_next ? (lane < 31 ? rank_n : kInf) : rank[k];
        merged[j] = from_next ? (lane < 31 ? merged_n : -1) : merged[k];
      } else if (pos == p) {
        id[j] = m;
      }
    }

    // re-probe the two pairs the merge touched: (p - 1, p) and (p, p + 1)
    const int next = __shfl_down_sync(full, id[0], 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int pos = lane * K + j;
      if (pos == p - 1 || pos == p) {
        const int right = j + 1 < K ? id[j + 1 < K ? j + 1 : j] : (lane < 31 ? next : -1);
        int r = kInf;
        int mg = -1;
        int msup = 0;
        if (id[j] >= 0 && right >= 0) {
          t.lookup(static_cast<unsigned>(id[j]), static_cast<unsigned>(right), r, mg, msup);
        }
        rank[j] = r;
        merged[j] = mg;
      }
    }
  }
}

// One word a tile of G lanes (K = 1) or a warp (G = 32, K = 2 or 4).
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
  static_assert(K == 1 || G == 32, "a word of more than 32 ids takes a whole warp");
  constexpr int kWords = kWarpsPerBlock * (32 / G);  // words per block
  __shared__ int32_t stage[kWarpsPerBlock][32];
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
    if constexpr (K == 1) {
      int unused = 0;
      ht::merge_word<G, false>(table, tile, n, id[0], unused, stage[warp]);
    } else {
      merge_long<K>(table, wl, id);
    }
  }

  // the row's surviving ids: count, and this lane's offset among them
  int c = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) c += id[j] >= 0 ? 1 : 0;
  int incl = c;
  for (int d = 1; d < G; d <<= 1) {
    const int v = __shfl_up_sync(tile.mask, incl, d, G);
    if (tile.lane >= d) incl += v;
  }
  const int total = __shfl_sync(tile.mask, incl, G - 1, G);
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
    launch_shape<16, 1>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
  } else if (width <= 32) {
    launch_shape<32, 1>(table, ids, byte_seed, raw, lens, num_words, width, padded, out, sc, st);
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
// ceil(W / words a block): 256 / G for width <= 32, else 8).
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
