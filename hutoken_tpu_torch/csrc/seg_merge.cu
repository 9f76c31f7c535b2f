// Segmented byte-level BPE merge of the words of a byte chunk, in place,
// for Hopper (sm_90a).
//
// Replaces hutoken_tpu/ops/pallas_merge.py::_kernel_seg, and computes the
// same function: each listed word (1..32 bytes at any byte offset of the
// chunk) runs the greedy merge fixed point of fused_merge, and every
// surviving token's id is written at the byte of its first byte; all
// other bytes (consumed bytes, bytes of unlisted words, padding) stay -1,
// as the caller fills them.  A listed length of 0 skips the word: the raw
// path lists words longer than 32 bytes that way.  That is _kernel_seg's
// "survivors stay at their lanes, holes = -1" with the lane replaced by
// the byte position.  Its final nxt links are not produced: only the
// partial-table divergence probe reads them, and the full-table probe
// never diverges.
//
// Design.  The TPU kernel takes the chunk as 96-byte windows in 128-lane
// rows with a per-lane aux word (position, word-end lane, dead bit) and
// segment-relative prefix-min reductions; that layout exists to keep XLA
// away from gathers.  Here the word list comes straight from the start
// mask, and words of every length share it: a raw chunk averages under
// 5 bytes a word.  Each warp takes a run of 32 consecutive words, one per
// lane, and ballots which of them fit 8 lanes, which 16 and which need
// 32.  Its four 8-lane tiles merge the first class, tile k taking the
// class's k-th, (k+4)-th, ... word, each tile at its own pace; then two
// 16-lane tiles the second, then the whole warp the rest (17-32 bytes)
// one at a time.  Lane i of a tile loads byte word_start + i, maps it
// through the byte LUT and runs merge_warp.cuh's merge_word,
// carrying its byte offset through every compaction so that each
// survivor is written in place.  The argmin key is rank * 32 + compacted
// position where _kernel_seg keys on the original in-word position; both
// orders are leftmost at equal rank, so both reach the same fixed point.
//
// What bounds it.  Bytes would allow about 8 us per 4 MB chunk (the
// chunk and the word lists read once, the int32 ids written once).  The
// bound in practice is the latency of the dependent L2 probe loads per
// round times the number of rounds, with many resident tiles to hide it;
// tiles of the word's size keep the lanes of short words busy, where one
// warp per word left about 27 of 32 lanes idle.  Without the 16-lane
// class (9-16-byte words on the whole warp) the kernel ran 10-12 % slower
// per 4 MB chunk on the H100, timed in turns in one process.

#include <cstdint>

#include <cuda_runtime.h>

#include "merge_warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// Merge one word held by `tile` (its start and length tile-uniform) and
// write its survivors in place.
template <int G>
__device__ __forceinline__ void merge_one(const ht::PairTable& table,
                                          const ht::Tile<G>& tile,
                                          const int32_t* __restrict__ byte_seed,
                                          const uint8_t* __restrict__ chunk,
                                          int64_t start, int len,
                                          int32_t* __restrict__ out,
                                          int32_t* stage) {
  int id = tile.lane < len ? __ldg(byte_seed + chunk[start + tile.lane]) : -1;
  int off = tile.lane;  // byte offset of this token's first byte in the word
  const int n = ht::merge_word<G, true>(table, tile, len, id, off, stage);
  if (tile.lane < n) out[start + off] = id;
}

// Merge the words of `run` whose bits are set in `words` (each of at
// most G bytes) on the warp's 32 / G tiles of G lanes, round-robin.
template <int G>
__device__ __forceinline__ void merge_class(const ht::PairTable& table,
                                            const int32_t* __restrict__ byte_seed,
                                            const uint8_t* __restrict__ chunk,
                                            const int32_t* __restrict__ word_start,
                                            const int32_t* __restrict__ word_len,
                                            int64_t run, unsigned words,
                                            int32_t* __restrict__ out,
                                            int32_t* stage) {
  const ht::Tile<G> tile(threadIdx.x & 31);
  const int n = __popc(words);
  for (int i = (threadIdx.x & 31) / G; i < n; i += 32 / G) {  // tile-uniform
    const int64_t w = run + __fns(words, 0, i + 1);
    merge_one<G>(table, tile, byte_seed, chunk, word_start[w],
                 min(word_len[w], G), out, stage);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_merge_kernel(ht::PairTable table, const int32_t* __restrict__ byte_seed,
                 const uint8_t* __restrict__ chunk,
                 const int32_t* __restrict__ word_start,
                 const int32_t* __restrict__ word_len, int64_t num_words,
                 int32_t* __restrict__ out) {
  __shared__ int32_t stage[kWarpsPerBlock][64];
  const int wl = threadIdx.x & 31;
  int32_t* my_stage = stage[threadIdx.x >> 5];
  const int64_t run = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                       (threadIdx.x >> 5)) * 32;
  if (run >= num_words) return;  // the whole warp leaves together

  // lane i describes word run + i; length 0 is a skip
  const int64_t wi = run + wl;
  const int len = wi < num_words ? min(max(word_len[wi], 0), 32) : 0;
  const unsigned to8 = __ballot_sync(ht::kFullMask, len >= 1 && len <= 8);
  const unsigned to16 = __ballot_sync(ht::kFullMask, len > 8 && len <= 16);
  const unsigned to32 = __ballot_sync(ht::kFullMask, len > 16);
  merge_class<8>(table, byte_seed, chunk, word_start, word_len, run, to8, out, my_stage);
  merge_class<16>(table, byte_seed, chunk, word_start, word_len, run, to16, out, my_stage);
  merge_class<32>(table, byte_seed, chunk, word_start, word_len, run, to32, out, my_stage);
}

}  // namespace

// pslots: int32 [C, 4] (key, value, minsuper, 0), 16-byte aligned
extern "C" int ht_seg_merge(const int32_t* pslots, int64_t cap_mask,
                            int32_t probe_len, int32_t multi,
                            const int32_t* byte_seed, const uint8_t* chunk,
                            const int32_t* word_start, const int32_t* word_len,
                            int64_t num_words, int32_t* out, void* stream) {
  const ht::PairTable table{reinterpret_cast<const int4*>(pslots),
                            static_cast<unsigned>(cap_mask), probe_len,
                            multi != 0};
  const int64_t warps = (num_words + 31) / 32;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seg_merge_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, byte_seed, chunk, word_start, word_len, num_words, out);
  return static_cast<int>(cudaGetLastError());
}
