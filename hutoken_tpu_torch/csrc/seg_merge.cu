// Segmented byte-level BPE merge of the words of a byte chunk, in place,
// for Hopper (sm_90a).
//
// Replaces hutoken_tpu/ops/pallas_merge.py::_kernel_seg, and computes the
// same function: each listed word (1..32 bytes at any byte offset of the
// chunk) runs the greedy merge fixed point of fused_merge, and every
// surviving token's id is written at the byte of its first byte; all
// other bytes (consumed bytes, bytes of unlisted words, padding) stay -1,
// as the caller fills them.  A listed length of 0 skips the word: the raw
// path lists words longer than 32 bytes that way.  That is _kernel_seg's "survivors stay at
// their lanes, holes = -1" with the lane replaced by the byte position.
// Its final nxt links are not produced: only the partial-table
// divergence probe reads them, and the full-table probe never diverges.
//
// Design.  The TPU kernel takes the chunk as 96-byte windows in 128-lane
// rows with a per-lane aux word (position, word-end lane, dead bit) and
// segment-relative prefix-min reductions; that layout exists to keep XLA
// away from gathers.  Here one warp takes one word straight from the
// word list: lane i loads byte word_start + i, maps it through the byte
// LUT, and runs merge_warp.cuh's merge_word, carrying its byte offset
// through every compaction so that each survivor is written in place.
// The argmin key is rank * 32 + compacted position where _kernel_seg
// keys on the original in-word position; both orders are leftmost at
// equal rank, so both reach the same fixed point.
//
// What bounds it.  As for fused_merge: dependent L2 probes per round
// times the number of rounds, with many resident warps to hide them.
// The byte loads now start at unaligned word offsets, but a word spans
// at most two 32-byte sectors and each byte is read once.

#include <cstdint>

#include <cuda_runtime.h>

#include "merge_warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_merge_kernel(ht::PairTable table, const int32_t* __restrict__ byte_seed,
                 const uint8_t* __restrict__ chunk,
                 const int32_t* __restrict__ word_start,
                 const int32_t* __restrict__ word_len, int64_t num_words,
                 int32_t* __restrict__ out) {
  __shared__ int32_t stage_id[kWarpsPerBlock][32];
  __shared__ int32_t stage_off[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (w >= num_words) return;  // the whole warp leaves together

  const int64_t start = word_start[w];
  const int len = min(max(word_len[w], 0), 32);
  int id = lane < len ? __ldg(byte_seed + chunk[start + lane]) : -1;
  int off = lane;  // byte offset of this token's first byte in the word
  const int n = ht::merge_word<true>(table, lane, len, id, off,
                                     stage_id[warp], stage_off[warp]);
  if (lane < n) out[start + off] = id;
}

}  // namespace

extern "C" int ht_seg_merge(const int32_t* pkey, const int32_t* pval,
                            int64_t cap_mask, int32_t probe_len,
                            const int32_t* byte_seed, const int32_t* minsuper,
                            int32_t minsuper_len, const uint8_t* chunk,
                            const int32_t* word_start, const int32_t* word_len,
                            int64_t num_words, int32_t* out, void* stream) {
  const ht::PairTable table{pkey, pval, static_cast<unsigned>(cap_mask),
                            probe_len, minsuper, minsuper_len};
  const int64_t blocks = (num_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seg_merge_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, byte_seed, chunk, word_start, word_len, num_words, out);
  return static_cast<int>(cudaGetLastError());
}
