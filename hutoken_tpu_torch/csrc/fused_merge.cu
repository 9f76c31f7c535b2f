// Fused byte-level BPE merge for words of up to 32 bytes, for Hopper (sm_90a).
//
// Replaces hutoken_tpu/ops/pallas_merge.py::_kernel / _kernel_body, and
// computes the same function: byte -> seed id through the 256-entry LUT,
// the greedy merge fixed point (each round applies the word's leftmost
// minimum-rank pair, plus every local minimum that the minsuper bound
// certifies as safe), then the survivors left-compacted with their count.
//
// Design.  One warp per word, lane i holding position i (words are at
// most 32 bytes, the warp width); the rounds are merge_warp.cuh's
// merge_word.  Each warp leaves the loop on its own once its word merges
// nothing.
//
// What bounds it.  Not bytes: a round reads a few int32 per lane.  The
// bound is the latency of the dependent L2 reads per round times the
// number of rounds.  The table is small enough to stay in the 50 MB L2,
// probing stops at the first empty slot, and many resident warps (8
// words per 256-thread block, a few registers per thread) hide the
// latency.  The TPU kernel's lane-bucketed partial table and its 0x8000
// divergence flag existed for the VMEM budget; probing the full table
// makes every word exact, and none is flagged.
//
// The wide variant (ht_fused_merge_wide) is the same kernel on the wide
// pair table of vocabularies whose ids or ranks pass 16 bits.  It
// replaces what the JAX package runs for those words on the TPU: not a
// Pallas kernel but the XLA R-matrix program
// (hutoken_tpu/ops/rmatrix.py::_merge_bytes_rmatrix and
// _merge_bytes_rmatrix_merges), which resolved every span of a word by
// hashing because the TPU's gather ran on its scalar core.  Here a
// probe step is one 16-byte load from L2, so the probe itself serves
// those vocabularies, in the same greedy order.

#include <cstdint>

#include <cuda_runtime.h>

#include "merge_warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <class Table>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_merge_kernel(Table table, const int32_t* __restrict__ byte_seed,
                   const uint8_t* __restrict__ raw,
                   const int32_t* __restrict__ lens, int64_t num_words,
                   int width, int32_t* __restrict__ out,
                   int32_t* __restrict__ counts) {
  __shared__ int32_t stage[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (w >= num_words) return;  // the whole warp leaves together

  const int len = min(max(lens[w], 0), width);
  int id = lane < len ? __ldg(byte_seed + raw[w * width + lane]) : -1;
  int unused = 0;
  const int n = ht::merge_word<false>(table, lane, len, id, unused,
                                      stage[warp], nullptr);

  if (lane < width) out[w * width + lane] = lane < n ? id : -1;
  if (lane == 0) counts[w] = n;
}

template <class Table>
int launch(const Table& table, const int32_t* byte_seed, const uint8_t* raw,
           const int32_t* lens, int64_t num_words, int32_t width,
           int32_t* out, int32_t* counts, void* stream) {
  const int64_t blocks = (num_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_merge_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      table, byte_seed, raw, lens, num_words, width, out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ht_fused_merge(const int32_t* pkey, const int32_t* pval,
                              int64_t cap_mask, int32_t probe_len,
                              const int32_t* byte_seed,
                              const int32_t* minsuper, int32_t minsuper_len,
                              const uint8_t* raw, const int32_t* lens,
                              int64_t num_words, int32_t width, int32_t* out,
                              int32_t* counts, void* stream) {
  const ht::PairTable table{pkey, pval, static_cast<unsigned>(cap_mask),
                            probe_len, minsuper, minsuper_len};
  return launch(table, byte_seed, raw, lens, num_words, width, out, counts,
                stream);
}

// slots: int32 [C, 4] (left, right, rank, merged), 16-byte aligned
extern "C" int ht_fused_merge_wide(const int32_t* slots, int64_t cap_mask,
                                   int32_t probe_len, const int32_t* byte_seed,
                                   const int32_t* minsuper,
                                   int32_t minsuper_len, const uint8_t* raw,
                                   const int32_t* lens, int64_t num_words,
                                   int32_t width, int32_t* out,
                                   int32_t* counts, void* stream) {
  const ht::WidePairTable table{reinterpret_cast<const int4*>(slots),
                                static_cast<unsigned>(cap_mask), probe_len,
                                minsuper, minsuper_len};
  return launch(table, byte_seed, raw, lens, num_words, width, out, counts,
                stream);
}
