// Fused byte-level BPE merge for words of up to 32 bytes, writing the
// packed output layout, for Hopper (sm_90a).
//
// Replaces hutoken_tpu/ops/pallas_merge.py::_kernel / _kernel_body
// together with the packing that follows it (merge.py::_compact_output),
// and computes the same function: byte -> seed id through the 256-entry
// LUT, the greedy merge fixed point (each round applies the word's
// leftmost minimum-rank pair, plus every local minimum that the minsuper
// bound certifies as safe), then ONE 1-D output: W per-word counts, then
// every word's surviving ids, row-major, with no gaps.  As int16 holding
// uint16 bit patterns for vocabularies below 0xFFFF ids, else int32.
//
// Design.  A word of a width-G block (G = 8, 16 or 32: the engine sends
// length-sorted blocks narrowed to the longest word) is held by a tile
// of G lanes, so a warp merges 32 / G words at once; the rounds are
// merge_warp.cuh's merge_word.  Each tile leaves the loop on its own once
// its word merges nothing.  A block of 8 warps then scans its words'
// counts in one warp, and the row base of its first word comes from a
// single-pass decoupled look-back over the blocks before it: every block
// publishes its count total, then its inclusive prefix, in one 64-bit
// status word per block.  Blocks take their logical index from an atomic
// ticket (the wrapper zeroes ticket and statuses), so a block only waits
// on blocks that already run, in whatever order the card starts them.
// Only the counts and the W + sum(counts) prefix are written: the host
// reads nothing past it.
//
// What bounds it.  Not bytes: 0.6 MB in and at most 2.2 MB out for a
// 16,384 x 32 block, about a microsecond at 3.35 TB/s.  The bound is the
// latency of the dependent L2 probe loads per round times the number of
// rounds; the tables stay in the 50 MB L2, probing stops at the first
// empty slot, a probe step is one 16-byte load, and many resident tiles
// hide the latency.  The TPU kernel's lane-bucketed partial table and its
// 0x8000 divergence flag existed for the VMEM budget; probing the full
// table makes every word exact, and none is flagged.
//
// The wide variant (ht_fused_merge_wide) is the same kernel on the wide
// pair table of vocabularies whose ids or ranks pass 16 bits.  It
// replaces what the JAX package runs for those words on the TPU: not a
// Pallas kernel but the XLA R-matrix program
// (hutoken_tpu/ops/rmatrix.py::_merge_bytes_rmatrix and
// _merge_bytes_rmatrix_merges), which resolved every span of a word by
// hashing because the TPU's gather ran on its scalar core.

#include <cstdint>

#include <cuda_runtime.h>

#include "merge_warp.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned long long kAggregate = 1ull << 62;  // status: block total
constexpr unsigned long long kPrefix = 2ull << 62;     // status: inclusive prefix
constexpr unsigned long long kValue = (1ull << 62) - 1;

// Exclusive row base of logical block `block`, whose own count total is
// `total`: the decoupled look-back, run by one whole warp.  status[b] is
// 0 until block b publishes.  Each lane watches one of the 32 blocks
// before the window's end; the window's sum runs up to the closest block
// with an inclusive prefix, or slides 32 blocks back when none has one.
__device__ long long look_back(unsigned long long* status, int block,
                               long long total, int lane) {
  if (block == 0) {
    if (lane == 0) atomicExch(status, kPrefix | static_cast<unsigned long long>(total));
    return 0;
  }
  if (lane == 0) {
    atomicExch(status + block, kAggregate | static_cast<unsigned long long>(total));
  }
  long long prefix = 0;
  for (int j = block - 1 - lane;; j -= 32) {  // warp-uniform
    unsigned long long s = kPrefix;  // before block 0: a prefix of 0
    if (j >= 0) {
      do {
        s = *reinterpret_cast<volatile unsigned long long*>(status + j);
      } while (s == 0);
    }
    const unsigned has_prefix = __ballot_sync(ht::kFullMask, (s & kPrefix) != 0);
    const int stop = has_prefix ? __ffs(has_prefix) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(s & kValue) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(ht::kFullMask, v, d);
    prefix += v;
    if (has_prefix) break;
  }
  if (lane == 0) {
    atomicExch(status + block, kPrefix | static_cast<unsigned long long>(prefix + total));
  }
  return prefix;
}

template <int G, class Table, typename OutT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_merge_kernel(Table table, const int32_t* __restrict__ byte_seed,
                   const uint8_t* __restrict__ raw,
                   const int32_t* __restrict__ lens, int64_t num_words,
                   int width, OutT* __restrict__ out,
                   unsigned long long* __restrict__ scan) {
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

  int n = 0;
  int id = -1;
  if (w < num_words) {  // tile-uniform
    const int len = min(max(lens[w], 0), width);
    id = tile.lane < len ? __ldg(byte_seed + raw[w * width + tile.lane]) : -1;
    int unused = 0;
    n = ht::merge_word<G, false>(table, tile, len, id, unused, stage[warp]);
  }
  if (tile.lane == 0) s_excl[slot] = n;
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the block's counts (kWords <= 32), then the
    // row base of its first word
    const int c = wl < kWords ? s_excl[wl] : 0;
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(ht::kFullMask, incl, d);
      if (wl >= d) incl += v;
    }
    if (wl < kWords) s_excl[wl] = incl - c;
    const int total = __shfl_sync(ht::kFullMask, incl, 31);
    const long long base = look_back(scan + 1, s_block, total, wl);
    if (wl == 0) s_base = base;
  }
  __syncthreads();

  if (w < num_words) {
    if (tile.lane == 0) out[w] = static_cast<OutT>(n);
    if (tile.lane < n) {
      out[num_words + s_base + s_excl[slot] + tile.lane] = static_cast<OutT>(id);
    }
  }
}

template <int G, class Table, typename OutT>
void launch_g(const Table& table, const int32_t* byte_seed, const uint8_t* raw,
              const int32_t* lens, int64_t num_words, int32_t width, OutT* out,
              unsigned long long* scan, cudaStream_t stream) {
  constexpr int kWords = kWarpsPerBlock * (32 / G);
  const int64_t blocks = (num_words + kWords - 1) / kWords;
  fused_merge_kernel<G><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                          stream>>>(table, byte_seed, raw, lens, num_words,
                                    width, out, scan);
}

template <class Table, typename OutT>
int launch_typed(const Table& table, const int32_t* byte_seed,
                 const uint8_t* raw, const int32_t* lens, int64_t num_words,
                 int32_t width, OutT* out, int64_t* scan, void* stream) {
  auto* sc = reinterpret_cast<unsigned long long*>(scan);
  auto st = static_cast<cudaStream_t>(stream);
  if (width <= 8) {
    launch_g<8>(table, byte_seed, raw, lens, num_words, width, out, sc, st);
  } else if (width <= 16) {
    launch_g<16>(table, byte_seed, raw, lens, num_words, width, out, sc, st);
  } else {
    launch_g<32>(table, byte_seed, raw, lens, num_words, width, out, sc, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Table>
int launch(const Table& table, const int32_t* byte_seed, const uint8_t* raw,
           const int32_t* lens, int64_t num_words, int32_t width,
           int32_t u16_out, void* out, int64_t* scan, void* stream) {
  if (u16_out) {
    return launch_typed(table, byte_seed, raw, lens, num_words, width,
                        static_cast<int16_t*>(out), scan, stream);
  }
  return launch_typed(table, byte_seed, raw, lens, num_words, width,
                      static_cast<int32_t*>(out), scan, stream);
}

}  // namespace

// pslots: int32 [C, 4] (key, value, minsuper, 0), 16-byte aligned.
// out: W + W * width entries of int16 (u16_out) or int32; scan: int64
// [1 + blocks], zeroed (blocks = ceil(W / (256 / G))).
extern "C" int ht_fused_merge(const int32_t* pslots, int64_t cap_mask,
                              int32_t probe_len, int32_t multi,
                              const int32_t* byte_seed, const uint8_t* raw,
                              const int32_t* lens, int64_t num_words,
                              int32_t width, int32_t u16_out, void* out,
                              int64_t* scan, void* stream) {
  const ht::PairTable table{reinterpret_cast<const int4*>(pslots),
                            static_cast<unsigned>(cap_mask), probe_len,
                            multi != 0};
  return launch(table, byte_seed, raw, lens, num_words, width, u16_out, out,
                scan, stream);
}

// slots: int32 [C, 4] (left, right, rank, merged), 16-byte aligned
extern "C" int ht_fused_merge_wide(const int32_t* slots, int64_t cap_mask,
                                   int32_t probe_len, const int32_t* minsuper,
                                   int32_t minsuper_len,
                                   const int32_t* byte_seed, const uint8_t* raw,
                                   const int32_t* lens, int64_t num_words,
                                   int32_t width, int32_t u16_out, void* out,
                                   int64_t* scan, void* stream) {
  const ht::WidePairTable table{reinterpret_cast<const int4*>(slots),
                                static_cast<unsigned>(cap_mask), probe_len,
                                minsuper, minsuper_len};
  return launch(table, byte_seed, raw, lens, num_words, width, u16_out, out,
                scan, stream);
}
