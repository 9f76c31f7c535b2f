// Table gathers for Hopper (sm_90a): the gather-rate probes of the TPU's
// profiling scripts, as four kernels with a plain C interface.
//
// Replaces the Pallas kernels of
//   scripts/profile_pallas_gather.py   k_take (run_take), k_taa (run_taa)
//   scripts/profile_pallas_gather2.py  k_gather2 (run2)
//   scripts/profile_gather3.py         kernel (pallas_taa), kernel0 (pallas_g0)
// and computes the same functions, on int32 tables and int32 indices that
// the caller keeps in range (the TPU kernels take in-range indices too):
//
//   gather_1d         out[i]    = table[idx[i]]                     (k_take, k_taa)
//   gather_two_level  out[n, l] = t2d[rows[n, j], j],
//                     j = idx[n, l] & 127, rows = idx >> 7           (k_gather2)
//   gather_rows       out[w, j] = R[w, idx[w, j]]                   (kernel)
//   gather_cols       out[n, l] = tbl[idx[n, l], l]                 (kernel0)
//
// Design.  On the TPU the table sits in VMEM and the question each script
// asks is whether Mosaic lowers a per-lane gather at all.  On the H100 a
// gather is a load per element; what matters is where the table lives and
// how many bytes each load brings.  What bounds every kernel here is
// bytes: each index and output moves once (8 B per lookup), plus the
// table reads; none does arithmetic worth counting.  The launch plans of
// gather_1d and gather_cols (threads and blocks, slab widths, row splits,
// TMA box rows, where shared memory holds the mbarrier) are computed in
// Python (ops/gather.py) and passed in, so that the CPU tests can check
// that a plan covers every lookup once and fits shared memory; these
// kernels keep no launch geometry of their own.
//   * gather_1d is one template with two instantiations.  kSmem = false
//     reads the table through the read-only path (__ldg), so a table of up
//     to the 50 MB L2 stays on chip across blocks (k_take).  kSmem = true
//     stages the whole table into dynamic shared memory first (k_taa,
//     whose table is broadcast to every row of VMEM): thread 0 issues one
//     bulk asynchronous copy (cp.async.bulk, completing on an mbarrier
//     held after the table in the same memory) of the table's
//     16-byte-aligned middle, while the threads copy the few entries
//     before and after it, so staging costs one round trip to L2 instead
//     of one per 4-byte load.  Both instantiations move indices
//     and outputs as 16-byte int4 vectors, 4 lookups a vector, 4 vectors
//     in flight per thread; block b takes a contiguous run of vectors.
//     The up to 3 indices before the first 16-byte boundary and the up to
//     3 after the last vector are looked up one by one (the wrapper
//     places the output at the same address mod 16 as the indices, so one
//     peel aligns both).  There are as many blocks as gather at least C
//     indices each (staging then moves no more than the gather), but at
//     least one per SM while the vectors last and no more than fit on the
//     card at once.  No cluster multicast: each block's shared memory is
//     filled from L2, which holds the table after the first block's copy.
//   * gather_two_level stages each 128-index row in shared memory: the
//     second level reads the row at lane idx & 127, which is another
//     thread's index.
//   * gather_rows gives one warp to each row of R; the row's 32 (or L)
//     reads fall inside one row of at most 2 KB.
//   * gather_cols gathers from column slabs staged in shared memory (the
//     TPU kernel holds the whole [C, 128] table in VMEM; 227 KB holds a
//     few of its columns).  Block (x, s) owns the k columns [s*k, s*k +
//     k) and the index rows [x*rows_per, (x+1)*rows_per): it stages its
//     slab, then reads each index row's k entries as 16-byte vectors,
//     looks each up in the slab and writes the output the same way.  The
//     slab arrives by TMA, in boxes of (256) table rows x k columns; where
//     it is only 4 columns wide (C > 7,168) two blocks of a cluster share
//     it, each box loaded once and multicast to both.  k is the widest of
//     32, 16, 8, 4 whose padded columns fit: a wider slab reads fewer and
//     fuller index and output rows, while staging costs about the same
//     per table row.  What bounds it on this card: each SM reads its
//     slab as C row pieces and its index and output as row pieces of 4k
//     bytes, at about one piece a nanosecond; at C = 8,192 the 8,192
//     staged rows alone cost about what torch.gather's one scattered read
//     per lookup costs (7,944 per SM at N = 2^20), so there the slab does
//     not win.  Every input the slab cannot take goes the L2 route: a
//     table, indices or output off a 16-byte boundary (a view at an
//     offset), a width no multiple of 4, or a table too long for a
//     4-column slab (C > 14,336 with the TMA padding).  The L2 route is a
//     block per index row and thread l on column l (the row's reads land
//     in column l of scattered table rows, one 32-byte sector per 4
//     bytes).  Rows spread over a cluster's blocks and read through
//     distributed shared memory, and clusters of 4 or 8 sharing a slab,
//     were slower.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // the kernels without a Python plan
constexpr int kUnroll = 4;     // 16-byte vectors in flight per thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Wait until the mbarrier at shared address b completes its phase 0.
__device__ __forceinline__ void wait_phase0(uint32_t b) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// Copy table[0, len) to stage[0, len).  table + lead and stage + lead are
// 16-byte aligned (lead < 4): thread 0 moves the aligned middle with one
// bulk asynchronous copy that completes on the mbarrier *bar, the threads
// move the at most 3 entries before it and 3 after it.  Every thread
// returns once the whole table is in shared memory.
__device__ void stage_table(const int32_t* __restrict__ table, int64_t len, int lead,
                            int32_t* stage, uint64_t* bar) {
  const int64_t head = min64(lead, len);
  const int64_t tail0 = head + (len - head) / 4 * 4;
  const uint32_t bytes = static_cast<uint32_t>((tail0 - head) * 4);
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) stage[i] = __ldg(table + i);
  for (int64_t i = tail0 + threadIdx.x; i < len; i += blockDim.x) stage[i] = __ldg(table + i);
  __syncthreads();  // the barrier is initialised, the edges are stored
  if (bytes == 0) return;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(stage + head)), "l"(reinterpret_cast<uint64_t>(table + head)), "r"(bytes), "r"(b)
        : "memory");
  }
  wait_phase0(b);
}

// out[i] = table[idx[i]].  idx + head and out + head are 16-byte aligned;
// block b gathers vectors [b * per_block, (b + 1) * per_block) of the
// (n - head) / 4 that follow, block 0 also the scalar head and tail.
// Staging, table entry i is int32 stage_at + i of the dynamic shared
// memory (stage_at + lead a multiple of 4) and the mbarrier int32 bar_at.
template <bool kSmem>
__global__ void gather_1d_kernel(const int32_t* __restrict__ table, int64_t table_len,
                                 int lead, int stage_at, int bar_at,
                                 const int32_t* __restrict__ idx, int64_t n, int head,
                                 int64_t per_block, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) int32_t smem[];
  int32_t* stage = smem + stage_at;
  if constexpr (kSmem) {
    stage_table(table, table_len, lead, stage, reinterpret_cast<uint64_t*>(smem + bar_at));
  }
  auto at = [&](int32_t j) -> int32_t {
    if constexpr (kSmem) {
      return stage[j];
    } else {
      return __ldg(table + j);
    }
  };
  const int64_t vecs = (n - head) / 4;
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    const int64_t i = t < head ? t : head + 4 * vecs + (t - head);
    if (i < n) out[i] = at(__ldg(idx + i));
  }
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t v1 = min64(vecs, v0 + per_block);
  const int threads = blockDim.x;
  for (int64_t v = v0 + threadIdx.x; v < v1; v += kUnroll * threads) {
    int4 j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * threads < v1) j[u] = __ldg(iv + v + u * threads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * threads < v1) {
        ov[v + u * threads] = make_int4(at(j[u].x), at(j[u].y), at(j[u].z), at(j[u].w));
      }
    }
  }
}

// two 128-index rows per block
__global__ void __launch_bounds__(kThreads)
gather_two_level_kernel(const int32_t* __restrict__ t2d,
                        const int32_t* __restrict__ idx, int64_t rows,
                        int32_t* __restrict__ out) {
  __shared__ int32_t row_idx[kThreads / 128][128];
  const int r = threadIdx.x >> 7;
  const int l = threadIdx.x & 127;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * (kThreads / 128) + r;
  if (n < rows) row_idx[r][l] = __ldg(idx + n * 128 + l);
  __syncthreads();
  if (n >= rows) return;
  const int j = row_idx[r][l] & 127;               // lanes[n, l]
  const int64_t row = row_idx[r][j] >> 7;          // rows[n, lanes[n, l]]
  out[n * 128 + l] = __ldg(t2d + row * 128 + j);
}

// one warp per row of R
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int32_t* __restrict__ R, int64_t rows, int64_t width,
                   const int32_t* __restrict__ idx, int64_t per_row,
                   int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (w >= rows) return;
  const int32_t* row = R + w * width;
  for (int64_t j = lane; j < per_row; j += 32) {
    out[w * per_row + j] = __ldg(row + __ldg(idx + w * per_row + j));
  }
}

// gather_cols, L2 route: one block per table-width row of indices; thread
// l takes column l
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const int32_t* __restrict__ tbl, int64_t width,
                   const int32_t* __restrict__ idx, int64_t rows,
                   int32_t* __restrict__ out) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    for (int64_t c = threadIdx.x; c < width; c += blockDim.x) {
      const int64_t i = r * width + c;
      out[i] = __ldg(tbl + static_cast<int64_t>(__ldg(idx + i)) * width + c);
    }
  }
}

// gather_cols, slab route.  Block (x, s) of a [row_splits, slabs] grid
// gathers table columns [s*k, s*k + k) for index rows [x*rows_per,
// (x+1)*rows_per).  Its slab, the boxes * box_rows (padded) table rows of
// those columns as slab[row * k + c], arrives by TMA in boxes of box_rows
// rows x k columns (columns past the table's width and rows past its
// length read as 0 and are never looked up); the mbarrier follows the
// slab in the dynamic shared memory.  The kS blocks of a cluster (along
// x) share one slab: box i is loaded once, by the cluster's block i % kS,
// and multicast into the shared memory of all of them, so L2 serves each
// slab once per cluster.  Indices, slab reads and output move 4 entries
// at a time: rows, indices and output are 16-byte aligned and k % 4 == 0.
template <int kS>
__global__ void gather_cols_tma_kernel(const __grid_constant__ CUtensorMap tmap, int boxes,
                                       int box_rows, int64_t width,
                                       const int32_t* __restrict__ idx, int64_t rows, int k,
                                       int64_t rows_per, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) int32_t slab[];
  const int box = box_rows * k;  // entries of a box
  const uint32_t b = smem_addr(slab + boxes * box);
  const int c0 = static_cast<int>(blockIdx.y) * k;
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(boxes) * box * 4;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
  }
  // every barrier of the cluster is armed before any box is multicast
  if constexpr (kS > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int rank = kS > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
    const uint64_t map = reinterpret_cast<uint64_t>(&tmap);
    for (int i = rank; i < boxes; i += kS) {
      const uint32_t dst = smem_addr(slab + i * box);
      const int row = i * box_rows;
      if constexpr (kS > 1) {
        const uint16_t mask = static_cast<uint16_t>((1u << kS) - 1);
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
            ::"r"(dst), "l"(map), "r"(c0), "r"(row), "r"(b), "h"(mask)
            : "memory");
      } else {
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];"
            ::"r"(dst), "l"(map), "r"(c0), "r"(row), "r"(b)
            : "memory");
      }
    }
  }
  wait_phase0(b);

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per;
  const int64_t r1 = min64(rows, r0 + rows_per);
  const int per = static_cast<int>(min64(k, width - c0)) / 4;  // vectors of a row
  const int items = r0 < r1 ? static_cast<int>((r1 - r0) * per) : 0;
  const int threads = blockDim.x;
  for (int v = threadIdx.x; v < items; v += kUnroll * threads) {
    int64_t off[kUnroll];
    int c[kUnroll];
    int4 j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = v + u * threads;
      const int row = w / per;
      c[u] = (w - row * per) * 4;
      off[u] = (r0 + row) * width + c0 + c[u];
      if (w < items) j[u] = __ldg(reinterpret_cast<const int4*>(idx + off[u]));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * threads < items) {
        const int32_t* s = slab + c[u];
        *reinterpret_cast<int4*>(out + off[u]) = make_int4(
            s[j[u].x * k], s[j[u].y * k + 1], s[j[u].z * k + 2], s[j[u].w * k + 3]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint, so that nothing links libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

constexpr int kCuResultBase = 10000;  // added to a CUresult returned as our error code

template <int kS>
int launch_tma(const CUtensorMap& tmap, int boxes, int box_rows, int64_t width,
               const int32_t* idx, int64_t rows, int k, int slabs, int row_splits, int threads,
               int64_t rows_per, int64_t smem_bytes, int32_t* out, cudaStream_t s) {
  cudaError_t err = allow_smem(gather_cols_tma_kernel<kS>, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_splits), static_cast<unsigned>(slabs));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gather_cols_tma_kernel<kS>, tmap, boxes, box_rows, width, idx,
                           rows, k, rows_per, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

unsigned grid_for(int64_t items, int per_block) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Largest dynamic shared memory a block may opt in to, in bytes: the
// bound on gather_1d's table in shared-memory mode and on gather_cols'
// slab.
extern "C" int ht_gather_smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Blocks of gather_1d of `threads` threads (through L2, or staging
// smem_bytes of shared memory) that fit on one SM at once, into *per_sm.
extern "C" int ht_gather_1d_blocks_per_sm(int smem, int threads, int64_t smem_bytes,
                                          int* per_sm) {
  cudaError_t err = smem ? allow_smem(gather_1d_kernel<true>, smem_bytes) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      smem ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gather_1d_kernel<true>,
                                                           threads, smem_bytes)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gather_1d_kernel<false>,
                                                           threads, 0));
}

// gather_1d with the plan of ops/gather.py::gather_1d_plan: `lead` table
// entries before its first 16-byte boundary, staged from int32
// `stage_at` of the shared memory on, its mbarrier at int32 `bar_at`,
// `head` indices before theirs (out
// has the same address mod 16 as idx), `blocks` blocks of `threads`
// threads and `per_block` vectors, `smem_bytes` of shared memory when
// staging.
extern "C" int ht_gather_1d(const int32_t* table, int64_t table_len, int lead, int stage_at,
                            int bar_at, const int32_t* idx, int64_t n, int head, int smem,
                            int blocks, int threads, int64_t per_block, int64_t smem_bytes,
                            int32_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!smem) {
    gather_1d_kernel<false><<<blocks, threads, 0, s>>>(table, table_len, lead, stage_at, bar_at,
                                                       idx, n, head, per_block, out);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = allow_smem(gather_1d_kernel<true>, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_1d_kernel<true><<<blocks, threads, smem_bytes, s>>>(table, table_len, lead, stage_at,
                                                             bar_at, idx, n, head, per_block, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ht_gather_two_level(const int32_t* t2d, const int32_t* idx,
                                   int64_t rows, int32_t* out, void* stream) {
  gather_two_level_kernel<<<grid_for(rows, kThreads / 128), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(t2d, idx, rows,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ht_gather_rows(const int32_t* R, int64_t rows, int64_t width,
                              const int32_t* idx, int64_t per_row, int32_t* out,
                              void* stream) {
  gather_rows_kernel<<<grid_for(rows, kThreads / 32), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(R, rows, width, idx,
                                                            per_row, out);
  return static_cast<int>(cudaGetLastError());
}

// gather_cols with the plan of ops/gather.py::gather_cols_plan: slab
// width k (0 = the L2 route), `slabs` x `row_splits` blocks of `threads`
// threads and `rows_per` index rows, in clusters of `cluster` blocks (1
// or 2) that share a slab of `boxes` TMA boxes of `box_rows` table rows,
// `smem_bytes` of shared memory a block.
extern "C" int ht_gather_cols(const int32_t* tbl, int64_t table_rows, int64_t width,
                              const int32_t* idx, int64_t rows, int k, int cluster, int boxes,
                              int box_rows, int slabs, int row_splits, int threads,
                              int64_t rows_per, int64_t smem_bytes, int32_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0) {
    const int l2_threads =
        width < kThreads ? static_cast<int>((width + 31) / 32 * 32) : kThreads;
    const int64_t blocks = rows < (1LL << 20) ? rows : (1LL << 20);
    gather_cols_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), l2_threads, 0, s>>>(
        tbl, width, idx, rows, out);
    return static_cast<int>(cudaGetLastError());
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(table_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int32_t*>(tbl),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kCuResultBase + static_cast<int>(r);
  switch (cluster) {
    case 1:
      return launch_tma<1>(tmap, boxes, box_rows, width, idx, rows, k, slabs, row_splits,
                           threads, rows_per, smem_bytes, out, s);
    case 2:
      return launch_tma<2>(tmap, boxes, box_rows, width, idx, rows, k, slabs, row_splits,
                           threads, rows_per, smem_bytes, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
