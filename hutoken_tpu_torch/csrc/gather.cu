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
// gather is a load per element; what matters is where the table lives,
// how many bytes each load brings, and how many loads are in flight.  What
// bounds every kernel here is bytes: each index and output moves once (8 B
// per lookup), plus the table reads, which device memory serves in 32-byte
// sectors (the probe prints both the entry bound and this sector bound);
// none does arithmetic worth counting.  The launch plans of gather_1d,
// gather_rows and gather_cols (threads and blocks, the row divider, slab
// widths, row splits, TMA box rows, where shared memory holds the
// mbarrier) are computed in Python (ops/gather.py) and passed in, so that
// the CPU tests can check that a plan covers every lookup once and fits
// shared memory; these kernels keep no launch geometry of their own.
//   * gather_1d and gather_rows share one loop (gather_vectors), a
//     template on how lookup i with index j forms its table address.  It
//     moves indices and outputs as 16-byte int4 vectors, 4 lookups a
//     vector, several vectors in flight per thread; block b takes a
//     contiguous run of vectors.  The up to 3 indices before the first
//     16-byte boundary and the up to 3 after the last vector are looked up
//     one by one (the wrapper places the output at the same address mod 16
//     as the indices, so one peel aligns both).
//   * gather_1d is that loop, 4 vectors in flight, with two
//     instantiations.  kSmem = false reads the table through the
//     read-only path (__ldg), so a table of up to the 50 MB L2 stays on
//     chip across blocks (k_take).  kSmem = true stages the whole table
//     into dynamic shared memory first (k_taa, whose table is broadcast to
//     every row of VMEM): thread 0 issues one bulk asynchronous copy
//     (cp.async.bulk, completing on an mbarrier held after the table in
//     the same memory) of the table's 16-byte-aligned middle, while the
//     threads copy the few entries before and after it, so staging costs
//     one round trip to L2 instead of one per 4-byte load.  There are as
//     many blocks as gather at least C indices each (staging then moves no
//     more than the gather), but at least one per SM while the vectors
//     last, and at most one wave.
//   * gather_rows is the same loop over the [W, L] indices taken as one
//     flat array of W * L lookups: out[i] = R[(i / L) * C2 + idx[i]].  What
//     bounds it on this card: the 32-byte sectors of R that the lookups
//     reach, plus 8 bytes of index and output per lookup, at 3.35 TB/s.  A
//     row of C2 = 32 entries is 4 sectors, all of which its 32 lookups
//     reach; at C2 = 512 they reach about 25 of its 64, and random sectors
//     come from device memory at well under its rate.  Two things decide
//     the rate there, both seen on an H100: each table-load instruction
//     must stay inside few rows of R, and the blocks in flight must sweep R
//     in order.  With lane l looking up its own vector's 4 entries an
//     instruction spans 4 rows, which ran slower than a warp per row at
//     C2 = 512; so the loop transposes each warp's run of 32 vectors
//     through a warp-private slice of shared memory, and instruction c
//     makes lookups 32c + l, 32 consecutive ones.  A grid of one wave, each
//     block on a long run of rows, spread the random reads over all of R
//     and ran slower than a block per pass of its threads, which is what
//     the plan gives; so did fewer blocks per SM.  Against the warp per row
//     it replaced (tools/gather_ab.py) it runs 1.38x at C2 = 32, 1.05x at
//     C2 = 128 and 1.14-1.22x at rows of 5 and 33 indices, but 2-4 %
//     behind at L = 32 with C2 = 256 and 512.  i / L is, while W * L <=
//     2^31, a 32-bit multiply-high division ((umulhi(i, m) + i) >> s, m
//     and s from the plan; m = 1 where L is a power of two, which makes it
//     a shift), past that a 64-bit one: at L = 32 a plain shift ran level
//     with the multiply-high division, as the loop waits on memory.
//   * gather_two_level stages each 128-index row in shared memory: the
//     second level reads the row at lane idx & 127, which is another
//     thread's index.  A warp per row that read its indices as int4
//     vectors and passed them between lanes by shuffles, 4 table loads a
//     lane, ran level with it or slower at every shape, into tables in L2
//     and past it (at 2^22 indices L2's or device memory's rate of random
//     32-byte reads binds both), so this loop stays.
//   * gather_cols gathers from column slabs staged in shared memory (the
//     TPU kernel holds the whole [C, 128] table in VMEM; 227 KB holds a
//     few of its columns) while the table is short, and through L2 past
//     that.  Slab route: block (x, s) owns the k columns [s*k, s*k + k)
//     and the index rows [x*rows_per, (x+1)*rows_per): it stages its slab,
//     then reads each index row's k entries as 16-byte vectors, looks each
//     up in the slab and writes the output the same way.  The slab arrives
//     by TMA, in boxes of (256) table rows x k columns; k is the widest of
//     32, 16, 8 whose padded columns fit.  Each SM stages its slab at about
//     one table row a nanosecond, while the L2 route and torch.gather make
//     one scattered read per lookup (7,944 per SM at N = 2^20), so the
//     slab's cost grows with the table and the L2 route's does not.  On an
//     H100 at N = 2^20 (tools/gather_ab.py --crossover, three rounds) the
//     slab took 0.83-0.96x the L2 route's time at 4,096-5,632 table rows,
//     1.01-1.04x at 6,144 (0.97x under a cold L2) and 1.03-1.08x at 6,656
//     and 7,168: the slab route is taken up to SLAB_MAX_ROWS = 5,632 table
//     rows (ops/gather.py), the last that won in every round.  Past it, and
//     for every input the slab cannot take (a table, indices or output off
//     a 16-byte boundary, a width no multiple of 4), the L2 route runs: a
//     block per index row at a time and thread l on column l (the row's
//     reads land in column l of scattered table rows, one 32-byte sector
//     per 4 bytes).  Slabs of 4
//     columns (past 7,168 rows) and the clusters of 2 blocks that shared
//     them by multicast lay past the crossover and are gone; rows spread
//     over a cluster's blocks and read through distributed shared memory,
//     and clusters of 4 or 8 sharing a slab, were slower.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;      // 16-byte vectors in flight per thread: gather_1d, gather_cols
constexpr int kRowVectors = 2;  // ... gather_rows (ht_gather_rows_vectors)
constexpr int kThreads = 256;   // gather_two_level, the one kernel without a Python plan
constexpr unsigned kFull = 0xffffffffu;

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

// out[i] = at(i, idx[i]) for i < n.  idx + head and out + head are 16-byte
// aligned; block b gathers vectors [b * per_block, (b + 1) * per_block) of
// the (n - head) / 4 that follow, block 0 also the scalar head and tail.
// The 32 lanes of a warp hold 32 consecutive vectors, kU such runs at a
// time.  kT: the lookups are transposed through the warp's kU x 128 int32
// of shared memory at `slices`, so that each table-load instruction makes
// 32 consecutive lookups (lane l lookup 32c + l of a run) and the outputs
// go back to vectors the same way; else lane l looks up its own vector's
// 4 entries.
template <int kU, bool kT, typename At>
__device__ __forceinline__ void gather_vectors(At at, const int32_t* __restrict__ idx, int64_t n,
                                               int head, int64_t per_block,
                                               int32_t* __restrict__ out, int32_t* slices) {
  const int64_t vecs = (n - head) / 4;
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    const int64_t i = t < head ? t : head + 4 * vecs + (t - head);
    if (i < n) out[i] = at(i, __ldg(idx + i));
  }
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t v1 = min64(vecs, v0 + per_block);
  const int threads = blockDim.x;
  const int lane = threadIdx.x & 31;
  int32_t* sl = kT ? slices + (threadIdx.x >> 5) * (kU * 128) : nullptr;
  // vb: the warp's first vector, the same for its 32 lanes
  for (int64_t vb = v0 + threadIdx.x - lane; vb < v1; vb += kU * threads) {
    const int64_t v = vb + lane;
    int4 j[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (v + u * threads < v1) j[u] = __ldg(iv + v + u * threads);
    }
    if constexpr (kT) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (v + u * threads < v1) reinterpret_cast<int4*>(sl + u * 128)[lane] = j[u];
      }
      __syncwarp(kFull);
      int32_t x[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 32 * c + lane;  // lookup e of the run, in vector e / 4
          if (vb + u * threads + (e >> 2) < v1) {
            x[u][c] = at(head + 4 * (vb + u * threads) + e, sl[u * 128 + e]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = 32 * c + lane;
          if (vb + u * threads + (e >> 2) < v1) sl[u * 128 + e] = x[u][c];
        }
      }
      __syncwarp(kFull);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (v + u * threads < v1) {
          ov[v + u * threads] = reinterpret_cast<const int4*>(sl + u * 128)[lane];
        }
      }
      __syncwarp(kFull);  // every lane has read its outputs before the next run lands
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (v + u * threads < v1) {
          const int64_t i = head + 4 * (v + u * threads);
          ov[v + u * threads] = make_int4(at(i, j[u].x), at(i + 1, j[u].y), at(i + 2, j[u].z),
                                          at(i + 3, j[u].w));
        }
      }
    }
  }
}

// out[i] = table[idx[i]].  Staging, table entry i is int32 stage_at + i of
// the dynamic shared memory (stage_at + lead a multiple of 4) and the
// mbarrier int32 bar_at.
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
  gather_vectors<kUnroll, false>(
      [&](int64_t, int32_t j) -> int32_t {
        if constexpr (kSmem) {
          return stage[j];
        } else {
          return __ldg(table + j);
        }
      },
      idx, n, head, per_block, out, nullptr);
}

// i / L: for i < 2^31 the multiply-high division (magic > 0: i / L =
// (umulhi(i, magic) + i) >> shift, exact for i < 2^31; magic is 1 where L
// is a power of two, a plain shift), else a 64-bit division
struct RowOf {
  int64_t L;
  uint32_t magic;
  int shift;

  __device__ __forceinline__ int64_t operator()(int64_t i) const {
    if (magic != 0) {
      const uint32_t u = static_cast<uint32_t>(i);
      return (__umulhi(u, magic) + u) >> shift;
    }
    return i / L;
  }
};

// out[w, j] = R[w, idx[w, j]], the indices as one flat array of n = W * L,
// transposed through the warps' slices of the dynamic shared memory
__global__ void gather_rows_kernel(const int32_t* __restrict__ R, int64_t width, RowOf row,
                                   const int32_t* __restrict__ idx, int64_t n, int head,
                                   int64_t per_block, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t slices[];
  gather_vectors<kRowVectors, true>(
      [&](int64_t i, int32_t j) { return __ldg(R + row(i) * width + j); }, idx, n, head,
      per_block, out, slices);
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

// gather_cols, L2 route: grid-stride over the index rows, thread l on
// column l
__global__ void gather_cols_kernel(const int32_t* __restrict__ tbl, int64_t width,
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
// slab in the dynamic shared memory.  Indices, slab reads and output move
// 4 entries at a time: rows, indices and output are 16-byte aligned and
// k % 4 == 0.
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
    const uint64_t map = reinterpret_cast<uint64_t>(&tmap);
    for (int i = 0; i < boxes; ++i) {
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3}], [%4];"
          ::"r"(smem_addr(slab + i * box)), "l"(map), "r"(c0), "r"(i * box_rows), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
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

int launched() { return static_cast<int>(cudaGetLastError()); }

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
    return launched();
  }
  const cudaError_t err = allow_smem(gather_1d_kernel<true>, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_1d_kernel<true><<<blocks, threads, smem_bytes, s>>>(table, table_len, lead, stage_at,
                                                             bar_at, idx, n, head, per_block, out);
  return launched();
}

// gather_two_level: a block per kThreads / 128 index rows (rows >= 1)
extern "C" int ht_gather_two_level(const int32_t* t2d, const int32_t* idx, int64_t rows,
                                   int32_t* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kThreads / 128 - 1) / (kThreads / 128));
  gather_two_level_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t2d, idx, rows, out);
  return launched();
}

// 16-byte vectors a gather_rows thread gathers at once: the plan's
// per_block and smem_bytes follow from it
extern "C" int ht_gather_rows_vectors() { return kRowVectors; }

// gather_rows with the plan of ops/gather.py::gather_rows_plan: R's rows
// are `width` entries long, the n = W * L indices flat; `head`, `blocks`,
// `threads` and `per_block` as for gather_1d, `smem_bytes` of shared
// memory for the warps' slices; the row of lookup i is RowOf{L, magic,
// shift}(i).
extern "C" int ht_gather_rows(const int32_t* R, int64_t width, const int32_t* idx, int64_t n,
                              int head, int blocks, int threads, int64_t per_block,
                              int64_t smem_bytes, int64_t L, uint32_t magic, int shift,
                              int32_t* out, void* stream) {
  const RowOf row{L, magic, shift};
  gather_rows_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      R, width, row, idx, n, head, per_block, out);
  return launched();
}

// gather_cols with the plan of ops/gather.py::gather_cols_plan: slab
// width k (0 = the L2 route), `slabs` x `row_splits` blocks of `threads`
// threads and `rows_per` index rows, each staging a slab of `boxes` TMA
// boxes of `box_rows` table rows in `smem_bytes` of shared memory; on the
// L2 route `row_splits` blocks of `threads` threads.
extern "C" int ht_gather_cols(const int32_t* tbl, int64_t table_rows, int64_t width,
                              const int32_t* idx, int64_t rows, int k, int boxes, int box_rows,
                              int slabs, int row_splits, int threads, int64_t rows_per,
                              int64_t smem_bytes, int32_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0) {
    gather_cols_kernel<<<row_splits, threads, 0, s>>>(tbl, width, idx, rows, out);
    return launched();
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
  const cudaError_t err = allow_smem(gather_cols_tma_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_cols_tma_kernel<<<dim3(static_cast<unsigned>(row_splits), static_cast<unsigned>(slabs)),
                           threads, smem_bytes, s>>>(tmap, boxes, box_rows, width, idx, rows, k,
                                                     rows_per, out);
  return launched();
}

