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
// gather is a load per element; what matters is where the table lives.
// Each kernel reads its indices coalesced (neighbouring threads on
// neighbouring indices) and writes its output coalesced; only the table
// reads scatter.
//   * gather_1d is one template with two instantiations.  kSmem = false
//     reads the table through the read-only path (__ldg), so a table of up
//     to the 50 MB L2 stays on chip across blocks (k_take).  kSmem = true
//     first stages the whole table into dynamic shared memory, block by
//     block, and gathers from there (k_taa, whose table is broadcast to
//     every row of VMEM).  Blocks loop over the indices; there are as
//     many as gather at least C indices each, so that staging costs no
//     more loads than the gather, but never fewer than one per SM.
//   * gather_two_level stages each 128-index row in shared memory: the
//     second level reads the row at lane idx & 127, which is another
//     thread's index.
//   * gather_rows gives one warp to each row of R; the row's 32 (or L)
//     reads fall inside one row of at most 2 KB.
//   * gather_cols gives a block to each row of indices and thread l to
//     column l, so no thread divides by the width; the row's 128 reads
//     land in column l of scattered table rows.
//
// What bounds them.  Bytes: each index and output moves once (8 B per
// lookup), plus the table reads, which hit L2 (or shared memory) when the
// table fits.  None of them does arithmetic worth counting.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
gather_1d_kernel(const int32_t* __restrict__ table, int64_t table_len,
                 const int32_t* __restrict__ idx, int64_t n,
                 int32_t* __restrict__ out) {
  extern __shared__ int32_t stage[];
  if constexpr (kSmem) {
    for (int64_t i = threadIdx.x; i < table_len; i += blockDim.x) {
      stage[i] = __ldg(table + i);
    }
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t j = __ldg(idx + i);
    out[i] = kSmem ? stage[j] : __ldg(table + j);
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

// one block per table-width row of indices; thread l takes column l
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

unsigned grid_for(int64_t items, int per_block) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// Largest dynamic shared memory a block may opt in to, in bytes: the
// bound on gather_1d's table in shared-memory mode.
extern "C" int ht_gather_smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

extern "C" int ht_gather_1d(const int32_t* table, int64_t table_len,
                            const int32_t* idx, int64_t n, int32_t* out,
                            int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!smem) {
    gather_1d_kernel<false><<<grid_for(n, kThreads), kThreads, 0, s>>>(
        table, table_len, idx, n, out);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = static_cast<size_t>(table_len) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      gather_1d_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_1d_kernel<true>, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: at most as many as fit on the card at once; few
  // enough that each gathers at least as many indices as it stages table
  // entries (staging is then at most half of the block's loads), but at
  // least one per SM while the indices last, since the SMs stage in
  // parallel
  const int sms = sm_count();
  const int64_t resident = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sms;
  int64_t blocks = grid_for(n, table_len > kThreads ? static_cast<int>(table_len) : kThreads);
  const int64_t by_threads = grid_for(n, kThreads);
  const int64_t floor_blocks = by_threads < sms ? by_threads : sms;
  if (blocks < floor_blocks) blocks = floor_blocks;
  if (blocks > resident) blocks = resident;
  gather_1d_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      table, table_len, idx, n, out);
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

extern "C" int ht_gather_cols(const int32_t* tbl, int64_t width,
                              const int32_t* idx, int64_t rows, int32_t* out,
                              void* stream) {
  const int threads = width < kThreads ? static_cast<int>((width + 31) / 32 * 32) : kThreads;
  const int64_t blocks = rows < (1LL << 20) ? rows : (1LL << 20);
  gather_cols_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(tbl, width, idx, rows,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}
