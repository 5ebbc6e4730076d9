// segment_spmm — edge-weighted gather-scatter SpMM, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm/kernel.py:26
// (_spmm_kernel, launched by segment_spmm_packed).  It computes
//
//     out[v, :] = sum over the CSR row of destination v of w_e * x[src_e, :]
//
// over a destination-sorted CSR (row_ptr, src, w), x (n, F) float32.  The
// TPU kernel's padded edge blocks, scalar-prefetched block ids, one-hot
// matrix-unit scatter and block_f feature tiling served the TPU's
// sequential grid; here one warp owns one destination row, so every output
// row is written once, by one warp, with no atomics.  Rows without edges
// get 0.
//
// Arithmetic order.  Per edge, lane c forms the message round(x[src, c] *
// w_e) and adds it to the row sum in CSR order, from 0 — the JAX package
// multiplies before it sums (segment_spmm/ref.py, gcn.py).  The explicit
// __fmul_rn / __fadd_rn keep nvcc from contracting them into one fma.  An
// edge of weight 0 is skipped: for finite x it adds exactly 0, and it is
// how a masked edge (GCN's self loops) is left out, as the JAX package's
// scatter_sum parks it in a waste bin.
//
// Lanes span F: lane l owns columns l, l + 32, ... of a block of 32 * COLS
// columns (COLS = 1 for F <= 32, 2 for F <= 64, else 4 per block of 128),
// so the row gathers of a warp are coalesced; the tail lanes idle (F = 100
// uses 100 of 128 lanes, F = 16 half the warp).
//
// What bounds it on an H100: device memory.  Each launch reads src and w
// (8 B per edge), row_ptr, one x row (4F B) per edge and writes out (4F B
// per row): at ogb_products (61.9M edges, 2.45M rows) about 0.5 GB of edge
// data plus the gathered rows, which repeat from L2 only by chance (random
// sources).  Each edge is a dependent src -> row load; 8 blocks of 8 warps
// per SM hide that latency.  Vector loads, and staging src/w with
// cp.async, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSM = 8;

template <int COLS>
__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
                    const float* __restrict__ w, const float* __restrict__ x,
                    float* __restrict__ out, int n_rows, int F) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n_rows;
       row += gridDim.x * kWarpsPerBlock) {
    const int beg = row_ptr[row];
    const int end = row_ptr[row + 1];
    float* out_row = out + static_cast<size_t>(row) * F;
    for (int c0 = 0; c0 < F; c0 += 32 * COLS) {
      float acc[COLS];
#pragma unroll
      for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
      for (int base = beg; base < end; base += 32) {
        // one coalesced load of up to 32 edges, then broadcast edge by edge
        const int e = base + lane;
        int s_lane = 0;
        float w_lane = 0.f;
        if (e < end) {
          s_lane = src[e];
          w_lane = w[e];
        }
        const int cnt = min(32, end - base);
        for (int j = 0; j < cnt; ++j) {
          const float we = __shfl_sync(0xffffffffu, w_lane, j);
          if (we == 0.f) continue;  // warp-uniform: masked edge
          const int s = __shfl_sync(0xffffffffu, s_lane, j);
          const float* x_row = x + static_cast<size_t>(s) * F;
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            const int c = c0 + lane + 32 * k;
            if (c < F) acc[k] = __fadd_rn(acc[k], __fmul_rn(__ldg(x_row + c), we));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < F) out_row[c] = acc[k];
      }
    }
  }
}

template <int COLS>
cudaError_t launch(const int* row_ptr, const int* src, const float* w,
                   const float* x, float* out, int n_rows, int F,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int cap = (sms > 0 ? sms : 132) * kBlocksPerSM;
  const int blocks = want < cap ? want : cap;
  segment_spmm_kernel<COLS><<<blocks, kThreads, 0, stream>>>(
      row_ptr, src, w, x, out, n_rows, F);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; the stream
// is PyTorch's current stream.  Returns the cudaError_t of the launch.
extern "C" int segment_spmm_launch(const void* row_ptr, const void* src,
                                   const void* w, const void* x, void* out,
                                   int n_rows, int F, void* stream) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* sr = static_cast<const int*>(src);
  const auto* wt = static_cast<const float*>(w);
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (F <= 32)
    err = launch<1>(rp, sr, wt, xx, o, n_rows, F, st);
  else if (F <= 64)
    err = launch<2>(rp, sr, wt, xx, o, n_rows, F, st);
  else
    err = launch<4>(rp, sr, wt, xx, o, n_rows, F, st);
  return static_cast<int>(err);
}
