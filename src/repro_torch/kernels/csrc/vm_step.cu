// vm_step — one depth step of TAPER's Visitor-Matrix DP, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vm_step/kernel.py:26
// (_vm_kernel, launched by vm_step_packed).  It computes
//
//     out[v, :] = sum over the CSR row of destination v of
//                 (alpha[src_e, :] @ T[row_label[v]]) * w_e
//
// over a destination-sorted CSR.  w_e is 1 / cnt[src, label(v)] on edges
// inside a partition and 0 on cut edges.  The TPU kernel's padded edge
// blocks, scalar-prefetched block ids and one-hot matrix-unit scatter served
// the TPU's sequential grid; here one warp owns one (destination row, block
// of 32 trie columns) pair, so every output element is written once, by one
// lane, with no atomics.
//
// T comes in its column form.  A trie transition T[l][p, c] = cond_p(c) iff
// c = child(p, l) has at most one nonzero per column, so per (label, column)
// the caller passes the nonzero's row, par[l, c] = parent(c), and value,
// val[l, c] = cond_p(c) (any row and 0 where the column is empty).  The
// dense product alpha[src] @ T[l] then reduces to one gather and one
// multiply per lane: acc_c = alpha[src, par[l, c]] * val[l, c].
//
// Arithmetic order.  Per edge, lane c forms round(acc_c), then the message
// round(acc_c * w_e), then adds it to the row sum in CSR order (ascending
// source id within the row).  So every message and every row sum is rounded
// as in the reference field (per-edge product, scale, sequential scatter-add
// in edge order).  The explicit __fmul_rn / __fadd_rn keep nvcc from
// contracting the scale and the add into one fma.  Edges of weight 0 are
// skipped: for finite alpha they add exactly 0.
//
// What bounds it on an H100: device memory.  Each step reads src and w
// (8 B per edge), gathers at most one alpha row (4N B) per local edge, reads
// row_ptr, row_label and the column form, and writes out (4N B per vertex).
// Each warp loads up to 32 edges of its row with one coalesced read and
// broadcasts them by warp shuffles; a row of N > 32 columns is walked once
// per column block (the row placement's co-access graph has rows of up to
// 6,889 edges and a 677-node trie: 22 blocks, spread over 22 warps).
// Staging the gathered rows with cp.async/TMA is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads)
vm_step_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
               const float* __restrict__ w, const int* __restrict__ row_label,
               const float* __restrict__ alpha, const int* __restrict__ par,
               const float* __restrict__ val, float* __restrict__ out, int n,
               int N) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_blk = (N + 31) / 32;
  const long long tasks = static_cast<long long>(n) * n_blk;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
       task < tasks; task += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const int row = static_cast<int>(task / n_blk);
    const size_t lN = static_cast<size_t>(row_label[row]) * N;
    const int beg = row_ptr[row];
    const int end = row_ptr[row + 1];
    const int c = static_cast<int>(task % n_blk) * 32 + lane;
    const int p = c < N ? par[lN + c] : 0;
    const float t = c < N ? val[lN + c] : 0.f;
    float sum = 0.f;
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
        if (we == 0.f) continue;  // warp-uniform: cut edge
        const int s = __shfl_sync(0xffffffffu, s_lane, j);
        if (c < N) {
          const float acc = __fmul_rn(alpha[static_cast<size_t>(s) * N + p], t);
          sum = __fadd_rn(sum, __fmul_rn(acc, we));
        }
      }
    }
    if (c < N) out[static_cast<size_t>(row) * N + c] = sum;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; par and val
// are (L, N) int32 / float32, T's column form; the stream is PyTorch's
// current stream.  Returns the cudaError_t of the launch.
extern "C" int vm_step_launch(const void* row_ptr, const void* src,
                              const void* w, const void* row_label,
                              const void* alpha, const void* par,
                              const void* val, void* out, int n, int N,
                              void* stream) {
  if (n <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tasks = static_cast<long long>(n) * ((N + 31) / 32);
  const long long want = (tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * kBlocksPerSM;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  vm_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(src),
      static_cast<const float*>(w), static_cast<const int*>(row_label),
      static_cast<const float*>(alpha), static_cast<const int*>(par),
      static_cast<const float*>(val), static_cast<float*>(out), n, N);
  return static_cast<int>(cudaGetLastError());
}
