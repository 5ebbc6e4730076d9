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
// the TPU's sequential grid; here one warp owns one destination row, so
// every output row is written once, by one warp, with no atomics.
//
// Arithmetic order.  Per edge, lane c forms the matrix-vector product
// acc_c = sum_p alpha[src, p] * T[l, p, c] in a chain of fmaf over ascending
// p, then the message round(acc_c * w_e), then adds it to the row sum in CSR
// order (ascending source id within the row).  With a trie transition T
// (at most one nonzero per column) acc_c is exactly round(alpha * cond_p),
// so every message and every row sum is rounded as in the reference field
// (per-edge product, scale, sequential scatter-add in edge order).  The
// explicit __fmul_rn / __fadd_rn keep nvcc from contracting the scale and
// the add into one fma.  Edges of weight 0 are skipped: for finite alpha
// they add exactly 0.
//
// What bounds it on an H100: device memory.  Each step reads src and w
// (8 B per edge), gathers one alpha row (4N B) per local edge, and reads
// row_ptr/row_label and writes out (about 4N + 8 B per vertex): at the
// provgen-1M shapes (E = 5.53M, N = 23) about 0.6 GB at most, ~0.2 ms at
// 3.35 TB/s.  The design keeps T (L*N*N floats: 6.3 KB for provgen,
// 12.3 KB for musicbrainz) in shared memory, loads each alpha row with one
// coalesced read and broadcasts it by warp shuffles.  The per-edge N x N
// product costs N shuffles and N fma per lane; staging the gathered rows
// with cp.async/TMA, or fusing the per-edge mass pass, is later work.
//
// Limits: N <= 64 (one or two columns per lane), L*N*N*4 bytes of shared
// memory per block; the Python wrapper raises beyond them.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSM = 8;

template <int COLS>  // output columns per lane: 1 (N <= 32) or 2 (N <= 64)
__global__ void __launch_bounds__(kThreads)
vm_step_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
               const float* __restrict__ w, const int* __restrict__ row_label,
               const float* __restrict__ alpha, const float* __restrict__ T,
               float* __restrict__ out, int n, int N, int L) {
  extern __shared__ float sT[];
  const int tnn = L * N * N;
  for (int i = threadIdx.x; i < tnn; i += blockDim.x) sT[i] = T[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n;
       row += gridDim.x * kWarpsPerBlock) {
    const float* Tl = sT + row_label[row] * N * N;
    const int beg = row_ptr[row];
    const int end = row_ptr[row + 1];
    float sum[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) sum[k] = 0.f;

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
        const float* a_row = alpha + static_cast<size_t>(s) * N;
        float a[COLS];
        float acc[COLS];
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int c = lane + 32 * k;
          a[k] = c < N ? a_row[c] : 0.f;
          acc[k] = 0.f;
        }
#pragma unroll 4
        for (int p = 0; p < N; ++p) {
          const float ap =
              __shfl_sync(0xffffffffu, (COLS == 1 || p < 32) ? a[0] : a[COLS - 1], p & 31);
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            const int c = lane + 32 * k;
            if (c < N) acc[k] = fmaf(ap, Tl[p * N + c], acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < COLS; ++k) sum[k] = __fadd_rn(sum[k], __fmul_rn(acc[k], we));
      }
    }
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int c = lane + 32 * k;
      if (c < N) out[static_cast<size_t>(row) * N + c] = sum[k];
    }
  }
}

template <int COLS>
cudaError_t launch(const int* row_ptr, const int* src, const float* w,
                   const int* row_label, const float* alpha, const float* T,
                   float* out, int n, int N, int L, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L) * N * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        vm_step_kernel<COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int cap = (sms > 0 ? sms : 132) * kBlocksPerSM;
  const int blocks = want < cap ? want : cap;
  vm_step_kernel<COLS><<<blocks, kThreads, smem, stream>>>(
      row_ptr, src, w, row_label, alpha, T, out, n, N, L);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; the stream
// is PyTorch's current stream.  Returns the cudaError_t of the launch.
extern "C" int vm_step_launch(const void* row_ptr, const void* src,
                              const void* w, const void* row_label,
                              const void* alpha, const void* T, void* out,
                              int n, int N, int L, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* sr = static_cast<const int*>(src);
  const auto* wt = static_cast<const float*>(w);
  const auto* rl = static_cast<const int*>(row_label);
  const auto* al = static_cast<const float*>(alpha);
  const auto* tt = static_cast<const float*>(T);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      N <= 32 ? launch<1>(rp, sr, wt, rl, al, tt, o, n, N, L, st)
              : launch<2>(rp, sr, wt, rl, al, tt, o, n, N, L, st);
  return static_cast<int>(err);
}
