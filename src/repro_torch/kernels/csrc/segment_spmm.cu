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
// sequential grid; here one group of lanes owns one destination row, so
// every output row is written once, by one group, with no atomics.  Rows
// without edges get 0.
//
// Order contract.  Per edge, in CSR order and from 0, each output element
// adds the message round(x[src, c] * w_e): out = __fadd_rn(out,
// __fmul_rn(x, w)).  The JAX package multiplies before it sums
// (segment_spmm/ref.py, gcn.py), and the plain version on the CPU adds in
// the same order, so kernel and CPU agree bitwise.  The explicit intrinsics
// keep nvcc from contracting them into one fma.  An edge of weight 0 adds
// nothing (for finite x it would add exactly 0): it is how a masked edge
// (GCN's self loops) is left out, as the JAX package's scatter_sum parks it
// in a waste bin.  Only the gathers run ahead; the adds never split.
//
// What bounds it on an H100: device memory, through the gathers.  Each
// live edge reads one x row (4F bytes) at a random source: at
// ogb_products (61.9M edges, F = 100) x is 980 MB, far past the 50 MB L2,
// so each 400-byte row costs 13 sectors of 32 B from HBM — ~26 GB a
// launch, against ~1.5 GB of edges and output.  What the design does
// about it:
//   * lane layout by F: a row's columns go to G lanes of 16-byte float4
//     loads (VEC = 4; G = ceil(F / 4) rounded up to a power of two, at
//     most 32), and a warp holds 32 / G rows (F = 100: 25 lanes of one
//     row; F = 16: 8 rows of 4 lanes).  The wrapper picks VEC = 4 when F
//     is a multiple of 4 and x is 16-byte aligned, else scalar loads
//     (VEC = 1, G = F rounded up);
//   * gathers in flight: a group loads B src/w entries of its row with
//     coalesced reads, then walks them in stages of D edges, issuing the
//     next stage's x loads before it adds the current stage; a zero
//     weight predicates its load off;
//   * the grid is as many blocks as the occupancy calculator fits on the
//     card (asked once per device and layout), each warp striding over row
//     groups.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ T fma_rn(T acc, T v, float w) {
    return __fadd_rn(acc, __fmul_rn(v, w));
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ T fma_rn(T acc, T v, float w) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
    acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
    acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
    acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
    return acc;
  }
};

// Edge j of the batch (j a compile-time index once unrolled): its source
// and weight from the lane of the row's group that loaded them, then its x
// loads, predicated off for weight 0 (and past the row, whose weight is 0).
template <class V, int G, int CH, int K>
__device__ __forceinline__ void fetch(int j, const int (&s_r)[K], const float (&w_r)[K],
                                      int gbase, int gl, int u0, int units,
                                      const typename V::T* xv, typename V::T (&v)[CH],
                                      float& wj) {
  const int sj = __shfl_sync(kFull, s_r[j / G], gbase + j % G);
  wj = __shfl_sync(kFull, w_r[j / G], gbase + j % G);
  const typename V::T* xr = xv + static_cast<size_t>(sj) * units;
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const int u = u0 + gl + G * h;
    v[h] = V::zero();
    if (wj != 0.f && u < units) v[h] = V::load(xr + u);
  }
}

// The edge's messages added to the row sums: one rounding for the product,
// one for the sum; an edge of weight 0 adds nothing.
template <class V, int G, int CH>
__device__ __forceinline__ void add(typename V::T (&acc)[CH], const typename V::T (&v)[CH],
                                    float wj, int gl, int u0, int units) {
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const int u = u0 + gl + G * h;
    if (wj != 0.f && u < units) acc[h] = V::fma_rn(acc[h], v[h], wj);
  }
}

// VEC: floats per load; G: lanes per row (a power of two, <= 32); CH:
// loads per lane and edge (a pass covers G * CH * VEC columns; wider rows
// take several passes over their edges).
template <int VEC, int G, int CH>
__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
                    const float* __restrict__ w, const float* __restrict__ x,
                    float* __restrict__ out, int n_rows, int F) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int R = 32 / G;                   // rows per warp
  constexpr int B = G * 8 < 32 ? G * 8 : 32;  // edges per row and batch
  constexpr int K = B / G;                    // of them loaded by each lane
  constexpr int D0 = 16 / (VEC * CH);
  constexpr int D = D0 < 2 ? 2 : (D0 > 8 ? 8 : D0);  // edges per stage
  constexpr int S = B / D;                    // stages per batch
  static_assert(B % D == 0, "a batch is whole stages");

  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);              // lane within the row's group
  const int gbase = lane & ~(G - 1);          // first lane of the group
  const int units = F / VEC;                  // loads per row
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  const int stride = gridDim.x * kWarpsPerBlock * R;

  for (int rb = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * R; rb < n_rows;
       rb += stride) {
    const int row = rb + lane / G;
    int beg = 0, end = 0;
    if (row < n_rows) {
      beg = row_ptr[row];
      end = row_ptr[row + 1];
    }
    // every lane walks the warp's longest row, so shuffles see all lanes
    const int max_len = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(end - beg)));
    for (int u0 = 0; u0 < units; u0 += G * CH) {
      T acc[CH];
#pragma unroll
      for (int h = 0; h < CH; ++h) acc[h] = V::zero();
      for (int base = 0; base < max_len; base += B) {
        // B edges of the row: lane gl holds edges gl, gl + G, ...
        int s_r[K];
        float w_r[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int e = beg + base + gl + G * k;
          s_r[k] = 0;
          w_r[k] = 0.f;  // past the row: weight 0, nothing loaded or added
          if (e < end) {
            s_r[k] = __ldg(src + e);
            w_r[k] = __ldg(w + e);
          }
        }
        T cur[D][CH], nxt[D][CH];
        float wc[D], wn[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
          fetch<V, G, CH>(d, s_r, w_r, gbase, gl, u0, units, xv, cur[d], wc[d]);
#pragma unroll
        for (int st = 0; st < S; ++st) {
          // the next stage's gathers go out before this stage's adds
          if (st + 1 < S) {
#pragma unroll
            for (int d = 0; d < D; ++d)
              fetch<V, G, CH>((st + 1) * D + d, s_r, w_r, gbase, gl, u0, units, xv,
                              nxt[d], wn[d]);
          }
#pragma unroll
          for (int d = 0; d < D; ++d) add<V, G, CH>(acc, cur[d], wc[d], gl, u0, units);
          if (st + 1 < S) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
              wc[d] = wn[d];
#pragma unroll
              for (int h = 0; h < CH; ++h) cur[d][h] = nxt[d][h];
            }
          }
        }
      }
      if (row < n_rows) {
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          const int u = u0 + gl + G * h;
          if (u < units) ov[static_cast<size_t>(row) * units + u] = acc[h];
        }
      }
    }
  }
}

template <int VEC, int G, int CH>
cudaError_t launch(const int* row_ptr, const int* src, const float* w,
                   const float* x, float* out, int n_rows, int F,
                   cudaStream_t stream) {
  auto kernel = segment_spmm_kernel<VEC, G, CH>;
  // blocks the card holds at once, per device: 0 until asked (a race asks
  // twice, same answer)
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int cap = resident[dev].load(std::memory_order_relaxed);
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    resident[dev].store(cap, std::memory_order_relaxed);
  }
  const long long rows_per_block = static_cast<long long>(kWarpsPerBlock) * (32 / G);
  const long long want = (n_rows + rows_per_block - 1) / rows_per_block;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  kernel<<<blocks, kThreads, 0, stream>>>(row_ptr, src, w, x, out, n_rows, F);
  return cudaGetLastError();
}

template <int VEC, int CH>
cudaError_t launch_g(int G, const int* rp, const int* sr, const float* wt,
                     const float* xx, float* o, int n_rows, int F, cudaStream_t st) {
  switch (G) {
    case 1: return launch<VEC, 1, CH>(rp, sr, wt, xx, o, n_rows, F, st);
    case 2: return launch<VEC, 2, CH>(rp, sr, wt, xx, o, n_rows, F, st);
    case 4: return launch<VEC, 4, CH>(rp, sr, wt, xx, o, n_rows, F, st);
    case 8: return launch<VEC, 8, CH>(rp, sr, wt, xx, o, n_rows, F, st);
    case 16: return launch<VEC, 16, CH>(rp, sr, wt, xx, o, n_rows, F, st);
    default: return launch<VEC, 32, CH>(rp, sr, wt, xx, o, n_rows, F, st);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; vec is 4
// (float4 loads: F % 4 == 0 and x 16-byte aligned) or 1 (scalar loads);
// the stream is PyTorch's current stream.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a vec the inputs do not allow).
extern "C" int segment_spmm_launch(const void* row_ptr, const void* src,
                                   const void* w, const void* x, void* out,
                                   int n_rows, int F, int vec, void* stream) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (vec != 1 && (vec != 4 || F % 4 != 0 ||
                   reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
                   reinterpret_cast<std::uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* sr = static_cast<const int*>(src);
  const auto* wt = static_cast<const float*>(w);
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int units = F / vec;
  int G = 1;
  while (G < units && G < 32) G <<= 1;
  cudaError_t err;
  if (vec == 4) {  // up to 64 float4 a lane-pass: 256 columns
    err = units <= 32 ? launch_g<4, 1>(G, rp, sr, wt, xx, o, n_rows, F, st)
                      : launch<4, 32, 2>(rp, sr, wt, xx, o, n_rows, F, st);
  } else {         // up to 4 floats a lane-pass: 128 columns
    err = units <= 32   ? launch_g<1, 1>(G, rp, sr, wt, xx, o, n_rows, F, st)
          : units <= 64 ? launch<1, 32, 2>(rp, sr, wt, xx, o, n_rows, F, st)
                        : launch<1, 32, 4>(rp, sr, wt, xx, o, n_rows, F, st);
  }
  return static_cast<int>(err);
}
