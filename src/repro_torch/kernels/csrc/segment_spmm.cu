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
// launch, against ~1.5 GB of edges and output.  Two routes, by the row's
// loads (units = F / VEC; VEC = 4, 16-byte float4 loads, when F is a
// multiple of 4 and x and out are 16-byte aligned, else scalar loads):
//
// The narrow route (units <= 32: F <= 128 in float4, F <= 32 in scalars):
//   * lane layout by F: a row's columns go to G lanes (G = units rounded
//     up to a power of two), and a warp holds 32 / G rows (F = 100: 25
//     lanes of one row; F = 16: 8 rows of 4 lanes);
//   * gathers in flight: a group loads B src/w entries of its row with
//     coalesced reads, then walks them in stages of D edges, issuing the
//     next stage's x loads before it adds the current stage; a zero
//     weight predicates its load off;
//   * the grid is as many blocks as the occupancy calculator fits on the
//     card (asked once per device and layout), each warp striding over row
//     groups.
//
// The wide route (units > 32: Equiformer-v2's message sums at F = 6,272,
// NequIP's at F = 288, and their transposes).  There a row is one to a
// few edges (a source is an edge id, so each x row is read once and the
// work streams), and walking a row's column passes in turn with padded
// edge batches left most gathers predicated off.  Instead:
//   * one lane a (row, load) of the output: a warp takes 32 consecutive
//     loads of the output in row-major order, so every lane is live at
//     every F (a warp may span two rows) and a row's column tiles run in
//     parallel warps (F = 6,272: 49 warps a row);
//   * real row lengths: a warp walks its rows' real edges, 32 sources and
//     weights loaded at once and handed out by shuffles, DW edges' x loads
//     in flight before their adds; a one-edge row costs one x load and one
//     store a lane, a chunk of masked edges its metadata load alone;
//   * a block's warps take consecutive tiles, so a row's src / w reads
//     are served from L1; out is written with cache-streaming stores;
//   * the grid comes from the occupancy calculator, as the narrow route's.

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
  static __device__ __forceinline__ void store_cs(T* p, T v) { __stcs(p, v); }
  static __device__ __forceinline__ T fma_rn(T acc, T v, float w) {
    return __fadd_rn(acc, __fmul_rn(v, w));
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ void store_cs(T* p, T v) { __stcs(p, v); }
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

// The narrow route's kernel.  VEC: floats per load; G: lanes per row (a
// power of two, <= 32); CH: loads per lane and edge (a pass covers
// G * CH * VEC columns).  Its launches take CH = 1: a row of at most 32
// loads is one pass, and wider rows take the wide route.
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

// The wide route's kernel: lane l of tile t owns load u of row r, where
// r * units + u = t * 32 + l.  Since units > 32, a tile's lanes lie in one
// row or two; the warp walks each of its rows in turn, loading 32 of the
// row's sources and weights at once (a lane each, coalesced), and hands
// them out DW at a time by shuffles: each lane of that row issues its DW
// x loads, then adds them in CSR order from 0.  A 32-edge chunk of weight
// 0 (GNN sum plans park masked edges in one waste row) costs its metadata
// load alone.  The sum is streamed out.
template <int VEC, int DW>
__global__ void __launch_bounds__(kThreads)
segment_spmm_wide_kernel(const int* __restrict__ row_ptr, const int* __restrict__ src,
                         const float* __restrict__ w, const float* __restrict__ x,
                         float* __restrict__ out, int n_rows, int F) {
  using V = Vec<VEC>;
  using T = typename V::T;
  static_assert(32 % DW == 0, "a chunk of 32 edges is whole batches");
  const int lane = threadIdx.x & 31;
  const int units = F / VEC;
  const long long total = static_cast<long long>(n_rows) * units;
  const long long tiles = (total + 31) / 32;
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;

  for (long long t = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
       t < tiles; t += stride) {
    const long long first = t * 32;
    const int r0 = static_cast<int>(first / units);  // one division a tile
    const int u0 = static_cast<int>(first - static_cast<long long>(r0) * units);
    const bool live = first + lane < total;           // the last tile's tail is not
    const bool wraps = u0 + lane >= units;            // this lane is in row r0 + 1
    const int u = wraps ? u0 + lane - units : u0 + lane;
    const int rows = (u0 + 31 >= units && r0 + 1 < n_rows) ? 2 : 1;
    T acc = V::zero();
    for (int part = 0; part < rows; ++part) {         // warp-uniform
      const int r = r0 + part;
      const bool mine = live && wraps == (part == 1);
      const int beg = __ldg(row_ptr + r);
      const int end = __ldg(row_ptr + r + 1);
      for (int base = beg; base < end; base += 32) {
        int s_l = 0;
        float w_l = 0.f;                              // past the row: weight 0
        if (base + lane < end) {
          s_l = __ldg(src + base + lane);
          w_l = __ldg(w + base + lane);
        }
        if (__ballot_sync(kFull, w_l != 0.f) == 0u) continue;
        const int m = end - base < 32 ? end - base : 32;
        for (int j0 = 0; j0 < m; j0 += DW) {
          int s_r[DW];
          float w_r[DW];
          T v[DW];
#pragma unroll
          for (int d = 0; d < DW; ++d) {
            s_r[d] = __shfl_sync(kFull, s_l, j0 + d);
            w_r[d] = __shfl_sync(kFull, w_l, j0 + d);
          }
#pragma unroll
          for (int d = 0; d < DW; ++d) {
            v[d] = V::zero();
            if (mine && w_r[d] != 0.f)
              v[d] = V::load(xv + static_cast<size_t>(s_r[d]) * units + u);
          }
#pragma unroll
          for (int d = 0; d < DW; ++d)
            if (mine && w_r[d] != 0.f) acc = V::fma_rn(acc, v[d], w_r[d]);
        }
      }
    }
    if (live) V::store_cs(ov + first + lane, acc);
  }
}

// Blocks of ``kernel`` the card holds at once, per device: asked of the
// occupancy calculator once per device and kernel (``resident`` is the
// kernel's own table; 0 until asked, a race asks twice, same answer).
template <class K>
cudaError_t resident_blocks(K kernel, std::atomic<int> (&resident)[kMaxDevices], int& cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  cap = resident[dev].load(std::memory_order_relaxed);
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    resident[dev].store(cap, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <int VEC, int G, int CH>
cudaError_t launch(const int* row_ptr, const int* src, const float* w,
                   const float* x, float* out, int n_rows, int F,
                   cudaStream_t stream) {
  auto kernel = segment_spmm_kernel<VEC, G, CH>;
  static std::atomic<int> resident[kMaxDevices];
  int cap = 0;
  cudaError_t err = resident_blocks(kernel, resident, cap);
  if (err != cudaSuccess) return err;
  const long long rows_per_block = static_cast<long long>(kWarpsPerBlock) * (32 / G);
  const long long want = (n_rows + rows_per_block - 1) / rows_per_block;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  kernel<<<blocks, kThreads, 0, stream>>>(row_ptr, src, w, x, out, n_rows, F);
  return cudaGetLastError();
}

// DW: edges whose loads are in flight before their adds (16-byte loads: 4;
// scalar loads: 8).
template <int VEC, int DW>
cudaError_t launch_wide(const int* row_ptr, const int* src, const float* w,
                        const float* x, float* out, int n_rows, int F,
                        cudaStream_t stream) {
  auto kernel = segment_spmm_wide_kernel<VEC, DW>;
  static std::atomic<int> resident[kMaxDevices];
  int cap = 0;
  cudaError_t err = resident_blocks(kernel, resident, cap);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(n_rows) * (F / VEC) + 31) / 32;
  const long long want = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
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
  if (units > 32)   // the wide route
    return static_cast<int>(vec == 4 ? launch_wide<4, 4>(rp, sr, wt, xx, o, n_rows, F, st)
                                     : launch_wide<1, 8>(rp, sr, wt, xx, o, n_rows, F, st));
  int G = 1;
  while (G < units) G <<= 1;
  const cudaError_t err = vec == 4 ? launch_g<4, 1>(G, rp, sr, wt, xx, o, n_rows, F, st)
                                   : launch_g<1, 1>(G, rp, sr, wt, xx, o, n_rows, F, st);
  return static_cast<int>(err);
}
