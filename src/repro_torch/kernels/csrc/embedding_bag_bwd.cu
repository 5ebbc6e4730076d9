// embedding_bag_bwd — the table's gradient of the multi-hot embedding bag,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes no backward for
// src/repro/kernels/embedding_bag/kernel.py:24 (_bag_kernel) and takes the
// table's gradient with jax.value_and_grad through its jnp embedding_bag
// (src/repro/models/dlrm.py:36).  This kernel stands in for that device
// work on the card.
//
// For g (B, d) float32 (each bag's output gradient, already divided by H
// for the mean) and the id-sorted CSR of the bag's valid slots (row_ptr
// (V + 1), and bag (E): the bag of each slot, in slot order within a row;
// made by a stable sort before the launch), it writes the dense (V, d)
// gradient
//
//     out[r, :] = sum over the CSR row r, in order and from 0, of g[bag[e], :]
//
// with __fadd_rn, one add a slot: the plain version's rounding (the port's
// sorted scatter-add), bit for bit.  A row with no slot is 0.
//
// What bounds it on an H100: device memory, the dense gradient written
// once (8.6 GB at dlrm-rm2's 33,762,577 x 64 table, 2.6 ms), and the
// longest row's chain of adds: ids of small vocabularies repeat in most
// bags (at train_batch one row takes 362,536 slots), and its adds follow
// one another.  Two kernels, each row written by exactly one of them:
//   * rows: a group of lanes per row (d / VEC lanes of VEC floats, 16-byte
//     float4 when d % 4 == 0 and g and out are 16-byte aligned; at most 32
//     lanes, in passes over wider rows), consecutive rows on consecutive
//     groups so a warp's stores are contiguous; a row's slots go in tiles
//     of kTile, all their gathers issued before the adds.  Rows longer than
//     long_slots (the wrapper's LONG_SLOTS) are left to
//   * long rows: a block per long row (and per kLongCols columns), whose
//     256 threads stage the row's gathered g rows chunk by chunk into
//     shared memory with cp.async (two chunks in flight), while one thread
//     per column adds the chunk before in slot order.  The chain of adds
//     then runs from shared memory, and the gathers of a whole chunk are in
//     flight at once, instead of a tile of kTile at a time.
// Row offsets are 64-bit.  The launcher returns any launch error.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;           // slots whose gathers are in flight at once (rows kernel)
constexpr int kChunk = 128;        // slots a long-row chunk stages
constexpr int kLongCols = 128;     // columns a long-row block owns
constexpr int kBlocks = 4096;      // rows kernel: blocks striding over the rows

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, T b) { a = __fadd_rn(a, b); }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
};

// G lanes a row; VEC floats a lane; rows with more than long_slots slots
// are skipped (the long-row kernel writes them)
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_bwd_rows(const float* __restrict__ g, const int* __restrict__ row_ptr,
             const int* __restrict__ bag, float* __restrict__ out, long long V, int d, int G,
             int long_slots) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  const int units = d / VEC;                     // VEC-wide columns a row
  const long long groups = static_cast<long long>(gridDim.x) * (kThreads / G);
  const long long gid = static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const T* gv = reinterpret_cast<const T*>(g);
  T* ov = reinterpret_cast<T*>(out);
  for (long long row = gid; row < V; row += groups) {
    const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
    if (e1 - e0 > long_slots) continue;
    for (int u = lane; u < units; u += G) {
      T acc = V_::zero();
      for (int e = e0; e < e1; e += kTile) {
        const int n = min(kTile, e1 - e);
        T vals[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (i < n) vals[i] = gv[static_cast<long long>(bag[e + i]) * units + u];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (i < n) V_::add(acc, vals[i]);
      }
      ov[row * units + u] = acc;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slots [e, e + n) of a long row, columns [c0, c0 + ncols), into buf
// (n rows of ncols floats), VEC floats a copy
template <int VEC>
__device__ __forceinline__ void stage_chunk(float* buf, const float* __restrict__ g,
                                            const int* __restrict__ bag, int e, int n, int d,
                                            int c0, int ncols) {
  const int units = ncols / VEC;
  for (int idx = threadIdx.x; idx < n * units; idx += kThreads) {
    const int s = idx / units, u = idx % units;
    const float* src = g + static_cast<long long>(bag[e + s]) * d + c0 + VEC * u;
    cp_async<4 * VEC>(buf + s * ncols + VEC * u, src);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_bwd_long(const float* __restrict__ g, const int* __restrict__ row_ptr,
             const int* __restrict__ bag, const int* __restrict__ long_rows,
             float* __restrict__ out, int d) {
  extern __shared__ float4 smem4[];   // two chunks of kChunk x ncols floats
  const long long row = long_rows[blockIdx.x];
  const int c0 = blockIdx.y * kLongCols;
  const int ncols = min(kLongCols, d - c0);
  float* const base = reinterpret_cast<float*>(smem4);
  const int stride = kChunk * ncols;   // chunk k lives at base + (k & 1) * stride
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  const int n_chunks = (e1 - e0 + kChunk - 1) / kChunk;
  const int col = threadIdx.x;
  float acc = 0.f;

  stage_chunk<VEC>(base, g, bag, e0, min(kChunk, e1 - e0), d, c0, ncols);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int e = e0 + k * kChunk;
    if (k + 1 < n_chunks) {   // the next chunk into the other buffer
      stage_chunk<VEC>(base + ((k + 1) & 1) * stride, g, bag, e + kChunk,
                       min(kChunk, e1 - e - kChunk), d, c0, ncols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();          // every thread's part of chunk k has landed
    if (col < ncols) {
      const float* b = base + (k & 1) * stride + col;
      const int n = min(kChunk, e1 - e);
      for (int s = 0; s < n; ++s) acc = __fadd_rn(acc, b[s * ncols]);
    }
    __syncthreads();          // chunk k is read before its buffer is refilled
  }
  if (col < ncols) out[row * d + c0 + col] = acc;
}

}  // namespace

// Plain C entry point for ctypes.  g (B, d), out (V, d) float32, contiguous;
// row_ptr (V + 1) and bag (row_ptr[V]) int32 on the device; long_rows
// (n_long) int32: the rows with more than long_slots slots (longest first:
// they start first), which the long-row kernel writes and the rows kernel
// skips.  vec is 4 (float4: d % 4 == 0, g and out 16-byte aligned) or 1.
// The stream is PyTorch's current stream.  Returns the cudaError_t of the
// launches.
extern "C" int embedding_bag_bwd_launch(const void* g, const void* row_ptr, const void* bag,
                                        const void* long_rows, int n_long, void* out,
                                        long long V, int d, int vec, int long_slots,
                                        void* stream) {
  if (V <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if ((vec != 1 && vec != 4) || d % vec != 0 || long_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* bg = static_cast<const int*>(bag);
  auto* of = static_cast<float*>(out);
  const int units = d / vec;
  int G = 1;
  while (G < units && G < 32) G *= 2;
  const long long want = (V + kThreads / G - 1) / (kThreads / G);
  const long long blocks = want < kBlocks ? want : kBlocks;
  if (vec == 4)
    bag_bwd_rows<4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(gf, rp, bg, of, V, d, G,
                                                                       long_slots);
  else
    bag_bwd_rows<1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(gf, rp, bg, of, V, d, G,
                                                                       long_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long == 0) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_long),
                  static_cast<unsigned>((d + kLongCols - 1) / kLongCols));
  const int smem = 2 * kChunk * (d < kLongCols ? d : kLongCols) * 4;
  const auto* lr = static_cast<const int*>(long_rows);
  auto kernel = vec == 4 ? bag_bwd_long<4> : bag_bwd_long<1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(gf, rp, bg, lr, of, d);
  return static_cast<int>(cudaGetLastError());
}
