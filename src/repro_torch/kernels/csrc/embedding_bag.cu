// embedding_bag — multi-hot embedding bag, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py:24
// (_bag_kernel, launched by embedding_bag_tiled).  It computes
//
//     out[b, :] = sum over slots h of table[ids[b, h], :]      (sum)
//     out[b, :] = (that sum) / H                                (mean)
//
// for a (V, d) float32 table and (B, H) int32 ids.  An id outside [0, V)
// adds nothing (the TPU kernel's one-hot count matrix matches no row for
// it); a repeated id counts once per occurrence.  The TPU kernel streamed
// the vocabulary through VMEM in tiles and formed count_matrix @ table_tile
// on the matrix unit, because random row gathers are slow there.  On Hopper
// a row gather is one coalesced 256-byte read at d = 64, so the kernel
// gathers rows directly: one warp owns one bag, walks its H slots in slot
// order, adds each row in registers and writes the output row once — no
// count matrix, no vocabulary sweep, no atomics.  Sums run in slot order
// from 0, so the result repeats bitwise and equals the plain version's.
//
// Lanes split the row: each lane owns VEC consecutive floats of every
// 32 * VEC columns (float2 at d = 64, float4 at d = 128, one float when d
// is odd or below 64).  Row offsets are 64-bit: dlrm-rm2's concatenated
// table has 33,762,577 rows, 2,160,804,928 floats at d = 64, past INT32_MAX.
//
// What bounds it on an H100: device memory.  A bag reads H ids (4 B each)
// and H rows (4d B each, fewer where rows repeat and stay in L1/L2) and
// writes one row: at serve_bulk (B = 262,144 requests x 26 fields, H = 8,
// d = 64) about 0.2 GB of ids and 1.7 GB of output, plus the distinct rows.
// Each slot is a dependent id -> row load; many warps in flight (8 blocks
// of 8 warps per SM) hide that latency.  Staging ids with cp.async, or
// several bags per warp at small d, is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSM = 8;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, T b) { a = __fadd_rn(a, b); }
  __device__ static void div(T& a, float h) { a = __fdiv_rn(a, h); }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void add(T& a, T b) {
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
  }
  __device__ static void div(T& a, float h) {
    a.x = __fdiv_rn(a.x, h);
    a.y = __fdiv_rn(a.y, h);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, T b) {
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
  __device__ static void div(T& a, float h) {
    a.x = __fdiv_rn(a.x, h);
    a.y = __fdiv_rn(a.y, h);
    a.z = __fdiv_rn(a.z, h);
    a.w = __fdiv_rn(a.w, h);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     float* __restrict__ out, long long V, int d, int B, int H,
                     int mean) {
  using V_ = Vec<VEC>;
  using VT = typename V_::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dv = d / VEC;  // vectors per row
  for (long long bag = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
       bag < B; bag += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const int* bag_ids = ids + bag * H;
    VT* out_row = reinterpret_cast<VT*>(out + bag * d);
    for (int c0 = 0; c0 < dv; c0 += 32) {
      const int c = c0 + lane;
      VT acc = V_::zero();
      for (int base = 0; base < H; base += 32) {
        // one coalesced load of up to 32 ids, then broadcast slot by slot
        const int id_lane = base + lane < H ? bag_ids[base + lane] : -1;
        const int cnt = min(32, H - base);
        for (int j = 0; j < cnt; ++j) {
          const int id = __shfl_sync(0xffffffffu, id_lane, j);
          if (id < 0 || id >= V) continue;  // warp-uniform: adds nothing
          if (c < dv) {
            const VT* row = reinterpret_cast<const VT*>(
                table + static_cast<size_t>(id) * static_cast<size_t>(d));
            V_::add(acc, __ldg(row + c));
          }
        }
      }
      if (c < dv) {
        if (mean) V_::div(acc, static_cast<float>(H));
        out_row[c] = acc;
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const float* table, const int* ids, float* out, long long V,
                   int d, int B, int H, int mean, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (static_cast<long long>(B) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * kBlocksPerSM;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  embedding_bag_kernel<VEC><<<blocks, kThreads, 0, stream>>>(
      table, ids, out, V, d, B, H, mean);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers (table and
// out contiguous, row-major); the stream is PyTorch's current stream.
// Returns the cudaError_t of the launch.
extern "C" int embedding_bag_launch(const void* table, const void* ids, void* out,
                                    long long V, int d, int B, int H, int mean,
                                    void* stream) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const auto* tb = static_cast<const float*>(table);
  const auto* id = static_cast<const int*>(ids);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto aligned = [&](int bytes) {
    return reinterpret_cast<uintptr_t>(table) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  cudaError_t err;
  if (d % 4 == 0 && d >= 128 && aligned(16))
    err = launch<4>(tb, id, o, V, d, B, H, mean, st);
  else if (d % 2 == 0 && d >= 64 && aligned(8))
    err = launch<2>(tb, id, o, V, d, B, H, mean, st);
  else
    err = launch<1>(tb, id, o, V, d, B, H, mean, st);
  return static_cast<int>(err);
}
