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
// a row gather is one coalesced read, so the kernel gathers rows directly:
// one group of lanes owns one bag and writes its output row once — no count
// matrix, no vocabulary sweep, no atomics.
//
// Order contract.  Each output element is summed in slot order from 0 with
// __fadd_rn, one add per slot (an invalid slot adds +0, which leaves the sum
// as it is, as the plain version's torch.where does), and `mean` divides by
// H with __fdiv_rn: the plain version's rounding, bit for bit.  A row that
// fills all H slots is added H times, never scaled.
//
// What bounds it on an H100: device memory.  A bag reads H ids (4 B each)
// and its rows, and writes one row of 4d bytes.  At serve_bulk (6,815,744
// bags, H = 8, d = 64, each field's id in all eight slots) that is 0.22 GB
// of ids, 0.42 GB of distinct rows and 1.74 GB of output: the output
// dominates.  What the design does about it:
//   * lane groups: a row's columns go to G lanes of VEC floats (16-byte
//     float4 when d % 4 == 0 and both table and out are 16-byte aligned,
//     else float2 or float; G = d / VEC rounded up to a power of two, at
//     most 32, in passes over wider rows), and a warp holds 32 / G bags
//     (d = 64: two bags of 16 lanes; d = 128: one of 32), consecutive, so
//     a warp's output rows are one contiguous store;
//   * gathers in flight: a bag's slots go in tiles of kTile = 8.  Each
//     lane loads the tile's ids itself (two 16-byte loads when H % 4 == 0
//     and ids are 16-byte aligned, else one load a slot; the group's lanes
//     read the same addresses, one request), not allocated in L1, then
//     issues all eight row gathers, predicated on the id being in [0, V),
//     before the first add; a slot whose id repeats the slot before it
//     reuses that row's registers instead of loading it again (it is still
//     added: eight adds of x in slot order are not 8 x).  While the rows
//     are in flight the warp already loads the ids of its next bag group,
//     so an id load and a row load never wait on each other.  The previous
//     kernel walked the slots one dependent id -> row -> add at a time;
//   * streaming stores (st.global.cs) for the output, which is written
//     once and read by the next layer, so it does not evict table rows
//     that later bags read again from the 50 MB L2;
//   * the grid is as many blocks as the occupancy calculator fits on the
//     card (asked once per device and layout), each warp striding over bag
//     groups.
// Row offsets are 64-bit: dlrm-rm2's concatenated table has 33,762,577
// rows, 2,160,804,928 floats at d = 64, past INT32_MAX.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;          // slots whose gathers are in flight at once
constexpr int kMaxDevices = 64;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, T b) { a = __fadd_rn(a, b); }
  static __device__ __forceinline__ void div(T& a, float h) { a = __fdiv_rn(a, h); }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
  }
  static __device__ __forceinline__ void div(T& a, float h) {
    a.x = __fdiv_rn(a.x, h);
    a.y = __fdiv_rn(a.y, h);
  }
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
  static __device__ __forceinline__ void div(T& a, float h) {
    a.x = __fdiv_rn(a.x, h);
    a.y = __fdiv_rn(a.y, h);
    a.z = __fdiv_rn(a.z, h);
    a.w = __fdiv_rn(a.w, h);
  }
};

// ids: read once, so not allocated in L1
__device__ __forceinline__ int4 load_ids4(const int* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ int load_id(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// one tile's ids of a bag: slot j is id base + j, or -1 past H (or when the
// bag is past B)
__device__ __forceinline__ void tile_ids(int (&id)[kTile], const int* bag_ids, int base,
                                         int H, bool live, bool ids4) {
  if (ids4) {
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      int4 v = make_int4(-1, -1, -1, -1);
      if (live && base + 4 * q < H) v = load_ids4(bag_ids + base + 4 * q);
      id[4 * q] = v.x;
      id[4 * q + 1] = v.y;
      id[4 * q + 2] = v.z;
      id[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      id[j] = live && base + j < H ? load_id(bag_ids + base + j) : -1;
  }
}

template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     float* __restrict__ out, long long V, int d, int B, int H,
                     int mean, int ids4) {
  using V_ = Vec<VEC>;
  using VT = typename V_::T;
  constexpr int kBagsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int group = lane / G, gl = lane % G;
  const int dv = d / VEC;   // vectors per row
  const int tiles = (H + kTile - 1) / kTile;
  const int passes = (dv + G - 1) / G;
  const long long groups = (static_cast<long long>(B) + kBagsPerWarp - 1) / kBagsPerWarp;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const VT* tab = reinterpret_cast<const VT*>(table);
  // The warp's work items, in order: bag group grp (grp = warp, warp +
  // warps, ...), pass over the row's columns, slot tile.  The next item's
  // ids are loaded while this item's rows are in flight.
  long long grp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  int pass = 0, tile = 0;
  int id[kTile];
  if (grp < groups) {
    const long long bag = grp * kBagsPerWarp + group;
    tile_ids(id, ids + bag * H, 0, H, bag < B, ids4 != 0);
  }
  VT acc = V_::zero();
  while (grp < groups) {
    const long long bag = grp * kBagsPerWarp + group;
    const int c = pass * G + gl;
    const bool col = bag < B && c < dv;
    const int this_tile = tile;
    // every gather of the tile first; a slot whose id repeats the slot
    // before it takes that slot's row (no second load of the same row)
    uint32_t repeat = 0;
    VT row[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j > 0 && id[j] == id[j - 1]) repeat |= 1u << j;
      row[j] = V_::zero();
      if (col && !((repeat >> j) & 1u) && id[j] >= 0 && id[j] < V)
        row[j] = __ldg(tab + static_cast<long long>(id[j]) * dv + c);
    }
    // the next item, and its ids
    if (++tile == tiles) {
      tile = 0;
      if (++pass == passes) {
        pass = 0;
        grp += warps;
      }
    }
    if (grp < groups) {
      const long long next = grp * kBagsPerWarp + group;
      tile_ids(id, ids + next * H, tile * kTile, H, next < B, ids4 != 0);
    }
    // then the adds, in slot order
    if (this_tile == 0) acc = V_::zero();
    VT cur = V_::zero();
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (!((repeat >> j) & 1u)) cur = row[j];
      V_::add(acc, cur);
    }
    if (this_tile == tiles - 1 && col) {
      if (mean) V_::div(acc, static_cast<float>(H));
      __stcs(reinterpret_cast<VT*>(out + bag * d) + c, acc);
    }
  }
}

template <int VEC, int G>
cudaError_t launch(const float* table, const int* ids, float* out, long long V, int d,
                   int B, int H, int mean, int ids4, cudaStream_t stream) {
  auto kernel = embedding_bag_kernel<VEC, G>;
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
  const long long bags_per_block = (kThreads / 32) * (32 / G);
  const long long want = (B + bags_per_block - 1) / bags_per_block;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  kernel<<<blocks, kThreads, 0, stream>>>(table, ids, out, V, d, B, H, mean, ids4);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_g(int G, const float* t, const int* i, float* o, long long V, int d,
                     int B, int H, int mean, int ids4, cudaStream_t st) {
  switch (G) {
    case 1: return launch<VEC, 1>(t, i, o, V, d, B, H, mean, ids4, st);
    case 2: return launch<VEC, 2>(t, i, o, V, d, B, H, mean, ids4, st);
    case 4: return launch<VEC, 4>(t, i, o, V, d, B, H, mean, ids4, st);
    case 8: return launch<VEC, 8>(t, i, o, V, d, B, H, mean, ids4, st);
    case 16: return launch<VEC, 16>(t, i, o, V, d, B, H, mean, ids4, st);
    default: return launch<VEC, 32>(t, i, o, V, d, B, H, mean, ids4, st);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers (table, ids
// and out contiguous, row-major); the stream is PyTorch's current stream.
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
    return reinterpret_cast<std::uintptr_t>(table) % bytes == 0 &&
           reinterpret_cast<std::uintptr_t>(out) % bytes == 0;
  };
  const int vec = d % 4 == 0 && aligned(16) ? 4 : d % 2 == 0 && aligned(8) ? 2 : 1;
  const int ids4 = H % 4 == 0 && reinterpret_cast<std::uintptr_t>(ids) % 16 == 0;
  const int units = d / vec;
  int G = 1;
  while (G < units && G < 32) G <<= 1;
  cudaError_t err;
  if (vec == 4)
    err = launch_g<4>(G, tb, id, o, V, d, B, H, mean, ids4, st);
  else if (vec == 2)
    err = launch_g<2>(G, tb, id, o, V, d, B, H, mean, ids4, st);
  else
    err = launch_g<1>(G, tb, id, o, V, d, B, H, mean, ids4, st);
  return static_cast<int>(err);
}
