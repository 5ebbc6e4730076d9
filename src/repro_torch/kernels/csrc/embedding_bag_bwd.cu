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
// sorted scatter-add), bit for bit.  A row with no slot is 0.  No atomics.
//
// What bounds it on an H100: device memory, the dense gradient written
// once (8.6 GB at dlrm-rm2's 33,762,577 x 64 table, 2.6 ms at 3.35 TB/s),
// and beside it the longest row's chain of dependent adds: ids of small
// vocabularies repeat in most bags (at train_batch one row takes 362,536
// slots, about 0.8 ms of adds at four cycles each).  A row's sorted slots
// come in runs of equal bag (ClickLogPipeline repeats each field's id in
// all multi_hot slots, so a row's entries come in runs of 8); the wrapper
// lists the runs (run_of, run_bag, run_len).  The design:
//   * The long rows first and beside the dense write.  Rows past
//     long_slots (the wrapper's LONG_SLOTS, 32: hot rows cluster at the
//     start of each field's range, and tiles of consecutive rows would put
//     them on one warp) go to the long-row kernel, launched first, longest
//     first, as many persistent blocks as the card holds at once (tasks
//     dealt in turn, so the longest starts first); the rows kernel is its
//     programmatic dependent, so it starts as soon as every long-row block
//     has started and runs beside them (the two write disjoint rows and
//     read nothing the other writes).  Two launches and not one: the long
//     rows want a ring of shared memory and specialised warps, the dense
//     write no shared memory and many plain warps, and one kernel would
//     reserve the ring for every block.  Only block 0 of the rows kernel
//     waits for the long-row kernel before it exits, so what follows on the
//     stream sees both, and the other blocks come and go freely.
//   * One gather a run, in both kernels: g[bag] loaded once a run and
//     added run-length times, in order.  The adds are the same, so are the
//     bits.
//   * A long row's chain fed from a deep ring.  A long-row block is a
//     streamer warp (the row's runs from the run list, kRuns a stage, into
//     a ring of kMetaStages stages of run metadata), kGatherWarps gatherer
//     warps (each stage's g rows into a ring of kStages stages in shared
//     memory by cp.async, kStages - 1 stages ahead: one warp keeps too few
//     copies in flight, and cp.async.mbarrier.arrive or a bulk copy a row
//     stalled the issuing warp) and kLongCols / 32 consumer warps, a thread
//     a column, that add each run its length of times.  Stages hand over on
//     mbarriers (full: runs published; ready: rows landed; empty: stage
//     added).  The adds have no branch a run (a branch costs a warp tens of
//     cycles): a stage whose runs are all at most 1, 2, 4 or 8 long adds
//     each run that many times, the padding adds of -0.f exact identities,
//     and a stage of runs all that long adds no select at all; a longer run
//     takes a loop.  So the chain of adds, not the gathers, sets the pace.
//     Columns past kLongCols are further tasks of the same row (the order
//     within a column never changes).
//   * The dense write at the memory's pace.  A warp owns a tile of 32
//     consecutive rows (one tile, so hot tiles spread over many short-lived
//     blocks): one coalesced load of their row_ptr entries, 16-byte
//     streaming stores of 0 for the empty rows in passes of 32 / G rows,
//     then the named short rows, G lanes a row, their bags kTile at a time
//     and one gather a run.
// Row offsets are 64-bit.  The launcher returns any launch error.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// rows kernel
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;           // a named row's slots whose bags and gathers are in flight
// long-row kernel
constexpr int kLongCols = 64;                    // columns a task owns: a consumer thread each
constexpr int kConsumerWarps = kLongCols / 32;
constexpr int kGatherWarps = 4;                  // a warp's copies in flight are few: four warps
constexpr int kLongThreads = 32 * (1 + kGatherWarps + kConsumerWarps);   // warp 0 streams
constexpr int kRuns = 32;                        // runs a stage holds
constexpr int kStages = 8;                       // stages of gathered rows; kStages - 1 ahead
constexpr int kMetaStages = 2 * kStages;         // stages of runs: the streamer runs further ahead
constexpr int kMaxUnrolled = 8;                  // a stage's runs this long at most: branch-free adds
struct StageMeta {
  int n;              // runs in the stage: fewer than kRuns ends its task; -1 ends the block's
  int adds;           // adds a run on the branch-free path (1, 2, 4, kMaxUnrolled), or 0
  int exact;          // all kRuns runs are exactly `adds` long
  int c0, ncols;      // the task's columns
  long long row;      // the task's row
  int len[kRuns];     // each run's length
  int bag[kRuns];     // each run's bag
};
constexpr int kRingBytes = kStages * kRuns * kLongCols * 4;
constexpr int kLongSmem = kRingBytes + (2 * kMetaStages + kStages) * 8 +
                          kMetaStages * static_cast<int>(sizeof(StageMeta));
static_assert(sizeof(StageMeta) % 8 == 0, "stage metadata keeps the ring's 8-byte alignment");

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, T b) { a = __fadd_rn(a, b); }
  static __device__ __forceinline__ void store(T* p, T v) { __stcs(p, v); }
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
  static __device__ __forceinline__ void store(T* p, T v) { __stcs(p, v); }
};

// ---- rows kernel -------------------------------------------------------------

// G lanes a row (units = d / VEC columns of VEC floats, u = this lane's
// first); rows with more than long_slots slots are the long-row kernel's.
// Only block 0 waits, at its end, for a programmatic primary.
template <int VEC>
__global__ void __launch_bounds__(kThreads, 3)
bag_bwd_rows(const float* __restrict__ g, const int* __restrict__ row_ptr,
             const int* __restrict__ bag, float* __restrict__ out, long long V, int d, int G,
             int long_slots) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  const int units = d / VEC;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, gl = lane % G, per_pass = 32 / G;
  const T* gv = reinterpret_cast<const T*>(g);
  T* ov = reinterpret_cast<T*>(out);
  const long long r0 = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (r0 < V) {
    const bool in = r0 + lane < V;
    const int n = in ? row_ptr[r0 + lane + 1] - row_ptr[r0 + lane] : 0;
    const unsigned empty = __ballot_sync(kFull, in && n == 0);
    const unsigned named = __ballot_sync(kFull, in && n > 0 && n <= long_slots);
    // zeros: per_pass rows a pass, a group of G lanes a row
    for (int j = grp; j < 32; j += per_pass)
      if ((empty >> j) & 1u)
        for (int u = gl; u < units; u += G) V_::store(ov + (r0 + j) * units + u, V_::zero());
    // the named short rows: the group takes every per_pass-th, from its grp-th
    unsigned left = named;
    for (int i = 0; i < grp; ++i) left &= left - 1u;
    for (; left; ) {
      const int j = __ffs(left) - 1;
      for (int i = 0; i < per_pass; ++i) left &= left - 1u;
      const int e0 = row_ptr[r0 + j], e1 = row_ptr[r0 + j + 1];
      for (int u = gl; u < units; u += G) {
        T acc = V_::zero(), cur = V_::zero();
        int prev = -1;
        for (int e = e0; e < e1; e += kTile) {
          const int m = min(kTile, e1 - e);
          int bb[kTile];
#pragma unroll
          for (int i = 0; i < kTile; ++i) bb[i] = i < m ? bag[e + i] : -1;
          T vals[kTile];
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            if (i < m && bb[i] != (i == 0 ? prev : bb[i - 1]))
              vals[i] = gv[static_cast<long long>(bb[i]) * units + u];
#pragma unroll
          for (int i = 0; i < kTile; ++i) {
            if (i < m) {
              if (bb[i] != (i == 0 ? prev : bb[i - 1])) cur = vals[i];
              V_::add(acc, cur);
            }
          }
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            if (i == m - 1) prev = bb[i];
        }
        V_::store(ov + (r0 + j) * units + u, acc);
      }
    }
  }
  // behind the long-row kernel: this grid ends only after it has
  if (blockIdx.x == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---- long-row kernel ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits for the phase of the given parity; a wait past 4 s traps, so a
// broken pipeline ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
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
__device__ __forceinline__ void cp_async_wait() {   // all but the N newest groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Task t is row long_rows[t / n_cb] (the list ends at n_long or at its
// first negative entry), columns [c0, c0 + ncols) of column block t % n_cb.
struct Task {
  long long row;
  int c0, ncols;
};
__device__ __forceinline__ bool task_at(const int* __restrict__ long_rows, int n_long, int n_cb,
                                        int d, long long t, Task& task) {
  if (t >= static_cast<long long>(n_long) * n_cb) return false;
  const int row = long_rows[t / n_cb];
  if (row < 0) return false;
  task.row = row;
  task.c0 = static_cast<int>(t % n_cb) * kLongCols;
  task.ncols = min(kLongCols, d - task.c0);
  return true;
}

// the adds a run a stage takes on the branch-free path (0: the loop)
__device__ __forceinline__ int adds_for(int longest) {
  return longest <= 1 ? 1 : longest <= 2 ? 2 : longest <= 4 ? 4
       : longest <= kMaxUnrolled ? kMaxUnrolled : 0;
}

// The streamer warp: the block's tasks in turn, then a stage with n = -1.
// A task's runs are consecutive in the run list (run_of maps a slot to
// its run); each kRuns of them (the next stage's already in flight, a lane
// a run) it publishes as a stage: waits for the stage to be free, writes
// the runs, the task and the stage's adds a run (the smallest of 1, 2, 4,
// kMaxUnrolled that covers its longest run, else 0), and arrives on its
// full barrier.  A task ends with one stage of fewer than kRuns runs.
__device__ __forceinline__ void stream_runs(const int* __restrict__ row_ptr,
                                            const int* __restrict__ run_of,
                                            const int* __restrict__ run_bag,
                                            const int* __restrict__ run_len,
                                            const int* __restrict__ long_rows, int n_long, int d,
                                            uint64_t* full, uint64_t* empty, StageMeta* meta) {
  const int lane = threadIdx.x & 31;
  const int n_cb = (d + kLongCols - 1) / kLongCols;
  long long k = 0;
  // publish stage k: n runs (n < 0: the block's end), this lane's bag and length
  auto place = [&](int n, const Task& task, int b, int l) {
    const int s = static_cast<int>(k % kMetaStages);
    mbar_wait(&empty[s], static_cast<uint32_t>(((k / kMetaStages) & 1) ^ 1));
    if (lane < n) {
      meta[s].bag[lane] = b;
      meta[s].len[lane] = l;
    }
    const int longest = __reduce_max_sync(kFull, lane < n ? l : 0);
    const int shortest = __reduce_min_sync(kFull, lane < n ? l : 1 << 30);
    if (lane == 0) {
      const int adds = adds_for(longest);
      meta[s].n = n;
      meta[s].adds = adds;
      meta[s].exact = n == kRuns && shortest == longest && longest == adds;
      meta[s].row = task.row;
      meta[s].c0 = task.c0;
      meta[s].ncols = task.ncols;
    }
    __syncwarp();   // the lanes' runs before lane 0's (releasing) arrive
    if (lane == 0) mbar_arrive(&full[s]);
    ++k;
  };
  Task task{};
  for (long long t = blockIdx.x; task_at(long_rows, n_long, n_cb, d, t, task); t += gridDim.x) {
    const int e0 = row_ptr[task.row], e1 = row_ptr[task.row + 1];
    const int r_end = run_of[e1 - 1] + 1;
    int r0 = run_of[e0];
    auto fetch = [&](int r, int& b, int& l) {
      b = r + lane < r_end ? run_bag[r + lane] : 0;
      l = r + lane < r_end ? run_len[r + lane] : 0;
    };
    int b, l;
    fetch(r0, b, l);
    for (;; r0 += kRuns) {
      int nb, nl;
      fetch(r0 + kRuns, nb, nl);   // the next stage's, in flight
      const int n = min(kRuns, r_end - r0);
      place(n, task, b, l);
      if (n < kRuns) break;        // the task's last stage
      b = nb;
      l = nl;
    }
  }
  place(-1, task, 0, 0);
}

// A stage's n runs, ADDS adds each: run i adds its value len[i] times,
// then -0.f for the rest (x + -0.f is x for every float x under
// round-to-nearest, zeros and NaN included, so the bits are those of
// len[i] adds); EXACT: every run is ADDS long, no selects.  Straight-line
// code a block of 8 runs: the chain of adds at one add per FADD latency,
// the loads and selects beside it.
template <int ADDS, bool EXACT>
__device__ __forceinline__ void add_runs(float& acc, const float* vals, const int* len, int n) {
  for (int i0 = 0; i0 < n; i0 += 8) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + r;
      const float v = vals[i * kLongCols];
      const int l = EXACT ? ADDS : (i < n ? len[i] : 0);
#pragma unroll
      for (int j = 0; j < ADDS; ++j) acc = __fadd_rn(acc, j < l ? v : -0.f);
    }
  }
}

// The gatherer warps: each published stage's g rows into the ring of
// kStages stages by cp.async (lanes_per_run lanes a run, VEC floats a
// lane: two 64-column runs an instruction at float4; the stage's copy
// instructions dealt over kGatherWarps warps, since a warp keeps few in
// flight), a commit group a stage, kStages - 1 stages in flight; as each
// stage's copies land each warp tells the consumers on the stage's ready
// barrier.  A stage's slot is
// taken again once the consumers freed the stage kStages before.  After
// the block's end stage (n = -1) it tells the rest, the end included.
template <int VEC>
__device__ __forceinline__ void gather(const float* __restrict__ g, int d, float* ring,
                                       uint64_t* full, uint64_t* empty, uint64_t* ready,
                                       const StageMeta* meta) {
  const int lane = threadIdx.x & 31;
  const int first = lane + 32 * ((threadIdx.x >> 5) - 1);   // this warp's share of a stage
  for (long long u = 0;; ++u) {
    if (u >= kStages - 1) {           // stage u - kStages + 1 to the consumers first
      cp_async_wait<kStages - 2>();   // this lane's copies of it
      __syncwarp();                   // every lane's, before lane 0's (releasing) arrive
      if (lane == 0) mbar_arrive(&ready[(u - kStages + 1) % kStages]);
    }
    if (u >= kStages)   // the stage that held this slot has been added
      mbar_wait(&empty[(u - kStages) % kMetaStages],
                static_cast<uint32_t>(((u - kStages) / kMetaStages) & 1));
    const StageMeta& m = meta[u % kMetaStages];
    mbar_wait(&full[u % kMetaStages], static_cast<uint32_t>((u / kMetaStages) & 1));
    const int n = m.n;
    const int units = m.ncols / VEC;
    int shift = 0;       // log2 of the lanes a run: the power of 2 >= units, at most 32
    while ((1 << shift) < units && shift < 5) ++shift;
    float* rows = ring + static_cast<size_t>(u % kStages) * kRuns * kLongCols;
    for (int f = first; f < (max(n, 0) << shift); f += 32 * kGatherWarps) {
      const int r = f >> shift;
      const float* src = g + static_cast<long long>(m.bag[r]) * d + m.c0;
      for (int w = f & ((1 << shift) - 1); w < units; w += 1 << shift)
        cp_async<4 * VEC>(rows + r * kLongCols + VEC * w, src + VEC * w);
    }
    cp_async_commit();
    if (n < 0) {   // the block's end: the stages in flight, then the end itself
      cp_async_wait<0>();
      __syncwarp();
      if (lane == 0)
        for (long long x = u - kStages + 2 > 0 ? u - kStages + 2 : 0; x <= u; ++x)
          mbar_arrive(&ready[x % kStages]);
      return;
    }
  }
}

// The consumer threads, a column each: every stage as its rows land, each
// run added its length of times in slot order, the column's sum written
// after a task's last stage, each stage freed on its empty barrier, until
// the block's end stage.  A stage with a run past kMaxUnrolled takes the
// loop over its lengths.
__device__ __forceinline__ void consume(int d, const float* ring, uint64_t* empty,
                                        uint64_t* ready, const StageMeta* meta,
                                        float* __restrict__ out) {
  const int col = threadIdx.x - 32 * (1 + kGatherWarps);
  float acc = 0.f;
  for (long long t = 0;; ++t) {
    mbar_wait(&ready[t % kStages], static_cast<uint32_t>((t / kStages) & 1));
    const int s = static_cast<int>(t % kMetaStages);
    const StageMeta& m = meta[s];
    const int n = m.n;
    if (n < 0) return;
    if (col < m.ncols) {
      const float* vals = ring + static_cast<size_t>(t % kStages) * kRuns * kLongCols + col;
      if (m.exact) {
        switch (m.adds) {
          case 1: add_runs<1, true>(acc, vals, m.len, n); break;
          case 2: add_runs<2, true>(acc, vals, m.len, n); break;
          case 4: add_runs<4, true>(acc, vals, m.len, n); break;
          default: add_runs<kMaxUnrolled, true>(acc, vals, m.len, n);
        }
      } else {
        switch (m.adds) {
          case 1: add_runs<1, false>(acc, vals, m.len, n); break;
          case 2: add_runs<2, false>(acc, vals, m.len, n); break;
          case 4: add_runs<4, false>(acc, vals, m.len, n); break;
          case kMaxUnrolled: add_runs<kMaxUnrolled, false>(acc, vals, m.len, n); break;
          default:
            for (int i = 0; i < n; ++i) {
              const float v = vals[i * kLongCols];
              for (int j = m.len[i]; j > 0; --j) acc = __fadd_rn(acc, v);
            }
        }
      }
      if (n < kRuns) {   // the task's last stage
        out[m.row * d + m.c0 + col] = acc;
        acc = 0.f;
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kLongThreads)
bag_bwd_long(const float* __restrict__ g, const int* __restrict__ row_ptr,
             const int* __restrict__ run_of, const int* __restrict__ run_bag,
             const int* __restrict__ run_len, const int* __restrict__ long_rows, int n_long,
             float* __restrict__ out, int d) {
  // the rows kernel may launch at once (it reads nothing this one writes)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem4) + kRingBytes);
  uint64_t* empty = full + kMetaStages;
  uint64_t* ready = empty + kMetaStages;
  StageMeta* meta = reinterpret_cast<StageMeta*>(ready + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMetaStages; ++s) {
      mbar_init(&full[s], 1);                 // the streamer's lane 0
      mbar_init(&empty[s], kConsumerWarps);   // each consumer warp's lane 0
    }
    for (int s = 0; s < kStages; ++s) mbar_init(&ready[s], kGatherWarps);   // their lanes 0
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32)
    stream_runs(row_ptr, run_of, run_bag, run_len, long_rows, n_long, d, full, empty, meta);
  else if (threadIdx.x < 32 * (1 + kGatherWarps))
    gather<VEC>(g, d, ring, full, empty, ready, meta);
  else
    consume(d, ring, empty, ready, meta, out);
}

// Per device, asked once: how many long-row blocks it holds at once (its
// SMs times the blocks an SM holds), with the long-row kernel's shared
// memory attribute set.  0 until asked; a race asks twice.
constexpr int kMaxDevices = 64;
std::atomic<int> g_long_blocks[kMaxDevices];

cudaError_t long_blocks_of(int& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  blocks = g_long_blocks[dev].load(std::memory_order_relaxed);
  if (blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bag_bwd_long<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLongSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bag_bwd_long<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLongSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bag_bwd_long<4>, kLongThreads,
                                                        kLongSmem);
  if (err != cudaSuccess) return err;
  blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  g_long_blocks[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// Plain C entry point for ctypes.  g (B, d), out (V, d) float32, contiguous;
// row_ptr (V + 1) and bag (row_ptr[V]) int32 on the device; the slots' runs
// of equal bag within a row, int32: run_of (row_ptr[V]: each slot's run,
// runs numbered in slot order), run_bag and run_len (each run's bag and
// length); long_rows (n_long) int32: the rows with more than long_slots
// slots, longest first, ending at n_long or at the first negative entry
// (the wrapper pads a list of fixed size with -1); the long-row kernel
// writes them and the rows kernel skips every row past long_slots.  vec is
// 4 (float4: d % 4 == 0, g and out 16-byte aligned) or 1.  parts: 1 the
// long-row kernel alone, 2 the rows kernel alone (each leaves the other's
// rows unwritten: for timing), 3 both.  The stream is PyTorch's current
// stream.  Returns the cudaError_t of the launches.
extern "C" int embedding_bag_bwd_launch(const void* g, const void* row_ptr, const void* bag,
                                        const void* run_of, const void* run_bag,
                                        const void* run_len, const void* long_rows, int n_long,
                                        void* out, long long V, int d, int vec, int long_slots,
                                        int parts, void* stream) {
  if (V <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if ((vec != 1 && vec != 4) || d % vec != 0 || long_slots < 0 || n_long < 0 || parts < 1 ||
      parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* bg = static_cast<const int*>(bag);
  const auto* ro = static_cast<const int*>(run_of);
  const auto* rb = static_cast<const int*>(run_bag);
  const auto* rl = static_cast<const int*>(run_len);
  const auto* lr = static_cast<const int*>(long_rows);
  auto* of = static_cast<float*>(out);
  int cap = 0;
  cudaError_t err = long_blocks_of(cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool with_long = (parts & 1) && n_long > 0;
  if (with_long) {
    const long long tasks = static_cast<long long>(n_long) * ((d + kLongCols - 1) / kLongCols);
    const int blocks = static_cast<int>(tasks < cap ? tasks : cap);
    if (vec == 4)
      bag_bwd_long<4><<<blocks, kLongThreads, kLongSmem, st>>>(gf, rp, ro, rb, rl, lr, n_long,
                                                               of, d);
    else
      bag_bwd_long<1><<<blocks, kLongThreads, kLongSmem, st>>>(gf, rp, ro, rb, rl, lr, n_long,
                                                               of, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(parts & 2)) return static_cast<int>(cudaSuccess);
  const int units = d / vec;
  int G = 1;
  while (G < units && G < 32) G *= 2;
  const long long tiles = (V + 31) / 32;   // a warp a tile of 32 rows
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // behind the long-row kernel the rows kernel may start while it runs
  // (programmatic dependent launch: the two write disjoint rows); its
  // block 0 waits for it before it exits.  Without it, an ordinary launch.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = with_long ? 1 : 0;
  if (vec == 4)
    err = cudaLaunchKernelEx(&cfg, bag_bwd_rows<4>, gf, rp, bg, of, V, d, G, long_slots);
  else
    err = cudaLaunchKernelEx(&cfg, bag_bwd_rows<1>, gf, rp, bg, of, V, d, G, long_slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
