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
// the TPU's sequential grid; here every output element is summed by one
// lane and written once, with no atomics.
//
// T comes in its column form.  A trie transition T[l][p, c] = cond_p(c) iff
// c = child(p, l) has at most one nonzero per column, so per (label, column)
// the caller passes the nonzero's row, par[l, c] = parent(c), and value,
// val[l, c] = cond_p(c) (any row and 0 where the column is empty).  The
// dense product alpha[src] @ T[l] then reduces to one gather and one
// multiply per lane: acc_c = alpha[src, par[l, c]] * val[l, c].
//
// Order contract.  Per edge, lane c forms round(acc_c), then the message
// round(acc_c * w_e), then adds it to the row sum in CSR order (ascending
// source id within the row), from 0.  So every message and every row sum is
// rounded as in the reference field (per-edge product, scale, sequential
// scatter-add in edge order), and the kernel agrees bitwise with the plain
// version on the CPU.  The explicit __fmul_rn / __fadd_rn keep nvcc from
// contracting the scale and the add into one fma.  Edges of weight 0 add
// nothing: for finite alpha they would add exactly 0.  Only the gathers of
// a row are split or run ahead; its adds never are.
//
// What bounds it on an H100: latency and instruction issue, then device
// memory.  A row is a chain of dependent loads (row_ptr -> src/w -> the
// alpha gather); at the paper's ProvGen scale a row has 5.5 edges, and a
// skewed graph's early rows hold thousands.  Each step reads src and w (8 B
// per edge), gathers one alpha row (4N B) per local edge and writes out (4N
// B per vertex).  The CSR's row plan (segment_spmm/ops.py::row_plan, made
// once with the CSR) cuts the rows into runs of at most 32 rows and about
// 256 edges, and lists the long rows (more than 256 edges), each a run of
// its own that starts at ~row, so the warps know to skip it.  Two kernels:
//   * short rows: a warp owns one run and one block of 32 trie columns
//     (lane c, column c) and walks the run's edges as one stream, in
//     windows of 64 edges whatever the row lengths; the next window's
//     src/w and the next run's row_ptr are in flight while this one is
//     summed.  Each lane finds its edge's row by a binary search over the
//     run's row starts (warp shuffles).  A window's live edges (weight !=
//     0) are compacted into shared memory in CSR order, and taken in rounds
//     of kRound: the next round's gathers alpha[s * N + par[l, c]] are
//     issued before this round's adds.  The rounds are straight-line code
//     (predicates, no branches), so nvcc schedules them as one block.  A
//     row's sum is stored when the next row's first live edge comes; rows
//     no live edge reached write 0.  par/val sit in shared memory when
//     L * N * 8 B fits kTableSmemBytes (the provgen trie's 23 nodes), else
//     they are read through L1 (the row placement's 677).  Registers are
//     what bounds the warps in flight, so the windows are short and the
//     rounds 4 edges (48 registers: 40 warps an SM).
//   * long rows: one block per (long row, column block), longest first.
//     Seven warps form the messages of 32-edge slices of a 224-edge chunk
//     into shared memory, only the live ones, compacted, while the eighth
//     adds the previous chunk in CSR order (double-buffered); src/w come
//     kAhead chunks ahead through cp.async.  The placement's 6,889-edge hub
//     row so no longer costs 22 warps a serial walk each.
//   The long-row kernel goes first, when there are long rows; the short-row
//   kernel is then launched as its programmatic dependent, so it starts at
//   once and runs beside it (the two write disjoint rows and read nothing
//   the other writes), and waits for it only before it exits.  Without long
//   rows the short-row kernel is an ordinary launch.  Both grids come from
//   the occupancy calculator, asked once per device.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kSub = 2;                       // 32-edge batches per window
constexpr int kShortBlocksPerSM = 5;          // registers for 40 warps an SM
constexpr int kRound = 4;                     // live edges' gathers per round
constexpr int kTableSmemBytes = 16 * 1024;    // par/val in shared memory up to this
constexpr int kLongWarps = 8;                 // one adder and seven gatherers
constexpr int kLongThreads = kLongWarps * 32;
constexpr int kChunk = (kLongWarps - 1) * 32; // edges a long-row chunk
constexpr int kAhead = 4;                     // chunks of src/w in flight
constexpr int kLongSmemBytes = 2 * kChunk * 32 * static_cast<int>(sizeof(float));

// A store that only a predicate guards: no branch, so the rounds below
// stay one basic block that nvcc can schedule as a whole.
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.global.f32 [%0], %1;\n\t}"
               :: "l"(p), "f"(v), "r"(static_cast<unsigned>(pred)) : "memory");
}

// TABLE_IN_SMEM: par/val copied to shared memory (L * N * 8 B within
// kTableSmemBytes), else read through L1.
template <bool TABLE_IN_SMEM>
__global__ void __launch_bounds__(kThreads, kShortBlocksPerSM)
vm_step_short(const int* __restrict__ row_ptr, const int* __restrict__ src,
              const float* __restrict__ w, const int* __restrict__ row_label,
              const float* __restrict__ alpha, const int* __restrict__ par,
              const float* __restrict__ val, float* __restrict__ out,
              const int* __restrict__ runs, int n_runs, int N, int LN) {
  extern __shared__ int s_table[];                   // [LN] par, then [LN] val
  // per warp: a window's live edges (src * N, w, local row, label * N), and
  // room for the predicated-off reads past them
  __shared__ int4 s_edge[kWarpsPerBlock][kSub * 32 + 2 * kRound];
  const int* par_t = par;
  const float* val_t = val;
  if (TABLE_IN_SMEM) {
    for (int i = threadIdx.x; i < LN; i += blockDim.x) {
      s_table[i] = par[i];
      s_table[LN + i] = __float_as_int(val[i]);
    }
    __syncthreads();
    par_t = s_table;
    val_t = reinterpret_cast<const float*>(s_table + LN);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int4* slots = s_edge[warp];
  // every slot holds a valid edge (or zeros), so the rounds may read past
  // a window's live edges unguarded
  for (int i = lane; i < kSub * 32 + 2 * kRound; i += 32) slots[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  const int n_blk = (N + 31) / 32;
  const int tasks = n_runs * n_blk;           // the launcher keeps it below 2^30
  const int stride = gridDim.x * kWarpsPerBlock;
  // lane i describes row r0 + i of a task's run (beg INT_MAX past the run);
  // a long row's run (stored as ~row) gets nr = 0: the other kernel sums
  // it.  The next task's rows are loaded while this one runs.
  auto load_run = [&](int t, int& r0, int& nr, int& beg, int& end, int& lab) {
    r0 = 0, nr = 0, beg = INT_MAX, end = INT_MAX, lab = 0;
    if (t >= tasks) return;
    const int run = t / n_blk;
    const int first = __ldg(runs + run);
    const int next = __ldg(runs + run + 1);
    r0 = first < 0 ? ~first : first;
    nr = first < 0 ? 0 : (next < 0 ? ~next : next) - r0;
    if (lane < nr) {
      beg = __ldg(row_ptr + r0 + lane);
      end = __ldg(row_ptr + r0 + lane + 1);
      lab = __ldg(row_label + r0 + lane);
    }
  };
  int task = blockIdx.x * kWarpsPerBlock + warp;
  int r0, nr, beg_l, end_l, lab_l;
  load_run(task, r0, nr, beg_l, end_l, lab_l);
  for (; task < tasks; task += stride) {
    int nr0, nnr, nbeg, nend, nlab;
    load_run(task + stride, nr0, nnr, nbeg, nend, nlab);
    const int c = (task % n_blk) * 32 + lane;
    const bool col = c < N;
    const int cc = col ? c : N - 1;  // lanes past N repeat the last column, unstored
    float* out_run = out + static_cast<size_t>(r0) * N + c;   // the run's column c
    if (nr > 0) {
      const int e_beg = __shfl_sync(kFull, beg_l, 0);
      const int e_end = __shfl_sync(kFull, end_l, nr - 1);
      // the last row of the run that starts at or before edge e
      auto row_of = [&](int e) {
        int r = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(kFull, beg_l, r + step) <= e) r += step;
        return r;
      };
      // a window of kSub * 32 edges: every load in flight at once
      auto load_window = [&](int b, int (&s_i)[kSub], float (&w_i)[kSub], int (&r_i)[kSub]) {
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int e = b + 32 * i + lane;
          r_i[i] = row_of(e);
          s_i[i] = 0;
          w_i[i] = 0.f;
          if (e < e_end) {
            s_i[i] = __ldg(src + e);
            w_i[i] = __ldg(w + e);
          }
        }
      };
      unsigned written = 0;  // rows of the run that got a live edge
      int cur = -1;          // local row whose sum is open
      float sum = 0.f;
      // kRound live edges' gathers, issued together.  Straight-line code,
      // slots past cnt predicated off, so nvcc schedules every load of a
      // round ahead of its uses.
      auto gather = [&](int k0, int cnt, float (&v)[kRound]) {
#pragma unroll
        for (int k = 0; k < kRound; ++k) {
          const int4 ed = slots[k0 + k];
          v[k] = 0.f;
          if (k0 + k < cnt) v[k] = __ldg(alpha + (ed.x + par_t[ed.w + cc]));
        }
      };
      // ... and their adds, in CSR order; a row's sum is written when the
      // next row's first live edge comes
      auto add = [&](int k0, int cnt, const float (&v)[kRound]) {
#pragma unroll
        for (int k = 0; k < kRound; ++k) {
          const int4 ed = slots[k0 + k];
          const bool live = k0 + k < cnt;
          const bool fresh = live && ed.z != cur;
          store_if(out_run + (cur & 31) * N, sum, fresh && cur >= 0 && col);
          sum = fresh ? 0.f : sum;
          cur = fresh ? ed.z : cur;
          const float acc = __fmul_rn(v[k], val_t[ed.w + cc]);
          const float next = __fadd_rn(sum, __fmul_rn(acc, __int_as_float(ed.y)));
          sum = live ? next : sum;
        }
      };
      int base = e_beg;
      int s_c[kSub], r_c[kSub];
      float w_c[kSub];
      if (base < e_end) load_window(base, s_c, w_c, r_c);
      while (base < e_end) {
        // the next window's edges are in flight while this one is summed
        const int next = base + 32 * kSub;
        int s_n[kSub], r_n[kSub];
        float w_n[kSub];
        if (next < e_end) load_window(next, s_n, w_n, r_n);
        // the window's live edges (weight != 0), compacted in CSR order
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int lab_n = __shfl_sync(kFull, lab_l, r_c[i]) * N;
          const unsigned live = __ballot_sync(kFull, w_c[i] != 0.f);
          if (w_c[i] != 0.f)
            slots[cnt + __popc(live & ((1u << lane) - 1u))] =
                make_int4(s_c[i] * N, __float_as_int(w_c[i]), r_c[i], lab_n);
          cnt += __popc(live);
          written |= __reduce_or_sync(kFull, w_c[i] != 0.f ? 1u << r_c[i] : 0u);
        }
        __syncwarp();
        // rounds of kRound live edges, the next round's gathers issued
        // before this round's adds
        float va[kRound], vb[kRound];
        gather(0, cnt, va);
        for (int k0 = 0; k0 < cnt; k0 += 2 * kRound) {
          gather(k0 + kRound, cnt, vb);
          add(k0, cnt, va);
          gather(k0 + 2 * kRound, cnt, va);
          add(k0 + kRound, cnt, vb);
        }
        __syncwarp();      // the slots are read before the next window fills them
        base = next;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          s_c[i] = s_n[i];
          w_c[i] = w_n[i];
          r_c[i] = r_n[i];
        }
      }
      store_if(out_run + (cur & 31) * N, sum, cur >= 0 && col);
      // rows of the run no live edge reached (no edges, or only cut ones): 0
      const unsigned zero = (nr == 32 ? kFull : (1u << nr) - 1u) & ~written;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        store_if(out_run + i * N, 0.f, (zero >> i) & 1u && col);
    }
    r0 = nr0;
    nr = nnr;
    beg_l = nbeg;
    end_l = nend;
    lab_l = nlab;
  }
  // when launched behind the long-row kernel, end only after it has (with
  // no programmatic primary this returns at once)
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The long-row kernel.  Gatherer warp g (1..7) owns slice g - 1 of each
// chunk, edges [beg + k * kChunk + 32 (g - 1), + 32); each lane copies its
// edge's src and w kAhead chunks ahead into a ring in shared memory with
// cp.async (one commit group per chunk), so no register waits on them.
__device__ __forceinline__ void long_prefetch(const int* __restrict__ src,
                                              const float* __restrict__ w, int beg,
                                              int end, int k, int* ring_s, float* ring_w) {
  const int slot = ((threadIdx.x >> 5) - 1) * 32 + (threadIdx.x & 31);
  const int e = beg + k * kChunk + slot;
  const int stage = (k % kAhead) * kChunk + slot;
  if (e < end) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n\t"
                 "cp.async.ca.shared.global [%2], [%3], 4;"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(ring_s + stage))),
                    "l"(src + e),
                    "r"(static_cast<unsigned>(__cvta_generic_to_shared(ring_w + stage))),
                    "l"(w + e) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// ... long_gather waits for chunk k's copies, takes the lane's edge (weight
// 0 past the row), refills the stage kAhead chunks on, and stores the
// messages round(round(alpha[s, p] * t) * w) of the slice's live edges
// (weight != 0), compacted in CSR order, and their count into buffer b:
// all 32 gathers first, then the products.
__device__ __forceinline__ void long_gather(const int* __restrict__ src,
                                            const float* __restrict__ w,
                                            const float* __restrict__ alpha, int N, int p,
                                            float t, bool col, int beg, int end, int k,
                                            int* ring_s, float* ring_w, float* s_msg,
                                            int (*s_cnt)[kLongWarps]) {
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int slot = (g - 1) * 32 + lane;
  asm volatile("cp.async.wait_group %0;" :: "n"(kAhead - 1) : "memory");
  const bool in_row = beg + k * kChunk + slot < end;
  const int s = in_row ? ring_s[(k % kAhead) * kChunk + slot] : 0;
  const float we = in_row ? ring_w[(k % kAhead) * kChunk + slot] : 0.f;
  long_prefetch(src, w, beg, end, k + kAhead, ring_s, ring_w);
  const int b = k & 1;
  const unsigned live = __ballot_sync(kFull, we != 0.f);
  if (lane == 0) s_cnt[b][g] = __popc(live);
  float v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int sj = __shfl_sync(kFull, s, j);
    v[j] = (live >> j) & 1u && col ? __ldg(alpha + static_cast<size_t>(sj) * N + p) : 0.f;
  }
  float* dst = s_msg + (static_cast<size_t>(b) * kChunk + (g - 1) * 32) * 32 + lane;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float wj = __shfl_sync(kFull, we, j);
    if ((live >> j) & 1u) dst[__popc(live & ((1u << j) - 1u)) * 32] = __fmul_rn(__fmul_rn(v[j], t), wj);
  }
}

__global__ void __launch_bounds__(kLongThreads)
vm_step_long(const int* __restrict__ row_ptr, const int* __restrict__ src,
             const float* __restrict__ w, const int* __restrict__ row_label,
             const float* __restrict__ alpha, const int* __restrict__ par,
             const float* __restrict__ val, float* __restrict__ out,
             const int* __restrict__ long_rows, int n_long, int N) {
  // the short-row kernel may launch at once (it reads no output of this one)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ float s_msg[];            // [2][kChunk][32] live edges' messages
  __shared__ int s_cnt[2][kLongWarps];        // live edges per slice (from warp 1)
  __shared__ int ring_s[kAhead * kChunk];     // src and w, kAhead chunks ahead
  __shared__ float ring_w[kAhead * kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_blk = (N + 31) / 32;
  const long long tasks = static_cast<long long>(n_long) * n_blk;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int row = long_rows[task / n_blk];
    const int c = static_cast<int>(task % n_blk) * 32 + lane;
    const bool col = c < N;
    const size_t lN = static_cast<size_t>(row_label[row]) * N;
    const int p = col ? par[lN + c] : 0;
    const float t = col ? val[lN + c] : 0.f;
    const int beg = row_ptr[row];
    const int end = row_ptr[row + 1];
    const int n_chunks = (end - beg + kChunk - 1) / kChunk;
    // gatherers: the first kAhead chunks' edges in flight, chunk 0 into
    // buffer 0
    if (warp > 0) {
      for (int k = 0; k < kAhead; ++k) long_prefetch(src, w, beg, end, k, ring_s, ring_w);
      long_gather(src, w, alpha, N, p, t, col, beg, end, 0, ring_s, ring_w, s_msg, s_cnt);
    }
    __syncthreads();
    float sum = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      // the gatherers form chunk k + 1 while the adder sums chunk k
      if (warp > 0 && k + 1 < n_chunks)
        long_gather(src, w, alpha, N, p, t, col, beg, end, k + 1, ring_s, ring_w, s_msg,
                    s_cnt);
      if (warp == 0) {
        const int b = k & 1;
        for (int g = 1; g < kLongWarps; ++g) {
          const float* msg = s_msg + (static_cast<size_t>(b) * kChunk + (g - 1) * 32) * 32 + lane;
          const int cnt = s_cnt[b][g];
#pragma unroll 8
          for (int i = 0; i < cnt; ++i) sum = __fadd_rn(sum, msg[i * 32]);
        }
      }
      __syncthreads();
    }
    if (warp == 0 && col) out[static_cast<size_t>(row) * N + c] = sum;
    // no copy of this row may land in the ring after the next row's
    if (warp > 0) asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

// Per device, asked once: how many blocks of each kernel the card holds at
// once (the short-row kernel's at its largest table in shared memory, which
// its registers bound all the same), and the long-row kernel's shared
// memory attribute set.  0 until asked; a race asks twice, same answer.
constexpr int kMaxDevices = 64;
struct Residency {
  std::atomic<int> short_smem{0}, short_l1{0}, long_rows{0};
};
Residency g_residency[kMaxDevices];

cudaError_t resident(const void* kernel, int threads, size_t smem, std::atomic<int>& slot,
                     int& blocks) {
  blocks = slot.load(std::memory_order_relaxed);
  if (blocks > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  slot.store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; alpha is
// (n_in, N) and out (n_out, N), with n_out = the CSR's rows: alpha may hold
// more rows than out (a shard's own rows, then the halo rows exchanged from
// other shards), and the kernels index alpha only by source id, so the row
// plan and the order of the adds are those of n_in == n_out.  par and val
// are (L, N) int32 / float32, T's column form; runs and long_rows are the
// CSR's row plan (n_runs runs, the n_long long rows stored as ~row in runs
// and listed in long_rows; the short-row kernel leaves exactly those rows to
// the long-row kernel); the stream is PyTorch's current stream.  Returns the
// first cudaError_t of the launches.
extern "C" int vm_step_launch(const void* row_ptr, const void* src,
                              const void* w, const void* row_label,
                              const void* alpha, const void* par,
                              const void* val, void* out, int n_out, int n_in, int N, int L,
                              const void* runs, int n_runs, const void* long_rows,
                              int n_long, void* stream) {
  if (n_out <= 0 || N <= 0 || n_runs <= 0) return static_cast<int>(cudaSuccess);
  // the short-row kernel keeps source offsets (src * N < n_in * N) and its
  // task indices in int
  if (static_cast<long long>(n_in) * N >= INT_MAX ||
      static_cast<long long>(n_runs) * ((N + 31) / 32) >= INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* sr = static_cast<const int*>(src);
  const auto* wt = static_cast<const float*>(w);
  const auto* lab = static_cast<const int*>(row_label);
  const auto* al = static_cast<const float*>(alpha);
  const auto* pa = static_cast<const int*>(par);
  const auto* va = static_cast<const float*>(val);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  Residency& res = g_residency[dev];
  const long long LN = static_cast<long long>(L) * N;
  const bool in_smem = LN * 8 <= kTableSmemBytes;
  const size_t smem = in_smem ? static_cast<size_t>(LN) * 8 : 0;
  const long long tasks = static_cast<long long>(n_runs) * ((N + 31) / 32);
  auto short_kernel = in_smem ? vm_step_short<true> : vm_step_short<false>;
  int cap = 0;
  err = resident(reinterpret_cast<const void*>(short_kernel), kThreads,
                 in_smem ? kTableSmemBytes : 0, in_smem ? res.short_smem : res.short_l1, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  if (n_long > 0) {
    if (res.long_rows.load(std::memory_order_relaxed) == 0) {
      err = cudaFuncSetAttribute(vm_step_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kLongSmemBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int long_cap = 0;
    err = resident(reinterpret_cast<const void*>(vm_step_long), kLongThreads, kLongSmemBytes,
                   res.long_rows, long_cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long long_tasks = static_cast<long long>(n_long) * ((N + 31) / 32);
    vm_step_long<<<static_cast<int>(long_tasks < long_cap ? long_tasks : long_cap),
                   kLongThreads, kLongSmemBytes, st>>>(
        rp, sr, wt, lab, al, pa, va, o, static_cast<const int*>(long_rows), n_long, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // behind the long-row kernel, the short rows may start while it runs
  // (programmatic dependent launch: the two write disjoint rows); each
  // block waits for it before it exits, so what follows on the stream sees
  // both.  With no long rows the launch is an ordinary one: the kernel
  // before it on the stream may have written alpha or w.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n_long > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, short_kernel, rp, sr, wt, lab, al, pa, va, o,
                           static_cast<const int*>(runs), n_runs, N, static_cast<int>(LN));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
