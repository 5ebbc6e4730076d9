// flash_attention_bf16 — blocked online-softmax attention on Hopper's tensor
// cores (sm_90a: wgmma, TMA, mbarrier pipeline, warp specialisation).
//
// Replaces, for bfloat16 q, k and v, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:27 (_attn_kernel); float32
// inputs go to flash_attention_f32.cu.  For q (B, Sq, H, D) and k, v
// (B, Skv, KV, D), query head h reads KV head h / (H / KV) in place, and
//
//     s[i, j] = (q_i . k_j) / sqrt(D)                 float32 accumulation
//     mask    = j < Skv  [&& j <= i  (causal, top-left: q counted from 0)]
//                        [&& j > i - window  (one-sided window)]
//     out_i   = sum_j p~_ij v_j / max(sum_j p~_ij, 1e-30)
//
// with p = exp(s - running max) where the mask holds and exactly 0 where it
// does not.  A row with no valid key keeps l = 0, acc = 0 and writes 0.
// m, l, the rescaling and the division stay in float32; exp is exp2 of the
// score times log2(e) / sqrt(D).
//
// The weights.  P feeds the tensor cores as bf16, and one bf16 rounding of
// p (8 significant bits) moves each weight by up to 2^-9 of itself: in a
// row with few keys those errors do not average out, and an output near 0
// then misses the serving path's gate (one bf16 step + 1e-3 of the
// output's RMS) by several times; tests/test_torch_flash_attention.py
// shows it.  So p~ = hi + lo, hi = bf16(p), lo = bf16(p - hi): two bf16
// products P_hi V + P_lo V carry each weight to ~2^-17, and l sums exactly
// those weights, so out_i is a convex combination of the v rows (a common
// part of the v rows passes through unshifted).  The price is a second
// P V product: half again the tensor-core work.
//
// The design is FlashAttention-3's (Shah et al., arXiv:2407.08608, §3), in
// its plainest form.  One block of 384 threads owns one (batch * head,
// 128-row q tile) and loops over its kv tiles; nothing carries between
// blocks, and q tiles are issued last-first so the longest causal rows
// start first.  The kv loop visits only [max(0, q0 - window + 1),
// min(Skv, q0 + 128)) under the causal and window masks, and applies the
// mask only on tiles that cross the diagonal, the window's edge or Skv.
//
//   * warpgroup 0 is the producer: after `setmaxnreg` gives its registers
//     away, one thread loads the q tile once and keeps a ring of ST K and V
//     stages in flight with TMA (cp.async.bulk.tensor, 4-D maps over
//     (D, heads, S, B), so a box clipped at S never reads the next batch and
//     rows past S arrive as zeros), completing on `mbarrier`s; K and V
//     stages are released separately;
//   * warpgroups 1 and 2 are consumers, 64 q rows each: S = Q K^T with
//     wgmma m64nBKk16 (Q and K from shared memory, K-major, K in its own
//     (kv, D) row layout), the online softmax in registers, then
//     O += P V with P from registers as the A operand and V from shared
//     memory as the MN-major B operand (the transpose is the descriptor's),
//     m64n128k16 across two column boxes at D >= 128.
//
// Shared-memory tiles use the 128-byte swizzle (64-byte at D = 32): a TMA
// box row is 64 bf16 wide at most, so a D = 128 tile is two column boxes,
// D = 256 four, and each wgmma descriptor addresses its box.  The tile plan
// per D (BK, stages) is kernel.py's TILE_PLAN; BQ is 128.
//
// What bounds it on an H100: operations.  A causal prefill does
// 4 * D * (pairs kept) FLOP; at qwen3-4b's 32k prefill (H=32, D=128) that is
// 8.80e12 FLOP against 671 MB of q, k, v and out, far above the ridge of the
// bf16 tensor cores (989 TFLOP/s: 8.89 ms).  With the second P V product the
// tensor cores do 1.5x that.  Next to the products, the time goes to the
// softmax between S and P V, on each warpgroup's critical path: P V is
// issued in two halves, the first while the second half's weights are made.
// FlashAttention-3's intra-warpgroup overlap (the next S beside this P V)
// needs the scores, P and O in registers at once, more than ptxas gives a
// consumer thread here (it spills), and ping-pong orders of the two
// warpgroups' products gained nothing measurable.  At D = 256 the O
// accumulators alone take 128 registers and ptxas spills.
//
// Offsets are 64-bit.  The launcher raises the shared-memory limit and
// returns any error, including a failed tensor-map encoding (10000 + the
// CUresult).

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1e30f;   // the running max before any key

template <int D, int BK, int ST>
struct Plan {
  static constexpr int kSwz = D >= 64 ? 128 : 64;   // bytes per box row
  static constexpr int kBoxW = kSwz / 2;            // bf16 per box row
  static constexpr int kChunks = D / kBoxW;         // column boxes per tile
  static constexpr int kNW = D < 128 ? D : 128;     // N of one P V product
  static constexpr int kNPV = D / kNW;              // P V products per k-step
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;
  static constexpr int kBarOffset = kQBytes + 2 * ST * kKVBytes;
  // 1024 of slack to align the tiles to the swizzle's 1024-byte pattern,
  // then Q, ST K stages, ST V stages and 128 bytes of mbarriers
  // (kernel.py's smem_bytes computes the same)
  static constexpr int kSmem = 1024 + kBarOffset + 128;
  static_assert(1 + 4 * ST <= 16, "mbarriers take 128 bytes");
  static_assert(kSmem <= 232448, "tile plan exceeds shared memory");
  static_assert(BK % 16 == 0 && BK <= 256 && D % kBoxW == 0, "tile shape");
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait longer than
// 4 s (legitimate waits take microseconds) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B).
template <int SWZ>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = SWZ == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (kLayout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FA_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_F16(d, i) FA_F8(d, i), FA_F8(d, i + 8)
#define FA_F32(d, i) FA_F16(d, i), FA_F16(d, i + 16)
#define FA_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FA_R32                                                                          \
  FA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FA_R64                                                                          \
  FA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
         "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, " \
         "%63"

// D(64 x N) (+)= A(64 x 16) B(16 x N), A and B K-major in shared memory.
template <int N>
struct MmaSS;
template <>
struct MmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_F32(d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct MmaSS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FA_F32(d, 0), FA_F32(d, 32)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// D(64 x N) += A(64 x 16) B(16 x N), A in registers, B MN-major in shared
// memory (transposed through the descriptor).
template <int N>
struct MmaRS;
template <>
struct MmaRS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" FA_R16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FA_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct MmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FA_F32(d, 0), FA_F32(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two weights (p0, p1) of one row as bf16 pairs hi + lo, where hi = bf16(p)
// and lo = bf16(p - hi): hi + lo holds p to ~2^-17.  sum gains exactly
// the weights the two products are fed.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo,
                                           float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float h0 = __low2float(h), h1 = __high2float(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - h0, p1 - h1);
  hi = bits(h);
  lo = bits(r);
  sum += (h0 + __low2float(r)) + (h1 + __high2float(r));
}

// ---- the consumer's steps ------------------------------------------------

// S = Q K^T for one warpgroup: A = its 64 rows of Q, B = the K tile, both
// K-major; k-step kk reads 16 columns of box kk / (kBoxW / 16) at a
// 32-byte offset in the swizzled row.  Issued, not waited for.
template <int D, int BK, int ST>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
  using P = Plan<D, BK, ST>;
  constexpr int kPerBox = P::kBoxW / 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / kPerBox;
    const uint32_t off = (kk % kPerBox) * 32;
    const uint64_t da = make_desc<P::kSwz>(q_rows + box * kBQ * P::kSwz + off, 16, 8 * P::kSwz);
    const uint64_t db = make_desc<P::kSwz>(k_tile + box * BK * P::kSwz + off, 16, 8 * P::kSwz);
    MmaSS<BK>::run(sc, da, db, kk > 0);
  }
}

// O += P V over k-steps [k0, k1) with P = hi + lo from registers; V's (kv,
// D) rows are the MN-major B operand.  k-step kk is kv rows [16 kk, 16 kk +
// 16); one product spans kNW columns, kNW / kBoxW boxes of the tile: the
// leading byte offset is the distance between boxes, the stride byte offset
// that of 8 kv rows.  Issued, not waited for.
template <int D, int BK, int ST>
__device__ __forceinline__ void issue_pv(
    float (&acc)[Plan<D, BK, ST>::kNPV][Plan<D, BK, ST>::kNW / 2],
    const uint32_t (&pa)[BK / 16][4], const uint32_t (&pl)[BK / 16][4], uint32_t v_tile,
    int k0, int k1) {
  using P = Plan<D, BK, ST>;
#pragma unroll
  for (int kk = k0; kk < k1; ++kk)
#pragma unroll
    for (int n = 0; n < P::kNPV; ++n) {
      const uint32_t box = n * (P::kNW / P::kBoxW);
      const uint64_t dv = make_desc<P::kSwz>(v_tile + box * BK * P::kSwz + kk * 16 * P::kSwz,
                                             BK * P::kSwz, 8 * P::kSwz);
      MmaRS<P::kNW>::run(acc[n], pa[kk], dv);
      MmaRS<P::kNW>::run(acc[n], pl[kk], dv);
    }
}

// ---- the kernel ----------------------------------------------------------

template <int D, int BK, int ST>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                            int Skv, int H, int KV, int causal, int has_window, long long window,
                            float scale_log2) {
  using P = Plan<D, BK, ST>;
  constexpr int kSwz = P::kSwz, kBoxW = P::kBoxW, kChunks = P::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + P::kQBytes;               // stage s at sK + s * kKVBytes
  const uint32_t sV = sK + ST * P::kKVBytes;
  // mbarriers: q full; per stage K full, V full, K free, V free
  const uint32_t bar_q = base + P::kBarOffset;
  const uint32_t bar_kf = bar_q + 8, bar_vf = bar_kf + 8 * ST;
  const uint32_t bar_ke = bar_vf + 8 * ST, bar_ve = bar_ke + 8 * ST;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kBQ;

  // the kv tiles that hold a key some row of this q tile may see
  long long lo = 0, hi = Skv;
  if (causal) hi = min(hi, q0 + kBQ);
  if (has_window) lo = max(0LL, q0 - window + 1);
  lo = lo / BK * BK;
  const int n_tiles = hi > lo ? static_cast<int>((hi - lo + BK - 1) / BK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_kf + 8 * s, 1);
      mbar_init(bar_vf + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 8);   // lane 0 of each of the 8 consumer warps
      mbar_init(bar_ve + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, P::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sQ + c * kBQ * kSwz, &tm_q, bar_q, c * kBoxW, h, static_cast<int>(q0), b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, round = it / ST;
        const int kv0 = static_cast<int>(lo) + it * BK;
        if (round > 0) mbar_wait(bar_ke + 8 * s, (round - 1) & 1);
        mbar_expect_tx(bar_kf + 8 * s, P::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sK + s * P::kKVBytes + c * BK * kSwz, &tm_k, bar_kf + 8 * s, c * kBoxW,
                      kvh, kv0, b);
        if (round > 0) mbar_wait(bar_ve + 8 * s, (round - 1) & 1);
        mbar_expect_tx(bar_vf + 8 * s, P::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sV + s * P::kKVBytes + c * BK * kSwz, &tm_v, bar_vf + 8 * s, c * kBoxW,
                      kvh, kv0, b);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;              // 0 or 1: q rows [64 wg, 64 wg + 64)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long qa = q0 + 64 * wg;                 // the warpgroup's first q row
  // this thread's two rows: qa + 16 warp + g (+ 8); their valid kv interval
  long long row[2];
  int rlo[2], rhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = qa + 16 * warp + g + 8 * r;
    long long a = 0, z = Skv;
    if (causal) z = min(z, row[r] + 1);
    if (has_window) a = max(a, row[r] - window + 1);
    rlo[r] = static_cast<int>(min(a, static_cast<long long>(Skv)));
    rhi[r] = static_cast<int>(max(z, 0LL));
  }
  const uint32_t q_rows = sQ + 64 * wg * kSwz;

  float acc[P::kNPV][P::kNW / 2];
#pragma unroll
  for (int n = 0; n < P::kNPV; ++n)
#pragma unroll
    for (int j = 0; j < P::kNW / 2; ++j) acc[n][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[BK / 2];                          // scores, then their exponentials
  uint32_t pa[BK / 16][4], pl[BK / 16][4];   // P = hi + lo as wgmma A fragments

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    const long long kv0 = lo + static_cast<long long>(it) * BK;

    // S = Q K^T
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    mbar_wait(bar_kf + 8 * s, parity);
    wg_fence();
    issue_qk<D, BK, ST>(sc, q_rows, sK + s * P::kKVBytes);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    if (lane == 0) mbar_arrive(bar_ke + 8 * s);   // the K stage is free again

    // mask the tile where it crosses the diagonal, the window's edge or Skv;
    // accumulator element j is row g + 8 ((j >> 1) & 1), column
    // 8 (j / 4) + 2 t + (j & 1)
    if (kv0 + BK > Skv || (causal && kv0 + BK - 1 > qa) ||
        (has_window && kv0 <= qa + 63 - window)) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        const int col = static_cast<int>(kv0) + 8 * (j / 4) + 2 * t + (j & 1);
        if (col < rlo[r] || col >= rhi[r]) sc[j] = -CUDART_INF_F;
      }
    }

    // online softmax: the running max over the quad that shares a row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, corr[2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < P::kNPV; ++n)
#pragma unroll
      for (int j = 0; j < P::kNW / 2; ++j) acc[n][j] *= corr[(j >> 1) & 1];

    // O += P V, half the tile at a time: P = exp2(s * log2(e) / sqrt(D) - m)
    // as hi + lo A fragments (l gains exactly those weights), so that the
    // first half's products run while the second half's weights are made
    constexpr int kHalf = BK / 32;       // k-steps of 16 kv rows in half a tile
    mbar_wait(bar_vf + 8 * s, parity);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int kk = half * kHalf; kk < (half + 1) * kHalf; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 8 * kk + 2 * i;
          const float mr = m[i & 1];
          split_bf16(exp2_approx(fmaf(sc[j], scale_log2, -mr)),
                     exp2_approx(fmaf(sc[j + 1], scale_log2, -mr)), pa[kk][i], pl[kk][i],
                     l[i & 1]);
        }
      wg_fence();
      issue_pv<D, BK, ST>(acc, pa, pl, sV + s * P::kKVBytes, half * kHalf, (half + 1) * kHalf);
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < P::kNPV; ++n) reg_fence(acc[n]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      reg_fence(pa[kk]);
      reg_fence(pl[kk]);
    }
    if (lane == 0) mbar_arrive(bar_ve + 8 * s);   // the V stage is free again
  }

  // out = acc / l, l summed over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the row log-sum-exp, when asked for: ln 2 (m + log2 l), -inf on a
    // row with no valid key (l = 0)
    if (lse != nullptr && t == 0 && row[r] < Sq)
      lse[(static_cast<long long>(b) * H + h) * Sq + row[r]] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : -CUDART_INF_F;
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const long long row_stride = static_cast<long long>(H) * D;
  __nv_bfloat16* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    __nv_bfloat16* dst = ob + row[r] * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < P::kNPV; ++n)
#pragma unroll
      for (int i = 0; i < P::kNW / 8; ++i) {
        const int j = 4 * i + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dst + n * P::kNW + 8 * i) =
            __floats2bfloat162_rn(acc[n][j] / l[r], acc[n][j + 1] / l[r]);
      }
  }
}

// ---- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, S, heads, D) bf16 tensor, innermost first
// (D, heads, S, B); one box is `box_w` columns of one head over `rows` rows.
int make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B, int box_w,
             int rows, int swz) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <int D, int BK, int ST>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Skv, int H, int KV, int causal, int has_window, long long window,
           float scale_log2, cudaStream_t stream) {
  using P = Plan<D, BK, ST>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, H, Sq, B, P::kBoxW, kBQ, P::kSwz);
  if (err == 0) err = make_map(&tk, k, D, KV, Skv, B, P::kBoxW, BK, P::kSwz);
  if (err == 0) err = make_map(&tv, v, D, KV, Skv, B, P::kBoxW, BK, P::kSwz);
  if (err != 0) return err;
  auto kernel = flash_attention_bf16_kernel<D, BK, ST>;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                  static_cast<unsigned>((Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, P::kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                               Sq, Skv, H, KV, causal, has_window, window,
                                               scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  q, k, v and out are contiguous bf16
// device arrays in the model's layout, q and out (B, Sq, H, D), k and v
// (B, Skv, KV, D), 16-byte aligned; D is 32, 64, 128 or 256 and (bk,
// stages) the tile plan kernel.py's TILE_PLAN gives for it; H is a multiple
// of KV and Sq / 128 at most 65535.  window is used when has_window is set.
// scale_log2 is log2(e) / sqrt(D).  lse, when not null, is a float32 (B,
// H, Sq) array that receives each row's log-sum-exp of its scaled scores
// (natural log; -inf on a row with no valid key), which the backward
// (flash_attention_bwd.cu) reads; the output is the same either way.  The
// stream is PyTorch's current stream.  Returns 0, a cudaError_t, or 10000 +
// the CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                           void* out, int B, int Sq, int Skv, int H, int KV,
                                           int D, int bk, int stages, int causal,
                                           int has_window, long long window, float scale_log2,
                                           void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || Skv > 0x7fffffff - 256 ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define FA_PLAN(d, b, s)                                                                    \
  if (D == d && bk == b && stages == s)                                                   \
    return launch<d, b, s>(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, KV,    \
                           causal, has_window, window, scale_log2, st);
  FA_PLAN(32, 64, 2)
  FA_PLAN(64, 64, 2)
  FA_PLAN(128, 128, 2)
  FA_PLAN(256, 64, 2)
#undef FA_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}
