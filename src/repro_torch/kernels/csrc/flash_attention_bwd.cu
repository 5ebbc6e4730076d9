// flash_attention_bwd — the backward of blocked attention, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes no backward for
// src/repro/kernels/flash_attention/kernel.py:27 (_attn_kernel) and takes
// the training gradient with jax.value_and_grad through the plain jnp
// attention (src/repro/models/layers.py:93), which XLA differentiates on the
// device.  This kernel stands in for that device work on the card.
//
// For q (B, Sq, H, D), k and v (B, Skv, KV, D), the forward's output o
// (B, Sq, H, D), its float32 row log-sum-exp lse (B, H, Sq) and the
// output's gradient dout, with s = (q_i . k_j) / sqrt(D) and the forward's
// masks (top-left causal kv <= q, one-sided window kv > q - window, kv <
// Skv), it computes FlashAttention-2's backward:
//
//     p_ij     = exp(s_ij - lse_i) where the mask holds, exactly 0 elsewhere
//     delta_i  = sum_d dout_id o_id
//     dv_j     = sum_i p_ij dout_i
//     ds_ij    = p_ij ((dout_i . v_j) - delta_i)
//     dk_j     = sum_i ds_ij q_i / sqrt(D)
//     dq_i     = sum_j ds_ij k_j / sqrt(D)
//
// Query head h reads KV head h / (H / KV), so dk and dv of a KV head sum
// over the H / KV query heads that read it.  A row with no valid key has
// p = 0 throughout and gets zero gradient.  Inputs are bf16 or float32;
// accumulators are float32; outputs are in the input type.  Two routes:
//   * bf16 at head sizes 32, 64 and 128 (qwen3-4b's and olmoe-1b-7b's
//     path): wgmma on operands that TMA brings into shared memory under
//     mbarriers, p and ds rounded to bf16 as the register A operand of the
//     next product (the section "bf16 on Hopper's tensor cores" below);
//   * float32 at every head size (the float32 gradient gate's route), and
//     bf16 at head size 256 (gemma3-4b's): mma.sync on tiles that cp.async
//     double-buffers, each float32 product as three TF32 products
//     (3xTF32), each bf16 one as one bf16 product (the section "float32
//     and bf16 at head size 256 on mma.sync" below).
//
// Launches, none with an atomic, so the gradient repeats bit for bit:
//   1. delta, one warp per (b, i, h) row;
//   2. dv, then dk: one block per (batch * KV head, key tile), which
//      recomputes p from q, k and lse for every q tile that can see its
//      keys, and loops over the query heads of its KV head in order, so
//      the GQA sum has one fixed order;
//   3. dq: one block per (batch * head, q tile), looping over the kv tiles
//      its rows can see (q tiles issued last-first, as in the forward, so
//      the longest causal rows start first).
//
// What bounds it on an H100: operations.  The backward does five products
// of q/dout/k/v size, 10 D FLOP a kept (q, k) pair and head against the
// forward's 4 D; at qwen3-4b's 1 x 4,096 x 32 heads of 128, causal, that is
// 3.44e11 FLOP: 0.35 ms at the bf16 tensor cores' 989 TFLOP/s (in float32
// three TF32 products each, 2.1 ms at 495 TFLOP/s), while its 168 MB of
// inputs and gradients take 0.05 ms at 3.35 TB/s.  What the wgmma route
// does about it:
//   * every product is a wgmma, the only instruction that reaches the
//     tensor cores' full rate on Hopper (the mma.sync m16n8k16 design it
//     replaced ran at 0.13 of the bound);
//   * a producer warp keeps the next tiles' TMA loads in flight in a ring
//     of two stages, so no thread spends instructions on a copy and no
//     load waits behind a barrier of the products;
//   * a dv or dk block keeps 128 keys' K (and V) in shared memory and its
//     accumulator in registers over every q tile of all its query heads,
//     and a dq block keeps 128 rows' q and dout; lse and delta travel with
//     each q tile (dv, dk) or sit in registers (dq);
//   * one accumulator a consumer thread: dk and dv in one launch would hold
//     128 accumulator registers beside s^T and dp^T, and ptxas then spills
//     and serialises every wgmma; so the dv and dq launches recompute s (and
//     dq dp), eight products for the bound's five (1.6x its FLOP), and no
//     launch needs an atomic or an order between blocks;
//   * causal walks are issued longest first, so the grid's tail holds the
//     short ones, and dk and dq launch as programmatic dependents, so each
//     one's first blocks fill the SMs that the one before leaves idle (dv
//     follows delta in plain stream order: dk and dq read delta before
//     any griddepcontrol.wait, so delta must be complete before they start).
// Between a consumer's products its softmax gradient (exp2, the masks on
// edge tiles, the bf16 packing) is on its critical path; the two consumer
// warpgroups of a block fill each other's gaps.  The products whose B tile
// both consumer warpgroups read from shared memory at N = 64 (s^T and dp^T
// in dk, s and dp in dq) ask for 128 bytes a cycle, all that shared memory
// gives; the dv launch's N = 128 tiles ask for 96.  The mma.sync route
// reaches a part of the TF32 rate that wgmma would (wgmma takes TF32 only
// K-major, so dv's and dk's updates would need q and dout transposed in
// shared memory), and splits every operand into two TF32 parts on the
// ALUs beside its products.
//
// Offsets are 64-bit.  The launchers return any launch error.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // the delta launch's block: a warp a row
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
               int Sq, int H, long long rows) {
  const long long r = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* orow = o + r * D;
  const T* drow = dout + r * D;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) sum = fmaf(to_f(orow[d]), to_f(drow[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long b = r / (static_cast<long long>(Sq) * H);
    const long long i = (r / H) % Sq;
    const long long h = r % H;
    delta[(b * H + h) * Sq + i] = sum;
  }
}

// ---- bf16 on Hopper's tensor cores (wgmma, TMA, mbarriers), head sizes 32 to 128 ----
//
// Three kernels of one shape, FlashAttention-3's backward (Shah et al.,
// arXiv:2407.08608) without its atomics: a block of 384 threads, warpgroup 0
// the producer (after `setmaxnreg` gives its registers away, one thread
// keeps a ring of TMA loads in flight on mbarriers) and warpgroups 1 and 2
// the consumers, 64 rows each, whose products are wgmma m64nNk16 (bf16 in,
// float32 accumulate).  Tiles land in shared memory in the forward's
// layout: a (rows, D) tile as column boxes of 64 bf16 (32 at D = 32) with
// the 128-byte (64-byte) swizzle, so one tile serves as a K-major operand
// (its rows the product's rows or columns, D the inner dimension) and as an
// MN-major B operand (its rows the inner dimension; the transpose is the
// descriptor's).  p and ds are rounded to bf16 only as the register A
// operand of the next product, straight from the accumulator fragments.
//
//   * dv, then dk: a block owns (batch, KV head, 128 keys) and loads its K
//     (and V) once.  The ring holds (q, dout) tiles of 128 rows (dv) or
//     64 (dk), over the query heads of its KV head in order and, within a
//     head, the q tiles that can see its keys; warp 1 of the producer
//     stages each tile's lse (in log2 units) and delta beside it.  The dv launch computes s^T =
//     K q^T, p^T in registers and dv += p^T dout; the dk launch s^T and
//     dp^T = V dout^T, ds^T in registers and dk += ds^T q (q and dout K-major
//     for s^T and dp^T, MN-major for the updates).  One launch holding both
//     dk and dv (64 + 64 accumulator registers at D = 128) beside s^T and
//     dp^T would do four products for these five, but ptxas then
//     serialises its wgmma and spills (792 bytes at D = 128): s^T is
//     computed twice instead.  The dv ring's q tiles are 128 rows (s^T at
//     N = 128), the dk ring's 64 (its s^T and dp^T at N = 128 spill too).
//     Key tiles are issued first to last, so the longest causal walks start
//     first.
//   * dq: a block owns (batch, head, 128 q rows) and loads q and dout once;
//     the ring holds (k, v) tiles of 64 keys.  s = q k^T, dp = dout v^T,
//     ds in registers, dq += ds k (k MN-major); q tiles are issued last
//     first.  It recomputes s and dp.
// So the launch does eight products for the bound's five, and needs no
// atomic and no order between blocks.
//
// Masks are applied only on tiles that cross the diagonal, the window's
// edge, Sq or Skv; a consumer warpgroup that no pair of a tile can see skips
// its products (but releases the stage).  Every sum has one order.

constexpr int kWgThreads = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int kKeysA = 128;       // keys a dv or dk block owns: 64 a consumer warpgroup
constexpr int kRowsV = 128;       // q rows a stage of the dv ring holds
constexpr int kStagesV = 2;
constexpr int kRowsK = 64;        // q rows a stage of the dk ring holds
constexpr int kStagesK = 2;
constexpr int kRowsB = 128;       // q rows a dq block owns: 64 a consumer warpgroup
constexpr int kKeysB = 64;        // keys a stage of the dq ring holds
constexpr int kStagesB = 2;

template <int D>
struct WgPlan {
  static constexpr int kSwz = D >= 64 ? 128 : 64;   // bytes per box row
  static constexpr int kBoxW = kSwz / 2;            // bf16 per box row
  static constexpr int kChunks = D / kBoxW;         // column boxes per tile
  // dq: q, dout, the stages' K, the stages' V, mbarriers
  static constexpr int kQTileB = kRowsB * D * 2;
  static constexpr int kKVTileB = kKeysB * D * 2;
  static constexpr int kBarOffB = 2 * kQTileB + 2 * kStagesB * kKVTileB;
  static constexpr int kSmemB = 1024 + kBarOffB + 128;
  static_assert(1 + 4 * kStagesB <= 16, "mbarriers take 128 bytes");
  static_assert(kSmemB <= 232448, "tile plan exceeds shared memory");
  static_assert(D % kBoxW == 0 && D <= 128, "head size");
};

// The dv or dk launch's shared memory: K, V, the ST stages' q, the stages'
// dout, the stages' lse and delta (BQ floats each), mbarriers.
template <int D, int BQ, int ST>
struct DkvPlan {
  static constexpr int kKVTile = kKeysA * D * 2;
  static constexpr int kQTile = BQ * D * 2;
  static constexpr int kRowsOff = 2 * kKVTile + 2 * ST * kQTile;
  static constexpr int kBarOff = kRowsOff + 2 * ST * BQ * 4;
  static constexpr int kSmem = 1024 + kBarOff + 128;
  static_assert(1 + 2 * ST <= 16, "mbarriers take 128 bytes");
  static_assert(kSmem <= 232448, "tile plan exceeds shared memory");
};

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

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C (64 x N) = A B^T over D: A = the warpgroup's 64 rows of a tile of
// A_ROWS rows (a_rows: their first row in box 0), B = N rows of a tile of
// B_ROWS rows (b_rows: their first row in box 0); both (rows, D) tiles,
// K-major.  k-step kk reads 16 columns of box kk / (kBoxW / 16) at a
// 32-byte offset in the swizzled row.  Issued, not waited for.
template <int D, int N, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void issue_abt(float (&c)[N / 2], uint32_t a_rows, uint32_t b_rows) {
  using P = WgPlan<D>;
  constexpr int kPerBox = P::kBoxW / 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / kPerBox;
    const uint32_t off = (kk % kPerBox) * 32;
    const uint64_t da = make_desc<P::kSwz>(a_rows + box * A_ROWS * P::kSwz + off, 16,
                                           8 * P::kSwz);
    const uint64_t db = make_desc<P::kSwz>(b_rows + box * B_ROWS * P::kSwz + off, 16,
                                           8 * P::kSwz);
    MmaSS<N>::run(c, da, db, kk > 0);
  }
}

// C (64 x D) += A X: A (64 x 16 KS) as KS k-steps of register fragments, X
// 16 KS rows of a (X_ROWS, D) tile (x_rows: their first row in box 0) as the
// MN-major B operand: one product spans D columns, the leading byte offset
// is the distance between column boxes, the stride byte offset that of 8
// rows.  Issued, not waited for.
template <int D, int KS, int X_ROWS>
__device__ __forceinline__ void issue_ax(float (&c)[D / 2], const uint32_t (&a)[KS][4],
                                         uint32_t x_rows) {
  using P = WgPlan<D>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t dx = make_desc<P::kSwz>(x_rows + kk * 16 * P::kSwz, X_ROWS * P::kSwz,
                                           8 * P::kSwz);
    MmaRS<D>::run(c, a[kk], dx);
  }
}

// A 64 x N accumulator as N / 16 k-steps of A fragments: accumulator
// element j is row g + 8 ((j >> 1) & 1), column 8 (j / 4) + 2 t + (j & 1)
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
}

// Two rows (row0 + 8 r, r = 0, 1) of a consumer thread's (row, D)
// accumulator to global memory as bf16 pairs, times mul; rows at or past S
// skipped.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, long long row_stride,
                                          long long row0, long long S, const float (&acc)[D / 2],
                                          float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* dst = base + row * row_stride + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int j = 4 * i + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(acc[j] * mul, acc[j + 1] * mul);
    }
  }
}

// (q row qp, key kp) seen under the forward's masks, with the window
// clamped into int range by the caller (1 << 30 for none)
__device__ __forceinline__ bool seen(int qp, int kp, int Sq, int Skv, int causal, int win) {
  return qp < Sq && kp < Skv && (!causal || kp <= qp) && kp > qp - win;
}

// dv (kDK false) or dk (kDK true) of 128 keys: s^T = K q^T, p^T in
// registers, then dv += p^T dout; or s^T and dp^T = V dout^T, ds^T in
// registers, then dk += ds^T q.  One accumulator a consumer thread.
template <int D, bool kDK>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ out, int Sq,
                   int Skv, int H, int KV, int causal, int has_window, long long window,
                   float scale) {
  using P = WgPlan<D>;
  constexpr int BQ = kDK ? kRowsK : kRowsV, ST = kDK ? kStagesK : kStagesV;
  using A = DkvPlan<D, BQ, ST>;
  constexpr int kSwz = P::kSwz, kBoxW = P::kBoxW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + A::kKVTile;
  const uint32_t sQ = sV + A::kKVTile;           // stage s at sQ + s * kQTile
  const uint32_t sO = sQ + ST * A::kQTile;      // dout, likewise
  // stage s: lse (log2 units) at rows + 2 s BQ, delta BQ floats after it
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + A::kRowsOff);
  // mbarriers: K (and V) loaded; per stage full, empty
  const uint32_t bar_kv = base + A::kBarOff;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * ST;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * kKeysA;
  const int win = has_window ? static_cast<int>(min(window, 1LL << 30)) : 1 << 30;
  // the q rows that may see a key of this tile, in q tiles of BQ
  const int qlo = (causal ? k0 : 0) / BQ * BQ;
  const int qhi = static_cast<int>(min(static_cast<long long>(Sq),
                                       static_cast<long long>(k0) + kKeysA - 1 + win));
  const int n_qt = qhi > qlo ? (qhi - qlo + BQ - 1) / BQ : 0;
  const int n_it = G * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);   // the TMA thread and warp 1's lanes
      mbar_init(bar_empty + 8 * s, 8);       // lane 0 of each of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the next launch of the backward may start on SMs this grid leaves idle
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, (kDK ? 2 : 1) * A::kKVTile);
      for (int c = 0; c < P::kChunks; ++c) {
        tma_load_4d(sK + c * kKeysA * kSwz, &tm_k, bar_kv, c * kBoxW, kvh, k0, b);
        if (kDK) tma_load_4d(sV + c * kKeysA * kSwz, &tm_v, bar_kv, c * kBoxW, kvh, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, round = it / ST;
        const int h = kvh * G + it / n_qt;
        const int q0 = qlo + (it % n_qt) * BQ;
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * A::kQTile);
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load_4d(sQ + s * A::kQTile + c * BQ * kSwz, &tm_q, bar_full + 8 * s, c * kBoxW,
                      h, q0, b);
          tma_load_4d(sO + s * A::kQTile + c * BQ * kSwz, &tm_do, bar_full + 8 * s,
                      c * kBoxW, h, q0, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, round = it / ST;
        const int h = kvh * G + it / n_qt;
        const int q0 = qlo + (it % n_qt) * BQ;
        const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Sq;
        const float* delta_h = delta + (static_cast<long long>(b) * H + h) * Sq;
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        float* L = rows + 2 * s * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int qp = q0 + i;
          L[i] = qp < Sq ? lse_h[qp] * kLog2e : 0.f;
          if (kDK) L[BQ + i] = qp < Sq ? delta_h[qp] : 0.f;
        }
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;            // keys [k0 + 64 wg, k0 + 64 wg + 64)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + g;            // this thread's keys: key0, key0 + 8
  const uint32_t k_rows = sK + 64 * wg * kSwz, v_rows = sV + 64 * wg * kSwz;
  const float scale_log2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    const int q0 = qlo + (it % n_qt) * BQ;
    // no pair of this warpgroup's keys and the tile's rows is seen
    const bool none = kw0 >= Skv || (causal && q0 + BQ - 1 < kw0) ||
                      static_cast<long long>(q0) >= static_cast<long long>(kw0) + 63 + win;
    mbar_wait(bar_full + 8 * s, parity);
    if (!none) {
      const float* L = rows + 2 * s * BQ;
      const uint32_t q_tile = sQ + s * A::kQTile, o_tile = sO + s * A::kQTile;
      // s^T = K q^T (and dp^T = V dout^T), issued before either is read
      float st[BQ / 2], dpt[BQ / 2];
      wg_fence();
      issue_abt<D, BQ, kKeysA, BQ>(st, k_rows, q_tile);
      wg_commit();
      if (kDK) {
        issue_abt<D, BQ, kKeysA, BQ>(dpt, v_rows, o_tile);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      reg_fence(st);
      // p^T: element j is key key0 + 8 ((j >> 1) & 1), q row q0 + qi
      const bool edge = q0 + BQ > Sq || kw0 + 64 > Skv || (causal && kw0 + 63 > q0) ||
                        kw0 <= q0 + BQ - 1 - win;
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int qi = 8 * (j / 4) + 2 * t + (j & 1);
        float p = exp2_approx(fmaf(st[j], scale_log2, -L[qi]));
        if (edge && !seen(q0 + qi, key0 + 8 * ((j >> 1) & 1), Sq, Skv, causal, win)) p = 0.f;
        st[j] = p;
      }
      uint32_t a[BQ / 16][4];
      if (kDK) {
        wg_wait<0>();                              // dp^T is in
        reg_fence(dpt);
        const float* Dl = L + BQ;
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int qi = 8 * (j / 4) + 2 * t + (j & 1);
          st[j] *= dpt[j] - Dl[qi];
        }
      }
      to_frags<BQ>(a, st);
      wg_fence();
      // dv += p^T dout, or dk += ds^T q
      issue_ax<D, BQ / 16, BQ>(acc, a, kDK ? q_tile : o_tile);
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) reg_fence(a[kk]);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // the stage is free again
  }

  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  store_acc<D>(out + kv_off, kv_stride, key0, Skv, acc, kDK ? scale : 1.f, t);
  // finish no earlier than the launch before, so that the backward's last
  // launch completes after all of them
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                  int Skv, int H, int KV, int causal, int has_window, long long window,
                  float scale) {
  using P = WgPlan<D>;
  constexpr int kSwz = P::kSwz, kBoxW = P::kBoxW, ST = kStagesB, BK = kKeysB, BQ = kRowsB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = sQ + P::kQTileB;
  const uint32_t sK = sO + P::kQTileB;            // stage s at sK + s * kKVTileB
  const uint32_t sV = sK + ST * P::kKVTileB;
  // mbarriers: q and dout loaded; per stage K full, V full, K free, V free
  const uint32_t bar_q = base + P::kBarOffB;
  const uint32_t bar_kf = bar_q + 8, bar_vf = bar_kf + 8 * ST;
  const uint32_t bar_ke = bar_vf + 8 * ST, bar_ve = bar_ke + 8 * ST;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * BQ;
  // the kv tiles that hold a key some row of this q tile may see
  long long lo = 0, hi = Skv;
  if (causal) hi = min(hi, q0 + BQ);
  if (has_window) lo = max(0LL, q0 - window + 1);
  lo = lo / BK * BK;
  const int n_tiles = hi > lo ? static_cast<int>((hi - lo + BK - 1) / BK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_kf + 8 * s, 1);
      mbar_init(bar_vf + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 8);
      mbar_init(bar_ve + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the next launch of the backward may start on SMs this grid leaves idle
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * P::kQTileB);
      for (int c = 0; c < P::kChunks; ++c) {
        tma_load_4d(sQ + c * BQ * kSwz, &tm_q, bar_q, c * kBoxW, h, static_cast<int>(q0), b);
        tma_load_4d(sO + c * BQ * kSwz, &tm_do, bar_q, c * kBoxW, h, static_cast<int>(q0), b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, round = it / ST;
        const int kv0 = static_cast<int>(lo) + it * BK;
        if (round > 0) mbar_wait(bar_ke + 8 * s, (round - 1) & 1);
        mbar_expect_tx(bar_kf + 8 * s, P::kKVTileB);
        for (int c = 0; c < P::kChunks; ++c)
          tma_load_4d(sK + s * P::kKVTileB + c * BK * kSwz, &tm_k, bar_kf + 8 * s, c * kBoxW,
                      kvh, kv0, b);
        if (round > 0) mbar_wait(bar_ve + 8 * s, (round - 1) & 1);
        mbar_expect_tx(bar_vf + 8 * s, P::kKVTileB);
        for (int c = 0; c < P::kChunks; ++c)
          tma_load_4d(sV + s * P::kKVTileB + c * BK * kSwz, &tm_v, bar_vf + 8 * s, c * kBoxW,
                      kvh, kv0, b);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;            // q rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long qa = q0 + 64 * wg;
  const long long row0 = qa + 16 * warp + g;       // this thread's rows: row0, row0 + 8
  // per row: its valid kv interval, lse (log2 units) and delta
  long long rlo[2], rhi[2];
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + 8 * r;
    long long a = 0, z = Skv;
    if (causal) z = min(z, row + 1);
    if (has_window) a = max(a, row - window + 1);
    rlo[r] = a;
    rhi[r] = z;
    const long long off = (static_cast<long long>(b) * H + h) * Sq + row;
    L[r] = row < Sq ? lse[off] * kLog2e : 0.f;
    Dl[r] = row < Sq ? delta[off] : 0.f;
  }
  const uint32_t q_rows = sQ + 64 * wg * kSwz, o_rows = sO + 64 * wg * kSwz;
  const float scale_log2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    const long long kv0 = lo + static_cast<long long>(it) * BK;
    const uint32_t k_tile = sK + s * P::kKVTileB;
    // s = q K^T and dp = dout V^T, both issued before either is read
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(bar_kf + 8 * s, parity);
    wg_fence();
    issue_abt<D, BK, BQ, BK>(sc, q_rows, k_tile);
    wg_commit();
    mbar_wait(bar_vf + 8 * s, parity);
    issue_abt<D, BK, BQ, BK>(dp, o_rows, sV + s * P::kKVTileB);
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
    // p: element j is row row0 + 8 ((j >> 1) & 1), key kv0 + 8 (j / 4) + 2 t + (j & 1)
    const bool edge = kv0 + BK > Skv || (causal && kv0 + BK - 1 > qa) ||
                      (has_window && kv0 <= qa + 63 - window);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j >> 1) & 1;
      const long long col = kv0 + 8 * (j / 4) + 2 * t + (j & 1);
      float p = exp2_approx(fmaf(sc[j], scale_log2, -L[r]));
      if (edge && (col < rlo[r] || col >= rhi[r])) p = 0.f;
      sc[j] = p;
    }
    wg_wait<0>();                                  // dp is in
    reg_fence(dp);
    if (lane == 0) mbar_arrive(bar_ve + 8 * s);    // the V stage is free again
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) dp[j] = sc[j] * (dp[j] - Dl[(j >> 1) & 1]);
    uint32_t dsa[BK / 16][4];
    to_frags<BK>(dsa, dp);
    wg_fence();
    issue_ax<D, BK / 16, BK>(acc, dsa, k_tile);    // dq += ds K
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) reg_fence(dsa[kk]);
    if (lane == 0) mbar_arrive(bar_ke + 8 * s);    // the K stage is free again
  }

  store_acc<D>(dq + (static_cast<long long>(b) * Sq * H + h) * D, static_cast<long long>(H) * D,
               row0, Sq, acc, scale, t);
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

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
// (D, heads, S, B); one box is `box_w` columns of one head over `rows` rows,
// so a box clipped at S never reads the next batch and rows past S arrive
// as zeros.
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

// delta, then dv, dk and dq (parts: a mask of 1, 2, 4 and 8 for the four
// launches).  Returns 0, a cudaError_t, or 10000 + the CUresult of a
// failed tensor-map encoding.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                 int Skv, int H, int KV, int causal, int has_window, long long window,
                 float scale, cudaStream_t stream, int parts) {
  using P = WgPlan<D>;
  using T = __nv_bfloat16;
  const long long kv_tiles = (Skv + kKeysA - 1) / kKeysA, q_tiles = (Sq + kRowsB - 1) / kRowsB;
  if (kv_tiles > 65535 || q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // q and dout in the boxes of the dv, dk and dq rings; k and v in 128-row
  // boxes (dv, dk) and the dq ring's
  CUtensorMap tqv, tov, tqk, tok, tka, tva, tqb, tob, tkb, tvb;
  int err = make_map(&tqv, q, D, H, Sq, B, P::kBoxW, kRowsV, P::kSwz);
  if (err == 0) err = make_map(&tov, dout, D, H, Sq, B, P::kBoxW, kRowsV, P::kSwz);
  if (err == 0) err = make_map(&tqk, q, D, H, Sq, B, P::kBoxW, kRowsK, P::kSwz);
  if (err == 0) err = make_map(&tok, dout, D, H, Sq, B, P::kBoxW, kRowsK, P::kSwz);
  if (err == 0) err = make_map(&tka, k, D, KV, Skv, B, P::kBoxW, kKeysA, P::kSwz);
  if (err == 0) err = make_map(&tva, v, D, KV, Skv, B, P::kBoxW, kKeysA, P::kSwz);
  if (err == 0) err = make_map(&tqb, q, D, H, Sq, B, P::kBoxW, kRowsB, P::kSwz);
  if (err == 0) err = make_map(&tob, dout, D, H, Sq, B, P::kBoxW, kRowsB, P::kSwz);
  if (err == 0) err = make_map(&tkb, k, D, KV, Skv, B, P::kBoxW, kKeysB, P::kSwz);
  if (err == 0) err = make_map(&tvb, v, D, KV, Skv, B, P::kBoxW, kKeysB, P::kSwz);
  if (err != 0) return err;
  auto dvk = attn_bwd_dkv_wgmma<D, false>;
  auto dkk = attn_bwd_dkv_wgmma<D, true>;
  auto dqk = attn_bwd_dq_wgmma<D>;
  constexpr int kSmemV = DkvPlan<D, kRowsV, kStagesV>::kSmem;
  constexpr int kSmemK = DkvPlan<D, kRowsK, kStagesK>::kSmem;
  cudaError_t cerr =
      cudaFuncSetAttribute(dvk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemV);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(dkk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemK);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemB);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  if (parts & 1) {
    const long long rows = static_cast<long long>(B) * Sq * H;
    const long long delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
    attn_bwd_delta<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, Sq, H, rows);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  // dv follows delta in plain stream order: delta's stores are then
  // complete and visible before dv starts, and so before dk and dq read
  // them (a programmatic dependent sees its predecessor's stores only after
  // griddepcontrol.wait, which dk and dq reach only at their end).  dk and
  // dq are programmatic dependents of the launch before them, so each one's
  // first blocks fill the SMs the last one's tail leaves idle: none reads
  // another's output.  A launch timed alone does not overlap its repeats.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWgThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(KV),
                     static_cast<unsigned>(kv_tiles));
  if (parts & 2) {
    cfg.dynamicSmemBytes = kSmemV;
    cerr = cudaLaunchKernelEx(&cfg, dvk, tqv, tka, tva, tov, lse, static_cast<const float*>(delta),
                              static_cast<T*>(dv), Sq, Skv, H, KV, causal, has_window, window,
                              scale);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  attr[0].val.programmaticStreamSerializationAllowed = (parts & (parts - 1)) != 0;
  if (parts & 4) {
    cfg.dynamicSmemBytes = kSmemK;
    cerr = cudaLaunchKernelEx(&cfg, dkk, tqk, tka, tva, tok, lse, static_cast<const float*>(delta),
                              static_cast<T*>(dk), Sq, Skv, H, KV, causal, has_window, window,
                              scale);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  if (parts & 8) {
    cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                       static_cast<unsigned>(q_tiles));
    cfg.dynamicSmemBytes = P::kSmemB;
    cerr = cudaLaunchKernelEx(&cfg, dqk, tqb, tkb, tvb, tob, lse, static_cast<const float*>(delta),
                              static_cast<T*>(dq), Sq, Skv, H, KV, causal, has_window, window,
                              scale);
  }
  return static_cast<int>(cerr);
}

// ---- float32 and bf16 at head size 256 on mma.sync ----
//
// Three kernels of one shape, four warps a block, each warp owning 16 rows
// (the M side of every product) and a block 64 (kRows):
//   * dv, then dk: a block owns (batch, KV head, 64 keys) and stages its K
//     (and V) once; q and dout arrive by cp.async in steps of BQ rows, ST
//     steps in flight, with each step's lse and delta, over the query heads
//     of its KV head in order and, within a head, the q rows that can see
//     its keys.  A warp computes s^T = K q^T for its 16 keys, p^T =
//     exp2(s^T scale log2e - lse log2e) and dv += p^T dout; or s^T and
//     dp^T = V dout^T, ds^T = p^T (dp^T - delta) and dk += ds^T q;
//   * dq: a block owns (batch, head, 64 q rows), stages q and dout once and
//     takes k and v in steps of BK keys; s = q K^T, dp = dout V^T, ds, dq +=
//     ds K.  q tiles are issued last-first, key tiles first to last, so the
//     longest causal walks start first.
// Eight products for the bound's five (s^T twice, dp twice), no atomic, and
// every sum in one order.  dv follows delta in stream order; dk and dq are
// programmatic dependents, so the long walks of all three launches share
// the card instead of each launch's tail waiting for its longest block.
//
// The products (the policy Tc<T>).  float32: each operand x split as hi =
// rna(x) to TF32 and lo = rna(x - hi), a product as hi.lo + lo.hi + hi.hi on
// mma.sync.m16n8k8 (tf32 in, float32 out), as flash_attention_f32.cu does;
// bf16: one mma.sync.m16n8k16 (bf16 in, float32 out), p and ds rounded to
// bf16 from the accumulator fragments as the wgmma route rounds them.  A
// 16-wide k unit is two TF32 k-steps or one bf16 k-step:
//   * over head dims (s, dp and their transposes): thread t reads 4 dims of
//     a row in one 16-byte (8-byte) load; float32 takes dims dc .. dc + 3 of
//     unit u, dc = 32 (u / 2) + 8 t + 4 (u % 2), as k slots t and t + 4 of
//     two k-steps; bf16 takes dc = 64 (u / 4) + 8 (u % 4) + 32 (t % 2) + 4
//     (t / 2) as k slots 2t, 2t + 1, 2t + 8, 2t + 9 (any bijection of dims
//     to k slots gives the same sum when A and B share it; these two keep
//     a quarter-warp's (half-warp's) loads on distinct banks);
//   * over rows (dv, dk, dq): the score accumulator's fragment (row g,
//     columns 2t, 2t + 1 of two 8-column tiles) is the A operand as it
//     stands, and B reads rows 2t, 2t + 1, 2t + 8, 2t + 9 of the 16-row unit
//     at 4 dims (32 mb + 4 g ..), one load a row for four 8-dim n-tiles; a
//     thread's output dims are then 8 t .. 8 t + 7 of each 32-dim block.
// The tensor core rounds its float32 sums toward zero, so a long run of
// products into one accumulator drifts (4 heads x 2,048 rows into one dv
// key: ~1,024 ulp, past the 1e-4 tolerance): a score's three products sum
// in three accumulators, and each (head, q step) of dv or dk, each key step
// of dq, is summed from 0 in a 32-dim block's own accumulator and added to
// the running float32 sum with one rounded add.
// Tiles are kept in the input type at a row stride of D plus 16 bytes.

constexpr int kMmaWarps = 4;
constexpr int kRows = 16 * kMmaWarps;   // keys a dv or dk block owns, q rows a dq block owns
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kScoreUnroll = 4;         // k units unrolled in a score product above D = 64

// Shared memory of a tile plan (kernel.py's smem_bytes_bwd_f32 for float):
// dv and dk K (and V) and ST steps of q, dout (BQ rows), lse and delta; dq
// q, dout and ST steps of K and V (BK rows).
template <typename T, int D, int BQ, int BK, int ST>
struct MmaPlan {
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kTile = static_cast<int>(sizeof(T)) * kLd;   // bytes a staged row
  static constexpr int kSmemDv = kRows * kTile + 2 * ST * BQ * kTile + 8 * ST * BQ;
  static constexpr int kSmemDk = kSmemDv + kRows * kTile;
  static constexpr int kSmemDq = 2 * kRows * kTile + 2 * ST * BK * kTile;
  static_assert(D % 32 == 0 && BQ % 16 == 0 && BK % 16 == 0 && ST >= 2, "tile shape");
  static_assert(sizeof(T) == 4 || D % 64 == 0, "bf16 takes head dims in blocks of 64");
  static_assert(kSmemDk <= 232448 && kSmemDq <= 232448, "tile plan exceeds shared memory");
};

// 16 bytes global -> shared, asynchronously; zeros when !ok (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of one head of a (.., S, heads, D) tensor into
// shared memory at row stride LD, 16 bytes a copy; rows at or past S are zeros
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void stage_tile(T* dst, const T* base, long long row_stride,
                                           long long row0, long long S) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  constexpr int kC = D / kE;
  for (int i = threadIdx.x; i < ROWS * kC; i += kMmaThreads) {
    const int r = i / kC, c = (i % kC) * kE;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * LD + c, ok ? base + (row0 + r) * row_stride + c : base, ok);
  }
}

// floats [row0, row0 + ROWS) of a row array of length S; zeros past S
template <int ROWS>
__device__ __forceinline__ void stage_floats(float* dst, const float* src, long long row0,
                                             long long S) {
  for (int i = threadIdx.x; i < ROWS; i += kMmaThreads) {
    const bool ok = row0 + i < S;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32
// for finite x), and x = hi + lo in two TF32 parts
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The product policy.  A 16-wide k unit's values, in k order: r0 of row g,
// r8 of row g + 8 (A), v of a B column.
template <typename T>
struct Tc;

// float32: 3xTF32; k-step s takes values 2s and 2s + 1 as slots t and t + 4
// (A registers (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B
// (slot t, col g), (t + 4, g)).
template <>
struct Tc<float> {
  static constexpr int kParts = 3;   // a score's accumulators: hi.lo, lo.hi, hi.hi
  struct A {
    uint32_t h[2][4], l[2][4];
  };
  struct B {
    uint32_t h[2][2], l[2][2];
  };
  struct Rows {   // rows 2t, 2t + 1, 2t + 8, 2t + 9 of a unit, 4 dims each
    float4 r[4];
  };
  static __device__ __forceinline__ int dcol(int u, int t) {
    return 32 * (u >> 1) + 8 * t + 4 * (u & 1);
  }
  static __device__ __forceinline__ A a_of(const float (&r0)[4], const float (&r8)[4]) {
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      split(r0[2 * s], a.h[s][0], a.l[s][0]);
      split(r8[2 * s], a.h[s][1], a.l[s][1]);
      split(r0[2 * s + 1], a.h[s][2], a.l[s][2]);
      split(r8[2 * s + 1], a.h[s][3], a.l[s][3]);
    }
    return a;
  }
  static __device__ __forceinline__ B b_of(const float (&v)[4]) {
    B b;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      split(v[2 * s], b.h[s][0], b.l[s][0]);
      split(v[2 * s + 1], b.h[s][1], b.l[s][1]);
    }
    return b;
  }
  static __device__ __forceinline__ A a_rows(const float* p0, const float* p8) {
    const float4 x = *reinterpret_cast<const float4*>(p0);
    const float4 y = *reinterpret_cast<const float4*>(p8);
    return a_of({x.x, x.y, x.z, x.w}, {y.x, y.y, y.z, y.w});
  }
  static __device__ __forceinline__ B b_row(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    return b_of({x.x, x.y, x.z, x.w});
  }
  // the A operand from two accumulator n-tiles (columns 2t, 2t + 1 of c0,
  // then of c1)
  static __device__ __forceinline__ A a_acc(const float (&c0)[4], const float (&c1)[4]) {
    return a_of({c0[0], c0[1], c1[0], c1[1]}, {c0[2], c0[3], c1[2], c1[3]});
  }
  static __device__ __forceinline__ Rows rows(const float* p, int ld) {
    const float4* x = reinterpret_cast<const float4*>(p);
    return Rows{{x[0], x[ld / 4], x[2 * ld], x[9 * ld / 4]}};
  }
  static __device__ __forceinline__ float lane_of(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ B b_rows(const Rows& x, int n) {
    return b_of({lane_of(x.r[0], n), lane_of(x.r[1], n), lane_of(x.r[2], n), lane_of(x.r[3], n)});
  }
  // c += a b in three products a k-step, the small terms first
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mma_tf32(c, a.h[s], b.l[s]);
      mma_tf32(c, a.l[s], b.h[s]);
      mma_tf32(c, a.h[s], b.h[s]);
    }
  }
  static __device__ __forceinline__ void mma_parts(float (&c)[3][4], const A& a, const B& b) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mma_tf32(c[0], a.h[s], b.l[s]);
      mma_tf32(c[1], a.l[s], b.h[s]);
      mma_tf32(c[2], a.h[s], b.h[s]);
    }
  }
  static __device__ __forceinline__ float total(const float (&c)[3][4], int i) {
    return __fadd_rn(__fadd_rn(c[0][i], c[1][i]), c[2][i]);
  }
  static __device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

// bf16: one m16n8k16; values 0, 1 are k slots 2t, 2t + 1 and values 2, 3
// slots 2t + 8, 2t + 9, a pair in one register, the lower k in the low half
// (A registers (row g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..);
// B (2t.., col g), (2t + 8.., g)).
template <>
struct Tc<__nv_bfloat16> {
  static constexpr int kParts = 1;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  struct Rows {
    uint2 r[4];
  };
  static __device__ __forceinline__ int dcol(int u, int t) {
    return 64 * (u >> 2) + 8 * (u & 3) + 32 * (t & 1) + 4 * (t >> 1);
  }
  static __device__ __forceinline__ A a_rows(const __nv_bfloat16* p0, const __nv_bfloat16* p8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p0);
    const uint2 y = *reinterpret_cast<const uint2*>(p8);
    return A{{x.x, y.x, x.y, y.y}};
  }
  static __device__ __forceinline__ B b_row(const __nv_bfloat16* p) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    return B{{x.x, x.y}};
  }
  static __device__ __forceinline__ A a_acc(const float (&c0)[4], const float (&c1)[4]) {
    return A{{pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]), pack_bf16(c1[0], c1[1]),
              pack_bf16(c1[2], c1[3])}};
  }
  static __device__ __forceinline__ Rows rows(const __nv_bfloat16* p, int ld) {
    const uint2* x = reinterpret_cast<const uint2*>(p);
    return Rows{{x[0], x[ld / 4], x[2 * ld], x[9 * ld / 4]}};
  }
  // dim n of two rows as a bf16 pair, the first row in the low half
  static __device__ __forceinline__ uint32_t pair(const uint2& lo, const uint2& hi, int n) {
    return __byte_perm(n < 2 ? lo.x : lo.y, n < 2 ? hi.x : hi.y, (n & 1) ? 0x7632 : 0x5410);
  }
  static __device__ __forceinline__ B b_rows(const Rows& x, int n) {
    return B{{pair(x.r[0], x.r[1], n), pair(x.r[2], x.r[3], n)}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
  static __device__ __forceinline__ void mma_parts(float (&c)[1][4], const A& a, const B& b) {
    mma(c[0], a, b);
  }
  static __device__ __forceinline__ float total(const float (&c)[1][4], int i) { return c[0][i]; }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                                float d) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
  }
};

// C (16 x 8 NT) = A B^T over D: A the warp's 16 rows (aw: its row g), B NT
// 8-row n-tiles of a tile (bt: its row 0); both (rows, D) tiles at stride LD
template <typename T, int D, int NT, int LD>
__device__ __forceinline__ void score(float (&c)[NT][Tc<T>::kParts][4], const T* aw,
                                      const T* bt, int t, int g) {
  using Op = Tc<T>;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < Op::kParts; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][p][i] = 0.f;
#pragma unroll(D <= 64 ? D / 16 : kScoreUnroll)
  for (int u = 0; u < D / 16; ++u) {
    const int dc = Op::dcol(u, t);
    const typename Op::A a = Op::a_rows(aw + dc, aw + 8 * LD + dc);
#pragma unroll
    for (int j = 0; j < NT; ++j) Op::mma_parts(c[j], a, Op::b_row(bt + (8 * j + g) * LD + dc));
  }
}

// acc (16 x D) += P X, P (16 x KR) in accumulator fragments, X KR rows of a
// (rows, D) tile at stride LD: each 32-dim block's share summed from 0,
// then added to acc in one rounding.  acc[mb][n][2 r + c] is row g + 8 r,
// dim 32 mb + 8 t + 4 c + n.
template <typename T, int D, int KR, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[D / 32][4][4], const float (&p)[KR / 8][4],
                                           const T* x, int t, int g) {
  using Op = Tc<T>;
  typename Op::A a[KR / 16];
#pragma unroll
  for (int u = 0; u < KR / 16; ++u) a[u] = Op::a_acc(p[2 * u], p[2 * u + 1]);
#pragma unroll
  for (int mb = 0; mb < D / 32; ++mb) {
    float part[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
    for (int u = 0; u < KR / 16; ++u) {
      const typename Op::Rows r = Op::rows(x + (16 * u + 2 * t) * LD + 32 * mb + 4 * g, LD);
#pragma unroll
      for (int n = 0; n < 4; ++n) Op::mma(part[n], a[u], Op::b_rows(r, n));
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][n][i] = __fadd_rn(acc[mb][n][i], part[n][i]);
  }
}

// a warp's 16 rows (row0: its row g) of acc to (.., S, heads, D) memory,
// times mul; rows at or past S skipped
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, long long row0,
                                           long long S, const float (&acc)[D / 32][4][4],
                                           float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + 8 * r;
    if (row >= S) continue;
    T* dst = base + row * row_stride + 8 * t;
#pragma unroll
    for (int mb = 0; mb < D / 32; ++mb)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        Tc<T>::store4(dst + 32 * mb + 4 * c, acc[mb][0][2 * r + c] * mul,
                      acc[mb][1][2 * r + c] * mul, acc[mb][2][2 * r + c] * mul,
                      acc[mb][3][2 * r + c] * mul);
  }
}

// dv (kDK false) or dk (kDK true) of kRows keys.
template <typename T, int D, int BQ, int ST, bool kDK>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ out, int Sq, int Skv, int H,
                 int KV, int causal, int has_window, long long window, float scale) {
  using Op = Tc<T>;
  constexpr int kLd = MmaPlan<T, D, BQ, 16, ST>::kLd;
  constexpr int kNT = BQ / 8;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + kRows * kLd;                            // dk only
  T* Qs = Ks + (kDK ? 2 : 1) * kRows * kLd;           // step s at Qs + s BQ kLd
  T* Os = Qs + ST * BQ * kLd;                          // dout, likewise
  float* Ls = reinterpret_cast<float*>(Os + ST * BQ * kLd);   // lse of step s at Ls + s BQ
  float* Ds = Ls + ST * BQ;                                    // delta, likewise (dk)

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long k0 = static_cast<long long>(blockIdx.y) * kRows;
  const long long kw0 = k0 + 16 * warp;                // this warp's keys
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const float scale_log2 = scale * kLog2e;
  const int win = has_window ? static_cast<int>(max(min(window, 1LL << 30), -(1LL << 30)))
                             : 1 << 30;

  // the q rows that may see a key of this block, in steps of BQ, for each
  // query head of the group in order
  long long qlo = causal ? k0 : 0, qhi = Sq;
  if (has_window) qhi = min(qhi, k0 + kRows - 1 + window);
  qlo = qlo / BQ * BQ;
  const int n_qt = qhi > qlo ? static_cast<int>((qhi - qlo + BQ - 1) / BQ) : 0;
  const long long n_it = static_cast<long long>(G) * n_qt;

  int st_g = 0, st_qt = 0;   // the next step to stage: query head st_g of the group, q step st_qt
  auto stage_step = [&](int s) {
    const int h = kvh * G + st_g;
    const long long q0 = qlo + static_cast<long long>(st_qt) * BQ;
    if (++st_qt == n_qt) {
      st_qt = 0;
      ++st_g;
    }
    const long long q_off = (static_cast<long long>(b) * Sq * H + h) * D;
    const long long r_off = (static_cast<long long>(b) * H + h) * Sq;
    stage_tile<T, D, BQ, kLd>(Qs + s * BQ * kLd, q + q_off, q_stride, q0, Sq);
    stage_tile<T, D, BQ, kLd>(Os + s * BQ * kLd, dout + q_off, q_stride, q0, Sq);
    stage_floats<BQ>(Ls + s * BQ, lse + r_off, q0, Sq);
    if (kDK) stage_floats<BQ>(Ds + s * BQ, delta + r_off, q0, Sq);
  };

  // K (and V) with the first ST - 1 steps: one commit group a step
  stage_tile<T, D, kRows, kLd>(Ks, k + kv_off, kv_stride, k0, Skv);
  if (kDK) stage_tile<T, D, kRows, kLd>(Vs, v + kv_off, kv_stride, k0, Skv);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_it) stage_step(i);
    cp_async_commit();
  }
  // the next launch of the backward may start on SMs this grid leaves idle
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  float acc[D / 32][4][4];
#pragma unroll
  for (int mb = 0; mb < D / 32; ++mb)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][n][i] = 0.f;

  int qt = 0;   // this step's q step
  const T* Kw = Ks + (16 * warp + g) * kLd;
  const T* Vw = Vs + (16 * warp + g) * kLd;
  for (long long it = 0; it < n_it; ++it) {
    {   // the step ST - 1 ahead, into the slot the last iteration read
      const long long ahead = it + ST - 1;
      if (ahead < n_it) stage_step(static_cast<int>(ahead % ST));
      cp_async_commit();
    }
    cp_async_wait<ST - 1>();
    __syncthreads();
    const int s = static_cast<int>(it % ST);
    const long long q0 = qlo + static_cast<long long>(qt) * BQ;
    if (++qt == n_qt) qt = 0;
    // no pair of this warp's keys and the step's rows is seen
    const bool none = kw0 >= Skv || (causal && q0 + BQ - 1 < kw0) ||
                      (has_window && q0 >= kw0 + 15 + window);
    if (!none) {
      const T* Qt = Qs + s * BQ * kLd;
      const T* Ot = Os + s * BQ * kLd;
      const float* L = Ls + s * BQ;
      const bool full = q0 + BQ <= Sq && kw0 + 16 <= Skv && (!causal || kw0 + 15 <= q0) &&
                        (!has_window || kw0 > q0 + BQ - 1 - window);
      // s^T = K q^T; p^T: element i of n-tile j is key kw0 + g + 8 (i / 2),
      // q row q0 + 8 j + 2 t + i % 2
      float st[kNT][Op::kParts][4];
      score<T, D, kNT, kLd>(st, Kw, Qt, t, g);
      float p[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = 8 * j + 2 * t + (i & 1);
          float x = exp2f(fmaf(Op::total(st[j], i), scale_log2, -L[qi] * kLog2e));
          if (!full && !seen(static_cast<int>(q0) + qi, static_cast<int>(kw0) + g + 8 * (i >> 1),
                             Sq, Skv, causal, win))
            x = 0.f;
          p[j][i] = x;
        }
      if (kDK) {   // ds^T = p^T (dp^T - delta), dp^T = V dout^T
        const float* Dl = Ds + s * BQ;
        score<T, D, kNT, kLd>(st, Vw, Ot, t, g);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[j][i] *= Op::total(st[j], i) - Dl[8 * j + 2 * t + (i & 1)];
      }
      accumulate<T, D, BQ, kLd>(acc, p, kDK ? Qt : Ot, t, g);   // dv += p^T dout, dk += ds^T q
    }
    __syncthreads();   // every warp is done with this slot before it is refilled
  }
  cp_async_wait<0>();
  store_rows<T, D>(out + kv_off, kv_stride, kw0 + g, Skv, acc, kDK ? scale : 1.f, t);
  // finish no earlier than the launch before, so that the backward's last
  // launch completes after all of them
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// dq of kRows q rows of one head.
template <typename T, int D, int BK, int ST>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int H,
                int KV, int causal, int has_window, long long window, float scale) {
  using Op = Tc<T>;
  constexpr int kLd = MmaPlan<T, D, 16, BK, ST>::kLd;
  constexpr int kNT = BK / 8;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Os = Qs + kRows * kLd;
  T* Ks = Os + kRows * kLd;        // step s at Ks + s BK kLd
  T* Vs = Ks + ST * BK * kLd;      // likewise

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kRows;
  const long long qw0 = q0 + 16 * warp;                // this warp's rows
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long q_off = (static_cast<long long>(b) * Sq * H + h) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const long long r_off = (static_cast<long long>(b) * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;
  const int win = has_window ? static_cast<int>(max(min(window, 1LL << 30), -(1LL << 30)))
                             : 1 << 30;

  // the kv steps that hold a key some row of this tile may see
  long long lo = 0, hi = Skv;
  if (causal) hi = min(hi, q0 + kRows);
  if (has_window) lo = max(0LL, q0 - window + 1);
  lo = lo / BK * BK;
  const long long n_it = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  auto stage_step = [&](long long it, int s) {
    stage_tile<T, D, BK, kLd>(Ks + s * BK * kLd, k + kv_off, kv_stride, lo + it * BK, Skv);
    stage_tile<T, D, BK, kLd>(Vs + s * BK * kLd, v + kv_off, kv_stride, lo + it * BK, Skv);
  };
  // delta was complete before the dv launch began: this launch reads it
  // before any griddepcontrol.wait
  stage_tile<T, D, kRows, kLd>(Qs, q + q_off, q_stride, q0, Sq);
  stage_tile<T, D, kRows, kLd>(Os, dout + q_off, q_stride, q0, Sq);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_it) stage_step(i, i);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // this thread's rows qw0 + g + 8 r: lse (log2 units) and delta
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = qw0 + g + 8 * r;
    L[r] = row < Sq ? lse[r_off + row] * kLog2e : 0.f;
    Dl[r] = row < Sq ? delta[r_off + row] : 0.f;
  }
  float acc[D / 32][4][4];
#pragma unroll
  for (int mb = 0; mb < D / 32; ++mb)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][n][i] = 0.f;

  const T* Qw = Qs + (16 * warp + g) * kLd;
  const T* Ow = Os + (16 * warp + g) * kLd;
  for (long long it = 0; it < n_it; ++it) {
    {
      const long long ahead = it + ST - 1;
      if (ahead < n_it) stage_step(ahead, static_cast<int>(ahead % ST));
      cp_async_commit();
    }
    cp_async_wait<ST - 1>();
    __syncthreads();
    const int s = static_cast<int>(it % ST);
    const long long kv0 = lo + it * BK;
    const bool none = qw0 >= Sq || (causal && kv0 > qw0 + 15) ||
                      (has_window && kv0 + BK - 1 <= qw0 - window);
    if (!none) {
      const T* Kt = Ks + s * BK * kLd;
      const bool full = qw0 + 16 <= Sq && kv0 + BK <= Skv &&
                        (!causal || kv0 + BK - 1 <= qw0) &&
                        (!has_window || kv0 > qw0 + 15 - window);
      // s = q K^T; p: element i of n-tile j is row qw0 + g + 8 (i / 2), key
      // kv0 + 8 j + 2 t + i % 2
      float sc[kNT][Op::kParts][4];
      score<T, D, kNT, kLd>(sc, Qw, Kt, t, g);
      float p[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = exp2f(fmaf(Op::total(sc[j], i), scale_log2, -L[i >> 1]));
          if (!full && !seen(static_cast<int>(qw0) + g + 8 * (i >> 1),
                             static_cast<int>(kv0) + 8 * j + 2 * t + (i & 1), Sq, Skv, causal,
                             win))
            x = 0.f;
          p[j][i] = x;
        }
      // ds = p (dp - delta), dp = dout V^T
      score<T, D, kNT, kLd>(sc, Ow, Vs + s * BK * kLd, t, g);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[j][i] *= Op::total(sc[j], i) - Dl[i >> 1];
      accumulate<T, D, BK, kLd>(acc, p, Kt, t, g);   // dq += ds K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<T, D>(dq + q_off, q_stride, qw0 + g, Sq, acc, scale, t);
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// delta, then dv, dk and dq.
template <typename T, int D, int BQ, int BK, int ST>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Skv, int H, int KV, int causal,
                       int has_window, long long window, float scale, cudaStream_t stream) {
  using P = MmaPlan<T, D, BQ, BK, ST>;
  const long long kv_tiles = (Skv + kRows - 1) / kRows, q_tiles = (Sq + kRows - 1) / kRows;
  if (kv_tiles > 65535 || q_tiles > 65535) return cudaErrorInvalidValue;
  auto dvk = attn_bwd_dkv_mma<T, D, BQ, ST, false>;
  auto dkk = attn_bwd_dkv_mma<T, D, BQ, ST, true>;
  auto dqk = attn_bwd_dq_mma<T, D, BK, ST>;
  cudaError_t err = cudaFuncSetAttribute(dvk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::kSmemDv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkk, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemDk);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemDq);
  if (err != cudaSuccess) return err;

  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
  attn_bwd_delta<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, Sq, H, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dv follows delta in plain stream order, so delta is complete before dk
  // and dq read it; dk and dq are programmatic dependents of the launch
  // before them (none reads another's output), so the longest causal
  // walks of all three run side by side
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kMmaThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cdelta = delta;
  if (Skv > 0) {
    cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(KV),
                       static_cast<unsigned>(kv_tiles));
    cfg.dynamicSmemBytes = P::kSmemDv;
    err = cudaLaunchKernelEx(&cfg, dvk, tq, tk, tv, tdo, lse, cdelta, static_cast<T*>(dv), Sq,
                             Skv, H, KV, causal, has_window, window, scale);
    if (err != cudaSuccess) return err;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.dynamicSmemBytes = P::kSmemDk;
    err = cudaLaunchKernelEx(&cfg, dkk, tq, tk, tv, tdo, lse, cdelta, static_cast<T*>(dk), Sq,
                             Skv, H, KV, causal, has_window, window, scale);
    if (err != cudaSuccess) return err;
  }
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                     static_cast<unsigned>(q_tiles));
  cfg.dynamicSmemBytes = P::kSmemDq;
  return cudaLaunchKernelEx(&cfg, dqk, tq, tk, tv, tdo, lse, cdelta, static_cast<T*>(dq), Sq,
                            Skv, H, KV, causal, has_window, window, scale);
}

// float32 at head size D on plan (BQ, BK, ST), and bf16 on the same plan
// at D = 256
template <int D, int BQ, int BK, int ST>
cudaError_t launch_plan(int is_bf16, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, float* delta,
                        void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                        int causal, int has_window, long long window, float scale,
                        cudaStream_t st) {
  if constexpr (D == 256) {
    if (is_bf16)
      return launch_mma<__nv_bfloat16, D, BQ, BK, ST>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                      B, Sq, Skv, H, KV, causal, has_window,
                                                      window, scale, st);
  }
  if (is_bf16) return cudaErrorInvalidValue;
  return launch_mma<float, D, BQ, BK, ST>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                                          H, KV, causal, has_window, window, scale, st);
}
}  // namespace

// Plain C entry point for ctypes.  q, o, dout and dq are contiguous (B, Sq,
// H, D), k, v, dk and dv (B, Skv, KV, D), all bf16 (is_bf16) or all float32;
// lse is the forward's float32 (B, H, Sq) row log-sum-exp (natural log; -inf
// on a row with no valid key) and delta a float32 (B, H, Sq) scratch array;
// D is 32, 64, 128 or 256, H a multiple of KV.  window is used when
// has_window is set; scale is 1 / sqrt(D).  The stream is PyTorch's current
// stream.  bf16 arrays are 16-byte aligned.  Returns 0, the cudaError_t of
// the launches, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int H, int KV, int D, int is_bf16,
                                          int causal, int has_window, long long window,
                                          float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Skv < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (is_bf16 && Skv > 0 && D == 128)
    return launch_wgmma<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                             has_window, window, scale, st, 15);
  if (is_bf16 && Skv > 0 && D == 64)
    return launch_wgmma<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                            has_window, window, scale, st, 15);
  if (is_bf16 && Skv > 0 && D == 32)
    return launch_wgmma<32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                            has_window, window, scale, st, 15);
  // float32, and bf16 at D = 256: the tile plans of kernel.py's TILE_PLAN_BWD_F32
#define FA_BWD_F32_PLAN(d, bq, bk, stages)                                                  \
  if (D == d)                                                                             \
    return static_cast<int>(launch_plan<d, bq, bk, stages>(is_bf16, q, k, v, o, dout, l, dl, \
                                                           dq, dk, dv, B, Sq, Skv, H, KV,   \
                                                           causal, has_window, window,      \
                                                           scale, st));
  FA_BWD_F32_PLAN(32, 32, 32, 2)
  FA_BWD_F32_PLAN(64, 32, 32, 2)
  FA_BWD_F32_PLAN(128, 16, 16, 2)
  FA_BWD_F32_PLAN(256, 16, 16, 2)
#undef FA_BWD_F32_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core route's launches one by one, for timing each: the
// arguments of flash_attention_bwd_launch (bf16, D 32, 64 or 128, Skv > 0)
// and parts, a mask of 1 (delta), 2 (dv), 4 (dk, which reads delta) and 8
// (dq, which reads it too).
extern "C" int flash_attention_bwd_launch_parts(const void* q, const void* k, const void* v,
                                                const void* o, const void* dout,
                                                const void* lse, void* delta, void* dq,
                                                void* dk, void* dv, int B, int Sq, int Skv,
                                                int H, int KV, int D, int causal,
                                                int has_window, long long window, float scale,
                                                void* stream, int parts) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
#define FA_BWD_PARTS(d)                                                                     \
  if (D == d)                                                                               \
    return launch_wgmma<d>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal, \
                           has_window, window, scale, st, parts);
  FA_BWD_PARTS(32)
  FA_BWD_PARTS(64)
  FA_BWD_PARTS(128)
#undef FA_BWD_PARTS
  return static_cast<int>(cudaErrorInvalidValue);
}
