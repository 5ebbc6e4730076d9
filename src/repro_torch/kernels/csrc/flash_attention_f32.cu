// flash_attention_f32 — blocked online-softmax attention in float32 on
// Hopper's tensor cores, three TF32 products per product (3xTF32), for
// sm_90a.
//
// Replaces, for float32 q, k and v, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:27 (_attn_kernel, launched by
// flash_attention_bhsd; GQA expanded by ops.py); bfloat16 inputs go to the
// kernel of flash_attention_bf16.cu.
// For q (B, Sq, H, D) and k, v (B, Skv, KV, D), query head h reads KV head
// h / (H / KV) (the order of ops.py's jnp.repeat), and
//
//     s[i, j] = (q_i . k_j) / sqrt(D)              in float32
//     mask    = j < Skv  [&& j <= i  (causal, top-left: q counted from 0)]
//                        [&& j > i - window  (one-sided window)]
//     out_i   = sum_j p_ij v_j / max(sum_j p_ij, 1e-30)
//
// with p = exp(s - running max) where the mask holds and exactly 0 where it
// does not (exp2 of the score times log2(e) / sqrt(D)); masked scores are
// -1e30, not -inf, so a row with no valid key keeps l = 0 and acc = 0 and
// writes exactly 0.
//
// The products.  One TF32 rounding of an operand keeps 11 significant bits,
// and a one-product TF32 kernel misses the float32 tolerance of 2e-5 by an
// order of magnitude or more (tests/test_torch_flash_attention.py shows it).  So each float32
// operand x is split as x_hi = rna(x) to TF32 and x_lo = rna(x - x_hi)
// (cvt.rna.tf32.f32's rounding; x - x_hi is exact), and each product A B
// is formed as A_hi B_lo + A_lo B_hi + A_hi B_hi, the small terms first,
// accumulated in float32 by mma.sync.m16n8k8 (tf32 in, float32 out): the
// method of SDPA's memory-efficient back end (CUTLASS's OpMultiplyAddFastF32).
// It carries each operand to ~22 bits; the missing A_lo B_lo term is below
// 2^-22 of the product.  Both products S = Q K^T and O += P V are formed so;
// the softmax (scale, mask, running max, exp, sums, rescaling, the final
// division) stays in float32 on the CUDA cores.  The tensor core rounds the
// float32 sum of each mma toward zero, so a long run of same-signed products
// into one accumulator drifts: S keeps its three products in three
// accumulators over the D / 8 k-steps and adds them at the end, and each kv
// tile's P V is summed from 0 in its own accumulator and added to O with one
// rounded FMA (O = O * corr + P V).
//
// The blocks.  The TPU kernel walked a (B*H, q-block, kv-block) grid in order
// and carried m, l and acc across the kv steps in VMEM scratch.  Here blocks
// run in no order on 132 SMs, so one block of four warps owns one (batch *
// head, 64-row q tile); each warp owns 16 q rows and loops over the block's
// kv tiles, with m, l, the scores and O in registers; the output tile is
// written once, without atomics.  K and V are read straight from their KV
// head (no repeated copy).  The kv loop visits only tiles that hold a key
// some row of the q tile may see: [max(0, q0 - window + 1), min(Skv, q0 +
// 64)) under causal and window (the TPU kernel's pl.when), and masks only
// tiles that cross the diagonal, the window's edge or Skv.  q tiles are
// issued last-first so the longest causal rows start first.
//
// Per kv tile of BK rows (kernel.py's TILE_PLAN_F32 per D): K and V arrive in
// shared memory by cp.async, ST tiles in flight (Q once, with the first);
// rows past the sequence arrive as zeros.  The fragments are read with
// 16-byte loads and split in registers (each Q fragment once per kv tile and
// 16 head dims, each K and V fragment once where it is used):
//   * S = Q K^T: a k-step of 8 head dims takes dims {4t, 4t+1} (+ 16 jb) of
//     thread t as its k slots t and t + 4, the next k-step {4t+2, 4t+3}, so
//     one float4 of a Q row and one of a K row serve two k-steps (any
//     bijection of dims to k slots gives the same sum if A and B share it);
//   * O += P V: the scores' accumulator fragment (row g, columns 2t, 2t+1)
//     is used as the A fragment directly, by taking kv 2t and 2t + 1 of the
//     8-key step as its k slots t and t + 4; V's B fragment then reads rows
//     2t and 2t + 1, and four n-tiles of 8 output dims take dims 4g .. 4g+3
//     of a 32-dim block, one float4 each; a thread's output dims are then
//     8t .. 8t+7 of each 32-dim block, written as two float4.
// Row strides are padded (Q and K by 16 floats, V by 4) so each 16-byte
// fragment load of a quarter-warp hits 32 distinct banks.
//
// What bounds it on an H100: operations.  A causal prefill does
// 4 * D * (pairs kept) FLOP; at 4 x 4,096 tokens of qwen3-4b (H = 32, D =
// 128) that is 5.50e11 FLOP, and three TF32 products make it 1.65e12 on the
// tensor cores (495 TFLOP/s dense: 3.33 ms); on the float32 CUDA cores (67
// TFLOP/s) the one product would take 8.21 ms.  mma.sync reaches part of the
// TF32 rate that wgmma does, and the splits (a few ALU instructions an
// element) and the softmax share the issue slots with it.  wgmma takes TF32
// only K-major, so P V would need V transposed in shared memory: a later
// step if this one falls short.
//
// Offsets are 64-bit.  The launcher raises the per-kernel shared-memory
// limit once per device and returns any error.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;   // q rows per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

template <int D, int BK, int ST>
struct Plan {
  static constexpr int kLdQK = D + 16;   // row stride of the Q and K tiles
  static constexpr int kLdV = D + 4;     // row stride of the V tiles
  static constexpr int kQ = kBQ * kLdQK;
  static constexpr int kK = BK * kLdQK;
  static constexpr int kV = BK * kLdV;
  // Q, then ST K tiles, then ST V tiles (kernel.py's smem_bytes_f32)
  static constexpr int kSmem = 4 * (kQ + ST * (kK + kV));
  static_assert(D % 32 == 0 && BK % 8 == 0 && BK <= 64 && ST >= 2, "tile shape");
  static_assert(kSmem <= 232448, "tile plan exceeds shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (nothing read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one head of a (.., S, heads, D) tensor into
// shared memory, row stride LD; rows at or past S are zeros.  Thread i
// copies 16 bytes of column (i % (D / 4)) * 4 in rows i / (D / 4) + k *
// (kThreads / (D / 4)).
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const float* base, long long row_stride,
                                      long long row0, long long S) {
  constexpr int kC4 = D / 4;
  constexpr int kRows = kThreads / kC4;   // rows a pass of the block covers
  static_assert(kThreads % kC4 == 0 && ROWS % kRows == 0, "staging layout");
  const int r = threadIdx.x / kC4, c = (threadIdx.x % kC4) * 4;
  const float* src = base + (row0 + r) * row_stride + c;
#pragma unroll
  for (int k = 0; k < ROWS / kRows; ++k) {
    const bool ok = row0 + r + k * kRows < S;
    cp_async16(dst + (r + k * kRows) * LD + c, ok ? src + k * kRows * row_stride : base, ok);
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32 for finite x, as two integer instructions (the cvt
// itself lowers to a longer sequence that also handles NaN and infinity)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each TF32: hi carries x's top 11 significant bits, lo the
// next 11 (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b: the first product of a sum, C from the zero register (no moves
// to clear an accumulator)
__device__ __forceinline__ void mma_first(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// c += a b in three TF32 products, the small terms first (c = a b when
// first)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2], bool first) {
  if (first)
    mma_first(c, ah, bl);
  else
    mma(c, ah, bl);
  mma(c, al, bh);
  mma(c, ah, bh);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int D, int BK, int ST>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Skv, int H, int KV, int causal,
                       int has_window, long long window, float scale_log2) {
  using P = Plan<D, BK, ST>;
  constexpr int kNT = BK / 8;     // score n-tiles (8 keys) per kv tile
  constexpr int kMB = D / 32;     // 32-dim blocks of O
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + P::kQ;         // ST K tiles
  float* Vs = Ks + ST * P::kK;    // ST V tiles

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const float* qb = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const float* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  float* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;

  // the kv tiles that hold a key some row of this q tile may see
  long long lo = 0, hi = Skv;
  if (causal) hi = min(hi, q0 + kBQ);
  if (has_window) lo = max(0LL, q0 - window + 1);
  lo = lo / BK * BK;
  const int n_tiles = hi > lo ? static_cast<int>((hi - lo + BK - 1) / BK) : 0;

  // Q with the first ST - 1 kv tiles: one commit group per tile
  stage<D, kBQ, P::kLdQK>(Qs, qb, q_stride, q0, Sq);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) {
      stage<D, BK, P::kLdQK>(Ks + i * P::kK, kb, kv_stride, lo + i * BK, Skv);
      stage<D, BK, P::kLdV>(Vs + i * P::kV, vb, kv_stride, lo + i * BK, Skv);
    }
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kMB][4][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][n][i] = 0.f;

  const float* Qw = Qs + (16 * warp + g) * P::kLdQK + 4 * t;   // row g; row g + 8 below
  for (int it = 0; it < n_tiles; ++it) {
    const long long kv0 = lo + static_cast<long long>(it) * BK;
    {   // the tile ST - 1 ahead, into the slot the last iteration read
      const int ahead = it + ST - 1;
      if (ahead < n_tiles) {
        stage<D, BK, P::kLdQK>(Ks + (ahead % ST) * P::kK, kb, kv_stride, lo + ahead * BK, Skv);
        stage<D, BK, P::kLdV>(Vs + (ahead % ST) * P::kV, vb, kv_stride, lo + ahead * BK, Skv);
      }
      cp_async_commit();
    }
    cp_async_wait<ST - 1>();
    __syncthreads();
    const float* Kt = Ks + (it % ST) * P::kK + g * P::kLdQK + 4 * t;
    const float* Vt = Vs + (it % ST) * P::kV + 2 * t * P::kLdV + 4 * g;

    // S = Q K^T (16 rows x BK keys a warp), two k-steps per 16 head dims;
    // the three products in three accumulators (more independent chains,
    // and each sum only of its own terms), added small terms first
    float s[kNT][4], s_hl[kNT][4], s_lh[kNT][4];
#pragma unroll(D <= 128 ? D / 16 : 2)
    for (int jb = 0; jb < D / 16; ++jb) {
      const float4 qa = *reinterpret_cast<const float4*>(Qw + 16 * jb);
      const float4 qc = *reinterpret_cast<const float4*>(Qw + 8 * P::kLdQK + 16 * jb);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        split(lane_of(qa, 2 * ks), ah[ks][0], al[ks][0]);       // row g, slot t
        split(lane_of(qc, 2 * ks), ah[ks][1], al[ks][1]);       // row g + 8, slot t
        split(lane_of(qa, 2 * ks + 1), ah[ks][2], al[ks][2]);   // row g, slot t + 4
        split(lane_of(qc, 2 * ks + 1), ah[ks][3], al[ks][3]);   // row g + 8, slot t + 4
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(Kt + 8 * j * P::kLdQK + 16 * jb);
        uint32_t bh_[2][2], bl_[2][2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          split(lane_of(kk, 2 * ks), bh_[ks][0], bl_[ks][0]);
          split(lane_of(kk, 2 * ks + 1), bh_[ks][1], bl_[ks][1]);
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if (jb == 0 && ks == 0) {
            mma_first(s_hl[j], ah[ks], bl_[ks]);
            mma_first(s_lh[j], al[ks], bh_[ks]);
            mma_first(s[j], ah[ks], bh_[ks]);
          } else {
            mma(s_hl[j], ah[ks], bl_[ks]);
            mma(s_lh[j], al[ks], bh_[ks]);
            mma(s[j], ah[ks], bh_[ks]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = __fadd_rn(__fadd_rn(s_hl[j][i], s_lh[j][i]), s[j][i]);

    // scale, mask, online softmax update: this thread holds rows g (r = 0)
    // and g + 8 (r = 1), keys kv0 + 8 j + 2 t + c
    const bool full = kv0 + BK <= Skv && (!causal || kv0 + BK - 1 <= q0) &&
                      (!has_window || kv0 > q0 + kBQ - 1 - window);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long qp = q0 + 16 * warp + g + 8 * r;
      uint32_t keep = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long long kp = kv0 + 8 * j + 2 * t + c;
          bool ok = full;
          if (!full) {
            ok = kp < Skv;
            if (causal) ok = ok && kp <= qp;
            if (has_window) ok = ok && kp > qp - window;
          }
          keep |= static_cast<uint32_t>(ok) << (2 * j + c);
          float& x = s[j][2 * r + c];
          x = ok ? x * scale_log2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * r + c];
          x = (keep >> (2 * j + c)) & 1u ? exp2f(x - m_new) : 0.f;   // s now holds p
          sum += x;
        }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      corr[r] = exp2f(m[r] - m_new);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }

    // O = O corr + P V.  The tile's P V is summed in its own accumulator,
    // from 0, and added to O by one rounded FMA: the tensor core rounds
    // its float32 sums toward zero, so adding every tile's products into
    // one accumulator drifts by up to an ulp of O per product (on an H100,
    // 1.7e-4 of the output at 4,096 keys of one sign), while a tile's
    // 3 BK / 8 products drift by ~1e-6 of its own share.  k-step j is keys
    // 8 j .. 8 j + 7, P's fragment as A.
    float pv[kMB][4][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);   // row g, key 2t: slot t
      split(s[j][2], ph[1], pl[1]);   // row g + 8, key 2t
      split(s[j][1], ph[2], pl[2]);   // row g, key 2t + 1: slot t + 4
      split(s[j][3], ph[3], pl[3]);   // row g + 8, key 2t + 1
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const float4 v0 = *reinterpret_cast<const float4*>(Vt + 8 * j * P::kLdV + 32 * mb);
        const float4 v1 =
            *reinterpret_cast<const float4*>(Vt + (8 * j + 1) * P::kLdV + 32 * mb);
#pragma unroll
        for (int n = 0; n < 4; ++n) {   // n-tile n: dim 32 mb + 4 g + n
          uint32_t bh_[2], bl_[2];
          split(lane_of(v0, n), bh_[0], bl_[0]);
          split(lane_of(v1, n), bh_[1], bl_[1]);
          mma3(pv[mb][n], ph, pl, bh_, bl_, j == 0);
        }
      }
    }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mb][n][i] = __fmaf_rn(acc[mb][n][i], corr[i >> 1], pv[mb][n][i]);
    __syncthreads();   // every warp is done with this slot before it is refilled
  }
  cp_async_wait<0>();

  // the row log-sum-exp, when asked for: ln 2 (m + log2 l), -inf on a row
  // with no valid key (l = 0); m and l are the quad's, in every lane
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long qp = q0 + 16 * warp + g + 8 * r;
      if (qp < Sq)
        lse[(static_cast<long long>(b) * H + h) * Sq + qp] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -CUDART_INF_F;
    }
  }

  // acc[mb][n][2r + c] is row g + 8r, dim 32 mb + 8 t + 4 c + n
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long qp = q0 + 16 * warp + g + 8 * r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* row = ob + qp * q_stride + 8 * t;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<float4*>(row + 32 * mb + 4 * c) =
            make_float4(acc[mb][0][2 * r + c] / denom, acc[mb][1][2 * r + c] / denom,
                        acc[mb][2][2 * r + c] / denom, acc[mb][3][2 * r + c] / denom);
  }
}

template <int D, int BK, int ST>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int KV, int causal, int has_window, long long window,
                   float scale_log2, cudaStream_t stream) {
  using P = Plan<D, BK, ST>;
  auto kernel = flash_attention_kernel<D, BK, ST>;
  // the shared-memory limit is raised once per device
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    raised[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                  static_cast<unsigned>((Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, P::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, H, KV, causal, has_window, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  q, k, v and out are contiguous float32
// device arrays in the model's layout, q and out (B, Sq, H, D), k and v
// (B, Skv, KV, D), 16-byte aligned; (D, bk, stages) is one of the tile plans
// below (kernel.py's TILE_PLAN_F32), H a multiple of KV, Sq / 64 at most
// 65535.  window is used when has_window is set.  lse, when not null, is a
// float32 (B, H, Sq) array that receives each row's log-sum-exp of its
// scaled scores (natural log; -inf on a row with no valid key), which the
// backward (flash_attention_bwd.cu) reads; the output is the same either
// way.  The stream is PyTorch's current stream.  Returns the cudaError_t of
// the launch.
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                                          void* out, int B, int Sq, int Skv, int H, int KV,
                                          int D, int bk, int stages, int causal,
                                          int has_window, long long window,
                                          float scale_log2, void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Skv < 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define FA32_PLAN(d, b, s)                                                                  \
  if (D == d && bk == b && stages == s)                                                   \
    return static_cast<int>(launch<d, b, s>(q, k, v, out, static_cast<float*>(lse), B, Sq,  \
                                            Skv, H, KV, causal, has_window, window,       \
                                            scale_log2, st));
  FA32_PLAN(32, 64, 2)
  FA32_PLAN(64, 64, 2)
  FA32_PLAN(128, 32, 2)
  FA32_PLAN(256, 32, 2)
#undef FA32_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}
