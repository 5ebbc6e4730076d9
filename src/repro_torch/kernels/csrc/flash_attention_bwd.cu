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
//   * bf16 at head sizes 32, 64 and 128 (qwen3-4b's path): the five
//     products on the tensor cores as mma.sync m16n8k16 (bf16 in, float32
//     accumulate), p and ds rounded to bf16 as the A operand of the next
//     product, operands read with ldmatrix (see the section below);
//   * float32, and bf16 at head size 256: every product on the CUDA cores
//     in float32 (the float32 gradient gate's route).
//
// Three launches, none with an atomic, so the gradient repeats bit for bit:
//   1. delta, one warp per (b, i, h) row;
//   2. dk and dv: one block per (batch * KV head, BK-key tile), which
//      recomputes p from q, k and lse for every q tile that can see its
//      keys, and loops over the query heads of its KV head in order, so
//      the GQA sum has one fixed order;
//   3. dq: one block per (batch * head, BQ-row q tile), looping over the
//      kv tiles its rows can see (issued last-first, as in the forward, so
//      the longest causal rows start first).
// On the CUDA-core route a thread owns a 16 x 16 lattice of a tile: scores (i, j) = (ty + 16 a,
// tx + 16 b), and output (row, dim) = (ty + 16 a, tx + 16 b), in registers;
// tiles are staged in shared memory as float32 with a row stride of D + 1
// (BK + 1 for p and ds), so a warp's column reads fall on distinct banks.
//
// What bounds it on an H100: operations.  The backward does 2.5 times the
// forward's 4 D (pairs kept) FLOP (five products of q/dout/k/v size against
// the forward's two); at qwen3-4b's 1 x 4,096 x 32 heads of 128, causal,
// that is 3.44e11 FLOP: 0.35 ms at the bf16 tensor cores' 989 TFLOP/s,
// 5.1 ms at the float32 CUDA cores' 67 TFLOP/s.  The CUDA-core route reads
// its operands from shared memory (about one load for two FMAs) and runs
// well below the latter; the mma.sync route stages its tiles synchronously
// (no cp.async or TMA ring yet) and issues no wgmma, so it too stays below
// the tensor cores' rate: those are the next steps for this kernel.
//
// Offsets are 64-bit.  The launcher returns any launch error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 lattice
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D, int BQ, int BK>
struct Plan {
  static constexpr int kLd = D + 1;      // row stride of the q, dout, k and v tiles
  static constexpr int kLdP = BK + 1;    // row stride of p and ds
  static constexpr int kMR = BQ / 16;    // score rows a thread owns
  static constexpr int kMC = BK / 16;    // score columns a thread owns
  static constexpr int kKR = BK / 16;    // dk / dv rows a thread owns
  static constexpr int kQR = BQ / 16;    // dq rows a thread owns
  static constexpr int kDC = D / 16;     // head dims a thread owns
  // q, dout (BQ rows), k, v (BK rows), p and ds, lse and delta
  static constexpr int kFloats = 2 * BQ * kLd + 2 * BK * kLd + 2 * BQ * kLdP + 2 * BQ;
  static constexpr int kSmem = 4 * kFloats;
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert(kSmem <= 232448, "tile plan exceeds shared memory");
};

// rows [row0, row0 + ROWS) of one head of a (.., S, heads, D) tensor into
// shared memory as float32, row stride LD; rows at or past S are zeros
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* base, long long row_stride,
                                      long long row0, long long S) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const long long row = row0 + r;
    dst[r * LD + c] = row < S ? to_f(base[row * row_stride + c]) : 0.f;
  }
}

// acc[a][b] = sum_d A[(ty + 16 a) LD + d] B[(tx + 16 b) LD + d]
template <int D, int LD, int MR, int MC>
__device__ __forceinline__ void dot_tile(float (&acc)[MR][MC], const float* A, const float* Bm,
                                         int ty, int tx) {
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[MR], bv[MC];
#pragma unroll
    for (int a = 0; a < MR; ++a) av[a] = A[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int b = 0; b < MC; ++b) bv[b] = Bm[(tx + 16 * b) * LD + d];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < MC; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// acc[a][b] += sum_{i < ROWS} A[i LDA + ty + 16 a] X[i LDX + tx + 16 b]  (A transposed)
template <int ROWS, int LDA, int LDX, int MR, int NC>
__device__ __forceinline__ void acc_tn(float (&acc)[MR][NC], const float* A, const float* X,
                                       int ty, int tx) {
#pragma unroll 4
  for (int i = 0; i < ROWS; ++i) {
    float av[MR], xv[NC];
#pragma unroll
    for (int a = 0; a < MR; ++a) av[a] = A[i * LDA + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < NC; ++b) xv[b] = X[i * LDX + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < NC; ++b) acc[a][b] = fmaf(av[a], xv[b], acc[a][b]);
  }
}

// acc[a][b] += sum_{j < COLS} A[(ty + 16 a) LDA + j] X[j LDX + tx + 16 b]
template <int COLS, int LDA, int LDX, int MR, int NC>
__device__ __forceinline__ void acc_nn(float (&acc)[MR][NC], const float* A, const float* X,
                                       int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < COLS; ++j) {
    float av[MR], xv[NC];
#pragma unroll
    for (int a = 0; a < MR; ++a) av[a] = A[(ty + 16 * a) * LDA + j];
#pragma unroll
    for (int b = 0; b < NC; ++b) xv[b] = X[j * LDX + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < NC; ++b) acc[a][b] = fmaf(av[a], xv[b], acc[a][b]);
  }
}

__device__ __forceinline__ bool visible(long long qp, long long kp, int Sq, int Skv, int causal,
                                        int has_window, long long window) {
  bool ok = qp < Sq && kp < Skv;
  if (causal) ok = ok && kp <= qp;
  if (has_window) ok = ok && kp > qp - window;
  return ok;
}

// p and ds of one (BQ x BK) tile from its scores s = q k^T and dp = dout
// v^T: p into P (when P is given) and ds into DS, both at row stride LDP
template <int MR, int MC, int LDP>
__device__ __forceinline__ void softmax_grad(const float (&s)[MR][MC], const float (&dp)[MR][MC],
                                             float* P, float* DS, const float* Ls,
                                             const float* Ds, long long q0, long long k0,
                                             int ty, int tx, int Sq, int Skv, int causal,
                                             int has_window, long long window,
                                             float scale_log2) {
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int j = tx + 16 * b;
      const float p = visible(q0 + i, k0 + j, Sq, Skv, causal, has_window, window)
                          ? exp2f(fmaf(s[a][b], scale_log2, -Ls[i]))
                          : 0.f;
      if (P != nullptr) P[i * LDP + j] = p;
      DS[i * LDP + j] = p * (dp[a][b] - Ds[i]);
    }
  }
}

// lse (in log2 units) and delta of q rows [q0, q0 + BQ) of one head
template <int BQ>
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds, const float* lse_h,
                                           const float* delta_h, long long q0, int Sq) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const long long qp = q0 + i;
    Ls[i] = qp < Sq ? lse_h[qp] * kLog2e : 0.f;
    Ds[i] = qp < Sq ? delta_h[qp] : 0.f;
  }
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

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
              int Skv, int H, int KV, int causal, int has_window, long long window,
              float scale) {
  using P = Plan<D, BQ, BK>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * P::kLd;
  float* Ks = dOs + BQ * P::kLd;
  float* Vs = Ks + BK * P::kLd;
  float* Ps = Vs + BK * P::kLd;
  float* dSs = Ps + BQ * P::kLdP;
  float* Ls = dSs + BQ * P::kLdP;
  float* Ds = Ls + BQ;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const long long k0 = static_cast<long long>(blockIdx.y) * BK;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const float scale_log2 = scale * kLog2e;

  stage<T, D, BK, P::kLd>(Ks, k + kv_off, kv_stride, k0, Skv);
  stage<T, D, BK, P::kLd>(Vs, v + kv_off, kv_stride, k0, Skv);

  float acc_k[P::kKR][P::kDC], acc_v[P::kKR][P::kDC];
#pragma unroll
  for (int a = 0; a < P::kKR; ++a)
#pragma unroll
    for (int c = 0; c < P::kDC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  // the q rows that may see a key of this tile
  long long qlo = causal ? k0 : 0, qhi = Sq;
  if (has_window) qhi = min(qhi, k0 + BK - 1 + window);
  qlo = qlo / BQ * BQ;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_off = (static_cast<long long>(b) * Sq * H + h) * D;
    const long long row_off = (static_cast<long long>(b) * H + h) * Sq;
    for (long long q0 = qlo; q0 < qhi; q0 += BQ) {
      __syncthreads();   // the last tile's readers are done
      stage<T, D, BQ, P::kLd>(Qs, q + q_off, q_stride, q0, Sq);
      stage<T, D, BQ, P::kLd>(dOs, dout + q_off, q_stride, q0, Sq);
      stage_rows<BQ>(Ls, Ds, lse + row_off, delta + row_off, q0, Sq);
      __syncthreads();
      float s[P::kMR][P::kMC], dp[P::kMR][P::kMC];
      dot_tile<D, P::kLd>(s, Qs, Ks, ty, tx);
      dot_tile<D, P::kLd>(dp, dOs, Vs, ty, tx);
      softmax_grad<P::kMR, P::kMC, P::kLdP>(s, dp, Ps, dSs, Ls, Ds, q0, k0, ty, tx, Sq, Skv,
                                             causal, has_window, window, scale_log2);
      __syncthreads();
      acc_tn<BQ, P::kLdP, P::kLd>(acc_v, Ps, dOs, ty, tx);    // dv += p^T dout
      acc_tn<BQ, P::kLdP, P::kLd>(acc_k, dSs, Qs, ty, tx);    // dk += ds^T q
    }
  }

#pragma unroll
  for (int a = 0; a < P::kKR; ++a) {
    const long long kp = k0 + ty + 16 * a;
    if (kp >= Skv) continue;
    const long long off = kv_off + kp * kv_stride + tx;
#pragma unroll
    for (int c = 0; c < P::kDC; ++c) {
      dv[off + 16 * c] = from_f<T>(acc_v[a][c]);
      dk[off + 16 * c] = from_f<T>(acc_k[a][c] * scale);
    }
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int H, int KV,
            int causal, int has_window, long long window, float scale) {
  using P = Plan<D, BQ, BK>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * P::kLd;
  float* Ks = dOs + BQ * P::kLd;
  float* Vs = Ks + BK * P::kLd;
  float* dSs = Vs + BK * P::kLd;
  float* Ls = dSs + 2 * BQ * P::kLdP;
  float* Ds = Ls + BQ;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * BQ;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long q_off = (static_cast<long long>(b) * Sq * H + h) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const long long row_off = (static_cast<long long>(b) * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  stage<T, D, BQ, P::kLd>(Qs, q + q_off, q_stride, q0, Sq);
  stage<T, D, BQ, P::kLd>(dOs, dout + q_off, q_stride, q0, Sq);
  stage_rows<BQ>(Ls, Ds, lse + row_off, delta + row_off, q0, Sq);

  float acc[P::kQR][P::kDC];
#pragma unroll
  for (int a = 0; a < P::kQR; ++a)
#pragma unroll
    for (int c = 0; c < P::kDC; ++c) acc[a][c] = 0.f;

  // the kv tiles that hold a key some row of this q tile may see
  long long klo = 0, khi = Skv;
  if (causal) khi = min(khi, q0 + BQ);
  if (has_window) klo = max(0LL, q0 - window + 1);
  klo = klo / BK * BK;

  for (long long k0 = klo; k0 < khi; k0 += BK) {
    __syncthreads();   // the last tile's readers are done
    stage<T, D, BK, P::kLd>(Ks, k + kv_off, kv_stride, k0, Skv);
    stage<T, D, BK, P::kLd>(Vs, v + kv_off, kv_stride, k0, Skv);
    __syncthreads();
    float s[P::kMR][P::kMC], dp[P::kMR][P::kMC];
    dot_tile<D, P::kLd>(s, Qs, Ks, ty, tx);
    dot_tile<D, P::kLd>(dp, dOs, Vs, ty, tx);
    softmax_grad<P::kMR, P::kMC, P::kLdP>(s, dp, nullptr, dSs, Ls, Ds, q0, k0, ty, tx, Sq, Skv,
                                           causal, has_window, window, scale_log2);
    __syncthreads();
    acc_nn<BK, P::kLdP, P::kLd>(acc, dSs, Ks, ty, tx);     // dq += ds k
  }

#pragma unroll
  for (int a = 0; a < P::kQR; ++a) {
    const long long qp = q0 + ty + 16 * a;
    if (qp >= Sq) continue;
    const long long off = q_off + qp * q_stride + tx;
#pragma unroll
    for (int c = 0; c < P::kDC; ++c) dq[off + 16 * c] = from_f<T>(acc[a][c] * scale);
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Skv, int H, int KV, int causal, int has_window, long long window,
                   float scale, cudaStream_t stream) {
  using P = Plan<D, BQ, BK>;
  const long long kv_tiles = (Skv + BK - 1) / BK, q_tiles = (Sq + BQ - 1) / BQ;
  if (kv_tiles > 65535 || q_tiles > 65535) return cudaErrorInvalidValue;
  auto dkdv = attn_bwd_dkdv<T, D, BQ, BK>;
  auto dqk = attn_bwd_dq<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
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
  if (Skv > 0) {
    const dim3 grid_kv(static_cast<unsigned>(B) * static_cast<unsigned>(KV),
                       static_cast<unsigned>(kv_tiles));
    dkdv<<<grid_kv, kThreads, P::kSmem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                                   static_cast<T*>(dk), static_cast<T*>(dv), Sq,
                                                   Skv, H, KV, causal, has_window, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                    static_cast<unsigned>(q_tiles));
  dqk<<<grid_q, kThreads, P::kSmem, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
                                              Sq, Skv, H, KV, causal, has_window, window, scale);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16), head sizes up to 128 ----
//
// The same two-kernel split, four warps a block, each warp owning 16 rows
// of its block's outputs in registers: 16 keys of dk and dv in the dk/dv
// kernel (a 64-key tile, q tiles of 32 rows), 16 query rows of dq in the dq
// kernel (a 64-row q tile, kv tiles of 64 keys).  Operands are staged in
// shared memory as bf16 (row stride D + 8, so each 8-row ldmatrix hits 32
// distinct banks) and read with ldmatrix (.trans where the product needs a
// column of the tile).  The scores and dp accumulate in float32; p and ds
// are rounded to bf16 only as the A operand of the next product, straight
// from the accumulator fragments (FlashAttention-2's choice).

constexpr int kMmaThreads = 128;   // four warps
constexpr int kMmaBK = 64;         // keys a dk/dv block owns; kv tile of the dq kernel
constexpr int kMmaBQ = 32;         // q tile of the dk/dv kernel
constexpr int kMmaBQ2 = 64;        // q rows a dq block owns

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of one head of a (.., S, heads, D) bf16 tensor
// into shared memory, row stride LDS; 16 bytes a thread a step; rows at or
// past S are zeros
template <int D, int ROWS, int LDS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long row_stride, long long row0, long long S) {
  constexpr int kC = D / 8;   // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * kC; idx += kMmaThreads) {
    const int r = idx / kC, c = (idx % kC) * 8;
    const long long row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) val = *reinterpret_cast<const uint4*>(base + row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// acc[n] (n-tiles of 8 columns, NT of them) = A (16 rows at a_row0 of As)
// times B^T, B's rows (the columns of the product) at b_row0 of Bs, over D:
// both tiles row-major in shared memory, the product's inner dimension their
// columns
template <int D, int LDS, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* As, int a_row0,
                                        const __nv_bfloat16* Bs, int b_row0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const int j = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_addr(As + (a_row0 + r8 + 8 * (j & 1)) * LDS + 16 * kk + 8 * (j >> 1)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, smem_addr(Bs + (b_row0 + 16 * np + r8 + 8 * (j >> 1)) * LDS + 16 * kk +
                           8 * (j & 1)));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (n-tiles over D) += A (KS k-steps of 16 as register fragments)
// times Xs rows [0, 16 KS), row-major in shared memory (ldmatrix.trans)
template <int D, int LDS, int KS>
__device__ __forceinline__ void mma_ax(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                       const __nv_bfloat16* Xs, int lane) {
  const int j = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_addr(Xs + (16 * kk + r8 + 8 * (j & 1)) * LDS + 16 * np + 8 * (j >> 1)));
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// an accumulator of NT n-tiles (16 rows x 8 NT columns) as NT / 2 A
// fragments over its columns
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// 16 rows of a warp's (row, dim) accumulator to global memory, bf16 pairs,
// rows at or past S skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           long long row0, long long S,
                                           const float (&acc)[D / 8][4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(base + row * row_stride + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                  int Skv, int H, int KV, int causal, int has_window, long long window,
                  float scale) {
  constexpr int LDS = D + 8, BK = kMmaBK, BQ = kMmaBQ, NT = BQ / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Vs = Ks + BK * LDS;
  __nv_bfloat16* Qs = Vs + BK * LDS;
  __nv_bfloat16* dOs = Qs + BQ * LDS;
  float* Ls = reinterpret_cast<float*>(dOs + BQ * LDS);
  float* Ds = Ls + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const long long k0 = static_cast<long long>(blockIdx.y) * BK;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const float scale_log2 = scale * kLog2e;

  stage_bf16<D, BK, LDS>(Ks, k + kv_off, kv_stride, k0, Skv);
  stage_bf16<D, BK, LDS>(Vs, v + kv_off, kv_stride, k0, Skv);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  long long qlo = causal ? k0 : 0, qhi = Sq;
  if (has_window) qhi = min(qhi, k0 + BK - 1 + window);
  qlo = qlo / BQ * BQ;
  const long long kw = k0 + 16 * warp + g;   // this thread's keys: kw, kw + 8

  for (int gh = 0; gh < G; ++gh) {
    const int h = kvh * G + gh;
    const long long q_off = (static_cast<long long>(b) * Sq * H + h) * D;
    const long long row_off = (static_cast<long long>(b) * H + h) * Sq;
    for (long long q0 = qlo; q0 < qhi; q0 += BQ) {
      __syncthreads();   // the last tile's readers are done
      stage_bf16<D, BQ, LDS>(Qs, q + q_off, q_stride, q0, Sq);
      stage_bf16<D, BQ, LDS>(dOs, dout + q_off, q_stride, q0, Sq);
      for (int i = threadIdx.x; i < BQ; i += kMmaThreads) {
        const long long qp = q0 + i;
        Ls[i] = qp < Sq ? lse[row_off + qp] * kLog2e : 0.f;
        Ds[i] = qp < Sq ? delta[row_off + qp] : 0.f;
      }
      __syncthreads();
      // s^T and dp^T: this warp's 16 keys against the tile's BQ queries
      float st[NT][4], dpt[NT][4];
      mma_abt<D, LDS, NT>(st, Ks, 16 * warp, Qs, 0, lane);
      mma_abt<D, LDS, NT>(dpt, Vs, 16 * warp, dOs, 0, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = 8 * n + 2 * t + (i & 1);
          const long long kp = kw + 8 * (i >> 1);
          const float p = visible(q0 + qi, kp, Sq, Skv, causal, has_window, window)
                              ? exp2f(fmaf(st[n][i], scale_log2, -Ls[qi]))
                              : 0.f;
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - Ds[qi]);
        }
      uint32_t pa[NT / 2][4], dsa[NT / 2][4];
      to_a<NT>(pa, st);
      to_a<NT>(dsa, dpt);
      mma_ax<D, LDS, NT / 2>(acc_v, pa, dOs, lane);    // dv += p^T dout
      mma_ax<D, LDS, NT / 2>(acc_k, dsa, Qs, lane);    // dk += ds^T q
    }
  }
  store_rows<D>(dv + kv_off, kv_stride, k0 + 16 * warp, Skv, acc_v, 1.f, lane);
  store_rows<D>(dk + kv_off, kv_stride, k0 + 16 * warp, Skv, acc_k, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
                int has_window, long long window, float scale) {
  constexpr int LDS = D + 8, BK = kMmaBK, BQ = kMmaBQ2, NT = BK / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* dOs = Qs + BQ * LDS;
  __nv_bfloat16* Ks = dOs + BQ * LDS;
  __nv_bfloat16* Vs = Ks + BK * LDS;
  float* Ls = reinterpret_cast<float*>(Vs + BK * LDS);
  float* Ds = Ls + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * BQ;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long q_off = (static_cast<long long>(b) * Sq * H + h) * D;
  const long long kv_off = (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const long long row_off = (static_cast<long long>(b) * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  stage_bf16<D, BQ, LDS>(Qs, q + q_off, q_stride, q0, Sq);
  stage_bf16<D, BQ, LDS>(dOs, dout + q_off, q_stride, q0, Sq);
  for (int i = threadIdx.x; i < BQ; i += kMmaThreads) {
    const long long qp = q0 + i;
    Ls[i] = qp < Sq ? lse[row_off + qp] * kLog2e : 0.f;
    Ds[i] = qp < Sq ? delta[row_off + qp] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  long long klo = 0, khi = Skv;
  if (causal) khi = min(khi, q0 + BQ);
  if (has_window) klo = max(0LL, q0 - window + 1);
  klo = klo / BK * BK;
  const int qr = 16 * warp + g;   // this thread's q rows in the tile: qr, qr + 8

  for (long long k0 = klo; k0 < khi; k0 += BK) {
    __syncthreads();   // the last tile's readers are done
    stage_bf16<D, BK, LDS>(Ks, k + kv_off, kv_stride, k0, Skv);
    stage_bf16<D, BK, LDS>(Vs, v + kv_off, kv_stride, k0, Skv);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    mma_abt<D, LDS, NT>(s, Qs, 16 * warp, Ks, 0, lane);
    mma_abt<D, LDS, NT>(dp, dOs, 16 * warp, Vs, 0, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = qr + 8 * (i >> 1);
        const long long kp = k0 + 8 * n + 2 * t + (i & 1);
        const float p = visible(q0 + qi, kp, Sq, Skv, causal, has_window, window)
                            ? exp2f(fmaf(s[n][i], scale_log2, -Ls[qi]))
                            : 0.f;
        dp[n][i] = p * (dp[n][i] - Ds[qi]);
      }
    uint32_t dsa[NT / 2][4];
    to_a<NT>(dsa, dp);
    mma_ax<D, LDS, NT / 2>(acc, dsa, Ks, lane);        // dq += ds k
  }
  store_rows<D>(dq + q_off, q_stride, q0 + 16 * warp, Sq, acc, scale, lane);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Skv, int H, int KV, int causal,
                       int has_window, long long window, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int LDS = D + 8;
  constexpr int kSmemKV = 2 * (2 * kMmaBK + 2 * kMmaBQ) * LDS + 4 * 2 * kMmaBQ;
  constexpr int kSmemQ = 2 * (2 * kMmaBQ2 + 2 * kMmaBK) * LDS + 4 * 2 * kMmaBQ2;
  const long long kv_tiles = (Skv + kMmaBK - 1) / kMmaBK, q_tiles = (Sq + kMmaBQ2 - 1) / kMmaBQ2;
  if (kv_tiles > 65535 || q_tiles > 65535) return cudaErrorInvalidValue;
  auto dkdv = attn_bwd_dkdv_mma<D>;
  auto dqk = attn_bwd_dq_mma<D>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
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
  if (Skv > 0) {
    const dim3 grid_kv(static_cast<unsigned>(B) * static_cast<unsigned>(KV),
                       static_cast<unsigned>(kv_tiles));
    dkdv<<<grid_kv, kMmaThreads, kSmemKV, stream>>>(tq, tk, tv, tdo, lse, delta,
                                                    static_cast<T*>(dk), static_cast<T*>(dv),
                                                    Sq, Skv, H, KV, causal, has_window, window,
                                                    scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                    static_cast<unsigned>(q_tiles));
  dqk<<<grid_q, kMmaThreads, kSmemQ, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
                                               Sq, Skv, H, KV, causal, has_window, window,
                                               scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int Sq, int Skv, int H, int KV, int causal,
                     int has_window, long long window, float scale, cudaStream_t st) {
#define FA_BWD_PLAN(d, bq, bk)                                                               \
  if (D == d)                                                                              \
    return launch<T, d, bq, bk>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, \
                                causal, has_window, window, scale, st);
  FA_BWD_PLAN(32, 64, 64)
  FA_BWD_PLAN(64, 64, 64)
  FA_BWD_PLAN(128, 64, 64)
  FA_BWD_PLAN(256, 32, 32)
#undef FA_BWD_PLAN
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point for ctypes.  q, o, dout and dq are contiguous (B, Sq,
// H, D), k, v, dk and dv (B, Skv, KV, D), all bf16 (is_bf16) or all float32;
// lse is the forward's float32 (B, H, Sq) row log-sum-exp (natural log; -inf
// on a row with no valid key) and delta a float32 (B, H, Sq) scratch array;
// D is 32, 64, 128 or 256, H a multiple of KV.  window is used when
// has_window is set; scale is 1 / sqrt(D).  The stream is PyTorch's current
// stream.  Returns the cudaError_t of the launches.
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
  cudaError_t err;
  if (is_bf16 && D == 128)
    err = launch_mma<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                          has_window, window, scale, st);
  else if (is_bf16 && D == 64)
    err = launch_mma<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                         has_window, window, scale, st);
  else if (is_bf16 && D == 32)
    err = launch_mma<32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                         has_window, window, scale, st);
  else if (is_bf16)
    err = launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV,
                                  causal, has_window, window, scale, st);
  else
    err = launch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                          has_window, window, scale, st);
  return static_cast<int>(err);
}
