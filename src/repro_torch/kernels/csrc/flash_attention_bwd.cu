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
//   * float32, and bf16 at head size 256: every product on the CUDA cores
//     in float32 (the float32 gradient gate's route).
//
// Launches, none with an atomic, so the gradient repeats bit for bit:
//   1. delta, one warp per (b, i, h) row;
//   2. dk and dv (one launch on the CUDA cores; a dv launch, then a dk
//      launch on the tensor cores): one block per (batch * KV head, key
//      tile), which recomputes p from q, k and lse for every q tile that
//      can see its keys, and loops over the query heads of its KV head in
//      order, so the GQA sum has one fixed order;
//   3. dq: one block per (batch * head, q tile), looping over the kv tiles
//      its rows can see (q tiles issued last-first, as in the forward, so
//      the longest causal rows start first).
// On the CUDA-core route a thread owns a 16 x 16 lattice of a tile: scores (i, j) = (ty + 16 a,
// tx + 16 b), and output (row, dim) = (ty + 16 a, tx + 16 b), in registers;
// tiles are staged in shared memory as float32 with a row stride of D + 1
// (BK + 1 for p and ds), so a warp's column reads fall on distinct banks.
//
// What bounds it on an H100: operations.  The backward does five products
// of q/dout/k/v size, 10 D FLOP a kept (q, k) pair and head against the
// forward's 4 D; at qwen3-4b's 1 x 4,096 x 32 heads of 128, causal, that is
// 3.44e11 FLOP: 0.35 ms at the bf16 tensor cores' 989 TFLOP/s, 5.1 ms at
// the float32 CUDA cores' 67 TFLOP/s, while its 168 MB of inputs and
// gradients take 0.05 ms at 3.35 TB/s.  What the tensor-core route does
// about it:
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
// gives; the dv launch's N = 128 tiles ask for 96.  The CUDA-core route
// reads its operands from shared memory (about one load for two FMAs) and
// runs well below the float32 peak.
//
// Offsets are 64-bit.  The launchers return any launch error.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  cudaError_t err;
  if (is_bf16)
    err = launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV,
                                  causal, has_window, window, scale, st);
  else
    err = launch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, KV, causal,
                          has_window, window, scale, st);
  return static_cast<int>(err);
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
