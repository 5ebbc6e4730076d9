// flash_attention_f32 — blocked online-softmax attention in float32 on the
// CUDA cores, for Hopper (sm_90a).
//
// Replaces, for float32 q, k and v, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:27 (_attn_kernel, launched by
// flash_attention_bhsd; GQA expanded by ops.py); bfloat16 inputs go to the
// tensor-core kernel flash_attention_bf16.cu.
// For q (B, Sq, H, D) and k, v (B, Skv, KV, D), query head h reads KV head
// h / (H / KV) (the order of ops.py's jnp.repeat), and
//
//     s[i, j] = (q_i . k_j) * (1 / sqrt(D))        in float32
//     mask    = j < Skv  [&& j <= i  (causal, top-left: q counted from 0)]
//                        [&& j > i - window  (one-sided window)]
//     out_i   = sum_j p_ij v_j / max(sum_j p_ij, 1e-30)
//
// with p = exp(s - running max) where the mask holds and exactly 0 where it
// does not; masked scores are -1e30, not -inf, so a row with no valid key
// keeps l = 0 and acc = 0 and writes exactly 0.  Both products and the
// softmax run in float32 (no TF32), so the full-width float32 model through
// this kernel stays within 1e-4 of the plain version.
//
// The TPU kernel walked a (B*H, q-block, kv-block) grid in order and carried
// m, l and acc across the kv steps in VMEM scratch.  Here blocks run in no
// order on 132 SMs, so one thread block owns one (batch*head, 64-row q tile)
// and loops over its kv tiles itself, with m, l and acc in registers; the
// output tile is written once, without atomics.  K and V are read straight
// from their KV head (no repeated copy: at 32k tokens it would be 4x the
// bytes).  The kv loop visits only tiles that hold a key some row of the q
// tile may see: [max(0, q0 - window + 1), min(Skv, q0 + 64)) under causal and
// window, which skips the tiles above the diagonal and outside the window as
// the TPU kernel's pl.when did (half the work of a causal prefill).  q tiles
// are issued last-first so the longest causal rows start first.
//
// Per kv tile of 64 rows: K and V are staged through shared memory (K and Q
// rows padded by 4 floats so float4 reads by 8 neighbouring
// threads hit 32 distinct banks); 256 threads form a 16 x 16 grid, each
// owning 4 q rows: 4 score columns (tx + 16 j) of S = Q K^T, and D/16 output
// columns (tx + 16 c) of acc.  Row max and row sum are reduced over the 16
// threads of a half-warp with shuffles.  P goes through shared memory (in
// the K tile's space, which the scores no longer need) for P V.  Both
// products are float32 FMAs on the CUDA cores.
//
// What bounds it on an H100: operations.  A causal prefill does
// 4 * D * (pairs kept) FLOP; at qwen3-4b's 32k prefill (H=32, D=128) that is
// 8.80e12 FLOP, far above the card's ridge; on the float32 CUDA cores (67
// TFLOP/s peak) that is 131 ms at the least.  This kernel reaches about half
// of that peak; bf16 serving runs flash_attention_bf16.cu on the tensor
// cores instead.
//
// Offsets are 64-bit.  Dynamic shared memory is 34.8 KB (D=32) to 198.7 KB
// (D=256); the launcher raises the per-kernel limit and returns any error.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 64;         // kv rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float store(float x) { return x; }
};

template <int D>
struct Smem {
  static constexpr int kLdQK = D + 4;   // padded row stride of the Q and K tiles
  static constexpr int kLdP = kBK + 4;  // padded row stride of P
  static constexpr int kQ = kBQ * kLdQK;
  static constexpr int kKP = (kBK * kLdQK > kBQ * kLdP) ? kBK * kLdQK : kBQ * kLdP;
  static constexpr int kV = kBK * D;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

// Rows [row0, row0 + ROWS) of one head of a (.., S, heads, D) tensor into
// shared memory as float32, row stride LD; rows at or past S are zero.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* base, long long row_stride,
                                      long long row0, long long S) {
  constexpr int kC4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * kC4; i += kThreads) {
    const int r = i / kC4;
    const int c = (i % kC4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) val = Elem<T>::load4(base + (row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int H, int KV, int causal, int has_window, long long window,
                       float scale) {
  using S_ = Smem<D>;
  constexpr int kNC = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S_::kQ;      // the K tile; P reuses its space
  float* Ps = Ks;
  float* Vs = Ks + S_::kKP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;

  // the kv tiles that hold a key some row of this q tile may see
  long long lo = 0, hi = Skv;
  if (causal) hi = min(hi, q0 + kBQ);
  if (has_window) lo = max(0LL, q0 - window + 1);
  lo = lo / kBK * kBK;

  stage<T, D, kBQ, S_::kLdQK>(Qs, qb, q_stride, q0, Sq);

  float m[4], l[4], acc[4][kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  for (long long kv0 = lo; kv0 < hi; kv0 += kBK) {
    __syncthreads();   // the last tile's P and V are read (and Q is staged)
    stage<T, D, kBK, S_::kLdQK>(Ks, kb, kv_stride, kv0, Skv);
    stage<T, D, kBK, D>(Vs, vb, kv_stride, kv0, Skv);
    __syncthreads();

    // S = Q K^T for rows ty*4 + i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * S_::kLdQK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * S_::kLdQK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, mask, online softmax update
    bool keep[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kp = kv0 + tx + 16 * j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (has_window) ok = ok && kp > qp - window;
        keep[i][j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = keep[i][j] ? expf(s[i][j] - m_new) : 0.f;   // s now holds p
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }

    __syncthreads();   // every thread is done reading K: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * S_::kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P V for rows ty*4 + i, columns tx + 16 c
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * S_::kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c) vv[c] = Vs[(kk + u) * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kNC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = ob + qp * q_stride;
#pragma unroll
    for (int c = 0; c < kNC; ++c) row[tx + 16 * c] = Elem<T>::store(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int KV, int causal, int has_window, long long window,
                   float scale, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<D>::kBytes;
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H),
                  static_cast<unsigned>((Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, KV, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Skv, int H, int KV, int causal, int has_window,
                     long long window, float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal, has_window, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, has_window, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal, has_window, window, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KV, causal, has_window, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  q, k, v and out are contiguous float32
// device arrays in the model's layout, q and out (B, Sq, H, D), k and v
// (B, Skv, KV, D), 16-byte aligned; D is 32, 64, 128 or 256, H a multiple of
// KV, Sq / 64 at most 65535.  window is used when has_window is set.  The
// stream is PyTorch's current stream.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                                          void* out, int B, int Sq, int Skv, int H, int KV,
                                          int D, int causal, int has_window, long long window,
                                          float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || Skv < 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<float>(D, q, k, v, out, B, Sq, Skv, H, KV, causal,
                                          has_window, window, scale,
                                          static_cast<cudaStream_t>(stream)));
}
