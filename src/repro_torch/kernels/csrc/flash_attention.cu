// Flash attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_bhsd, GQA front end flash_attention).  Same
// function: scale d**-0.5, f32 scores, causal mask aligned bottom-right
// (col <= row + S_kv - S), per-batch-row kv_start mask, masked scores -1e30,
// any score <= -1e28 contributes exactly 0, f32 running m / l / acc, a row
// with l == 0 divides by 1 (zeros out, never NaN), output in the input type.
//
// Design.  One block of 256 threads per (batch * head, BQ query rows).  A loop
// inside the block walks the KV columns in BK-column tiles staged in shared
// memory (this replaces the TPU's sequential "arbitrary" KV grid axis), with
// the online-softmax state in shared memory and registers.  Block sizes are
// template arguments chosen by the port's tile table and passed at launch.
//  * Operands stay in the model's (B, S, H, d) layout; the batch stride is an
//    argument, so a view of a larger cache is read in place.
//  * GQA: query head h reads KV head h / (H / KV) directly; KV heads are
//    never repeated in device memory.
//  * Lengths that are not block multiples are masked in place (rows >= S are
//    not stored, columns >= S_kv are masked).  For every real row this masks
//    exactly the columns the reference's left-padding masks.
//  * The KV loop starts at the tile holding kv_start and stops at the causal
//    limit of the block's last row: the tiles skipped are fully masked, and a
//    fully masked tile leaves m, l and acc unchanged.
//  * All arithmetic is f32 FMA (QK^T and PV), matching the reference's f32
//    dots; tensor cores, cp.async / TMA and warp specialisation are later work.
//
// Bound on the H100 at llama3.2-1b prefill, q (8, 256, 32, 64) and k, v
// (8, 256, 8, 64) bf16, causal: 4*d FLOP per unmasked (query, key) pair, about
// 4.3 GFLOP, against 989 TFLOP/s is ~4 us; q + k + v + o is ~21 MB, ~6 us at
// 3.35 TB/s, so bytes bound it.  This kernel runs on the CUDA cores at f32
// rates, well above that bound; PERF.md keeps its measured time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = -1e28f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BQ, int BK, int D>
struct Smem {
  static constexpr int kDp = D + 1;   // padded row of Q and K
  static constexpr int kSp = BK + 1;  // padded row of the score tile
  static constexpr int kFloats = BQ * kDp + BK * kDp + BK * D + BQ * kSp + 3 * BQ;
  static constexpr int kBytes = kFloats * 4;
};

template <int BQ, int BK, int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_start,
                 T* __restrict__ o, long long q_bstride, long long k_bstride,
                 long long v_bstride, int S, int Skv, int H, int KVH,
                 float scale, int causal) {
  typedef Smem<BQ, BK, D> L;
  constexpr int RM = BQ / 16;            // query rows per thread (QK^T, PV)
  constexpr int CN = BK / 16;            // key columns per thread (QK^T)
  constexpr int TD = D / 16;             // output columns per thread (PV)
  constexpr int TPR = kThreads / BQ;     // threads per row in the softmax
  constexpr int CPT = BK / TPR;          // columns per thread in the softmax
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % 16 == 0, "16 x 16 threads");
  static_assert(kThreads % BQ == 0 && BK % TPR == 0 && TPR <= 32, "softmax split");

  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                    // [BQ][kDp], pre-scaled
  float* Ks = Qs + BQ * L::kDp;      // [BK][kDp]
  float* Vs = Ks + BK * L::kDp;      // [BK][D]
  float* Ss = Vs + BK * D;           // [BQ][kSp] scores, then probabilities
  float* row_m = Ss + BQ * L::kSp;   // running max
  float* row_l = row_m + BQ;         // running sum
  float* row_a = row_l + BQ;         // this tile's rescale factor

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int start = kv_start ? kv_start[b] : 0;
  const long long q_row = (long long)H * D, kv_row = (long long)KVH * D;
  const T* qb = q + b * q_bstride + (long long)h * D;
  const T* kb = k + b * k_bstride + (long long)kvh * D;
  const T* vb = v + b * v_bstride + (long long)kvh * D;
  T* ob = o + (long long)b * S * q_row + (long long)h * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D, s = q0 + r;
    Qs[r * L::kDp + c] = s < S ? to_f32(qb[s * q_row + c]) * scale : 0.0f;
  }
  if (tid < BQ) { row_m[tid] = kNegInf; row_l[tid] = 0.0f; }

  float acc[RM][TD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.0f;

  // Columns [lo, hi) can hold a valid score for some row of this block.
  const int last_row = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(Skv, last_row + (Skv - S) + 1) : Skv;
  const int lo = max(start, 0) / BK * BK;

  for (int c0 = lo; c0 < hi; c0 += BK) {
    __syncthreads();  // Q staged; the previous tile's K, V, P are consumed
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, c = e % D, t = c0 + r;
      const bool ok = t < Skv;
      Ks[r * L::kDp + c] = ok ? to_f32(kb[t * kv_row + c]) : 0.0f;
      Vs[r * D + c] = ok ? to_f32(vb[t * kv_row + c]) : 0.0f;
    }
    __syncthreads();

    // scores: rows ty*RM + i, columns tx + 16*j
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RM], bk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty * RM + i) * L::kDp + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) bk[j] = Ks[(tx + 16 * j) * L::kDp + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int r = ty * RM + i, c = tx + 16 * j;
        const int row = q0 + r, col = c0 + c;
        const bool ok = col < Skv && col >= start &&
                        (!causal || col <= row + (Skv - S));
        Ss[r * L::kSp + c] = ok ? sc[i][j] : kNegInf;
      }
    __syncthreads();

    // online softmax: TPR neighbouring threads share one row
    {
      const int r = tid / TPR, part = tid % TPR;
      float* srow = Ss + r * L::kSp + part * CPT;
      float mx = kNegInf;
#pragma unroll
      for (int x = 0; x < CPT; ++x) mx = fmaxf(mx, srow[x]);
#pragma unroll
      for (int off = 1; off < TPR; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int x = 0; x < CPT; ++x) {
        const float s = srow[x];
        const float p = s > kMaskedBelow ? expf(s - m_new) : 0.0f;
        srow[x] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V: rows ty*RM + i, columns tx + 16*j
    float t[RM][TD];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TD; ++j) t[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RM], vv[TD];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ss[(ty * RM + i) * L::kSp + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) t[i][j] = fmaf(p[i], vv[j], t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = row_a[ty * RM + i];
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] = acc[i][j] * alpha + t[i][j];
    }
  }
  __syncthreads();  // row_l final (also when no tile ran)

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i, row = q0 + r;
    if (row >= S) continue;
    const float l = row_l[r];
    const float denom = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      ob[row * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <int BQ, int BK, int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_start, void* o, long long qb, long long kb,
                   long long vb, int B, int S, int Skv, int H, int KVH,
                   float scale, int causal, cudaStream_t stream) {
  typedef Smem<BQ, BK, D> L;
  auto kernel = flash_fwd_kernel<BQ, BK, D, T>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_start, static_cast<T*>(o), qb, kb, vb, S,
      Skv, H, KVH, scale, causal);
  return cudaGetLastError();
}

template <int BQ, int BK, typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* ks,
               void* o, long long qb, long long kb, long long vb, int B, int S,
               int Skv, int H, int KVH, int D, float scale, int causal,
               cudaStream_t st) {
  switch (D) {
    case 16: return launch<BQ, BK, 16, T>(q, k, v, ks, o, qb, kb, vb, B, S, Skv, H, KVH, scale, causal, st);
    case 32: return launch<BQ, BK, 32, T>(q, k, v, ks, o, qb, kb, vb, B, S, Skv, H, KVH, scale, causal, st);
    case 64: return launch<BQ, BK, 64, T>(q, k, v, ks, o, qb, kb, vb, B, S, Skv, H, KVH, scale, causal, st);
    case 128: return launch<BQ, BK, 128, T>(q, k, v, ks, o, qb, kb, vb, B, S, Skv, H, KVH, scale, causal, st);
    default: return -1;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* ks,
             void* o, long long qb, long long kb, long long vb, int B, int S,
             int Skv, int H, int KVH, int D, float scale, int causal, int bq,
             int bk, cudaStream_t st) {
  if (bq == 64 && bk == 64)
    return dispatch_d<64, 64, T>(q, k, v, ks, o, qb, kb, vb, B, S, Skv, H, KVH, D, scale, causal, st);
  if (bq == 32 && bk == 64)
    return dispatch_d<32, 64, T>(q, k, v, ks, o, qb, kb, vb, B, S, Skv, H, KVH, D, scale, causal, st);
  return -1;
}

}  // namespace

// q: (B, S, H, D); k, v: (B, Skv, KVH, D), each contiguous in its last three
// dims, with the given batch strides (elements).  o: contiguous (B, S, H, D).
// kv_start: (B,) int32 or null.  is_f32: float32 operands (else bfloat16).
// Returns cudaGetLastError() after the launch, or -1 for a (bq, bk, D) with no
// instantiation.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* kv_start,
                                      void* o, long long q_bstride,
                                      long long k_bstride, long long v_bstride,
                                      int B, int S, int Skv, int H, int KVH,
                                      int D, float scale, int causal,
                                      int is_f32, int bq, int bk,
                                      void* stream) {
  if (B == 0 || S == 0) return 0;
  const int* ks = static_cast<const int*>(kv_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return dispatch<float>(q, k, v, ks, o, q_bstride, k_bstride, v_bstride, B,
                           S, Skv, H, KVH, D, scale, causal, bq, bk, st);
  return dispatch<bf16>(q, k, v, ks, o, q_bstride, k_bstride, v_bstride, B, S,
                        Skv, H, KVH, D, scale, causal, bq, bk, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
