// K2, flash attention forward (online softmax), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_bhsd, GQA front end flash_attention).  Same
// function: scale d**-0.5, f32 scores, causal mask aligned bottom-right
// (col <= row + S_kv - S), per-batch-row kv_start mask, masked scores -1e30,
// any score <= -1e28 contributes exactly 0, f32 running m / l / acc, a row
// with l == 0 divides by 1 (zeros out, never NaN), output in the input type.
// On the TPU the KV axis is a sequential grid dimension carrying m / l / acc
// in scratch; here it is a loop inside the block.  Operands stay in the
// model's (B, S, H, d) layout; K and V take a batch stride, so views
// k[:, :s] of the (B, max_len, KV, d) cache are read in place.  Blocks are
// template arguments chosen by the port's tile table and passed at launch.
// Two kernels, chosen by the wrapper from the operands before the launch:
//
//  * wgmma (flash_fwd_wgmma_kernel): bf16, d in {64, 128}.  Bound by
//    operations at prompt lengths (4 d FLOP per unmasked (query, key) pair:
//    68.7 GFLOP, 0.069 ms at 989 TFLOP/s, for a 4096-token causal prompt
//    at llama3.2-1b's width) and by bytes at the serving path's 256-token
//    prefill (q + k + v + o ~21 MB, ~6 us at 3.35 TB/s).
//    - GQA heads packed into one block: a block takes one (batch row, KV
//      head) and 64 * NWG query rows, which are 64 * NWG / G positions times
//      the G = H / KV query heads that share the KV head (llama3.2-1b at
//      NWG = 1: 16 positions x 4 heads).  The G heads of a position are
//      contiguous in q, so one 4-D TMA box (64 of d, G heads, positions, 1)
//      lands Q as a rows x d tile, and O leaves the same way.  Each K / V
//      tile is read once for G heads, and all rows of a block share one
//      causal extent.
//    - Warp-specialised: one producer warp issues TMA loads of BK-column
//      K and V tiles (128-byte swizzle; d = 64 bf16 is one 128-byte row,
//      d = 128 two column blocks) into a ring of STAGES buffers, with a
//      full barrier each for K and V (S = Q K^T starts before V lands) and
//      an empty barrier; NWG consumer warpgroups own 64 rows each.  With
//      NWG = 1 three or four blocks share an SM, so one block's softmax
//      overlaps another's products (softmax and the next product are not
//      pipelined inside a warpgroup).
//    - S = Q K^T on wgmma m64nBKk16 from raw bf16 q and k (exact products,
//      f32 sums); the scale is applied to the f32 scores, folded with
//      log2(e) into one FMA before exp2.  The online softmax stays in the
//      accumulator's registers: each row lives in one quad of lanes, so row
//      max and sum take two shuffles.  P is rounded to bf16 in registers
//      (at most 2^-9 of each weight) and is the A operand of O += P V
//      (wgmma m64n{d}k16, A from registers, V MN-major from shared memory);
//      l sums the f32 P.
//    - Masks only on the tiles that straddle kv_start, S_kv or the causal
//      diagonal; the loop starts at the tile holding kv_start and stops at
//      the block's causal limit (a warpgroup past its own limit skips the
//      tile); columns past S_kv arrive as zeros from TMA and are masked.
//    - Epilogue: divide by l (by 1 where l == 0), round to bf16, stage in
//      the warpgroup's drained rows of the Q tile in the swizzled layout,
//      one TMA store per 64 columns (rows past S are not written).
//    - No atomics: two launches give equal bits.
//  * fma (flash_fwd_kernel): f32 (the exactness pass), and bf16 operands the
//    wgmma kernel does not take.  One block of 256 threads per (batch *
//    head, BQ query rows); K / V tiles staged in shared memory as f32; all
//    arithmetic f32 FMA, matching the reference's f32 dots; GQA by
//    indexing; rows >= S not stored, columns >= S_kv masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // PTX wrappers: mbarrier, TMA, wgmma, tensor-map encoder

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
// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, the G query heads of a KV head packed into one block
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedBelowLog2 = kMaskedBelow * kLog2e;

template <int NWG, int D, int BK, int STAGES>
struct WgmmaFlash {
  static constexpr int kRows = 64 * NWG;          // packed query rows
  static constexpr int kThreads = 128 * NWG + 32; // consumers, producer warp
  static constexpr int kSub = D / 64;             // 128-byte column blocks of a row
  static constexpr int kQSub = kRows * 128;       // bytes of one Q column block
  static constexpr int kKVSub = BK * 128;         // bytes of one K or V column block
  static constexpr int kQBytes = kSub * kQSub;
  static constexpr int kKVBytes = kSub * kKVSub;  // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  // blocks an SM: one with two consumer warpgroups; with one, as many as
  // registers and shared memory allow at d = 64
  static constexpr int kMinBlocks = NWG > 1 ? 1 : BK == 64 ? 4 : 3;
  // 1024 bytes of slack to align the tiles (the swizzle atom), then the Q
  // tile, the ring, a Q barrier and per stage a K-full, a V-full and an
  // empty barrier
  static constexpr int kSmem =
      1024 + kQBytes + STAGES * kStageBytes + (1 + 3 * STAGES) * 8;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Registers: the producer is one warp, so nearly the whole register file
// goes to the consumers at the launch bound, without setmaxnreg (which acts
// on whole warpgroups): NWG = 1 runs three or four blocks an SM at up to
// 136 or 102 registers a thread, NWG = 2 one block at up to 224.
template <int NWG, int D, int BK, int STAGES>
__global__ void __launch_bounds__(128 * NWG + 32,
                                  WgmmaFlash<NWG, D, BK, STAGES>::kMinBlocks)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tma_q,
                       __grid_constant__ const CUtensorMap tma_k,
                       __grid_constant__ const CUtensorMap tma_v,
                       __grid_constant__ const CUtensorMap tma_o,
                       const int* __restrict__ kv_start, int S, int Skv,
                       int KVH, int G, float scale_log2, int causal) {
  typedef WgmmaFlash<NWG, D, BK, STAGES> L;
  static_assert((D == 64 || D == 128) && (BK == 64 || BK == 128), "wgmma tiles");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + L::kQBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * L::kStageBytes);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  // Blocks start in blockIdx.x-fastest order: (KV head, batch row) on x and
  // the query tile on y, last tile first, so the longest causal blocks of
  // every head start first and the short ones fill the tail.
  const int P = L::kRows / G;                          // positions per block
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;
  const int kvh = blockIdx.x % KVH, b = blockIdx.x / KVH;
  const int shift = Skv - S;                           // bottom-right causal
  const int start = kv_start ? max(kv_start[b], 0) : 0;
  const int last = min(p0 + P, S) - 1;                 // the block's last row
  const int hi = causal ? min(Skv, last + shift + 1) : Skv;
  const int lo = start / BK * BK;
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {
    // producer warp: one thread keeps up to STAGES K / V tiles in flight
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int j = 0; j < L::kSub; ++j)
        tma_load_4d(qs + j * L::kQSub, &tma_q, 64 * j, kvh * G, p0, b, qbar);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, c0 = lo + t * BK;
        unsigned char* ks = ring + s * L::kStageBytes;
        unsigned char* vs = ks + L::kKVBytes;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kfull[s], L::kKVBytes);
        for (int j = 0; j < L::kSub; ++j)
          tma_load_4d(ks + j * L::kKVSub, &tma_k, 64 * j, kvh, c0, b, &kfull[s]);
        mbar_expect_tx(&vfull[s], L::kKVBytes);
        for (int j = 0; j < L::kSub; ++j)
          tma_load_4d(vs + j * L::kKVSub, &tma_v, 64 * j, kvh, c0, b, &vfull[s]);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns packed rows cw * 64 .. + 63; this thread
  // holds rows r and r + 8 of them, each spread over one quad of lanes
  const int cw = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int quad = lane % 4;
  const int r = (t / 32) * 16 + lane / 4;
  const int pos_lo = p0 + (cw * 64 + r) / G, pos_hi = p0 + (cw * 64 + r + 8) / G;
  const int wg_first = p0 + cw * 64 / G;
  const int wg_hi = wg_first >= S ? lo
      : causal ? min(Skv, min(p0 + (cw * 64 + 63) / G, S - 1) + shift + 1) : Skv;
  const unsigned char* qa = qs + cw * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES, c0 = lo + it * BK;
    const uint32_t phase = (it / STAGES) & 1;
    const unsigned char* ks = ring + s * L::kStageBytes;
    const unsigned char* vs = ks + L::kKVBytes;
    if (c0 < wg_hi) {  // warpgroup-uniform: tiles past its causal limit skip
      // S = Q K^T: raw bf16 operands, f32 sums
      float sc[BK / 2];
      mbar_wait(&kfull[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int j = kk / 4, k32 = (kk % 4) * 32;
        Wgmma<BK>::template mma<0>(
            sc, sw128_desc(qa + j * L::kQSub + k32, 16, 1024),
            sw128_desc(ks + j * L::kKVSub + k32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sc);

      // element 4i + {0, 1}: row r, column c0 + 8i + 2 quad + {0, 1};
      // 4i + {2, 3}: row r + 8.  Masked scores are -inf: exp2 gives 0.
      if (c0 < start || c0 + BK > Skv || (causal && c0 + BK - 1 > wg_first + shift)) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * i + 2 * quad + e;
            const bool in = col >= start && col < Skv;
            if (!in || (causal && col > pos_lo + shift)) sc[4 * i + e] = -INFINITY;
            if (!in || (causal && col > pos_hi + shift)) sc[4 * i + 2 + e] = -INFINITY;
          }
      }

      // online softmax in the log2 domain: x * scale * log2(e)
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
      const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
      const float alpha_lo = ex2(m_lo - mn_lo), alpha_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      // a row whose maximum is a masked score (<= -1e28) takes no weight
      const float neg_lo = mn_lo > kMaskedBelowLog2 ? -mn_lo : -INFINITY;
      const float neg_hi = mn_hi > kMaskedBelowLog2 ? -mn_hi : -INFINITY;
      uint32_t pa[BK / 16][4];  // P in bf16: the A fragments of O += P V
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0_lo = ex2(fmaf(sc[4 * i], scale_log2, neg_lo));
        const float p1_lo = ex2(fmaf(sc[4 * i + 1], scale_log2, neg_lo));
        const float p0_hi = ex2(fmaf(sc[4 * i + 2], scale_log2, neg_hi));
        const float p1_hi = ex2(fmaf(sc[4 * i + 3], scale_log2, neg_hi));
        sum_lo += p0_lo + p1_lo;
        sum_hi += p0_hi + p1_hi;
        pa[i / 2][(i % 2) * 2] = pack_bf16(p0_lo, p1_lo);
        pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p0_hi, p1_hi);
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha_lo;
        o[4 * i + 1] *= alpha_lo;
        o[4 * i + 2] *= alpha_hi;
        o[4 * i + 3] *= alpha_hi;
      }

      // O += P V: V is MN-major (d contiguous), 64-column blocks BK rows
      // apart, k16 = 16 rows of 128 bytes
      mbar_wait(&vfull[s], phase);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        WgmmaRS<D>::template mma<1>(o, pa[j],
                                    sw128_desc(vs + j * 16 * 128, L::kKVSub, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_regs<BK / 4>(&pa[0][0]);  // P's registers stay live until here
    } else {
      // A skipped tile still waits for its load before releasing the stage,
      // so this warpgroup never runs a ring phase ahead of the other one
      // (two arrivals in one phase would release a stage still in use).
      mbar_wait(&kfull[s], phase);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: full row sums (over the quad), divide, round to bf16 and stage
  // in this warpgroup's drained rows of the Q tile in the 128-byte swizzled
  // layout (16-byte chunk c of row x sits at chunk c ^ (x % 8)); then one
  // TMA store per 64 columns.
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo == 0.0f ? 1.0f : 1.0f / l_lo;
  const float inv_hi = l_hi == 0.0f ? 1.0f : 1.0f / l_hi;
  unsigned char* os = qs + cw * 64 * 128;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    unsigned char* at = os + (i / 8) * L::kQSub + (((i % 8) ^ (r % 8)) * 16) + quad * 4;
    *reinterpret_cast<uint32_t*>(at + r * 128) =
        pack_bf16(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(at + (r + 8) * 128) =
        pack_bf16(o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
  }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
  if (t == 0 && wg_first < S) {
    for (int j = 0; j < L::kSub; ++j)
      tma_store_4d(&tma_o, os + j * L::kQSub, 64 * j, kvh * G, wg_first, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// ---------------------------------------------------------------------------
// host-side launchers
// ---------------------------------------------------------------------------
// Return codes besides cudaError_t: no instantiation for the schedule, a
// tensor map cuTensorMapEncodeTiled refused, arguments the kernel does not
// take.
enum { ERR_NO_TILE = -1, ERR_TENSOR_MAP = -2, ERR_ARGS = -4 };
enum { KERNEL_FMA = 0, KERNEL_WGMMA = 1 };

struct Args {
  const void* q; const void* k; const void* v; const int* kv_start; void* o;
  long long qb, kb, vb;  // batch strides, elements
  int B, S, Skv, H, KVH, D;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int BQ, int BK, int D, typename T>
cudaError_t launch_fma(const Args& a) {
  typedef Smem<BQ, BK, D> L;
  auto kernel = flash_fwd_kernel<BQ, BK, D, T>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kv_start, static_cast<T*>(a.o), a.qb, a.kb,
      a.vb, a.S, a.Skv, a.H, a.KVH, a.scale, a.causal);
  return cudaGetLastError();
}

template <int BQ, int BK, typename T>
int fma_d(const Args& a) {
  switch (a.D) {
    case 16: return launch_fma<BQ, BK, 16, T>(a);
    case 32: return launch_fma<BQ, BK, 32, T>(a);
    case 64: return launch_fma<BQ, BK, 64, T>(a);
    case 128: return launch_fma<BQ, BK, 128, T>(a);
    default: return ERR_NO_TILE;
  }
}

// A 4-D bf16 tensor map over (d, heads, positions, batch) of a tensor whose
// (positions, heads, d) are contiguous in each batch row: boxes of 64 x
// box_heads x box_pos x 1, 128-byte swizzle, zeros outside the tensor.
bool make_map_4d(CUtensorMap* map, const void* base, int D, int heads, int len,
                 int B, long long bstride, int box_heads, int box_pos) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)len,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                           (cuuint64_t)bstride * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_pos, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int D, int BK, int STAGES>
int launch_wgmma(const Args& a) {
  typedef WgmmaFlash<NWG, D, BK, STAGES> L;
  auto kernel = flash_fwd_wgmma_kernel<NWG, D, BK, STAGES>;
  if (a.KVH <= 0 || a.H % a.KVH || 64 % (a.H / a.KVH) || !(a.scale > 0.0f))
    return ERR_ARGS;
  const int G = a.H / a.KVH, P = L::kRows / G;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // an empty KV sequence loads no tile, but its tensor map needs an extent
  const int kv_len = a.Skv > 0 ? a.Skv : 1;
  CUtensorMap tq, tk, tv, to;
  if (!make_map_4d(&tq, a.q, D, a.H, a.S, a.B, a.qb, G, P) ||
      !make_map_4d(&tk, a.k, D, a.KVH, kv_len, a.B, a.kb, 1, BK) ||
      !make_map_4d(&tv, a.v, D, a.KVH, kv_len, a.B, a.vb, 1, BK) ||
      !make_map_4d(&to, a.o, D, a.H, a.S, a.B, (long long)a.S * a.H * D, G,
                   64 / G))
    return ERR_TENSOR_MAP;
  const long long heads = (long long)a.KVH * a.B, qtiles = (a.S + P - 1) / P;
  if (heads > 0x7fffffffLL || qtiles > 65535) return ERR_ARGS;
  dim3 grid((unsigned)heads, (unsigned)qtiles);
  kernel<<<grid, L::kThreads, L::kSmem, a.stream>>>(
      tq, tk, tv, to, a.kv_start, a.S, a.Skv, a.KVH, G, a.scale * kLog2e,
      a.causal);
  return cudaGetLastError();
}

template <int NWG, int BK, int STAGES>
int wgmma_d(const Args& a) {
  switch (a.D) {
    case 64: return launch_wgmma<NWG, 64, BK, STAGES>(a);
    case 128: return launch_wgmma<NWG, 128, BK, STAGES>(a);
    default: return ERR_NO_TILE;
  }
}

// One dispatch_<kernel> per FlashAttentionConfig.kernel; each line is one
// instantiated schedule (bq: query rows per block, bk: KV columns per tile,
// stages: ring depth) for every head dim the kernel takes.  The CPU tests
// read them from this text.  The wgmma schedules with one consumer
// warpgroup (bq = 64) spill at d = 128 under their launch bounds; the tile
// table takes bq = 128 there.
template <typename T>
int dispatch_fma(const Args& a, int bq, int bk) {
  if (bq == 64 && bk == 64) return fma_d<64, 64, T>(a);
  if (bq == 32 && bk == 64) return fma_d<32, 64, T>(a);
  return ERR_NO_TILE;
}

int dispatch_wgmma(const Args& a, int bq, int bk, int stages) {
  if (bq == 64 && bk == 64 && stages == 2) return wgmma_d<1, 64, 2>(a);
  if (bq == 64 && bk == 128 && stages == 2) return wgmma_d<1, 128, 2>(a);
  if (bq == 128 && bk == 128 && stages == 2) return wgmma_d<2, 128, 2>(a);
  return ERR_NO_TILE;
}

}  // namespace

// q: (B, S, H, D); k, v: (B, Skv, KVH, D), each contiguous in its last three
// dims, with the given batch strides (elements).  o: contiguous (B, S, H, D).
// kv_start: (B,) int32 or null.  is_f32: float32 operands (else bfloat16).
// kernel: 0 fma (bf16 or f32), 1 wgmma (bf16; D 64 or 128; H / KVH dividing
// 64; 16-byte aligned bases and batch strides; scale > 0).  Returns
// cudaGetLastError() after the launch, or a negative code: -1 no
// instantiation of (kernel, bq, bk, stages, D), -2 tensor map refused, -4
// arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* kv_start,
                                      void* o, long long q_bstride,
                                      long long k_bstride, long long v_bstride,
                                      int B, int S, int Skv, int H, int KVH,
                                      int D, float scale, int causal,
                                      int is_f32, int kernel, int bq, int bk,
                                      int stages, void* stream) {
  if (B == 0 || S == 0) return 0;
  const Args a{q, k, v, static_cast<const int*>(kv_start), o, q_bstride,
               k_bstride, v_bstride, B, S, Skv, H, KVH, D, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (kernel == KERNEL_WGMMA)
    return is_f32 ? ERR_NO_TILE : dispatch_wgmma(a, bq, bk, stages);
  if (kernel != KERNEL_FMA) return ERR_NO_TILE;
  return is_f32 ? dispatch_fma<float>(a, bq, bk) : dispatch_fma<bf16>(a, bq, bk);
}

extern "C" const char* flash_attention_error_string(int err) {
  switch (err) {
    case ERR_NO_TILE: return "no kernel instantiation for this schedule";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused the operands";
    case ERR_ARGS: return "arguments the kernel does not take";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
