// K1, the GEMM of the port, for Hopper (sm_90a):
//
//     D = act(alpha * A @ B + beta * C + bias)
//
// Replaces the TPU kernel src/repro/kernels/gemm.py::_gemm_kernel (launched
// by gemm_pallas, pallas_call at gemm.py:134).  Same function: float32
// accumulation over K, then the epilogue in this order: alpha, beta*C in
// f32, bias in f32, activation (none, relu, gelu-tanh, silu, tanh), cast to
// the output type.  B is read through its strides: row-major (stride over N
// is 1) or K-major (stride over K is 1, e.g. the tied unembed's
// embedding.T), so a transposed weight is never copied.  Ragged M/N/K edges
// are masked (zero fill in the loads, masked stores); nothing is padded in
// device memory.  Every schedule choice (tile, ring depth, split count,
// raster grouping) arrives as a launch argument from the port's tile table
// (repro_torch/core/tile_config.py); no kernel here chooses one.
//
// Five kernels, one per regime.  Bounds are for llama3.2-1b's serving and
// training shapes on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16, 67
// TFLOP/s f32 outside the tensor cores, 132 SMs):
//
//  * decode, bf16, M <= 16 (gemm_decode_kernel).  Bound by bytes: a decode
//    step reads every weight once (16 x 36.7 MB of projections + the 525 MB
//    tied unembed, ~0.74 ms) and does 2*M FLOP per weight element.  The
//    operands are swapped, D^T (N x M) = W^T (N x K) . X^T (K x M), on
//    mma.sync.m16n8k16: the weight's N fills the MMA's 16 rows and the M <= 16
//    tokens its n = 8 (one or two fragments), so no lane is wasted on padding
//    rows.  Row-major W reaches the A fragment through ldmatrix.trans, K-major
//    W through plain ldmatrix.  To keep enough bytes in flight on all 132
//    SMs, N is cut into 64-column tiles and K into split_k chunks, and each
//    block streams its (chunk x 64) slice of W, with its slice of X, through
//    a ring of `stages` shared-memory buffers filled by 16-byte cp.async.
//    Split-K partials go to an f32 workspace; the last block of a column
//    tile (an integer counter, reset by that block) sums them in split order
//    and applies the epilogue: no float atomics, so the same inputs give the
//    same bits on every run, and since the chunking depends on (K, N) only,
//    a row computes the same bits at M = 8 as at M = 1.
//  * prefill, bf16, large M (gemm_wgmma_kernel).  Bound by operations
//    (2 * 1.24e9 FLOP per token; 0.0695 ms for a 2048 x 2048 x 8192
//    product).  Warp-specialised: one producer warpgroup (one thread)
//    issues TMA loads of 128x64 A and 64xBN B tiles, 128-byte swizzled, into
//    a ring of `stages` buffers tracked by mbarriers; two consumer
//    warpgroups (64 rows each, setmaxnreg moves registers to them) run
//    wgmma.mma_async m64nBNk16 on the tiles that have arrived and keep one
//    group in flight.  A 128 x 256 tile does 85 FLOP per byte it loads
//    (128 x 64: 43) and has a quarter of the tile fills and epilogues,
//    which the K loop does not overlap; the table keeps 128 x 64 only where
//    N is too small to give 132 SMs enough 128 x 256 tiles.  CTAs walk
//    the tiles in columns of group_m tile rows so a wave's panels stay in
//    L2.  The epilogue stages the accumulators in the drained ring and
//    writes rows with 16-byte stores from one rolled loop: a register-direct
//    epilogue (4-byte stores over 8 rows, the activation inlined per
//    accumulator) cost more than the whole K loop.  TMA needs 16-byte
//    aligned bases and row strides; the wrapper sends other operands to WMMA
//    before the launch.
//  * bf16 operands neither path can take (gemm_bf16_kernel): 4 warps of
//    WMMA 16x16x16 tiles, loads then MMAs, no overlap (the first port).
//  * f32, M > 16 (gemm_simt_kernel): the unembed's f32 backward in
//    training (dX = dZ @ W.T and dW = X.T @ dZ over the f32 cotangent, e.g.
//    4096 x 128256 x 2048) and the f32 oracles' prefill.  Bound by FP32
//    operations: 2 * M * N * K FLOP at 67 TFLOP/s (32 ms for each of
//    llama's two), far above the bytes.  Full precision, never TF32 or a
//    split bf16 product: every output is one fmaf chain over k = 0 .. K - 1
//    in ascending order from +0.0f, as gemm_f32_kernel computes it, so the
//    two give the same bits on every input, whatever the tile or M (no
//    split-K, no reordering).  To reach the FP32 pipes, each thread owns 8 x
//    8 outputs (2 x 2 fragments of 4 x 4; 128 x 128 x 16 a block of 256
//    threads, and 128 x 64 x 8 of 128 threads where N is small), so a k step
//    is 4 16-byte shared loads for 64 FFMA; vector global loads (16 or 8
//    bytes, a template parameter the wrapper picks from the bases and
//    strides) run into registers while the current k tile is computed and
//    are stored transposed into the other half of a double buffer, one
//    barrier a k tile; tiles are walked in columns of group_m tile rows.
//    At most 128 registers a thread keep 2 blocks (4 of 128 threads) an
//    SM.  The k loop is unrolled whole (unrolled by 4 it spilled and ran
//    slower on an H100).
//    f32 operands no vector path takes (a 4-byte-only base or row stride)
//    go to gemm_f32_kernel; the wrapper decides before the launch.
//  * f32, M <= 16, and the operands above (gemm_f32_kernel): plain FMA,
//    4 x 4 outputs a thread, scalar loads, one shared buffer (the first
//    port's kernel), the same fmaf chain.
#include <cuda.h>   // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // PTX wrappers: cp.async, ldmatrix, mma.sync, mbarrier, TMA, wgmma

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };
enum { KERNEL_WMMA = 0, KERNEL_FMA = 1, KERNEL_DECODE = 2, KERNEL_WGMMA = 3,
       KERNEL_SIMT = 4 };
// Return codes besides cudaError_t: no instantiation for the schedule, a
// tensor map cuTensorMapEncodeTiled refused, a split-K launch without its
// workspace, arguments the kernel does not take.
enum { ERR_NO_TILE = -1, ERR_TENSOR_MAP = -2, ERR_WORKSPACE = -3, ERR_ARGS = -4 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.0f + expf(-x));
    case ACT_TANH: return tanhf(x);
    default: return x;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Epilogue {
  const float* C;     // optional (M, N) f32, row stride ldc
  long long ldc;
  const float* bias;  // optional (N,) f32
  float alpha, beta;
  int act;
};

// FAST (the wgmma kernel's epilogue, which does not overlap its K loop):
// SiLU through __expf and __fdividef, a few ulp from expf and the IEEE
// division, far inside what a bf16 or f32 result is held to.  alpha, beta
// * C and bias are rounded one operation at a time (the _rn intrinsics are
// never fused into an FMA), so every kernel, whatever code surrounds its
// epilogue, rounds them alike: with alpha = 1 and no C, the only case the
// models issue, that is what an FMA of alpha, acc and bias gives too.
template <bool FAST = false>
__device__ __forceinline__ float epilogue(float acc, int gm, int gn,
                                          const Epilogue& ep) {
  float out = __fmul_rn(ep.alpha, acc);
  if (ep.C) out = __fadd_rn(out, __fmul_rn(ep.beta, ep.C[(long long)gm * ep.ldc + gn]));
  if (ep.bias) out = __fadd_rn(out, ep.bias[gn]);
  if (FAST && ep.act == ACT_SILU) return __fdividef(out, 1.0f + __expf(-out));
  return activate(out, ep.act);
}

template <typename OutT>
__device__ __forceinline__ void store_one(OutT* D, long long ldd, int gm, int gn,
                                          float acc, const Epilogue& ep) {
  D[(long long)gm * ldd + gn] = from_f32<OutT>(epilogue(acc, gm, gn, ep));
}

// The output type of the decode and wgmma kernels is a runtime flag.
__device__ __forceinline__ void store_out(void* D, bool out_f32, long long ldd,
                                          int gm, int gn, float acc,
                                          const Epilogue& ep) {
  if (out_f32) store_one<float>(static_cast<float*>(D), ldd, gm, gn, acc, ep);
  else store_one<bf16>(static_cast<bf16*>(D), ldd, gm, gn, acc, ep);
}

// Eight neighbouring columns gn .. gn + 7 of row gm, from row[c .. c + 7] in
// shared memory, masked at the edges; one 16-byte store (bf16) or two
// (f32) where all eight lie inside and the address allows it.
__device__ __forceinline__ void store_row8(void* D, bool out_f32, long long ldd,
                                           int gm, int gn, const float* row, int c,
                                           int M, int N, const Epilogue& ep) {
  if (gm >= M || gn >= N) return;
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    o[j] = gn + j < N ? epilogue<true>(row[c + j], gm, gn + j, ep) : 0.0f;
  const long long at = (long long)gm * ldd + gn;
  if (out_f32) {
    float* d = static_cast<float*>(D) + at;
    if (gn + 8 <= N && at % 4 == 0) {
      reinterpret_cast<float4*>(d)[0] = make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(d)[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gn + j < N) d[j] = o[j];
    }
  } else {
    bf16* d = static_cast<bf16*>(D) + at;
    if (gn + 8 <= N && at % 8 == 0) {
      uint4 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
      *reinterpret_cast<uint4*>(d) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gn + j < N) d[j] = __float2bfloat16_rn(o[j]);
    }
  }
}

// Copy 8 consecutive bf16 (16 bytes) from device memory into shared memory,
// zero-filling what lies outside the matrix.  `g` is the index of the first
// element along the contiguous dimension and `limit` that dimension's size.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, bool row_ok,
                                      int g, int limit, bool vec) {
  if (row_ok && vec && g + 8 <= limit) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = (row_ok && g + e < limit) ? s[e] : 0;
  }
}

// ---------------------------------------------------------------------------
// bf16 x bf16 -> f32 accumulate, tensor cores (WMMA), 4 warps per block
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, int WARPS_M, bool B_KMAJOR>
struct Bf16Tile {
  static constexpr int kPad = 8;
  static constexpr int kLdA = BK + kPad;                          // As[BM][kLdA]
  static constexpr int kLdB = B_KMAJOR ? BK + kPad : BN + kPad;   // Bs[BN][..] or Bs[BK][..]
  static constexpr int kBElems = B_KMAJOR ? BN * kLdB : BK * kLdB;
  static constexpr int kLdC = BN + 4;
  static constexpr int kInBytes = (BM * kLdA + kBElems) * 2;
  static constexpr int kOutBytes = BM * kLdC * 4;
  static constexpr int kSmem = kInBytes > kOutBytes ? kInBytes : kOutBytes;
};

template <int BM, int BN, int BK, int WARPS_M, bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ A, long long lda,
                 const bf16* __restrict__ B, long long sbk, long long sbn,
                 OutT* __restrict__ D, long long ldd, int M, int N, int K,
                 Epilogue ep, bool vec_a, bool vec_b) {
  typedef Bf16Tile<BM, BN, BK, WARPS_M, B_KMAJOR> Tile;
  constexpr int NT = 128;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int FM = WTM / 16, FN = WTN / 16;
  static_assert(WARPS_M * WARPS_N == 4, "four warps per block");
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "WMMA tiles");
  typedef typename std::conditional<B_KMAJOR, wmma::col_major,
                                    wmma::row_major>::type BLayout;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * Tile::kLdA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int ch = tid; ch < BM * BK / 8; ch += NT) {
      const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      load8(As + r * Tile::kLdA + c, A + (long long)gm * lda + gk, gm < M, gk,
            K, vec_a);
    }
    if (B_KMAJOR) {  // element (k, n) at B[n * sbn + k]; stored Bs[n][k]
      for (int ch = tid; ch < BN * BK / 8; ch += NT) {
        const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        load8(Bs + r * Tile::kLdB + c, B + (long long)gn * sbn + gk, gn < N,
              gk, K, vec_b);
      }
    } else {         // element (k, n) at B[k * sbk + n]; stored Bs[k][n]
      for (int ch = tid; ch < BK * BN / 8; ch += NT) {
        const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        load8(Bs + r * Tile::kLdB + c, B + (long long)gk * sbk + gn, gk < K,
              gn, N, vec_b);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WTM + i * 16) * Tile::kLdA + kk,
                               Tile::kLdA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const bf16* p = B_KMAJOR ? Bs + (wn * WTN + j * 16) * Tile::kLdB + kk
                                 : Bs + kk * Tile::kLdB + wn * WTN + j * 16;
        wmma::load_matrix_sync(fb[j], p, Tile::kLdB);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WTM + i * 16) * Tile::kLdC + wn * WTN + j * 16,
                              acc[i][j], Tile::kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) store_one<OutT>(D, ldd, gm, gn, Cs[r * Tile::kLdC + c], ep);
  }
}

// ---------------------------------------------------------------------------
// f32 x f32, plain FMA in full precision, 16 x 16 threads per block
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, long long lda,
                const float* __restrict__ B, long long sbk, long long sbn,
                OutT* __restrict__ D, long long ldd, int M, int N, int K,
                Epilogue ep) {
  constexpr int NT = 256, TM = BM / 16, TN = BN / 16;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "16 x 16 threads");
  __shared__ float As[BK][BM + 1];  // transposed: As[k][m]
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(long long)gm * lda + gk] : 0.0f;
    }
    if (B_KMAJOR) {
      for (int e = tid; e < BN * BK; e += NT) {
        const int r = e / BK, c = e % BK, gn = n0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? B[(long long)gn * sbn + gk] : 0.0f;
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN, gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gk < K && gn < N) ? B[(long long)gk * sbk + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) store_one<OutT>(D, ldd, gm, gn, acc[i][j], ep);
    }
}

// Output tile of CTA `id`: CTAs walk the (M / BM) x (N / BN) grid of tiles
// in columns of group_m tile rows, so that the A and B panels a wave of CTAs
// reads stay in L2.
__device__ __forceinline__ void tile_of(int id, int group_m, int m_tiles, int n_tiles,
                                        int& m_tile, int& n_tile) {
  const int per_group = group_m * n_tiles;
  const int first = (id / per_group) * group_m;
  const int rows = min(group_m, m_tiles - first);
  const int in_group = id % per_group;
  m_tile = first + in_group % rows;
  n_tile = in_group / rows;
}

// ---------------------------------------------------------------------------
// f32 x f32, register-blocked SIMT: 8 x 8 outputs a thread, double-buffered
// ---------------------------------------------------------------------------
// A block of (BM / 8) x (BN / 8) threads owns a BM x BN tile.  Thread (tr,
// tc) owns rows tr*4 .. +3 and BM/2 + tr*4 .. +3 and the same two groups of
// columns: 2 x 2 fragments of 4 x 4, so that each k step reads its 8 A and
// 8 B values as four 16-byte shared loads (A stored transposed, As[k][m]).
// Global loads are VEC floats wide (VEC * 4 = 16 or 8 bytes; the wrapper
// picks VEC from the bases and strides) and go through registers into the
// other half of a double buffer while the current half is computed: one
// barrier a k step.
template <int BM, int BN, int BK, int VEC, bool B_KMAJOR>
struct SimtTile {
  static constexpr int kThreads = (BM / 8) * (BN / 8);
  static constexpr int kLdA = BM + 4;                   // As[k][m]; 16-byte rows
  static constexpr int kLdB = BN + 4;                   // Bs[k][n]
  static constexpr int kAVecs = BM * BK / VEC / kThreads;  // a thread's, a k step
  static constexpr int kBVecs = BN * BK / VEC / kThreads;
  static_assert(BM % 32 == 0 && BN % 64 == 0, "warps of 4 x 8 threads");
  static_assert(kAVecs * VEC * kThreads == BM * BK &&
                kBVecs * VEC * kThreads == BN * BK && BK % VEC == 0,
                "whole vectors a thread");
};

// VEC consecutive floats from p[0 .. VEC - 1], those at index >= `left` (and
// all of them when !ok) read as zeros.  p must be VEC * 4-byte aligned.
template <int VEC>
__device__ __forceinline__ void load_vec(float* v, const float* p, bool ok,
                                         int left) {
  if (ok && left >= VEC) {
    if constexpr (VEC == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = t.x; v[1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = (ok && j < left) ? p[j] : 0.0f;
  }
}

// Four neighbouring columns gn .. gn + 3 of row gm, masked at N; one vector
// store where all four lie inside and the address allows it.  Each value
// goes through the same epilogue and rounding as store_one.
__device__ __forceinline__ void store_four(void* D, bool out_f32, long long ldd,
                                           int gm, int gn, float4 v, int N,
                                           const Epilogue& ep) {
  const float in[4] = {v.x, v.y, v.z, v.w};
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = gn + j < N ? epilogue(in[j], gm, gn + j, ep) : 0.0f;
  const long long at = (long long)gm * ldd + gn;
  const bool whole = gn + 4 <= N && at % 4 == 0;
  if (out_f32) {
    float* d = static_cast<float*>(D) + at;
    if (whole) {
      *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) d[j] = o[j];
    }
  } else {
    bf16* d = static_cast<bf16*>(D) + at;
    if (whole) {
      uint2 w;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
      h[0] = __halves2bfloat162(__float2bfloat16_rn(o[0]), __float2bfloat16_rn(o[1]));
      h[1] = __halves2bfloat162(__float2bfloat16_rn(o[2]), __float2bfloat16_rn(o[3]));
      *reinterpret_cast<uint2*>(d) = w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) d[j] = __float2bfloat16_rn(o[j]);
    }
  }
}

template <int BM, int BN, int BK, int VEC, bool B_KMAJOR>
__global__ void __launch_bounds__((BM / 8) * (BN / 8), 512 / ((BM / 8) * (BN / 8)))
gemm_simt_kernel(const float* __restrict__ A, long long lda,
                 const float* __restrict__ B, long long sbk, long long sbn,
                 void* __restrict__ D, long long ldd, int M, int N, int K,
                 Epilogue ep, bool out_f32, int group_m) {
  typedef SimtTile<BM, BN, BK, VEC, B_KMAJOR> Tile;
  constexpr int NT = Tile::kThreads;
  __shared__ __align__(16) float As[2][BK][Tile::kLdA];
  __shared__ __align__(16) float Bs[2][BK][Tile::kLdB];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int m_tile, n_tile;
  tile_of(blockIdx.x, group_m, (M + BM - 1) / BM, (N + BN - 1) / BN, m_tile, n_tile);
  const int m0 = m_tile * BM, n0 = n_tile * BN;
  // warps of 4 x 8 threads; BM / 32 warps down the tile
  const int tr = (warp % (BM / 32)) * 4 + lane / 8;
  const int tc = (warp / (BM / 32)) * 8 + lane % 8;

  // The k-contiguous operands (A, and a K-major B) are read VEC k at a
  // time, BK / VEC threads to a row; a row-major B VEC n at a time.
  float ra[Tile::kAVecs][VEC], rb[Tile::kBVecs][VEC];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tile::kAVecs; ++i) {
      const int e = tid + i * NT, r = e / (BK / VEC), gk = k0 + (e % (BK / VEC)) * VEC;
      load_vec<VEC>(ra[i], A + (long long)(m0 + r) * lda + gk, m0 + r < M, K - gk);
    }
#pragma unroll
    for (int i = 0; i < Tile::kBVecs; ++i) {
      const int e = tid + i * NT;
      if (B_KMAJOR) {  // element (k, n) at B[n * sbn + k]
        const int r = e / (BK / VEC), gk = k0 + (e % (BK / VEC)) * VEC;
        load_vec<VEC>(rb[i], B + (long long)(n0 + r) * sbn + gk, n0 + r < N, K - gk);
      } else {         // element (k, n) at B[k * sbk + n]
        const int r = e / (BN / VEC), gn = n0 + (e % (BN / VEC)) * VEC;
        load_vec<VEC>(rb[i], B + (long long)(k0 + r) * sbk + gn, k0 + r < K, N - gn);
      }
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int i = 0; i < Tile::kAVecs; ++i) {
      const int e = tid + i * NT, r = e / (BK / VEC), c = (e % (BK / VEC)) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) As[buf][c + j][r] = ra[i][j];
    }
#pragma unroll
    for (int i = 0; i < Tile::kBVecs; ++i) {
      const int e = tid + i * NT;
      if (B_KMAJOR) {
        const int r = e / (BK / VEC), c = (e % (BK / VEC)) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) Bs[buf][c + j][r] = rb[i][j];
      } else {
        const int r = e / (BN / VEC), c = (e % (BN / VEC)) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) Bs[buf][r][c + j] = rb[i][j];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Zero-filled k >= K adds fmaf(0, 0, acc) = acc: every output is the
  // fmaf chain over k = 0 .. K - 1 in ascending order that gemm_f32_kernel
  // computes, whatever the tile.
  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    gload(0);
    sstore(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * BK);  // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][BM / 2 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][BN / 2 + tc * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other half was last read in step kt - 1, which every thread
    // finished before the barrier that ended it
    if (kt + 1 < nk) sstore(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * (BM / 2) + tr * 4 + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * (BN / 2) + tc * 4;
      if (gn < N)
        store_four(D, out_f32, ldd, gm, gn,
                   make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                               acc[i][4 * h + 3]),
                   N, ep);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 decode, M <= 16: D^T = W^T X^T on mma.sync.m16n8k16, split-K, cp.async
// ---------------------------------------------------------------------------
// A block owns BN = 64 weight columns (4 warps x 16, the MMA's rows) and one
// K chunk; it streams the chunk in BK steps through a ring of STAGES buffers,
// each holding a BK x BN slice of W and the 16 x BK slice of X.  Rows are
// padded by 16 bytes so that ldmatrix reads are free of bank conflicts.
template <int BK, int BN, bool B_KMAJOR>
struct DecodeTile {
  static constexpr int kLdW = B_KMAJOR ? BK + 8 : BN + 8;  // Ws[n][k] or Ws[k][n]
  static constexpr int kWElems = (B_KMAJOR ? BN : BK) * kLdW;
  static constexpr int kLdX = BK + 8;                      // Xs[m][k], 16 rows
  static constexpr int kStageElems = kWElems + 16 * kLdX;
  static constexpr int kLdC = BN + 4;                      // Cs[m][n], f32
};

template <int BK, int BN, int STAGES, bool B_KMAJOR>
__global__ void __launch_bounds__(128)
gemm_decode_kernel(const bf16* __restrict__ X, long long ldx,
                   const bf16* __restrict__ W, long long sbk, long long sbn,
                   void* __restrict__ D, long long ldd, int M, int N, int K,
                   int k_chunk, Epilogue ep, bool out_f32,
                   float* __restrict__ ws, int* __restrict__ counters) {
  typedef DecodeTile<BK, BN, B_KMAJOR> Tile;
  static_assert(BN == 64 && BK % 16 == 0 && STAGES >= 2, "decode tile");
  static_assert(Tile::kLdC * 16 * 4 <= STAGES * Tile::kStageElems * 2, "Cs fits");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int kbeg = split * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int nk = (kend - kbeg + BK - 1) / BK;

  auto load_stage = [&](int stage, int k0) {
    bf16* Ws = ring + stage * Tile::kStageElems;
    bf16* Xs = Ws + Tile::kWElems;
    if (B_KMAJOR) {  // W element (k, n) at W[n * sbn + k]; stored Ws[n][k]
      for (int ch = tid; ch < BN * BK / 8; ch += 128) {
        const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        const bool ok = gn < N && gk < kend;
        cp_async16(Ws + r * Tile::kLdW + c, ok ? W + (long long)gn * sbn + gk : W, ok);
      }
    } else {         // W element (k, n) at W[k * sbk + n]; stored Ws[k][n]
      for (int ch = tid; ch < BK * BN / 8; ch += 128) {
        const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < kend && gn < N;
        cp_async16(Ws + r * Tile::kLdW + c, ok ? W + (long long)gk * sbk + gn : W, ok);
      }
    }
    for (int ch = tid; ch < 16 * BK / 8; ch += 128) {  // rows >= M land as zeros
      const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
      const int gk = k0 + c;
      const bool ok = r < M && gk < kend;
      cp_async16(Xs + r * Tile::kLdX + c, ok ? X + (long long)r * ldx + gk : X, ok);
    }
  };

  float acc[2][4];  // tokens 0-7 and 8-15
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.0f;
  const bool two = M > 8;  // tokens 8..15 need the second n-fragment

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    {
      const int nx = it + STAGES - 1;
      if (nx < nk) load_stage(nx % STAGES, kbeg + nx * BK);
      cp_async_commit();
    }
    const bf16* Ws = ring + (it % STAGES) * Tile::kStageElems;
    const bf16* Xs = Ws + Tile::kWElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // B = X^T, k kk..kk+15: tokens 0-7 in b[0..1], 8-15 in b[2..3]
      const bf16* xp = Xs + (((lane >> 4) << 3) + (lane & 7)) * Tile::kLdX + kk +
                       ((lane >> 3) & 1) * 8;
      uint32_t b[4];
      if (two) {
        ldsm_x4(b, xp);
      } else {
        uint32_t h[2];
        ldsm_x2(h, xp);
        b[0] = h[0]; b[1] = h[1]; b[2] = b[3] = 0;
      }
      uint32_t a[4];  // A = W^T rows warp * 16 .., k kk ..
      if (B_KMAJOR)
        ldsm_x4(a, Ws + (warp * 16 + (lane & 15)) * Tile::kLdW + kk + (lane >> 4) * 8);
      else
        ldsm_x4_trans(a, Ws + (kk + (lane & 7) + ((lane >> 4) << 3)) * Tile::kLdW +
                             warp * 16 + ((lane >> 3) & 1) * 8);
      mma_16816(acc[0], a, b[0], b[1]);
      if (two) mma_16816(acc[1], a, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: Cs reuses it

  // fragment element (row n, column m) -> Cs[m][n]
  const int nl = warp * 16 + (lane >> 2), ml = (lane & 3) * 2;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int m = f * 8 + ml;
    Cs[m * Tile::kLdC + nl] = acc[f][0];
    Cs[(m + 1) * Tile::kLdC + nl] = acc[f][1];
    Cs[m * Tile::kLdC + nl + 8] = acc[f][2];
    Cs[(m + 1) * Tile::kLdC + nl + 8] = acc[f][3];
  }
  __syncthreads();

  if (splits == 1) {
    for (int e = tid; e < M * BN; e += 128) {
      const int m = e / BN, c = e % BN, gn = n0 + c;
      if (gn < N) store_out(D, out_f32, ldd, m, gn, Cs[m * Tile::kLdC + c], ep);
    }
    return;
  }
  // split-K: write this chunk's partial, then the last block of the column
  // tile sums all partials in split order and applies the epilogue
  float* part = ws + (long long)split * M * N;
  for (int e = tid; e < M * BN; e += 128) {
    const int m = e / BN, c = e % BN, gn = n0 + c;
    if (gn < N) part[(long long)m * N + gn] = Cs[m * Tile::kLdC + c];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < M * BN; e += 128) {
    const int m = e / BN, c = e % BN, gn = n0 + c;
    if (gn >= N) continue;
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s)
      sum += __ldcg(ws + ((long long)s * M + m) * N + gn);
    store_out(D, out_f32, ldd, m, gn, sum, ep);
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// bf16 prefill, large M: TMA + wgmma, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------
template <int BN, int STAGES>
struct WgmmaTile {
  static constexpr int BM = 128, BK = 64;  // BK * 2 bytes = the 128-byte swizzle
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBytes = BN * BK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // 1024 bytes of slack to align the ring (the swizzle atom), then the ring,
  // then a full and an empty barrier per stage
  static constexpr int kSmem = 1024 + STAGES * kStageBytes + 2 * STAGES * 8;
};

template <int BN, int STAGES, bool B_KMAJOR>
__global__ void __launch_bounds__(384, 1)
gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tma_a,
                  __grid_constant__ const CUtensorMap tma_b,
                  void* __restrict__ D, long long ldd, int M, int N, int K,
                  Epilogue ep, bool out_f32, int group_m) {
  typedef WgmmaTile<BN, STAGES> Tile;
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma n");
  static_assert(2 * 64 * (BN + 4) * 4 <= STAGES * Tile::kStageBytes, "epilogue fits");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Tile::kStageBytes);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  int m_tile, n_tile;
  tile_of(blockIdx.x, group_m, (M + Tile::BM - 1) / Tile::BM, (N + BN - 1) / BN,
          m_tile, n_tile);
  const int m0 = m_tile * Tile::BM, n0 = n_tile * BN;
  const int nk = (K + Tile::BK - 1) / Tile::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps up to STAGES tiles in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * Tile::kStageBytes;
        unsigned char* sb = st + Tile::kABytes;
        mbar_expect_tx(&full[s], Tile::kStageBytes);
        tma_load_2d(st, &tma_a, kt * Tile::BK, m0, &full[s]);
        if (B_KMAJOR) {  // box: 64 k x BN rows of n
          tma_load_2d(sb, &tma_b, kt * Tile::BK, n0, &full[s]);
        } else {         // boxes: 64 n x 64 rows of k, BN / 64 side by side
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(sb + j * 64 * Tile::BK * 2, &tma_b, n0 + 64 * j,
                        kt * Tile::BK, &full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg - 1 owns rows m0 + 64 (wg - 1) .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const bool releaser = threadIdx.x % 32 == 0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* a_tile = smem + s * Tile::kStageBytes + cw * 64 * Tile::BK * 2;
      const unsigned char* b_tile = smem + s * Tile::kStageBytes + Tile::kABytes;
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Tile::BK / 16; ++kk) {
        // A: K-major rows of 128 B, 8-row groups 1024 B apart; k16 = 32 B
        const uint64_t da = sw128_desc(a_tile + kk * 32, 16, 1024);
        // B: K-major as A; or MN-major, 64-column blocks of 64 k rows
        // (8192 B apart), 8-k groups 1024 B apart, k16 = 16 rows of 128 B
        const uint64_t db = B_KMAJOR
            ? sw128_desc(b_tile + kk * 32, 16, 1024)
            : sw128_desc(b_tile + kk * 16 * 128, 64 * Tile::BK * 2, 1024);
        Wgmma<BN>::template mma<B_KMAJOR ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage kt - 1 are done with it
      fence_regs<BN / 2>(acc);
      if (kt > 0) {
        __syncwarp();
        if (releaser) mbar_arrive(&empty[(kt - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);

    // Epilogue.  Once both consumer warpgroups are done with the ring (named
    // barrier 1), each stages its 64 x BN f32 tile there: accumulator element
    // 4i + {0,1,2,3} is row r (+8 for 2, 3), column 8i + 2 (lane % 4) (+1
    // for 1, 3).  Then (barrier 2 + cw) it writes the tile out in rows, 8
    // columns a thread, from one rolled loop: coalesced 16-byte stores, and
    // one copy of the epilogue's code.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    constexpr int LD = BN + 4;
    float* cs = reinterpret_cast<float*>(smem) + cw * 64 * LD;
    const int t = threadIdx.x % 128;
    const int r0 = (t / 32) * 16 + (t % 32) / 4, c0 = (t % 4) * 2;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      *reinterpret_cast<float2*>(cs + r0 * LD + 8 * i + c0) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(cs + (r0 + 8) * LD + 8 * i + c0) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + cw) : "memory");
#pragma unroll 1
    for (int e = t; e < 64 * (BN / 8); e += 128) {
      const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      store_row8(D, out_f32, ldd, m0 + cw * 64 + r, n0 + c, cs + r * LD, c, M, N, ep);
    }
  }
}

// ---------------------------------------------------------------------------
// host-side launchers
// ---------------------------------------------------------------------------
struct Args {
  const void* A; long long lda;
  const void* B; long long sbk, sbn;
  void* D; long long ldd;
  int M, N, K;
  Epilogue ep;
  bool out_f32;
  int k_chunk;      // decode: K elements per split
  float* ws;        // decode split-K: (splits, M, N) f32 partials
  int* counters;    // decode split-K: one zeroed int per column tile
  int group_m;      // wgmma, simt: tile rows per raster column
  int vec;          // simt: bytes a global load reads (16 or 8)
  cudaStream_t stream;
};

template <int BM, int BN, int BK, int WARPS_M, bool B_KMAJOR, typename OutT>
cudaError_t launch_bf16(const Args& a) {
  typedef Bf16Tile<BM, BN, BK, WARPS_M, B_KMAJOR> Tile;
  auto kernel = gemm_bf16_kernel<BM, BN, BK, WARPS_M, B_KMAJOR, OutT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const bool vec_a = (reinterpret_cast<uintptr_t>(a.A) % 16 == 0) && (a.lda % 8 == 0);
  const bool vec_b = (reinterpret_cast<uintptr_t>(a.B) % 16 == 0) &&
                     ((B_KMAJOR ? a.sbn : a.sbk) % 8 == 0);
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  kernel<<<grid, 128, Tile::kSmem, a.stream>>>(
      static_cast<const bf16*>(a.A), a.lda, static_cast<const bf16*>(a.B),
      a.sbk, a.sbn, static_cast<OutT*>(a.D), a.ldd, a.M, a.N, a.K, a.ep,
      vec_a, vec_b);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool B_KMAJOR, typename OutT>
cudaError_t launch_f32(const Args& a) {
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  gemm_f32_kernel<BM, BN, BK, B_KMAJOR, OutT><<<grid, 256, 0, a.stream>>>(
      static_cast<const float*>(a.A), a.lda, static_cast<const float*>(a.B),
      a.sbk, a.sbn, static_cast<OutT*>(a.D), a.ldd, a.M, a.N, a.K, a.ep);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool B_KMAJOR>
int launch_simt(const Args& a) {
  if (a.group_m < 1) return ERR_ARGS;
  const long long tiles = (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return ERR_ARGS;
  constexpr int threads = (BM / 8) * (BN / 8);
  const float* A = static_cast<const float*>(a.A);
  const float* B = static_cast<const float*>(a.B);
  if (a.vec == 16)
    gemm_simt_kernel<BM, BN, BK, 4, B_KMAJOR><<<(unsigned)tiles, threads, 0, a.stream>>>(
        A, a.lda, B, a.sbk, a.sbn, a.D, a.ldd, a.M, a.N, a.K, a.ep, a.out_f32, a.group_m);
  else if (a.vec == 8)
    gemm_simt_kernel<BM, BN, BK, 2, B_KMAJOR><<<(unsigned)tiles, threads, 0, a.stream>>>(
        A, a.lda, B, a.sbk, a.sbn, a.D, a.ldd, a.M, a.N, a.K, a.ep, a.out_f32, a.group_m);
  else
    return ERR_ARGS;
  return cudaGetLastError();
}

template <int BK, int BN, int STAGES, bool B_KMAJOR>
int launch_decode(const Args& a) {
  typedef DecodeTile<BK, BN, B_KMAJOR> Tile;
  auto kernel = gemm_decode_kernel<BK, BN, STAGES, B_KMAJOR>;
  constexpr int smem = STAGES * Tile::kStageElems * 2;
  if (a.M > 16 || a.K <= 0 || a.k_chunk <= 0 || a.k_chunk % BK != 0) return ERR_ARGS;
  const int splits = (a.K + a.k_chunk - 1) / a.k_chunk;
  if (splits > 65535) return ERR_ARGS;
  if (splits > 1 && (a.ws == nullptr || a.counters == nullptr)) return ERR_WORKSPACE;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.N + BN - 1) / BN, splits);
  kernel<<<grid, 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.A), a.lda, static_cast<const bf16*>(a.B),
      a.sbk, a.sbn, a.D, a.ldd, a.M, a.N, a.K, a.k_chunk, a.ep, a.out_f32,
      a.ws, a.counters);
  return cudaGetLastError();
}

// A 2-D bf16 tensor map: `inner` contiguous elements per row, `outer` rows
// `ld` elements apart, boxes of box_inner x box_outer, 128-byte swizzle,
// zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* base, long long inner,
              long long outer, long long ld, int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t estride[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int STAGES, bool B_KMAJOR>
int launch_wgmma(const Args& a) {
  typedef WgmmaTile<BN, STAGES> Tile;
  auto kernel = gemm_wgmma_kernel<BN, STAGES, B_KMAJOR>;
  if (a.K <= 0 || a.group_m < 1) return ERR_ARGS;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ta, tb;
  if (!make_map(&ta, a.A, a.K, a.M, a.lda, Tile::BK, Tile::BM)) return ERR_TENSOR_MAP;
  const bool ok_b = B_KMAJOR
      ? make_map(&tb, a.B, a.K, a.N, a.sbn, Tile::BK, BN)
      : make_map(&tb, a.B, a.N, a.K, a.sbk, 64, Tile::BK);
  if (!ok_b) return ERR_TENSOR_MAP;
  const long long tiles = ((a.M + Tile::BM - 1) / Tile::BM) * ((a.N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return ERR_ARGS;
  kernel<<<(unsigned)tiles, 384, Tile::kSmem, a.stream>>>(
      ta, tb, a.D, a.ldd, a.M, a.N, a.K, a.ep, a.out_f32, a.group_m);
  return cudaGetLastError();
}

// One dispatch_<kernel> per TileConfig.kernel; each line is one instantiated
// schedule (the CPU tests read them from this text).
template <bool B_KMAJOR, typename OutT>
int dispatch_wmma(const Args& a, int bm, int bk, int bn) {
  if (bm == 16 && bk == 64 && bn == 64) return launch_bf16<16, 64, 64, 1, B_KMAJOR, OutT>(a);
  if (bm == 64 && bk == 32 && bn == 64) return launch_bf16<64, 64, 32, 2, B_KMAJOR, OutT>(a);
  if (bm == 128 && bk == 32 && bn == 128) return launch_bf16<128, 128, 32, 2, B_KMAJOR, OutT>(a);
  return ERR_NO_TILE;
}

template <bool B_KMAJOR, typename OutT>
int dispatch_fma(const Args& a, int bm, int bk, int bn) {
  if (bm == 16 && bk == 16 && bn == 128) return launch_f32<16, 128, 16, B_KMAJOR, OutT>(a);
  if (bm == 64 && bk == 16 && bn == 64) return launch_f32<64, 64, 16, B_KMAJOR, OutT>(a);
  return ERR_NO_TILE;
}

template <bool B_KMAJOR>
int dispatch_simt(const Args& a, int bm, int bk, int bn) {
  if (bm == 128 && bk == 16 && bn == 128) return launch_simt<128, 128, 16, B_KMAJOR>(a);
  if (bm == 128 && bk == 8 && bn == 64) return launch_simt<128, 64, 8, B_KMAJOR>(a);
  return ERR_NO_TILE;
}

template <bool B_KMAJOR>
int dispatch_decode(const Args& a, int bm, int bk, int bn, int stages) {
  if (bm == 16 && bk == 128 && bn == 64 && stages == 4) return launch_decode<128, 64, 4, B_KMAJOR>(a);
  if (bm == 16 && bk == 128 && bn == 64 && stages == 3) return launch_decode<128, 64, 3, B_KMAJOR>(a);
  if (bm == 16 && bk == 128 && bn == 64 && stages == 2) return launch_decode<128, 64, 2, B_KMAJOR>(a);
  if (bm == 16 && bk == 128 && bn == 64 && stages == 5) return launch_decode<128, 64, 5, B_KMAJOR>(a);
  if (bm == 16 && bk == 128 && bn == 64 && stages == 6) return launch_decode<128, 64, 6, B_KMAJOR>(a);
  return ERR_NO_TILE;
}

template <bool B_KMAJOR>
int dispatch_wgmma(const Args& a, int bm, int bk, int bn, int stages) {
  if (bm == 128 && bk == 64 && bn == 64 && stages == 6) return launch_wgmma<64, 6, B_KMAJOR>(a);
  if (bm == 128 && bk == 64 && bn == 256 && stages == 4) return launch_wgmma<256, 4, B_KMAJOR>(a);
  if (bm == 128 && bk == 64 && bn == 128 && stages == 4) return launch_wgmma<128, 4, B_KMAJOR>(a);
  if (bm == 128 && bk == 64 && bn == 128 && stages == 6) return launch_wgmma<128, 6, B_KMAJOR>(a);
  return ERR_NO_TILE;
}

}  // namespace

// in_f32: A and B are float32 (else bfloat16); out_f32: D is float32 (else
// bfloat16).  C and bias, when given, are float32.  b_kmajor: B's stride over
// K is 1 (else its stride over N is 1).  kernel: 0 wmma, 1 fma (f32 only),
// 2 decode (bf16, M <= 16; k_chunk, and for more than one chunk the
// workspace and counters), 3 wgmma (bf16; 16-byte aligned bases and row
// strides; group_m >= 1 tile rows per raster column), 4 simt (f32; vec 16
// or 8: bases and the row strides of A and B are multiples of vec bytes;
// group_m as wgmma).  Returns cudaGetLastError() after the launch, or a
// negative code: -1 no instantiation of the schedule, -2 tensor map refused, -3
// split-K without workspace, -4 arguments the kernel does not take.
static int gemm_launch(const void* A, long long lda, const void* B,
                       long long sbk, long long sbn, const void* C,
                       long long ldc, const void* bias, void* D,
                       long long ldd, int M, int N, int K, float alpha,
                       float beta, int act, int in_f32, int out_f32,
                       int b_kmajor, int bm, int bk, int bn, int kernel,
                       int stages, int k_chunk, int group_m, int vec,
                       void* workspace, void* counters, void* stream) {
  Args a;
  a.A = A; a.lda = lda; a.B = B; a.sbk = sbk; a.sbn = sbn;
  a.D = D; a.ldd = ldd; a.M = M; a.N = N; a.K = K;
  a.ep.C = static_cast<const float*>(C); a.ep.ldc = ldc;
  a.ep.bias = static_cast<const float*>(bias);
  a.ep.alpha = alpha; a.ep.beta = beta; a.ep.act = act;
  a.out_f32 = out_f32 != 0; a.k_chunk = k_chunk; a.group_m = group_m; a.vec = vec;
  a.ws = static_cast<float*>(workspace); a.counters = static_cast<int*>(counters);
  a.stream = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (in_f32) {
    if (kernel == KERNEL_FMA) {
      if (b_kmajor) return out_f32 ? dispatch_fma<true, float>(a, bm, bk, bn)
                                   : dispatch_fma<true, bf16>(a, bm, bk, bn);
      return out_f32 ? dispatch_fma<false, float>(a, bm, bk, bn)
                     : dispatch_fma<false, bf16>(a, bm, bk, bn);
    }
    if (kernel == KERNEL_SIMT)
      return b_kmajor ? dispatch_simt<true>(a, bm, bk, bn) : dispatch_simt<false>(a, bm, bk, bn);
    return ERR_NO_TILE;
  }
  switch (kernel) {
    case KERNEL_WMMA:
      if (b_kmajor) return out_f32 ? dispatch_wmma<true, float>(a, bm, bk, bn)
                                   : dispatch_wmma<true, bf16>(a, bm, bk, bn);
      return out_f32 ? dispatch_wmma<false, float>(a, bm, bk, bn)
                     : dispatch_wmma<false, bf16>(a, bm, bk, bn);
    case KERNEL_DECODE:
      return b_kmajor ? dispatch_decode<true>(a, bm, bk, bn, stages)
                      : dispatch_decode<false>(a, bm, bk, bn, stages);
    case KERNEL_WGMMA:
      return b_kmajor ? dispatch_wgmma<true>(a, bm, bk, bn, stages)
                      : dispatch_wgmma<false>(a, bm, bk, bn, stages);
    default:
      return ERR_NO_TILE;
  }
}

// The library's entry point: gemm_launch with its integer and pointer
// arguments packed, in the same order, into one array of 64-bit integers:
// one ctypes conversion instead of 30, which is most of a decode launch's
// host time.
extern "C" int gemm_launch_packed(const long long* p, float alpha, float beta) {
  return gemm_launch(
      reinterpret_cast<const void*>(p[0]), p[1], reinterpret_cast<const void*>(p[2]),
      p[3], p[4], reinterpret_cast<const void*>(p[5]), p[6],
      reinterpret_cast<const void*>(p[7]), reinterpret_cast<void*>(p[8]), p[9],
      (int)p[10], (int)p[11], (int)p[12], alpha, beta, (int)p[13], (int)p[14],
      (int)p[15], (int)p[16], (int)p[17], (int)p[18], (int)p[19], (int)p[20],
      (int)p[21], (int)p[22], (int)p[23], (int)p[24], reinterpret_cast<void*>(p[25]),
      reinterpret_cast<void*>(p[26]), reinterpret_cast<void*>(p[27]));
}

extern "C" const char* gemm_error_string(int err) {
  switch (err) {
    case ERR_NO_TILE: return "no kernel instantiation for this schedule";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused the operands";
    case ERR_WORKSPACE: return "split-K launch without workspace or counters";
    case ERR_ARGS: return "arguments the kernel does not take";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
