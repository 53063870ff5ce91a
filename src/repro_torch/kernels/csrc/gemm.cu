// Tiled GEMM for Hopper (sm_90a):  D = act(alpha * A @ B + beta * C + bias)
//
// Replaces the TPU kernel src/repro/kernels/gemm.py::_gemm_kernel (launched
// by gemm_pallas).  Same function: float32 accumulation over K, then the
// epilogue in this order: alpha, beta*C in f32, bias in f32, activation
// (none, relu, gelu-tanh, silu, tanh), cast to the output type.
//
// Design.  One thread block per (BM, BN) output tile; a loop inside the block
// walks K in BK steps through shared memory.  This replaces the TPU's
// sequential "arbitrary" k grid axis: nothing carries across blocks.  The
// tile sizes are template arguments picked from the port's tile table
// (repro_torch/core/tile_config.py) and reach the kernel as launch arguments;
// the kernel holds no tuning choice of its own.
//  * bf16 inputs: 4 warps, WMMA 16x16x16 bf16 -> f32 tensor-core products
//    (mma.sync underneath), the accumulator in registers.
//  * f32 inputs: 256 threads, plain f32 FMA in full precision (never TF32).
//  * B is read through its strides: row-major (stride over N is 1) or
//    K-major (stride over K is 1, e.g. the tied unembed's embedding.T), so a
//    transposed weight is never copied.
//  * Ragged M/N/K edges are masked in the tile loads (zero fill) and in the
//    epilogue stores; nothing is padded in device memory.
//  * Every output element is accumulated in the same K order (k ascending,
//    16 at a time through the tensor core, or one at a time through FMA)
//    whatever M and the tile are, so a row computes the same bits batched or
//    alone.
//
// Bound on the H100 at the serving shapes of llama3.2-1b (bf16):
//  * decode, M = 8: bytes.  Each step reads every weight once (2.5 GB per
//    forward); at 3.35 TB/s that is ~0.75 ms per decode step.  A 16-row tile
//    wastes half of each MMA and N/BN blocks may not fill 132 SMs (8 blocks
//    for the K/V projections); a split-K / GEMV design is later work.
//  * prefill, M = 8 x plen: operations (2 * 1.24e9 FLOP per token against
//    989 TFLOP/s).  No cp.async / TMA pipelining and no wgmma yet: loads and
//    MMAs do not overlap, which is the first thing a faster version fixes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

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

template <typename OutT>
__device__ __forceinline__ void store_one(OutT* D, long long ldd, int gm, int gn,
                                          float acc, const Epilogue& ep) {
  float out = ep.alpha * acc;
  if (ep.C) out += ep.beta * ep.C[(long long)gm * ep.ldc + gn];
  if (ep.bias) out += ep.bias[gn];
  D[(long long)gm * ldd + gn] = from_f32<OutT>(activate(out, ep.act));
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

// ---------------------------------------------------------------------------
// host-side launchers
// ---------------------------------------------------------------------------
struct Args {
  const void* A; long long lda;
  const void* B; long long sbk, sbn;
  void* D; long long ldd;
  int M, N, K;
  Epilogue ep;
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

template <bool B_KMAJOR, typename OutT>
int dispatch_bf16(const Args& a, int bm, int bk, int bn) {
  if (bm == 16 && bk == 64 && bn == 64) return launch_bf16<16, 64, 64, 1, B_KMAJOR, OutT>(a);
  if (bm == 64 && bk == 32 && bn == 64) return launch_bf16<64, 64, 32, 2, B_KMAJOR, OutT>(a);
  if (bm == 128 && bk == 32 && bn == 128) return launch_bf16<128, 128, 32, 2, B_KMAJOR, OutT>(a);
  return -1;  // tile not instantiated
}

template <bool B_KMAJOR, typename OutT>
int dispatch_f32(const Args& a, int bm, int bk, int bn) {
  if (bm == 16 && bk == 16 && bn == 128) return launch_f32<16, 128, 16, B_KMAJOR, OutT>(a);
  if (bm == 64 && bk == 16 && bn == 64) return launch_f32<64, 64, 16, B_KMAJOR, OutT>(a);
  return -1;
}

}  // namespace

// in_f32: A and B are float32 (else bfloat16); out_f32: D is float32 (else
// bfloat16).  C and bias, when given, are float32.  b_kmajor: B's stride over
// K is 1 (else its stride over N is 1).  Returns cudaGetLastError() after the
// launch, or -1 when (bm, bk, bn) has no instantiation.
extern "C" int gemm_launch(const void* A, long long lda, const void* B,
                           long long sbk, long long sbn, const void* C,
                           long long ldc, const void* bias, void* D,
                           long long ldd, int M, int N, int K, float alpha,
                           float beta, int act, int in_f32, int out_f32,
                           int b_kmajor, int bm, int bk, int bn, void* stream) {
  Args a;
  a.A = A; a.lda = lda; a.B = B; a.sbk = sbk; a.sbn = sbn;
  a.D = D; a.ldd = ldd; a.M = M; a.N = N; a.K = K;
  a.ep.C = static_cast<const float*>(C); a.ep.ldc = ldc;
  a.ep.bias = static_cast<const float*>(bias);
  a.ep.alpha = alpha; a.ep.beta = beta; a.ep.act = act;
  a.stream = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (in_f32) {
    if (b_kmajor) return out_f32 ? dispatch_f32<true, float>(a, bm, bk, bn)
                                 : dispatch_f32<true, bf16>(a, bm, bk, bn);
    return out_f32 ? dispatch_f32<false, float>(a, bm, bk, bn)
                   : dispatch_f32<false, bf16>(a, bm, bk, bn);
  }
  if (b_kmajor) return out_f32 ? dispatch_bf16<true, float>(a, bm, bk, bn)
                               : dispatch_bf16<true, bf16>(a, bm, bk, bn);
  return out_f32 ? dispatch_bf16<false, float>(a, bm, bk, bn)
                 : dispatch_bf16<false, bf16>(a, bm, bk, bn);
}

extern "C" const char* gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
