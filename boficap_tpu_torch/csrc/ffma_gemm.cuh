// Building block: the float32 matrix product on Hopper's FFMA units, for
// every float32 product of the layer, stack and window kernels (#1, #2,
// #4-#8, through product<float> in wgmma_gemm.cuh) and for the greedy
// head's float32 logits (#3, greedy_head.cu).  It replaces, at float32,
// the jnp.dot calls of the TPU kernels' bodies
// (boficap_tpu/ops/pallas_decoder_layer.py::_mha :75, _kernel :124,
// _win_kernel :283, _enc_kernel :500, _head_kernel :671;
// pallas_stack.py :583-634).
//
//   C = epilogue(A[M,K] @ W[K,N])     W in the flax [in, out] layout
//
// The float32 contract: each output element is one fmaf chain,
// acc = fmaf(a_k, w_k, acc) from 0.f over k = 0, 1, ..., K - 1 (then zeros
// to the next multiple of BK = 16), with no split-K and no partial sums.
// An element's value therefore depends on its row and column alone, never
// on the tile: the tile may follow M, and rows stay bitwise
// batch-independent.  There is no TF32.
//
// Bound on the H100: operations.  A narrow SA round's products (M = B*W =
// 512 rows, N = 512-2048) are 0.27-1.07 GFLOP each, 4-16 us at the 67
// TFLOP/s of float32 FFMA; the serving layers' are 1-5 GFLOP.  The design:
//
//  - A block tile of BM x BN outputs, RM x RN a thread (8 x 8 at most),
//    in RM / 4 x RN / 4 sub-blocks of 4 x 4 half a tile apart, so a warp's
//    fragment reads are 16-byte loads over consecutive addresses.
//  - k in steps of BK = 16 through a 3-slot shared-memory ring filled by
//    cp.async: W's [16][BN] tile in 16-byte copies where N is a multiple of
//    4 and W 16-byte aligned (else 4-byte copies), A's [BM][16] tile in
//    4-byte copies stored k-major ([16][BM + 4]) so a thread's RM rows at
//    one k are RM / 4 16-byte loads.  Copies past M, N or K fill zeros.
//    One __syncthreads a k step: the slot refilled is the one every thread
//    finished in the step before.
//  - The tile follows M and N (``tile_for``).  128 x 128 (8 x 8 a thread)
//    does the most work per SM, but in coarse waves of NUM_SMS blocks;
//    32 x 64 (4 x 4 a thread, 128 threads, up to 5 blocks an SM) keeps every
//    SM busy.  The rule takes 128 x 128 where its grid keeps at least 3/4 of
//    the SM-waves it takes busy, else 32 x 64: on the H100 it matched or beat
//    the rule "largest tile that fills the SMs" at all 17 serving shapes
//    (scripts/ffma_tile_sweep.py; PERF.md).  The narrow round's 512 x 512
//    products run 128 blocks, where the former 64 x 64 tile left 68 SMs
//    idle.  64 x 128 serves the head's 128-column chunks at small N.
//  - Epilogue (epilogue.cuh): from the registers to global memory, 16-byte
//    vectors of bias, residual and C where N and the pointers allow.
#pragma once

#include <atomic>

#include "epilogue.cuh"

namespace bfc {
namespace ffma {
// Internal linkage, as wgmma_gemm.cuh's tc namespace: each kernel library
// keeps its own kernel stubs and attribute flags.
namespace {

constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int APAD = 4;        // k-major A rows stay 16-byte aligned, and
                               // the 4-byte copies of a warp hit 2 rows of
                               // banks instead of 1
constexpr int NUM_SMS = 132;   // H100 SXM

template <int BM_, int BN_, int RM_, int RN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, RM = RM_, RN = RN_;
  static constexpr int TX = BN / RN;           // threads along a row
  static constexpr int TY = BM / RM;
  static constexpr int THREADS = TX * TY;
  static constexpr int A_STRIDE = BM + APAD;   // floats per k row of A
  static constexpr int A_FLOATS = BK * A_STRIDE;
  static constexpr int W_FLOATS = BK * BN;
  static constexpr int SMEM = STAGES * (A_FLOATS + W_FLOATS) * 4;
  // two blocks an SM: at most 128 registers a thread for the 8 x 8 tile
  static constexpr int MIN_BLOCKS = 2;
  static_assert(RM % 4 == 0 && RN % 4 == 0 && RM <= 8 && RN <= 8, "");
  static_assert(TX <= 32 && 32 % TX == 0, "a row's lanes share a warp");
  static_assert((BM * BK) % THREADS == 0 && (BK * BN / 4) % THREADS == 0,
                "");
};

// the tiles, largest first; tile ids 1-3
using T128x128 = Tile<128, 128, 8, 8>;   // 256 threads
using T64x128 = Tile<64, 128, 4, 8>;     // 256 threads
using T32x64 = Tile<32, 64, 4, 4>;       // 128 threads

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// k tile kt of A (k-major) and W into one ring slot; zeros outside
template <class TL, bool VEC>
__device__ __forceinline__ void load_tile(float* As, float* Ws,
                                          const float* __restrict__ A,
                                          const float* __restrict__ W, int M,
                                          int N, int K, int m0, int n0,
                                          int kt) {
  const int tid = threadIdx.x;
  const int k0 = kt * BK;
#pragma unroll
  for (int i = 0; i < TL::BM * BK / TL::THREADS; ++i) {
    const int e = tid + i * TL::THREADS;
    const int m = e / BK, k = e % BK;
    const bool in = m0 + m < M && k0 + k < K;
    cp_async4(As + k * TL::A_STRIDE + m,
              in ? A + (size_t)(m0 + m) * K + k0 + k : A, in);
  }
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < BK * TL::BN / 4 / TL::THREADS; ++i) {
      const int q = tid + i * TL::THREADS;
      const int k = q / (TL::BN / 4), n = 4 * (q % (TL::BN / 4));
      const bool in = k0 + k < K && n0 + n < N;   // N % 4 == 0: all 4 or none
      cp_async16(Ws + k * TL::BN + n,
                 in ? W + (size_t)(k0 + k) * N + n0 + n : W, in);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * TL::BN / TL::THREADS; ++i) {
      const int e = tid + i * TL::THREADS;
      const int k = e / TL::BN, n = e % TL::BN;
      const bool in = k0 + k < K && n0 + n < N;
      cp_async4(Ws + k * TL::BN + n,
                in ? W + (size_t)(k0 + k) * N + n0 + n : W, in);
    }
  }
}

// one BM x BN tile of A @ W per block (blockIdx.x along N, blockIdx.y
// along M), handed row by row to the epilogue
template <class TL, bool VEC, class Epi>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS)
    ffma_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                     const Epi epi, int M, int N, int K) {
  extern __shared__ __align__(16) float ffma_smem[];
  float* As = ffma_smem;                             // [STAGES][A_FLOATS]
  float* Ws = ffma_smem + STAGES * TL::A_FLOATS;     // [STAGES][W_FLOATS]
  const int tid = threadIdx.x;
  const int tx = tid % TL::TX, ty = tid / TL::TX;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const int KT = (K + BK - 1) / BK;

  float acc[TL::RM][TL::RN];
#pragma unroll
  for (int i = 0; i < TL::RM; ++i)
#pragma unroll
    for (int j = 0; j < TL::RN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_tile<TL, VEC>(As + s * TL::A_FLOATS, Ws + s * TL::W_FLOATS, A, W,
                         M, N, K, m0, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile kt ...
    __syncthreads();               // ... and everyone's; slot kt - 1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_tile<TL, VEC>(As + (nk % STAGES) * TL::A_FLOATS,
                         Ws + (nk % STAGES) * TL::W_FLOATS, A, W, M, N, K,
                         m0, n0, nk);
    cp_async_commit();
    const float* a_s = As + (kt % STAGES) * TL::A_FLOATS + ty * 4;
    const float* w_s = Ws + (kt % STAGES) * TL::W_FLOATS + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TL::RM], b[TL::RN];
#pragma unroll
      for (int g = 0; g < TL::RM / 4; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            a_s + k * TL::A_STRIDE + g * (TL::BM / 2));
        a[4 * g] = x.x, a[4 * g + 1] = x.y, a[4 * g + 2] = x.z,
        a[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < TL::RN / 4; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            w_s + k * TL::BN + g * (TL::BN / 2));
        b[4 * g] = x.x, b[4 * g + 1] = x.y, b[4 * g + 2] = x.z,
        b[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TL::RM; ++i)
#pragma unroll
        for (int j = 0; j < TL::RN; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // thread (tx, ty) holds rows ty*4 + (i % 4) + (i / 4) * BM/2 and columns
  // tx*4 + (j % 4) + (j / 4) * BN/2
#pragma unroll
  for (int i = 0; i < TL::RM; ++i)
    epi.template row<TL::RN, 4, TL::BN / 2, TL::TX>(
        acc[i], m0 + (i / 4) * (TL::BM / 2) + ty * 4 + i % 4, n0 + tx * 4);
}

template <class TL, class Epi>
cudaError_t launch(const float* A, const float* W, const Epi& epi, int M,
                   int N, int K, bool vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};   // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured.load() & bit)) {
    // above 48 KB only with the attribute (the 128 x 128 tile: 51 KB)
    err = cudaFuncSetAttribute(ffma_gemm_kernel<TL, true, Epi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TL::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ffma_gemm_kernel<TL, false, Epi>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TL::SMEM);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  if (vec)
    ffma_gemm_kernel<TL, true, Epi>
        <<<grid, TL::THREADS, TL::SMEM, stream>>>(A, W, epi, M, N, K);
  else
    ffma_gemm_kernel<TL, false, Epi>
        <<<grid, TL::THREADS, TL::SMEM, stream>>>(A, W, epi, M, N, K);
  return cudaGetLastError();
}

template <class TL>
long long blocks_of(int M, int N) {
  return (long long)((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN);
}

// BFC_FFMA_TILE forces one tile (1-3) for every product, to measure the
// rule below against each tile alone; 0, the default, is the rule
#ifndef BFC_FFMA_TILE
#define BFC_FFMA_TILE 0
#endif

// The tile id of an M x N product: 128 x 128 where its blocks fill at
// least 3/4 of the NUM_SMS-block waves they take, else 32 x 64
inline int tile_for(int M, int N) {
  if (BFC_FFMA_TILE != 0) return BFC_FFMA_TILE;
  const long long b = blocks_of<T128x128>(M, N);
  const long long waves = (b + NUM_SMS - 1) / NUM_SMS;
  return 4 * b >= 3 * waves * NUM_SMS ? 1 : 3;
}

// the (BM, BN) of tile id t
inline void tile_shape(int t, int* bm, int* bn) {
  *bm = t == 1 ? 128 : t == 2 ? 64 : 32;
  *bn = t == 3 ? 64 : 128;
}

// run A @ W with epilogue epi on tile t; vec: W may take 16-byte copies
template <class Epi>
cudaError_t run(int t, const float* A, const float* W, const Epi& epi, int M,
                int N, int K, bool vec, cudaStream_t s) {
  switch (t) {
    case 1: return launch<T128x128>(A, W, epi, M, N, K, vec, s);
    case 2: return launch<T64x128>(A, W, epi, M, N, K, vec, s);
    case 3: return launch<T32x64>(A, W, epi, M, N, K, vec, s);
  }
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// C = epilogue(A @ W + bias) at float32, any shape; res (nullable) [M, N]
inline cudaError_t gemm(const float* A, const float* W, const float* bias,
                        const float* res, float* C, int M, int N, int K,
                        bool relu, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const bool n4 = N % 4 == 0;
  const LinearEpi<float> epi{
      bias, res, C, M, N, relu ? 1 : 0,
      n4 && aligned16(bias) && aligned16(res) && aligned16(C) ? 1 : 0};
  return run(tile_for(M, N), A, W, epi, M, N, K, n4 && aligned16(W), stream);
}

}  // namespace
}  // namespace ffma
}  // namespace bfc
