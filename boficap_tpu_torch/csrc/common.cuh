// Shared building blocks of the port's hand-written Hopper kernels.
//
// Types: every kernel is a template over the compute type T (float or
// __nv_bfloat16).  Arithmetic runs in float32; values round to T exactly
// where the TPU kernels round (boficap_tpu/ops/pallas_decoder_layer.py
// :102-121,139,153-158): a matmul's float32 sum casts to T, the bias adds in
// T, then ReLU or the residual add, again in T.
//
// The tiled matrix product here is plain FFMA on float32 (a bf16 product is
// exact in float32, so bf16 inputs give the same sum as a float32 product of
// the same values).  The layer and window kernels' bf16 products run on
// the tensor cores instead (wgmma_gemm.cuh); the head keeps this tile at
// both types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace bfc {

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as torch and XLA round
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
};

// x rounded to T's precision, returned as float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

// ---------------------------------------------------------------------------
// Tiled product: a 64 x 64 output tile of C = A[M,K] @ W[K,N] (both
// row-major), 256 threads, each holding a 4 x 4 block of float32 sums:
// rows row0 + ty*4 + i, columns col0 + tx*4 + j (tx = tid % 16,
// ty = tid / 16).  The k sum runs in order 0..K-1 for every element, so an
// element's value does not depend on the tile it lies in, nor on M: rows
// are batch-independent.  Ragged edges load zeros.
// ---------------------------------------------------------------------------
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int SPAD = 4;   // keeps each shared row 16-byte aligned

template <typename T>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ A,
                                          const T* __restrict__ W, int M,
                                          int N, int K, int row0, int col0,
                                          float acc[4][4]) {
  __shared__ __align__(16) float As[BK][BM + SPAD];  // A tile, transposed
  __shared__ __align__(16) float Ws[BK][BN + SPAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? Cvt<T>::to_f(A[(size_t)gr * K + gc])
                                    : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += GEMM_THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Ws[r][c] = (gr < K && gc < N) ? Cvt<T>::to_f(W[(size_t)gr * N + gc])
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace bfc

// C interface: each kernel source (encoder_layer.cu, decoder_layer.cu,
// greedy_head.cu) is its own shared library with one entry point.  The entry
// selects its device (each library carries its own CUDA runtime), launches
// on the caller's stream, allocates nothing, and returns the first
// cudaError_t of its launches for the Python wrapper to check.
#define BFC_DTYPE_F32 0
#define BFC_DTYPE_BF16 1

// one definition per library: every library is a single translation unit
extern "C" const char* bfc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// evaluates a launch helper; returns its error from the enclosing function
#define BFC_TRY(call)                                  \
  do {                                                 \
    const cudaError_t bfc_err_ = (call);               \
    if (bfc_err_ != cudaSuccess) return bfc_err_;      \
  } while (0)
