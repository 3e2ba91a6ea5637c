// Building block: matrix product with a fused epilogue, for the
// projections and FFN products inside the TPU encoder-layer and
// decoder-layer kernels (boficap_tpu/ops/pallas_decoder_layer.py, the
// jnp.dot calls of _mha :75 and _kernel :124 / _enc_kernel :500).
//
//   C = epilogue(A[M,K] @ W[K,N])     W in the flax [in, out] layout
//   epilogue: v = T(sum); v = T(v + bias); relu?; v = T(v + res)
//
// Bound on the H100: operations.  At the serving batch (B = 64) the
// encoder's products are 2304 x 512 x {1536, 512, 2048} and 2304 x 2048 x
// 512, at least ~100 flops per byte moved.  This product is 64 x 64 tiles of
// float32 FFMA from shared memory (common.cuh gemm_tile).  It serves every
// float32 product of the layer and window kernels; their bf16 products run
// on the tensor cores (wgmma_gemm.cuh).
#pragma once

#include "common.cuh"

namespace bfc {

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
                const T* __restrict__ bias, const T* __restrict__ res,
                T* __restrict__ C, int M, int N, int K, int relu) {
  float acc[4][4];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  gemm_tile<T>(A, W, M, N, K, row0, col0, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      float v = round_to<T>(acc[i][j]);
      v = round_to<T>(v + Cvt<T>::to_f(bias[c]));
      if (relu) v = fmaxf(v, 0.f);
      if (res != nullptr)
        v = round_to<T>(v + Cvt<T>::to_f(res[(size_t)r * N + c]));
      C[(size_t)r * N + c] = Cvt<T>::from_f(v);
    }
  }
}

// C = epilogue(A @ W + bias); res (nullable) is [M, N] like C
template <typename T>
cudaError_t gemm(const T* A, const T* W, const T* bias, const T* res, T* C,
                 int M, int N, int K, bool relu, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T><<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, res, C, M, N,
                                                    K, relu ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace bfc
