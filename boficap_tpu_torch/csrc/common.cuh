// Shared building blocks of the port's hand-written Hopper kernels.
//
// Types: every kernel is a template over the compute type T (float or
// __nv_bfloat16).  Arithmetic runs in float32; values round to T exactly
// where the TPU kernels round (boficap_tpu/ops/pallas_decoder_layer.py
// :102-121,139,153-158): a matmul's float32 sum casts to T, the bias adds in
// T, then ReLU or the residual add, again in T.
//
// The matrix products live in their own blocks: bf16 on the tensor cores
// (wgmma_gemm.cuh), float32 on the FFMA units (ffma_gemm.cuh), both with
// the epilogues of epilogue.cuh.
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

// a shared-memory address as the 32-bit offset PTX takes
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace bfc

// C interface: each kernel source (csrc/*.cu) is its own shared library.
// An entry selects its device (each library carries its own CUDA runtime),
// launches on the caller's stream, allocates nothing, and returns the
// first cudaError_t of its launches for the Python wrapper to check.
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
