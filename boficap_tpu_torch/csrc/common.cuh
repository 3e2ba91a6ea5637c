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

// Programmatic dependent launch (Hopper).  A kernel launched chained
// (launch_kernel<true> below) may start while its predecessor on the
// stream still runs, once every block of the predecessor has called
// grid_launch_dependents() or exited.  grid_wait() blocks the calling
// thread until the predecessor has completed and its writes are visible;
// nothing a predecessor writes may be read, and nothing it reads may be
// written, before it.  Every block of a chained kernel calls grid_wait()
// before it exits, so that a kernel's completion implies its
// predecessors': the chain is then ordered as a plain stream, and a read
// two launches back (a residual) is safe.  A kernel takes CH, whether it
// is launched chained, as a template parameter: the unchained instances
// hold neither instruction and are the kernels as they were before the
// chain existed (with the instructions behind a run-time flag, they ran
// 1-6% slower on the H100).
template <bool CH>
__device__ __forceinline__ void grid_wait() {
  if constexpr (CH) asm volatile("griddepcontrol.wait;" ::: "memory");
}
template <bool CH>
__device__ __forceinline__ void grid_launch_dependents() {
  if constexpr (CH)
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// kernel<<<grid, block, smem, s>>>(args), or, CH, the same through
// cudaLaunchKernelEx with programmatic stream serialization; the launch's
// error either way
template <bool CH, typename... Exp, typename... Act>
cudaError_t launch_kernel(void (*kernel)(Exp...), dim3 grid, dim3 block,
                          size_t smem, cudaStream_t s, Act&&... args) {
  if constexpr (!CH) {
    kernel<<<grid, block, smem, s>>>(static_cast<Act&&>(args)...);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
}

// Thread-block clusters (Hopper).  cluster_along(n): the blocks of a
// cluster along a grid dimension of n blocks, the largest of 8, 4, 2, 1
// that divides n (8: the portable maximum).
inline int cluster_along(int n) {
  int c = 8;
  while (n % c != 0) c /= 2;
  return c;
}

// the cluster barrier, split: arrive releases this thread's writes (to
// shared and device memory), wait acquires every thread's of the cluster.
// Every thread of every block of the cluster arrives at each phase, warp
// by warp (.aligned), and waits on it before it arrives again or exits: a
// warp that arrived twice and left hung a cluster on the H100
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the float at p in the shared memory of the cluster's block ``rank``
// (distributed shared memory: mapa, then ld.shared::cluster)
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// launch_kernel's launch in clusters of cluster_x blocks along x (gridDim.x
// a multiple of it): the cluster dimension and, CH, programmatic stream
// serialization in one cudaLaunchKernelEx
template <bool CH, typename... Exp, typename... Act>
cudaError_t launch_cluster(void (*kernel)(Exp...), dim3 grid, dim3 block,
                           size_t smem, cudaStream_t s, int cluster_x,
                           Act&&... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = CH ? 2 : 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
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
