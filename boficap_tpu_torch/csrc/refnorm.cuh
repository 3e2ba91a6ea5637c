// Building block: RefLayerNorm, the normalisation inside the TPU
// encoder-layer and decoder-layer kernels
// (boficap_tpu/ops/pallas_decoder_layer.py::_refnorm :63):
//
//   y = (x - mean) / (sqrt(sum((x - mean)^2) / (d - 1)) + eps) * scale + bias
//
// float32 arithmetic, output cast to T; scale and bias are float32.  Bound on
// the H100: bytes (each row read and written once).  One warp a row, the
// reductions in shuffles, no shared memory.  Lane c holds the row's
// elements c, c + 32, c + 64, ... in registers: they are loaded once, all
// at once (independent loads, in flight together), then summed in
// ascending order for the mean, then for the variance of (x - mean), then
// normalised, so the three passes read registers, not memory.  The sums and
// the xor trees are those of a lane-strided loop over the row, and the two
// fused multiply-adds are written out as the compiler contracted that loop
// (left to itself, it kept the unrolled variance's product and sum apart,
// an ulp off in some outputs), so the float32 results are bitwise those of
// the lane-strided loop.  A row wider than 32 * PER elements goes
// through the same kernel in chunks of PER a lane, read again each pass.
// Scale and bias are read once a lane, in the last pass.
#pragma once

#include "common.cuh"

namespace bfc {

constexpr int NORM_WARPS = 4;
constexpr float NORM_EPS = 1e-6f;

// One row's norm by one warp (lane ``lane`` of it): row xr [d] ->
// store(c, y) for each of the lane's columns c, y the float32 value before
// its rounding to T.  PER: elements a lane holds in registers (the row in
// chunks of 32 * PER).  PER changes no bit: a lane sums its elements c =
// lane, lane + 32, ... in that order whatever the chunk, so the
// window-parts layer's norm that writes two outputs (window_parts.cu
// parts_refnorm_kernel) gives refnorm_kernel's values.  mid() runs
// between the statistics and the stores (the chained kernel's
// grid_launch_dependents).
template <typename T, int PER, class Mid, class Store>
__device__ __forceinline__ void refnorm_row(const T* __restrict__ xr,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            int d, int lane, Mid mid,
                                            Store store) {
  constexpr int CH = 32 * PER;
  const bool whole = d <= CH;   // the row stays in registers
  float v[PER];
  auto load = [&](int base) {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int c = base + lane + 32 * t;
      v[t] = c < d ? Cvt<T>::to_f(xr[c]) : 0.f;
    }
  };

  float s = 0.f;
  for (int base = 0; base < d; base += CH) {
    load(base);
#pragma unroll
    for (int t = 0; t < PER; ++t)
      if (base + lane + 32 * t < d) s += v[t];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / static_cast<float>(d);

  float q = 0.f;
  for (int base = 0; base < d; base += CH) {
    if (!whole) load(base);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      if (base + lane + 32 * t < d) {
        const float u = v[t] - mean;
        q = fmaf(u, u, q);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float var = q / static_cast<float>(d > 1 ? d - 1 : 1);
  const float denom = sqrtf(var) + NORM_EPS;
  mid();

  for (int base = 0; base < d; base += CH) {
    if (!whole) load(base);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int c = base + lane + 32 * t;
      if (c < d) {
        const float u = (v[t] - mean) / denom;
        store(c, fmaf(u, scale[c], bias[c]));
      }
    }
  }
}

// PER: elements a lane holds in registers (the row in chunks of 32 * PER);
// CHAIN: launched chained (common.cuh)
template <typename T, int PER, bool CHAIN>
__global__ void __launch_bounds__(NORM_WARPS * 32)
    refnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   int rows, int d) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NORM_WARPS + warp;
  grid_wait<CHAIN>();   // x: a predecessor's output; y: read before
  if (row >= rows) return;
  T* yr = y + (size_t)row * d;
  refnorm_row<T, PER>(
      x + (size_t)row * d, scale, bias, d, lane,
      [] { grid_launch_dependents<CHAIN>(); },
      [&](int c, float v) { yr[c] = Cvt<T>::from_f(v); });
}

// CH: launched as a link of a launch chain (common.cuh launch_kernel)
template <typename T, bool CH = false>
cudaError_t refnorm(const T* x, const float* scale, const float* bias, T* y,
                    int rows, int d, cudaStream_t stream) {
  const int blocks = (rows + NORM_WARPS - 1) / NORM_WARPS;
  // registers a lane: the row whole up to d = 1024, then chunks of 1024
  auto kernel = d <= 128   ? refnorm_kernel<T, 4, CH>
                : d <= 256 ? refnorm_kernel<T, 8, CH>
                : d <= 512 ? refnorm_kernel<T, 16, CH>
                           : refnorm_kernel<T, 32, CH>;
  return launch_kernel<CH>(kernel, blocks, NORM_WARPS * 32, 0, stream, x,
                           scale, bias, y, rows, d);
}

}  // namespace bfc
