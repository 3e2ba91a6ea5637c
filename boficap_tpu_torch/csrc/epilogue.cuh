// Building block: the two epilogues of the port's matrix products, shared
// by the bf16 tensor-core product (wgmma_gemm.cuh) and the float32 FFMA
// product (ffma_gemm.cuh).  A product hands its epilogue one output row of
// a thread at a time:
//
//   row<NV, G, S, LANES>(v, r, c0): v[NV] holds the float32 sums of row r
//   at columns c0 + (i / G) * S + i % G (ascending in i); the row's other
//   columns of the block tile lie with the LANES - 1 neighbouring lanes
//   (an aligned group, lane ^ 1 .. lane ^ (LANES / 2)).
//
// Every lane of a warp calls row() the same number of times, rows past M
// included, so an epilogue may shuffle within the group.  The tensor-core
// product hands over its whole accumulator fragment instead:
//
//   fragment<BN>(acc, r0, c0): register 4j + 2h + e of acc holds row
//   r0 + 8h, column c0 + 8j + e (wgmma's m64nBN layout, one thread's share).
//
//   LinearEpi  C = epilogue(A @ W): v = T(sum); v = T(v + bias); relu?;
//              v = T(v + res), the rounding of the TPU kernels
//              (boficap_tpu/ops/pallas_decoder_layer.py:102-121); groups
//              of G columns move as one vector where ``vec`` allows.
//   SplitEpi   LinearEpi's values (no residual, no ReLU) of a [M, 3D]
//              product written as three [M, D] outputs by column third:
//              the window-parts layer's q, k and v without the
//              self-attention (csrc/window_parts.cu).
//   HeadEpi    the greedy head's partials (greedy_head.cu): for block
//              column tile (vocab chunk) blockIdx.x, per row the chunk's
//              max logit, its first argmax, sum exp(l - max) and
//              sum exp(l - max) l, and the PAD column's logit, with
//              l = T(T(sum) + b) (:688-694) and columns >= V masked.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace bfc {

// G consecutive values of p as float: one 16-byte (float32 x 4) or 4-byte
// (bf16 x 2) load where ``vec``, else G scalar loads
template <typename T, int G>
__device__ __forceinline__ void load_group(const T* p, bool vec,
                                           float (&o)[G]) {
  if constexpr (std::is_same<T, float>::value && G == 4) {
    if (vec) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
      return;
    }
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && G == 2) {
    if (vec) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
      o[0] = __low2float(x), o[1] = __high2float(x);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < G; ++e) o[e] = Cvt<T>::to_f(p[e]);
}

template <typename T, int G>
__device__ __forceinline__ void store_group(T* p, bool vec,
                                            const float (&v)[G]) {
  if constexpr (std::is_same<T, float>::value && G == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && G == 2) {
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < G; ++e) p[e] = Cvt<T>::from_f(v[e]);
}

// C [M, N] = epilogue(sums + bias [N]), res [M, N] nullable; vec: N is a
// multiple of the group and bias, res and C are aligned for its vectors
template <typename T>
struct LinearEpi {
  const T* bias;
  const T* res;
  T* C;
  int M, N, relu, vec;

  // one output value from its sum s, bias b and residual x
  __device__ __forceinline__ float apply(float s, float b, float x) const {
    float y = round_to<T>(round_to<T>(s) + b);
    if (relu) y = fmaxf(y, 0.f);
    return res != nullptr ? round_to<T>(y + x) : y;
  }

  template <int NV, int G, int S, int LANES>
  __device__ __forceinline__ void row(float (&v)[NV], int r, int c0) const {
    row_<NV, G, S>(v, r, c0, bias, res, C);
  }

  template <int BN>
  __device__ __forceinline__ void fragment(const float (&acc)[BN / 2], int r0,
                                           int c0) const {
    fragment_<BN>(acc, r0, c0, bias, res, C);
  }

  // The helpers take the pointers again as __restrict__ parameters, as the
  // kernels took them before the epilogue was a parameter: no store to C
  // then aliases a bias or residual load.
  template <int NV, int G, int S>
  __device__ __forceinline__ void row_(float (&v)[NV], int r, int c0,
                                       const T* __restrict__ bias,
                                       const T* __restrict__ res,
                                       T* __restrict__ C) const {
    if (r >= M) return;
#pragma unroll
    for (int g = 0; g < NV / G; ++g) {
      const int c = c0 + g * S;
      if (c >= N) continue;
      const size_t o = (size_t)r * N + c;
      const bool full = vec && c + G <= N;
      float b[G], x[G], y[G];
      if (full) {
        load_group<T, G>(bias + c, true, b);
        if (res != nullptr) load_group<T, G>(res + o, true, x);
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e) {
          const bool in = c + e < N;
          b[e] = in ? Cvt<T>::to_f(bias[c + e]) : 0.f;
          x[e] = in && res != nullptr ? Cvt<T>::to_f(res[o + e]) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < G; ++e) y[e] = apply(v[g * G + e], b[e], x[e]);
      if (full) {
        store_group<T, G>(C + o, true, y);
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (c + e < N) C[o + e] = Cvt<T>::from_f(y[e]);
      }
    }
  }

  // column pairs outer, so a pair's bias is read once for both rows; the
  // tensor-core product's N is even and its pointers 4-byte aligned
  template <int BN>
  __device__ __forceinline__ void fragment_(const float (&acc)[BN / 2],
                                            int r0, int c0,
                                            const T* __restrict__ bias,
                                            const T* __restrict__ res,
                                            T* __restrict__ C) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= N) continue;   // N is even, so c + 1 < N too
      float b[2], x[2] = {0.f, 0.f}, y[2];
      load_group<T, 2>(bias + c, true, b);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        const size_t o = (size_t)r * N + c;
        if (res != nullptr) load_group<T, 2>(res + o, true, x);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = apply(acc[4 * j + 2 * h + e], b[e], x[e]);
        store_group<T, 2>(C + o, true, y);
      }
    }
  }
};

// C[j] [M, D] = third j of the [M, 3D] output, each value LinearEpi's with
// no residual and no ReLU: v = T(T(sum) + bias); bias [3D]
template <typename T>
struct SplitEpi {
  const T* bias;
  T* C[3];
  int M, D;

  __device__ __forceinline__ void put(float s, int r, int c) const {
    const int j = c >= 2 * D ? 2 : c >= D ? 1 : 0;
    const float y = round_to<T>(round_to<T>(s) + Cvt<T>::to_f(bias[c]));
    C[j][(size_t)r * D + c - j * D] = Cvt<T>::from_f(y);
  }

  template <int NV, int G, int S, int LANES>
  __device__ __forceinline__ void row(float (&v)[NV], int r, int c0) const {
    if (r >= M) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (i / G) * S + i % G;
      if (c < 3 * D) put(v[i], r, c);
    }
  }

  // the tensor-core product's D is a multiple of 8: a column pair never
  // straddles two thirds, and each third's pairs are 4-byte aligned
  template <int BN>
  __device__ __forceinline__ void fragment(const float (&acc)[BN / 2], int r0,
                                           int c0) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= 3 * D) continue;
      const int part = c >= 2 * D ? 2 : c >= D ? 1 : 0;
      float b[2], y[2];
      load_group<T, 2>(bias + c, true, b);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = round_to<T>(round_to<T>(acc[4 * j + 2 * h + e]) + b[e]);
        store_group<T, 2>(C[part] + (size_t)r * D + c - part * D, true, y);
      }
    }
  }
};

// the greedy head's partials of vocab chunk blockIdx.x, each [n_chunks, M]
// (chunk-major); pad_logit [M]; bias [>= V]
template <typename T>
struct HeadEpi {
  const T* bias;
  float *pmax, *psum, *pdot, *pad_logit;
  int* parg;
  int M, V, pad_id;

  template <int NV, int G, int S, int LANES>
  __device__ __forceinline__ void row(float (&v)[NV], int r, int c0) const {
    // this lane's logits, ascending columns; the first maximum (strict >)
    float m = -INFINITY;
    int a = INT_MAX;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (i / G) * S + i % G;
      if (c < V) {
        v[i] = round_to<T>(round_to<T>(v[i]) + Cvt<T>::to_f(bias[c]));
        if (v[i] > m) {
          m = v[i];
          a = c;
        }
      }
    }
    // merge over the row's lanes; on an equal maximum the lower index wins
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const int oa = __shfl_xor_sync(0xffffffffu, a, off);
      if (om > m || (om == m && oa < a)) {
        m = om;
        a = oa;
      }
    }
    // every chunk holds a column < V, so m is finite here
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (i / G) * S + i % G;
      if (c < V) {
        const float e = expf(v[i] - m);
        s += e;
        t += e * v[i];
      }
      if (c == pad_id && r < M) pad_logit[r] = v[i];
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      t += __shfl_xor_sync(0xffffffffu, t, off);
    }
    if (r < M && (threadIdx.x % LANES) == 0) {
      const size_t o = (size_t)blockIdx.x * M + r;
      pmax[o] = m;
      parg[o] = a;
      psum[o] = s;
      pdot[o] = t;
    }
  }

  // a row's columns lie with the 4 lanes of a quad: hand over each of the
  // thread's two rows whole.  The fields are read once into registers
  // (``e``): read from the __grid_constant__ parameter at every use, the
  // bf16 head ran ~10% slower on the H100.
  template <int BN>
  __device__ __forceinline__ void fragment(const float (&acc)[BN / 2], int r0,
                                           int c0) const {
    const HeadEpi e = *this;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        v[2 * j] = acc[4 * j + 2 * h];
        v[2 * j + 1] = acc[4 * j + 2 * h + 1];
      }
      e.template row<BN / 4, 2, 8, 4>(v, r0 + 8 * h, c0);
    }
  }
};

}  // namespace bfc
