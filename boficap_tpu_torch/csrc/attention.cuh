// Building block: masked multi-head attention core, the score -> mask ->
// softmax -> context step inside the TPU encoder-layer and decoder-layer
// kernels (boficap_tpu/ops/pallas_decoder_layer.py::_mha :75), per sample
// instead of the TPU's block-diagonal batching.
//
//   s = (q . k) / sqrt(Dh);  s = mask ? s : -1e9;  p = T(softmax_f32(s))
//   ctx = T(sum_j p_j v_j)
//
// One block per (sample, head).  The head's Q, K and V slices (columns
// h*Dh .. h*Dh+Dh-1 of row-major [rows, ld] activations for the layer
// kernels; any strided [B, H, rows, Dh] view, HeadView, for the attention
// core of attention_core.cu) are staged in
// shared memory as float32; one warp per query row computes its scores,
// softmax and context.  A fully masked row has every score at -1e9 and so
// comes out uniform over its own sample's keys, as on the TPU.  The mask is
// bool [B, Lq, Lk] addressed as b * mask_sb + i * mask_sq + j, so a
// [B, Lk] padding mask is passed with mask_sq = 0.
//
// The keys come from up to two sources, read in order: key j < a.rows is
// row j of source a, the rest are source c's rows.  The windowed decoder
// layers (pallas_decoder_layer.py::_win_kernel :283) attend over a K/V cache
// followed by the window's fresh K/V; reading both in place saves copying
// them into one [B, L + W, D] buffer per layer.  Those layers also hand the
// block a destination for the fresh K/V (KvDst): once its sample's keys
// are staged, block (b, h) copies head h's columns of source c's rows into
// it, so the narrow SA round updates its cache in place with no launch of
// its own, and every key was read before any is overwritten.
//
// Bound on the H100: bytes.  At BoFiCap's sizes (L <= 36, Dh = 64) the
// score and context work is ~4 * L * L * Dh flops per (sample, head), a few
// flops per byte of Q/K/V read; the kernel reads each slice once.
#pragma once

#include "common.cuh"

namespace bfc {

constexpr int ATT_WARPS = 4;
constexpr float MASK_FILL = -1e9f;

// keys and values of one source: row (b, j) at (b * rows + j) * ld
template <typename T>
struct KeySrc {
  const T* k;
  const T* v;
  int ldk, ldv, rows;
};

// A strided [B, H, rows, Dh] operand: element (b, h, j, d) at
// p[b * sb + h * sh + j * sl + d].  Row-major [B * rows, ld] activations
// with heads as column slices are the view {p, rows * ld, Dh, ld}; the
// attention-core kernel (attention_core.cu) takes any strides, a stride of
// 0 included (a query broadcast over the batch).
template <typename T>
struct HeadView {
  T* p;
  long long sb, sh, sl;
  __device__ __forceinline__ T& at(int b, int h, int j, int d) const {
    return p[b * sb + h * sh + j * sl + d];
  }
};

template <typename T>
HeadView<T> rows_view(T* p, int ld, int rows, int Dh) {
  return HeadView<T>{p, (long long)rows * ld, Dh, ld};
}

// Where the fresh K/V (source c's rows) go: row (b, j) to row s_b + j of
// row-major [B, Ld, ld] k and v, s_b = clamp(starts[b], 0, Ld - rows_c)
// (0 without starts).  k == nullptr: nowhere.
template <typename T>
struct KvDst {
  T* k;
  T* v;
  const int* starts;
  int Ld, ld;
};

// How the scores are scaled: the layer kernels divide by sqrt(Dh)
// (pallas_decoder_layer.py:86); the attention core multiplies by the float32
// 1/sqrt(Dh) (pallas_attention.py:38,47).  The two agree exactly when
// sqrt(Dh) is a power of two (Dh = 64: 0.125).
enum class Scale { kDivSqrt, kMulInvSqrt };

template <typename T, Scale S>
__global__ void __launch_bounds__(ATT_WARPS * 32)
    attention_kernel(HeadView<const T> q, HeadView<const T> ka,
                     HeadView<const T> va, int rows_a, HeadView<const T> kc,
                     HeadView<const T> vc, int rows_c,
                     const uint8_t* __restrict__ mask, long long mask_sb,
                     long long mask_sq, HeadView<T> out, int H, int Lq,
                     int Dh, KvDst<T> dst) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int Lk = rows_a + rows_c;
  const float sqrt_dh = sqrtf(static_cast<float>(Dh));
  const float inv_sqrt_dh = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  const int ks_ld = Dh + 1;  // odd stride: lanes reading key rows j hit distinct banks
  float* Ks = smem;                      // [Lk][Dh + 1]
  float* Vs = Ks + (size_t)Lk * ks_ld;   // [Lk][Dh]
  float* Qs = Vs + (size_t)Lk * Dh;      // [Lq][Dh]
  float* Ps = Qs + (size_t)Lq * Dh;      // [ATT_WARPS][Lk]

  const int nthr = blockDim.x;
  for (int e = threadIdx.x; e < Lk * Dh; e += nthr) {
    const int j = e / Dh, d = e % Dh;
    const bool first = j < rows_a;
    Ks[j * ks_ld + d] = Cvt<T>::to_f(first ? ka.at(b, h, j, d)
                                           : kc.at(b, h, j - rows_a, d));
    Vs[j * Dh + d] = Cvt<T>::to_f(first ? va.at(b, h, j, d)
                                        : vc.at(b, h, j - rows_a, d));
  }
  for (int e = threadIdx.x; e < Lq * Dh; e += nthr) {
    const int i = e / Dh, d = e % Dh;
    Qs[i * Dh + d] = Cvt<T>::to_f(q.at(b, h, i, d));
  }
  __syncthreads();

  if (dst.k != nullptr) {
    // every key of (b, h) is staged: copy the fresh rows out, exactly (T
    // to float32 and back is the identity); no other block touches them
    const int s0 = dst.starts == nullptr
                       ? 0
                       : min(max(dst.starts[b], 0), dst.Ld - rows_c);
    for (int e = threadIdx.x; e < rows_c * Dh; e += nthr) {
      const int j = e / Dh, d = e % Dh;
      const size_t o = ((size_t)b * dst.Ld + s0 + j) * dst.ld +
                       (size_t)h * Dh + d;
      dst.k[o] = Cvt<T>::from_f(Ks[(rows_a + j) * ks_ld + d]);
      dst.v[o] = Cvt<T>::from_f(Vs[(rows_a + j) * Dh + d]);
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* P = Ps + (size_t)warp * Lk;
  for (int i = warp; i < Lq; i += ATT_WARPS) {
    const uint8_t* mrow = mask + (size_t)b * mask_sb + (size_t)i * mask_sq;
    const float* qi = Qs + (size_t)i * Dh;
    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kj = Ks + (size_t)j * ks_ld;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qi[d], kj[d], s);
      s = S == Scale::kDivSqrt ? s / sqrt_dh : s * inv_sqrt_dh;
      if (!mrow[j]) s = MASK_FILL;
      P[j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(P[j] - mx);
      P[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < Lk; j += 32) P[j] = round_to<T>(P[j] / sum);
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(P[j], Vs[(size_t)j * Dh + d], acc);
      out.at(b, h, i, d) = Cvt<T>::from_f(acc);
    }
    __syncwarp();
  }
}

// shared memory of one (sample, head) block
inline size_t attention_smem(int Lq, int Lk, int Dh) {
  return sizeof(float) * ((size_t)Lk * (Dh + 1) + (size_t)Lk * Dh +
                          (size_t)Lq * Dh + (size_t)ATT_WARPS * Lk);
}

template <typename T, Scale S>
cudaError_t launch_attention(HeadView<const T> q, HeadView<const T> ka,
                             HeadView<const T> va, int rows_a,
                             HeadView<const T> kc, HeadView<const T> vc,
                             int rows_c, const uint8_t* mask,
                             long long mask_sb, long long mask_sq,
                             HeadView<T> out, int B, int H, int Lq, int Dh,
                             cudaStream_t stream, KvDst<T> dst = {}) {
  const size_t smem = attention_smem(Lq, rows_a + rows_c, Dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attention_kernel<T, S><<<B * H, ATT_WARPS * 32, smem, stream>>>(
      q, ka, va, rows_a, kc, vc, rows_c, mask, mask_sb, mask_sq, out, H, Lq,
      Dh, dst);
  return cudaGetLastError();
}

// keys a ++ c; q points at head 0's column of a row-major [B*Lq, ldq]
// buffer; c's rows also go to dst, if it has k
template <typename T>
cudaError_t attention2(const T* q, int ldq, KeySrc<T> a, KeySrc<T> c,
                       const uint8_t* mask, long long mask_sb,
                       long long mask_sq, T* out, int ldo, int B, int H,
                       int Lq, int Dh, cudaStream_t stream,
                       KvDst<T> dst = {}) {
  return launch_attention<T, Scale::kDivSqrt>(
      rows_view(q, ldq, Lq, Dh), rows_view(a.k, a.ldk, a.rows, Dh),
      rows_view(a.v, a.ldv, a.rows, Dh), a.rows,
      rows_view(c.k, c.ldk, c.rows, Dh), rows_view(c.v, c.ldv, c.rows, Dh),
      c.rows, mask, mask_sb, mask_sq, rows_view(out, ldo, Lq, Dh), B, H, Lq,
      Dh, stream, dst);
}

// one key source: q/k/v point at head 0's column of row-major
// [B*Lq | B*Lk, ld*] buffers
template <typename T>
cudaError_t attention(const T* q, int ldq, const T* k, int ldk, const T* v,
                      int ldv, const uint8_t* mask, long long mask_sb,
                      long long mask_sq, T* out, int ldo, int B, int H,
                      int Lq, int Lk, int Dh, cudaStream_t stream) {
  return attention2<T>(q, ldq, KeySrc<T>{k, v, ldk, ldv, Lk},
                       KeySrc<T>{nullptr, nullptr, 0, 0, 0}, mask, mask_sb,
                       mask_sq, out, ldo, B, H, Lq, Dh, stream);
}

}  // namespace bfc
