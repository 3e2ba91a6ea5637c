// Building block: the head-block-diagonal attention of
// scripts/bench_kernel_parts.py::_hb_kernel (:327; pallas_call :460), the
// variant of the windowed decoder layer whose two attentions score every
// head at once against a head-block-diagonal K [D, H*M] (the TPU's one
// large product instead of H small ones), per sample instead of the TPU's
// block-diagonal batching of G samples.
//
// What it computes differs from attention.cuh's block in one place: the
// softmax takes ONE max per query row across all heads (:382), and each
// head's denominator is its own segment sum (the indicator products of
// :384-386 and :420-424):
//
//   s[h, j] = (q_h . k_{j,h}) * (1/sqrt(Dh));  s = mask ? s : -1e9
//   m = max_{h, j} s[h, j]
//   p[h, j] = T(exp(s[h, j] - m) / sum_j' exp(s[h, j'] - m))
//   ctx_h = T(sum_j p[h, j] v_{j,h})
//
// The scale is the float32 1/sqrt(Dh) multiplied in, as _hb_kernel does
// (the layer kernels divide by sqrt(Dh); the two agree when sqrt(Dh) is a
// power of two, Dh = 64).  The zeros of the head-block-diagonal K and V are
// not multiplied: on the TPU they add exact zeros (q * 0 and 0 * v for
// finite q and v) to each score and context sum, so skipping them computes
// the same function.  A head whose scores all sit more than ~87 below the
// row's max across heads underflows to a zero sum and a NaN row, on the TPU
// as here: that is the variant's function, not guarded.  A fully masked row
// has every score at -1e9 in every head and comes out uniform over its own
// sample's keys per head.
//
// One block of HB_WARPS warps a (sample, HB_ROWS query rows).  The block
// stages its query rows (every head) as float32, then, head after head,
// that head's K [Lk, Dh + 1] (keys from up to two sources, read in order,
// as attention.cuh's KeySrc) and scores its rows, one thread a (row, key)
// on an fmaf chain over d; the score rows [HB_ROWS, H, Lk] stay in shared
// memory.  One warp a row takes the max across heads, one warp a (row,
// head) the sum of exp and p, rounded to T and kept as float32; then, head
// after head, V is staged where K was and one thread a (row, column) sums
// p v over the keys.  Block (b, 0) also copies source c's rows into dst
// (the window's fresh K/V, as _hb_kernel:351-352 writes them); dst must not
// alias a source.
//
// Bound on the H100: bytes, as the layer's other attentions (a few flops a
// byte of K/V).  The block re-reads its sample's K and V once a query tile
// and stages a head at a time: a simple kernel, not a tuned one.
#pragma once

#include "attention.cuh"

namespace bfc {

constexpr int HB_WARPS = 8;   // warps a block
constexpr int HB_ROWS = 4;    // query rows a block

// shared memory of one block at Lk keys, width D = H * Dh;
// ops/window_parts.py hb_shared_bytes mirrors it
inline size_t hb_smem(int Lk, int D, int H) {
  const int Dh = D / H;
  return sizeof(float) * ((size_t)HB_ROWS * D + (size_t)HB_ROWS * H * Lk +
                          (size_t)Lk * (Dh + 1) + HB_ROWS) +
         (size_t)HB_ROWS * Lk;
}

namespace hb {

template <typename T>
__device__ __forceinline__ const T* key_row(const T* pa, int lda, int rows_a,
                                            const T* pc, int ldc, int rows_c,
                                            int b, int j) {
  return j < rows_a ? pa + ((size_t)b * rows_a + j) * lda
                    : pc + ((size_t)b * rows_c + (j - rows_a)) * ldc;
}

// stage head h's rows of one source pair (K or V) as float32 [Lk, Dh + 1]
template <typename T>
__device__ void stage_head(float* dst, const T* pa, int lda, int rows_a,
                           const T* pc, int ldc, int rows_c, int b, int h,
                           int Dh) {
  const int Lk = rows_a + rows_c;
  for (int i = threadIdx.x; i < Lk * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i % Dh;
    const T* row = key_row(pa, lda, rows_a, pc, ldc, rows_c, b, j);
    dst[j * (Dh + 1) + d] = Cvt<T>::to_f(row[h * Dh + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(HB_WARPS * 32)
    hb_attention_kernel(const T* __restrict__ q, int ldq, KeySrc<T> a,
                        KeySrc<T> c, const uint8_t* __restrict__ mask,
                        long long mask_sb, long long mask_sq, T* out, int ldo,
                        int H, int Lq, int Dh, KvDst<T> dst) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * HB_ROWS;
  const int rows = min(HB_ROWS, Lq - i0);
  const int D = H * Dh;
  const int Lk = a.rows + c.rows;
  float* Qs = smem;                               // [HB_ROWS, D]
  float* S = Qs + HB_ROWS * D;                    // [HB_ROWS, H, Lk]
  float* KV = S + HB_ROWS * H * Lk;               // [Lk, Dh + 1]
  float* mx = KV + Lk * (Dh + 1);                 // [HB_ROWS]
  uint8_t* mk = reinterpret_cast<uint8_t*>(mx + HB_ROWS);   // [HB_ROWS, Lk]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float factor = score_factor<Scale::kMulInvSqrt>(Dh);

  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    Qs[r * D + d] = Cvt<T>::to_f(q[((size_t)b * Lq + i0 + r) * ldq + d]);
  }
  for (int i = tid; i < rows * Lk; i += blockDim.x) {
    const int r = i / Lk, j = i % Lk;
    mk[r * Lk + j] = mask[b * mask_sb + (long long)(i0 + r) * mask_sq + j];
  }
  if (blockIdx.y == 0 && dst.k != nullptr) {
    const int s0 = dst_start(dst, b, c.rows);
    for (int i = tid; i < c.rows * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const size_t o = ((size_t)b * dst.Ld + s0 + j) * dst.ld + d;
      dst.k[o] = c.k[((size_t)b * c.rows + j) * c.ldk + d];
      dst.v[o] = c.v[((size_t)b * c.rows + j) * c.ldv + d];
    }
  }

  // scores, head after head
  for (int h = 0; h < H; ++h) {
    __syncthreads();   // Qs and mk staged; the previous head's K read
    stage_head(KV, a.k, a.ldk, a.rows, c.k, c.ldk, c.rows, b, h, Dh);
    __syncthreads();
    for (int i = tid; i < rows * Lk; i += blockDim.x) {
      const int r = i / Lk, j = i % Lk;
      const float* qr = Qs + r * D + h * Dh;
      const float* kr = KV + j * (Dh + 1);
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
      s = scale_score<Scale::kMulInvSqrt>(s, factor);
      S[(r * H + h) * Lk + j] = mk[r * Lk + j] ? s : MASK_FILL;
    }
  }
  __syncthreads();

  // one max a row across every head
  for (int r = warp; r < rows; r += HB_WARPS) {
    float m = -INFINITY;
    for (int i = lane; i < H * Lk; i += 32) m = fmaxf(m, S[r * H * Lk + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(att::FULL, m, off));
    if (lane == 0) mx[r] = m;
  }
  __syncthreads();
  // each head's sum of exp; p normalised, then rounded to T
  for (int rh = warp; rh < rows * H; rh += HB_WARPS) {
    float* sr = S + rh * Lk;
    const float m = mx[rh / H];
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(att::FULL, sum, off);
    for (int j = lane; j < Lk; j += 32) sr[j] = round_to<T>(sr[j] / sum);
  }

  // contexts, head after head
  for (int h = 0; h < H; ++h) {
    __syncthreads();   // p written; the previous head's V read
    stage_head(KV, a.v, a.ldv, a.rows, c.v, c.ldv, c.rows, b, h, Dh);
    __syncthreads();
    for (int i = tid; i < rows * Dh; i += blockDim.x) {
      const int r = i / Dh, d = i % Dh;
      const float* pr = S + (r * H + h) * Lk;
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(pr[j], KV[j * (Dh + 1) + d], acc);
      out[((size_t)b * Lq + i0 + r) * ldo + h * Dh + d] = Cvt<T>::from_f(acc);
    }
  }
}

}  // namespace hb

// keys a ++ c for each sample's Lq query rows; q points at head 0's column
// of a row-major [B*Lq, ldq] buffer, out at [B*Lq, ldo]; c's rows also go to
// dst, if it has k
template <typename T>
cudaError_t hb_attention(const T* q, int ldq, KeySrc<T> a, KeySrc<T> c,
                         const uint8_t* mask, long long mask_sb,
                         long long mask_sq, T* out, int ldo, int B, int H,
                         int Lq, int Dh, cudaStream_t stream,
                         KvDst<T> dst = {}) {
  const int Lk = a.rows + c.rows;
  if (Lk < 1 || H < 1 || Dh < 1) return cudaErrorInvalidValue;
  const size_t smem = hb_smem(Lk, H * Dh, H);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  BFC_TRY(allow_smem(hb::hb_attention_kernel<T>, smem));
  const dim3 grid(B, (Lq + HB_ROWS - 1) / HB_ROWS);
  return launch_kernel<false>(hb::hb_attention_kernel<T>, grid,
                              HB_WARPS * 32, smem, stream, q, ldq, a, c, mask,
                              mask_sb, mask_sq, out, ldo, H, Lq, Dh, dst);
}

}  // namespace bfc
