// Greedy generator head: the port of the TPU kernel
// boficap_tpu/ops/pallas_decoder_layer.py::_head_kernel (:671, entered
// through fused_greedy_head :726).
//
//   logits = h[N,K] @ W[K,V] + b   (bf16: the sum rounds to bf16, the bias
//                                   adds in bf16, then widens; :688-694)
//   ids = first argmax, tok = max - logZ, ent = logZ - sum(p * logit),
//   lp_pad = logit[pad_id] - logZ
//
// without ever writing the [N, V] logits.  The TPU walks the vocabulary
// tiles in order inside one kernel; Hopper's blocks run in no order, so the
// work splits in two launches:
//   1. head_partial: one block per (row tile, 128-column vocab chunk) runs
//      the product of its tile and hands each row to the head epilogue
//      (epilogue.cuh HeadEpi), which writes per row the chunk's (max, first
//      argmax, sum exp(l - max), sum exp(l - max) l), plus the PAD column's
//      logit from the chunk that holds it.  bf16 runs the tensor-core
//      product (wgmma_gemm.cuh: TMA ring, wgmma), float32 the FFMA product
//      (ffma_gemm.cuh); both take W [K, Vp] and b [Vp] padded with zero
//      columns to Vp = 8 ceil(V / 8) (ops/decoder_layer.py pad_head: TMA
//      needs 16-byte row strides), and columns >= V are masked.
//   2. head_combine: one warp per row merges the chunks; on equal maxima
//      the lower index wins, so ids are the first maximum as jnp.argmax.
//
// Batch independence: the chunk width (128) follows nothing, and the row
// tile, which follows N, only sets how many rows share a block; a row's
// ids and log-probabilities are bitwise the same for any N.
//
// Bound on the H100: operations (2 N K V: 12.4 GFLOP at N = 1280, K = 512,
// V = 9491: 12.6 us at bf16's 989 TFLOP/s, 186 us at float32's 67); W is
// read from device memory once and from L2 by each row tile.
#include "wgmma_gemm.cuh"

namespace bfc {

constexpr int HEAD_BN = 128;   // the vocab chunk: the product's column tile

// head_partial: the product of h [N, K] and W [K, Vp] with the head
// epilogue on 128-column tiles, at bf16 on the tensor cores
cudaError_t head_partial(const __nv_bfloat16* h, const __nv_bfloat16* W,
                         const HeadEpi<__nv_bfloat16>& epi, int N, int Vp,
                         int K, cudaStream_t s) {
  // 128 rows where that still gives every SM a block, else 64
  const long long chunks = (Vp + HEAD_BN - 1) / HEAD_BN;
  const int bm = (N + 127) / 128 * chunks >= tc::NUM_SMS ? 128 : 64;
  return tc::run(h, W, epi, N, Vp, K, bm, HEAD_BN, s);
}

// ... and at float32 on FFMA
cudaError_t head_partial(const float* h, const float* W,
                         const HeadEpi<float>& epi, int N, int Vp, int K,
                         cudaStream_t s) {
  // the 128 x 128 tile where that still gives every SM a block, else
  // 64 x 128
  const bool vec = Vp % 4 == 0 && ffma::aligned16(W);
  if (ffma::blocks_of<ffma::T128x128>(N, Vp) >= ffma::NUM_SMS)
    return ffma::launch<ffma::T128x128>(h, W, epi, N, Vp, K, vec, s);
  return ffma::launch<ffma::T64x128>(h, W, epi, N, Vp, K, vec, s);
}

constexpr int COMBINE_WARPS = 8;

__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    head_combine_kernel(const float* __restrict__ pmax,
                        const int* __restrict__ parg,
                        const float* __restrict__ psum,
                        const float* __restrict__ pdot,
                        const float* __restrict__ pad_logit, int N,
                        int n_chunks, long long* __restrict__ ids,
                        float* __restrict__ tok, float* __restrict__ ent,
                        float* __restrict__ lp_pad) {
  const int r = blockIdx.x * COMBINE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= N) return;
  float m = -INFINITY;
  int a = INT_MAX;
  for (int c = lane; c < n_chunks; c += 32) {
    const float cm = pmax[(size_t)c * N + r];
    const int ca = parg[(size_t)c * N + r];
    if (cm > m || (cm == m && ca < a)) {
      m = cm;
      a = ca;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const int oa = __shfl_xor_sync(0xffffffffu, a, off);
    if (om > m || (om == m && oa < a)) {
      m = om;
      a = oa;
    }
  }
  float s = 0.f, t = 0.f;
  for (int c = lane; c < n_chunks; c += 32) {
    const size_t o = (size_t)c * N + r;
    const float f = expf(pmax[o] - m);
    s += psum[o] * f;
    t += pdot[o] * f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  if (lane == 0) {
    const float logz = m + logf(s);
    ids[r] = a;
    tok[r] = m - logz;
    ent[r] = logz - t / s;
    lp_pad[r] = pad_logit[r] - logz;
  }
}

template <typename T>
cudaError_t greedy_head(const T* h, const T* W, const T* bias, int N, int V,
                        int Vp, int K, int pad_id, float* scratch,
                        long long* ids, float* tok, float* ent, float* lp_pad,
                        cudaStream_t stream) {
  const int n_chunks = (V + HEAD_BN - 1) / HEAD_BN;   // = ceil(Vp / 128)
  const size_t part = (size_t)n_chunks * N;
  HeadEpi<T> epi;
  epi.bias = bias;
  epi.pmax = scratch;
  epi.psum = epi.pmax + part;
  epi.pdot = epi.psum + part;
  epi.parg = reinterpret_cast<int*>(epi.pdot + part);
  epi.pad_logit = reinterpret_cast<float*>(epi.parg + part);
  epi.M = N;
  epi.V = V;
  epi.pad_id = pad_id;
  BFC_TRY(head_partial(h, W, epi, N, Vp, K, stream));
  head_combine_kernel<<<(N + COMBINE_WARPS - 1) / COMBINE_WARPS,
                        COMBINE_WARPS * 32, 0, stream>>>(
      epi.pmax, epi.parg, epi.psum, epi.pdot, epi.pad_logit, N, n_chunks, ids,
      tok, ent, lp_pad);
  return cudaGetLastError();
}

}  // namespace bfc

// scratch (4-byte words) for one launch: pmax, psum, pdot (float32) and
// parg (int32), each [ceil(V / 128), N], then pad_logit float32 [N]
extern "C" long long bfc_greedy_head_scratch(int N, int V) {
  return 4LL * ((V + bfc::HEAD_BN - 1) / bfc::HEAD_BN) * N + N;
}

// h [N, K]; W [K, Vp] and bias [Vp], zero past the V real columns,
// V <= Vp < V + 8 (every chunk holds a real column); at bf16 K and Vp
// multiples of 8, h and W 16-byte aligned (TMA)
extern "C" int bfc_greedy_head(int dtype, int device, const void* h,
                               const void* W, const void* bias, int N, int V,
                               int Vp, int K, int pad_id, void* scratch,
                               void* ids, void* tok, void* ent, void* lp_pad,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (V <= 0 || Vp < V || Vp >= V + 8 || K <= 0 || pad_id < 0 || pad_id >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  long long* id = static_cast<long long*>(ids);
  float* tk = static_cast<float*>(tok);
  float* en = static_cast<float*>(ent);
  float* lp = static_cast<float*>(lp_pad);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(bfc::greedy_head<float>(
        static_cast<const float*>(h), static_cast<const float*>(W),
        static_cast<const float*>(bias), N, V, Vp, K, pad_id, sc, id, tk, en,
        lp, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(bfc::greedy_head<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(W),
        static_cast<const __nv_bfloat16*>(bias), N, V, Vp, K, pad_id, sc, id,
        tk, en, lp, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
