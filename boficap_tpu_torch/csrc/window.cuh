// Building block: one windowed decoder layer of the SA fill, shared by the
// per-layer kernel (window_layer.cu, the port of
// boficap_tpu/ops/pallas_decoder_layer.py::_win_kernel :283) and the two
// whole-stack kernels (window_stack.cu, the ports of
// boficap_tpu/ops/pallas_stack.py::_win_stack_kernel :551 and
// ::_win_wide_stack_kernel :712).
//
// A window is W new decoder positions per sample.  Its self-attention keys
// are the sample's K/V cache rows (Lc of them; none for the wide round)
// followed by the window's fresh K/V; the cross-attention K/V arrive
// pre-projected from the encoder memory:
//
//   n0 = refnorm(x);   q|k|v = n0 @ Wqkv + bqkv             ([D, 3D])
//   x1 = x + (attention(q, cache_k ++ k, cache_v ++ v, tgt) @ Wo + bo)
//   (k, v) -> rows start_b .. start_b + W - 1 of k_dst / v_dst
//   n1 = refnorm(x1);  q2 = n1 @ Wq2 + bq2
//   x2 = x1 + (attention(q2, k2, v2, src) @ Wo2 + bo2)
//   n2 = refnorm(x2);  out = x2 + (relu(n2 @ W1 + bf1) @ W2 + bf2)
//
// Eleven launches on the caller's stream (3 refnorm, 6 products, 2
// attention).  The self-attention block also writes the window's fresh K/V
// into k_dst / v_dst (attention.cuh KvDst): block (b, h) stages its
// sample's cache and fresh K/V, then copies head h's fresh columns out, so
// a layer whose destination is its own cache (the narrow stack round)
// attends over the cache as it was before this layer's update, as the TPU
// kernel does (pallas_stack.py:587-608).  That matters even for the cache's
// copies of in-window positions, which the caller masks: a fully masked
// query row averages uniformly over every key, those included.
//
// Bound on the H100: the serving shapes put a narrow round (B = 64, W = 8,
// 512 rows) at ~3.8 GFLOP a layer against ~32 MB (float32) or ~16 MB (bf16)
// of weights, caches and cross K/V, so float32 FFMA is bound by operations
// (~57 us) and bf16 by bytes (~5 us).  The products go through product<T>
// (wgmma_gemm.cuh): bf16 on the tensor cores (TMA into a shared-memory ring,
// wgmma; the layer kernels' product), float32 on the FFMA product of
// ffma_gemm.cuh (a cp.async ring, up to 8 x 8 outputs a thread, its tile
// chosen so the 512-row products still fill the card).
// Every weight is still read once a launch; keeping the weights resident
// across a round's layers is later work.
#pragma once

#include "attention.cuh"
#include "refnorm.cuh"
#include "wgmma_gemm.cuh"

namespace bfc {

template <typename T>
struct WinLayer {
  const T* x;                     // [B*W, D]
  const T *kc, *vc;               // cache keys [B, Lc, D]; Lc = 0: none
  int Lc;
  T *k_dst, *v_dst;               // fresh K/V destination [B, Ld, D]
  const int* starts;              // [B] window start in the destination, or null
  int Ld;
  const T *k2, *v2;               // pre-projected cross K/V [B, R, D]
  const uint8_t* tgt;             // keys: Lc cache columns, then W window columns
  long long tgt_sb, tgt_sq;
  const uint8_t* src;
  long long src_sb, src_sq;
  const float *s0, *b0, *s1, *b1, *s2, *b2;
  const T *wqkv, *bqkv, *wo, *bo, *wq2, *bq2, *wo2, *bo2, *w1, *bf1, *w2, *bf2;
  T* scratch;                     // window_layer_scratch() elements
  T* out;                         // [B*W, D]
  int B, W, R, D, F, H;
};

inline long long window_layer_scratch(long long M, long long D, long long F) {
  return M * (8 * D + F);
}

template <typename T>
cudaError_t window_layer(const WinLayer<T>& a, cudaStream_t s) {
  const int M = a.B * a.W, D = a.D, F = a.F;
  const int Dh = D / a.H;
  T* n = a.scratch;                    // [M, D]   n0, n1, then n2
  T* qkv = n + (size_t)M * D;          // [M, 3D]
  T* ctx = qkv + (size_t)M * 3 * D;    // [M, D]   self, then cross context
  T* x1 = ctx + (size_t)M * D;         // [M, D]
  T* q2 = x1 + (size_t)M * D;          // [M, D]
  T* x2 = q2 + (size_t)M * D;          // [M, D]
  T* f = x2 + (size_t)M * D;           // [M, F]

  // self-attention sublayer: keys = cache ++ fresh window; the fresh K/V
  // go to k_dst / v_dst once the block has staged every key
  BFC_TRY(refnorm<T>(a.x, a.s0, a.b0, n, M, D, s));
  BFC_TRY(product<T>(n, a.wqkv, a.bqkv, nullptr, qkv, M, 3 * D, D, false, s));
  BFC_TRY(attention2<T>(qkv, 3 * D, KeySrc<T>{a.kc, a.vc, D, D, a.Lc},
                        KeySrc<T>{qkv + D, qkv + 2 * D, 3 * D, 3 * D, a.W},
                        a.tgt, a.tgt_sb, a.tgt_sq, ctx, D, a.B, a.H, a.W, Dh,
                        s, KvDst<T>{a.k_dst, a.v_dst, a.starts, a.Ld, D}));
  BFC_TRY(product<T>(ctx, a.wo, a.bo, a.x, x1, M, D, D, false, s));
  // cross-attention sublayer on the pre-projected memory K/V
  BFC_TRY(refnorm<T>(x1, a.s1, a.b1, n, M, D, s));
  BFC_TRY(product<T>(n, a.wq2, a.bq2, nullptr, q2, M, D, D, false, s));
  BFC_TRY(attention<T>(q2, D, a.k2, D, a.v2, D, a.src, a.src_sb, a.src_sq,
                       ctx, D, a.B, a.H, a.W, a.R, Dh, s));
  BFC_TRY(product<T>(ctx, a.wo2, a.bo2, x1, x2, M, D, D, false, s));
  // FFN sublayer
  BFC_TRY(refnorm<T>(x2, a.s2, a.b2, n, M, D, s));
  BFC_TRY(product<T>(n, a.w1, a.bf1, nullptr, f, M, F, D, true, s));
  return product<T>(f, a.w2, a.bf2, x2, a.out, M, D, F, false, s);
}

}  // namespace bfc
