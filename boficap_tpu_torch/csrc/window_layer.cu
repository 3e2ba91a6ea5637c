// Windowed decoder layer: the port of the TPU kernel
// boficap_tpu/ops/pallas_decoder_layer.py::_win_kernel (:283, entered
// through fused_window_decoder_layer, pallas_call :415).
//
// One decoder layer on a W-wide window of new SA positions per sample:
// keys = the layer's K/V cache [B, L, D] ++ the window's fresh K/V, cross
// K/V pre-projected.  Returns the window's output and its fresh K/V
// ([B, W, D] each, written by the self-attention block); the caller
// scatters them into the cache (a torch index write, as the JAX package
// scatters in XLA between launches).  The layer body is window.cuh's (11
// launches on the caller's stream), so this kernel takes the bf16
// tensor-core product and the K/V write of the window stacks
// (window_stack.cu) without a design of its own.
//
// Bound on the H100 at B = 64, W = 8, L = 20, R = 36, D = 512, d_ff = 2048:
// ~3.8 GFLOP against ~32 MB (float32) / ~16 MB (bf16): operations in
// float32 (~57 us on FFMA), bytes in bf16 (~5 us).  The TPU kernel's
// block-diagonal batching of G samples is a VMEM layout trick and is not
// ported: attention runs per (sample, head) with per-sample masks.
#include "window.cuh"

// Field order and types are mirrored by ops/decoder_layer.py
// (_WindowLayerArgs); bfc_window_layer_args_size() lets it check.
struct BfcWindowLayerArgs {
  const void* x;                    // [B, W, D] compute dtype
  const void* k_cache;              // [B, L, D]
  const void* v_cache;              // [B, L, D]
  const void* k2;                   // [B, R, D] pre-projected cross K
  const void* v2;                   // [B, R, D] pre-projected cross V
  const void* tgt_mask;             // bool (b, i, j) at b*tgt_sb + i*tgt_sq + j, j < L + W
  long long tgt_sb, tgt_sq;
  const void* src_mask;             // bool (b, i, j) at b*src_sb + i*src_sq + j
  long long src_sb, src_sq;
  const float *s0, *b0, *s1, *b1, *s2, *b2;   // float32 [D]
  const void *wqkv, *bqkv;          // [D, 3D], [3D]
  const void *wo, *bo;              // [D, D], [D]
  const void *wq2, *bq2;            // [D, D], [D]
  const void *wo2, *bo2;            // [D, D], [D]
  const void *w1, *bf1;             // [D, F], [F]
  const void *w2, *bf2;             // [F, D], [D]
  void* scratch;                    // bfc_window_layer_scratch() elements
  void* out;                        // [B, W, D]
  void* k_new;                      // [B, W, D]
  void* v_new;                      // [B, W, D]
  int B, W, L, R, D, F, H;
};

namespace bfc {

template <typename T>
cudaError_t window_layer_entry(const BfcWindowLayerArgs& a, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  WinLayer<T> w{};
  w.x = c(a.x);
  w.kc = c(a.k_cache);
  w.vc = c(a.v_cache);
  w.Lc = a.L;
  w.k_dst = static_cast<T*>(a.k_new);
  w.v_dst = static_cast<T*>(a.v_new);
  w.starts = nullptr;
  w.Ld = a.W;
  w.k2 = c(a.k2);
  w.v2 = c(a.v2);
  w.tgt = static_cast<const uint8_t*>(a.tgt_mask);
  w.tgt_sb = a.tgt_sb;
  w.tgt_sq = a.tgt_sq;
  w.src = static_cast<const uint8_t*>(a.src_mask);
  w.src_sb = a.src_sb;
  w.src_sq = a.src_sq;
  w.s0 = a.s0; w.b0 = a.b0; w.s1 = a.s1; w.b1 = a.b1; w.s2 = a.s2; w.b2 = a.b2;
  w.wqkv = c(a.wqkv); w.bqkv = c(a.bqkv); w.wo = c(a.wo); w.bo = c(a.bo);
  w.wq2 = c(a.wq2); w.bq2 = c(a.bq2); w.wo2 = c(a.wo2); w.bo2 = c(a.bo2);
  w.w1 = c(a.w1); w.bf1 = c(a.bf1); w.w2 = c(a.w2); w.bf2 = c(a.bf2);
  w.scratch = static_cast<T*>(a.scratch);
  w.out = static_cast<T*>(a.out);
  w.B = a.B; w.W = a.W; w.R = a.R; w.D = a.D; w.F = a.F; w.H = a.H;
  return window_layer<T>(w, s);
}

}  // namespace bfc

extern "C" int bfc_window_layer_args_size() {
  return static_cast<int>(sizeof(BfcWindowLayerArgs));
}

// scratch elements (compute dtype) for one launch
extern "C" long long bfc_window_layer_scratch(int B, int W, int D, int F) {
  return bfc::window_layer_scratch((long long)B * W, D, F);
}

extern "C" int bfc_window_layer(int dtype, int device,
                                const BfcWindowLayerArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->H <= 0 || a->D % a->H != 0 || a->R <= 0 || a->L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B <= 0 || a->W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(bfc::window_layer_entry<float>(*a, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(bfc::window_layer_entry<__nv_bfloat16>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
