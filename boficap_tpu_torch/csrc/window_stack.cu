// Windowed decoder stacks: one SA fill round through all NL layers in one
// call.  Two entries of one library:
//
//   bfc_window_stack       <- boficap_tpu/ops/pallas_stack.py::
//                             _win_stack_kernel (:551; pallas_call :672)
//   bfc_window_wide_stack  <- ::_win_wide_stack_kernel (:712; pallas_call :812)
//
// The narrow round (bfc_window_stack) decodes a W-wide window per sample
// against each layer's K/V cache [NL, B, L, D] and writes the window's fresh
// K/V into that cache at the sample's window start w_start[b] (clamped to
// [0, L - W]) once the layer's self-attention has read it, so the caches
// are updated in place: rows outside the window are never written.  The TPU
// kernel does the same merge with a [G*L, G*W] one-hot product and aliases
// the caches input to output (pallas_stack.py:587-608,701).  The wide round
// (W == L, bfc_window_wide_stack) has no cache keys; it writes each layer's
// fresh K/V as that layer's whole new cache.
//
// Each layer is window.cuh's body (11 launches: its self-attention block
// writes the fresh K/V); layers pass activations through two ping-pong
// buffers of the scratch, and the last layer writes the output.  The final
// RefLayerNorm lies outside the TPU kernels too and runs in the Python
// wrapper.
//
// Bound on the H100 at B = 64, D = 512, d_ff = 2048, 6 layers, R = 36,
// L = 20: a narrow round (W = 8) is ~23 GFLOP against ~208 MB (float32) /
// ~104 MB (bf16) of weights, caches and cross K/V; a wide round (W = 20) is
// ~57 GFLOP against ~176 / ~88 MB.  Float32 FFMA is bound by operations in
// both; bf16 is bound by bytes in the narrow round (the weights and cross
// K/V are read again every round) and by operations in the wide one.  The
// bf16 products run on the tensor cores (wgmma_gemm.cuh), the float32 ones
// on FFMA (ffma_gemm.cuh); every weight is read once per layer per round,
// from L2 for all but the first block row.  A round is 66 launches; one
// persistent kernel per round, or a CUDA graph of it, is later work.
#include "window.cuh"

// Field order and types are mirrored by ops/stack.py (_WindowStackArgs);
// bfc_window_stack_args_size() lets it check.
struct BfcWindowStackArgs {
  const void* x;                    // [B, W, D] compute dtype
  void* k_caches;                   // [NL, B, L, D]: narrow, read and updated in place; wide, written
  void* v_caches;                   // [NL, B, L, D]
  const void* k2s;                  // [NL, B, R, D] pre-projected cross K
  const void* v2s;                  // [NL, B, R, D] pre-projected cross V
  const void* w_start;              // int32 [B] window starts (narrow); null (wide)
  const void* tgt_mask;             // bool (b, i, j) at b*tgt_sb + i*tgt_sq + j
  long long tgt_sb, tgt_sq;
  const void* src_mask;             // bool (b, i, j) at b*src_sb + i*src_sq + j
  long long src_sb, src_sq;
  const float *s0, *b0, *s1, *b1, *s2, *b2;   // float32 [NL, D]
  const void *wqkv, *bqkv;          // [NL, D, 3D], [NL, 3D]
  const void *wo, *bo;              // [NL, D, D], [NL, D]
  const void *wq2, *bq2;            // [NL, D, D], [NL, D]
  const void *wo2, *bo2;            // [NL, D, D], [NL, D]
  const void *w1, *bf1;             // [NL, D, F], [NL, F]
  const void *w2, *bf2;             // [NL, F, D], [NL, D]
  void* scratch;                    // bfc_window_stack_scratch() elements
  void* out;                        // [B, W, D], before the final norm
  int NL, B, W, L, R, D, F, H;
};

namespace bfc {

template <typename T>
cudaError_t window_stack(const BfcWindowStackArgs& a, bool wide,
                         cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  const size_t D = a.D, F = a.F, M = (size_t)a.B * a.W;
  const size_t cache = (size_t)a.B * a.L * D, cross = (size_t)a.B * a.R * D;
  T* scratch = static_cast<T*>(a.scratch);
  T* xbuf[2] = {scratch + window_layer_scratch(M, D, F),
                scratch + window_layer_scratch(M, D, F) + M * D};
  const T* cur = c(a.x);
  for (int l = 0; l < a.NL; ++l) {
    T* kc = static_cast<T*>(a.k_caches) + l * cache;
    T* vc = static_cast<T*>(a.v_caches) + l * cache;
    WinLayer<T> w{};
    w.x = cur;
    w.kc = wide ? nullptr : kc;
    w.vc = wide ? nullptr : vc;
    w.Lc = wide ? 0 : a.L;
    w.k_dst = kc;
    w.v_dst = vc;
    w.starts = wide ? nullptr : static_cast<const int*>(a.w_start);
    w.Ld = a.L;
    w.k2 = c(a.k2s) + l * cross;
    w.v2 = c(a.v2s) + l * cross;
    w.tgt = static_cast<const uint8_t*>(a.tgt_mask);
    w.tgt_sb = a.tgt_sb;
    w.tgt_sq = a.tgt_sq;
    w.src = static_cast<const uint8_t*>(a.src_mask);
    w.src_sb = a.src_sb;
    w.src_sq = a.src_sq;
    w.s0 = a.s0 + l * D; w.b0 = a.b0 + l * D;
    w.s1 = a.s1 + l * D; w.b1 = a.b1 + l * D;
    w.s2 = a.s2 + l * D; w.b2 = a.b2 + l * D;
    w.wqkv = c(a.wqkv) + l * D * 3 * D; w.bqkv = c(a.bqkv) + l * 3 * D;
    w.wo = c(a.wo) + l * D * D;         w.bo = c(a.bo) + l * D;
    w.wq2 = c(a.wq2) + l * D * D;       w.bq2 = c(a.bq2) + l * D;
    w.wo2 = c(a.wo2) + l * D * D;       w.bo2 = c(a.bo2) + l * D;
    w.w1 = c(a.w1) + l * D * F;         w.bf1 = c(a.bf1) + l * F;
    w.w2 = c(a.w2) + l * F * D;         w.bf2 = c(a.bf2) + l * D;
    w.scratch = scratch;
    T* dst = (l == a.NL - 1) ? static_cast<T*>(a.out) : xbuf[l % 2];
    w.out = dst;
    w.B = a.B; w.W = a.W; w.R = a.R; w.D = a.D; w.F = a.F; w.H = a.H;
    BFC_TRY(window_layer<T>(w, s));
    cur = dst;
  }
  return cudaSuccess;
}

template <typename T>
int run(const BfcWindowStackArgs* a, bool wide, void* stream) {
  return static_cast<int>(
      window_stack<T>(*a, wide, static_cast<cudaStream_t>(stream)));
}

int entry(int dtype, int device, const BfcWindowStackArgs* a, bool wide,
          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->H <= 0 || a->D % a->H != 0 || a->R <= 0 || a->NL <= 0 ||
      a->W > a->L || (wide && a->W != a->L) ||
      (!wide && a->w_start == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B <= 0 || a->W <= 0) return 0;
  if (dtype == BFC_DTYPE_F32) return run<float>(a, wide, stream);
  if (dtype == BFC_DTYPE_BF16) return run<__nv_bfloat16>(a, wide, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bfc

extern "C" int bfc_window_stack_args_size() {
  return static_cast<int>(sizeof(BfcWindowStackArgs));
}

// scratch elements (compute dtype) for one launch of either entry
extern "C" long long bfc_window_stack_scratch(int B, int W, int D, int F) {
  const long long M = (long long)B * W;
  return bfc::window_layer_scratch(M, D, F) + 2 * M * D;
}

extern "C" int bfc_window_stack(int dtype, int device,
                                const BfcWindowStackArgs* a, void* stream) {
  return bfc::entry(dtype, device, a, false, stream);
}

extern "C" int bfc_window_wide_stack(int dtype, int device,
                                     const BfcWindowStackArgs* a,
                                     void* stream) {
  return bfc::entry(dtype, device, a, true, stream);
}
