// Encoder layer and encoder stack: the ports of the TPU kernels
//
//   bfc_encoder_layer  <- boficap_tpu/ops/pallas_decoder_layer.py::
//                         _enc_kernel (:500, entered through
//                         fused_encoder_layer, pallas_call :597)
//   bfc_encoder_stack  <- boficap_tpu/ops/pallas_stack.py::
//                         _enc_stack_kernel (:415; pallas_call :502)
//
//   n0 = refnorm(x);   q|k|v = n0 @ Wqkv + bqkv      (one [D, 3D] product)
//   x1 = x + (attention(q, k, v, mask) @ Wo + bo)
//   n1 = refnorm(x1);  out = x1 + (relu(n1 @ W1 + bf1) @ W2 + bf2)
//
// The TPU runs the layer as one kernel over a block of samples held in
// VMEM.  Here it is seven launches of the building blocks on the caller's
// stream (2 refnorm, 4 products, 1 attention); activations pass between them
// through a scratch buffer the wrapper allocates, which at the serving
// batch stays in the 50 MB L2.
//
// The stack entry runs that body once per layer in one call: the weights
// arrive stacked over the layers ([NL, ...], each layer's block at a fixed
// stride) and the activations pass between layers through two ping-pong
// buffers behind the layer's scratch; the last layer writes the output.  The
// TPU kernel keeps the layer index as its outer grid axis and prefetches the
// next layer's weights into VMEM; that is a VMEM/DMA schedule, not ported.
//
// Bound on the H100: operations, ~14.7 GFLOP a layer at B = 64, R = 36,
// D = 512, d_ff = 2048, against ~22 MB to move in float32 (the stack: six
// times the work, ~75 MB of weights).  The products, ~98% of the flops,
// go through product<T> (wgmma_gemm.cuh): at bf16 TMA-fed wgmma on the
// tensor cores, at float32 the FFMA product of ffma_gemm.cuh.  One
// persistent fused kernel is later work.
#include "attention.cuh"
#include "wgmma_gemm.cuh"
#include "refnorm.cuh"

// Field order and types are mirrored by ops/decoder_layer.py
// (_EncoderLayerArgs); bfc_encoder_layer_args_size() lets it check.
struct BfcEncoderLayerArgs {
  const void* x;                    // [B, R, D] compute dtype
  const void* mask;                 // bool (b, i, j) at b*mask_sb + i*mask_sq + j
  long long mask_sb, mask_sq;
  const float *s0, *b0, *s1, *b1;   // RefLayerNorm scale / bias, float32 [D]
  const void *wqkv, *bqkv;          // [D, 3D], [3D]
  const void *wo, *bo;              // [D, D], [D]
  const void *w1, *bf1;             // [D, F], [F]
  const void *w2, *bf2;             // [F, D], [D]
  void* scratch;                    // bfc_encoder_layer_scratch() elements
  void* out;                        // [B, R, D]
  int B, R, D, F, H;
};

namespace bfc {

template <typename T>
cudaError_t encoder_layer(const BfcEncoderLayerArgs& a, cudaStream_t s) {
  const int M = a.B * a.R, D = a.D, F = a.F;
  auto w = [](const void* p) { return static_cast<const T*>(p); };
  const T* x = w(a.x);
  T* n = static_cast<T*>(a.scratch);   // [M, D]  n0, then n1
  T* qkv = n + (size_t)M * D;          // [M, 3D]
  T* ctx = qkv + (size_t)M * 3 * D;    // [M, D]
  T* x1 = ctx + (size_t)M * D;         // [M, D]
  T* f = x1 + (size_t)M * D;           // [M, F]
  BFC_TRY(refnorm<T>(x, a.s0, a.b0, n, M, D, s));
  BFC_TRY(product<T>(n, w(a.wqkv), w(a.bqkv), nullptr, qkv, M, 3 * D, D,
                     false, s));
  BFC_TRY(attention<T>(qkv, 3 * D, qkv + D, 3 * D, qkv + 2 * D, 3 * D,
                       static_cast<const uint8_t*>(a.mask), a.mask_sb,
                       a.mask_sq, ctx, D, a.B, a.H, a.R, a.R, D / a.H, s));
  BFC_TRY(product<T>(ctx, w(a.wo), w(a.bo), x, x1, M, D, D, false, s));
  BFC_TRY(refnorm<T>(x1, a.s1, a.b1, n, M, D, s));
  BFC_TRY(product<T>(n, w(a.w1), w(a.bf1), nullptr, f, M, F, D, true, s));
  return product<T>(f, w(a.w2), w(a.bf2), x1, static_cast<T*>(a.out), M, D,
                    F, false, s);
}

// a: the layer's arguments with every weight pointer at layer 0 of its
// [NL, ...] stack, scratch of bfc_encoder_stack_scratch() elements
template <typename T>
cudaError_t encoder_stack(const BfcEncoderLayerArgs& a, int NL,
                          cudaStream_t s) {
  const size_t D = a.D, F = a.F, M = (size_t)a.B * a.R;
  auto at = [](const void* p, int l, size_t n) {
    return static_cast<const void*>(static_cast<const T*>(p) + l * n);
  };
  T* xbuf = static_cast<T*>(a.scratch) + (size_t)M * (6 * D + F);
  const void* cur = a.x;
  for (int l = 0; l < NL; ++l) {
    BfcEncoderLayerArgs w = a;
    w.x = cur;
    w.s0 = a.s0 + l * D; w.b0 = a.b0 + l * D;
    w.s1 = a.s1 + l * D; w.b1 = a.b1 + l * D;
    w.wqkv = at(a.wqkv, l, D * 3 * D); w.bqkv = at(a.bqkv, l, 3 * D);
    w.wo = at(a.wo, l, D * D);         w.bo = at(a.bo, l, D);
    w.w1 = at(a.w1, l, D * F);         w.bf1 = at(a.bf1, l, F);
    w.w2 = at(a.w2, l, F * D);         w.bf2 = at(a.bf2, l, D);
    w.out = (l == NL - 1) ? a.out : xbuf + (l % 2) * M * D;
    BFC_TRY(encoder_layer<T>(w, s));
    cur = w.out;
  }
  return cudaSuccess;
}

int run(int dtype, int device, const BfcEncoderLayerArgs* a, int NL,
        bool stack, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->H <= 0 || a->D % a->H != 0 || NL <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B <= 0 || a->R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(stack ? encoder_stack<float>(*a, NL, s)
                                  : encoder_layer<float>(*a, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(stack ? encoder_stack<__nv_bfloat16>(*a, NL, s)
                                  : encoder_layer<__nv_bfloat16>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bfc

extern "C" int bfc_encoder_layer_args_size() {
  return static_cast<int>(sizeof(BfcEncoderLayerArgs));
}

// scratch elements (compute dtype) for one launch
extern "C" long long bfc_encoder_layer_scratch(int B, int R, int D, int F) {
  return (long long)B * R * (6LL * D + F);
}

// scratch elements (compute dtype) for one stack launch: the layer's, and
// two [B, R, D] ping-pong buffers
extern "C" long long bfc_encoder_stack_scratch(int B, int R, int D, int F) {
  return bfc_encoder_layer_scratch(B, R, D, F) + 2LL * B * R * D;
}

extern "C" int bfc_encoder_layer(int dtype, int device,
                                 const BfcEncoderLayerArgs* a, void* stream) {
  return bfc::run(dtype, device, a, 1, false, stream);
}

// every layer of the stack in one call; a's weights are [NL, ...] stacks
extern "C" int bfc_encoder_stack(int dtype, int device,
                                 const BfcEncoderLayerArgs* a, int NL,
                                 void* stream) {
  return bfc::run(dtype, device, a, NL, true, stream);
}
