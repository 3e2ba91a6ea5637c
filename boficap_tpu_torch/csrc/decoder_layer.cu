// Decoder layer and decoder stack: the ports of the TPU kernels
//
//   bfc_decoder_layer  <- boficap_tpu/ops/pallas_decoder_layer.py::_kernel
//                         (:124, entered through fused_decoder_layer,
//                         pallas_call :638)
//   bfc_decoder_stack  <- boficap_tpu/ops/pallas_stack.py::
//                         _dec_stack_kernel (:258; pallas_call :362)
//
//   n0 = refnorm(x);   q|k|v = n0 @ Wqkv + bqkv           ([D, 3D])
//   x1 = x + (attention(q, k, v, tgt_mask) @ Wo + bo)
//   n1 = refnorm(x1);  q2 = n1 @ Wq2 + bq2
//   k2|v2 = memory @ Wkv2 + bkv2     ([D, 2D]; the memory is already normed)
//   x2 = x1 + (attention(q2, k2, v2, src_mask) @ Wo2 + bo2)
//   n2 = refnorm(x2);  out = x2 + (relu(n2 @ W1 + bf1) @ W2 + bf2)
//
// The layer is twelve launches of the building blocks on the caller's
// stream (3 refnorm, 7 products, 2 attention); activations pass through a
// scratch buffer the wrapper allocates.  The TPU kernel's block-diagonal
// batching and its 2x fill on cross-sample blocks are a VMEM layout trick:
// attention here is per (sample, head) with per-sample masks.
//
// The stack entry runs that body once per layer in one call, as
// encoder_layer.cu's does: weights stacked over the layers ([NL, ...]),
// activations through two ping-pong buffers behind the layer's scratch,
// the memory and the masks shared by every layer.  1 + 11 NL launches (67
// at NL = 6; ops/decoder_layer.py decoder_launches mirrors the count).
//
// Bound on the H100: operations, ~72 GFLOP a stack at B = 64, L = 20,
// R = 36, D = 512, d_ff = 2048 (0.073 ms at the 989 TFLOP/s of bf16),
// against ~0.1 GB of float32 weights.  The products go through product<T>
// (wgmma_gemm.cuh): bf16 on the tensor cores, float32 on the FFMA product
// of ffma_gemm.cuh.  At B = 64 a layer's kernels each do a few µs of work,
// so the launches and the dead time between dependent ones were much of
// the stack's time.  Against that:
//  - The memory's cross K|V does not depend on the layer's input: the
//    stack projects every layer's in one product first, memory [B*R, D] @
//    [D, NL*2D] (the layers' Wkv2 side by side, StackPack "wkv2_all"), 864
//    128 x 128 tiles in one launch where six launches of 144 left a tail
//    on 132 SMs; each layer's cross-attention reads its columns of the
//    result, which no later launch writes.  BN follows the layer's width
//    2D, so every output sums as #2's own projection does: bitwise.
//  - At bf16 the launches form one chain by programmatic dependent launch
//    (common.cuh launch_kernel): each starts while its predecessor drains,
//    sets up its barriers and fetches its first W tiles, and reads or
//    writes activations only after griddepcontrol.wait.  Every block of
//    every kernel waits before it exits, so the chain keeps stream order
//    (a residual read two launches back included); the outputs are
//    bitwise those of plain launches.  A cross-attention over more than
//    128 regions (196: a 14 x 14 image grid) takes attention.cuh's
//    chunked tile kernel, a link of the same chain.  float32 launches
//    plainly (slower chained on the H100; PERF.md).
//
// bfc_gemm runs one product alone, C = epilogue(A @ W + bias), on the same
// route, and bfc_refnorm one RefLayerNorm (refnorm.cuh): ways to time the
// building blocks alone (ops/decoder_layer.py fused_linear, fused_refnorm);
// no decode path calls them.
#include "attention.cuh"
#include "wgmma_gemm.cuh"
#include "refnorm.cuh"

// Field order and types are mirrored by ops/decoder_layer.py
// (_DecoderLayerArgs); bfc_decoder_layer_args_size() lets it check.
struct BfcDecoderLayerArgs {
  const void* x;                    // [B, L, D] compute dtype
  const void* memory;               // [B, R, D]
  const void* tgt_mask;             // bool (b, i, j) at b*tgt_sb + i*tgt_sq + j
  long long tgt_sb, tgt_sq;
  const void* src_mask;             // bool (b, i, j) at b*src_sb + i*src_sq + j
  long long src_sb, src_sq;
  const float *s0, *b0, *s1, *b1, *s2, *b2;   // float32 [D]
  const void *wqkv, *bqkv;          // [D, 3D], [3D]
  const void *wo, *bo;              // [D, D], [D]
  const void *wq2, *bq2;            // [D, D], [D]
  const void *wkv2, *bkv2;          // [D, 2D], [2D]
  const void *wo2, *bo2;            // [D, D], [D]
  const void *w1, *bf1;             // [D, F], [F]
  const void *w2, *bf2;             // [F, D], [D]
  void* scratch;                    // bfc_decoder_layer_scratch() elements
  void* out;                        // [B, L, D]
  int B, L, R, D, F, H;
};

namespace bfc {

// One layer's launches on stream s.  kv: the layer's cross K|V, rows of
// [B * R, ld_kv] with K at column 0 and V at column D (the stack's, which
// it projects for every layer up front), or nullptr: projected here into
// the scratch (#2).  At bf16 every launch but the layer's first is chained
// to the one before it (common.cuh launch_kernel); chain_first chains the
// first too (the stack's layers, which follow the stack's own launches).
// float32 launches plainly: chained, its FFMA products and attention ran
// 18% slower on the H100 (PERF.md).
template <typename T>
cudaError_t decoder_layer(const BfcDecoderLayerArgs& a, const T* kv,
                          int ld_kv, bool chain_first, cudaStream_t s) {
  const int M = a.B * a.L, MR = a.B * a.R, D = a.D, F = a.F;
  const int Dh = D / a.H;
  constexpr bool CH = sizeof(T) == 2;   // chained launches: bf16 only
  auto w = [](const void* p) { return static_cast<const T*>(p); };
  const T* x = w(a.x);
  T* n = static_cast<T*>(a.scratch);   // [M, D]   n0, n1, then n2
  T* qkv = n + (size_t)M * D;          // [M, 3D]
  T* ctx = qkv + (size_t)M * 3 * D;    // [M, D]   self, then cross context
  T* x1 = ctx + (size_t)M * D;         // [M, D]
  T* q2 = x1 + (size_t)M * D;          // [M, D]
  T* x2 = q2 + (size_t)M * D;          // [M, D]
  T* f = x2 + (size_t)M * D;           // [M, F]
  const uint8_t* tgt = static_cast<const uint8_t*>(a.tgt_mask);
  const uint8_t* src = static_cast<const uint8_t*>(a.src_mask);

  // self-attention sublayer (each call in parentheses: BFC_TRY is a macro,
  // and the commas of <T, CH> would split its argument)
  BFC_TRY((chain_first ? refnorm<T, CH>(x, a.s0, a.b0, n, M, D, s)
                       : refnorm<T>(x, a.s0, a.b0, n, M, D, s)));
  BFC_TRY((product<T, CH>(n, w(a.wqkv), w(a.bqkv), nullptr, qkv, M, 3 * D,
                          D, false, s)));
  BFC_TRY((attention<T, CH>(qkv, 3 * D, qkv + D, 3 * D, qkv + 2 * D, 3 * D,
                            tgt, a.tgt_sb, a.tgt_sq, ctx, D, a.B, a.H, a.L,
                            a.L, Dh, s)));
  BFC_TRY((product<T, CH>(ctx, w(a.wo), w(a.bo), x, x1, M, D, D, false, s)));
  // cross-attention sublayer: only the query side is normed
  BFC_TRY((refnorm<T, CH>(x1, a.s1, a.b1, n, M, D, s)));
  BFC_TRY((product<T, CH>(n, w(a.wq2), w(a.bq2), nullptr, q2, M, D, D,
                          false, s)));
  if (kv == nullptr) {
    T* kv2 = f + (size_t)M * F;        // [MR, 2D]
    BFC_TRY((product<T, CH>(w(a.memory), w(a.wkv2), w(a.bkv2), nullptr, kv2,
                            MR, 2 * D, D, false, s)));
    kv = kv2;
    ld_kv = 2 * D;
  }
  BFC_TRY((attention<T, CH>(q2, D, kv, ld_kv, kv + D, ld_kv, src, a.src_sb,
                            a.src_sq, ctx, D, a.B, a.H, a.L, a.R, Dh, s)));
  BFC_TRY((product<T, CH>(ctx, w(a.wo2), w(a.bo2), x1, x2, M, D, D, false,
                          s)));
  // FFN sublayer
  BFC_TRY((refnorm<T, CH>(x2, a.s2, a.b2, n, M, D, s)));
  BFC_TRY((product<T, CH>(n, w(a.w1), w(a.bf1), nullptr, f, M, F, D, true,
                          s)));
  return product<T, CH>(f, w(a.w2), w(a.bf2), x2, static_cast<T*>(a.out), M,
                        D, F, false, s);
}

// a: the layer's arguments with every weight pointer at layer 0 of its
// [NL, ...] stack, except wkv2, which is every layer's K|V projection side
// by side, [D, NL * 2D] (bkv2, [NL, 2D], is read as [NL * 2D]); scratch of
// bfc_decoder_stack_scratch() elements
template <typename T>
cudaError_t decoder_stack(const BfcDecoderLayerArgs& a, int NL,
                          cudaStream_t s) {
  const size_t D = a.D, F = a.F, M = (size_t)a.B * a.L;
  const int MR = a.B * a.R, NKV = NL * 2 * a.D;
  auto at = [](const void* p, int l, size_t n) {
    return static_cast<const void*>(static_cast<const T*>(p) + l * n);
  };
  // the layer's activations, then two [M, D] ping-pong buffers, then every
  // layer's cross K|V, [B * R, NL * 2D]: written once, first, and by no
  // later launch of the stack
  T* xbuf = static_cast<T*>(a.scratch) + M * (8 * D + F);
  T* kv = xbuf + 2 * M * D;
  BFC_TRY(product<T>(static_cast<const T*>(a.memory),
                     static_cast<const T*>(a.wkv2),
                     static_cast<const T*>(a.bkv2), nullptr, kv, MR, NKV,
                     a.D, false, s, 2 * a.D));
  const void* cur = a.x;
  for (int l = 0; l < NL; ++l) {
    BfcDecoderLayerArgs w = a;
    w.x = cur;
    w.s0 = a.s0 + l * D; w.b0 = a.b0 + l * D;
    w.s1 = a.s1 + l * D; w.b1 = a.b1 + l * D;
    w.s2 = a.s2 + l * D; w.b2 = a.b2 + l * D;
    w.wqkv = at(a.wqkv, l, D * 3 * D); w.bqkv = at(a.bqkv, l, 3 * D);
    w.wo = at(a.wo, l, D * D);         w.bo = at(a.bo, l, D);
    w.wq2 = at(a.wq2, l, D * D);       w.bq2 = at(a.bq2, l, D);
    w.wkv2 = w.bkv2 = nullptr;         // read from kv
    w.wo2 = at(a.wo2, l, D * D);       w.bo2 = at(a.bo2, l, D);
    w.w1 = at(a.w1, l, D * F);         w.bf1 = at(a.bf1, l, F);
    w.w2 = at(a.w2, l, F * D);         w.bf2 = at(a.bf2, l, D);
    w.out = (l == NL - 1) ? a.out : xbuf + (l % 2) * M * D;
    BFC_TRY(decoder_layer<T>(w, kv + (size_t)l * 2 * D, NKV, true, s));
    cur = w.out;
  }
  return cudaSuccess;
}

int run(int dtype, int device, const BfcDecoderLayerArgs* a, int NL,
        bool stack, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->H <= 0 || a->D % a->H != 0 || a->R <= 0 || NL <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B <= 0 || a->L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(stack ? decoder_stack<float>(*a, NL, s)
                                  : decoder_layer<float>(*a, nullptr, 0,
                                                         false, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(
        stack ? decoder_stack<__nv_bfloat16>(*a, NL, s)
              : decoder_layer<__nv_bfloat16>(*a, nullptr, 0, false, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// bfc_gemm's product in the type T
template <typename T>
int run_product(const void* A, const void* W, const void* bias,
                const void* res, void* C, int M, int N, int K, bool relu,
                cudaStream_t s) {
  return static_cast<int>(product<T>(
      static_cast<const T*>(A), static_cast<const T*>(W),
      static_cast<const T*>(bias), static_cast<const T*>(res),
      static_cast<T*>(C), M, N, K, relu, s));
}

}  // namespace bfc

extern "C" int bfc_decoder_layer_args_size() {
  return static_cast<int>(sizeof(BfcDecoderLayerArgs));
}

// scratch elements (compute dtype) for one launch
extern "C" long long bfc_decoder_layer_scratch(int B, int L, int R, int D,
                                               int F) {
  return (long long)B * L * (8LL * D + F) + (long long)B * R * 2 * D;
}

// scratch elements (compute dtype) for one stack launch of NL layers: the
// layer's activations, two [B, L, D] ping-pong buffers, and every layer's
// cross K|V ([B * R, NL * 2D]; the layer's own K|V region is not used)
extern "C" long long bfc_decoder_stack_scratch(int B, int L, int R, int D,
                                               int F, int NL) {
  return bfc_decoder_layer_scratch(B, L, R, D, F) + 2LL * B * L * D +
         (NL - 1LL) * B * R * 2 * D;
}

extern "C" int bfc_decoder_layer(int dtype, int device,
                                 const BfcDecoderLayerArgs* a, void* stream) {
  return bfc::run(dtype, device, a, 1, false, stream);
}

// every layer of the stack in one call; a's weights are [NL, ...] stacks
extern "C" int bfc_decoder_stack(int dtype, int device,
                                 const BfcDecoderLayerArgs* a, int NL,
                                 void* stream) {
  return bfc::run(dtype, device, a, NL, true, stream);
}

// one product alone: C [M, N] = epilogue(A [M, K] @ W [K, N] + bias [N]),
// relu if relu != 0, res [M, N] (nullable) added last
extern "C" int bfc_gemm(int dtype, int device, const void* A, const void* W,
                        const void* bias, const void* res, void* C, int M,
                        int N, int K, int relu, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return bfc::run_product<float>(A, W, bias, res, C, M, N, K, relu != 0, s);
  if (dtype == BFC_DTYPE_BF16)
    return bfc::run_product<__nv_bfloat16>(A, W, bias, res, C, M, N, K,
                                           relu != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// one RefLayerNorm alone: y [rows, d] = refnorm(x [rows, d]), float32
// scale and bias [d]
extern "C" int bfc_refnorm(int dtype, int device, const void* x,
                           const float* scale, const float* bias, void* y,
                           int rows, int d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(bfc::refnorm<float>(
        static_cast<const float*>(x), scale, bias, static_cast<float*>(y),
        rows, d, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(bfc::refnorm<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), scale, bias,
        static_cast<__nv_bfloat16*>(y), rows, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the tile of an M x N product at dtype: BM, BN and the block count
extern "C" int bfc_gemm_tile(int dtype, int M, int N, int* bm, int* bn) {
  if (dtype == BFC_DTYPE_F32) {
    bfc::ffma::tile_shape(bfc::ffma::tile_for(M, N), bm, bn);
  } else {
    *bm = bfc::tc::tile_m(M, N);
    *bn = bfc::tc::tile_n(N);
  }
  return ((M + *bm - 1) / *bm) * ((N + *bn - 1) / *bn);
}
