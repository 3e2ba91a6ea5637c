// The windowed decoder layer taken apart: the ports of the two TPU kernels
// of the kernel-parts tool (scripts/bench_kernel_parts.py):
//
//   bfc_window_layer_parts  <- _abl_kernel (:36; abl_layer, pallas_call :164)
//   bfc_window_layer_hb     <- _hb_kernel  (:327; hb_layer, pallas_call :460)
//
// Both take the operands and give the outputs of the window layer #8
// (window_layer.cu): x [B, W, D], caches [B, L, D], pre-projected cross K/V
// [B, R, D], per-sample bool masks; out, k_new, v_new [B, W, D].  The TPU
// kernels' block-diagonal batching of G samples is a VMEM layout and is not
// ported (its cross-sample keys sit at 2 * -1e9 and add exact zeros).
//
// bfc_window_layer_parts runs window.cuh's eleven-launch layer with parts
// switched off by a mask (WP_PROJ, WP_SELF, WP_CROSS, WP_FFN, WP_NORM); a
// switch drops its part's launches and nothing else, as _abl_kernel
// (:56-141) drops its code:
//
//   norm off   each refnorm is the identity: the products read x itself
//   proj off   q = k_new = v_new = n0 and no self sublayer: one copy
//              launch writes n0 into k_new and v_new
//   proj on, self off
//              x += q @ Wo + bo: the fresh K/V and q leave the qkv product
//              [M, 3D] by one copy launch (q into a contiguous buffer, the
//              out product's A; k, v into k_new, v_new), in place of the
//              attention block's KvDst write
//   cross off, ffn off
//              their sublayers' launches go; the last sublayer still on
//              writes the output, and with none on (no proj, no cross, no
//              ffn) the copy launch also writes out = x
//
// Launches by variant (ops/window_parts.py kernel_launches mirrors this):
// full 11 (3 refnorm, 6 products, 2 attention), no_self 11 (3, 6, 1 and 1
// copy), no_cross 7, no_ffn 8, no_norm 8, proj_only 3 (2 products, 1
// copy), empty 1 (the copy).
//
// bfc_window_layer_hb is the same eleven launches with both attentions on
// hb_attention.cuh's block: one max a query row across every head, each
// head's own sum.  It writes the fresh K/V as the self-attention block of
// #8 does.
//
// Bound on the H100 at B = 64, W = 8, L = 20, R = 36, D = 512, d_ff = 2048:
// #8's (window_layer.cu): ~3.8 GFLOP against ~16 MB (bf16) / ~32 MB
// (float32); no variant does more useful work.
#include "hb_attention.cuh"
#include "window.cuh"

// Field order and types are those of window_layer.cu's BfcWindowLayerArgs,
// mirrored by ops/decoder_layer.py (_WindowLayerArgs);
// bfc_window_parts_args_size() lets it check.
struct BfcWindowPartsArgs {
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
  void* scratch;                    // bfc_window_parts_scratch() elements
  void* out;                        // [B, W, D]
  void* k_new;                      // [B, W, D]
  void* v_new;                      // [B, W, D]
  int B, W, L, R, D, F, H;
};

namespace bfc {

enum : int {
  WP_PROJ = 1, WP_SELF = 2, WP_CROSS = 4, WP_FFN = 8, WP_NORM = 16,
  WP_ALL = 31
};

// up to three row copies in one launch: job j copies [M, D] from src[j]
// (row stride lds[j]) to dst[j] (row stride D)
template <typename T>
struct CopyJobs {
  const T* src[3];
  int lds[3];
  T* dst[3];
  int n;
};

// one block a (row, job): the row in 16-byte chunks where every row of
// every job starts 16-byte aligned (vec), else element by element.  No
// index division an element: a 64-bit division and remainder an element
// made the copy cost ~16 us at 512 rows on the H100, arithmetic and not
// bytes.
template <typename T>
__global__ void parts_copy_kernel(CopyJobs<T> jobs, int D, bool vec) {
  const int j = blockIdx.y;
  const T* s = jobs.src[j] + (size_t)blockIdx.x * jobs.lds[j];
  T* d = jobs.dst[j] + (size_t)blockIdx.x * D;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int c = threadIdx.x; c < D / V; c += blockDim.x)
      reinterpret_cast<uint4*>(d)[c] = reinterpret_cast<const uint4*>(s)[c];
  } else {
    for (int c = threadIdx.x; c < D; c += blockDim.x) d[c] = s[c];
  }
}

template <typename T>
cudaError_t copy_rows(const CopyJobs<T>& jobs, int M, int D,
                      cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  bool vec = D % V == 0;
  for (int j = 0; j < jobs.n; ++j)
    vec = vec && jobs.lds[j] % V == 0 &&
          reinterpret_cast<uintptr_t>(jobs.src[j]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(jobs.dst[j]) % 16 == 0;
  return launch_kernel<false>(parts_copy_kernel<T>, dim3(M, jobs.n), 128, 0,
                              s, jobs, D, vec);
}

// window.cuh's window_layer with the parts of ``parts`` only
template <typename T>
cudaError_t window_layer_parts(const WinLayer<T>& a, int parts,
                               cudaStream_t s) {
  const int M = a.B * a.W, D = a.D, F = a.F;
  const int Dh = D / a.H;
  T* n = a.scratch;                    // [M, D]   n0, n1, then n2
  T* qkv = n + (size_t)M * D;          // [M, 3D]
  T* ctx = qkv + (size_t)M * 3 * D;    // [M, D]   self (or q), then cross
  T* x1 = ctx + (size_t)M * D;         // [M, D]
  T* q2 = x1 + (size_t)M * D;          // [M, D]
  T* x2 = q2 + (size_t)M * D;          // [M, D]
  T* f = x2 + (size_t)M * D;           // [M, F]
  const bool norm = parts & WP_NORM;
  // the last sublayer on writes the output
  const int last = (parts & WP_FFN)     ? WP_FFN
                   : (parts & WP_CROSS) ? WP_CROSS
                   : (parts & WP_PROJ)  ? WP_PROJ
                                        : 0;
  const T* cur = a.x;

  const T* n0 = a.x;
  if (norm) {
    BFC_TRY(refnorm<T>(a.x, a.s0, a.b0, n, M, D, s));
    n0 = n;
  }
  if (parts & WP_PROJ) {
    BFC_TRY(product<T>(n0, a.wqkv, a.bqkv, nullptr, qkv, M, 3 * D, D, false,
                       s));
    if (parts & WP_SELF) {
      BFC_TRY(attention2<T>(qkv, 3 * D, KeySrc<T>{a.kc, a.vc, D, D, a.Lc},
                            KeySrc<T>{qkv + D, qkv + 2 * D, 3 * D, 3 * D, a.W},
                            a.tgt, a.tgt_sb, a.tgt_sq, ctx, D, a.B, a.H, a.W,
                            Dh, s,
                            KvDst<T>{a.k_dst, a.v_dst, a.starts, a.Ld, D}));
    } else {
      // x += q @ Wo + bo: q into ctx, the fresh K/V out, by one copy
      BFC_TRY(copy_rows<T>(
          CopyJobs<T>{{qkv, qkv + D, qkv + 2 * D}, {3 * D, 3 * D, 3 * D},
                      {ctx, a.k_dst, a.v_dst}, 3},
          M, D, s));
    }
    T* x1o = last == WP_PROJ ? a.out : x1;
    BFC_TRY(product<T>(ctx, a.wo, a.bo, cur, x1o, M, D, D, false, s));
    cur = x1o;
  } else {
    // k_new = v_new = n0; with no sublayer after, out = x in the same launch
    CopyJobs<T> jobs{{n0, n0, a.x}, {D, D, D}, {a.k_dst, a.v_dst, a.out}, 2};
    if (last == 0) jobs.n = 3;
    BFC_TRY(copy_rows<T>(jobs, M, D, s));
  }
  if (parts & WP_CROSS) {
    const T* n1 = cur;
    if (norm) {
      BFC_TRY(refnorm<T>(cur, a.s1, a.b1, n, M, D, s));
      n1 = n;
    }
    BFC_TRY(product<T>(n1, a.wq2, a.bq2, nullptr, q2, M, D, D, false, s));
    BFC_TRY(attention<T>(q2, D, a.k2, D, a.v2, D, a.src, a.src_sb, a.src_sq,
                         ctx, D, a.B, a.H, a.W, a.R, Dh, s));
    T* x2o = last == WP_CROSS ? a.out : x2;
    BFC_TRY(product<T>(ctx, a.wo2, a.bo2, cur, x2o, M, D, D, false, s));
    cur = x2o;
  }
  if (parts & WP_FFN) {
    const T* n2 = cur;
    if (norm) {
      BFC_TRY(refnorm<T>(cur, a.s2, a.b2, n, M, D, s));
      n2 = n;
    }
    BFC_TRY(product<T>(n2, a.w1, a.bf1, nullptr, f, M, F, D, true, s));
    BFC_TRY(product<T>(f, a.w2, a.bf2, cur, a.out, M, D, F, false, s));
  }
  return cudaSuccess;
}

// window.cuh's window_layer with both attentions on hb_attention
template <typename T>
cudaError_t window_layer_hb(const WinLayer<T>& a, cudaStream_t s) {
  const int M = a.B * a.W, D = a.D, F = a.F;
  const int Dh = D / a.H;
  T* n = a.scratch;
  T* qkv = n + (size_t)M * D;
  T* ctx = qkv + (size_t)M * 3 * D;
  T* x1 = ctx + (size_t)M * D;
  T* q2 = x1 + (size_t)M * D;
  T* x2 = q2 + (size_t)M * D;
  T* f = x2 + (size_t)M * D;

  BFC_TRY(refnorm<T>(a.x, a.s0, a.b0, n, M, D, s));
  BFC_TRY(product<T>(n, a.wqkv, a.bqkv, nullptr, qkv, M, 3 * D, D, false, s));
  BFC_TRY(hb_attention<T>(qkv, 3 * D, KeySrc<T>{a.kc, a.vc, D, D, a.Lc},
                          KeySrc<T>{qkv + D, qkv + 2 * D, 3 * D, 3 * D, a.W},
                          a.tgt, a.tgt_sb, a.tgt_sq, ctx, D, a.B, a.H, a.W,
                          Dh, s,
                          KvDst<T>{a.k_dst, a.v_dst, a.starts, a.Ld, D}));
  BFC_TRY(product<T>(ctx, a.wo, a.bo, a.x, x1, M, D, D, false, s));
  BFC_TRY(refnorm<T>(x1, a.s1, a.b1, n, M, D, s));
  BFC_TRY(product<T>(n, a.wq2, a.bq2, nullptr, q2, M, D, D, false, s));
  BFC_TRY(hb_attention<T>(q2, D, KeySrc<T>{a.k2, a.v2, D, D, a.R},
                          KeySrc<T>{nullptr, nullptr, 0, 0, 0}, a.src,
                          a.src_sb, a.src_sq, ctx, D, a.B, a.H, a.W, Dh, s));
  BFC_TRY(product<T>(ctx, a.wo2, a.bo2, x1, x2, M, D, D, false, s));
  BFC_TRY(refnorm<T>(x2, a.s2, a.b2, n, M, D, s));
  BFC_TRY(product<T>(n, a.w1, a.bf1, nullptr, f, M, F, D, true, s));
  return product<T>(f, a.w2, a.bf2, x2, a.out, M, D, F, false, s);
}

template <typename T>
WinLayer<T> win_layer_of(const BfcWindowPartsArgs& a) {
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
  return w;
}

// -1: run; else the entry's return code
inline int check_args(int device, const BfcWindowPartsArgs* a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->H <= 0 || a->D % a->H != 0 || a->R <= 0 || a->L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B <= 0 || a->W <= 0) return 0;
  return -1;
}

}  // namespace bfc

extern "C" int bfc_window_parts_args_size() {
  return static_cast<int>(sizeof(BfcWindowPartsArgs));
}

// scratch elements (compute dtype) for one launch of either entry
extern "C" long long bfc_window_parts_scratch(int B, int W, int D, int F) {
  return bfc::window_layer_scratch((long long)B * W, D, F);
}

// shared memory of one hb_attention block (ops/window_parts.py checks it)
extern "C" long long bfc_window_hb_smem(int Lk, int D, int H) {
  return static_cast<long long>(bfc::hb_smem(Lk, D, H));
}

extern "C" int bfc_window_layer_parts(int dtype, int device,
                                      const BfcWindowPartsArgs* a, int parts,
                                      void* stream) {
  const int rc = bfc::check_args(device, a);
  if (rc >= 0) return rc;
  if (parts < 0 || parts > bfc::WP_ALL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(
        bfc::window_layer_parts<float>(bfc::win_layer_of<float>(*a), parts, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(bfc::window_layer_parts<__nv_bfloat16>(
        bfc::win_layer_of<__nv_bfloat16>(*a), parts, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bfc_window_layer_hb(int dtype, int device,
                                   const BfcWindowPartsArgs* a, void* stream) {
  const int rc = bfc::check_args(device, a);
  if (rc >= 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(
        bfc::window_layer_hb<float>(bfc::win_layer_of<float>(*a), s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(bfc::window_layer_hb<__nv_bfloat16>(
        bfc::win_layer_of<__nv_bfloat16>(*a), s));
  return static_cast<int>(cudaErrorInvalidValue);
}
