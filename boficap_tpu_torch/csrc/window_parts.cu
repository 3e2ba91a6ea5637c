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
// One launch plan serves both (window_layer_parts below), with the
// attention block a template parameter: #8's (attention.cuh) for
// bfc_window_layer_parts, hb_attention.cuh's for bfc_window_layer_hb (one
// max a query row across every head, each head's own sum).  Against #8's
// eleven launches (window.cuh):
//
//  - Each RefLayerNorm keeps its own launch (refnorm.cuh).  Folded into
//    the launch of the product that reads it, the norm cost the H100 more
//    than the launch it saved (PERF.md).
//  - No copy launch while ``proj`` is on: without ``self`` the qkv
//    product's epilogue (epilogue.cuh SplitEpi) writes q into ctx and k, v
//    into k_new, v_new.  Without ``proj``, one launch writes n0 (the norm,
//    parts_refnorm_kernel; or x, the copy) into k_new and v_new, and x into
//    out when no sublayer follows.
//  - At bf16 every launch after the first is a link of a programmatic
//    dependent launch chain (common.cuh launch_kernel), as #5's: it starts
//    while its predecessor drains, fetches its first W tiles, and reads
//    activations after griddepcontrol.wait.  The first launch is plain (a
//    product fetches W before any wait, and whatever precedes the call on
//    the stream may write W).  At float32 the launches are plain: chained,
//    the layer ran slower on the H100 (PERF.md).
//  - The bf16 products take a tile from N alone (wgmma_gemm.cuh
//    parts_tile_n): BM = 64; BN = 64 for 3D, 128 for d_ff, 32 for D, so
//    each of the six products at B = 64, W = 8 (512 rows) runs at least
//    128 blocks, where #8's ran 64 for each N = 512 product.  The float32
//    products are #8's (ffma_gemm.cuh tile_for).  An output's bits do not
//    depend on the tile: the full layer is #8's, bitwise, at both dtypes;
//    rows stay bitwise batch-independent.
//
// Launches by variant (ops/window_parts.py kernel_launches mirrors this):
// full 11 (3 refnorm, 6 products, 2 attention), no_self 10, no_cross 7,
// no_ffn 8, no_norm 8, proj_only 2 (the products), empty 1 (the copy);
// #11 11 (3 refnorm, 6 products, 2 hb attention).
//
// Bound on the H100 at B = 64, W = 8, L = 20, R = 36, D = 512, d_ff = 2048:
// #8's (window_layer.cu): ~3.8 GFLOP against ~16 MB (bf16) / ~32 MB
// (float32); no variant does more useful work.
#include <type_traits>

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

// ``proj`` off, ``norm`` on: n0 = refnorm(x) [rows, d] into y0 and y1 (k_new,
// v_new), one warp a row as refnorm_kernel, and x into xo where it is not
// null (no sublayer follows)
template <typename T>
__global__ void __launch_bounds__(NORM_WARPS * 32)
    parts_refnorm_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y0,
                         T* __restrict__ y1, T* __restrict__ xo, int rows,
                         int d) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NORM_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t o = (size_t)row * d;
  refnorm_row<T, 16>(x + o, scale, bias, d, lane, [] {},
                     [&](int c, float v) {
                       const T t = Cvt<T>::from_f(v);
                       y0[o + c] = t;
                       y1[o + c] = t;
                     });
  if (xo != nullptr)
    for (int c = lane; c < d; c += 32) xo[o + c] = x[o + c];
}

// A [M, K] @ W [K, N] handed to epi on the tensor cores, on
// tc::parts_tile_n's tile
template <bool CH, class Epi>
cudaError_t prod_tc(const __nv_bfloat16* A, const __nv_bfloat16* W,
                    const Epi& epi, int M, int N, int K, cudaStream_t s) {
  switch (tc::parts_tile_n(N)) {
    case 32: return tc::run_parts<32, CH>(A, W, epi, M, N, K, s);
    case 64: return tc::run_parts<64, CH>(A, W, epi, M, N, K, s);
    default: return tc::run_parts<128, CH>(A, W, epi, M, N, K, s);
  }
}

// C = epilogue(A @ W + bias) [M, N]: FFMA at float32 (ffma::gemm, #8's
// product), the tensor cores at bf16 (prod_tc)
template <typename T, bool CH>
cudaError_t prod(const T* A, const T* W, const T* bias, const T* res, T* C,
                 int M, int N, int K, bool relu, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    return ffma::gemm(A, W, bias, res, C, M, N, K, relu, s);
  } else {
    if (M <= 0) return cudaSuccess;
    if (!tc::aligned(bias, 4) || !tc::aligned(res, 4) || !tc::aligned(C, 4))
      return cudaErrorInvalidValue;
    return prod_tc<CH>(A, W, LinearEpi<T>{bias, res, C, M, N, relu ? 1 : 0, 1},
                       M, N, K, s);
  }
}

// the qkv product [M, 3D] written as q, k, v [M, D] each (SplitEpi)
template <typename T, bool CH>
cudaError_t prod_split(const T* A, const T* W, const T* bias, T* q, T* k,
                       T* v, int M, int D, cudaStream_t s) {
  if (M <= 0) return cudaSuccess;
  const SplitEpi<T> epi{bias, {q, k, v}, M, D};
  if constexpr (sizeof(T) == 4) {
    return ffma::run(ffma::tile_for(M, 3 * D), A, W, epi, M, 3 * D, D,
                     (3 * D) % 4 == 0 && ffma::aligned16(W), s);
  } else {
    if (!tc::aligned(bias, 4) || !tc::aligned(q, 4) || !tc::aligned(k, 4) ||
        !tc::aligned(v, 4))
      return cudaErrorInvalidValue;
    return prod_tc<CH>(A, W, epi, M, 3 * D, D, s);
  }
}

// #8's attention block (attention.cuh), the self-attention also writing
// the fresh K/V
struct LayerAttention {
  template <typename T, bool CH>
  static cudaError_t self(const WinLayer<T>& a, const T* qkv, T* ctx,
                          cudaStream_t s) {
    const int D = a.D;
    return attention2<T, CH>(
        qkv, 3 * D, KeySrc<T>{a.kc, a.vc, D, D, a.Lc},
        KeySrc<T>{qkv + D, qkv + 2 * D, 3 * D, 3 * D, a.W}, a.tgt, a.tgt_sb,
        a.tgt_sq, ctx, D, a.B, a.H, a.W, D / a.H, s,
        KvDst<T>{a.k_dst, a.v_dst, a.starts, a.Ld, D});
  }
  template <typename T, bool CH>
  static cudaError_t cross(const WinLayer<T>& a, const T* q2, T* ctx,
                           cudaStream_t s) {
    const int D = a.D;
    return attention<T, CH>(q2, D, a.k2, D, a.v2, D, a.src, a.src_sb,
                            a.src_sq, ctx, D, a.B, a.H, a.W, a.R, D / a.H, s);
  }
};

// hb_attention.cuh's block: one max a query row across every head
struct HbAttention {
  template <typename T, bool CH>
  static cudaError_t self(const WinLayer<T>& a, const T* qkv, T* ctx,
                          cudaStream_t s) {
    const int D = a.D;
    return hb_attention<T, CH>(
        qkv, 3 * D, KeySrc<T>{a.kc, a.vc, D, D, a.Lc},
        KeySrc<T>{qkv + D, qkv + 2 * D, 3 * D, 3 * D, a.W}, a.tgt, a.tgt_sb,
        a.tgt_sq, ctx, D, a.B, a.H, a.W, D / a.H, s,
        KvDst<T>{a.k_dst, a.v_dst, a.starts, a.Ld, D});
  }
  template <typename T, bool CH>
  static cudaError_t cross(const WinLayer<T>& a, const T* q2, T* ctx,
                           cudaStream_t s) {
    const int D = a.D;
    return hb_attention<T, CH>(q2, D, KeySrc<T>{a.k2, a.v2, D, D, a.R},
                               KeySrc<T>{nullptr, nullptr, 0, 0, 0}, a.src,
                               a.src_sb, a.src_sq, ctx, D, a.B, a.H, a.W,
                               D / a.H, s);
  }
};

// scratch elements (compute dtype) of one call: n (the normalised rows),
// qkv [M, 3D], ctx, x1, q2, x2 [M, D] each, f [M, F]
inline long long parts_scratch(long long M, long long D, long long F) {
  return M * (8 * D + F);
}

// The layer with the parts of ``parts`` only, its attentions on Att; a
// switch drops its part's launches and nothing else, as _abl_kernel
// (:56-141) drops its code.  The last sublayer on writes the output.  At
// bf16 every launch after the first is a link of the chain (CH).
template <typename T, class Att>
cudaError_t window_layer_parts(const WinLayer<T>& a, int parts,
                               cudaStream_t s) {
  constexpr bool CH = sizeof(T) == 2;
  const int M = a.B * a.W, D = a.D, F = a.F;
  T* n = a.scratch;                    // [M, D]   n0, n1, then n2
  T* qkv = n + (size_t)M * D;          // [M, 3D]
  T* ctx = qkv + (size_t)M * 3 * D;    // [M, D]   self (or q), then cross
  T* x1 = ctx + (size_t)M * D;         // [M, D]
  T* q2 = x1 + (size_t)M * D;          // [M, D]
  T* x2 = q2 + (size_t)M * D;          // [M, D]
  T* f = x2 + (size_t)M * D;           // [M, F]
  const bool norm = parts & WP_NORM;
  const int last = (parts & WP_FFN)     ? WP_FFN
                   : (parts & WP_CROSS) ? WP_CROSS
                   : (parts & WP_PROJ)  ? WP_PROJ
                                        : 0;
  const T* cur = a.x;

  if (parts & WP_PROJ) {
    // the layer's first launch (plain): the norm, or the qkv product
    const T* n0 = a.x;
    if (norm) {
      BFC_TRY((refnorm<T, false>(a.x, a.s0, a.b0, n, M, D, s)));
      n0 = n;
    }
    auto qkv_prod = [&](auto ch) {
      constexpr bool C = decltype(ch)::value;
      // without self: q into ctx and the fresh K/V out, by the epilogue
      return (parts & WP_SELF)
                 ? prod<T, C>(n0, a.wqkv, a.bqkv, nullptr, qkv, M, 3 * D, D,
                              false, s)
                 : prod_split<T, C>(n0, a.wqkv, a.bqkv, ctx, a.k_dst,
                                    a.v_dst, M, D, s);
    };
    BFC_TRY(norm ? qkv_prod(std::bool_constant<CH>{})
                 : qkv_prod(std::false_type{}));
    if (parts & WP_SELF)
      BFC_TRY((Att::template self<T, CH>(a, qkv, ctx, s)));
    T* x1o = last == WP_PROJ ? a.out : x1;
    BFC_TRY((prod<T, CH>(ctx, a.wo, a.bo, cur, x1o, M, D, D, false, s)));
    cur = x1o;
  } else if (norm) {
    // k_new = v_new = refnorm(x); out = x with no sublayer after
    if (M > 0)
      BFC_TRY(launch_kernel<false>(
          parts_refnorm_kernel<T>, (M + NORM_WARPS - 1) / NORM_WARPS,
          NORM_WARPS * 32, 0, s, a.x, a.s0, a.b0, a.k_dst, a.v_dst,
          last == 0 ? a.out : nullptr, M, D));
  } else {
    // k_new = v_new = x; out = x in the same launch with no sublayer after
    CopyJobs<T> jobs{{a.x, a.x, a.x}, {D, D, D}, {a.k_dst, a.v_dst, a.out}, 2};
    if (last == 0) jobs.n = 3;
    if (M > 0) BFC_TRY(copy_rows<T>(jobs, M, D, s));
  }
  if (parts & WP_CROSS) {
    const T* n1 = cur;
    if (norm) {
      BFC_TRY((refnorm<T, CH>(cur, a.s1, a.b1, n, M, D, s)));
      n1 = n;
    }
    BFC_TRY((prod<T, CH>(n1, a.wq2, a.bq2, nullptr, q2, M, D, D, false, s)));
    BFC_TRY((Att::template cross<T, CH>(a, q2, ctx, s)));
    T* x2o = last == WP_CROSS ? a.out : x2;
    BFC_TRY((prod<T, CH>(ctx, a.wo2, a.bo2, cur, x2o, M, D, D, false, s)));
    cur = x2o;
  }
  if (parts & WP_FFN) {
    const T* n2 = cur;
    if (norm) {
      BFC_TRY((refnorm<T, CH>(cur, a.s2, a.b2, n, M, D, s)));
      n2 = n;
    }
    BFC_TRY((prod<T, CH>(n2, a.w1, a.bf1, nullptr, f, M, F, D, true, s)));
    BFC_TRY((prod<T, CH>(f, a.w2, a.bf2, cur, a.out, M, D, F, false, s)));
  }
  return cudaSuccess;
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
  return bfc::parts_scratch((long long)B * W, D, F);
}

// shared memory of one hb_attention block at dtype (ops/window_parts.py
// checks it)
extern "C" long long bfc_window_hb_smem(int Lk, int D, int H, int dtype) {
  return static_cast<long long>(
      bfc::hb_smem(Lk, D, H, dtype == BFC_DTYPE_F32 ? 4 : 2));
}

// the tile (*bm, *bn) and blocks of an M x N product of the layer at
// dtype (ops/window_parts.py product_tile mirrors it)
extern "C" int bfc_window_parts_tile(int dtype, int M,
                                     int N, int* bm, int* bn) {
  if (dtype == BFC_DTYPE_BF16) {
    *bm = 64;
    *bn = bfc::tc::parts_tile_n(N);
  } else {
    bfc::ffma::tile_shape(bfc::ffma::tile_for(M, N), bm, bn);
  }
  return ((M + *bm - 1) / *bm) * ((N + *bn - 1) / *bn);
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
        bfc::window_layer_parts<float, bfc::LayerAttention>(
            bfc::win_layer_of<float>(*a), parts, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(
        bfc::window_layer_parts<__nv_bfloat16, bfc::LayerAttention>(
            bfc::win_layer_of<__nv_bfloat16>(*a), parts, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// #10's full plan with both attentions on the hb block
extern "C" int bfc_window_layer_hb(int dtype, int device,
                                   const BfcWindowPartsArgs* a,
                                   void* stream) {
  const int rc = bfc::check_args(device, a);
  if (rc >= 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(bfc::window_layer_parts<float, bfc::HbAttention>(
        bfc::win_layer_of<float>(*a), bfc::WP_ALL, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(
        bfc::window_layer_parts<__nv_bfloat16, bfc::HbAttention>(
            bfc::win_layer_of<__nv_bfloat16>(*a), bfc::WP_ALL, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
