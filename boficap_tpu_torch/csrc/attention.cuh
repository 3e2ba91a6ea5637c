// Building block: masked multi-head attention core, the score -> mask ->
// softmax -> context step inside the TPU encoder-layer and decoder-layer
// kernels (boficap_tpu/ops/pallas_decoder_layer.py::_mha :75), per sample
// instead of the TPU's block-diagonal batching.
//
//   s = (q . k) / sqrt(Dh);  s = mask ? s : -1e9;  p = T(softmax_f32(s))
//   ctx = T(sum_j p_j v_j)
//
// Every operand is a strided [B, H, rows, Dh] view (HeadView): the head's
// columns h*Dh .. h*Dh+Dh-1 of row-major [rows, ld] activations for the
// layer kernels, any strides for the attention core of attention_core.cu.
// The mask is bool [B, Lq, Lk] addressed as b * mask_sb + i * mask_sq + j,
// so a [B, Lk] padding mask is passed with mask_sq = 0.  A fully masked row
// has every real score at -1e9 and so comes out uniform over its own
// sample's Lk keys, as on the TPU.
//
// The keys come from up to two sources, read in order: key j < a.rows is
// row j of source a, the rest are source c's rows.  The windowed decoder
// layers (pallas_decoder_layer.py::_win_kernel :283) attend over a K/V cache
// followed by the window's fresh K/V; reading both in place saves copying
// them into one [B, L + W, D] buffer per layer.  Those layers also hand the
// attention a destination for the fresh K/V (KvDst): once every key of
// (sample, head) has been read, head h's columns of source c's rows are
// copied into it, so the narrow SA round updates its cache in place with no
// launch of its own, and every key was read before any is overwritten.
//
// Four paths behind launch_attention, chosen by attention_path(Lq, Lk,
// dtype), with the same arithmetic contract:
//
//  row   Lq <= LQ_ROW, Lk <= row_key_max, both dtypes (the decode steps:
//        one query row).  One warp a (sample, head), ROW_WARPS warps a
//        block, no shared memory, no block barrier.  K and V are read
//        straight from device memory in 16-byte chunks, G lanes a key row
//        (a bf16 Dh = 64 row is 8 lanes, 4 keys an instruction); every K
//        and V chunk of up to ROW_KEYS keys, the query row and its mask are
//        asked for at once, so a call waits on memory once at the callers'
//        key counts up to ROW_KEYS.  A score is a G-lane shuffle sum; the
//        whole score row stays in registers (SREG a lane: KEY_MAX / 32 up
//        to KEY_MAX keys, ROW_KEY_MAX / 32 past it at bf16), so the
//        softmax is exact in two passes (max, then exp and sum); p is
//        rounded to T after normalisation, the context summed over the
//        keys in registers and written as T.  (On the card the tile path matched it
//        at one bf16 query row and beat it from two, so LQ_ROW is 1; a
//        forced row path takes any Lq, one row after another over the same
//        registers.)
//  tile  otherwise at bf16 (the layer and stack attentions).  One block a
//        (sample, head): Q, K and V staged as bf16 by 16-byte cp.async into
//        rows padded by 16 bytes (ldmatrix without bank conflicts), K and V
//        of both sources into one tile, the mask bits read meanwhile.  One
//        warp a 16 query rows: S = Q K^T on mma.sync.m16n8k16 (bf16 in,
//        float32 sums), the scale and the -1e9 fill, the row softmax by quad
//        shuffles over the accumulator fragments, then P = bf16(p / sum)
//        straight from the accumulators (the C layout of two n8 tiles is the
//        A layout of one k16 step) into P V on mma.sync, V read with
//        ldmatrix.trans.  Tiles of 20-36 rows are below wgmma's 64-row
//        minimum.  The quotients are a reciprocal and an fma correction,
//        p / sum correctly rounded in the normal range: IEEE divisions
//        were a large share of the block's time on the card (PERF.md).
//  ffma  otherwise at float32 up to KEY_MAX keys: the first port's block,
//        one fmaf chain over d a score and one over the keys a context
//        element, K and V staged as float32 (the float32 outputs of the
//        layer kernels stay bitwise those of that block).  Forced, it takes
//        any Lk that fits.
//  ffma_long  float32 past KEY_MAX keys (attention_ffma_long_kernel): the
//        ffma block's arithmetic, in its order, tiled for occupancy.  One
//        block a (sample, head, FL_ROWS query rows); K, then V, stream
//        through a two-chunk ring of FL_KEYS keys by cp.async; the tile's
//        score rows stay in shared memory from S = Q K^T to P V; both
//        products are register-tiled, 4 query rows by FL_KEYS / 32 keys
//        (or DC head columns) a thread.  Its outputs are bitwise the ffma
//        block's.
//
// Padded key columns (up to the n8 / k16 tile, or the lanes past Lk) get
// -inf, not -1e9, so they add exactly 0 to the softmax.  Nothing depends on
// B: rows are bitwise batch-independent.  Up to KEY_MAX keys no online
// rescaling: a row's scores are normalised, rounded, then multiplied by V,
// as the TPU kernel does (pallas_attention.py:49-52).  Past KEY_MAX keys
// the keys come from one source with no KvDst (the attention core, the
// encoder layers' self-attention over the regions and every
// cross-attention over the memory; a 14 x 14 image grid is 196 regions):
// one query row at bf16 takes the row path up to ROW_KEY_MAX keys; the
// rest take the ffma_long block (float32) or the tile path, which goes
// over the keys in chunks of KEY_MAX twice (attention_tile_long_kernel,
// one warp a query tile, up to TILE_LONG_WARPS a block): a running max and
// sum a query row first, then p normalised, rounded to bf16 and multiplied by V, in the
// short path's order.  Every path needs Dh <= DH_MAX and
// at most SMEM_MAX bytes of shared memory a block (the wrappers raise
// above them).  16-byte loads need 16-byte aligned bases,
// strides and head width (the attention-core wrapper requires them); the
// layer kernels, which take any float32 width, read element by element in
// the same lane layout where they are not (ffma_long copies 4-byte
// elements and needs no alignment).
//
// Bound on the H100: bytes at BoFiCap's region counts (L <= 36, Dh = 64:
// ~4 * L * L * Dh flops per (sample, head), a few flops per byte of Q/K/V
// read; every path reads each slice once).  Operations at 196-211 keys in
// float32 (67 TFLOP/s of FFMA): ffma_long keeps 32 warps an SM busy on
// register-tiled products instead of the ffma block's 4 on serial chains.
#pragma once

#include "common.cuh"

namespace bfc {

constexpr int ATT_WARPS = 4;       // ffma path: warps a block
constexpr int ROW_WARPS = 4;       // row path: (sample, head) warps a block
constexpr int ROW_KEYS = 40;       // row path: keys one batch of loads holds,
constexpr int ROW_BATCH = 20;      // at most this many K (and V) chunks a lane
constexpr int ROW_KEYS_WIDE = 36;  // ... past KEY_MAX keys (bf16 only)
constexpr int TILE_WARPS = 4;      // tile path: at most, one a 16 query rows
constexpr int TILE_LONG_WARPS = 16;  // ... past KEY_MAX keys, past TILE_WARPS
constexpr int LQ_ROW = 1;          // row path up to this many query rows
constexpr int KEY_MAX = 128;       // keys a score row holds in registers
constexpr int ROW_KEY_MAX = 256;   // ... on the row path at bf16, one source
constexpr int FL_WARPS = 8;        // ffma_long: warps a block,
constexpr int FL_ROWS = 32;        // query rows a block (/ FL_WARPS a warp)
constexpr int FL_KEYS = 32;        // keys a K or V chunk (32 a lane)
constexpr int DH_MAX = 128;        // head width
constexpr int SMEM_MAX = 232448;   // shared memory a block may use (227 KB)
constexpr float MASK_FILL = -1e9f;

enum AttentionPath {
  kPathRow = 0, kPathTile = 1, kPathFfma = 2, kPathFfmaLong = 3
};

// keys the row path takes at dtype (BFC_DTYPE_*): the wide score rows at
// bf16 only (at float32 ffma_long is the faster of the two past KEY_MAX:
// PERF.md); ops/decoder_layer.py row_key_max mirrors it
inline int row_key_max(int dtype) {
  return dtype == BFC_DTYPE_BF16 ? ROW_KEY_MAX : KEY_MAX;
}

// the path of an Lq x Lk attention at dtype (BFC_DTYPE_*), -1 without
// keys: the row path up to LQ_ROW query rows and row_key_max keys, else
// tile (bf16), or ffma up to KEY_MAX keys and ffma_long past them
// (float32); ops/attention.py attention_path mirrors it
inline int attention_path(int Lq, int Lk, int dtype) {
  if (Lk < 1) return -1;
  if (Lq <= LQ_ROW && Lk <= row_key_max(dtype)) return kPathRow;
  if (dtype == BFC_DTYPE_BF16) return kPathTile;
  return Lk > KEY_MAX ? kPathFfmaLong : kPathFfma;
}

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

// the factor of scale_score: 1/sqrt(Dh) in float32 to multiply by; for
// kDivSqrt sqrt(Dh) to divide by, negated where sqrt(Dh) is a power of two
// and so 1/sqrt(Dh) exact (Dh = 64): then a product gives the quotient's
// bits, for a division's cost
template <Scale S>
__device__ __forceinline__ float score_factor(int Dh) {
  if (S == Scale::kMulInvSqrt)
    return static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  const float f = sqrtf(static_cast<float>(Dh));
  int e;
  return frexpf(f, &e) == 0.5f ? -1.f / f : f;
}

template <Scale S>
__device__ __forceinline__ float scale_score(float s, float factor) {
  if (S == Scale::kMulInvSqrt) return s * factor;
  return factor < 0.f ? s * -factor : s / factor;
}

template <typename T>
__device__ __forceinline__ int dst_start(KvDst<T> dst, int b,
                                         int rows_c) {
  return dst.starts == nullptr ? 0
                               : min(max(dst.starts[b], 0), dst.Ld - rows_c);
}

namespace att {
namespace {

constexpr unsigned FULL = 0xffffffffu;

// word i (static after unrolling) of a 16-byte chunk
__device__ __forceinline__ uint32_t word(uint4 u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// the bits of one element of T, and back
template <typename T>
__device__ __forceinline__ uint32_t bits_of(T x) {
  if constexpr (sizeof(T) == 4) return __float_as_uint(x);
  else return __bfloat16_as_ushort(x);
}

// n (<= 16 / sizeof(T)) elements of T at p as one raw 16-byte chunk, zero
// past n: one 16-byte load where vec (aligned, n whole), else element loads
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = i < n ? bits_of(p[i]) : 0u;
    } else {
      w[i] = (2 * i < n ? bits_of(p[2 * i]) : 0u) |
             ((2 * i + 1 < n ? bits_of(p[2 * i + 1]) : 0u) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, uint4 u, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = word(u, i);
    if constexpr (sizeof(T) == 4) {
      if (i < n) p[i] = __uint_as_float(w);
    } else {
      if (2 * i < n) p[2 * i] = __ushort_as_bfloat16(w & 0xffffu);
      if (2 * i + 1 < n) p[2 * i + 1] = __ushort_as_bfloat16(w >> 16);
    }
  }
}

template <typename T>
__device__ __forceinline__ void to_floats(uint4 u,
                                          float (&f)[16 / sizeof(T)]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = word(u, i);
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w);
    } else {   // bf16 -> float32 is exact: the bits move up 16 places
      f[2 * i] = __uint_as_float(w << 16);
      f[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 from_floats(const float (&f)[16 / sizeof(T)]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      w[i] = bits_of(Cvt<T>::from_f(f[2 * i])) |
             (bits_of(Cvt<T>::from_f(f[2 * i + 1])) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// head h's columns of source c's rows of sample b to dst, by 16-byte chunks
// over the ``nthr`` threads from ``tid``
template <typename T>
__device__ __forceinline__ void copy_fresh(HeadView<const T> kc,
                                           HeadView<const T> vc,
                                           int rows_c, KvDst<T> dst,
                                           int b, int h, int Dh, bool vec,
                                           int tid, int nthr) {
  constexpr int N = 16 / sizeof(T);
  const int nch = (Dh + N - 1) / N;
  const int s0 = dst_start(dst, b, rows_c);
  for (int e = tid; e < rows_c * nch; e += nthr) {
    const int j = e / nch, d = (e % nch) * N, n = min(N, Dh - d);
    const size_t o = ((size_t)b * dst.Ld + s0 + j) * dst.ld + (size_t)h * Dh + d;
    store_chunk(dst.k + o, load_chunk(&kc.at(b, h, j, d), n, vec), n, vec);
    store_chunk(dst.v + o, load_chunk(&vc.at(b, h, j, d), n, vec), n, vec);
  }
}

// ---- row path --------------------------------------------------------------

// G lanes a key row (a power of two, >= the row's 16-byte chunks), 32 / G
// keys an instruction.  Iteration ``it`` reads key it * (32 / G) + lane / G;
// its score ends in lane (lane / G) * G + it % G, register it / G (written
// and read by predicated selects over the SREG registers, so the batches
// loop at run time and nothing goes to local memory).  A batch is NB
// iterations: NB chunks of K and NB of V a lane, asked for together before
// any is used.  At the callers' key counts (<= ROW_KEYS) one batch holds
// every key: a call then waits on memory once, with the first query row
// and its mask, and every further query row reuses the registers.  SREG:
// score registers a lane, Lk <= 32 SREG: KEY_MAX / 32, or ROW_KEY_MAX / 32
// at bf16 (wide rows: one query row over a 14 x 14 grid), in batches of
// ROW_KEYS_WIDE keys, the first V batch asked for after the softmax: so
// the wide kernel holds no K and V batch at once, and at Dh = 64 it fits
// its registers with no spill (40 keys a batch, or the V batch ahead,
// spilled; PERF.md).
template <typename T, Scale S, int G, int SREG, bool CH>
__global__ void __launch_bounds__(ROW_WARPS * 32)
    attention_row_kernel(HeadView<const T> q, HeadView<const T> ka,
                         HeadView<const T> va, int rows_a, HeadView<const T> kc,
                         HeadView<const T> vc, int rows_c,
                         const uint8_t* __restrict__ mask, long long mask_sb,
                         long long mask_sq, HeadView<T> out, int BH, int H,
                         int Lq, int Dh, KvDst<T> dst, bool vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int KPI = 32 / G;
  constexpr bool WIDE = SREG > KEY_MAX / 32;
  static_assert(!WIDE || sizeof(T) == 2, "wide score rows at bf16 only");
  constexpr int BK = WIDE ? ROW_KEYS_WIDE : ROW_KEYS;
  constexpr int NB = BK / KPI < ROW_BATCH ? BK / KPI : ROW_BATCH;
  const int w = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  grid_wait<CH>();   // q, k, v: a predecessor's outputs (common.cuh)
  if (w >= BH) return;
  const int b = w / H, h = w % H;
  const int lane = threadIdx.x % 32, grp = lane / G, lig = lane % G;
  const int d0 = lig * N;
  const int n = max(0, min(N, Dh - d0));          // this lane's elements
  const int Lk = rows_a + rows_c;
  const int its = (Lk + KPI - 1) / KPI;
  const bool multi = its > NB;       // more than one batch: reloaded a row
  const float factor = score_factor<S>(Dh);
  // (views by value throughout: taking a kernel parameter's address would
  // copy it to local memory)
  auto load = [=](HeadView<const T> a, HeadView<const T> c, int t0,
                  uint4 (&raw)[NB]) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int j = (t0 + u) * KPI + grp;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < Lk && n > 0)
        raw[u] = load_chunk(j < rows_a ? &a.at(b, h, j, d0)
                                       : &c.at(b, h, j - rows_a, d0),
                            n, vec);
    }
  };
  // bit u: key (t0 + u) * KPI + grp is visible to query row i
  auto load_mask = [=](int i, int t0) {
    const uint8_t* mrow = mask + (size_t)b * mask_sb + (size_t)i * mask_sq;
    uint8_t m[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {   // every byte asked for before any is used
      const int j = (t0 + u) * KPI + grp;
      m[u] = j < Lk ? __ldg(mrow + j) : 0;
    }
    uint32_t mb = 0u;
#pragma unroll
    for (int u = 0; u < NB; ++u) mb |= (m[u] ? 1u : 0u) << u;
    return mb;
  };
  auto load_q = [=](int i) {
    return n > 0 ? load_chunk(&q.at(b, h, i, d0), n, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
  };

  uint4 kr[NB], vr[NB];
  load(ka, kc, 0, kr);
  if constexpr (!WIDE) load(va, vc, 0, vr);
  uint4 qraw = load_q(0);
  uint32_t mb = load_mask(0, 0);
  float qf[N], sc[SREG], acc[N];
  // one batch of scores, iterations t0 .. t0 + NB - 1 (t0 = 0 is a
  // constant at the first call: its register indices fold away)
  auto scores = [&](int t0) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int it = t0 + u;
      float kf[N];
      to_floats<T>(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) s = fmaf(qf[e], kf[e], s);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      s = scale_score<S>(s, factor);
      if (!(mb >> u & 1u)) s = MASK_FILL;
      if (it * KPI + grp >= Lk) s = -INFINITY;     // past the keys: adds 0
      const bool mine = lig == it % G;
#pragma unroll
      for (int r = 0; r < SREG; ++r)
        if (mine && r == it / G) sc[r] = s;
    }
  };
  auto context = [&](int t0) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int it = t0 + u;
      float held = sc[0];
#pragma unroll
      for (int r = 1; r < SREG; ++r)
        if (r == it / G) held = sc[r];
      const float p = __shfl_sync(FULL, held, grp * G + it % G);
      float vf[N];
      to_floats<T>(vr[u], vf);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
  };
  for (int i = 0; i < Lq; ++i) {
    if (i > 0) {
      qraw = load_q(i);
      if (multi) load(ka, kc, 0, kr);
      mb = load_mask(i, 0);
    }
    to_floats<T>(qraw, qf);
#pragma unroll
    for (int r = 0; r < SREG; ++r) sc[r] = -INFINITY;
    scores(0);
    for (int t0 = NB; t0 < its; t0 += NB) {
      load(ka, kc, t0, kr);
      mb = load_mask(i, t0);
      scores(t0);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < SREG; ++r) mx = fmaxf(mx, sc[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < SREG; ++r) {
      sc[r] = expf(sc[r] - mx);
      sum += sc[r];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
#pragma unroll
    for (int r = 0; r < SREG; ++r) sc[r] = round_to<T>(sc[r] / sum);

#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
    if (WIDE || (multi && i > 0)) load(va, vc, 0, vr);
    context(0);
    for (int t0 = NB; t0 < its; t0 += NB) {
      load(va, vc, t0, vr);
      context(t0);
    }
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], off);
    if (grp == 0 && n > 0)
      store_chunk(&out.at(b, h, i, d0), from_floats<T>(acc), n, vec);
  }
  grid_launch_dependents<CH>();

  if (dst.k != nullptr) {
    __syncwarp();   // every key of (b, h) has been read
    copy_fresh(kc, vc, rows_c, dst, b, h, Dh, vec, lane, 32);
  }
}

// ---- tile path (bf16) -------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits_of(__float2bfloat16(lo)) | (bits_of(__float2bfloat16(hi)) << 16);
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// row r of view (b, h) (r < rows; zeros past it) into row ``tr`` of a bf16
// tile of row stride ld, by 16-byte chunks: cp.async where vec, else element
// loads; columns past Dh up to round16(Dh) are zero
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* tile, int ld,
                                            int tr, int d,
                                            HeadView<const __nv_bfloat16> v,
                                            int b, int h, int r, bool live,
                                            int Dh, bool vec) {
  __nv_bfloat16* s = tile + (size_t)tr * ld + d;
  if (live && vec && d < Dh) {
    cp_async16(s, &v.at(b, h, r, d));
    return;
  }
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (live && d < Dh) u = load_chunk(&v.at(b, h, r, d), min(8, Dh - d), false);
  *reinterpret_cast<uint4*>(s) = u;
}

// KT: key tiles of 16 (16 * KT >= Lk)
template <Scale S, int KT, bool CH>
__global__ void __launch_bounds__(TILE_WARPS * 32)
    attention_tile_kernel(HeadView<const __nv_bfloat16> q, HeadView<const __nv_bfloat16> ka,
                HeadView<const __nv_bfloat16> va, int rows_a,
                HeadView<const __nv_bfloat16> kc, HeadView<const __nv_bfloat16> vc,
                int rows_c, const uint8_t* __restrict__ mask, long long mask_sb,
                long long mask_sq, HeadView<__nv_bfloat16> out, int H, int Lq,
                int Dh, KvDst<__nv_bfloat16> dst, bool vec) {
  using T = __nv_bfloat16;
  extern __shared__ uint4 smem_tile[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  grid_wait<CH>();   // q, k, v: a predecessor's outputs (common.cuh)
  const int Lk = rows_a + rows_c;
  const int LqP = round16(Lq), DhP = round16(Dh), ld = DhP + 8;
  T* Qs = reinterpret_cast<T*>(smem_tile);    // [LqP][ld]
  T* Ks = Qs + (size_t)LqP * ld;              // [16 KT][ld]
  T* Vs = Ks + (size_t)16 * KT * ld;          // [16 KT][ld]

  const int nch = DhP / 8;
  for (int e = threadIdx.x; e < LqP * nch; e += blockDim.x) {
    const int r = e / nch;
    stage_chunk(Qs, ld, r, (e % nch) * 8, q, b, h, r, r < Lq, Dh, vec);
  }
  // keys: source a, then source c, then zero rows up to 16 KT
  for (int e = threadIdx.x; e < rows_a * nch; e += blockDim.x) {
    const int r = e / nch, d = (e % nch) * 8;
    stage_chunk(Ks, ld, r, d, ka, b, h, r, true, Dh, vec);
    stage_chunk(Vs, ld, r, d, va, b, h, r, true, Dh, vec);
  }
  for (int e = threadIdx.x; e < (16 * KT - rows_a) * nch; e += blockDim.x) {
    const int j = e / nch, d = (e % nch) * 8;
    stage_chunk(Ks, ld, rows_a + j, d, kc, b, h, j, j < rows_c, Dh, vec);
    stage_chunk(Vs, ld, rows_a + j, d, vc, b, h, j, j < rows_c, Dh, vec);
  }
  // this thread's mask bits of a query tile: bit 2 t + e of word hr is key
  // t * 8 + 2 tig + e of query row qt * 16 + g + 8 hr (rows past Lq read
  // row Lq - 1); the first tile's are read while the copies fly
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int nwarps = blockDim.x / 32;
  auto mask_bits = [=](int qt, int hr) {
    const int i = min(qt * 16 + g + 8 * hr, Lq - 1);
    const uint8_t* mr = mask + (size_t)b * mask_sb + (size_t)i * mask_sq;
    uint32_t m = 0u;
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = t * 8 + 2 * tig + e;
        if (j < Lk && mr[j]) m |= 1u << (2 * t + e);
      }
    return m;
  };
  uint32_t mb0 = mask_bits(warp, 0), mb1 = mask_bits(warp, 1);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  grid_launch_dependents<CH>();   // the operands are staged

  if (dst.k != nullptr) {
    // every key of (b, h) is staged: copy the fresh rows out; no other
    // block touches them
    const int s0 = dst_start(dst, b, rows_c);
    const int nch = (Dh + 7) / 8;
    for (int e = threadIdx.x; e < rows_c * nch; e += blockDim.x) {
      const int j = e / nch, d = (e % nch) * 8, n = min(8, Dh - d);
      const size_t o = ((size_t)b * dst.Ld + s0 + j) * dst.ld + (size_t)h * Dh + d;
      const size_t so = (size_t)(rows_a + j) * ld + d;
      store_chunk(dst.k + o, *reinterpret_cast<const uint4*>(Ks + so), n, vec);
      store_chunk(dst.v + o, *reinterpret_cast<const uint4*>(Vs + so), n, vec);
    }
  }

  const float factor = score_factor<S>(Dh);
  for (int qt = warp; qt < LqP / 16; qt += nwarps) {
    if (qt != warp) {
      mb0 = mask_bits(qt, 0);
      mb1 = mask_bits(qt, 1);
    }
    float acc[2 * KT][4];
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int ks = 0; ks < DhP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (size_t)(qt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (size_t)(np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(acc[2 * np], a, kb[0], kb[1]);
        mma16816(acc[2 * np + 1], a, kb[2], kb[3]);
      }
    }

    // rows i0 (c0, c1) and i0 + 8 (c2, c3); columns t * 8 + 2 tig + {0, 1}
    const int i0 = qt * 16 + g, i1 = i0 + 8;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = t * 8 + 2 * tig + e;
        float s0 = scale_score<S>(acc[t][e], factor);
        float s1 = scale_score<S>(acc[t][2 + e], factor);
        if (j < Lk) {
          if (!(mb0 >> (2 * t + e) & 1u)) s0 = MASK_FILL;
          if (!(mb1 >> (2 * t + e) & 1u)) s1 = MASK_FILL;
        } else {
          s0 = s1 = -INFINITY;          // padded key columns add exactly 0
        }
        acc[t][e] = s0;
        acc[t][2 + e] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[t][e] = expf(acc[t][e] - mx0);
        acc[t][2 + e] = expf(acc[t][2 + e] - mx1);
        sum0 += acc[t][e];
        sum1 += acc[t][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(FULL, sum0, off);
      sum1 += __shfl_xor_sync(FULL, sum1, off);
    }
    // P = bf16(p / sum) as the A fragments of the k16 steps over the keys;
    // p / sum as RN(1/sum) times p, corrected once by an fma (Markstein:
    // the correctly rounded quotient in the normal range), three operations
    // for a division's ~20
    const float r0 = __frcp_rn(sum0), r1 = __frcp_rn(sum1);
    auto quot = [](float p, float sum, float r) {
      const float q = p * r;
      return fmaf(fmaf(-q, sum, p), r, q);
    };
    uint32_t pa[KT][4];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      pa[k][0] = pack_bf16(quot(acc[2 * k][0], sum0, r0),
                           quot(acc[2 * k][1], sum0, r0));
      pa[k][1] = pack_bf16(quot(acc[2 * k][2], sum1, r1),
                           quot(acc[2 * k][3], sum1, r1));
      pa[k][2] = pack_bf16(quot(acc[2 * k + 1][0], sum0, r0),
                           quot(acc[2 * k + 1][1], sum0, r0));
      pa[k][3] = pack_bf16(quot(acc[2 * k + 1][2], sum1, r1),
                           quot(acc[2 * k + 1][3], sum1, r1));
    }

    for (int dp = 0; dp < DhP / 16; ++dp) {
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (size_t)(k * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                          dp * 16 + (lane >> 4) * 8);
        mma16816(o[0], pa[k], vb[0], vb[1]);
        mma16816(o[1], pa[k], vb[2], vb[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = dp * 16 + t * 8 + 2 * tig;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = hr ? i1 : i0;
          if (i >= Lq || d >= Dh) continue;
          T* p = &out.at(b, h, i, d);
          if (vec) {
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(o[t][2 * hr], o[t][2 * hr + 1]);
          } else {
            p[0] = __float2bfloat16(o[t][2 * hr]);
            if (d + 1 < Dh) p[1] = __float2bfloat16(o[t][2 * hr + 1]);
          }
        }
      }
    }
  }
}

// The tile path past KEY_MAX keys (one key source, no KvDst): Q, K and V
// staged as in attention_tile_kernel, then each warp's query tiles go over
// the keys in chunks of KEY_MAX (8 key tiles), twice, so that p is
// normalised before it is rounded, as the short path and the TPU kernel do
// (pallas_attention.py:49-52).  Pass 1: S of the chunk on mma.sync, the
// scale, the -1e9 fill and -inf past Lk, the chunk's row max m_c; a running
// max m' = max(m, m_c) and sum l' = l exp(m - m') + sum exp(s - m') a query
// row (the running pair, not a sweep for the max and another for the sum:
// l differs from the short path's sum by float32 rounding only, and S is
// formed twice, not three times).  Pass 2: S of each chunk again (the same
// instructions, so the same bits), p = exp(s - m) / l formed as the short
// path forms p / sum (quot), rounded to bf16 as the A fragments of P V, and
// the float32 context summed over the chunks with no rescale and no division
// at the end.  DP: the context's 16-column tiles a row holds (DhP / 16 <=
// DP).  CH: a link of a launch chain, as attention_tile_kernel (#5's
// cross-attention).  One block a (sample, head, group of W query tiles),
// one warp a query tile: the block stages its group's Q rows and all of K
// and V.  W = TILE_LONG_WARPS (16) past TILE_WARPS tiles, so 211 x 211
// runs one block of 14 warps a (sample, head), 2 blocks an SM, where the
// first design walked the 14 tiles on 4 warps (on the H100 at B = 64:
// 0.194 against 0.302 ms; groups of 4 tiles, 0.304; of 8, 0.313).  Up to
// TILE_WARPS tiles W = TILE_WARPS: 4 warps a block keep the first
// design's 168 registers, where 16 cap them at 128 and spill.  A row's
// arithmetic is the first design's, bit for bit.
template <Scale S, int DP, int W, bool CH>
__global__ void __launch_bounds__(W * 32)
    attention_tile_long_kernel(HeadView<const __nv_bfloat16> q,
                               HeadView<const __nv_bfloat16> k,
                               HeadView<const __nv_bfloat16> v, int Lk,
                               const uint8_t* __restrict__ mask,
                               long long mask_sb, long long mask_sq,
                               HeadView<__nv_bfloat16> out, int H, int Lq,
                               int Dh, bool vec) {
  using T = __nv_bfloat16;
  constexpr int KT = KEY_MAX / 16;            // key tiles a chunk
  extern __shared__ uint4 smem_tile[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  grid_wait<CH>();   // q, k, v: a predecessor's outputs (common.cuh)
  const int LkP = round16(Lk), DhP = round16(Dh);
  const int ld = DhP + 8, ntiles = LkP / 16;
  const int qt0 = blockIdx.y * W;             // the group's first tile
  const int nq = min(round16(Lq) - qt0 * 16, W * 16);
  T* Qs = reinterpret_cast<T*>(smem_tile);    // [nq][ld]: the group's rows
  T* Ks = Qs + (size_t)nq * ld;               // [LkP][ld]
  T* Vs = Ks + (size_t)LkP * ld;              // [LkP][ld]

  const int nch = DhP / 8;
  for (int e = threadIdx.x; e < nq * nch; e += blockDim.x) {
    const int r = e / nch, i = qt0 * 16 + r;
    stage_chunk(Qs, ld, r, (e % nch) * 8, q, b, h, i, i < Lq, Dh, vec);
  }
  for (int e = threadIdx.x; e < LkP * nch; e += blockDim.x) {
    const int r = e / nch, d = (e % nch) * 8;
    stage_chunk(Ks, ld, r, d, k, b, h, r, r < Lk, Dh, vec);
    stage_chunk(Vs, ld, r, d, v, b, h, r, r < Lk, Dh, vec);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  grid_launch_dependents<CH>();   // the operands are staged

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int nwarps = blockDim.x / 32;
  const int ndp = DhP / 16;
  // bit 2 t + e: key j0 + t * 8 + 2 tig + e of query row qt * 16 + g + 8 hr
  auto mask_bits = [=](int qt, int hr, int j0) {
    const int i = min(qt * 16 + g + 8 * hr, Lq - 1);
    const uint8_t* mr = mask + (size_t)b * mask_sb + (size_t)i * mask_sq;
    uint32_t m = 0u;
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + t * 8 + 2 * tig + e;
        if (j < Lk && mr[j]) m |= 1u << (2 * t + e);
      }
    return m;
  };
  auto quot = [](float p, float sum, float r) {
    const float qv = p * r;
    return fmaf(fmaf(-qv, sum, p), r, qv);
  };
  const float factor = score_factor<S>(Dh);
  // the scores of query tile qt against the nt key tiles from c0: rows
  // i0 (acc[t][0..1]) and i0 + 8 (acc[t][2..3]), columns j0 + t * 8 +
  // 2 tig + {0, 1}; scaled, -1e9 where masked, -inf past Lk
  auto chunk_scores = [&](int qt, int c0, int nt, float (&acc)[2 * KT][4]) {
    const int j0 = c0 * 16;
    const uint32_t mb0 = mask_bits(qt, 0, j0), mb1 = mask_bits(qt, 1, j0);
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int ks = 0; ks < DhP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (size_t)((qt - qt0) * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * ld +
                     ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        if (np < nt) {
          uint32_t kb[4];
          ldsm_x4(kb, Ks + (size_t)(j0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          mma16816(acc[2 * np], a, kb[0], kb[1]);
          mma16816(acc[2 * np + 1], a, kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + t * 8 + 2 * tig + e;
        float s0 = scale_score<S>(acc[t][e], factor);
        float s1 = scale_score<S>(acc[t][2 + e], factor);
        if (j < Lk) {
          if (!(mb0 >> (2 * t + e) & 1u)) s0 = MASK_FILL;
          if (!(mb1 >> (2 * t + e) & 1u)) s1 = MASK_FILL;
        } else {
          s0 = s1 = -INFINITY;          // padded key columns add exactly 0
        }
        acc[t][e] = s0;
        acc[t][2 + e] = s1;
      }
    }
  };
  for (int qt = qt0 + warp; qt < qt0 + nq / 16; qt += nwarps) {
    const int i0 = qt * 16 + g, i1 = i0 + 8;
    float acc[2 * KT][4];

    // pass 1: each row's max m and sum l over every chunk
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int c0 = 0; c0 < ntiles; c0 += KT) {
      chunk_scores(qt, c0, min(KT, ntiles - c0), acc);
      float c_0 = -INFINITY, c_1 = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2 * KT; ++t) {
        c_0 = fmaxf(c_0, fmaxf(acc[t][0], acc[t][1]));
        c_1 = fmaxf(c_1, fmaxf(acc[t][2], acc[t][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        c_0 = fmaxf(c_0, __shfl_xor_sync(FULL, c_0, off));
        c_1 = fmaxf(c_1, __shfl_xor_sync(FULL, c_1, off));
      }
      // every chunk holds a real key, so the new maxima are finite; the
      // first chunk's rescale is exp(-inf) = 0 of a zero sum
      const float n0 = fmaxf(m0, c_0), n1 = fmaxf(m1, c_1);
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      float s_0 = 0.f, s_1 = 0.f;
#pragma unroll
      for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s_0 += expf(acc[t][e] - n0);
          s_1 += expf(acc[t][2 + e] - n1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s_0 += __shfl_xor_sync(FULL, s_0, off);
        s_1 += __shfl_xor_sync(FULL, s_1, off);
      }
      l0 = l0 * a0 + s_0;
      l1 = l1 * a1 + s_1;
    }

    // pass 2: P = bf16(exp(s - m) / l) chunk by chunk into P V
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
    float o[DP][2][4];
#pragma unroll
    for (int dp = 0; dp < DP; ++dp)
#pragma unroll
      for (int t = 0; t < 2; ++t) o[dp][t][0] = o[dp][t][1] = o[dp][t][2] = o[dp][t][3] = 0.f;
    for (int c0 = 0; c0 < ntiles; c0 += KT) {
      const int nt = min(KT, ntiles - c0), j0 = c0 * 16;
      chunk_scores(qt, c0, nt, acc);
#pragma unroll
      for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[t][e] = quot(expf(acc[t][e] - m0), l0, r0);
          acc[t][2 + e] = quot(expf(acc[t][2 + e] - m1), l1, r1);
        }
      }
      uint32_t pa[KT][4];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        pa[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
        pa[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
        pa[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP; ++dp) {
        if (dp < ndp) {
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            if (kk < nt) {
              uint32_t vb[4];
              ldsm_x4_t(vb, Vs + (size_t)(j0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                                dp * 16 + (lane >> 4) * 8);
              mma16816(o[dp][0], pa[kk], vb[0], vb[1]);
              mma16816(o[dp][1], pa[kk], vb[2], vb[3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int dp = 0; dp < DP; ++dp) {
      if (dp >= ndp) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = dp * 16 + t * 8 + 2 * tig;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = hr ? i1 : i0;
          if (i >= Lq || d >= Dh) continue;
          T* p = &out.at(b, h, i, d);
          if (vec) {
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(o[dp][t][2 * hr], o[dp][t][2 * hr + 1]);
          } else {
            p[0] = __float2bfloat16(o[dp][t][2 * hr]);
            if (d + 1 < Dh) p[1] = __float2bfloat16(o[dp][t][2 * hr + 1]);
          }
        }
      }
    }
  }
}

// ---- ffma path (float32) ----------------------------------------------------

template <typename T, Scale S, bool CH>
__global__ void __launch_bounds__(ATT_WARPS * 32)
    attention_ffma_kernel(HeadView<const T> q, HeadView<const T> ka,
                HeadView<const T> va, int rows_a, HeadView<const T> kc,
                HeadView<const T> vc, int rows_c,
                const uint8_t* __restrict__ mask, long long mask_sb,
                long long mask_sq, HeadView<T> out, int H, int Lq, int Dh,
                KvDst<T> dst) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int Lk = rows_a + rows_c;
  grid_wait<CH>();   // q, k, v: a predecessor's outputs (common.cuh)
  const float factor = score_factor<S>(Dh);
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
  grid_launch_dependents<CH>();   // the operands are staged

  if (dst.k != nullptr) {
    // every key of (b, h) is staged: copy the fresh rows out, exactly (T
    // to float32 and back is the identity); no other block touches them
    const int s0 = dst_start(dst, b, rows_c);
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
      s = scale_score<S>(s, factor);
      if (!mrow[j]) s = MASK_FILL;
      P[j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(P[j] - mx);
      P[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
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

// ---- ffma_long path (float32 past KEY_MAX keys) ----------------------------

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)),
               "l"(g)
               : "memory");
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// n (1, 2 or a multiple of 4) consecutive floats of shared memory at p,
// min(4n, 16)-byte aligned
template <int n>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      x[i] = u.x; x[i + 1] = u.y; x[i + 2] = u.z; x[i + 3] = u.w;
    }
  } else if constexpr (n == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  } else {
    x[0] = p[0];
  }
}

// The ffma block's arithmetic past KEY_MAX keys, tiled for occupancy (one
// key source, no KvDst).  One block of FL_WARPS warps a (sample, head,
// FL_ROWS query rows); warp w owns rows RW w .. RW w + RW - 1 of the tile
// through all three steps, so only the K/V ring needs block barriers.
//  - Q^T staged once by cp.async, [Dh][FL_ROWS + 4] (a warp's RW rows of
//    one d are one vector load, the same for every lane); the row scores
//    [FL_ROWS][Lk rounded to 4] stay in shared memory from S = Q K^T to
//    P V; the mask rows as bits, [FL_ROWS][Lk / 32 words] (one ballot a 32
//    keys), read from device memory while the first chunk flies.
//  - K chunks, then V chunks, of FL_KEYS keys stream through a ring of
//    two [FL_KEYS][Dh + 1] buffers (odd stride: lanes on distinct key rows
//    hit distinct banks) by 4-byte cp.async (any alignment, any head
//    width); chunk t + 1 is asked for right after the barrier that makes
//    chunk t visible, so it flies while the block computes on t, and that
//    one barrier a chunk also frees the buffer it lands in.
//  - S: lane l holds RW rows x keys j0 + l + 32 u (u < FL_KEYS / 32); each
//    score one fmaf chain over d ascending from 0, as the ffma block forms
//    it.
//  - softmax: each of the warp's rows as the ffma block does one, the rows
//    side by side: lane l over keys j = l (mod 32) ascending: the scale,
//    the -1e9 fill, the max, e = exp(s - max) and the lane's sum, the xor
//    butterfly 16 .. 1, p = e / sum.
//  - P V: lane l holds RW rows x head columns l + 32 c (c < DC); each
//    context element one fmaf chain over j ascending from 0, carried over
//    the chunks.
// So every output is bitwise the ffma block's (its float32 contract);
// the block is 53,888 bytes at 211 keys and Dh = 64 and 64 registers a
// thread: 4 blocks (32 warps) an SM, against the ffma block's one of 4
// warps.  Bound: operations (FFMA) at 196-211 keys, bytes below; on the
// H100 it runs at a fifth of the FFMA bound at 211 x 211 (PERF.md: 32 or
// 64 keys a chunk and 32 or 64 rows a block time alike there).
template <Scale S, int DC, bool CH>
__global__ void __launch_bounds__(FL_WARPS * 32)
    attention_ffma_long_kernel(HeadView<const float> q,
                               HeadView<const float> k,
                               HeadView<const float> v, int Lk,
                               const uint8_t* __restrict__ mask,
                               long long mask_sb, long long mask_sq,
                               HeadView<float> out, int H, int Lq, int Dh) {
  constexpr int RW = FL_ROWS / FL_WARPS;
  constexpr int KL = FL_KEYS / 32;     // keys a lane holds in S
  constexpr int QLD = FL_ROWS + 4;
  extern __shared__ float4 smem_long[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * FL_ROWS;
  const int rows = min(FL_ROWS, Lq - q0);
  grid_wait<CH>();   // q, k, v: a predecessor's outputs (common.cuh)
  const int sld = round4(Lk), kld = Dh + 1, nw = (Lk + 31) / 32;
  float* Qt = reinterpret_cast<float*>(smem_long);   // [Dh][QLD]
  float* Ss = Qt + (size_t)Dh * QLD;                  // [FL_ROWS][sld]
  float* ring = Ss + (size_t)FL_ROWS * sld;           // 2 x [FL_KEYS][kld]
  uint32_t* Mb = reinterpret_cast<uint32_t*>(ring + (size_t)2 * FL_KEYS * kld);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (Lk + FL_KEYS - 1) / FL_KEYS;
  // item t: K chunk t (t < nc), else V chunk t - nc, into buffer t & 1
  // (a warp a row, a lane a column: no division in the address)
  auto issue = [=](int t) {
    const bool isk = t < nc;
    const int j0 = (isk ? t : t - nc) * FL_KEYS;
    const int jn = min(FL_KEYS, Lk - j0);
    float* buf = ring + (size_t)(t & 1) * FL_KEYS * kld;
    for (int j = warp; j < jn; j += FL_WARPS) {
      const float* src = isk ? &k.at(b, h, j0 + j, 0) : &v.at(b, h, j0 + j, 0);
      for (int d = lane; d < Dh; d += 32) cp_async4(buf + j * kld + d, src + d);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = warp; i < FL_ROWS; i += FL_WARPS) {
    const float* src = &q.at(b, h, q0 + min(i, rows - 1), 0);
    for (int d = lane; d < Dh; d += 32) {
      if (i < rows) cp_async4(Qt + d * QLD + i, src + d);
      else Qt[d * QLD + i] = 0.f;
    }
  }
  issue(0);                            // Q^T lands with the first chunk

  const int r0 = warp * RW;            // the warp's first row of the tile
  const bool live = r0 < rows;
  if (live) {
    // bit l of word w of row r: key 32 w + l visible to query row r (rows
    // past Lq: none), 8 words of each row asked for before any is used
    for (int w0 = 0; w0 < nw; w0 += 8) {
      uint8_t m[RW][8];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const uint8_t* mrow =
            mask + (size_t)b * mask_sb + (size_t)(q0 + r0 + r) * mask_sq;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = (w0 + u) * 32 + lane;
          m[r][u] = r0 + r < rows && j < Lk ? mrow[j] : 0;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint32_t bits = __ballot_sync(FULL, m[r][u] != 0);
          if (lane == 0 && w0 + u < nw) Mb[(r0 + r) * nw + w0 + u] = bits;
        }
    }
  }
  const float factor = score_factor<S>(Dh);
  int dcol[DC];                        // this lane's head columns (clamped)
#pragma unroll
  for (int c = 0; c < DC; ++c) dcol[c] = min(lane + 32 * c, Dh - 1);
  float acc[RW][DC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  // P V of keys jj .. jj + 3 (prow: row r0's scores from the chunk's
  // first key; buf: the chunk's V)
  auto pv4 = [&](const float* prow, const float* buf, int jj) {
    float4 p[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
      p[r] = *reinterpret_cast<const float4*>(prow + (size_t)r * sld + jj);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* vrow = buf + (jj + u) * kld;
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vrow[dcol[c]];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pu = u == 0 ? p[r].x : u == 1 ? p[r].y
                         : u == 2 ? p[r].z : p[r].w;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pu, vv[c], acc[r][c]);
      }
    }
  };

  for (int t = 0; t < 2 * nc; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();       // chunk t visible; buffer (t + 1) & 1 free
    if (t + 1 < 2 * nc) issue(t + 1);
    const float* buf = ring + (size_t)(t & 1) * FL_KEYS * kld;
    if (!live) continue;
    if (t < nc) {
      // S of keys j0 + lane + 32 u
      const int j0 = t * FL_KEYS;
      float sc[RW][KL];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int u = 0; u < KL; ++u) sc[r][u] = 0.f;
      const float* krow = buf + lane * kld;
#pragma unroll 4
      for (int d = 0; d < Dh; ++d) {
        float qv[RW], kv[KL];
        load_rows<RW>(Qt + d * QLD + r0, qv);
#pragma unroll
        for (int u = 0; u < KL; ++u) kv[u] = krow[32 * u * kld + d];
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int u = 0; u < KL; ++u) sc[r][u] = fmaf(qv[r], kv[u], sc[r][u]);
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float* srow = Ss + (size_t)(r0 + r) * sld + j0;
#pragma unroll
        for (int u = 0; u < KL; ++u)
          if (j0 + lane + 32 * u < Lk) srow[lane + 32 * u] = sc[r][u];
      }
      continue;
    }
    const int c0 = t - nc;
    if (c0 == 0) {
      // the ffma block's softmax, the warp's RW rows side by side (rows
      // past Lq see no key and stay finite: they are not written)
      float mx[RW], sum[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        mx[r] = -INFINITY;
        sum[r] = 0.f;
      }
      for (int w = 0; w < nw; ++w) {
        const int j = w * 32 + lane;
        if (j >= Lk) break;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float* P = Ss + (size_t)(r0 + r) * sld;
          float s = scale_score<S>(P[j], factor);
          if (!(Mb[(r0 + r) * nw + w] >> lane & 1u)) s = MASK_FILL;
          P[j] = s;
          mx[r] = fmaxf(mx[r], s);
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], off));
      for (int j = lane; j < Lk; j += 32) {
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float* P = Ss + (size_t)(r0 + r) * sld;
          const float e = expf(P[j] - mx[r]);
          P[j] = e;
          sum[r] += e;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum[r] += __shfl_xor_sync(FULL, sum[r], off);
      for (int j = lane; j < Lk; j += 32) {
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float* P = Ss + (size_t)(r0 + r) * sld;
          P[j] = P[j] / sum[r];
        }
      }
      __syncwarp();
    }
    // P V over keys j0 .. j0 + jn - 1, ascending
    const int j0 = c0 * FL_KEYS, jn = min(FL_KEYS, Lk - j0);
    const float* prow = Ss + (size_t)r0 * sld + j0;
    int jj = 0;
    if (jn == FL_KEYS) {
#pragma unroll 4
      for (; jj < FL_KEYS; jj += 4) pv4(prow, buf, jj);
    } else {
      for (; jj + 4 <= jn; jj += 4) pv4(prow, buf, jj);
    }
    for (; jj < jn; ++jj) {
      const float* vrow = buf + jj * kld;
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vrow[dcol[c]];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pu = prow[(size_t)r * sld + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pu, vv[c], acc[r][c]);
      }
    }
  }
  grid_launch_dependents<CH>();

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r0 + r >= rows) break;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) out.at(b, h, q0 + r0 + r, d) = acc[r][c];
    }
  }
}

template <typename V>
bool aligned16(const V& v, long long esize) {
  return reinterpret_cast<uintptr_t>(v.p) % 16 == 0 && (v.sb * esize) % 16 == 0 &&
         (v.sh * esize) % 16 == 0 && (v.sl * esize) % 16 == 0;
}

}  // namespace
}  // namespace att

template <typename T>
constexpr int dtype_code() {
  return sizeof(T) == 4 ? BFC_DTYPE_F32 : BFC_DTYPE_BF16;
}

// shared memory of one (sample, head) block on ``path``
inline size_t attention_smem(int path, int Lq, int Lk, int Dh) {
  if (path == kPathRow) return 0;
  if (path == kPathTile) {
    // past KEY_MAX keys a block stages one group of query tiles
    const int lq16 = att::round16(Lq);
    const int lq = Lk > KEY_MAX && lq16 > TILE_LONG_WARPS * 16
                       ? TILE_LONG_WARPS * 16 : lq16;
    return 2 * (size_t)(lq + 2 * att::round16(Lk)) * (att::round16(Dh) + 8);
  }
  if (path == kPathFfmaLong)
    return sizeof(float) * ((size_t)Dh * (FL_ROWS + 4) +
                            (size_t)FL_ROWS * att::round4(Lk) +
                            (size_t)2 * FL_KEYS * (Dh + 1) +
                            (size_t)FL_ROWS * ((Lk + 31) / 32));
  return sizeof(float) * ((size_t)Lk * (Dh + 1) + (size_t)Lk * Dh +
                          (size_t)Lq * Dh + (size_t)ATT_WARPS * Lk);
}

// lanes a key row on the row path: the row's 16-byte chunks, to a power of
// 2, at least 8 (three instantiations: 8, 16, 32 lanes)
inline int row_lanes(int Dh, int esize) {
  const int nch = (Dh * esize + 15) / 16;
  int g = 8;
  while (g < nch) g <<= 1;
  return g;
}

// lets ``kernel`` take ``smem`` bytes of dynamic shared memory
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// path < 0: attention_path's; a path given must be one the dtype has
// (row at both, tile at bf16, ffma and ffma_long at float32); CH: launched
// as a link of a launch chain (common.cuh launch_kernel).  More than
// KEY_MAX keys only from one source with no KvDst (the row path's wide
// score rows, the tile path's chunked kernel and ffma_long take one
// source; ffma_long takes one at any Lk), the row path at most row_key_max
// (ops/decoder_layer.py check_attention_shape mirrors this and
// attention_smem)
template <typename T, Scale S, bool CH = false>
cudaError_t launch_attention(HeadView<const T> q, HeadView<const T> ka,
                             HeadView<const T> va, int rows_a,
                             HeadView<const T> kc, HeadView<const T> vc,
                             int rows_c, const uint8_t* mask,
                             long long mask_sb, long long mask_sq,
                             HeadView<T> out, int B, int H, int Lq, int Dh,
                             cudaStream_t stream, KvDst<T> dst = {},
                             int path = -1) {
  const int Lk = rows_a + rows_c;
  constexpr int code = dtype_code<T>();
  const int auto_path = attention_path(Lq, Lk, code);
  if (auto_path < 0 || Dh < 1 || Dh > DH_MAX) return cudaErrorInvalidValue;
  if (path < 0) path = auto_path;
  const bool bf16 = code == BFC_DTYPE_BF16;
  const bool one_source = rows_c == 0 && dst.k == nullptr;
  if (path > kPathFfmaLong || (path == kPathTile && !bf16) ||
      ((path == kPathFfma || path == kPathFfmaLong) && bf16))
    return cudaErrorInvalidValue;
  if ((Lk > KEY_MAX || path == kPathFfmaLong) && !one_source)
    return cudaErrorInvalidValue;
  if (path == kPathRow && Lk > row_key_max(code))
    return cudaErrorInvalidValue;
  const long long es = sizeof(T);
  const bool vec =
      (Dh * es) % 16 == 0 && att::aligned16(q, es) && att::aligned16(ka, es) &&
      att::aligned16(va, es) && att::aligned16(kc, es) &&
      att::aligned16(vc, es) && att::aligned16(out, es) &&
      (dst.k == nullptr ||
       (reinterpret_cast<uintptr_t>(dst.k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(dst.v) % 16 == 0 && (dst.ld * es) % 16 == 0));
  const size_t smem = attention_smem(path, Lq, Lk, Dh);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;

  if (path == kPathRow) {
    const int BH = B * H;
    const int grid = (BH + ROW_WARPS - 1) / ROW_WARPS;
#define BFC_ROW(G, SREG)                                                      \
  return launch_kernel<CH>(att::attention_row_kernel<T, S, G, SREG, CH>,      \
                           grid, ROW_WARPS * 32, 0, stream, q, ka, va,        \
                           rows_a, kc, vc, rows_c, mask, mask_sb, mask_sq,    \
                           out, BH, H, Lq, Dh, dst, vec)
#define BFC_ROW_KEYS(G)                                                       \
  if constexpr (sizeof(T) == 2) {                                             \
    if (Lk > KEY_MAX) BFC_ROW(G, ROW_KEY_MAX / 32);                           \
  }                                                                           \
  BFC_ROW(G, KEY_MAX / 32)
    switch (row_lanes(Dh, static_cast<int>(es))) {
      case 8: BFC_ROW_KEYS(8);
      case 16: BFC_ROW_KEYS(16);
      case 32: BFC_ROW_KEYS(32);
      default: return cudaErrorInvalidValue;
    }
#undef BFC_ROW_KEYS
#undef BFC_ROW
  }
  if constexpr (sizeof(T) == 2) {
    if (path == kPathTile) {
      const int tiles = att::round16(Lq) / 16;
      const int threads = 32 * (tiles < TILE_WARPS ? tiles : TILE_WARPS);
      if (Lk > KEY_MAX) {
        const bool wide = tiles > TILE_WARPS;
        const int w = wide ? TILE_LONG_WARPS : TILE_WARPS;
        const dim3 grid(B * H, (tiles + w - 1) / w);
        const int lw = tiles < w ? tiles : w;
#define BFC_TILE_LONG(DP, W)                                                  \
  {                                                                           \
    BFC_TRY(allow_smem(att::attention_tile_long_kernel<S, DP, W, CH>, smem)); \
    return launch_kernel<CH>(att::attention_tile_long_kernel<S, DP, W, CH>,   \
                             grid, 32 * lw, smem, stream, q, ka, va, Lk,      \
                             mask, mask_sb, mask_sq, out, H, Lq, Dh, vec);    \
  }
        if (att::round16(Dh) <= 64) {
          if (wide) BFC_TILE_LONG(4, TILE_LONG_WARPS);
          BFC_TILE_LONG(4, TILE_WARPS);
        }
        if (wide) BFC_TILE_LONG(8, TILE_LONG_WARPS);
        BFC_TILE_LONG(8, TILE_WARPS);
#undef BFC_TILE_LONG
      }
#define BFC_TILE(KT)                                                          \
  {                                                                           \
    BFC_TRY(allow_smem(att::attention_tile_kernel<S, KT, CH>, smem));         \
    return launch_kernel<CH>(att::attention_tile_kernel<S, KT, CH>, B * H,    \
                             threads, smem, stream, q, ka, va, rows_a, kc,    \
                             vc, rows_c, mask, mask_sb, mask_sq, out, H, Lq,  \
                             Dh, dst, vec);                                   \
  }
      switch (att::round16(Lk) / 16) {
        case 1: BFC_TILE(1);
        case 2: BFC_TILE(2);
        case 3: BFC_TILE(3);
        case 4: BFC_TILE(4);
        case 5: BFC_TILE(5);
        case 6: BFC_TILE(6);
        case 7: BFC_TILE(7);
        case 8: BFC_TILE(8);
        default: return cudaErrorInvalidValue;
      }
#undef BFC_TILE
    }
  }
  if constexpr (sizeof(T) == 4) {
    if (path == kPathFfmaLong) {
      const dim3 grid(B * H, (Lq + FL_ROWS - 1) / FL_ROWS);
#define BFC_FFMA_LONG(DC)                                                     \
  {                                                                           \
    BFC_TRY(allow_smem(att::attention_ffma_long_kernel<S, DC, CH>, smem));    \
    return launch_kernel<CH>(att::attention_ffma_long_kernel<S, DC, CH>,      \
                             grid, FL_WARPS * 32, smem, stream, q, ka, va,    \
                             Lk, mask, mask_sb, mask_sq, out, H, Lq, Dh);     \
  }
      if (Dh <= 64) BFC_FFMA_LONG(2);
      BFC_FFMA_LONG(4);
#undef BFC_FFMA_LONG
    }
  }
  BFC_TRY(allow_smem(att::attention_ffma_kernel<T, S, CH>, smem));
  return launch_kernel<CH>(att::attention_ffma_kernel<T, S, CH>, B * H,
                           ATT_WARPS * 32, smem, stream, q, ka, va, rows_a,
                           kc, vc, rows_c, mask, mask_sb, mask_sq, out, H, Lq,
                           Dh, dst);
}

// keys a ++ c; q points at head 0's column of a row-major [B*Lq, ldq]
// buffer; c's rows also go to dst, if it has k
template <typename T, bool CH = false>
cudaError_t attention2(const T* q, int ldq, KeySrc<T> a, KeySrc<T> c,
                       const uint8_t* mask, long long mask_sb,
                       long long mask_sq, T* out, int ldo, int B, int H,
                       int Lq, int Dh, cudaStream_t stream,
                       KvDst<T> dst = {}) {
  return launch_attention<T, Scale::kDivSqrt, CH>(
      rows_view(q, ldq, Lq, Dh), rows_view(a.k, a.ldk, a.rows, Dh),
      rows_view(a.v, a.ldv, a.rows, Dh), a.rows,
      rows_view(c.k, c.ldk, c.rows, Dh), rows_view(c.v, c.ldv, c.rows, Dh),
      c.rows, mask, mask_sb, mask_sq, rows_view(out, ldo, Lq, Dh), B, H, Lq,
      Dh, stream, dst);
}

// one key source: q/k/v point at head 0's column of row-major
// [B*Lq | B*Lk, ld*] buffers
template <typename T, bool CH = false>
cudaError_t attention(const T* q, int ldq, const T* k, int ldk, const T* v,
                      int ldv, const uint8_t* mask, long long mask_sb,
                      long long mask_sq, T* out, int ldo, int B, int H,
                      int Lq, int Lk, int Dh, cudaStream_t stream) {
  return attention2<T, CH>(q, ldq, KeySrc<T>{k, v, ldk, ldv, Lk},
                           KeySrc<T>{nullptr, nullptr, 0, 0, 0}, mask,
                           mask_sb, mask_sq, out, ldo, B, H, Lq, Dh, stream);
}

}  // namespace bfc
