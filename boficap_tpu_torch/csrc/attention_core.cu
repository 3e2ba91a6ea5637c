// Attention core: the port of the TPU kernel
// boficap_tpu/ops/pallas_attention.py::_kernel (:33, entered through
// attention_core, pallas_call :65).
//
// For every (sample, head) of q [B, H, Lq, Dh], k / v [B, H, Lk, Dh] and a
// bool mask [B, Lq, Lk] (True = attend):
//
//   s = (q . k) * f32(1 / sqrt(Dh));  s = mask ? s : -1e9
//   p = T(softmax_f32(s));  out = T(sum_j p_j v_j)
//
// This is attention.cuh's block over strided views: every operand arrives
// with its own sample, head and row strides, so the callers' layouts are
// read in place.  MultiHeadAttention.attend passes transposed views of its
// [B, L, H, Dh] projections, a [B, Lk] padding mask expanded over the query
// rows (row stride 0), and the bounding step a query broadcast over the
// batch (sample stride 0); the output is written as [B, Lq, H, Dh] rows, so
// the caller's merge of the heads is a view.  No copy runs around the
// launch.  A fully masked row comes out uniform over its sample's Lk keys
// (the finite -1e9 fill), as on the TPU.
//
// The decode steps that call it have one query row: attention.cuh's row
// path, one warp a (sample, head) reading K and V from device memory with
// 16-byte loads, no shared memory, no block barrier.  Wider queries (a
// plain encode or NA fill under use_pallas) take the tile path at bf16
// (mma.sync tensor cores) and the FFMA block at float32.
//
// Bound on the H100: bytes.  At the AR step's cross-attention (B = 64,
// H = 8, Lq = 1, Lk = 36, Dh = 64) the call reads 4.85 MB in bf16 (9.70 MB
// in float32), ~1.4 us (2.9 us) at 3.35 TB/s, for 4.7 MFLOP; 512 warps of
// the row path, four a block on 128 blocks, each read their head's slices
// once.
#include "attention.cuh"

// Field order and types are mirrored by ops/attention.py
// (_AttentionCoreArgs); bfc_attention_core_args_size() lets it check.
// Strides count elements; element (b, h, i, d) of q lies at
// q + b*q_sb + h*q_sh + i*q_sl + d (d contiguous), and likewise for k, v
// and out; mask (b, i, j) at mask + b*mask_sb + i*mask_sq + j.
struct BfcAttentionCoreArgs {
  const void* q;
  long long q_sb, q_sh, q_sl;
  const void* k;
  long long k_sb, k_sh, k_sl;
  const void* v;
  long long v_sb, v_sh, v_sl;
  const void* mask;                 // bool
  long long mask_sb, mask_sq;
  void* out;
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk, Dh;
  int path;                         // -1: attention_path's; else that path
};

namespace bfc {

template <typename T>
cudaError_t attention_core_entry(const BfcAttentionCoreArgs& a,
                                 cudaStream_t s) {
  auto view = [](const void* p, long long sb, long long sh, long long sl) {
    return HeadView<const T>{static_cast<const T*>(p), sb, sh, sl};
  };
  const HeadView<const T> none{nullptr, 0, 0, 0};
  return launch_attention<T, Scale::kMulInvSqrt, false, true>(
      view(a.q, a.q_sb, a.q_sh, a.q_sl), view(a.k, a.k_sb, a.k_sh, a.k_sl),
      view(a.v, a.v_sb, a.v_sh, a.v_sl), a.Lk, none, none, 0,
      static_cast<const uint8_t*>(a.mask), a.mask_sb, a.mask_sq,
      HeadView<T>{static_cast<T*>(a.out), a.o_sb, a.o_sh, a.o_sl}, a.B, a.H,
      a.Lq, a.Dh, s, KvDst<T>{}, a.path);
}

}  // namespace bfc

extern "C" int bfc_attention_core_args_size() {
  return static_cast<int>(sizeof(BfcAttentionCoreArgs));
}

// the path an Lq x Lk attention at dtype takes (attention.cuh
// AttentionPath), -1 past the key bound
extern "C" int bfc_attention_path(int Lq, int Lk, int dtype) {
  return bfc::attention_path(Lq, Lk, dtype);
}

// the shared memory of one (sample, head) block on the path that dtype
// takes, in bytes; the wrapper holds it against the card's 227 KB a block
extern "C" long long bfc_attention_core_scratch(int Lq, int Lk, int Dh,
                                                int dtype) {
  return static_cast<long long>(
      bfc::attention_smem(bfc::attention_path(Lq, Lk, dtype), Lq, Lk, Dh));
}

extern "C" int bfc_attention_core(int dtype, int device,
                                  const BfcAttentionCoreArgs* a,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->H <= 0 || a->Lk <= 0 || a->Dh <= 0 || a->Lq < 0 || a->B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B == 0 || a->Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BFC_DTYPE_F32)
    return static_cast<int>(bfc::attention_core_entry<float>(*a, s));
  if (dtype == BFC_DTYPE_BF16)
    return static_cast<int>(bfc::attention_core_entry<__nv_bfloat16>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
