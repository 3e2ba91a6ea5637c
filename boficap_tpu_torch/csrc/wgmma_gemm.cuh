// Building block: the bfloat16 matrix product on Hopper's tensor cores, for
// the projections and FFN products of the encoder-layer and decoder-layer
// kernels (#1, #2; the stacks #4, #5 loop the same bodies), of the window
// layer (window.cuh: #6, #7, #8) and for the greedy head's logits (#3,
// greedy_head.cu).  It replaces, at bf16, the jnp.dot calls of the TPU
// kernels' bodies (boficap_tpu/ops/pallas_decoder_layer.py::_mha :75,
// _kernel :124, _win_kernel :283, _enc_kernel :500, _head_kernel :671;
// pallas_stack.py :583-634).
//
//   C = epilogue(A[M,K] @ W[K,N])     W in the flax [in, out] layout
//
// One mainloop, with the epilogue a template parameter (epilogue.cuh):
// LinearEpi rounds as the TPU kernels do, v = bf16(sum); v = bf16(v +
// bias); relu?; v = bf16(v + res); HeadEpi reduces each row's logits of a
// vocab chunk to the head's partials.  float32 runs on the FFMA product of
// ffma_gemm.cuh (``product<float>`` below).
//
// Bound on the H100: operations.  At the serving batch the products are
// 2304 or 1280 rows by 512-2048, 200-700 flops per byte moved; e.g. 2304 x
// 512 x 1536 is 3.6 GFLOP, 3.66 us at the 989 TFLOP/s of bf16 wgmma.  The
// design:
//
//  - One output tile of BM x BN per block, k in steps of BK = 64 (one
//    128-byte row of bf16, the width of TMA's 128-byte swizzle).
//  - Loads: one producer warp keeps TMA copies in flight into a ring of
//    3 or 4 shared-memory slots.  A slot holds A's [BM][64] tile (K-major)
//    and BN / 64 tiles [64 k][64 n] of W (N-major: W stays in its packed
//    [in, out] layout; wgmma reads a 16-bit B operand either way), all
//    128-byte swizzled (at BN = 32, the window-parts layer's D-wide tile,
//    one [64 k][32 n] W tile with the 64-byte swizzle); each slot has a
//    "full" mbarrier the copies complete on and an "empty" one the
//    consumers release it on.
//  - Compute: BM / 64 consumer warpgroups, each running wgmma m64nBNk16
//    over its 64 rows with the float32 sums in registers; one k step's
//    wgmma group stays in flight while the next is issued.
//  - Epilogue: each thread hands its accumulator fragment to the epilogue
//    (epilogue.cuh ``fragment``), which works from the registers straight
//    to global memory, bias and residual read there.
//  - Ragged edges: TMA fills elements outside A or W with zeros (they add
//    nothing to a sum); the epilogue writes only rows < M, columns < N.
//  - Batch independence: no split-K.  Every element sums its k in one
//    order (the k tiles in turn, four k16 steps each) with one instruction
//    shape (BN follows N alone), so row r of C is bitwise the same for any
//    M; BM, which follows M, only sets how many warpgroups share a block.
//  - Shapes: TMA needs 16-byte aligned bases and row strides, so K and N
//    are multiples of 8 and A, W 16-byte aligned; bias, res and C are read
//    and written in pairs (4-byte aligned).  Anything else returns
//    cudaErrorInvalidValue; the Python wrappers check first and raise.
//  - Tensor maps: cuTensorMapEncodeTiled, looked up at run time with
//    cudaGetDriverEntryPoint (no -lcuda).  W's map is cached by (pointer,
//    shape, box): weights live as long as their model.  A's is encoded per
//    call.  Both pass as __grid_constant__ kernel parameters, and so does
//    the epilogue: its methods take its address, which without the
//    qualifier makes each thread copy it first (the bf16 products ran up
//    to ~1 us slower that way on the H100).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; libcuda is not linked

#include <atomic>
#include <mutex>

#include "ffma_gemm.cuh"

namespace bfc {
namespace tc {
// Internal linkage: encoder_layer.cu, decoder_layer.cu, window_layer.cu
// and window_stack.cu each build this into their own library, with its own
// CUDA runtime.  Shared (weak) template symbols would let one library's
// kernel stubs and statics (the shared-memory attribute set per device, the
// map cache) stand in for another's, whose runtime never registered or
// configured them.
namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;
// ring slots: 3 for the 128 x 128 tile (96 KB, so two blocks share an SM;
// 4 slots, 128 KB, left one a block and read 8-19% slower on the H100), 4
// for the others (at most 96 KB)
template <int NC, int BN>
__host__ __device__ constexpr int stages() {
  return NC * 64 + BN > 192 ? 3 : 4;
}
constexpr int ATOM_BYTES = 64 * BK * 2;   // one [64][64] bf16 tile, 8 KB
constexpr int NUM_SMS = 132;               // H100 SXM

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// spin until the phase of parity ``parity`` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 inner, c1 outer) of map into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (K-major: SBO between 8-row
// groups, LBO unused; MN-major: LBO between 64-wide MN atoms, SBO between
// 8-row k groups)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the same with the 64-byte swizzle: W's [64 k][32 n] tile of the BN = 32
// product (rows of 64 bytes, SBO 512 between 8-row k groups)
__device__ __forceinline__ uint64_t sw64_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A(desc_a, K-major) @ B(desc_b, MN-major), m64n64k16, bf16 in,
// float32 sums; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, m64n32k16
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, m64n128k16
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 32)
    wgmma_n32(d, da, db, scale_d);
  else if constexpr (BN == 64)
    wgmma_n64(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}

// W's k tile at k0 (columns n0 .. n0 + BN - 1) into dst: BN / 64 tiles
// [64 k][64 n] with the 128-byte swizzle, or, BN = 32, one [64 k][32 n]
// with the 64-byte swizzle (w_map's box width: w_box(BN))
template <int BN>
__device__ __forceinline__ void load_w(uint8_t* dst, const CUtensorMap* map,
                                       uint64_t* bar, int n0, int k0) {
  if constexpr (BN == 32) {
    tma_load_2d(dst, map, bar, n0, k0);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(dst + j * ATOM_BYTES, map, bar, n0 + 64 * j, k0);
  }
}

// the wgmma descriptor of k16 step kk of W's tile at b_s (load_w's layout)
template <int BN>
__device__ __forceinline__ uint64_t w_desc(const uint8_t* b_s, int kk) {
  if constexpr (BN == 32)
    return sw64_desc(b_s + kk * 16 * 64, 64 * BK * 2, 512);
  else
    return sw128_desc(b_s + kk * 16 * 128, ATOM_BYTES, 1024);
}

template <int NC, int BN>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the ring to the 1024-byte swizzle period
  return 1024 + (size_t)stages<NC, BN>() * (64 * NC + BN) * BK * 2 +
         2 * stages<NC, BN>() * sizeof(uint64_t);
}

// NC consumer warpgroups (BM = 64 * NC rows), then one producer warp;
// blockIdx.x along N, blockIdx.y along M; CH: launched as a link of a
// launch chain (common.cuh launch_kernel)
template <int NC, int BN, class Epi, bool CH>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
    gemm_tc_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ Epi epi, int K) {
  constexpr int BM = 64 * NC;
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  constexpr int R = BN / 2;   // accumulator registers a thread
  constexpr int STAGES = stages<NC, BN>();
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = smem_u32(tc_smem);
  uint8_t* ring = tc_smem + ((1024 - (base & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // producer: one thread issues every copy, a slot's A, then its W.
    // Chained, the first slots' W go out before grid_wait (common.cuh): no
    // kernel of a launch chain writes W; A is the predecessor's output.
    // (Unchained, W first made #4's products 3% slower on the H100.)
    if (tid == NC * 128) {
      auto load_w = [&](int kt) {
        uint8_t* slot = ring + (kt % STAGES) * STAGE_BYTES;
        bfc::tc::load_w<BN>(slot + A_BYTES, &w_map, &full[kt % STAGES], n0,
                            kt * BK);
      };
      const int pre = !CH ? 0 : KT < STAGES ? KT : STAGES;
      for (int kt = 0; kt < pre; ++kt) {
        mbar_expect_tx(&full[kt], STAGE_BYTES);
        load_w(kt);
      }
      grid_wait<CH>();
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        if (kt >= pre) mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(ring + s * STAGE_BYTES, &a_map, &full[s], kt * BK, m0);
        if (kt >= pre) load_w(kt);
      }
      grid_launch_dependents<CH>();
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63; the epilogue reads the
  // residual, which a predecessor wrote
  grid_wait<CH>();
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a_s = ring + s * STAGE_BYTES + wg * 64 * BK * 2;
    const uint8_t* b_s = ring + s * STAGE_BYTES + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 k are 32 bytes along the swizzled row; W: 16 k-rows of 128 B
      wgmma_bn<BN>(acc, sw128_desc(a_s + kk * 32, 16, 1024),
                   w_desc<BN>(b_s, kk), (kt > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();            // the previous k step's group is done ...
    if (kt > 0 && tid % 128 == 0)
      mbar_arrive(&empty[(kt - 1) % STAGES]);   // ... so its slot is free
  }
  wgmma_wait<0>();
  fence_acc(acc);
  grid_launch_dependents<CH>();

  // accumulator fragment: register 4j + 2h + e of thread (warp w, lane l)
  // holds row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e
  const int t = tid % 128;
  const int row0 = m0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
  epi.template fragment<BN>(acc, row0, col0);
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// the map of a row-major bf16 [rows, cols] matrix, read in boxes of
// box_rows x box_cols columns (64, with the 128-byte swizzle; 32, BN = 32's
// W tile, with the 64-byte swizzle), zeros outside
inline cudaError_t make_map(CUtensorMap* m, const void* p, int rows, int cols,
                            int box_rows, int box_cols = BK) {
  const EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (!aligned(p, 16) || cols % 8 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         box_cols == BK ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// W's maps, by (pointer, shape, box width).  A map depends on nothing
// else, so an entry can never go stale: a freed weight's address reused at
// the same shape gets the same map.  Round-robin replacement past CAP
// entries.
class WeightMaps {
 public:
  cudaError_t get(const void* p, int rows, int cols, CUtensorMap* out,
                  int box_cols = BK) {
    std::lock_guard<std::mutex> lock(mu_);
    for (int i = 0; i < n_; ++i) {
      const Entry& e = entries_[i];
      if (e.p == p && e.rows == rows && e.cols == cols &&
          e.box_cols == box_cols) {
        *out = e.map;
        return cudaSuccess;
      }
    }
    Entry e{p, rows, cols, box_cols, {}};
    const cudaError_t err = make_map(&e.map, p, rows, cols, BK, box_cols);
    if (err != cudaSuccess) return err;
    entries_[n_ < CAP ? n_++ : next_++ % CAP] = e;
    *out = e.map;
    return cudaSuccess;
  }

 private:
  static constexpr int CAP = 512;
  struct Entry {
    const void* p;
    int rows, cols, box_cols;
    CUtensorMap map;
  };
  std::mutex mu_;
  Entry entries_[CAP];
  int n_ = 0, next_ = 0;
};

inline WeightMaps& weight_maps() {
  static WeightMaps maps;
  return maps;
}

// The tile of an M x N product: BN from N alone (the instruction shape,
// so rows stay batch-independent); BM = 128 where that still gives a block
// to every SM, else 64 (twice the blocks at small M)
inline int tile_n(int N) { return N >= 1024 ? 128 : 64; }
inline int tile_m(int M, int N) {
  const int bn = tile_n(N);
  const long long blocks = (long long)((M + 127) / 128) * ((N + bn - 1) / bn);
  return blocks >= NUM_SMS ? 128 : 64;
}

template <int NC, int BN, bool CH, class Epi>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& w_map,
                   const Epi& epi, int M, int N, int K, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NC, BN>();
  static std::atomic<unsigned long long> configured{0};   // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(gemm_tc_kernel<NC, BN, Epi, CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const dim3 grid((N + BN - 1) / BN, (M + 64 * NC - 1) / (64 * NC));
  return launch_kernel<CH>(gemm_tc_kernel<NC, BN, Epi, CH>, grid,
                           NC * 128 + 32, smem, stream, a_map, w_map, epi, K);
}

// A [M, K] @ W [K, N] on the BM x BN tile (BM 64 or 128, BN 64 or 128),
// handed to epi; N is W's row length; CH: launch_kernel's
template <bool CH = false, class Epi>
cudaError_t run(const bf16* A, const bf16* W, const Epi& epi, int M, int N,
                int K, int bm, int bn, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 || !aligned(A, 16) ||
      !aligned(W, 16))
    return cudaErrorInvalidValue;
  CUtensorMap a_map, w_map;
  cudaError_t err = weight_maps().get(W, K, N, &w_map);
  if (err != cudaSuccess) return err;
  err = make_map(&a_map, A, M, K, bm);
  if (err != cudaSuccess) return err;
  if (bm == 128)
    return bn == 128 ? launch<2, 128, CH>(a_map, w_map, epi, M, N, K, stream)
                     : launch<2, 64, CH>(a_map, w_map, epi, M, N, K, stream);
  return bn == 128 ? launch<1, 128, CH>(a_map, w_map, epi, M, N, K, stream)
                   : launch<1, 64, CH>(a_map, w_map, epi, M, N, K, stream);
}

// W's TMA box width for BN: 64 (128-byte swizzle), or 32 at BN = 32
inline int w_box(int bn) { return bn == 32 ? 32 : BK; }

// The window-parts layer's tile (csrc/window_parts.cu;
// ops/window_parts.py product_tile mirrors it): BM = 64, and BN from N
// alone, the widest of 128, 64 and 32 that still cuts N into at least 16
// column tiles, so a 512-row product (8 row tiles) runs at least 128
// blocks on the 132 SMs; rows stay bitwise batch-independent, and an
// output's bits do not depend on BN (#8's, PERF.md).  At N = 512 and K =
// d_ff = 2048 (w2) BN = 32 reads A 16 times where BN = 64 read it 8, and
// still ran faster than BN = 64 unsplit or split in K (PERF.md)
inline int parts_tile_n(int N) {
  return N >= 16 * 128 ? 128 : N >= 16 * 64 ? 64 : 32;
}

// A [M, K] @ W [K, N] on gemm_tc_kernel's 64 x BN tile (the window-parts
// layer's products whose A a predecessor wrote), handed to epi
template <int BN, bool CH, class Epi>
cudaError_t run_parts(const bf16* A, const bf16* W, const Epi& epi, int M,
                      int N, int K, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 || !aligned(A, 16) ||
      !aligned(W, 16))
    return cudaErrorInvalidValue;
  CUtensorMap a_map, w_map;
  cudaError_t err = weight_maps().get(W, K, N, &w_map, w_box(BN));
  if (err != cudaSuccess) return err;
  err = make_map(&a_map, A, M, K, 64);
  if (err != cudaSuccess) return err;
  return launch<1, BN, CH>(a_map, w_map, epi, M, N, K, stream);
}

// C = epilogue(A @ W + bias) on the tensor cores; res (nullable) is [M, N].
// BN is tile_n(width): width is N, or, for products side by side in one
// (W = [W_0 | W_1 | ...]), the width of one, so each output sums as in
// that product alone
template <bool CH>
cudaError_t gemm(const bf16* A, const bf16* W, const bf16* bias,
                 const bf16* res, bf16* C, int M, int N, int K, bool relu,
                 cudaStream_t stream, int width) {
  if (M <= 0) return cudaSuccess;
  if (!aligned(bias, 4) || !aligned(res, 4) || !aligned(C, 4))
    return cudaErrorInvalidValue;
  const LinearEpi<bf16> epi{bias, res, C, M, N, relu ? 1 : 0, 1};
  return run<CH>(A, W, epi, M, N, K, tile_m(M, N), tile_n(width), stream);
}

}  // namespace
}  // namespace tc

// The layer bodies' product: float32 on the FFMA tile (ffma_gemm.cuh), any
// shape; bf16 on the tensor cores.  There is no fallback between them: a
// bf16 product the tensor-core path cannot take returns its error.
// CH (bf16): launched as a link of a launch chain (common.cuh
// launch_kernel); float32 products are never chained (they ran slower so
// on the H100: PERF.md).  width: for products side by side in one,
// the width of one (tc::gemm); 0: N.  A float32 output does not depend on
// the tile.
template <typename T, bool CH = false>
cudaError_t product(const T* A, const T* W, const T* bias, const T* res, T* C,
                    int M, int N, int K, bool relu, cudaStream_t stream,
                    int width = 0) {
  if constexpr (sizeof(T) == 4) {
    static_assert(!CH, "float32 products are never chained");
    return ffma::gemm(A, W, bias, res, C, M, N, K, relu, stream);
  } else {
    return tc::gemm<CH>(A, W, bias, res, C, M, N, K, relu, stream,
                        width > 0 ? width : N);
  }
}

}  // namespace bfc
