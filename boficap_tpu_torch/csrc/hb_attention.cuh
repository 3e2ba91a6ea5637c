// Building block: the head-block-diagonal attention of
// scripts/bench_kernel_parts.py::_hb_kernel (:327; pallas_call :460), the
// variant of the windowed decoder layer whose two attentions score every
// head at once against a head-block-diagonal K [D, H*M] (the TPU's one
// large product instead of H small ones), per sample instead of the TPU's
// block-diagonal batching of G samples.
//
// What it computes differs from attention.cuh's block in one place: the
// softmax takes ONE max per query row across all heads (:382), and each
// head's denominator is its own segment sum (the indicator products of
// :384-386 and :420-424):
//
//   s[h, j] = (q_h . k_{j,h}) * (1/sqrt(Dh));  s = mask ? s : -1e9
//   m = max_{h, j} s[h, j]
//   p[h, j] = T(exp(s[h, j] - m) / sum_j' exp(s[h, j'] - m))
//   ctx_h = T(sum_j p[h, j] v_{j,h})
//
// The scale is the float32 1/sqrt(Dh) multiplied in, as _hb_kernel does
// (the layer kernels divide by sqrt(Dh); the two agree when sqrt(Dh) is a
// power of two, Dh = 64).  The zeros of the head-block-diagonal K and V are
// not multiplied: on the TPU they add exact zeros (q * 0 and 0 * v for
// finite q and v) to each score and context sum, so skipping them computes
// the same function.  A head whose scores all sit more than ~87 below the
// row's max across heads underflows to a zero sum and a NaN row, on the TPU
// as here: that is the variant's function, not guarded.  A fully masked row
// has every score at -1e9 in every head and comes out uniform over its own
// sample's keys per head.
//
// The design: a thread-block cluster over the heads.  A cluster of C
// blocks (C = hb_cluster(H): the largest of 8, 4, 2, 1 that divides H) a
// (sample, HB_ROWS query rows), each block holding H / C heads, so at H = 8
// a block is one head.  A block stages its heads' columns of Q (float32)
// and its rows' mask bytes, then streams its heads' columns of K, and
// after the softmax of V, in chunks of HB_KC keys (in T, rows padded by 16
// bytes) through two buffers: chunk i + 1 flies by 16-byte cp.async (where
// the widths and pointers allow; else element copies) while chunk i is
// used.  One thread a (row, head, key) scores on an fmaf chain over d,
// reading K in 16-byte chunks (conflict-free: rows are 9 chunks apart);
// every key's score stays in shared memory, so the shared memory grows by
// 4 * HB_ROWS * (H / C) + HB_ROWS bytes a key (at H = 8: 80; 2,400 keys
// fit).  Each block takes its rows' max over its heads, the cluster
// barrier publishes them, and each block reads the other blocks' maxima
// through distributed shared memory (mapa): the row's max across every
// head.  Then one warp a (row, head) forms its exps and its own sum, p
// normalised and rounded to T, and one thread a (row, head, 16 bytes of
// columns) sums p v over each chunk's keys into the float32 sums in
// shared memory (Q's place), in key order: the chunks change no bit.  The
// block of row group 0 also copies its heads' columns of source c's rows
// (the window's fresh K/V, as _hb_kernel:351-352 writes them) from each
// staged chunk into dst, once; dst must not alias a source.  A last
// cluster barrier keeps each block's maxima alive until every block has
// read them.
//
// Bound on the H100: bytes, as the layer's other attentions (a few flops a
// byte of K/V).  The first design (a block a (sample, 4 rows), the heads in
// turn, one element and one division a staged value) took 64-74 us a
// launch at bf16 W = 8 (PERF.md); this one stages each K/V slice once a
// row group, in parallel over the heads.
#pragma once

#include "attention.cuh"

namespace bfc {

constexpr int HB_THREADS = 128;   // threads a block
constexpr int HB_ROWS = 16;       // query rows a block (a W = 16 window)
constexpr int HB_KC = 64;         // keys a staged chunk of K or V

// blocks a cluster: the largest of 8, 4, 2, 1 that divides H
inline int hb_cluster(int H) { return cluster_along(H); }

// bytes a staged K or V row of a block holding hpc heads of width Dh
__host__ __device__ inline size_t hb_pitch(int hpc, int Dh, int esize) {
  return ((size_t)hpc * Dh * esize + 15) / 16 * 16 + 16;
}

// keys a chunk buffer holds at Lk keys
__host__ __device__ inline int hb_chunk(int Lk) {
  return Lk < HB_KC ? Lk : HB_KC;
}

// shared memory of one block at Lk keys, width D = H * Dh, element size
// esize; ops/window_parts.py hb_shared_bytes mirrors it
inline size_t hb_smem(int Lk, int D, int H, int esize) {
  const int hpc = H / hb_cluster(H), Dh = D / H;
  return sizeof(float) * (size_t)HB_ROWS * hpc * Dh +      // Q, the sums
         2 * (size_t)hb_chunk(Lk) * hb_pitch(hpc, Dh, esize) +  // chunks
         sizeof(float) * (size_t)HB_ROWS * hpc * Lk +      // scores
         sizeof(float) * 2 * HB_ROWS +                     // maxima
         ((size_t)HB_ROWS * Lk + 15) / 16 * 16;            // mask bytes
}

namespace hb {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one block of a cluster over the heads: (sample b, cluster rank) =
// (blockIdx.x / C, blockIdx.x % C), query rows HB_ROWS * blockIdx.y on;
// heads rank * hpc .. + hpc - 1.  vec: 16-byte copies and chunks (Dh *
// sizeof(T) a multiple of 16, every pointer and row stride aligned)
template <typename T, bool CH>
__global__ void __launch_bounds__(HB_THREADS)
    hb_attention_kernel(const T* __restrict__ q, int ldq, KeySrc<T> a,
                        KeySrc<T> c, const uint8_t* __restrict__ mask,
                        long long mask_sb, long long mask_sq, T* out, int ldo,
                        int C, int hpc, int Lq, int Dh, KvDst<T> dst,
                        bool vec) {
  constexpr int N = 16 / sizeof(T);   // elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t hb_smem_raw[];
  const int b = blockIdx.x / C, rank = blockIdx.x % C;
  const int i0 = blockIdx.y * HB_ROWS;
  const int rows = min(HB_ROWS, Lq - i0);
  const int Lk = a.rows + c.rows;
  const int kc = hb_chunk(Lk), nck = (Lk + kc - 1) / kc;
  const int w = hpc * Dh;                  // the block's columns
  const int h0 = rank * hpc;               // its first head
  const int col0 = h0 * Dh;
  const int pitch = (int)(hb_pitch(hpc, Dh, sizeof(T)) / sizeof(T));
  float* Qs = reinterpret_cast<float*>(hb_smem_raw);        // [HB_ROWS][w]
  T* buf = reinterpret_cast<T*>(Qs + HB_ROWS * w);          // [2][kc][pitch]
  float* S = reinterpret_cast<float*>(buf + (size_t)2 * kc * pitch);
  float* mx = S + HB_ROWS * hpc * Lk;      // [HB_ROWS] the block's maxima
  float* mrow = mx + HB_ROWS;              // [HB_ROWS] the cluster's
  uint8_t* mk = reinterpret_cast<uint8_t*>(mrow + HB_ROWS);  // [rows][Lk]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  grid_wait<CH>();   // q, K, V: a predecessor's outputs (common.cuh)

  // chunk ci of K (v false) or V into buffer ci % 2: its keys j0 .. j0 +
  // nk - 1 of a ++ c, this block's columns
  auto stage = [&](bool v, int ci) {
    T* bs = buf + (size_t)(ci & 1) * kc * pitch;
    const int j0 = ci * kc, nk = min(kc, Lk - j0);
    const T* pa = v ? a.v : a.k;
    const T* pc = v ? c.v : c.k;
    const int lda = v ? a.ldv : a.ldk, ldc = v ? c.ldv : c.ldk;
    auto key = [&](int j) {
      return j < a.rows
                 ? pa + ((size_t)b * a.rows + j) * lda + col0
                 : pc + ((size_t)b * c.rows + (j - a.rows)) * ldc + col0;
    };
    if (vec) {
      const int nch = w / N;
      for (int e = tid; e < nk * nch; e += HB_THREADS) {
        const int j = e / nch, d = (e % nch) * N;
        cp_async16(bs + (size_t)j * pitch + d, key(j0 + j) + d);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    } else {
      for (int e = tid; e < nk * w; e += HB_THREADS) {
        const int j = e / w, d = e % w;
        bs[(size_t)j * pitch + d] = key(j0 + j)[d];
      }
    }
  };
  // chunk ci staged, and the buffer of chunk ci + 1 (staged meanwhile)
  // free: wait for ci's copies, then the block
  auto ready = [&](bool v, int ci) {
    if (ci + 1 < nck) {
      stage(v, ci + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
  };
  // the fresh rows (source c's) of chunk ci into dst, this block's heads,
  // from the row group 0 block (the chunk is staged)
  auto fresh = [&](bool v, int ci) {
    if (blockIdx.y != 0 || dst.k == nullptr) return;
    const T* bs = buf + (size_t)(ci & 1) * kc * pitch;
    const int j0 = ci * kc, nk = min(kc, Lk - j0);
    const int jf = max(a.rows - j0, 0);    // the chunk's first fresh key
    const int s0 = dst_start(dst, b, c.rows);
    T* to = v ? dst.v : dst.k;
    for (int e = tid; e < (nk - jf) * w; e += HB_THREADS) {
      const int j = jf + e / w, d = e % w;
      to[((size_t)b * dst.Ld + s0 + j0 + j - a.rows) * dst.ld + col0 + d] =
          bs[(size_t)j * pitch + d];
    }
  };

  stage(false, 0);
  for (int e = tid; e < rows * w; e += HB_THREADS) {
    const int r = e / w, d = e % w;
    Qs[r * w + d] =
        Cvt<T>::to_f(q[((size_t)b * Lq + i0 + r) * ldq + col0 + d]);
  }
  for (int e = tid; e < rows * Lk; e += HB_THREADS) {
    const int r = e / Lk, j = e % Lk;
    mk[e] = mask[b * mask_sb + (long long)(i0 + r) * mask_sq + j];
  }

  // scores: one thread a (row, head, key) of each K chunk, an fmaf chain
  // over d
  const float factor = score_factor<Scale::kMulInvSqrt>(Dh);
  for (int ci = 0; ci < nck; ++ci) {
    ready(false, ci);
    const T* bs = buf + (size_t)(ci & 1) * kc * pitch;
    const int j0 = ci * kc, nk = min(kc, Lk - j0);
    for (int e = tid; e < rows * hpc * nk; e += HB_THREADS) {
      const int j = e % nk, rh = e / nk, hl = rh % hpc, r = rh / hpc;
      const float* qr = Qs + r * w + hl * Dh;
      const T* kr = bs + (size_t)j * pitch + hl * Dh;
      float s = 0.f;
      if (vec) {
        for (int d = 0; d < Dh; d += N) {
          float f[N];
          att::to_floats<T>(*reinterpret_cast<const uint4*>(kr + d), f);
#pragma unroll
          for (int u = 0; u < N; ++u) s = fmaf(qr[d + u], f[u], s);
        }
      } else {
        for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], Cvt<T>::to_f(kr[d]), s);
      }
      s = scale_score<Scale::kMulInvSqrt>(s, factor);
      S[rh * Lk + j0 + j] = mk[r * Lk + j0 + j] ? s : MASK_FILL;
    }
    fresh(false, ci);
    __syncthreads();   // chunk ci used: its buffer may take ci + 2
  }
  grid_launch_dependents<CH>();   // q and K are read
  stage(true, 0);
  for (int e = tid; e < rows * w; e += HB_THREADS) Qs[e] = 0.f;

  // the max of a row over this block's heads, then over the cluster's
  for (int r = warp; r < rows; r += HB_THREADS / 32) {
    float m = -INFINITY;
    for (int i = lane; i < hpc * Lk; i += 32) m = fmaxf(m, S[r * hpc * Lk + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(att::FULL, m, off));
    if (lane == 0) mx[r] = m;
  }
  cluster_arrive();   // this block's maxima are published ...
  cluster_wait();     // ... and every block's
  {
    // thread r * C + k reads block k's max of row r (all at once); the C
    // lanes of a row reduce by shuffles (C divides 32, rows * C <= 128)
    float m = tid < rows * C ? ld_cluster(mx + tid / C, tid % C) : -INFINITY;
    for (int off = C / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(att::FULL, m, off));
    if (tid < rows * C && tid % C == 0) mrow[tid / C] = m;
  }
  cluster_arrive();   // this block has read the others' maxima
  __syncthreads();

  // each head's sum of exp; p normalised, then rounded to T
  for (int rh = warp; rh < rows * hpc; rh += HB_THREADS / 32) {
    float* sr = S + rh * Lk;
    const float m = mrow[rh / hpc];
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(att::FULL, sum, off);
    for (int j = lane; j < Lk; j += 32) sr[j] = round_to<T>(sr[j] / sum);
  }

  // contexts: the float32 sums in Qs, over each V chunk's keys in order;
  // one thread a (row, head, chunk of N columns) where vec
  for (int ci = 0; ci < nck; ++ci) {
    ready(true, ci);
    const T* bs = buf + (size_t)(ci & 1) * kc * pitch;
    const int j0 = ci * kc, nk = min(kc, Lk - j0);
    if (vec) {
      const int nch = Dh / N;
      for (int e = tid; e < rows * hpc * nch; e += HB_THREADS) {
        const int d = (e % nch) * N, rh = e / nch, hl = rh % hpc,
                  r = rh / hpc;
        const float* pr = S + rh * Lk + j0;
        const T* vc = bs + hl * Dh + d;
        float* sums = Qs + r * w + hl * Dh + d;
        float acc[N];
#pragma unroll
        for (int u = 0; u < N; ++u) acc[u] = sums[u];
        for (int j = 0; j < nk; ++j) {
          float f[N];
          att::to_floats<T>(
              *reinterpret_cast<const uint4*>(vc + (size_t)j * pitch), f);
          const float p = pr[j];
#pragma unroll
          for (int u = 0; u < N; ++u) acc[u] = fmaf(p, f[u], acc[u]);
        }
#pragma unroll
        for (int u = 0; u < N; ++u) sums[u] = acc[u];
      }
    } else {
      for (int e = tid; e < rows * w; e += HB_THREADS) {
        const int d = e % w, r = e / w, hl = d / Dh;
        const float* pr = S + (r * hpc + hl) * Lk + j0;
        float acc = Qs[e];
        for (int j = 0; j < nk; ++j)
          acc = fmaf(pr[j], Cvt<T>::to_f(bs[(size_t)j * pitch + d]), acc);
        Qs[e] = acc;
      }
    }
    fresh(true, ci);
    __syncthreads();   // chunk ci used: its buffer may take ci + 2
  }

  T* orow = out + ((size_t)b * Lq + i0) * ldo + col0;
  if (vec) {
    for (int e = tid; e < rows * w / N; e += HB_THREADS) {
      const int r = e / (w / N), d = (e % (w / N)) * N;
      float acc[N];
#pragma unroll
      for (int u = 0; u < N; ++u) acc[u] = Qs[r * w + d + u];
      *reinterpret_cast<uint4*>(orow + (size_t)r * ldo + d) =
          att::from_floats<T>(acc);
    }
  } else {
    for (int e = tid; e < rows * w; e += HB_THREADS)
      orow[(size_t)(e / w) * ldo + e % w] = Cvt<T>::from_f(Qs[e]);
  }
  cluster_wait();     // every block has read this block's maxima
}

}  // namespace hb

// keys a ++ c for each sample's Lq query rows; q points at head 0's column
// of a row-major [B*Lq, ldq] buffer, out at [B*Lq, ldo]; c's rows also go to
// dst, if it has k.  CH: launched as a link of a launch chain; the launch
// carries the cluster dimension and, chained, programmatic serialization,
// in one cudaLaunchKernelEx.
template <typename T, bool CH = false>
cudaError_t hb_attention(const T* q, int ldq, KeySrc<T> a, KeySrc<T> c,
                         const uint8_t* mask, long long mask_sb,
                         long long mask_sq, T* out, int ldo, int B, int H,
                         int Lq, int Dh, cudaStream_t stream,
                         KvDst<T> dst = {}) {
  const int Lk = a.rows + c.rows;
  if (Lk < 1 || H < 1 || Dh < 1) return cudaErrorInvalidValue;
  if (B <= 0 || Lq <= 0) return cudaSuccess;
  const size_t smem = hb_smem(Lk, H * Dh, H, sizeof(T));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int C = hb_cluster(H), hpc = H / C;
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int es = sizeof(T);
  const bool vec =
      (Dh * es) % 16 == 0 && al(q) && al(out) && al(a.k) && al(a.v) &&
      (ldq * es) % 16 == 0 && (ldo * es) % 16 == 0 && (a.ldk * es) % 16 == 0 &&
      (a.ldv * es) % 16 == 0 &&
      (c.rows == 0 || (al(c.k) && al(c.v) && (c.ldk * es) % 16 == 0 &&
                       (c.ldv * es) % 16 == 0));
  auto kernel = hb::hb_attention_kernel<T, CH>;
  BFC_TRY(allow_smem(kernel, smem));
  return launch_cluster<CH>(kernel, dim3(B * C, (Lq + HB_ROWS - 1) / HB_ROWS),
                            HB_THREADS, smem, stream, C, q, ldq, a, c, mask,
                            mask_sb, mask_sq, out, ldo, C, hpc, Lq, Dh, dst,
                            vec);
}

}  // namespace bfc
