// Kernel K4's device code and launchers: flash_fwd_kernel (K4a),
// flash_dkv_kernel (K4b) and flash_dq_kernel (K4c), their geometry and
// the host functions fwd, dkv and dq that launch one instance; the wide
// K4a (D above 256) and what the wide K4b and K4c share.  The design and
// its figures are in flash_attn.cu's header comment.  Five sources include
// this file, so that nvcc builds their instances in parallel:
// flash_attn.cu (float32 at DP 32 to 192, and the C interface),
// flash_attn_bf16.cu (bf16 at DP 32 to 192), flash_attn_d256.cu (DP 256),
// flash_attn_wide.cu (K4a above 256) and flash_attn_wide_bwd.cu (K4b and
// K4c above 256).  Everything is in an unnamed namespace, as in
// common.cuh.
#pragma once

#include "common.cuh"

#include <math_constants.h>

#include <cfloat>
#include <type_traits>

namespace ptk {
namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;          // rows a block owns
// jax's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX in double rounded to float
constexpr float MASK_VALUE = static_cast<float>(-0.7 * double(FLT_MAX));

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float logit(float dot, float scale, int qv,
                                       int kv) {
  const float s = dot * scale;
  return s + (qv == kv ? 0.f : MASK_VALUE);
}

// ------------------------------------------------------ device functions
// TF32 mma.sync as inline PTX; the bf16 product, ldmatrix and cp.async
// are common.cuh's.

// c += a . b, m16n8k8, TF32 operands (given as float bit patterns)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a.b as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(c, alo, bhi0, bhi1);
  mma_tf32(c, ahi, blo0, blo1);
  mma_tf32(c, ahi, bhi0, bhi1);
}

// x = hi + lo: hi is x with the 13 low mantissa bits cleared (a TF32
// value), lo = x - hi (exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc += A . B^T over DP columns for one warp (the first `cols` of them,
// a multiple of 32, where cols < DP): A the warp's 16 rows of a resident
// matrix, B the BN rows of a streamed tile, both of pitch LD in shared
// memory; acc[j] holds columns 8j + 2t, 8j + 2t + 1 of rows g and g + 8.
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void tile_abt_add(float (&acc)[BN / 8][4],
                                             const T* a, const T* b,
                                             int cols = DP) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int c2 = 0; c2 < DP / 32; ++c2) {
      if (c2 * 32 >= cols) break;
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, a + (lane & 15) * LD + c2 * 32 + (lane >> 4) * 8);
      ldsm_x4(a1, a + (lane & 15) * LD + c2 * 32 + 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, b + (j * 8 + (lane & 7)) * LD + c2 * 32 +
                        (lane >> 3) * 8);
        mma_bf16(acc[j], a0, kb[0], kb[1]);
        mma_bf16(acc[j], a1, kb[2], kb[3]);
      }
    }
  } else {
    const float* ap = reinterpret_cast<const float*>(a) + g * LD + t;
    const float* bp = reinterpret_cast<const float*>(b) + g * LD + t;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      if (kk * 8 >= cols) break;
      uint32_t ahi[4], alo[4];
      split_tf32(ap[kk * 8], ahi[0], alo[0]);
      split_tf32(ap[8 * LD + kk * 8], ahi[1], alo[1]);
      split_tf32(ap[kk * 8 + 4], ahi[2], alo[2]);
      split_tf32(ap[8 * LD + kk * 8 + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float* p = bp + j * 8 * LD + kk * 8;
        uint32_t bhi0, blo0, bhi1, blo1;
        split_tf32(p[0], bhi0, blo0);
        split_tf32(p[4], bhi1, blo1);
        mma_3xtf32(acc[j], ahi, alo, bhi0, bhi1, blo0, blo1);
      }
    }
  }
}

// acc = A . B^T (tile_abt_add from zero)
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void tile_abt(float (&acc)[BN / 8][4],
                                         const T* a, const T* b,
                                         int cols = DP) {
  zero_acc(acc);
  tile_abt_add<T, DP, BN, LD>(acc, a, b, cols);
}

// acc += T(x) . B for one warp: x (16 rows by BN, laid out as tile_abt
// leaves it) is the A operand straight from registers, B the BN rows of a
// streamed tile (pitch LD); the product contracts over those rows.  Only
// the first `cols` columns of acc (a multiple of 16, where cols < DP)
// are formed.
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void tile_xb(float (&acc)[DP / 8][4],
                                        const float (&x)[BN / 8][4],
                                        const T* b, int cols = DP) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                              pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                              pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        if (n2 * 16 >= cols) break;
        uint32_t vb[4];
        ldsm_x4_trans(vb, b + (kk * 16 + (lane & 15)) * LD + n2 * 16 +
                              (lane >> 4) * 8);
        mma_bf16(acc[2 * n2], xa, vb[0], vb[1]);
        mma_bf16(acc[2 * n2 + 1], xa, vb[2], vb[3]);
      }
    }
  } else {
    const float* bp = reinterpret_cast<const float*>(b) + 2 * t * LD + g;
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      // A fragment columns t, t + 4 are rows 2t, 2t + 1 of this k step
      uint32_t xhi[4], xlo[4];
      split_tf32(x[kk][0], xhi[0], xlo[0]);
      split_tf32(x[kk][2], xhi[1], xlo[1]);
      split_tf32(x[kk][1], xhi[2], xlo[2]);
      split_tf32(x[kk][3], xhi[3], xlo[3]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        if (n * 8 >= cols) break;
        const float* p = bp + kk * 8 * LD + n * 8;
        uint32_t bhi0, blo0, bhi1, blo1;
        split_tf32(p[0], bhi0, blo0);
        split_tf32(p[LD], bhi1, blo1);
        mma_3xtf32(acc[n], xhi, xlo, bhi0, bhi1, blo0, blo1);
      }
    }
  }
}

// Write a warp's accumulator strip (the thread's rows row0 and row0 + 8,
// columns 8n + 2t and 8n + 2t + 1) as T to out (a row every D values)
// rows below tlen and columns below cols.
template <typename T, int ND>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[ND][4],
                                          int row0, int tlen, int D,
                                          int cols) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= cols) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= tlen) continue;
      T* dst = out + static_cast<size_t>(row) * D + col;
      if constexpr (std::is_same<T, bf16>::value)
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      else
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ K4a
// K4a's geometry: BN keys a tile (k4a_block_k in ops/kernels/
// flash_attn.py), a pitch of DP + 16 bytes (conflict-free ldmatrix rows in
// bf16, 32-bit fragment loads in float32), and a ring of STAGES stages of
// K tile | V tile | kv_valid.  Up to DP = 128, Q is staged once through
// stage 1's K and V tiles, which hold 2 * BN >= BM rows of the same pitch,
// and held in registers.  Above it (QRES, DP = 192 and 256) Q's fragments
// and O's 96 or 128 accumulators a thread would not fit in 255 registers,
// so Q stays resident in shared memory ahead of the ring, kQ bytes, and
// each tile re-reads it as the backward kernels re-read their resident
// strips.  BN is 32 keys in float32 and 64 in bf16, but 32 in bf16 at
// DP = 256: half the stages' shared memory, so that two blocks fit an SM
// beside O's 128 accumulators a thread.
template <typename T, int DP>
struct FwdGeo {
  static constexpr int BN =
      std::is_same<T, float>::value || DP > 192 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int LD = DP + 16 / sizeof(T);
  static constexpr bool QRES = DP > 128;
  static constexpr size_t kQ = QRES ? size_t(BM) * LD * sizeof(T) : 0;
  static constexpr size_t kTile = size_t(BN) * LD * sizeof(T);
  static constexpr size_t kStage = 2 * kTile + BN * sizeof(int);
  static constexpr size_t kSmem = kQ + STAGES * kStage;
  static_assert(2 * BN >= BM, "Q is staged in one stage's K and V tiles");
  static_assert(kTile % 16 == 0 && kQ % 16 == 0,
                "tiles stay 16-byte aligned");
  static_assert(kSmem <= 232448, "a block has at most 227 KB");
};

// cp.async columns [c0, c0 + DP) of rows [row0, row0 + nrows) of a (tlen,
// D) row-major matrix into shared rows of pitch LD; zero past tlen and in
// columns from D on
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_rows_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int nrows,
                                                int tlen, int D,
                                                int c0 = 0) {
  constexpr int EV = 16 / sizeof(T);
  constexpr int VPR = DP / EV;
  for (int i = threadIdx.x; i < nrows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * EV;
    const bool ok = row0 + r < tlen && c0 + c < D;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(row0 + r) * D + c0 + c : src,
               ok);
  }
}

// cp.async the N 32-bit values src[i0 .. i0 + N) to dst; zero from len on
template <int N>
__device__ __forceinline__ void load_vec_async(void* dst, const void* src,
                                               int i0, int len) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool ok = i0 + i < len;
    cp_async4(static_cast<uint32_t*>(dst) + i,
              static_cast<const uint32_t*>(src) + (ok ? i0 + i : 0), ok);
  }
}

// K4a's step over one tile of scores (sacc, keys k0 + 8j + 2t (+1) of the
// thread's rows g and g + 8, kv_valid of the tile in kvs): the logits,
// the running max m and sum l, p = exp(s - m_new) in place of s, and O
// rescaled by alpha = exp(m_old - m_new)
template <int NT, int ND>
__device__ __forceinline__ void online_softmax(float (&sacc)[NT][4],
                                               float (&oacc)[ND][4],
                                               const int* kvs, int k0,
                                               int Tk, float scale, int qv0,
                                               int qv1, float (&m_run)[2],
                                               float (&l_run)[2]) {
  const int t = threadIdx.x & 3;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t;
    const int2 kv2 = *reinterpret_cast<const int2*>(kvs + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c + (e & 1);
      const int kvv = (e & 1) ? kv2.y : kv2.x;
      const float sv =
          k0 + col < Tk ? logit(sacc[j][e], scale, e < 2 ? qv0 : qv1, kvv)
                        : -CUDART_INF_F;
      sacc[j][e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);   // finite: a key is in
    alpha[r] = __expf(m_run[r] - m_new);          // 0 at the first tile
    m_run[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(sacc[j][e] - m_run[e >> 1]);   // -inf -> 0
      sacc[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + sum[r];
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    oacc[n][0] *= alpha[0];
    oacc[n][1] *= alpha[0];
    oacc[n][2] *= alpha[1];
    oacc[n][3] *= alpha[1];
  }
}

// K4a's end: lse = m + log l of the thread's rows (written when `write`),
// and O scaled by 1 / l (1 where l == 0)
template <int ND>
__device__ __forceinline__ void finish_rows(float (&oacc)[ND][4],
                                            const float (&m_run)[2],
                                            const float (&l_run)[2],
                                            float* lse_bh, int row0, int Tq,
                                            bool write) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
    const int row = row0 + 8 * r;
    if (write && (threadIdx.x & 3) == 0 && row < Tq)
      lse_bh[row] = m_run[r] + logf(l_run[r]);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    oacc[n][0] *= inv[0];
    oacc[n][1] *= inv[0];
    oacc[n][2] *= inv[1];
    oacc[n][3] *= inv[1];
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qvalid,
                 const int* __restrict__ kvalid, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 float scale) {
  using G = FwdGeo<T, DP>;
  constexpr int BN = G::BN, LD = G::LD, NT = BN / 8, ND = DP / 8;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  auto ktile = [&](int s) {
    return reinterpret_cast<T*>(smem + G::kQ + s * G::kStage);
  };
  auto vtile = [&](int s) {
    return reinterpret_cast<T*>(smem + G::kQ + s * G::kStage + G::kTile);
  };
  auto kvtile = [&](int s) {
    return reinterpret_cast<int*>(smem + G::kQ + s * G::kStage +
                                  2 * G::kTile);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;       // fragment row, quad lane
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const int* kvb = kvalid + static_cast<size_t>(b) * Tk;
  const int ntiles = (Tk + BN - 1) / BN;

  auto issue_tile = [&](int tile, int s) {
    const int k0 = tile * BN;
    load_rows_async<T, DP, LD>(ktile(s), k + koff, k0, BN, Tk, D);
    load_rows_async<T, DP, LD>(vtile(s), v + koff, k0, BN, Tk, D);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      cp_async4(kvtile(s) + i, k0 + i < Tk ? kvb + k0 + i : kvb,
                k0 + i < Tk);
  };

  // One commit group per tile (possibly empty), so that wait_group<1> at
  // the top of step i means tile i has landed.  QRES: Q to its resident
  // rows with tile 0, then tile 1.  Otherwise Q through stage 1, tile 0
  // into stage 0; Q's fragments to registers; then tile 1 into stage 1.
  const T* qw = reinterpret_cast<const T*>(smem) + warp * 16 * LD;
  // bf16: ldmatrix A fragments, two per 32 columns; float32: the raw
  // values of the m16n8k8 A fragments (rows g, g + 8; columns t, t + 4)
  uint32_t qf[G::QRES ? 1 : (kBf16 ? DP / 16 : ND)][4];
  if constexpr (G::QRES) {
    load_rows_async<T, DP, LD>(reinterpret_cast<T*>(smem), q + qoff, q0,
                               BM, Tq, D);
    issue_tile(0, 0);
    cp_async_commit();
  } else {
    load_rows_async<T, DP, LD>(ktile(1), q + qoff, q0, BM, Tq, D);
    cp_async_commit();
    issue_tile(0, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qs = ktile(1) + warp * 16 * LD;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(qf[kk], qs + (lane & 15) * LD + kk * 16 +
                            (lane >> 4) * 8);
    } else {
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const float* p = reinterpret_cast<const float*>(qs) + kk * 8 + t;
        qf[kk][0] = __float_as_uint(p[g * LD]);
        qf[kk][1] = __float_as_uint(p[(g + 8) * LD]);
        qf[kk][2] = __float_as_uint(p[g * LD + 4]);
        qf[kk][3] = __float_as_uint(p[(g + 8) * LD + 4]);
      }
    }
    __syncthreads();                     // every warp holds its Q
  }
  if (ntiles > 1) issue_tile(1, 1);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;   // and row0 + 8
  const int qv0 = row0 < Tq ? qvalid[static_cast<size_t>(b) * Tq + row0] : 0;
  const int qv1 =
      row0 + 8 < Tq ? qvalid[static_cast<size_t>(b) * Tq + row0 + 8] : 0;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();                     // tile it is in stage it % 2
    const int s = it % G::STAGES, k0 = it * BN;
    const T* ks = ktile(s);
    const T* vs = vtile(s);
    const int* kvs = kvtile(s);

    // S = Q K^T: sacc[j] holds keys 8j + 2t, 8j + 2t + 1 of rows g, g + 8
    float sacc[NT][4];
    if constexpr (G::QRES) {
      tile_abt<T, DP, BN, LD>(sacc, qw, ks);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
      if constexpr (kBf16) {
#pragma unroll
        for (int c2 = 0; c2 < DP / 32; ++c2) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t kb[4];
            ldsm_x4(kb, ks + (j * 8 + (lane & 7)) * LD + c2 * 32 +
                            (lane >> 3) * 8);
            mma_bf16(sacc[j], qf[2 * c2], kb[0], kb[1]);
            mma_bf16(sacc[j], qf[2 * c2 + 1], kb[2], kb[3]);
          }
        }
      } else {
        const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) {
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(qf[kk][e]), ahi[e], alo[e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float* p = kf + (j * 8 + g) * LD + kk * 8 + t;
            uint32_t bhi0, blo0, bhi1, blo1;
            split_tf32(p[0], bhi0, blo0);
            split_tf32(p[4], bhi1, blo1);
            mma_3xtf32(sacc[j], ahi, alo, bhi0, bhi1, blo0, blo1);
          }
        }
      }
    }

    // logits, the tile's row max, then p = exp(s - m_new) in place
    online_softmax(sacc, oacc, kvs, k0, Tk, scale, qv0, qv1, m_run, l_run);
    tile_xb<T, DP, BN, LD>(oacc, sacc, vs);     // O += T(P) V
    __syncthreads();                     // every warp is done with stage s
    if (it + G::STAGES < ntiles) issue_tile(it + G::STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // o = acc * (1 / l), straight from the accumulators
  finish_rows(oacc, m_run, l_run, lse + static_cast<size_t>(bh) * Tq, row0,
              Tq, true);
  store_acc<T>(o + qoff, oacc, row0, Tq, D, D);
}

// ------------------------------------------------------------ K4b, K4c
// The backward kernels' geometry: K4a's BN and pitch; the block's 64 rows
// of two matrices resident (K4c: Q, dO; K4b: K, V); a ring of STAGES
// stages, each two streamed tiles and NVEC vectors of BN 32-bit values
// (K4c: kv_valid; K4b: q_valid, lse, di).  At D = 96 that is 100-103 KB
// in float32 (BN 32) and 79-80 KB in bf16 (BN 64): two blocks an SM,
// which the registers allow too (ptxas: K4c 177 and K4b 209 a thread in
// float32, 244 and 254 in bf16, no spills).  Both kernels declare a
// minimum of one block an SM: without it ptxas traded spills for the
// register count of a third block (168 registers and an 8-byte spill in
// float32 at DP = 128, 16 bytes in bf16 at BN 32), and the float32
// instances ran slower on the H100.  At DP = 256 in float32 the two
// resident strips take 130 KB, and two stages of 32 rows (130 KB more)
// would not fit in the 227 KB a block may have: the tiles are 16 rows
// there (195-196 KB in all), so that the next tile still loads while this
// one computes.
template <typename T, int DP, int NVEC>
struct BwdGeo {
  // K4a's tiles, but 32 rows in bf16 above DP = 96, where 64 spill in K4b,
  // and 16 in float32 at DP = 256
  static constexpr int BN = std::is_same<T, float>::value && DP > 192 ? 16
                            : DP > 96 ? 32 : FwdGeo<T, DP>::BN;
  static constexpr int LD = FwdGeo<T, DP>::LD;
  static constexpr int STAGES = 2;
  static constexpr size_t kRows = size_t(BM) * LD * sizeof(T);
  static constexpr size_t kTile = size_t(BN) * LD * sizeof(T);
  static constexpr size_t kStage = 2 * kTile + NVEC * BN * sizeof(float);
  static constexpr size_t kSmem = 2 * kRows + STAGES * kStage;
  static_assert(kRows % 16 == 0 && kStage % 16 == 0,
                "tiles stay 16-byte aligned");
  static_assert(kSmem <= 232448, "a block has at most 227 KB");
};

// ------------------------------------------------------------------ K4c
// p = exp(s - lse), then ds = ((dp - di) * p) * scale in place of s (key
// columns k0 + 8j + 2t (+1), kv_valid of the tile in kvs; the thread's
// rows' lse, di, q_valid and whether they are below Tq in registers)
template <int NT>
__device__ __forceinline__ void dq_ds(float (&sacc)[NT][4],
                                      const float (&dpacc)[NT][4],
                                      const int* kvs, int k0, int Tk,
                                      float scale, const bool (&in)[2],
                                      const int (&qv)[2],
                                      const float (&lse_r)[2],
                                      const float (&di_r)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t;
    const int2 kv2 = *reinterpret_cast<const int2*>(kvs + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      const float p =
          in[r] && k0 + c + odd < Tk
              ? __expf(logit(sacc[j][e], scale, qv[r],
                             odd ? kv2.y : kv2.x) - lse_r[r])
              : 0.f;
      sacc[j][e] = ((dpacc[j][e] - di_r[r]) * p) * scale;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ qvalid,
                const int* __restrict__ kvalid, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                T* __restrict__ dq, int H, int Tq, int Tk, int D,
                float scale) {
  using G = BwdGeo<T, DP, 1>;
  constexpr int BN = G::BN, LD = G::LD, NT = BN / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + G::kRows);
  auto stage = [&](int s) { return smem + 2 * G::kRows + s * G::kStage; };
  auto ktile = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto vtile = [&](int s) {
    return reinterpret_cast<T*>(stage(s) + G::kTile);
  };
  auto kvtile = [&](int s) {
    return reinterpret_cast<int*>(stage(s) + 2 * G::kTile);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;                     // fragment row
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const int* kvb = kvalid + static_cast<size_t>(b) * Tk;
  const int ntiles = (Tk + BN - 1) / BN;

  auto issue_tile = [&](int tile, int s) {
    const int k0 = tile * BN;
    load_rows_async<T, DP, LD>(ktile(s), k + koff, k0, BN, Tk, D);
    load_rows_async<T, DP, LD>(vtile(s), v + koff, k0, BN, Tk, D);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      cp_async4(kvtile(s) + i, k0 + i < Tk ? kvb + k0 + i : kvb,
                k0 + i < Tk);
  };

  // Q and dO go with tile 0, then tile 1: one commit group per tile
  // (possibly empty), so that wait_group<1> at the top of step i means
  // tile i has landed
  load_rows_async<T, DP, LD>(qs, q + qoff, q0, BM, Tq, D);
  load_rows_async<T, DP, LD>(dos, dout + qoff, q0, BM, Tq, D);
  issue_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) issue_tile(1, 1);
  cp_async_commit();

  // the statistics of the thread's rows row0 and row0 + 8
  const int row0 = q0 + warp * 16 + g;
  bool in[2];
  int qv[2];
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    in[r] = row < Tq;
    const size_t i = static_cast<size_t>(bh) * Tq + row;
    qv[r] = in[r] ? qvalid[static_cast<size_t>(b) * Tq + row] : 0;
    lse_r[r] = in[r] ? lse[i] : 0.f;
    di_r[r] = in[r] ? di[i] : 0.f;
  }
  float dqacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    dqacc[n][0] = dqacc[n][1] = dqacc[n][2] = dqacc[n][3] = 0.f;
  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();                     // tile it is in stage it % 2
    const int s = it % G::STAGES, k0 = it * BN;
    const int* kvs = kvtile(s);
    float sacc[NT][4], dpacc[NT][4];
    tile_abt<T, DP, BN, LD>(sacc, qw, ktile(s));
    tile_abt<T, DP, BN, LD>(dpacc, dow, vtile(s));
    dq_ds(sacc, dpacc, kvs, k0, Tk, scale, in, qv, lse_r, di_r);
    tile_xb<T, DP, BN, LD>(dqacc, sacc, ktile(s));   // dQ += T(dS) K
    __syncthreads();                     // every warp is done with stage s
    if (it + G::STAGES < ntiles) issue_tile(it + G::STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_acc<T>(dq + qoff, dqacc, row0, Tq, D, D);
}

// ------------------------------------------------------------------ K4b
// p^T = exp(s^T - lse) in place of s^T: column c is query i0 + c (q_valid
// and lse of the tile's queries from the stage); the thread's keys'
// kv_valid and whether they are below Tk in registers
template <int NT>
__device__ __forceinline__ void dkv_p(float (&sacc)[NT][4], const int* qvs,
                                      const float* lses, int i0, int Tq,
                                      float scale, const bool (&in)[2],
                                      const int (&kv)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t;
    const int2 qv2 = *reinterpret_cast<const int2*>(qvs + c);
    const float2 l2 = *reinterpret_cast<const float2*>(lses + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      sacc[j][e] = in[r] && i0 + c + odd < Tq
                       ? __expf(logit(sacc[j][e], scale,
                                      odd ? qv2.y : qv2.x, kv[r]) -
                                (odd ? l2.y : l2.x))
                       : 0.f;
    }
  }
}

// ds^T = ((dp^T - di) * p^T) * scale in place of p^T (x); di of the
// tile's queries from the stage
template <int NT>
__device__ __forceinline__ void ds_from_dp(float (&x)[NT][4],
                                           const float (&dpacc)[NT][4],
                                           const float* dis, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dis + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[j][e] = ((dpacc[j][e] - ((e & 1) ? d2.y : d2.x)) * x[j][e]) * scale;
  }
}

// ds_from_dp with dP^T = V dO^T from the warp's resident V rows and the
// tile's dO
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void ds_in_place(float (&x)[BN / 8][4],
                                            const T* vw, const T* dos,
                                            const float* dis, float scale) {
  float dpacc[BN / 8][4];
  tile_abt<T, DP, BN, LD>(dpacc, vw, dos);
  ds_from_dp(x, dpacc, dis, scale);
}

// SPLIT (DP = 192 and 256): dK's and dV's accumulators together, 192 or
// 256 floats a thread beside two score tiles, would spill, so the grid's
// z splits the work over two blocks of the same 64 keys: z = 0 forms dV,
// z = 1 dK, each in one accumulator.  Both compute S^T (10 T^2 D
// products a head instead of 8), in one launch.
template <int DP>
constexpr bool kDkvSplit = DP > 128;

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qvalid,
                 const int* __restrict__ kvalid, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                 int Tk, int D, float scale) {
  using G = BwdGeo<T, DP, 3>;
  constexpr int BN = G::BN, LD = G::LD, NT = BN / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + G::kRows);
  auto stage = [&](int s) { return smem + 2 * G::kRows + s * G::kStage; };
  auto qtile = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto dotile = [&](int s) {
    return reinterpret_cast<T*>(stage(s) + G::kTile);
  };
  // q_valid | lse | di of the tile's queries
  auto vec = [&](int s, int i) { return stage(s) + 2 * G::kTile +
                                        i * BN * sizeof(float); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;                     // fragment row
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const int* qvb = qvalid + static_cast<size_t>(b) * Tq;
  const float* lseb = lse + static_cast<size_t>(bh) * Tq;
  const float* dib = di + static_cast<size_t>(bh) * Tq;
  const int ntiles = (Tq + BN - 1) / BN;

  auto issue_tile = [&](int tile, int s) {
    const int i0 = tile * BN;
    load_rows_async<T, DP, LD>(qtile(s), q + qoff, i0, BN, Tq, D);
    load_rows_async<T, DP, LD>(dotile(s), dout + qoff, i0, BN, Tq, D);
    for (int i = threadIdx.x; i < BN; i += THREADS) {
      const bool ok = i0 + i < Tq;
      const int at = ok ? i0 + i : 0;
      cp_async4(vec(s, 0) + i * sizeof(int), qvb + at, ok);
      cp_async4(vec(s, 1) + i * sizeof(float), lseb + at, ok);
      cp_async4(vec(s, 2) + i * sizeof(float), dib + at, ok);
    }
  };

  // K and V go with tile 0, then tile 1 (one commit group per tile)
  load_rows_async<T, DP, LD>(ks, k + koff, k0, BM, Tk, D);
  load_rows_async<T, DP, LD>(vs, v + koff, k0, BM, Tk, D);
  issue_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) issue_tile(1, 1);
  cp_async_commit();

  // the validity of the thread's keys krow0 and krow0 + 8
  const int krow0 = k0 + warp * 16 + g;
  bool in[2];
  int kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + 8 * r;
    in[r] = row < Tk;
    kv[r] = in[r] ? kvalid[static_cast<size_t>(b) * Tk + row] : 0;
  }
  // dK, or dV in a SPLIT block with z = 0; dV beside it otherwise
  constexpr bool SPLIT = kDkvSplit<DP>;
  const bool dv_block = SPLIT && blockIdx.z == 0;
  float acc[ND][4], dvacc[SPLIT ? 1 : ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if constexpr (!SPLIT) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
      dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
  }
  const T* kw = ks + warp * 16 * LD;
  const T* vw = vs + warp * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();                     // tile it is in stage it % 2
    const int s = it % G::STAGES, i0 = it * BN;
    const int* qvs = reinterpret_cast<const int*>(vec(s, 0));
    const float* lses = reinterpret_cast<const float*>(vec(s, 1));
    const float* dis = reinterpret_cast<const float*>(vec(s, 2));
    // p^T = exp(s^T - lse) in place: column c is query i0 + c
    float sacc[NT][4];
    tile_abt<T, DP, BN, LD>(sacc, kw, qtile(s));
    dkv_p(sacc, qvs, lses, i0, Tq, scale, in, kv);
    if constexpr (SPLIT) {
      if (dv_block) {
        tile_xb<T, DP, BN, LD>(acc, sacc, dotile(s));   // dV += T(P^T) dO
      } else {
        ds_in_place<T, DP, BN, LD>(sacc, vw, dotile(s), dis, scale);
        tile_xb<T, DP, BN, LD>(acc, sacc, qtile(s));    // dK += T(dS^T) Q
      }
    } else {
      tile_xb<T, DP, BN, LD>(dvacc, sacc, dotile(s));   // dV += T(P^T) dO
      ds_in_place<T, DP, BN, LD>(sacc, vw, dotile(s), dis, scale);
      tile_xb<T, DP, BN, LD>(acc, sacc, qtile(s));      // dK += T(dS^T) Q
    }
    __syncthreads();                     // every warp is done with stage s
    if (it + G::STAGES < ntiles) issue_tile(it + G::STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_acc<T>((dv_block ? dv : dk) + koff, acc, krow0, Tk, D, D);
  if constexpr (!SPLIT) store_acc<T>(dv + koff, dvacc, krow0, Tk, D, D);
}

// ------------------------------------------------------------ wide D
// K4a above DP = 256 (head widths in (256, 1024]): neither a 64-row strip
// of Q nor a thread's accumulators over all of D fit, so the forward keeps
// nothing resident and splits O's columns:
// - the grid's z gives each block one chunk of DC = 256 columns of O, 128
//   accumulators a thread as at DP = 256;
// - every block forms its tile's scores over all of D, in chunk steps of
//   W columns (64 float32 or 128 bf16: 256 bytes a row), each of which
//   stages the block's 64 rows and the tile's 32 keys of those columns of
//   Q and K; the tile's out step then stages the DC columns of V and the
//   tile's kv_valid.  A ring of two stages, one per step, double-buffers
//   them all.
// Each chunk of one row block repeats the same sums in the same order, so
// they reach the same scores, m, l and lse bit for bit; z = 0 writes lse.
// The backward kernels above DP = 256 (ClusterGeo, below) share a tile's
// scores across a thread-block cluster instead.
constexpr int kWideDC = 256;                    // output columns a block

// A stage holds a chunk step's rows (the block's 64 of Q, then the tile's
// BN of K) or an out step's (the tile's BN rows of V over DC columns),
// whichever is larger, then the tile's kv_valid
template <typename T>
struct WideGeo {
  static constexpr int BN = 32;                 // keys a tile
  static constexpr int W = 256 / sizeof(T);     // columns a chunk step
  static constexpr int DC = kWideDC;            // output columns a block
  static constexpr int LDW = W + 16 / sizeof(T);
  static constexpr int LDC = DC + 16 / sizeof(T);
  static constexpr size_t kA = size_t(BM) * LDW * sizeof(T);   // own rows
  static constexpr size_t kB = size_t(BN) * LDW * sizeof(T);   // tile rows
  static constexpr size_t kOut = size_t(BN) * LDC * sizeof(T);
  static constexpr size_t kMain = kA + kB > kOut ? kA + kB : kOut;
  static constexpr size_t kStage = kMain + BN * sizeof(int);
  static constexpr size_t kSmem = 2 * kStage;
  static_assert(kA % 16 == 0 && kB % 16 == 0 && kMain % 16 == 0 &&
                    kStage % 16 == 0,
                "tiles stay 16-byte aligned");
  static_assert(kSmem <= 232448, "a block has at most 227 KB");
};

template <typename T>
__device__ __forceinline__ const T* at(const unsigned char* p, size_t off) {
  return reinterpret_cast<const T*>(p + off);
}

// K4b and K4c above DP = 256 (flash_attn_wide_bwd.cu): a cluster of C =
// ceil(DP / 256) blocks a row block, block c owning a chunk of at most
// kWideW = 256 output columns (k4_wide_split in ops/kernels/flash_attn.py
// mirrors the split), of kClusterWarps = 8 warps in two warpgroups over
// the row block's 64 rows (16 rows a warp in each).  A block keeps its 64
// rows of its columns of two operands resident (K4b: K, V; K4c: Q, dO) at
// a pitch of kWideW + 16 bytes; a ring of two stages holds two streamed
// tiles of BN rows of its columns (K4b: Q, dO; K4c: K, V; BN 16 in
// float32, 32 in bf16) and NVEC vectors of BN 32-bit values (K4b:
// q_valid, lse, di; K4c: kv_valid); two slots (one a tile, in turn) hold
// the partial S and dP of its columns, 64 by BN float32 each, which the
// cluster's blocks read from one another.
constexpr int kWideW = 256;
constexpr int kClusterWarps = 8;
constexpr int kClusterThreads = 32 * kClusterWarps;
constexpr int kMaxCluster = 8;          // the portable cluster size

template <typename T, int NVEC>
struct ClusterGeo {
  static constexpr int W = kWideW;
  static constexpr int BN = std::is_same<T, float>::value ? 16 : 32;
  static constexpr int LD = W + 16 / sizeof(T);
  static constexpr size_t kRows = size_t(BM) * LD * sizeof(T);
  static constexpr size_t kTile = size_t(BN) * LD * sizeof(T);
  static constexpr size_t kStage = 2 * kTile + NVEC * BN * sizeof(float);
  static constexpr size_t kSlot = 2 * size_t(BM) * BN * sizeof(float);
  static constexpr size_t kSmem = 2 * kRows + 2 * kStage + 2 * kSlot;
  static_assert(kRows % 16 == 0 && kStage % 16 == 0,
                "tiles and slots stay 16-byte aligned");
  static_assert(kSmem <= 232448, "a block has at most 227 KB");
  static_assert(kWideW * kMaxCluster >= 1024, "the widest head fits");
};

// cp.async columns [c0, c0 + cw) of rows [row0, row0 + nrows) of a (tlen,
// D) row-major matrix into shared rows of pitch LD, by a block of
// kClusterThreads; zero past tlen and from column D on (cw a multiple of
// 16 bytes' values, at most kWideW; the row's vectors past cw are left)
template <typename T, int LD>
__device__ __forceinline__ void load_cols_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int nrows,
                                                int tlen, int D, int c0,
                                                int cw) {
  constexpr int EV = 16 / sizeof(T), VPR = kWideW / EV;
  for (int i = threadIdx.x; i < nrows * VPR; i += kClusterThreads) {
    const int r = i / VPR, c = (i % VPR) * EV;
    if (c >= cw) continue;
    const bool ok = row0 + r < tlen && c0 + c < D;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(row0 + r) * D + c0 + c : src,
               ok);
  }
}

// The cluster's barrier (every thread of every block arrives, then waits;
// release and acquire at cluster scope), the address of a shared
// variable in block `rank`'s shared memory, and a 16-byte load from there.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// A slot holds the partial S (part 0) and dP (part 1) of a tile, each as
// 4 row warps x NT fragments x 32 lanes of float4 (the accumulator
// layout): where this lane's fragments of row warp rw's part lie.
template <int NT>
__device__ __forceinline__ float4* slot_part(float4* slot, int part,
                                             int rw) {
  return slot + (part * 4 + rw) * NT * 32 + (threadIdx.x & 31);
}

template <int NT>
__device__ __forceinline__ void store_part(float4* p,
                                           const float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    p[j * 32] = make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
}

// d = v for the first rank, d += v after it
__device__ __forceinline__ void add_rank(float (&d)[4], float4 v,
                                         bool first) {
  d[0] = first ? v.x : d[0] + v.x;
  d[1] = first ? v.y : d[1] + v.y;
  d[2] = first ? v.z : d[2] + v.z;
  d[3] = first ? v.w : d[3] + v.w;
}

// a = the sum of the part at pa (slot_part's place) over the cluster's
// `nrank` blocks, added in rank order 0, 1, ..., and with TWO, b the sum
// of the part at pb likewise (both parts' loads of a rank, 16 bytes a
// fragment, issued together; without TWO, b and pb are not touched):
// every block reads the same stored values in the same order, so every
// block gets the same sums bit for bit.  Called between the
// cluster_sync after every block stored its parts and the next one; a
// slot is written again two tiles later, after that next cluster_sync,
// which no block reaches before it has read this tile's slot.
template <bool TWO, int NT>
__device__ __forceinline__ void sum_ranks(float (&a)[NT][4], float4* pa,
                                          float (&b)[NT][4], float4* pb,
                                          int nrank) {
  const uint32_t la = smem_addr(pa), lb = smem_addr(pb);
  for (int r = 0; r < nrank; ++r) {
    const uint32_t ra = cluster_addr(la, r);
    float4 x[NT], y[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) x[j] = ld_cluster(ra + j * 32 * 16);
    if constexpr (TWO) {
      const uint32_t rb = cluster_addr(lb, r);
#pragma unroll
      for (int j = 0; j < NT; ++j) y[j] = ld_cluster(rb + j * 32 * 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      add_rank(a[j], x[j], r == 0);
      if constexpr (TWO) add_rank(b[j], y[j], r == 0);
    }
  }
}

// K4a, wide: keys stream; chunk step c stages Q's and the tile's K's
// columns [cW, cW + W), the out step the tile's V columns [c0, c0 + DC)
// and kv_valid
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ qvalid,
                      const int* __restrict__ kvalid, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk, int D,
                      float scale) {
  using G = WideGeo<T>;
  constexpr int BN = G::BN, W = G::W, DC = G::DC, NT = BN / 8, ND = DC / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BM, c0 = blockIdx.z * DC;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const int* kvb = kvalid + static_cast<size_t>(b) * Tk;
  const int nc = (D + W - 1) / W, steps = (Tk + BN - 1) / BN * (nc + 1);

  auto issue = [&](int step, int s) {
    T* st = reinterpret_cast<T*>(smem + s * G::kStage);
    const int k0 = step / (nc + 1) * BN, c = step % (nc + 1);
    if (c < nc) {
      load_rows_async<T, W, G::LDW>(st, q + qoff, q0, BM, Tq, D, c * W);
      load_rows_async<T, W, G::LDW>(st + BM * G::LDW, k + koff, k0, BN, Tk,
                                    D, c * W);
    } else {
      load_rows_async<T, DC, G::LDC>(st, v + koff, k0, BN, Tk, D, c0);
      load_vec_async<BN>(smem + s * G::kStage + G::kMain, kvb, k0, Tk);
    }
  };
  // one commit group per step (possibly empty), so that wait_group<1> at
  // the top of step i means step i's data has landed
  issue(0, 0);
  cp_async_commit();
  if (steps > 1) issue(1, 1);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;   // and row0 + 8
  const int qv0 = row0 < Tq ? qvalid[static_cast<size_t>(b) * Tq + row0] : 0;
  const int qv1 =
      row0 + 8 < Tq ? qvalid[static_cast<size_t>(b) * Tq + row0 + 8] : 0;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  float oacc[ND][4], sacc[NT][4];
  zero_acc(oacc);
  for (int it = 0, c = 0, k0 = 0; it < steps; ++it) {
    cp_async_wait<1>();
    __syncthreads();                     // step it is in stage it % 2
    const unsigned char* st = smem + (it & 1) * G::kStage;
    if (c < nc) {                        // S += Q_c K_c^T
      if (c == 0) zero_acc(sacc);
      tile_abt_add<T, W, BN, G::LDW>(sacc, at<T>(st, 0) + warp * 16 * G::LDW,
                                     at<T>(st, G::kA));
    } else {                             // O += T(P) V_z
      online_softmax(sacc, oacc, at<int>(st, G::kMain), k0, Tk, scale, qv0,
                     qv1, m_run, l_run);
      tile_xb<T, DC, BN, G::LDC>(oacc, sacc, at<T>(st, 0));
    }
    __syncthreads();                     // every warp is done with it
    if (it + 2 < steps) issue(it + 2, it & 1);
    cp_async_commit();
    if (++c > nc) {
      c = 0;
      k0 += BN;
    }
  }
  cp_async_wait<0>();
  finish_rows(oacc, m_run, l_run, lse + static_cast<size_t>(bh) * Tq, row0,
              Tq, blockIdx.z == 0);
  store_acc<T>(o + qoff + c0, oacc, row0, Tq, D, D - c0);
}

// Launch one kernel instance for T and DP; `launch` gets the grid, the
// shared-memory bytes and the stream.
template <typename Kernel, typename Launch>
cudaError_t run(Kernel kernel, size_t smem, Launch launch) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  launch(smem);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* qv,
                const void* kv, void* o, void* lse, int B, int H, int Tq,
                int Tk, int D, float scale, cudaStream_t s) {
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  auto kernel = flash_fwd_kernel<T, DP>;
  return run(kernel, FwdGeo<T, DP>::kSmem, [&](size_t smem) {
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(qv),
        static_cast<const int*>(kv), static_cast<T*>(o),
        static_cast<float*>(lse), H, Tq, Tk, D, scale);
  });
}

template <typename T, int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* qv,
               const void* kv, const void* dout, const void* lse,
               const void* di, void* dq_, int B, int H, int Tq, int Tk, int D,
               float scale, cudaStream_t s) {
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  auto kernel = flash_dq_kernel<T, DP>;
  return run(kernel, BwdGeo<T, DP, 1>::kSmem, [&](size_t smem) {
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(qv),
        static_cast<const int*>(kv), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<T*>(dq_), H, Tq, Tk, D, scale);
  });
}

template <typename T, int DP>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* qv,
                const void* kv, const void* dout, const void* lse,
                const void* di, void* dk, void* dv, int B, int H, int Tq,
                int Tk, int D, float scale, cudaStream_t s) {
  const dim3 grid((Tk + BM - 1) / BM, B * H, kDkvSplit<DP> ? 2 : 1);
  auto kernel = flash_dkv_kernel<T, DP>;
  return run(kernel, BwdGeo<T, DP, 3>::kSmem, [&](size_t smem) {
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(qv),
        static_cast<const int*>(kv), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, D, scale);
  });
}

// The wide K4a (D above 256): one instance a type, grid z over O's
// chunks of DC columns
template <typename T>
cudaError_t fwd_w(const void* q, const void* k, const void* v,
                  const void* qv, const void* kv, void* o, void* lse, int B,
                  int H, int Tq, int Tk, int D, float scale, cudaStream_t s) {
  const dim3 grid((Tq + BM - 1) / BM, B * H, (D + kWideDC - 1) / kWideDC);
  auto kernel = flash_fwd_wide_kernel<T>;
  return run(kernel, WideGeo<T>::kSmem, [&](size_t smem) {
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(qv),
        static_cast<const int*>(kv), static_cast<T*>(o),
        static_cast<float*>(lse), H, Tq, Tk, D, scale);
  });
}

}  // namespace

// The DP = 256 instances of fwd, dkv and dq in float32 (bf16 false) or
// bf16, defined in flash_attn_d256.cu and called by flash_attn.cu's
// dispatch: the only names of these sources with external linkage
// besides the C interface.
cudaError_t fwd_d256(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv, void* o,
                     void* lse, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s);
cudaError_t dkv_d256(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv,
                     const void* dout, const void* lse, const void* di,
                     void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s);
cudaError_t dq_d256(bool bf16, const void* q, const void* k, const void* v,
                    const void* qv, const void* kv, const void* dout,
                    const void* lse, const void* di, void* dq_, int B, int H,
                    int Tq, int Tk, int D, float scale, cudaStream_t s);
// The wide instances (D above 256) in float32 (bf16 false) or bf16,
// K4a's defined in flash_attn_wide.cu, K4b's and K4c's in
// flash_attn_wide_bwd.cu, and called by flash_attn.cu's dispatch.
cudaError_t fwd_wide(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv, void* o,
                     void* lse, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s);
cudaError_t dkv_wide(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv,
                     const void* dout, const void* lse, const void* di,
                     void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s);
cudaError_t dq_wide(bool bf16, const void* q, const void* k, const void* v,
                    const void* qv, const void* kv, const void* dout,
                    const void* lse, const void* di, void* dq_, int B, int H,
                    int Tq, int Tk, int D, float scale, cudaStream_t s);
// The attributes (registers, local memory) of the wide K4b (kernel 1) or
// K4c (2) instance, defined in flash_attn_wide_bwd.cu.
cudaError_t wide_bwd_attrs(bool bf16, int kernel, cudaFuncAttributes* attr);
// The bf16 instances at DP 32, 64, 96, 128 and 192 (dp), defined in
// flash_attn_bf16.cu and called by flash_attn.cu's dispatch.
cudaError_t fwd_bf16(int dp, const void* q, const void* k, const void* v,
                     const void* qv, const void* kv, void* o, void* lse,
                     int B, int H, int Tq, int Tk, int D, float scale,
                     cudaStream_t s);
cudaError_t dkv_bf16(int dp, const void* q, const void* k, const void* v,
                     const void* qv, const void* kv, const void* dout,
                     const void* lse, const void* di, void* dk, void* dv,
                     int B, int H, int Tq, int Tk, int D, float scale,
                     cudaStream_t s);
cudaError_t dq_bf16(int dp, const void* q, const void* k, const void* v,
                    const void* qv, const void* kv, const void* dout,
                    const void* lse, const void* di, void* dq_, int B, int H,
                    int Tq, int Tk, int D, float scale, cudaStream_t s);
}  // namespace ptk
