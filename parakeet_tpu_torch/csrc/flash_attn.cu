// Kernel K4: flash attention, forward (K4a), dK/dV pass (K4b), dQ pass
// (K4c).
//
// Replaces the Pallas TPU flash-attention kernel that
// parakeet_tpu/nn/flash.py:88 (make_flash_attn_core) wraps: jax's
// pallas/ops/tpu/flash_attention.py, its forward kernel and the
// _flash_attention_dkv_kernel / _flash_attention_dq_kernel of its VJP.
//
// What it computes, per (batch, head), with q (Tq, D), k and v (Tk, D):
//   s[i, j] = (q_i . k_j in float32) * scale
//             + (q_valid[i] == kv_valid[j] ? 0 : -0.7 * FLT_MAX)
//   m_i = max_j s, l_i = sum_j exp(s - m_i), lse_i = m_i + log(l_i)
//   o_i = (sum_j T(exp(s - m_i)) v_j) * (1 / l_i)      (T: v's type)
// and, with di_i = sum_d o * do (float32, computed outside, as jax does),
// p = exp(s - lse), dp = do . v, ds = ((dp - di) * p) * scale:
//   dv = sum_i T(p) do_i,  dk = sum_i T(ds) q_i,  dq = sum_j T(ds) k_j.
// Masking is additive and by segment equality, as in jax's kernel: a row
// whose validity matches no key attends to every key with the same large
// negative bias.  Keys past Tk and queries past Tq are not padding here:
// the kernels mask the ragged edges themselves (p = 0 there), so no
// caller pads T to a block multiple.
//
// Every kernel has four warps and owns 64 rows: 64 query rows (K4a, K4c)
// or 64 key rows (K4b); each warp owns 16 of them and walks the other
// sequence in tiles of BN rows, 32 in float32 and 64 in bf16 (32 in K4b
// and K4c at DP = 128).  All three are written for the H100 with mma.sync
// fragments, whose register layouts the PTX ISA documents, and float32
// accumulators.  float32 operands use the 3xTF32 split: x = hi + lo with
// hi and lo TF32 values, a.b = hi.hi + hi.lo + lo.hi, which keeps ~22 of
// float32's 24 bits (plain TF32 keeps 11, about three decimal digits,
// which would miss a float32 tolerance).  What the three share:
//   - scores never leave registers: a thread holds rows lane/4 and
//     lane/4 + 8 of each m16n8 accumulator tile, and a tile of scores
//     becomes the A operand of the next product directly (bf16: two n8
//     tiles repack as one k16 fragment; TF32: the A fragment holds
//     columns t and t + 4, the accumulator 2t and 2t + 1, so each k8 step
//     takes its streamed rows in the order 0, 2, 4, 6, 1, 3, 5, 7 and
//     reads the B operand's rows in that same order: the sum over k does
//     not depend on it);
//   - operands in shared memory are read by ldmatrix in bf16 (.trans
//     where a product contracts over the streamed rows) and by 32-bit
//     loads on a pitch of D + 4 floats in float32 (no bank conflicts,
//     read along rows or down columns), where each operand is split by
//     clearing the 13 low mantissa bits (hi, exactly a TF32 value) and
//     one subtraction (lo = x - hi, exact): no cvt in the loop;
//   - streamed tiles (and their per-row vectors) are copied by 16-byte
//     (4-byte) cp.async into a ring of two stages, so the next tile loads
//     while this one computes; rows past T are zero-filled by the
//     src-size form and their pairs masked to p = 0 exactly; D is padded
//     to DP (32, 64, 96 or 128) with zero columns.
//
// K4a (forward): one pass over the keys with the online softmax, as jax's
// multi-step kernel: per row a running max m and sum l (two quad
// shuffles each); at every key tile the O accumulator is rescaled by
// alpha = exp(m_old - m_new) in registers and gains T(exp(s - m_new)) . v;
// it is divided by l once at the end.  Q is loaded once into registers
// (bf16 through ldmatrix); K and V stream.  With Q, S, P and O in
// registers, ptxas gives the D = 96 instances 238 registers a thread in
// float32 (two blocks an SM) and 168 in bf16 (three), with 51-54 KB of
// shared memory a block; capping float32 at three blocks an SM spills and
// ran slower on the H100.  Rounding points: s in float32; p = exp(s -
// m_new) rounded to v's type at the running max of its tile
// (flash_attention_reference with block_k = K4A_BLOCK_K states exactly
// this); l summed from the unrounded p; lse = m + log l; o = acc * (1 / l)
// cast to q's type.
//
// K4c (dQ), 64 query rows a block: Q and dO of the block are staged once;
// K, V and kv_valid stream.  Per key tile, S = Q K^T and dP = dO V^T into
// accumulators, then p = exp(s - lse) and ds = ((dp - di) * p) * scale in
// place (lse, di and q_valid of the thread's two rows in registers), then
// dQ += T(ds) K, K read as the B operand the other way.  dQ is written
// from its accumulators.
//
// K4b (dK, dV), 64 key rows a block: K and V of the block are staged
// once; Q, dO and the tile's q_valid, lse and di stream.  Per query tile,
// S^T = K Q^T, p^T in place (each column's lse and q_valid from the
// stage), dV += T(p^T) dO, then dP^T = V dO^T, ds^T in place and dK +=
// T(ds^T) Q.  dK and dV stay in registers for the whole loop.
//
// In both backward kernels the resident strips (Q/dO, K/V) are re-read
// from shared memory at every tile, not held in registers: with both
// strips, the D-wide accumulators and two score tiles in registers, the
// float32 instances at D = 96 would spill.  The rounding points are the
// plain versions': s, dp and di in float32; p and ds in float32, rounded
// to the operand type only as the A operand of their product.  Neither
// has atomics: K4b owns its keys and K4c its queries, so two runs give
// bit-identical gradients.
//
// What bounds them: at T = 1024, D = 96 the products (4, 8 and 6 T^2 D
// per head for K4a, K4b and K4c) dominate and only the tiles and the
// outputs touch device memory; in float32 the three TF32 products per
// step (165 TFLOP/s of float32 products at the TF32 peak) bound them, in
// bf16 the products and the exp per score.  Left for later: wgmma with
// TMA and warp specialisation, skipping tiles that lie wholly outside a
// sequence, D > 128.
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

// acc = A . B^T for one warp: A the warp's 16 rows of a resident matrix,
// B the BN rows of a streamed tile, both of pitch LD in shared memory;
// acc[j] holds columns 8j + 2t, 8j + 2t + 1 of rows g and g + 8.
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void tile_abt(float (&acc)[BN / 8][4],
                                         const T* a, const T* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int c2 = 0; c2 < DP / 32; ++c2) {
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

// acc += T(x) . B for one warp: x (16 rows by BN, laid out as tile_abt
// leaves it) is the A operand straight from registers, B the BN rows of a
// streamed tile (pitch LD); the product contracts over those rows.
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void tile_xb(float (&acc)[DP / 8][4],
                                        const float (&x)[BN / 8][4],
                                        const T* b) {
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
// columns 8n + 2t and 8n + 2t + 1) as T to out rows below tlen and
// columns below D.
template <typename T, int ND>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[ND][4],
                                          int row0, int tlen, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= D) continue;
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
// K4a's geometry: BN keys a tile (K4A_BLOCK_K in ops/kernels/
// flash_attn.py), a pitch of DP + 16 bytes (conflict-free ldmatrix rows in
// bf16, 32-bit fragment loads in float32), and a ring of STAGES stages of
// K tile | V tile | kv_valid.  Q is staged once through stage 1's K and V
// tiles, which hold 2 * BN >= BM rows of the same pitch.
template <typename T, int DP>
struct FwdGeo {
  static constexpr int BN = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int LD = DP + 16 / sizeof(T);
  static constexpr size_t kTile = size_t(BN) * LD * sizeof(T);
  static constexpr size_t kStage = 2 * kTile + BN * sizeof(int);
  static constexpr size_t kSmem = STAGES * kStage;
  static_assert(2 * BN >= BM, "Q is staged in one stage's K and V tiles");
  static_assert(kTile % 16 == 0, "tiles stay 16-byte aligned");
};

// cp.async rows [row0, row0 + nrows) of a (tlen, D) row-major matrix into
// shared rows of pitch LD; zero past tlen and in columns [D, DP)
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_rows_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int nrows,
                                                int tlen, int D) {
  constexpr int EV = 16 / sizeof(T);
  constexpr int VPR = DP / EV;
  for (int i = threadIdx.x; i < nrows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * EV;
    const bool ok = row0 + r < tlen && c < D;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(row0 + r) * D + c : src, ok);
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
    return reinterpret_cast<T*>(smem + s * G::kStage);
  };
  auto vtile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * G::kStage + G::kTile);
  };
  auto kvtile = [&](int s) {
    return reinterpret_cast<int*>(smem + s * G::kStage + 2 * G::kTile);
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

  // Q through stage 1, tile 0 into stage 0; Q's fragments to registers;
  // then tile 1 into stage 1.  One commit group per tile (possibly
  // empty), so that wait_group<1> at the top of step i means tile i has
  // landed.
  load_rows_async<T, DP, LD>(ktile(1), q + qoff, q0, BM, Tq, D);
  cp_async_commit();
  issue_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const T* qw = ktile(1) + warp * 16 * LD;
  // bf16: ldmatrix A fragments, two per 32 columns; float32: the raw
  // values of the m16n8k8 A fragments (rows g, g + 8; columns t, t + 4)
  uint32_t qf[kBf16 ? DP / 16 : ND][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldsm_x4(qf[kk], qw + (lane & 15) * LD + kk * 16 +
                          (lane >> 4) * 8);
  } else {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const float* p = reinterpret_cast<const float*>(qw) + kk * 8 + t;
      qf[kk][0] = __float_as_uint(p[g * LD]);
      qf[kk][1] = __float_as_uint(p[(g + 8) * LD]);
      qf[kk][2] = __float_as_uint(p[g * LD + 4]);
      qf[kk][3] = __float_as_uint(p[(g + 8) * LD + 4]);
    }
  }
  __syncthreads();                       // every warp holds its Q
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

    // logits, the tile's row max, then p = exp(s - m_new) in place
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

    tile_xb<T, DP, BN, LD>(oacc, sacc, vs);     // O += T(P) V
    __syncthreads();                     // every warp is done with stage s
    if (it + G::STAGES < ntiles) issue_tile(it + G::STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // o = acc * (1 / l), straight from the accumulators
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
    const int row = row0 + 8 * r;
    if (t == 0 && row < Tq)
      lse[static_cast<size_t>(bh) * Tq + row] = m_run[r] + logf(l_run[r]);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    oacc[n][0] *= inv[0];
    oacc[n][1] *= inv[0];
    oacc[n][2] *= inv[1];
    oacc[n][3] *= inv[1];
  }
  store_acc<T>(o + qoff, oacc, row0, Tq, D);
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
// instances ran slower on the H100.
template <typename T, int DP, int NVEC>
struct BwdGeo {
  // K4a's tiles, but 32 rows in bf16 at DP = 128, where 64 spill in K4b
  static constexpr int BN = DP > 96 ? 32 : FwdGeo<T, DP>::BN;
  static constexpr int LD = FwdGeo<T, DP>::LD;
  static constexpr int STAGES = 2;
  static constexpr size_t kRows = size_t(BM) * LD * sizeof(T);
  static constexpr size_t kTile = size_t(BN) * LD * sizeof(T);
  static constexpr size_t kStage = 2 * kTile + NVEC * BN * sizeof(float);
  static constexpr size_t kSmem = 2 * kRows + STAGES * kStage;
  static_assert(kRows % 16 == 0 && kStage % 16 == 0,
                "tiles stay 16-byte aligned");
};

// ------------------------------------------------------------------ K4c
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
    // p = exp(s - lse), then ds = ((dp - di) * p) * scale in place of s
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
    tile_xb<T, DP, BN, LD>(dqacc, sacc, ktile(s));   // dQ += T(dS) K
    __syncthreads();                     // every warp is done with stage s
    if (it + G::STAGES < ntiles) issue_tile(it + G::STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_acc<T>(dq + qoff, dqacc, row0, Tq, D);
}

// ------------------------------------------------------------------ K4b
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
  const int g = lane >> 2, t = lane & 3;       // fragment row, quad lane
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
  float dkacc[ND][4], dvacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
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
    tile_xb<T, DP, BN, LD>(dvacc, sacc, dotile(s));  // dV += T(P^T) dO
    // ds^T = ((dp^T - di) * p^T) * scale in place of p^T
    float dpacc[NT][4];
    tile_abt<T, DP, BN, LD>(dpacc, vw, dotile(s));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dis + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[j][e] =
            ((dpacc[j][e] - ((e & 1) ? d2.y : d2.x)) * sacc[j][e]) * scale;
    }
    tile_xb<T, DP, BN, LD>(dkacc, sacc, qtile(s));   // dK += T(dS^T) Q
    __syncthreads();                     // every warp is done with stage s
    if (it + G::STAGES < ntiles) issue_tile(it + G::STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_acc<T>(dk + koff, dkacc, krow0, Tk, D);
  store_acc<T>(dv + koff, dvacc, krow0, Tk, D);
}

bool bad_args(int B, int H, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D < 16 || D > 128 ||
         D % 16 != 0 || static_cast<long long>(B) * H > 65535;
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
  const dim3 grid((Tk + BM - 1) / BM, B * H);
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

// Call F<T, DP>(...) for the element type (bf16 or float32) and D rounded
// up to 32, 64, 96 or 128.
#define PTK_FLASH_DISPATCH(F, is_bf16, D, ...)                        \
  do {                                                                \
    const int dp_ = ((D) + 31) / 32 * 32;                             \
    if (is_bf16) {                                                    \
      switch (dp_) {                                                  \
        case 32: return static_cast<int>(F<bf16, 32>(__VA_ARGS__));   \
        case 64: return static_cast<int>(F<bf16, 64>(__VA_ARGS__));   \
        case 96: return static_cast<int>(F<bf16, 96>(__VA_ARGS__));   \
        case 128: return static_cast<int>(F<bf16, 128>(__VA_ARGS__)); \
      }                                                               \
    } else {                                                          \
      switch (dp_) {                                                  \
        case 32: return static_cast<int>(F<float, 32>(__VA_ARGS__));  \
        case 64: return static_cast<int>(F<float, 64>(__VA_ARGS__));  \
        case 96: return static_cast<int>(F<float, 96>(__VA_ARGS__));  \
        case 128: return static_cast<int>(F<float, 128>(__VA_ARGS__));\
      }                                                               \
    }                                                                 \
    return -1;                                                        \
  } while (0)

}  // namespace
}  // namespace ptk

// Tensors are contiguous: q, o, do (B, H, Tq, D); k, v (B, H, Tk, D);
// q_valid (B, Tq) and kv_valid (B, Tk) int32; lse and di (B, H, Tq)
// float32; all of q's type (bf16 when is_bf16, else float32) but lse, di
// and the validities.  D is a multiple of 16 in [16, 128].  Returns 0,
// -1 for arguments the kernels do not take, or a CUDA error code.

// K4a: o and lse.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* q_valid, const void* kv_valid,
                              void* o, void* lse, int B, int H, int Tq,
                              int Tk, int D, int is_bf16, float scale,
                              void* stream) {
  using namespace ptk;
  if (bad_args(B, H, Tq, Tk, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTK_FLASH_DISPATCH(fwd, is_bf16, D, q, k, v, q_valid, kv_valid, o, lse, B,
                     H, Tq, Tk, D, scale, s);
}

// K4b: dk and dv.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* q_valid,
                                  const void* kv_valid, const void* dout,
                                  const void* lse, const void* di, void* dk,
                                  void* dv, int B, int H, int Tq, int Tk,
                                  int D, int is_bf16, float scale,
                                  void* stream) {
  using namespace ptk;
  if (bad_args(B, H, Tq, Tk, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTK_FLASH_DISPATCH(dkv, is_bf16, D, q, k, v, q_valid, kv_valid, dout, lse,
                     di, dk, dv, B, H, Tq, Tk, D, scale, s);
}

// K4c: dq.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* q_valid, const void* kv_valid,
                                 const void* dout, const void* lse,
                                 const void* di, void* dq, int B, int H,
                                 int Tq, int Tk, int D, int is_bf16,
                                 float scale, void* stream) {
  using namespace ptk;
  if (bad_args(B, H, Tq, Tk, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTK_FLASH_DISPATCH(ptk::dq, is_bf16, D, q, k, v, q_valid, kv_valid, dout,
                     lse, di, dq, B, H, Tq, Tk, D, scale, s);
}
