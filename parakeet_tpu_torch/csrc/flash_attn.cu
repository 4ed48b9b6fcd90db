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
// Design (simple and right; wgmma, TMA and warp specialisation are later
// work).  A block has four warps and owns 64 rows: 64 query rows (K4a,
// K4c) or 64 key rows (K4b); each warp owns 16 of them and streams the
// other sequence through shared memory in tiles of BN rows (64 in bf16,
// 32 in float32, so that two or three blocks fit on an SM).  Products run
// on the tensor cores through wmma with float32 accumulators:
//   - bf16 operands: m16n16k16 bf16 products, as kernels K1-K3 do;
//   - float32 operands: m16n16k8 TF32 products in the 3xTF32 split: each
//     operand x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
//     a.b = hi.hi + hi.lo + lo.hi, which keeps ~22 of float32's 24 bits
//     (plain TF32 keeps 11, about three decimal digits, which would miss a
//     float32 tolerance).
// The forward makes two passes over the keys: the first finds m and l per
// row (online, rescaling a scalar per row), the second accumulates the
// products with p = exp(s - m), already final, so the output accumulator
// is never rescaled (a wmma accumulator's layout is opaque).  That costs
// one more QK^T product (1.5x the forward's products) and matches jax's
// rounding points.  Gradients have no atomics: K4b owns a key tile and
// loops over query tiles, K4c owns a query tile and loops over key tiles,
// so two runs give bit-identical gradients.
//
// What bounds it: at T = 1024 and D = 96 the products (4 T^2 D per head
// forward) dominate and everything stays on chip but the tiles; the wmma
// fragment loads from shared memory and, for float32, the three products
// per step bound it, not device memory.
#include "common.cuh"

#include <math_constants.h>

#include <cfloat>
#include <type_traits>

namespace ptk {
namespace {

namespace wmma = nvcuda::wmma;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;          // rows a block owns
// jax's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX in double rounded to float
constexpr float MASK_VALUE = static_cast<float>(-0.7 * double(FLT_MAX));

using bf16 = __nv_bfloat16;

template <typename T>
struct Mma;

// bf16: one m16n16k16 product per step.
template <>
struct Mma<bf16> {
  static constexpr int BN = 64;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  __device__ static bf16 cast(float v) { return __float2bfloat16_rn(v); }

  // acc[n] += A (16 x kdim, row-major, lda) . B (kdim x 16 NF); B is
  // row-major (element (k, n) at b[k * ldb + n]) or, with B_COL, stored
  // as the rows of its transpose (element (k, n) at b[n * ldb + k]).
  template <bool B_COL, int NF>
  __device__ static void strip(Acc (&acc)[NF], const bf16* a, int lda,
                               const bf16* b, int ldb, int kdim) {
    using LB = std::conditional_t<B_COL, wmma::col_major, wmma::row_major>;
    for (int k = 0; k < kdim; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + k, lda);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
        wmma::load_matrix_sync(
            fb, B_COL ? b + n * 16 * ldb + k : b + k * ldb + n * 16, ldb);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
};

// float32: three m16n16k8 TF32 products per step (3xTF32).
template <>
struct Mma<float> {
  static constexpr int BN = 32;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  __device__ static float cast(float v) { return v; }

  template <typename F>
  __device__ static void split(F& hi, F& lo) {
#pragma unroll
    for (int t = 0; t < hi.num_elements; ++t) {
      const float v = hi.x[t];
      const float h = wmma::__float_to_tf32(v);
      hi.x[t] = h;
      lo.x[t] = wmma::__float_to_tf32(v - h);
    }
  }

  template <bool B_COL, int NF>
  __device__ static void strip(Acc (&acc)[NF], const float* a, int lda,
                               const float* b, int ldb, int kdim) {
    using LB = std::conditional_t<B_COL, wmma::col_major, wmma::row_major>;
    using FA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                              wmma::precision::tf32, wmma::row_major>;
    using FB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                              wmma::precision::tf32, LB>;
    for (int k = 0; k < kdim; k += 8) {
      FA ahi, alo;
      wmma::load_matrix_sync(ahi, a + k, lda);
      split(ahi, alo);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        FB bhi, blo;
        wmma::load_matrix_sync(
            bhi, B_COL ? b + n * 16 * ldb + k : b + k * ldb + n * 16, ldb);
        split(bhi, blo);
        wmma::mma_sync(acc[n], alo, bhi, acc[n]);
        wmma::mma_sync(acc[n], ahi, blo, acc[n]);
        wmma::mma_sync(acc[n], ahi, bhi, acc[n]);
      }
    }
  }
};

template <typename Acc, int NF>
__device__ void zero(Acc (&acc)[NF]) {
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);
}

// Shared-memory geometry of one instance.  DP is D rounded up to 32, 64,
// 96 or 128 (the padded columns are zero).  D-wide tiles have a pitch of
// DP + 8 elements, score strips BN + 8 floats: every row start is 16-byte
// aligned and every wmma fragment start 32-byte aligned.
template <typename T, int DP>
struct Geo {
  static constexpr int BN = Mma<T>::BN;
  static constexpr int LD = DP + 8;
  static constexpr int LS = BN + 8;
  // float32: p and ds overwrite the float32 scores in place
  static constexpr bool kAlias = std::is_same<T, float>::value;
  static constexpr size_t kTileM = size_t(BM) * LD * sizeof(T);
  static constexpr size_t kTileN = size_t(BN) * LD * sizeof(T);
  static constexpr size_t kS = size_t(BM) * LS * sizeof(float);
  static constexpr size_t kP = kAlias ? 0 : size_t(BM) * LS * sizeof(T);
  static constexpr size_t kScratch = size_t(WARPS) * 256 * sizeof(float);
  // two streamed tiles hold the float32 epilogue strip of all 64 rows
  static_assert(2 * kTileN == size_t(BM) * LD * sizeof(float),
                "the epilogue reuses the two streamed tiles");
  // forward: Q | K | V | S | P | rows (q_valid, m, 1/l) | kv_valid
  static constexpr size_t kFwd = kTileM + 2 * kTileN + kS + kP +
                                 3 * BM * sizeof(float) + BN * sizeof(int);
  // dQ: Q | dO | K | V | S | P | scratch | rows (q_valid, lse, di) | kv
  static constexpr size_t kDq = 2 * kTileM + 2 * kTileN + kS + kP +
                                kScratch + 3 * BM * sizeof(float) +
                                BN * sizeof(int);
  // dK/dV: K | V | Q | dO | S | P | scratch | rows (q_valid, lse, di) of
  // the streamed queries | kv_valid of the block's keys
  static constexpr size_t kDkv = 2 * kTileM + 2 * kTileN + kS + kP +
                                 kScratch + 3 * BN * sizeof(float) +
                                 BM * sizeof(int);
};

// Copy rows [row0, row0 + nrows) of a (T_len, D) row-major matrix into
// shared rows of pitch LD, zero past T_len and in columns [D, DP).
template <typename T, int DP>
__device__ void stage(T* dst, const T* __restrict__ src, int row0, int nrows,
                      int tlen, int D) {
  constexpr int EV = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int VPR = DP / EV;
  constexpr int LD = DP + 8;
  const int n = nrows * VPR;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * EV;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < tlen && c < D)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

__device__ __forceinline__ float logit(float dot, float scale, int qv,
                                       int kv) {
  const float s = dot * scale;
  return s + (qv == kv ? 0.f : MASK_VALUE);
}

// Write a warp's float32 strip (16 rows of pitch LD in `e`), times
// row_scale (or 1), as T to out rows [row0, row0 + 16) below tlen.
template <typename T, int DP>
__device__ void write_rows(const float* e, const float* row_scale,
                           T* __restrict__ out, int row0, int tlen, int D) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    if (row0 + r < tlen) {
      const float f = row_scale ? row_scale[r] : 1.f;
      out[static_cast<size_t>(row0 + r) * D + c] =
          Mma<T>::cast(e[r * LD + c] * f);
    }
  }
}

// ------------------------------------------------------------------ K4a
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qvalid,
                 const int* __restrict__ kvalid, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 float scale) {
  using G = Geo<T, DP>;
  using M = Mma<T>;
  constexpr int BN = G::BN, LD = G::LD, LS = G::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + G::kTileM);
  T* vs = reinterpret_cast<T*>(smem + G::kTileM + G::kTileN);
  float* ss = reinterpret_cast<float*>(smem + G::kTileM + 2 * G::kTileN);
  T* ps = G::kAlias ? reinterpret_cast<T*>(ss)
                    : reinterpret_cast<T*>(smem + G::kTileM + 2 * G::kTileN +
                                           G::kS);
  int* qv_s = reinterpret_cast<int*>(smem + G::kTileM + 2 * G::kTileN +
                                     G::kS + G::kP);
  float* m_s = reinterpret_cast<float*>(qv_s + BM);
  float* inv_s = m_s + BM;
  int* kv_s = reinterpret_cast<int*>(inv_s + BM);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;

  stage<T, DP>(qs, q + qoff, q0, BM, Tq, D);
  for (int i = threadIdx.x; i < BM; i += THREADS)
    qv_s[i] = q0 + i < Tq ? qvalid[static_cast<size_t>(b) * Tq + q0 + i] : 0;
  __syncthreads();

  const T* qw = qs + warp * 16 * LD;
  float* sw = ss + warp * 16 * LS;
  T* pw = ps + warp * 16 * LS;
  // pass 1: row max and sum; lanes 2r and 2r + 1 share row r, half the
  // columns each
  const int r = lane >> 1, half = lane & 1;
  const int qv_r = qv_s[warp * 16 + r];
  float m_run = -CUDART_INF_F;
  float l_run = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += BN) {
    __syncthreads();
    stage<T, DP>(ks, k + koff, k0, BN, Tk, D);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      kv_s[i] = k0 + i < Tk ? kvalid[static_cast<size_t>(b) * Tk + k0 + i]
                            : 0;
    __syncthreads();
    typename M::Acc acc[BN / 16];
    zero(acc);
    M::template strip<true, BN / 16>(acc, qw, LD, ks, LD, DP);
#pragma unroll
    for (int n = 0; n < BN / 16; ++n)
      wmma::store_matrix_sync(sw + n * 16, acc[n], LS, wmma::mem_row_major);
    __syncwarp();
    float mx = -CUDART_INF_F;
    for (int c = half * (BN / 2); c < (half + 1) * (BN / 2); ++c)
      if (k0 + c < Tk)
        mx = fmaxf(mx, logit(sw[r * LS + c], scale, qv_r, kv_s[c]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
    for (int c = half * (BN / 2); c < (half + 1) * (BN / 2); ++c)
      if (k0 + c < Tk)
        sum += expf(logit(sw[r * LS + c], scale, qv_r, kv_s[c]) - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }
  if (half == 0) {
    m_s[warp * 16 + r] = m_run;
    inv_s[warp * 16 + r] = l_run == 0.f ? 1.f : 1.f / l_run;
    if (q0 + warp * 16 + r < Tq)
      lse[static_cast<size_t>(bh) * Tq + q0 + warp * 16 + r] =
          m_run + logf(l_run);
  }
  __syncwarp();

  // pass 2: o = (sum_j T(exp(s - m)) v_j) / l
  typename M::Acc oacc[DP / 16];
  zero(oacc);
  const float* mw = m_s + warp * 16;
  const int* qvw = qv_s + warp * 16;
  for (int k0 = 0; k0 < Tk; k0 += BN) {
    __syncthreads();
    stage<T, DP>(ks, k + koff, k0, BN, Tk, D);
    stage<T, DP>(vs, v + koff, k0, BN, Tk, D);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      kv_s[i] = k0 + i < Tk ? kvalid[static_cast<size_t>(b) * Tk + k0 + i]
                            : 0;
    __syncthreads();
    typename M::Acc acc[BN / 16];
    zero(acc);
    M::template strip<true, BN / 16>(acc, qw, LD, ks, LD, DP);
#pragma unroll
    for (int n = 0; n < BN / 16; ++n)
      wmma::store_matrix_sync(sw + n * 16, acc[n], LS, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * BN; i += 32) {
      const int rr = i / BN, c = i % BN;
      float p = 0.f;
      if (k0 + c < Tk)
        p = expf(logit(sw[rr * LS + c], scale, qvw[rr], kv_s[c]) - mw[rr]);
      pw[rr * LS + c] = M::cast(p);
    }
    __syncwarp();
    M::template strip<false, DP / 16>(oacc, pw, LS, vs, LD, BN);
  }
  __syncthreads();                  // every warp is done with K and V
  float* ew = reinterpret_cast<float*>(ks) + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(ew + n * 16, oacc[n], LD, wmma::mem_row_major);
  __syncwarp();
  write_rows<T, DP>(ew, inv_s + warp * 16, o + qoff, q0 + warp * 16, Tq, D);
}

// ------------------------------------------------------------------ K4c
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ qvalid,
                const int* __restrict__ kvalid, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                T* __restrict__ dq, int H, int Tq, int Tk, int D,
                float scale) {
  using G = Geo<T, DP>;
  using M = Mma<T>;
  constexpr int BN = G::BN, LD = G::LD, LS = G::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + G::kTileM);
  T* ks = reinterpret_cast<T*>(smem + 2 * G::kTileM);
  T* vs = reinterpret_cast<T*>(smem + 2 * G::kTileM + G::kTileN);
  unsigned char* rest = smem + 2 * G::kTileM + 2 * G::kTileN;
  float* ss = reinterpret_cast<float*>(rest);
  T* ps = G::kAlias ? reinterpret_cast<T*>(ss)
                    : reinterpret_cast<T*>(rest + G::kS);
  float* scratch = reinterpret_cast<float*>(rest + G::kS + G::kP);
  int* qv_s = reinterpret_cast<int*>(rest + G::kS + G::kP + G::kScratch);
  float* lse_s = reinterpret_cast<float*>(qv_s + BM);
  float* di_s = lse_s + BM;
  int* kv_s = reinterpret_cast<int*>(di_s + BM);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;

  stage<T, DP>(qs, q + qoff, q0, BM, Tq, D);
  stage<T, DP>(dos, dout + qoff, q0, BM, Tq, D);
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const bool in = q0 + i < Tq;
    const size_t row = static_cast<size_t>(bh) * Tq + q0 + i;
    qv_s[i] = in ? qvalid[static_cast<size_t>(b) * Tq + q0 + i] : 0;
    lse_s[i] = in ? lse[row] : 0.f;
    di_s[i] = in ? di[row] : 0.f;
  }

  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;
  float* sw = ss + warp * 16 * LS;
  T* pw = ps + warp * 16 * LS;
  float* scr = scratch + warp * 256;
  const int* qvw = qv_s + warp * 16;
  const float* lsew = lse_s + warp * 16;
  const float* diw = di_s + warp * 16;

  typename M::Acc dqacc[DP / 16];
  zero(dqacc);
  for (int k0 = 0; k0 < Tk; k0 += BN) {
    __syncthreads();
    stage<T, DP>(ks, k + koff, k0, BN, Tk, D);
    stage<T, DP>(vs, v + koff, k0, BN, Tk, D);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      kv_s[i] = k0 + i < Tk ? kvalid[static_cast<size_t>(b) * Tk + k0 + i]
                            : 0;
    __syncthreads();
    {
      typename M::Acc acc[BN / 16];
      zero(acc);
      M::template strip<true, BN / 16>(acc, qw, LD, ks, LD, DP);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n)
        wmma::store_matrix_sync(sw + n * 16, acc[n], LS,
                                wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * BN; i += 32) {
      const int rr = i / BN, c = i % BN;
      float p = 0.f;
      if (k0 + c < Tk)
        p = expf(logit(sw[rr * LS + c], scale, qvw[rr], kv_s[c]) - lsew[rr]);
      sw[rr * LS + c] = p;
    }
    __syncwarp();
    // dp, 16 columns at a time, then ds = ((dp - di) * p) * scale
#pragma unroll 1
    for (int n = 0; n < BN / 16; ++n) {
      typename M::Acc acc[1];
      zero(acc);
      M::template strip<true, 1>(acc, dow, LD, vs + n * 16 * LD, LD, DP);
      wmma::store_matrix_sync(scr, acc[0], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int rr = i >> 4, c = n * 16 + (i & 15);
        const float p = sw[rr * LS + c];
        pw[rr * LS + c] = M::cast(((scr[i] - diw[rr]) * p) * scale);
      }
      __syncwarp();
    }
    M::template strip<false, DP / 16>(dqacc, pw, LS, ks, LD, BN);
  }
  __syncthreads();
  float* ew = reinterpret_cast<float*>(ks) + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(ew + n * 16, dqacc[n], LD, wmma::mem_row_major);
  __syncwarp();
  write_rows<T, DP>(ew, nullptr, dq + qoff, q0 + warp * 16, Tq, D);
}

// ------------------------------------------------------------------ K4b
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qvalid,
                 const int* __restrict__ kvalid, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                 int Tk, int D, float scale) {
  using G = Geo<T, DP>;
  using M = Mma<T>;
  constexpr int BN = G::BN, LD = G::LD, LS = G::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + G::kTileM);
  T* qs = reinterpret_cast<T*>(smem + 2 * G::kTileM);
  T* dos = reinterpret_cast<T*>(smem + 2 * G::kTileM + G::kTileN);
  unsigned char* rest = smem + 2 * G::kTileM + 2 * G::kTileN;
  float* ss = reinterpret_cast<float*>(rest);
  T* ps = G::kAlias ? reinterpret_cast<T*>(ss)
                    : reinterpret_cast<T*>(rest + G::kS);
  float* scratch = reinterpret_cast<float*>(rest + G::kS + G::kP);
  int* qv_s = reinterpret_cast<int*>(rest + G::kS + G::kP + G::kScratch);
  float* lse_s = reinterpret_cast<float*>(qv_s + BN);
  float* di_s = lse_s + BN;
  int* kv_s = reinterpret_cast<int*>(di_s + BN);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;

  stage<T, DP>(ks, k + koff, k0, BM, Tk, D);
  stage<T, DP>(vs, v + koff, k0, BM, Tk, D);
  for (int i = threadIdx.x; i < BM; i += THREADS)
    kv_s[i] = k0 + i < Tk ? kvalid[static_cast<size_t>(b) * Tk + k0 + i] : 0;

  const T* kw = ks + warp * 16 * LD;
  const T* vw = vs + warp * 16 * LD;
  float* sw = ss + warp * 16 * LS;
  T* pw = ps + warp * 16 * LS;
  float* scr = scratch + warp * 256;
  const int* kvw = kv_s + warp * 16;
  const int krow0 = k0 + warp * 16;

  typename M::Acc dkacc[DP / 16], dvacc[DP / 16];
  zero(dkacc);
  zero(dvacc);
  for (int i0 = 0; i0 < Tq; i0 += BN) {
    __syncthreads();
    stage<T, DP>(qs, q + qoff, i0, BN, Tq, D);
    stage<T, DP>(dos, dout + qoff, i0, BN, Tq, D);
    for (int i = threadIdx.x; i < BN; i += THREADS) {
      const bool in = i0 + i < Tq;
      const size_t row = static_cast<size_t>(bh) * Tq + i0 + i;
      qv_s[i] = in ? qvalid[static_cast<size_t>(b) * Tq + i0 + i] : 0;
      lse_s[i] = in ? lse[row] : 0.f;
      di_s[i] = in ? di[row] : 0.f;
    }
    __syncthreads();
    // s^T for the warp's 16 keys against the BN queries
    {
      typename M::Acc acc[BN / 16];
      zero(acc);
      M::template strip<true, BN / 16>(acc, kw, LD, qs, LD, DP);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n)
        wmma::store_matrix_sync(sw + n * 16, acc[n], LS,
                                wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * BN; i += 32) {
      const int rr = i / BN, c = i % BN;
      float p = 0.f;
      if (i0 + c < Tq && krow0 + rr < Tk)
        p = expf(logit(sw[rr * LS + c], scale, qv_s[c], kvw[rr]) - lse_s[c]);
      sw[rr * LS + c] = p;
      pw[rr * LS + c] = M::cast(p);
    }
    __syncwarp();
    M::template strip<false, DP / 16>(dvacc, pw, LS, dos, LD, BN);
    __syncwarp();
    // dp^T = v . do^T, 16 query columns at a time; ds^T overwrites p^T
#pragma unroll 1
    for (int n = 0; n < BN / 16; ++n) {
      typename M::Acc acc[1];
      zero(acc);
      M::template strip<true, 1>(acc, vw, LD, dos + n * 16 * LD, LD, DP);
      wmma::store_matrix_sync(scr, acc[0], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int rr = i >> 4, c = n * 16 + (i & 15);
        const float p = sw[rr * LS + c];
        pw[rr * LS + c] = M::cast(((scr[i] - di_s[c]) * p) * scale);
      }
      __syncwarp();
    }
    M::template strip<false, DP / 16>(dkacc, pw, LS, qs, LD, BN);
  }
  __syncthreads();
  float* ew = reinterpret_cast<float*>(qs) + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(ew + n * 16, dkacc[n], LD, wmma::mem_row_major);
  __syncwarp();
  write_rows<T, DP>(ew, nullptr, dk + koff, krow0, Tk, D);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(ew + n * 16, dvacc[n], LD, wmma::mem_row_major);
  __syncwarp();
  write_rows<T, DP>(ew, nullptr, dv + koff, krow0, Tk, D);
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
  return run(kernel, Geo<T, DP>::kFwd, [&](size_t smem) {
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
  return run(kernel, Geo<T, DP>::kDq, [&](size_t smem) {
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
  return run(kernel, Geo<T, DP>::kDkv, [&](size_t smem) {
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
