// Parallel WaveGAN discriminator, layers 1..9: forward (kernel K3a),
// backward from saved streams (K3b) and backward with recompute (K3c) of
// the port.
//
// Replaces the Pallas TPU kernels parakeet_tpu/ops/pallas/pwg_disc.py::
// _fwd_save_kernel / _fwd_nosave_kernel (K3a), _bwd_kernel (K3b) and
// _bwd_rc_kernel (K3c).  The
// nine layers: eight 64 -> 64 k=3 convs with dilations 1..8, each followed
// by LeakyReLU, then the 64 -> 1 output conv (d = 1), its weight padded to
// 64 columns.  Layer 0 (1 -> 64) stays in PyTorch.  Per layer j, with the
// layer input x_j kept in bf16 (the only form the products read):
//   pre(t)  = x_j(t-d) Wl + x_j(t) Wc + x_j(t+d) Wr + b     (f32 accum.)
//   x_j+1   = bf16(leaky(pre)), zero outside [0, T); logits = pre of j = 8
// and, transposed, with dy the gradient of the layer's output:
//   dpre    = dy * where(x_j+1 > 0, 1, slope), zero outside [0, T)
//   dy_j-1(t) = dpre(t+d) Wl^T + dpre(t) Wc^T + dpre(t-d) Wr^T
//   dW_j    = sum_t x_j(t + tap)^T bf16(dpre)(t),  db_j = sum_t dpre(t)
// The mask comes from the sign of the next-layer input (LeakyReLU keeps
// signs), as on the TPU.  Unlike the TPU kernels, dy is zeroed outside the
// signal before every layer: the TPU's reverse grid lets gradient leak
// through rows past the signal's ends into the last ~37 rows of each end
// (measured against autograd of the bf16 forward; ROADMAP queue 3).
//
// K3a.  The TPU kernel walks time blocks in order and carries each layer's
// left tail; CUDA blocks run in no order.  Here a block owns TC = 400
// centre rows of one item and computes all nine layers on a window of TC +
// 2 * 40 rows in shared memory: the 40-row halo on each side covers the
// receptive field (the sum of dilations, 37), so the centre rows are exact
// and no block waits for another.  The halo costs 20% more products.  Each
// layer's taps are read straight from the bf16 window at row offsets t +- d
// (a pitch of 80 bf16 keeps every row 32-byte aligned, as wmma's loads
// need); the weights of one layer (24 KB) are staged per layer.
//
// The reverse-layer routine (reverse_product), which K3b and K3c share: a
// warp forms dy of a 16-row strip on 32 columns in mma.sync m16n8k16
// registers from ldmatrix fragments of the bf16 dpre rows and the layer's
// [Wl^T; Wc^T; Wr^T], taps in the order d, 0, -d and k ascending; the
// callers' epilogues run on the accumulators' lanes (the mask from y, bf16
// dpre for the next layer, db in float32, dh as float2).  One routine in
// both kernels, so K3c's dh is K3b's bitwise.
//
// K3b, one pass per layer, last to first (k3b_launches).  The rows are cut
// into tiles of TM = 64 rows of one item (an item's last tile may be
// short) and the tiles, in (item, time) order, into one contiguous chunk a
// block.  Pass j walks its chunk's tiles with STAGES cp.async stages in
// flight, each holding the tile's bf16 dpre_j and saved x_j rows with M
// rows of halo on each side; a source row outside the tile's item is
// zero-filled (a source size of 0), so no tap crosses an item.  Pass 8
// forms dpre_8 in the stage from dlogits (column 0).  Per tile the pass
// adds dW_j = X_j^T bf16(dpre_j) into registers (192 x 64 float32 a block,
// 48 a thread, kept over the whole chunk), forms dy_j-1 with the routine,
// and writes bf16 dpre_j-1 (or float32 dh at j = 0) while summing db_j-1 in
// float32.  x_j serves twice: dW_j's tap operand and dpre_j-1's mask.  Each
// chunk writes one (3 * 64 + 1, 64) partial per layer (dW rows, then db)
// and one fixed-order reduction adds them up: no float atomics, so two runs
// give bit-identical gradients.  What bounds it on the H100: bytes.  Each
// stream is read once, ~3.5 KB a row a call (dpre_j and x_j in, dpre_j-1
// out, 384 bytes a layer; dlogits and dh) against 0.44 MFLOP a row.
//
// K3c reads h and dlogits only and writes dh, dW and db: the nine
// full-size streams never reach HBM.  The TPU kernel keeps all nine
// rebuilt streams of a ~4,200-row window in VMEM (4.9 MB); an SM has 227
// KB.  Persistent blocks, one per SM, each walk tiles of TCR centre rows in
// a fixed order.  Per tile a block re-runs K3a's layers 1..8 (K3a's own
// device code) on a window of TCR + 2 * 80 rows (the 80-row halo covers the
// reverse window's 40 plus the 36 rows the rebuilt streams lose at the
// edges) and writes the nine streams' reverse-window rows to a per-block
// scratch in global memory.  Its reverse half then runs the routine on TCR
// + 2 * 40 rows in the same shared memory (the forward's staging is free
// by then), with the masks read from the scratch and the next layer's
// weights and saved rows arriving by cp.async while this layer computes;
// each tile's dW_j, formed in mma.sync registers, is added into the
// block's float32 partial (a read-modify-write per tile and layer) and db
// into shared memory.  The fixed-order reduction then sums the blocks'
// partials.  The rebuilt streams equal K3a's saved ones and the routine is
// K3b's, so dh equals K3b's bitwise; dW and db are summed in another
// grouping.  K3c does ~0.6 MFLOP of useful products a row (layers 1..8
// again, dx and dW) against ~0.4 KB a row in and out; the scratch and the
// partials' read-modify-writes add ~8 KB a row of L2 traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;               // channels
constexpr int NL = 9;               // layers 1..9 of the discriminator
constexpr int H = 40;               // halo rows on each side (>= 37)
constexpr int TC = 400;             // K3a: centre rows per block
constexpr int WIN = TC + 2 * H;     // K3a: window rows, 30 strips of 16
constexpr int M = 8;                // margin rows (>= the largest dilation)
constexpr int XR = WIN + 2 * M;     // K3a: buffer rows
constexpr int LDX = 80;             // window pitch (bf16): 160-byte rows
constexpr int LDW = C + 8;          // weight pitch (bf16)
constexpr int LDS = C + 4;          // f32 staging pitch
// pitch of rows read by ldmatrix only: 144 bytes, an odd multiple of 16,
// so the eight rows of one ldmatrix read hit distinct banks
constexpr int LDB = C + 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STRIPS = WIN / 16;
constexpr int PR = 3 * C + 1;       // rows of a layer's partial: dW, db
static_assert(WIN % 16 == 0, "the window is whole strips");

__constant__ int kDils[NL] = {1, 2, 3, 4, 5, 6, 7, 8, 1};

using ptk::FragA;
using ptk::FragB;
using ptk::FragC;
using ptk::set_smem;

constexpr size_t kBufBytes = sizeof(__nv_bfloat16) * XR * LDX;
constexpr size_t kWBytes = sizeof(__nv_bfloat16) * 3 * C * LDW;
constexpr size_t kStBytes = sizeof(float) * WARPS * 16 * LDS;
constexpr size_t kFwdSmem = 2 * kBufBytes + kWBytes + kStBytes +
                            sizeof(float) * C;
// One strip of 16 window rows of one layer: acc = sum over the three taps
// of buf rows (wr0 + off_tap) @ w rows [tap * 64, tap * 64 + 64).
__device__ __forceinline__ void strip_product(const __nv_bfloat16* buf,
                                              const __nv_bfloat16* w_s,
                                              int wr0, const int offs[3],
                                              FragC acc[4]) {
  FragA af;
  FragB bf;
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    const __nv_bfloat16* a = buf + (M + wr0 + offs[tap]) * LDX;
#pragma unroll
    for (int k = 0; k < C; k += 16) {
      wmma::load_matrix_sync(af, a + k, LDX);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::load_matrix_sync(bf, w_s + (tap * C + k) * LDW + n * 16, LDW);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
  }
}

// Load buffer rows [0, ROWS) of item b from a (B, T, 64) bf16 tensor, zero
// outside [0, T); row br is time t0 - HALO - M + br.
template <int ROWS, int HALO>
__device__ void load_window(__nv_bfloat16* buf,
                            const __nv_bfloat16* __restrict__ src, int b,
                            int T, int t0) {
  constexpr int V = C / 8;
  for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
    const int br = i / V;
    const int t = t0 - HALO - M + br;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < T)
      v = reinterpret_cast<const uint4*>(
          src + (static_cast<size_t>(b) * T + t) * C)[i % V];
    *reinterpret_cast<uint4*>(buf + br * LDX + (i % V) * 8) = v;
  }
}

// Zero the M margin rows on each side of a window of WROWS rows.
template <int WROWS>
__device__ void zero_margins(__nv_bfloat16* buf) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < 2 * M * LDX; i += THREADS) {
    const int r = i / LDX;
    buf[(r < M ? r : WROWS + r) * LDX + i % LDX] = zero;
  }
}

// The forward's epilogue for one strip of 16 window rows: the next layer's
// input bf16(leaky(acc + b)), zero outside [0, T).  t_row0 is the time of
// the strip's first row.  K3a and K3c's recompute both run it.
__device__ __forceinline__ void fwd_strip_out(const float* st,
                                              const float* b_s,
                                              __nv_bfloat16* nxt, int wr0,
                                              int t_row0, int T, float slope,
                                              int lane) {
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C;
    const int n = i - r * C;
    const int t = t_row0 + r;
    float v = st[r * LDS + n] + b_s[n];
    v = v > 0.f ? v : slope * v;
    if (t < 0 || t >= T) v = 0.f;
    nxt[(M + wr0 + r) * LDX + n] = __float2bfloat16_rn(v);
  }
}

// dpre of columns (n0, n0 + 1) of one row: dy times LeakyReLU's slope at
// the layer's output y (from its sign).  K3b and K3c both run it.
__device__ __forceinline__ float2 leaky_grad(float dy0, float dy1,
                                             __nv_bfloat162 y, float m_mid,
                                             float m_half) {
  const float y0 = __low2float(y), y1 = __high2float(y);
  const float s0 = y0 > 0.f ? 1.f : (y0 < 0.f ? -1.f : 0.f);
  const float s1 = y1 > 0.f ? 1.f : (y1 < 0.f ? -1.f : 0.f);
  return make_float2(dy0 * (m_mid + m_half * s0), dy1 * (m_mid + m_half * s1));
}

// centre rows of the window to a (B, T, 64) bf16 stream
__device__ void store_centre(__nv_bfloat16* __restrict__ dst,
                             const __nv_bfloat16* buf, int b, int T,
                             int t0) {
  constexpr int V = C / 8;
  for (int i = threadIdx.x; i < TC * V; i += THREADS) {
    const int r = i / V;
    const int t = t0 + r;
    if (t < T)
      reinterpret_cast<uint4*>(dst + (static_cast<size_t>(b) * T + t) *
                                         C)[i % V] =
          *reinterpret_cast<const uint4*>(buf + (M + H + r) * LDX +
                                          (i % V) * 8);
  }
}

// ----------------------------------------------------------------- K3a --

template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
disc_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wk,
                const float* __restrict__ bk, float* __restrict__ logits,
                __nv_bfloat16* __restrict__ saved, int B, int T,
                float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + XR * LDX;
  __nv_bfloat16* w_s = buf1 + XR * LDX;
  float* st_all = reinterpret_cast<float*>(w_s + 3 * C * LDW);
  float* b_s = st_all + WARPS * 16 * LDS;

  const int tiles = (T + TC - 1) / TC;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st = st_all + warp * 16 * LDS;

  load_window<XR, H>(buf0, x, b, T, t0);
  zero_margins<WIN>(buf1);
  __nv_bfloat16* cur = buf0;
  __nv_bfloat16* nxt = buf1;
  FragC acc[4];

  for (int j = 0; j < NL; ++j) {
    const int d = kDils[j];
    __syncthreads();   // the previous layer is done with w_s and nxt
    ptk::stage_rows<THREADS>(w_s, wk + static_cast<size_t>(j) * 3 * C * C,
                             3 * C, C, LDW);
    for (int i = threadIdx.x; i < C; i += THREADS) b_s[i] = bk[j * C + i];
    if constexpr (SAVE)
      store_centre(saved + static_cast<size_t>(j) * B * T * C, cur, b, T, t0);
    __syncthreads();
    const int offs[3] = {-d, 0, d};
    for (int s = warp; s < STRIPS; s += WARPS) {
      const int wr0 = s * 16;
      strip_product(cur, w_s, wr0, offs, acc);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(st + n * 16, acc[n], LDS,
                                wmma::mem_row_major);
      __syncwarp();
      if (j < NL - 1) {
        fwd_strip_out(st, b_s, nxt, wr0, t0 - H + wr0, T, slope, lane);
      } else if (lane < 16) {
        const int wr = wr0 + lane;
        const int t = t0 - H + wr;
        if (wr >= H && wr < H + TC && t < T)
          logits[static_cast<size_t>(b) * T + t] = st[lane * LDS] + b_s[0];
      }
      __syncwarp();    // before the next strip overwrites the staging
    }
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// ------------------------------------------- the reverse-layer routine --

// dy of one warp's 16-row strip on columns n0 .. n0 + 31:
// acc = dp(t + d) Wl^T + dp(t) Wc^T + dp(t - d) Wr^T.  a: the strip's
// first row of bf16 dpre (row r at a + r * lda; rows r +- d readable);
// w_s: the layer's [Wl^T; Wc^T; Wr^T] (192 rows of pitch LDW).  Taps in
// the order d, 0, -d, k ascending.  acc[n][0..1] are columns n0 + 8n +
// 2 (lane % 4) + {0, 1} of row lane / 4, acc[n][2..3] those of row
// lane / 4 + 8.  TAPS_UNROLL: how many taps the compiler may unroll (the
// same products and order either way; K3c rolls them to spare registers).
template <int TAPS_UNROLL = 3>
__device__ __forceinline__ void reverse_product(float (&acc)[4][4],
                                                const bf16* a, int lda,
                                                int d, const bf16* w_s,
                                                int n0, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll (TAPS_UNROLL)
  for (int tap = 0; tap < 3; ++tap) {
    const bf16* ap = a + ((1 - tap) * d + (lane & 15)) * lda + (lane >> 4) * 8;
    const bf16* bp = w_s + (tap * C + (lane & 15)) * LDW + n0 + (lane >> 4) * 8;
#pragma unroll
    for (int k = 0; k < C; k += 16) {
      uint32_t af[4];
      ptk::ldsm_x4(af, ap + k);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, bp + k * LDW + 16 * p);
        ptk::mma_bf16(acc[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// One warp's share of dW += X^T bf16(dpre) over 16 rows (k .. k + 15 of
// the operands): the m16 tiles mq, mq + 4, mq + 8 of dW's 192 rows (tap
// i = 0, 1, 2, columns 16 mq ..) by the n8 tiles n0 .. n0 + 31.  x: the
// saved rows with the tap offsets applied by the caller's row pointer
// (row k + r + off of tap i at x + (k + r + offs[i]) * ldx); y: dpre rows
// (row k + r at y + (k + r) * ldy).
__device__ __forceinline__ void dw_step(float (&acc)[3][4][4],
                                        const bf16* x, int ldx,
                                        const bf16* y, int ldy, int k,
                                        int d, int mq, int n0, int lane) {
  uint32_t bf[4][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t v[4];
    ptk::ldsm_x4_trans(v, y + (k + (lane & 15)) * ldy + n0 + 16 * p +
                              (lane >> 4) * 8);
    bf[2 * p][0] = v[0];
    bf[2 * p][1] = v[1];
    bf[2 * p + 1][0] = v[2];
    bf[2 * p + 1][1] = v[3];
  }
  const bf16* xk = x + (k + (lane & 7) + ((lane >> 4) << 3)) * ldx +
                   16 * mq + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t af[4];
    ptk::ldsm_x4_trans(af, xk + (i - 1) * d * ldx);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      ptk::mma_bf16(acc[i][n], af, bf[n][0], bf[n][1]);
  }
}

// acc (a warp's dW tiles, as dw_step) to or from a layer's (PR, 64) f32
// partial block
__device__ __forceinline__ void dw_store(float* out,
                                         const float (&acc)[3][4][4],
                                         int mq, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float* o = out + (16 * (mq + 4 * i) + g) * C + n0 + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][n][0], acc[i][n][1]);
      *reinterpret_cast<float2*>(o + 8 * C) =
          make_float2(acc[i][n][2], acc[i][n][3]);
    }
}
__device__ __forceinline__ void dw_load(float (&acc)[3][4][4], const float* in,
                                        int mq, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* o = in + (16 * (mq + 4 * i) + g) * C + n0 + 8 * n + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(o);
      const float2 hi = *reinterpret_cast<const float2*>(o + 8 * C);
      acc[i][n][0] = lo.x;
      acc[i][n][1] = lo.y;
      acc[i][n][2] = hi.x;
      acc[i][n][3] = hi.y;
    }
}

// A lane's float32 column sums s[n][e] (columns n0 + 8n + 2 (lane % 4) + e
// over its rows), added over the eight lanes that share them in a fixed
// order; lanes 0..3 then write them to red[column].
__device__ __forceinline__ void column_sums(float (&s)[4][2], float* red,
                                            int n0, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        s[n][e] += __shfl_xor_sync(0xffffffffu, s[n][e], o);
  if (lane < 4)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      red[n0 + 8 * n + 2 * lane] = s[n][0];
      red[n0 + 8 * n + 2 * lane + 1] = s[n][1];
    }
}

// ----------------------------------------------------------------- K3b --

constexpr int TM = 64;              // rows per tile
constexpr int XS = TM + 2 * M;      // stage rows: the tile and M on each side
constexpr int STAGES = 4;
// one stage: dpre rows, saved rows (XS x LDB bf16 each), dlogits (XS f32)
constexpr size_t kStageBytes = 2 * sizeof(bf16) * XS * LDB + sizeof(float) * XS;
constexpr size_t kLayerSmem = kWBytes + STAGES * kStageBytes +
                              sizeof(float) * (4 * C + TM);
static_assert(kStageBytes % 16 == 0 && kWBytes % 16 == 0, "16-byte stages");

// Pass j of K3b over the chunk of tiles [blockIdx.x * per_chunk, ...).
// xj: saved x_j (B, T, 64) bf16 (null at j = 0 without weights); dpj:
// dpre_j (B, T, 64) bf16, null at j = 8, where dlog (B, T) f32 gives it;
// wkt: the layer's (192, 64) bf16 [Wl^T; Wc^T; Wr^T]; dp_out: dpre_j-1 (B,
// T, 64) bf16 for j > 0; dx: dh (B, T, 64) f32 at j = 0, or null; part:
// null, or the chunks' partials (chunks, 9, PR, 64) f32, of which this
// pass writes dW_j (rows 0..191 of layer j), db_j-1 (row 192 of layer j -
// 1) and at j = 8 db_8.
__global__ void __launch_bounds__(THREADS, 1)
disc_bwd_layer_kernel(const bf16* __restrict__ xj,
                      const bf16* __restrict__ dpj,
                      const float* __restrict__ dlog,
                      const bf16* __restrict__ wkt,
                      bf16* __restrict__ dp_out, float* __restrict__ dx,
                      float* __restrict__ part, int j, int B, int T,
                      float slope, int per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  unsigned char* stages = smem + kWBytes;
  float* red = reinterpret_cast<float*>(stages + STAGES * kStageBytes);
  float* red8 = red + 4 * C;
  auto dp_s = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * kStageBytes);
  };
  auto x_s = [&](int s) { return dp_s(s) + XS * LDB; };
  auto dl_s = [&](int s) {
    return reinterpret_cast<float*>(dp_s(s) + 2 * XS * LDB);
  };

  const int d = kDils[j];
  const bool last = dpj == nullptr;
  const bool need_w = part != nullptr;
  const bool need_x = need_w || j > 0;
  const bool need_dy = j > 0 || dx != nullptr;
  const int tpi = (T + TM - 1) / TM;             // tiles an item
  const int ga = blockIdx.x * per_chunk;
  const int gb = min(ga + per_chunk, B * tpi);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, tl = lane & 3;
  const int mq = warp & 3;                       // dW: m16 tiles mq + 4i
  const int rw = 16 * mq;                        // dy: the warp's rows
  const int n0 = 32 * (warp >> 2);               // and columns
  const float m_mid = 0.5f * (1.f + slope);
  const float m_half = 0.5f * (1.f - slope);

  for (int i = threadIdx.x; i < 3 * C * (C / 8); i += THREADS)
    ptk::cp_async16(w_s + (i >> 3) * LDW + (i & 7) * 8, wkt + i * 8, true);
  if (last)      // dpre_8: column 0 is written per tile, the rest stays 0
    for (int i = threadIdx.x; i < STAGES * XS * (C / 8); i += THREADS)
      *reinterpret_cast<uint4*>(dp_s(i / (XS * 8)) + (i / 8 % XS) * LDB +
                                (i & 7) * 8) = make_uint4(0u, 0u, 0u, 0u);

  // stage s <- rows t0 - M .. t0 + TM + M - 1 of tile gt's item
  auto issue = [&](int s, int gt) {
    const int b = gt / tpi;
    const int t0 = (gt - b * tpi) * TM;
    const size_t base = static_cast<size_t>(b) * T;
    for (int i = threadIdx.x; i < XS * (C / 8); i += THREADS) {
      const int r = i >> 3, v = i & 7;
      const int t = t0 - M + r;
      const bool ok = t >= 0 && t < T;
      const size_t o = (base + (ok ? t : 0)) * C + v * 8;
      if (!last) ptk::cp_async16(dp_s(s) + r * LDB + v * 8, dpj + o, ok);
      if (need_x) ptk::cp_async16(x_s(s) + r * LDB + v * 8, xj + o, ok);
    }
    if (last)
      for (int r = threadIdx.x; r < XS; r += THREADS) {
        const int t = t0 - M + r;
        const bool ok = t >= 0 && t < T;
        ptk::cp_async4(dl_s(s) + r, dlog + base + (ok ? t : 0), ok);
      }
  };

  float acc_w[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      acc_w[i][n][0] = acc_w[i][n][1] = acc_w[i][n][2] = acc_w[i][n][3] = 0.f;
  float db[4][2] = {};           // db_j-1 of the lane's columns
  float db8 = 0.f;               // threads < TM: dlogits of tile row tid

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ga + s < gb) issue(s, ga + s);
    ptk::cp_async_commit();
  }
  for (int it = 0, gt = ga; gt < gb; ++it, ++gt) {
    const int s = it % STAGES;
    ptk::cp_async_wait<STAGES - 2>();
    __syncthreads();   // this tile is in; the stage refilled next is free
    if (gt + STAGES - 1 < gb)
      issue((it + STAGES - 1) % STAGES, gt + STAGES - 1);
    ptk::cp_async_commit();

    const int b = gt / tpi;
    const int t0 = (gt - b * tpi) * TM;
    bf16* dp = dp_s(s);
    const bf16* xs = x_s(s);
    if (last) {
      const float* dl = dl_s(s);
      for (int r = threadIdx.x; r < XS; r += THREADS)
        dp[r * LDB] = __float2bfloat16_rn(dl[r]);
      if (threadIdx.x < TM) db8 += dl[M + threadIdx.x];
      __syncthreads();
    }
    if (need_w) {
#pragma unroll
      for (int k = 0; k < TM; k += 16)
        dw_step(acc_w, xs + M * LDB, LDB, dp + M * LDB, LDB, k, d, mq, n0,
                lane);
    }
    if (!need_dy) continue;
    // the epilogue's mask (x_j at the tile's rows) first
    uint32_t ym[2][4];
    if (j > 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          ym[h][n] = *reinterpret_cast<const uint32_t*>(
              xs + (M + rw + g + 8 * h) * LDB + n0 + 8 * n + 2 * tl);
    float acc[4][4];
    reverse_product(acc, dp + (M + rw) * LDB, LDB, d, w_s, n0, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + rw + g + 8 * h;
      if (t >= T) continue;
      const size_t row = (static_cast<size_t>(b) * T + t) * C;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = n0 + 8 * n + 2 * tl;
        const float dy0 = acc[n][2 * h], dy1 = acc[n][2 * h + 1];
        if (j > 0) {
          const float2 p = leaky_grad(
              dy0, dy1, *reinterpret_cast<const __nv_bfloat162*>(&ym[h][n]),
              m_mid, m_half);
          *reinterpret_cast<uint32_t*>(dp_out + row + c) =
              ptk::pack_bf16(p.x, p.y);
          db[n][0] += p.x;
          db[n][1] += p.y;
        } else {
          *reinterpret_cast<float2*>(dx + row + c) = make_float2(dy0, dy1);
        }
      }
    }
  }
  if (!need_w) return;

  float* out = part + static_cast<size_t>(blockIdx.x) * NL * PR * C;
  dw_store(out + static_cast<size_t>(j) * PR * C, acc_w, mq, n0, lane);
  if (j > 0) {
    column_sums(db, red + mq * C, n0, lane);
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.f;
      for (int w = 0; w < 4; ++w) s += red[w * C + threadIdx.x];
      out[(static_cast<size_t>(j - 1) * PR + 3 * C) * C + threadIdx.x] = s;
    }
  }
  if (last) {
    if (threadIdx.x < TM) red8[threadIdx.x] = db8;
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.f;
      if (threadIdx.x == 0)
        for (int r = 0; r < TM; ++r) s += red8[r];
      out[(static_cast<size_t>(NL - 1) * PR + 3 * C) * C + threadIdx.x] = s;
    }
  }
}

// ----------------------------------------------------------------- K3c --

constexpr int TCR = 272;            // centre rows per tile
constexpr int HR = 80;              // recompute halo: H + the 36 rows lost
constexpr int RW = TCR + 2 * HR;    // recompute window
constexpr int WR = TCR + 2 * H;     // reverse window and scratch rows
constexpr int XRR = RW + 2 * M;     // buffer rows of the recompute half
constexpr int XRW = WR + 2 * M;     // buffer rows of the reverse half
constexpr int XD = TCR + 2 * M;     // rows of the dW operand's stage
constexpr int RC_STREAM = WR * C;   // scratch elements of one stream
constexpr int RC_UNITS = 2 * (WR / 16);   // reverse: strips x column halves
static_assert(RW % 16 == 0 && WR % 16 == 0 && TCR % 16 == 0,
              "the windows are whole strips");
static_assert(HR - H >= 36, "the rebuilt streams are exact on the reverse "
                            "window (they lose the sum of dilations 1..8)");
static_assert(WARPS % 2 == 0, "a warp keeps one column half");

// The two halves share one region of shared memory, in turn:
//   recompute: buf0, buf1 (XRR x LDX bf16), w_s, the f32 staging, b_s;
//   reverse:   rb0, rb1 (XRW x LDX bf16), two weight buffers, the dW
//              operand's stage (XD x LDB bf16);
// then, for the whole kernel, db partials (WARPS x 64) and db (9 x 64).
constexpr size_t kRcFwdBytes = 2 * sizeof(bf16) * XRR * LDX + kWBytes +
                               kStBytes + sizeof(float) * C;
constexpr size_t kRcRevBytes = 2 * sizeof(bf16) * XRW * LDX + 2 * kWBytes +
                               sizeof(bf16) * XD * LDB;
constexpr size_t kRcRegion = kRcFwdBytes > kRcRevBytes ? kRcFwdBytes
                                                       : kRcRevBytes;
constexpr size_t kRcSmem = kRcRegion + sizeof(float) * (WARPS + NL) * C;
static_assert(kRcSmem <= 232448, "K3c fits a block's shared memory");

// cp.async of one layer's (192, 64) weights into rows of pitch LDW
__device__ __forceinline__ void cp_weights(bf16* w_s, const bf16* w) {
  for (int i = threadIdx.x; i < 3 * C * (C / 8); i += THREADS)
    ptk::cp_async16(w_s + (i >> 3) * LDW + (i & 7) * 8, w + i * 8, true);
}

// cp.async of a scratch stream's rows H - M .. H + TCR + M - 1 (the dW
// operand: the centre rows and their taps) into rows of pitch LDB
__device__ __forceinline__ void cp_dw_rows(bf16* xd, const bf16* stream) {
  for (int i = threadIdx.x; i < XD * (C / 8); i += THREADS)
    ptk::cp_async16(xd + (i >> 3) * LDB + (i & 7) * 8,
                    stream + (H - M) * C + i * 8, true);
}

// K3c's two halves for one tile (b, t0), each computing its own pointers
// into the shared region, so that little stays live from one to the other.
// The first: rebuild the streams with K3a's layers 1..8 on RW rows and
// write stream j's reverse-window rows to the block's scratch sc.
__device__ __forceinline__ void rc_rebuild(unsigned char* smem,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ wk,
                                           const float* __restrict__ bk,
                                           bf16* sc, int b, int t0, int T,
                                           float slope) {
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + XRR * LDX;
  __nv_bfloat16* w_s = buf1 + XRR * LDX;
  float* st_all = reinterpret_cast<float*>(w_s + 3 * C * LDW);
  float* b_s = st_all + WARPS * 16 * LDS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st = st_all + warp * 16 * LDS;
  FragC acc[4];

  load_window<XRR, HR>(buf0, x, b, T, t0);
  zero_margins<RW>(buf1);
  __nv_bfloat16* cur = buf0;
  __nv_bfloat16* nxt = buf1;
  for (int j = 0; j < NL; ++j) {
    const int d = kDils[j];
    __syncthreads();   // the previous layer is done with w_s and nxt
    ptk::stage_rows<THREADS>(w_s, wk + static_cast<size_t>(j) * 3 * C * C,
                             3 * C, C, LDW);
    for (int i = threadIdx.x; i < C; i += THREADS) b_s[i] = bk[j * C + i];
    // stream j's rows of the reverse window to the scratch
    constexpr int V = C / 8;
    for (int i = threadIdx.x; i < WR * V; i += THREADS) {
      const int r = i / V;
      reinterpret_cast<uint4*>(sc + j * RC_STREAM + r * C)[i % V] =
          *reinterpret_cast<const uint4*>(cur + (M + HR - H + r) * LDX +
                                          (i % V) * 8);
    }
    __syncthreads();
    if (j == NL - 1) break;        // the logits are not needed
    const int offs[3] = {-d, 0, d};
    for (int s = warp; s < RW / 16; s += WARPS) {
      const int wr0 = s * 16;
      strip_product(cur, w_s, wr0, offs, acc);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(st + n * 16, acc[n], LDS,
                                wmma::mem_row_major);
      __syncwarp();
      fwd_strip_out(st, b_s, nxt, wr0, t0 - HR + wr0, T, slope, lane);
      __syncwarp();    // before the next strip overwrites the staging
    }
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// The second: the reverse pass on WR rows, masks from the scratch sc, each
// layer's dW added into the block's partial my_part (null without the
// weight gradients; zeroed instead of read on the block's first tile),
// db into db_acc, dh written to dx (or null).
__device__ __forceinline__ void rc_reverse(unsigned char* smem,
                                           const float* __restrict__ dlog,
                                           const bf16* __restrict__ wkt,
                                           float* __restrict__ dx,
                                           const bf16* sc, float* my_part,
                                           int b, int t0, int T, float slope,
                                           bool first) {
  bf16* rb0 = reinterpret_cast<bf16*>(smem);
  bf16* rb1 = rb0 + XRW * LDX;
  bf16* wb0 = rb1 + XRW * LDX;
  bf16* xd = wb0 + 2 * 3 * C * LDW;
  float* dbw = reinterpret_cast<float*>(smem + kRcRegion);  // (WARPS, 64)
  float* db_acc = dbw + WARPS * C;                         // (9, 64)
  const bool need_w = my_part != nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  cp_weights(wb0, wkt + static_cast<size_t>(NL - 1) * 3 * C * C);
  if (need_w) cp_dw_rows(xd, sc + (NL - 1) * RC_STREAM);
  ptk::cp_async_commit();
  for (int i = threadIdx.x; i < XRW * LDX; i += THREADS) {
    const int br = i / LDX;
    const int n = i - br * LDX;
    const int t = t0 - H - M + br;
    float v = 0.f;
    if (n == 0 && t >= 0 && t < T) v = dlog[static_cast<size_t>(b) * T + t];
    rb0[i] = __float2bfloat16_rn(v);
  }
  zero_margins<WR>(rb1);
  if (need_w && warp == 0) {
    // the output layer's db: dlogits summed over the centre rows
    float s = 0.f;
    for (int r = lane; r < TCR; r += 32) {
      const int t = t0 + r;
      if (t < T) s += dlog[static_cast<size_t>(b) * T + t];
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) db_acc[(NL - 1) * C] += s;
  }
  bf16* rc = rb0;
  bf16* rn = rb1;
  for (int j = NL - 1; j >= 0; --j) {
    const int d = kDils[j];
    const bf16* w_j = wb0 + ((NL - 1 - j) & 1) * 3 * C * LDW;
    ptk::cp_async_wait<0>();
    __syncthreads();   // w_j and x_j are in; rc holds bf16(dpre_j)
    if (j > 0)         // the next layer's weights, into the other buffer
      cp_weights(wb0 + ((NL - j) & 1) * 3 * C * LDW,
                 wkt + static_cast<size_t>(j - 1) * 3 * C * C);
    ptk::cp_async_commit();
    if (need_w) {      // dW_j over the centre rows, into the partial
      const int mq = warp & 3;             // as K3b's
      const int nw = 32 * (warp >> 2);
      float acc_w[3][4][4];
      float* part_j = my_part + static_cast<size_t>(j) * PR * C;
      if (first) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            acc_w[i][n][0] = acc_w[i][n][1] = acc_w[i][n][2] =
                acc_w[i][n][3] = 0.f;
      } else {
        dw_load(acc_w, part_j, mq, nw, lane);
      }
#pragma unroll 1
      for (int k = 0; k < TCR; k += 16)
        dw_step(acc_w, xd + M * LDB, LDB, rc + (M + H) * LDX, LDX, k, d, mq,
                nw, lane);
      dw_store(part_j, acc_w, mq, nw, lane);
      __syncthreads();   // every warp is done with x_j's stage
      if (j > 0) cp_dw_rows(xd, sc + (j - 1) * RC_STREAM);
      ptk::cp_async_commit();
    }
    if (j == 0 && dx == nullptr) break;
    const int g = lane >> 2, tl = lane & 3;
    const int nh = 32 * (warp & 1);        // the warp's column half
    const float m_mid = 0.5f * (1.f + slope);
    const float m_half = 0.5f * (1.f - slope);
    float dbs[4][2] = {};                  // db_j-1 of the lane's columns
    for (int u = warp; u < RC_UNITS; u += WARPS) {
      const int wr0 = 16 * (u >> 1);
      uint32_t ym[2][4];
      if (j > 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            ym[h][n] = *reinterpret_cast<const uint32_t*>(
                sc + j * RC_STREAM + (wr0 + g + 8 * h) * C + nh + 8 * n +
                2 * tl);
      float ac[4][4];
      reverse_product<1>(ac, rc + (M + wr0) * LDX, LDX, d, w_j, nh, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wr = wr0 + g + 8 * h;
        const int t = t0 - H + wr;
        const bool valid = t >= 0 && t < T;
        const bool centre = wr >= H && wr < H + TCR && t < T;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = nh + 8 * n + 2 * tl;
          const float dy0 = ac[n][2 * h], dy1 = ac[n][2 * h + 1];
          if (j > 0) {
            float2 p = make_float2(0.f, 0.f);
            if (valid)
              p = leaky_grad(
                  dy0, dy1,
                  *reinterpret_cast<const __nv_bfloat162*>(&ym[h][n]),
                  m_mid, m_half);
            *reinterpret_cast<uint32_t*>(rn + (M + wr) * LDX + c) =
                ptk::pack_bf16(p.x, p.y);
            if (centre) {
              dbs[n][0] += p.x;
              dbs[n][1] += p.y;
            }
          } else if (centre) {
            *reinterpret_cast<float2*>(
                dx + (static_cast<size_t>(b) * T + t) * C + c) =
                make_float2(dy0, dy1);
          }
        }
      }
    }
    if (j > 0 && need_w) {
      column_sums(dbs, dbw + warp * C, nh, lane);
      __syncthreads();
      if (threadIdx.x < C) {
        // the warps of the column's half, in order
        const int h0 = (threadIdx.x / 32) & 1;
        float s = 0.f;
        for (int w = h0; w < WARPS; w += 2) s += dbw[w * C + threadIdx.x];
        db_acc[(j - 1) * C + threadIdx.x] += s;
      }
    }
    bf16* tmp = rc;
    rc = rn;
    rn = tmp;
  }
  ptk::cp_async_wait<0>();
}

// K3c.  x: (B, T, 64) bf16, the layer-0 output; dlog: (B, T) f32; wk: (9,
// 3, 64, 64) bf16; wkt: (9, 192, 64) bf16; bk: (9, 64) f32.  Writes dx (B,
// T, 64) f32 when non-null; with part non-null, adds each tile's dW into
// part[block] (9, PR, 64) f32 (rows 0..191 of each layer) and writes the
// block's db to row 192.  scratch: (gridDim.x, 9, WR, 64) bf16.  Block g
// walks tiles g, g + gridDim.x, ... of the B * ceil(T / TCR) tiles.
__global__ void __launch_bounds__(THREADS, 1)
disc_bwd_rc_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dlog,
                   const __nv_bfloat16* __restrict__ wk,
                   const __nv_bfloat16* __restrict__ wkt,
                   const float* __restrict__ bk, float* __restrict__ dx,
                   __nv_bfloat16* __restrict__ scratch,
                   float* __restrict__ part, int B, int T, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* db_acc = reinterpret_cast<float*>(smem + kRcRegion) + WARPS * C;
  for (int i = threadIdx.x; i < NL * C; i += THREADS) db_acc[i] = 0.f;
  const int per_item = (T + TCR - 1) / TCR;
  bool first = true;
  for (int tile = blockIdx.x; tile < B * per_item; tile += gridDim.x) {
    const int b = tile / per_item;
    const int t0 = (tile - b * per_item) * TCR;
    bf16* sc = scratch + static_cast<size_t>(blockIdx.x) * NL * RC_STREAM;
    __syncthreads();                 // the previous tile is done
    rc_rebuild(smem, x, wk, bk, sc, b, t0, T, slope);
    __syncthreads();                 // the scratch is written, smem free
    rc_reverse(smem, dlog, wkt, dx, sc,
               part == nullptr ? nullptr
                               : part + static_cast<size_t>(blockIdx.x) *
                                            NL * PR * C,
               b, t0, T, slope, first);
    first = false;
  }
  if (part != nullptr) {
    __syncthreads();
    float* my_part = part + static_cast<size_t>(blockIdx.x) * NL * PR * C;
    for (int i = threadIdx.x; i < NL * C; i += THREADS)
      my_part[(i / C * PR + 3 * C) * C + i % C] = db_acc[i];
  }
}

bool bad_shape(int B, int T) {
  return B <= 0 || T <= 0 ||
         static_cast<long long>(B) * ((T + TC - 1) / TC) > (1LL << 30) ||
         static_cast<long long>(B) * T > (1LL << 30);
}

}  // namespace

// K3a.  x: (B, T, 64) bf16, the layer-0 output; wk: (9, 3, 64, 64) bf16
// per-tap kernels [t-d, t, t+d] (the last layer's columns 1..63 zero); bk:
// (9, 64) f32; logits: (B, T) f32; saved: null, or (9, B, T, 64) bf16, each
// layer's input.
extern "C" int pwg_disc_fwd(const void* x, const void* wk, const void* bk,
                            void* logits, void* saved, int B, int T,
                            float slope, void* stream) {
  if (bad_shape(B, T)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * ((T + TC - 1) / TC);
  cudaError_t err;
  if (saved != nullptr) {
    err = set_smem(disc_fwd_kernel<true>, kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    disc_fwd_kernel<true><<<grid, THREADS, kFwdSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wk), static_cast<const float*>(bk),
        static_cast<float*>(logits), static_cast<__nv_bfloat16*>(saved), B,
        T, slope);
  } else {
    err = set_smem(disc_fwd_kernel<false>, kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    disc_fwd_kernel<false><<<grid, THREADS, kFwdSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wk), static_cast<const float*>(bk),
        static_cast<float*>(logits), nullptr, B, T, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3b, pass j (8 down to 0) over nchunk chunks of per_chunk tiles of TM
// rows of one item each (see disc_bwd_layer_kernel for the operands).
// pwg_reduce_partials then sums part over the chunks.
extern "C" int pwg_disc_bwd_layer(const void* xj, const void* dpj,
                                  const void* dlog, const void* wkt,
                                  void* dp_out, void* dx, void* part, int j,
                                  int B, int T, int nchunk, int per_chunk,
                                  float slope, void* stream) {
  if (bad_shape(B, T) || j < 0 || j >= NL) return -1;
  if ((j == NL - 1) != (dpj == nullptr) || (j == NL - 1 && dlog == nullptr))
    return -1;
  if ((j > 0) != (dp_out != nullptr)) return -1;
  if (j == 0 && dx == nullptr && part == nullptr) return -1;
  if (xj == nullptr && (j > 0 || part != nullptr)) return -1;
  const long long tiles = static_cast<long long>(B) * ((T + TM - 1) / TM);
  if (nchunk <= 0 || per_chunk <= 0 ||
      static_cast<long long>(nchunk) * per_chunk < tiles ||
      static_cast<long long>(nchunk - 1) * per_chunk >= tiles)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem(disc_bwd_layer_kernel, kLayerSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  disc_bwd_layer_kernel<<<nchunk, THREADS, kLayerSmem, s>>>(
      static_cast<const bf16*>(xj), static_cast<const bf16*>(dpj),
      static_cast<const float*>(dlog), static_cast<const bf16*>(wkt),
      static_cast<bf16*>(dp_out), static_cast<float*>(dx),
      static_cast<float*>(part), j, B, T, slope, per_chunk);
  return static_cast<int>(cudaGetLastError());
}

// K3c's grid for (B, T) on `sms` SMs: one persistent block per SM, no more
// than there are tiles (a block with no tile would leave its partials
// unwritten).  -1 on a bad shape.
extern "C" int pwg_disc_rc_blocks(int B, int T, int sms) {
  if (bad_shape(B, T) || sms <= 0) return -1;
  const long long tiles = static_cast<long long>(B) * ((T + TCR - 1) / TCR);
  return static_cast<int>(tiles < sms ? tiles : sms);
}

// bf16 elements of one block's scratch: nine streams of WR rows.
extern "C" int pwg_disc_rc_scratch_elems() { return NL * RC_STREAM; }

// Dynamic shared memory bytes of K3b's layer pass (which 0) and of K3c
// (which 1); the launcher's Python mirror is held against it.
extern "C" long long pwg_disc_smem(int which) {
  if (which == 0) return static_cast<long long>(kLayerSmem);
  if (which == 1) return static_cast<long long>(kRcSmem);
  return -1;
}

// K3c.  x: (B, T, 64) bf16; dlog: (B, T) f32; wk: (9, 3, 64, 64) bf16; wkt:
// (9, 192, 64) bf16; bk: (9, 64) f32; dx: null or (B, T, 64) f32; scratch:
// (blocks, pwg_disc_rc_scratch_elems) bf16; part: null or (blocks, 9, 193,
// 64) f32.  pwg_reduce_partials then sums part over the blocks.
extern "C" int pwg_disc_bwd_rc(const void* x, const void* dlog,
                               const void* wk, const void* wkt,
                               const void* bk, void* dx, void* scratch,
                               void* part, int B, int T, int blocks,
                               float slope, void* stream) {
  if (bad_shape(B, T) || blocks <= 0) return -1;
  if (dx == nullptr && part == nullptr) return -1;
  if (static_cast<long long>(blocks) >
      static_cast<long long>(B) * ((T + TCR - 1) / TCR))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem(disc_bwd_rc_kernel, kRcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  disc_bwd_rc_kernel<<<blocks, THREADS, kRcSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dlog),
      static_cast<const __nv_bfloat16*>(wk),
      static_cast<const __nv_bfloat16*>(wkt), static_cast<const float*>(bk),
      static_cast<float*>(dx), static_cast<__nv_bfloat16*>(scratch),
      static_cast<float*>(part), B, T, slope);
  return static_cast<int>(cudaGetLastError());
}
