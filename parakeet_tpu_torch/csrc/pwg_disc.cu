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
// Layout: the TPU kernel walks time blocks in order and carries each
// layer's left tail; CUDA blocks run in no order.  Here a block owns TC =
// 400 centre rows of one item and computes all nine layers on a window of
// TC + 2 * 40 rows in shared memory: the 40-row halo on each side covers
// the receptive field (the sum of dilations, 37), so the centre rows are
// exact and no block waits for another.  The halo costs 20% more products.
// Each layer's taps are read straight from the bf16 window at row offsets
// t +- d (a pitch of 80 bf16 keeps every row 32-byte aligned, as wmma's
// loads need); the weights of one layer (24 KB) are staged per layer.
// K3b's weight gradients: a second kernel sums X^T dpre over chunks of
// rows per layer into partials, which a fixed-order reduction adds up (no
// atomics).
//
// K3c reads h and dlogits only and writes dh, dW and db: the nine
// full-size streams never reach HBM.  The TPU kernel keeps all nine
// rebuilt streams of a ~4,200-row window in VMEM (4.9 MB); an SM has 227
// KB, and the reverse pass alone fills it.  Design taken, the simple one:
// persistent blocks, one per SM, each walking tiles of TCR = 208 centre
// rows in a fixed order.  Per tile it re-runs K3a's layers 1..8 on a
// window of TCR + 2 * 80 rows (the 80-row halo covers the reverse window's
// 40 plus the 36 rows the rebuilt streams lose at the edges), writes the
// nine streams' reverse-window rows (288 a stream, 324 KB a block, 43 MB
// over 132 blocks: L2-sized) to a per-block scratch in global memory, then
// runs K3b's reverse pass on TCR + 2 * 40 rows reading the masks from that
// scratch, and adds the tile's dW (wmma over the centre rows) and db into
// per-block partials.  The fixed-order reduction then sums the blocks'
// partials: gradients are bit-identical from run to run.  Every layer is
// computed by the same device code as K3a and K3b, so the rebuilt streams
// equal K3a's saved ones and dh equals K3b's bitwise; dW and db are summed
// in another grouping.  Thread-block clusters sharing the streams in
// distributed shared memory would keep them out of L2: later work.
//
// What bounds them on the H100: K3a and K3b bytes (K3a reads x, 128 B a
// row, and with saving writes nine bf16 streams, 1.15 KB a row; K3b reads
// the streams and writes the dpre streams), while the products are 9
// layers x 3 taps x 64 x 64 x 2 = 0.22 MFLOP a row forward.  K3c moves
// ~0.4 KB a row (h in, dh out) against ~0.59 MFLOP of useful products a
// row (layers 1..8 again, dx and dW): operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int C = 64;               // channels
constexpr int NL = 9;               // layers 1..9 of the discriminator
constexpr int H = 40;               // halo rows on each side (>= 37)
constexpr int TC = 400;             // centre rows per block
constexpr int WIN = TC + 2 * H;     // window rows, 30 strips of 16
constexpr int M = 8;                // margin rows (>= the largest dilation)
constexpr int XR = WIN + 2 * M;     // buffer rows
constexpr int LDX = 80;             // buffer pitch (bf16): 160-byte rows
constexpr int LDW = C + 8;          // weight pitch (bf16)
constexpr int LDS = C + 4;          // f32 staging pitch
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STRIPS = WIN / 16;
constexpr int TK = 64;              // rows per step of the dw kernel
static_assert(WIN % 16 == 0, "the window is whole strips");

__constant__ int kDils[NL] = {1, 2, 3, 4, 5, 6, 7, 8, 1};

using ptk::FragA;
using ptk::FragAt;
using ptk::FragB;
using ptk::FragC;
using ptk::set_smem;

constexpr size_t kBufBytes = sizeof(__nv_bfloat16) * XR * LDX;
constexpr size_t kWBytes = sizeof(__nv_bfloat16) * 3 * C * LDW;
constexpr size_t kStBytes = sizeof(float) * WARPS * 16 * LDS;
constexpr size_t kFwdSmem = 2 * kBufBytes + kWBytes + kStBytes +
                            sizeof(float) * C;
constexpr size_t kBwdSmem = 2 * kBufBytes + kWBytes + kStBytes +
                            sizeof(float) * WARPS * C;

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

// ----------------------------------------------------------------- K3b --

// Reverse pass over the nine layers for one block's window.  dlog: (B, T)
// f32.  wkt: (9, 192, 64) bf16, per layer [Wl^T; Wc^T; Wr^T].  Writes dx
// (B, T, 64) f32 when non-null; with dpre non-null, writes each layer's
// bf16 dpre stream (9, B, T, 64) and the block's float32 column sums of
// dpre over its centre rows to dbp[block] (9, 64).
__global__ void __launch_bounds__(THREADS, 1)
disc_bwd_kernel(const __nv_bfloat16* __restrict__ saved,
                const float* __restrict__ dlog,
                const __nv_bfloat16* __restrict__ wkt,
                float* __restrict__ dx, __nv_bfloat16* __restrict__ dpre,
                float* __restrict__ dbp, int B, int T, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + XR * LDX;
  __nv_bfloat16* w_s = buf1 + XR * LDX;
  float* st_all = reinterpret_cast<float*>(w_s + 3 * C * LDW);
  float* dbw = st_all + WARPS * 16 * LDS;       // (WARPS, 64) db partials

  const int tiles = (T + TC - 1) / TC;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st = st_all + warp * 16 * LDS;
  const size_t stream = static_cast<size_t>(B) * T * C;
  const float m_mid = 0.5f * (1.f + slope);
  const float m_half = 0.5f * (1.f - slope);

  // dpre of the output layer: dlogits in column 0
  for (int i = threadIdx.x; i < XR * LDX; i += THREADS) {
    const int br = i / LDX;
    const int n = i - br * LDX;
    const int t = t0 - H - M + br;
    float v = 0.f;
    if (n == 0 && t >= 0 && t < T) v = dlog[static_cast<size_t>(b) * T + t];
    buf0[i] = __float2bfloat16_rn(v);
  }
  zero_margins<WIN>(buf1);
  if (dpre != nullptr && warp == 0) {
    // the output layer's db: dlogits summed over the centre rows
    float s = 0.f;
    for (int r = lane; r < TC; r += 32) {
      const int t = t0 + r;
      if (t < T) s += dlog[static_cast<size_t>(b) * T + t];
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    float* out = dbp + (static_cast<size_t>(blockIdx.x) * NL + NL - 1) * C;
    for (int n = lane; n < C; n += 32) out[n] = n == 0 ? s : 0.f;
  }
  __syncthreads();
  if (dpre != nullptr)
    store_centre(dpre + (NL - 1) * stream, buf0, b, T, t0);

  __nv_bfloat16* cur = buf0;
  __nv_bfloat16* nxt = buf1;
  FragC acc[4];
  for (int j = NL - 1; j >= 0; --j) {
    const int d = kDils[j];
    __syncthreads();
    ptk::stage_rows<THREADS>(w_s, wkt + static_cast<size_t>(j) * 3 * C * C,
                             3 * C, C, LDW);
    __syncthreads();
    // [Wl^T; Wc^T; Wr^T] meet dpre(t + d), dpre(t), dpre(t - d)
    const int offs[3] = {d, 0, -d};
    float db0 = 0.f, db1 = 0.f;    // this lane's columns 2 lane, 2 lane + 1
    for (int s = warp; s < STRIPS; s += WARPS) {
      const int wr0 = s * 16;
      strip_product(cur, w_s, wr0, offs, acc);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(st + n * 16, acc[n], LDS,
                                wmma::mem_row_major);
      __syncwarp();
      const int n0 = 2 * lane;
      for (int r = 0; r < 16; ++r) {
        const int wr = wr0 + r;
        const int t = t0 - H + wr;
        const bool valid = t >= 0 && t < T;
        const bool centre = wr >= H && wr < H + TC && t < T;
        const float dy0 = st[r * LDS + n0];
        const float dy1 = st[r * LDS + n0 + 1];
        const size_t o = (static_cast<size_t>(b) * T + (valid ? t : 0)) * C +
                         n0;
        if (j > 0) {
          // dpre of layer j - 1: its output is layer j's saved input
          float p0 = 0.f, p1 = 0.f;
          if (valid) {
            const float2 p = leaky_grad(
                dy0, dy1,
                *reinterpret_cast<const __nv_bfloat162*>(
                    saved + static_cast<size_t>(j) * stream + o),
                m_mid, m_half);
            p0 = p.x;
            p1 = p.y;
          }
          const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
          *reinterpret_cast<__nv_bfloat162*>(nxt + (M + wr) * LDX + n0) = pb;
          if (centre) {
            db0 += p0;
            db1 += p1;
            if (dpre != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(
                  dpre + static_cast<size_t>(j - 1) * stream + o) = pb;
          }
        } else if (centre && dx != nullptr) {
          *reinterpret_cast<float2*>(dx + o) = make_float2(dy0, dy1);
        }
      }
      __syncwarp();
    }
    if (j > 0 && dpre != nullptr) {
      dbw[warp * C + 2 * lane] = db0;
      dbw[warp * C + 2 * lane + 1] = db1;
      __syncthreads();
      if (threadIdx.x < C) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += dbw[w * C + threadIdx.x];
        dbp[(static_cast<size_t>(blockIdx.x) * NL + j - 1) * C +
            threadIdx.x] = s;
      }
    }
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// dW partials: block (chunk, layer j) sums X^T bf16(dpre_j) over its rows,
// X = [x_j(t-d) | x_j(t) | x_j(t+d)] from the saved stream; writes the
// (192, 64) f32 block part[chunk][j].
__global__ void __launch_bounds__(THREADS)
disc_dw_kernel(const __nv_bfloat16* __restrict__ saved,
               const __nv_bfloat16* __restrict__ dpre,
               float* __restrict__ part, int B, int T, int chunk_rows) {
  constexpr int K3 = 3 * C;
  constexpr int LDXW = K3 + 8;
  constexpr int LDY = C + 8;
  constexpr int NG = C / 16;
  constexpr int MT = (K3 / 16) * NG;      // 48 output tiles
  constexpr int FR = MT / WARPS;
  static_assert(MT % WARPS == 0, "tiles divide among warps");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* y_s = x_s + TK * LDXW;
  const int j = blockIdx.y;
  const int d = kDils[j];
  const int R = B * T;
  const size_t stream = static_cast<size_t>(R) * C;
  const __nv_bfloat16* xs = saved + j * stream;
  const __nv_bfloat16* ys = dpre + j * stream;
  const int warp = threadIdx.x / 32;
  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);

  FragC acc[FR];
#pragma unroll
  for (int k = 0; k < FR; ++k) wmma::fill_fragment(acc[k], 0.f);
  FragAt af;
  FragB bf;
  for (int q0 = qa; q0 < qb; q0 += TK) {
    __syncthreads();
    ptk::load_rows<C, THREADS>(x_s, LDXW, 0, xs, q0, TK, qb, T, -d);
    ptk::load_rows<C, THREADS>(x_s, LDXW, C, xs, q0, TK, qb, T, 0);
    ptk::load_rows<C, THREADS>(x_s, LDXW, 2 * C, xs, q0, TK, qb, T, d);
    ptk::load_rows<C, THREADS>(y_s, LDY, 0, ys, q0, TK, qb, T, 0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
#pragma unroll
      for (int k = 0; k < FR; ++k) {
        const int tix = warp + k * WARPS;
        const int mi = tix / NG;
        const int ni = tix - mi * NG;
        wmma::load_matrix_sync(af, x_s + kk * LDXW + mi * 16, LDXW);
        wmma::load_matrix_sync(bf, y_s + kk * LDY + ni * 16, LDY);
        wmma::mma_sync(acc[k], af, bf, acc[k]);
      }
    }
  }
  float* out = part + (static_cast<size_t>(blockIdx.x) * NL + j) * K3 * C;
#pragma unroll
  for (int k = 0; k < FR; ++k) {
    const int tix = warp + k * WARPS;
    const int mi = tix / NG;
    const int ni = tix - mi * NG;
    wmma::store_matrix_sync(out + mi * 16 * C + ni * 16, acc[k], C,
                            wmma::mem_row_major);
  }
}

constexpr size_t kDwSmem =
    sizeof(__nv_bfloat16) * TK * ((3 * C + 8) + (C + 8));

// ----------------------------------------------------------------- K3c --

constexpr int TCR = 208;            // centre rows per tile
constexpr int HR = 80;              // recompute halo: H + the 36 rows lost
constexpr int RW = TCR + 2 * HR;    // recompute window, 23 strips
constexpr int WR = TCR + 2 * H;     // reverse window and scratch rows, 18
constexpr int XRR = RW + 2 * M;     // buffer rows
constexpr int XRW = WR + 2 * M;     // buffer rows the reverse pass uses
constexpr int RC_STREAM = WR * C;   // scratch elements of one stream
static_assert(RW % 16 == 0 && WR % 16 == 0 && TCR % 16 == 0,
              "the windows are whole strips");
static_assert(HR - H >= 36, "the rebuilt streams are exact on the reverse "
                            "window (they lose the sum of dilations 1..8)");

constexpr size_t kRcBufBytes = sizeof(__nv_bfloat16) * XRR * LDX;
constexpr size_t kRcSmem = 2 * kRcBufBytes + kWBytes + kStBytes +
                           sizeof(float) * (C + WARPS * C + NL * C);

// One tile's dW_j added to the block's partial part_j (192, 64) f32:
// X_j^T bf16(dpre_j) over the tile's centre rows, X_j = [x_j(t-d) |
// x_j(t) | x_j(t+d)] from the scratch stream xs (rows of the reverse
// window, pitch 64), dpre_j from the reverse buffer dp.  Each warp owns 6
// of the 48 output tiles, in the same order on every tile.
__device__ void rc_tile_dw(const __nv_bfloat16* xs, const __nv_bfloat16* dp,
                           float* part_j, int d, bool first, int warp) {
  constexpr int NG = C / 16;
  constexpr int MT = (3 * C / 16) * NG;     // 48 output tiles
  constexpr int FR = MT / WARPS;
  static_assert(MT % WARPS == 0, "tiles divide among warps");
  FragC acc[FR];
#pragma unroll
  for (int k = 0; k < FR; ++k) {
    const int tix = warp + k * WARPS;
    const int mi = tix / NG;
    const int ni = tix - mi * NG;
    if (first)
      wmma::fill_fragment(acc[k], 0.f);
    else
      wmma::load_matrix_sync(acc[k], part_j + mi * 16 * C + ni * 16, C,
                             wmma::mem_row_major);
  }
  FragAt af;
  FragB bf;
  for (int kk = 0; kk < TCR; kk += 16) {
#pragma unroll
    for (int k = 0; k < FR; ++k) {
      const int tix = warp + k * WARPS;
      const int mi = tix / NG;
      const int ni = tix - mi * NG;
      const int tap = mi / NG;             // rows tap * 64 + 16 * (mi % 4)
      const int off = (tap - 1) * d;
      wmma::load_matrix_sync(af, xs + (H + kk + off) * C + (mi % NG) * 16, C);
      wmma::load_matrix_sync(bf, dp + (M + H + kk) * LDX + ni * 16, LDX);
      wmma::mma_sync(acc[k], af, bf, acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < FR; ++k) {
    const int tix = warp + k * WARPS;
    const int mi = tix / NG;
    const int ni = tix - mi * NG;
    wmma::store_matrix_sync(part_j + mi * 16 * C + ni * 16, acc[k], C,
                            wmma::mem_row_major);
  }
}

// K3c.  x: (B, T, 64) bf16, the layer-0 output; dlog: (B, T) f32; wk: (9,
// 3, 64, 64) bf16; wkt: (9, 192, 64) bf16; bk: (9, 64) f32.  Writes dx (B,
// T, 64) f32 when non-null; with part non-null, adds each tile's dW into
// part[block] (9, 192, 64) f32 and writes the block's db to dbp[block]
// (9, 64) f32.  scratch: (gridDim.x, 9, WR, 64) bf16.  Block g walks tiles
// g, g + gridDim.x, ... of the B * ceil(T / TCR) tiles.
__global__ void __launch_bounds__(THREADS, 1)
disc_bwd_rc_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dlog,
                   const __nv_bfloat16* __restrict__ wk,
                   const __nv_bfloat16* __restrict__ wkt,
                   const float* __restrict__ bk, float* __restrict__ dx,
                   __nv_bfloat16* __restrict__ scratch,
                   float* __restrict__ part, float* __restrict__ dbp, int B,
                   int T, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + XRR * LDX;
  __nv_bfloat16* w_s = buf1 + XRR * LDX;
  float* st_all = reinterpret_cast<float*>(w_s + 3 * C * LDW);
  float* b_s = st_all + WARPS * 16 * LDS;
  float* dbw = b_s + C;                      // (WARPS, 64) db partials
  float* db_acc = dbw + WARPS * C;           // (9, 64): this block's db

  const int per_item = (T + TCR - 1) / TCR;
  const int tiles = B * per_item;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st = st_all + warp * 16 * LDS;
  const bool need_w = part != nullptr;
  const float m_mid = 0.5f * (1.f + slope);
  const float m_half = 0.5f * (1.f - slope);
  __nv_bfloat16* sc = scratch + static_cast<size_t>(blockIdx.x) * NL *
                                    RC_STREAM;
  float* my_part = need_w ? part + static_cast<size_t>(blockIdx.x) * NL *
                                       3 * C * C
                          : nullptr;
  for (int i = threadIdx.x; i < NL * C; i += THREADS) db_acc[i] = 0.f;
  FragC acc[4];

  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_item;
    const int t0 = (tile - b * per_item) * TCR;

    // ---- rebuild the streams: K3a's layers 1..8 on RW rows ----
    __syncthreads();                 // the previous tile is done
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

    // ---- K3b's reverse pass on WR rows, masks from the scratch ----
    __syncthreads();                 // the scratch and buffers are written
    for (int i = threadIdx.x; i < XRW * LDX; i += THREADS) {
      const int br = i / LDX;
      const int n = i - br * LDX;
      const int t = t0 - H - M + br;
      float v = 0.f;
      if (n == 0 && t >= 0 && t < T) v = dlog[static_cast<size_t>(b) * T + t];
      buf0[i] = __float2bfloat16_rn(v);
    }
    zero_margins<WR>(buf1);
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
    cur = buf0;
    nxt = buf1;
    for (int j = NL - 1; j >= 0; --j) {
      const int d = kDils[j];
      __syncthreads();
      ptk::stage_rows<THREADS>(w_s, wkt + static_cast<size_t>(j) * 3 * C * C,
                               3 * C, C, LDW);
      __syncthreads();
      if (need_w)      // cur holds bf16(dpre_j) on the window
        rc_tile_dw(sc + j * RC_STREAM, cur,
                   my_part + static_cast<size_t>(j) * 3 * C * C, d, first,
                   warp);
      if (j == 0 && dx == nullptr) break;
      const int offs[3] = {d, 0, -d};
      float db0 = 0.f, db1 = 0.f;    // this lane's columns 2 lane, 2 lane + 1
      for (int s = warp; s < WR / 16; s += WARPS) {
        const int wr0 = s * 16;
        strip_product(cur, w_s, wr0, offs, acc);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(st + n * 16, acc[n], LDS,
                                  wmma::mem_row_major);
        __syncwarp();
        const int n0 = 2 * lane;
        for (int r = 0; r < 16; ++r) {
          const int wr = wr0 + r;
          const int t = t0 - H + wr;
          const bool valid = t >= 0 && t < T;
          const bool centre = wr >= H && wr < H + TCR && t < T;
          const float dy0 = st[r * LDS + n0];
          const float dy1 = st[r * LDS + n0 + 1];
          if (j > 0) {
            // dpre of layer j - 1: its output is stream j
            float p0 = 0.f, p1 = 0.f;
            if (valid) {
              const float2 p = leaky_grad(
                  dy0, dy1,
                  *reinterpret_cast<const __nv_bfloat162*>(
                      sc + j * RC_STREAM + wr * C + n0),
                  m_mid, m_half);
              p0 = p.x;
              p1 = p.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(nxt + (M + wr) * LDX + n0) =
                __floats2bfloat162_rn(p0, p1);
            if (centre) {
              db0 += p0;
              db1 += p1;
            }
          } else if (centre) {
            *reinterpret_cast<float2*>(
                dx + (static_cast<size_t>(b) * T + t) * C + n0) =
                make_float2(dy0, dy1);
          }
        }
        __syncwarp();
      }
      if (j > 0 && need_w) {
        dbw[warp * C + 2 * lane] = db0;
        dbw[warp * C + 2 * lane + 1] = db1;
        __syncthreads();
        if (threadIdx.x < C) {
          float s = 0.f;
          for (int w = 0; w < WARPS; ++w) s += dbw[w * C + threadIdx.x];
          db_acc[(j - 1) * C + threadIdx.x] += s;
        }
      }
      __nv_bfloat16* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    first = false;
  }
  if (need_w) {
    __syncthreads();
    for (int i = threadIdx.x; i < NL * C; i += THREADS)
      dbp[static_cast<size_t>(blockIdx.x) * NL * C + i] = db_acc[i];
  }
}

bool bad_shape(int B, int T) {
  return B <= 0 || T <= 0 ||
         static_cast<long long>(B) * ((T + TC - 1) / TC) > (1LL << 30) ||
         static_cast<long long>(B) * T > (1LL << 30);
}

}  // namespace

// Blocks of the K3a and K3b grids for (B, T): one per TC centre rows of an
// item (the wrapper sizes the db partials with it).
extern "C" int pwg_disc_blocks(int B, int T) {
  if (bad_shape(B, T)) return -1;
  return B * ((T + TC - 1) / TC);
}

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

// K3b, reverse pass.  saved: (9, B, T, 64) bf16 from K3a; dlog: (B, T) f32;
// wkt: (9, 192, 64) bf16; dx: null or (B, T, 64) f32; dpre: null or
// (9, B, T, 64) bf16; dbp: (pwg_disc_blocks, 9, 64) f32, with dpre.
extern "C" int pwg_disc_bwd(const void* saved, const void* dlog,
                            const void* wkt, void* dx, void* dpre, void* dbp,
                            int B, int T, float slope, void* stream) {
  if (bad_shape(B, T)) return -1;
  if ((dpre == nullptr) != (dbp == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * ((T + TC - 1) / TC);
  cudaError_t err = set_smem(disc_bwd_kernel, kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  disc_bwd_kernel<<<grid, THREADS, kBwdSmem, s>>>(
      static_cast<const __nv_bfloat16*>(saved),
      static_cast<const float*>(dlog),
      static_cast<const __nv_bfloat16*>(wkt), static_cast<float*>(dx),
      static_cast<__nv_bfloat16*>(dpre), static_cast<float*>(dbp), B, T,
      slope);
  return static_cast<int>(cudaGetLastError());
}

// K3b, weight gradients: chunk i of `chunk_rows` rows (a multiple of 64)
// writes part[i] (9, 192, 64) f32; pwg_reduce_partials then sums them.
extern "C" int pwg_disc_dw(const void* saved, const void* dpre, void* part,
                           int B, int T, int nchunk, int chunk_rows,
                           void* stream) {
  if (bad_shape(B, T) || nchunk <= 0 || chunk_rows <= 0 ||
      chunk_rows % TK != 0)
    return -1;
  if (static_cast<long long>(nchunk) * chunk_rows <
      static_cast<long long>(B) * T)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem(disc_dw_kernel, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  disc_dw_kernel<<<dim3(nchunk, NL), THREADS, kDwSmem, s>>>(
      static_cast<const __nv_bfloat16*>(saved),
      static_cast<const __nv_bfloat16*>(dpre), static_cast<float*>(part), B,
      T, chunk_rows);
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

// K3c.  x: (B, T, 64) bf16; dlog: (B, T) f32; wk: (9, 3, 64, 64) bf16; wkt:
// (9, 192, 64) bf16; bk: (9, 64) f32; dx: null or (B, T, 64) f32; scratch:
// (blocks, pwg_disc_rc_scratch_elems) bf16; part: null or (blocks, 9, 192,
// 64) f32 and dbp (blocks, 9, 64) f32 with it.  pwg_reduce_partials then
// sums part and dbp over the blocks.
extern "C" int pwg_disc_bwd_rc(const void* x, const void* dlog,
                               const void* wk, const void* wkt,
                               const void* bk, void* dx, void* scratch,
                               void* part, void* dbp, int B, int T,
                               int blocks, float slope, void* stream) {
  if (bad_shape(B, T) || blocks <= 0) return -1;
  if ((part == nullptr) != (dbp == nullptr)) return -1;
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
      static_cast<float*>(part), static_cast<float*>(dbp), B, T, slope);
  return static_cast<int>(cudaGetLastError());
}
