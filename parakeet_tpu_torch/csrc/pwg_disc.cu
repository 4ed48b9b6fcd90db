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
// The forward-layer routine (forward_layer), which K3a and K3c's rebuild
// share: a warp keeps one column half of the layer's [Wl; Wc; Wr] as
// mma.sync B fragments in registers for the whole layer and, per 16-row
// strip of the bf16 window in shared memory, forms pre in m16n8k16
// registers from ldmatrix fragments of the rows t - d, t and t + d
// (forward_product: taps in the order -d, 0, d, k ascending).  Its
// epilogue runs on the accumulators' lanes: the bias, LeakyReLU, zero
// outside [0, T), bf16 pairs into the next window, and, where the caller
// asks, a 16-byte copy of the strip's rows to a stream in global memory.
// Layer j computes only the rows its output is needed on, in whole strips:
// the rows wanted of x_8 plus, on each side, the dilations of layers j +
// 1 .. 7 still to come (forward_strips).  One routine and one order of
// products in both kernels, so K3c rebuilds K3a's streams bit for bit.
//
// K3a.  The TPU kernel walks time blocks in order and carries each layer's
// left tail; CUDA blocks run in no order.  Here a block owns TC = 400
// centre rows of one item and runs the nine layers on a window of those
// rows and RF = 37 (the sum of the dilations) on each side, so the centre
// rows are exact and no block waits for another.  Layers 0..7 shrink from
// 480 rows to 416 (the centre and 36, 34, 31, 27, 22, 16, 9, 1 rows on each
// side, rounded up to strips); the output layer computes its first n8
// column tile only (column 0's sums do not depend on the others): 1.14x
// the useful products.  The window arrives in float32 by cp.async (rows
// outside the item zero-filled), staged over the second window, and is
// rounded to bf16 in shared memory (h.to(bfloat16) bit for bit, so no
// separate cast of h runs); with saving, that pass writes stream 0's
// centre rows and the epilogues streams 1..8.  Each next layer's weights
// arrive by cp.async into a second buffer while this layer computes.
// Window and weight pitch 72 bf16 (144 bytes, an odd multiple of 16):
// ldmatrix and the epilogue's 4-byte stores are free of bank conflicts.
// What bounds it on the H100: products, ~0.2 MFLOP a row against ~1.4 KB
// a row with saving and 0.26 KB without.
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
// a fixed order.  Per tile a block re-runs layers 1..8 with K3a's
// forward-layer routine on a window of TCR + 2 * 80 rows (the 80-row halo
// covers the reverse window's 40 plus the 36 rows the rebuilt streams lose
// at the edges), its epilogue writing the eight rebuilt streams'
// reverse-window rows (and the loaded window stream 0's) to a per-block
// scratch in global memory.  Its reverse half then runs the routine on TCR
// + 2 * 40 rows in the same shared memory (the forward's windows are free
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

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;               // channels
constexpr int NL = 9;               // layers 1..9 of the discriminator
constexpr int H = 40;               // K3c: reverse halo rows on each side
constexpr int M = 8;                // margin rows (>= the largest dilation)
constexpr int LDX = 80;             // K3c's reverse windows' pitch (bf16)
constexpr int LDW = C + 8;          // weight pitch (bf16)
// pitch of rows read by ldmatrix only: 144 bytes, an odd multiple of 16,
// so the eight rows of one ldmatrix read hit distinct banks
constexpr int LDB = C + 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PR = 3 * C + 1;       // rows of a layer's partial: dW, db

__constant__ int kDils[NL] = {1, 2, 3, 4, 5, 6, 7, 8, 1};
// the dilations of layers j + 1 .. 7, for j = 0 .. 7: how far x_j+1 must
// be exact beyond the rows wanted of x_8
__constant__ int kAhead[NL - 1] = {35, 33, 30, 26, 21, 15, 8, 0};

using ptk::set_smem;

// The same geometry, for constant expressions: a layer's dilation, the
// dilations after it up to layer 7, and the strips layer j computes so
// that `rows` rows of x_8 are exact.
constexpr int dil_of(int j) { return j == NL - 1 ? 1 : j + 1; }
constexpr int ahead_of(int j) {
  return j >= NL - 2 ? 0 : dil_of(j + 1) + ahead_of(j + 1);
}
constexpr int strips_of(int rows, int j) {
  return (rows + 2 * ahead_of(j) + 15) / 16;
}
// window rows: one past the last row the layers read (a layer's last strip
// may overrun the rows it must keep exact), the rows wanted of x_8
// starting at window row `first`
constexpr int window_rows(int rows, int first) {
  int top = 0;
  for (int j = 0; j < NL - 1; ++j) {
    const int end = first - ahead_of(j) + 16 * strips_of(rows, j) + dil_of(j);
    top = end > top ? end : top;
  }
  return top;
}

constexpr size_t kWBytes = sizeof(bf16) * 3 * C * LDW;

// cp.async of one layer's (192, 64) weights into rows of pitch LDW
__device__ __forceinline__ void cp_weights(bf16* w_s, const bf16* w) {
  for (int i = threadIdx.x; i < 3 * C * (C / 8); i += THREADS)
    ptk::cp_async16(w_s + (i >> 3) * LDW + (i & 7) * 8, w + i * 8, true);
}

// cp.async of window rows [0, ROWS) of one item (src: its (T, 64) bf16
// rows) into rows of pitch LDB; window row r is time tw0 + r, zero-filled
// outside [0, T)
template <int ROWS>
__device__ __forceinline__ void cp_window(bf16* win, const bf16* src,
                                          int tw0, int T) {
  for (int i = threadIdx.x; i < ROWS * (C / 8); i += THREADS) {
    const int r = i >> 3, v = i & 7;
    const int t = tw0 + r;
    const bool ok = t >= 0 && t < T;
    ptk::cp_async16(win + r * LDB + v * 8,
                    src + static_cast<size_t>(ok ? t : 0) * C + v * 8, ok);
  }
}

template <int ROWS>
__device__ __forceinline__ void zero_rows(bf16* win) {
  for (int i = threadIdx.x; i < ROWS * LDB / 8; i += THREADS)
    reinterpret_cast<uint4*>(win)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ------------------------------------------- the forward-layer routine --

// B fragments of a layer's [Wl; Wc; Wr] (w_s: 192 rows of pitch LDW) for
// the NT n8 column tiles from n0: bw[tap][k / 16][n] = {b0, b1}.
template <int NT>
__device__ __forceinline__ void weight_frags(uint32_t (&bw)[3][4][NT][2],
                                             const bf16* w_s, int n0,
                                             int lane) {
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int p = 0; p < (NT + 1) / 2; ++p) {
        uint32_t v[4];
        ptk::ldsm_x4_trans(v, w_s + (tap * C + 16 * ks + (lane & 15)) * LDW +
                                  n0 + 16 * p + (lane >> 4) * 8);
        bw[tap][ks][2 * p][0] = v[0];
        bw[tap][ks][2 * p][1] = v[1];
        if (2 * p + 1 < NT) {
          bw[tap][ks][2 * p + 1][0] = v[2];
          bw[tap][ks][2 * p + 1][1] = v[3];
        }
      }
}

// pre of one warp's 16-row strip, without the bias, on the column tiles of
// bw: acc = x(t - d) Wl + x(t) Wc + x(t + d) Wr.  a: the strip's first row
// of the bf16 layer input (row r at a + r * LDB; rows r +- d readable).
// Taps in the order -d, 0, d, k ascending.  acc[n][0..1] are columns 8n +
// 2 (lane % 4) + {0, 1} of bw's first column, of row lane / 4;
// acc[n][2..3] those of row lane / 4 + 8.
template <int NT>
__device__ __forceinline__ void forward_product(
    float (&acc)[NT][4], const bf16* a, int d,
    const uint32_t (&bw)[3][4][NT][2], int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    const bf16* ap = a + ((tap - 1) * d + (lane & 15)) * LDB + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4];
      ptk::ldsm_x4(af, ap + 16 * ks);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        ptk::mma_bf16(acc[n], af, bw[tap][ks][n][0], bw[tap][ks][n][1]);
    }
  }
}

// Layer j < 8 of the forward on a window in shared memory (window row r is
// time tw0 + r): x_j+1 = bf16(leaky(pre + b)), zero outside [0, T), from
// cur into nxt (both of pitch LDB), on the strips that keep rows [first,
// first + rows) of x_8 exact.  w_s: the layer's weights; b_s: its 64
// biases.  Warp w keeps column half w % 2 and takes strips w / 2, w / 2 +
// 4, ...  dst: null, or where rows [c_lo, c_hi) of x_j+1 go (row r to dst
// + (r - c_lo) * 64), each warp copying its strips' rows of its half.
__device__ __forceinline__ void forward_layer(const bf16* cur, bf16* nxt,
                                              const bf16* w_s,
                                              const float* b_s, int j,
                                              int first, int rows, int tw0,
                                              int T, float slope, bf16* dst,
                                              int c_lo, int c_hi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, tl = lane & 3;
  const int n0 = 32 * (warp & 1);
  const int d = kDils[j];
  const int lo = first - kAhead[j];
  const int nstrips = (rows + 2 * kAhead[j] + 15) / 16;
  uint32_t bw[3][4][4][2];
  weight_frags<4>(bw, w_s, n0, lane);
  float bias[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bias[n][0] = b_s[n0 + 8 * n + 2 * tl];
    bias[n][1] = b_s[n0 + 8 * n + 2 * tl + 1];
  }
  for (int s = warp >> 1; s < nstrips; s += WARPS / 2) {
    const int r0 = lo + 16 * s;
    float acc[4][4];
    forward_product<4>(acc, cur + r0 * LDB, d, bw, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const int t = tw0 + r;
      const bool valid = t >= 0 && t < T;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float v0 = acc[n][2 * h] + bias[n][0];
        float v1 = acc[n][2 * h + 1] + bias[n][1];
        v0 = v0 > 0.f ? v0 : slope * v0;
        v1 = v1 > 0.f ? v1 : slope * v1;
        if (!valid) v0 = v1 = 0.f;
        *reinterpret_cast<uint32_t*>(nxt + r * LDB + n0 + 8 * n + 2 * tl) =
            ptk::pack_bf16(v0, v1);
      }
    }
    if (dst != nullptr) {
      __syncwarp();    // the strip's rows of this half are in nxt
#pragma unroll
      for (int k = 0; k < 2; ++k) {   // 16 rows x 4 vectors of 16 bytes
        const int i = lane + 32 * k;
        const int r = r0 + (i >> 2);
        const int c = n0 + (i & 3) * 8;
        if (r >= c_lo && r < c_hi)
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r - c_lo) * C +
                                    c) =
              *reinterpret_cast<const uint4*>(nxt + r * LDB + c);
      }
    }
  }
}

// ----------------------------------------------------------------- K3a --

constexpr int TC = 400;             // K3a: centre rows a block
constexpr int RF = 37;              // the receptive field: sum of dilations
// window row r is time t0 - RF + r; rows RF - 1 .. RF + TC of x_8 are
// wanted (the centre and the output conv's taps)
constexpr int XA = window_rows(TC + 2, RF - 1);
static_assert(RF == dil_of(0) + ahead_of(0) + dil_of(NL - 1),
              "the halo is the receptive field");
static_assert(XA >= TC + 2 * RF, "the window holds the receptive field");
// Shared memory: win0, the first weight buffer, then win1 and the second
// weight buffer, over which the float32 window is staged before the first
// layer (and the rows it needs past them); then the biases.
constexpr size_t kWinBytes = sizeof(bf16) * XA * LDB;
constexpr size_t kF32WinBytes = sizeof(float) * XA * C;
constexpr size_t kFwdTail = kF32WinBytes > kWinBytes + kWBytes
                                ? kF32WinBytes
                                : kWinBytes + kWBytes;
constexpr size_t kFwdSmem = kWinBytes + kWBytes + kFwdTail +
                            sizeof(float) * NL * C;
static_assert(kFwdSmem <= 232448, "K3a fits a block's shared memory");
static_assert(kWinBytes % 16 == 0 && kWBytes % 16 == 0, "16-byte regions");

// K3a: block g owns centre rows t0 .. t0 + TC - 1 of item b (g = b *
// tiles + t0 / TC).  h: (B, T, 64) float32, the layer-0 output, which the
// block stages by cp.async and rounds to bf16 (as h.to(torch.bfloat16))
// into its first window; with SAVE it writes the nine streams of saved
// (9, B, T, 64): stream 0 from that window, 1..8 from the epilogues.
template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
disc_fwd_kernel(const float* __restrict__ h, const bf16* __restrict__ wk,
                const float* __restrict__ bk, float* __restrict__ logits,
                bf16* __restrict__ saved, int B, int T, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* win0 = reinterpret_cast<bf16*>(smem);
  bf16* w_s0 = win0 + XA * LDB;
  bf16* win1 = w_s0 + 3 * C * LDW;
  bf16* w_s1 = win1 + XA * LDB;
  float* stage = reinterpret_cast<float*>(win1);   // (XA, 64) float32
  float* b_s = reinterpret_cast<float*>(smem + kWinBytes + kWBytes +
                                        kFwdTail);
  auto w_s = [&](int j) { return (j & 1) ? w_s1 : w_s0; };

  const int tiles = (T + TC - 1) / TC;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TC;
  const int tw0 = t0 - RF;
  const int n_c = min(TC, T - t0);             // centre rows in the item
  const size_t item = static_cast<size_t>(b) * T;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the float32 window (zero outside [0, T)) and w_0 by cp.async
  for (int i = threadIdx.x; i < XA * (C / 4); i += THREADS) {
    const int r = i >> 4, v = i & 15;
    const int t = tw0 + r;
    const bool ok = t >= 0 && t < T;
    ptk::cp_async16(stage + r * C + v * 4,
                    h + (item + (ok ? t : 0)) * C + v * 4, ok);
  }
  cp_weights(w_s0, wk);
  ptk::cp_async_commit();
  for (int i = threadIdx.x; i < NL * C; i += THREADS) b_s[i] = bk[i];
  ptk::cp_async_wait<0>();
  __syncthreads();     // the float32 window is in
  for (int i = threadIdx.x; i < XA * (C / 8); i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(stage + r * C + c);
    const float4 hi = *reinterpret_cast<const float4*>(stage + r * C + c + 4);
    const uint4 v = make_uint4(ptk::pack_bf16(lo.x, lo.y),
                               ptk::pack_bf16(lo.z, lo.w),
                               ptk::pack_bf16(hi.x, hi.y),
                               ptk::pack_bf16(hi.z, hi.w));
    *reinterpret_cast<uint4*>(win0 + r * LDB + c) = v;
    if constexpr (SAVE)
      if (r >= RF && r < RF + n_c)
        *reinterpret_cast<uint4*>(saved + (item + t0 + r - RF) * C + c) = v;
  }
  __syncthreads();     // the stage is read: win1 and w_s1 are free
  zero_rows<XA>(win1);   // rows no layer writes are read as zeros
  bf16* cur = win0;
  bf16* nxt = win1;
  for (int j = 0; j < NL - 1; ++j) {
    ptk::cp_async_wait<0>();
    __syncthreads();   // x_j and w_j are in; layer j - 1 is done
    cp_weights(w_s(j + 1), wk + static_cast<size_t>(j + 1) * 3 * C * C);
    ptk::cp_async_commit();
    bf16* dst = nullptr;
    if constexpr (SAVE)
      dst = saved + (static_cast<size_t>(j + 1) * B * T + item + t0) * C;
    forward_layer(cur, nxt, w_s(j), b_s + j * C, j, RF - 1, TC + 2, tw0, T,
                  slope, dst, RF, RF + n_c);
    bf16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  ptk::cp_async_wait<0>();
  __syncthreads();     // x_8 and w_8 are in
  // the output conv: column 0 of pre over the centre's strips
  uint32_t bw[3][4][1][2];
  weight_frags<1>(bw, w_s(NL - 1), 0, lane);
  const float b8 = b_s[(NL - 1) * C];
  for (int s = warp; s < TC / 16; s += WARPS) {
    float acc[1][4];
    forward_product<1>(acc, cur + (RF + 16 * s) * LDB, kDils[NL - 1], bw,
                       lane);
    if ((lane & 3) == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + 16 * s + lane / 4 + 8 * r;
        if (t < T) logits[item + t] = acc[0][2 * r] + b8;
      }
  }
}
static_assert(TC % 16 == 0, "the output conv runs on whole strips");

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
constexpr int WR = TCR + 2 * H;     // reverse window and scratch rows
// the recompute window: window row r is time t0 - HR + r; rows HR - H ..
// HR - H + WR - 1 of the rebuilt streams are wanted (the reverse window)
constexpr int XRR = window_rows(WR, HR - H);
constexpr int XRW = WR + 2 * M;     // buffer rows of the reverse half
constexpr int XD = TCR + 2 * M;     // rows of the dW operand's stage
constexpr int RC_STREAM = WR * C;   // scratch elements of one stream
constexpr int RC_UNITS = 2 * (WR / 16);   // reverse: strips x column halves
static_assert(WR % 16 == 0 && TCR % 16 == 0, "the windows are whole strips");
static_assert(HR - H >= dil_of(0) + ahead_of(0),
              "the rebuilt streams are exact on the reverse window (they "
              "lose the sum of dilations 1..8)");
static_assert(XRR >= TCR + 2 * HR, "the recompute window holds the halo");
static_assert(WARPS % 2 == 0, "a warp keeps one column half");

// The two halves share one region of shared memory, in turn:
//   recompute: win0, win1 (XRR x LDB bf16), two layers' weights, the
//              biases of layers 0..7;
//   reverse:   rb0, rb1 (XRW x LDX bf16), two weight buffers, the dW
//              operand's stage (XD x LDB bf16);
// then, for the whole kernel, db partials (WARPS x 64) and db (9 x 64).
constexpr size_t kRcFwdBytes = 2 * sizeof(bf16) * XRR * LDB + 2 * kWBytes +
                               sizeof(float) * (NL - 1) * C;
constexpr size_t kRcRevBytes = 2 * sizeof(bf16) * XRW * LDX + 2 * kWBytes +
                               sizeof(bf16) * XD * LDB;
constexpr size_t kRcRegion = kRcFwdBytes > kRcRevBytes ? kRcFwdBytes
                                                       : kRcRevBytes;
constexpr size_t kRcSmem = kRcRegion + sizeof(float) * (WARPS + NL) * C;
static_assert(kRcSmem <= 232448, "K3c fits a block's shared memory");

// Zero the M margin rows on each side of a reverse window of WROWS rows.
template <int WROWS>
__device__ void zero_margins(bf16* buf) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < 2 * M * LDX; i += THREADS) {
    const int r = i / LDX;
    buf[(r < M ? r : WROWS + r) * LDX + i % LDX] = zero;
  }
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
// The first: rebuild the streams with K3a's forward-layer routine (layers
// 0..7, the next layer's weights arriving by cp.async while one computes)
// and write stream j's reverse-window rows to the block's scratch sc:
// stream 0 from the loaded window, the others from the epilogue.
__device__ __forceinline__ void rc_rebuild(unsigned char* smem,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ wk,
                                           const float* __restrict__ bk,
                                           bf16* sc, int b, int t0, int T,
                                           float slope) {
  constexpr int c_lo = HR - H;       // the reverse window's first row
  bf16* win0 = reinterpret_cast<bf16*>(smem);
  bf16* win1 = win0 + XRR * LDB;
  bf16* w_s = win1 + XRR * LDB;                // two layers' weights
  float* b_s = reinterpret_cast<float*>(w_s + 2 * 3 * C * LDW);
  const int tw0 = t0 - HR;

  cp_window<XRR>(win0, x + static_cast<size_t>(b) * T * C, tw0, T);
  cp_weights(w_s, wk);
  ptk::cp_async_commit();
  for (int i = threadIdx.x; i < (NL - 1) * C; i += THREADS) b_s[i] = bk[i];
  zero_rows<XRR>(win1);
  bf16* cur = win0;
  bf16* nxt = win1;
  for (int j = 0; j < NL - 1; ++j) {
    ptk::cp_async_wait<0>();
    __syncthreads();   // x_j and w_j are in; layer j - 1 is done
    if (j + 1 < NL - 1)
      cp_weights(w_s + ((j + 1) & 1) * 3 * C * LDW,
                 wk + static_cast<size_t>(j + 1) * 3 * C * C);
    ptk::cp_async_commit();
    if (j == 0)
      for (int i = threadIdx.x; i < WR * (C / 8); i += THREADS)
        reinterpret_cast<uint4*>(sc)[i] = *reinterpret_cast<const uint4*>(
            cur + (c_lo + (i >> 3)) * LDB + (i & 7) * 8);
    forward_layer(cur, nxt, w_s + (j & 1) * 3 * C * LDW, b_s + j * C, j,
                  c_lo, WR, tw0, T, slope, sc + (j + 1) * RC_STREAM, c_lo,
                  c_lo + WR);
    bf16* tmp = cur;
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

// K3a.  h: (B, T, 64) f32, the layer-0 output; wk: (9, 3, 64, 64) bf16
// per-tap kernels [t-d, t, t+d] (the last layer's columns 1..63 zero); bk:
// (9, 64) f32; logits: (B, T) f32; saved: null, or (9, B, T, 64) bf16, each
// layer's input (stream 0 is bf16(h)).
extern "C" int pwg_disc_fwd(const void* h, const void* wk, const void* bk,
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
        static_cast<const float*>(h), static_cast<const bf16*>(wk),
        static_cast<const float*>(bk), static_cast<float*>(logits),
        static_cast<bf16*>(saved), B, T, slope);
  } else {
    err = set_smem(disc_fwd_kernel<false>, kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    disc_fwd_kernel<false><<<grid, THREADS, kFwdSmem, s>>>(
        static_cast<const float*>(h), static_cast<const bf16*>(wk),
        static_cast<const float*>(bk), static_cast<float*>(logits), nullptr,
        B, T, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3a's resident blocks an SM, from the occupancy calculator after the
// shared-memory opt-in; -1 on an error.
extern "C" int pwg_disc_fwd_blocks_per_sm() {
  int n = 0;
  if (set_smem(disc_fwd_kernel<true>, kFwdSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, disc_fwd_kernel<true>, THREADS, kFwdSmem) != cudaSuccess)
    return -1;
  return n;
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

// Dynamic shared memory bytes of K3b's layer pass (which 0), of K3c
// (which 1) and of K3a (which 2); the launcher's Python mirror is held
// against it.
extern "C" long long pwg_disc_smem(int which) {
  if (which == 0) return static_cast<long long>(kLayerSmem);
  if (which == 1) return static_cast<long long>(kRcSmem);
  if (which == 2) return static_cast<long long>(kFwdSmem);
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
