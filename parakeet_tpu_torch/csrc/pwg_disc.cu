// Parallel WaveGAN discriminator, layers 1..9 forward (kernel K3a) and
// backward (kernel K3b) of the port.
//
// Replaces the Pallas TPU kernels parakeet_tpu/ops/pallas/pwg_disc.py::
// _fwd_save_kernel / _fwd_nosave_kernel (K3a) and _bwd_kernel (K3b).  The
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
// The mask comes from the sign of the saved next-layer input (LeakyReLU
// keeps signs), as on the TPU, so nothing is recomputed.  Unlike the TPU
// kernel, dy is zeroed outside the signal before every layer: the TPU's
// reverse grid lets gradient leak through rows past the signal's ends into
// the last ~37 rows of each end (measured against autograd of the bf16
// forward; ROADMAP queue 3).
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
// Weight gradients: a second kernel sums X^T dpre over chunks of rows per
// layer into partials, which a fixed-order reduction adds up (no atomics).
//
// What bounds it on the H100: bytes.  K3a reads x (128 B a row) and, with
// saving, writes nine bf16 streams (1.15 KB a row); K3b reads the saved
// streams for the masks and writes the dpre streams; the products are
// ~5 MFLOP a row.

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

// Load buffer rows [0, XR) of item b from a (B, T, 64) bf16 tensor, zero
// outside [0, T); row br is time t0 - H - M + br.
__device__ void load_window(__nv_bfloat16* buf,
                            const __nv_bfloat16* __restrict__ src, int b,
                            int T, int t0) {
  constexpr int V = C / 8;
  for (int i = threadIdx.x; i < XR * V; i += THREADS) {
    const int br = i / V;
    const int t = t0 - H - M + br;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < T)
      v = reinterpret_cast<const uint4*>(
          src + (static_cast<size_t>(b) * T + t) * C)[i % V];
    *reinterpret_cast<uint4*>(buf + br * LDX + (i % V) * 8) = v;
  }
}

__device__ void zero_margins(__nv_bfloat16* buf) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < 2 * M * LDX; i += THREADS) {
    const int r = i / LDX;
    buf[(r < M ? r : WIN + r) * LDX + i % LDX] = zero;
  }
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

  load_window(buf0, x, b, T, t0);
  zero_margins(buf1);
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
        for (int i = lane; i < 16 * C; i += 32) {
          const int r = i / C;
          const int n = i - r * C;
          const int t = t0 - H + wr0 + r;
          float v = st[r * LDS + n] + b_s[n];
          v = v > 0.f ? v : slope * v;
          if (t < 0 || t >= T) v = 0.f;
          nxt[(M + wr0 + r) * LDX + n] = __float2bfloat16_rn(v);
        }
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
  zero_margins(buf1);
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
            const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(
                saved + static_cast<size_t>(j) * stream + o);
            const float y0 = __low2float(y), y1 = __high2float(y);
            const float s0 = y0 > 0.f ? 1.f : (y0 < 0.f ? -1.f : 0.f);
            const float s1 = y1 > 0.f ? 1.f : (y1 < 0.f ? -1.f : 0.f);
            p0 = dy0 * (m_mid + m_half * s0);
            p1 = dy1 * (m_mid + m_half * s1);
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
