// Parallel WaveGAN residual stack, backward of one layer (kernel K2b of the
// port): three kernels per layer and one reduction per group.
//
// Replaces the Pallas TPU kernel parakeet_tpu/ops/pallas/pwg_stack_train.py::
// _bwd_kernel, which runs a group's ten layers in reverse on a sequential
// reverse grid of time blocks, carries the left-tap gradient tails from one
// block to the next (dtaps_left) and accumulates the weight gradients in
// output blocks that every grid step revisits.  CUDA blocks run in no
// order, so neither carry transfers.  Here each layer of the reverse pass is
// three launches over all B * T rows (flattened; taps never cross an item):
//
//   gate  rebuild gate = [x(t-d) | x(t+d) | x(t) | c | 1 | 0] @ wg from the
//         bf16 input rows that K2a saved, ta = tanh, sb = sigmoid;
//         h = bf16(ta * sb) (written, for dwso);
//         dso = bf16([dskip | dres]), dres = dx_out * sqrt(0.5);
//         dh = dso @ wso^T; da = dh sb (1 - ta^2), db = dh ta sb (1 - sb);
//         dg = bf16([da | db]) (written).
//   dw    per chunk of rows: dwg partial = A^T dg over the chunk (A the
//         gate operand above, three jobs over its columns), dwso partial =
//         h^T dso, dbso partial = column sums of [dskip | dres] in float32.
//   dx    dx(t) = dg(t) W1^T + dg(t+d) W0^T + dg(t-d) W2^T + dres(t) and
//         dc(t) (+)= dg(t) Wa^T, with W0, W2, W1, Wa the row blocks of wg.
//
// A group ends with one reduction of the dw partials over the chunks, in a
// fixed order (no float atomics), so two runs give bit-identical gradients.
// Products are bf16 with float32 accumulation (wmma 16x16x16), the same
// rounding points as the TPU kernel: the operands dso and dg are bf16, dh,
// da, db, dx and dc stay float32.
//
// What bounds it on the H100: bytes.  Per layer and row, the gate kernel
// reads the saved taps (3 x 2cr bytes), c, dx_out and dskip (f32) and
// writes dg and h; the dw kernel reads them again per job; the dx kernel
// reads dg three times (two taps mostly from L2), dx_out and dc and writes
// dx and dc: ~2.5 KB per row and layer at cr = 64, against ~0.6 MFLOP.  A
// first design that is right: splitting the layer into three passes costs
// the re-reads; fusing the dw products into the gate pass (they need the
// same operand) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

using namespace nvcuda;
using ptk::BATCH;

namespace {

constexpr int TM = 128;             // rows per tile (gate and dx kernels)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TK = 64;              // rows per step of the dw kernel
constexpr int AW_MAX = 128;         // widest [c | 1 | 0] operand
constexpr float SQRT_HALF = 0.70710678118654752f;

using ptk::FragA;
using ptk::FragAt;
using ptk::FragB;
using ptk::FragC;
using ptk::set_smem;

// [c(t) | 1 | 0 ...], aw columns: the 1 meets the gate-bias row of wg.
// Rows of c are 16-byte vectors when ca % 8 == 0; the rest element-wise.
__device__ void load_aux(__nv_bfloat16* dst, int ld, int col0,
                         const __nv_bfloat16* __restrict__ c, int q0,
                         int nrows, int qend, int ca, int aw) {
  const int cv = (ca % 8) == 0 ? ca / 8 : 0;
  if (cv > 0) {
    const uint4* s = reinterpret_cast<const uint4*>(c);
    for (int i = threadIdx.x; i < nrows * cv; i += THREADS) {
      const int q = q0 + i / cv;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q < qend) v = s[static_cast<size_t>(q) * cv + i % cv];
      *reinterpret_cast<uint4*>(dst + (i / cv) * ld + col0 + (i % cv) * 8) =
          v;
    }
  }
  const int rest = aw - 8 * cv;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f);
  for (int i = threadIdx.x; i < nrows * rest; i += THREADS) {
    const int r = i / rest;
    const int j = 8 * cv + (i - r * rest);
    const int q = q0 + r;
    __nv_bfloat16 v = zero;
    if (q < qend) {
      if (j < ca)
        v = c[static_cast<size_t>(q) * ca + j];
      else if (j == ca)
        v = one;
    }
    dst[r * ld + col0 + j] = v;
  }
}

// dso = bf16([dskip | dx_out * sqrt(0.5)]), 2cr columns.  With `sums`,
// each thread also adds the float32 values of its fixed four columns (the
// bias gradient dbso = column sums of [dskip | dres]).
template <int CR>
__device__ void load_dso(__nv_bfloat16* dst, int ld,
                         const float* __restrict__ dskip,
                         const float* __restrict__ dxo, int q0, int nrows,
                         int qend, float4* sums) {
  constexpr int V4 = CR / 4;               // float4 per half row
  constexpr int N4 = 2 * V4;
  static_assert(THREADS % N4 == 0, "a thread's columns must stay fixed");
  const int n = nrows * N4;
  for (int base = threadIdx.x; base < n; base += BATCH * THREADS) {
    float4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * THREADS;
      const int q = q0 + i / N4;
      const int j4 = i % N4;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && q < qend) {
        if (j4 < V4) {
          v[k] = reinterpret_cast<const float4*>(
              dskip + static_cast<size_t>(q) * CR)[j4];
        } else {
          const float4 g = reinterpret_cast<const float4*>(
              dxo + static_cast<size_t>(q) * CR)[j4 - V4];
          v[k] = make_float4(g.x * SQRT_HALF, g.y * SQRT_HALF,
                             g.z * SQRT_HALF, g.w * SQRT_HALF);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * THREADS;
      if (i < n) {
        *reinterpret_cast<uint2*>(dst + (i / N4) * ld + (i % N4) * 4) =
            ptk::pack4(v[k]);
        if (sums != nullptr) {
          sums->x += v[k].x;
          sums->y += v[k].y;
          sums->z += v[k].z;
          sums->w += v[k].w;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- gate --

template <int CR>
struct GateGeo {
  static constexpr int G = 2 * CR;
  static constexpr int LDW = G + 8;       // wg rows (bf16)
  static constexpr int LDT = CR + 8;      // wso^T rows (bf16)
  static constexpr int LDS = G + 4;       // f32 gate staging rows
  static constexpr int LDD = G + 8;       // dso rows (bf16); a warp's 16
                                          // rows then hold its dh staging
  int kp, lda;
  __host__ __device__ explicit GateGeo(int kp_)
      : kp(kp_), lda(kp_ + 8 > 2 * LDS ? kp_ + 8 : 2 * LDS) {}
  __host__ __device__ size_t w_elems() const { return size_t(kp) * LDW; }
  __host__ __device__ size_t t_elems() const { return size_t(G) * LDT; }
  __host__ __device__ size_t a_elems() const { return size_t(TM) * lda; }
  __host__ __device__ size_t d_elems() const { return size_t(TM) * LDD; }
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) *
           (w_elems() + t_elems() + a_elems() + d_elems());
  }
};

template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
gate_kernel(const __nv_bfloat16* __restrict__ saved,
            const __nv_bfloat16* __restrict__ c,
            const __nv_bfloat16* __restrict__ wg,
            const __nv_bfloat16* __restrict__ wsot,
            const float* __restrict__ dxo, const float* __restrict__ dskip,
            __nv_bfloat16* __restrict__ dg, __nv_bfloat16* __restrict__ h,
            int R, int T, int CA, int KP, int d) {
  using Geo = GateGeo<CR>;
  constexpr int G = Geo::G;
  constexpr int NF = G / 16;
  constexpr int NH = CR / 16;
  constexpr int LDW = Geo::LDW, LDT = Geo::LDT, LDS = Geo::LDS;
  constexpr int LDD = Geo::LDD;
  const Geo geo(KP);
  const int lda = geo.lda;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* t_s = w_s + geo.w_elems();
  __nv_bfloat16* a_s = t_s + geo.t_elems();
  __nv_bfloat16* d_s = a_s + geo.a_elems();
  ptk::stage_rows<THREADS>(w_s, wg, KP, G, LDW);
  ptk::stage_rows<THREADS>(t_s, wsot, G, CR, LDT);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  float* st_s = reinterpret_cast<float*>(a_s + r0 * lda);
  float* dh_s = reinterpret_cast<float*>(d_s + r0 * LDD);
  const int ntiles = (R + TM - 1) / TM;
  FragC acc[NF];
  FragA af;
  FragB bf;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * TM;
    __syncthreads();   // weights staged; the previous tile is done
    ptk::load_rows<CR, THREADS>(a_s, lda, 0, saved, q0, TM, R, T, -d);
    ptk::load_rows<CR, THREADS>(a_s, lda, CR, saved, q0, TM, R, T, d);
    ptk::load_rows<CR, THREADS>(a_s, lda, 2 * CR, saved, q0, TM, R, T, 0);
    load_aux(a_s, lda, 3 * CR, c, q0, TM, R, CA, KP - 3 * CR);
    load_dso<CR>(d_s, LDD, dskip, dxo, q0, TM, R, nullptr);
    __syncthreads();

    // the gate, exactly as the forward computed it
#pragma unroll
    for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int k = 0; k < KP; k += 16) {
      wmma::load_matrix_sync(af, a_s + r0 * lda + k, lda);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::load_matrix_sync(bf, w_s + k * LDW + n * 16, LDW);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NF; ++n)
      wmma::store_matrix_sync(st_s + n * 16, acc[n], LDS,
                              wmma::mem_row_major);
    __syncwarp();
    // ta and sb in place of the gate; h to device memory
    for (int i = lane; i < 16 * CR; i += 32) {
      const int r = i / CR;
      const int j = i - r * CR;
      const float ta = ptk::fast_tanh(st_s[r * LDS + j]);
      const float sb = ptk::fast_sigmoid(st_s[r * LDS + CR + j]);
      st_s[r * LDS + j] = ta;
      st_s[r * LDS + CR + j] = sb;
      const int q = q0 + r0 + r;
      if (q < R)
        h[static_cast<size_t>(q) * CR + j] = __float2bfloat16_rn(ta * sb);
    }

    // dh = dso @ wso^T   (16 x 2CR) @ (2CR x CR)
#pragma unroll
    for (int n = 0; n < NH; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int k = 0; k < G; k += 16) {
      wmma::load_matrix_sync(af, d_s + r0 * LDD + k, LDD);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        wmma::load_matrix_sync(bf, t_s + k * LDT + n * 16, LDT);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
    __syncwarp();      // all of this warp's dso reads are done
#pragma unroll
    for (int n = 0; n < NH; ++n)
      wmma::store_matrix_sync(dh_s + n * 16, acc[n], CR,
                              wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * CR; i += 32) {
      const int r = i / CR;
      const int j = i - r * CR;
      const int q = q0 + r0 + r;
      if (q >= R) continue;
      const float dh = dh_s[r * CR + j];
      const float ta = st_s[r * LDS + j];
      const float sb = st_s[r * LDS + CR + j];
      const size_t o = static_cast<size_t>(q) * G;
      dg[o + j] = __float2bfloat16_rn(dh * sb * (1.f - ta * ta));
      dg[o + CR + j] = __float2bfloat16_rn(dh * ta * sb * (1.f - sb));
    }
  }
}

// ------------------------------------------------------------------ dx --

template <int CR>
struct DxGeo {
  static constexpr int K6 = 6 * CR;       // [dg(t) | dg(t+d) | dg(t-d)]
  static constexpr int LDX = CR + 8;      // wdx rows (bf16)
  int cap, ldc, lda;                      // cap = ca rounded up to 16
  __host__ __device__ explicit DxGeo(int cap_)
      : cap(cap_), ldc(cap_ + 8),
        lda(K6 + 8 > 2 * (CR + cap_ + 8) ? K6 + 8 : 2 * (CR + cap_ + 8)) {}
  __host__ __device__ size_t x_elems() const { return size_t(K6) * LDX; }
  __host__ __device__ size_t c_elems() const { return size_t(2 * CR) * ldc; }
  __host__ __device__ size_t a_elems() const { return size_t(TM) * lda; }
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) * (x_elems() + c_elems() + a_elems());
  }
};

template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
dx_kernel(const __nv_bfloat16* __restrict__ dg,
          const __nv_bfloat16* __restrict__ wdx,
          const __nv_bfloat16* __restrict__ wdc,
          const float* __restrict__ dxo, float* __restrict__ dx,
          float* __restrict__ dc, int R, int T, int CA, int CAP, int d,
          int dc_init) {
  using Geo = DxGeo<CR>;
  constexpr int G = 2 * CR;
  constexpr int K6 = Geo::K6;
  constexpr int LDX = Geo::LDX;
  constexpr int NX = CR / 16;
  constexpr int NC_MAX = AW_MAX / 16;
  const Geo geo(CAP);
  const int lda = geo.lda, ldc = geo.ldc;
  const int nc = CAP / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wx_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wc_s = wx_s + geo.x_elems();
  __nv_bfloat16* a_s = wc_s + geo.c_elems();
  ptk::stage_rows<THREADS>(wx_s, wdx, K6, CR, LDX);
  ptk::stage_rows<THREADS>(wc_s, wdc, G, CAP, ldc);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  // staging over this warp's operand rows: dx (16 x CR+4), dc (16 x CAP+4)
  float* sx_s = reinterpret_cast<float*>(a_s + r0 * lda);
  float* sc_s = sx_s + 16 * (CR + 4);
  const int ntiles = (R + TM - 1) / TM;
  FragC accx[NX], accc[NC_MAX];
  FragA af;
  FragB bf;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * TM;
    __syncthreads();
    ptk::load_rows<G, THREADS>(a_s, lda, 0, dg, q0, TM, R, T, 0);
    ptk::load_rows<G, THREADS>(a_s, lda, G, dg, q0, TM, R, T, d);
    ptk::load_rows<G, THREADS>(a_s, lda, 2 * G, dg, q0, TM, R, T, -d);
    __syncthreads();

#pragma unroll
    for (int n = 0; n < NX; ++n) wmma::fill_fragment(accx[n], 0.f);
#pragma unroll
    for (int n = 0; n < NC_MAX; ++n) wmma::fill_fragment(accc[n], 0.f);
    for (int k = 0; k < K6; k += 16) {
      wmma::load_matrix_sync(af, a_s + r0 * lda + k, lda);
#pragma unroll
      for (int n = 0; n < NX; ++n) {
        wmma::load_matrix_sync(bf, wx_s + k * LDX + n * 16, LDX);
        wmma::mma_sync(accx[n], af, bf, accx[n]);
      }
      if (k < G) {     // dc reads dg(t) only
#pragma unroll
        for (int n = 0; n < NC_MAX; ++n) {
          if (n < nc) {
            wmma::load_matrix_sync(bf, wc_s + k * ldc + n * 16, ldc);
            wmma::mma_sync(accc[n], af, bf, accc[n]);
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NX; ++n)
      wmma::store_matrix_sync(sx_s + n * 16, accx[n], CR + 4,
                              wmma::mem_row_major);
#pragma unroll
    for (int n = 0; n < NC_MAX; ++n)
      if (n < nc)
        wmma::store_matrix_sync(sc_s + n * 16, accc[n], CAP + 4,
                                wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * CR; i += 32) {
      const int r = i / CR;
      const int j = i - r * CR;
      const int q = q0 + r0 + r;
      if (q >= R) continue;
      const size_t o = static_cast<size_t>(q) * CR + j;
      dx[o] = sx_s[r * (CR + 4) + j] + dxo[o] * SQRT_HALF;
    }
    for (int i = lane; i < 16 * CA; i += 32) {
      const int r = i / CA;
      const int j = i - r * CA;
      const int q = q0 + r0 + r;
      if (q >= R) continue;
      const size_t o = static_cast<size_t>(q) * CA + j;
      const float v = sc_s[r * (CAP + 4) + j];
      dc[o] = dc_init ? v : dc[o] + v;
    }
  }
}

// ------------------------------------------------------------------ dw --

// Jobs (blockIdx.y) over the columns of the gate operand, each a product
// X^T Y summed over a chunk of rows, written to rows [row0, row0 + mw) of
// the chunk's (KP + CR + 1, 2CR) float32 partial:
//   0: X = [x(t-d) | x(t+d)], Y = dg   -> dwg rows [0, 2CR)
//   1: X = [x(t) | c | 1 | 0], Y = dg  -> dwg rows [2CR, KP)
//   2: X = h, Y = dso                  -> dwso, and the dbso row (f32 sums)
template <int CR>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const __nv_bfloat16* __restrict__ saved,
          const __nv_bfloat16* __restrict__ c,
          const __nv_bfloat16* __restrict__ dg,
          const __nv_bfloat16* __restrict__ h,
          const float* __restrict__ dskip, const float* __restrict__ dxo,
          float* __restrict__ part, int R, int T, int CA, int KP, int d,
          int chunk_rows, long long part_stride) {
  constexpr int G = 2 * CR;
  constexpr int NG = G / 16;
  constexpr int LDY = G + 8;
  constexpr int FR = ((CR + AW_MAX) / 16 * NG + WARPS - 1) / WARPS;
  const int job = blockIdx.y;
  const int aw = KP - 3 * CR;
  const int mw = job == 0 ? 2 * CR : (job == 1 ? CR + aw : CR);
  const int row0 = job == 0 ? 0 : (job == 1 ? 2 * CR : KP);
  const int ldx = mw + 8;
  const int mt = (mw / 16) * NG;          // output tiles of this job

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* y_s = x_s + TK * ldx;
  const int warp = threadIdx.x / 32;
  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);
  float4 sums = make_float4(0.f, 0.f, 0.f, 0.f);

  FragC acc[FR];
#pragma unroll
  for (int k = 0; k < FR; ++k) wmma::fill_fragment(acc[k], 0.f);
  FragAt af;
  FragB bf;

  for (int q0 = qa; q0 < qb; q0 += TK) {
    __syncthreads();
    if (job == 0) {
      ptk::load_rows<CR, THREADS>(x_s, ldx, 0, saved, q0, TK, qb, T, -d);
      ptk::load_rows<CR, THREADS>(x_s, ldx, CR, saved, q0, TK, qb, T, d);
    } else if (job == 1) {
      ptk::load_rows<CR, THREADS>(x_s, ldx, 0, saved, q0, TK, qb, T, 0);
      load_aux(x_s, ldx, CR, c, q0, TK, qb, CA, aw);
    } else {
      ptk::load_rows<CR, THREADS>(x_s, ldx, 0, h, q0, TK, qb, T, 0);
    }
    if (job == 2)
      load_dso<CR>(y_s, LDY, dskip, dxo, q0, TK, qb, &sums);
    else
      ptk::load_rows<G, THREADS>(y_s, LDY, 0, dg, q0, TK, qb, T, 0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
#pragma unroll
      for (int k = 0; k < FR; ++k) {
        const int tix = warp + k * WARPS;
        if (tix < mt) {
          const int mi = tix / NG;
          const int ni = tix - mi * NG;
          // X^T: the (mw x TK) transpose of the row-major tile, col-major
          wmma::load_matrix_sync(af, x_s + kk * ldx + mi * 16, ldx);
          wmma::load_matrix_sync(bf, y_s + kk * LDY + ni * 16, LDY);
          wmma::mma_sync(acc[k], af, bf, acc[k]);
        }
      }
    }
  }

  float* out = part + blockIdx.x * part_stride;
#pragma unroll
  for (int k = 0; k < FR; ++k) {
    const int tix = warp + k * WARPS;
    if (tix < mt) {
      const int mi = tix / NG;
      const int ni = tix - mi * NG;
      wmma::store_matrix_sync(out + static_cast<size_t>(row0 + mi * 16) * G +
                                  ni * 16,
                              acc[k], G, wmma::mem_row_major);
    }
  }
  if (job == 2) {
    // dbso: the threads that share four columns add their sums in order
    constexpr int N4 = G / 4;
    __syncthreads();
    float4* red = reinterpret_cast<float4*>(smem);
    red[threadIdx.x] = sums;
    __syncthreads();
    if (threadIdx.x < N4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = threadIdx.x; p < THREADS; p += N4) {
        s.x += red[p].x;
        s.y += red[p].y;
        s.z += red[p].z;
        s.w += red[p].w;
      }
      reinterpret_cast<float4*>(out + static_cast<size_t>(KP + CR) * G)
          [threadIdx.x] = s;
    }
  }
}

template <int CR>
size_t dw_smem(int KP) {
  const int mw = CR + (KP - 3 * CR) > 2 * CR ? CR + (KP - 3 * CR) : 2 * CR;
  const size_t x = static_cast<size_t>(TK) * (mw + 8);
  const size_t y = static_cast<size_t>(TK) * (2 * CR + 8);
  const size_t red = THREADS * sizeof(float4) / sizeof(__nv_bfloat16);
  return sizeof(__nv_bfloat16) * (x + y > red ? x + y : red);
}

int persistent_grid(int R, int sms) {
  const int ntiles = (R + TM - 1) / TM;
  return ntiles < sms ? ntiles : sms;
}

template <int CR>
cudaError_t gate_launch(const void* saved, const void* c, const void* wg,
                        const void* wsot, const void* dxo, const void* dskip,
                        void* dg, void* h, int R, int T, int CA, int KP,
                        int d, cudaStream_t s) {
  const size_t smem = GateGeo<CR>(KP).bytes();
  int sms = 0;
  cudaError_t err = ptk::sm_count(&sms);
  if (err == cudaSuccess) err = set_smem(gate_kernel<CR>, smem);
  if (err != cudaSuccess) return err;
  gate_kernel<CR><<<persistent_grid(R, sms), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(saved),
      static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wsot),
      static_cast<const float*>(dxo), static_cast<const float*>(dskip),
      static_cast<__nv_bfloat16*>(dg), static_cast<__nv_bfloat16*>(h), R, T,
      CA, KP, d);
  return cudaGetLastError();
}

template <int CR>
cudaError_t dx_launch(const void* dg, const void* wdx, const void* wdc,
                      const void* dxo, void* dx, void* dc, int R, int T,
                      int CA, int CAP, int d, int dc_init, cudaStream_t s) {
  const size_t smem = DxGeo<CR>(CAP).bytes();
  int sms = 0;
  cudaError_t err = ptk::sm_count(&sms);
  if (err == cudaSuccess) err = set_smem(dx_kernel<CR>, smem);
  if (err != cudaSuccess) return err;
  dx_kernel<CR><<<persistent_grid(R, sms), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(dg),
      static_cast<const __nv_bfloat16*>(wdx),
      static_cast<const __nv_bfloat16*>(wdc), static_cast<const float*>(dxo),
      static_cast<float*>(dx), static_cast<float*>(dc), R, T, CA, CAP, d,
      dc_init);
  return cudaGetLastError();
}

template <int CR>
cudaError_t dw_launch(const void* saved, const void* c, const void* dg,
                      const void* h, const void* dskip, const void* dxo,
                      void* part, int R, int T, int CA, int KP, int d,
                      int nchunk, int chunk_rows, long long part_stride,
                      cudaStream_t s) {
  const size_t smem = dw_smem<CR>(KP);
  cudaError_t err = set_smem(dw_kernel<CR>, smem);
  if (err != cudaSuccess) return err;
  dw_kernel<CR><<<dim3(nchunk, 3), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(saved),
      static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(dg),
      static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(dskip),
      static_cast<const float*>(dxo), static_cast<float*>(part), R, T, CA,
      KP, d, chunk_rows, part_stride);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int CR, int CA, int KP) {
  if (B <= 0 || T <= 0 || CA <= 0) return true;
  if (static_cast<long long>(B) * T > (1LL << 30)) return true;
  if (CR != 32 && CR != 64) return true;
  if (KP % 16 != 0 || KP < 3 * CR + CA + 1 || KP - 3 * CR > AW_MAX)
    return true;
  return false;
}

}  // namespace

// Gate pass of one layer.  saved: (B, T, CR) bf16, the layer's input rows
// (K2a); c: (B, T, CA) bf16; wg: (KP, 2CR) bf16 as K1 takes it; wsot:
// (2CR, CR) bf16 = [W_skip | W_out]^T; dxo: (B, T, CR) f32, the gradient of
// the layer's output; dskip: (B, T, CR) f32, of the group's skip sum.
// Writes dg (B, T, 2CR) bf16 and h (B, T, CR) bf16.
extern "C" int pwg_stack_bwd_gate(const void* saved, const void* c,
                                  const void* wg, const void* wsot,
                                  const void* dxo, const void* dskip,
                                  void* dg, void* h, int B, int T, int CR,
                                  int CA, int KP, int d, void* stream) {
  if (bad_shape(B, T, CR, CA, KP) || d < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * T;
  if (CR == 32)
    return static_cast<int>(gate_launch<32>(saved, c, wg, wsot, dxo, dskip,
                                            dg, h, R, T, CA, KP, d, s));
  return static_cast<int>(gate_launch<64>(saved, c, wg, wsot, dxo, dskip,
                                          dg, h, R, T, CA, KP, d, s));
}

// dx pass of one layer.  dg: (B, T, 2CR) bf16; wdx: (6CR, CR) bf16 =
// [W1^T; W0^T; W2^T] (centre, t-d and t+d taps of wg, transposed); wdc:
// (2CR, CAP) bf16 = Wa^T with CAP = CA rounded up to 16; dxo: (B, T, CR)
// f32.  Writes dx (B, T, CR) f32 and writes (dc_init) or adds to dc
// (B, T, CA) f32.
extern "C" int pwg_stack_bwd_dx(const void* dg, const void* wdx,
                                const void* wdc, const void* dxo, void* dx,
                                void* dc, int B, int T, int CR, int CA,
                                int CAP, int d, int dc_init, void* stream) {
  if (B <= 0 || T <= 0 || CA <= 0 || d < 0) return -1;
  if (static_cast<long long>(B) * T > (1LL << 30)) return -1;
  if (CAP % 16 != 0 || CAP < CA || CAP > AW_MAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * T;
  if (CR == 32)
    return static_cast<int>(dx_launch<32>(dg, wdx, wdc, dxo, dx, dc, R, T,
                                          CA, CAP, d, dc_init, s));
  if (CR == 64)
    return static_cast<int>(dx_launch<64>(dg, wdx, wdc, dxo, dx, dc, R, T,
                                          CA, CAP, d, dc_init, s));
  return -1;
}

// Weight-gradient partials of one layer: chunk i of `chunk_rows` rows
// writes the (KP + CR + 1, 2CR) f32 block at part + i * part_stride: rows
// [0, KP) dwg, [KP, KP + CR) dwso, row KP + CR dbso.
extern "C" int pwg_stack_bwd_dw(const void* saved, const void* c,
                                const void* dg, const void* h,
                                const void* dskip, const void* dxo,
                                void* part, int B, int T, int CR, int CA,
                                int KP, int d, int nchunk, int chunk_rows,
                                long long part_stride, void* stream) {
  if (bad_shape(B, T, CR, CA, KP) || d < 0) return -1;
  if (chunk_rows <= 0 || chunk_rows % TK != 0 || nchunk <= 0) return -1;
  if (static_cast<long long>(nchunk) * chunk_rows <
      static_cast<long long>(B) * T)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * T;
  if (CR == 32)
    return static_cast<int>(dw_launch<32>(saved, c, dg, h, dskip, dxo, part,
                                          R, T, CA, KP, d, nchunk,
                                          chunk_rows, part_stride, s));
  return static_cast<int>(dw_launch<64>(saved, c, dg, h, dskip, dxo, part, R,
                                        T, CA, KP, d, nchunk, chunk_rows,
                                        part_stride, s));
}

// out[i] = sum over p < nparts of part[p * n + i], in order.
extern "C" int pwg_reduce_partials(const void* part, void* out, int nparts,
                                   long long n, void* stream) {
  if (nparts <= 0 || n <= 0) return -1;
  return static_cast<int>(ptk::reduce_partials(
      static_cast<const float*>(part), static_cast<float*>(out), nparts, n,
      static_cast<cudaStream_t>(stream)));
}
