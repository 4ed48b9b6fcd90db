// Parallel WaveGAN residual stack, forward: one gated residual layer per
// launch (kernel K1 of the port, inference; with a save pointer, kernel K2a,
// the training forward).
//
// K2a replaces parakeet_tpu/ops/pallas/pwg_stack.py::_group_save_kernel:
// K1 plus a write of each layer's input rows as bf16, (B, T, cr), which the
// backward (pwg_stack_bwd.cu, K2b) rebuilds the gate from.  The TPU pads
// those rows to 128 lanes for Mosaic's DMA alignment; here they keep cr.
// The save is a template branch, so K1 is compiled without it.
//
// Replaces the Pallas TPU kernel parakeet_tpu/ops/pallas/pwg_stack.py::
// _group_kernel (body _group_body), which runs a whole group of ten layers
// per call on a sequential grid of time blocks and carries each layer's
// left tail from one block to the next.  CUDA blocks run in no order, so
// that carry does not transfer; this kernel runs one layer per launch and
// lets neighbouring blocks read the rows t - d and t + d they need from the
// previous layer's output in device memory.
//
// Per time row t of one batch item, with d the layer's dilation:
//   gate[0:2cr]   = [x(t-d) | x(t+d) | x(t) | c(t) | 1 | 0..] @ wg
//   h[0:cr]       = bf16(tanh(gate[:cr]) * sigmoid(gate[cr:]))
//   so[0:2cr]     = h @ wso + bso                      ([skip | res])
//   skip(t)      += so[:cr]                            (float32, in place)
//   x_next(t)     = (so[cr:] + x(t)) * sqrt(0.5)       (float32)
// Operands of both products are bf16 with float32 accumulation
// (nvcuda::wmma 16x16x16 tiles); x outside [0, T) is zero.  The gate bias
// is the row of wg that meets the constant-1 column, so it is bf16, as on
// the TPU.  At the last layer of a group x_next is rounded to bf16
// (round_out), and the very last layer writes bf16 only (x_out_bf16).
//
// What bounds it on the H100: bytes.  At T = 268,800 and cr = 64, x is
// 69 MB in float32 against a 50 MB L2; a layer reads x (three taps, the
// two shifted ones mostly from L2), c (43 MB in bf16) and the skip sum
// (69 MB), and writes the skip sum and x_next: 0.3 to 0.46 GB per layer
// (the latter when the shifted taps miss L2) for 2.3 * 10^10 FLOP, some 50
// to 80 FLOP per byte against the card's ~295.  The design keeps both
// products on the tensor cores and fuses gate, skip and residual into one
// pass, so each row makes one round trip per layer.  Measured on an H100
// 80GB HBM3 at 700 W: ~10.8 ms per 30-layer call at B=1, T=268,800, about
// 38% of the bytes roofline (PERF.md).
//
// Layout: persistent blocks, one per SM, each of eight warps.  A block
// stages the layer's weights (wg and wso, ~95 KB at cr = 64) in shared
// memory once and then walks over tiles of TM = 128 rows of one batch
// item.  All threads load a tile's operand rows; then each warp owns 16 of
// them end to end (both products, gate, epilogue), staging its f32 results
// over its own operand rows.  x ping-pongs between two buffers, because
// blocks read rows t +- d that other blocks write.  Overlapping a tile's
// loads with the previous tile's products (cp.async or TMA), wgmma, and
// fusing a whole group with a 1023-row halo are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

using namespace nvcuda;
using ptk::BATCH;
using ptk::pack4;

namespace {

constexpr int TM = 128;             // time rows per tile
constexpr int WARPS = TM / 16;      // one warp per 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr float SQRT_HALF = 0.70710678118654752f;

// Shared-memory geometry.  Row pitches are padded by 8 bf16 (16 bytes)
// against bank conflicts and stay multiples of 8 elements, as wmma needs.
template <int CR>
struct Geometry {
  static constexpr int G = 2 * CR;        // gate width == [skip | res] width
  static constexpr int LDW = G + 8;       // weight rows (bf16)
  static constexpr int LDS = G + 4;       // f32 staging rows
  static constexpr int LDH = CR + 8;      // h rows (bf16)
  int kp;                                 // operand depth
  int lda;                                // operand rows (bf16); a warp's
                                          // 16 rows also hold its staging
  __host__ __device__ explicit Geometry(int kp_)
      : kp(kp_), lda(kp_ + 8 > 2 * LDS ? kp_ + 8 : 2 * LDS) {}
  __host__ __device__ size_t w_elems() const { return size_t(kp) * LDW; }
  __host__ __device__ size_t wso_elems() const { return size_t(CR) * LDW; }
  __host__ __device__ size_t a_elems() const { return size_t(TM) * lda; }
  __host__ __device__ size_t h_elems() const { return size_t(TM) * LDH; }
  __host__ __device__ size_t bytes() const {
    return sizeof(__nv_bfloat16) *
           (w_elems() + wso_elems() + a_elems() + h_elems());
  }
};

// SAVE (kernel K2a, the training forward) also writes the layer's input
// rows as bf16 to `saved`; K1 is the SAVE = false instance, which holds no
// trace of that code.
template <int CR, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
pwg_layer_kernel(const float* __restrict__ x_in,
                 float* __restrict__ x_out_f32,
                 __nv_bfloat16* __restrict__ x_out_bf16,
                 const __nv_bfloat16* __restrict__ c,
                 const __nv_bfloat16* __restrict__ wg,
                 const __nv_bfloat16* __restrict__ wso,
                 const float* __restrict__ bso,
                 float* __restrict__ skip,
                 __nv_bfloat16* __restrict__ saved,
                 int B, int T, int CA, int KP, int d, int skip_init,
                 int round_out) {
  using Geo = Geometry<CR>;
  constexpr int G = Geo::G;
  constexpr int NF = G / 16;             // accumulator tiles per strip
  constexpr int LDW = Geo::LDW;
  constexpr int LDS = Geo::LDS;
  constexpr int LDH = Geo::LDH;
  constexpr int V4 = CR / 4;             // float4 per x row
  constexpr int XITERS = TM * 3 * V4 / THREADS;
  constexpr int CITERS = TM * 16 / THREADS;   // c rows hold <= 16 vectors
  constexpr int VEC = CR / 32;           // epilogue channels per lane
  static_assert(TM * 3 * V4 % THREADS == 0, "tap loads must tile evenly");
  static_assert(VEC == 1 || VEC == 2, "CR must be 32 or 64");
  const Geo geo(KP);
  const int lda = geo.lda;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wso_s = w_s + geo.w_elems();
  __nv_bfloat16* a_s = wso_s + geo.wso_elems();
  __nv_bfloat16* h_s = a_s + geo.a_elems();

  // the layer's weights stay in shared memory for all of this block's tiles
  ptk::stage_rows<THREADS>(w_s, wg, KP, G, LDW);
  ptk::stage_rows<THREADS>(wso_s, wso, CR, G, LDW);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  // this warp's f32 staging overlays its own 16 operand rows
  float* st_s = reinterpret_cast<float*>(a_s + r0 * lda);
  const int naux = KP - 3 * CR;
  const int cv = (CA % 8) == 0 ? CA / 8 : 0;    // 16-byte vectors of c
  const int cs = CA - 8 * cv;                   // c columns loaded singly
  const int tiles_per_item = (T + TM - 1) / TM;
  const int ntiles = tiles_per_item * B;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tiles_per_item;
    const int t0 = (tile - b * tiles_per_item) * TM;
    const float* xb = x_in + static_cast<size_t>(b) * T * CR;
    const __nv_bfloat16* cb = c + static_cast<size_t>(b) * T * CA;
    __syncthreads();   // weights staged; the previous tile is done

    // operand tile: [x(t-d) | x(t+d) | x(t)] as bf16, four channels a step
#pragma unroll
    for (int k0 = 0; k0 < XITERS; k0 += BATCH) {
      float4 v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = threadIdx.x + (k0 + k) * THREADS;
        const int r = i / (3 * V4);
        const int tap = (i % (3 * V4)) / V4;
        const int t = t0 + r + (tap == 0 ? -d : (tap == 1 ? d : 0));
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < XITERS && t0 + r < T && t >= 0 && t < T)
          v[k] = reinterpret_cast<const float4*>(
              xb + static_cast<size_t>(t) * CR)[i % V4];
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = threadIdx.x + (k0 + k) * THREADS;
        if (k0 + k < XITERS)
          *reinterpret_cast<uint2*>(a_s + (i / (3 * V4)) * lda +
                                    (i % (3 * V4)) * 4) = pack4(v[k]);
      }
    }
    // then [c(t) | 1 | 0 ...]: the 1 meets the gate-bias row of wg.  c rows
    // are 16-byte vectors when CA % 8 == 0; otherwise element by element.
    {
      uint4 v[CITERS];
#pragma unroll
      for (int k = 0; k < CITERS; ++k) {
        const int i = threadIdx.x + k * THREADS;
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (cv > 0 && i < TM * cv && t0 + i / cv < T)
          v[k] = reinterpret_cast<const uint4*>(
              cb + static_cast<size_t>(t0 + i / cv) * CA)[i % cv];
      }
#pragma unroll
      for (int k = 0; k < CITERS; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (cv > 0 && i < TM * cv)
          *reinterpret_cast<uint4*>(a_s + (i / cv) * lda + 3 * CR +
                                    (i % cv) * 8) = v[k];
      }
    }
    for (int i = threadIdx.x; i < TM * (naux - 8 * cv); i += THREADS) {
      const int r = i / (naux - 8 * cv);
      const int j = 8 * cv + (i - r * (naux - 8 * cv));
      const int t = t0 + r;
      __nv_bfloat16 v = zero;
      if (j < 8 * cv + cs) {
        if (t < T) v = cb[static_cast<size_t>(t) * CA + j];
      } else if (j == CA) {
        v = one;
      }
      a_s[r * lda + 3 * CR + j] = v;
    }
    __syncthreads();

    if constexpr (SAVE) {
      // K2a: the layer's input rows exactly as the products consume them
      // (the bf16 centre tap), for the backward.  Each warp saves its own
      // 16 rows, which it alone overwrites with staging further down.
      constexpr int SV = CR / 8;             // 16-byte vectors per row
      for (int i = lane; i < 16 * SV; i += 32) {
        const int r = i / SV;
        const int t = t0 + r0 + r;
        if (t < T)
          reinterpret_cast<uint4*>(
              saved + (static_cast<size_t>(b) * T + t) * CR)[i % SV] =
              *reinterpret_cast<const uint4*>(a_s + (r0 + r) * lda + 2 * CR +
                                              (i % SV) * 8);
      }
    }

    // gate = operand rows @ wg   (16 x KP) @ (KP x G)
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
    __syncwarp();      // all of this warp's operand reads are done
#pragma unroll
    for (int n = 0; n < NF; ++n)
      wmma::store_matrix_sync(st_s + n * 16, acc[n], LDS,
                              wmma::mem_row_major);
    __syncwarp();

    // h = bf16(tanh(a) * sigmoid(b)) for this warp's 16 rows
    for (int i = lane; i < 16 * CR; i += 32) {
      const int r = i / CR;
      const int j = i - r * CR;
      const float ga = st_s[r * LDS + j];
      const float gb = st_s[r * LDS + CR + j];
      const float hv = ptk::fast_tanh(ga) * ptk::fast_sigmoid(gb);
      h_s[(r0 + r) * LDH + j] = __float2bfloat16_rn(hv);
    }
    __syncwarp();

    // the epilogue's operands from device memory, requested now so that
    // they arrive while the second product runs: VEC channels of each of
    // this warp's 16 rows per lane
    const int j0 = lane * VEC;
    float xv[16][VEC], sv[16][VEC];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int t = t0 + r0 + r;
      const size_t o = (static_cast<size_t>(b) * T + t) * CR + j0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) xv[r][e] = sv[r][e] = 0.f;
      if (t < T) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xv[r][e] = x_in[o + e];
          if (!skip_init) sv[r][e] = skip[o + e];
        }
      }
    }

    // [skip | res] = h @ wso   (16 x CR) @ (CR x G)
#pragma unroll
    for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int k = 0; k < CR; k += 16) {
      wmma::load_matrix_sync(af, h_s + r0 * LDH + k, LDH);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        wmma::load_matrix_sync(bf, wso_s + k * LDW + n * 16, LDW);
        wmma::mma_sync(acc[n], af, bf, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NF; ++n)
      wmma::store_matrix_sync(st_s + n * 16, acc[n], LDS,
                              wmma::mem_row_major);
    __syncwarp();

    // epilogue: skip sum in place, residual to the other x buffer
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int t = t0 + r0 + r;
      if (t >= T) continue;
      const size_t o = (static_cast<size_t>(b) * T + t) * CR + j0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = j0 + e;
        skip[o + e] = sv[r][e] + (st_s[r * LDS + j] + bso[j]);
        const float res = st_s[r * LDS + CR + j] + bso[CR + j];
        const float xn = (res + xv[r][e]) * SQRT_HALF;
        if (x_out_bf16 != nullptr) {
          x_out_bf16[o + e] = __float2bfloat16_rn(xn);
        } else {
          x_out_f32[o + e] =
              round_out ? __bfloat162float(__float2bfloat16_rn(xn)) : xn;
        }
      }
    }
  }
}

template <int CR, bool SAVE>
cudaError_t launch(const void* x_in, void* x_out_f32, void* x_out_bf16,
                   const void* c, const void* wg, const void* wso,
                   const void* bso, void* skip, void* saved, int B, int T,
                   int CA, int KP, int d, int skip_init, int round_out,
                   cudaStream_t stream) {
  const size_t smem = Geometry<CR>(KP).bytes();
  int sms = 0;
  cudaError_t err = ptk::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pwg_layer_kernel<CR, SAVE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // persistent blocks: one per SM, each walks over many tiles so that the
  // staged weights are loaded once per block and layer
  const long long ntiles = static_cast<long long>((T + TM - 1) / TM) * B;
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  pwg_layer_kernel<CR, SAVE><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x_in), static_cast<float*>(x_out_f32),
      static_cast<__nv_bfloat16*>(x_out_bf16),
      static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wso), static_cast<const float*>(bso),
      static_cast<float*>(skip), static_cast<__nv_bfloat16*>(saved), B, T,
      CA, KP, d, skip_init, round_out);
  return cudaGetLastError();
}

template <int CR>
cudaError_t launch_cr(const void* x_in, void* x_out_f32, void* x_out_bf16,
                      const void* c, const void* wg, const void* wso,
                      const void* bso, void* skip, void* saved, int B, int T,
                      int CA, int KP, int d, int skip_init, int round_out,
                      cudaStream_t s) {
  if (saved != nullptr)
    return launch<CR, true>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso,
                            skip, saved, B, T, CA, KP, d, skip_init,
                            round_out, s);
  return launch<CR, false>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso,
                           skip, saved, B, T, CA, KP, d, skip_init,
                           round_out, s);
}

}  // namespace

// One layer.  x_in: (B, T, CR) f32; exactly one of x_out_f32 (B, T, CR) f32
// and x_out_bf16 (B, T, CR) bf16 is non-null; c: (B, T, CA) bf16; wg:
// (KP, 2CR) bf16 with KP = 3CR + round_up(CA + 1, 16); wso: (CR, 2CR) bf16;
// bso: (2CR) f32; skip: (B, T, CR) f32, written (skip_init) or accumulated;
// saved: null (K1) or (B, T, CR) bf16, the layer's input rows (K2a).  CR
// is 32 or 64.  Returns a cudaError_t value, or -1 for arguments the
// kernel does not take.
extern "C" int pwg_stack_layer(const void* x_in, void* x_out_f32,
                               void* x_out_bf16, const void* c,
                               const void* wg, const void* wso,
                               const void* bso, void* skip, void* saved,
                               int B, int T, int CR, int CA, int KP,
                               int dilation, int skip_init, int round_out,
                               void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || CA <= 0 || dilation < 0) return -1;
  if (KP % 16 != 0 || KP < 3 * CR + CA + 1) return -1;
  if ((x_out_f32 == nullptr) == (x_out_bf16 == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (CR) {
    case 32:
      err = launch_cr<32>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso, skip,
                          saved, B, T, CA, KP, dilation, skip_init,
                          round_out, s);
      break;
    case 64:
      err = launch_cr<64>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso, skip,
                          saved, B, T, CA, KP, dilation, skip_init,
                          round_out, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(err);
}

extern "C" const char* pwg_stack_error_string(int err) {
  if (err == -1) return "arguments not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
