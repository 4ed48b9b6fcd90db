// Parallel WaveGAN residual stack, forward: one gated residual layer per
// launch (kernel K1 of the port, inference; with a save pointer, kernel K2a,
// the training forward), written for the H100.
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
// Operands of both products are bf16 with float32 accumulation; x outside
// [0, T) is zero and taps never cross batch items.  tanh and sigmoid are
// common.cuh's fast forms, which K2b uses to rebuild this gate.  The gate
// bias is the row of wg that meets the constant-1 column, so it is bf16,
// as on the TPU.  At the last layer of a group x_next is rounded to bf16
// (round_out), and the very last layer writes bf16 only (x_out_bf16).
//
// What bounds it on the H100: bytes.  A row and layer reads x (float32,
// 4cr bytes; the shifted taps are the same rows and come mostly from L2),
// c (bf16) and the skip sum, and writes the skip sum and x_next: 1,184
// bytes at cr 64, ca 80 (1,312 with K2a's saved rows) against ~90 kFLOP,
// some 76 FLOP a byte against the card's ~295.  At B=1, T=268,800 a
// 30-layer call must move ~9.44 GB, 2.82 ms at 3.35 TB/s.  So the design
// keeps the card's memory busy and every intermediate on chip:
//   - the layer's weights stay in shared memory; each block has 8 warps
//     (7 where 8 stages do not fit beside the weights: cr 64, ca >= 96),
//     and each warp walks tiles of 16 rows of one item on its own, in the
//     interleaved order tile = (blockIdx.x * warps + warp) + k * (gridDim.x
//     * warps), so the front of all warps stays ~17k rows wide and the taps
//     at t +- d (d <= 512) hit L2.  No block barrier after the weights;
//   - a warp's stage holds its tile's three float32 taps and bf16 [c | 1 |
//     0] columns, copied by 16-byte cp.async; a source size of 0
//     zero-fills rows outside their item and past T.  Once the gate is
//     formed, x(t) is read out of the stage and the next tile's copies
//     start, so they overlap this tile's second product and epilogue and
//     the other warps' work: up to 8 tiles in flight an SM;
//   - a warp owns its 16 rows and all 2cr gate columns, so tanh's column j
//     and sigmoid's column cr + j sit in the same lane.  Both products are
//     mma.sync m16n8k16: the float32 taps' A fragments come from 8-byte
//     shared loads packed to bf16 (ldmatrix reads 16-bit elements only),
//     the [c | 1 | 0] and weight fragments from ldmatrix.  h is packed
//     from the gate's accumulators straight into the second product's A
//     fragments (an m16n8 accumulator pair is the m16k16 A layout);
//   - the epilogue runs on the accumulators' lanes: the skip sum is read
//     as float2 before the products, so its latency hides behind them, and
//     skip, x_next and K2a's saved rows are written from the same lanes.
// Warps that wait on no block barrier keep more rows in flight than one
// 64-row tile a block of four warps, double-buffered, which took 6.0 ms a
// 30-layer call at B=1, T=268,800 on an H100 80GB HBM3 at 700 W (PERF.md).
// Left for later: fusing a group's layers (the skip sum written once),
// overlapping a launch's weight copy with the previous layer's tail, and
// wgmma with TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int AW_MAX = 128;         // widest [c | 1 | 0] operand
constexpr int MAX_WARPS = 8;
constexpr float SQRT_HALF = 0.70710678118654752f;
// the most dynamic shared memory a block may have on the H100 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// Shared-memory geometry of one launch: the weights, then one stage of 16
// rows a warp.  bf16 rows (weights, [c | 1 | 0]) are padded by 8 elements,
// 16 bytes times an odd number, so the eight rows of an ldmatrix read hit
// distinct banks; the float32 tap rows [x(t-d) | x(t+d) | x(t)] are padded
// by 8 floats, so that the 8-byte loads of an A fragment (row g, columns
// 2t of lane 4g + t) hit distinct banks.
struct Geometry {
  int cr, kp, aw;
  Geometry(int cr_, int kp_) : cr(cr_), kp(kp_), aw(kp_ - 3 * cr_) {}
  int ldw() const { return 2 * cr + 8; }    // bf16
  int ldx() const { return 3 * cr + 8; }    // float
  int lda() const { return aw + 8; }        // bf16
  size_t weight_bytes() const {             // wg, wso; bso
    return sizeof(bf16) * size_t(kp + cr) * ldw() + sizeof(float) * 2 * cr;
  }
  size_t stage_bytes() const {              // taps; [c | 1 | 0]
    return 16 * (sizeof(float) * ldx() + sizeof(bf16) * lda());
  }
  // warps a block: 8, or as many stages as fit beside the weights
  int warps() const {
    int w = MAX_WARPS;
    while (w > 1 && weight_bytes() + w * stage_bytes() > SMEM_LIMIT) --w;
    return w;
  }
  size_t bytes() const { return weight_bytes() + warps() * stage_bytes(); }
};

// SAVE (kernel K2a, the training forward) also writes the layer's input
// rows as bf16 to `saved`; K1 is the SAVE = false instance, which holds no
// trace of that code.  blockDim.x is 32 * Geometry::warps().
template <int CR, bool SAVE>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
pwg_layer_kernel(const float* __restrict__ x_in,
                 float* __restrict__ x_out_f32,
                 bf16* __restrict__ x_out_bf16,
                 const bf16* __restrict__ c,
                 const bf16* __restrict__ wg,
                 const bf16* __restrict__ wso,
                 const float* __restrict__ bso,
                 float* __restrict__ skip,
                 bf16* __restrict__ saved,
                 int B, int T, int CA, int CW, int KP, int d, int skip_init,
                 int round_out) {
  constexpr int G = 2 * CR;
  constexpr int LDW = G + 8;
  constexpr int LDX = 3 * CR + 8;
  constexpr int NG = G / 8;               // n8 tiles of the gate and of so
  constexpr int NH = CR / 8;              // n8 tiles of h, skip or res
  constexpr int V = CR / 4;               // 16-byte vectors of a tap row
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int aw = KP - 3 * CR;
  const int lda = aw + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);      // wg's KP rows, wso's CR
  float* bso_s = reinterpret_cast<float*>(w_s + size_t(KP + CR) * LDW);
  float* x_all = bso_s + G;                       // the warps' taps
  bf16* a_all = reinterpret_cast<bf16*>(x_all + size_t(warps) * 16 * LDX);

  // the weights, copied once a block; then the [c | 1 | 0] columns past c
  // (the 1 meets the gate-bias row of wg) of every stage, when the kernel
  // reads c itself: cp.async never writes them
  for (int i = threadIdx.x; i < (KP + CR) * (G / 8); i += threads) {
    const int r = i / (G / 8);
    const int v = i - r * (G / 8);
    const bf16* src = r < KP ? wg + size_t(r) * G : wso + size_t(r - KP) * G;
    ptk::cp_async16(w_s + r * LDW + 8 * v, src + 8 * v, true);
  }
  for (int i = threadIdx.x; i < G / 4; i += threads)
    ptk::cp_async16(bso_s + 4 * i, bso + 4 * i, true);
  ptk::cp_async_commit();
  for (int i = threadIdx.x; i < warps * 16 * (aw - CW); i += threads) {
    const int r = i / (aw - CW);
    const int j = CW + (i - r * (aw - CW));
    a_all[r * lda + j] = __float2bfloat16_rn(j == CA ? 1.f : 0.f);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  float* xs = x_all + warp * 16 * LDX;            // this warp's stage
  bf16* as = a_all + warp * 16 * lda;
  const int tiles_per_item = (T + 15) / 16;
  const int ntiles = tiles_per_item * B;
  const int stride = gridDim.x * warps;

  // cp.async copies of tile `tile`'s rows into this warp's stage: the three
  // float32 taps of x_in (rows t - d, t + d, t of the item, zero outside
  // [0, T)) and the CW bf16 columns of c (zero past T)
  auto load_tile = [&](int tile) {
    const int b = tile / tiles_per_item;
    const int t0 = (tile - b * tiles_per_item) * 16;
    const float* xb = x_in + static_cast<size_t>(b) * T * CR;
#pragma unroll 4
    for (int i = lane; i < 16 * 3 * V; i += 32) {
      const int r = i / (3 * V);
      const int p = (i / V) % 3;          // 0: t - d, 1: t + d, 2: t
      const int v = i % V;
      const int t = t0 + r + (p == 0 ? -d : (p == 1 ? d : 0));
      const bool ok = t0 + r < T && t >= 0 && t < T;
      const float* s = ok ? xb + static_cast<size_t>(t) * CR + 4 * v : xb;
      ptk::cp_async16(xs + r * LDX + p * CR + 4 * v, s, ok);
    }
    const int cv = CW / 8;
    const bf16* cb = c + static_cast<size_t>(b) * T * CW;
    for (int i = lane; i < 16 * cv; i += 32) {
      const int r = i / cv;
      const int v = i - r * cv;
      const bool ok = t0 + r < T;
      const bf16* s =
          ok ? cb + static_cast<size_t>(t0 + r) * CW + 8 * v : cb;
      ptk::cp_async16(as + r * lda + 8 * v, s, ok);
    }
  };

  int tile = blockIdx.x * warps + warp;
  if (tile < ntiles) load_tile(tile);
  ptk::cp_async_commit();
  ptk::cp_async_wait<1>();   // the weights are in (the first tile may not)
  __syncthreads();

  for (; tile < ntiles; tile += stride) {
    const int b = tile / tiles_per_item;
    const int t0 = (tile - b * tiles_per_item) * 16;
    ptk::cp_async_wait<0>();
    __syncwarp();            // this warp's rows are in

    // the skip sum of this lane's rows and channels, requested now so that
    // it arrives while the products run
    const size_t row0 = static_cast<size_t>(b) * T + t0 + g;
    bool valid[2];
    float2 sv[NH][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = t0 + g + 8 * h < T;
#pragma unroll
      for (int m = 0; m < NH; ++m) {
        sv[m][h] = make_float2(0.f, 0.f);
        if (valid[h] && !skip_init)
          sv[m][h] = *reinterpret_cast<const float2*>(
              skip + (row0 + 8 * h) * CR + 8 * m + 2 * t4);
      }
    }

    // gate = [taps | c | 1 | 0] @ wg on the warp's 16 rows, all columns
    float ga[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
      ga[n][0] = ga[n][1] = ga[n][2] = ga[n][3] = 0.f;
    const bf16* bp = w_s + (lane & 15) * LDW + (lane >> 4) * 8;
    const float* xp = xs + g * LDX + 2 * t4;
#pragma unroll 2
    for (int k = 0; k < 3 * CR; k += 16) {
      // float32 taps to the bf16 A fragment: rows g, g + 8, columns
      // k + 2t, k + 2t + 1 and k + 8 + 2t, k + 9 + 2t
      const float2 f0 = *reinterpret_cast<const float2*>(xp + k);
      const float2 f1 = *reinterpret_cast<const float2*>(xp + 8 * LDX + k);
      const float2 f2 = *reinterpret_cast<const float2*>(xp + k + 8);
      const float2 f3 =
          *reinterpret_cast<const float2*>(xp + 8 * LDX + k + 8);
      const uint32_t af[4] = {ptk::pack_bf16(f0.x, f0.y),
                              ptk::pack_bf16(f1.x, f1.y),
                              ptk::pack_bf16(f2.x, f2.y),
                              ptk::pack_bf16(f3.x, f3.y)};
#pragma unroll
      for (int p = 0; p < NG / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, bp + k * LDW + 16 * p);
        ptk::mma_bf16(ga[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(ga[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    const bf16* ap = as + (lane & 15) * lda + (lane >> 4) * 8;
    for (int k = 0; k < aw; k += 16) {
      uint32_t af[4];
      ptk::ldsm_x4(af, ap + k);
#pragma unroll
      for (int p = 0; p < NG / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, bp + (3 * CR + k) * LDW + 16 * p);
        ptk::mma_bf16(ga[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(ga[2 * p + 1], af, bf[2], bf[3]);
      }
    }

    // x(t) of this lane's rows and channels out of the stage (the centre
    // tap, float32); then the stage takes the next tile's rows
    float2 xv[NH][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < NH; ++m)
        xv[m][h] = *reinterpret_cast<const float2*>(
            xs + (g + 8 * h) * LDX + 2 * CR + 8 * m + 2 * t4);
    __syncwarp();
    if (tile + stride < ntiles) load_tile(tile + stride);
    ptk::cp_async_commit();

    // h = bf16(tanh(gate[:cr]) sigmoid(gate[cr:])), packed straight into
    // the A fragments of h @ wso: n8 tiles 2k and 2k + 1 of h are the
    // m16k16 A tile k
    uint32_t hf[CR / 16][4];
#pragma unroll
    for (int m = 0; m < NH; ++m) {
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hv[e] = ptk::fast_tanh(ga[m][e]) * ptk::fast_sigmoid(ga[NH + m][e]);
      hf[m / 2][2 * (m % 2)] = ptk::pack_bf16(hv[0], hv[1]);
      hf[m / 2][2 * (m % 2) + 1] = ptk::pack_bf16(hv[2], hv[3]);
    }

    // [skip | res] = h @ wso
    float so[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
      so[n][0] = so[n][1] = so[n][2] = so[n][3] = 0.f;
#pragma unroll
    for (int k = 0; k < CR / 16; ++k) {
#pragma unroll
      for (int p = 0; p < NG / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, bp + (KP + 16 * k) * LDW + 16 * p);
        ptk::mma_bf16(so[2 * p], hf[k], bf[0], bf[1]);
        ptk::mma_bf16(so[2 * p + 1], hf[k], bf[2], bf[3]);
      }
    }

    // epilogue from the accumulators' lanes: channels 8m + 2t, 8m + 2t + 1
    // of rows g and g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const size_t o = (row0 + 8 * h) * CR + 2 * t4;
#pragma unroll
      for (int m = 0; m < NH; ++m) {
        const float2 bs = *reinterpret_cast<const float2*>(bso_s + 8 * m +
                                                           2 * t4);
        const float2 br = *reinterpret_cast<const float2*>(
            bso_s + CR + 8 * m + 2 * t4);
        const float2 x = xv[m][h];
        const float2 sk =
            make_float2(sv[m][h].x + (so[m][2 * h] + bs.x),
                        sv[m][h].y + (so[m][2 * h + 1] + bs.y));
        *reinterpret_cast<float2*>(skip + o + 8 * m) = sk;
        float x0 = (so[NH + m][2 * h] + br.x + x.x) * SQRT_HALF;
        float x1 = (so[NH + m][2 * h + 1] + br.y + x.y) * SQRT_HALF;
        if (x_out_bf16 != nullptr) {
          *reinterpret_cast<uint32_t*>(x_out_bf16 + o + 8 * m) =
              ptk::pack_bf16(x0, x1);
        } else {
          if (round_out) {
            x0 = ptk::bf16_round(x0);
            x1 = ptk::bf16_round(x1);
          }
          *reinterpret_cast<float2*>(x_out_f32 + o + 8 * m) =
              make_float2(x0, x1);
        }
        if constexpr (SAVE)   // K2a: the input rows as the gate read them
          *reinterpret_cast<uint32_t*>(saved + o + 8 * m) =
              ptk::pack_bf16(x.x, x.y);
      }
    }
  }
  ptk::cp_async_wait<0>();
}

template <int CR, bool SAVE>
cudaError_t launch(const void* x_in, void* x_out_f32, void* x_out_bf16,
                   const void* c, const void* wg, const void* wso,
                   const void* bso, void* skip, void* saved, int B, int T,
                   int CA, int CW, int KP, int d, int skip_init,
                   int round_out, cudaStream_t stream) {
  auto kernel = pwg_layer_kernel<CR, SAVE>;
  const Geometry geo(CR, KP);
  const int warps = geo.warps();
  const size_t smem = geo.bytes();
  int sms = 0;
  cudaError_t err = ptk::sm_count(&sms);
  if (err == cudaSuccess) err = ptk::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks, at most one an SM, so that the weights are copied
  // once per block and layer
  const long long ntiles = static_cast<long long>((T + 15) / 16) * B;
  const long long blocks = (ntiles + warps - 1) / warps;
  const int grid = static_cast<int>(blocks < sms ? blocks : sms);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const float*>(x_in), static_cast<float*>(x_out_f32),
      static_cast<bf16*>(x_out_bf16), static_cast<const bf16*>(c),
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wso),
      static_cast<const float*>(bso), static_cast<float*>(skip),
      static_cast<bf16*>(saved), B, T, CA, CW, KP, d, skip_init, round_out);
  return cudaGetLastError();
}

template <int CR>
cudaError_t launch_cr(const void* x_in, void* x_out_f32, void* x_out_bf16,
                      const void* c, const void* wg, const void* wso,
                      const void* bso, void* skip, void* saved, int B, int T,
                      int CA, int CW, int KP, int d, int skip_init,
                      int round_out, cudaStream_t s) {
  if (saved != nullptr)
    return launch<CR, true>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso,
                            skip, saved, B, T, CA, CW, KP, d, skip_init,
                            round_out, s);
  return launch<CR, false>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso,
                           skip, saved, B, T, CA, CW, KP, d, skip_init,
                           round_out, s);
}

}  // namespace

// One layer.  x_in: (B, T, CR) f32; exactly one of x_out_f32 (B, T, CR) f32
// and x_out_bf16 (B, T, CR) bf16 is non-null; c: (B, T, CW) bf16, either c
// itself (CW = CA, CA % 8 == 0) or the [c | 1 | 0] operand (CW = KP - 3CR);
// wg: (KP, 2CR) bf16 with KP = 3CR + round_up(CA + 1, 16); wso: (CR, 2CR)
// bf16; bso: (2CR) f32; skip: (B, T, CR) f32, written (skip_init) or
// accumulated; saved: null (K1) or (B, T, CR) bf16, the layer's input rows
// (K2a).  CR is 32 or 64 (at 128 a layer is pwg_stack_cr128.cu's two
// launches).  Returns a cudaError_t value, or -1 for arguments
// the kernel does not take.
extern "C" int pwg_stack_layer(const void* x_in, void* x_out_f32,
                               void* x_out_bf16, const void* c,
                               const void* wg, const void* wso,
                               const void* bso, void* skip, void* saved,
                               int B, int T, int CR, int CA, int CW, int KP,
                               int dilation, int skip_init, int round_out,
                               void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || CA <= 0 || dilation < 0) return -1;
  if (static_cast<long long>(B) * T > (1LL << 30)) return -1;
  if (CR != 32 && CR != 64) return -1;
  if (KP % 16 != 0 || KP < 3 * CR + CA + 1 || KP - 3 * CR > AW_MAX)
    return -1;
  if (!(CW == CA && CA % 8 == 0) && CW != KP - 3 * CR) return -1;
  if ((x_out_f32 == nullptr) == (x_out_bf16 == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      CR == 32 ? launch_cr<32>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso,
                               skip, saved, B, T, CA, CW, KP, dilation,
                               skip_init, round_out, s)
               : launch_cr<64>(x_in, x_out_f32, x_out_bf16, c, wg, wso, bso,
                               skip, saved, B, T, CA, CW, KP, dilation,
                               skip_init, round_out, s);
  return static_cast<int>(err);
}

// Dynamic shared memory bytes of a K1/K2a launch at these widths (the
// launcher's Python mirror, k1_smem_bytes, is held against it), or -1.
extern "C" long long pwg_stack_smem(int CR, int KP) {
  if ((CR != 32 && CR != 64) || KP % 16 != 0 || KP - 3 * CR > AW_MAX ||
      KP - 3 * CR < 16)
    return -1;
  return static_cast<long long>(Geometry(CR, KP).bytes());
}

extern "C" const char* pwg_stack_error_string(int err) {
  if (err == -1) return "arguments not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
