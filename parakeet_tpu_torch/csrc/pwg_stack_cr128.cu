// Parallel WaveGAN residual stack, forward, at residual width 128: kernels
// K1 (inference) and K2a (the training forward, which saves each layer's
// input rows) as two launches a layer, written for the H100.  The
// arithmetic, the rounding points and what they replace are pwg_stack.cu's
// (one launch a layer at widths 32 and 64); only the split of a layer
// differs.
//
// At cr = 128 (gate 256) a layer's bf16 weights outgrow a block: wg alone
// is KP x 256 (480 x 264 x 2 = 253,440 bytes with the padded rows at the
// YAMLs' 80 aux channels), against the 232,448 a block may have, and a warp
// that owned all 256 gate columns of its 16 rows would hold 128 float32
// gate accumulators a thread beside 128 of [skip | res].  So a layer is
//   gate  pwg_gate_kernel, grid y = the two halves of the column pairs:
//         block y holds wg's columns [64y, 64y + 64) (tanh) and [128 + 64y,
//         ...) (sigmoid), KP x 128 (130,560 bytes at KP 480); each warp
//         walks tiles of 16 rows of one item as pwg_stack.cu's kernel does,
//         copying its tile's bf16 gate operand [x(t-d) | x(t+d) | x(t) | c |
//         1 | 0] into its stage by cp.async (as many warps as stages fit:
//         6 at ca 80), and writes its half of h = bf16(tanh(gate[:cr])
//         sigmoid(gate[cr:])) (B, T, 128) bf16: 64 gate accumulators a
//         thread.  The taps come from xb, the layer's input rounded to bf16
//         (the gate's operand is that rounding either way);
//   out   pwg_out_kernel: holds wso (128 x 264 bf16) and bso; a warp takes
//         16 rows of h (cp.async), forms [skip | res] = h @ wso + bso one
//         half of each at a time (64 accumulators), and writes the skip sum
//         and x_next as pwg_stack.cu's epilogue does, and x_next in bf16
//         (xb_out): the next layer's taps, and in K2a the next layer's saved
//         rows, whose bf16 input rows are this (the first layer's are
//         x's, rounded by the caller).
// h is a rounding point already, so the split adds no rounding; each
// product is still one float32 sum a thread.  A row and layer moves
// pwg_stack.cu's 2,208 bytes at ca 80 with x's taps read in bf16 (256
// fewer), plus h's write and read (512), the output launch's read of x in
// float32 (512) and the bf16 x_next (256): 3,232.
// Left for later: one launch a layer on a cluster of two blocks, h crossing
// through distributed shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CR = 128;
constexpr int G = 2 * CR;
constexpr int HALF = CR / 2;        // column pairs a gate block takes
constexpr int AW_MAX = 128;         // widest [c | 1 | 0] operand
constexpr int MAX_WARPS = 8;
constexpr float SQRT_HALF = 0.70710678118654752f;
// the most dynamic shared memory a block may have on the H100 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// Shared memory of a gate launch: its half of wg in bf16 rows of 2 HALF +
// 8, then a stage of 16 rows of the gate operand (bf16, rows of KP + 8) a
// warp.  The pads of 8 make a row 16 bytes times an odd number, so the
// eight rows of an ldmatrix read hit distinct banks.
struct GateGeometry {
  int kp;
  explicit GateGeometry(int kp_) : kp(kp_) {}
  __host__ __device__ static constexpr int ldw() { return 2 * HALF + 8; }
  size_t weight_bytes() const { return sizeof(bf16) * size_t(kp) * ldw(); }
  size_t stage_bytes() const { return 16 * sizeof(bf16) * size_t(kp + 8); }
  int warps() const {
    int w = MAX_WARPS;
    while (w > 1 && weight_bytes() + w * stage_bytes() > SMEM_LIMIT) --w;
    return w;
  }
  size_t bytes() const { return weight_bytes() + warps() * stage_bytes(); }
};

// Shared memory of an out launch: wso in bf16 rows of 2cr + 8, bso, and a
// stage of 16 rows of h (bf16, rows of cr + 8) for each of its 8 warps.
constexpr int OUT_WARPS = 8;
constexpr int LDO = G + 8;
constexpr int LDH = CR + 8;
constexpr size_t OUT_SMEM = sizeof(bf16) * CR * LDO + sizeof(float) * G +
                            OUT_WARPS * 16 * LDH * sizeof(bf16);

// h[:, 64y : 64y + 64] of one layer, y = blockIdx.y, from its input xb
// (B, T, CR) bf16.  blockDim.x is 32 * GateGeometry::warps().
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
pwg_gate_kernel(const bf16* __restrict__ xb, const bf16* __restrict__ c,
                const bf16* __restrict__ wg, bf16* __restrict__ h_out,
                int B, int T, int CA, int CW, int KP, int d) {
  constexpr int LDW = GateGeometry::ldw();
  constexpr int NG = 2 * HALF / 8;        // n8 tiles of the block's gate
  constexpr int NH = HALF / 8;            // n8 tiles of its half of h
  constexpr int V = CR / 8;               // 16-byte vectors of a tap row
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int lda = KP + 8;
  const int jb = blockIdx.y * HALF;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);      // [tanh j | sigmoid j]
  bf16* a_all = w_s + size_t(KP) * LDW;           // the warps' stages

  // the block's columns of wg, copied once; then the [c | 1 | 0] columns
  // past c of every stage (the 1 meets the gate-bias row of wg; cp.async
  // never writes them)
  for (int i = threadIdx.x; i < KP * (2 * HALF / 8); i += threads) {
    const int r = i / (2 * HALF / 8);
    const int v = i - r * (2 * HALF / 8);
    const int col = v < HALF / 8 ? jb + 8 * v : CR + jb + 8 * (v - HALF / 8);
    ptk::cp_async16(w_s + r * LDW + 8 * v, wg + size_t(r) * G + col, true);
  }
  ptk::cp_async_commit();
  const int pad = KP - 3 * CR - CW;
  for (int i = threadIdx.x; i < warps * 16 * pad; i += threads) {
    const int r = i / pad;
    const int j = CW + (i - r * pad);
    a_all[r * lda + 3 * CR + j] = __float2bfloat16_rn(j == CA ? 1.f : 0.f);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* as = a_all + warp * 16 * lda;             // this warp's stage
  const int tiles_per_item = (T + 15) / 16;
  const int ntiles = tiles_per_item * B;
  const int stride = gridDim.x * warps;

  // cp.async copies of tile `tile`'s rows into this warp's stage: the three
  // taps of xb (rows t - d, t + d, t of the item, zero outside [0, T)) and
  // the CW columns of c (zero past T)
  auto load_tile = [&](int tile) {
    const int b = tile / tiles_per_item;
    const int t0 = (tile - b * tiles_per_item) * 16;
    const bf16* xi = xb + static_cast<size_t>(b) * T * CR;
#pragma unroll 4
    for (int i = lane; i < 16 * 3 * V; i += 32) {
      const int r = i / (3 * V);
      const int p = (i / V) % 3;          // 0: t - d, 1: t + d, 2: t
      const int v = i % V;
      const int t = t0 + r + (p == 0 ? -d : (p == 1 ? d : 0));
      const bool ok = t0 + r < T && t >= 0 && t < T;
      const bf16* s = ok ? xi + static_cast<size_t>(t) * CR + 8 * v : xi;
      ptk::cp_async16(as + r * lda + p * CR + 8 * v, s, ok);
    }
    const int cv = CW / 8;
    const bf16* cb = c + static_cast<size_t>(b) * T * CW;
    for (int i = lane; i < 16 * cv; i += 32) {
      const int r = i / cv;
      const int v = i - r * cv;
      const bool ok = t0 + r < T;
      const bf16* s =
          ok ? cb + static_cast<size_t>(t0 + r) * CW + 8 * v : cb;
      ptk::cp_async16(as + r * lda + 3 * CR + 8 * v, s, ok);
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

    // the block's gate columns on the warp's 16 rows: tanh's in ga[0, NH),
    // sigmoid's in ga[NH, NG)
    float ga[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
      ga[n][0] = ga[n][1] = ga[n][2] = ga[n][3] = 0.f;
    const bf16* ap = as + (lane & 15) * lda + (lane >> 4) * 8;
    const bf16* bp = w_s + (lane & 15) * LDW + (lane >> 4) * 8;
#pragma unroll 2
    for (int k = 0; k < KP; k += 16) {
      uint32_t af[4];
      ptk::ldsm_x4(af, ap + k);
#pragma unroll
      for (int p = 0; p < NG / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, bp + k * LDW + 16 * p);
        ptk::mma_bf16(ga[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(ga[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    __syncwarp();            // the stage is read: the next tile's rows
    if (tile + stride < ntiles) load_tile(tile + stride);
    ptk::cp_async_commit();

    // h = bf16(tanh(gate[:cr]) sigmoid(gate[cr:])): columns jb + 8m + 2t
    // of rows g and g + 8
    const size_t row0 = static_cast<size_t>(b) * T + t0 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t0 + g + 8 * h >= T) continue;
      bf16* o = h_out + (row0 + 8 * h) * CR + jb + 2 * t4;
#pragma unroll
      for (int m = 0; m < NH; ++m)
        *reinterpret_cast<uint32_t*>(o + 8 * m) = ptk::pack_bf16(
            ptk::fast_tanh(ga[m][2 * h]) * ptk::fast_sigmoid(ga[NH + m][2 * h]),
            ptk::fast_tanh(ga[m][2 * h + 1]) *
                ptk::fast_sigmoid(ga[NH + m][2 * h + 1]));
    }
  }
  ptk::cp_async_wait<0>();
}

// [skip | res] = h @ wso + bso on R = B T rows, then skip (+)= skip, x_next
// = (res + x) sqrt(0.5) (bf16-rounded at round_out, or bf16 only into
// x_out_bf16) and, where xb_out is not null, x_next in bf16 into it.
__global__ void __launch_bounds__(32 * OUT_WARPS, 1)
pwg_out_kernel(const bf16* __restrict__ h_in, const float* __restrict__ x_in,
               float* __restrict__ x_out_f32, bf16* __restrict__ x_out_bf16,
               bf16* __restrict__ xb_out, const bf16* __restrict__ wso,
               const float* __restrict__ bso, float* __restrict__ skip,
               int R, int skip_init, int round_out) {
  constexpr int NS = HALF / 8;            // n8 tiles of a half of skip
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);           // wso
  float* bso_s = reinterpret_cast<float*>(w_s + CR * LDO);
  bf16* h_all = reinterpret_cast<bf16*>(bso_s + G);     // the warps' stages

  for (int i = threadIdx.x; i < CR * (G / 8); i += blockDim.x) {
    const int r = i / (G / 8);
    const int v = i - r * (G / 8);
    ptk::cp_async16(w_s + r * LDO + 8 * v, wso + size_t(r) * G + 8 * v, true);
  }
  for (int i = threadIdx.x; i < G / 4; i += blockDim.x)
    ptk::cp_async16(bso_s + 4 * i, bso + 4 * i, true);
  ptk::cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* hs = h_all + warp * 16 * LDH;
  const int ntiles = (R + 15) / 16;
  const int stride = gridDim.x * OUT_WARPS;

  auto load_tile = [&](int tile) {
    for (int i = lane; i < 16 * (CR / 8); i += 32) {
      const int r = i / (CR / 8);
      const int v = i - r * (CR / 8);
      const int q = tile * 16 + r;
      const bool ok = q < R;
      ptk::cp_async16(hs + r * LDH + 8 * v,
                      ok ? h_in + static_cast<size_t>(q) * CR + 8 * v : h_in,
                      ok);
    }
  };

  int tile = blockIdx.x * OUT_WARPS + warp;
  if (tile < ntiles) load_tile(tile);
  ptk::cp_async_commit();
  ptk::cp_async_wait<1>();   // the weights are in
  __syncthreads();

  for (; tile < ntiles; tile += stride) {
    ptk::cp_async_wait<0>();
    __syncwarp();
    // h's A fragments, all cr columns of the warp's 16 rows; then the
    // stage takes the next tile
    uint32_t hf[CR / 16][4];
    const bf16* ap = hs + (lane & 15) * LDH + (lane >> 4) * 8;
#pragma unroll
    for (int k = 0; k < CR / 16; ++k) ptk::ldsm_x4(hf[k], ap + 16 * k);
    __syncwarp();
    if (tile + stride < ntiles) load_tile(tile + stride);
    ptk::cp_async_commit();

    const size_t row0 = static_cast<size_t>(tile) * 16 + g;
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) valid[h] = row0 + 8 * h < size_t(R);
    const bf16* bp = w_s + (lane & 15) * LDO + (lane >> 4) * 8;
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {        // skip and res columns 64u + ...
      const int c0 = u * HALF;
      // the skip sum and x of this lane's rows and channels, requested
      // before the product so that they arrive while it runs
      float2 sv[NS][2], xv[NS][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const size_t o = (row0 + 8 * h) * CR + c0 + 8 * m + 2 * t4;
          sv[m][h] = xv[m][h] = make_float2(0.f, 0.f);
          if (!valid[h]) continue;
          if (!skip_init) sv[m][h] = *reinterpret_cast<const float2*>(skip + o);
          xv[m][h] = __ldg(reinterpret_cast<const float2*>(x_in + o));
        }
      // n8 tiles [0, NS): skip columns c0 + ...; [NS, 2 NS): res columns
      float so[2 * NS][4];
#pragma unroll
      for (int n = 0; n < 2 * NS; ++n)
        so[n][0] = so[n][1] = so[n][2] = so[n][3] = 0.f;
#pragma unroll
      for (int k = 0; k < CR / 16; ++k) {
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          const int col = p < NS / 2 ? c0 + 16 * p : CR + c0 + 16 * (p - NS / 2);
          uint32_t bf[4];
          ptk::ldsm_x4_trans(bf, bp + 16 * k * LDO + col);
          ptk::mma_bf16(so[2 * p], hf[k], bf[0], bf[1]);
          ptk::mma_bf16(so[2 * p + 1], hf[k], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!valid[h]) continue;
        const size_t o = (row0 + 8 * h) * CR + c0 + 2 * t4;
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const float2 bs = *reinterpret_cast<const float2*>(
              bso_s + c0 + 8 * m + 2 * t4);
          const float2 br = *reinterpret_cast<const float2*>(
              bso_s + CR + c0 + 8 * m + 2 * t4);
          const float2 x = xv[m][h];
          *reinterpret_cast<float2*>(skip + o + 8 * m) =
              make_float2(sv[m][h].x + (so[m][2 * h] + bs.x),
                          sv[m][h].y + (so[m][2 * h + 1] + bs.y));
          float x0 = (so[NS + m][2 * h] + br.x + x.x) * SQRT_HALF;
          float x1 = (so[NS + m][2 * h + 1] + br.y + x.y) * SQRT_HALF;
          const uint32_t x16 = ptk::pack_bf16(x0, x1);
          if (x_out_bf16 != nullptr) {
            *reinterpret_cast<uint32_t*>(x_out_bf16 + o + 8 * m) = x16;
          } else {
            if (round_out) {
              x0 = ptk::bf16_round(x0);
              x1 = ptk::bf16_round(x1);
            }
            *reinterpret_cast<float2*>(x_out_f32 + o + 8 * m) =
                make_float2(x0, x1);
          }
          if (xb_out != nullptr)
            *reinterpret_cast<uint32_t*>(xb_out + o + 8 * m) = x16;
        }
      }
    }
  }
  ptk::cp_async_wait<0>();
}

bool bad_args(int B, int T, int CR_, int CA, int CW, int KP, int d) {
  if (B <= 0 || B > 65535 || T <= 0 || CA <= 0 || d < 0) return true;
  if (static_cast<long long>(B) * T > (1LL << 30)) return true;
  if (CR_ != CR) return true;
  if (KP % 16 != 0 || KP < 3 * CR + CA + 1 || KP - 3 * CR > AW_MAX)
    return true;
  return !(CW == CA && CA % 8 == 0) && CW != KP - 3 * CR;
}

}  // namespace

// The gate half of one layer at CR = 128: h (B, T, CR) bf16 from xb (B, T,
// CR) bf16, the layer's input rounded, c (B, T, CW) bf16 as
// pwg_stack_layer takes it and wg (KP, 2CR) bf16.  Returns a cudaError_t
// value, or -1 for arguments the kernel does not take.
extern "C" int pwg_stack_layer_gate(const void* xb, const void* c,
                                    const void* wg, void* h, int B, int T,
                                    int CR_, int CA, int CW, int KP,
                                    int dilation, void* stream) {
  if (bad_args(B, T, CR_, CA, CW, KP, dilation)) return -1;
  const GateGeometry geo(KP);
  const int warps = geo.warps();
  const size_t smem = geo.bytes();
  int sms = 0;
  cudaError_t err = ptk::sm_count(&sms);
  if (err == cudaSuccess) err = ptk::set_smem(pwg_gate_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks, one an SM: the two halves side by side on the same
  // tiles, so that the second read of xb's rows comes from L2
  const long long ntiles = static_cast<long long>((T + 15) / 16) * B;
  const long long blocks = (ntiles + warps - 1) / warps;
  const long long half = (sms + 1) / 2;
  const dim3 grid(static_cast<unsigned>(blocks < half ? blocks : half), 2);
  pwg_gate_kernel<<<grid, 32 * warps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xb), static_cast<const bf16*>(c),
      static_cast<const bf16*>(wg), static_cast<bf16*>(h), B, T, CA, CW, KP,
      dilation);
  return static_cast<int>(cudaGetLastError());
}

// The output half of one layer at CR = 128, as pwg_stack_layer's
// arguments with h from pwg_stack_layer_gate in place of c and wg: skip
// written (skip_init) or accumulated, exactly one of x_out_f32 and
// x_out_bf16 non-null, and xb_out null or (B, T, CR) bf16, x_next rounded
// (the next layer's xb; in K2a its saved rows).
extern "C" int pwg_stack_layer_out(const void* h, const void* x_in,
                                   void* x_out_f32, void* x_out_bf16,
                                   void* xb_out, const void* wso,
                                   const void* bso, void* skip, int B, int T,
                                   int CR_, int skip_init, int round_out,
                                   void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || CR_ != CR) return -1;
  if (static_cast<long long>(B) * T > (1LL << 30)) return -1;
  if ((x_out_f32 == nullptr) == (x_out_bf16 == nullptr)) return -1;
  const int R = B * T;
  int sms = 0;
  cudaError_t err = ptk::sm_count(&sms);
  if (err == cudaSuccess) err = ptk::set_smem(pwg_out_kernel, OUT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = ((R + 15) / 16 + OUT_WARPS - 1) / OUT_WARPS;
  const int grid = static_cast<int>(blocks < sms ? blocks : sms);
  pwg_out_kernel<<<grid, 32 * OUT_WARPS, OUT_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const float*>(x_in),
      static_cast<float*>(x_out_f32), static_cast<bf16*>(x_out_bf16),
      static_cast<bf16*>(xb_out), static_cast<const bf16*>(wso),
      static_cast<const float*>(bso), static_cast<float*>(skip), R,
      skip_init, round_out);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory bytes of the gate (which 0) or out (1) launch at
// CR = 128 and this KP (the launcher's Python mirror is held against it),
// or -1.
extern "C" long long pwg_stack_split_smem(int which, int KP) {
  if (KP % 16 != 0 || KP - 3 * CR > AW_MAX || KP - 3 * CR < 16) return -1;
  if (which == 0) return static_cast<long long>(GateGeometry(KP).bytes());
  if (which == 1) return static_cast<long long>(OUT_SMEM);
  return -1;
}
