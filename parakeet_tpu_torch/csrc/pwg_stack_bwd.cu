// Parallel WaveGAN residual stack, backward of one group of layers (kernel
// K2b of the port), written for the H100.
//
// Replaces the Pallas TPU kernel parakeet_tpu/ops/pallas/pwg_stack_train.py::
// _bwd_kernel, which runs a group's ten layers in reverse on a sequential
// reverse grid of time blocks, carries the left-tap gradient tails from one
// block to the next (dtaps_left) and accumulates the weight gradients in
// output blocks that every grid step revisits.  CUDA blocks run in no
// order, so neither carry transfers.  Here the rows (b, t) are flattened
// (taps never cross an item) and cut into one contiguous chunk per block;
// a group of n layers is 3n + 2 launches (2n + 1 without the weight
// gradients):
//
//   prep    once: dsk16 = bf16(dskip), the skip half of every layer's dso,
//           and per chunk the float32 column sums of dskip, the skip half
//           of every layer's dbso.
//   then for each layer, last to first:
//   gate    rebuild gate = [x(t-d) | x(t+d) | x(t) | c | 1 | 0] @ wg from
//           the bf16 input rows that K2a saved; ta = tanh, sb = sigmoid
//           (common.cuh's fast forms, as the forward computed them);
//           h = bf16(ta sb); dso = [dsk16 | bf16(dres)] with dres =
//           dxo sqrt(0.5); dh = dso @ wso^T;
//           dg = bf16([dh sb (1 - ta^2) | dh ta sb (1 - sb)]) (written);
//           per chunk dwso = h^T dso and the column sums of dres.
//   dw      per chunk dwg = A^T dg, A the gate operand above.
//   dx      dx(t) = dg(t) W1^T + dg(t+d) W0^T + dg(t-d) W2^T + dres(t) and
//           dc(t) (+)= dg(t) Wa^T, with W0, W2, W1, Wa the row blocks of wg.
//   reduce  once: each chunk's partials of dwg, dwso and dbso added in a
//           fixed order (no float atomics), so two runs give bit-identical
//           gradients.
//
// Rounding points are the TPU kernel's: the products' operands (saved x, c,
// dso, dg, h) are bf16, every product accumulates in float32, and dh, da,
// db, dx and dc stay float32.
//
// What bounds it on the H100: bytes.  At cr = 64, ca = 80 a layer moves
// about 2.9 KB a row, 3.1 KB with the chunks' partials (the gate reads the
// centre tap, c, dxo and dsk16 and writes dg; dw reads the centre tap, c
// and dg; dx reads dg, dxo and dc and writes dx and dc; the shifted taps
// come mostly from L2) against ~0.25 MFLOP, far below the card's ~295 FLOP
// a byte.  So the design keeps the
// card's memory busy:
//   - products are mma.sync m16n8k16 (bf16 in, float32 accumulators) on
//     ldmatrix fragments, whose register layouts the PTX ISA documents, so
//     every epilogue runs on the accumulators in registers: a gate warp
//     owns 16 rows and one half of tanh's columns j, and holds sigmoid's
//     columns cr + j and dh's columns j in the same lanes;
//   - one block of 8 warps an SM walks its chunk in tiles of TM rows; the
//     next tile's rows are copied by cp.async (two stages, three in dw)
//     while this one computes, and the weights stay in shared memory;
//   - dwso and dbso are formed in the gate pass, which holds h and dso, so
//     h never goes to device memory and dw reads each operand once;
//   - dwg's 288 x 128 float32 accumulators of a chunk stay in registers:
//     160 a thread at cr = 64 (a warp owns one half of dg's columns and
//     every fourth 16-row block of A's columns);
//   - dx and dc are written, and dxo and dc read, as float2 straight from
//     the accumulators' lanes, loaded before the products so that their
//     latency hides behind them.
// Left for later: wgmma with TMA, forming dc once per group.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TM = 64;              // rows per tile
constexpr int DW_STAGES = 3;
constexpr int AW_MAX = 128;         // widest [c | 1 | 0] operand
constexpr float SQRT_HALF = 0.70710678118654752f;

// Shared pitch of rows of w bf16 columns (w % 16 == 0): 16 bytes times an
// odd number, so the eight rows of an ldmatrix read hit distinct banks.
__host__ __device__ constexpr int pitch(int w) { return w + 8; }

// Shared memory of each kernel, in bf16 elements (prep's is static).
__host__ __device__ size_t gate_elems(int cr, int kp) {
  const size_t g = pitch(2 * cr);
  return size_t(kp) * g + size_t(cr) * g               // wg, wso
         + 2 * size_t(TM) * (pitch(kp) + pitch(cr))    // stages: A, dsk16
         + 2 * size_t(TM) * pitch(cr);                 // dres, h
}
__host__ __device__ size_t dw_elems(int cr, int kp) {
  return DW_STAGES * size_t(TM) * (pitch(kp) + pitch(2 * cr));  // A, dg
}
__host__ __device__ size_t dx_elems(int cr, int cap) {
  return size_t(6 * cr) * pitch(cr) + size_t(2 * cr) * pitch(cap)  // weights
         + 2 * 3 * size_t(TM) * pitch(2 * cr);  // stages: dg(t), dg(t+-d)
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Start 16-byte cp.async copies of the TM rows q0, q0 + 1, ... of a tile:
// row q takes row q + off of src (vpr 16-byte vectors a row) into shared
// rows of pitch ld.  Rows at or past qend, and rows whose t + off leaves
// [0, T) (the shifted taps of a dilated conv), are zero-filled.
__device__ __forceinline__ void cp_rows(bf16* dst, int ld,
                                        const bf16* __restrict__ src,
                                        int vpr, int q0, int qend, int T,
                                        int off) {
  for (int i = threadIdx.x; i < TM * vpr; i += THREADS) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    const int q = q0 + r;
    bool ok = q < qend;
    if (ok && off != 0) {
      const int ts = q % T + off;
      ok = ts >= 0 && ts < T;
    }
    const bf16* s =
        ok ? src + (static_cast<size_t>(q + off) * vpr + v) * 8 : src;
    ptk::cp_async16(dst + r * ld + v * 8, s, ok);
  }
}

// The gate operand's rows [x(t-d) | x(t+d) | x(t) | c] of a tile; c has cw
// columns (cw % 8 == 0).
template <int CR>
__device__ __forceinline__ void cp_gate_operand(
    bf16* a, int lda, const bf16* __restrict__ saved,
    const bf16* __restrict__ c, int cw, int q0, int qend, int T, int d) {
  constexpr int V = CR / 8;
  cp_rows(a, lda, saved, V, q0, qend, T, -d);
  cp_rows(a + CR, lda, saved, V, q0, qend, T, d);
  cp_rows(a + 2 * CR, lda, saved, V, q0, qend, T, 0);
  cp_rows(a + 3 * CR, lda, c, cw / 8, q0, qend, T, 0);
}

// The columns [cw, aw) after c in every row of `stages` tiles of the gate
// operand (3cr + cw on): the constant 1 at column ca, which meets the gate
// bias row of wg, and zeros.  cp.async never writes them.
__device__ void fill_aux(bf16* a, int lda, size_t stage, int stages, int cr,
                         int ca, int cw, int aw) {
  const int w = aw - cw;
  for (int i = threadIdx.x; i < stages * TM * w; i += THREADS) {
    const int r = i / w;
    const int j = cw + (i - r * w);
    a[(r / TM) * stage + (r % TM) * lda + 3 * cr + j] =
        __float2bfloat16_rn(j == ca ? 1.f : 0.f);
  }
}

// dres = dxo sqrt(0.5) of a tile, read ahead into registers: a thread
// holds K float4 of fixed columns (THREADS is a multiple of a row's
// float4), so it also adds their float32 column sums (dbso's dres half).
template <int CR>
struct DresRows {
  static constexpr int N4 = CR / 4;
  static constexpr int K = TM * N4 / THREADS;
  static_assert(THREADS % N4 == 0 && K >= 1, "fixed columns a thread");
  float4 v[K];

  __device__ __forceinline__ void load(const float* __restrict__ dxo, int q0,
                                       int qend) {
    const float4* s = reinterpret_cast<const float4*>(dxo);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int q = q0 + i / N4;
      v[k] = q < qend ? __ldg(s + static_cast<size_t>(q) * N4 + i % N4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // bf16 into the shared tile (pitch(CR)), float32 into sums
  __device__ __forceinline__ void store(bf16* dr, float4& sums) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const float4 x = make_float4(v[k].x * SQRT_HALF, v[k].y * SQRT_HALF,
                                   v[k].z * SQRT_HALF, v[k].w * SQRT_HALF);
      *reinterpret_cast<uint2*>(dr + (i / N4) * pitch(CR) + (i % N4) * 4) =
          ptk::pack4(x);
      sums = add4(sums, x);
    }
  }
};

// The float32 sums of THREADS threads that share CR / 4 float4 columns,
// added in a fixed order, to out[0, CR).  red: THREADS float4 of shared
// memory free for this; every thread calls it.
template <int CR>
__device__ void write_column_sums(float4* red, float4 sums, float* out) {
  constexpr int N4 = CR / 4;
  red[threadIdx.x] = sums;
  __syncthreads();
  if (threadIdx.x < N4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = threadIdx.x; p < THREADS; p += N4) s = add4(s, red[p]);
    reinterpret_cast<float4*>(out)[threadIdx.x] = s;
  }
}

// ---------------------------------------------------------------- prep --

template <int CR>
__global__ void __launch_bounds__(THREADS)
k2b_prep_kernel(const float* __restrict__ dskip, bf16* __restrict__ dsk16,
                float* __restrict__ sk_part, int R, int chunk_rows) {
  constexpr int N4 = CR / 4;
  __shared__ float4 red[THREADS];
  const float4* src = reinterpret_cast<const float4*>(dskip);
  uint2* dst = reinterpret_cast<uint2*>(dsk16);
  const long long qa = static_cast<long long>(blockIdx.x) * chunk_rows;
  const long long qb = min(qa + chunk_rows, static_cast<long long>(R));
  const long long end = qb * N4;
  float4 sums = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long base = qa * N4 + threadIdx.x; base < end;
       base += ptk::BATCH * THREADS) {
    float4 v[ptk::BATCH];
#pragma unroll
    for (int k = 0; k < ptk::BATCH; ++k) {
      const long long i = base + k * THREADS;
      v[k] = i < end ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < ptk::BATCH; ++k) {
      const long long i = base + k * THREADS;
      if (i < end) {
        dst[i] = ptk::pack4(v[k]);
        sums = add4(sums, v[k]);
      }
    }
  }
  if (sk_part != nullptr)
    write_column_sums<CR>(red, sums,
                          sk_part + static_cast<size_t>(blockIdx.x) * CR);
}

// ---------------------------------------------------------------- gate --

// part (with the weight gradients, else null): the chunk's block of the
// layer's (KP + CR + 1, 2CR) float32 partial, at part + blockIdx.x *
// part_stride; this kernel writes rows [KP, KP + CR) (dwso) and row KP + CR
// (dbso: the prep kernel's sums of dskip, then those of dres).
template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
k2b_gate_kernel(const bf16* __restrict__ saved, const bf16* __restrict__ c,
                const bf16* __restrict__ wg, const bf16* __restrict__ wso,
                const float* __restrict__ dxo,
                const bf16* __restrict__ dsk16,
                const float* __restrict__ sk_part, bf16* __restrict__ dg,
                float* __restrict__ part, int R, int T, int CA, int CW,
                int KP, int d, int chunk_rows, long long part_stride) {
  constexpr int G = 2 * CR;
  constexpr int LDG = pitch(G), LDS = pitch(CR);
  constexpr int NQ = CR / 16;       // n8 tiles of a warp's half of CR
  constexpr int MT = CR / 16;       // dwso: m16 tiles (h's columns)
  constexpr int NW = MT * (G / 8) / WARPS;   // a warp's n8 tiles of dwso
  const bool need_w = part != nullptr;
  const int lda = pitch(KP);
  const size_t stage_a = size_t(TM) * lda;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wg_s = reinterpret_cast<bf16*>(smem);
  bf16* wso_s = wg_s + size_t(KP) * LDG;
  bf16* a_s = wso_s + CR * LDG;              // two stages
  bf16* sk_s = a_s + 2 * stage_a;            // two stages
  bf16* dr_s = sk_s + 2 * TM * LDS;
  bf16* h_s = dr_s + TM * LDS;
  ptk::stage_rows<THREADS>(wg_s, wg, KP, G, LDG);
  ptk::stage_rows<THREADS>(wso_s, wso, CR, G, LDG);
  fill_aux(a_s, lda, stage_a, 2, CR, CA, CW, KP - 3 * CR);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);           // the warp's rows of a tile
  const int j0 = (warp >> 2) * (CR / 2);    // its half of the columns
  const int wm = 16 * (warp % MT);          // its dwso tile: h columns
  const int wn = 8 * NW * (warp / MT);      // and dso columns
  float acc_w[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
    acc_w[n][0] = acc_w[n][1] = acc_w[n][2] = acc_w[n][3] = 0.f;
  float4 sums = make_float4(0.f, 0.f, 0.f, 0.f);

  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);
  DresRows<CR> dres;
  cp_gate_operand<CR>(a_s, lda, saved, c, CW, qa, qb, T, d);
  cp_rows(sk_s, LDS, dsk16, CR / 8, qa, qb, T, 0);
  ptk::cp_async_commit();
  dres.load(dxo, qa, qb);

  for (int it = 0, q0 = qa; q0 < qb; ++it, q0 += TM) {
    const int s = it & 1;
    const bf16* a = a_s + s * stage_a;
    const bf16* sk = sk_s + s * TM * LDS;
    dres.store(dr_s, sums);
    ptk::cp_async_wait<0>();
    __syncthreads();   // this tile's rows are in; the last tile is done
    if (q0 + TM < qb) {
      cp_gate_operand<CR>(a_s + (s ^ 1) * stage_a, lda, saved, c, CW,
                          q0 + TM, qb, T, d);
      cp_rows(sk_s + (s ^ 1) * TM * LDS, LDS, dsk16, CR / 8, q0 + TM, qb,
              T, 0);
      dres.load(dxo, q0 + TM, qb);
    }
    ptk::cp_async_commit();

    // the gate, tanh's columns j0 + ... in ga[0] and sigmoid's in ga[1]
    float ga[2][NQ][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        ga[u][n][0] = ga[u][n][1] = ga[u][n][2] = ga[u][n][3] = 0.f;
    const bf16* ap = a + (rw + (lane & 15)) * lda + (lane >> 4) * 8;
    const bf16* bp = wg_s + (lane & 15) * LDG + j0 + (lane >> 4) * 8;
#pragma unroll 2
    for (int k = 0; k < KP; k += 16) {
      uint32_t af[4];
      ptk::ldsm_x4(af, ap + k);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int p = 0; p < NQ / 2; ++p) {
          uint32_t bf[4];
          ptk::ldsm_x4_trans(bf, bp + k * LDG + u * CR + 16 * p);
          ptk::mma_bf16(ga[u][2 * p], af, bf[0], bf[1]);
          ptk::mma_bf16(ga[u][2 * p + 1], af, bf[2], bf[3]);
        }
      }
    }
    // ta and sb in place; h = bf16(ta sb) to shared memory for dwso
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ga[0][n][e] = ptk::fast_tanh(ga[0][n][e]);
        ga[1][n][e] = ptk::fast_sigmoid(ga[1][n][e]);
      }
      bf16* hp = h_s + (rw + g) * LDS + j0 + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(hp) = ptk::pack_bf16(
          ga[0][n][0] * ga[1][n][0], ga[0][n][1] * ga[1][n][1]);
      *reinterpret_cast<uint32_t*>(hp + 8 * LDS) = ptk::pack_bf16(
          ga[0][n][2] * ga[1][n][2], ga[0][n][3] * ga[1][n][3]);
    }

    // dh = dso @ wso^T on the warp's columns, dso = [dsk16 | dres]
    float dh[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      dh[n][0] = dh[n][1] = dh[n][2] = dh[n][3] = 0.f;
#pragma unroll
    for (int k = 0; k < G; k += 16) {
      const bf16* src = k < CR ? sk : dr_s;
      uint32_t af[4];
      ptk::ldsm_x4(af, src + (rw + (lane & 15)) * LDS + (k % CR) +
                           (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4(bf, wso_s + (j0 + 16 * p + (lane & 7) +
                                  ((lane >> 4) << 3)) * LDG +
                             k + ((lane >> 3) & 1) * 8);
        ptk::mma_bf16(dh[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(dh[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    // dg = bf16([dh sb (1 - ta^2) | dh ta sb (1 - sb)]) to device memory
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + rw + g + 8 * r;
        if (q >= qb) continue;
        float da[2], db[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ta = ga[0][n][2 * r + e], sb = ga[1][n][2 * r + e];
          const float x = dh[n][2 * r + e];
          da[e] = x * sb * (1.f - ta * ta);
          db[e] = x * ta * sb * (1.f - sb);
        }
        bf16* o = dg + static_cast<size_t>(q) * G + j0 + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(o) = ptk::pack_bf16(da[0], da[1]);
        *reinterpret_cast<uint32_t*>(o + CR) = ptk::pack_bf16(db[0], db[1]);
      }
    }

    if (need_w) {
      __syncthreads();   // h of every warp is in
      // dwso += h^T dso over the tile's rows
#pragma unroll
      for (int k = 0; k < TM; k += 16) {
        uint32_t af[4];
        ptk::ldsm_x4_trans(af, h_s + (k + (lane & 7) + ((lane >> 4) << 3)) *
                                         LDS +
                                   wm + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int p = 0; p < NW / 2; ++p) {
          const int n0 = wn + 16 * p;
          const bf16* src = n0 < CR ? sk + n0 : dr_s + (n0 - CR);
          uint32_t bf[4];
          ptk::ldsm_x4_trans(bf, src + (k + (lane & 15)) * LDS +
                                     (lane >> 4) * 8);
          ptk::mma_bf16(acc_w[2 * p], af, bf[0], bf[1]);
          ptk::mma_bf16(acc_w[2 * p + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // dres, h and this stage are free again
  }
  if (!need_w) return;

  float* out = part + blockIdx.x * part_stride;
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    float* o = out + static_cast<size_t>(KP + wm + g) * G + wn + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(acc_w[n][0], acc_w[n][1]);
    *reinterpret_cast<float2*>(o + 8 * G) =
        make_float2(acc_w[n][2], acc_w[n][3]);
  }
  float* row = out + static_cast<size_t>(KP + CR) * G;
  for (int i = threadIdx.x; i < CR; i += THREADS)
    row[i] = sk_part[static_cast<size_t>(blockIdx.x) * CR + i];
  write_column_sums<CR>(reinterpret_cast<float4*>(a_s), sums, row + CR);
}

// ------------------------------------------------------------------ dw --

// Writes rows [0, KP) (dwg) of the chunk's partial block (see the gate).
template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
k2b_dw_kernel(const bf16* __restrict__ saved, const bf16* __restrict__ c,
              const bf16* __restrict__ dg, float* __restrict__ part, int R,
              int T, int CA, int CW, int KP, int d, int chunk_rows,
              long long part_stride) {
  constexpr int G = 2 * CR;
  constexpr int LDY = pitch(G);
  constexpr int NH = G / 16;        // n8 tiles of a warp's half of dg
  constexpr int MI = ((3 * CR + AW_MAX) / 16 + 3) / 4;  // its m16 tiles
  const int lda = pitch(KP);
  const int mt = KP / 16;
  const size_t stage = size_t(TM) * (lda + LDY);

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* st = reinterpret_cast<bf16*>(smem);
  fill_aux(st, lda, stage, DW_STAGES, CR, CA, CW, KP - 3 * CR);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (warp >> 2) * (G / 2);     // the warp's half of dg
  const int mq = warp & 3;                  // its m16 tiles mq, mq + 4, ...
  float acc[MI][NH][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < NH; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);
  auto issue = [&](int s, int q0) {
    bf16* a = st + s * stage;
    cp_gate_operand<CR>(a, lda, saved, c, CW, q0, qb, T, d);
    cp_rows(a + TM * lda, LDY, dg, G / 8, q0, qb, T, 0);
  };
#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (qa + s * TM < qb) issue(s, qa + s * TM);
    ptk::cp_async_commit();
  }
  for (int it = 0, q0 = qa; q0 < qb; ++it, q0 += TM) {
    ptk::cp_async_wait<DW_STAGES - 2>();
    __syncthreads();   // this tile is in; the stage refilled next is free
    const int nxt = q0 + (DW_STAGES - 1) * TM;
    if (nxt < qb) issue((it + DW_STAGES - 1) % DW_STAGES, nxt);
    ptk::cp_async_commit();

    const bf16* a = st + (it % DW_STAGES) * stage;
    const bf16* y = a + TM * lda;
#pragma unroll
    for (int k = 0; k < TM; k += 16) {
      uint32_t bf[NH][2];
#pragma unroll
      for (int p = 0; p < NH / 2; ++p) {
        uint32_t v[4];
        ptk::ldsm_x4_trans(v, y + (k + (lane & 15)) * LDY + n0 + 16 * p +
                                  (lane >> 4) * 8);
        bf[2 * p][0] = v[0];
        bf[2 * p][1] = v[1];
        bf[2 * p + 1][0] = v[2];
        bf[2 * p + 1][1] = v[3];
      }
      const bf16* ak = a + (k + (lane & 7) + ((lane >> 4) << 3)) * lda +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = mq + 4 * i;
        if (m < mt) {
          uint32_t af[4];
          ptk::ldsm_x4_trans(af, ak + 16 * m);
#pragma unroll
          for (int n = 0; n < NH; ++n)
            ptk::mma_bf16(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
  }

  float* out = part + blockIdx.x * part_stride;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = mq + 4 * i;
    if (m >= mt) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      float* o = out + static_cast<size_t>(16 * m + g) * G + n0 + 8 * n +
                 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][n][0], acc[i][n][1]);
      *reinterpret_cast<float2*>(o + 8 * G) =
          make_float2(acc[i][n][2], acc[i][n][3]);
    }
  }
}

// ------------------------------------------------------------------ dx --

template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
k2b_dx_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ wdx,
              const bf16* __restrict__ wdc, const float* __restrict__ dxo,
              float* __restrict__ dx, float* __restrict__ dc, int R, int T,
              int CA, int CAP, int d, int dc_init, int chunk_rows) {
  constexpr int G = 2 * CR;
  constexpr int LDT = pitch(G), LDX = pitch(CR);
  constexpr int NQ = CR / 16;          // n8 tiles of a warp's half of dx
  constexpr int NB = AW_MAX / 32;      // its n16 blocks of dc, at most
  const int ldc = pitch(CAP);
  const int nc16 = CAP / 16;
  const size_t stage = 3 * size_t(TM) * LDT;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wx_s = reinterpret_cast<bf16*>(smem);
  bf16* wc_s = wx_s + 6 * CR * LDX;
  bf16* st = wc_s + G * ldc;             // two stages of three tiles
  ptk::stage_rows<THREADS>(wx_s, wdx, 6 * CR, CR, LDX);
  ptk::stage_rows<THREADS>(wc_s, wdc, G, CAP, ldc);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);
  const int ch = warp >> 2;
  const int j0 = ch * (CR / 2);           // the warp's half of dx
  const bool pairs = (CA % 2) == 0;       // dc rows of float2

  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);
  // [dg(t) | dg(t+d) | dg(t-d)] against [W1^T; W0^T; W2^T]
  auto issue = [&](int s, int q0) {
    bf16* a = st + s * stage;
    cp_rows(a, LDT, dg, G / 8, q0, qb, T, 0);
    cp_rows(a + TM * LDT, LDT, dg, G / 8, q0, qb, T, d);
    cp_rows(a + 2 * TM * LDT, LDT, dg, G / 8, q0, qb, T, -d);
  };
  issue(0, qa);
  ptk::cp_async_commit();

  for (int it = 0, q0 = qa; q0 < qb; ++it, q0 += TM) {
    const int s = it & 1;
    ptk::cp_async_wait<0>();
    __syncthreads();
    if (q0 + TM < qb) issue(s ^ 1, q0 + TM);
    ptk::cp_async_commit();

    // the epilogue's operands first: their latency hides behind the products
    int rows[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = q0 + rw + g + 8 * r;
      live[r] = rows[r] < qb;
    }
    float2 xo[NQ][2];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        xo[n][r] = live[r] ? __ldg(reinterpret_cast<const float2*>(
                                 dxo + static_cast<size_t>(rows[r]) * CR +
                                 j0 + 8 * n + 2 * t))
                           : make_float2(0.f, 0.f);
    float2 co[NB][2][2];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 16 * (ch + 2 * i) + 8 * u + 2 * t;
          co[i][u][r] = make_float2(0.f, 0.f);
          if (dc_init || !live[r] || col >= CA) continue;
          const float* p = dc + static_cast<size_t>(rows[r]) * CA + col;
          if (pairs) {
            co[i][u][r] = *reinterpret_cast<const float2*>(p);
          } else {
            co[i][u][r].x = p[0];
            if (col + 1 < CA) co[i][u][r].y = p[1];
          }
        }

    float ax[NQ][4], ac[NB][2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      ax[n][0] = ax[n][1] = ax[n][2] = ax[n][3] = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        ac[i][u][0] = ac[i][u][1] = ac[i][u][2] = ac[i][u][3] = 0.f;
    const bf16* a = st + s * stage + (rw + (lane & 15)) * LDT +
                    (lane >> 4) * 8;
#pragma unroll
    for (int k = 0; k < 3 * G; k += 16) {
      uint32_t af[4];
      ptk::ldsm_x4(af, a + (k / G) * TM * LDT + (k % G));
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, wx_s + (k + (lane & 15)) * LDX + j0 + 16 * p +
                                   (lane >> 4) * 8);
        ptk::mma_bf16(ax[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(ax[2 * p + 1], af, bf[2], bf[3]);
      }
      if (k < G) {     // dc reads dg(t) only
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int nb = ch + 2 * i;
          if (nb < nc16) {
            uint32_t bf[4];
            ptk::ldsm_x4_trans(bf, wc_s + (k + (lane & 15)) * ldc + 16 * nb +
                                       (lane >> 4) * 8);
            ptk::mma_bf16(ac[i][0], af, bf[0], bf[1]);
            ptk::mma_bf16(ac[i][1], af, bf[2], bf[3]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const size_t q = static_cast<size_t>(rows[r]);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        *reinterpret_cast<float2*>(dx + q * CR + j0 + 8 * n + 2 * t) =
            make_float2(ax[n][2 * r] + xo[n][r].x * SQRT_HALF,
                        ax[n][2 * r + 1] + xo[n][r].y * SQRT_HALF);
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 16 * (ch + 2 * i) + 8 * u + 2 * t;
          if (col >= CA) continue;
          const float v0 = ac[i][u][2 * r] + co[i][u][r].x;
          const float v1 = ac[i][u][2 * r + 1] + co[i][u][r].y;
          float* p = dc + q * CA + col;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (col + 1 < CA) p[1] = v1;
          }
        }
    }
  }
}

// --------------------------------------------------------------- launch --

bool bad_shape(int B, int T, int CR, int CA, int KP) {
  if (B <= 0 || T <= 0 || CA <= 0) return true;
  if (static_cast<long long>(B) * T > (1LL << 30)) return true;
  if (CR != 32 && CR != 64) return true;
  if (KP % 16 != 0 || KP < 3 * CR + CA + 1 || KP - 3 * CR > AW_MAX)
    return true;
  return false;
}

bool bad_chunks(int R, int nparts, int chunk_rows) {
  return chunk_rows <= 0 || nparts <= 0 ||
         static_cast<long long>(nparts) * chunk_rows < R ||
         static_cast<long long>(nparts - 1) * chunk_rows >= R;
}

// c's columns as the kernels read them: CA itself when its rows are
// 16-byte vectors, else the [c | 1 | 0] copy of KP - 3CR columns
bool bad_cw(int CR, int CA, int CW, int KP) {
  return !(CW == CA && CA % 8 == 0) && CW != KP - 3 * CR;
}

}  // namespace

// dsk16 (B, T, CR) bf16 = dskip (B, T, CR) f32 rounded; with sk_part (else
// null), chunk i's float32 column sums of dskip to sk_part[i, 0:CR).
extern "C" int pwg_stack_bwd_prep(const void* dskip, void* dsk16,
                                  void* sk_part, int B, int T, int CR,
                                  int nparts, int chunk_rows, void* stream) {
  if (B <= 0 || T <= 0 || (CR != 32 && CR != 64)) return -1;
  if (static_cast<long long>(B) * T > (1LL << 30)) return -1;
  const int R = B * T;
  if (bad_chunks(R, nparts, chunk_rows)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(dskip);
  bf16* out = static_cast<bf16*>(dsk16);
  float* sums = static_cast<float*>(sk_part);
  if (CR == 32)
    k2b_prep_kernel<32><<<nparts, THREADS, 0, s>>>(in, out, sums, R,
                                                   chunk_rows);
  else
    k2b_prep_kernel<64><<<nparts, THREADS, 0, s>>>(in, out, sums, R,
                                                   chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

// Gate pass of one layer over nparts chunks of chunk_rows rows.  saved:
// (B, T, CR) bf16, the layer's input rows (K2a); c: (B, T, CW) bf16 (see
// bad_cw); wg: (KP, 2CR) bf16 as K1 takes it; wso: (CR, 2CR) bf16 =
// [W_skip | W_out]; dxo: (B, T, CR) f32, the gradient of the layer's
// output; dsk16 from the prep.  Writes dg (B, T, 2CR) bf16 and, with part
// (else null; sk_part then unread), the chunks' dwso and dbso partials.
extern "C" int pwg_stack_bwd_gate(const void* saved, const void* c,
                                  const void* wg, const void* wso,
                                  const void* dxo, const void* dsk16,
                                  const void* sk_part, void* dg, void* part,
                                  int B, int T, int CR, int CA, int CW,
                                  int KP, int d, int nparts, int chunk_rows,
                                  long long part_stride, void* stream) {
  if (bad_shape(B, T, CR, CA, KP) || bad_cw(CR, CA, CW, KP) || d < 0)
    return -1;
  const int R = B * T;
  if (bad_chunks(R, nparts, chunk_rows)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(bf16) * gate_elems(CR, KP);
  auto run = [&](auto kernel) {
    cudaError_t err = ptk::set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<nparts, THREADS, smem, s>>>(
        static_cast<const bf16*>(saved), static_cast<const bf16*>(c),
        static_cast<const bf16*>(wg), static_cast<const bf16*>(wso),
        static_cast<const float*>(dxo), static_cast<const bf16*>(dsk16),
        static_cast<const float*>(sk_part), static_cast<bf16*>(dg),
        static_cast<float*>(part), R, T, CA, CW, KP, d, chunk_rows,
        part_stride);
    return static_cast<int>(cudaGetLastError());
  };
  return CR == 32 ? run(k2b_gate_kernel<32>) : run(k2b_gate_kernel<64>);
}

// Weight-gradient pass of one layer: chunk i writes rows [0, KP) (dwg) of
// the (KP + CR + 1, 2CR) f32 block at part + i * part_stride.
extern "C" int pwg_stack_bwd_dw(const void* saved, const void* c,
                                const void* dg, void* part, int B, int T,
                                int CR, int CA, int CW, int KP, int d,
                                int nparts, int chunk_rows,
                                long long part_stride, void* stream) {
  if (bad_shape(B, T, CR, CA, KP) || bad_cw(CR, CA, CW, KP) || d < 0)
    return -1;
  const int R = B * T;
  if (bad_chunks(R, nparts, chunk_rows)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(bf16) * dw_elems(CR, KP);
  auto run = [&](auto kernel) {
    cudaError_t err = ptk::set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<nparts, THREADS, smem, s>>>(
        static_cast<const bf16*>(saved), static_cast<const bf16*>(c),
        static_cast<const bf16*>(dg), static_cast<float*>(part), R, T, CA,
        CW, KP, d, chunk_rows, part_stride);
    return static_cast<int>(cudaGetLastError());
  };
  return CR == 32 ? run(k2b_dw_kernel<32>) : run(k2b_dw_kernel<64>);
}

// dx pass of one layer.  dg: (B, T, 2CR) bf16; wdx: (6CR, CR) bf16 =
// [W1^T; W0^T; W2^T] (centre, t-d and t+d taps of wg, transposed); wdc:
// (2CR, CAP) bf16 = Wa^T with CAP = CA rounded up to 16; dxo: (B, T, CR)
// f32.  Writes dx (B, T, CR) f32 and writes (dc_init) or adds to dc
// (B, T, CA) f32.
extern "C" int pwg_stack_bwd_dx(const void* dg, const void* wdx,
                                const void* wdc, const void* dxo, void* dx,
                                void* dc, int B, int T, int CR, int CA,
                                int CAP, int d, int dc_init, int nparts,
                                int chunk_rows, void* stream) {
  if (B <= 0 || T <= 0 || CA <= 0 || d < 0) return -1;
  if (static_cast<long long>(B) * T > (1LL << 30)) return -1;
  if (CR != 32 && CR != 64) return -1;
  if (CAP % 16 != 0 || CAP < CA || CAP > AW_MAX) return -1;
  const int R = B * T;
  if (bad_chunks(R, nparts, chunk_rows)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(bf16) * dx_elems(CR, CAP);
  auto run = [&](auto kernel) {
    cudaError_t err = ptk::set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<nparts, THREADS, smem, s>>>(
        static_cast<const bf16*>(dg), static_cast<const bf16*>(wdx),
        static_cast<const bf16*>(wdc), static_cast<const float*>(dxo),
        static_cast<float*>(dx), static_cast<float*>(dc), R, T, CA, CAP, d,
        dc_init, chunk_rows);
    return static_cast<int>(cudaGetLastError());
  };
  return CR == 32 ? run(k2b_dx_kernel<32>) : run(k2b_dx_kernel<64>);
}

// Dynamic shared memory bytes of K2b's kernel `which` (0 gate, 1 dw, 2 dx)
// at these widths; the launcher's Python mirror is held against it.
extern "C" long long pwg_stack_bwd_smem(int which, int CR, int KP, int CAP) {
  if (which == 0) return sizeof(bf16) * gate_elems(CR, KP);
  if (which == 1) return sizeof(bf16) * dw_elems(CR, KP);
  if (which == 2) return sizeof(bf16) * dx_elems(CR, CAP);
  return -1;
}

// out[i] = sum over p < nparts of part[p * n + i], in order.
extern "C" int pwg_reduce_partials(const void* part, void* out, int nparts,
                                   long long n, void* stream) {
  if (nparts <= 0 || n <= 0) return -1;
  return static_cast<int>(ptk::reduce_partials(
      static_cast<const float*>(part), static_cast<float*>(out), nparts, n,
      static_cast<cudaStream_t>(stream)));
}
