// Kernel K2b's device code and launchers: k2b_prep_kernel, k2b_gate_kernel,
// k2b_dw_kernel and k2b_dx_kernel, their geometry and the host functions
// that launch one instance.  The design and its figures are in
// pwg_stack_bwd.cu's header comment.  Two sources include this file, so
// that nvcc builds their instances in parallel: pwg_stack_bwd.cu (residual
// widths 32 and 64, and the C interface) and pwg_stack_bwd_cr128.cu (128).
// Everything but the declarations at the end is in an unnamed namespace, as
// in common.cuh.
//
// How each pass splits a chunk's work over blocks at residual width cr.
// At 32 and 64 one block a chunk holds all the weights it needs.  At 128
// they outgrow a block's 227 KB, so the grid's y splits the columns:
//   gate  y = two halves of the column pairs j (tanh's j, sigmoid's cr + j,
//         dh's j): a block holds its half of wg (KP x 128) and wso's rows j
//         (64 x 256), walks its chunk in tiles of 32 rows with one stage,
//         and writes its half of dg and its rows of dwso; y = 0 also writes
//         dbso;
//   dw    y = four quarters of dg's 256 columns: a block stages its quarter
//         of dg beside the whole gate operand and keeps a KP x 64 block of
//         dwg in registers (128 a thread);
//   dx    y = two halves of dx's columns (a block holds its half of
//         [W1^T; W0^T; W2^T], 768 x 64, and the whole of Wa^T), tiles of 32
//         rows with one stage; each dc column block is one warp's of one y.
// No sum is split: every output element is still formed by one thread.
#pragma once

#include "common.cuh"

namespace ptk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TM = 64;              // rows per tile (dw; gate and dx below)
constexpr int DW_STAGES = 3;
constexpr int AW_MAX = 128;         // widest [c | 1 | 0] operand
constexpr float SQRT_HALF = 0.70710678118654752f;

// the split of each pass at residual width cr (see above)
__host__ __device__ constexpr int gate_split(int cr) {
  return cr > 64 ? 2 : 1;
}
__host__ __device__ constexpr int gate_rows(int cr) {
  return cr > 64 ? 32 : TM;
}
__host__ __device__ constexpr int gate_stages(int cr) {
  return cr > 64 ? 1 : 2;
}
__host__ __device__ constexpr int dw_split(int cr) { return cr > 64 ? 4 : 1; }
__host__ __device__ constexpr int dx_split(int cr) { return cr > 64 ? 2 : 1; }
__host__ __device__ constexpr int dx_rows(int cr) {
  return cr > 64 ? 32 : TM;
}
__host__ __device__ constexpr int dx_stages(int cr) {
  return cr > 64 ? 1 : 2;
}

// Shared pitch of rows of w bf16 columns (w % 16 == 0): 16 bytes times an
// odd number, so the eight rows of an ldmatrix read hit distinct banks.
__host__ __device__ constexpr int pitch(int w) { return w + 8; }

// Shared memory of each kernel, in bf16 elements (prep's is static).
__host__ __device__ size_t gate_elems(int cr, int kp) {
  const size_t jw = cr / gate_split(cr);      // a block's column pairs
  const size_t tm = gate_rows(cr);
  return size_t(kp) * pitch(2 * jw) + jw * pitch(2 * cr)   // wg, wso
         + gate_stages(cr) * tm * (pitch(kp) + pitch(cr))  // A, dsk16
         + tm * pitch(cr) + tm * pitch(jw);                // dres, h
}
__host__ __device__ size_t dw_elems(int cr, int kp) {
  return DW_STAGES * size_t(TM) *
         (pitch(kp) + pitch(2 * cr / dw_split(cr)));   // A, dg
}
__host__ __device__ size_t dx_elems(int cr, int cap) {
  return size_t(6 * cr) * pitch(cr / dx_split(cr))      // [W1; W0; W2]^T
         + size_t(2 * cr) * pitch(cap)                  // Wa^T
         + dx_stages(cr) * 3 * size_t(dx_rows(cr)) *
               pitch(2 * cr);   // stages: dg(t), dg(t+-d)
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Start 16-byte cp.async copies of the `rows` rows q0, q0 + 1, ... of a
// tile: row q takes vpr 16-byte vectors of row q + off of src, whose rows
// are src_vpr vectors apart, into shared rows of pitch ld.  Rows at or past
// qend, and rows whose t + off leaves [0, T) (the shifted taps of a dilated
// conv), are zero-filled.
__device__ __forceinline__ void cp_rows(bf16* dst, int ld,
                                        const bf16* __restrict__ src,
                                        int vpr, int rows, int q0, int qend,
                                        int T, int off, int src_vpr) {
  for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    const int q = q0 + r;
    bool ok = q < qend;
    if (ok && off != 0) {
      const int ts = q % T + off;
      ok = ts >= 0 && ts < T;
    }
    const bf16* s =
        ok ? src + (static_cast<size_t>(q + off) * src_vpr + v) * 8 : src;
    ptk::cp_async16(dst + r * ld + v * 8, s, ok);
  }
}

// The gate operand's rows [x(t-d) | x(t+d) | x(t) | c] of a tile; c has cw
// columns (cw % 8 == 0).
template <int CR>
__device__ __forceinline__ void cp_gate_operand(
    bf16* a, int lda, const bf16* __restrict__ saved,
    const bf16* __restrict__ c, int cw, int rows, int q0, int qend, int T,
    int d) {
  constexpr int V = CR / 8;
  cp_rows(a, lda, saved, V, rows, q0, qend, T, -d, V);
  cp_rows(a + CR, lda, saved, V, rows, q0, qend, T, d, V);
  cp_rows(a + 2 * CR, lda, saved, V, rows, q0, qend, T, 0, V);
  cp_rows(a + 3 * CR, lda, c, cw / 8, rows, q0, qend, T, 0, cw / 8);
}

// The columns [cw, aw) after c in every row of `stages` tiles of `rows`
// rows of the gate operand (3cr + cw on): the constant 1 at column ca,
// which meets the gate bias row of wg, and zeros.  cp.async never writes
// them.
__device__ void fill_aux(bf16* a, int lda, size_t stage, int stages,
                         int rows, int cr, int ca, int cw, int aw) {
  const int w = aw - cw;
  for (int i = threadIdx.x; i < stages * rows * w; i += THREADS) {
    const int r = i / w;
    const int j = cw + (i - r * w);
    a[(r / rows) * stage + (r % rows) * lda + 3 * cr + j] =
        __float2bfloat16_rn(j == ca ? 1.f : 0.f);
  }
}

// Copy columns [col0, col0 + cols) of a (rows, src_cols) bf16 row-major
// matrix (col0, cols and src_cols multiples of 8) into shared rows of pitch
// ldd from column dcol0 on, loads in batches as common.cuh's stage_rows.
__device__ void stage_cols(bf16* dst, int ldd, int dcol0,
                           const bf16* __restrict__ src, int rows,
                           int src_cols, int col0, int cols) {
  const int vpr = cols / 8;
  const int n = rows * vpr;
  for (int base = threadIdx.x; base < n; base += ptk::BATCH * THREADS) {
    uint4 v[ptk::BATCH];
#pragma unroll
    for (int k = 0; k < ptk::BATCH; ++k) {
      const int i = base + k * THREADS;
      if (i < n)
        v[k] = *reinterpret_cast<const uint4*>(
            src + size_t(i / vpr) * src_cols + col0 + 8 * (i % vpr));
    }
#pragma unroll
    for (int k = 0; k < ptk::BATCH; ++k) {
      const int i = base + k * THREADS;
      if (i < n)
        *reinterpret_cast<uint4*>(dst + (i / vpr) * ldd + dcol0 +
                                  8 * (i % vpr)) = v[k];
    }
  }
}

// dres = dxo sqrt(0.5) of a tile of ROWS rows, read ahead into registers:
// a thread holds K float4 of fixed columns (THREADS is a multiple of a
// row's float4), so it also adds their float32 column sums (dbso's dres
// half).
template <int CR, int ROWS>
struct DresRows {
  static constexpr int N4 = CR / 4;
  static constexpr int K = ROWS * N4 / THREADS;
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

// Block (x, y) takes chunk x and the column pairs j of half y (all of them
// at gate_split 1).  part (with the weight gradients, else null): the
// chunk's block of the layer's (KP + CR + 1, 2CR) float32 partial, at part
// + blockIdx.x * part_stride; this kernel writes rows KP + j (dwso) and, at
// y = 0, row KP + CR (dbso: the prep kernel's sums of dskip, then those of
// dres).
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
  constexpr int JW = CR / gate_split(CR);   // the block's column pairs
  constexpr int ROWS = gate_rows(CR);       // rows a tile
  constexpr int STAGES = gate_stages(CR);
  constexpr int RG = ROWS / 16;             // warps along a tile's rows
  constexpr int CG = WARPS / RG;            // and along its columns
  constexpr int LDG = pitch(G), LDS = pitch(CR);
  constexpr int LDW = pitch(2 * JW), LDH = pitch(JW);
  constexpr int NQ = JW / CG / 8;   // n8 tiles of a warp's columns j
  constexpr int MT = JW / 16;       // dwso: m16 tiles (h's columns)
  constexpr int NW = MT * (G / 8) / WARPS;   // a warp's n8 tiles of dwso
  static_assert(NQ % 2 == 0 && NW % 2 == 0 && WARPS % MT == 0, "warp tiles");
  const bool need_w = part != nullptr;
  const int jb = blockIdx.y * JW;           // the block's first column j
  const int lda = pitch(KP);
  const size_t stage_a = size_t(ROWS) * lda;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wg_s = reinterpret_cast<bf16*>(smem);  // [tanh j | sigmoid j] cols
  bf16* wso_s = wg_s + size_t(KP) * LDW;       // wso's rows j
  bf16* a_s = wso_s + JW * LDG;              // STAGES stages
  bf16* sk_s = a_s + STAGES * stage_a;       // STAGES stages
  bf16* dr_s = sk_s + STAGES * ROWS * LDS;
  bf16* h_s = dr_s + ROWS * LDS;
  stage_cols(wg_s, LDW, 0, wg, KP, G, jb, JW);
  stage_cols(wg_s, LDW, JW, wg, KP, G, CR + jb, JW);
  stage_cols(wso_s, LDG, 0, wso + size_t(jb) * G, JW, G, 0, G);
  fill_aux(a_s, lda, stage_a, STAGES, ROWS, CR, CA, CW, KP - 3 * CR);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp % RG);          // the warp's rows of a tile
  const int jl = (warp / RG) * (JW / CG);   // its columns, from jb
  const int wm = 16 * (warp % MT);          // its dwso tile: h columns
  const int wn = 8 * NW * (warp / MT);      // and dso columns
  float acc_w[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
    acc_w[n][0] = acc_w[n][1] = acc_w[n][2] = acc_w[n][3] = 0.f;
  float4 sums = make_float4(0.f, 0.f, 0.f, 0.f);

  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);
  DresRows<CR, ROWS> dres;
  auto issue = [&](int s, int q0) {
    cp_gate_operand<CR>(a_s + s * stage_a, lda, saved, c, CW, ROWS, q0, qb,
                        T, d);
    cp_rows(sk_s + s * ROWS * LDS, LDS, dsk16, CR / 8, ROWS, q0, qb, T, 0,
            CR / 8);
    dres.load(dxo, q0, qb);
  };
  issue(0, qa);
  ptk::cp_async_commit();

  for (int it = 0, q0 = qa; q0 < qb; ++it, q0 += ROWS) {
    const int s = STAGES == 1 ? 0 : it & 1;
    const bf16* a = a_s + s * stage_a;
    const bf16* sk = sk_s + s * ROWS * LDS;
    dres.store(dr_s, sums);
    ptk::cp_async_wait<0>();
    __syncthreads();   // this tile's rows are in; the last tile is done
    if (STAGES == 2 && q0 + ROWS < qb) issue(s ^ 1, q0 + ROWS);
    ptk::cp_async_commit();

    // the gate, tanh's columns jb + jl + ... in ga[0] and sigmoid's in ga[1]
    float ga[2][NQ][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        ga[u][n][0] = ga[u][n][1] = ga[u][n][2] = ga[u][n][3] = 0.f;
    const bf16* ap = a + (rw + (lane & 15)) * lda + (lane >> 4) * 8;
    const bf16* bp = wg_s + (lane & 15) * LDW + jl + (lane >> 4) * 8;
#pragma unroll 2
    for (int k = 0; k < KP; k += 16) {
      uint32_t af[4];
      ptk::ldsm_x4(af, ap + k);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int p = 0; p < NQ / 2; ++p) {
          uint32_t bf[4];
          ptk::ldsm_x4_trans(bf, bp + k * LDW + u * JW + 16 * p);
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
      bf16* hp = h_s + (rw + g) * LDH + jl + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(hp) = ptk::pack_bf16(
          ga[0][n][0] * ga[1][n][0], ga[0][n][1] * ga[1][n][1]);
      *reinterpret_cast<uint32_t*>(hp + 8 * LDH) = ptk::pack_bf16(
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
        ptk::ldsm_x4(bf, wso_s + (jl + 16 * p + (lane & 7) +
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
        bf16* o = dg + static_cast<size_t>(q) * G + jb + jl + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(o) = ptk::pack_bf16(da[0], da[1]);
        *reinterpret_cast<uint32_t*>(o + CR) = ptk::pack_bf16(db[0], db[1]);
      }
    }

    if (need_w) {
      __syncthreads();   // h of every warp is in
      // dwso += h^T dso over the tile's rows
#pragma unroll
      for (int k = 0; k < ROWS; k += 16) {
        uint32_t af[4];
        ptk::ldsm_x4_trans(af, h_s + (k + (lane & 7) + ((lane >> 4) << 3)) *
                                         LDH +
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
    if (STAGES == 1 && q0 + ROWS < qb) issue(0, q0 + ROWS);
    ptk::cp_async_commit();
  }
  if (!need_w) return;

  float* out = part + blockIdx.x * part_stride;
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    float* o = out + static_cast<size_t>(KP + jb + wm + g) * G + wn + 8 * n +
               2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(acc_w[n][0], acc_w[n][1]);
    *reinterpret_cast<float2*>(o + 8 * G) =
        make_float2(acc_w[n][2], acc_w[n][3]);
  }
  if (blockIdx.y != 0) return;
  float* row = out + static_cast<size_t>(KP + CR) * G;
  for (int i = threadIdx.x; i < CR; i += THREADS)
    row[i] = sk_part[static_cast<size_t>(blockIdx.x) * CR + i];
  write_column_sums<CR>(reinterpret_cast<float4*>(a_s), sums, row + CR);
}

// ------------------------------------------------------------------ dw --

// Block (x, y) takes chunk x and columns [y GW, (y + 1) GW) of dg, GW = 2CR
// / dw_split; it writes those columns of rows [0, KP) (dwg) of the chunk's
// partial block (see the gate).
template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
k2b_dw_kernel(const bf16* __restrict__ saved, const bf16* __restrict__ c,
              const bf16* __restrict__ dg, float* __restrict__ part, int R,
              int T, int CA, int CW, int KP, int d, int chunk_rows,
              long long part_stride) {
  constexpr int G = 2 * CR;
  constexpr int GW = G / dw_split(CR);   // the block's columns of dg
  constexpr int LDY = pitch(GW);
  constexpr int NH = GW / 16;       // n8 tiles of a warp's half of them
  constexpr int MI = ((3 * CR + AW_MAX) / 16 + 3) / 4;  // its m16 tiles
  const int lda = pitch(KP);
  const int mt = KP / 16;
  const size_t stage = size_t(TM) * (lda + LDY);
  const int nb = blockIdx.y * GW;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* st = reinterpret_cast<bf16*>(smem);
  fill_aux(st, lda, stage, DW_STAGES, TM, CR, CA, CW, KP - 3 * CR);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (warp >> 2) * (GW / 2);    // the warp's half, from nb
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
    cp_gate_operand<CR>(a, lda, saved, c, CW, TM, q0, qb, T, d);
    cp_rows(a + TM * lda, LDY, dg + nb, GW / 8, TM, q0, qb, T, 0, G / 8);
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
      float* o = out + static_cast<size_t>(16 * m + g) * G + nb + n0 +
                 8 * n + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][n][0], acc[i][n][1]);
      *reinterpret_cast<float2*>(o + 8 * G) =
          make_float2(acc[i][n][2], acc[i][n][3]);
    }
  }
}

// ------------------------------------------------------------------ dx --

// Block (x, y) takes chunk x and dx's columns [y CR / dx_split, ...); dc's
// n16 column blocks are dealt to the warps' column groups of every y.
template <int CR>
__global__ void __launch_bounds__(THREADS, 1)
k2b_dx_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ wdx,
              const bf16* __restrict__ wdc, const float* __restrict__ dxo,
              float* __restrict__ dx, float* __restrict__ dc, int R, int T,
              int CA, int CAP, int d, int dc_init, int chunk_rows) {
  constexpr int G = 2 * CR;
  constexpr int XW = CR / dx_split(CR);   // the block's columns of dx
  constexpr int ROWS = dx_rows(CR);
  constexpr int STAGES = dx_stages(CR);
  constexpr int RG = ROWS / 16;           // warps along a tile's rows
  constexpr int CG = WARPS / RG;          // and along its columns
  constexpr int NGRP = CG * dx_split(CR);  // column groups of all blocks
  constexpr int LDT = pitch(G), LDX = pitch(XW);
  constexpr int NQ = XW / CG / 8;         // n8 tiles of a warp's dx columns
  constexpr int NB = (AW_MAX / 16 + NGRP - 1) / NGRP;  // its n16 blocks of dc
  static_assert(NQ % 2 == 0, "warp tiles");
  const int ldc = pitch(CAP);
  const int nc16 = CAP / 16;
  const size_t stage = 3 * size_t(ROWS) * LDT;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wx_s = reinterpret_cast<bf16*>(smem);
  bf16* wc_s = wx_s + 6 * CR * LDX;
  bf16* st = wc_s + G * ldc;             // STAGES stages of three tiles
  stage_cols(wx_s, LDX, 0, wdx, 6 * CR, CR, blockIdx.y * XW, XW);
  ptk::stage_rows<THREADS>(wc_s, wdc, G, CAP, ldc);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp % RG);
  const int ch = warp / RG;
  const int jl = ch * (XW / CG);            // the warp's dx columns, local
  const int j0 = blockIdx.y * XW + jl;      // and in dx
  const int grp = blockIdx.y * CG + ch;     // its dc blocks grp + NGRP i
  const bool pairs = (CA % 2) == 0;         // dc rows of float2

  const int qa = blockIdx.x * chunk_rows;
  const int qb = min(qa + chunk_rows, R);
  // [dg(t) | dg(t+d) | dg(t-d)] against [W1^T; W0^T; W2^T]
  auto issue = [&](int s, int q0) {
    bf16* a = st + s * stage;
    cp_rows(a, LDT, dg, G / 8, ROWS, q0, qb, T, 0, G / 8);
    cp_rows(a + ROWS * LDT, LDT, dg, G / 8, ROWS, q0, qb, T, d, G / 8);
    cp_rows(a + 2 * ROWS * LDT, LDT, dg, G / 8, ROWS, q0, qb, T, -d, G / 8);
  };
  issue(0, qa);
  ptk::cp_async_commit();

  for (int it = 0, q0 = qa; q0 < qb; ++it, q0 += ROWS) {
    const int s = STAGES == 1 ? 0 : it & 1;
    ptk::cp_async_wait<0>();
    __syncthreads();
    if (STAGES == 2 && q0 + ROWS < qb) issue(s ^ 1, q0 + ROWS);
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
          const int col = 16 * (grp + NGRP * i) + 8 * u + 2 * t;
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
      ptk::ldsm_x4(af, a + (k / G) * ROWS * LDT + (k % G));
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        uint32_t bf[4];
        ptk::ldsm_x4_trans(bf, wx_s + (k + (lane & 15)) * LDX + jl + 16 * p +
                                   (lane >> 4) * 8);
        ptk::mma_bf16(ax[2 * p], af, bf[0], bf[1]);
        ptk::mma_bf16(ax[2 * p + 1], af, bf[2], bf[3]);
      }
      if (k < G) {     // dc reads dg(t) only
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int nb = grp + NGRP * i;
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
          const int col = 16 * (grp + NGRP * i) + 8 * u + 2 * t;
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
    if (STAGES == 1) {
      __syncthreads();   // the stage is free again
      if (q0 + ROWS < qb) issue(0, q0 + ROWS);
      ptk::cp_async_commit();
    }
  }
}

// -------------------------------------------------------------- launchers

template <int CR>
cudaError_t launch_prep(const void* dskip, void* dsk16, void* sk_part, int R,
                        int nparts, int chunk_rows, cudaStream_t s) {
  k2b_prep_kernel<CR><<<nparts, THREADS, 0, s>>>(
      static_cast<const float*>(dskip), static_cast<bf16*>(dsk16),
      static_cast<float*>(sk_part), R, chunk_rows);
  return cudaGetLastError();
}

template <int CR>
cudaError_t launch_gate(const void* saved, const void* c, const void* wg,
                        const void* wso, const void* dxo, const void* dsk16,
                        const void* sk_part, void* dg, void* part, int R,
                        int T, int CA, int CW, int KP, int d, int nparts,
                        int chunk_rows, long long part_stride,
                        cudaStream_t s) {
  auto kernel = k2b_gate_kernel<CR>;
  const size_t smem = sizeof(bf16) * gate_elems(CR, KP);
  cudaError_t err = ptk::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nparts, gate_split(CR)), THREADS, smem, s>>>(
      static_cast<const bf16*>(saved), static_cast<const bf16*>(c),
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wso),
      static_cast<const float*>(dxo), static_cast<const bf16*>(dsk16),
      static_cast<const float*>(sk_part), static_cast<bf16*>(dg),
      static_cast<float*>(part), R, T, CA, CW, KP, d, chunk_rows,
      part_stride);
  return cudaGetLastError();
}

template <int CR>
cudaError_t launch_dw(const void* saved, const void* c, const void* dg,
                      void* part, int R, int T, int CA, int CW, int KP, int d,
                      int nparts, int chunk_rows, long long part_stride,
                      cudaStream_t s) {
  auto kernel = k2b_dw_kernel<CR>;
  const size_t smem = sizeof(bf16) * dw_elems(CR, KP);
  cudaError_t err = ptk::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nparts, dw_split(CR)), THREADS, smem, s>>>(
      static_cast<const bf16*>(saved), static_cast<const bf16*>(c),
      static_cast<const bf16*>(dg), static_cast<float*>(part), R, T, CA, CW,
      KP, d, chunk_rows, part_stride);
  return cudaGetLastError();
}

template <int CR>
cudaError_t launch_dx(const void* dg, const void* wdx, const void* wdc,
                      const void* dxo, void* dx, void* dc, int R, int T,
                      int CA, int CAP, int d, int dc_init, int nparts,
                      int chunk_rows, cudaStream_t s) {
  auto kernel = k2b_dx_kernel<CR>;
  const size_t smem = sizeof(bf16) * dx_elems(CR, CAP);
  cudaError_t err = ptk::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nparts, dx_split(CR)), THREADS, smem, s>>>(
      static_cast<const bf16*>(dg), static_cast<const bf16*>(wdx),
      static_cast<const bf16*>(wdc), static_cast<const float*>(dxo),
      static_cast<float*>(dx), static_cast<float*>(dc), R, T, CA, CAP, d,
      dc_init, chunk_rows);
  return cudaGetLastError();
}

}  // namespace

// The CR = 128 instances, in pwg_stack_bwd_cr128.cu; arguments as the
// launchers above.
cudaError_t k2b_prep_cr128(const void* dskip, void* dsk16, void* sk_part,
                           int R, int nparts, int chunk_rows, cudaStream_t s);
cudaError_t k2b_gate_cr128(const void* saved, const void* c, const void* wg,
                           const void* wso, const void* dxo,
                           const void* dsk16, const void* sk_part, void* dg,
                           void* part, int R, int T, int CA, int CW, int KP,
                           int d, int nparts, int chunk_rows,
                           long long part_stride, cudaStream_t s);
cudaError_t k2b_dw_cr128(const void* saved, const void* c, const void* dg,
                         void* part, int R, int T, int CA, int CW, int KP,
                         int d, int nparts, int chunk_rows,
                         long long part_stride, cudaStream_t s);
cudaError_t k2b_dx_cr128(const void* dg, const void* wdx, const void* wdc,
                         const void* dxo, void* dx, void* dc, int R, int T,
                         int CA, int CAP, int d, int dc_init, int nparts,
                         int chunk_rows, cudaStream_t s);

}  // namespace ptk
