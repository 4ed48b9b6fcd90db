// Kernel K4: flash attention, forward (K4a), dK/dV pass (K4b), dQ pass
// (K4c).
//
// Replaces the Pallas TPU flash-attention kernel that
// parakeet_tpu/nn/flash.py:88 (make_flash_attn_core) wraps: jax's
// pallas/ops/tpu/flash_attention.py, its forward kernel and the
// _flash_attention_dkv_kernel / _flash_attention_dq_kernel of its VJP.
//
// What it computes, per (batch, head), with q (Tq, D), k and v (Tk, D):
//   s[i, j] = (q_i . k_j in float32) * scale
//             + (q_valid[i] == kv_valid[j] ? 0 : -0.7 * FLT_MAX)
//   m_i = max_j s, l_i = sum_j exp(s - m_i), lse_i = m_i + log(l_i)
//   o_i = (sum_j T(exp(s - m_i)) v_j) * (1 / l_i)      (T: v's type)
// and, with di_i = sum_d o * do (float32, computed outside, as jax does),
// p = exp(s - lse), dp = do . v, ds = ((dp - di) * p) * scale:
//   dv = sum_i T(p) do_i,  dk = sum_i T(ds) q_i,  dq = sum_j T(ds) k_j.
// Masking is additive and by segment equality, as in jax's kernel: a row
// whose validity matches no key attends to every key with the same large
// negative bias.  Keys past Tk and queries past Tq are not padding here:
// the kernels mask the ragged edges themselves (p = 0 there), so no
// caller pads T to a block multiple.
//
// Every kernel has four warps and owns 64 rows: 64 query rows (K4a, K4c)
// or 64 key rows (K4b); each warp owns 16 of them and walks the other
// sequence in tiles of BN rows, 32 in float32 and 64 in bf16 (32 in K4b
// and K4c above DP = 96 and in K4a at DP = 256; 16 in K4b and K4c in
// float32 at DP = 256).  All three are written for the H100 with mma.sync
// fragments, whose register layouts the PTX ISA documents, and float32
// accumulators.  float32 operands use the 3xTF32 split: x = hi + lo with
// hi and lo TF32 values, a.b = hi.hi + hi.lo + lo.hi, which keeps ~22 of
// float32's 24 bits (plain TF32 keeps 11, about three decimal digits,
// which would miss a float32 tolerance).  What the three share:
//   - scores never leave registers: a thread holds rows lane/4 and
//     lane/4 + 8 of each m16n8 accumulator tile, and a tile of scores
//     becomes the A operand of the next product directly (bf16: two n8
//     tiles repack as one k16 fragment; TF32: the A fragment holds
//     columns t and t + 4, the accumulator 2t and 2t + 1, so each k8 step
//     takes its streamed rows in the order 0, 2, 4, 6, 1, 3, 5, 7 and
//     reads the B operand's rows in that same order: the sum over k does
//     not depend on it);
//   - operands in shared memory are read by ldmatrix in bf16 (.trans
//     where a product contracts over the streamed rows) and by 32-bit
//     loads on a pitch of D + 4 floats in float32 (no bank conflicts,
//     read along rows or down columns), where each operand is split by
//     clearing the 13 low mantissa bits (hi, exactly a TF32 value) and
//     one subtraction (lo = x - hi, exact): no cvt in the loop;
//   - streamed tiles (and their per-row vectors) are copied by 16-byte
//     (4-byte) cp.async into a ring of two stages, so the next tile loads
//     while this one computes; rows past T are zero-filled by the
//     src-size form and their pairs masked to p = 0 exactly; D is padded
//     to DP (32, 64, 96, 128, 192 or 256) with zero columns.
//
// K4a (forward): one pass over the keys with the online softmax, as jax's
// multi-step kernel: per row a running max m and sum l (two quad
// shuffles each); at every key tile the O accumulator is rescaled by
// alpha = exp(m_old - m_new) in registers and gains T(exp(s - m_new)) . v;
// it is divided by l once at the end.  Up to DP = 128 Q is loaded once
// into registers (bf16 through ldmatrix); at DP = 192 and 256 it stays
// resident in shared memory and is re-read at every tile (FwdGeo::QRES);
// K and V stream.  With Q, S, P and O in registers, ptxas gives the
// D = 96 instances 238 registers a thread in float32 (two blocks an SM)
// and 168 in bf16 (three), with 51-54 KB of shared memory a block;
// capping float32 at three blocks an SM spills and ran slower on the
// H100.  Rounding points: s in float32; p = exp(s - m_new) rounded to
// v's type at the running max of its tile (flash_attention_reference with
// block_k = k4a_block_k(dtype, D) states exactly this); l summed from the
// unrounded p; lse = m + log l; o = acc * (1 / l) cast to q's type.
//
// K4c (dQ), 64 query rows a block: Q and dO of the block are staged once;
// K, V and kv_valid stream.  Per key tile, S = Q K^T and dP = dO V^T into
// accumulators, then p = exp(s - lse) and ds = ((dp - di) * p) * scale in
// place (lse, di and q_valid of the thread's two rows in registers), then
// dQ += T(ds) K, K read as the B operand the other way.  dQ is written
// from its accumulators.
//
// K4b (dK, dV), 64 key rows a block: K and V of the block are staged
// once; Q, dO and the tile's q_valid, lse and di stream.  Per query tile,
// S^T = K Q^T, p^T in place (each column's lse and q_valid from the
// stage), dV += T(p^T) dO, then dP^T = V dO^T, ds^T in place and dK +=
// T(ds^T) Q.  dK and dV stay in registers for the whole loop.  At DP = 192
// and 256 the two accumulators would not fit beside the score tiles: the
// launch's grid has two blocks for each 64 keys (z = 0 forms dV, z = 1
// dK), both of which form S^T (kDkvSplit).
//
// In both backward kernels the resident strips (Q/dO, K/V) are re-read
// from shared memory at every tile, not held in registers: with both
// strips, the D-wide accumulators and two score tiles in registers, the
// float32 instances at D = 96 would spill.  The rounding points are the
// plain versions': s, dp and di in float32; p and ds in float32, rounded
// to the operand type only as the A operand of their product.  Neither
// has atomics: K4b owns its keys and K4c its queries, so two runs give
// bit-identical gradients.
//
// What bounds them: at T = 1024, D = 96 the products (4, 8 and 6 T^2 D
// per head for K4a, K4b and K4c) dominate and only the tiles and the
// outputs touch device memory; in float32 the three TF32 products per
// step (165 TFLOP/s of float32 products at the TF32 peak) bound them, in
// bf16 the products and the exp per score; at D = 192 (K4b 10 T^2 D)
// likewise.  At D = 192 the shared memory a block (K4a 150.8 KB in
// float32 and 128.5 KB in bf16, K4b 201.5 and 103.2, K4c 201.0 and
// 102.7) leaves one block of four warps an SM, two for the bf16 backward
// instances, so little hides the latency of the shared-memory operands.
//
// D = 256 (multiples of 16 in (192, 256] are padded to it) takes the
// same three kernels at DP = 256, where each thread holds 128 float32
// accumulators (O, dQ, or dK or dV in a split K4b block).  What changed is
// the tiles: K4b and K4c stream 16 rows a tile in float32, whose two
// resident strips already take 130 KB, and K4a 32 keys a tile in bf16
// too.  Shared memory a block, from the geometry (flash_attn_smem;
// ops/kernels/flash_attn.py::k4_smem_bytes mirrors it): K4a 199,936 B in
// float32 and 101,632 in bf16, K4b 200,064 and 135,936, K4c 199,808 and
// 135,424, all under the 232,448 a block may have.  ptxas (sm_90a, CUDA
// 12.8), registers a thread, no spill in any: K4a 228 in float32 and 228
// in bf16, K4b 248 and 246, K4c 232 and 252.  With 64 keys a tile bf16
// K4a fits too (244 registers, no spill) but takes 169,472 B, one block
// an SM; at 32 two blocks fit an SM by shared memory and registers.  On
// the H100 at B=16, T=1024, H=2 in float32 they take about 0.80 (K4a),
// 2.43 (K4b) and 1.33 ms (K4c) against bounds of 0.18, 0.36 and 0.27 ms
// (chip_smoke.py).  These instances build in their own source,
// flash_attn_d256.cu, beside flash_attn.cu's, so that nvcc compiles them
// in parallel with the others; so do the bf16 instances of DP 32-192
// (flash_attn_bf16.cu), which took half of this source's build.
//
// D above 256 (jax's kernel takes every multiple of 128; here every
// multiple of 16 in (256, 1024]) takes three more kernels, the "wide"
// ones, padded to a multiple of 128 (DP 384 to 1024).  At DP = 384 the
// two float32 strips of 64 rows over all of D would take 198,656 B and a
// thread would hold 192 accumulators over all of D, so each wide kernel
// splits the output's columns over several blocks.
//
// K4a (flash_fwd_wide_kernel, flash_attn_wide.cu) keeps nothing resident
// and splits O's columns over the grid's z:
//   - a block owns 64 query rows and one chunk of DC = 256 columns of O,
//     128 accumulators a thread as at DP = 256; z has ceil(D / 256)
//     chunks;
//   - it forms each tile's scores over all of D in "chunk steps" of W
//     columns (64 in float32, 128 in bf16: 256 bytes a row), each of
//     which stages those columns of the block's 64 rows of Q and of the
//     tile's 32 keys; then one "out step" stages the tile's DC columns of
//     V and its kv_valid, and the step runs the online softmax and the
//     product as at DP <= 256.  Each step is one stage of a two-stage
//     cp.async ring, so the next step's columns load while this one
//     computes;
//   - every chunk of one row block repeats the same sums in the same order
//     over the same tiles, so its blocks reach the same scores, m, l and
//     lse bit for bit (the z = 0 block writes lse).
// Each chunk recomputes the scores (2 T^2 D a chunk beside the product's
// 2 over its DC columns), and the block's own rows are re-read from L2 at
// every tile.  66,816 B a block in float32, 52,480 in bf16, at every wide
// D; 238 and 241 registers a thread (ptxas, sm_90a), no spill.
//
// K4b and K4c (flash_dkv_cluster_kernel, flash_dq_cluster_kernel,
// flash_attn_wide_bwd.cu) form each tile's scores once, across a
// thread-block cluster (ClusterGeo, sum_ranks in flash_attn.cuh):
//   - a row block of 64 rows (keys in K4b, queries in K4c) is a cluster
//     of C = ceil(DP / 256) blocks along the grid's x (2 at DP 384 and
//     512, 3 at 640 and 768, 4 at 896 and 1024); block c owns a chunk of
//     DP / C output columns rounded up to 32 (the last the rest: 2 x 192
//     at DP 384, 2 x 256 at 512, 224 + 224 + 192 at 640);
//   - a block is 8 warps, two warpgroups over the same 64 rows (16 a
//     warp).  Its 64 rows of its columns of two operands stay resident in
//     shared memory for the whole pass, staged once (K4b: K, V; K4c: Q,
//     dO); tiles of BN rows (16 in float32, 32 in bf16) of its columns of
//     the other two (K4b: Q, dO; K4c: K, V) and the tile's vectors stream
//     through a two-stage cp.async ring;
//   - per tile, warpgroup 0 forms the partial S and warpgroup 1 the partial
//     dP over the block's columns only (tile_abt, mma.sync as at DP <=
//     256), and each stores it to a slot in shared memory (one of two, in
//     turn); after a cluster barrier every warp reads the C blocks' slots
//     of its rows through distributed shared memory (mapa,
//     ld.shared::cluster) and adds them in rank order 0 ... C - 1: every
//     block holds the same S and dP bit for bit, formed once, as if one
//     block had summed over all of D;
//   - then p and ds run as at DP <= 256, and K4b's warpgroup 0 forms
//     dV_c += T(p^T) dO_c and warpgroup 1 dK_c += T(ds^T) Q_c (128
//     accumulators a thread, as at DP = 256), K4c's warpgroups each half
//     of dQ_c += T(ds) K_c's columns (64 a thread).  A block waits at a
//     last cluster barrier before it leaves, so that no slot it owns is
//     read after it has gone.
// Work, per head: K4b 8 T^2 D and K4c 6 T^2 D, the function's own (the
// earlier wide backward, built as K4a is, a chunk of 256 columns a block
// over the grid's z with every chunk forming the scores again, did K4b 16
// and K4c 10 at D = 512, 12 and 8 at 384).  Bytes into shared memory:
// each column of the streamed operands once per row block (T x D x 2
// values) and the resident rows once; at B = 16, T = 1024, D = 512 in
// float32 about 1.07 GB for each kernel (the earlier design: ~16 GB for
// K4b, ~11 GB for K4c, the block's own rows re-staged at every 16-row
// tile).  Exchanged through the cluster, per row block
// and tile: (C - 1) remote reads of each block's S part, and of its dP
// part in K4b's warpgroup 1 and in K4c, 64 x BN x 4 B each: at D = 384
// and 512 (C = 2) ~0.40 GB for K4b and ~0.54 GB for K4c in float32.
// Shared memory a block (flash_attn_smem; ops/kernels/flash_attn.py::
// k4_smem_bytes mirrors it), at every wide D: K4b 216,448 B in float32
// and 168,704 in bf16, K4c 216,192 and 168,192: one block of 8 warps an
// SM.  ptxas (sm_90a), registers a thread, no spill: K4b 228 in float32
// and 252 in bf16, K4c 159 and 168 (cudaFuncGetAttributes reports the
// same and 0 bytes of local memory; chip_smoke.py checks it).  Float32
// products stay 3xTF32 on mma.sync, whose fragments come from registers:
// wgmma reads its B operand (and here A, the resident strip) from shared
// memory, so the hi and lo halves of both would have to be stored there,
// twice the strips, which do not fit beside the float32 stages.  No
// atomics: each block owns its columns and every block holds the same
// sums, so two runs give bit-identical gradients.
// On an NVIDIA H100 80GB HBM3 at 700 W, B=16, T=1024, H=1, float32
// (chip_smoke.py's K4 phase; PERF.md): K4b 2.15-2.19 and K4c 1.74-1.79 ms
// at D = 384, 2.52-2.62 and 2.06-2.09 at 512, against 3.70-3.88 and
// 2.27-2.42, 5.05-5.18 and 3.32-3.38 in the earlier design; SDPA's
// backward takes 2.10-2.15 and 2.65-2.70.  With the exchange cut out of a
// copy (tools/k4_wide_exchange_cost.py, timing only) they take 1.86 and
// 1.43 at 384: the block's compute, mma.sync 3xTF32 at about a seventh of
// its bound with one block of 8 warps an SM, is most of the time, the
// barrier ~0.15 ms and the loads ~0.13-0.2 the rest.  A cluster of
// 128-column blocks of 4 warps (3 and 4 blocks at 384 and 512) formed the
// same sums and was faster at 384 (3.66 ms for both) but slower at 512
// (5.27), its exchange growing as C(C - 1).
//
// Left for later: wgmma with TMA and warp specialisation, skipping tiles
// that lie wholly outside a sequence, a cluster sharing the wide K4a's
// scores, D above 1024.
#include "flash_attn.cuh"

namespace ptk {
namespace {

constexpr int kMaxD = 1024;             // the widest head K4 takes

// D rounded up to the instance that takes it: to 32 up to 128, then 192
// or 256, then to 128 (zero columns pad it; the wide instances take any
// D and zero-fill their chunks past it)
int padded_dim(int D) {
  return D <= 128 ? (D + 31) / 32 * 32
                  : D <= 192 ? 192 : D <= 256 ? 256 : (D + 127) / 128 * 128;
}

bool bad_args(int B, int H, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D < 16 ||
         D % 16 != 0 || D > kMaxD || static_cast<long long>(B) * H > 65535;
}

// Call F<float, DP>(...) for D's padded width, FB(DP, ...) for bf16
// (flash_attn_bf16.cu), F256(is_bf16, ...) at DP = 256
// (flash_attn_d256.cu), or FW(is_bf16, ...) above it (flash_attn_wide.cu).
#define PTK_FLASH_DISPATCH(F, FB, F256, FW, is_bf16, D, ...)          \
  do {                                                                \
    const int dp_ = padded_dim(D);                                    \
    if (dp_ > 256)                                                    \
      return static_cast<int>(FW(is_bf16 != 0, __VA_ARGS__));         \
    if (dp_ == 256)                                                   \
      return static_cast<int>(F256(is_bf16 != 0, __VA_ARGS__));       \
    if (is_bf16) return static_cast<int>(FB(dp_, __VA_ARGS__));       \
    switch (dp_) {                                                    \
      case 32: return static_cast<int>(F<float, 32>(__VA_ARGS__));    \
      case 64: return static_cast<int>(F<float, 64>(__VA_ARGS__));    \
      case 96: return static_cast<int>(F<float, 96>(__VA_ARGS__));    \
      case 128: return static_cast<int>(F<float, 128>(__VA_ARGS__));  \
      case 192: return static_cast<int>(F<float, 192>(__VA_ARGS__));  \
    }                                                                 \
    return -1;                                                        \
  } while (0)

// Dynamic shared memory of one kernel's block (0 K4a, 1 K4b, 2 K4c) at
// the padded width DP
template <typename T, int DP>
long long smem_of(int kernel) {
  switch (kernel) {
    case 0: return static_cast<long long>(FwdGeo<T, DP>::kSmem);
    case 1: return static_cast<long long>(BwdGeo<T, DP, 3>::kSmem);
    case 2: return static_cast<long long>(BwdGeo<T, DP, 1>::kSmem);
  }
  return -1;
}

// ... and of the wide instances (any D above 256)
template <typename T>
long long smem_wide(int kernel) {
  switch (kernel) {
    case 0: return static_cast<long long>(WideGeo<T>::kSmem);
    case 1: return static_cast<long long>(ClusterGeo<T, 3>::kSmem);
    case 2: return static_cast<long long>(ClusterGeo<T, 1>::kSmem);
  }
  return -1;
}

}  // namespace
}  // namespace ptk

// Tensors are contiguous: q, o, do (B, H, Tq, D); k, v (B, H, Tk, D);
// q_valid (B, Tq) and kv_valid (B, Tk) int32; lse and di (B, H, Tq)
// float32; all of q's type (bf16 when is_bf16, else float32) but lse, di
// and the validities.  D is a multiple of 16 in [16, 1024].
// Returns 0, -1 for arguments the kernels do not take, or a CUDA error
// code.

// K4a: o and lse.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* q_valid, const void* kv_valid,
                              void* o, void* lse, int B, int H, int Tq,
                              int Tk, int D, int is_bf16, float scale,
                              void* stream) {
  using namespace ptk;
  if (bad_args(B, H, Tq, Tk, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTK_FLASH_DISPATCH(fwd, fwd_bf16, fwd_d256, fwd_wide, is_bf16, D, q, k, v,
                     q_valid, kv_valid, o, lse, B, H, Tq, Tk, D, scale, s);
}

// K4b: dk and dv.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* q_valid,
                                  const void* kv_valid, const void* dout,
                                  const void* lse, const void* di, void* dk,
                                  void* dv, int B, int H, int Tq, int Tk,
                                  int D, int is_bf16, float scale,
                                  void* stream) {
  using namespace ptk;
  if (bad_args(B, H, Tq, Tk, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTK_FLASH_DISPATCH(dkv, dkv_bf16, dkv_d256, dkv_wide, is_bf16, D, q, k, v,
                     q_valid, kv_valid, dout, lse, di, dk, dv, B, H, Tq, Tk,
                     D, scale, s);
}

// K4c: dq.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* q_valid, const void* kv_valid,
                                 const void* dout, const void* lse,
                                 const void* di, void* dq, int B, int H,
                                 int Tq, int Tk, int D, int is_bf16,
                                 float scale, void* stream) {
  using namespace ptk;
  if (bad_args(B, H, Tq, Tk, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTK_FLASH_DISPATCH(ptk::dq, dq_bf16, dq_d256, dq_wide, is_bf16, D, q, k, v,
                     q_valid, kv_valid, dout, lse, di, dq, B, H, Tq, Tk, D,
                     scale, s);
}

// Dynamic shared memory bytes of a block of K4a (kernel 0), K4b (1) or
// K4c (2) at head width D (the launcher's Python mirror, k4_smem_bytes, is
// held against it), or -1 for a width or kernel the kernels do not take.
extern "C" long long flash_attn_smem(int kernel, int is_bf16, int D) {
  using namespace ptk;
  if (bad_args(1, 1, 1, 1, D)) return -1;
  const int dp = padded_dim(D);
  if (dp > 256) return is_bf16 ? smem_wide<bf16>(kernel)
                               : smem_wide<float>(kernel);
  switch (dp * 2 + (is_bf16 != 0)) {
#define PTK_FLASH_SMEM(DP)                                      \
    case 2 * DP: return smem_of<float, DP>(kernel);             \
    case 2 * DP + 1: return smem_of<bf16, DP>(kernel);
    PTK_FLASH_SMEM(32) PTK_FLASH_SMEM(64) PTK_FLASH_SMEM(96)
    PTK_FLASH_SMEM(128) PTK_FLASH_SMEM(192) PTK_FLASH_SMEM(256)
#undef PTK_FLASH_SMEM
  }
  return -1;
}

// The registers a thread (regs) and local memory bytes (local, spills
// included) of the wide K4b (kernel 1) or K4c (2) instance; returns 0 or
// a CUDA error code (-1 for another kernel).
extern "C" int flash_attn_wide_bwd_attrs(int kernel, int is_bf16, int* regs,
                                         long long* local) {
  using namespace ptk;
  if (kernel != 1 && kernel != 2) return -1;
  cudaFuncAttributes attr;
  const cudaError_t err = wide_bwd_attrs(is_bf16 != 0, kernel, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local = static_cast<long long>(attr.localSizeBytes);
  return 0;
}
