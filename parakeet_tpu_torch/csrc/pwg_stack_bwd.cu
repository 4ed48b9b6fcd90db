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
//
// At residual width 128 the weights outgrow a block's shared memory; the
// passes split their columns over the grid's y (pwg_stack_bwd.cuh) and
// those instances build in pwg_stack_bwd_cr128.cu.
// Left for later: wgmma with TMA, forming dc once per group.

#include "pwg_stack_bwd.cuh"

namespace {

using ptk::AW_MAX;
using ptk::THREADS;
using bf16 = __nv_bfloat16;

bool bad_width(int CR) { return CR != 32 && CR != 64 && CR != 128; }

bool bad_shape(int B, int T, int CR, int CA, int KP) {
  if (B <= 0 || T <= 0 || CA <= 0) return true;
  if (static_cast<long long>(B) * T > (1LL << 30)) return true;
  if (bad_width(CR)) return true;
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
  if (B <= 0 || T <= 0 || bad_width(CR)) return -1;
  if (static_cast<long long>(B) * T > (1LL << 30)) return -1;
  const int R = B * T;
  if (bad_chunks(R, nparts, chunk_rows)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      CR == 32   ? ptk::launch_prep<32>(dskip, dsk16, sk_part, R, nparts,
                                        chunk_rows, s)
      : CR == 64 ? ptk::launch_prep<64>(dskip, dsk16, sk_part, R, nparts,
                                        chunk_rows, s)
                 : ptk::k2b_prep_cr128(dskip, dsk16, sk_part, R, nparts,
                                       chunk_rows, s);
  return static_cast<int>(err);
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
  const cudaError_t err =
      CR == 32 ? ptk::launch_gate<32>(saved, c, wg, wso, dxo, dsk16, sk_part,
                                      dg, part, R, T, CA, CW, KP, d, nparts,
                                      chunk_rows, part_stride, s)
      : CR == 64
          ? ptk::launch_gate<64>(saved, c, wg, wso, dxo, dsk16, sk_part, dg,
                                 part, R, T, CA, CW, KP, d, nparts,
                                 chunk_rows, part_stride, s)
          : ptk::k2b_gate_cr128(saved, c, wg, wso, dxo, dsk16, sk_part, dg,
                                part, R, T, CA, CW, KP, d, nparts,
                                chunk_rows, part_stride, s);
  return static_cast<int>(err);
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
  const cudaError_t err =
      CR == 32   ? ptk::launch_dw<32>(saved, c, dg, part, R, T, CA, CW, KP,
                                      d, nparts, chunk_rows, part_stride, s)
      : CR == 64 ? ptk::launch_dw<64>(saved, c, dg, part, R, T, CA, CW, KP,
                                      d, nparts, chunk_rows, part_stride, s)
                 : ptk::k2b_dw_cr128(saved, c, dg, part, R, T, CA, CW, KP,
                                     d, nparts, chunk_rows, part_stride, s);
  return static_cast<int>(err);
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
  if (bad_width(CR)) return -1;
  if (CAP % 16 != 0 || CAP < CA || CAP > AW_MAX) return -1;
  const int R = B * T;
  if (bad_chunks(R, nparts, chunk_rows)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      CR == 32   ? ptk::launch_dx<32>(dg, wdx, wdc, dxo, dx, dc, R, T, CA,
                                      CAP, d, dc_init, nparts, chunk_rows, s)
      : CR == 64 ? ptk::launch_dx<64>(dg, wdx, wdc, dxo, dx, dc, R, T, CA,
                                      CAP, d, dc_init, nparts, chunk_rows, s)
                 : ptk::k2b_dx_cr128(dg, wdx, wdc, dxo, dx, dc, R, T, CA,
                                     CAP, d, dc_init, nparts, chunk_rows, s);
  return static_cast<int>(err);
}

// Dynamic shared memory bytes of K2b's kernel `which` (0 gate, 1 dw, 2 dx)
// at these widths; the launcher's Python mirror is held against it.
extern "C" long long pwg_stack_bwd_smem(int which, int CR, int KP, int CAP) {
  if (bad_width(CR)) return -1;
  if (which == 0) return sizeof(bf16) * ptk::gate_elems(CR, KP);
  if (which == 1) return sizeof(bf16) * ptk::dw_elems(CR, KP);
  if (which == 2) return sizeof(bf16) * ptk::dx_elems(CR, CAP);
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
