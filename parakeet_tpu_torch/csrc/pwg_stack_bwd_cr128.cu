// Kernel K2b at residual width 128: the CR = 128 instances of
// k2b_prep_kernel, k2b_gate_kernel, k2b_dw_kernel and k2b_dx_kernel, built
// in a source of their own so that nvcc compiles them in parallel with
// pwg_stack_bwd.cu's.  How their passes split a chunk's columns over the
// grid's y is in pwg_stack_bwd.cuh; pwg_stack_bwd.cu's C interface calls
// these four functions.
#include "pwg_stack_bwd.cuh"

namespace ptk {

cudaError_t k2b_prep_cr128(const void* dskip, void* dsk16, void* sk_part,
                           int R, int nparts, int chunk_rows,
                           cudaStream_t s) {
  return launch_prep<128>(dskip, dsk16, sk_part, R, nparts, chunk_rows, s);
}

cudaError_t k2b_gate_cr128(const void* saved, const void* c, const void* wg,
                           const void* wso, const void* dxo,
                           const void* dsk16, const void* sk_part, void* dg,
                           void* part, int R, int T, int CA, int CW, int KP,
                           int d, int nparts, int chunk_rows,
                           long long part_stride, cudaStream_t s) {
  return launch_gate<128>(saved, c, wg, wso, dxo, dsk16, sk_part, dg, part,
                          R, T, CA, CW, KP, d, nparts, chunk_rows,
                          part_stride, s);
}

cudaError_t k2b_dw_cr128(const void* saved, const void* c, const void* dg,
                         void* part, int R, int T, int CA, int CW, int KP,
                         int d, int nparts, int chunk_rows,
                         long long part_stride, cudaStream_t s) {
  return launch_dw<128>(saved, c, dg, part, R, T, CA, CW, KP, d, nparts,
                        chunk_rows, part_stride, s);
}

cudaError_t k2b_dx_cr128(const void* dg, const void* wdx, const void* wdc,
                         const void* dxo, void* dx, void* dc, int R, int T,
                         int CA, int CAP, int d, int dc_init, int nparts,
                         int chunk_rows, cudaStream_t s) {
  return launch_dx<128>(dg, wdx, wdc, dxo, dx, dc, R, T, CA, CAP, d, dc_init,
                        nparts, chunk_rows, s);
}

}  // namespace ptk
