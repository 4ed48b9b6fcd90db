// Kernel K4's forward above head width 256: the float32 and bf16
// instances of flash_fwd_wide_kernel (K4a) for head widths in (256, 1024],
// built in a source of their own so that nvcc compiles them in parallel
// with the others (the backward's are in flash_attn_wide_bwd.cu).  Their
// design and figures are in flash_attn.cu's header comment; flash_attn.cu's
// dispatch calls fwd_wide.
#include "flash_attn.cuh"

namespace ptk {

cudaError_t fwd_wide(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv, void* o,
                     void* lse, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s) {
  return bf16 ? fwd_w<__nv_bfloat16>(q, k, v, qv, kv, o, lse, B, H, Tq, Tk,
                                     D, scale, s)
              : fwd_w<float>(q, k, v, qv, kv, o, lse, B, H, Tq, Tk, D, scale,
                             s);
}

}  // namespace ptk
