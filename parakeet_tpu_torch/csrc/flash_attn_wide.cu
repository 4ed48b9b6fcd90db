// Kernel K4 above head width 256: the float32 and bf16 instances of
// flash_fwd_wide_kernel (K4a), flash_dkv_wide_kernel (K4b) and
// flash_dq_wide_kernel (K4c) for head widths in (256, 640], built in a
// source of their own so that nvcc compiles them in parallel with the
// others.  Their design and figures are in flash_attn.cu's header
// comment; flash_attn.cu's dispatch calls these three functions.
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

cudaError_t dkv_wide(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv,
                     const void* dout, const void* lse, const void* di,
                     void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s) {
  return bf16 ? dkv_w<__nv_bfloat16>(q, k, v, qv, kv, dout, lse, di, dk, dv,
                                     B, H, Tq, Tk, D, scale, s)
              : dkv_w<float>(q, k, v, qv, kv, dout, lse, di, dk, dv, B, H,
                             Tq, Tk, D, scale, s);
}

cudaError_t dq_wide(bool bf16, const void* q, const void* k, const void* v,
                    const void* qv, const void* kv, const void* dout,
                    const void* lse, const void* di, void* dq_, int B, int H,
                    int Tq, int Tk, int D, float scale, cudaStream_t s) {
  return bf16 ? dq_w<__nv_bfloat16>(q, k, v, qv, kv, dout, lse, di, dq_, B,
                                    H, Tq, Tk, D, scale, s)
              : dq_w<float>(q, k, v, qv, kv, dout, lse, di, dq_, B, H, Tq,
                            Tk, D, scale, s);
}

}  // namespace ptk
