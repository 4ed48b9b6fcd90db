// Kernel K4 at DP = 256: the float32 and bf16 instances of
// flash_fwd_kernel (K4a), flash_dkv_kernel (K4b) and flash_dq_kernel
// (K4c) for head widths in (192, 256], built in a source of their own so
// that nvcc compiles them in parallel with flash_attn.cu's.  Their design
// and figures are in flash_attn.cu's header comment; flash_attn.cu's
// dispatch calls these three functions.
#include "flash_attn.cuh"

namespace ptk {

cudaError_t fwd_d256(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv, void* o,
                     void* lse, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s) {
  return bf16 ? fwd<__nv_bfloat16, 256>(q, k, v, qv, kv, o, lse, B, H, Tq,
                                        Tk, D, scale, s)
              : fwd<float, 256>(q, k, v, qv, kv, o, lse, B, H, Tq, Tk, D,
                                scale, s);
}

cudaError_t dkv_d256(bool bf16, const void* q, const void* k,
                     const void* v, const void* qv, const void* kv,
                     const void* dout, const void* lse, const void* di,
                     void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                     float scale, cudaStream_t s) {
  return bf16 ? dkv<__nv_bfloat16, 256>(q, k, v, qv, kv, dout, lse, di, dk,
                                        dv, B, H, Tq, Tk, D, scale, s)
              : dkv<float, 256>(q, k, v, qv, kv, dout, lse, di, dk, dv, B,
                                H, Tq, Tk, D, scale, s);
}

cudaError_t dq_d256(bool bf16, const void* q, const void* k, const void* v,
                    const void* qv, const void* kv, const void* dout,
                    const void* lse, const void* di, void* dq_, int B, int H,
                    int Tq, int Tk, int D, float scale, cudaStream_t s) {
  return bf16 ? dq<__nv_bfloat16, 256>(q, k, v, qv, kv, dout, lse, di, dq_,
                                       B, H, Tq, Tk, D, scale, s)
              : dq<float, 256>(q, k, v, qv, kv, dout, lse, di, dq_, B, H,
                               Tq, Tk, D, scale, s);
}

}  // namespace ptk
