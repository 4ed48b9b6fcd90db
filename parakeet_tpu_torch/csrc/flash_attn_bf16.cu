// Kernel K4 in bf16 at DP = 32, 64, 96, 128 and 192: the bf16 instances of
// flash_fwd_kernel (K4a), flash_dkv_kernel (K4b) and flash_dq_kernel (K4c),
// built in a source of their own so that nvcc compiles them in parallel
// with flash_attn.cu's float32 ones.  Their design and figures are in
// flash_attn.cu's header comment; flash_attn.cu's dispatch calls these
// three functions.
#include "flash_attn.cuh"

namespace ptk {

#define PTK_FLASH_BF16(F, dp, ...)                       \
  switch (dp) {                                          \
    case 32: return F<bf16, 32>(__VA_ARGS__);            \
    case 64: return F<bf16, 64>(__VA_ARGS__);            \
    case 96: return F<bf16, 96>(__VA_ARGS__);            \
    case 128: return F<bf16, 128>(__VA_ARGS__);          \
    case 192: return F<bf16, 192>(__VA_ARGS__);          \
  }                                                      \
  return cudaErrorInvalidValue

cudaError_t fwd_bf16(int dp, const void* q, const void* k, const void* v,
                     const void* qv, const void* kv, void* o, void* lse,
                     int B, int H, int Tq, int Tk, int D, float scale,
                     cudaStream_t s) {
  PTK_FLASH_BF16(fwd, dp, q, k, v, qv, kv, o, lse, B, H, Tq, Tk, D, scale,
                 s);
}

cudaError_t dkv_bf16(int dp, const void* q, const void* k, const void* v,
                     const void* qv, const void* kv, const void* dout,
                     const void* lse, const void* di, void* dk, void* dv,
                     int B, int H, int Tq, int Tk, int D, float scale,
                     cudaStream_t s) {
  PTK_FLASH_BF16(dkv, dp, q, k, v, qv, kv, dout, lse, di, dk, dv, B, H, Tq,
                 Tk, D, scale, s);
}

cudaError_t dq_bf16(int dp, const void* q, const void* k, const void* v,
                    const void* qv, const void* kv, const void* dout,
                    const void* lse, const void* di, void* dq_, int B, int H,
                    int Tq, int Tk, int D, float scale, cudaStream_t s) {
  PTK_FLASH_BF16(dq, dp, q, k, v, qv, kv, dout, lse, di, dq_, B, H, Tq, Tk,
                 D, scale, s);
}

#undef PTK_FLASH_BF16

}  // namespace ptk
