// Helpers shared by the port's CUDA kernels (pwg_stack.cu,
// pwg_stack_bwd.cu, pwg_disc.cu, flash_attn.cu).  Header-only: every
// translation unit gets its own copy, so the sources build independently
// and in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

// Everything here has internal linkage (an unnamed namespace), so that
// each source's copy, kernels included, links beside the others'.
namespace ptk {
namespace {

// wmma fragments of the bf16 16x16x16 products with float32 accumulators;
// FragAt reads a row-major tile as its transpose (the row contractions
// of the weight gradients).
using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using FragAt = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                      __nv_bfloat16, nvcuda::wmma::col_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

// Global loads are issued in batches of BATCH into registers before any of
// them is used, so that a thread waits for one round trip per batch and
// not one per element.
constexpr int BATCH = 8;

// Copy a (rows, cols) bf16 row-major matrix (cols % 8 == 0, 16-byte
// aligned rows) into shared rows of pitch ldd elements (ldd % 8 == 0).
template <int THREADS>
__device__ void stage_rows(__nv_bfloat16* dst,
                           const __nv_bfloat16* __restrict__ src, int rows,
                           int cols, int ldd) {
  const int vpr = cols / 8;                 // 16-byte vectors per row
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const int n = rows * vpr;
  for (int base = threadIdx.x; base < n; base += BATCH * THREADS) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * THREADS;
      if (i < n) v[k] = s[i];
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * THREADS;
      if (i < n)
        *reinterpret_cast<uint4*>(dst + (i / vpr) * ldd + (i % vpr) * 8) =
            v[k];
    }
  }
}

// Rows are the flattened (b, t) of items of T steps: row q is (q / T,
// q % T).  Fill `nrows` shared rows of pitch `ld` (ld % 8 == 0), from
// column col0 (a multiple of 8) on, with W bf16 columns (W % 8 == 0) of
// row q + off of `src`, for q = q0, q0 + 1, ...; zero where q >= qend or
// where t + off leaves [0, T) (the shifted taps of a dilated conv).
template <int W, int THREADS>
__device__ void load_rows(__nv_bfloat16* dst, int ld, int col0,
                          const __nv_bfloat16* __restrict__ src, int q0,
                          int nrows, int qend, int T, int off) {
  constexpr int V = W / 8;                 // 16-byte vectors per row
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const int n = nrows * V;
  for (int base = threadIdx.x; base < n; base += BATCH * THREADS) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * THREADS;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      const int q = q0 + i / V;
      if (i < n && q < qend) {
        const int ts = q % T + off;
        if (ts >= 0 && ts < T)
          v[k] = s[static_cast<size_t>(q + off) * V + i % V];
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = base + k * THREADS;
      if (i < n)
        *reinterpret_cast<uint4*>(dst + (i / V) * ld + col0 + (i % V) * 8) =
            v[k];
    }
  }
}

__device__ __forceinline__ uint2 pack4(float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 out;
  out.x = *reinterpret_cast<uint32_t*>(&lo);
  out.y = *reinterpret_cast<uint32_t*>(&hi);
  return out;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tanh(a) = 1 - 2 / (e^2a + 1), sigmoid(b) = 1 - 1 / (e^b + 1), with the
// fast exponential and division (the limits at +-inf are exact).  The
// residual stack's forward and backward both use these, so the backward
// rebuilds exactly the gate the forward computed.
__device__ __forceinline__ float fast_tanh(float a) {
  return 1.f - __fdividef(2.f, __expf(2.f * a) + 1.f);
}
__device__ __forceinline__ float fast_sigmoid(float b) {
  return 1.f - __fdividef(1.f, __expf(b) + 1.f);
}

// out[i] = sum over p of part[p * n + i], in the order p = 0, 1, ...: the
// second pass of the kernels' weight gradients.  Blocks write partial
// sums and this kernel adds them up in a fixed order, so two runs give
// bit-identical gradients (float atomics would not).
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int nparts,
                                       long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < nparts; ++p) acc += part[p * n + i];
    out[i] = acc;
  }
}

inline cudaError_t reduce_partials(const float* part, float* out,
                                   int nparts, long long n,
                                   cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  reduce_partials_kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(
      part, out, nparts, n);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// mma.sync, ldmatrix and cp.async as inline PTX (sm_80 and later), shared
// by flash_attn.cu and pwg_stack_bwd.cu.  An m16n8 accumulator tile holds,
// in lane l (g = l / 4, t = l % 4), columns 2t and 2t + 1 of rows g and
// g + 8; the PTX ISA documents the operand fragments.

// c += a . b, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 16 (or 4) bytes from global to shared, zero-filled when !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace
}  // namespace ptk
