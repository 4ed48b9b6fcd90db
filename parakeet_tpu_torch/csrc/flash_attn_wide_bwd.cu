// Kernel K4's backward passes above head width 256: flash_dkv_cluster_kernel
// (K4b: dK, dV) and flash_dq_cluster_kernel (K4c: dQ), float32 and bf16,
// for head widths in (256, 1024], launched as thread-block clusters.  They
// replace the Pallas TPU kernel's _flash_attention_dkv_kernel and
// _flash_attention_dq_kernel (jax's pallas/ops/tpu/flash_attention.py:796
// and :1146, behind parakeet_tpu/nn/flash.py:88) at those widths.  The
// design and its figures are in flash_attn.cu's header comment; the
// geometry (ClusterGeo) and the exchange of partial scores (sum_ranks)
// are in flash_attn.cuh; flash_attn.cu's dispatch calls dkv_wide and
// dq_wide.
//
// In outline: a row block of 64 rows (keys in K4b, queries in K4c) is one
// cluster of C = ceil(DP / 256) blocks along the grid's x, block c owning
// a chunk of at most 256 output columns, of 8 warps: two warpgroups over
// the same 64 rows, 16 a warp.  Its 64 rows of its columns of two
// operands stay resident; tiles of its columns of the other two stream.
// At every tile one warpgroup forms the partial S over the block's
// columns and the other the partial dP (tile_abt), the cluster adds the C
// partials in rank order through distributed shared memory (sum_ranks),
// and then K4b's first warpgroup forms dV_c and its second dK_c, and
// K4c's two warpgroups each half of dQ_c's columns, as flash_dkv_kernel
// and flash_dq_kernel do at DP <= 256.
#include "flash_attn.cuh"

namespace ptk {
namespace {

// The columns a block of a cluster computes: its chunk [c0, c0 + chunk),
// cut at D rounded up to 32 (the zero columns up to there are loaded and
// add nothing)
__device__ __forceinline__ int chunk_cols(int chunk, int c0, int D) {
  return min(chunk, (D - c0 + 31) / 32 * 32);
}

// K4c: 64 queries a cluster; Q and dO of the block's columns resident; K,
// V (its columns) and kv_valid stream.  Warpgroup 0 forms the partial S,
// 1 the partial dP; each then forms half of dQ_c's columns.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1)
flash_dq_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ qvalid,
                        const int* __restrict__ kvalid,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int H, int Tq, int Tk, int D, int chunk,
                        float scale) {
  using G = ClusterGeo<T, 1>;
  constexpr int BN = G::BN, LD = G::LD, W = G::W, NT = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + G::kRows);
  auto stage = [&](int s) { return smem + 2 * G::kRows + s * G::kStage; };
  auto ktile = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto vtile = [&](int s) {
    return reinterpret_cast<T*>(stage(s) + G::kTile);
  };
  auto kvtile = [&](int s) {
    return reinterpret_cast<int*>(stage(s) + 2 * G::kTile);
  };
  auto slot = [&](int s) {
    return reinterpret_cast<float4*>(smem + 2 * G::kRows + 2 * G::kStage +
                                     s * G::kSlot);
  };

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int wg = warp >> 2, rw = warp & 3;     // warpgroup, row warp
  const int nrank = gridDim.x, c0 = blockIdx.x * chunk;  // a cluster is x
  const int cw = chunk_cols(chunk, c0, D), half = cw / 2, h0 = wg * half;
  const int bh = blockIdx.z, b = bh / H;
  const int q0 = blockIdx.y * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const int* kvb = kvalid + static_cast<size_t>(b) * Tk;
  const int ntiles = (Tk + BN - 1) / BN;

  auto issue_tile = [&](int tile, int s) {
    const int k0 = tile * BN;
    load_cols_async<T, LD>(ktile(s), k + koff, k0, BN, Tk, D, c0, cw);
    load_cols_async<T, LD>(vtile(s), v + koff, k0, BN, Tk, D, c0, cw);
    load_vec_async<BN>(kvtile(s), kvb, k0, Tk);
  };

  // Q and dO go with tile 0, then tile 1: one commit group per tile
  // (possibly empty), so that wait_group<1> at the top of step i means
  // tile i has landed
  load_cols_async<T, LD>(qs, q + qoff, q0, BM, Tq, D, c0, cw);
  load_cols_async<T, LD>(dos, dout + qoff, q0, BM, Tq, D, c0, cw);
  issue_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) issue_tile(1, 1);
  cp_async_commit();

  // the statistics of the thread's rows row0 and row0 + 8
  const int row0 = q0 + rw * 16 + g;
  bool in[2];
  int qv[2];
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    in[r] = row < Tq;
    const size_t i = static_cast<size_t>(bh) * Tq + row;
    qv[r] = in[r] ? qvalid[static_cast<size_t>(b) * Tq + row] : 0;
    lse_r[r] = in[r] ? lse[i] : 0.f;
    di_r[r] = in[r] ? di[i] : 0.f;
  }
  float dqacc[W / 16][4];                 // columns [c0 + h0, + half)
  zero_acc(dqacc);
  const T* own = (wg == 0 ? qs : dos) + rw * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();                     // tile it is in stage it % 2
    const int s = it & 1, k0 = it * BN;
    // the partial S = Q_c K_c^T (warpgroup 0) or dP = dO_c V_c^T (1) over
    // this block's columns, then both over all of D
    float sacc[NT][4], dpacc[NT][4];
    tile_abt<T, W, BN, LD>(sacc, own, wg == 0 ? ktile(s) : vtile(s), cw);
    store_part(slot_part<NT>(slot(s), wg, rw), sacc);
    cluster_sync();
    sum_ranks<true>(sacc, slot_part<NT>(slot(s), 0, rw), dpacc,
                    slot_part<NT>(slot(s), 1, rw), nrank);
    dq_ds(sacc, dpacc, kvtile(s), k0, Tk, scale, in, qv, lse_r, di_r);
    // dQ_c's columns [h0, h0 + half) += T(dS) K_c's
    tile_xb<T, W / 2, BN, LD>(dqacc, sacc, ktile(s) + h0, half);
    __syncthreads();                     // every warp is done with stage s
    if (it + 2 < ntiles) issue_tile(it + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  cluster_sync();                        // no block leaves while another
                                         // may still read its slots
  store_acc<T>(dq + qoff + c0 + h0, dqacc, row0, Tq, D,
               min(half, D - c0 - h0));
}

// K4b: 64 keys a cluster; K and V of the block's columns resident; Q, dO
// (its columns) and q_valid | lse | di of the tile's queries stream.
// Warpgroup 0 forms the partial S^T and then dV_c, 1 the partial dP^T and
// then dK_c.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1)
flash_dkv_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ qvalid,
                         const int* __restrict__ kvalid,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tq, int Tk, int D,
                         int chunk, float scale) {
  using G = ClusterGeo<T, 3>;
  constexpr int BN = G::BN, LD = G::LD, W = G::W, NT = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + G::kRows);
  auto stage = [&](int s) { return smem + 2 * G::kRows + s * G::kStage; };
  auto qtile = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto dotile = [&](int s) {
    return reinterpret_cast<T*>(stage(s) + G::kTile);
  };
  // q_valid | lse | di of the tile's queries
  auto vec = [&](int s, int i) {
    return stage(s) + 2 * G::kTile + i * BN * sizeof(float);
  };
  auto slot = [&](int s) {
    return reinterpret_cast<float4*>(smem + 2 * G::kRows + 2 * G::kStage +
                                     s * G::kSlot);
  };

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int wg = warp >> 2, rw = warp & 3;     // warpgroup, row warp
  const int nrank = gridDim.x, c0 = blockIdx.x * chunk;  // a cluster is x
  const int cw = chunk_cols(chunk, c0, D);
  const int bh = blockIdx.z, b = bh / H;
  const int k0 = blockIdx.y * BM;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const int* qvb = qvalid + static_cast<size_t>(b) * Tq;
  const float* lseb = lse + static_cast<size_t>(bh) * Tq;
  const float* dib = di + static_cast<size_t>(bh) * Tq;
  const int ntiles = (Tq + BN - 1) / BN;

  auto issue_tile = [&](int tile, int s) {
    const int i0 = tile * BN;
    load_cols_async<T, LD>(qtile(s), q + qoff, i0, BN, Tq, D, c0, cw);
    load_cols_async<T, LD>(dotile(s), dout + qoff, i0, BN, Tq, D, c0, cw);
    load_vec_async<BN>(vec(s, 0), qvb, i0, Tq);
    load_vec_async<BN>(vec(s, 1), lseb, i0, Tq);
    load_vec_async<BN>(vec(s, 2), dib, i0, Tq);
  };

  // K and V go with tile 0, then tile 1 (one commit group per tile)
  load_cols_async<T, LD>(ks, k + koff, k0, BM, Tk, D, c0, cw);
  load_cols_async<T, LD>(vs, v + koff, k0, BM, Tk, D, c0, cw);
  issue_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) issue_tile(1, 1);
  cp_async_commit();

  // the validity of the thread's keys krow0 and krow0 + 8
  const int krow0 = k0 + rw * 16 + g;
  bool in[2];
  int kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + 8 * r;
    in[r] = row < Tk;
    kv[r] = in[r] ? kvalid[static_cast<size_t>(b) * Tk + row] : 0;
  }
  float acc[W / 8][4];                    // dV_c (warpgroup 0) or dK_c (1)
  zero_acc(acc);
  const T* own = (wg == 0 ? ks : vs) + rw * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();                     // tile it is in stage it % 2
    const int s = it & 1, i0 = it * BN;
    // the partial S^T = K_c Q_c^T (warpgroup 0) or dP^T = V_c dO_c^T (1)
    // over this block's columns (column c is query i0 + c), then S^T over
    // all of D and p^T in place
    float sacc[NT][4], dpacc[NT][4];
    tile_abt<T, W, BN, LD>(sacc, own, wg == 0 ? qtile(s) : dotile(s), cw);
    store_part(slot_part<NT>(slot(s), wg, rw), sacc);
    cluster_sync();
    if (wg == 0)
      sum_ranks<false>(sacc, slot_part<NT>(slot(s), 0, rw), dpacc,
                       slot_part<NT>(slot(s), 0, rw), nrank);
    else
      sum_ranks<true>(sacc, slot_part<NT>(slot(s), 0, rw), dpacc,
                      slot_part<NT>(slot(s), 1, rw), nrank);
    dkv_p(sacc, reinterpret_cast<const int*>(vec(s, 0)),
          reinterpret_cast<const float*>(vec(s, 1)), i0, Tq, scale, in, kv);
    if (wg == 0) {
      tile_xb<T, W, BN, LD>(acc, sacc, dotile(s), cw);  // dV_c += T(P^T) dO_c
    } else {
      ds_from_dp(sacc, dpacc, reinterpret_cast<const float*>(vec(s, 2)),
                 scale);
      tile_xb<T, W, BN, LD>(acc, sacc, qtile(s), cw);   // dK_c += T(dS^T) Q_c
    }
    __syncthreads();                     // every warp is done with stage s
    if (it + 2 < ntiles) issue_tile(it + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  cluster_sync();                        // no block leaves while another
                                         // may still read its slots
  store_acc<T>((wg == 0 ? dv : dk) + koff + c0, acc, krow0, Tk, D,
               min(cw, D - c0));
}

// A head width's cluster: C = ceil(DP / 256) blocks of `chunk` columns,
// DP / C rounded up to 32 (the last block takes the rest); mirrored by
// ops/kernels/flash_attn.py::k4_wide_split
struct WideSplit {
  int blocks, chunk;
};

WideSplit wide_split(int D) {
  const int dp = (D + 127) / 128 * 128;      // padded_dim above 256
  const int blocks = (dp + kWideW - 1) / kWideW;
  return {blocks, (dp / blocks + 31) / 32 * 32};
}

// Launch `kernel` over grid (blocks, row blocks of `rows`, B * H) as
// clusters of `blocks` along x, with `smem` bytes of dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int blocks, int rows,
                           int B, int H, size_t smem, cudaStream_t s,
                           Args... args) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (rows + BM - 1) / BM, B * H);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dq_w(const void* q, const void* k, const void* v,
                 const void* qv, const void* kv, const void* dout,
                 const void* lse, const void* di, void* dq_, int B, int H,
                 int Tq, int Tk, int D, float scale, cudaStream_t s) {
  const WideSplit w = wide_split(D);
  return launch_cluster(
      flash_dq_cluster_kernel<T>, w.blocks, Tq, B, H,
      ClusterGeo<T, 1>::kSmem, s, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qv), static_cast<const int*>(kv),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<T*>(dq_), H, Tq, Tk, D,
      w.chunk, scale);
}

template <typename T>
cudaError_t dkv_w(const void* q, const void* k, const void* v,
                  const void* qv, const void* kv, const void* dout,
                  const void* lse, const void* di, void* dk, void* dv, int B,
                  int H, int Tq, int Tk, int D, float scale, cudaStream_t s) {
  const WideSplit w = wide_split(D);
  return launch_cluster(
      flash_dkv_cluster_kernel<T>, w.blocks, Tk, B, H,
      ClusterGeo<T, 3>::kSmem, s, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qv), static_cast<const int*>(kv),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, D, w.chunk, scale);
}

}  // namespace

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

cudaError_t wide_bwd_attrs(bool bf16, int kernel, cudaFuncAttributes* attr) {
  using bf = __nv_bfloat16;
  switch (kernel * 2 + bf16) {
    case 2: return cudaFuncGetAttributes(attr, flash_dkv_cluster_kernel<float>);
    case 3: return cudaFuncGetAttributes(attr, flash_dkv_cluster_kernel<bf>);
    case 4: return cudaFuncGetAttributes(attr, flash_dq_cluster_kernel<float>);
    case 5: return cudaFuncGetAttributes(attr, flash_dq_cluster_kernel<bf>);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptk
