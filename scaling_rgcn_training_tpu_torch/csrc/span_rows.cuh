// The span row kernel of the R-GCN conv for Hopper (sm_90a), shared by
// span_kernels.cu (kernels #1 and the dx half of #2) and halo_kernels.cu
// (kernel #7): over a CSR plan sorted by (row, rel),
//   out[row] = sum_e norm_e * feat(idx_e) @ Wk[rel_e]
// where feat(i) is row i of one matrix (DenseRows) or row i of the virtual
// concatenation of S shards' [n_per, K] matrices, each read where it lies
// (ShardRows: a peer's rows are read straight from its memory; its
// epilogue also gathers the halo buffer that the backward reads).
//
// What bounds it on an H100: each edge reads W[rel] (K*M values). Read
// through L1/L2, those W reads bound it: at the bench shape (E = 4M,
// 64 -> 16) the f32 forward reads 16.4 GB of W per call, against 1 GB for
// the gather, and took 3.0 ms on an H100 SXM at 700 W. So W is staged in
// shared memory: persistent blocks copy the relation slice of W they need
// once, in as few relation passes as fit (layer 1 of the bench shape,
// 91*64*16 f32 = 373 KB, takes two passes of 227 KB at most); the same
// call then takes 2.2 ms. Design:
//   - one warp owns whole output rows, so no two warps write one row, with
//     no atomics; rows with no edges are written as 0; a later relation
//     pass adds to what the earlier one wrote, in pass order;
//   - a pass finds the row's edges of its relations with a warp ballot
//     over the (row, rel)-sorted plan;
//   - narrow outputs (M <= 16) split the warp into groups of G lanes that
//     work on 32/G edges at a time and are reduced with shuffles at the
//     end of the row, so lanes are not left idle at M = 4..16;
//   - each lane owns output columns; the gathered feature row is loaded
//     once, coalesced, and broadcast element by element with a shuffle;
//   - inputs may be f32 or bf16, every sum is f32;
//   - no vector loads: rows of any width (63, 11, ...) are read as scalars,
//     so nothing assumes 16-byte-aligned rows.
// A simple design: tensor cores are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace span {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kWarpsPerBlock = 32;
// shared memory a block may use on sm_90 (227 KB)
constexpr size_t kMaxSmem = 232448;
// most shards a pointer table holds (kernel parameters, 8 bytes each)
constexpr int kMaxShards = 64;

// S device pointers, passed by value in a kernel's parameters (its
// constant bank); read only at static indices, so nothing is copied to
// local memory.
struct PtrTable {
  const void* p[kMaxShards];
};

// Row i of one [n, K] matrix.
template <typename T>
struct DenseRows {
  static constexpr size_t kStaticSmem = 0;
  const T* base;
  __device__ __forceinline__ void prepare() const {}
  __device__ __forceinline__ const T* row(int i, int K) const {
    return base + (size_t)i * K;
  }
  __device__ __forceinline__ void epilogue(int, int, int, int) const {}
};

// The shard table in shared memory; only kernels of a ShardRows source
// touch it, so only they allocate it.
__shared__ const void* g_shard_tab[kMaxShards];

// Row i of the concatenation of S shards' [n_per, K] matrices: shard
// i / n_per, its row i % n_per. prepare() copies the table into shared
// memory (static indices only), so row() indexes shared memory. Unless
// buf is null, the epilogue of the first relation pass writes the halo
// buffer: buf[s * halo + j] = row recv_idx[s * halo + j] of shard s.
template <typename T>
struct ShardRows {
  static constexpr size_t kStaticSmem = sizeof(void*) * kMaxShards;
  PtrTable tab;
  int n_per;
  int n_shards;
  int halo;
  const int* recv_idx;
  T* buf;
  __device__ __forceinline__ void prepare() const {
#pragma unroll
    for (int k = 0; k < kMaxShards; ++k)
      if (threadIdx.x == k) g_shard_tab[k] = tab.p[k];
  }
  __device__ __forceinline__ const T* shard(int s) const {
    return static_cast<const T*>(g_shard_tab[s]);
  }
  __device__ __forceinline__ const T* row(int i, int K) const {
    const int s = i / n_per;
    return shard(s) + (size_t)(i - s * n_per) * K;
  }
  // one warp per halo row, lanes over its K columns
  __device__ __forceinline__ void epilogue(int warp, int n_warps, int lane,
                                           int K) const {
    if (buf == nullptr) return;
    const int rows = n_shards * halo;
    for (int r = warp; r < rows; r += n_warps) {
      const T* src = shard(r / halo) + (size_t)recv_idx[r] * K;
      T* dst = buf + (size_t)r * K;
      for (int k = lane; k < K; k += 32) dst[k] = src[k];
    }
  }
};

// One warp per output row (grid-stride over persistent blocks), relations
// [r_lo, r_hi) only, whose W slice the block stages in shared memory. G
// lanes per edge group, OC output chunks of G columns per lane: column
// o = c * G + (lane % G). add != 0: add to out instead of writing it.
template <typename T, int G, int OC, typename Src>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
span_rows_kernel(Src feat, const T* __restrict__ w,
                 const int* __restrict__ rowptr, const int* __restrict__ idx,
                 const int* __restrict__ rel, const float* __restrict__ norm,
                 float* __restrict__ out, int n_rows, int K, int M,
                 int r_lo, int r_hi, int n_slots, int add) {
  constexpr int NG = 32 / G;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const size_t wn = (size_t)(r_hi - r_lo) * K * M;
  const T* wsrc = w + (size_t)r_lo * K * M;
  for (size_t i = threadIdx.x; i < wn; i += blockDim.x) ws[i] = wsrc[i];
  feat.prepare();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int lg = lane % G;
  const bool all_rels = r_lo == 0 && r_hi == n_slots;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; row < n_rows;
       row += n_warps) {
    float acc[OC];
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[c] = 0.f;
    int lo = rowptr[row];
    int hi = rowptr[row + 1];
    if (!all_rels) {
      // the row's edges are sorted by rel: count those below r_lo / r_hi
      int below_lo = 0, below_hi = 0;
      for (int b = lo; b < hi; b += 32) {
        const int rv = b + lane < hi ? rel[b + lane] : n_slots;
        below_lo += __popc(__ballot_sync(kFull, rv < r_lo));
        below_hi += __popc(__ballot_sync(kFull, rv < r_hi));
      }
      hi = lo + below_hi;
      lo += below_lo;
    }
    // every loop bound below is uniform across the warp, so the shuffles
    // always see all 32 lanes; dead groups carry zeros
    for (int base = lo; base < hi; base += NG) {
      const int e = base + grp;
      const bool live = e < hi;
      int s = 0, r = 0;
      float nr = 0.f;
      if (live) {
        s = idx[e];
        r = rel[e];
        nr = norm[e];
      }
      const T* xr = feat.row(s, K);
      const T* wr = ws + (size_t)(live ? r - r_lo : 0) * K * M;
      for (int k0 = 0; k0 < K; k0 += G) {
        const int kn = min(G, K - k0);
        float xv = 0.f;
        if (live && lg < kn) xv = to_f(xr[k0 + lg]) * nr;
        for (int j = 0; j < kn; ++j) {
          const float xj = __shfl_sync(kFull, xv, j, G);
          const T* wk = wr + (size_t)(k0 + j) * M;
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            const int o = c * G + lg;
            if (live && o < M) acc[c] = fmaf(xj, to_f(wk[o]), acc[c]);
          }
        }
      }
    }
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int o = c * G + lg;
        if (o < M) {
          float* dst = out + (size_t)row * M + o;
          *dst = add ? *dst + acc[c] : acc[c];
        }
      }
    }
  }
  if (!add) feat.epilogue((blockIdx.x * blockDim.x + threadIdx.x) >> 5,
                          n_warps, lane, K);
}

// Relation passes of at most kMaxSmem bytes of W each (less the source's
// static shared memory); persistent grid of as many blocks as fit on the
// card at once. Returns the first error of the set-up calls or a launch.
template <typename T, int G, int OC, typename Src>
cudaError_t launch_rows(Src feat, const void* w, const int* rowptr,
                        const int* idx, const int* rel, const float* norm,
                        float* out, int n_rows, int K, int M, int n_slots,
                        cudaStream_t stream) {
  auto kernel = span_rows_kernel<T, G, OC, Src>;
  const size_t max_dyn = kMaxSmem - Src::kStaticSmem;
  const size_t rel_bytes = sizeof(T) * K * M;
  const int rels_per_pass = (int)(max_dyn / rel_bytes);
  if (rels_per_pass < 1) return cudaErrorInvalidValue;
  const int n_pass = (n_slots + rels_per_pass - 1) / rels_per_pass;
  const int pass_rels = (n_slots + n_pass - 1) / n_pass;
  const size_t smem = rel_bytes * pass_rels;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarpsPerBlock * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int needed = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < per_sm * n_sm ? needed : per_sm * n_sm;
  for (int p = 0; p < n_pass; ++p) {
    const int r_lo = p * pass_rels;
    const int r_hi = r_lo + pass_rels < n_slots ? r_lo + pass_rels : n_slots;
    kernel<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
        feat, static_cast<const T*>(w), rowptr, idx, rel, norm, out, n_rows,
        K, M, r_lo, r_hi, n_slots, p > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The (G, OC) specialisation for an output width M <= 128.
template <typename T, typename Src>
cudaError_t dispatch_rows(Src feat, const void* w, const int* rowptr,
                          const int* idx, const int* rel, const float* norm,
                          float* out, int n_rows, int K, int M, int n_slots,
                          cudaStream_t s) {
  if (M <= 4)
    return launch_rows<T, 4, 1>(feat, w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
  if (M <= 8)
    return launch_rows<T, 8, 1>(feat, w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
  if (M <= 16)
    return launch_rows<T, 16, 1>(feat, w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
  if (M <= 32)
    return launch_rows<T, 32, 1>(feat, w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
  if (M <= 64)
    return launch_rows<T, 32, 2>(feat, w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
  return launch_rows<T, 32, 4>(feat, w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
}

}  // namespace span
