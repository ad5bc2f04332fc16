// Grouped (per-relation) matmul and its weight gradient for Hopper
// (sm_90a), with a plain C interface (bound from Python with ctypes, see
// ops/grouped_kernels.py). Rows are group-contiguous: group g owns rows
// offs[g] .. offs[g+1] - 1 (offs [G + 1] int32, non-decreasing).
//
// grouped_matmul replaces the JAX package's
//   scaling_rgcn_training_tpu/ops/pallas_kernels.py:56 _fwd_kernel
//     (via _fwd, grouped_matmul_pallas)
//     out[rows of g] = lhs[rows of g] @ rhs[g]   lhs [M, K], rhs [G, K, N]
// and serves its VJP's d_lhs too (the same product with rhs transposed).
// The output has lhs's dtype, as the TPU kernel's: bf16 in, bf16 out.
// Design: a block owns a tile of BM rows x BN columns of out and finds the
// groups that intersect its rows by a binary search over offs (the TPU
// kernel prefetched host-built per-tile ranges; here each block loads its
// own). For each such group it stages slices of the lhs tile (rows outside
// the group zeroed, as the TPU kernel's mask) and of rhs[g] in shared
// memory, BK deep, and each thread accumulates a 4 x RN register tile in
// f32. Each output element is written once, by one thread. Rows of any
// count are masked at the ragged edge; nothing is padded.
//
// grouped_drhs replaces
//   scaling_rgcn_training_tpu/ops/pallas_kernels.py:114 _drhs_kernel
//     (via _drhs)
//     d_rhs[g] = lhs[rows of g]^T @ gout[rows of g]   -> [G, K, N] f32
// The TPU kernel zeroes the output at grid step 0 and adds every row tile
// into it, which is race-free only because a TPU grid runs in order. CUDA
// blocks run in no order, so the rows are cut into fixed tiles of T rows,
// one block computes the partial sum of one (row tile i, group g) pair for
// one [BK, BN] tile of the output and writes it to partial[i + g] (the
// pairs of sorted groups form a staircase, so i + g is unique), and a
// second pass adds each group's partials in row-tile order: two runs give
// the same bits. The [K, N] output is tiled, so wide layers (256 x 64) fit.
//
// What bounds them on an H100: bytes. Both do 2 * M * K * N operations on
// M * (K + N) values read once (at the bench shape's first layer, 64 -> 16
// f32: 8.4 GFLOP, 0.13 ms at 67 TFLOP/s, against 1.28 GB, 0.38 ms at
// 3.35 TB/s). The register tiles keep the shared-memory reads per
// multiply-add below one; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kThreads = 256;

// The group whose rows hold `row`: the largest g in [0, G) with
// offs[g] <= row (empty groups share their offset with the next group).
__device__ int group_of(const int* __restrict__ offs, int G, int row) {
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offs[mid] <= row) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// -- grouped_matmul -----------------------------------------------------------

constexpr int kBK = 16;   // depth of a staged slice
constexpr int kRM = 4;    // rows per thread

// Threads: CG = BN / RN column groups x RG = 256 / CG row groups; thread
// (tr, tc) owns rows tr * 4 .. tr * 4 + 3 and columns tc * RN .. + RN - 1.
template <typename T, int BN, int RN>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ offs, T* __restrict__ out, int M, int K,
           int N, int G) {
  constexpr int CG = BN / RN;
  constexpr int RG = kThreads / CG;
  constexpr int BM = RG * kRM;
  __shared__ float As[BM][kBK + 1];
  __shared__ float Bs[kBK][BN];
  __shared__ int g_range[2];
  const int row0 = blockIdx.x * BM;
  const int row_end = min(row0 + BM, M);
  const int col0 = blockIdx.y * BN;
  const int tc = threadIdx.x % CG;
  const int tr = threadIdx.x / CG;
  if (threadIdx.x == 0) {
    g_range[0] = group_of(offs, G, row0);
    g_range[1] = group_of(offs, G, row_end - 1);
  }
  __syncthreads();
  float acc[kRM][RN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int g = g_range[0]; g <= g_range[1]; ++g) {
    const int a = max(offs[g], row0);
    const int b = min(offs[g + 1], row_end);
    if (a >= b) continue;  // the same for every thread of the block
    const T* w = rhs + (size_t)g * K * N;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      for (int t = threadIdx.x; t < BM * kBK; t += kThreads) {
        const int r = t / kBK, k = t % kBK;
        const int row = row0 + r;
        float v = 0.f;
        if (row >= a && row < b && k0 + k < K)
          v = to_f(lhs[(size_t)row * K + k0 + k]);
        As[r][k] = v;
      }
      for (int t = threadIdx.x; t < kBK * BN; t += kThreads) {
        const int k = t / BN, n = t % BN;
        float v = 0.f;
        if (k0 + k < K && col0 + n < N) v = to_f(w[(size_t)(k0 + k) * N + col0 + n]);
        Bs[k][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float av[kRM], bv[RN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) av[i] = As[tr * kRM + i][k];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = Bs[k][tc * RN + j];
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = row0 + tr * kRM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = col0 + tc * RN + j;
      if (col < N) put(out + (size_t)row * N + col, acc[i][j]);
    }
  }
}

template <typename T, int BN, int RN>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const int* offs,
                       void* out, int M, int K, int N, int G, cudaStream_t s) {
  constexpr int BM = kThreads / (BN / RN) * kRM;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gmm_kernel<T, BN, RN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), offs,
      static_cast<T*>(out), M, K, N, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_gmm(const void* lhs, const void* rhs, const int* offs,
                         void* out, int M, int K, int N, int G, cudaStream_t s) {
  if (N <= 4) return launch_gmm<T, 4, 1>(lhs, rhs, offs, out, M, K, N, G, s);
  if (N <= 8) return launch_gmm<T, 8, 2>(lhs, rhs, offs, out, M, K, N, G, s);
  if (N <= 16) return launch_gmm<T, 16, 4>(lhs, rhs, offs, out, M, K, N, G, s);
  if (N <= 32) return launch_gmm<T, 32, 4>(lhs, rhs, offs, out, M, K, N, G, s);
  return launch_gmm<T, 64, 4>(lhs, rhs, offs, out, M, K, N, G, s);
}

// -- grouped_drhs -------------------------------------------------------------

constexpr int kRB = 32;   // rows staged at a time

// One block: row tile blockIdx.x (rows [i * T, (i + 1) * T)), output tile
// blockIdx.y of [BK, BN]; for each group g meeting the row tile,
// partial[i + g][k, n] = sum over the tile's rows of g of lhs[r, k] gout[r, n].
// Threads: CG = BN / RN column groups x (BK / RK) row groups.
template <typename T, int BK, int BN, int RK, int RN>
__global__ void __launch_bounds__(kThreads)
drhs_partial_kernel(const T* __restrict__ lhs, const T* __restrict__ gout,
                    const int* __restrict__ offs, float* __restrict__ partial,
                    int M, int K, int N, int G, int tile_rows) {
  constexpr int CG = BN / RN;
  static_assert((BK / RK) * CG == kThreads, "one output tile per block");
  __shared__ float Ls[kRB][BK + 1];
  __shared__ float Gs[kRB][BN + 1];
  __shared__ int g_range[2];
  const int tile = blockIdx.x;
  const int row0 = tile * tile_rows;
  const int row_end = min(row0 + tile_rows, M);
  const int n_ktiles = (K + BK - 1) / BK;
  const int k0 = (blockIdx.y % n_ktiles) * BK;
  const int n0 = (blockIdx.y / n_ktiles) * BN;
  const int tn = threadIdx.x % CG;
  const int tk = threadIdx.x / CG;
  if (threadIdx.x == 0) {
    g_range[0] = group_of(offs, G, row0);
    g_range[1] = group_of(offs, G, row_end - 1);
  }
  __syncthreads();
  const size_t P = (size_t)K * N;

  for (int g = g_range[0]; g <= g_range[1]; ++g) {
    const int a = max(offs[g], row0);
    const int b = min(offs[g + 1], row_end);
    if (a >= b) continue;  // the same for every thread of the block
    float acc[RK][RN];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int base = a; base < b; base += kRB) {
      const int nr = min(kRB, b - base);
      for (int t = threadIdx.x; t < kRB * BK; t += kThreads) {
        const int r = t / BK, k = t % BK;
        float v = 0.f;
        if (r < nr && k0 + k < K) v = to_f(lhs[(size_t)(base + r) * K + k0 + k]);
        Ls[r][k] = v;
      }
      for (int t = threadIdx.x; t < kRB * BN; t += kThreads) {
        const int r = t / BN, n = t % BN;
        float v = 0.f;
        if (r < nr && n0 + n < N) v = to_f(gout[(size_t)(base + r) * N + n0 + n]);
        Gs[r][n] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kRB; ++r) {
        float av[RK], bv[RN];
#pragma unroll
        for (int i = 0; i < RK; ++i) av[i] = Ls[r][tk * RK + i];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = Gs[r][tn * RN + j];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* dst = partial + (size_t)(tile + g) * P;
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int k = k0 + tk * RK + i;
      if (k >= K) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = n0 + tn * RN + j;
        if (n < N) dst[(size_t)k * N + n] = acc[i][j];
      }
    }
  }
}

// out[g] = sum of group g's partials in row-tile order; 0 for an empty group.
__global__ void drhs_reduce_kernel(const float* __restrict__ partial,
                                   const int* __restrict__ offs,
                                   float* __restrict__ out, int M, int K,
                                   int N, int tile_rows) {
  const int g = blockIdx.y;
  const size_t P = (size_t)K * N;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int lo = min(offs[g], M);
  const int hi = min(offs[g + 1], M);
  float s = 0.f;
  if (hi > lo)
    for (int i = lo / tile_rows; i <= (hi - 1) / tile_rows; ++i)
      s += partial[(size_t)(i + g) * P + p];
  out[(size_t)g * P + p] = s;
}

template <typename T, int BK, int BN, int RK, int RN>
cudaError_t launch_drhs(const void* lhs, const void* gout, const int* offs,
                        float* partial, float* out, int M, int K, int N, int G,
                        int tile_rows, cudaStream_t s) {
  if (M > 0) {
    const int n_tiles = (M + tile_rows - 1) / tile_rows;
    const dim3 grid(n_tiles, ((K + BK - 1) / BK) * ((N + BN - 1) / BN));
    drhs_partial_kernel<T, BK, BN, RK, RN><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(gout), offs, partial,
        M, K, N, G, tile_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t P = (size_t)K * N;
  const dim3 grid((unsigned)((P + 255) / 256), G);
  drhs_reduce_kernel<<<grid, 256, 0, s>>>(partial, offs, out, M, K, N, tile_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_drhs(const void* lhs, const void* gout, const int* offs,
                          float* partial, float* out, int M, int K, int N,
                          int G, int tile_rows, cudaStream_t s) {
  if (K <= 16 && N <= 16)
    return launch_drhs<T, 16, 16, 1, 1>(lhs, gout, offs, partial, out, M, K, N, G, tile_rows, s);
  if (N <= 16)
    return launch_drhs<T, 64, 16, 4, 1>(lhs, gout, offs, partial, out, M, K, N, G, tile_rows, s);
  return launch_drhs<T, 64, 64, 4, 4>(lhs, gout, offs, partial, out, M, K, N, G, tile_rows, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out). lhs [M, K], rhs
// [G, K, N], offs [G + 1] with offs[0] = 0, out [M, N]. Returns
// cudaGetLastError() after the launch.
int grouped_matmul(int dtype, const void* lhs, const void* rhs,
                   const int* offs, void* out, int M, int K, int N, int G,
                   void* stream) {
  if (M <= 0 || N <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
      ? dispatch_gmm<__nv_bfloat16>(lhs, rhs, offs, out, M, K, N, G, s)
      : dispatch_gmm<float>(lhs, rhs, offs, out, M, K, N, G, s);
  return static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16 (lhs and gout). lhs [M, K], gout
// [M, N], offs [G + 1], partial [ceil(M / tile_rows) + G - 1, K, N] f32
// scratch, out [G, K, N] f32.
int grouped_drhs(int dtype, const void* lhs, const void* gout,
                 const int* offs, float* partial, float* out, int M, int K,
                 int N, int G, int tile_rows, void* stream) {
  if (K <= 0 || N <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
      ? dispatch_drhs<__nv_bfloat16>(lhs, gout, offs, partial, out, M, K, N, G, tile_rows, s)
      : dispatch_drhs<float>(lhs, gout, offs, partial, out, M, K, N, G, tile_rows, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
