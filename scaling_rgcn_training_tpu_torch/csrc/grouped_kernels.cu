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
// gmm_tc_kernel, on the tensor cores: a block of 4 warps owns a row tile
// of tile_rows rows (and a column tile of at most 64 columns, and a depth
// chunk of `depth` features: both one tile at the bench shape) and finds
// the groups that meet its rows from a warp's ballots over offs (the TPU
// kernel prefetched host-built per-tile ranges; here each block finds its
// own: no host plan, no device sync). For each such group g it stages
// rhs[g] n-major in shared memory as the B operand (stage_rhs; float32:
// big and small parts on each column's grid), and walks the group's rows
// in the tile from the group's first, 16 rows a warp tile: each warp
// copies its tiles' lhs rows by cp.async, 16 bytes at a time, into one of
// two buffers, one tile ahead, rows past the group as zeros (a 0-byte
// source), and multiplies them by the staged rhs[g] (span_tc.cuh
// tile_times_staged, scale 1: float32 as split TF32 on fixed-point grids,
// four products a multiply-add; bfloat16 one exact product, f32 sums),
// writing each row of the group from registers in lhs's dtype, two
// columns a store (bfloat16 rows of 64 columns through a shared tile,
// 16 bytes a store). Every row is written once, by its own group's pass;
// nothing is added across passes. A K wider than `depth` is cut into
// depth chunks over the grid, each writing an f32 partial, added in chunk
// order by gmm_depth_reduce_kernel.
//
// grouped_drhs replaces
//   scaling_rgcn_training_tpu/ops/pallas_kernels.py:114 _drhs_kernel
//     (via _drhs)
//     d_rhs[g] = lhs[rows of g]^T @ gout[rows of g]   -> [G, K, N] f32
// The TPU kernel zeroes the output at grid step 0 and adds every row tile
// into it, which is race-free only because a TPU grid runs in order. CUDA
// blocks run in no order, so the rows are cut into fixed tiles of T rows,
// one block computes the partial sum of one (row tile i, group g) pair for
// one [<= 64, <= 64] tile of the output and writes it to partial[i + g]
// (the pairs of sorted groups form a staircase, so i + g is unique), and a
// second pass (drhs_reduce_kernel) adds each group's partials in row-tile
// order: two runs give the same bits. drhs_tc_kernel, on the tensor
// cores: 4 warps walk the pair's rows in stages of four 16-row tiles, one
// a warp, copied by cp.async (lhs and gout rows, 16 bytes at a time, rows
// past the group as zeros) into one of two stage buffers, one stage ahead,
// behind one block barrier a stage; each warp keeps its 16 x 8 tiles of
// the output in registers across the pair and adds lhs_tile^T gout_tile
// with the rows as the depth (span_tc.cuh DwTiles, #2's dW arithmetic:
// bfloat16 one exact m16n8k16 product, f32 sums; float32 m16n8k8 TF32 on
// grids per feature and per output over the tile's 16 rows, four
// products), and writes the pair's partial once.
//
// What bounds them on an H100: bytes. Both do 2 * M * K * N operations on
// M * (K + N) values read once (at the bench shape's first layer, 64 -> 16
// f32: 8.4 GFLOP, 0.13 ms on the CUDA cores at 67 TFLOP/s, 0.05 ms as
// 3xTF32 on the tensor cores, against 1.28 GB, 0.38 ms at 3.35 TB/s). The
// tensor cores take the products off the load units, cp.async keeps a
// stage of rows in flight while the warps multiply, and 16-byte copies
// load bfloat16 at half float32's instructions.
//
// The earlier routes, on the CUDA cores, stay callable as
// grouped_matmul_simt (gmm_kernel) and grouped_drhs_simt
// (drhs_partial_kernel): a block stages BK-deep (32-row) slices of both
// operands in shared memory with scalar loads, then each thread
// accumulates a register tile in f32 FMAs.

#include "span_tc.cuh"

#include <algorithm>
#include <climits>

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


// -- the tensor-core routes ---------------------------------------------------

// widest column tile of gmm_tc_kernel
constexpr int kGmmMaxBN = 64;
// gmm_tc_kernel's shared memory, at most, before its column tile halves
// (two blocks an SM)
constexpr size_t kGmmSmem = 116 * 1024;
// output tile of drhs_tc_kernel
constexpr int kDrhsBK = 64;
constexpr int kDrhsBN = 64;
// most 16 x 8 output tiles a warp of drhs_tc_kernel owns: 64 x 64 / 4
constexpr int kDrhsTiles = 8;

// Rows of a row-major [rows, ld] matrix as a row source of gather_rows:
// x points at the first column of the block's tile, and the gather's K is
// the tile's column count.
template <typename T>
struct TileSrc {
  using Handle = int;
  const T* __restrict__ x;
  int ld;
  __device__ __forceinline__ void prepare() const {}
  __device__ __forceinline__ Handle at(int i, int) const { return i; }
  __device__ __forceinline__ static bool valid(Handle h) { return h >= 0; }
  __device__ __forceinline__ const T* addr(Handle h, bool valid, int k,
                                           int) const {
    return x + (valid ? (size_t)h * ld + k : 0);
  }
  __device__ __forceinline__ T load(Handle h, int k, int) const {
    return x[(size_t)h * ld + k];
  }
};

// The groups g_first .. g_last that meet rows row_first .. row_last: the
// largest g < G with offs[g] <= row, for both rows at once, by a warp's
// ballots over 32 offsets a load (offs non-decreasing, offs[0] = 0).
__device__ __forceinline__ void groups_met(const int* __restrict__ offs,
                                           int G, int row_first,
                                           int row_last, int lane,
                                           int& g_first, int& g_last) {
  int n_first = 0, n_last = 0;
  for (int base = 0; base < G; base += 32) {
    const int o = base + lane < G ? offs[base + lane] : INT_MAX;
    n_first += __popc(__ballot_sync(kFull, o <= row_first));
    const unsigned last = __ballot_sync(kFull, o <= row_last);
    n_last += __popc(last);
    if (last != kFull) break;   // every later offset is past both rows
  }
  g_first = max(n_first - 1, 0);
  g_last = max(n_last - 1, 0);
}

// Shared memory of one block of gmm_tc_kernel for a depth chunk of kc
// features and a column tile of nc columns: rhs[g]'s tile staged n-major
// [Np, ld] (big and small parts for float32), then per warp two lhs tiles
// [16, ld] and, for a staged output (o_size bytes a value), its output
// tile [16, ldo]. The first two are read as mma
// fragments along their rows, so ld = 4 (mod 8) floats, 8 (mod 16)
// bfloat16, keeps a fragment load's 32 lanes on 32 banks; the output tile
// takes a lane's two columns a store, so ldo = 8 (mod 32) floats, 8 (mod
// 16) bfloat16.
template <typename T>
struct GmmDims {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  int Kp, Np, ld, ldo;
  size_t w_elems, w_bytes, x_bytes, o_bytes;
  __host__ __device__ GmmDims(int kc, int nc, int o_size) {
    Kp = round_up(kc, TileShape<T>::kK);
    Np = round_up(nc, 8);
    ld = kSplit ? padded_stride(Kp, 4, 8) : padded_stride(Kp, 8, 16);
    ldo = o_size == 4 ? padded_stride(Np, 8, 32) : padded_stride(Np, 8, 16);
    w_elems = (size_t)Np * ld;
    w_bytes = align16(w_elems * sizeof(T) * (kSplit ? 2 : 1));
    x_bytes = align16((size_t)16 * ld * sizeof(T));
    o_bytes = o_size ? align16((size_t)16 * ldo * o_size) : 0;
  }
  __host__ __device__ size_t smem() const {
    return w_bytes + (size_t)kMsgWarps * (2 * x_bytes + o_bytes);
  }
};

// rhs[g]'s [kc, nc] tile (row stride ldw) staged n-major as the B operand
// of tile_times_staged: w_big[n * ld + k] = W[k][n], zero-padded to [Np,
// Kp]; float32: W's big part on column n's grid and the TF32 small part in
// w_small (span_tc.cuh Grid). Every thread loads its share first (one
// round trip), then the columns' largest |W| (col_top, Np floats) come
// from shared memory. Ends with the block's barrier.
template <typename T>
__device__ __forceinline__ void stage_rhs(T* w_big, T* w_small,
                                          float* col_top,
                                          const T* __restrict__ wr, int kc,
                                          int nc, int ldw,
                                          const GmmDims<T>& d) {
#pragma unroll 4
  for (int i = threadIdx.x; i < d.Np * d.Kp; i += blockDim.x) {
    const int k = i / d.Np;
    const int n = i - k * d.Np;
    w_big[(size_t)n * d.ld + k] =
        k < kc && n < nc ? wr[(size_t)k * ldw + n] : zero<T>();
  }
  if constexpr (GmmDims<T>::kSplit) {
    __syncthreads();
    for (int n = threadIdx.x; n < d.Np; n += blockDim.x) {
      float top = 0.f;
      for (int k = 0; k < d.Kp; ++k)
        top = fmaxf(top, fabsf(w_big[(size_t)n * d.ld + k]));
      col_top[n] = top;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d.Np * d.Kp; i += blockDim.x) {
      const int n = i / d.Kp;
      const size_t at = (size_t)n * d.ld + i - n * d.Kp;
      const float v = w_big[at];
      const float b = Grid(col_top[n]).big(v);
      w_big[at] = b;
      w_small[at] = tf32_round(v - b);
    }
  }
  __syncthreads();
}

// The warp's output tile os [16, d.ldo] to out rows base .. base + n_rows
// - 1 (row stride ldo_g), columns < nc: 16 bytes a store where every row
// of out and the tile's width allow it (vec), else one value a store.
template <typename O>
__device__ __forceinline__ void store_tile(const O* os, int ldo, O* out,
                                           size_t base, int n_rows,
                                           int ldo_g, int nc, bool vec,
                                           int lane) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(O);
    const int units = nc / kPer;
    for (int c = lane; c < 16 * units; c += 32) {
      const int r = c / units, u = c - r * units;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + (base + r) * ldo_g + u * kPer) =
            *reinterpret_cast<const uint4*>(os + r * ldo + u * kPer);
    }
    return;
  }
  for (int c = lane; c < 16 * nc; c += 32) {
    const int r = c / nc, n = c - r * nc;
    if (r < n_rows) out[(base + r) * ldo_g + n] = os[r * ldo + n];
  }
}

struct GmmArgs {
  const void* lhs;
  const void* rhs;
  const int* offs;
  void* out;   // [M, N] in T, or the depth chunks' [chunks, M, N] f32
  int M, K, N, G, tile_rows, depth, BN, unit;
};

// One block: rows [row0, row0 + tile_rows) of out, columns [n0, n0 + BN)
// (blockIdx.y), depth [k0, k0 + depth) (blockIdx.z: its own partial).
// A warp's product goes to out from registers, a lane's two columns of a
// row a store; kStaged: through the warp's output tile in shared memory
// instead, 16 bytes a store (bfloat16 rows of 64 columns: there the pairs'
// 4-byte stores, 8 rows a store, ran far slower on the H100; at 8 and 16
// columns the shared tile was the slower).
template <typename T, typename O, bool kStaged>
__global__ void __launch_bounds__(kMsgThreads)
gmm_tc_kernel(GmmArgs a) {
  const T* __restrict__ lhs = static_cast<const T*>(a.lhs);
  const T* __restrict__ rhs = static_cast<const T*>(a.rhs);
  const int row0 = blockIdx.x * a.tile_rows;
  const int row_end = min(row0 + a.tile_rows, a.M);
  const int n0 = blockIdx.y * a.BN;
  const int nc = min(a.BN, a.N - n0);
  const int k0 = blockIdx.z * a.depth;
  const int kc = min(a.depth, a.K - k0);
  const GmmDims<T> d(kc, nc, kStaged ? sizeof(O) : 0);
  extern __shared__ __align__(16) unsigned char gmm_buf[];
  __shared__ float col_top[kGmmMaxBN];
  T* w_big = reinterpret_cast<T*>(gmm_buf);
  T* w_small = w_big + d.w_elems;   // float32 only
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* bufs =
      gmm_buf + d.w_bytes + warp * (2 * d.x_bytes + d.o_bytes);
  O* os = reinterpret_cast<O*>(bufs + 2 * d.x_bytes);   // kStaged only
  O* out = static_cast<O*>(a.out) + (size_t)blockIdx.z * a.M * a.N + n0;
  const TileSrc<T> rows{lhs + k0, a.K};

  // rows past the last group (group sizes that sum to less than M) are 0
  for (int r = max(a.offs[a.G], row0) + warp; r < row_end; r += kMsgWarps)
    for (int n = lane; n < nc; n += 32)
      out[(size_t)r * a.N + n] = from_float<O>(0.f);
  int g_first, g_last;
  groups_met(a.offs, a.G, row0, row_end - 1, lane, g_first, g_last);
  for (int g = g_first; g <= g_last; ++g) {
    const int lo = max(a.offs[g], row0);
    const int hi = min(a.offs[g + 1], row_end);
    if (lo >= hi) continue;   // the same for every thread of the block
    __syncthreads();   // every warp is done with the last group's rhs
    stage_rhs(w_big, w_small, col_top,
              rhs + ((size_t)g * a.K + k0) * a.N + n0, kc, nc, a.N, d);
    // each warp owns the pass's 16-row tiles warp, warp + 4, ...: its own
    // lhs rows, copied one tile ahead into the other of its two buffers
    // (deeper rings measured no faster on the H100 at the bench shape)
    const int n_tiles = (hi - lo + 15) >> 4;
    const auto copy = [&](int it) {   // the warp's it-th tile of the pass
      const int t = warp + it * kMsgWarps;
      if (t < n_tiles) {   // the same on every lane
        const int r = lo + t * 16 + (lane & 15);
        gather_rows(reinterpret_cast<T*>(bufs + (it & 1) * d.x_bytes), rows,
                    r < hi ? r : -1, kc, d.Kp, d.ld, a.unit, lane);
      }
      cp_commit();
    };
    copy(0);
    for (int it = 0, tile = warp; tile < n_tiles; ++it, tile += kMsgWarps) {
      copy(it + 1);
      cp_wait<1>();   // all but the newest copies: this tile's rows
      __syncwarp();
      const T* xs = reinterpret_cast<const T*>(bufs + (it & 1) * d.x_bytes);
      const int base = lo + tile * 16;
      if constexpr (kStaged) {
        tile_times_staged<T, O, true>(xs, d.ld, d.Kp, w_big, w_small, d.ld,
                                      d.Np, d.Np, os, d.ldo, 0, 16, 1.f, 1.f,
                                      lane);
        __syncwarp();
        // 16-byte stores: every row of out and the tile's width whole units
        const bool vec = (a.N * sizeof(O)) % 16 == 0
                         && (nc * sizeof(O)) % 16 == 0;
        store_tile(os, d.ldo, out, (size_t)base, min(16, hi - base), a.N, nc,
                   vec, lane);
      } else {
        tile_times_staged<T, O, true>(xs, d.ld, d.Kp, w_big, w_small, d.ld,
                                      d.Np, nc, out, a.N, (size_t)base,
                                      hi - base, 1.f, 1.f, lane);
      }
      __syncwarp();
    }
    cp_wait<0>();
  }
}

// out = the sum of the depth chunks' partials [chunks, MN] in chunk order,
// in T.
template <typename T>
__global__ void gmm_depth_reduce_kernel(const float* __restrict__ partial,
                                        T* __restrict__ out, size_t MN,
                                        int chunks) {
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= MN) return;
  float s = partial[p];
  for (int c = 1; c < chunks; ++c) s += partial[c * MN + p];
  out[p] = from_float<T>(s);
}

template <typename T, typename O, bool kStaged>
cudaError_t launch_gmm_tc_kernel(const GmmArgs& a, int chunks,
                                 cudaStream_t s) {
  const size_t smem =
      GmmDims<T>(std::min(a.depth, a.K), a.BN, kStaged ? sizeof(O) : 0)
          .smem();
  auto kernel = gmm_tc_kernel<T, O, kStaged>;
  // a host call each launch: only for the widths past the default 48 KiB
  // (with the static col_top)
  if (smem + sizeof(float) * kGmmMaxBN > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.M + a.tile_rows - 1) / a.tile_rows,
                  (a.N + a.BN - 1) / a.BN, chunks);
  kernel<<<grid, kMsgThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// partial: [chunks, M, N] f32 scratch when K > depth, else unused.
template <typename T>
cudaError_t launch_gmm_tc(GmmArgs a, float* partial, cudaStream_t s) {
  // the widest column tile (a multiple of 8, at most 64) whose shared
  // memory fits kGmmSmem
  a.BN = std::min(round_up(a.N, 8), kGmmMaxBN);
  while (a.BN > 8 && GmmDims<T>(std::min(a.depth, a.K), a.BN, sizeof(float))
                             .smem() > kGmmSmem)
    a.BN = round_up(a.BN / 2, 8);
  a.unit = copy_unit<T>(a.lhs, a.K);
  const int chunks = (a.K + a.depth - 1) / a.depth;
  if (chunks == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      if (a.N >= 64) return launch_gmm_tc_kernel<T, T, true>(a, 1, s);
    return launch_gmm_tc_kernel<T, T, false>(a, 1, s);
  }
  void* out = a.out;
  a.out = partial;
  cudaError_t err = launch_gmm_tc_kernel<T, float, false>(a, chunks, s);
  if (err != cudaSuccess) return err;
  const size_t MN = (size_t)a.M * a.N;
  gmm_depth_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
      partial, static_cast<T*>(out), MN, chunks);
  return cudaGetLastError();
}

// Shared memory of one block of drhs_tc_kernel for a [kc, nc] output tile:
// two stages of kMsgWarps tiles, each lhs rows [16, ldx] (Kx = 16
// ceil(kc / 16) columns) and gout rows [16, ldg] (Ng columns, a multiple of
// the mma depth: whole 16-byte copies).
template <typename T>
struct DrhsDims {
  int kc, nc, Kx, Ng, Mn, n_dw, ldx, ldg;
  size_t x_bytes, g_bytes, stage_bytes;
  __host__ __device__ DrhsDims(int kc_, int nc_) : kc(kc_), nc(nc_) {
    Kx = round_up(kc, 16);
    Ng = round_up(nc, TileShape<T>::kK);
    Mn = (nc + 7) / 8;
    n_dw = Kx / 16 * Mn;
    // read down their columns (lane 4 g + t reads row t, 2 t for bfloat16,
    // of column g): rows 8 or 24 elements apart modulo 32 banks
    ldx = padded_stride(Kx, 8, 16);
    ldg = padded_stride(Ng, 8, 16);
    x_bytes = align16((size_t)16 * ldx * sizeof(T));
    g_bytes = align16((size_t)16 * ldg * sizeof(T));
    stage_bytes = kMsgWarps * (x_bytes + g_bytes);
  }
  __host__ __device__ size_t smem() const { return 2 * stage_bytes; }
};

struct DrhsArgs {
  const void* lhs;
  const void* gout;
  const int* offs;
  float* partial;
  int M, K, N, G, tile_rows, unit_x, unit_g;
};

// One block: row tile blockIdx.x (rows [i T, (i + 1) T)), output tile
// blockIdx.y of [kDrhsBK, kDrhsBN]; for each group g meeting the row tile,
// partial[i + g][k, n] = sum over the tile's rows of g of lhs[r, k]
// gout[r, n].
template <typename T, int kTiles>
__global__ void __launch_bounds__(kMsgThreads)
drhs_tc_kernel(DrhsArgs a) {
  const int n_kt = (a.K + kDrhsBK - 1) / kDrhsBK;
  const int k0 = (blockIdx.y % n_kt) * kDrhsBK;
  const int n0 = (blockIdx.y / n_kt) * kDrhsBN;
  const DrhsDims<T> d(min(kDrhsBK, a.K - k0), min(kDrhsBN, a.N - n0));
  extern __shared__ __align__(16) unsigned char drhs_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int row0 = tile * a.tile_rows;
  const int row_end = min(row0 + a.tile_rows, a.M);
  const TileSrc<T> xrows{static_cast<const T*>(a.lhs) + k0, a.K};
  const TileSrc<T> grows{static_cast<const T*>(a.gout) + n0, a.N};
  const auto tile_x = [&](int s, int i) {
    return reinterpret_cast<T*>(drhs_smem + (s & 1) * d.stage_bytes
                                + i * (d.x_bytes + d.g_bytes));
  };
  const auto tile_g = [&](int s, int i) {
    return reinterpret_cast<T*>(drhs_smem + (s & 1) * d.stage_bytes
                                + i * (d.x_bytes + d.g_bytes) + d.x_bytes);
  };
  DwTiles<kTiles> own(d.n_dw, d.Mn, warp);

  int g_first, g_last;
  groups_met(a.offs, a.G, row0, row_end - 1, lane, g_first, g_last);
  for (int g = g_first; g <= g_last; ++g) {
    const int lo = max(a.offs[g], row0);
    const int hi = min(a.offs[g + 1], row_end);
    if (lo >= hi) continue;   // the same for every thread of the block
    // stage s holds the pair's tiles 4 s .. 4 s + 3 (rows from lo), tile
    // 4 s + i copied by warp i into buffer s & 1
    const int n_tiles = (hi - lo + 15) >> 4;
    const int n_stages = (n_tiles + kMsgWarps - 1) / kMsgWarps;
    const auto copy = [&](int s) {
      const int t = s * kMsgWarps + warp;
      if (t < n_tiles) {   // the same on every lane
        const int r = lo + t * 16 + (lane & 15);
        const int row = r < hi ? r : -1;
        gather_rows(tile_x(s, warp), xrows, row, d.kc, d.Kx, d.ldx, a.unit_x,
                    lane);
        gather_rows(tile_g(s, warp), grows, row, d.nc, d.Ng, d.ldg, a.unit_g,
                    lane);
      }
      cp_commit();
    };
    own.clear();
    __syncthreads();   // every warp is done with the last pair's buffers
    copy(0);
    for (int s = 0; s < n_stages; ++s) {
      cp_wait<0>();      // this warp's copies of stage s
      __syncthreads();   // every warp's; and stage s - 1's buffer is free
      copy(s + 1);
      own.template add<T>(
          min(kMsgWarps, n_tiles - s * kMsgWarps),
          [&](int i) { return tile_x(s, i); },
          [&](int i) { return tile_g(s, i); }, d.ldx, d.ldg, lane);
    }
    own.store(a.partial + (size_t)(tile + g) * a.K * a.N + (size_t)k0 * a.N
                  + n0,
              d.kc, d.nc, a.N, reinterpret_cast<float*>(drhs_smem), warp,
              lane);
  }
}

template <typename T, int kTiles>
cudaError_t launch_drhs_tc_kernel(const DrhsArgs& a, cudaStream_t s) {
  const size_t smem =
      DrhsDims<T>(std::min(kDrhsBK, a.K), std::min(kDrhsBN, a.N)).smem();
  auto kernel = drhs_tc_kernel<T, kTiles>;
  // a host call each launch: only for the widths past the default 48 KiB
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.M + a.tile_rows - 1) / a.tile_rows,
                  ((a.K + kDrhsBK - 1) / kDrhsBK) *
                      ((a.N + kDrhsBN - 1) / kDrhsBN));
  kernel<<<grid, kMsgThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_drhs_tc(DrhsArgs a, float* out, cudaStream_t s) {
  if (a.M > 0) {
    a.unit_x = copy_unit<T>(a.lhs, a.K);
    a.unit_g = copy_unit<T>(a.gout, a.N);
    // the first output tile is the largest: its tiles a warp bound kTiles
    const cudaError_t err =
        DrhsDims<T>(std::min(kDrhsBK, a.K), std::min(kDrhsBN, a.N)).n_dw
                > 2 * kMsgWarps
            ? launch_drhs_tc_kernel<T, kDrhsTiles>(a, s)
            : launch_drhs_tc_kernel<T, 2>(a, s);
    if (err != cudaSuccess) return err;
  }
  const size_t P = (size_t)a.K * a.N;
  const dim3 grid((unsigned)((P + 255) / 256), a.G);
  drhs_reduce_kernel<<<grid, 256, 0, s>>>(a.partial, a.offs, out, a.M, a.K,
                                          a.N, a.tile_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out). lhs [M, K], rhs
// [G, K, N], offs [G + 1] with offs[0] = 0, out [M, N]; partial [ceil(K /
// depth), M, N] f32 scratch when K > depth (else unused); tile_rows: rows
// of a block; depth: a multiple of 16, the widest K a block takes at once.
// Returns the first error of the set-up calls or of a launch.
int grouped_matmul(int dtype, const void* lhs, const void* rhs,
                   const int* offs, void* out, float* partial, int M, int K,
                   int N, int G, int tile_rows, int depth, void* stream) {
  if (tile_rows <= 0 || depth <= 0 || depth % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GmmArgs a{lhs, rhs, offs, out, M, K, N, G, tile_rows, depth, 0, 0};
  const cudaError_t err = dtype == 1
      ? launch_gmm_tc<__nv_bfloat16>(a, partial, s)
      : launch_gmm_tc<float>(a, partial, s);
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
  const DrhsArgs a{lhs, gout, offs, partial, M, K, N, G, tile_rows, 0, 0};
  const cudaError_t err = dtype == 1
      ? launch_drhs_tc<__nv_bfloat16>(a, out, s)
      : launch_drhs_tc<float>(a, out, s);
  return static_cast<int>(err);
}


// The earlier routes on the CUDA cores, for timing beside the above:
// grouped_matmul_simt as grouped_matmul (any K at once, no scratch),
// grouped_drhs_simt as grouped_drhs.
int grouped_matmul_simt(int dtype, const void* lhs, const void* rhs,
                        const int* offs, void* out, int M, int K, int N,
                        int G, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
      ? dispatch_gmm<__nv_bfloat16>(lhs, rhs, offs, out, M, K, N, G, s)
      : dispatch_gmm<float>(lhs, rhs, offs, out, M, K, N, G, s);
  return static_cast<int>(err);
}

int grouped_drhs_simt(int dtype, const void* lhs, const void* gout,
                      const int* offs, float* partial, float* out, int M,
                      int K, int N, int G, int tile_rows, void* stream) {
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
