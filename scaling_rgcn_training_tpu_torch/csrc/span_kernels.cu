// Span kernels of the R-GCN conv for Hopper (sm_90a): gather, per-edge
// relational matmul and segment sum in one pass, with a plain C interface
// (bound from Python with ctypes, see ops/span_kernels.py).
//
// span_rows replaces both the forward kernel and the dx half of the
// backward kernel of the JAX package:
//   scaling_rgcn_training_tpu/ops/span_kernels.py:425 _fwd_kernel
//     out[n] = sum_{e: dst_e = n} norm_e * x[src_e] @ W[rel_e]
//   scaling_rgcn_training_tpu/ops/span_kernels.py:542 _bwd_kernel (dx)
//     dx[n]  = sum_{e: src_e = n} norm_e * g[dst_e] @ W[rel_e]^T
// Both are the same row-segment form over a CSR plan sorted by (row, rel):
// out[row] = sum_e norm_e * feat[idx_e] @ Wk[rel_e], with Wk = W for the
// forward and Wk = W^T (transposed by the wrapper) for dx.
//
// span_dw replaces the dW half of _bwd_kernel:
//     dW[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g[dst_e])
// over relation-sorted edges cut into chunks of one relation each. Each
// block writes the partial sum of its chunk; a second pass adds the
// partials of each relation in chunk order, so runs reproduce bit for bit
// (the TPU kernel summed dW across its sequential grid; CUDA blocks run in
// no order and a shared accumulator would race).
//
// What bounds them on an H100: the forward is a gather of E*d_in elements
// plus E*d_in*d_out multiply-adds, and each edge reads W[rel] (d_in*d_out
// values). Read through L1/L2, those W reads bound it: at the bench shape
// (E = 4M, 64 -> 16) the f32 forward reads 16.4 GB of W per call, against
// 1 GB for the gather, and took 3.0 ms on an H100 SXM at 700 W. So W is
// staged in shared memory: persistent blocks copy the relation slice of W
// they need once, in as few relation passes as fit (layer 1 of the bench
// shape, 91*64*16 f32 = 373 KB, takes two passes of 227 KB at most); the
// same call then takes 2.2 ms. What bounds it now is not measured:
// unrolling the loop over W rows did not change it, and loading four
// chunks of the x row at once made it slower. Design:
//   - one warp owns whole output rows, so no two warps write one row, with
//     no atomics; rows with no edges are written as 0; a later relation
//     pass adds to what the earlier one wrote, in pass order;
//   - a pass finds the row's edges of its relations with a warp ballot
//     over the (row, rel)-sorted plan;
//   - narrow outputs (d_out <= 16) split the warp into groups of G lanes
//     that work on 32/G edges at a time and are reduced with shuffles at
//     the end of the row, so lanes are not left idle at d_out = 4..16;
//   - each lane owns output columns; the gathered feature row is loaded
//     once, coalesced, and broadcast element by element with a shuffle;
//   - inputs may be f32 or bf16, every sum is f32;
//   - no vector loads: rows of any width (63, 11, ...) are read as scalars,
//     so nothing assumes 16-byte-aligned rows.
// A simple design: tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kWarpsPerBlock = 32;
// shared memory a block may use on sm_90 (227 KB)
constexpr size_t kMaxSmem = 232448;

// One warp per output row (grid-stride over persistent blocks), relations
// [r_lo, r_hi) only, whose W slice the block stages in shared memory. G
// lanes per edge group, OC output chunks of G columns per lane: column
// o = c * G + (lane % G). add != 0: add to out instead of writing it.
template <typename T, int G, int OC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
span_rows_kernel(const T* __restrict__ feat, const T* __restrict__ w,
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
      const T* xr = feat + (size_t)s * K;
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
}

constexpr int kDwThreads = 256;
constexpr int kDwPerThread = 16;   // K * M <= 4096
constexpr int kDwTile = 32;        // edges staged in shared memory at a time

// One block per chunk of edges of one relation: partial[c] = sum over the
// chunk of x[src]^T (norm * g[dst]), laid out [K, M].
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
span_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const int* __restrict__ chunk_lo,
                       const int* __restrict__ chunk_hi,
                       const int* __restrict__ e_src,
                       const int* __restrict__ e_dst,
                       const float* __restrict__ e_norm,
                       float* __restrict__ partial, int K, int M) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [kDwTile, K]
  float* gs = smem + kDwTile * K;   // [kDwTile, M], norm applied
  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  const int P = K * M;
  float acc[kDwPerThread];
#pragma unroll
  for (int q = 0; q < kDwPerThread; ++q) acc[q] = 0.f;
  for (int base = lo; base < hi; base += kDwTile) {
    const int ne = min(kDwTile, hi - base);
    for (int t = threadIdx.x; t < ne * K; t += blockDim.x) {
      const int e = base + t / K;
      xs[t] = to_f(x[(size_t)e_src[e] * K + t % K]);
    }
    for (int t = threadIdx.x; t < ne * M; t += blockDim.x) {
      const int e = base + t / M;
      gs[t] = e_norm[e] * to_f(g[(size_t)e_dst[e] * M + t % M]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kDwPerThread; ++q) {
      const int p = threadIdx.x + q * kDwThreads;
      if (p < P) {
        const int k = p / M;
        const int m = p % M;
        float a = acc[q];
        for (int e = 0; e < ne; ++e) a = fmaf(xs[e * K + k], gs[e * M + m], a);
        acc[q] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kDwPerThread; ++q) {
    const int p = threadIdx.x + q * kDwThreads;
    if (p < P) partial[(size_t)c * P + p] = acc[q];
  }
}

// dW[r] = sum of relation r's chunk partials, in chunk order; 0 when r
// has no edges.
__global__ void span_dw_reduce_kernel(const float* __restrict__ partial,
                                      const int* __restrict__ rel_chunk_ptr,
                                      float* __restrict__ dw, int P) {
  const int r = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int c = rel_chunk_ptr[r]; c < rel_chunk_ptr[r + 1]; ++c)
    s += partial[(size_t)c * P + p];
  dw[(size_t)r * P + p] = s;
}

// Relation passes of at most kMaxSmem bytes of W each; persistent grid of
// as many blocks as fit on the card at once.
template <typename T, int G, int OC>
cudaError_t launch_rows(const void* feat, const void* w, const int* rowptr,
                        const int* idx, const int* rel, const float* norm,
                        float* out, int n_rows, int K, int M, int n_slots,
                        cudaStream_t stream) {
  auto kernel = span_rows_kernel<T, G, OC>;
  const size_t rel_bytes = sizeof(T) * K * M;
  const int rels_per_pass = (int)(kMaxSmem / rel_bytes);
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
    span_rows_kernel<T, G, OC><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
        static_cast<const T*>(feat), static_cast<const T*>(w), rowptr, idx,
        rel, norm, out, n_rows, K, M, r_lo, r_hi, n_slots, p > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_rows(const void* feat, const void* w, const int* rowptr,
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

template <typename T>
void launch_dw(const void* x, const void* g, const int* chunk_lo,
               const int* chunk_hi, const int* rel_chunk_ptr, const int* e_src,
               const int* e_dst, const float* e_norm, float* partial,
               float* dw, int n_chunks, int slots, int K, int M,
               cudaStream_t stream) {
  const int P = K * M;
  if (n_chunks > 0) {
    const size_t smem = sizeof(float) * kDwTile * (K + M);
    span_dw_partial_kernel<T><<<n_chunks, kDwThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), chunk_lo, chunk_hi,
        e_src, e_dst, e_norm, partial, K, M);
  }
  const dim3 grid((P + 255) / 256, slots);
  span_dw_reduce_kernel<<<grid, 256, 0, stream>>>(partial, rel_chunk_ptr, dw, P);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Widths: K <= 128 and M <= 128 (the
// wrapper checks). w holds n_slots relations of [K, M]. Returns the first
// error of the set-up calls or of a launch (cudaGetLastError()).
int span_rows(int dtype, const void* feat, const void* w, const int* rowptr,
              const int* idx, const int* rel, const float* norm, float* out,
              int n_rows, int K, int M, int n_slots, void* stream) {
  cudaError_t err = cudaSuccess;
  if (n_rows > 0 && n_slots > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
      err = dispatch_rows<__nv_bfloat16>(feat, w, rowptr, idx, rel, norm, out,
                                         n_rows, K, M, n_slots, s);
    else
      err = dispatch_rows<float>(feat, w, rowptr, idx, rel, norm, out, n_rows,
                                 K, M, n_slots, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// partial: [n_chunks, K, M] f32 scratch; dw: [slots, K, M] f32. K * M <=
// 4096 and K + M <= 256 (the wrapper checks).
int span_dw(int dtype, const void* x, const void* g, const int* chunk_lo,
            const int* chunk_hi, const int* rel_chunk_ptr, const int* e_src,
            const int* e_dst, const float* e_norm, float* partial, float* dw,
            int n_chunks, int slots, int K, int M, void* stream) {
  if (slots > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
      launch_dw<__nv_bfloat16>(x, g, chunk_lo, chunk_hi, rel_chunk_ptr, e_src,
                               e_dst, e_norm, partial, dw, n_chunks, slots, K, M, s);
    else
      launch_dw<float>(x, g, chunk_lo, chunk_hi, rel_chunk_ptr, e_src, e_dst,
                       e_norm, partial, dw, n_chunks, slots, K, M, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
