// Span kernels of the R-GCN conv for Hopper (sm_90a) on the CUDA cores:
// gather, per-edge relational matmul and segment sum in one pass, with a
// plain C interface (bound from Python with ctypes, see
// ops/span_kernels.py). They are the earlier routes of kernels #1 and #2,
// which now run on the tensor cores (span_fwd_tc.cu, span_bwd_tc.cu); no
// main path calls them (span_forward_rows, span_backward_rows).
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
// partials of each relation in chunk order (span_dw_reduce_kernel, shared
// with span_bwd_tc.cu in span_tc.cuh), so runs reproduce bit for bit (the
// TPU kernel summed dW across its sequential grid; CUDA blocks run in no
// order and a shared accumulator would race).
//
// span_rows_kernel (csrc/span_rows.cuh, shared with halo_kernels.cu's
// kernel #7) says what bounds the row kernel on an H100 and how it is
// built: W staged in shared memory in relation passes, one warp per output
// row, write-once, no atomics.

#include "span_rows.cuh"
#include "span_tc.cuh"

namespace {

using span::to_f;

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
  launch_dw_reduce(partial, rel_chunk_ptr, dw, slots, P, stream);
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
      err = span::dispatch_rows<__nv_bfloat16>(
          span::DenseRows<__nv_bfloat16>{
              static_cast<const __nv_bfloat16*>(feat)},
          w, rowptr, idx, rel, norm, out, n_rows, K, M, n_slots, s);
    else
      err = span::dispatch_rows<float>(
          span::DenseRows<float>{static_cast<const float*>(feat)}, w, rowptr,
          idx, rel, norm, out, n_rows, K, M, n_slots, s);
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
