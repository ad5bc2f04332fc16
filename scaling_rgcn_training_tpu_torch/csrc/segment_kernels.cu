// Sorted-key segment sum for Hopper (sm_90a), with a plain C interface
// (bound from Python with ctypes, see ops/segment_kernels.py).
//
// segment_sum replaces the JAX package's
//   scaling_rgcn_training_tpu/ops/segment_kernels.py:87 _seg_kernel
//     (via sorted_segment_sum_pallas)
//     out[k] = sum_{e: keys_e = k} vals_e   for keys in ascending order.
// The TPU kernel turns each bucket of keys into a one-hot [chunk, S] tile
// and reduces it on the MXU, because a TPU scatter past VMEM falls off a
// cliff and a TPU has no atomics. Neither holds here, and the one-hot
// product is not carried over: the keys arrive as a CSR row pointer
// (values rowptr[k] .. rowptr[k+1] - 1 belong to row k), and
//   - a group of G lanes owns whole output rows: it sums its row's
//     contiguous range of values in f32, in order, and writes the row once,
//     so there are no atomics, two runs give the same bits, and rows with
//     no values are written as 0;
//   - lane l of a group owns columns l, l + G, ... (OC of them per pass), so
//     a group reads each value row with neighbouring lanes on neighbouring
//     addresses; narrow rows (h <= 16) use groups of 4, 8 or 16 lanes so
//     lanes are not left idle;
//   - values may be f32 or bf16; the sums and the output are f32;
//   - no vector loads: rows of any width are read as scalars.
// What bounds it on an H100: bytes. It reads E * h values once and writes
// M * h sums once, with one add per value read (at the bench shape's
// forward scatter, [4M, 16] f32 -> [200k, 16]: 0.27 GB, 0.08 ms at
// 3.35 TB/s), so the design aims at full, coalesced reads and nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kThreads = 256;

template <typename T, int G, int OC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals, const int* __restrict__ rowptr,
                   float* __restrict__ out, int n_rows, int h) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (row >= n_rows) return;
  const int lg = threadIdx.x % G;
  const int lo = rowptr[row];
  const int hi = rowptr[row + 1];
  for (int c0 = 0; c0 < h; c0 += G * OC) {
    float acc[OC];
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
      const T* v = vals + (size_t)e * h + c0;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int o = c * G + lg;
        if (c0 + o < h) acc[c] += to_f(v[o]);
      }
    }
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int o = c0 + c * G + lg;
      if (o < h) out[(size_t)row * h + o] = acc[c];
    }
  }
}

template <typename T, int G, int OC>
cudaError_t launch(const void* vals, const int* rowptr, float* out, int n_rows,
                   int h, cudaStream_t stream) {
  const long long threads = (long long)n_rows * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<T, G, OC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), rowptr, out, n_rows, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* vals, const int* rowptr, float* out,
                     int n_rows, int h, cudaStream_t s) {
  if (h <= 4) return launch<T, 4, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 8) return launch<T, 8, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 16) return launch<T, 16, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 32) return launch<T, 32, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 64) return launch<T, 32, 2>(vals, rowptr, out, n_rows, h, s);
  return launch<T, 32, 4>(vals, rowptr, out, n_rows, h, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vals [E, h] in key order, rowptr
// [n_rows + 1] int32 (non-decreasing, rowptr[n_rows] = E), out [n_rows, h]
// f32. Returns cudaGetLastError() after the launch.
int segment_sum(int dtype, const void* vals, const int* rowptr, float* out,
                int n_rows, int h, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(vals, rowptr, out, n_rows, h, s)
      : dispatch<float>(vals, rowptr, out, n_rows, h, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
