// Sorted-key segment sum for Hopper (sm_90a), with a plain C interface
// (bound from Python with ctypes, see ops/segment_kernels.py).
//
// segment_sum replaces the JAX package's
//   scaling_rgcn_training_tpu/ops/segment_kernels.py:87 _seg_kernel
//     (via sorted_segment_sum_pallas)
//     out[k] = sum_{e: keys_e = k} vals_e   for keys in ascending order,
// together with the two passes the JAX package runs before it
// (ops/rgcn_conv.py: msg * norm, then jnp.take(msg, dst_perm)):
//     out[k] = sum_{e = rowptr[k]}^{rowptr[k+1]-1} scale[p_e] * vals[p_e]
// with p_e = perm[e] (or e without perm) and scale optional (in vals'
// order). The TPU kernel turns each bucket of keys into a one-hot
// [chunk, S] tile and reduces it on the MXU, because a TPU scatter past
// VMEM falls off a cliff, a TPU has no atomics, and Mosaic cannot gather
// inside a kernel, so the values arrive already permuted into key order.
// None of that holds here, and the one-hot product is not carried over:
//   - a group of G lanes owns whole output rows: it sums its row's values
//     in f32, in edge order, and writes the row once, so there are no
//     atomics, two runs give the same bits, and rows with no values are
//     written as 0;
//   - the gather is inside: each value row is read from
//     vals + (size_t)perm[e] * h (64-bit offsets: 12M edges x 64 x 4 B is
//     past 2^31), perm and the row pointer through the read-only path;
//   - a lane reads 16-byte units (4 f32 or 8 bf16 columns) and a row of
//     h * elt bytes takes h * elt / 16 lanes; where the row or the base
//     pointer is not 16-byte aligned, the same kernel takes 8-, 4- or
//     2-byte units;
//   - a lane issues the loads of kAhead values before it adds any (with
//     no predicate: past the row's end it reads its last value again, and
//     the value rows skip L1), then adds them in edge order; the scale is
//     multiplied with __fmul_rn (no FMA contraction) and 1.0f stands in
//     for no scale, which is exact, so the sums are those of the earlier
//     route (segment_sum_rows: the multiply and the gather as separate
//     passes, then segment_sum_rows_kernel), bit for bit.
// What bounds it on an H100: bytes. It reads each value row, perm, scale
// and the row pointer once and writes each sum once, with one multiply and
// one add per value (at the bench shape's forward sum, [4M, 16] f32 in
// relation order -> [200k, 16] with perm and scale: 0.30 GB, 0.09 ms at
// 3.35 TB/s). The row reads are scattered: a 16-wide f32 row is two 32-byte
// sectors, a bf16 row one, and the scale read costs a sector for 4 bytes.
//
// segment_sum_rows is the earlier route's kernel: values already in key
// order, scalar loads, groups of 4 to 32 lanes a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// values whose loads a lane has in flight before it adds the first
constexpr int kAhead = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// One VB-byte unit of a value row: VB / sizeof(T) columns, read as one
// load through the read-only path.
template <typename T, int VB>
struct Unit {
  static constexpr int kCols = VB / static_cast<int>(sizeof(T));
  static constexpr int kWords = VB >= 4 ? VB / 4 : 1;
  uint32_t w[kWords];

  // read-only, and not allocated in L1: a value row is read once, and its
  // lines would evict the scale's and the permutation's
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VB == 16) {
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
    } else if constexpr (VB == 8) {
      asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                   : "=r"(w[0]), "=r"(w[1]) : "l"(p));
    } else if constexpr (VB == 4) {
      asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                   : "=r"(w[0]) : "l"(p));
    } else {
      unsigned short v;
      asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];"
                   : "=h"(v) : "l"(p));
      w[0] = v;
    }
  }

  // column c as f32 (a bf16 is the top half of its f32: exact)
  __device__ __forceinline__ float col(int c) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[c]);
    } else {
      const uint32_t v = w[c >> 1];
      return __uint_as_float((c & 1) ? (v & 0xffff0000u) : (v << 16));
    }
  }
};

// NC f32 sums to out[0 .. NC), as 16- or 8-byte stores where NC allows
// (out is then aligned to them: the row width is a multiple of NC)
template <int NC>
__device__ __forceinline__ void store(float* out, const float (&acc)[NC]) {
  if constexpr (NC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < NC; c += 4)
      *reinterpret_cast<float4*>(out + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  } else if constexpr (NC == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(acc[0], acc[1]);
  } else {
    out[0] = acc[0];
  }
}

// at most 64 registers, so four blocks share an SM
template <typename T, int VB, int G>
__global__ void __launch_bounds__(kThreads, 4)
segment_sum_kernel(const T* __restrict__ vals, const int* __restrict__ perm,
                   const float* __restrict__ scale,
                   const int* __restrict__ rowptr, float* __restrict__ out,
                   int n_rows, int h) {
  using U = Unit<T, VB>;
  constexpr int NC = U::kCols;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (row >= n_rows) return;
  const int lo = __ldg(rowptr + row);
  const int hi = __ldg(rowptr + row + 1);
  const int units = h / NC;
  // a row wider than G units takes several passes over its values
  for (int u = threadIdx.x % G; u < units; u += G) {
    const T* col0 = vals + (size_t)u * NC;
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    for (int e0 = lo; e0 < hi; e0 += kAhead) {
      // past the row's end the lane reads its last value again, so the
      // loads carry no predicate and issue back to back (guarded loads
      // compile to a branch each, with one load in flight)
      int idx[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int e = min(e0 + j, hi - 1);
        idx[j] = perm ? __ldg(perm + e) : e;
      }
      U v[kAhead];
      float s[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        v[j].load(col0 + (size_t)idx[j] * h);
        s[j] = scale ? __ldg(scale + idx[j]) : 1.f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (e0 + j < hi) {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[c] = __fadd_rn(acc[c], __fmul_rn(s[j], v[j].col(c)));
        }
      }
    }
    store<NC>(out + (size_t)row * h + (size_t)u * NC, acc);
  }
}

template <typename T, int VB, int G>
cudaError_t launch(const void* vals, const int* perm, const float* scale,
                   const int* rowptr, float* out, int n_rows, int h,
                   cudaStream_t stream) {
  const long long threads = (long long)n_rows * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<T, VB, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), perm, scale, rowptr, out, n_rows, h);
  return cudaGetLastError();
}

// G: the least power of two lanes that covers a row's units, at most 32
template <typename T, int VB>
cudaError_t by_width(const void* vals, const int* perm, const float* scale,
                     const int* rowptr, float* out, int n_rows, int h,
                     cudaStream_t s) {
  const int units = h * static_cast<int>(sizeof(T)) / VB;
  if (units <= 1) return launch<T, VB, 1>(vals, perm, scale, rowptr, out, n_rows, h, s);
  if (units <= 2) return launch<T, VB, 2>(vals, perm, scale, rowptr, out, n_rows, h, s);
  if (units <= 4) return launch<T, VB, 4>(vals, perm, scale, rowptr, out, n_rows, h, s);
  if (units <= 8) return launch<T, VB, 8>(vals, perm, scale, rowptr, out, n_rows, h, s);
  if (units <= 16) return launch<T, VB, 16>(vals, perm, scale, rowptr, out, n_rows, h, s);
  return launch<T, VB, 32>(vals, perm, scale, rowptr, out, n_rows, h, s);
}

// the widest unit that divides both the row's bytes and the base address
template <typename T>
cudaError_t dispatch(const void* vals, const int* perm, const float* scale,
                     const int* rowptr, float* out, int n_rows, int h,
                     cudaStream_t s) {
  const size_t row_bytes = (size_t)h * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(vals);
  auto fits = [&](size_t vb) { return row_bytes % vb == 0 && base % vb == 0; };
  if (fits(16)) return by_width<T, 16>(vals, perm, scale, rowptr, out, n_rows, h, s);
  if (fits(8)) return by_width<T, 8>(vals, perm, scale, rowptr, out, n_rows, h, s);
  if constexpr (sizeof(T) == 4) {
    return by_width<T, 4>(vals, perm, scale, rowptr, out, n_rows, h, s);
  } else {
    if (fits(4)) return by_width<T, 4>(vals, perm, scale, rowptr, out, n_rows, h, s);
    return by_width<T, 2>(vals, perm, scale, rowptr, out, n_rows, h, s);
  }
}

// -- the earlier route: values in key order, scalar loads ----------------

template <typename T, int G, int OC>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows_kernel(const T* __restrict__ vals,
                        const int* __restrict__ rowptr,
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
cudaError_t launch_rows(const void* vals, const int* rowptr, float* out,
                        int n_rows, int h, cudaStream_t stream) {
  const long long threads = (long long)n_rows * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  segment_sum_rows_kernel<T, G, OC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), rowptr, out, n_rows, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* vals, const int* rowptr, float* out,
                          int n_rows, int h, cudaStream_t s) {
  if (h <= 4) return launch_rows<T, 4, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 8) return launch_rows<T, 8, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 16) return launch_rows<T, 16, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 32) return launch_rows<T, 32, 1>(vals, rowptr, out, n_rows, h, s);
  if (h <= 64) return launch_rows<T, 32, 2>(vals, rowptr, out, n_rows, h, s);
  return launch_rows<T, 32, 4>(vals, rowptr, out, n_rows, h, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vals [E_v, h]; perm [E] int32 indices
// into vals' rows (in range; null: vals is in key order, E_v = E); scale
// [E_v] f32 in vals' order (null: none); rowptr [n_rows + 1] int32
// (non-decreasing, rowptr[n_rows] = E); out [n_rows, h] f32. Returns
// cudaGetLastError() after the launch.
int segment_sum(int dtype, const void* vals, const int* perm,
                const float* scale, const int* rowptr, float* out, int n_rows,
                int h, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(vals, perm, scale, rowptr, out, n_rows, h, s)
      : dispatch<float>(vals, perm, scale, rowptr, out, n_rows, h, s);
  return static_cast<int>(err);
}

// the earlier route's sum: vals [E, h] already in key order
int segment_sum_rows(int dtype, const void* vals, const int* rowptr,
                     float* out, int n_rows, int h, void* stream) {
  if (n_rows <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch_rows<__nv_bfloat16>(vals, rowptr, out, n_rows, h, s)
      : dispatch_rows<float>(vals, rowptr, out, n_rows, h, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
