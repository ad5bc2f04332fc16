// Kernel #8 for Hopper (sm_90a): the span conv's backward, dx and dW in one
// pass over the src-sorted CSR, with compile-time variants that switch
// parts of the work off, for the attribution microbench
// (bwd_variants.py, wrapper ops/bwd_kernels.py). Plain C interface, bound
// with ctypes.
//
// Replaces scripts/bwd_variants.py:76 `kernel` (make_bwd), whose `base`
// variant computes, in one pass over src buckets,
//   dx[n] = sum_{e: src_e = n} norm_e * g[dst_e] @ W[rel_e]^T
//   dW[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g[dst_e])
// Variants (template flag V): kBase; kNoDw (dx only); kNoDx (dW only);
// kStatRmw (every edge's dW added into the first relation slot of its
// pass: wrong math, it measures the cost of indexing dW per relation, i.e.
// the contention of warps adding into one dW slice).
// None of the TPU kernel's machinery is carried over: no one-hot MXU
// gathers or scatters, no lane repeat, no tile-packed code/norm columns,
// no chunk grid.
//
// Design:
//   - one warp owns a src row (persistent blocks, grid stride); it loads
//     x[row] once per relation pass, and each edge's g[dst] row once, and
//     uses that row for both halves;
//   - the block stages W^T ([M, K] per relation, so lanes read
//     consecutive k) and a float32 dW accumulator ([M, K] per relation) in
//     shared memory for a pass of relations: at float32 64 -> 16 that is
//     4 KB + 4 KB per relation, so 91 slots take 4 passes; a pass finds the
//     row's edges of its relations with a warp ballot over the
//     (src, rel)-sorted plan, as span_rows_kernel does;
//   - lane l owns columns k = l + 32 j of dx[row] and of dW[r] (j < KC):
//     the edge's scaled g row (lane l holds m = l + 32 i, i < MC) is
//     broadcast column by column with a shuffle; dx sums in registers, dW
//     adds into shared memory with atomics (warps of a block meet on one
//     relation's slice), so dW is held to a tolerance and not to identical
//     bits;
//   - at the end of each pass a block writes its dW slice to its own
//     partial [block, slot, M, K]; a second kernel sums the blocks'
//     partials in block order into dW [slot, K, M];
//   - dx is written once in the first pass, added to in later passes by
//     the same warp (no atomics); rows with no edges get 0.
// What bounds it on an H100 is what the microbench measures (PERF.md):
// at the bench shape the f32 operations bound 4 E K M / 67 TFLOP/s, the
// bf16 bytes.
// A simple design: tensor cores, TMA and wgmma are later work.

#include "span_rows.cuh"

namespace {

using span::to_f;

constexpr int kThreads = span::kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kBase = 0, kNoDw = 1, kNoDx = 2, kStatRmw = 3 };

template <int V>
struct Flags {
  static constexpr bool dx = V != kNoDx;
  static constexpr bool dw = V != kNoDw;
  static constexpr bool stat = V == kStatRmw;
};

// Shared-memory bytes per relation of a pass.
template <typename T, int V>
size_t rel_bytes(int K, int M) {
  return (size_t)K * M * ((Flags<V>::dx ? sizeof(T) : 0) +
                          (Flags<V>::dw ? sizeof(float) : 0));
}

template <typename T, int KC, int MC, int V>
__global__ void __launch_bounds__(kThreads)
bwd_variant_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const T* __restrict__ wt, const int* __restrict__ rowptr,
                   const int* __restrict__ dst, const int* __restrict__ rel,
                   const float* __restrict__ norm, float* __restrict__ dx,
                   float* __restrict__ partial, int n_rows, int K, int M,
                   int n_slots, int pass_rels) {
  using F = Flags<V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per_rel = K * M;
  // [pass_rels, M, K] each: the dW accumulator (f32), then W^T (T)
  float* dws = reinterpret_cast<float*>(smem_raw);
  T* ws = reinterpret_cast<T*>(
      smem_raw + (F::dw ? sizeof(float) * pass_rels * per_rel : 0));
  const int lane = threadIdx.x & 31;
  const int warp0 = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;

  for (int r_lo = 0; r_lo < n_slots; r_lo += pass_rels) {
    const int r_hi = min(r_lo + pass_rels, n_slots);
    const int n_el = (r_hi - r_lo) * per_rel;
    if (F::dx) {
      const T* src = wt + (size_t)r_lo * per_rel;
      for (int i = threadIdx.x; i < n_el; i += blockDim.x) ws[i] = src[i];
    }
    if (F::dw)
      for (int i = threadIdx.x; i < n_el; i += blockDim.x) dws[i] = 0.f;
    __syncthreads();

    for (int row = warp0; row < n_rows; row += n_warps) {
      const int lo0 = rowptr[row];
      const int hi0 = rowptr[row + 1];
      // the row's edges are sorted by rel: count those below r_lo / r_hi
      int below_lo = 0, below_hi = 0;
      for (int b = lo0; b < hi0; b += 32) {
        const int rv = b + lane < hi0 ? rel[b + lane] : n_slots;
        below_lo += __popc(__ballot_sync(kFull, rv < r_lo));
        below_hi += __popc(__ballot_sync(kFull, rv < r_hi));
      }
      const int lo = lo0 + below_lo;
      const int hi = lo0 + below_hi;
      float acc[KC], xk[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int k = lane + 32 * j;
        acc[j] = 0.f;
        xk[j] = F::dw && lo < hi && k < K ? to_f(x[(size_t)row * K + k]) : 0.f;
      }
      // every loop bound below is uniform across the warp, so the
      // shuffles always see all 32 lanes
      for (int b = lo; b < hi; b += 32) {
        int my_d = 0, my_r = r_lo;
        float my_n = 0.f;
        if (b + lane < hi) {
          my_d = dst[b + lane];
          my_r = rel[b + lane];
          my_n = norm[b + lane];
        }
        const int ne = min(32, hi - b);
        for (int e = 0; e < ne; ++e) {
          const int d = __shfl_sync(kFull, my_d, e);
          const int r = __shfl_sync(kFull, my_r, e) - r_lo;
          const float nr = __shfl_sync(kFull, my_n, e);
          float t[MC];
#pragma unroll
          for (int i = 0; i < MC; ++i) {
            const int m = lane + 32 * i;
            t[i] = m < M ? nr * to_f(g[(size_t)d * M + m]) : 0.f;
          }
          const T* wr = ws + (size_t)r * per_rel;
          float* dr = dws + (size_t)(F::stat ? 0 : r) * per_rel;
#pragma unroll
          for (int i = 0; i < MC; ++i) {
#pragma unroll 4
            for (int mm = 0; mm < 32; ++mm) {
              const int m = 32 * i + mm;
              if (m >= M) break;
              const float tm = __shfl_sync(kFull, t[i], mm);
#pragma unroll
              for (int j = 0; j < KC; ++j) {
                const int k = lane + 32 * j;
                if (k < K) {
                  if (F::dx) acc[j] = fmaf(tm, to_f(wr[m * K + k]), acc[j]);
                  if (F::dw) atomicAdd(&dr[m * K + k], xk[j] * tm);
                }
              }
            }
          }
        }
      }
      if (F::dx) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            float* o = dx + (size_t)row * K + k;
            *o = r_lo == 0 ? acc[j] : *o + acc[j];
          }
        }
      }
    }
    __syncthreads();
    if (F::dw) {
      float* out = partial + ((size_t)blockIdx.x * n_slots + r_lo) * per_rel;
      for (int i = threadIdx.x; i < n_el; i += blockDim.x) out[i] = dws[i];
    }
    __syncthreads();  // the next pass restages shared memory
  }
}

// dw[r][k][m] = sum over blocks b, in block order, of partial[b][r][m][k];
// thread p walks the partials' [M, K] layout so its reads coalesce.
__global__ void bwd_dw_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dw, int n_blocks,
                                     int n_slots, int K, int M) {
  const int r = blockIdx.y;
  const int P = K * M;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b)
    s += partial[((size_t)b * n_slots + r) * P + p];
  dw[(size_t)r * P + (p % K) * M + p / K] = s;
}

__global__ void bwd_floor_kernel() {}

// The relations per pass and the persistent grid of one launch.
template <typename T, int KC, int MC, int V>
cudaError_t plan_launch(int K, int M, int n_slots, int n_rows, int* pass_rels,
                        size_t* smem, int* blocks) {
  auto kernel = bwd_variant_kernel<T, KC, MC, V>;
  const size_t per_rel = rel_bytes<T, V>(K, M);
  const int rels_per_pass = (int)(span::kMaxSmem / per_rel);
  if (rels_per_pass < 1 || n_slots < 1) return cudaErrorInvalidValue;
  const int n_pass = (n_slots + rels_per_pass - 1) / rels_per_pass;
  *pass_rels = (n_slots + n_pass - 1) / n_pass;
  *smem = per_rel * *pass_rels;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  int device = 0, n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int needed = (n_rows + span::kWarpsPerBlock - 1) / span::kWarpsPerBlock;
  *blocks = needed < per_sm * n_sm ? needed : per_sm * n_sm;
  return cudaSuccess;
}

struct Args {
  const void* g;
  const void* x;
  const void* wt;
  const int* rowptr;
  const int* dst;
  const int* rel;
  const float* norm;
  float* dx;
  float* partial;
  float* dw;
  int n_rows, K, M, n_slots, max_blocks;
};

template <typename T, int KC, int MC, int V>
cudaError_t run(const Args* a, int* blocks_out, cudaStream_t stream) {
  int pass_rels = 0, blocks = 0;
  size_t smem = 0;
  cudaError_t err = plan_launch<T, KC, MC, V>(a->K, a->M, a->n_slots,
                                              a->n_rows, &pass_rels, &smem,
                                              &blocks);
  if (err != cudaSuccess) return err;
  if (blocks_out != nullptr) {  // a query: the grid only
    *blocks_out = blocks;
    return cudaSuccess;
  }
  if (blocks > a->max_blocks) return cudaErrorInvalidValue;
  if (blocks > 0) {
    bwd_variant_kernel<T, KC, MC, V><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a->g), static_cast<const T*>(a->x),
        static_cast<const T*>(a->wt), a->rowptr, a->dst, a->rel, a->norm,
        a->dx, a->partial, a->n_rows, a->K, a->M, a->n_slots, pass_rels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Flags<V>::dw) {
    const int P = a->K * a->M;
    const dim3 grid((P + 255) / 256, a->n_slots);
    bwd_dw_reduce_kernel<<<grid, 256, 0, stream>>>(a->partial, a->dw, blocks,
                                                   a->n_slots, a->K, a->M);
  }
  return cudaGetLastError();
}

// The (KC, MC) specialisation for K, M <= 128.
template <typename T, int V>
cudaError_t dispatch_widths(const Args* a, int* blocks_out, cudaStream_t s) {
  const bool m1 = a->M <= 32;
  if (a->K <= 32)
    return m1 ? run<T, 1, 1, V>(a, blocks_out, s) : run<T, 1, 4, V>(a, blocks_out, s);
  if (a->K <= 64)
    return m1 ? run<T, 2, 1, V>(a, blocks_out, s) : run<T, 2, 4, V>(a, blocks_out, s);
  return m1 ? run<T, 4, 1, V>(a, blocks_out, s) : run<T, 4, 4, V>(a, blocks_out, s);
}

template <typename T>
cudaError_t dispatch_variant(int variant, const Args* a, int* blocks_out,
                             cudaStream_t s) {
  switch (variant) {
    case kBase: return dispatch_widths<T, kBase>(a, blocks_out, s);
    case kNoDw: return dispatch_widths<T, kNoDw>(a, blocks_out, s);
    case kNoDx: return dispatch_widths<T, kNoDx>(a, blocks_out, s);
    case kStatRmw: return dispatch_widths<T, kStatRmw>(a, blocks_out, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int variant, int dtype, const Args* a, int* blocks_out,
                     cudaStream_t s) {
  if (a->K < 1 || a->M < 1 || a->K > 128 || a->M > 128)
    return cudaErrorInvalidValue;
  return dtype == 1 ? dispatch_variant<__nv_bfloat16>(variant, a, blocks_out, s)
                    : dispatch_variant<float>(variant, a, blocks_out, s);
}

}  // namespace

extern "C" {

// variant: 0 base, 1 nodw, 2 nodx, 3 statrmw; dtype: 0 float32, 1 bfloat16.
// The persistent grid of a launch at these widths, for sizing `partial`.
int bwd_variant_grid(int variant, int dtype, int K, int M, int n_slots,
                     int n_rows, int* blocks) {
  Args a{};
  a.n_rows = n_rows;
  a.K = K;
  a.M = M;
  a.n_slots = n_slots;
  return static_cast<int>(dispatch(variant, dtype, &a, blocks, nullptr));
}

// g [n_dst, M], x [n_rows, K], wt [slots, M, K] (W transposed), the
// src-sorted CSR (rowptr [n_rows + 1], dst, rel, norm [E]); dx [n_rows, K]
// f32 (unused by nodx), partial [max_blocks, slots, M, K] f32 scratch and
// dw [slots, K, M] f32 (unused by nodw). Returns the first error of the
// set-up calls or of a launch (cudaGetLastError()).
int bwd_variant(int variant, int dtype, const void* g, const void* x,
                const void* wt, const int* rowptr, const int* dst,
                const int* rel, const float* norm, float* dx, float* partial,
                float* dw, int n_rows, int K, int M, int n_slots,
                int max_blocks, void* stream) {
  const Args a{g, x, wt, rowptr, dst, rel, norm, dx, partial, dw,
               n_rows, K, M, n_slots, max_blocks};
  return static_cast<int>(dispatch(variant, dtype, &a, nullptr,
                                   static_cast<cudaStream_t>(stream)));
}

// One empty launch: the microbench's harness floor.
int bwd_floor(void* stream) {
  bwd_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
