// Kernel #8 for Hopper (sm_90a): the span conv's backward, dx and dW in one
// pass, with compile-time variants that switch parts of the work off, for
// the attribution microbench (bwd_variants.py, wrapper ops/bwd_kernels.py).
// Plain C interface, bound with ctypes.
//
// Replaces scripts/bwd_variants.py:76 `kernel` (make_bwd), whose `base`
// variant computes, in one pass over src buckets,
//   dx[n] = sum_{e: src_e = n} norm_e * g[dst_e] @ W[rel_e]^T
//   dW[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g[dst_e])
// on a grid (src bucket j, chunk ci) whose dx block stays resident across
// the bucket's chunks while dW is read, modified and written at the
// chunk's relation band. Two routes live here.
//
// bwd_tc_kernel, the redesign: that design on the tensor cores. Edges come
// sorted by (src / B, rel, src) (ops/bwd_kernels.py plan_buckets): a
// bucket's B src rows, relation by relation. For one src row that is the
// relation order of the (src, rel)-sorted CSR that kernel #2's dx sum walks.
//   - Persistent blocks of 8 warps, one per SM, each owning a contiguous
//     range of buckets (balanced by edges). The block sweeps its buckets
//     once per pass of relations; a pass's dW [pass_rels, K, M] f32 lives
//     in shared memory (at 64 -> 16 f32 and B = 128, 23 relations: 4
//     passes), and each edge is read in exactly one pass.
//   - Per bucket: x[bucket] [B, K] and the bucket's dx accumulator [B, K]
//     f32 are staged in shared memory (cp.async); the accumulator is zeroed
//     in the first pass and read back and added to in later ones.
//   - Per (bucket, relation) segment, in stages of four 16-edge tiles:
//     warps 0-3 each gather one tile's g[dst] rows by cp.async, one stage
//     ahead, and scale them by norm in the input type (as #2 does); for
//     float32 they also split each row on its grid (span_tc.cuh Grid,
//     tf32_round), once for every warp that reads it. W[r] comes staged
//     from the layout bwd_wsplit_kernel writes once a call (its rows and
//     each row's top), one segment ahead into the other of two buffers.
//   - dx: the messages as dx^T = W[r] (norm g)^T on mma.sync: a warp's A
//     operand is 16 rows of W[r] (a 16-column slice of dx), split on each
//     row's grid as it loads it; its B operand eight edges' split rows;
//     span_tc.cuh tile_times_staged's operands, grids and four products
//     with the roles swapped. The messages land in shared memory, and after
//     a block barrier each thread of (a part of the stage's edges cut
//     where a row's run starts, column) adds its rows' messages into their
//     shared dx rows in edge order, so no atomics are needed: the sums of
//     #2's CSR sum.
//   - dW: x_tile^T (norm g)_tile with the x rows read from the staged
//     bucket through each edge's row in the bucket: span_tc.cuh DwA's
//     operand and grids (loaded through the rows here) and dw_tile_product,
//     with DwTiles' ownership over 8 warps, each warp owning fixed 16 x 8
//     tiles of dW[r] (summed in registers over a segment, two edge tiles at
//     a time, then added into the shared dW[r] by the warp that owns them),
//     so no atomics are needed.
//   - At a pass's end the block writes its dW slice once to its partial
//     [block, slot, K, M]; bwd_tc_reduce_kernel sums the partials in block
//     order. No [E, K] scratch, no separate CSR-sum launch, and the same
//     bits on every run for dx and dW.
// Variants (template flag V): kTcBase; kTcNoDw (dx only); kTcNoDx (dW
// only); kTcTf32 (float32 with one TF32 product per multiply-add, the
// operands rounded to TF32 instead of split: wrong bits, kept to time the
// split; bfloat16 inputs run kTcBase).
// What bounds it on an H100: at layer 1 of the bench shape (E = 4M, 64 ->
// 16, f32) the 3xTF32 operations of span_kernels.backward_cost, 0.099 ms
// at the TF32 peak; its DRAM bytes are 0.2-0.4 GB (g, x once a pass, the
// dx accumulator's round trips between passes, the plan). The design keeps
// every per-edge intermediate on chip. What holds it back at the bench
// shape is neither (PERF.md, the microbench's --phases): a bucket's
// segment of one relation averages 28 edges at B = 128, so a block runs
// ~1,100 stages of at most 64 edges, each a chain of gather, scale,
// products, run adds and dW adds between two block barriers, with two
// warps on each SM sub-partition.
//
// bwd_variant_kernel, the earlier route (no main path calls it; the
// microbench's simt and statrmw rows): one warp owns a src row over the
// src-sorted CSR (persistent blocks, grid stride) and uses each edge's g
// row for both halves on the CUDA cores; the block stages W^T ([M, K] per
// relation) and a float32 dW accumulator in shared memory for a pass of
// relations (4 passes at f32 64 -> 16), finding the row's edges of its
// relations with a warp ballot; lane l owns columns k = l + 32 j of dx[row]
// and of dW[r]; dx sums in registers, dW adds into shared memory with
// atomics, so its dW is held to a tolerance and not to identical bits. Its
// variants: kBase, kNoDw, kNoDx and kStatRmw (every edge's dW added into
// the first relation slot of its pass: wrong math, the cost of indexing dW
// per relation). At the end of each pass a block writes its dW slice to its
// partial [block, slot, M, K]; bwd_dw_reduce_kernel sums them in block
// order.
// None of the TPU kernel's machinery is carried over by either route: no
// one-hot MXU gathers or scatters, no lane repeat, no tile-packed
// code/norm columns, no chunk grid.

#include "span_rows.cuh"
#include "span_tc.cuh"

namespace {

using span::to_f;

constexpr int kThreads = span::kWarpsPerBlock * 32;

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

// -- the redesign on the tensor cores: bwd_tc_kernel ------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
// a stage: four 16-edge tiles, one gathered by each of warps 0..3
constexpr int kGatherWarps = 4;
constexpr int kStageEdges = 16 * kGatherWarps;
constexpr int kStageN8 = kStageEdges / 8;
// 16 x 8 dW tiles a warp keeps in registers: ceil(K / 16) ceil(M / 8) <=
// 48 (checked) over 8 warps
constexpr int kTcMaxDwTiles = 6;
constexpr int kTcMaxK = 128;

enum TcVariant { kTcBase = 0, kTcNoDw = 1, kTcNoDx = 2, kTcTf32 = 3 };

template <int V>
struct TcFlags {
  static constexpr bool dx = V != kTcNoDx;
  static constexpr bool dw = V != kTcNoDw;
  static constexpr bool tf32 = V == kTcTf32;
};

// How a dx product splits its float32 operands: kModeSplit (#2's four
// products on fixed-point grids), kModeTf32 (one TF32 product, the tf32
// variant), kModeBf16 (one exact bfloat16 product).
enum TcMode { kModeSplit = 0, kModeTf32 = 1, kModeBf16 = 2 };

// The least stride >= n with stride % (2 res) == res: 8 rows of a fragment
// load (4 lanes of 4 bytes each) fall on 32 banks (res 4 for float32, 8
// for bfloat16 pairs), with less padding than span_tc.cuh padded_stride.
__host__ __device__ __forceinline__ int frag_stride(int n, int res) {
  return n + ((res - n % (2 * res)) + 2 * res) % (2 * res);
}

// Shared memory of one block, in order: x[bucket] [B, ldx] (T; dW only),
// the dx accumulator [B, ldd] f32 (dx only), two W[r] buffers of w_bytes
// (dx only: W[r] [Kx, ldw] in T, then each row's largest |value| [Kx]
// f32), two stages of four g tiles [16, ldg] (T; scaled by norm), for the
// float32 split their big and small parts (2 x two stages of four [16,
// ldg] f32), the stages' in-bucket rows (2 x kStageEdges ints), the
// stage's dx messages [kStageEdges, ldm] f32 (dx only), the bucket's
// segment offsets (n_slots + 1 ints), then the pass's dW [pass_rels, K, M]
// f32.
template <typename T>
struct TcDims {
  int Kx, Mg, Mn, n_dw, n_slices, ldx, ldg, ldw, ldd, ldm, tile_elems;
  size_t w_bytes, w_top, tiles_bytes, off_dx, off_w, off_g, off_split,
      off_rows, off_msg, off_offs, fixed;
  __host__ __device__ TcDims(int K, int M, int B, int n_slots, bool dx,
                             bool dw, bool split) {
    using S = TileShape<T>;
    Kx = round_up(K, 16);      // m16 tiles: dx slices and dW rows
    Mg = round_up(M, S::kK);   // the depth of dx; dW columns
    Mn = (M + 7) / 8;
    n_dw = Kx / 16 * Mn;
    n_slices = Kx / 16;
    // x is read down its columns through the edges' rows (#2's stride)
    ldx = padded_stride(Kx, 8, 32);
    ldg = frag_stride(Mg, S::kRes);
    ldw = ldg;
    ldd = round_up(K, 4);
    // message stores of lanes (g, t) at edge 2 t, column g: 32 banks
    ldm = frag_stride(K, 4);
    tile_elems = (int)(align16((size_t)16 * ldg * sizeof(T)) / sizeof(T));
    w_top = align16((size_t)Kx * ldw * sizeof(T));
    w_bytes = w_top + align16((size_t)Kx * sizeof(float));
    tiles_bytes = (size_t)2 * kGatherWarps * tile_elems * sizeof(T);
    off_dx = dw ? align16((size_t)B * ldx * sizeof(T)) : 0;
    off_w = off_dx + (dx ? align16((size_t)B * ldd * 4) : 0);
    off_g = off_w + (dx ? 2 * w_bytes : 0);
    off_split = off_g + tiles_bytes;
    off_rows = off_split + (dx && split ? 2 * tiles_bytes : 0);
    off_msg = off_rows + 2 * kStageEdges * sizeof(int);
    off_offs = off_msg + (dx ? align16((size_t)kStageEdges * ldm * 4) : 0);
    fixed = off_offs + align16((size_t)(n_slots + 1) * sizeof(int));
  }
};

// The pointers and sizes of one call.
struct TcArgs {
  const void* g;
  const void* x;
  const void* wsplit;
  const int* seg_ptr;
  const int* dst;
  const float* norm;
  const short* row;
  float* partial;
  float* dx;
  int n_src, n_buckets, B, K, M, n_slots, pass_rels, unit_x, unit_g;
};

// W[r] once a call in the layout a block stages (w_bytes a relation): rows
// k < Kx of W[r], ldw apart, zero-padded, then each row's largest |value|
// (the top of its fixed-point grid, span_tc.cuh Grid; #2 stages the same
// grids).
template <typename T>
__global__ void bwd_wsplit_kernel(const T* __restrict__ w,
                                  unsigned char* __restrict__ out, int K,
                                  int M, int Kx, int ldw, size_t w_top,
                                  size_t w_bytes) {
  const int r = blockIdx.x;
  const T* wr = w + (size_t)r * K * M;
  T* rows = reinterpret_cast<T*>(out + (size_t)r * w_bytes);
  float* top = reinterpret_cast<float*>(out + (size_t)r * w_bytes + w_top);
  for (int k = threadIdx.x; k < Kx; k += blockDim.x) {
    float t = 0.f;
    if (k < K)
      for (int m = 0; m < M; ++m) t = fmaxf(t, fabsf(as_float(wr[k * M + m])));
    top[k] = t;
  }
  for (int i = threadIdx.x; i < Kx * ldw; i += blockDim.x) {
    const int k = i / ldw;
    const int m = i - k * ldw;
    rows[i] = k < K && m < M ? wr[k * M + m] : zero<T>();
  }
}

// One stage: edges [lo, hi) of relation r (its index in the pass; -1:
// none) of the bucket, whose segment ends at seg_hi; seg counts the
// bucket's segments (its parity picks the W buffer).
struct TcStage {
  int r, lo, hi, seg_hi, seg;
};

__device__ __forceinline__ TcStage segment_stage(const int* offs, int r,
                                                 int n_r, int seg) {
  for (; r < n_r; ++r)
    if (offs[r + 1] > offs[r])
      return {r, offs[r], min(offs[r] + kStageEdges, offs[r + 1]),
              offs[r + 1], seg};
  return {-1, 0, 0, 0, seg};
}

__device__ __forceinline__ TcStage next_stage(const TcStage& s,
                                              const int* offs, int n_r) {
  if (s.r < 0) return s;
  if (s.lo + kStageEdges < s.seg_hi)
    return {s.r, s.lo + kStageEdges, min(s.lo + 2 * kStageEdges, s.seg_hi),
            s.seg_hi, s.seg};
  return segment_stage(offs, s.r + 1, n_r, s.seg + 1);
}

// Edge lane & 15 of a gathering warp's tile of a stage: dst, norm, row in
// the bucket (-1, 0, -1 past the stage, and for the other warps).
struct TcEdge {
  int dst;
  float norm;
  int row;
};

__device__ __forceinline__ TcEdge load_tc_edge(const TcArgs& a,
                                               const TcStage& s, int warp,
                                               int lane) {
  const int e = s.lo + 16 * warp + (lane & 15);
  return warp < kGatherWarps && s.r >= 0 && e < s.hi
             ? TcEdge{a.dst[e], a.norm[e], static_cast<int>(a.row[e])}
             : TcEdge{-1, 0.f, -1};
}

// A gathering warp's tile: its g rows times norm, in place, in T (as #2
// scales them); with kSplit also each row's big and small parts on the
// row's grid over its Mg values (the A rows of tile_times_staged: the B
// operand of dx^T here), so the warps of every dx slice read them split.
// Lanes 2 i and 2 i + 1 own row i, alternate columns; a row of at most 16
// values is held in registers, its loads ahead of its stores.
template <typename T, bool kSplit>
__device__ __forceinline__ void scale_tile(T* ts, float* tbig, float* tsmall,
                                           int ldg, int Mg, float norm,
                                           int lane) {
  const int row = lane >> 1, h = lane & 1;
  const float nr = __shfl_sync(kFull, norm, row);
  T* r = ts + row * ldg;
  float top = 0.f;
  if (Mg <= 16) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = h + 2 * i < Mg ? as_float(r[h + 2 * i]) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T sv = from_float<T>(nr * v[i]);
      v[i] = as_float(sv);
      top = fmaxf(top, fabsf(v[i]));
      if (h + 2 * i < Mg) r[h + 2 * i] = sv;
    }
    if constexpr (kSplit) {
      const Grid grid(fmaxf(top, __shfl_xor_sync(kFull, top, 1)));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float b = grid.big(v[i]);
        if (h + 2 * i < Mg) {
          tbig[row * ldg + h + 2 * i] = b;
          tsmall[row * ldg + h + 2 * i] = tf32_round(v[i] - b);
        }
      }
    }
    return;
  }
#pragma unroll 4
  for (int c = h; c < Mg; c += 2) {
    const T v = from_float<T>(nr * as_float(r[c]));
    r[c] = v;
    top = fmaxf(top, fabsf(as_float(v)));
  }
  if constexpr (kSplit) {
    const Grid grid(fmaxf(top, __shfl_xor_sync(kFull, top, 1)));
#pragma unroll 4
    for (int c = h; c < Mg; c += 2) {
      const float v = as_float(r[c]);
      const float b = grid.big(v);
      tbig[row * ldg + c] = b;
      tsmall[row * ldg + c] = tf32_round(v - b);
    }
  }
}

// DwA's operand with the x rows of the tile's 16 edges read from the staged
// bucket through their rows tr[e] (-1: a zero row); DwA::load's values,
// grids and split otherwise. kTf32: x rounded to TF32, no small parts.
template <bool kTf32>
__device__ __forceinline__ void load_dw_rows(DwA<float>& a, const float* xs,
                                             int ldx, const int* tr, int k0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* xa = xs + k0 + g;
  float v[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r0 = tr[8 * h + t], r4 = tr[8 * h + t + 4];
    v[h][0] = r0 >= 0 ? xa[r0 * ldx] : 0.f;
    v[h][1] = r0 >= 0 ? xa[r0 * ldx + 8] : 0.f;
    v[h][2] = r4 >= 0 ? xa[r4 * ldx] : 0.f;
    v[h][3] = r4 >= 0 ? xa[r4 * ldx + 8] : 0.f;
  }
  if constexpr (kTf32) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a.big[h][i] = bits(tf32_round(v[h][i]));
        a.small[h][i] = 0u;
      }
    return;
  }
  float top = 0.f, top8 = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    top = fmaxf(top, fmaxf(fabsf(v[h][0]), fabsf(v[h][2])));
    top8 = fmaxf(top8, fmaxf(fabsf(v[h][1]), fabsf(v[h][3])));
  }
  const Grid grid(quad_max(top)), grid8(quad_max(top8));
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float b = (i & 1 ? grid8 : grid).big(v[h][i]);
      a.big[h][i] = bits(b);
      a.small[h][i] = bits(tf32_round(v[h][i] - b));
    }
}

template <bool kTf32>
__device__ __forceinline__ void load_dw_rows(DwA<__nv_bfloat16>& a,
                                             const __nv_bfloat16* xs, int ldx,
                                             const int* tr, int k0, int lane) {
  const int g = lane >> 2, e = 2 * (lane & 3);
  const __nv_bfloat16* xa = xs + k0 + g;
  const auto at = [&](int edge, int off) {
    const int r = tr[edge];
    return r >= 0 ? xa[r * ldx + off] : zero<__nv_bfloat16>();
  };
  a.frag[0] = pack(at(e, 0), at(e + 1, 0));
  a.frag[1] = pack(at(e, 8), at(e + 1, 8));
  a.frag[2] = pack(at(e + 8, 0), at(e + 9, 0));
  a.frag[3] = pack(at(e + 8, 8), at(e + 9, 8));
}

// dw_tile_product with one TF32 product a step: A as loaded by
// load_dw_rows<true>, B rounded to TF32.
__device__ __forceinline__ void dw_tile_product_tf32(float (&run)[4],
                                                     const DwA<float>& a,
                                                     const float* gs, int ldg,
                                                     int m0, int lane) {
  const int t = lane & 3;
  const float* gb = gs + m0 + (lane >> 2);
  float big[4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float part[4];
    mma_tf32(part, a.big[h], bits(tf32_round(gb[(8 * h + t) * ldg])),
             bits(tf32_round(gb[(8 * h + t + 4) * ldg])));
#pragma unroll
    for (int i = 0; i < 4; ++i) big[i] += part[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] += big[i];
}

// The stage's dx messages of one 16-column slice (rows kb.. of W[r]) over
// NT of the stage's 8-edge tiles j = j0, j0 + js, ... (those past n8 are
// formed from tile j0 and not stored): msg[e, k] = sum_m W[r][k, m] t[e,
// m], t the scaled g rows (tile j >> 1, rows (j & 1) * 8 + g).
// tile_times_staged's operands with A and B swapped: A = W[r] rows, split
// here on each row's grid (its staged top), B = the t columns as
// scale_tile split them, the four products summed as there (big in acc,
// the three others in sm), then acc + sm; kModeTf32 one TF32 product of
// rounded operands; kModeBf16 one exact product.
template <typename T, int kMode, int NT>
__device__ __forceinline__ void dx_slice(const T* ws, const float* wtop,
                                         int ldw, int Mg, int kb, const T* ts,
                                         const float* tbig,
                                         const float* tsmall, int tile_elems,
                                         int ldg, int j0, int js, int n8,
                                         int n_valid, int K, float* msg,
                                         int ldm, int lane) {
  const int g = lane >> 2, t = lane & 3;
  int off[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int j = j0 + q * js < n8 ? j0 + q * js : j0;
    off[q] = (j >> 1) * tile_elems + ((j & 1) * 8 + g) * ldg;
  }
  float acc[NT][4], sm[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = sm[q][i] = 0.f;
  const Grid grid(kMode == kModeSplit ? wtop[kb + g] : 0.f);
  const Grid grid8(kMode == kModeSplit ? wtop[kb + g + 8] : 0.f);
  const T* w0 = ws + (kb + g) * ldw;
  const T* w8 = ws + (kb + g + 8) * ldw;
  for (int k0 = 0; k0 < Mg; k0 += TileShape<T>::kK) {
    unsigned a_big[4], a_small[4];
    if constexpr (kMode == kModeBf16) {
      a_big[0] = pair(w0 + k0 + 2 * t);
      a_big[1] = pair(w8 + k0 + 2 * t);
      a_big[2] = pair(w0 + k0 + 2 * t + 8);
      a_big[3] = pair(w8 + k0 + 2 * t + 8);
    } else {
      const float v[4] = {as_float(w0[k0 + t]), as_float(w8[k0 + t]),
                          as_float(w0[k0 + t + 4]), as_float(w8[k0 + t + 4])};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kMode == kModeSplit) {
          const float b = (i & 1 ? grid8 : grid).big(v[i]);
          a_big[i] = bits(b);
          a_small[i] = bits(tf32_round(v[i] - b));
        } else {
          a_big[i] = bits(tf32_round(v[i]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int at = off[q] + k0;
      float part[4];
      if constexpr (kMode == kModeSplit) {
        const unsigned bb0 = bits(tbig[at + t]), bb1 = bits(tbig[at + t + 4]);
        const unsigned bs0 = bits(tsmall[at + t]);
        const unsigned bs1 = bits(tsmall[at + t + 4]);
        mma_tf32(part, a_big, bb0, bb1);
        float cross[4];
        mma_tf32(cross, a_big, bs0, bs1);         // t small, W big
        mma_tf32_acc(cross, a_small, bb0, bb1);   // t big, W small
        mma_tf32_acc(cross, a_small, bs0, bs1);   // small x small
#pragma unroll
        for (int i = 0; i < 4; ++i) sm[q][i] += cross[i];
      } else if constexpr (kMode == kModeTf32) {
        mma_tf32(part, a_big, bits(tf32_round(as_float(ts[at + t]))),
                 bits(tf32_round(as_float(ts[at + t + 4]))));
      } else {
        mma_bf16(part, a_big, pair(ts + at + 2 * t), pair(ts + at + 2 * t + 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] += part[i];
    }
  }
  // lane (g, t) holds columns kb + g, kb + g + 8 of edges 8 j + 2 t, + 1
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int j = j0 + q * js;
    if (j >= n8) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kb + (i < 2 ? g : g + 8);
      const int e = 8 * j + 2 * t + (i & 1);
      if (k < K && e < n_valid) msg[e * ldm + k] = acc[q][i] + sm[q][i];
    }
  }
}

// dx_slice with NT the least of 1, 2, 4, 8 that covers the warp's tiles.
template <typename T, int kMode>
__device__ __forceinline__ void dx_slice_any(const T* ws, const float* wtop,
                                             int ldw, int Mg, int kb,
                                             const T* ts, const float* tbig,
                                             const float* tsmall,
                                             int tile_elems, int ldg, int j0,
                                             int js, int n8, int n_valid,
                                             int K, float* msg, int ldm,
                                             int lane) {
  const int n = (n8 - j0 + js - 1) / js;
#define TC_DX(NT)                                                           \
  dx_slice<T, kMode, NT>(ws, wtop, ldw, Mg, kb, ts, tbig, tsmall,           \
                         tile_elems, ldg, j0, js, n8, n_valid, K, msg, ldm, \
                         lane)
  if (n <= 0) return;
  if (n == 1) TC_DX(1);
  else if (n == 2) TC_DX(2);
  else if (n <= 4) TC_DX(4);
  else TC_DX(8);
#undef TC_DX
}

// Each src row's messages of the stage's n edges added into its dx row in
// edge order, without atomics: thread (part p, column k) walks edges
// [lo_p, hi_p) in order, the n edges cut into parts at the starts of
// rows' runs (one row's edges are consecutive within a segment), loading a
// row's dx value at its first edge and storing it after its last; four
// edges' rows and messages are loaded ahead of their adds.
__device__ __forceinline__ void add_runs(float* dxs, int ldd,
                                         const float* msg, int ldm,
                                         const int* rows, int n, int K,
                                         int tid) {
  const int parts = max(kTcThreads / K, 1);
  const int p = tid / K, k = tid - p * K;
  if (p >= parts) return;
  const auto cut = [&](int q) {
    int e = q * n / parts;
    while (e > 0 && e < n && rows[e] == rows[e - 1]) ++e;
    return e;
  };
  const int lo = cut(p), hi = cut(p + 1);
  int cur = -1;
  float acc = 0.f;
  for (int e0 = lo; e0 < hi; e0 += 4) {
    int r[4];
    float m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = min(e0 + u, hi - 1);
      r[u] = e0 + u < hi ? rows[e] : -1;
      m[u] = msg[e * ldm + k];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] < 0) break;
      if (r[u] != cur) {
        if (cur >= 0) dxs[cur * ldd + k] = acc;
        cur = r[u];
        acc = dxs[cur * ldd + k];
      }
      acc += m[u];
    }
  }
  if (cur >= 0) dxs[cur * ldd + k] = acc;
}

// The 16 x 8 tiles of dW[r] a warp owns and sums in registers over a
// segment: span_tc.cuh DwTiles' ownership over kTcWarps warps (consecutive
// tiles, which share their rows; with fewer tiles than warps, warps past
// the last own none, so no two warps add into one tile).
template <int kTiles>
struct TcDw {
  int Mn, first, n_own;
  float run[kTiles][4];

  __device__ __forceinline__ TcDw(int n_dw, int mn, int warp) : Mn(mn) {
    const int per_warp = (n_dw + kTcWarps - 1) / kTcWarps;
    first = warp * per_warp;
    n_own = max(min(per_warp, n_dw - first), 0);
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[q][i] = 0.f;
  }
};

// The warp's dW sums of a segment added into its relation's shared dW [K,
// M] (loads ahead of stores: no other warp touches these tiles), then
// cleared.
template <int kTiles>
__device__ __forceinline__ void flush_dw(TcDw<kTiles>& own, float* dwr,
                                         int K, int M, int lane) {
  const int g = lane >> 2, t = lane & 3;
  int at[kTiles][4];
  float old[kTiles][4];
#pragma unroll
  for (int q = 0; q < kTiles; ++q) {
    const int o = own.first + q;
    const int k0 = o / own.Mn * 16, m0 = o % own.Mn * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + (i < 2 ? g : g + 8), m = m0 + 2 * t + (i & 1);
      at[q][i] = q < own.n_own && k < K && m < M ? k * M + m : -1;
      old[q][i] = at[q][i] >= 0 ? dwr[at[q][i]] : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (at[q][i] >= 0) dwr[at[q][i]] = old[q][i] + own.run[q][i];
  own.clear();
}

// run[q] += x_tile^T t_tile over the stage's 16-edge tiles for the warp's
// dW tiles (span_tc.cuh dw_tile_product: DwA's operand loaded through the
// edges' rows), two edge tiles at a time: both tiles' operands and products
// ahead of the adds, which stay in tile order.
template <typename T, bool kTf32, int kTiles>
__device__ __forceinline__ void dw_stage(TcDw<kTiles>& own, const T* xs,
                                         int ldx, const int* rows,
                                         const T* tiles, int tile_elems,
                                         int ldg, int n_tiles, int lane) {
  const auto product = [&](float (&sum)[4], const DwA<T>& frag, const T* gs,
                           int m0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i] = 0.f;
    if constexpr (kTf32)
      dw_tile_product_tf32(sum, frag, gs, ldg, m0, lane);
    else
      dw_tile_product(sum, frag, gs, ldg, m0, lane);
  };
  for (int i = 0; i < n_tiles; i += 2) {
    const int i1 = i + 1 < n_tiles ? i + 1 : i;   // the same on every lane
    DwA<T> fa, fb;
    int loaded = -1;
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      if (q >= own.n_own) break;
      const int kt = (own.first + q) / own.Mn;
      if (kt != loaded) {
        load_dw_rows<kTf32>(fa, xs, ldx, rows + 16 * i, 16 * kt, lane);
        load_dw_rows<kTf32>(fb, xs, ldx, rows + 16 * i1, 16 * kt, lane);
        loaded = kt;
      }
      const int m0 = (own.first + q - kt * own.Mn) * 8;
      float sa[4], sb[4];
      product(sa, fa, tiles + i * tile_elems, m0);
      product(sb, fb, tiles + i1 * tile_elems, m0);
#pragma unroll
      for (int u = 0; u < 4; ++u) own.run[q][u] += sa[u];
      if (i1 != i)
#pragma unroll
        for (int u = 0; u < 4; ++u) own.run[q][u] += sb[u];
    }
  }
}

// The first bucket of block `blk` of `blocks`: the least b whose first edge
// is at or past blk E / blocks (every block gets about E / blocks edges).
__device__ __forceinline__ int first_bucket(const int* seg_ptr, int blk,
                                            int blocks, int n_buckets,
                                            int n_slots) {
  if (blk >= blocks) return n_buckets;
  const long long target =
      (long long)seg_ptr[(size_t)n_buckets * n_slots] * blk / blocks;
  int lo = 0, hi = n_buckets;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_ptr[(size_t)mid * n_slots] >= target) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Rows [row0, row0 + n_rows) of a [*, K] matrix into shared rows of stride
// ld by cp.async of `unit` bytes (copy_unit), or plain loads for 0.
template <typename T>
__device__ __forceinline__ void stage_rows(T* to, int ld, const T* from,
                                           size_t row0, int n_rows, int K,
                                           int unit, int tid) {
  if (unit > 0) {
    const int v = unit / (int)sizeof(T);
    const int kc = K / v;
    for (int c = tid; c < n_rows * kc; c += kTcThreads) {
      const int i = c / kc;
      const int k = (c - i * kc) * v;
      const T* src = from + (row0 + i) * K + k;
      if (unit == 16) cp_async16(to + i * ld + k, src, 16);
      else cp_async4(to + i * ld + k, src, 4);
    }
    return;
  }
  for (int c = tid; c < n_rows * K; c += kTcThreads) {
    const int i = c / K;
    const int k = c - i * K;
    to[i * ld + k] = from[(row0 + i) * K + k];
  }
}

// Phase timers of the microbench's --phases (built with -DBWD_TC_PHASES
// only): warp 0's clock64 cycles in each phase of the stage loop, summed
// per block, and the block's stages and bucket passes. Warp 0 gathers and
// scales a tile, so its barrier phases are its waits for the other warps.
constexpr int kTcPhases = 16;
constexpr int kTcPhaseBlocks = 1024;
#ifdef BWD_TC_PHASES
__device__ unsigned long long g_tc_phases[kTcPhaseBlocks][kTcPhases];
#define TC_PHASE_START unsigned long long tc_phase_t0 = clock64()
#define TC_PHASE(i)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0 && blockIdx.x < kTcPhaseBlocks) {               \
      const unsigned long long t_ = clock64();                           \
      g_tc_phases[blockIdx.x][i] += t_ - tc_phase_t0;                    \
      tc_phase_t0 = t_;                                                  \
    }                                                                    \
  } while (0)
#define TC_COUNT(i)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0 && blockIdx.x < kTcPhaseBlocks)                 \
      g_tc_phases[blockIdx.x][i] += 1;                                   \
  } while (0)
#else
#define TC_PHASE_START
#define TC_PHASE(i) do {} while (0)
#define TC_COUNT(i) do {} while (0)
#endif

template <typename T, int V, int kTiles>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_tc_kernel(TcArgs a) {
  TC_PHASE_START;
  using F = TcFlags<V>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kSplit = kF32 && !F::tf32;
  constexpr bool kTf32 = kF32 && F::tf32;
  constexpr int kMode = !kF32 ? kModeBf16 : kTf32 ? kModeTf32 : kModeSplit;
  const int K = a.K, M = a.M, B = a.B, slots = a.n_slots;
  const TcDims<T> d(K, M, B, slots, F::dx, F::dw, kSplit);
  extern __shared__ __align__(16) unsigned char bwd_tc_smem[];
  T* xs = reinterpret_cast<T*>(bwd_tc_smem);
  float* dxs = reinterpret_cast<float*>(bwd_tc_smem + d.off_dx);
  unsigned char* wbuf = bwd_tc_smem + d.off_w;
  T* tiles = reinterpret_cast<T*>(bwd_tc_smem + d.off_g);
  float* tbig = reinterpret_cast<float*>(bwd_tc_smem + d.off_split);
  float* tsmall = tbig + 2 * kGatherWarps * d.tile_elems;
  int* rows_s = reinterpret_cast<int*>(bwd_tc_smem + d.off_rows);
  float* msg = reinterpret_cast<float*>(bwd_tc_smem + d.off_msg);
  int* offs = reinterpret_cast<int*>(bwd_tc_smem + d.off_offs);
  float* dws = reinterpret_cast<float*>(bwd_tc_smem + d.fixed);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  // stage s's tile i (and its split parts) start at element (s & 1) * 4 + i
  // tiles in
  const auto tile_at = [&](int s, int i) {
    return ((s & 1) * kGatherWarps + i) * d.tile_elems;
  };

  const int b_lo = first_bucket(a.seg_ptr, blockIdx.x, gridDim.x,
                                a.n_buckets, slots);
  const int b_hi = first_bucket(a.seg_ptr, blockIdx.x + 1, gridDim.x,
                                a.n_buckets, slots);
  const int P = a.pass_rels, KM = K * M;
  if constexpr (F::dw) {
    // x columns K..Kx of the staged rows are read as zeros by dW's padding
    // rows, and no staging writes them
    for (int i = tid; i < B * (d.Kx - K); i += kTcThreads)
      xs[(i / (d.Kx - K)) * d.ldx + K + i % (d.Kx - K)] = zero<T>();
    for (int i = tid; i < P * KM; i += kTcThreads) dws[i] = 0.f;
  }
  TcDw<kTiles> own(d.n_dw, d.Mn, warp);
  // the warp's dx slices and 8-edge tiles (split warps share a slice)
  const int dx_split = d.n_slices >= kTcWarps ? 1 : kTcWarps / d.n_slices;
  const int dx_first = warp / dx_split, dx_sub = warp % dx_split;
  const int dx_step = d.n_slices >= kTcWarps ? kTcWarps : d.n_slices;

  for (int r_lo = 0; r_lo < slots; r_lo += P) {
    const int n_r = min(P, slots - r_lo);
    for (int b = b_lo; b < b_hi; ++b) {
      __syncthreads();   // every warp is done with the previous bucket
      for (int i = tid; i <= n_r; i += kTcThreads)
        offs[i] = a.seg_ptr[(size_t)b * slots + r_lo + i];
      const size_t row0 = (size_t)b * B;
      const int n_rows = min(B, a.n_src - (int)row0);
      __syncthreads();
      if (offs[n_r] == offs[0]) {   // no edge of the pass in this bucket
        if (F::dx && r_lo == 0)
          for (int i = tid; i < n_rows * K; i += kTcThreads)
            a.dx[row0 * K + i] = 0.f;
        continue;
      }
      if constexpr (F::dw) stage_rows(xs, d.ldx, x, row0, n_rows, K, a.unit_x, tid);
      if constexpr (F::dx) {
        if (r_lo == 0) {
          for (int i = tid; i < n_rows * d.ldd; i += kTcThreads) dxs[i] = 0.f;
        } else {
          stage_rows(dxs, d.ldd, a.dx, row0, n_rows, K, K % 4 == 0 ? 16 : 4,
                     tid);
        }
      }
      // stage s gathers stage s + 1's g rows (and W[r] at a new segment)
      // and loads stage s + 2's edges
      const auto issue = [&](int s, const TcStage& st, const TcEdge& e,
                             bool new_seg) {
        if (st.r < 0) return;
        if (warp < kGatherWarps && st.lo + 16 * warp < st.hi)
          gather_rows(tiles + tile_at(s, warp), DenseSrc<T>{g}, e.dst, M,
                      d.Mg, d.ldg, a.unit_g, lane);
        if constexpr (F::dx) {
          if (new_seg) {
            const unsigned char* from =
                static_cast<const unsigned char*>(a.wsplit)
                + (size_t)(r_lo + st.r) * d.w_bytes;
            unsigned char* to = wbuf + (st.seg & 1) * d.w_bytes;
            for (int c = tid; c < (int)(d.w_bytes / 16); c += kTcThreads)
              cp_async16(to + 16 * c, from + 16 * c, 16);
          }
        }
      };
      TC_COUNT(14);
      TcStage cur = segment_stage(offs, 0, n_r, 0);
      TcStage nxt = next_stage(cur, offs, n_r);
      TcEdge e_cur = load_tc_edge(a, cur, warp, lane);
      TcEdge e_nxt = load_tc_edge(a, nxt, warp, lane);
      issue(0, cur, e_cur, true);
      cp_commit();
      TC_PHASE(0);
      for (int s = 0; cur.r >= 0; ++s) {
        TC_COUNT(13);
        const TcStage after = next_stage(nxt, offs, n_r);
        const TcEdge e_after = load_tc_edge(a, after, warp, lane);
        TC_PHASE(1);
        cp_wait<0>();   // this thread's copies of stage s
        __syncwarp();
        TC_PHASE(2);
        const int n_valid = cur.hi - cur.lo;
        const int n_tiles = (n_valid + 15) >> 4;
        int* rows = rows_s + (s & 1) * kStageEdges;
        if (warp < kGatherWarps) {
          if (warp < n_tiles) {
            const int at = tile_at(s, warp);
            scale_tile<T, kSplit && F::dx>(tiles + at, tbig + at, tsmall + at,
                                           d.ldg, d.Mg, e_cur.norm, lane);
          }
          if (lane < 16) rows[16 * warp + lane] = e_cur.row;
        }
        TC_PHASE(3);
        // every copy, scale and row of stage s is in; stage s - 1's buffers
        // are free
        __syncthreads();
        TC_PHASE(4);
        issue(s + 1, nxt, e_nxt, nxt.seg != cur.seg);
        cp_commit();
        TC_PHASE(5);
        const int base = tile_at(s, 0);
        if constexpr (F::dx) {
          const T* ws = reinterpret_cast<const T*>(wbuf + (cur.seg & 1) * d.w_bytes);
          const float* wtop = reinterpret_cast<const float*>(
              wbuf + (cur.seg & 1) * d.w_bytes + d.w_top);
          const int n8 = (n_valid + 7) >> 3;
          for (int sl = dx_first; sl < d.n_slices; sl += dx_step)
            dx_slice_any<T, kMode>(ws, wtop, d.ldw, d.Mg, 16 * sl,
                                   tiles + base, tbig + base, tsmall + base,
                                   d.tile_elems, d.ldg, dx_sub, dx_split, n8,
                                   n_valid, K, msg, d.ldm, lane);
        }
        TC_PHASE(6);
        if constexpr (F::dw)
          if (own.n_own > 0)
            dw_stage<T, kTf32>(own, xs, d.ldx, rows, tiles + base,
                               d.tile_elems, d.ldg, n_tiles, lane);
        TC_PHASE(7);
        if constexpr (F::dx) {
          __syncthreads();   // the stage's messages are in
          TC_PHASE(8);
          add_runs(dxs, d.ldd, msg, d.ldm, rows, n_valid, K, tid);
          TC_PHASE(9);
        }
        if constexpr (F::dw)
          if (cur.hi == cur.seg_hi)   // the segment's last stage
            flush_dw(own, dws + (size_t)cur.r * KM, K, M, lane);
        TC_PHASE(10);
        cur = nxt;
        nxt = after;
        e_cur = e_nxt;
        e_nxt = e_after;
      }
      if constexpr (F::dx) {
        __syncthreads();   // every run is added
        for (int i = tid; i < n_rows * K; i += kTcThreads) {
          const int rr = i / K;
          a.dx[row0 * K + i] = dxs[rr * d.ldd + i - rr * K];
        }
      }
      TC_PHASE(11);
    }
    if constexpr (F::dw) {
      __syncthreads();   // every segment is flushed
      float* out = a.partial + ((size_t)blockIdx.x * slots + r_lo) * KM;
      for (int i = tid; i < n_r * KM; i += kTcThreads) {
        out[i] = dws[i];
        dws[i] = 0.f;
      }
    }
    TC_PHASE(12);
  }
}

// dw[r] = sum over blocks b, in block order, of partial[b][r] ([K, M]).
__global__ void bwd_tc_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dw, int n_blocks,
                                     int n_slots, int KM) {
  const int r = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= KM) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b)
    s += partial[((size_t)b * n_slots + r) * KM + p];
  dw[(size_t)r * KM + p] = s;
}

struct TcCall {
  const void* g;
  const void* x;
  const void* w;
  const int* seg_ptr;
  const int* dst;
  const float* norm;
  const short* row;
  void* wsplit;
  float* partial;
  float* dx;
  float* dw;
  int n_src, n_buckets, B, K, M, n_slots, max_blocks;
};

// launch sizes of a call: [0] blocks, [1] relations a pass, [2] bytes of
// one relation's staged W (the wsplit scratch holds n_slots of them), [3]
// 16-edge tiles a stage
template <typename T, int V, int kTiles>
cudaError_t tc_run(const TcCall* c, int* query, cudaStream_t stream) {
  using F = TcFlags<V>;
  constexpr bool kSplit = std::is_same<T, float>::value && !F::tf32;
  auto kernel = bwd_tc_kernel<T, V, kTiles>;
  const TcDims<T> d(c->K, c->M, c->B, c->n_slots, F::dx, F::dw, kSplit);
  const size_t per_rel = F::dw ? (size_t)c->K * c->M * sizeof(float) : 0;
  if (d.fixed > span::kMaxSmem) return cudaErrorInvalidValue;
  int pass_rels = c->n_slots;
  if (per_rel > 0) {
    const int fit = (int)((span::kMaxSmem - d.fixed) / per_rel);
    if (fit < 1) return cudaErrorInvalidValue;
    const int n_pass = (c->n_slots + fit - 1) / fit;
    pass_rels = (c->n_slots + n_pass - 1) / n_pass;
  }
  const size_t smem = d.fixed + pass_rels * per_rel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTcThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = c->n_buckets < per_sm * n_sm ? c->n_buckets : per_sm * n_sm;
  if (query != nullptr) {
    query[0] = blocks;
    query[1] = pass_rels;
    query[2] = (int)d.w_bytes;
    query[3] = kGatherWarps;
    return cudaSuccess;
  }
  if (blocks > c->max_blocks) return cudaErrorInvalidValue;
  if constexpr (F::dx)
    bwd_wsplit_kernel<T><<<c->n_slots, 128, 0, stream>>>(
        static_cast<const T*>(c->w), static_cast<unsigned char*>(c->wsplit),
        c->K, c->M, d.Kx, d.ldw, d.w_top, d.w_bytes);
  if (blocks > 0) {
    const TcArgs a{c->g, c->x, c->wsplit, c->seg_ptr, c->dst, c->norm, c->row,
                   c->partial, c->dx, c->n_src, c->n_buckets, c->B, c->K,
                   c->M, c->n_slots, pass_rels, copy_unit<T>(c->x, c->K),
                   copy_unit<T>(c->g, c->M)};
    kernel<<<blocks, kTcThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (F::dw) {
    const int KM = c->K * c->M;
    const dim3 grid((KM + 255) / 256, c->n_slots);
    bwd_tc_reduce_kernel<<<grid, 256, 0, stream>>>(c->partial, c->dw, blocks,
                                                   c->n_slots, KM);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t tc_tiles(const TcCall* c, int* query, cudaStream_t s) {
  if constexpr (!TcFlags<V>::dw) {
    return tc_run<T, V, 1>(c, query, s);
  } else {
    const int n_dw = (c->K + 15) / 16 * ((c->M + 7) / 8);
    if (n_dw <= kTcWarps) return tc_run<T, V, 1>(c, query, s);
    return tc_run<T, V, kTcMaxDwTiles>(c, query, s);
  }
}

template <typename T>
cudaError_t tc_variant(int variant, const TcCall* c, int* query,
                       cudaStream_t s) {
  switch (variant) {
    case kTcBase: return tc_tiles<T, kTcBase>(c, query, s);
    case kTcNoDw: return tc_tiles<T, kTcNoDw>(c, query, s);
    case kTcNoDx: return tc_tiles<T, kTcNoDx>(c, query, s);
    case kTcTf32:
      // bfloat16 products are exact already: its tf32 row is its base
      if constexpr (std::is_same<T, float>::value)
        return tc_tiles<T, kTcTf32>(c, query, s);
      else
        return tc_tiles<T, kTcBase>(c, query, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t tc_dispatch(int variant, int dtype, const TcCall* c, int* query,
                        cudaStream_t s) {
  if (c->K < 1 || c->M < 1 || c->K > kTcMaxK || c->M > kMaxM || c->B < 1
      || c->B > 32768 || c->n_slots < 1
      || (c->K + 15) / 16 * ((c->M + 7) / 8) > kTcWarps * kTcMaxDwTiles)
    return cudaErrorInvalidValue;
  return dtype == 1 ? tc_variant<__nv_bfloat16>(variant, c, query, s)
                    : tc_variant<float>(variant, c, query, s);
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

// The redesign. variant: 0 base, 1 nodw, 2 nodx, 3 tf32; dtype: 0
// float32, 1 bfloat16. out[4]: the blocks of a launch (for sizing
// `partial`), the relations a pass, the bytes of one relation's staged W
// (for sizing `wsplit`), the 16-edge tiles a stage. Returns
// cudaErrorInvalidValue when the widths or the bucket rows do not fit.
int bwd_tc_grid(int variant, int dtype, int K, int M, int B, int n_slots,
                int n_buckets, int* out) {
  TcCall c{};
  c.K = K;
  c.M = M;
  c.B = B;
  c.n_slots = n_slots;
  c.n_buckets = n_buckets;
  return static_cast<int>(tc_dispatch(variant, dtype, &c, out, nullptr));
}

// g [n_dst, M], x [n_src, K], w [slots, K, M] in one type; the bucket plan
// (seg_ptr [n_buckets * slots + 1], dst, norm, row [E]); wsplit [slots *
// w_bytes] scratch (dx variants), partial [max_blocks, slots, K, M] f32
// scratch and dw [slots, K, M] f32 (dW variants); dx [n_src, K] f32 (dx
// variants). Returns the first error of the set-up calls or of a launch.
int bwd_tc(int variant, int dtype, const void* g, const void* x,
           const void* w, const int* seg_ptr, const int* dst,
           const float* norm, const short* row, void* wsplit, float* partial,
           float* dx, float* dw, int n_src, int n_buckets, int B, int K,
           int M, int n_slots, int max_blocks, void* stream) {
  const TcCall c{g, x, w, seg_ptr, dst, norm, row, wsplit, partial, dx, dw,
                 n_src, n_buckets, B, K, M, n_slots, max_blocks};
  return static_cast<int>(tc_dispatch(variant, dtype, &c, nullptr,
                                      static_cast<cudaStream_t>(stream)));
}

#ifdef BWD_TC_PHASES
// The phase timers of the launches since the last reset: out [1024, 16]
// (blocks, phases); reset != 0 zeroes them instead. Synchronises the
// device.
int bwd_tc_phases(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    if (reset) {
      static unsigned long long zeros[kTcPhaseBlocks][kTcPhases];
      err = cudaMemcpyToSymbol(g_tc_phases, zeros, sizeof(zeros));
    } else {
      err = cudaMemcpyFromSymbol(out, g_tc_phases,
                                 sizeof(unsigned long long) * kTcPhaseBlocks
                                     * kTcPhases);
    }
  }
  return static_cast<int>(err);
}
#endif

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
