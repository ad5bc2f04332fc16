// The forward of the fused R-GCN conv on Hopper's tensor cores (sm_90a),
// with a plain C interface (bound from Python with ctypes, see
// ops/span_kernels.py span_forward).
//
// Replaces the JAX package's forward span kernel
//   scaling_rgcn_training_tpu/ops/span_kernels.py:425 _fwd_kernel
//     out[n] = sum_{e: dst_e = n} norm_e * x[src_e] @ W[rel_e]
// which ran the product on the TPU's matrix unit.
//
// Why relation chunks: one dst row's ~20 edges carry ~20 different
// relations, so a tile of a row's edges shares no W operand and the
// tensor cores have nothing to multiply it by. Edges of one relation do
// share W[r]. The span plan already cuts the relation-sorted edges
// (rel_src, rel_norm) into chunks of at most DW_CHUNK edges of one
// relation (the dW chunks of span_backward); each chunk is one
// [edges, K] x [K, M] product with a shared B operand.
//
// Two launches, no atomics, the same bits on every run:
//   1. span_msg_kernel: one block of 4 warps per chunk stages W[r]^T in
//      shared memory, zero-padded to [Np, Kp]; each warp takes 16 edges
//      at a time, multiplies their rows x[rel_src[j]] by W[r] with
//      mma.sync (m16n8k8 TF32 or m16n8k16 bf16), scales row j by
//      rel_norm[j] in registers and writes msg[j, :M] (f32, relation
//      order). The rows come into a shared-memory tile (zero-padded to Kp
//      columns and to 16 rows at the chunk's end) by cp.async, 16 bytes
//      at a time where the rows allow it, into one of two buffers: the
//      next 16 rows arrive while the warp multiplies the current ones.
//   2. span_msg_sum_kernel: a group of lanes owns each output row n and
//      sums out[n] = sum_{j = rowptr[n]}^{rowptr[n+1]-1} msg[pos[j]] in
//      f32, in forward-CSR order (pos maps the j-th edge of the
//      (dst, rel)-sorted CSR to its index in relation order). Rows with
//      no edges are written as 0.
//
// float32 inputs: split TF32 products with exact big sums. One TF32
// product keeps about three decimal digits, so a = a_big + a_small and b
// likewise, and the product is a_big b_big + a_small b_big + a_big b_small
// (3xTF32) + a_small b_small. The tensor cores cut each sum they form
// toward zero; with a_big = tf32(a) the sums of big products lost up to an
// ulp toward zero, a signed error of -4e-8 relative on every call that
// moved a 10-step f32 training run's loss 2.5e-4 away from the CUDA-core
// routes (an H100). So a_big is a on a fixed-point grid of 2^-kFixBits
// times the power of two above its row's largest |a| (b_big: its
// column's), round to nearest: an m16n8k8 product then sums 8 integers of
// at most 2^20 in one unit, at most 2^23, which float32 holds exactly.
// a_small = tf32(a - a_big) (round to nearest even) is at most
// 2^-(kFixBits+1) of the row's top, so the other products' sums are cut at
// 2^-11 of the result's scale. On this grid a_small carries whole every
// value below 2^-11 of its row's top, so the fourth product stays: without
// it the largest error at layer 1 of the bench shape was 2.9x the one with
// it, and the 10-step run's loss moved 3.7e-4 (an H100). Each k step's
// products go into fresh accumulators, added to the running sums in
// registers, rounded to nearest. bfloat16 products are exact too; their
// sums per k step are cut toward zero (bfloat16 inputs are held to 2e-2).
//
// What bounds it on an H100: the msg round trip (written once and read
// once, E * M * 4 bytes each way: 256 MB at layer 1 of the bench shape)
// and the gather of x[src] (E * K elements, mostly served from the 50 MB
// L2 since each chunk is src-sorted), not the products: 3xTF32 at layer 1
// is 25 GFLOP, 0.05 ms at the TF32 peak (33 GFLOP with the fourth
// product, the design's own cost). The earlier
// route (span_rows_kernel, csrc/span_rows.cuh) ran K * M scalar FMAs per
// edge on the CUDA cores and stays callable as span_forward_rows.
//
// Padding rows and columns are zero in both operands: uninitialised
// shared memory times a zero can still give NaN.

#include "span_tc.cuh"

namespace {

// One block per chunk c of edges [chunk_lo[c], chunk_hi[c]) of one
// relation: msg[j, :M] = rel_norm[j] * x[rel_src[j]] @ W[r], f32.
template <typename T>
__global__ void __launch_bounds__(kMsgThreads)
span_msg_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ chunk_lo,
                const int* __restrict__ chunk_hi,
                const int* __restrict__ rel_chunk_ptr,
                const int* __restrict__ rel_src,
                const float* __restrict__ rel_norm, float* __restrict__ msg,
                int K, int M, int n_slots, int unit) {
  constexpr bool kF32 = TileDims<T>::kSplit;
  const TileDims<T> d(K, M);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float col_top[kMaxM];
  T* w_big = reinterpret_cast<T*>(smem);
  T* w_small = w_big + d.w_elems;   // float32 only
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* bufs = smem + d.w_bytes + warp * 2 * d.x_bytes;

  const int c = blockIdx.x;
  const int lo = chunk_lo[c];
  const int hi = chunk_hi[c];
  const T* wr = w + (size_t)chunk_relation(rel_chunk_ptr, c, n_slots) * K * M;
  if constexpr (kF32) {
    for (int n = threadIdx.x; n < d.Np; n += blockDim.x) {
      float top = 0.f;
      if (n < M)
        for (int k = 0; k < K; ++k) top = fmaxf(top, fabsf(wr[k * M + n]));
      col_top[n] = top;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d.Np * d.Kp; i += blockDim.x) {
    const int n = i / d.Kp;
    const int k = i - n * d.Kp;
    const T v = n < M && k < K ? wr[k * M + n] : zero<T>();
    const size_t at = (size_t)n * d.ld + k;
    if constexpr (kF32) {
      const float b = Grid(col_top[n]).big(v);
      w_big[at] = b;
      w_small[at] = tf32_round(v - b);
    } else {
      w_big[at] = v;
    }
  }
  __syncthreads();

  const int g = lane >> 2;
  // each warp owns the chunk's 16-edge tiles warp, warp + 4, ...: its own
  // x rows in shared memory, so only W needs the block's barrier. Lane
  // r < 16 loads edge r's source row and norm one tile ahead of the
  // gather, which runs one tile ahead of the products.
  const int n_tiles = (hi - lo + 15) >> 4;
  const auto edge_src = [&](int tile) {
    const int e = lo + tile * 16 + (lane & 15);
    return tile < n_tiles && e < hi ? rel_src[e] : -1;
  };
  const auto edge_norm = [&](int tile) {
    const int e = lo + tile * 16 + (lane & 15);
    return tile < n_tiles && e < hi ? rel_norm[e] : 0.f;
  };
  int tile = warp;
  if (tile < n_tiles)
    gather_rows(reinterpret_cast<T*>(bufs), x, edge_src(tile), K, d.Kp, d.ld,
                unit, lane);
  cp_commit();
  float my_norm = edge_norm(tile);
  int src_next = edge_src(tile + kMsgWarps);
  float norm_next = edge_norm(tile + kMsgWarps);
  for (int it = 0; tile < n_tiles; ++it, tile += kMsgWarps) {
    const T* xs = reinterpret_cast<const T*>(bufs + (it & 1) * d.x_bytes);
    if (tile + kMsgWarps < n_tiles)
      gather_rows(reinterpret_cast<T*>(bufs + ((it + 1) & 1) * d.x_bytes), x,
                  src_next, K, d.Kp, d.ld, unit, lane);
    cp_commit();
    const int src_after = edge_src(tile + 2 * kMsgWarps);
    const float norm_after = edge_norm(tile + 2 * kMsgWarps);
    cp_wait<1>();   // all but the newest copies: this tile's rows
    __syncwarp();
    const int base = lo + tile * 16;
    tile_times_staged(xs, d.ld, d.Kp, w_big, w_small, d.ld, d.Np, M, msg,
                      (size_t)base, hi - base, __shfl_sync(kFull, my_norm, g),
                      __shfl_sync(kFull, my_norm, g + 8), lane);
    __syncwarp();
    my_norm = norm_next;
    src_next = src_after;
    norm_next = norm_after;
  }
  cp_wait<0>();
}

template <typename T>
cudaError_t launch_msg(const void* x, const void* w, const int* chunk_lo,
                       const int* chunk_hi, const int* rel_chunk_ptr,
                       const int* rel_src, const float* rel_norm, float* msg,
                       int n_chunks, int K, int M, int n_slots,
                       cudaStream_t stream) {
  const size_t smem = TileDims<T>(K, M).smem();
  auto kernel = span_msg_kernel<T>;
  const int unit = copy_unit<T>(x, K);
  // a host call each launch: only for the widths past the default 48 KiB
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_chunks, kMsgThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), chunk_lo, chunk_hi,
      rel_chunk_ptr, rel_src, rel_norm, msg, K, M, n_slots, unit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Widths: K, M <= 128 and K * M <= 4096
// (the wrapper checks). w holds n_slots relations of [K, M]; msg is
// [E, M] f32 scratch in relation order; out is [n_rows, M] f32. Returns
// the first error of the set-up calls or of a launch.
int span_fwd_tc(int dtype, const void* x, const void* w, const int* chunk_lo,
                const int* chunk_hi, const int* rel_chunk_ptr,
                const int* rel_src, const float* rel_norm, const int* rowptr,
                const int* pos, float* msg, float* out, int n_chunks,
                int n_rows, int K, int M, int n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (n_chunks > 0)
    err = dtype == 1
        ? launch_msg<__nv_bfloat16>(x, w, chunk_lo, chunk_hi, rel_chunk_ptr,
                                    rel_src, rel_norm, msg, n_chunks, K, M,
                                    n_slots, s)
        : launch_msg<float>(x, w, chunk_lo, chunk_hi, rel_chunk_ptr, rel_src,
                            rel_norm, msg, n_chunks, K, M, n_slots, s);
  if (err == cudaSuccess && n_rows > 0)
    err = dispatch_sum(msg, rowptr, pos, out, n_rows, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
