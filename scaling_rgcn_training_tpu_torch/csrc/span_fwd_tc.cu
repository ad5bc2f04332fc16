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
//   1. span_msg_kernel (span_tc.cuh, over a DenseSrc of x; #7 runs it over
//      the shards' rows): one block of 4 warps per chunk stages W[r]^T in
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

template <typename T>
cudaError_t launch_dense(const void* x, const void* w, const int* chunk_lo,
                         const int* chunk_hi, const int* rel_chunk_ptr,
                         const int* rel_src, const float* rel_norm, float* msg,
                         int n_chunks, int K, int M, int n_slots,
                         cudaStream_t s) {
  return launch_msg<T>(DenseSrc<T>{static_cast<const T*>(x)},
                       copy_unit<T>(x, K), w, chunk_lo, chunk_hi,
                       rel_chunk_ptr, rel_src, rel_norm, msg, n_chunks, K, M,
                       n_slots, s);
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
        ? launch_dense<__nv_bfloat16>(x, w, chunk_lo, chunk_hi,
                                      rel_chunk_ptr, rel_src, rel_norm, msg,
                                      n_chunks, K, M, n_slots, s)
        : launch_dense<float>(x, w, chunk_lo, chunk_hi, rel_chunk_ptr,
                              rel_src, rel_norm, msg, n_chunks, K, M, n_slots,
                              s);
  if (err == cudaSuccess && n_rows > 0)
    err = dispatch_sum(msg, rowptr, pos, out, n_rows, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
