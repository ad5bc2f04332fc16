// The backward of the fused R-GCN conv on Hopper's tensor cores (sm_90a),
// with a plain C interface (bound from Python with ctypes, see
// ops/span_kernels.py span_backward).
//
// Replaces the JAX package's backward span kernel
//   scaling_rgcn_training_tpu/ops/span_kernels.py:542 _bwd_kernel
//     dx[n] = sum_{e: src_e = n} norm_e * g[dst_e] @ W[rel_e]^T
//     dW[r] = sum_{e: rel_e = r} x[src_e]^T (norm_e * g[dst_e])
// which formed both from one tile of edges in one pass on the TPU's matrix
// unit. Here too one pass over the plan's relation chunks (at most
// DW_CHUNK edges of one relation, relation-sorted by (rel, src)) forms
// both: the edges of a chunk share W[r] and dW[r], so a tile of them is a
// tensor-core product for either half.
//
// Three launches, no atomics, the same bits on every run:
//   1. span_bwd_chunk_kernel: one block of 4 warps per chunk c of relation
//      r stages W[r] in shared memory as the B operand of dx (n-major:
//      row k of W[r], M contiguous, zero-padded; big and small parts for
//      float32). The chunk is walked in stages of four 16-edge tiles, one
//      a warp: the warp gathers x[rel_src[j]] ([16, K]) and g[rel_dst[j]]
//      ([16, M]) into shared memory by cp.async, one stage ahead into the
//      other of two buffers, and scales its g rows by rel_norm[j] in place,
//      in the input type (bfloat16 streams see bf16(norm g), as the TPU
//      kernel's do). Then
//        - dx messages: each warp multiplies its own tile's scaled g rows
//          by W[r]^T (mma.sync, as span_fwd_tc.cu's messages) and writes
//          msg[j, :K] (f32, relation order);
//        - dW: after a block barrier each warp owns consecutive 16 x 8
//          tiles of dW[r] and adds x_tile^T (norm g)_tile of the stage's
//          tiles (the edges are the depth) to sums kept in registers across
//          the chunk, splitting each x fragment once for its tiles of the
//          same rows; the chunk's partial [K, M] is written once at the end
//          (when dW[r] has fewer than 4 tiles, 2 or 4 warps share one, each
//          over its share of the tiles, summed in warp order).
//   2. span_msg_sum_kernel (span_tc.cuh): each src row's messages summed in
//      src-CSR order through bwd_pos (each edge of the (src, rel)-sorted
//      CSR's index in relation order); rows with no edges are written 0.
//   3. span_dw_reduce_kernel (span_tc.cuh): each relation's chunk partials
//      summed in chunk order; relations with no edges get 0.
//
// float32 inputs: split TF32 products on fixed-point grids with exact big
// sums, four products a multiply-add (span_fwd_tc.cu says why). For dx the
// grids are the forward's: each scaled g row's over its M values, each
// W[r] row's (a column of B) over its M values. For dW the grid of an A row
// is feature k over the tile's 16 edges, and that of a B column is output
// m over the same edges; each 8-edge step's products go into fresh
// accumulators (the big products' sums exact), the tile's two steps are
// added, then added to the running sums, round to nearest. bfloat16
// inputs: exact products, one mma per tile.
//
// What bounds it on an H100: the dx message round trip (E * K * 4 bytes
// each way: 1 GB at layer 1 of the bench shape) and the gathers of x[src]
// and g[dst] (mostly from the 50 MB L2: x is 51 MB and src-sorted within a
// chunk, g 12.8 MB), not the products: 3xTF32 of both halves at layer 1 is
// 49 GFLOP, 0.10 ms at the TF32 peak (the fourth product is the design's
// own cost). The earlier route (span_rows_kernel with W^T for dx,
// span_dw_partial_kernel on the CUDA cores for dW, span_kernels.cu) stays
// callable as span_backward_rows.
//
// Padding rows and columns are zero in both operands: uninitialised
// shared memory times a zero can still give NaN.

#include "span_tc.cuh"

namespace {

// 16 x 8 tiles of dW[r] a warp keeps in registers: ceil(K / 16) ceil(M /
// 8) <= 48 = 4 kMaxDwTiles for K, M <= 128 and K M <= 4096 (checked).
constexpr int kMaxDwTiles = 12;
// widest K the kernel takes (the wrapper checks)
constexpr int kMaxK = 128;

// Shared memory of one block: W[r] as the B operand of dx, [Kn, ldw] (big
// and small parts for float32), then two stages of kMsgWarps tiles, each
// x rows [16, ldx] and g rows [16, ldg].
template <typename T>
struct BwdDims {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  int Kx, Kn, Mg, Mn, n_dw, ldx, ldg, ldw;
  size_t w_elems, w_bytes, x_bytes, g_bytes, stage_bytes;
  __host__ __device__ BwdDims(int K, int M) {
    using S = TileShape<T>;
    Kx = round_up(K, 16);     // dW rows: m16 tiles
    Kn = round_up(K, 8);      // dx columns: n8 tiles
    Mg = round_up(M, S::kK);  // dx depth; dW columns
    Mn = (M + 7) / 8;
    n_dw = Kx / 16 * Mn;
    // row-major fragment loads (dx's A and B): the residue of #1's tiles
    ldw = padded_stride(Mg, S::kRes, S::kPeriod);
    ldg = ldw;
    // x is read down its columns (A of dW: lane 4 g + t reads edge t's
    // column g), so its rows sit 8 words apart modulo 32 banks
    ldx = padded_stride(Kx, 8, 32);
    w_elems = (size_t)Kn * ldw;
    w_bytes = align16(w_elems * sizeof(T) * (kSplit ? 2 : 1));
    x_bytes = align16((size_t)16 * ldx * sizeof(T));
    g_bytes = align16((size_t)16 * ldg * sizeof(T));
    stage_bytes = kMsgWarps * (x_bytes + g_bytes);
  }
  __host__ __device__ size_t smem() const { return w_bytes + 2 * stage_bytes; }
};

// The pointers and widths of one call.
struct BwdArgs {
  const void* g;
  const void* x;
  const void* w;
  const int* chunk_lo;
  const int* chunk_hi;
  const int* rel_chunk_ptr;
  const int* rel_src;
  const int* rel_dst;
  const float* rel_norm;
  float* msg;
  float* partial;
  int K, M, n_slots;
};

// One block per chunk c of edges [chunk_lo[c], chunk_hi[c]) of relation r.
// kDx: msg[j, :K] = (rel_norm[j] g[rel_dst[j]]) @ W[r]^T; kDw: partial[c] =
// sum_j x[rel_src[j]]^T (rel_norm[j] g[rel_dst[j]]). (One half alone is
// for timing.) kTiles: the most dW tiles a warp owns (2 up to 8 tiles in
// all, so narrow layers keep few registers; else kMaxDwTiles).
template <typename T, bool kDx, bool kDw, int kTiles>
__global__ void __launch_bounds__(kMsgThreads)
span_bwd_chunk_kernel(BwdArgs a, int unit_x, int unit_g) {
  constexpr bool kF32 = BwdDims<T>::kSplit;
  const T* __restrict__ gout = static_cast<const T*>(a.g);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int K = a.K, M = a.M;
  const BwdDims<T> d(K, M);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float row_top[kMaxK];
  T* w_big = reinterpret_cast<T*>(smem);
  T* w_small = w_big + d.w_elems;   // float32 only
  unsigned char* stages = smem + d.w_bytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int c = blockIdx.x;
  const int lo = a.chunk_lo[c];
  const int hi = a.chunk_hi[c];
  if constexpr (kDx) {
    // B of dx is W[r]^T: its column n is row n of W[r]
    const T* wr = static_cast<const T*>(a.w)
                  + (size_t)chunk_relation(a.rel_chunk_ptr, c, a.n_slots) * K * M;
    if constexpr (kF32) {
      for (int n = threadIdx.x; n < d.Kn; n += blockDim.x) {
        float top = 0.f;
        if (n < K)
          for (int m = 0; m < M; ++m) top = fmaxf(top, fabsf(wr[n * M + m]));
        row_top[n] = top;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < d.Kn * d.Mg; i += blockDim.x) {
      const int n = i / d.Mg;
      const int m = i - n * d.Mg;
      const T v = n < K && m < M ? wr[n * M + m] : zero<T>();
      const size_t at = (size_t)n * d.ldw + m;
      if constexpr (kF32) {
        const float b = Grid(row_top[n]).big(v);
        w_big[at] = b;
        w_small[at] = tf32_round(v - b);
      } else {
        w_big[at] = v;
      }
    }
    __syncthreads();
  }

  // stage s holds tiles 4 s .. 4 s + 3 of the chunk, tile 4 s + i gathered
  // by warp i into buffer s & 1. Lane r < 16 (and r + 16) holds edge r of
  // the warp's tile, loaded one stage ahead of its gather, which runs one
  // stage ahead of the products.
  const int n_tiles = (hi - lo + 15) >> 4;
  const int n_stages = (n_tiles + kMsgWarps - 1) / kMsgWarps;
  const auto tile_x = [&](int s, int i) {
    return reinterpret_cast<T*>(stages + (s & 1) * d.stage_bytes
                                + i * (d.x_bytes + d.g_bytes));
  };
  const auto tile_g = [&](int s, int i) {
    return reinterpret_cast<T*>(stages + (s & 1) * d.stage_bytes
                                + i * (d.x_bytes + d.g_bytes) + d.x_bytes);
  };
  struct Edge {
    int src, dst;
    float norm;
  };
  const auto load_edge = [&](int s) {
    const int e = lo + (s * kMsgWarps + warp) * 16 + (lane & 15);
    return e < hi ? Edge{a.rel_src[e], a.rel_dst[e], a.rel_norm[e]}
                  : Edge{-1, -1, 0.f};
  };
  const auto gather = [&](int s, const Edge& edge) {
    if (s * kMsgWarps + warp < n_tiles) {   // the same on every lane
      if constexpr (kDw)
        gather_rows(tile_x(s, warp), DenseSrc<T>{x}, edge.src, K, d.Kx,
                    d.ldx, unit_x, lane);
      gather_rows(tile_g(s, warp), DenseSrc<T>{gout}, edge.dst, M, d.Mg,
                  d.ldg, unit_g, lane);
    }
    cp_commit();
  };

  // this warp's dW tiles (span_tc.cuh DwTiles)
  DwTiles<kTiles> own(d.n_dw, d.Mn, warp);

  Edge cur = load_edge(0);
  gather(0, cur);
  Edge next = load_edge(1);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      // every warp is done with stage s - 1, whose buffer stage s + 1 takes
      if constexpr (kDw) __syncthreads();
      gather(s + 1, next);
    } else {
      cp_commit();
    }
    const Edge after = load_edge(s + 2);
    cp_wait<1>();   // all but the newest copies: this stage's rows
    __syncwarp();
    const int tile = s * kMsgWarps + warp;
    if (tile < n_tiles) {
      T* gs = tile_g(s, warp);
      // g rows times norm, in place, in T (16 * Mg is a multiple of 32)
      for (int i = lane; i < 16 * d.Mg; i += 32) {
        const int row = i / d.Mg;
        const int col = i - row * d.Mg;
        const float nr = __shfl_sync(kFull, cur.norm, row);
        gs[row * d.ldg + col] = from_float<T>(nr * as_float(gs[row * d.ldg + col]));
      }
      __syncwarp();
      if constexpr (kDx) {
        const int base = lo + tile * 16;
        tile_times_staged(gs, d.ldg, d.Mg, w_big, w_small, d.ldw, d.Kn, K,
                          a.msg, K, (size_t)base, hi - base, 1.f, 1.f, lane);
      }
    }
    if constexpr (kDw) {
      __syncthreads();   // the stage's tiles, scaled, are in shared memory
      own.template add<T>(
          min(kMsgWarps, n_tiles - s * kMsgWarps),
          [&](int i) { return tile_x(s, i); },
          [&](int i) { return tile_g(s, i); }, d.ldx, d.ldg, lane);
    }
    __syncwarp();
    cur = next;
    next = after;
  }
  cp_wait<0>();

  if constexpr (kDw)
    own.store(a.partial + (size_t)c * K * M, K, M, M,
              reinterpret_cast<float*>(stages), warp, lane);
}

template <typename T, bool kDx, bool kDw, int kTiles>
cudaError_t launch_chunks(const BwdArgs& a, int n_chunks, cudaStream_t stream) {
  const size_t smem = BwdDims<T>(a.K, a.M).smem();
  auto kernel = span_bwd_chunk_kernel<T, kDx, kDw, kTiles>;
  // a host call each launch: only for the widths past the default 48 KiB
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_chunks, kMsgThreads, smem, stream>>>(
      a, copy_unit<T>(a.x, a.K), copy_unit<T>(a.g, a.M));
  return cudaGetLastError();
}

template <typename T, bool kDx, bool kDw>
cudaError_t dispatch_tiles(const BwdArgs& a, int n_chunks, cudaStream_t s) {
  if (BwdDims<T>(a.K, a.M).n_dw <= 2 * kMsgWarps)
    return launch_chunks<T, kDx, kDw, 2>(a, n_chunks, s);
  return launch_chunks<T, kDx, kDw, kMaxDwTiles>(a, n_chunks, s);
}

template <typename T>
cudaError_t dispatch_chunks(int parts, const BwdArgs& a, int n_chunks,
                            cudaStream_t s) {
  if (parts == 1) return launch_chunks<T, true, false, 2>(a, n_chunks, s);
  if (parts == 2) return dispatch_tiles<T, false, true>(a, n_chunks, s);
  return dispatch_tiles<T, true, true>(a, n_chunks, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. parts: 1 = dx only, 2 = dW only, 3 =
// both (one half alone is for timing). Widths: K, M <= 128 and K * M <=
// 4096 (the wrapper checks). g [rows, M], x [n_src, K], w [n_slots, K, M]
// in one type; msg [E, K] and partial [n_chunks, K, M] f32 scratch; dx
// [n_src, K] and dw [n_slots, K, M] f32. Returns the first error of the
// set-up calls or of a launch.
int span_bwd_tc(int dtype, int parts, const void* g, const void* x,
                const void* w, const int* chunk_lo, const int* chunk_hi,
                const int* rel_chunk_ptr, const int* rel_src,
                const int* rel_dst, const float* rel_norm,
                const int* bwd_rowptr, const int* bwd_pos, float* msg,
                float* partial, float* dx, float* dw, int n_chunks, int n_src,
                int K, int M, int n_slots, void* stream) {
  if (K > kMaxK || M > kMaxM || (K + 15) / 16 * ((M + 7) / 8) > 4 * kMaxDwTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{g, x, w, chunk_lo, chunk_hi, rel_chunk_ptr, rel_src,
                  rel_dst, rel_norm, msg, partial, K, M, n_slots};
  cudaError_t err = cudaSuccess;
  if (n_chunks > 0)
    err = dtype == 1 ? dispatch_chunks<__nv_bfloat16>(parts, a, n_chunks, s)
                     : dispatch_chunks<float>(parts, a, n_chunks, s);
  if (err == cudaSuccess && (parts & 1) && n_src > 0)
    err = dispatch_sum(msg, bwd_rowptr, bwd_pos, dx, n_src, K, s);
  if (err == cudaSuccess && (parts & 2) && n_slots > 0)
    err = launch_dw_reduce(partial, rel_chunk_ptr, dw, n_slots, K * M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
