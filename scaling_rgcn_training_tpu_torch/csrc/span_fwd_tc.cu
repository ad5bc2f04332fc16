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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMsgWarps = 4;
constexpr int kMsgThreads = kMsgWarps * 32;
constexpr int kSumThreads = 256;
// x elements a lane loads before it stores them to shared memory
// (the gather without cp.async: bfloat16 rows of odd width)
constexpr int kGatherBatch = 8;
// 8-column tiles of the output a warp keeps in registers at once
constexpr int kNGroup = 4;
// fraction bits of the big parts' grid below a row's (column's) top
constexpr int kFixBits = 10;
// least exponent of a grid's top: a row (column) of smaller values takes
// this grid, so 2^(kFixBits - e) stays finite and the values go wholly to
// the small parts
constexpr int kMinTopExp = -100;
// widest output the kernels take (the wrapper checks)
constexpr int kMaxM = 128;
constexpr unsigned kFull = 0xffffffffu;

// Depth of one mma (kK) and the row stride of the shared tiles, in
// elements: stride % kPeriod == kRes keeps a fragment load's 32 lanes on
// 32 banks.
template <typename T> struct TileShape;
template <> struct TileShape<float> {
  static constexpr int kK = 8, kRes = 4, kPeriod = 32;
};
template <> struct TileShape<__nv_bfloat16> {
  static constexpr int kK = 16, kRes = 8, kPeriod = 64;
};

// Shared memory of one block: W[r]^T as [Np, ld] (its big and small parts
// for float32), then per warp two [16, ld] x tiles; both are read as
// fragments of Kp columns, so they share the row stride ld.
template <typename T>
struct TileDims {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  int Kp, Np, ld;
  size_t w_elems, w_bytes, x_bytes;
  __host__ __device__ TileDims(int K, int M) {
    using S = TileShape<T>;
    Kp = (K + S::kK - 1) / S::kK * S::kK;
    Np = (M + 7) / 8 * 8;
    ld = Kp + ((S::kRes - Kp % S::kPeriod) + S::kPeriod) % S::kPeriod;
    w_elems = (size_t)Np * ld;
    w_bytes = (w_elems * sizeof(T) * (kSplit ? 2 : 1) + 15) / 16 * 16;
    x_bytes = ((size_t)16 * ld * sizeof(T) + 15) / 16 * 16;
  }
  __host__ __device__ size_t smem() const {
    return w_bytes + kMsgWarps * 2 * x_bytes;
  }
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// v rounded to TF32 (10 mantissa bits), round to nearest even; the low 13
// bits are zero, so the tensor cores read it exactly.
__device__ __forceinline__ float tf32_round(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0xfffu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xffffe000u);
}

// The big parts' grid of a row (column) whose largest |value| is top:
// multiples of 2^(e - kFixBits), where top < 2^e and e >= kMinTopExp.
struct Grid {
  float unit, inv;
  __device__ __forceinline__ explicit Grid(float top) {
    int e;
    frexpf(top, &e);
    e = max(e, kMinTopExp);
    unit = ldexpf(1.f, e - kFixBits);
    inv = ldexpf(1.f, kFixBits - e);
  }
  __device__ __forceinline__ float big(float v) const {
    return rintf(v * inv) * unit;
  }
};

// d = a b (fresh: the accumulator input is 0), m16n8k8 TF32 -> f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a b, m16n8k8 TF32 -> f32.
__device__ __forceinline__ void mma_tf32_acc(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (fresh), m16n8k16 bfloat16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }

// two consecutive bfloat16 (4-byte aligned) as one register
__device__ __forceinline__ unsigned pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// cp.async of `bytes` (4 or 16) from global to shared memory; src_bytes 0
// writes zeros.
__device__ __forceinline__ void cp_async4(void* to, const void* from,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(to)),
               "l"(from), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* to, const void* from,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(to)),
               "l"(from), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's 16 rows of x into xs [16, ld], zero-padded to Kp columns
// (lane r < 16 holds row r's source row src, -1 for none). unit: the bytes
// of one cp.async (16 or 4; the wrapper picks the widest that divides a
// row and its alignment), or 0: plain loads and stores, kGatherBatch loads
// in flight per lane. Copy (element) c = lane + 32 i is row c / kc, unit
// c % kc of it; a lane walks its copies by (32 / kc, 32 % kc) steps.
template <typename T>
__device__ __forceinline__ void gather_rows(T* xs, const T* __restrict__ x,
                                            int src, int K,
                                            const TileDims<T>& d, int unit,
                                            int lane) {
  const int v = unit > 0 ? unit / (int)sizeof(T) : 1;   // elements a copy
  const int kc = d.Kp / v;
  const int n_cp = 16 * kc;   // a multiple of 32
  const int step_rows = 32 / kc, step_cols = 32 % kc;
  int rr = lane / kc, cu = lane % kc;
  if (unit > 0) {
    for (int c0 = 0; c0 < n_cp; c0 += 32) {
      const int s = __shfl_sync(kFull, src, rr);
      const int k = cu * v;
      const bool valid = s >= 0 && k < K;
      const T* from = x + (valid ? (size_t)s * K + k : 0);
      T* to = xs + rr * d.ld + k;
      if (unit == 16) cp_async16(to, from, valid ? 16 : 0);
      else cp_async4(to, from, valid ? 4 : 0);
      rr += step_rows;
      cu += step_cols;
      if (cu >= kc) {
        cu -= kc;
        ++rr;
      }
    }
    return;
  }
  for (int c0 = 0; c0 < n_cp; c0 += 32 * kGatherBatch) {
    T val[kGatherBatch];
    int at[kGatherBatch];
#pragma unroll
    for (int b = 0; b < kGatherBatch; ++b) {
      const bool in = c0 + 32 * b < n_cp;   // the same on every lane
      const int s = __shfl_sync(kFull, src, in ? rr : 0);
      at[b] = in ? rr * d.ld + cu : -1;
      val[b] = in && s >= 0 && cu < K ? x[(size_t)s * K + cu] : zero<T>();
      rr += step_rows;
      cu += step_cols;
      if (cu >= kc) {
        cu -= kc;
        ++rr;
      }
    }
#pragma unroll
    for (int b = 0; b < kGatherBatch; ++b)
      if (at[b] >= 0) xs[at[b]] = val[b];
  }
}

// One block per chunk c of edges [chunk_lo[c], chunk_hi[c]) of one
// relation: msg[j, :M] = rel_norm[j] * x[rel_src[j]] @ W[r], f32.
// Fragments (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4 g + t holds rows
// g and g + 8 of A, column g of B and of the sums, columns 2 t, 2 t + 1.
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
  // the chunk's relation: rel_chunk_ptr[r] <= c < rel_chunk_ptr[r + 1]
  int r = 0, r_end = n_slots;
  while (r_end - r > 1) {
    const int mid = (r + r_end) >> 1;
    if (rel_chunk_ptr[mid] <= c) r = mid; else r_end = mid;
  }
  const T* wr = w + (size_t)r * K * M;
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

  const int g = lane >> 2, t = lane & 3;
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
    gather_rows(reinterpret_cast<T*>(bufs), x, edge_src(tile), K, d, unit,
                lane);
  cp_commit();
  float my_norm = edge_norm(tile);
  int src_next = edge_src(tile + kMsgWarps);
  float norm_next = edge_norm(tile + kMsgWarps);
  for (int it = 0; tile < n_tiles; ++it, tile += kMsgWarps) {
    const T* xs = reinterpret_cast<const T*>(bufs + (it & 1) * d.x_bytes);
    if (tile + kMsgWarps < n_tiles)
      gather_rows(reinterpret_cast<T*>(bufs + ((it + 1) & 1) * d.x_bytes), x,
                  src_next, K, d, unit, lane);
    cp_commit();
    const int src_after = edge_src(tile + 2 * kMsgWarps);
    const float norm_after = edge_norm(tile + 2 * kMsgWarps);
    cp_wait<1>();   // all but the newest copies: this tile's rows
    __syncwarp();
    const int base = lo + tile * 16;
    const float norm_g = __shfl_sync(kFull, my_norm, g);
    const float norm_g8 = __shfl_sync(kFull, my_norm, g + 8);
    const T* row_g = xs + g * d.ld;
    const T* row_g8 = xs + (g + 8) * d.ld;

    // the grids of rows g and g + 8: their tops over the four lanes of g
    float top_g = 0.f, top_g8 = 0.f;
    if constexpr (kF32) {
      for (int k0 = 0; k0 < d.Kp; k0 += 8) {
        top_g = fmaxf(top_g, fmaxf(fabsf(row_g[k0 + t]), fabsf(row_g[k0 + t + 4])));
        top_g8 = fmaxf(top_g8, fmaxf(fabsf(row_g8[k0 + t]), fabsf(row_g8[k0 + t + 4])));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        top_g = fmaxf(top_g, __shfl_xor_sync(kFull, top_g, off));
        top_g8 = fmaxf(top_g8, __shfl_xor_sync(kFull, top_g8, off));
      }
    }
    const Grid grid_g(top_g), grid_g8(top_g8);

    for (int n0 = 0; n0 < d.Np; n0 += 8 * kNGroup) {
      float acc[kNGroup][4] = {}, small[kNGroup][4] = {};
      for (int k0 = 0; k0 < d.Kp; k0 += TileShape<T>::kK) {
        unsigned a_big[4], a_small[4];
        if constexpr (kF32) {
          const float a[4] = {row_g[k0 + t], row_g8[k0 + t], row_g[k0 + t + 4],
                              row_g8[k0 + t + 4]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float b = (i & 1 ? grid_g8 : grid_g).big(a[i]);
            a_big[i] = bits(b);
            a_small[i] = bits(tf32_round(a[i] - b));
          }
        } else {
          a_big[0] = pair(row_g + k0 + 2 * t);
          a_big[1] = pair(row_g8 + k0 + 2 * t);
          a_big[2] = pair(row_g + k0 + 2 * t + 8);
          a_big[3] = pair(row_g8 + k0 + 2 * t + 8);
        }
#pragma unroll
        for (int j = 0; j < kNGroup; ++j) {
          if (n0 + 8 * j >= d.Np) break;
          const size_t wb = (size_t)(n0 + 8 * j + g) * d.ld + k0;
          float part[4];
          if constexpr (kF32) {
            mma_tf32(part, a_big, bits(w_big[wb + t]), bits(w_big[wb + t + 4]));
            float cross[4];
            mma_tf32(cross, a_small, bits(w_big[wb + t]), bits(w_big[wb + t + 4]));
            mma_tf32_acc(cross, a_big, bits(w_small[wb + t]),
                         bits(w_small[wb + t + 4]));
            mma_tf32_acc(cross, a_small, bits(w_small[wb + t]),
                         bits(w_small[wb + t + 4]));
#pragma unroll
            for (int i = 0; i < 4; ++i) small[j][i] += cross[i];
          } else {
            mma_bf16(part, a_big, pair(w_big + wb + 2 * t),
                     pair(w_big + wb + 2 * t + 8));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
        }
      }
      // rows g, g + 8 and columns 2 t, 2 t + 1 of each 8-column tile
#pragma unroll
      for (int j = 0; j < kNGroup; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (n0 + 8 * j >= d.Np) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? g : g + 8;
          if (base + row < hi && col + (i & 1) < M)
            msg[(size_t)(base + row) * M + col + (i & 1)] =
                (acc[j][i] + small[j][i]) * (i < 2 ? norm_g : norm_g8);
        }
      }
    }
    __syncwarp();
    my_norm = norm_next;
    src_next = src_after;
    norm_next = norm_after;
  }
  cp_wait<0>();
}

// G lanes own one output row (32 / G rows per warp), OC columns per lane:
// column o = c * G + (lane % G). Each lane sums its columns over the row's
// edges in CSR order.
template <int G, int OC>
__global__ void __launch_bounds__(kSumThreads)
span_msg_sum_kernel(const float* __restrict__ msg,
                    const int* __restrict__ rowptr, const int* __restrict__ pos,
                    float* __restrict__ out, int n_rows, int M) {
  const int lane = threadIdx.x & 31;
  const int row = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (32 / G)
                  + lane / G;
  if (row >= n_rows) return;
  const int lg = lane % G;
  float acc[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) acc[c] = 0.f;
  const int hi = rowptr[row + 1];
  int j = rowptr[row];
  // four edges' loads in flight, added in order
  for (; j + 4 <= hi; j += 4) {
    const float* m0 = msg + (size_t)pos[j] * M;
    const float* m1 = msg + (size_t)pos[j + 1] * M;
    const float* m2 = msg + (size_t)pos[j + 2] * M;
    const float* m3 = msg + (size_t)pos[j + 3] * M;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int o = c * G + lg;
      if (o < M) {
        const float v0 = m0[o], v1 = m1[o], v2 = m2[o], v3 = m3[o];
        acc[c] = (((acc[c] + v0) + v1) + v2) + v3;
      }
    }
  }
  for (; j < hi; ++j) {
    const float* mj = msg + (size_t)pos[j] * M;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int o = c * G + lg;
      if (o < M) acc[c] += mj[o];
    }
  }
#pragma unroll
  for (int c = 0; c < OC; ++c) {
    const int o = c * G + lg;
    if (o < M) out[(size_t)row * M + o] = acc[c];
  }
}

template <typename T>
cudaError_t launch_msg(const void* x, const void* w, const int* chunk_lo,
                       const int* chunk_hi, const int* rel_chunk_ptr,
                       const int* rel_src, const float* rel_norm, float* msg,
                       int n_chunks, int K, int M, int n_slots,
                       cudaStream_t stream) {
  const size_t smem = TileDims<T>(K, M).smem();
  auto kernel = span_msg_kernel<T>;
  // the widest cp.async that divides a row and the rows' alignment; none
  // for bfloat16 rows of odd width
  const size_t at = reinterpret_cast<size_t>(x);
  const int per16 = 16 / (int)sizeof(T), per4 = 4 / (int)sizeof(T);
  const int unit = K % per16 == 0 && at % 16 == 0 ? 16
                   : K % per4 == 0 && at % 4 == 0 ? 4 : 0;
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

template <int G, int OC>
cudaError_t launch_sum(const float* msg, const int* rowptr, const int* pos,
                       float* out, int n_rows, int M, cudaStream_t stream) {
  const long long warps = (n_rows + 32 / G - 1) / (32 / G);
  const int blocks = (int)((warps * 32 + kSumThreads - 1) / kSumThreads);
  span_msg_sum_kernel<G, OC><<<blocks, kSumThreads, 0, stream>>>(
      msg, rowptr, pos, out, n_rows, M);
  return cudaGetLastError();
}

// The (G, OC) specialisation for an output width M <= 128.
cudaError_t dispatch_sum(const float* msg, const int* rowptr, const int* pos,
                         float* out, int n_rows, int M, cudaStream_t s) {
  if (M <= 4) return launch_sum<4, 1>(msg, rowptr, pos, out, n_rows, M, s);
  if (M <= 8) return launch_sum<8, 1>(msg, rowptr, pos, out, n_rows, M, s);
  if (M <= 16) return launch_sum<16, 1>(msg, rowptr, pos, out, n_rows, M, s);
  if (M <= 32) return launch_sum<32, 1>(msg, rowptr, pos, out, n_rows, M, s);
  if (M <= 64) return launch_sum<32, 2>(msg, rowptr, pos, out, n_rows, M, s);
  return launch_sum<32, 4>(msg, rowptr, pos, out, n_rows, M, s);
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
