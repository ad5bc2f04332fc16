// Device helpers of the kernels on Hopper's tensor cores (sm_90a), shared
// by span_fwd_tc.cu (kernel #1), span_bwd_tc.cu (kernel #2),
// halo_kernels.cu (kernel #7) and grouped_kernels.cu (kernels #4 and #5):
// the mma tile shapes, the split of float32 operands into a big part on a
// fixed-point grid and a TF32 small part (span_fwd_tc.cu says why), the
// mma.sync and cp.async wrappers in inline PTX, the warp's row gather over
// a row source, the product of a warp's 16-row tile with a staged B
// operand (#1, #7, #2's dx, #4), the product x^T g with the rows as the
// depth, summed in registers per warp (#2's dW, #5), the
// chunk kernel of per-edge messages (#1 and #7), the fixed-order CSR sum
// of per-edge messages and the chunk-ordered reduce of dW partials.
//
// Fragments (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4 g + t holds rows g
// and g + 8 of A, column g of B and of the sums, columns 2 t, 2 t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// warps of a chunk kernel's block
constexpr int kMsgWarps = 4;
constexpr int kMsgThreads = kMsgWarps * 32;
constexpr int kSumThreads = 256;
// elements a lane loads before it stores them to shared memory
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
// widest row the kernels take (the wrappers check)
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

// n rounded up to a multiple of m
__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// the least stride >= n with stride % period == res
__host__ __device__ __forceinline__ int padded_stride(int n, int res,
                                                      int period) {
  return n + ((res - n % period) + period) % period;
}

// bytes rounded up to 16
__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of one block of span_msg_kernel: W[r]^T as [Np, ld] (its
// big and small parts for float32), then per warp two [16, ld] x tiles;
// both are read as fragments of Kp columns, so they share the row stride
// ld.
template <typename T>
struct TileDims {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  int Kp, Np, ld;
  size_t w_elems, w_bytes, x_bytes;
  __host__ __device__ TileDims(int K, int M) {
    using S = TileShape<T>;
    Kp = round_up(K, S::kK);
    Np = round_up(M, 8);
    ld = padded_stride(Kp, S::kRes, S::kPeriod);
    w_elems = (size_t)Np * ld;
    w_bytes = align16(w_elems * sizeof(T) * (kSplit ? 2 : 1));
    x_bytes = align16((size_t)16 * ld * sizeof(T));
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

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v in T, round to nearest even
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
// For finite top >= 0, e is frexpf's exponent (top = f 2^e, f in [0.5,
// 1)) read from the bits (0 and subnormal tops take kMinTopExp), and the
// powers of two are built from their bits: the same grid as frexpf and
// ldexpf give, in a few integer operations.
struct Grid {
  float unit, inv;
  __device__ __forceinline__ explicit Grid(float top) {
    const int e = max((int)((__float_as_uint(top) >> 23) & 0xffu) - 126,
                      kMinTopExp);
    unit = __int_as_float((e - kFixBits + 127) << 23);
    inv = __int_as_float((kFixBits - e + 127) << 23);
  }
  __device__ __forceinline__ float big(float v) const {
    return rintf(v * inv) * unit;
  }
};

// The largest of v over the four lanes of a fragment row (lanes 4 g .. 4 g
// + 3).
__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

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

// two bfloat16 as one register, lo in the low half (the lower index of a
// fragment's pair)
__device__ __forceinline__ unsigned pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo)
         | ((unsigned)__bfloat16_as_ushort(hi) << 16);
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

// The widest cp.async (16 or 4 bytes) that divides a row of K elements of
// T and the rows' alignment, or 0: plain loads (bfloat16 rows of odd
// width).
template <typename T>
int copy_unit(const void* rows, int K) {
  const size_t at = reinterpret_cast<size_t>(rows);
  const int per16 = 16 / (int)sizeof(T), per4 = 4 / (int)sizeof(T);
  return K % per16 == 0 && at % 16 == 0 ? 16
         : K % per4 == 0 && at % 4 == 0 ? 4 : 0;
}

// Row sources of the gather. Lane r < 16 resolves its tile row's source
// once a tile (at(): a handle, invalid for src -1), and the lanes that copy
// the row read it through the shuffled handle: addr() is the address of
// element k of the row (any readable address for an invalid handle: a
// cp.async of 0 bytes), load() the element itself. DenseSrc is row i of
// one [n, K] matrix (#1, #2; its arithmetic is that of a plain pointer);
// halo_kernels.cu's ShardSrc is row i of the S shards' rows, read where
// each shard keeps it (#7). prepare() runs once a block before its first
// barrier.
template <typename T>
struct DenseSrc {
  using Handle = int;
  const T* __restrict__ x;
  __device__ __forceinline__ void prepare() const {}
  __device__ __forceinline__ Handle at(int i, int) const { return i; }
  __device__ __forceinline__ static bool valid(Handle h) { return h >= 0; }
  __device__ __forceinline__ const T* addr(Handle h, bool valid, int k,
                                           int K) const {
    return x + (valid ? (size_t)h * K + k : 0);
  }
  __device__ __forceinline__ T load(Handle h, int k, int K) const {
    return x[(size_t)h * K + k];
  }
};

// lane `from`'s handle: a row index, or a row's address
__device__ __forceinline__ int shfl_handle(int h, int from) {
  return __shfl_sync(kFull, h, from);
}
template <typename T>
__device__ __forceinline__ const T* shfl_handle(const T* h, int from) {
  return reinterpret_cast<const T*>(__shfl_sync(
      kFull, reinterpret_cast<unsigned long long>(h), from));
}

// The warp's 16 rows of a source into xs [16, ld], zero-padded to Kp
// columns (lane r < 16 holds row r's source row src, -1 for none; Kp is a
// multiple of the mma depth). unit: the bytes of one cp.async (copy_unit,
// for every row the source may give), or 0: plain loads and stores,
// kGatherBatch loads in flight per lane. Copy (element) c = lane + 32 i is
// row c / kc, unit c % kc of it; a lane walks its copies by (32 / kc, 32 %
// kc) steps.
template <typename T, typename Src>
__device__ __forceinline__ void gather_rows(T* xs, const Src& rows, int src,
                                            int K, int Kp, int ld, int unit,
                                            int lane) {
  const typename Src::Handle mine = rows.at(src, K);
  const int v = unit > 0 ? unit / (int)sizeof(T) : 1;   // elements a copy
  const int kc = Kp / v;
  const int n_cp = 16 * kc;   // a multiple of 32
  const int step_rows = 32 / kc, step_cols = 32 % kc;
  int rr = lane / kc, cu = lane % kc;
  if (unit > 0) {
    for (int c0 = 0; c0 < n_cp; c0 += 32) {
      const auto s = shfl_handle(mine, rr);
      const int k = cu * v;
      const bool valid = Src::valid(s) && k < K;
      const T* from = rows.addr(s, valid, k, K);
      T* to = xs + rr * ld + k;
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
      const auto s = shfl_handle(mine, in ? rr : 0);
      at[b] = in ? rr * ld + cu : -1;
      val[b] = in && Src::valid(s) && cu < K ? rows.load(s, cu, K) : zero<T>();
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

// Two consecutive values of a row in O, rounded to nearest even, as one
// store (p aligned to two elements).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The warp's 16-row tile times a staged B operand:
//   out[(row0 + i) * ldo + n] = scale_i * sum_k A[i, k] B[k, n]
// in O, for rows i < n_rows and columns n < N, with A the rows of `as`
// (stride lda, Kp columns, zero-padded to Kp) and B^T staged n-major as
// b_big [Np, ldb] (and b_small for float32: the parts on each column's
// grid). scale_g, scale_g8: the scales of rows g and g + 8. float32: each
// row's grid over its Kp values, four products a multiply-add
// (span_fwd_tc.cu); bfloat16: one exact product. kPairs: a lane stores
// its two columns of a row as one store where ldo is even (out aligned to
// two elements); else one store a value.
template <typename T, typename O = float, bool kPairs = false>
__device__ __forceinline__ void tile_times_staged(
    const T* as, int lda, int Kp, const T* b_big, const T* b_small, int ldb,
    int Np, int N, O* __restrict__ out, int ldo, size_t row0, int n_rows,
    float scale_g, float scale_g8, int lane) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int g = lane >> 2, t = lane & 3;
  const T* row_g = as + g * lda;
  const T* row_g8 = as + (g + 8) * lda;

  // the grids of rows g and g + 8: their tops over the four lanes of g
  float top_g = 0.f, top_g8 = 0.f;
  if constexpr (kF32) {
    for (int k0 = 0; k0 < Kp; k0 += 8) {
      top_g = fmaxf(top_g, fmaxf(fabsf(row_g[k0 + t]), fabsf(row_g[k0 + t + 4])));
      top_g8 = fmaxf(top_g8, fmaxf(fabsf(row_g8[k0 + t]), fabsf(row_g8[k0 + t + 4])));
    }
    top_g = quad_max(top_g);
    top_g8 = quad_max(top_g8);
  }
  const Grid grid_g(top_g), grid_g8(top_g8);

  for (int n0 = 0; n0 < Np; n0 += 8 * kNGroup) {
    float acc[kNGroup][4] = {}, small[kNGroup][4] = {};
    for (int k0 = 0; k0 < Kp; k0 += TileShape<T>::kK) {
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
        if (n0 + 8 * j >= Np) break;
        const size_t wb = (size_t)(n0 + 8 * j + g) * ldb + k0;
        float part[4];
        if constexpr (kF32) {
          mma_tf32(part, a_big, bits(b_big[wb + t]), bits(b_big[wb + t + 4]));
          float cross[4];
          mma_tf32(cross, a_small, bits(b_big[wb + t]), bits(b_big[wb + t + 4]));
          mma_tf32_acc(cross, a_big, bits(b_small[wb + t]),
                       bits(b_small[wb + t + 4]));
          mma_tf32_acc(cross, a_small, bits(b_small[wb + t]),
                       bits(b_small[wb + t + 4]));
#pragma unroll
          for (int i = 0; i < 4; ++i) small[j][i] += cross[i];
        } else {
          mma_bf16(part, a_big, pair(b_big + wb + 2 * t),
                   pair(b_big + wb + 2 * t + 8));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
      }
    }
    // rows g, g + 8 and columns 2 t, 2 t + 1 of each 8-column tile
    if constexpr (kPairs) {
      if (ldo % 2 == 0) {
#pragma unroll
        for (int j = 0; j < kNGroup; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (n0 + 8 * j >= Np) break;
#pragma unroll
          for (int i = 0; i < 4; i += 2) {
            const int row = i < 2 ? g : g + 8;
            const float scale = i < 2 ? scale_g : scale_g8;
            if (row >= n_rows || col >= N) continue;
            O* p = out + (row0 + row) * ldo + col;
            const float v0 = (acc[j][i] + small[j][i]) * scale;
            if (col + 1 < N)
              store_pair(p, v0, (acc[j][i + 1] + small[j][i + 1]) * scale);
            else
              *p = from_float<O>(v0);
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < kNGroup; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (n0 + 8 * j >= Np) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? g : g + 8;
        if (row < n_rows && col + (i & 1) < N)
          out[(row0 + row) * ldo + col + (i & 1)] = from_float<O>(
              (acc[j][i] + small[j][i]) * (i < 2 ? scale_g : scale_g8));
      }
    }
  }
}

// -- x^T g with the rows as the depth (#2's dW, #5) -------------------------

// The A operand of dW over one 16-edge tile for the warp's rows k0 + g,
// k0 + g + 8 (A[k][e] = xs[e][k]), as mma fragments: float32 in big and
// small parts on each row's grid over the tile's 16 edges, two 8-edge
// steps (A[g][8 h + t], A[g + 8][8 h + t], A[g][8 h + t + 4], A[g + 8][8 h
// + t + 4]); bfloat16 one m16n8k16 fragment (A[g][2 t, 2 t + 1], A[g +
// 8][2 t, 2 t + 1], A[g][2 t + 8, 2 t + 9], A[g + 8][2 t + 8, 2 t + 9]).
template <typename T> struct DwA;
template <> struct DwA<float> {
  unsigned big[2][4], small[2][4];
  __device__ __forceinline__ void load(const float* xs, int ldx, int k0,
                                       int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* xa = xs + k0 + g;
    float a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 8 * h + t;
      a[h][0] = xa[e * ldx];
      a[h][1] = xa[e * ldx + 8];
      a[h][2] = xa[(e + 4) * ldx];
      a[h][3] = xa[(e + 4) * ldx + 8];
    }
    float top = 0.f, top8 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top = fmaxf(top, fmaxf(fabsf(a[h][0]), fabsf(a[h][2])));
      top8 = fmaxf(top8, fmaxf(fabsf(a[h][1]), fabsf(a[h][3])));
    }
    const Grid grid(quad_max(top)), grid8(quad_max(top8));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = (i & 1 ? grid8 : grid).big(a[h][i]);
        big[h][i] = bits(v);
        small[h][i] = bits(tf32_round(a[h][i] - v));
      }
  }
};
template <> struct DwA<__nv_bfloat16> {
  unsigned frag[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* xs, int ldx,
                                       int k0, int lane) {
    const int g = lane >> 2, e = 2 * (lane & 3);
    const __nv_bfloat16* xa = xs + k0 + g;
    frag[0] = pack(xa[e * ldx], xa[(e + 1) * ldx]);
    frag[1] = pack(xa[e * ldx + 8], xa[(e + 1) * ldx + 8]);
    frag[2] = pack(xa[(e + 8) * ldx], xa[(e + 9) * ldx]);
    frag[3] = pack(xa[(e + 8) * ldx + 8], xa[(e + 9) * ldx + 8]);
  }
};

// run += A B over one 16-edge tile for the warp's 16 x 8 dW tile: A as
// loaded, B[e][n] = gs[e][m0 + n] (B[e][g] = gb[e * ldg]). float32: B's
// column g on its grid over the 16 edges; each 8-edge step's four products
// into fresh sums (the big ones exact), the two steps added, then added to
// run.
__device__ __forceinline__ void dw_tile_product(float (&run)[4],
                                                const DwA<float>& a,
                                                const float* gs, int ldg,
                                                int m0, int lane) {
  const int t = lane & 3;
  const float* gb = gs + m0 + (lane >> 2);
  float b[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h][0] = gb[(8 * h + t) * ldg];
    b[h][1] = gb[(8 * h + t + 4) * ldg];
  }
  const Grid grid(quad_max(fmaxf(fmaxf(fabsf(b[0][0]), fabsf(b[0][1])),
                                 fmaxf(fabsf(b[1][0]), fabsf(b[1][1])))));
  float big[4] = {}, small[4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned b_big[2], b_small[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v = grid.big(b[h][j]);
      b_big[j] = bits(v);
      b_small[j] = bits(tf32_round(b[h][j] - v));
    }
    float part[4], cross[4];
    mma_tf32(part, a.big[h], b_big[0], b_big[1]);
    mma_tf32(cross, a.small[h], b_big[0], b_big[1]);
    mma_tf32_acc(cross, a.big[h], b_small[0], b_small[1]);
    mma_tf32_acc(cross, a.small[h], b_small[0], b_small[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      big[i] += part[i];
      small[i] += cross[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] += big[i] + small[i];
}

// bfloat16: B[2 t, 2 t + 1][g], B[2 t + 8, 2 t + 9][g]; one exact product.
__device__ __forceinline__ void dw_tile_product(
    float (&run)[4], const DwA<__nv_bfloat16>& a, const __nv_bfloat16* gs,
    int ldg, int m0, int lane) {
  const int e = 2 * (lane & 3);
  const __nv_bfloat16* gb = gs + m0 + (lane >> 2);
  float part[4];
  mma_bf16(part, a.frag, pack(gb[e * ldg], gb[(e + 1) * ldg]),
           pack(gb[(e + 8) * ldg], gb[(e + 9) * ldg]));
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] += part[i];
}

// The warp's sums of dW tile (k0, m0) into part (row stride ld), rows
// k < K, columns m < M.
__device__ __forceinline__ void store_dw_tile(float* __restrict__ part,
                                              const float (&v)[4], int k0,
                                              int m0, int K, int M, int ld,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + (i < 2 ? g : g + 8), m = m0 + 2 * t + (i & 1);
    if (k < K && m < M) part[k * ld + m] = v[i];
  }
}

// The 16 x 8 tiles of a [K, M] product x^T g (the rows of x and g its
// depth: #2's dW, #5's d_rhs) that the warps of a kMsgWarps-warp block sum
// in registers. Tile o is rows 16 (o / Mn), columns 8 (o % Mn), Mn =
// ceil(M / 8); a warp owns consecutive tiles, which share their rows, so it
// splits each A fragment once for all of them. With fewer tiles (n_dw)
// than warps, `split` warps share one, each over every split-th 16-row
// tile of a stage, and add their sums in warp order at the end. kTiles:
// the most tiles a warp owns.
template <int kTiles>
struct DwTiles {
  int Mn, split, grp, sub, first, n_own;
  float run[kTiles][4];

  __device__ __forceinline__ DwTiles(int n_dw, int mn, int warp) : Mn(mn) {
    split = n_dw >= kMsgWarps ? 1 : kMsgWarps / n_dw;
    grp = warp / split;
    sub = warp % split;
    const int per_warp = (n_dw + kMsgWarps / split - 1) / (kMsgWarps / split);
    first = grp * per_warp;
    n_own = max(min(per_warp, n_dw - first), 0);
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[q][i] = 0.f;
  }

  // run += x^T g over a stage's 16-row tiles i = sub, sub + split, ... < n:
  // x rows tile_x(i) [16, ldx] (Kx = 16 ceil(K / 16) columns), g rows
  // tile_g(i) [16, ldg], zero rows and columns past the ends.
  template <typename T, typename TileX, typename TileG>
  __device__ __forceinline__ void add(int n, const TileX& tile_x,
                                      const TileG& tile_g, int ldx, int ldg,
                                      int lane) {
    for (int i = sub; i < n; i += split) {
      const T* xs = tile_x(i);
      const T* gs = tile_g(i);
      DwA<T> frag;
      int rows = -1;
#pragma unroll
      for (int q = 0; q < kTiles; ++q) {
        if (q >= n_own) break;
        const int kt = (first + q) / Mn;
        if (kt != rows) {
          frag.load(xs, ldx, kt * 16, lane);
          rows = kt;
        }
        dw_tile_product(run[q], frag, gs, ldg, (first + q - kt * Mn) * 8,
                        lane);
      }
    }
  }

  // The sums into part (row stride ld), rows k < K, columns m < M. Split
  // warps add theirs in warp order through red (kMsgWarps * 128 floats of
  // shared memory that no warp reads any more), between block barriers.
  __device__ __forceinline__ void store(float* __restrict__ part, int K,
                                        int M, int ld, float* red, int warp,
                                        int lane) const {
    if (split == 1) {
#pragma unroll
      for (int q = 0; q < kTiles; ++q) {
        const int o = first + q;
        if (q >= n_own) break;
        store_dw_tile(part, run[q], o / Mn * 16, o % Mn * 8, K, M, ld, lane);
      }
      return;
    }
    __syncthreads();   // every warp is done with red's memory
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(warp * 4 + i) * 32 + lane] = run[0][i];
    __syncthreads();
    if (sub == 0) {
      float sum[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum[i] = red[(warp * 4 + i) * 32 + lane];
        for (int j = 1; j < split; ++j)
          sum[i] += red[((warp + j) * 4 + i) * 32 + lane];
      }
      store_dw_tile(part, sum, grp / Mn * 16, grp % Mn * 8, K, M, ld, lane);
    }
  }
};


// The relation r of chunk c: rel_chunk_ptr[r] <= c < rel_chunk_ptr[r + 1].
__device__ __forceinline__ int chunk_relation(const int* __restrict__ rel_chunk_ptr,
                                              int c, int n_slots) {
  int r = 0, r_end = n_slots;
  while (r_end - r > 1) {
    const int mid = (r + r_end) >> 1;
    if (rel_chunk_ptr[mid] <= c) r = mid; else r_end = mid;
  }
  return r;
}

// The chunk kernel of #1 (span_fwd_tc.cu says how it works) and #7
// (halo_kernels.cu): one block per chunk c of edges [chunk_lo[c],
// chunk_hi[c]) of one relation, msg[j, :M] = rel_norm[j] * row(rel_src[j])
// @ W[r], f32, with row() from the source (DenseSrc, or #7's ShardSrc).
template <typename T, typename Src>
__global__ void __launch_bounds__(kMsgThreads)
span_msg_kernel(Src rows, const T* __restrict__ w,
                const int* __restrict__ chunk_lo,
                const int* __restrict__ chunk_hi,
                const int* __restrict__ rel_chunk_ptr,
                const int* __restrict__ rel_src,
                const float* __restrict__ rel_norm, float* __restrict__ msg,
                int K, int M, int n_slots, int unit) {
  constexpr bool kF32 = TileDims<T>::kSplit;
  const TileDims<T> d(K, M);
  extern __shared__ __align__(16) unsigned char msg_smem[];
  __shared__ float col_top[kMaxM];
  T* w_big = reinterpret_cast<T*>(msg_smem);
  T* w_small = w_big + d.w_elems;   // float32 only
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  rows.prepare();   // before the block's barriers below
  unsigned char* bufs = msg_smem + d.w_bytes + warp * 2 * d.x_bytes;

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
    gather_rows(reinterpret_cast<T*>(bufs), rows, edge_src(tile), K, d.Kp,
                d.ld, unit, lane);
  cp_commit();
  float my_norm = edge_norm(tile);
  int src_next = edge_src(tile + kMsgWarps);
  float norm_next = edge_norm(tile + kMsgWarps);
  for (int it = 0; tile < n_tiles; ++it, tile += kMsgWarps) {
    const T* xs = reinterpret_cast<const T*>(bufs + (it & 1) * d.x_bytes);
    if (tile + kMsgWarps < n_tiles)
      gather_rows(reinterpret_cast<T*>(bufs + ((it + 1) & 1) * d.x_bytes),
                  rows, src_next, K, d.Kp, d.ld, unit, lane);
    cp_commit();
    const int src_after = edge_src(tile + 2 * kMsgWarps);
    const float norm_after = edge_norm(tile + 2 * kMsgWarps);
    cp_wait<1>();   // all but the newest copies: this tile's rows
    __syncwarp();
    const int base = lo + tile * 16;
    tile_times_staged(xs, d.ld, d.Kp, w_big, w_small, d.ld, d.Np, M, msg, M,
                      (size_t)base, hi - base, __shfl_sync(kFull, my_norm, g),
                      __shfl_sync(kFull, my_norm, g + 8), lane);
    __syncwarp();
    my_norm = norm_next;
    src_next = src_after;
    norm_next = norm_after;
  }
  cp_wait<0>();
}

// Static shared memory of span_msg_kernel, at most: col_top and a source's
// table (ShardSrc: 64 pointers).
constexpr size_t kMsgStaticSmem = 1024;

// span_msg_kernel over n_chunks chunks; unit: the source's copy_unit.
template <typename T, typename Src>
cudaError_t launch_msg(const Src& rows, int unit, const void* w,
                       const int* chunk_lo, const int* chunk_hi,
                       const int* rel_chunk_ptr, const int* rel_src,
                       const float* rel_norm, float* msg, int n_chunks, int K,
                       int M, int n_slots, cudaStream_t stream) {
  const size_t smem = TileDims<T>(K, M).smem();
  auto kernel = span_msg_kernel<T, Src>;
  // a host call each launch: only for the widths past the default 48 KiB
  if (smem + kMsgStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_chunks, kMsgThreads, smem, stream>>>(
      rows, static_cast<const T*>(w), chunk_lo, chunk_hi, rel_chunk_ptr,
      rel_src, rel_norm, msg, K, M, n_slots, unit);
  return cudaGetLastError();
}

// G lanes own one output row (32 / G rows per warp), OC columns per lane:
// column o = c * G + (lane % G). Each lane sums its columns over the row's
// edges in CSR order: out[n] = sum_{j = rowptr[n]}^{rowptr[n+1]-1}
// msg[pos[j]]; rows with no edges are written as 0.
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

// dW[r] = sum of relation r's chunk partials [K, M] (P = K M values), in
// chunk order; 0 when r has no edges.
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

cudaError_t launch_dw_reduce(const float* partial, const int* rel_chunk_ptr,
                             float* dw, int slots, int P, cudaStream_t stream) {
  const dim3 grid((P + 255) / 256, slots);
  span_dw_reduce_kernel<<<grid, 256, 0, stream>>>(partial, rel_chunk_ptr, dw, P);
  return cudaGetLastError();
}

}  // namespace
