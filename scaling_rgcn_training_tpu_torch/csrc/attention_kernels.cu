// The attention head's multi-head self-attention, fused, for Hopper
// (sm_90a), with a plain C interface (bound from Python with ctypes, see
// ops/attention_kernels.py).
//
// Replaces no TPU kernel: the JAX package leaves its MHA
// (models/attention.py mha_self_attention) to XLA. The port's plain-op
// route ran it as some twenty PyTorch kernels a pass over [L, B, 3d]
// intermediates (batched 3x3 cuBLAS products, permute copies, elementwise
// passes), 142 of a 163 ms AM epoch, while the trunk reads only the first
// summary's output row. This computes that row alone, per node b:
//
//   q      = Wq x0 + bq                          (summary 0 only)
//   s_hj   = (q_h . (Wk_h x_j + bk_h)) / sqrt(dh),   a_h = softmax_j s_h
//   a'_hj  = a_hj / (1 - p) where draw[b, h, 0, j] >= p, else 0
//   o_h    = sum_j a'_hj (Wv_h x_j + bv_h)
//   y      = Wo o + bo
//
// rearranged so that no product runs once per summary: with
// qt_h = Wk_h^T q_h (a d-vector per head) s_hj = (qt_h . x_j + q_h . bk_h)
// / sqrt(dh), and with xbar_h = sum_j a'_hj x_j and S_h = sum_j a'_hj,
// o_h = Wv_h xbar_h + S_h bv_h. Four [d x d] products a node (Q, Qt, V,
// out: 8 d^2 FLOP) instead of the 2 (2L + 2) d^2 of K and V for every
// summary; the summaries enter only through the per-node dot products
// (4 H L d FLOP). The same function, rounded in another order.
//
// Three kernels:
//   - mha_pack_kernel: the parameters in torch's layouts (in_proj [3d, d],
//     [3d]; out_proj [d, d], [d]) into one packed buffer in the layouts the
//     products read, zero-padded: d to dp (a multiple of 4) and each head
//     of dh to dhp (a multiple of 4), so every product runs in float4
//     steps and no 4-wide group of outputs straddles two heads;
//   - mha_fwd_kernel: persistent blocks of 512 threads over tiles of T
//     nodes (the last partial). The packed matrices sit in shared memory
//     for the block's life where they fit beside a tile (AM: 79 KB at d =
//     63), else each is copied in before the product that reads it. A
//     tile's x rows are copied once into shared memory (cp.async; the next
//     tile's while this one runs its last products) as [feature][node]
//     rows, T + 4 floats apart (an odd number of float4: float4 reads of
//     adjacent rows fall on distinct banks), and every intermediate stays
//     there: each product is
//     register-tiled, 4 nodes x 4 outputs a thread, float4 loads along the
//     depth, f32 FFMA; the softmax, dropout and xbar are per-node loops;
//   - mha_bwd_kernel: the same chain recomputed from x, then its backward
//     (dWo, go, dWv, gxbar, the softmax's backward, gqt, dWk, gq, dWq and,
//     when asked, dx) in the same tile. Each block owns a partial of the
//     packed gradients in global memory (L2-resident at AM's shape) and
//     adds each tile's sums into it, each entry always by the same thread:
//     no atomics. mha_reduce_kernel sums the partials in block order and
//     unpacks them into torch's layouts, so two runs give the same bits.
//
// What bounds it on an H100: the f32 operations. At AM (N = 1,666,764,
// L = H = 3, d = 63) the forward is 8 d^2 + 4 H L d = 34k FLOP a node,
// 57 GFLOP (0.85 ms at 67 TFLOP/s), against 1.26 GB of x and 0.42 GB of y
// (0.50 ms at 3.35 TB/s); the backward recomputes the forward's first
// three products and adds seven more (20 d^2 a node; 22 d^2 with dx). The
// products are f32 FFMA on the CUDA cores: single-pass TF32 fails the
// benchmark's gradient check, and 3xTF32 with mma.sync, one 16 x 8 tile a
// warp at a time, ran slower at AM's shape (H100: 6.7 against 4.7 ms
// forward, 19.2 against 15.8 ms backward), its phases being a few short
// chains of dependent mma's.
//
// Padding rows and columns hold zeros in the packed weights and in the
// shared x rows, so padded outputs are 0 and add nothing; nodes past the
// end of a partial tile read zeros (x and gy), so their gradient sums are
// 0 and they write nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "span_tc.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxL = 8;
// dynamic shared memory a block may use (227 KB)
constexpr int kMaxSmem = 232448;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// the row stride of a packed matrix of `cols` columns (a multiple of 4):
// an odd number of float4, so the rows that a warp's lanes read in one
// step lie on distinct banks
__host__ __device__ __forceinline__ int row_stride(int cols) {
  return cols % 8 == 0 ? cols + 4 : cols;
}

// The shape and the packed buffer: MQ [dp][dq] (Wq^T), MK [dq][dp] (Wk),
// MV [dp][dq] (Wv^T), MO [dq][dp] (Wo^T), rows ldq = row_stride(dq) or
// ldp = row_stride(dp) floats apart, then BQ, BK, BV [dq] and BO [dp];
// dq = H dhp indexes q, o and their gradients head by head.
struct Shape {
  int L, d, H, dh, dp, dhp, dq, ldq, ldp, packed;
  __host__ __device__ Shape(int L_, int d_, int H_)
      : L(L_), d(d_), H(H_), dh(d_ / H_), dp(round4(d_)),
        dhp(round4(d_ / H_)), dq(H_ * round4(d_ / H_)) {
    ldq = row_stride(dq);
    ldp = row_stride(dp);
    packed = bias() + 3 * dq + dp;
  }
  // matrix m's offset in the packed buffer, its floats and its row stride
  __host__ __device__ int off(int m) const {
    return (m / 2) * (dp * ldq + dq * ldp) + (m % 2) * dp * ldq;
  }
  __host__ __device__ int size(int m) const {
    return m % 2 == 0 ? dp * ldq : dq * ldp;
  }
  __host__ __device__ int ld(int m) const { return m % 2 == 0 ? ldq : ldp; }
  __host__ __device__ int bias() const { return off(4); }
  __host__ __device__ int largest() const {
    return size(0) > size(1) ? size(0) : size(1);
  }
};

// Where packed entry idx comes from in torch's layouts: which tensor (0
// in_proj_weight, 1 in_proj_bias, 2 out_proj_weight, 3 out_proj_bias; -1
// padding) and the offset in it.
__device__ __forceinline__ int source_of(const Shape& s, int idx, int* off) {
  int m = 0;
  while (m < 4 && idx >= s.off(m + 1)) ++m;
  int r = idx - s.off(m);
  if (m < 4) {
    // MQ, MV: row i (feature), column e' (head-padded); MK, MO: row e',
    // column i
    const bool rows_feat = (m == 0 || m == 2);
    const int ld = s.ld(m);
    const int row = r / ld, col = r - row * ld;
    if (col >= (rows_feat ? s.dq : s.dp)) return -1;
    const int i = rows_feat ? row : col, ep = rows_feat ? col : row;
    const int h = ep / s.dhp, e = ep - h * s.dhp;
    if (i >= s.d || e >= s.dh) return -1;
    const int f = h * s.dh + e;
    if (m == 3) {
      *off = i * s.d + f;               // Wo[i][f]
      return 2;
    }
    const int part = m == 0 ? 0 : (m == 1 ? 1 : 2);
    *off = (part * s.d + f) * s.d + i;  // in_proj[part d + f][i]
    return 0;
  }
  r = idx - s.bias();
  if (r < 3 * s.dq) {
    const int part = r / s.dq, ep = r - part * s.dq;
    const int h = ep / s.dhp, e = ep - h * s.dhp;
    if (e >= s.dh) return -1;
    *off = part * s.d + h * s.dh + e;
    return 1;
  }
  r -= 3 * s.dq;
  if (r >= s.d) return -1;
  *off = r;
  return 3;
}

// Shared memory of a block, in floats (each region 16-byte aligned): the
// biases, the matrices (all four, or one at a time), then [rows][ldt]
// regions: X (the L x rows), Q (q; o in the forward; gq in the backward),
// QT (qt; xbar, then y's [dp][T], in the forward; gqt in the backward),
// and in the backward XB (xbar, then gxbar), O (o, then go), GY and, with
// dx, GX; P holds the per-node scalars: a, a', S and in the backward
// scale * gs and gc.
struct Layout {
  int T, ldt, resident, bias, w, x, q, qt, xb, o, gy, p, gx, total;
  __host__ __device__ Layout(const Shape& s, int T_, int resident_,
                             bool backward, bool dx)
      : T(T_), ldt(T_ + 4), resident(resident_) {
    int at = 0;
    auto take = [&](int floats) {
      const int here = at;
      at += round4(floats);
      return here;
    };
    bias = take(3 * s.dq + s.dp);
    w = take(resident ? s.bias() : s.largest());
    x = take(s.L * s.dp * ldt);
    q = take(s.dq * ldt);
    qt = take(s.H * s.dp * ldt);
    xb = backward ? take(s.H * s.dp * ldt) : qt;
    o = backward ? take(s.dq * ldt) : q;
    gy = backward ? take(s.dp * ldt) : 0;
    p = take((2 * s.H * s.L + s.H + (backward ? s.H * s.L + s.H : 0)) * ldt);
    gx = dx ? take(s.L * s.dp * ldt) : 0;
    total = at;
  }
  __host__ __device__ size_t bytes() const { return (size_t)total * 4; }
  // rows of P: a (H L), a' (H L), S (H), scale * gs (H L), gc (H)
  __host__ __device__ int pa() const { return p; }
  __host__ __device__ int pd(const Shape& s) const { return p + s.H * s.L * ldt; }
  __host__ __device__ int ps(const Shape& s) const { return p + 2 * s.H * s.L * ldt; }
  __host__ __device__ int pg(const Shape& s) const {
    return p + (2 * s.H * s.L + s.H) * ldt;
  }
  __host__ __device__ int pc(const Shape& s) const {
    return p + (3 * s.H * s.L + s.H) * ldt;
  }
};

// The tile size and weight residence of a pass: the largest tile (64 to
// 16 nodes) beside all four matrices, else the largest (64 to 4) beside
// one; T = 0 when nothing fits.
__host__ Layout plan_layout(const Shape& s, bool backward, bool dx) {
  for (int resident = 1; resident >= 0; --resident)
    for (int T = 64; T >= (resident ? 16 : 4); T /= 2) {
      const Layout l(s, T, resident, backward, dx);
      if (l.bytes() <= (size_t)kMaxSmem) return l;
    }
  return Layout(s, 0, 0, backward, dx);
}

struct Args {
  const float* x;       // [L, B, d]
  const float* draw;    // [B, H, L, L] or null (no dropout)
  const float* packed;  // Shape::packed floats
  const float* gy;      // [B, d] (backward)
  float* y;             // [B, d] (forward)
  float* dx;            // [L, B, d] or null (backward)
  float* partial;       // [gridDim.x, packed] (backward)
  int L, B, d, H;
  float p, inv_keep, scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// floats [0, n) (n a multiple of 4) from global to shared memory
__device__ __forceinline__ void copy_in(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    st4(dst + i, ld4(src + i));
}

// For each group g < G, output rows n < N of C_g, nodes t < T:
//   C_g[n][t] (=|+=) sum_{k<K} A_g[k][t] B_g(k, n)
//                    + bias_g[n] * (bscale_g ? bscale_g[t] : 1)
// A_g = A + g ag and C_g = C + g cg are [row][ldt] regions; B_g = B + g bg
// is B(k, n) = B_g[k ldb + n] (natural) or B_g[n ldb + k] (kTrans). K, N
// and T are multiples of 4. A thread holds 4 x 4 sums and takes 4 depth
// steps a round: 4 float4 loads of A and 4 of B for 64 FFMA, the next
// round's loads started before this round's products. Its outputs are 4
// adjacent rows (natural: one float4 of B a step) or 4 rows N / 4 apart
// (kTrans: the lanes of a warp then read adjacent rows of B, on distinct
// banks by row_stride).
template <bool kTrans>
__device__ void gemm(int G, int K, int N, int T, int ldt, const float* A,
                     int ag, const float* B, int ldb, int bg,
                     const float* bias, int biasg, const float* bscale,
                     int bscaleg, float* C, int cg, bool add) {
  const int TG = T / 4, NG = N / 4, per = TG * NG, total = G * per;
  for (int m = threadIdx.x; m < total; m += kThreads) {
    const int g = m / per, r = m - g * per;
    const int ng = r / TG, tg = r - ng * TG;
    const int t0 = 4 * tg;
    // the thread's output rows: n0 + j nstep, j < 4
    const int n0 = kTrans ? ng : 4 * ng, nstep = kTrans ? NG : 1;
    const float* a = A + g * ag + t0;
    const float* b = B + g * bg;
    float acc[4][4];  // [n][t]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    float4 av[4], bv[4];
    auto fetch = [&](int k, float4 (&ta)[4], float4 (&tb)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) ta[u] = ld4(a + (k + u) * ldt);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        tb[u] = kTrans ? ld4(b + (n0 + u * nstep) * ldb + k)  // B(k.., n_u)
                       : ld4(b + (k + u) * ldb + n0);         // B(k+u, n0..)
    };
    fetch(0, av, bv);
    for (int k = 0; k < K; k += 4) {
      float4 an[4], bn[4];
      fetch(k + 4 < K ? k + 4 : k, an, bn);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bk = kTrans ? at4(bv[j], u) : at4(bv[u], j);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j][i] = fmaf(at4(av[u], i), bk, acc[j][i]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = an[u];
        bv[u] = bn[u];
      }
    }
    float4 old[4];
    if (add) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        old[j] = ld4(C + g * cg + (n0 + j * nstep) * ldt + t0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j * nstep;
      float v[4] = {acc[j][0], acc[j][1], acc[j][2], acc[j][3]};
      if (bias != nullptr) {
        const float bb = bias[g * biasg + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] += bscale == nullptr ? bb : bb * bscale[g * bscaleg + t0 + i];
      }
      if (add) {
        v[0] += old[j].x; v[1] += old[j].y; v[2] += old[j].z; v[3] += old[j].w;
      }
      st4(C + g * cg + n * ldt + t0, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

// For each group g, rows r < R and columns c < Cn of a gradient matrix:
//   P_g[r ldp + c] (= on the block's first tile, else +=)
//       sum_{t<T} Rs_g[r][t] Ss_g[c][t]   (added in t order)
// with Rs_g = Rs + g rg, Ss_g = Ss + g sg ([row][ldt] regions) and P_g =
// P + g pg in global memory. R, Cn and T are multiples of 4. A thread
// holds 4 adjacent rows by 4 columns Cn / 4 apart (the lanes of a warp
// read adjacent rows of Ss, on distinct banks: ldt / 4 is odd for T >= 8).
__device__ void dw_gemm(int G, int R, int Cn, int T, int ldt, const float* Rs,
                        int rg, const float* Ss, int sg, float* P, int pg,
                        int ldp, bool first) {
  const int CG = Cn / 4, per = (R / 4) * CG, total = G * per;
  for (int m = threadIdx.x; m < total; m += kThreads) {
    const int g = m / per, rem = m - g * per;
    const int rb = rem / CG, cb = rem - rb * CG;
    const int r0 = 4 * rb;
    const float* rs = Rs + g * rg + r0 * ldt;
    const float* ss = Ss + g * sg + cb * ldt;
    float* dst = P + g * pg + r0 * ldp + cb;
    // the partial's values, read before the products so the L2 round trip
    // overlaps them
    float acc[4][4];  // [r][c]
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][j] = first ? 0.f : dst[u * ldp + j * CG];
    float4 rv[4], sv[4];
    auto fetch = [&](int t, float4 (&tr)[4], float4 (&ts)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) tr[u] = ld4(rs + u * ldt + t);
#pragma unroll
      for (int j = 0; j < 4; ++j) ts[j] = ld4(ss + j * CG * ldt + t);
    };
    fetch(0, rv, sv);
    for (int t = 0; t < T; t += 4) {
      float4 rn[4], sn[4];
      fetch(t + 4 < T ? t + 4 : t, rn, sn);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[u][j] = fmaf(at4(rv[u], i), at4(sv[j], i), acc[u][j]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        rv[u] = rn[u];
        sv[u] = sn[u];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[u * ldp + j * CG] = acc[u][j];
  }
}

// P[r] (= on the first tile, else +=) sum_{t<T} rows[r][t] (scale ?
// scale[(r / per_scale) ldt + t] : 1), for r < n; row r on thread
// kThreads - 1 - r (the threads a dw_gemm beside it leaves idle)
__device__ void bias_sum(int n, int per_scale, int T, int ldt,
                         const float* rows, const float* scale, float* P,
                         bool first) {
  for (int r = kThreads - 1 - threadIdx.x; r < n; r += kThreads) {
    const float* row = rows + r * ldt;
    const float* sc = scale == nullptr ? nullptr : scale + (r / per_scale) * ldt;
    float acc = first ? 0.f : P[r];
    for (int t = 0; t < T; ++t)
      acc = fmaf(row[t], sc == nullptr ? 1.f : sc[t], acc);
    P[r] = acc;
  }
}

// `blocks` blocks of a tile's rows from node-major global memory (block j
// at src + j src_block, node b0 + t at row t, d floats a row) into
// [feature][ldt] shared rows (block j at dst + j dp ldt), by cp.async: 4
// bytes a node, zeros past the valid nodes and the d features. The caller
// commits and waits. The forward starts the next tile's x once X is no
// longer read, so the copy overlaps the tile's last products.
__device__ void copy_rows_async(float* dst, const float* src,
                                size_t src_block, int blocks, int d, int dp,
                                int T, int ldt, int b0, int valid) {
  const int TG = T / 4, total = blocks * TG * dp;
  for (int m = threadIdx.x; m < total; m += kThreads) {
    const int i = m % dp, rest = m / dp;
    const int tg = rest % TG, j = rest / TG;
    const float* s = src + j * src_block + (size_t)b0 * d + i;
    float* o = dst + (j * dp + i) * ldt + 4 * tg;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = 4 * tg + u;
      const bool in = i < d && t < valid;
      cp_async4(o + u, in ? s + (size_t)t * d : src, in ? 4 : 0);
    }
  }
}

// The dropout draw's keep bits of node b0 + t, head h: bit j set where
// draw[b, h, 0, j] >= p (all set without a draw or past the valid
// nodes). The loads start before the caller's first use of the bits.
__device__ __forceinline__ unsigned keep_bits(const Args& a, const Shape& s,
                                              int b0, int t, int valid,
                                              int h) {
  if (a.draw == nullptr || t >= valid) return ~0u;
  const float* r = a.draw + ((size_t)(b0 + t) * s.H + h) * s.L * s.L;
  float v[kMaxL];
#pragma unroll
  for (int j = 0; j < kMaxL; ++j) v[j] = j < s.L ? r[j] : 0.f;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kMaxL; ++j)
    if (j < s.L && v[j] >= a.p) bits |= 1u << j;
  return bits;
}

// The per-node dot products of a tile: for each head h, summary j and
// node t, D[(h L + j) ldt + t] = sum_{i<dp} U[h dp + i][t] X[j dp + i][t];
// one thread a (head, summary, node).
__device__ void head_dots(const Shape& s, int T, int ldt, const float* U,
                          const float* X, float* D) {
  for (int m = threadIdx.x; m < s.H * s.L * T; m += kThreads) {
    const int hj = m / T, t = m - hj * T;
    const int h = hj / s.L, j = hj - h * s.L;
    const float* u = U + h * s.dp * ldt + t;
    const float* x = X + j * s.dp * ldt + t;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < s.dp; ++i) acc = fmaf(u[i * ldt], x[i * ldt], acc);
    D[hj * ldt + t] = acc;
  }
}

// the inverse of copy_rows_async, for the valid nodes and features
__device__ void store_rows(float* dst, size_t dst_block, const float* src,
                           int blocks, int d, int dp, int T, int ldt,
                           int valid) {
  const int TG = T / 4, total = blocks * TG * d;
  for (int m = threadIdx.x; m < total; m += kThreads) {
    const int i = m % d, rest = m / d;
    const int tg = rest % TG, j = rest / TG;
    const float4 v = ld4(src + (j * dp + i) * ldt + 4 * tg);
    float* o = dst + j * dst_block;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = 4 * tg + u;
      if (t < valid) o[(size_t)t * d + i] = at4(v, u);
    }
  }
}

// the shared copy of packed matrix m (0 MQ, 1 MK, 2 MV, 3 MO): resident,
// or copied in now (after the barrier that ended the previous product)
__device__ __forceinline__ const float* use_matrix(const Args& a,
                                                   const Shape& s,
                                                   const Layout& l,
                                                   float* smem, int m) {
  if (l.resident) return smem + l.w + s.off(m);
  copy_in(smem + l.w, a.packed + s.off(m), s.size(m));
  __syncthreads();
  return smem + l.w;
}

// The forward chain of one tile up to xbar and S (into XB), from the x
// rows in X: q, qt, the scores, softmax and dropout (a, a', S in P).
__device__ void chain_to_xbar(const Args& a, const Shape& s, const Layout& l,
                              float* smem, int b0, int valid, float* xbar) {
  const int T = l.T, ldt = l.ldt;
  float* X = smem + l.x;
  float* Q = smem + l.q;
  float* QT = smem + l.qt;
  const float* bias = smem + l.bias;
  // q = Wq x0 + bq
  const float* MQ = use_matrix(a, s, l, smem, 0);
  gemm<false>(1, s.dp, s.dq, T, ldt, X, 0, MQ, s.ldq, 0, bias, 0, nullptr, 0,
              Q, 0, false);
  __syncthreads();
  // qt_h = Wk_h^T q_h
  const float* MK = use_matrix(a, s, l, smem, 1);
  gemm<false>(s.H, s.dhp, s.dp, T, ldt, Q, s.dhp * ldt, MK, s.ldp,
              s.dhp * s.ldp, nullptr, 0, nullptr, 0, QT, s.dp * ldt, false);
  __syncthreads();
  // scores qt_h . x_j (into PA), then per (head, node) the softmax and
  // dropout
  float* PA = smem + l.pa();
  float* PD = smem + l.pd(s);
  float* PS = smem + l.ps(s);
  const float* BK = bias + s.dq;
  head_dots(s, T, ldt, QT, X, PA);
  __syncthreads();
  for (int m = threadIdx.x; m < s.H * T; m += kThreads) {
    const int h = m / T, t = m - h * T;
    const unsigned keep = keep_bits(a, s, b0, t, valid, h);
    float c = 0.f;
    for (int e = 0; e < s.dhp; ++e)
      c = fmaf(Q[(h * s.dhp + e) * ldt + t], BK[h * s.dhp + e], c);
    float* sc = PA + h * s.L * ldt + t;  // row j: sc[j ldt]
    float* ad = PD + h * s.L * ldt + t;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < s.L; ++j) {
      const float v = (sc[j * ldt] + c) * a.scale;
      sc[j * ldt] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.f;
    for (int j = 0; j < s.L; ++j) {
      const float e = expf(sc[j * ldt] - mx);
      sc[j * ldt] = e;
      sum += e;
    }
    float S = 0.f;
    for (int j = 0; j < s.L; ++j) {
      const float aj = sc[j * ldt] / sum;
      float kept = aj;
      if (a.draw != nullptr) kept = (keep >> j) & 1u ? aj * a.inv_keep : 0.f;
      sc[j * ldt] = aj;
      ad[j * ldt] = kept;
      S += kept;
    }
    PS[h * ldt + t] = S;
  }
  __syncthreads();
  // xbar_h = sum_j a'_hj x_j: one thread a (head, feature, 4 nodes)
  const int TG = T / 4;
  for (int m = threadIdx.x; m < s.H * s.dp * TG; m += kThreads) {
    const int tg = m % TG, hi = m / TG;
    const int h = hi / s.dp, i = hi - h * s.dp;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < s.L; ++j) {
      const float4 w = ld4(PD + (h * s.L + j) * ldt + 4 * tg);
      const float4 xv = ld4(X + (j * s.dp + i) * ldt + 4 * tg);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = fmaf(at4(w, u), at4(xv, u), v[u]);
    }
    st4(xbar + hi * ldt + 4 * tg, make_float4(v[0], v[1], v[2], v[3]));
  }
  __syncthreads();
}

// o_h = Wv_h xbar_h + S_h bv_h into O
__device__ void chain_o(const Args& a, const Shape& s, const Layout& l,
                        float* smem, const float* xbar, float* O) {
  const float* MV = use_matrix(a, s, l, smem, 2);
  gemm<false>(s.H, s.dp, s.dhp, l.T, l.ldt, xbar, s.dp * l.ldt, MV, s.ldq,
              s.dhp, smem + l.bias + 2 * s.dq, s.dhp, smem + l.ps(s), l.ldt,
              O, s.dhp * l.ldt, false);
  __syncthreads();
}

__device__ void load_packed_biases(const Args& a, const Shape& s,
                                   const Layout& l, float* smem) {
  copy_in(smem + l.bias, a.packed + s.bias(), round4(3 * s.dq + s.dp));
  if (l.resident) copy_in(smem + l.w, a.packed, s.bias());
}

__global__ void __launch_bounds__(kThreads)
mha_pack_kernel(const float* __restrict__ in_w, const float* __restrict__ in_b,
                const float* __restrict__ out_w,
                const float* __restrict__ out_b, float* __restrict__ packed,
                int L, int d, int H) {
  const Shape s(L, d, H);
  const int n = round4(s.packed);
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += gridDim.x * kThreads) {
    int off = 0;
    const int src = idx < s.packed ? source_of(s, idx, &off) : -1;
    const float* from = src == 0 ? in_w : src == 1 ? in_b : src == 2 ? out_w
                                                                     : out_b;
    packed[idx] = src < 0 ? 0.f : from[off];
  }
}

__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(Args a, int T, int resident) {
  extern __shared__ __align__(16) float smem[];
  const Shape s(a.L, a.d, a.H);
  const Layout l(s, T, resident, false, false);
  load_packed_biases(a, s, l, smem);
  const int n_tiles = (a.B + T - 1) / T;
  float* X = smem + l.x;
  const size_t block = (size_t)a.B * a.d;
  if ((int)blockIdx.x < n_tiles) {
    const int b0 = blockIdx.x * T;
    copy_rows_async(X, a.x, block, s.L, a.d, s.dp, T, l.ldt, b0,
                    min(T, a.B - b0));
    cp_commit();
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * T, valid = min(T, a.B - b0);
    cp_wait<0>();
    __syncthreads();  // the tile's x is in; the previous tile's y is out
    float* xbar = smem + l.qt;  // qt is read before xbar is written
    chain_to_xbar(a, s, l, smem, b0, valid, xbar);
    const int next = b0 + gridDim.x * T;
    if (next < a.B) {
      copy_rows_async(X, a.x, block, s.L, a.d, s.dp, T, l.ldt, next,
                      min(T, a.B - next));
      cp_commit();
    }
    float* O = smem + l.q;      // q is read before o is written
    chain_o(a, s, l, smem, xbar, O);
    // y = Wo o + bo into the QT region (xbar is read before)
    const float* MO = use_matrix(a, s, l, smem, 3);
    float* Y = smem + l.qt;
    gemm<false>(1, s.dq, s.dp, T, l.ldt, O, 0, MO, s.ldp, 0,
                smem + l.bias + 3 * s.dq, 0, nullptr, 0, Y, 0, false);
    __syncthreads();
    store_rows(a.y + (size_t)b0 * a.d, 0, Y, 1, a.d, s.dp, T, l.ldt, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
mha_bwd_kernel(Args a, int T, int resident) {
  extern __shared__ __align__(16) float smem[];
  const Shape s(a.L, a.d, a.H);
  const bool want_dx = a.dx != nullptr;
  const Layout l(s, T, resident, true, want_dx);
  const int ldt = l.ldt;
  load_packed_biases(a, s, l, smem);
  float* X = smem + l.x;
  float* Q = smem + l.q;
  float* QT = smem + l.qt;
  float* XB = smem + l.xb;
  float* O = smem + l.o;
  float* GY = smem + l.gy;
  float* GX = smem + l.gx;
  const float* PA = smem + l.pa();
  const float* PD = smem + l.pd(s);
  const float* PS = smem + l.ps(s);
  float* PG = smem + l.pg(s);
  float* PC = smem + l.pc(s);
  const float* bias = smem + l.bias;
  float* part = a.partial + (size_t)blockIdx.x * s.packed;
  float* dB = part + s.bias();
  const int n_tiles = (a.B + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * T, valid = min(T, a.B - b0);
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();
    copy_rows_async(X, a.x, (size_t)a.B * a.d, s.L, a.d, s.dp, T, ldt, b0,
                    valid);
    copy_rows_async(GY, a.gy, 0, 1, a.d, s.dp, T, ldt, b0, valid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    chain_to_xbar(a, s, l, smem, b0, valid, XB);
    chain_o(a, s, l, smem, XB, O);
    // dWo (MO[e'][n] += o[e'] gy[n]), dbo
    dw_gemm(1, s.dq, s.dp, T, ldt, O, 0, GY, 0, part + s.off(3), 0, s.ldp,
            first);
    bias_sum(s.dp, 1, T, ldt, GY, nullptr, dB + 3 * s.dq, first);
    __syncthreads();
    // go = Wo^T gy, over o
    const float* MO = use_matrix(a, s, l, smem, 3);
    gemm<true>(1, s.dp, s.dq, T, ldt, GY, 0, MO, s.ldp, 0, nullptr, 0, nullptr,
               0, O, 0, false);
    __syncthreads();
    // dWv (MV[i][h dhp + e] += xbar_h[i] go_h[e]), dbv (go S_h)
    dw_gemm(s.H, s.dp, s.dhp, T, ldt, XB, s.dp * ldt, O, s.dhp * ldt,
            part + s.off(2), s.dhp, s.ldq, first);
    bias_sum(s.dq, s.dhp, T, ldt, O, PS, dB + 2 * s.dq, first);
    __syncthreads();
    // gxbar_h = Wv_h^T go_h, over xbar
    const float* MV = use_matrix(a, s, l, smem, 2);
    gemm<true>(s.H, s.dhp, s.dp, T, ldt, O, s.dhp * ldt, MV, s.ldq, s.dhp,
               nullptr, 0, nullptr, 0, XB, s.dp * ldt, false);
    __syncthreads();
    // gxbar_h . x_j (into PG), then per (head, node) the dropout's and
    // softmax's backward
    head_dots(s, T, ldt, XB, X, PG);
    __syncthreads();
    const float* BV = bias + 2 * s.dq;
    for (int m = threadIdx.x; m < s.H * T; m += kThreads) {
      const int h = m / T, t = m - h * T;
      const unsigned keep = keep_bits(a, s, b0, t, valid, h);
      float gS = 0.f;
      for (int e = 0; e < s.dhp; ++e)
        gS = fmaf(O[(h * s.dhp + e) * ldt + t], BV[h * s.dhp + e], gS);
      float* g = PG + h * s.L * ldt + t;  // row j: g[j ldt]
      const float* pa = PA + h * s.L * ldt + t;
      float dot = 0.f;
      for (int j = 0; j < s.L; ++j) {
        float ga = g[j * ldt] + gS;
        if (a.draw != nullptr) ga = (keep >> j) & 1u ? ga * a.inv_keep : 0.f;
        g[j * ldt] = ga;
        dot = fmaf(pa[j * ldt], ga, dot);
      }
      float gc = 0.f;
      for (int j = 0; j < s.L; ++j) {
        const float gs = pa[j * ldt] * (g[j * ldt] - dot) * a.scale;
        g[j * ldt] = gs;
        gc += gs;
      }
      PC[h * ldt + t] = gc;
    }
    __syncthreads();
    const int TG = T / 4;
    if (want_dx) {
      // gx_j = sum_h (scale gs_hj qt_h + a'_hj gxbar_h)
      for (int m = threadIdx.x; m < s.L * s.dp * TG; m += kThreads) {
        const int tg = m % TG, ji = m / TG;
        const int j = ji / s.dp, i = ji - j * s.dp;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int h = 0; h < s.H; ++h) {
          const float4 g = ld4(PG + (h * s.L + j) * ldt + 4 * tg);
          const float4 qt = ld4(QT + (h * s.dp + i) * ldt + 4 * tg);
          const float4 w = ld4(PD + (h * s.L + j) * ldt + 4 * tg);
          const float4 gx = ld4(XB + (h * s.dp + i) * ldt + 4 * tg);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = fmaf(at4(w, u), at4(gx, u),
                        fmaf(at4(g, u), at4(qt, u), v[u]));
        }
        st4(GX + ji * ldt + 4 * tg, make_float4(v[0], v[1], v[2], v[3]));
      }
      __syncthreads();
    }
    // gqt_h = sum_j scale gs_hj x_j, over qt
    for (int m = threadIdx.x; m < s.H * s.dp * TG; m += kThreads) {
      const int tg = m % TG, hi = m / TG;
      const int h = hi / s.dp, i = hi - h * s.dp;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < s.L; ++j) {
        const float4 g = ld4(PG + (h * s.L + j) * ldt + 4 * tg);
        const float4 xv = ld4(X + (j * s.dp + i) * ldt + 4 * tg);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = fmaf(at4(g, u), at4(xv, u), v[u]);
      }
      st4(QT + hi * ldt + 4 * tg, make_float4(v[0], v[1], v[2], v[3]));
    }
    __syncthreads();
    // dWk (MK[h dhp + e][i] += q_h[e] gqt_h[i]), dbk (q gc_h)
    dw_gemm(s.H, s.dhp, s.dp, T, ldt, Q, s.dhp * ldt, QT, s.dp * ldt,
            part + s.off(1), s.dhp * s.ldp, s.ldp, first);
    bias_sum(s.dq, s.dhp, T, ldt, Q, PC, dB + s.dq, first);
    __syncthreads();
    // gq_h = Wk_h gqt_h + gc_h bk_h, over q
    const float* MK = use_matrix(a, s, l, smem, 1);
    gemm<true>(s.H, s.dp, s.dhp, T, ldt, QT, s.dp * ldt, MK, s.ldp,
               s.dhp * s.ldp, bias + s.dq, s.dhp, PC, ldt, Q, s.dhp * ldt,
               false);
    __syncthreads();
    // dWq (MQ[i][e'] += x0[i] gq[e']), dbq
    dw_gemm(1, s.dp, s.dq, T, ldt, X, 0, Q, 0, part, 0, s.ldq, first);
    bias_sum(s.dq, 1, T, ldt, Q, nullptr, dB, first);
    if (want_dx) {
      // gx_0 += Wq^T gq
      __syncthreads();
      const float* MQ = use_matrix(a, s, l, smem, 0);
      gemm<true>(1, s.dq, s.dp, T, ldt, Q, 0, MQ, s.ldq, 0, nullptr, 0,
                 nullptr, 0, GX, 0, true);
      __syncthreads();
      store_rows(a.dx + (size_t)b0 * a.d, (size_t)a.B * a.d, GX, s.L, a.d,
                 s.dp, T, ldt, valid);
    }
  }
}

// Each packed entry's sum over the blocks' partials, in block order, into
// torch's layouts (padding entries are dropped).
__global__ void __launch_bounds__(kThreads)
mha_reduce_kernel(const float* __restrict__ partial, int blocks, int L, int d,
                  int H, float* __restrict__ d_in_w, float* __restrict__ d_in_b,
                  float* __restrict__ d_out_w, float* __restrict__ d_out_b) {
  const Shape s(L, d, H);
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < s.packed;
       idx += gridDim.x * kThreads) {
    int off = 0;
    const int dst = source_of(s, idx, &off);
    if (dst < 0) continue;
    float acc = 0.f;
    for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * s.packed + idx];
    float* to = dst == 0 ? d_in_w : dst == 1 ? d_in_b : dst == 2 ? d_out_w
                                                                 : d_out_b;
    to[off] = acc;
  }
}

bool shape_ok(int L, int d, int H) {
  return L >= 1 && L <= kMaxL && d >= 1 && H >= 1 && d % H == 0;
}

int pack_blocks(const Shape& s) {
  const int n = (round4(s.packed) + kThreads - 1) / kThreads;
  return n < 1024 ? n : 1024;
}

}  // namespace

extern "C" {

// The launch plan of a pass over B nodes (backward: 1 with dx, 0 without;
// -1 the forward): out[0] the tile's nodes T, out[1] 1 when the matrices
// stay in shared memory, out[2] the shared bytes, out[3] the blocks,
// out[4] the packed buffer's floats (a block's partial). Sets the
// kernel's shared-memory limit. Returns a cudaError_t.
int mha_plan(int L, int B, int d, int H, int backward, int* out) {
  if (!shape_ok(L, d, H) || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s(L, d, H);
  const Layout l = plan_layout(s, backward >= 0, backward == 1);
  if (l.T == 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = backward >= 0 ? (const void*)mha_bwd_kernel
                                     : (const void*)mha_fwd_kernel;
  // the most a block may take, so one setting serves every plan
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  int device = 0, n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, l.bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (B + l.T - 1) / l.T;
  out[0] = l.T;
  out[1] = l.resident;
  out[2] = (int)l.bytes();
  out[3] = tiles < per_sm * n_sm ? tiles : per_sm * n_sm;
  out[4] = s.packed;
  return static_cast<int>(cudaSuccess);
}

// in_w [3d, d], in_b [3d], out_w [d, d], out_b [d] -> packed [packed
// rounded up to 4] (f32, on the card).
int mha_pack(const float* in_w, const float* in_b, const float* out_w,
             const float* out_b, float* packed, int L, int d, int H,
             void* stream) {
  if (!shape_ok(L, d, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s(L, d, H);
  mha_pack_kernel<<<pack_blocks(s), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(in_w, in_b, out_w,
                                                         out_b, packed, L, d, H);
  return static_cast<int>(cudaGetLastError());
}

// x [L, B, d], draw [B, H, L, L] or null, packed (mha_pack) -> y [B, d];
// T, resident, smem and blocks from mha_plan (backward -1).
int mha_forward(const float* x, const float* draw, const float* packed,
                float* y, int L, int B, int d, int H, float p, float inv_keep,
                float scale, int T, int resident, int smem, int blocks,
                void* stream) {
  if (!shape_ok(L, d, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, draw, packed, nullptr, y, nullptr, nullptr, L, B, d, H,
               p, inv_keep, scale};
  mha_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, T, resident);
  return static_cast<int>(cudaGetLastError());
}

// As mha_forward, with gy [B, d]: the gradients d_in_w [3d, d], d_in_b
// [3d], d_out_w [d, d], d_out_b [d] and, when dx is not null, dx [L, B, d];
// partial [blocks, packed] is scratch. T, resident, smem and blocks from
// mha_plan (backward 1 with dx, else 0).
int mha_backward(const float* x, const float* draw, const float* packed,
                 const float* gy, float* dx, float* partial, float* d_in_w,
                 float* d_in_b, float* d_out_w, float* d_out_b, int L, int B,
                 int d, int H, float p, float inv_keep, float scale, int T,
                 int resident, int smem, int blocks, void* stream) {
  if (!shape_ok(L, d, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, draw, packed, gy, nullptr, dx, partial, L, B, d, H,
               p, inv_keep, scale};
  mha_bwd_kernel<<<blocks, kThreads, smem, st>>>(a, T, resident);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s(L, d, H);
  mha_reduce_kernel<<<pack_blocks(s), kThreads, 0, st>>>(
      partial, blocks, L, d, H, d_in_w, d_in_b, d_out_w, d_out_b);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
