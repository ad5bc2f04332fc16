// The featureless basis layer for Hopper (sm_90a), with a plain C interface
// (bound from Python with ctypes, see ops/basis_kernels.py).
//
// The R-GCN paper's entity classifier (Schlichtkrull et al. 2018; PyG
// RGCNConv with x = None) has no node features: its first layer reads the
// node id, so relation r's weight W_r = sum_b comp[r, b] V[:, b] has a row
// a node, out of B bases V [N, B, H] (PyG's weight[b, j] is V[j, b]):
//
//   out[i] = root[i] + bias + sum_{e: dst_e = i} norm_e sum_b comp[rel_e, b] V[src_e, b]
//
// and, for g = dL/dout (droot = g and dbias = sum_i g[i] are the caller's),
//
//   dV[j, b]    = sum_{e: src_e = j} norm_e comp[rel_e, b] g[dst_e]
//   dcomp[r, b] = sum_{e: rel_e = r} norm_e <V[src_e, b], g[dst_e]>
//
// No TPU kernel computes it: the JAX package materialises W ([R, N, H],
// 17.8 GB at AM) over an identity input. What bounds it on an H100: bytes.
// V is 2.67 GB at AM (40 bases of [1.67M, 10]); a gather of V[src_e] an
// edge would move 19.2 GB a pass. So every pass reads V in node order, each
// node's rows once, over the span plan's src-sorted CSR (edges by (src,
// rel)): a node's B x H block is 1.6 KB of contiguous memory; a warp owns
// a node, and nothing needs shared memory or a barrier:
//
// - forward, basis_msg_kernel: a group of H lanes holds the node's
//   V[j] (lane k its column, B registers) and computes one edge's
//   message norm_e * sum_b comp[rel_e, b] V[j, b, k], 32 / H edges at once,
//   written in src-sorted order ([E, H]); the node's edges' relations and
//   coefficients are read 32 at a time, a lane each, and passed round by
//   shuffles. Then basis_sum_kernel, dst-major over the forward CSR, a
//   group of H lanes a row: the row's messages summed in edge order through
//   perm (each dst-sorted edge's src-sorted position), then root and bias
//   added; a row with no edges gets root + bias;
// - backward, basis_bwd_kernel: lane b holds V[j, b, :] and dV[j, b, :]
//   (and b + 32). The node's edges are read 32 at a time, a lane each,
//   with u = norm_e g[dst_e] (H floats) and the edge's relation-order
//   position; for each edge in order, passed round by shuffles, it adds
//   comp[rel_e, b] u to dV's row and writes the edge's dcomp term
//   <V[j, b], u> into cterm [E, B] at that position. Each dV block is
//   written once, contiguous (zeros for a node with no edges). Then
//   basis_dcomp_chunk_kernel sums cterm over each chunk of the plan (at
//   most DW_CHUNK edges of one relation) and basis_dcomp_reduce_kernel
//   each relation's chunks in chunk order.
//
// Every sum runs in a fixed order and nothing adds atomically, so two runs
// give the same bits. Float32 on the CUDA cores (FFMA), no TF32. Offsets
// are 64-bit: B * N * H is 667M at AM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBases = 64;
constexpr int kMaxWidth = 16;
// loads a thread has in flight before it adds the first, in the sums
constexpr int kAhead = 4;
constexpr unsigned kFull = 0xffffffffu;

// MB: B rounded up to a multiple of 8 (a lane's column of the node's bases
// in registers); VEC: B % 4 == 0 and comp 16-byte aligned, so a lane reads
// comp's row four at a time (the sum runs in the same order either way)
template <int MB, bool VEC>
__global__ void __launch_bounds__(kThreads)
basis_msg_kernel(const float* __restrict__ V, const float* __restrict__ comp,
                 const int* __restrict__ rowptr, const int* __restrict__ rel,
                 const float* __restrict__ norm, float* __restrict__ msg,
                 int n, int B, int H) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / H;
  const int grp = lane / H;
  const int k = lane - grp * H;
  const int j = blockIdx.x * kWarps + threadIdx.x / 32;
  if (j >= n) return;                          // warp-uniform
  const int lo = __ldg(rowptr + j), hi = __ldg(rowptr + j + 1);
  if (lo == hi) return;
  const float* row = V + static_cast<size_t>(j) * B * H + (grp < groups ? k : 0);
  float v[MB];
#pragma unroll
  for (int b = 0; b < MB; ++b) v[b] = b < B ? __ldg(row + b * H) : 0.f;
  for (int base = lo; base < hi; base += 32) {
    const int cnt = hi - base < 32 ? hi - base : 32;
    const int my_rel = lane < cnt ? __ldg(rel + base + lane) : 0;
    const float my_norm = lane < cnt ? __ldg(norm + base + lane) : 0.f;
    for (int s0 = 0; s0 < cnt; s0 += groups) {
      const int s = s0 + grp;
      const bool live = grp < groups && s < cnt;
      const int r = __shfl_sync(kFull, my_rel, live ? s : 0);
      const float w = __shfl_sync(kFull, my_norm, live ? s : 0);
      if (!live) continue;
      const float* c = comp + static_cast<size_t>(r) * B;
      float acc = 0.f;
      if constexpr (VEC) {
#pragma unroll
        for (int b = 0; b < MB; b += 4) {
          if (b < B) {
            const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + b));
            acc = fmaf(c4.x, v[b], acc);
            acc = fmaf(c4.y, v[b + 1], acc);
            acc = fmaf(c4.z, v[b + 2], acc);
            acc = fmaf(c4.w, v[b + 3], acc);
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < MB; ++b)
          if (b < B) acc = fmaf(__ldg(c + b), v[b], acc);
      }
      msg[static_cast<size_t>(base + s) * H + k] = __fmul_rn(acc, w);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
basis_sum_kernel(const float* __restrict__ msg, const int* __restrict__ rowptr,
                 const int* __restrict__ perm, const float* __restrict__ root,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int n, int H) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / H;
  const int grp = lane / H;
  const int k = lane - grp * H;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * groups + grp;
  if (grp >= groups || row >= n) return;
  const int lo = __ldg(rowptr + row), hi = __ldg(rowptr + row + 1);
  float acc = 0.f;
  int q = lo;
  for (; q + kAhead <= hi; q += kAhead) {
    float m[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      m[a] = __ldg(msg + static_cast<size_t>(__ldg(perm + q + a)) * H + k);
#pragma unroll
    for (int a = 0; a < kAhead; ++a) acc += m[a];
  }
  for (; q < hi; ++q)
    acc += __ldg(msg + static_cast<size_t>(__ldg(perm + q)) * H + k);
  const size_t at = static_cast<size_t>(row) * H + k;
  out[at] = (acc + __ldg(root + at)) + __ldg(bias + k);
}

// SL: slots of 32 bases a lane holds (1 or 2); MH: H rounded up to even
template <int SL, int MH>
__global__ void __launch_bounds__(kThreads)
basis_bwd_kernel(const float* __restrict__ V, const float* __restrict__ comp,
                 const float* __restrict__ g, const int* __restrict__ rowptr,
                 const int* __restrict__ dst, const int* __restrict__ rel,
                 const float* __restrict__ norm, const int* __restrict__ pos,
                 float* __restrict__ dV, float* __restrict__ cterm,
                 int n, int B, int H) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + threadIdx.x / 32;
  if (j >= n) return;                          // warp-uniform
  const int lo = __ldg(rowptr + j), hi = __ldg(rowptr + j + 1);
  const size_t block = static_cast<size_t>(j) * B * H;
  float v[SL][MH], dv[SL][MH];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int b = lane + 32 * s;
#pragma unroll
    for (int k = 0; k < MH; ++k) {
      dv[s][k] = 0.f;
      v[s][k] = (b < B && k < H && lo < hi) ? __ldg(V + block + b * H + k) : 0.f;
    }
  }
  for (int base = lo; base < hi; base += 32) {
    const int cnt = hi - base < 32 ? hi - base : 32;
    int my_rel = 0, my_pos = 0;
    float my_u[MH];
#pragma unroll
    for (int k = 0; k < MH; ++k) my_u[k] = 0.f;
    if (lane < cnt) {
      const int e = base + lane;
      const float w = __ldg(norm + e);
      const float* gd = g + static_cast<size_t>(__ldg(dst + e)) * H;
      my_rel = __ldg(rel + e);
      my_pos = __ldg(pos + e);
#pragma unroll
      for (int k = 0; k < MH; ++k)
        if (k < H) my_u[k] = __fmul_rn(w, __ldg(gd + k));
    }
    for (int q = 0; q < cnt; ++q) {              // warp-uniform
      const int r = __shfl_sync(kFull, my_rel, q);
      const size_t at = static_cast<size_t>(__shfl_sync(kFull, my_pos, q)) * B;
      float u[MH];
#pragma unroll
      for (int k = 0; k < MH; ++k) u[k] = __shfl_sync(kFull, my_u[k], q);
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        const int b = lane + 32 * s;
        if (b < B) {
          const float cb = __ldg(comp + static_cast<size_t>(r) * B + b);
          float c = 0.f;
#pragma unroll
          for (int k = 0; k < MH; ++k) {
            if (k < H) {
              c = fmaf(v[s][k], u[k], c);
              dv[s][k] = fmaf(cb, u[k], dv[s][k]);
            }
          }
          cterm[at + b] = c;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int b = lane + 32 * s;
    if (b >= B) continue;
#pragma unroll
    for (int k = 0; k < MH; ++k)
      if (k < H) dV[block + b * H + k] = dv[s][k];
  }
}

// partial[c, b]: chunk c's rows of cterm summed; kThreads / B rows in flight,
// then the rows' sums added in row order
__global__ void __launch_bounds__(kThreads)
basis_dcomp_chunk_kernel(const float* __restrict__ cterm,
                         const int* __restrict__ chunk_lo,
                         const int* __restrict__ chunk_hi,
                         float* __restrict__ partial, int B) {
  __shared__ float red[kThreads];
  const int rows = kThreads / B;
  const int s = threadIdx.x / B, b = threadIdx.x - s * B;
  const int c = blockIdx.x;
  const int lo = __ldg(chunk_lo + c), hi = __ldg(chunk_hi + c);
  float acc = 0.f;
  if (s < rows) {
    int e = lo + s;
    for (; e + (kAhead - 1) * rows < hi; e += kAhead * rows) {
      float t[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        t[a] = __ldg(cterm + static_cast<size_t>(e + a * rows) * B + b);
#pragma unroll
      for (int a = 0; a < kAhead; ++a) acc += t[a];
    }
    for (; e < hi; e += rows) acc += __ldg(cterm + static_cast<size_t>(e) * B + b);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < B) {
    float t = 0.f;
    for (int i = 0; i < rows; ++i) t += red[i * B + threadIdx.x];
    partial[static_cast<size_t>(c) * B + threadIdx.x] = t;
  }
}

// dcomp[r, b]: relation r's chunks' partials in chunk order (0 without any)
__global__ void __launch_bounds__(kThreads)
basis_dcomp_reduce_kernel(const float* __restrict__ partial,
                          const int* __restrict__ rel_chunk_ptr,
                          float* __restrict__ dcomp, int slots, int B) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= slots * B) return;
  const int r = t / B, b = t - r * B;
  float acc = 0.f;
  for (int c = __ldg(rel_chunk_ptr + r); c < __ldg(rel_chunk_ptr + r + 1); ++c)
    acc += __ldg(partial + static_cast<size_t>(c) * B + b);
  dcomp[t] = acc;
}

inline unsigned blocks_for(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

bool shapes_ok(int B, int H) {
  return B >= 1 && B <= kMaxBases && H >= 1 && H <= kMaxWidth;
}

}  // namespace

extern "C" {

// V [n, B, H], comp [slots, B], root [n, H], bias [H] f32; the span plan's
// src-sorted CSR bwd_rowptr [n + 1], bwd_rel, bwd_norm [E] and forward CSR
// fwd_rowptr [n + 1]; perm [E] each dst-sorted edge's src-sorted position;
// msg [E, H] scratch; out [n, H]. B <= 64, H <= 16. Returns
// cudaGetLastError() after the launches.
int basis_forward(const float* V, const float* comp, const float* root,
                  const float* bias, const int* bwd_rowptr, const int* bwd_rel,
                  const float* bwd_norm, const int* fwd_rowptr,
                  const int* perm, float* msg, float* out, int n, int B,
                  int H, int E, void* stream) {
  if (!shapes_ok(B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    const unsigned grid = blocks_for(n, kWarps);
    const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(comp) % 16 == 0;
#define BASIS_MSG(MB)                                                     \
  if (vec)                                                                \
    basis_msg_kernel<MB, true><<<grid, kThreads, 0, s>>>(                 \
        V, comp, bwd_rowptr, bwd_rel, bwd_norm, msg, n, B, H);            \
  else                                                                    \
    basis_msg_kernel<MB, false><<<grid, kThreads, 0, s>>>(                \
        V, comp, bwd_rowptr, bwd_rel, bwd_norm, msg, n, B, H)
    switch ((B + 7) / 8) {
      case 1: BASIS_MSG(8); break;
      case 2: BASIS_MSG(16); break;
      case 3: BASIS_MSG(24); break;
      case 4: BASIS_MSG(32); break;
      case 5: BASIS_MSG(40); break;
      case 6: BASIS_MSG(48); break;
      case 7: BASIS_MSG(56); break;
      default: BASIS_MSG(64); break;
    }
#undef BASIS_MSG
  }
  const long long rows_per_block = static_cast<long long>(kWarps) * (32 / H);
  basis_sum_kernel<<<blocks_for(n, rows_per_block), kThreads, 0, s>>>(
      msg, fwd_rowptr, perm, root, bias, out, n, H);
  return static_cast<int>(cudaGetLastError());
}

// V [n, B, H], comp [slots, B], g [n, H] f32; the src-sorted CSR
// bwd_rowptr [n + 1], bwd_dst, bwd_rel, bwd_norm, bwd_pos [E] (each edge's
// relation-order index); the plan's chunks chunk_lo, chunk_hi
// [num_chunks] and rel_chunk_ptr [slots + 1]; cterm [E, B] and partial
// [num_chunks, B] scratch; dV [n, B, H] and dcomp [slots, B] written
// whole. Returns cudaGetLastError() after the launches.
int basis_backward(const float* V, const float* comp, const float* g,
                   const int* bwd_rowptr, const int* bwd_dst,
                   const int* bwd_rel, const float* bwd_norm,
                   const int* bwd_pos, const int* chunk_lo,
                   const int* chunk_hi, const int* rel_chunk_ptr,
                   float* cterm, float* partial, float* dV, float* dcomp,
                   int n, int B, int H, int num_chunks, int slots,
                   void* stream) {
  if (!shapes_ok(B, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const unsigned grid = blocks_for(n, kWarps);
#define BASIS_BWD(SL, MH) basis_bwd_kernel<SL, MH><<<grid, kThreads, 0, s>>>( \
    V, comp, g, bwd_rowptr, bwd_dst, bwd_rel, bwd_norm, bwd_pos, dV, cterm,   \
    n, B, H)
#define BASIS_BWD_H(SL)                                                    \
  switch ((H + 1) / 2) {                                                   \
    case 1: BASIS_BWD(SL, 2); break;                                       \
    case 2: BASIS_BWD(SL, 4); break;                                       \
    case 3: BASIS_BWD(SL, 6); break;                                       \
    case 4: BASIS_BWD(SL, 8); break;                                       \
    case 5: BASIS_BWD(SL, 10); break;                                      \
    case 6: BASIS_BWD(SL, 12); break;                                      \
    case 7: BASIS_BWD(SL, 14); break;                                      \
    default: BASIS_BWD(SL, 16); break;                                     \
  }
    if (B <= 32) {
      BASIS_BWD_H(1)
    } else {
      BASIS_BWD_H(2)
    }
#undef BASIS_BWD_H
#undef BASIS_BWD
  }
  if (num_chunks > 0)
    basis_dcomp_chunk_kernel<<<num_chunks, kThreads, 0, s>>>(
        cterm, chunk_lo, chunk_hi, partial, B);
  if (slots > 0)
    basis_dcomp_reduce_kernel<<<blocks_for(static_cast<long long>(slots) * B,
                                           kThreads), kThreads, 0, s>>>(
        partial, rel_chunk_ptr, dcomp, slots, B);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
