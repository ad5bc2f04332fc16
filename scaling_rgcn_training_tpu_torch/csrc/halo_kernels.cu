// Halo kernels of the node-partitioned R-GCN conv for Hopper (sm_90a), with
// a plain C interface (bound from Python with ctypes, see
// parallel/ring_halo.py and parallel/fused_halo.py). The S shards of the
// mesh are S devices, or S virtual shards on one device; a shard's tensors
// are read where they lie, through a table of S device pointers passed in
// the kernel's parameters (read at static indices only).
//
// halo_pull (kernel #6) replaces
//   scaling_rgcn_training_tpu/parallel/ring_halo.py:42 _a2a_kernel
// the all-to-all of [S, H, d] halo blocks: receiver q's out[p] is sender
// p's send[q]. The TPU kernel pushes each block to its peer with a remote
// DMA behind a barrier semaphore. Here the receiver PULLS: one launch per
// receiver, on that receiver's stream, whose blocks read the S senders'
// blocks (its own included) and write its output. Ordering is the
// streams': the wrapper makes the receiver's stream wait for each sender's
// stream before the launch, and each sender's stream wait for the
// receiver's after it, so nothing rewrites a block being read and no
// barrier is needed. What bounds it: bytes, S * H * d elements read once
// and written once (peer reads over NVLink between cards). Design: each
// block of the grid copies one contiguous H * d-element run with 16-byte
// loads and stores where source and destination share their alignment
// (2-byte head and tail), else with the widest unit both allow; every
// element is 2 or 4 bytes wide, so 2-byte units always fit.
//
// fused_halo_rows (kernel #7) replaces
//   scaling_rgcn_training_tpu/parallel/fused_halo.py:307 _fused_kernel
// exchange, then local and halo relational aggregation in one kernel:
//   agg[n] = sum_{e: dst_e = n} norm_e * row(src_e) @ W[rel_e]
// over one dst-sorted CSR of all of the shard's edges, local and halo, with
// src_e the global (partition-padded) node id: row(i) is row i % n_per of
// shard i / n_per, read straight from that shard's memory, so the halo
// gather and the exchange both happen inside the row kernel
// (span_rows.cuh, W staged in shared memory). The first relation pass's
// epilogue also writes the received halo buffer, buf[p * H + j] = row
// recv_idx[p, j] of shard p, which the backward reads. None of the TPU
// kernel's machinery is carried over: no one-hot MXU products, no [8, 128]
// code tiles or 128-edge chunk padding, no Python per-edge planner and no
// padding blow-up gate; the plan is a plain CSR built in numpy. What
// bounds it: as the span forward (#1), the per-edge row reads and
// multiply-adds; the halo rows come from the peers' memory.

#include <cstdint>

#include "span_rows.cuh"

namespace {

using span::kMaxShards;
using span::PtrTable;

constexpr int kPullThreads = 256;

template <typename V>
__device__ __forceinline__ void copy_units(const unsigned char* src,
                                           unsigned char* dst, long long n,
                                           long long start, long long stride) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (long long i = start; i < n; i += stride) d[i] = s[i];
}

// blockIdx.y = sender p: out + p * bytes <- senders[p] + me * bytes.
__global__ void __launch_bounds__(kPullThreads)
halo_pull_kernel(PtrTable senders, unsigned char* __restrict__ out, int me,
                 long long bytes) {
  const int p = blockIdx.y;
  const void* send = nullptr;
#pragma unroll
  for (int k = 0; k < kMaxShards; ++k)
    if (k == p) send = senders.p[k];
  const unsigned char* src =
      static_cast<const unsigned char*>(send) + (size_t)me * bytes;
  unsigned char* dst = out + (size_t)p * bytes;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t s_mis = reinterpret_cast<uintptr_t>(src) & 15;
  const uintptr_t d_mis = reinterpret_cast<uintptr_t>(dst) & 15;
  if (s_mis == d_mis) {
    long long head = s_mis ? 16 - (long long)s_mis : 0;
    if (head > bytes) head = bytes;
    const long long body = (bytes - head) / 16;
    const long long tail = head + body * 16;
    copy_units<unsigned short>(src, dst, head / 2, t, stride);
    copy_units<uint4>(src + head, dst + head, body, t, stride);
    copy_units<unsigned short>(src + tail, dst + tail, (bytes - tail) / 2, t,
                               stride);
    return;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) | (uintptr_t)bytes;
  if ((a & 7) == 0)
    copy_units<uint2>(src, dst, bytes / 8, t, stride);
  else if ((a & 3) == 0)
    copy_units<unsigned int>(src, dst, bytes / 4, t, stride);
  else
    copy_units<unsigned short>(src, dst, bytes / 2, t, stride);
}

template <typename T>
cudaError_t launch_fused(const PtrTable& tab, int n_shards, int n_per,
                         const void* w, const int* rowptr, const int* src,
                         const int* rel, const float* norm, float* out,
                         int n_rows, int K, int M, int n_slots,
                         const int* recv_idx, void* buf, int halo,
                         cudaStream_t s) {
  const span::ShardRows<T> rows{tab, n_per, n_shards, halo, recv_idx,
                                static_cast<T*>(buf)};
  return span::dispatch_rows<T>(rows, w, rowptr, src, rel, norm, out, n_rows,
                                K, M, n_slots, s);
}

}  // namespace

extern "C" {

// Let the current device read `peer`'s memory (a no-op when it already
// can). Returns a cudaError_t.
int enable_peer(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(err);
}

// Receiver `me` of an all-to-all over n_shards senders: out [S, H, d] on
// the current device; senders[p] -> sender p's [S, H, d] send buffer;
// bytes = H * d * element size. Returns the launch's error.
int halo_pull(const void* const* senders, int n_shards, void* out, int me,
              long long bytes, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards) return cudaErrorInvalidValue;
  if (bytes <= 0) return static_cast<int>(cudaGetLastError());
  PtrTable tab{};
  for (int k = 0; k < n_shards; ++k) tab.p[k] = senders[k];
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = bytes / 16 + 1;
  long long gx = (units + kPullThreads - 1) / kPullThreads;
  const long long cap = (4LL * n_sm + n_shards - 1) / n_shards;
  if (gx > cap) gx = cap;
  const dim3 grid((unsigned)gx, (unsigned)n_shards);
  halo_pull_kernel<<<grid, kPullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<unsigned char*>(out), me, bytes);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. xtab[p] -> shard p's [n_per, K] rows;
// the CSR (rowptr [n_rows + 1], src, rel, norm) is sorted by (dst, rel)
// with src the global node id; out [n_rows, M] f32; buf [S * halo, K] or
// null, with recv_idx [S * halo]. K, M <= 128 (the wrapper checks).
int fused_halo_rows(int dtype, const void* const* xtab, int n_shards,
                    int n_per, const void* w, const int* rowptr,
                    const int* src, const int* rel, const float* norm,
                    float* out, int n_rows, int K, int M, int n_slots,
                    const int* recv_idx, void* buf, int halo, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (n_rows > 0 && n_slots > 0) {
    PtrTable tab{};
    for (int k = 0; k < n_shards; ++k) tab.p[k] = xtab[k];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
      err = launch_fused<__nv_bfloat16>(tab, n_shards, n_per, w, rowptr, src,
                                        rel, norm, out, n_rows, K, M, n_slots,
                                        recv_idx, buf, halo, s);
    else
      err = launch_fused<float>(tab, n_shards, n_per, w, rowptr, src, rel,
                                norm, out, n_rows, K, M, n_slots, recv_idx,
                                buf, halo, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
