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
// fused_halo_tc (kernel #7) replaces
//   scaling_rgcn_training_tpu/parallel/fused_halo.py:307 _fused_kernel
// exchange, then local and halo relational aggregation:
//   agg[n] = sum_{e: dst_e = n} norm_e * row(src_e) @ W[rel_e]
// over all of the shard's edges, local and halo, with src_e the global
// (partition-padded) node id: row(i) is row i % n_per of shard i / n_per,
// read straight from that shard's memory, so the halo gather and the
// exchange both happen inside the kernel; plus the received halo buffer
// buf[p * H + j] = row recv_idx[p, j] of shard p, which the backward
// reads. Three launches, no atomics, the same bits on every run:
//   1. span_msg_kernel (span_tc.cuh), #1's chunk kernel over ShardSrc: per
//      relation chunk of the shard's edges (the plan's chunks over the
//      global src ids), the norm-scaled messages on the tensor cores into
//      an [E, M] f32 scratch in relation order; a lane resolves its tile
//      row's shard and address once a tile and the copying lanes read the
//      row through the shuffled address, by cp.async where every shard's
//      base allows the unit (else plain loads);
//   2. span_msg_sum_kernel (span_tc.cuh): each dst row's messages summed
//      in forward-CSR order through fwd_pos;
//   3. with a buffer, halo_buf_kernel: the S * H rows copied in 16-byte
//      units where every shard's base, the buffer and the row width allow
//      (else 4 or 2 bytes), bit for bit.
// float32 takes #1's split-TF32 products on the fixed-point grid with the
// fourth product (span_fwd_tc.cu says why), bfloat16 one exact product.
// None of the TPU kernel's machinery is carried over: no one-hot MXU
// products, no [8, 128] code tiles or 128-edge chunk padding, no Python
// per-edge planner and no padding blow-up gate. What bounds it on an
// H100: as #1, the msg round trip and the gather of the rows (the halo
// rows from the peers' memory), then the halo buffer's bytes (S * H rows
// read and written).
//
// fused_halo_rows is the earlier route of #7 (span_rows.cuh's row kernel
// over ShardRows on the CUDA cores, whose epilogue writes the buffer); it
// stays callable as fused_halo_aggregate_rows and no main path calls it.
//
// Across processes (parallel/ipc.py) the pointer tables of #6 and #7 also
// hold other processes' rows, mapped into this process by CUDA IPC: the
// ipc_* entries below allocate the buffers a process shares (cudaMalloc, as
// cudaIpcGetMemHandle wants the base of an allocation, which PyTorch's
// caching allocator does not give), export and open their memory handles,
// and create, export and open the interprocess events that order the
// processes' streams. No kernel changes for it.

#include <cstdint>
#include <cstring>

#include "span_rows.cuh"
#include "span_tc.cuh"

namespace {

using span::kMaxShards;
using span::PtrTable;

constexpr int kPullThreads = 256;
// >= kMaxShards: ShardRows::prepare copies the table one entry a thread
constexpr int kBufThreads = 256;
constexpr int kBufMaxBlocks = 1024;

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

// Row source of span_msg_kernel over the S shards' rows (span_tc.cuh's
// gather): a lane resolves its row's shard and address once a tile (an
// integer division), and the copying lanes read through the shuffled
// address. The table sits in shared memory (ShardRows::prepare).
template <typename T>
struct ShardSrc {
  using Handle = const T*;
  span::ShardRows<T> shards;
  __device__ __forceinline__ void prepare() const { shards.prepare(); }
  __device__ __forceinline__ Handle at(int i, int K) const {
    return i >= 0 ? shards.row(i, K) : nullptr;
  }
  __device__ __forceinline__ static bool valid(Handle h) {
    return h != nullptr;
  }
  __device__ __forceinline__ const T* addr(Handle h, bool valid, int k,
                                           int) const {
    return valid ? h + k : shards.shard(0);
  }
  __device__ __forceinline__ T load(Handle h, int k, int) const {
    return h[k];
  }
};

template <typename T>
cudaError_t launch_fused_msg(const PtrTable& tab, int n_shards, int n_per,
                             const void* w, const int* chunk_lo,
                             const int* chunk_hi, const int* rel_chunk_ptr,
                             const int* rel_src, const float* rel_norm,
                             float* msg, int n_chunks, int K, int M,
                             int n_slots, cudaStream_t s) {
  // a cp.async unit must hold for every shard's rows
  int unit = 16;
  for (int k = 0; k < n_shards; ++k) {
    const int u = copy_unit<T>(tab.p[k], K);
    unit = u < unit ? u : unit;
  }
  const ShardSrc<T> rows{
      span::ShardRows<T>{tab, n_per, n_shards, 0, nullptr, nullptr}};
  return launch_msg<T>(rows, unit, w, chunk_lo, chunk_hi, rel_chunk_ptr,
                       rel_src, rel_norm, msg, n_chunks, K, M, n_slots, s);
}

// buf[r] = row recv_idx[r] of shard r / halo for r < S * halo, in units
// V: the rows as bytes (ShardRows over unsigned char, row_bytes wide).
template <typename V>
__global__ void __launch_bounds__(kBufThreads)
halo_buf_kernel(span::ShardRows<unsigned char> rows, int row_bytes) {
  rows.prepare();
  __syncthreads();
  const int per_row = row_bytes / (int)sizeof(V);
  const long long n = (long long)rows.n_shards * rows.halo * per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < n;
       u += stride) {
    const int r = (int)(u / per_row);
    const int c = (int)(u - (long long)r * per_row);
    const V* from = reinterpret_cast<const V*>(
        rows.shard(r / rows.halo) + (size_t)rows.recv_idx[r] * row_bytes);
    V* to = reinterpret_cast<V*>(rows.buf + (size_t)r * row_bytes);
    to[c] = from[c];
  }
}

cudaError_t launch_buf(const PtrTable& tab, int n_shards, const int* recv_idx,
                       void* buf, int halo, int row_bytes, cudaStream_t s) {
  uintptr_t a = reinterpret_cast<uintptr_t>(buf) | (uintptr_t)row_bytes;
  for (int k = 0; k < n_shards; ++k)
    a |= reinterpret_cast<uintptr_t>(tab.p[k]);
  const span::ShardRows<unsigned char> rows{
      tab, 0, n_shards, halo, recv_idx, static_cast<unsigned char*>(buf)};
  const int unit = a % 16 == 0 ? 16 : a % 4 == 0 ? 4 : 2;
  const long long units = (long long)n_shards * halo * (row_bytes / unit);
  long long blocks = (units + kBufThreads - 1) / kBufThreads;
  if (blocks > kBufMaxBlocks) blocks = kBufMaxBlocks;
  const dim3 grid((unsigned)blocks);
  if (unit == 16)
    halo_buf_kernel<uint4><<<grid, kBufThreads, 0, s>>>(rows, row_bytes);
  else if (unit == 4)
    halo_buf_kernel<unsigned int><<<grid, kBufThreads, 0, s>>>(rows, row_bytes);
  else
    halo_buf_kernel<unsigned short><<<grid, kBufThreads, 0, s>>>(rows, row_bytes);
  return cudaGetLastError();
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

// Kernel #7. dtype: 0 = float32, 1 = bfloat16. xtab[p] -> shard p's
// [n_per, K] rows; w holds n_slots relations of [K, M]; the chunks
// (chunk_lo, chunk_hi, rel_chunk_ptr over the relation-ordered rel_src,
// global node ids, and rel_norm) and the forward CSR (rowptr [n_rows + 1],
// pos: each CSR edge's index in relation order) are the plan's; msg is an
// [E, M] f32 scratch, out [n_rows, M] f32; buf [S * halo, K] or null, with
// recv_idx [S * halo]. K, M <= 128 and K * M <= 4096 (the wrapper checks).
// Returns the first error of the set-up calls or of a launch.
int fused_halo_tc(int dtype, const void* const* xtab, int n_shards, int n_per,
                  const void* w, const int* chunk_lo, const int* chunk_hi,
                  const int* rel_chunk_ptr, const int* rel_src,
                  const float* rel_norm, const int* rowptr, const int* pos,
                  float* msg, float* out, int n_chunks, int n_rows, int K,
                  int M, int n_slots, const int* recv_idx, void* buf,
                  int halo, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards) return cudaErrorInvalidValue;
  PtrTable tab{};
  for (int k = 0; k < n_shards; ++k) tab.p[k] = xtab[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (n_chunks > 0)
    err = dtype == 1
        ? launch_fused_msg<__nv_bfloat16>(tab, n_shards, n_per, w, chunk_lo,
                                          chunk_hi, rel_chunk_ptr, rel_src,
                                          rel_norm, msg, n_chunks, K, M,
                                          n_slots, s)
        : launch_fused_msg<float>(tab, n_shards, n_per, w, chunk_lo,
                                  chunk_hi, rel_chunk_ptr, rel_src, rel_norm,
                                  msg, n_chunks, K, M, n_slots, s);
  if (err == cudaSuccess && n_rows > 0)
    err = dispatch_sum(msg, rowptr, pos, out, n_rows, M, s);
  if (err == cudaSuccess && buf != nullptr && halo > 0)
    err = launch_buf(tab, n_shards, recv_idx, buf, halo,
                     K * (dtype == 1 ? 2 : 4), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The earlier route of #7: the row kernel over ShardRows. dtype: 0 =
// float32, 1 = bfloat16. xtab[p] -> shard p's [n_per, K] rows;
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

// CUDA IPC. A handle is 64 bytes (CUDA_IPC_HANDLE_SIZE) in the caller's
// buffer; each entry returns a cudaError_t.

// bytes of device memory on the current device, and its memory handle.
int ipc_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(err);
}

int ipc_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// Another process's allocation mapped on the current device (peer access
// enabled when it lies on another card).
int ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// An interprocess event of the current device (no timing, as IPC wants),
// and its handle.
int ipc_event_create(void** event, void* handle) {
  cudaEvent_t ev;
  cudaError_t err = cudaEventCreateWithFlags(
      &ev, cudaEventInterprocess | cudaEventDisableTiming);
  if (err != cudaSuccess) return static_cast<int>(err);
  *event = ev;
  return static_cast<int>(
      cudaIpcGetEventHandle(static_cast<cudaIpcEventHandle_t*>(handle), ev));
}

int ipc_event_open(const void* handle, void** event) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t ev;
  cudaError_t err = cudaIpcOpenEventHandle(&ev, h);
  if (err == cudaSuccess) *event = ev;
  return static_cast<int>(err);
}

int event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}

int event_record(void* event, void* stream) {
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event),
                                          static_cast<cudaStream_t>(stream)));
}

int stream_wait_event(void* stream, void* event) {
  return static_cast<int>(cudaStreamWaitEvent(
      static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t>(event), 0));
}

int copy_async(void* dst, const void* src, long long bytes, void* stream) {
  return static_cast<int>(cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                                          cudaMemcpyDeviceToDevice,
                                          static_cast<cudaStream_t>(stream)));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
