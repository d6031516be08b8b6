// Host-tier row gather and row update for Hopper (sm_90a).
//
// Replace the host-side regions of dlrm_tpu/parallel/host_tier.py:
// host_tier_gather (:279) and host_tier_scatter_add (:297).  There they are
// XLA gather and scatter ops placed on the host by
// compute_on("device_host"), with only the touched rows crossing to the
// device.  Here the host tier is one (R_host, D) tensor in pinned host
// memory.  Under unified addressing pinned memory is mapped into the card's
// address space, so these kernels read and write it in place over PCIe:
// neither the host CPU nor a host sync moves a row.
//
//   host_gather       out[dst(i)] = table[ids[i]] for i < n: a byte copy of
//                     each row, so bit-exact in any dtype.  Row i goes to
//                     out + r * s_row + col(j) * s_col + h * s_hot, where
//                     i = (r * n_cols + j) * n_hot + h and col(j) = cols[j]
//                     (or j without a column map): the host tables' columns
//                     of a pooled (B, T, D) or (B, T, H, D) buffer, or a
//                     contiguous (n, D) one.
//   host_update_rows  table[ids[i]] += upd[i] for DISTINCT ids, a
//                     read-modify-write in place: f32 arithmetic on the
//                     f32 update, rounded once to the table's dtype (f32 or
//                     bf16).  The caller sums duplicates on the card first:
//                     PCIe carries no floating-point atomics, so two rows of
//                     one id would race.
//
// What bounds them: PCIe.  A gather reads n rows from host memory and
// writes them to HBM; an update reads and writes each distinct row once
// over PCIe and reads its f32 update from HBM.  At Kaggle fs=128 (f32,
// B=32768, 3 host tables) a step gathers 98,304 rows of 512 B (50.3 MB).
// Each row is read by a group of lanes, 16 bytes a lane where the row and
// the pointers allow it (2 to 8 bytes otherwise), so a warp moves up to
// 512 contiguous bytes per request; many warps in flight cover the link's
// latency.  Ids are checked against the stack: one out of range traps,
// as PyTorch's index_select asserts on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

template <typename Id, typename V>
__global__ void host_gather_kernel(const char* __restrict__ table,
                                   long long rows, long long row_bytes,
                                   const Id* __restrict__ ids, long long n,
                                   char* __restrict__ out, int n_cols,
                                   int n_hot, const int* __restrict__ cols,
                                   long long s_row, long long s_col,
                                   long long s_hot, int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long groups = (long long)gridDim.x * blockDim.x / lanes;
  const long long per = (long long)n_cols * n_hot;
  const long long chunks = row_bytes / (long long)sizeof(V);
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
       i < n; i += groups) {
    const long long id = static_cast<long long>(ids[i]);
    if (id < 0 || id >= rows) __trap();
    const long long r = i / per;
    const long long rem = i - r * per;
    const int j = static_cast<int>(rem / n_hot);
    const int h = static_cast<int>(rem - (long long)j * n_hot);
    const long long col = cols != nullptr ? cols[j] : j;
    const V* src = reinterpret_cast<const V*>(table + id * row_bytes);
    V* dst = reinterpret_cast<V*>(out + r * s_row + col * s_col + h * s_hot);
    for (long long c = lane; c < chunks; c += lanes) dst[c] = src[c];
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec: table elements a lane reads at once (16 bytes), or 1.
template <typename T, typename Id, int kVec>
__global__ void host_update_rows_kernel(T* __restrict__ table, long long rows,
                                        int width, const Id* __restrict__ ids,
                                        long long n,
                                        const float* __restrict__ upd,
                                        int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long groups = (long long)gridDim.x * blockDim.x / lanes;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
       i < n; i += groups) {
    const long long id = static_cast<long long>(ids[i]);
    if (id < 0 || id >= rows) __trap();
    T* w = table + id * width;
    const float* u = upd + i * width;
    for (int c = lane * kVec; c < width; c += lanes * kVec) {
      if constexpr (kVec == 1) {
        w[c] = from_f<T>(to_f(w[c]) + u[c]);
      } else {
        uint4 raw = *reinterpret_cast<const uint4*>(w + c);
        T vals[kVec];
        memcpy(vals, &raw, sizeof(raw));
        float add[kVec];
#pragma unroll
        for (int k = 0; k < kVec; k += 4) {
          const float4 q = *reinterpret_cast<const float4*>(u + c + k);
          add[k] = q.x;
          add[k + 1] = q.y;
          add[k + 2] = q.z;
          add[k + 3] = q.w;
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          vals[k] = from_f<T>(to_f(vals[k]) + add[k]);
        }
        memcpy(&raw, vals, sizeof(raw));
        *reinterpret_cast<uint4*>(w + c) = raw;
      }
    }
  }
}

int blocks_for(long long n, int lanes) {
  const long long per_block = kThreads / lanes;
  long long b = (n + per_block - 1) / per_block;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

// The card's address of a byte of pinned host memory: its allocation's
// mapped base plus the offset.
cudaError_t device_address(const void* host_base, long long offset,
                           char** out) {
  void* dev = nullptr;
  const cudaError_t rc =
      cudaHostGetDevicePointer(&dev, const_cast<void*>(host_base), 0);
  if (rc != cudaSuccess) return rc;
  *out = static_cast<char*>(dev) + offset;
  return cudaSuccess;
}

template <typename Id>
void launch_gather(const char* table, long long rows, long long row_bytes,
                   const void* ids, long long n, char* out, int n_cols,
                   int n_hot, const int* cols, long long s_row, long long s_col,
                   long long s_hot, int vec, int lanes, cudaStream_t stream) {
  const int blocks = blocks_for(n, lanes);
  const Id* id = static_cast<const Id*>(ids);
#define GATHER(V)                                                           \
  host_gather_kernel<Id, V><<<blocks, kThreads, 0, stream>>>(              \
      table, rows, row_bytes, id, n, out, n_cols, n_hot, cols, s_row, s_col, \
      s_hot, lanes)
  switch (vec) {
    case 16: GATHER(uint4); break;
    case 8: GATHER(uint2); break;
    case 4: GATHER(uint32_t); break;
    case 2: GATHER(uint16_t); break;
    default: GATHER(uint8_t); break;
  }
#undef GATHER
}

template <typename T, typename Id>
void launch_update(T* table, long long rows, int width, const void* ids,
                   long long n, const float* upd, int vec, int lanes,
                   cudaStream_t stream) {
  const int blocks = blocks_for(n, lanes);
  const Id* id = static_cast<const Id*>(ids);
  if (vec) {
    host_update_rows_kernel<T, Id, static_cast<int>(16 / sizeof(T))>
        <<<blocks, kThreads, 0, stream>>>(
        table, rows, width, id, n, upd, lanes);
  } else {
    host_update_rows_kernel<T, Id, 1><<<blocks, kThreads, 0, stream>>>(
        table, rows, width, id, n, upd, lanes);
  }
}

}  // namespace

extern "C" {

// table_base: the pinned host allocation holding the stack; table_offset:
// the stack's first byte within it.  vec: bytes a lane copies at once (16,
// 8, 4, 2 or 1; the caller checks row_bytes, pointers and strides are
// multiples of it).  lanes: lanes a row (a power of two up to 32).
// Returns the CUDA error of the address lookup or of the launch.
int host_gather(const void* table_base, long long table_offset,
                long long rows, long long row_bytes, const void* ids, int ids64,
                long long n, void* out, int n_cols, int n_hot, const int* cols,
                long long s_row, long long s_col, long long s_hot, int vec,
                int lanes, void* stream) {
  char* table = nullptr;
  cudaError_t rc = device_address(table_base, table_offset, &table);
  if (rc != cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids64) {
    launch_gather<long long>(table, rows, row_bytes, ids, n,
                             static_cast<char*>(out), n_cols, n_hot, cols,
                             s_row, s_col, s_hot, vec, lanes, s);
  } else {
    launch_gather<int>(table, rows, row_bytes, ids, n, static_cast<char*>(out),
                       n_cols, n_hot, cols, s_row, s_col, s_hot, vec, lanes,
                       s);
  }
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  vec: 1 for 16-byte table accesses (width a
// multiple of 16 bytes, table row and update 16-byte aligned), else 0.
int host_update_rows(void* table_base, long long table_offset, int dtype,
                     long long rows, int width, const void* ids, int ids64,
                     long long n, const float* upd, int vec, int lanes,
                     void* stream) {
  char* table = nullptr;
  cudaError_t rc = device_address(table_base, table_offset, &table);
  if (rc != cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UPDATE(T)                                                          \
  (ids64 ? launch_update<T, long long>(reinterpret_cast<T*>(table), rows,  \
                                       width, ids, n, upd, vec, lanes, s)  \
         : launch_update<T, int>(reinterpret_cast<T*>(table), rows, width, \
                                 ids, n, upd, vec, lanes, s))
  if (dtype == 1) {
    UPDATE(__nv_bfloat16);
  } else {
    UPDATE(float);
  }
#undef UPDATE
  return cudaGetLastError();
}

// What the card offers host memory: out[0] unified addressing, out[1] can
// map host memory, out[2] native atomics to host memory over its link,
// out[3] pageable memory access.
int host_tier_device_attrs(int device, int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrUnifiedAddressing, cudaDevAttrCanMapHostMemory,
      cudaDevAttrHostNativeAtomicSupported, cudaDevAttrPageableMemoryAccess};
  for (int k = 0; k < 4; ++k) {
    const cudaError_t rc = cudaDeviceGetAttribute(&out[k], attrs[k], device);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // extern "C"
