// Variants of a gather and an update of 512-byte f32 rows in mapped pinned
// host memory, for probes/host_tier_probe.py: what limits the reads that
// the SMs issue over PCIe.  Not part of the package: the kernels that the
// port runs are dlrm_tpu_torch/csrc/host_tier.cu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// The first design of host_gather (a warp a 512-byte row, a grid of n / 8
// blocks of 256 threads), kept here to compare the port's kernel with.
__global__ void g_first(const char* __restrict__ table, long long rows,
                      const int* __restrict__ ids, long long n,
                      char* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long groups = (long long)gridDim.x * blockDim.x / 32;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       i < n; i += groups) {
    const long long id = ids[i];
    if (id < 0 || id >= rows) __trap();
    reinterpret_cast<uint4*>(out + i * 512)[lane] =
        reinterpret_cast<const uint4*>(table + id * 512)[lane];
  }
}

// R rows in flight a warp: all loads issued before any store.
template <int R>
__global__ void g_rows(const char* __restrict__ table, long long rows,
                       const int* __restrict__ ids, long long n,
                       char* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32 * R;
       i0 < n; i0 += warps * R) {
    int my = lane < R && i0 + lane < n ? ids[i0 + lane] : 0;
    if (my < 0 || my >= rows) __trap();
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long id = __shfl_sync(0xffffffffu, my, r);
      if (i0 + r < n)
        v[r] = reinterpret_cast<const uint4*>(table + id * 512)[lane];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r < n) reinterpret_cast<uint4*>(out + (i0 + r) * 512)[lane] = v[r];
  }
}

// Bulk copies: a ring of kStages stages of kRows rows a block; the lanes
// of warp 0 issue a stage's row copies (host -> shared, cp.async.bulk) on
// one mbarrier, then the block stores the stage to HBM.
constexpr int kRows = 16;
template <int kStages>
__global__ void g_bulk(const char* __restrict__ table, long long rows,
                       const int* __restrict__ ids, long long n,
                       char* __restrict__ out) {
  extern __shared__ __align__(128) char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  char* ring = smem + 128;
  const long long chunks = (n + kRows - 1) / kRows;
  const int lane = threadIdx.x % 32;
  // warp 0: lane 0 expects the stage's bytes, lane r copies row r
  auto issue = [&](int s, long long c) {
    const long long i0 = c * kRows;
    const int k = static_cast<int>(n - i0 < kRows ? n - i0 : kRows);
    if (lane == 0) bar_expect(&bars[s], k * 512);
    __syncwarp();
    if (lane < k) {
      const long long id = ids[i0 + lane];
      if (id < 0 || id >= rows) __trap();
      bulk_load(ring + (s * kRows + lane) * 512, table + id * 512, 512,
                &bars[s]);
    }
  };
  if (threadIdx.x < 32) {
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) bar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int s = 0; s < kStages; ++s) {
      const long long c = blockIdx.x + (long long)s * gridDim.x;
      if (c < chunks) issue(s, c);
    }
  }
  __syncthreads();
  for (long long it = 0;; ++it) {
    const long long c = blockIdx.x + it * gridDim.x;
    if (c >= chunks) break;
    const int s = static_cast<int>(it % kStages);
    bar_wait(&bars[s], static_cast<uint32_t>((it / kStages) & 1));
    const long long i0 = c * kRows;
    const int k = static_cast<int>(n - i0 < kRows ? n - i0 : kRows);
    const uint4* src = reinterpret_cast<const uint4*>(ring + s * kRows * 512);
    uint4* dst = reinterpret_cast<uint4*>(out + i0 * 512);
    for (int q = threadIdx.x; q < k * 32; q += blockDim.x) dst[q] = src[q];
    __syncthreads();
    if (threadIdx.x < 32) {
      const long long nc = c + (long long)kStages * gridDim.x;
      if (nc < chunks) issue(s, nc);
    }
  }
}

// The first design of host_update_rows for f32 512-byte rows: a warp a row.
__global__ void u_first(float* __restrict__ table, long long rows,
                      const int* __restrict__ ids, long long n,
                      const float* __restrict__ upd) {
  const int lane = threadIdx.x % 32;
  const long long groups = (long long)gridDim.x * blockDim.x / 32;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       i < n; i += groups) {
    const long long id = ids[i];
    if (id < 0 || id >= rows) __trap();
    float4* w = reinterpret_cast<float4*>(table + id * 128) + lane;
    const float4 u = reinterpret_cast<const float4*>(upd + i * 128)[lane];
    float4 x = *w;
    x.x += u.x; x.y += u.y; x.z += u.z; x.w += u.w;
    *w = x;
  }
}

// R rows in flight a warp for the update.
template <int R>
__global__ void u_rows(float* __restrict__ table, long long rows,
                       const int* __restrict__ ids, long long n,
                       const float* __restrict__ upd) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32 * R;
       i0 < n; i0 += warps * R) {
    int my = lane < R && i0 + lane < n ? ids[i0 + lane] : 0;
    if (my < 0 || my >= rows) __trap();
    float4 v[R], u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long id = __shfl_sync(0xffffffffu, my, r);
      if (i0 + r < n) {
        v[r] = reinterpret_cast<const float4*>(table + id * 128)[lane];
        u[r] = reinterpret_cast<const float4*>(upd + (i0 + r) * 128)[lane];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long id = __shfl_sync(0xffffffffu, my, r);
      if (i0 + r < n) {
        float4 x = v[r];
        x.x += u[r].x; x.y += u[r].y; x.z += u[r].z; x.w += u[r].w;
        reinterpret_cast<float4*>(table + id * 128)[lane] = x;
      }
    }
  }
}

// Writes only: rows of HBM to host rows, R a warp.
template <int R>
__global__ void w_rows(char* __restrict__ table, long long rows,
                       const int* __restrict__ ids, long long n,
                       const char* __restrict__ src) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32 * R;
       i0 < n; i0 += warps * R) {
    int my = lane < R && i0 + lane < n ? ids[i0 + lane] : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long id = __shfl_sync(0xffffffffu, my, r);
      if (i0 + r < n)
        reinterpret_cast<uint4*>(table + id * 512)[lane] =
            reinterpret_cast<const uint4*>(src + (i0 + r) * 512)[lane];
    }
  }
}

template <typename K>
int occupancy(K k, int threads, int smem) {
  int per = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, threads, smem);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per * sms;
}

}  // namespace

extern "C" {

// variant: 0 the first design, R (1, 4, 8, 16) rows a warp on a grid of
// all resident blocks, 100 + S bulk copies through S stages.
int probe_gather(const void* base, long long off, long long rows,
                 const int* ids, long long n, void* out, int variant,
                 void* stream) {
  void* dev = nullptr;
  cudaError_t rc = cudaHostGetDevicePointer(&dev, const_cast<void*>(base), 0);
  if (rc != cudaSuccess) return rc;
  const char* t = static_cast<const char*>(dev) + off;
  char* o = static_cast<char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: g_first<<<(n + 7) / 8, 256, 0, s>>>(t, rows, ids, n, o); break;
#define ROWS(R)                                                         \
  case R: g_rows<R><<<occupancy(g_rows<R>, 256, 0), 256, 0, s>>>(     \
              t, rows, ids, n, o); break;
    ROWS(1) ROWS(4) ROWS(8) ROWS(16)
#undef ROWS
#define BULK(S)                                                           \
  case 100 + S: {                                                         \
    const int sm = 128 + S * kRows * 512;                                 \
    cudaFuncSetAttribute(g_bulk<S>,                                       \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, sm); \
    g_bulk<S><<<occupancy(g_bulk<S>, 128, sm), 128, sm, s>>>(t, rows, ids, \
                                                             n, o);       \
  } break;
    BULK(2) BULK(4) BULK(8)
#undef BULK
    default: return -1;
  }
  return cudaGetLastError();
}

// variant: 0 the first design, R (1, 4, 8) rows a warp; 200 + R writes
// only (upd: the rows' bytes, written to the host rows).
int probe_update(void* base, long long off, long long rows, const int* ids,
                 long long n, const void* upd, int variant, void* stream) {
  void* dev = nullptr;
  cudaError_t rc = cudaHostGetDevicePointer(&dev, base, 0);
  if (rc != cudaSuccess) return rc;
  char* t = static_cast<char*>(dev) + off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(upd);
  switch (variant) {
    case 0: u_first<<<(n + 7) / 8, 256, 0, s>>>(reinterpret_cast<float*>(t),
                                             rows, ids, n, u); break;
#define ROWS(R)                                                          \
  case R: u_rows<R><<<occupancy(u_rows<R>, 256, 0), 256, 0, s>>>(      \
              reinterpret_cast<float*>(t), rows, ids, n, u); break;      \
  case 200 + R: w_rows<R><<<occupancy(w_rows<R>, 256, 0), 256, 0, s>>>( \
              t, rows, ids, n, static_cast<const char*>(upd)); break;
    ROWS(1) ROWS(4) ROWS(8)
#undef ROWS
    default: return -1;
  }
  return cudaGetLastError();
}

}  // extern "C"

extern "C" {
// Page-lock and map an allocation (cudaHostRegister), and undo it.
int probe_register(void* p, long long size) {
  return cudaHostRegister(p, static_cast<size_t>(size),
                          cudaHostRegisterMapped | cudaHostRegisterPortable);
}
int probe_unregister(void* p) { return cudaHostUnregister(p); }
}

