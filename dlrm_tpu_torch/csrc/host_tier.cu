// Host-tier row gather and row update for Hopper (sm_90a).
//
// Replace the host-side regions of dlrm_tpu/parallel/host_tier.py:
// host_tier_gather (:279) and host_tier_scatter_add (:297).  There they are
// XLA gather and scatter ops placed on the host by
// compute_on("device_host"), with only the touched rows crossing to the
// device.  Here the host tier is one (R_host, W) tensor in pinned host
// memory.  Under unified addressing pinned memory is mapped into the card's
// address space, so these kernels read and write it in place over PCIe:
// neither the host CPU nor a host sync moves a row.
//
//   host_gather       out + dst[k] <- row ids[k] of the table, for k < n: a
//                     byte copy of each row, so bit-exact in any dtype.  The
//                     caller (parallel/host_tier.py, gather_plan) hands the
//                     ids over sorted, with dst[k] the byte offset in `out`
//                     of the row's place before the sort: the host tables'
//                     columns of a pooled (B, T, W) or (B, T, H, W) buffer,
//                     or a contiguous (n, W) one.
//   host_update_rows  table[ids[i]] += upd[i] for DISTINCT ids, a
//                     read-modify-write in place: f32 arithmetic on the
//                     f32 update, rounded once to the table's dtype (f32 or
//                     bf16).  The caller sums duplicates on the card first
//                     (PCIe carries no floating-point atomics, so two rows
//                     of one id would race); the ids come sorted from that.
//
// What bounds them.  PCIe Gen5 x16 carries 64 GB/s each way, but reads
// that the SMs issue to mapped host memory were measured far below that on
// an H100 (probes/host_tier_probe.py, chip_smoke.py): 26-50 GB/s for
// sequential rows depending on the host, whatever the rows in flight, and
// 15-16 GB/s for uniform random rows of a 13 GB tier.  What random rows
// lose is address translation: random rows within 1 GB read at the
// sequential rate, within 4 GB at 20 GB/s.  Rows in flight (1 to 16 a
// warp) and bulk copies into shared memory (cp.async.bulk, which does
// accept a mapped host address) change neither rate.  So the design cuts
// translation misses:
//   * the rows are visited in ascending id order (the gather's ids are
//     sorted on the card by its caller), so consecutive rows share their
//     translations;
//   * the rows in flight are a narrow window of that order: each round, the
//     grid moves kInFlight units a thread (a unit: 16 bytes, or less for
//     narrow rows), all host loads issued before any store, over units that
//     are contiguous in visiting order; the caller sizes the grid so that a
//     round covers a fixed number of bytes (gather_plan / update_plan), a
//     few hundred KB, which covers the link's latency and spans well under
//     the translations' reach.  A wider window of sorted rows reads slower;
//   * a thread fetches the next round's ids (and destination offsets) from
//     HBM while this round's host reads are in flight, so no host read
//     waits behind an id read.
// Units are 16 bytes where the row's bytes and the pointers allow it.  Rows
// that are not a multiple of 16 bytes -- the row-wise Adagrad accumulator,
// width 1, 4 bytes a row -- take a branch of their own: the gather copies
// them in the widest unit that divides them (8, 4, 2 or 1 bytes), the
// update adds element by element (kVec 1).  Ids are checked against the
// stack: one out of range traps, as PyTorch's index_select asserts on the
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// Threads a block and units a thread in flight; parallel/host_tier.py
// mirrors both (_THREADS, _IN_FLIGHT) to size the grid.
constexpr int kThreads = 256;
constexpr int kInFlight = 2;

// A thread's place in the flat walk over n rows of c units: unit (i, c) of
// row i.  Units a thread visits are step apart; advance() moves one step.
struct Walk {
  long long i;
  long long c;
  __device__ __forceinline__ void advance(long long di, long long dc,
                                          long long units) {
    i += di;
    c += dc;
    if (c >= units) {
      c -= units;
      ++i;
    }
  }
};

// The first unit of each of a thread's kInFlight slots this round, and the
// (rows, units) a round moves each slot.
struct Rounds {
  Walk w[kInFlight];
  long long round_i, round_c;

  __device__ __forceinline__ Rounds(long long units) {
    const long long step = (long long)gridDim.x * kThreads;
    const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long step_i = step / units, step_c = step % units;
    w[0] = {first / units, first % units};
#pragma unroll
    for (int k = 1; k < kInFlight; ++k) {
      w[k] = w[k - 1];
      w[k].advance(step_i, step_c, units);
    }
    const long long round = step * kInFlight;
    round_i = round / units;
    round_c = round % units;
  }

  __device__ __forceinline__ void next(long long units) {
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) w[k].advance(round_i, round_c, units);
  }
};

template <typename Id>
__device__ __forceinline__ long long checked(Id raw, long long rows) {
  const long long id = static_cast<long long>(raw);
  if (id < 0 || id >= rows) __trap();
  return id;
}

// V: the unit (uint4 for 16 bytes, down to uint8_t); units: row bytes /
// sizeof(V).
template <typename Id, typename V>
__global__ void __launch_bounds__(kThreads)
    host_gather_kernel(const char* __restrict__ table, long long rows,
                       long long units, const Id* __restrict__ ids,
                       const long long* __restrict__ dst, long long n,
                       char* __restrict__ out) {
  const long long row_bytes = units * (long long)sizeof(V);
  Rounds r(units);
  Id next[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k)
    if (r.w[k].i < n) next[k] = ids[r.w[k].i];
  while (r.w[0].i < n) {
    V v[kInFlight];
    long long to[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (r.w[k].i < n) {
        const long long id = checked(next[k], rows);
        v[k] = reinterpret_cast<const V*>(table + id * row_bytes)[r.w[k].c];
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (r.w[k].i < n) to[k] = dst[r.w[k].i] + r.w[k].c * (long long)sizeof(V);
    const Rounds cur = r;
    r.next(units);
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (r.w[k].i < n) next[k] = ids[r.w[k].i];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (cur.w[k].i < n) *reinterpret_cast<V*>(out + to[k]) = v[k];
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

// One unit of a table row: kVec elements of T (16 bytes), or 1.
template <typename T, int kVec>
struct Unit {
  T x[kVec];
};

template <typename T, int kVec>
__device__ __forceinline__ Unit<T, kVec> load_unit(const T* p) {
  Unit<T, kVec> u;
  if constexpr (kVec == 1) {
    u.x[0] = *p;
  } else {
    static_assert(sizeof(Unit<T, kVec>) == 16, "a 16-byte unit");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(&u, &raw, sizeof(raw));
  }
  return u;
}

template <typename T, int kVec>
__device__ __forceinline__ void store_unit(T* p, const Unit<T, kVec>& u) {
  if constexpr (kVec == 1) {
    *p = u.x[0];
  } else {
    uint4 raw;
    memcpy(&raw, &u, sizeof(raw));
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// kVec: table elements a unit (16 bytes), or 1 (the element-wise branch).
template <typename T, typename Id, int kVec>
__global__ void __launch_bounds__(kThreads)
    host_update_rows_kernel(T* __restrict__ table, long long rows, int width,
                            const Id* __restrict__ ids, long long n,
                            const float* __restrict__ upd) {
  const long long units = width / kVec;
  Rounds r(units);
  Id next[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k)
    if (r.w[k].i < n) next[k] = ids[r.w[k].i];
  while (r.w[0].i < n) {
    Unit<T, kVec> v[kInFlight];
    float add[kInFlight][kVec];
    T* at[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (r.w[k].i < n) {
        const long long id = checked(next[k], rows);
        at[k] = table + id * width + r.w[k].c * kVec;
        v[k] = load_unit<T, kVec>(at[k]);
        const float* u = upd + r.w[k].i * width + r.w[k].c * kVec;
        if constexpr (kVec == 1) {
          add[k][0] = *u;
        } else {
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 q = *reinterpret_cast<const float4*>(u + e);
            add[k][e] = q.x;
            add[k][e + 1] = q.y;
            add[k][e + 2] = q.z;
            add[k][e + 3] = q.w;
          }
        }
      }
    }
    const Rounds cur = r;
    r.next(units);
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (r.w[k].i < n) next[k] = ids[r.w[k].i];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (cur.w[k].i < n) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          v[k].x[e] = from_f<T>(to_f(v[k].x[e]) + add[k][e]);
        store_unit<T, kVec>(at[k], v[k]);
      }
    }
  }
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
                   const void* ids, const long long* dst, long long n,
                   char* out, int unit, int blocks, cudaStream_t stream) {
  const Id* id = static_cast<const Id*>(ids);
#define GATHER(V)                                                       \
  host_gather_kernel<Id, V><<<blocks, kThreads, 0, stream>>>(          \
      table, rows, row_bytes / (long long)sizeof(V), id, dst, n, out)
  switch (unit) {
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
                   long long n, const float* upd, int vec, int blocks,
                   cudaStream_t stream) {
  const Id* id = static_cast<const Id*>(ids);
  if (vec) {
    host_update_rows_kernel<T, Id, static_cast<int>(16 / sizeof(T))>
        <<<blocks, kThreads, 0, stream>>>(table, rows, width, id, n, upd);
  } else {
    host_update_rows_kernel<T, Id, 1><<<blocks, kThreads, 0, stream>>>(
        table, rows, width, id, n, upd);
  }
}

}  // namespace

extern "C" {

// table_base: the pinned host allocation holding the stack; table_offset:
// the stack's first byte within it.  ids (n, int32 or int64) in visiting
// order; dst (n, int64): each visited row's byte offset in out.  unit:
// bytes a thread copies at once (16, 8, 4, 2 or 1; the caller checks that
// row_bytes, the pointers and every dst are multiples of it).  blocks: the
// grid (gather_plan).  Returns the CUDA error of the address lookup or of
// the launch.
int host_gather(const void* table_base, long long table_offset,
                long long rows, long long row_bytes, const void* ids, int ids64,
                const long long* dst, long long n, void* out, int unit,
                int blocks, void* stream) {
  char* table = nullptr;
  cudaError_t rc = device_address(table_base, table_offset, &table);
  if (rc != cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* o = static_cast<char*>(out);
  if (ids64) {
    launch_gather<long long>(table, rows, row_bytes, ids, dst, n, o, unit,
                             blocks, s);
  } else {
    launch_gather<int>(table, rows, row_bytes, ids, dst, n, o, unit, blocks,
                       s);
  }
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  vec: 1 for 16-byte units (width a
// multiple of 16 bytes, table row and update 16-byte aligned), else 0 (the
// element-wise branch).  blocks: the grid (update_plan).
int host_update_rows(void* table_base, long long table_offset, int dtype,
                     long long rows, int width, const void* ids, int ids64,
                     long long n, const float* upd, int vec, int blocks,
                     void* stream) {
  char* table = nullptr;
  cudaError_t rc = device_address(table_base, table_offset, &table);
  if (rc != cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UPDATE(T)                                                          \
  (ids64 ? launch_update<T, long long>(reinterpret_cast<T*>(table), rows,  \
                                       width, ids, n, upd, vec, blocks, s) \
         : launch_update<T, int>(reinterpret_cast<T*>(table), rows, width, \
                                 ids, n, upd, vec, blocks, s))
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
